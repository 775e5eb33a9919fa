"""The sort path's segmented fold (S1): ``seg_reduce`` and ``seg_sum``
(wrappers of ``csrc/groupby.cu``) and ``seg_fold``, their plain version.

The rows are sorted by group: group g is the ``sizes[g]`` rows of ``x``
from ``starts[g]``. A fold reduces each group's rows with one op (add,
minimum or maximum) in a fixed tree of in-order runs: the rows fold left
to right in pieces of ``FOLD_WIDTH`` counted from the group's first row,
then the pieces of each group fold the same way, level after level,
until one is left. So a group of up to ``FOLD_WIDTH`` rows folds as a
loop over its rows would (the order of the reference's dense sweep, which
the folding tests pin bit for bit); no step meets two groups' values, so
rounding error, an Inf or a NaN stays in its group; nothing is added
atomically. It takes the place of the reference's segmented scan
(spark_rapids_tpu/ops/groupby.py ``_seg_scan``, a jnp scan with no
``pallas_call``).

``seg_reduce(x, starts, sizes, op)`` folds with ``op`` "sum" (float64),
"min" or "max" (float32, float64, int8, int16, int32, int64). On the card
it is one launch of one kernel a call, whatever the number of levels, and
reads nothing back from the device: the kernel finds each tile's groups
in ``starts`` itself (``csrc/groupby.cu`` says how it splits the work).
Every call counts in ``kernels.LAUNCHES["seg_sum"]``. A CUDA tensor of
another type raises. On the CPU it runs ``seg_fold`` with ``OPS[op]``;
the two agree bit for bit. The groups must be in row order, not overlap
and hold a row each, as the sort path's do. The zero and subnormal rules
of the reference's results (C4, C5) are the caller's
(``ops/groupby.py``); the fold itself is the pure tree.
"""
from __future__ import annotations

import functools
import threading
from typing import Dict, Tuple

import torch

from spark_rapids_tpu_torch import kernels as nk

#: items of a group one piece folds in order
FOLD_WIDTH = 8


def _minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """b where b < a or b is NaN, else a: NaN wins, a tie (-0.0 and
    +0.0) keeps the earlier value; the kernel's min."""
    return torch.where((b < a) | torch.isnan(b), b, a)


def _maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """b where b > a or b is NaN, else a; the kernel's max."""
    return torch.where((b > a) | torch.isnan(b), b, a)


#: the folds' ops by name, as ``seg_fold`` takes them
OPS = {"sum": torch.add, "min": _minimum, "max": _maximum}
_OP_CODES = {"sum": 0, "min": 1, "max": 2}
_TYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.int8: 2,
               torch.int16: 3, torch.int32: 4, torch.int64: 5}


def _pieces(n: int, starts, sizes, w: int):
    """(first item, items) of every piece of one level, and per group
    the inclusive prefix sum of its piece counts and the counts. The
    piece count is bounded from the host's counts (a sum of ceil(size /
    w) is at most (rows + groups * (w - 1)) / w); the spare pieces hold
    no items and no group reads them."""
    num_groups = sizes.shape[0]
    per = (sizes + w - 1) // w
    ends = torch.cumsum(per, 0)
    piece = torch.arange((n + num_groups * (w - 1)) // w,
                         device=sizes.device)
    grp = torch.searchsorted(ends, piece, right=True).clamp(
        max=num_groups - 1)
    k = (piece - (ends - per)[grp]) * w
    return starts[grp] + k, (sizes[grp] - k).clamp(0, w), ends, per


def seg_fold(x: torch.Tensor, starts: torch.Tensor, sizes: torch.Tensor,
             longest: int, op) -> torch.Tensor:
    """Per group: ``op`` (``torch.add`` or one of ``OPS``) over its rows of
    ``x`` ([rows] or [rows, columns]), every row in a group;
    ``longest`` is the largest group. One value (row) per group."""
    w = FOLD_WIDTH
    while True:
        n = x.shape[0]
        if longest <= w:  # one piece a group: the last level
            p_start, p_len, ends, per = starts, sizes, None, None
        else:
            p_start, p_len, ends, per = _pieces(n, starts, sizes, w)
        acc = x[p_start.clamp(max=max(n - 1, 0))]
        for j in range(1, min(w, longest)):
            more = (p_len > j).view(-1, *([1] * (x.dim() - 1)))
            acc = torch.where(more, op(acc, x[(p_start + j).clamp(
                max=n - 1)]), acc)
        if ends is None:
            return acc
        x, starts, sizes, longest = acc, ends - per, per, -(-longest // w)


#: (device index, stream handle) -> [chunk nodes, counters, epoch]
_SCRATCH: Dict[Tuple[int, int], list] = {}
#: held from a call's epoch to its launch, so threads sharing a stream
#: neither reuse an epoch nor grow the scratch under each other
_LOCK = threading.Lock()


def _scratch(device, stream, slots: int, node_bytes: int):
    """The (device, stream)'s scratch, grown to ``slots`` slots of two
    ``node_bytes`` chunk nodes and a counter each (counters zeroed), with
    a new epoch."""
    key = (device.index, stream)
    s = _SCRATCH.get(key)
    if s is None or s[0].numel() < 2 * slots * node_bytes or \
            s[1].numel() < slots or s[2] >= 0xFFFFFFFF:
        size = max(1 << max(slots - 1, 0).bit_length(),
                   0 if s is None else s[1].numel())
        nodes = max(2 * size * node_bytes, 0 if s is None else s[0].numel())
        s = [torch.empty(nodes, dtype=torch.uint8, device=device),
             torch.zeros(size, dtype=torch.int64, device=device), 0]
        _SCRATCH[key] = s
    s[2] += 1
    return s


@functools.lru_cache(maxsize=None)
def _chunk_rows() -> int:
    """Rows of one scratch slot of ``csrc/groupby.cu``."""
    return nk.load("groupby").srt_seg_fold_chunk()


def seg_reduce(x: torch.Tensor, starts: torch.Tensor, sizes: torch.Tensor,
               op: str) -> torch.Tensor:
    """Per group: ``op`` ("sum", "min" or "max") over its rows of ``x``
    ([rows] or [rows, columns]); ``starts`` and ``sizes`` int64. On the
    card one launch of ``csrc/groupby.cu``; on the CPU ``seg_fold``."""
    if op not in _OP_CODES:
        raise ValueError(f"seg_reduce: op {op!r}")
    if starts.dtype != torch.int64 or sizes.dtype != torch.int64:
        raise TypeError("seg_reduce: starts and sizes must be int64")
    if op == "sum" and x.dtype != torch.float64:
        raise TypeError("seg_reduce: a sum takes float64")
    if not x.is_cuda:
        longest = int(sizes.max()) if sizes.numel() else 0
        return seg_fold(x, starts, sizes, longest, OPS[op])
    if x.dtype not in _TYPE_CODES:
        raise TypeError(f"seg_reduce: {op} does not take {x.dtype}")
    x, starts, sizes = x.contiguous(), starts.contiguous(), sizes.contiguous()
    nk.require_cuda("seg_reduce", [x, starts, sizes],
                    [x.dtype, torch.int64, torch.int64])
    num_groups, n = sizes.shape[0], x.shape[0]
    m = 1 if x.dim() == 1 else x.shape[1]
    out = torch.empty((num_groups,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    if num_groups and n and m:
        lib = nk.load("groupby")
        stream = nk.stream_handle(x.device)
        with _LOCK:
            nodes, counters, epoch = _scratch(x.device, stream,
                                              -(-n // _chunk_rows()),
                                              m * x.element_size())
            nk.check(lib.srt_seg_fold(
                _OP_CODES[op], _TYPE_CODES[x.dtype], x.data_ptr(), m, n,
                starts.data_ptr(), sizes.data_ptr(), num_groups,
                out.data_ptr(), nodes.data_ptr(), counters.data_ptr(),
                epoch, stream), "seg_reduce")
        nk.count_launch("seg_sum", n)
    return out


def seg_sum(x: torch.Tensor, starts: torch.Tensor,
            sizes: torch.Tensor) -> torch.Tensor:
    """Per group: the sum of its rows of float64 ``x``
    (``seg_reduce(x, starts, sizes, "sum")``)."""
    return seg_reduce(x, starts, sizes, "sum")
