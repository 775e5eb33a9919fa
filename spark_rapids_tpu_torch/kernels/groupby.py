"""The sort path's segmented fold: ``seg_sum`` (wrapper of
``csrc/groupby.cu``) and ``seg_fold``, its plain version.

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

``seg_sum`` is the float64 sum, which the sort path runs on every batch:
on the card one kernel launch a level, a thread a piece, no read of the
device from the host; it replaces the scatter of float atomics
(``index_add_``) that contended on a few addresses. Its plain version is
``seg_fold`` with ``torch.add``, and the two agree bit for bit. ``seg_fold``
also folds the sort path's min and max, on either device.
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch import kernels as nk

#: items of a group one piece folds in order
FOLD_WIDTH = 8


def _pieces(n: int, starts, sizes, w: int):
    """(first item, items) of every piece of one level, and per group
    the inclusive prefix sum of its piece counts and the counts. The
    piece count is bounded from the host's counts (a sum of ceil(size /
    w) is at most (rows + groups * (w - 1)) / w), so nothing is read from
    the device; the spare pieces hold no items and no group reads
    them."""
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
    """Per group: ``op`` (``torch.add``, ``minimum`` or ``maximum``) over
    its rows of ``x`` ([rows] or [rows, columns]), every row in a group;
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


def seg_sum(x: torch.Tensor, starts: torch.Tensor, sizes: torch.Tensor,
            longest: int) -> torch.Tensor:
    """Per group: the sum of its rows of float64 ``x`` ([rows] or [rows,
    columns]); ``starts`` and ``sizes`` int64. On the card one launch of
    ``csrc/groupby.cu`` a level (a call counts once); on the CPU
    ``seg_fold``."""
    if x.dtype != torch.float64 or starts.dtype != torch.int64 or \
            sizes.dtype != torch.int64:
        raise TypeError("seg_sum: x must be float64, starts and sizes "
                        "int64")
    if not x.is_cuda:
        return seg_fold(x, starts, sizes, longest, torch.add)
    w = FOLD_WIDTH
    m = 1 if x.dim() == 1 else x.shape[1]
    num_groups = sizes.shape[0]
    lib = nk.load("groupby")
    stream = nk.stream_handle(x.device)
    level = x.contiguous()
    starts, sizes = starts.contiguous(), sizes.contiguous()
    nk.require_cuda("seg_sum", [level, starts, sizes],
                    [torch.float64, torch.int64, torch.int64])
    while True:
        n = level.shape[0]
        if longest <= w:
            ends, per, pieces = None, None, num_groups
        else:
            per = (sizes + w - 1) // w
            ends = torch.cumsum(per, 0)
            pieces = (n + num_groups * (w - 1)) // w
        out = torch.empty((pieces, m), dtype=torch.float64,
                          device=x.device)
        if pieces:
            nk.check(lib.srt_seg_sum_level(
                level.data_ptr(), m, starts.data_ptr(), sizes.data_ptr(),
                None if ends is None else ends.data_ptr(), num_groups,
                pieces, w, out.data_ptr(), stream), "seg_sum")
        if ends is None:
            if pieces:
                nk.count_launch("seg_sum", x.shape[0])
            return out if x.dim() > 1 else out[:, 0]
        level, starts, sizes = out, ends - per, per
        longest = -(-longest // w)
