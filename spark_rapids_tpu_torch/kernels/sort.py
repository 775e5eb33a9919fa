"""Partition (K1) and radix argsort (K2): wrappers and plain versions.

``partition_order`` replaces spark_rapids_tpu/native/kernels/sort.py
``partition_order``: the stable permutation with mask-true rows first,
bit-equal to ``argsort(~mask, stable=True)``. On the card it is bound by
bytes (1 B read, 4 B written per row); ``csrc/sort.cu`` answers it with
one counting pass, a scan of per-tile counts and one scatter pass, so
every row is read twice and written once.

``radix_order`` replaces ``radix_order`` of the same file: a stable
ascending argsort of integral keys, most significant first, over their
order-preserving unsigned views. It is bound by bytes too: each 8-bit
digit pass streams a (u64 key, i32 index) pair in and out. The CUDA
version runs 8-bit LSD passes (histogram, scan, stable scatter) where the
TPU kernel ran 1-bit passes; a stable sort's permutation is unique, so
the two agree bit for bit.

Each wrapper launches its CUDA kernel for CUDA tensors and runs the plain
version for CPU tensors; the plain versions repeat the TPU kernels'
arithmetic in PyTorch and are what the card's results are held against.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from spark_rapids_tpu_torch import kernels as nk
from spark_rapids_tpu_torch.columnar import dtypes as dt

# -- K1 ----------------------------------------------------------------------


def partition_order_plain(mask: torch.Tensor) -> torch.Tensor:
    """One prefix scan plus a scatter: a true row lands at its true-rank,
    a false row after every true row at its false-rank."""
    n = mask.shape[0]
    iota = torch.arange(n, dtype=torch.int64, device=mask.device)
    cs = torch.cumsum(mask.to(torch.int64), 0)
    n_true = cs[-1] if n else cs.new_zeros(())
    pos = torch.where(mask, cs - 1, n_true + iota - cs)
    out = torch.empty(n, dtype=torch.int32, device=mask.device)
    out[pos] = iota.to(torch.int32)
    return out


def partition_order(mask: torch.Tensor) -> torch.Tensor:
    """Stable permutation (int32) placing ``mask``-true rows first."""
    if mask.dtype != torch.bool:
        raise TypeError(f"partition_order: mask dtype {mask.dtype}")
    if not mask.is_cuda:
        return partition_order_plain(mask)
    mask = mask.contiguous()
    nk.require_cuda("partition_order", [mask])
    n = mask.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=mask.device)
    if n == 0:
        return out
    lib = nk.load("sort")
    scratch = torch.empty(lib.srt_k1_scratch_ints(n), dtype=torch.int32,
                          device=mask.device)
    nk.check(lib.srt_k1_partition_order(
        mask.data_ptr(), n, out.data_ptr(), scratch.data_ptr(),
        nk.stream_handle(mask.device)), "partition_order")
    nk.LAUNCHES["partition_order"] += 1
    return out


# -- K2 ----------------------------------------------------------------------

# bit width of each integral key dtype and its code in csrc/sort.cu
_KEY_BITS = {torch.bool: 1, torch.int8: 8, torch.int16: 16, torch.int32: 32,
             torch.int64: 64}
_KEY_CODE = {torch.bool: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3,
             torch.int64: 4}


def _key_widths(keys: Sequence[torch.Tensor],
                widths: Optional[Sequence[Optional[int]]]) -> List[int]:
    out = []
    for i, k in enumerate(keys):
        if k.dtype not in _KEY_BITS:
            raise TypeError(f"radix_order: key dtype {k.dtype} is not "
                            f"integral")
        b = _KEY_BITS[k.dtype]
        if widths is not None and widths[i] is not None:
            b = min(b, int(widths[i]))
        out.append(b)
    return out


def _unsigned_view(k: torch.Tensor) -> torch.Tensor:
    """int64 bit pattern of the order-isomorphic unsigned view (the TPU
    kernel's ``_unsigned_key``): bool as 0/1, narrow ints shifted by
    2^(bits-1), int64 with the sign bit flipped."""
    bits = _KEY_BITS[k.dtype]
    if k.dtype == torch.bool:
        return k.to(torch.int64)
    if bits < 64:
        return k.to(torch.int64) + (1 << (bits - 1))
    return k ^ torch.tensor(-(1 << 63), dtype=torch.int64, device=k.device)


def radix_order_plain(keys: Sequence[torch.Tensor],
                      widths: Optional[Sequence[Optional[int]]] = None
                      ) -> torch.Tensor:
    """LSD binary radix, least significant key and bit first: each pass
    is a stable partition by the current bit of the key as seen through
    the running permutation."""
    bit_list = _key_widths(keys, widths)
    n = keys[0].shape[0]
    dev = keys[0].device
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    idx = iota.clone()
    for k, b in zip(reversed(keys), reversed(bit_list)):
        u = _unsigned_view(k)
        for bit in range(b):
            cur = ((u[idx] >> bit) & 1) == 0
            cs = torch.cumsum(cur.to(torch.int64), 0)
            nz = cs[-1] if n else cs.new_zeros(())
            pos = torch.where(cur, cs - 1, nz + iota - cs)
            nxt = torch.empty_like(idx)
            nxt[pos] = idx
            idx = nxt
    return idx.to(torch.int32)


def radix_order(keys: Sequence[torch.Tensor],
                widths: Optional[Sequence[Optional[int]]] = None
                ) -> torch.Tensor:
    """Stable ascending argsort (int32) of integral ``keys``, most
    significant first. ``widths`` caps a key's bit count where the caller
    knows its range (the leading rank key is 1 bit)."""
    if not keys:
        raise ValueError("radix_order: no keys")
    bit_list = _key_widths(keys, widths)
    if not keys[0].is_cuda:
        return radix_order_plain(keys, widths)
    keys = [k.contiguous() for k in keys]
    nk.require_cuda("radix_order", keys)
    n = keys[0].shape[0]
    if any(k.shape[0] != n for k in keys):
        raise ValueError("radix_order: keys differ in length")
    out = torch.empty(n, dtype=torch.int32, device=keys[0].device)
    if n == 0:
        return out
    lib = nk.load("sort")
    scratch = torch.empty(lib.srt_k2_scratch_bytes(n), dtype=torch.uint8,
                          device=keys[0].device)
    m = len(keys)
    ptrs = (ctypes.c_void_p * m)(*[k.data_ptr() for k in keys])
    codes = (ctypes.c_int * m)(*[_KEY_CODE[k.dtype] for k in keys])
    wid = (ctypes.c_int * m)(*bit_list)
    nk.check(lib.srt_k2_radix_order(
        m, ptrs, codes, wid, n, out.data_ptr(), scratch.data_ptr(),
        nk.stream_handle(keys[0].device)), "radix_order")
    nk.LAUNCHES["radix_order"] += 1
    return out


def lexsort_order(cols, dtypes: List[dt.DType], specs,
                  live_mask=None) -> Optional[torch.Tensor]:
    """Radix permutation over the order-key arrays of
    ``sortkeys.order_key_arrays``; None when a key is floating (the
    caller keeps its multi-key stable sort)."""
    from spark_rapids_tpu_torch.ops import sortkeys

    for spec in specs:
        if dtypes[spec.ordinal].is_floating:
            return None
    keys = sortkeys.order_key_arrays(cols, dtypes, specs, live_mask)
    widths: List[Optional[int]] = [None] * len(keys)
    widths[0] = 1  # the leading liveness rank key is 0/1 by construction
    return radix_order(keys, widths)
