"""Bucketed hash-join probe (K3): table build, wrapper and plain version.

``probe`` replaces spark_rapids_tpu/native/kernels/join.py ``probe``.
The build side is the hash-sorted int64 build column ``sb_h``; its
sign-flipped unsigned view is ascending too, so the top ``table_bits``
bits of that view cut it into contiguous buckets, and ``part`` (one
int32 offset per bucket, 2x as many buckets as rows, load <= 0.5) is the
whole table. A probe maps each stream hash to its bucket and scans it,
returning the leftmost hash match ``lo`` and the match run length
``counts``: the contract of two ``searchsorted`` calls.

On the card the probe is bound by the stream side's bytes (8 B in, 8 B
out per row). ``csrc/join.cu`` probes four rows per thread; a build of up
to about 27,000 rows is staged in shared memory with a coarse bucket
table of its own, a larger one is read from L2 through ``part``. A
bucket of a few entries is scanned and a longer one binary-searched, so
a skewed build (one key's run filling a bucket) costs O(log run) per
probe, not O(run). The TPU kernel carried the build hashes as unsigned
values with padding parked at u64 max; the port keeps them signed (the
two orders agree) and has no padding, so its table covers exactly the
build's rows.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from spark_rapids_tpu_torch import DEFAULT_DEVICE
from spark_rapids_tpu_torch import kernels as nk

_SIGN = -(1 << 63)


class ProbeTable(NamedTuple):
    """``sb_h``: int64 build hashes, ascending, shared positions with the
    hash-sorted build rows; ``part``: int32[2^table_bits + 1] bucket
    offsets into ``sb_h``."""

    sb_h: torch.Tensor
    part: torch.Tensor

    @property
    def table_bits(self) -> int:
        return (self.part.shape[0] - 1).bit_length() - 1


def table_bits_for(rows: int) -> int:
    """Bucket-count exponent: 2x buckets per row => load <= 0.5."""
    bits = 1
    while (1 << bits) < 2 * max(rows, 1):
        bits += 1
    return bits


def _bucket(h: torch.Tensor, table_bits: int) -> torch.Tensor:
    """Top ``table_bits`` bits of the sign-flipped hash (a logical right
    shift written on int64 bit patterns)."""
    shift = 64 - table_bits
    u = h ^ torch.tensor(_SIGN, dtype=torch.int64, device=h.device)
    return (u >> shift) & ((1 << table_bits) - 1)


def build_table(sb_h: torch.Tensor) -> ProbeTable:
    """Bucket offsets over the ascending build hashes: ``part[j]`` = rows
    in buckets below ``j`` (histogram plus prefix sum; plain PyTorch, as
    the TPU version was jnp)."""
    tb = table_bits_for(sb_h.shape[0])
    hist = torch.bincount(_bucket(sb_h, tb), minlength=1 << tb)
    part = torch.zeros((1 << tb) + 1, dtype=torch.int32,
                       device=sb_h.device)
    part[1:] = torch.cumsum(hist, 0).to(torch.int32)
    return ProbeTable(sb_h.contiguous(), part)


def table_from_reference(u_sorted: np.ndarray, part: np.ndarray,
                         device=DEFAULT_DEVICE) -> ProbeTable:
    """The port's table from a reference ``ProbeTable``'s arrays
    (``u_sorted`` uint64 with padding at u64 max, ``part`` int32): the
    signed hashes are the unsigned view with the sign bit flipped back."""
    sb_h = (np.asarray(u_sorted, dtype=np.uint64) ^
            np.uint64(1 << 63)).view(np.int64)
    return ProbeTable(torch.from_numpy(sb_h.copy()).to(device),
                      torch.from_numpy(np.asarray(part, np.int32)
                                       .copy()).to(device))


def probe_plain(table: ProbeTable, h_p: torch.Tensor):
    """The kernel's arithmetic: bucket by shift, two offset gathers, then
    a binary search of the (ascending) bucket for the first hash not
    below ``h`` and the first above it, ``ceil(log2(max_seg + 1))``
    vectorised steps for the largest bucket's occupancy ``max_seg``.
    ``lo`` is the lower end and ``counts`` the run between the two: the
    TPU kernel's ``start + #(v < h)`` and ``#(v == h)``."""
    b = _bucket(h_p, table.table_bits)
    start = table.part[b].to(torch.int64)
    end = table.part[b + 1].to(torch.int64)
    part = table.part.to(torch.int64)
    max_seg = int((part[1:] - part[:-1]).max()) if part.numel() > 1 else 0
    # row 0 searches lower_bound (v < h moves right), row 1 upper_bound
    a = torch.stack([start, start])
    z = torch.stack([end, end])
    last = max(table.sb_h.shape[0] - 1, 0)
    for _ in range(max_seg.bit_length()):
        mid = (a + z) >> 1
        v = table.sb_h[mid.clamp(0, last)]
        right = torch.stack([v[0] < h_p, v[1] <= h_p])
        active = a < z
        a = torch.where(active & right, mid + 1, a)
        z = torch.where(active & ~right, mid, z)
    return a[0].to(torch.int32), (a[1] - a[0]).to(torch.int32)


def probe(table: ProbeTable, h_p: torch.Tensor):
    """``(lo, counts)`` int32 per stream hash ``h_p`` (int64)."""
    if h_p.dtype != torch.int64 or table.sb_h.dtype != torch.int64:
        raise TypeError("probe: hashes must be int64")
    if not h_p.is_cuda:
        return probe_plain(table, h_p)
    h_p = h_p.contiguous()
    nk.require_cuda("probe", [h_p, table.sb_h, table.part],
                    [torch.int64, torch.int64, torch.int32])
    n = h_p.shape[0]
    lo = torch.empty(n, dtype=torch.int32, device=h_p.device)
    cnt = torch.empty(n, dtype=torch.int32, device=h_p.device)
    if n == 0:
        return lo, cnt
    lib = nk.load("join")
    nk.check(lib.srt_k3_probe(
        table.sb_h.data_ptr(), table.sb_h.shape[0], table.part.data_ptr(),
        table.table_bits, h_p.data_ptr(), n, lo.data_ptr(), cnt.data_ptr(),
        nk.stream_handle(h_p.device)), "probe")
    nk.LAUNCHES["probe"] += 1
    return lo, cnt
