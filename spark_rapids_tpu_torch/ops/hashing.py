"""64-bit hashing of key columns (the counterpart of
spark_rapids_tpu/ops/hashing.py), bit-identical to the reference: the
join's build order follows these hashes.

Strings hash their content once per dictionary entry on the host
(FNV-1a) and gather by code on the device; NaN == NaN and -0.0 == 0.0
hash equal; mixing is splitmix64. torch has no usable uint64, so the
arithmetic runs on int64 bit patterns: constants above 2^63 are written
as their signed values, multiplication wraps the same way, and a logical
right shift is an arithmetic one masked to the remaining bits.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import (StringColumn,
                                                    dictionary_cache)
from spark_rapids_tpu_torch.ops import sortkeys

_NULL_HASH = 42  # Spark HashPartitioning leaves the seed for nulls

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3


def _signed(u: int) -> int:
    """int64 bit pattern of a uint64 constant."""
    return u - (1 << 64) if u >= (1 << 63) else u


_GOLDEN = _signed(0x9E3779B97F4A7C15)
_MIX1 = _signed(0xBF58476D1CE4E5B9)
_MIX2 = _signed(0x94D049BB133111EB)
_SEED = 0x2545F491
# canonical float32 quiet NaN (the bits the reference's CPU backend gives)
_F32_NAN_BITS = 0x7FC00000


def fnv1a64(s: str) -> int:
    """Deterministic string hash (host-side, per dictionary entry)."""
    h = _FNV_OFFSET
    for b in s.encode("utf-8"):
        h = ((h ^ b) * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    return _signed(h)


def dict_hashes(col: StringColumn) -> torch.Tensor:
    """int64 content hash per dictionary entry on the column's device,
    computed once per dictionary and device."""
    cache = dictionary_cache(col.dictionary)
    key = ("hashes", str(col.device))
    if key not in cache:
        h = np.array([fnv1a64(str(s)) for s in col.dictionary],
                     dtype=np.int64) \
            if len(col.dictionary) else np.zeros(1, dtype=np.int64)
        cache[key] = torch.from_numpy(h).to(col.device)
    return cache[key]


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _splitmix64(x: torch.Tensor) -> torch.Tensor:
    z = x + _GOLDEN
    z = (z ^ _lsr(z, 30)) * _MIX1
    z = (z ^ _lsr(z, 27)) * _MIX2
    return z ^ _lsr(z, 31)


def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 image of a float32's bits, every NaN as the canonical one
    (a float64 NaN narrowed on the card has other bits than on a CPU)."""
    bits = x.view(torch.int32).to(torch.int64)
    return torch.where(torch.isnan(x), torch.full_like(bits, _F32_NAN_BITS),
                       bits)


def _flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """A subnormal result becomes zero of its sign: what the reference's
    XLA backends give when a float64 narrows to float32."""
    return torch.where(x.abs() < torch.finfo(x.dtype).tiny, x * 0, x)


def _numeric_to_int64(data: torch.Tensor, dtype: dt.DType) -> torch.Tensor:
    """Deterministic int64 image of a value with NaN==NaN, -0.0==0.0.
    float64 splits into (float32 head, float32 residual), as the
    reference does, and each half contributes its 32 bits. The head is
    not canonicalized there, so a tiny negative value keeps a -0.0
    head; the residual is."""
    if dtype is dt.FLOAT64:
        x = sortkeys.canonicalize_floats(data)
        hi = _flush_subnormal(x.to(torch.float32))
        lo = sortkeys.canonicalize_floats(
            (x - hi.to(torch.float64)).to(torch.float32))
        return (_f32_bits(hi) << 32) | (_f32_bits(lo) & 0xFFFFFFFF)
    if dtype is dt.FLOAT32:
        return _f32_bits(sortkeys.canonicalize_floats(data))
    return data.to(torch.int64)


def hash_columns(batch: ColumnarBatch, key_ordinals: List[int],
                 dtypes: List[dt.DType]) -> torch.Tensor:
    """int64 combined hash of the key columns for every row."""
    vals = []
    for o in key_ordinals:
        c = batch.columns[o]
        if isinstance(c, StringColumn):
            h_tab = dict_hashes(c)
            val = h_tab[c.data.to(torch.int64).clamp(0, h_tab.shape[0] - 1)]
        else:
            val = _numeric_to_int64(c.data, dtypes[o])
        if c.validity is not None:
            val = torch.where(c.validity, val,
                              torch.full_like(val, _NULL_HASH))
        vals.append(val)
    return _combine(vals)


def _combine(vals: List[torch.Tensor]) -> torch.Tensor:
    h = torch.full_like(vals[0], _SEED)
    for v in vals:
        h = _splitmix64(h ^ v)
    return h
