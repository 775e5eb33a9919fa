"""Logical SQL types and their torch encodings (the counterpart of
spark_rapids_tpu/columnar/dtypes.py).

DATE is int32 days since the epoch, TIMESTAMP int64 microseconds (UTC),
STRING int32 codes into a sorted host dictionary (columnar/column.py), so
code order is string order and every relational kernel stays numeric.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DType:
    """A logical SQL type; ``torch_dtype`` is its physical encoding.
    Types are compared by identity."""

    name: str
    torch_dtype: torch.dtype
    is_floating: bool = False
    is_integral: bool = False

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return self.name

    @property
    def np_dtype(self) -> np.dtype:
        return _NP[self.torch_dtype]


_NP = {torch.bool: np.dtype(np.bool_), torch.int8: np.dtype(np.int8),
       torch.int16: np.dtype(np.int16), torch.int32: np.dtype(np.int32),
       torch.int64: np.dtype(np.int64), torch.float32: np.dtype(np.float32),
       torch.float64: np.dtype(np.float64)}

BOOLEAN = DType("boolean", torch.bool)
INT8 = DType("tinyint", torch.int8, is_integral=True)
INT16 = DType("smallint", torch.int16, is_integral=True)
INT32 = DType("int", torch.int32, is_integral=True)
INT64 = DType("bigint", torch.int64, is_integral=True)
FLOAT32 = DType("float", torch.float32, is_floating=True)
FLOAT64 = DType("double", torch.float64, is_floating=True)
DATE = DType("date", torch.int32)
TIMESTAMP = DType("timestamp", torch.int64)
STRING = DType("string", torch.int32)

ALL_TYPES = [BOOLEAN, INT8, INT16, INT32, INT64, FLOAT32, FLOAT64, DATE,
             TIMESTAMP, STRING]
_BY_NAME = {t.name: t for t in ALL_TYPES}


def by_name(name: str) -> DType:
    """The port's type of the same name (reference types map by name)."""
    return _BY_NAME[name]


def from_numpy(np_dtype) -> DType:
    d = np.dtype(np_dtype)
    if d.kind in "OUS":
        return STRING
    mapping = {np.dtype(np.bool_): BOOLEAN, np.dtype(np.int8): INT8,
               np.dtype(np.int16): INT16, np.dtype(np.int32): INT32,
               np.dtype(np.int64): INT64, np.dtype(np.float32): FLOAT32,
               np.dtype(np.float64): FLOAT64}
    if d in mapping:
        return mapping[d]
    raise TypeError(f"cannot infer a DType from numpy dtype {d}")


def common_type(a: DType, b: DType) -> DType:
    """Numeric promotion for binary expressions (the reference's
    ``common_type``: the wider of the two, int64 with float32 widening
    to float64)."""
    if a is b:
        return a
    order = {INT8: 0, INT16: 1, INT32: 2, INT64: 3, FLOAT32: 4, FLOAT64: 5}
    if a in order and b in order:
        if {a, b} == {INT64, FLOAT32}:
            return FLOAT64
        return a if order[a] >= order[b] else b
    raise TypeError(f"no common type for {a} and {b}")


def null_sentinel(t: DType):
    """Value stored in null slots (kernels consult validity; the sentinel
    only keeps gathers in bounds and values tame)."""
    if t.is_floating:
        return np.nan
    if t is BOOLEAN:
        return False
    return 0
