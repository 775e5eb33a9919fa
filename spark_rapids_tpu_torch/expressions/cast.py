"""Cast (the counterpart of spark_rapids_tpu/expressions/cast.py), with
Spark's non-ANSI semantics.

Casts between numbers, booleans, dates and timestamps run on the device:
a float to an integer is Java's ``(long)double`` (NaN is 0, out of range
saturates, the rest truncates), tested by explicit range comparisons
rather than clipping, since ``float(max)`` of a 64-bit type rounds up.
String casts work once per dictionary entry on the host (parse or
format), cached per dictionary object, then gather by code on the
device. A cast of a literal is a literal (``_cast_scalar``).
"""
from __future__ import annotations

import datetime

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.column import (Scalar, StringColumn,
                                                    dictionary_cache)
from spark_rapids_tpu_torch.expressions.base import (ColV, EvalContext,
                                                     EvalValue, Expression)
from spark_rapids_tpu_torch.ops.sortkeys import flush_subnormals

_US_PER_DAY = 86_400_000_000
_EPOCH = datetime.date(1970, 1, 1)


class Cast(Expression):
    def __init__(self, child: Expression, to: dt.DType, ansi: bool = False):
        super().__init__([child])
        self.to = to
        self.ansi = ansi

    @property
    def dtype(self) -> dt.DType:
        return self.to

    @property
    def device_only(self) -> bool:
        if self.children[0].dtype is dt.STRING or self.to is dt.STRING:
            return False
        return super().device_only

    def eval(self, ctx: EvalContext) -> EvalValue:
        src = self.children[0].dtype
        v = self.children[0].eval(ctx)
        if src is self.to:
            return v
        if isinstance(v, Scalar):
            return _cast_scalar(v, src, self.to)
        if src is dt.STRING:
            return _cast_from_string(v, self.to)
        if self.to is dt.STRING:
            return _cast_to_string(v, src)
        return ColV(self.to, _device_cast(v.data, src, self.to), v.validity)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Cast({self.children[0]!r} AS {self.to})"


def _cast_scalar(v: Scalar, src: dt.DType, to: dt.DType) -> Scalar:
    if v.is_null:
        return Scalar(to, None)
    if src is dt.STRING:
        val, ok = _parse_one(str(v.value), to)
        return Scalar(to, val if ok else None)
    if to is dt.STRING:
        return Scalar(dt.STRING, _format_one(v.value, src))
    out = _device_cast(torch.tensor([v.value], dtype=src.torch_dtype),
                       src, to)[0].item()
    if to is dt.BOOLEAN:
        return Scalar(to, bool(out))
    return Scalar(to, float(out) if to.is_floating else int(out))


# -- device casts -------------------------------------------------------------


def _device_cast(data: torch.Tensor, src: dt.DType, to: dt.DType
                 ) -> torch.Tensor:
    kd = to.torch_dtype
    if src is dt.BOOLEAN:
        return data.to(kd)
    if to is dt.BOOLEAN:
        # a subnormal is a zero to the reference's CPU backend (C1)
        return flush_subnormals(data) != 0
    if src is dt.DATE and to is dt.TIMESTAMP:
        return data.to(torch.int64) * _US_PER_DAY
    if src is dt.TIMESTAMP and to is dt.DATE:
        return torch.div(data, _US_PER_DAY,
                         rounding_mode="floor").to(torch.int32)
    if src.is_floating and (to.is_integral or to in (dt.DATE,
                                                       dt.TIMESTAMP)):
        info = torch.iinfo(kd)
        x = torch.trunc(torch.nan_to_num(data, nan=0.0))
        big = x >= float(info.max)
        small = x <= float(info.min)
        safe = torch.where(big | small, torch.zeros_like(x), x).to(kd)
        return torch.where(big, torch.full_like(safe, info.max),
                           torch.where(small, torch.full_like(safe, info.min),
                                       safe))
    if to.is_floating:
        # a subnormal operand and result are zeros of their sign to the
        # reference's CPU backend (C1), as float32 -> float64 shows
        return flush_subnormals(flush_subnormals(data).to(kd))
    return data.to(kd)


# -- string casts: once per dictionary entry ----------------------------------


def _parse_one(s: str, to: dt.DType):
    """(value, ok) of one string, as the reference parses it."""
    s = s.strip()
    try:
        if to is dt.BOOLEAN:
            ls = s.lower()
            if ls in ("t", "true", "y", "yes", "1"):
                return True, True
            if ls in ("f", "false", "n", "no", "0"):
                return False, True
            return None, False
        if to.is_integral:
            return int(s), True
        if to.is_floating:
            return float(s), True
        if to is dt.DATE:
            return (datetime.date.fromisoformat(s[:10]) - _EPOCH).days, True
        if to is dt.TIMESTAMP:
            x = datetime.datetime.fromisoformat(s)
            if x.tzinfo is None:
                x = x.replace(tzinfo=datetime.timezone.utc)
            return int(x.timestamp() * 1_000_000), True
    except (ValueError, OverflowError):
        return None, False
    return None, False


def _format_one(value, src: dt.DType) -> str:
    if src is dt.BOOLEAN:
        return "true" if value else "false"
    if src is dt.DATE:
        return (_EPOCH + datetime.timedelta(days=int(value))).isoformat()
    if src is dt.TIMESTAMP:
        x = datetime.datetime.fromtimestamp(value / 1_000_000,
                                            tz=datetime.timezone.utc)
        return x.strftime("%Y-%m-%d %H:%M:%S") + (
            f".{x.microsecond:06d}".rstrip("0") if x.microsecond else "")
    if src.is_floating:
        # Java's Double.toString, near enough (the reference's rule)
        f = float(value)
        if f != f:
            return "NaN"
        if f in (float("inf"), float("-inf")):
            return "Infinity" if f > 0 else "-Infinity"
        if f == int(f) and abs(f) < 1e16:
            return f"{f:.1f}"
        return repr(f)
    return str(int(value))


def _cast_from_string(v: ColV, to: dt.DType) -> ColV:
    """Each dictionary entry parsed once (a value that does not parse,
    or does not fit ``to``, is null), then a gather by code."""
    dic = v.scol.dictionary
    store = dictionary_cache(dic)
    key = ("cast", to.name, str(v.data.device))
    hit = store.get(key)
    if hit is None:
        vals = np.zeros(max(len(dic), 1), dtype=to.np_dtype)
        ok = np.zeros(max(len(dic), 1), dtype=bool)
        for i, s in enumerate(dic):
            val, good = _parse_one(str(s), to)
            if good:
                try:
                    vals[i] = val
                    ok[i] = True
                except (OverflowError, ValueError):
                    pass
        hit = store[key] = (torch.from_numpy(vals).to(v.data.device),
                            torch.from_numpy(ok).to(v.data.device))
    vals_t, ok_t = hit
    codes = v.data.to(torch.int64).clamp(0, len(vals_t) - 1)
    good = ok_t[codes]
    validity = good if v.validity is None else (v.validity & good)
    return ColV(to, vals_t[codes], validity)


def _distinct(raw: np.ndarray):
    """(the distinct values of ``raw``, each row's index among them);
    floats are told apart by bit pattern, so -0.0 formats as itself."""
    if raw.dtype.kind == "f":
        bits = raw.view(np.int64 if raw.itemsize == 8 else np.int32)
        _, first, inv = np.unique(bits, return_index=True,
                                  return_inverse=True)
        return raw[first], inv
    return np.unique(raw, return_inverse=True)


def _cast_to_string(v: ColV, src: dt.DType) -> ColV:
    """Each distinct value formatted once on the host, into a sorted
    dictionary; null rows keep code 0 under their validity."""
    raw = v.data.cpu().numpy()
    valid = None if v.validity is None else v.validity.cpu().numpy()
    live = raw if valid is None else raw[valid]
    values, inv = _distinct(live)
    # numpy scalars, as the reference formats them (an int64 timestamp
    # divides as a float64, not as an exact Python quotient)
    text = np.array([_format_one(x, src) for x in values], dtype=object)
    dictionary, pos = np.unique(text.astype(str), return_inverse=True)
    codes = np.zeros(len(raw), dtype=np.int32)
    if valid is None:
        codes[:] = pos[inv]
    else:
        codes[valid] = pos[inv]
    data = torch.from_numpy(codes).to(v.data.device)
    sc = StringColumn(data, dictionary.astype(object), v.validity)
    return ColV(dt.STRING, data, v.validity, sc)
