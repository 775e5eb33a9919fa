"""Math expressions (the counterpart of
spark_rapids_tpu/expressions/math.py): sqrt, cbrt, the exponentials,
logarithms, trigonometric and hyperbolic functions, degrees, radians,
rint, floor, ceil, pow, the two-argument log, atan2 and round.

Each is an elementwise tensor operation over float64 (floor, ceil and
round of an integral input give integers). A subnormal operand counts as
a zero of its sign, as on the reference's XLA backend, where XLA does
so (its approximations of the ``incompat`` functions mostly read and
give one as it is; the flags on each class say which). ``incompat``
marks the functions whose results the reference lets differ from
java.lang.Math in the last bits: they run only with
``rapids.tpu.sql.incompatibleOps.enabled`` (``plan/overrides``), and
torch's implementations differ from XLA's in the last bits too (ROADMAP
Queue C). Sqrt, floor, ceil, rint and round are exact, so bit-equal to
the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.column import Scalar
from spark_rapids_tpu_torch.expressions.arithmetic import (_scalar_result,
                                                           eval_unary,
                                                           on_host)
from spark_rapids_tpu_torch.expressions.base import (
    ColV, EvalContext, EvalValue, Expression, and_validity, operand,
    value_validity)
from spark_rapids_tpu_torch.ops.sortkeys import flush_subnormals


def _f64(x: torch.Tensor) -> torch.Tensor:
    return flush_subnormals(x.to(torch.float64))


class _UnaryMathF64(Expression):
    incompat = False

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        return dt.FLOAT64

    @staticmethod
    def fn(x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    #: where the function counts a subnormal as a zero: its operand,
    #: its result (the exact functions: both; XLA's approximations read
    #: and give one as it is, but for the logs' operands and the results
    #: of the functions ``_FLUSH_OUT`` lists)
    flush_in = flush_out = True

    def eval(self, ctx):
        def f(x):
            x = x.to(torch.float64)
            y = self.fn(flush_subnormals(x) if self.flush_in else x)
            return flush_subnormals(y) if self.flush_out else y
        return eval_unary(self, ctx, f, dt.FLOAT64)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """The real cube root: a power, then two Newton steps (within an ulp
    of the true root; XLA's is up to 101 ulps off, ROADMAP Queue C)."""
    a = x.abs()
    y = torch.pow(a, 1.0 / 3.0)
    for _ in range(2):
        y = torch.where((a > 0) & torch.isfinite(a),
                        y - (y * y * y - a) / (3.0 * y * y), y)
    return torch.copysign(y, x)


_FLUSH_IN = ("Log", "Log2", "Log10")
_FLUSH_OUT = ("Log1p", "Asin", "Atan", "Sinh", "Tanh", "Asinh", "Atanh")


def _unary(name, fn, incompat=True, doc=None):
    cls = type(name, (_UnaryMathF64,), {
        "fn": staticmethod(fn), "incompat": incompat,
        "flush_in": not incompat or name in _FLUSH_IN,
        "flush_out": not incompat or name in _FLUSH_OUT})
    cls.__doc__ = doc
    return cls


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root: CUDA's; on the CPU numpy's
    (torch's vectorized CPU sqrt misses the nearest double for some
    inputs)."""
    if on_host(x):
        with np.errstate(invalid="ignore"):
            return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


Sqrt = _unary("Sqrt", _sqrt, False, "sqrt(x), correctly rounded")
Cbrt = _unary("Cbrt", _cbrt, False, "cbrt(x), within an ulp")
Exp = _unary("Exp", torch.exp)
Expm1 = _unary("Expm1", torch.expm1)
Log = _unary("Log", torch.log)
Log1p = _unary("Log1p", torch.log1p)
Log2 = _unary("Log2", torch.log2)
Log10 = _unary("Log10", torch.log10)
Sin = _unary("Sin", torch.sin)
Cos = _unary("Cos", torch.cos)
Tan = _unary("Tan", torch.tan)
Asin = _unary("Asin", torch.asin)
Acos = _unary("Acos", torch.acos)
Atan = _unary("Atan", torch.atan)
Sinh = _unary("Sinh", torch.sinh)
Cosh = _unary("Cosh", torch.cosh)
Tanh = _unary("Tanh", torch.tanh)
Asinh = _unary("Asinh", torch.asinh)
Acosh = _unary("Acosh", torch.acosh)
Atanh = _unary("Atanh", torch.atanh)
Cot = _unary("Cot", lambda x: flush_subnormals(1.0 / flush_subnormals(
    torch.tan(x))))
ToDegrees = _unary("ToDegrees", lambda x: x * (180.0 / math.pi), False)
ToRadians = _unary("ToRadians", lambda x: x * (math.pi / 180.0), False)
Rint = _unary("Rint", torch.round, False,
              "rint(x): to the nearest integer, ties to even")


def java_f64_to_i64(y: torch.Tensor) -> torch.Tensor:
    """Java's (long) cast: NaN is 0, and values clamp at the long limits
    (a bare conversion of an out-of-range float is undefined)."""
    hi = y >= 9.223372036854776e18  # 2^63
    lo = y <= -9.223372036854776e18
    nan = torch.isnan(y)
    safe = torch.where(hi | lo | nan, torch.zeros_like(y), y).to(
        torch.int64)
    safe = torch.where(hi, torch.full_like(safe, 2 ** 63 - 1), safe)
    return torch.where(lo, torch.full_like(safe, -2 ** 63), safe)


class _Rounding(Expression):
    """floor / ceil: a bigint of the double's floor or ceiling."""

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        return dt.INT64

    @staticmethod
    def fn(x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def eval(self, ctx):
        return eval_unary(self, ctx,
                          lambda x: java_f64_to_i64(self.fn(_f64(x))),
                          dt.INT64)


class Floor(_Rounding):
    fn = staticmethod(torch.floor)


class Ceil(_Rounding):
    fn = staticmethod(torch.ceil)


class _BinaryMathF64(Expression):
    incompat = True

    def __init__(self, left: Expression, right: Expression):
        super().__init__([left, right])

    @property
    def dtype(self):
        return dt.FLOAT64

    @staticmethod
    def fn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    #: as ``_UnaryMathF64``'s: the operands of the two-argument log,
    #: the result of atan2
    flush_in = flush_out = False

    def eval(self, ctx: EvalContext) -> EvalValue:
        a = self.children[0].eval(ctx)
        b = self.children[1].eval(ctx)
        if (isinstance(a, Scalar) and a.is_null) or \
                (isinstance(b, Scalar) and b.is_null):
            return Scalar(dt.FLOAT64, None)
        x, y = (operand(v).to(torch.float64) for v in (a, b))
        if self.flush_in:
            x, y = flush_subnormals(x), flush_subnormals(y)
        data = self.fn(x, y)
        if self.flush_out:
            data = flush_subnormals(data)
        if isinstance(a, Scalar) and isinstance(b, Scalar):
            return _scalar_result(dt.FLOAT64, data)
        return ColV(dt.FLOAT64, data.expand(ctx.num_rows).contiguous(),
                    and_validity(value_validity(a), value_validity(b)))


class Pow(_BinaryMathF64):
    fn = staticmethod(torch.pow)


class Logarithm(_BinaryMathF64):
    """``log(base, x)``: ln x / ln base."""

    flush_in = True

    @staticmethod
    def fn(b, x):
        return torch.log(x) / torch.log(b)


class Atan2(_BinaryMathF64):
    fn = staticmethod(torch.atan2)
    flush_out = True


class Round(Expression):
    """ROUND(x[, scale]), half away from zero (Java's HALF_UP). A double
    result for a float input; an integral input keeps its type and is
    unchanged at scale >= 0. As the reference's program computes it:
    ``s = x * 10^scale``, then ``floor(s + 0.5)`` or ``ceil(s - 0.5)``
    by the sign of s, then the product by the reciprocal of the power
    (XLA's rewrite of a division by a constant); ``x * 1`` and ``r / 1``
    are no operations at scale 0."""

    def __init__(self, child: Expression, scale: int = 0):
        super().__init__([child])
        self.scale = int(scale)

    @property
    def dtype(self):
        ct = self.children[0].dtype
        return ct if ct.is_integral else dt.FLOAT64

    def _round(self, x: torch.Tensor) -> torch.Tensor:
        in_t = self.children[0].dtype
        if in_t.is_integral and self.scale >= 0:
            return x
        p = np.float64(10.0) ** np.float64(self.scale)
        x = x.to(torch.float64)
        scaled = x if p == 1.0 else flush_subnormals(_f64(x) * float(p))
        fs = flush_subnormals(scaled)
        r = torch.where(fs >= 0, torch.floor(flush_subnormals(fs + 0.5)),
                        torch.ceil(flush_subnormals(fs - 0.5)))
        if p != 1.0:
            r = flush_subnormals(r * float(np.float64(1.0) / p))
        if in_t.is_integral:
            return java_f64_to_i64(r).to(in_t.torch_dtype)
        return r

    def eval(self, ctx):
        return eval_unary(self, ctx, self._round, self.dtype)
