"""Arithmetic (the counterpart of spark_rapids_tpu/expressions/arithmetic.py):
add, subtract, multiply and divide with Spark's non-ANSI semantics. The
result is null where either side is null; division by zero is null and
always yields a double; integer overflow wraps.

Float arithmetic follows the reference's XLA backends on subnormals: an
operand and a result that are subnormal count as a zero of their sign
(``ops.sortkeys.flush_subnormals``), so ``1e-310 * 2.0`` is ``0.0`` and
``1.0 / 1e-310`` divides by zero (null). Two literals are computed as
they are, as XLA's constant folder does. What XLA rewrites before it
runs (literal chains, division by a literal, identities, fused
multiply-adds) is rewritten once per plan by ``expressions.folding``,
which makes the ``Identity``, ``Constant``, ``Zero`` and ``MultiplyAdd``
nodes below.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.column import Scalar
from spark_rapids_tpu_torch.expressions.base import (
    ColV, EvalContext, EvalValue, Expression, and_validity, operand,
    value_validity)
from spark_rapids_tpu_torch.ops.sortkeys import flush_subnormals


def _scalar_result(t: dt.DType, x: torch.Tensor) -> Scalar:
    v = x.item()
    return Scalar(t, float(v) if t.is_floating else int(v))


class BinaryArithmetic(Expression):
    def __init__(self, left: Expression, right: Expression):
        super().__init__([left, right])

    @property
    def dtype(self) -> dt.DType:
        return dt.common_type(self.children[0].dtype, self.children[1].dtype)

    @staticmethod
    def fn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def eval(self, ctx: EvalContext) -> EvalValue:
        a = self.children[0].eval(ctx)
        b = self.children[1].eval(ctx)
        t = self.dtype
        if (isinstance(a, Scalar) and a.is_null) or \
                (isinstance(b, Scalar) and b.is_null):
            return Scalar(t, None)
        kt = t.torch_dtype
        if isinstance(a, Scalar) and isinstance(b, Scalar):
            return _scalar_result(t, self.fn(operand(a).to(kt),
                                             operand(b).to(kt)))
        validity = and_validity(value_validity(a), value_validity(b))
        if not t.is_floating:
            return ColV(t, self.fn(operand(a).to(kt), operand(b).to(kt)),
                        validity)
        data = flush_subnormals(self.fn(flush_subnormals(operand(a).to(kt)),
                                        flush_subnormals(operand(b).to(kt))))
        return ColV(t, data, validity)


class Add(BinaryArithmetic):
    fn = staticmethod(lambda a, b: a + b)


class Subtract(BinaryArithmetic):
    fn = staticmethod(lambda a, b: a - b)


class Multiply(BinaryArithmetic):
    fn = staticmethod(lambda a, b: a * b)


class Divide(Expression):
    """Spark Divide: a double result; x / 0 is null (the reference's
    ``_DivLike`` with a float64 quotient). A subnormal divisor counts as
    zero. ``Divide(a, b, c, ...)``, which ``expressions.folding`` makes
    of ``(a / b) / c``, divides once by the product of the divisors, as
    XLA computes it, and is null where any divisor is zero."""

    def __init__(self, left: Expression, *divisors: Expression):
        super().__init__([left, *divisors])

    @property
    def dtype(self) -> dt.DType:
        return dt.FLOAT64

    def eval(self, ctx: EvalContext) -> EvalValue:
        vals = [c.eval(ctx) for c in self.children]
        if any(isinstance(v, Scalar) and v.is_null for v in vals):
            return Scalar(dt.FLOAT64, None)
        if all(isinstance(v, Scalar) for v in vals):
            if any(v.value == 0 for v in vals[1:]):
                return Scalar(dt.FLOAT64, None)
            q = operand(vals[0]).to(torch.float64)
            for v in vals[1:]:
                q = q / operand(v).to(torch.float64)
            return _scalar_result(dt.FLOAT64, q)
        validity = and_validity(*(value_validity(v) for v in vals))
        divisor = None
        for v in vals[1:]:
            bd = flush_subnormals(operand(v).to(torch.float64))
            nonzero = bd != 0
            safe = torch.where(nonzero, bd, torch.ones_like(bd))
            divisor = safe if divisor is None else \
                flush_subnormals(divisor * safe)
            nonzero = nonzero.to(ctx.device).expand(ctx.num_rows)
            validity = nonzero if validity is None else validity & nonzero
        data = flush_subnormals(
            flush_subnormals(operand(vals[0]).to(torch.float64)) / divisor)
        return ColV(dt.FLOAT64, data.expand(ctx.num_rows).contiguous(),
                    validity)


def _nulls(vals) -> Tuple[bool, Optional[torch.Tensor]]:
    """(any value a null scalar, the AND of the columns' validities)."""
    if any(isinstance(v, Scalar) and v.is_null for v in vals):
        return True, None
    return False, and_validity(*(value_validity(v) for v in vals))


class Identity(Expression):
    """What XLA leaves of ``x + 0`` and ``x * 1``: x converted to the
    operation's type and untouched, subnormals and -0.0 included; with
    ``negate``, what LLVM makes of ``x * -1`` and ``-0.0 - x``: -x. The
    rows of ``nulls_of`` (the zero of ``x + (i - i)``) are null where
    they are: XLA drops the zero from the data, not from the validity."""

    def __init__(self, child: Expression, dtype: dt.DType,
                 negate: bool = False,
                 nulls_of: Sequence[Expression] = ()):
        super().__init__([child, *nulls_of])
        self._dtype = dtype
        self.negate = negate

    @property
    def dtype(self) -> dt.DType:
        return self._dtype

    def eval(self, ctx: EvalContext) -> EvalValue:
        vals = [c.eval(ctx) for c in self.children]
        null, validity = _nulls(vals)
        if null:
            return Scalar(self._dtype, None)
        v = vals[0]
        data = operand(v).to(self._dtype.torch_dtype)
        if self.negate:
            data = -data
        if all(isinstance(x, Scalar) for x in vals):
            return _scalar_result(self._dtype, data)
        if isinstance(v, Scalar):
            data = data.expand(ctx.num_rows).contiguous()
        return ColV(self._dtype, data, validity)


class Constant(Expression):
    """What XLA makes of a literal combined with an integer zero
    (``-0.0 - (i * 0)``): the constant ``value`` of ``dtype`` in the
    data, null where any of ``sources`` is null (the reference keeps the
    validity apart from the folded data)."""

    def __init__(self, dtype: dt.DType, sources: Sequence[Expression],
                 value):
        super().__init__(sources)
        self._dtype = dtype
        self.value = value

    @property
    def dtype(self) -> dt.DType:
        return self._dtype

    def eval(self, ctx: EvalContext) -> EvalValue:
        null, validity = _nulls([c.eval(ctx) for c in self.children])
        if null:
            return Scalar(self._dtype, None)
        if validity is None:
            return Scalar(self._dtype, self.value)
        return ColV(self._dtype, torch.full(
            (ctx.num_rows,), self.value, dtype=self._dtype.torch_dtype,
            device=ctx.device), validity)


class Zero(Constant):
    """What XLA makes of integer ``x - x`` and ``x * 0``: a zero of
    ``dtype`` in the data, null where any of ``sources`` is null."""

    def __init__(self, dtype: dt.DType, sources: Sequence[Expression]):
        super().__init__(dtype, sources, 0)


class MultiplyAdd(Expression):
    """``product_sign * a * b + addend_sign * c`` rounded once: the fused
    multiply-add the reference's XLA backend makes of a float product
    that feeds ``+`` or ``-``. Operands and the result count a subnormal
    as a zero of its sign, as the separate operations do."""

    def __init__(self, a: Expression, b: Expression, c: Expression,
                 dtype: dt.DType, product_sign: int = 1,
                 addend_sign: int = 1):
        super().__init__([a, b, c])
        self._dtype = dtype
        self.product_sign = product_sign
        self.addend_sign = addend_sign

    @property
    def dtype(self) -> dt.DType:
        return self._dtype

    def eval(self, ctx: EvalContext) -> EvalValue:
        vals = [c.eval(ctx) for c in self.children]
        if any(isinstance(v, Scalar) and v.is_null for v in vals):
            return Scalar(self._dtype, None)
        kt = self._dtype.torch_dtype
        # a literal as a 0-d tensor on the batch's device (addcmul takes
        # no CPU scalar beside CUDA tensors)
        a, b, c = (flush_subnormals(
            torch.full((), v.value, dtype=kt, device=ctx.device)
            if isinstance(v, Scalar) else v.data.to(kt)) for v in vals)
        if self.addend_sign < 0:
            c = -c
        if self.product_sign < 0:
            a = -a
        # value=1 only: on the card (torch 2.11, CUDA 12.8) addcmul with
        # value=-1 rounded a * b before the add, so an operand carries
        # the sign (negation is exact)
        data = flush_subnormals(torch.addcmul(c, a, b))
        if all(isinstance(v, Scalar) for v in vals):
            return _scalar_result(self._dtype, data)
        validity = and_validity(*(value_validity(v) for v in vals))
        return ColV(self._dtype, data, validity)


def eval_unary(expr: Expression, ctx: EvalContext, fn,
               out_t: dt.DType) -> EvalValue:
    """``fn`` over the child's data (a scalar as a 0-d tensor): null in,
    null out; a scalar in, a scalar out."""
    v = expr.children[0].eval(ctx)
    if isinstance(v, Scalar):
        if v.is_null:
            return Scalar(out_t, None)
        return _scalar_result(out_t, fn(operand(v)).to(out_t.torch_dtype))
    return ColV(out_t, fn(v.data).to(out_t.torch_dtype), v.validity)


class _DivLike(Expression):
    """A division-like operation (the reference's ``_DivLike``): null
    where the divisor is zero (a subnormal divisor counts as zero), and
    the divisor made safe (1) there before the operation."""

    def __init__(self, left: Expression, right: Expression):
        super().__init__([left, right])

    def op(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def eval(self, ctx: EvalContext) -> EvalValue:
        a = self.children[0].eval(ctx)
        b = self.children[1].eval(ctx)
        out = self.dtype
        if (isinstance(a, Scalar) and a.is_null) or \
                (isinstance(b, Scalar) and b.is_null):
            return Scalar(out, None)
        ad, bd = operand(a), operand(b)
        # a literal divisor's test is folded before the program runs,
        # with no flush to zero
        nonzero = (bd if isinstance(b, Scalar) else
                   flush_subnormals(bd)) != 0
        safe = torch.where(nonzero, bd, torch.ones_like(bd))
        data = self.op(ad, safe).to(out.torch_dtype)
        if isinstance(a, Scalar) and isinstance(b, Scalar):
            return Scalar(out, None) if not bool(nonzero) else \
                _scalar_result(out, data)
        validity = and_validity(value_validity(a), value_validity(b))
        nonzero = nonzero.to(ctx.device).expand(ctx.num_rows)
        validity = nonzero if validity is None else validity & nonzero
        return ColV(out, data.expand(ctx.num_rows).contiguous(), validity)


def _int_safe(b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(b == -1, b with -1 made 1): ``MIN % -1`` and ``MIN / -1`` are
    the one quotient that overflows; XLA defines them (0 and MIN), a
    CPU's integer division traps."""
    neg1 = b == -1
    return neg1, torch.where(neg1, torch.ones_like(b), b)


def on_host(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def _fmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The truncated remainder (Java's ``%``: the sign of the dividend),
    with ``MIN % -1`` = 0. A float remainder is exact, of the dividend as
    it is, and NaN for a subnormal divisor, as the reference's libm call
    reads it under the XLA backend's flush-to-zero. torch's vectorized
    CPU fmod is not exact (a huge quotient gives NaN), so a CPU tensor's
    goes through numpy's libm call; CUDA's fmod is exact."""
    if a.is_floating_point():
        b = flush_subnormals(b)
        if on_host(a) and on_host(b):
            a, b = torch.broadcast_tensors(a, b)
            with np.errstate(invalid="ignore"):
                return torch.from_numpy(np.fmod(a.numpy(), b.numpy()))
        return torch.fmod(a, b)
    _, safe = _int_safe(b)
    return torch.fmod(a, safe)


class IntegralDivide(_DivLike):
    """``div``: a bigint quotient truncated toward zero; ``MIN div -1``
    wraps to MIN."""

    @property
    def dtype(self) -> dt.DType:
        return dt.INT64

    def op(self, a, b):
        a, b = a.to(torch.int64), b.to(torch.int64)
        neg1, safe = _int_safe(b)
        q = torch.div(a, safe, rounding_mode="trunc")
        return torch.where(neg1, -a, q)


class Remainder(_DivLike):
    """``%``: the truncated remainder in the operands' common type, the
    sign of the dividend (also right for infinite operands)."""

    @property
    def dtype(self) -> dt.DType:
        return dt.common_type(self.children[0].dtype,
                              self.children[1].dtype)

    def op(self, a, b):
        kt = self.dtype.torch_dtype
        return _fmod(a.to(kt), b.to(kt))


class Pmod(_DivLike):
    """``pmod(a, n)``: ``r = a % n``, and ``(r + n) % n`` where r < 0,
    with Java's wrap-around on ``r + n`` at the integer limits. The
    comparison and the add count a subnormal as a zero of its sign, as
    the reference's XLA backend does."""

    @property
    def dtype(self) -> dt.DType:
        return dt.common_type(self.children[0].dtype,
                              self.children[1].dtype)

    def op(self, a, b):
        kt = self.dtype.torch_dtype
        a, b = a.to(kt), b.to(kt)
        r = _fmod(a, b)
        fr, fb = flush_subnormals(r), flush_subnormals(b)
        return torch.where(fr < 0, _fmod(flush_subnormals(fr + fb), b), r)


class UnaryMinus(Expression):
    """``-x``: integers wrap; a float's sign flips, subnormals kept."""

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self) -> dt.DType:
        return self.children[0].dtype

    def eval(self, ctx):
        return eval_unary(self, ctx, torch.neg, self.dtype)


class UnaryPositive(Expression):
    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self) -> dt.DType:
        return self.children[0].dtype

    def eval(self, ctx):
        return self.children[0].eval(ctx)


class Abs(Expression):
    """``abs(x)``: integers wrap at MIN; a float's sign bit cleared."""

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self) -> dt.DType:
        return self.children[0].dtype

    def eval(self, ctx):
        return eval_unary(self, ctx, torch.abs, self.dtype)


class Signum(Expression):
    """``signum(x)``: -1.0, 1.0, or x itself for a zero (its sign kept,
    a subnormal a zero) and NaN, as a double."""

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self) -> dt.DType:
        return dt.FLOAT64

    def eval(self, ctx):
        def sign(x):
            x = flush_subnormals(x.to(torch.float64))
            return torch.where((x == 0) | torch.isnan(x), x, torch.sign(x))
        return eval_unary(self, ctx, sign, dt.FLOAT64)
