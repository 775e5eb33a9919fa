"""Arithmetic (the counterpart of spark_rapids_tpu/expressions/arithmetic.py):
add, subtract, multiply and divide with Spark's non-ANSI semantics. The
result is null where either side is null; division by zero is null and
always yields a double; integer overflow wraps.

Float arithmetic follows the reference's XLA backends on subnormals: an
operand and a result that are subnormal count as a zero of their sign
(``ops.sortkeys.flush_subnormals``), so ``1e-310 * 2.0`` is ``0.0`` and
``1.0 / 1e-310`` divides by zero (null). What XLA folds away before it
runs keeps its value unflushed: two literals are computed as they are,
and a literal that makes the operation an identity returns the other
side untouched (``x + 0.0``, ``0.0 + x``, ``x - 0.0``, ``x * 1.0``,
``1.0 * x``, ``x / 1.0``; a zero of either sign) or negated (``x * -1.0``,
``-1.0 * x``, ``x / -1.0``).
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def _folded(a: EvalValue, b: EvalValue, kt: torch.dtype,
            identity: Tuple, negation: Tuple, commutes: bool
            ) -> Optional[torch.Tensor]:
    """The column side of ``a op b``, untouched or negated, when the other
    side is a literal that makes ``op`` an identity or a negation (XLA's
    algebraic simplification); else None."""
    if isinstance(b, Scalar):
        column, literal = a, b.value
    elif commutes and isinstance(a, Scalar):
        column, literal = b, a.value
    else:
        return None
    if isinstance(literal, bool):
        return None
    if literal in identity:
        return column.data.to(kt)
    if literal in negation:
        return -column.data.to(kt)
    return None


class BinaryArithmetic(Expression):
    #: literal values c with ``x op c`` == x, and with ``x op c`` == -x
    identity: Tuple = ()
    negation: Tuple = ()
    #: whether ``c op x`` folds as ``x op c`` does
    commutes = True

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
        data = _folded(a, b, kt, self.identity, self.negation, self.commutes)
        if data is None:
            data = flush_subnormals(self.fn(
                flush_subnormals(operand(a).to(kt)),
                flush_subnormals(operand(b).to(kt))))
        return ColV(t, data, validity)


class Add(BinaryArithmetic):
    identity = (0,)
    fn = staticmethod(lambda a, b: a + b)


class Subtract(BinaryArithmetic):
    identity = (0,)
    commutes = False
    fn = staticmethod(lambda a, b: a - b)


class Multiply(BinaryArithmetic):
    identity = (1,)
    negation = (-1,)
    fn = staticmethod(lambda a, b: a * b)


class Divide(Expression):
    """Spark Divide: a double result; x / 0 is null (the reference's
    ``_DivLike`` with a float64 quotient). A subnormal divisor counts as
    zero."""

    def __init__(self, left: Expression, right: Expression):
        super().__init__([left, right])

    @property
    def dtype(self) -> dt.DType:
        return dt.FLOAT64

    def eval(self, ctx: EvalContext) -> EvalValue:
        a = self.children[0].eval(ctx)
        b = self.children[1].eval(ctx)
        if (isinstance(a, Scalar) and a.is_null) or \
                (isinstance(b, Scalar) and b.is_null):
            return Scalar(dt.FLOAT64, None)
        if isinstance(a, Scalar) and isinstance(b, Scalar):
            if b.value == 0:
                return Scalar(dt.FLOAT64, None)
            return _scalar_result(dt.FLOAT64, operand(a).to(torch.float64) /
                                  operand(b).to(torch.float64))
        validity = and_validity(value_validity(a), value_validity(b))
        folded = _folded(a, b, torch.float64, (1,), (-1,), False)
        if folded is not None:
            return ColV(dt.FLOAT64, folded, validity)
        ad = flush_subnormals(operand(a).to(torch.float64))
        bd = flush_subnormals(operand(b).to(torch.float64))
        nonzero = bd != 0
        data = flush_subnormals(ad / torch.where(nonzero, bd,
                                                 torch.ones_like(bd)))
        n = ctx.num_rows
        nonzero = nonzero.to(data.device).expand(n)
        validity = nonzero if validity is None else validity & nonzero
        return ColV(dt.FLOAT64, data.expand(n).contiguous(), validity)
