"""Arithmetic (the counterpart of spark_rapids_tpu/expressions/arithmetic.py):
add, subtract, multiply and divide with Spark's non-ANSI semantics. The
result is null where either side is null; division by zero is null and
always yields a double; integer overflow wraps."""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.column import Scalar
from spark_rapids_tpu_torch.expressions.base import (
    ColV, EvalContext, EvalValue, Expression, and_validity, operand,
    value_validity)


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
        data = self.fn(operand(a).to(kt), operand(b).to(kt))
        if isinstance(a, Scalar) and isinstance(b, Scalar):
            return _scalar_result(t, data)
        return ColV(t, data, and_validity(value_validity(a),
                                          value_validity(b)))


class Add(BinaryArithmetic):
    fn = staticmethod(lambda a, b: a + b)


class Subtract(BinaryArithmetic):
    fn = staticmethod(lambda a, b: a - b)


class Multiply(BinaryArithmetic):
    fn = staticmethod(lambda a, b: a * b)


class Divide(Expression):
    """Spark Divide: a double result; x / 0 is null (the reference's
    ``_DivLike`` with a float64 quotient)."""

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
        ad = operand(a).to(torch.float64)
        bd = operand(b).to(torch.float64)
        nonzero = bd != 0
        data = ad / torch.where(nonzero, bd, torch.ones_like(bd))
        validity = and_validity(value_validity(a), value_validity(b))
        n = ctx.num_rows
        nonzero = nonzero.to(data.device).expand(n)
        validity = nonzero if validity is None else validity & nonzero
        return ColV(dt.FLOAT64, data.expand(n).contiguous(), validity)
