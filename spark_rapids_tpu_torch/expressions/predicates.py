"""Predicates and boolean logic (the counterpart of
spark_rapids_tpu/expressions/predicates.py): the comparisons, the
null-safe ``<=>``, AND/OR with Spark's three-valued logic, NOT, IS
[NOT] NULL, isnan, IN and AtLeastNNonNulls.

A string column compares with a string literal in code space: the
literal's position in the column's sorted dictionary, on a doubled axis
(code * 2, or pos * 2 - 1 when the literal falls between entries), so
equality and order both hold without touching the strings on the device.
Two string columns compare after their dictionaries are unified.

Float operands of a comparison count a subnormal as a zero of its sign
(``ops.sortkeys.flush_subnormals``), as the reference's XLA backends do,
so ``1e-310 = 0.0`` holds as it does for a join or a GROUP BY. Two
literals compare as they are: the reference folds them as constants.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.column import (Scalar, StringColumn,
                                                    unify_dictionaries)
from spark_rapids_tpu_torch.expressions.base import (
    ColV, EvalContext, EvalValue, Expression, LeafExpression, Literal,
    and_validity, broadcast, operand, value_validity)
from spark_rapids_tpu_torch.ops.sortkeys import flush_subnormals


class _Comparison(Expression):
    op = None  # staticmethod on subclasses

    def __init__(self, left: Expression, right: Expression):
        super().__init__([left, right])

    @property
    def dtype(self) -> dt.DType:
        return dt.BOOLEAN

    @property
    def device_only(self) -> bool:
        # string comparisons unify dictionaries on the host
        return self.children[0].dtype is not dt.STRING and \
            super().device_only

    @staticmethod
    def _string_codes(a: EvalValue, b: EvalValue):
        """A string column against a string literal in doubled code
        space, or two string columns on one unified dictionary."""
        if not isinstance(a, Scalar) and not isinstance(b, Scalar):
            ua, ub = unify_dictionaries([
                StringColumn(a.data, a.scol.dictionary, a.validity),
                StringColumn(b.data, b.scol.dictionary, b.validity)])
            return (ColV(dt.STRING, ua.data, ua.validity, ua),
                    ColV(dt.STRING, ub.data, ub.validity, ub))
        scalar, colv = (a, b) if isinstance(a, Scalar) else (b, a)
        dic = colv.scol.dictionary
        keys = dic.astype(str) if len(dic) else np.array([], dtype=str)
        pos = int(np.searchsorted(keys, str(scalar.value)))
        exact = pos < len(dic) and str(dic[pos]) == str(scalar.value)
        a2 = ColV(dt.STRING, colv.data.to(torch.int64) * 2, colv.validity,
                  colv.scol)
        s2 = Scalar(dt.INT64, pos * 2 + (0 if exact else -1))
        return (s2, a2) if isinstance(a, Scalar) else (a2, s2)

    def eval(self, ctx: EvalContext) -> EvalValue:
        a = self.children[0].eval(ctx)
        b = self.children[1].eval(ctx)
        if (isinstance(a, Scalar) and a.is_null) or \
                (isinstance(b, Scalar) and b.is_null):
            return Scalar(dt.BOOLEAN, None)
        if isinstance(a, Scalar) and isinstance(b, Scalar):
            return Scalar(dt.BOOLEAN, bool(self.op(a.value, b.value)))
        if self.children[0].dtype is dt.STRING:
            a, b = self._string_codes(a, b)
        data = self.op(flush_subnormals(operand(a)),
                       flush_subnormals(operand(b)))
        return ColV(dt.BOOLEAN, data,
                    and_validity(value_validity(a), value_validity(b)))


class EqualTo(_Comparison):
    op = staticmethod(lambda a, b: a == b)


class GreaterThan(_Comparison):
    op = staticmethod(lambda a, b: a > b)


class GreaterThanOrEqual(_Comparison):
    op = staticmethod(lambda a, b: a >= b)


class LessThan(_Comparison):
    op = staticmethod(lambda a, b: a < b)


class LessThanOrEqual(_Comparison):
    op = staticmethod(lambda a, b: a <= b)


class EqualNullSafe(_Comparison):
    """``<=>``: null <=> null is true, null <=> x false; never null."""

    op = staticmethod(lambda a, b: a == b)

    def eval(self, ctx: EvalContext) -> EvalValue:
        a = self.children[0].eval(ctx)
        b = self.children[1].eval(ctx)
        a_null = isinstance(a, Scalar) and a.is_null
        b_null = isinstance(b, Scalar) and b.is_null
        if isinstance(a, Scalar) and isinstance(b, Scalar):
            if a_null or b_null:
                return Scalar(dt.BOOLEAN, a_null and b_null)
            return Scalar(dt.BOOLEAN, bool(self.op(a.value, b.value)))
        if self.children[0].dtype is dt.STRING and not (a_null or b_null):
            a, b = self._string_codes(a, b)
        n, dev = ctx.num_rows, ctx.device

        def valid(v, null):
            if null:
                return torch.zeros(n, dtype=torch.bool, device=dev)
            vv = value_validity(v)
            return torch.ones(n, dtype=torch.bool, device=dev) \
                if vv is None else vv

        av, bv = valid(a, a_null), valid(b, b_null)
        if a_null or b_null:
            eq = torch.zeros(n, dtype=torch.bool, device=dev)
        else:
            eq = self.op(flush_subnormals(operand(a)),
                         flush_subnormals(operand(b))).expand(n)
        return ColV(dt.BOOLEAN, torch.where(av & bv, eq, ~av & ~bv), None)


class And(Expression):
    """Spark 3VL: false AND null = false."""

    def __init__(self, left, right):
        super().__init__([left, right])

    @property
    def dtype(self):
        return dt.BOOLEAN

    def eval(self, ctx: EvalContext) -> EvalValue:
        a = broadcast(self.children[0].eval(ctx), ctx)
        b = broadcast(self.children[1].eval(ctx), ctx)
        if a.validity is None and b.validity is None:
            return ColV(dt.BOOLEAN, a.data & b.data, None)
        av = _valid_or_true(a, ctx)
        bv = _valid_or_true(b, ctx)
        validity = (av & bv) | (av & ~a.data) | (bv & ~b.data)
        return ColV(dt.BOOLEAN, a.data & b.data, validity)


class Or(Expression):
    """Spark 3VL: true OR null = true."""

    def __init__(self, left, right):
        super().__init__([left, right])

    @property
    def dtype(self):
        return dt.BOOLEAN

    def eval(self, ctx: EvalContext) -> EvalValue:
        a = broadcast(self.children[0].eval(ctx), ctx)
        b = broadcast(self.children[1].eval(ctx), ctx)
        if a.validity is None and b.validity is None:
            return ColV(dt.BOOLEAN, a.data | b.data, None)
        av = _valid_or_true(a, ctx)
        bv = _valid_or_true(b, ctx)
        validity = (av & bv) | (av & a.data) | (bv & b.data)
        return ColV(dt.BOOLEAN, a.data | b.data, validity)


class Not(Expression):
    def __init__(self, child):
        super().__init__([child])

    @property
    def dtype(self):
        return dt.BOOLEAN

    def eval(self, ctx):
        v = self.children[0].eval(ctx)
        if isinstance(v, Scalar):
            return Scalar(dt.BOOLEAN, None if v.is_null else (not v.value))
        return ColV(dt.BOOLEAN, ~v.data, v.validity)


class IsNotNull(Expression):
    def __init__(self, child):
        super().__init__([child])

    @property
    def dtype(self):
        return dt.BOOLEAN

    def eval(self, ctx):
        v = self.children[0].eval(ctx)
        if isinstance(v, Scalar):
            return Scalar(dt.BOOLEAN, not v.is_null)
        if v.validity is None:
            return Scalar(dt.BOOLEAN, True)
        return ColV(dt.BOOLEAN, v.validity, None)


class IsNull(Expression):
    def __init__(self, child):
        super().__init__([child])

    @property
    def dtype(self):
        return dt.BOOLEAN

    def eval(self, ctx):
        v = self.children[0].eval(ctx)
        if isinstance(v, Scalar):
            return Scalar(dt.BOOLEAN, v.is_null)
        if v.validity is None:
            return Scalar(dt.BOOLEAN, False)
        return ColV(dt.BOOLEAN, ~v.validity, None)


class IsNaN(Expression):
    """``isnan(x)``: false for a null x, never null."""

    def __init__(self, child):
        super().__init__([child])

    @property
    def dtype(self):
        return dt.BOOLEAN

    def eval(self, ctx):
        v = self.children[0].eval(ctx)
        if isinstance(v, Scalar):
            return Scalar(dt.BOOLEAN, False if v.is_null else
                          bool(np.isnan(v.value)))
        data = torch.isnan(v.data)
        if v.validity is not None:
            data = data & v.validity
        return ColV(dt.BOOLEAN, data, None)


class In(Expression):
    """x IN (literals): an OR of equalities over x evaluated once. Null
    if x is null, or if nothing matches and the list holds a null."""

    def __init__(self, child: Expression, values: List):
        super().__init__([child])
        self.values = [v.value if isinstance(v, Literal) else v
                       for v in values]

    @property
    def dtype(self):
        return dt.BOOLEAN

    @property
    def device_only(self) -> bool:
        return super().device_only and \
            self.children[0].dtype is not dt.STRING

    def eval(self, ctx):
        child = self.children[0]
        child_value = child.eval(ctx)

        class _Precomputed(LeafExpression):
            dtype = child.dtype

            def eval(self, _ctx):
                return child_value

        pre = _Precomputed()
        result: Optional[Expression] = None
        has_null = any(v is None for v in self.values)
        for v in self.values:
            if v is None:
                continue
            term = EqualTo(pre, Literal(v, child.dtype))
            result = term if result is None else Or(result, term)
        if result is None:
            return Scalar(dt.BOOLEAN, None if has_null else False)
        r = result.eval(ctx)
        if not has_null:
            return r
        if isinstance(r, Scalar):
            return Scalar(dt.BOOLEAN, None) if (not r.is_null and
                                                not r.value) else r
        valid = _valid_or_true(r, ctx)
        return ColV(dt.BOOLEAN, r.data, valid & r.data)


def _valid_or_true(v: ColV, ctx: EvalContext) -> torch.Tensor:
    if v.validity is not None:
        return v.validity
    return torch.ones(ctx.num_rows, dtype=torch.bool, device=ctx.device)


class AtLeastNNonNulls(Expression):
    """True where at least ``n`` children are neither null nor a float
    NaN (a literal counts unless it is null)."""

    def __init__(self, n: int, children: List[Expression]):
        super().__init__(children)
        self.n = n

    @property
    def dtype(self):
        return dt.BOOLEAN

    def eval(self, ctx):
        count = torch.zeros(ctx.num_rows, dtype=torch.int32,
                            device=ctx.device)
        for c in self.children:
            v = c.eval(ctx)
            if isinstance(v, Scalar):
                count = count + (0 if v.is_null else 1)
                continue
            ok = v.validity
            if v.dtype.is_floating:
                not_nan = ~torch.isnan(v.data)
                ok = not_nan if ok is None else ok & not_nan
            count = count + (1 if ok is None else ok.to(torch.int32))
        return ColV(dt.BOOLEAN, count >= self.n, None)
