"""Conditional and null-handling expressions (the counterpart of
spark_rapids_tpu/expressions/conditional.py): ``If``, ``CaseWhen``,
``Coalesce``, ``Nvl``, ``NaNvl``, ``Greatest`` and ``Least``. Every
branch evaluates and the branches combine with ``where``; a null
predicate takes the else branch, and the result's validity follows the
chosen side. A string result needs the dictionaries of its branches
merged, which is not ported (ROADMAP A2): such an expression raises
when it runs, and is not ``device_only``, as in the reference."""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.column import Scalar
from spark_rapids_tpu_torch.expressions.base import (
    ColV, EvalContext, EvalValue, Expression, broadcast)
from spark_rapids_tpu_torch.ops.sortkeys import flush_subnormals


class _Conditional(Expression):
    """The type of the first child that gives the result's type."""

    _typed_child = 0

    @property
    def dtype(self):
        return self.children[self._typed_child].dtype

    @property
    def device_only(self) -> bool:
        # string branches merge dictionaries on the host
        return super().device_only and self.dtype is not dt.STRING


def _select(ctx: EvalContext, pred: ColV, t: EvalValue, e: EvalValue,
            out_t: dt.DType) -> ColV:
    """where(pred is true, t, e): a null predicate selects ``e``; the
    validity follows the chosen side."""
    if out_t is dt.STRING:
        raise NotImplementedError(
            "a conditional with string results is not ported (ROADMAP A2: "
            "its branches' dictionaries must be merged)")
    tb, eb = broadcast(t, ctx), broadcast(e, ctx)
    cond = pred.data if pred.validity is None else pred.data & pred.validity
    data = torch.where(cond, tb.data, eb.data.to(tb.data.dtype))
    if tb.validity is None and eb.validity is None:
        return ColV(out_t, data, None)
    ones = torch.ones(ctx.num_rows, dtype=torch.bool, device=ctx.device)
    tv = tb.validity if tb.validity is not None else ones
    ev = eb.validity if eb.validity is not None else ones
    return ColV(out_t, data, torch.where(cond, tv, ev))


class If(_Conditional):
    _typed_child = 1

    def __init__(self, pred: Expression, then: Expression,
                 other: Expression):
        super().__init__([pred, then, other])

    def eval(self, ctx: EvalContext) -> EvalValue:
        pred = self.children[0].eval(ctx)
        if isinstance(pred, Scalar):
            pick = self.children[1] if (not pred.is_null and pred.value) \
                else self.children[2]
            return pick.eval(ctx)
        return _select(ctx, pred, self.children[1].eval(ctx),
                       self.children[2].eval(ctx), self.dtype)


class CaseWhen(_Conditional):
    """CASE WHEN c1 THEN v1 ... [ELSE e] END: the first true predicate
    wins (null counts as false), no match gives the else value or null.
    The type is the first branch value's."""

    _typed_child = 1

    def __init__(self, branches: List[Tuple[Expression, Expression]],
                 else_value: Optional[Expression] = None):
        flat: List[Expression] = []
        for c, v in branches:
            flat.extend([c, v])
        if else_value is not None:
            flat.append(else_value)
        super().__init__(flat)
        self.n_branches = len(branches)
        self.has_else = else_value is not None

    def eval(self, ctx: EvalContext) -> EvalValue:
        out_t = self.dtype
        result = self.children[-1].eval(ctx) if self.has_else else \
            Scalar(out_t, None)
        # right to left, so an earlier branch wins
        for i in reversed(range(self.n_branches)):
            pred = self.children[2 * i].eval(ctx)
            val = self.children[2 * i + 1].eval(ctx)
            if isinstance(pred, Scalar):
                if not pred.is_null and pred.value:
                    result = val
                continue
            result = _select(ctx, pred, val, result, out_t)
        return result


class Coalesce(_Conditional):
    """The first non-null argument; the type is the first argument's."""

    def __init__(self, children: List[Expression]):
        super().__init__(children)

    def eval(self, ctx: EvalContext) -> EvalValue:
        result: EvalValue = Scalar(self.dtype, None)
        for c in reversed(self.children):
            v = c.eval(ctx)
            if isinstance(v, Scalar):
                if not v.is_null:
                    result = v
                continue
            if v.validity is None:
                result = v
                continue
            result = _select(ctx, ColV(dt.BOOLEAN, v.validity, None), v,
                             result, self.dtype)
        return result


class Nvl(Coalesce):
    def __init__(self, left: Expression, right: Expression):
        super().__init__([left, right])


class NaNvl(_Conditional):
    """``nanvl(a, b)``: a unless a is NaN; a null a stays null."""

    def __init__(self, left: Expression, right: Expression):
        super().__init__([left, right])

    def eval(self, ctx: EvalContext) -> EvalValue:
        av = broadcast(self.children[0].eval(ctx), ctx)
        b = self.children[1].eval(ctx)
        pick_a = ~torch.isnan(av.data)
        if av.validity is not None:
            pick_a = pick_a | ~av.validity
        return _select(ctx, ColV(dt.BOOLEAN, pick_a, None), av, b,
                       self.dtype)


class _GreatestLeast(_Conditional):
    """n-ary greatest / least, skipping nulls (null only where every
    argument is); one evaluation per child. NaN is the largest value:
    greatest propagates it, least skips it. Strings are refused, as in
    the reference (codes of two dictionaries do not compare)."""

    def __init__(self, children: List[Expression]):
        assert len(children) >= 2
        if any(c.dtype is dt.STRING for c in children):
            raise TypeError("greatest/least over strings is unsupported")
        super().__init__(children)

    @staticmethod
    def combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def eval(self, ctx: EvalContext) -> EvalValue:
        acc = broadcast(self.children[0].eval(ctx), ctx)
        data, valid = acc.data, acc.validity
        for c in self.children[1:]:
            v = broadcast(c.eval(ctx), ctx)
            combined = self.combine(data, v.data.to(data.dtype))
            if valid is None and v.validity is None:
                data = combined
            elif valid is None:
                data = torch.where(v.validity, combined, data)
            elif v.validity is None:
                data = torch.where(valid, combined, v.data.to(data.dtype))
                valid = None
            else:
                data = torch.where(valid & v.validity, combined,
                                   torch.where(valid, data,
                                               v.data.to(data.dtype)))
                valid = valid | v.validity
        return ColV(self.dtype, data, valid)


def _ordered(x: torch.Tensor) -> torch.Tensor:
    """Floats as XLA's min and max read them: a subnormal is a zero of
    its sign, and -0.0 orders below +0.0."""
    if not x.is_floating_point():
        return x
    fi = torch.finfo(x.dtype)
    x = flush_subnormals(x)
    return torch.where((x == 0) & torch.signbit(x), -fi.tiny * fi.eps, x)


class Greatest(_GreatestLeast):
    """XLA's maximum: NaN wins, -0.0 orders below +0.0, and the result is
    flushed."""

    @staticmethod
    def combine(a, b):
        return flush_subnormals(torch.maximum(_ordered(a), _ordered(b)))


class Least(_GreatestLeast):
    """XLA's fmin: a NaN operand loses; else the first operand where it
    compares below the second (subnormals as zeros), the second
    otherwise, untouched (so of two equal zeros the second)."""

    @staticmethod
    def combine(a, b):
        if not a.is_floating_point():
            return torch.minimum(a, b)
        pick_a = torch.isnan(b) | (flush_subnormals(a) <
                                   flush_subnormals(b))
        return torch.where(pick_a & ~torch.isnan(a), a, b)
