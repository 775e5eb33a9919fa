"""Conditional expressions (the counterpart of
spark_rapids_tpu/expressions/conditional.py): ``If``. Both branches
evaluate and combine with ``where``; a null predicate takes the else
branch, and the result's validity follows the chosen side."""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.column import Scalar
from spark_rapids_tpu_torch.expressions.base import (
    ColV, EvalContext, EvalValue, Expression, broadcast)


class If(Expression):
    def __init__(self, pred: Expression, then: Expression,
                 other: Expression):
        super().__init__([pred, then, other])

    @property
    def dtype(self):
        return self.children[1].dtype

    @property
    def device_only(self) -> bool:
        # string branches merge dictionaries on the host
        return super().device_only and self.dtype is not dt.STRING

    def eval(self, ctx: EvalContext) -> EvalValue:
        pred = self.children[0].eval(ctx)
        if isinstance(pred, Scalar):
            pick = self.children[1] if (not pred.is_null and pred.value) \
                else self.children[2]
            return pick.eval(ctx)
        if self.dtype is dt.STRING:
            raise NotImplementedError("If over strings is not ported")
        t = broadcast(self.children[1].eval(ctx), ctx)
        e = broadcast(self.children[2].eval(ctx), ctx)
        cond = pred.data if pred.validity is None else \
            pred.data & pred.validity
        data = torch.where(cond, t.data, e.data)
        if t.validity is None and e.validity is None:
            return ColV(self.dtype, data, None)
        ones = torch.ones(ctx.num_rows, dtype=torch.bool, device=ctx.device)
        tv = t.validity if t.validity is not None else ones
        ev = e.validity if e.validity is not None else ones
        return ColV(self.dtype, data, torch.where(cond, tv, ev))
