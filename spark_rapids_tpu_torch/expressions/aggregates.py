"""Aggregate functions (the counterpart of
spark_rapids_tpu/expressions/aggregates.py): each declares its update
half (raw rows -> partial columns) and merge half (partials -> partials)
as group-by ops, plus its final evaluation over the partials. The
aggregate exec drives both halves. The central moments (variance and
standard deviation, sample and population) carry four partials that all
merge by addition. A ``distinct`` count or sum is
rewritten away before it runs (``plan/optimizer.rewrite_distinct_
aggregates``)."""
from __future__ import annotations

from typing import List, Optional

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.expressions.base import Expression


class AggregateFunction(Expression):
    """children[0], if any, is the input expression."""

    distinct = False

    @property
    def input(self) -> Optional[Expression]:
        return self.children[0] if self.children else None

    def partial_types(self) -> List[dt.DType]:
        raise NotImplementedError

    def update_ops(self) -> List[str]:
        raise NotImplementedError

    def merge_ops(self) -> List[str]:
        raise NotImplementedError

    def evaluate(self, partials: List[Expression]) -> Expression:
        return partials[0]


class _OneOp(AggregateFunction):
    """An aggregate of its input's type whose update and merge are one
    group-by op, ``op``."""

    op = ""

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        return self.children[0].dtype

    def partial_types(self):
        return [self.dtype]

    def update_ops(self):
        return [self.op]

    def merge_ops(self):
        return [self.op]


class Min(_OneOp):
    """min: null over no valid rows; a float NaN wins (the reference's
    ``jnp.minimum``); strings by dictionary code, which is string order."""

    op = "min"


class Max(_OneOp):
    op = "max"


class First(_OneOp):
    """first: the first row's value, null when that row is null (Spark's
    ``first`` with ignoreNulls false); with ``ignore_nulls`` the first
    valid value (``any_valid``)."""

    def __init__(self, child: Expression, ignore_nulls: bool = False):
        super().__init__(child)
        self.ignore_nulls = ignore_nulls

    @property
    def op(self):
        return "any_valid" if self.ignore_nulls else "first"


class Last(_OneOp):
    """last: the last row's value, null when that row is null."""

    op = "last"


class Sum(AggregateFunction):
    def __init__(self, child: Expression, distinct: bool = False):
        super().__init__([child])
        self.distinct = distinct

    @property
    def dtype(self):
        t = self.children[0].dtype
        return dt.INT64 if (t.is_integral or t is dt.BOOLEAN) \
            else dt.FLOAT64

    def partial_types(self):
        return [self.dtype]

    def update_ops(self):
        return ["sum"]

    def merge_ops(self):
        return ["sum"]


class Count(AggregateFunction):
    """count(expr); count(*) when child is None."""

    def __init__(self, child: Optional[Expression] = None,
                 distinct: bool = False):
        super().__init__([child] if child is not None else [])
        self.distinct = distinct

    @property
    def dtype(self):
        return dt.INT64

    def partial_types(self):
        return [dt.INT64]

    def update_ops(self):
        return ["count" if self.children else "count_star"]

    def merge_ops(self):
        return ["sum"]


class Average(AggregateFunction):
    """avg: sum and count partials, final sum / count (null over no
    valid rows: the count is 0 and Divide gives null)."""

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        return dt.FLOAT64

    def partial_types(self):
        return [dt.FLOAT64, dt.INT64]

    def update_ops(self):
        return ["sum", "count"]

    def merge_ops(self):
        return ["sum", "sum"]

    def evaluate(self, partials: List[Expression]) -> Expression:
        from spark_rapids_tpu_torch.expressions.arithmetic import Divide

        return Divide(partials[0], partials[1])


class _CentralMoment(AggregateFunction):
    """Variance and standard deviation (the reference's
    ``_CentralMoment``). Partials ``[sum, count, m2, rterm]``: ``m2`` is
    each update's exact centred second moment (every row shifted by its
    group's first valid value, ``ops.groupby``), ``rterm`` its (sum)^2 /
    n; all four merge by addition, and the final value is
    ``m2 + (rterm - sum^2 / n)`` (the correction is zero for one
    update), clamped at 0, over n or n - 1. A sample moment of one row
    is NaN; of no valid row, null."""

    _denom_minus = 1
    _sqrt = False

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        return dt.FLOAT64

    def partial_types(self):
        return [dt.FLOAT64, dt.INT64, dt.FLOAT64, dt.FLOAT64]

    def update_ops(self):
        return ["sum", "count", "m2", "rterm"]

    def merge_ops(self):
        return ["sum", "sum", "sum", "sum"]

    def evaluate(self, partials: List[Expression]) -> Expression:
        from spark_rapids_tpu_torch.expressions.arithmetic import (
            Add, Divide, Multiply, Subtract)
        from spark_rapids_tpu_torch.expressions.base import Literal
        from spark_rapids_tpu_torch.expressions.cast import Cast
        from spark_rapids_tpu_torch.expressions.conditional import If
        from spark_rapids_tpu_torch.expressions.math import Sqrt
        from spark_rapids_tpu_torch.expressions.predicates import (EqualTo,
                                                                   LessThan)

        s, n, m2, r = partials
        nf = Cast(n, dt.FLOAT64)
        total = Add(m2, Subtract(r, Divide(Multiply(s, s), nf)))
        total = If(LessThan(total, Literal(0.0)), Literal(0.0), total)
        denom = Subtract(nf, Literal(float(self._denom_minus))) \
            if self._denom_minus else nf
        out = Divide(total, denom)
        if self._denom_minus:
            out = If(EqualTo(n, Literal(1, dt.INT64)),
                     Literal(float("nan"), dt.FLOAT64), out)
        return Sqrt(out) if self._sqrt else out


class VarianceSamp(_CentralMoment):
    """var_samp / variance."""


class VariancePop(_CentralMoment):
    _denom_minus = 0


class StddevSamp(_CentralMoment):
    """stddev_samp / stddev / std."""

    _sqrt = True


class StddevPop(_CentralMoment):
    _denom_minus = 0
    _sqrt = True
