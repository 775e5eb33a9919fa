"""pyspark.sql.functions analogue over the Column DSL (the counterpart of
spark_rapids_tpu/api/functions.py): the aggregates the port has."""
from __future__ import annotations

from typing import Callable, Optional

from spark_rapids_tpu_torch.api.column import (  # noqa: F401
    Column, _to_col, col, lit)
from spark_rapids_tpu_torch.expressions import aggregates as A
from spark_rapids_tpu_torch.expressions.base import Expression


class AggColumn(Column):
    """An aggregate call awaiting ``GroupedData.agg``."""

    def __init__(self, make: Callable, name: Optional[str] = None):
        self.make = make          # schema -> AggregateFunction
        super().__init__(self._err, name)

    @staticmethod
    def _err(schema) -> Expression:
        raise TypeError("aggregate functions are only valid in "
                        "group_by(...).agg(...) or DataFrame.agg(...)")

    def alias(self, name: str) -> "AggColumn":
        return AggColumn(self.make, name)

    name = alias


def _agg(klass) -> Callable[[object], AggColumn]:
    def f(c) -> AggColumn:
        cc = col(c) if isinstance(c, str) else _to_col(c)
        return AggColumn(lambda s: klass(cc.resolve(s)))
    return f


sum = _agg(A.Sum)          # noqa: A001  (pyspark parity)
min = _agg(A.Min)          # noqa: A001
max = _agg(A.Max)          # noqa: A001
avg = _agg(A.Average)
mean = avg


def count(c="*") -> AggColumn:
    if isinstance(c, str) and c == "*":
        return AggColumn(lambda s: A.Count(None))
    cc = col(c) if isinstance(c, str) else _to_col(c)
    return AggColumn(lambda s: A.Count(cc.resolve(s)))
