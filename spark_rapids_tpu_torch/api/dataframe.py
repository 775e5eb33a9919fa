"""Lazy DataFrame over the port's plan tree (the counterpart of
spark_rapids_tpu/api/dataframe.py). Each transformation builds a plan
node; ``collect`` converts the plan to execs on the session's device and
runs it."""
from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

from spark_rapids_tpu_torch.api.column import Column, col, strip_alias
from spark_rapids_tpu_torch.api.functions import AggColumn
from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.expressions.base import (BoundReference,
                                                     Expression)
from spark_rapids_tpu_torch.ops.sortkeys import SortKeySpec
from spark_rapids_tpu_torch.plan import nodes as pn

ColumnOrName = Union[Column, str]

#: pyspark's join spellings -> the plan's join kinds the port has
#: pyspark's join names -> plan join kinds (the reference's mapping; a
#: cross join is not ported)
_HOW = {"inner": "inner", "left": "left", "leftouter": "left",
        "right": "right", "rightouter": "right", "full": "full",
        "outer": "full", "fullouter": "full", "full_outer": "full",
        "leftsemi": "left_semi", "left_semi": "left_semi",
        "leftanti": "left_anti", "left_anti": "left_anti"}


def _as_col(c: ColumnOrName) -> Column:
    return col(c) if isinstance(c, str) else c


class DataFrame:
    def __init__(self, plan: pn.PlanNode, session):
        self._plan = plan
        self.session = session

    @property
    def schema(self) -> Schema:
        return self._plan.output_schema()

    @property
    def columns(self) -> List[str]:
        return list(self.schema.names)

    def _df(self, plan: pn.PlanNode) -> "DataFrame":
        return DataFrame(plan, self.session)

    # -- transformations --------------------------------------------------

    def select(self, *cols: ColumnOrName) -> "DataFrame":
        schema = self.schema
        exprs: List[Expression] = []
        names: List[str] = []
        for i, c in enumerate(cols):
            cc = _as_col(c)
            exprs.append(strip_alias(cc.resolve(schema)))
            names.append(cc.out_name(f"col{i}"))
        return self._df(pn.ProjectNode(exprs, self._plan, names))

    def filter(self, condition: Column) -> "DataFrame":
        return self._df(pn.FilterNode(condition.resolve(self.schema),
                                      self._plan))

    where = filter

    def with_column(self, name: str, c: Column) -> "DataFrame":
        schema = self.schema
        exprs: List[Expression] = [BoundReference(i, t)
                                   for i, t in enumerate(schema.types)]
        names = list(schema.names)
        new = c.resolve(schema)
        if name in names:
            exprs[names.index(name)] = new
        else:
            exprs.append(new)
            names.append(name)
        return self._df(pn.ProjectNode(exprs, self._plan, names))

    withColumn = with_column

    def group_by(self, *cols: ColumnOrName) -> "GroupedData":
        return GroupedData(self, [_as_col(c) for c in cols])

    groupBy = group_by

    def agg(self, *aggs: AggColumn) -> "DataFrame":
        return GroupedData(self, []).agg(*aggs)

    def join(self, other: "DataFrame", on, how: str = "inner"
             ) -> "DataFrame":
        """Equi-join on column names (``on`` a name, a list of names, or
        (left name, right name) pairs). Every kind but cross is
        ported."""
        kind = _HOW.get(how)
        if kind is None:
            raise NotImplementedError(f"{how} join is not ported yet")
        ls, rs = self.schema, other.schema
        lk, rk = [], []
        for o in [on] if isinstance(on, str) else on:
            lname, rname = o if isinstance(o, tuple) else (o, o)
            lk.append(ls.index_of(lname))
            rk.append(rs.index_of(rname))
        return self._df(pn.JoinNode(kind, self._plan, other._plan, lk, rk))

    def order_by(self, *cols: ColumnOrName,
                 ascending: Union[bool, Sequence[bool]] = True
                 ) -> "DataFrame":
        schema = self.schema
        asc = [ascending] * len(cols) if isinstance(ascending, bool) \
            else list(ascending)
        specs = []
        for c, a in zip(cols, asc):
            e = _as_col(c).resolve(schema)
            if not isinstance(e, BoundReference):
                raise ValueError(
                    "order_by requires plain columns; project computed "
                    "keys first (with_column)")
            specs.append(SortKeySpec.spark_default(e.ordinal, ascending=a))
        return self._df(pn.SortNode(specs, self._plan))

    orderBy = sort = order_by

    def limit(self, n: int) -> "DataFrame":
        return self._df(pn.LimitNode(n, self._plan))

    def create_or_replace_temp_view(self, name: str) -> None:
        self.session.create_temp_view(name, self)

    createOrReplaceTempView = create_or_replace_temp_view

    # -- actions ----------------------------------------------------------

    def collect(self) -> Dict[str, np.ndarray]:
        """Run the plan on the session's device. Returns a dict of host
        numpy columns (name -> array, in output order; a column with nulls
        is an object array with None), not a pandas frame: the port does
        not depend on pandas."""
        from spark_rapids_tpu_torch.execs.base import collect
        from spark_rapids_tpu_torch.plan.overrides import apply_overrides

        return collect(apply_overrides(self._plan, self.session.conf,
                                       self.session.device))


class GroupedData:
    def __init__(self, df: DataFrame, keys: List[Column]):
        self.df = df
        self.keys = keys

    def agg(self, *aggs: AggColumn) -> DataFrame:
        schema = self.df.schema
        grouping, gnames = [], []
        for i, k in enumerate(self.keys):
            grouping.append(strip_alias(k.resolve(schema)))
            gnames.append(k.out_name(f"key{i}"))
        calls = []
        for i, a in enumerate(aggs):
            if not isinstance(a, AggColumn):
                raise TypeError("group_by().agg takes aggregate functions")
            calls.append(pn.AggCall(a.make(schema), a.out_name(f"agg{i}")))
        return self.df._df(pn.AggregateNode(
            grouping, calls, self.df._plan, grouping_names=gnames))

    def count(self) -> DataFrame:
        from spark_rapids_tpu_torch.api import functions as F

        return self.agg(F.count("*").alias("count"))
