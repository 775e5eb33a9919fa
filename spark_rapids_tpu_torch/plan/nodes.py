"""Plan nodes (the counterpart of spark_rapids_tpu/plan/nodes.py): the
node types TPCx-BB q26, TPC-H q14 and q22 and the SQL front end use.
Expressions inside nodes are bound: their ``BoundReference`` ordinals
index the child's output schema.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.expressions.aggregates import AggregateFunction
from spark_rapids_tpu_torch.expressions.base import Alias, Expression
from spark_rapids_tpu_torch.io.hoststrings import HostStrings
from spark_rapids_tpu_torch.ops.sortkeys import SortKeySpec


def expr_name(e: Expression, i: int) -> str:
    return e.alias if isinstance(e, Alias) else f"col{i}"


class PlanNode:
    def __init__(self, children: Sequence["PlanNode"]):
        self.children = list(children)

    def output_schema(self) -> Schema:
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__


class InMemorySource:
    """Host-resident columns: ``data`` maps name -> numpy array (a masked
    array's mask marks its nulls), or for strings a ``HostStrings``
    (codes into one sorted dictionary) or an object array (None = null),
    which is encoded here once as a ``HostStrings``; ``validity`` name ->
    bool mask."""

    def __init__(self, data: dict, schema: Optional[Schema] = None,
                 validity: Optional[dict] = None):
        self._schema = schema or Schema(
            list(data), [dt.STRING if isinstance(v, HostStrings) else
                         dt.from_numpy(np.asarray(v).dtype)
                         for v in data.values()])
        self.data, self.validity = dict(data), dict(validity or {})
        for name, v in data.items():
            if isinstance(v, np.ma.MaskedArray):
                self.data[name] = np.ma.getdata(v)
                self.validity.setdefault(name, ~np.ma.getmaskarray(v))
        for name, t in zip(self._schema.names, self._schema.types):
            v = self.data[name]
            if t is dt.STRING and not isinstance(v, HostStrings):
                self.data[name], self.validity[name] = _encode(
                    v, self.validity.get(name))

    def schema(self) -> Schema:
        return self._schema

    def num_rows(self) -> int:
        for v in self.data.values():
            return len(v)
        return 0


def _encode(values, validity):
    """An object string column as ``HostStrings`` and its validity (None
    rows and rows masked invalid are null, with code 0); None when every
    row is valid."""
    arr = np.asarray(values, dtype=object)
    null = np.array([v is None for v in arr], dtype=bool)
    if validity is not None:
        null |= ~np.asarray(validity, dtype=bool)
    if null.any():
        arr = arr.copy()
        arr[null] = None
    return HostStrings.from_objects(arr), (~null if null.any() else None)


class ScanNode(PlanNode):
    def __init__(self, source: InMemorySource):
        super().__init__([])
        self.source = source

    def output_schema(self) -> Schema:
        return self.source.schema()


class ProjectNode(PlanNode):
    def __init__(self, exprs: List[Expression], child: PlanNode,
                 names: Optional[List[str]] = None):
        super().__init__([child])
        self.exprs = list(exprs)
        self.names = names or [expr_name(e, i) for i, e in enumerate(exprs)]

    def output_schema(self) -> Schema:
        return Schema(self.names, [e.dtype for e in self.exprs])


class FilterNode(PlanNode):
    def __init__(self, condition: Expression, child: PlanNode):
        super().__init__([child])
        self.condition = condition

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()


@dataclasses.dataclass
class AggCall:
    """One named aggregate output."""

    fn: AggregateFunction
    name: str


class AggregateNode(PlanNode):
    """Group-by aggregate, raw input to final results (the reference's
    "complete" mode). Output: grouping columns then aggregates."""

    def __init__(self, grouping: List[Expression], aggs: List[AggCall],
                 child: PlanNode,
                 grouping_names: Optional[List[str]] = None):
        super().__init__([child])
        self.grouping = list(grouping)
        self.aggs = list(aggs)
        self.grouping_names = grouping_names or [
            expr_name(e, i) for i, e in enumerate(grouping)]

    def output_schema(self) -> Schema:
        return Schema(
            list(self.grouping_names) + [a.name for a in self.aggs],
            [e.dtype for e in self.grouping] + [a.fn.dtype
                                                for a in self.aggs])


class SortNode(PlanNode):
    """ORDER BY over the child's ordinals."""

    def __init__(self, specs: List[SortKeySpec], child: PlanNode):
        super().__init__([child])
        self.specs = list(specs)

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()


class LimitNode(PlanNode):
    """The first ``n`` rows of the child, in its order."""

    def __init__(self, n: int, child: PlanNode):
        super().__init__([child])
        self.n = n

    def output_schema(self) -> Schema:
        return self.children[0].output_schema()

    def describe(self) -> str:
        return f"Limit[{self.n}]"


#: the equi-join kinds (the reference's, but ``cross``)
JOIN_KINDS = ("inner", "left", "right", "full", "left_semi", "left_anti")


class JoinNode(PlanNode):
    """Equi-join on key ordinals plus an optional residual ``condition``
    over the joined row (left columns then right), applied as a filter
    after the join, as the reference does. Inner, left, right and full
    joins output left columns then right (the side an outer join pads
    with nulls is nullable); ``left_semi`` and ``left_anti`` joins the
    left columns only."""

    def __init__(self, kind: str, left: PlanNode, right: PlanNode,
                 left_keys: List[int], right_keys: List[int],
                 condition: Optional[Expression] = None):
        super().__init__([left, right])
        if len(left_keys) != len(right_keys) or not left_keys:
            raise ValueError("an equi-join needs matching key lists")
        if kind not in JOIN_KINDS:
            raise NotImplementedError(f"{kind} join is not ported")
        self.kind = kind
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.condition = condition

    def output_schema(self) -> Schema:
        ls, rs = (c.output_schema() for c in self.children)
        if self.kind in ("left_semi", "left_anti"):
            return ls
        return Schema(ls.names + rs.names, ls.types + rs.types)

    def describe(self) -> str:
        return f"JoinNode[{self.kind}]"
