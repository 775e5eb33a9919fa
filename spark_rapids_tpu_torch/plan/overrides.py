"""Plan -> exec conversion (the counterpart of
spark_rapids_tpu/plan/overrides.py with fusion and adaptive execution
off). Each ported node type converts to its exec; any other node raises.
First, as the reference's default optimizer does, each chain of three
or more inner joins is put in its greedy order (``plan/optimizer``), so
the build sides are the ones the reference builds, and then distinct
aggregates are rewritten to a dedup group-by. A right join becomes a
left join that streams the right side, as the reference plans it. Every expression
passes through ``expressions.folding.fold`` on its way, so each exec
computes what the reference's XLA backend computes. Tagging and CPU
fallback are not ported.
"""
from __future__ import annotations

from typing import Optional

from spark_rapids_tpu_torch import DEFAULT_DEVICE
from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.execs.aggregate import HashAggregateExec
from spark_rapids_tpu_torch.execs.base import TorchExec
from spark_rapids_tpu_torch.execs.basic import (FilterExec, LimitExec,
                                                ProjectExec, ScanExec)
from spark_rapids_tpu_torch.execs.joins import BroadcastHashJoinExec
from spark_rapids_tpu_torch.execs.sort import SortExec
from spark_rapids_tpu_torch.expressions.base import Alias, BoundReference
from spark_rapids_tpu_torch.expressions.folding import fold
from spark_rapids_tpu_torch.plan import nodes as pn
from spark_rapids_tpu_torch.plan.optimizer import (
    reorder_joins, rewrite_distinct_aggregates)

#: rows per uploaded scan batch (the reference's
#: rapids.tpu.sql.reader.batchSizeRows, same key and default)
BATCH_SIZE_ROWS = "rapids.tpu.sql.reader.batchSizeRows"
#: whether join chains take the greedy order (the reference's switch of
#: its optimizer, same key and default); off, a plan runs as written
OPTIMIZER_ENABLED = "rapids.tpu.sql.optimizer.enabled"
_DEFAULTS = {BATCH_SIZE_ROWS: 1 << 21, OPTIMIZER_ENABLED: True}


def apply_overrides(plan: pn.PlanNode, conf: Optional[dict] = None,
                    device=DEFAULT_DEVICE) -> TorchExec:
    """The exec tree for ``plan``, running on ``device``."""
    conf = {**_DEFAULTS, **(conf or {})}
    unknown = set(conf) - set(_DEFAULTS)
    if unknown:
        raise ValueError(f"unknown conf keys: {sorted(unknown)}")
    if conf[OPTIMIZER_ENABLED]:
        plan = reorder_joins(plan)
    return _convert(rewrite_distinct_aggregates(plan), conf, device)


def _convert(node: pn.PlanNode, conf: dict, device) -> TorchExec:
    kids = [_convert(c, conf, device) for c in node.children]
    schema = node.output_schema()
    if isinstance(node, pn.ScanNode):
        return ScanExec(node.source, schema, int(conf[BATCH_SIZE_ROWS]),
                        device)
    if isinstance(node, pn.FilterNode):
        return FilterExec(fold(node.condition), kids[0], device)
    if isinstance(node, pn.ProjectNode):
        return ProjectExec([fold(e) for e in node.exprs], kids[0], schema,
                           device)
    if isinstance(node, pn.AggregateNode):
        aggs = [pn.AggCall(fold(a.fn), a.name) for a in node.aggs]
        child = kids[0]
        if isinstance(child, FilterExec) and child.condition.device_only:
            # the reference fuses such a filter into the aggregate as a
            # live mask, so the child's column statistics survive it
            child.keep_stats = True
        return HashAggregateExec([fold(e) for e in node.grouping], aggs,
                                 child, schema, device)
    if isinstance(node, pn.SortNode):
        return SortExec(node.specs, kids[0], device)
    if isinstance(node, pn.LimitNode):
        return LimitExec(node.n, kids[0], device)
    if isinstance(node, pn.JoinNode):
        cond = None if node.condition is None else fold(node.condition)
        if node.kind == "right":
            return _flipped_right_join(node, kids, schema, cond, device)
        return BroadcastHashJoinExec(node.kind, kids[0], kids[1],
                                     node.left_keys, node.right_keys,
                                     schema, device, cond)
    raise NotImplementedError(f"{node.describe()} is not ported")


def _flipped_right_join(node: pn.JoinNode, kids, schema, cond, device
                        ) -> TorchExec:
    """A right join as the reference plans it: a left join that streams
    the right side and builds the left, then a projection back to left
    columns then right."""
    left, right = kids
    if cond is not None:
        raise NotImplementedError(
            "a right join with a residual condition is not ported")
    nl, nr = len(left.schema.types), len(right.schema.types)
    flipped = BroadcastHashJoinExec(
        "left", right, left, node.right_keys, node.left_keys,
        Schema(right.schema.names + left.schema.names,
               right.schema.types + left.schema.types), device)
    exprs = [Alias(BoundReference(nr + i, t), n) for i, (t, n) in
             enumerate(zip(left.schema.types, schema.names[:nl]))] + \
        [Alias(BoundReference(i, t), n) for i, (t, n) in
         enumerate(zip(right.schema.types, schema.names[nl:]))]
    return ProjectExec(exprs, flipped, schema, device)
