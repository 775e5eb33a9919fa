"""Plan -> exec conversion (the counterpart of
spark_rapids_tpu/plan/overrides.py with adaptive execution off). Each
ported node type converts to its exec; any other node raises. First the
reference's default optimizer runs (``plan/optimizer.optimize``:
projections and filters collapsed, filters pushed below joins, chains of
three or more inner joins in the greedy order, so the build sides are
the ones the reference builds, distinct aggregates rewritten to a dedup
group-by); with ``rapids.tpu.sql.optimizer.enabled`` false only the
distinct rewrite. A scan node that occurs twice converts to one scan
exec; every other node converts once per occurrence, as in the
reference, whose file-filter pass rebuilds every node with children
before conversion (so a CTE's subtree runs once per reference there
too). A right join becomes a left join that streams the right side, as
the reference plans it. Every expression passes through
``expressions.folding.fold`` on its way, so each exec computes what the
reference's XLA backend computes. Then, with
``rapids.tpu.sql.fusion.enabled`` true (the reference's default), the
fusion pass (``execs.fused.fuse_pipelines``) turns chains of filters,
projections and broadcast probes into fused execs; false keeps the
unfused tree. Tagging and CPU fallback are not ported: a plan with an
expression the reference marks ``incompat`` (the transcendental
functions) is refused unless ``rapids.tpu.sql.incompatibleOps.enabled``
is true.
"""
from __future__ import annotations

from typing import Optional

from spark_rapids_tpu_torch import DEFAULT_DEVICE
from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.execs.aggregate import HashAggregateExec
from spark_rapids_tpu_torch.execs.base import TorchExec
from spark_rapids_tpu_torch.execs.basic import (FilterExec, LimitExec,
                                                ProjectExec, ScanExec)
from spark_rapids_tpu_torch.execs.fused import fuse_pipelines
from spark_rapids_tpu_torch.execs.joins import BroadcastHashJoinExec
from spark_rapids_tpu_torch.execs.sort import SortExec
from spark_rapids_tpu_torch.expressions.base import Alias, BoundReference
from spark_rapids_tpu_torch.expressions.folding import fold
from spark_rapids_tpu_torch.plan import nodes as pn
from spark_rapids_tpu_torch.plan.optimizer import (
    optimize, rewrite_distinct_aggregates)

#: rows per uploaded scan batch (the reference's
#: rapids.tpu.sql.reader.batchSizeRows, same key and default)
BATCH_SIZE_ROWS = "rapids.tpu.sql.reader.batchSizeRows"
#: whether join chains take the greedy order (the reference's switch of
#: its optimizer, same key and default); off, a plan runs as written
OPTIMIZER_ENABLED = "rapids.tpu.sql.optimizer.enabled"
#: the reference's fusion switches (same keys and defaults): the fusion
#: pass, the ORDER BY absorbed into a post-aggregate chain, and the
#: largest build-key span a fused join probes through a dense table
FUSION_ENABLED = "rapids.tpu.sql.fusion.enabled"
FUSION_SORT_TAIL = "rapids.tpu.sql.fusion.sortTail"
FUSION_DENSE_PROBE_MAX_SPAN = "rapids.tpu.sql.fusion.denseProbe.maxSpan"
#: whether the expressions whose results may differ from java.lang.Math
#: in the last bits run (the reference's key and default; off, it runs
#: them on its CPU engine, which the port lacks, so the port refuses)
INCOMPATIBLE_OPS = "rapids.tpu.sql.incompatibleOps.enabled"
_DEFAULTS = {BATCH_SIZE_ROWS: 1 << 21, OPTIMIZER_ENABLED: True,
             FUSION_ENABLED: True, FUSION_SORT_TAIL: True,
             FUSION_DENSE_PROBE_MAX_SPAN: 1 << 22, INCOMPATIBLE_OPS: False}


def apply_overrides(plan: pn.PlanNode, conf: Optional[dict] = None,
                    device=DEFAULT_DEVICE) -> TorchExec:
    """The exec tree for ``plan``, running on ``device``."""
    conf = {**_DEFAULTS, **(conf or {})}
    unknown = set(conf) - set(_DEFAULTS)
    if unknown:
        raise ValueError(f"unknown conf keys: {sorted(unknown)}")
    plan = optimize(plan) if conf[OPTIMIZER_ENABLED] else \
        rewrite_distinct_aggregates(plan)
    exec_ = _convert(plan, conf, device, {})
    if conf[FUSION_ENABLED]:
        exec_ = fuse_pipelines(exec_, int(conf[FUSION_DENSE_PROBE_MAX_SPAN]),
                               bool(conf[FUSION_SORT_TAIL]))
    return exec_


def _convert(node: pn.PlanNode, conf: dict, device, memo: dict
             ) -> TorchExec:
    if node.children:
        return _convert_one(node, conf, device, memo)
    hit = memo.get(id(node))
    if hit is None:
        hit = memo[id(node)] = (node, _convert_one(node, conf, device,
                                                   memo))
    return hit[1]


def _refuse_incompatible(node: pn.PlanNode, conf: dict) -> None:
    """Raise where ``node`` holds an ``incompat`` expression and
    ``INCOMPATIBLE_OPS`` is off: the reference would run the node on its
    CPU engine, which is not ported (ROADMAP A6)."""
    if conf[INCOMPATIBLE_OPS]:
        return
    if isinstance(node, pn.ProjectNode):
        exprs = node.exprs
    elif isinstance(node, pn.AggregateNode):
        exprs = node.grouping + [a.fn for a in node.aggs]
    elif isinstance(node, (pn.FilterNode, pn.JoinNode)):
        exprs = [node.condition] if node.condition is not None else []
    else:
        return
    for e in exprs:
        bad = e.collect(lambda x: getattr(x, "incompat", False))
        if bad:
            raise NotImplementedError(
                f"{type(bad[0]).__name__} may differ from java.lang.Math "
                f"in the last bits: it runs with {INCOMPATIBLE_OPS} true; "
                "without it the reference runs it on its CPU engine, which "
                "is not ported (ROADMAP A6)")


def _convert_one(node: pn.PlanNode, conf: dict, device, memo: dict
                 ) -> TorchExec:
    _refuse_incompatible(node, conf)
    kids = [_convert(c, conf, device, memo) for c in node.children]
    schema = node.output_schema()
    if isinstance(node, pn.ScanNode):
        return ScanExec(node.source, schema, int(conf[BATCH_SIZE_ROWS]),
                        device)
    if isinstance(node, pn.FilterNode):
        return _keep_unfolded(FilterExec(fold(node.condition), kids[0],
                                         device),
                              condition=node.condition)
    if isinstance(node, pn.ProjectNode):
        return _keep_unfolded(ProjectExec([fold(e) for e in node.exprs],
                                          kids[0], schema, device),
                              exprs=list(node.exprs))
    if isinstance(node, pn.AggregateNode):
        aggs = [pn.AggCall(fold(a.fn), a.name) for a in node.aggs]
        child = kids[0]
        if isinstance(child, FilterExec) and child.condition.device_only:
            # the reference fuses such a filter into the aggregate as a
            # live mask, so the child's column statistics survive it
            child.keep_stats = True
        return _keep_unfolded(
            HashAggregateExec([fold(e) for e in node.grouping], aggs, child,
                              schema, device),
            input_exprs=list(node.grouping) + [
                a.fn.input for a in node.aggs if a.fn.input is not None])
    if isinstance(node, pn.SortNode):
        return SortExec(node.specs, kids[0], device)
    if isinstance(node, pn.LimitNode):
        return LimitExec(node.n, kids[0], device)
    if isinstance(node, pn.JoinNode):
        cond = None if node.condition is None else fold(node.condition)
        if node.kind == "right":
            return _flipped_right_join(node, kids, schema, cond, device)
        return _keep_unfolded(
            BroadcastHashJoinExec(node.kind, kids[0], kids[1],
                                  node.left_keys, node.right_keys, schema,
                                  device, cond),
            condition=node.condition)
    raise NotImplementedError(f"{node.describe()} is not ported")


def _keep_unfolded(exec_: TorchExec, **exprs) -> TorchExec:
    """``exec_`` with its expressions as planned, before ``fold``: a fused
    chain composes those over its steps and folds the compositions
    (``execs/fused.py``), as the reference's one program per chain
    does."""
    exec_.unfolded = exprs
    return exec_


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
