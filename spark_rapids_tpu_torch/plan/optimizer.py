"""The reference's plan optimizer (the counterpart of
spark_rapids_tpu/plan/optimizer.py's ``optimize``, which its
``apply_overrides`` runs by default, fusion and adaptive execution off
included): ``collapse_project``, ``push_filters_below_joins``, the greedy
join order and the distinct-aggregate rewrite, in the reference's order.

``collapse_project`` merges Project(Project(x)) into one projection over
x (the outer expressions rewritten over the inner ones, unless an inner
expression that is not a bare reference would be computed twice),
Filter(Filter(x)) into one conjunctive filter, and puts a filter over a
projection below it, its condition rewritten through the projection.
``push_filters_below_joins`` moves each conjunct of a filter over a join
that reads one side only below the join, where the join kind allows it
(not a left join's right side, nothing of a full join). These decide
which filters and projections sit next to each other, and so which
chains the fusion pass (``execs/fused.py``) forms, and which float
products meet an add in one expression (``expressions/folding.py``).

A maximal chain of condition-free inner equi-joins over three or more
relations is rebuilt left-deep: it starts from the relation of most
estimated rows (the fact table stays the stream side) and joins the
smallest relation connected to those placed so far, so each build side
is the smaller one. A projection on top restores the written column
order. Row estimates are the reference's: a scan's row count, 0.3 of the
child's rows for a filter, a third for an aggregate. The port's
in-memory sources carry no footer statistics, so a join's estimate is
the larger side's, as the reference's is for in-memory sources.

``rewrite_distinct_aggregates`` turns ``count(DISTINCT x)`` and
``sum(DISTINCT x)`` into a group-by on the keys and x (which drops the
duplicates), then the plain aggregate over it; plain sums, counts,
averages, minima and maxima beside it are computed per (keys, x) and
merged, as the reference does. Distinct aggregates over more than one
input are refused, where the reference falls back to its CPU engine.

Every pass keeps a subtree that occurs twice (a CTE) one object.
"""
from __future__ import annotations

import copy
from typing import List, Optional

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.expressions import aggregates as aggfn
from spark_rapids_tpu_torch.expressions.arithmetic import Divide
from spark_rapids_tpu_torch.expressions.base import (Alias, BoundReference,
                                                     Expression, Literal)
from spark_rapids_tpu_torch.expressions.compiler import (substitute,
                                                         unwrap_alias)
from spark_rapids_tpu_torch.expressions.conditional import If
from spark_rapids_tpu_torch.expressions.predicates import And, IsNotNull
from spark_rapids_tpu_torch.plan import nodes as pn

_FILTER_SELECTIVITY = 0.3


def optimize(plan: pn.PlanNode) -> pn.PlanNode:
    """The reference's ``optimize``: collapse, push, collapse, push,
    reorder, collapse, then the distinct rewrite."""
    plan = collapse_project(plan)
    plan = push_filters_below_joins(plan)
    plan = collapse_project(plan)
    plan = push_filters_below_joins(plan)
    plan = reorder_joins(plan)
    plan = collapse_project(plan)
    return rewrite_distinct_aggregates(plan)


def _memoized(one):
    """A bottom-up pass that rewrites a shared subtree once."""
    def run(node: pn.PlanNode, _memo=None) -> pn.PlanNode:
        if _memo is None:
            _memo = {}
        hit = _memo.get(id(node))
        if hit is not None:
            return hit[1]
        out = one(node, lambda c: run(c, _memo))
        _memo[id(node)] = (node, out)
        return out
    run.__name__ = one.__name__.lstrip("_")
    run.__doc__ = one.__doc__
    return run


@_memoized
def _collapse_project(node: pn.PlanNode, recurse) -> pn.PlanNode:
    """Project/Filter chains collapsed bottom up (the reference's
    ``collapse_project``)."""
    node = _with_children(node, [recurse(c) for c in node.children])
    child = node.children[0] if node.children else None
    if isinstance(node, pn.ProjectNode) and \
            isinstance(child, pn.ProjectNode) and \
            all(e.deterministic for e in child.exprs):
        counts = [0] * len(child.exprs)
        for e in node.exprs:
            for r in e.collect(lambda n: isinstance(n, BoundReference)):
                counts[r.ordinal] += 1
        if all(c <= 1 or
               isinstance(unwrap_alias(child.exprs[i]), BoundReference)
               for i, c in enumerate(counts)):
            return recurse(pn.ProjectNode(
                [substitute(e, child.exprs) for e in node.exprs],
                child.children[0], names=list(node.names)))
    if isinstance(node, pn.FilterNode) and isinstance(child, pn.FilterNode):
        return recurse(pn.FilterNode(And(child.condition, node.condition),
                                     child.children[0]))
    if isinstance(node, pn.FilterNode) and \
            isinstance(child, pn.ProjectNode) and \
            all(e.deterministic for e in child.exprs) and \
            node.condition.deterministic:
        return recurse(pn.ProjectNode(
            list(child.exprs),
            pn.FilterNode(substitute(node.condition, child.exprs),
                          child.children[0]),
            names=list(child.names)))
    return node


collapse_project = _collapse_project


def _conjuncts(e: Expression) -> List[Expression]:
    if isinstance(e, And):
        return _conjuncts(e.children[0]) + _conjuncts(e.children[1])
    return [e]


def _and_all(exprs: List[Expression]) -> Expression:
    out = exprs[0]
    for e in exprs[1:]:
        out = And(out, e)
    return out


def _shift_refs(e: Expression, delta: int) -> Expression:
    return e.transform(lambda n: BoundReference(n.ordinal + delta, n.dtype)
                       if isinstance(n, BoundReference) else n)


@_memoized
def _push_filters_below_joins(node: pn.PlanNode, recurse) -> pn.PlanNode:
    """Each conjunct of a filter over a join that reads one side only
    moves below the join where its kind allows (the reference's
    ``push_filters_below_joins``)."""
    node = _with_children(node, [recurse(c) for c in node.children])
    if not (isinstance(node, pn.FilterNode) and
            isinstance(node.children[0], pn.JoinNode)):
        return node
    join = node.children[0]
    lw = len(join.children[0].output_schema().names)
    # a left join's right side must not be filtered first (a dropped
    # match would become a null-extended row); a full join takes nothing
    push_left = join.kind in ("inner", "left", "left_semi", "left_anti")
    push_right = join.kind in ("inner", "right")
    keep, lpush, rpush = [], [], []
    for c in _conjuncts(node.condition):
        ords = [r.ordinal for r in
                c.collect(lambda n: isinstance(n, BoundReference))]
        if not c.deterministic or not ords:
            keep.append(c)
        elif max(ords) < lw and push_left:
            lpush.append(c)
        elif min(ords) >= lw and push_right:
            rpush.append(_shift_refs(c, -lw))
        else:
            keep.append(c)
    if not lpush and not rpush:
        return node
    left, right = join.children
    if lpush:
        left = recurse(pn.FilterNode(_and_all(lpush), left))
    if rpush:
        right = recurse(pn.FilterNode(_and_all(rpush), right))
    out: pn.PlanNode = pn.JoinNode(join.kind, left, right, join.left_keys,
                                   join.right_keys, condition=join.condition)
    if keep:
        out = pn.FilterNode(_and_all(keep), out)
    return out


push_filters_below_joins = _push_filters_below_joins


def estimate_rows(node: pn.PlanNode) -> Optional[int]:
    """Plan-time cardinality estimate; None = unknown (no reordering)."""
    if isinstance(node, pn.ScanNode):
        return node.source.num_rows()
    if isinstance(node, pn.FilterNode):
        c = estimate_rows(node.children[0])
        return None if c is None else max(int(c * _FILTER_SELECTIVITY), 1)
    if isinstance(node, pn.JoinNode):
        le = estimate_rows(node.children[0])
        if node.kind in ("left_semi", "left_anti"):
            return le
        re = estimate_rows(node.children[1])
        if le is None or re is None:
            return None
        return max(le, re) if node.kind == "inner" else le
    if isinstance(node, pn.AggregateNode):
        c = estimate_rows(node.children[0])
        return None if c is None else max(c // 3, 1)
    if isinstance(node, pn.LimitNode):
        c = estimate_rows(node.children[0])
        return node.n if c is None else min(node.n, c)
    if len(node.children) == 1:  # project, sort
        return estimate_rows(node.children[0])
    return None


def _with_children(node: pn.PlanNode, children) -> pn.PlanNode:
    if all(n is o for n, o in zip(children, node.children)):
        return node
    out = copy.copy(node)
    out.children = list(children)
    return out


def _chain(node: pn.PlanNode) -> bool:
    return isinstance(node, pn.JoinNode) and node.kind == "inner" and \
        node.condition is None and bool(node.left_keys)


def _flatten_inner_joins(node: pn.PlanNode):
    """(relations, output ordinal -> (relation, its ordinal), key
    equalities as ((ri, ci), (rj, cj)) pairs) of a join chain."""
    if _chain(node):
        lrels, lmap, ledges = _flatten_inner_joins(node.children[0])
        rrels, rmap, redges = _flatten_inner_joins(node.children[1])
        off = len(lrels)
        rmap = [(ri + off, ci) for ri, ci in rmap]
        redges = [((a + off, b), (c + off, d))
                  for (a, b), (c, d) in redges]
        edges = ledges + redges
        for lk, rk in zip(node.left_keys, node.right_keys):
            edges.append((lmap[lk], rmap[rk]))
        return lrels + rrels, lmap + rmap, edges
    width = len(node.output_schema().names)
    return [node], [(0, i) for i in range(width)], []


def _greedy_order(n: int, edges, est) -> Optional[List[int]]:
    adj = {i: set() for i in range(n)}
    for (ri, _), (rj, _) in edges:
        adj[ri].add(rj)
        adj[rj].add(ri)
    start = max(range(n), key=lambda i: est[i])
    order, placed = [start], {start}
    while len(order) < n:
        cand = [i for i in range(n) if i not in placed and adj[i] & placed]
        if not cand:
            return None  # disconnected: keep the written order
        nxt = min(cand, key=lambda i: est[i])
        order.append(nxt)
        placed.add(nxt)
    return order


@_memoized
def _reorder_joins(node: pn.PlanNode, recurse) -> pn.PlanNode:
    """``node`` with every join chain of three or more relations in the
    reference's greedy order (top down, so a chain flattens whole)."""
    if not _chain(node):
        return _with_children(node, [recurse(c) for c in node.children])
    rels, _colmap, edges = _flatten_inner_joins(node)
    est = [estimate_rows(r) for r in rels]
    order = None if len(rels) < 3 or any(e is None for e in est) else \
        _greedy_order(len(rels), edges, est)
    if order is None or order == list(range(len(rels))):
        return _with_children(node, [recurse(c) for c in node.children])
    rels = [recurse(r) for r in rels]
    # left-deep in greedy order; a relation joins on every key equality
    # that links it to the relations already placed
    offsets = {order[0]: 0}
    cur = rels[order[0]]
    width = len(cur.output_schema().names)
    placed = {order[0]}
    for idx in order[1:]:
        pairs = []
        for (ri, ci), (rj, cj) in edges:
            if ri in placed and rj == idx:
                pairs.append((offsets[ri] + ci, cj))
            elif rj in placed and ri == idx:
                pairs.append((offsets[rj] + cj, ci))
        pairs = list(dict.fromkeys(pairs))
        cur = pn.JoinNode("inner", cur, rels[idx], [p[0] for p in pairs],
                          [p[1] for p in pairs])
        offsets[idx] = width
        width += len(rels[idx].output_schema().names)
        placed.add(idx)
    out = node.output_schema()
    exprs = []
    for ri, rel in enumerate(rels):
        for ci, t in enumerate(rel.output_schema().types):
            exprs.append(Alias(BoundReference(offsets[ri] + ci, t),
                               out.names[len(exprs)]))
    return pn.ProjectNode(exprs, cur, names=list(out.names))


reorder_joins = _reorder_joins


@_memoized
def _rewrite_distinct_aggregates(node: pn.PlanNode, recurse) -> pn.PlanNode:
    """``node`` with every distinct count or sum rewritten to a dedup
    group-by and a plain aggregate over it (bottom up; a subtree that
    occurs twice is rewritten once)."""
    return _rewrite_distinct_one(
        _with_children(node, [recurse(c) for c in node.children]))


rewrite_distinct_aggregates = _rewrite_distinct_aggregates


def _rewrite_distinct_one(node: pn.PlanNode) -> pn.PlanNode:
    if not isinstance(node, pn.AggregateNode):
        return node
    dist = [a for a in node.aggs if a.fn.distinct]
    plain = [a for a in node.aggs if not a.fn.distinct]
    if not dist:
        return node
    decomposable = (aggfn.Count, aggfn.Sum, aggfn.Min, aggfn.Max,
                    aggfn.Average)
    if not all(type(a.fn) in (aggfn.Count, aggfn.Sum) and a.fn.children
               for a in dist) or \
            not all(type(a.fn) in decomposable for a in plain):
        raise NotImplementedError(
            "a distinct aggregate beside " + ", ".join(
                type(a.fn).__name__ for a in node.aggs) +
            " is not ported yet")
    x_in = dist[0].fn.children[0]
    if any(repr(a.fn.children[0]) != repr(x_in) for a in dist[1:]):
        raise NotImplementedError(
            "distinct aggregates over more than one input are not ported "
            "yet")

    nkeys = len(node.grouping)
    inner_aggs, inner_ords = [], {}
    for a in plain:
        i0 = len(inner_aggs)
        if isinstance(a.fn, aggfn.Average):
            # avg is no avg of avgs: a sum and a count, divided at the end
            inner_aggs += [pn.AggCall(aggfn.Sum(a.fn.children[0]), f"_p{i0}"),
                           pn.AggCall(aggfn.Count(a.fn.children[0]),
                                      f"_p{i0 + 1}")]
            inner_ords[id(a)] = [i0, i0 + 1]
        else:
            inner_aggs.append(pn.AggCall(type(a.fn)(*a.fn.children),
                                         f"_p{i0}"))
            inner_ords[id(a)] = [i0]
    inner = pn.AggregateNode(
        list(node.grouping) + [x_in], inner_aggs, node.children[0],
        grouping_names=list(node.grouping_names) + ["__distinct"])
    x = BoundReference(nkeys, x_in.dtype)
    outer_aggs, out_spec = [], []  # ("ref", j) | ("coalesce0", j) | div

    def partial(o):
        return BoundReference(nkeys + 1 + o, inner_aggs[o].fn.dtype)

    for a in node.aggs:
        if a.fn.distinct:
            out_spec.append(("ref", len(outer_aggs)))
            outer_aggs.append(pn.AggCall(type(a.fn)(x), a.name))
            continue
        ords = inner_ords[id(a)]
        if isinstance(a.fn, aggfn.Average):
            out_spec.append(("div", len(outer_aggs), len(outer_aggs) + 1))
            outer_aggs += [pn.AggCall(aggfn.Sum(partial(o)),
                                      f"{a.name}_{o}") for o in ords]
            continue
        merge = aggfn.Sum if isinstance(a.fn, (aggfn.Count, aggfn.Sum)) \
            else type(a.fn)
        # an ungrouped count merges through a sum, null over no rows
        kind = "coalesce0" if not node.grouping and \
            isinstance(a.fn, aggfn.Count) else "ref"
        out_spec.append((kind, len(outer_aggs)))
        outer_aggs.append(pn.AggCall(merge(partial(ords[0])), a.name))
    out = pn.AggregateNode(
        [BoundReference(i, e.dtype) for i, e in enumerate(node.grouping)],
        outer_aggs, inner, grouping_names=list(node.grouping_names))
    if all(spec[0] == "ref" for spec in out_spec):
        return out
    schema = out.output_schema()

    def col(j) -> Expression:
        return BoundReference(nkeys + j, schema.types[nkeys + j])

    exprs = [Alias(BoundReference(i, schema.types[i]), schema.names[i])
             for i in range(nkeys)]
    for spec, a in zip(out_spec, node.aggs):
        if spec[0] == "ref":
            e = col(spec[1])
        elif spec[0] == "coalesce0":
            e = If(IsNotNull(col(spec[1])), col(spec[1]),
                   Literal(0, dt.INT64))
        else:
            e = Divide(col(spec[1]), col(spec[2]))
        exprs.append(Alias(e, a.name))
    return pn.ProjectNode(exprs, out,
                          names=list(node.grouping_names) +
                          [a.name for a in node.aggs])
