"""Greedy join reordering (the counterpart of the join-order part of
spark_rapids_tpu/plan/optimizer.py, which the reference's
``apply_overrides`` runs by default, fusion and adaptive execution off
included).

A maximal chain of condition-free inner equi-joins over three or more
relations is rebuilt left-deep: it starts from the relation of most
estimated rows (the fact table stays the stream side) and joins the
smallest relation connected to those placed so far, so each build side
is the smaller one. A projection on top restores the written column
order. Row estimates are the reference's: a scan's row count, 0.3 of the
child's rows for a filter, a third for an aggregate. The port's
in-memory sources carry no footer statistics, so a join's estimate is
the larger side's, as the reference's is for in-memory sources.

Only the reorder is ported. The reference's ``optimize`` first runs
``collapse_project`` and ``push_filters_below_joins`` twice and
``collapse_project`` after the reorder; those passes are not ported, so
a plan whose filters sit above its joins can be estimated, and ordered,
otherwise than there. The plans the port runs (TPC-H q3, TPC-DS q91 as
``plan_statement`` gives it) are held to the reference's order in
``tests/test_torch_tpch.py``.
"""
from __future__ import annotations

import copy
from typing import List, Optional

from spark_rapids_tpu_torch.expressions.base import Alias, BoundReference
from spark_rapids_tpu_torch.plan import nodes as pn

_FILTER_SELECTIVITY = 0.3


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


def reorder_joins(node: pn.PlanNode) -> pn.PlanNode:
    """``node`` with every join chain of three or more relations in the
    reference's greedy order (top down, so a chain flattens whole)."""
    if not _chain(node):
        return _with_children(node, [reorder_joins(c)
                                     for c in node.children])
    rels, _colmap, edges = _flatten_inner_joins(node)
    est = [estimate_rows(r) for r in rels]
    order = None if len(rels) < 3 or any(e is None for e in est) else \
        _greedy_order(len(rels), edges, est)
    if order is None or order == list(range(len(rels))):
        return _with_children(node, [reorder_joins(c)
                                     for c in node.children])
    rels = [reorder_joins(r) for r in rels]
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
