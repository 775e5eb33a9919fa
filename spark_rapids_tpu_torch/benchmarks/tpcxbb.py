"""TPCx-BB q26 over in-memory tables (the counterpart of
spark_rapids_tpu/benchmarks/tpcxbb.py ``q26``), and a numpy oracle. The
plan runs on the default (fused) exec tree; ``tpch.query_conf("q26",
fused=False)`` is the conf of the unfused one."""
from __future__ import annotations

from typing import Dict

import numpy as np

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.expressions import predicates as P
from spark_rapids_tpu_torch.expressions.aggregates import Count
from spark_rapids_tpu_torch.expressions.base import (Alias, BoundReference,
                                                     Literal)
from spark_rapids_tpu_torch.expressions.conditional import If
from spark_rapids_tpu_torch.ops.sortkeys import SortKeySpec
from spark_rapids_tpu_torch.plan import nodes as pn

Q26_SS_COLUMNS = ["ss_item_sk", "ss_customer_sk"]
Q26_ITEM_COLUMNS = ["i_item_sk", "i_category", "i_class_id"]


def ref(i, t):
    return BoundReference(i, t)


def _count_if(cond):
    """count(CASE WHEN cond THEN 1 ELSE NULL END)"""
    return Count(If(cond, Literal(1, dt.INT64), Literal(None, dt.INT64)))


def q26(store_sales: Dict[str, np.ndarray],
        item: Dict[str, np.ndarray]) -> pn.PlanNode:
    """Per-customer class-id purchase counts over Books, HAVING count > 5,
    ORDER BY customer (TpcxbbLikeSpark.scala:1968-2014; class ids reduced
    to 8 as in the reference)."""
    ss = pn.FilterNode(
        P.IsNotNull(ref(1, dt.INT64)),
        pn.ScanNode(pn.InMemorySource(
            {c: store_sales[c] for c in Q26_SS_COLUMNS})))
    it = pn.FilterNode(
        P.In(ref(1, dt.STRING), [Literal("Books")]),
        pn.ScanNode(pn.InMemorySource(
            {c: item[c] for c in Q26_ITEM_COLUMNS})))
    # [ss_item_sk 0, ss_customer_sk 1, i_item_sk 2, i_category 3,
    #  i_class_id 4]
    j = pn.JoinNode("inner", ss, it, [0], [0])
    class_id = ref(4, dt.INT32)
    aggs = [pn.AggCall(_count_if(P.EqualTo(class_id,
                                           Literal(k, dt.INT32))),
                       f"id{k}") for k in range(1, 9)]
    aggs.append(pn.AggCall(Count(ref(0, dt.INT64)), "cnt"))
    agg = pn.AggregateNode([ref(1, dt.INT64)], aggs, j,
                           grouping_names=["cid"])
    having = pn.FilterNode(P.GreaterThan(ref(9, dt.INT64),
                                         Literal(5, dt.INT64)), agg)
    proj = pn.ProjectNode(
        [Alias(ref(0, dt.INT64), "cid")] +
        [Alias(ref(k, dt.INT64), f"id{k}") for k in range(1, 9)],
        having)
    return pn.SortNode([SortKeySpec.spark_default(0)], proj)


def q26_numpy(store_sales: Dict[str, np.ndarray],
              item: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The same query in plain numpy: look up each sale's item (item keys
    are unique), keep Books, count per customer and class."""
    sk = np.asarray(item["i_item_sk"], dtype=np.int64)
    books = item["i_category"].to_objects() == "Books"
    size = int(max(sk.max(initial=0),
                   store_sales["ss_item_sk"].max(initial=0))) + 1
    is_book = np.zeros(size, dtype=bool)
    is_book[sk[books]] = True
    cls = np.zeros(size, dtype=np.int64)
    cls[sk[books]] = item["i_class_id"][books]
    ss_item = store_sales["ss_item_sk"]
    hit = is_book[ss_item]
    cid = store_sales["ss_customer_sk"][hit]
    c = cls[ss_item[hit]]
    uniq, inv = np.unique(cid, return_inverse=True)
    cnt = np.bincount(inv, minlength=len(uniq))
    keep = cnt > 5
    out = {"cid": uniq[keep]}
    for k in range(1, 9):
        out[f"id{k}"] = np.bincount(inv[c == k],
                                    minlength=len(uniq))[keep].astype(
                                        np.int64)
    return out
