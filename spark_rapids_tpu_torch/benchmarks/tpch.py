"""TPC-H q14 and q22 over in-memory tables (the counterpart of
spark_rapids_tpu/benchmarks/tpch.py ``q14`` and ``q22``, the same plan
trees), and numpy oracles."""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from spark_rapids_tpu_torch.benchmarks.datagen import days
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.expressions import arithmetic as ar
from spark_rapids_tpu_torch.expressions import predicates as P
from spark_rapids_tpu_torch.expressions.aggregates import (Average, Count,
                                                           Sum)
from spark_rapids_tpu_torch.expressions.base import (Alias, BoundReference,
                                                     Literal)
from spark_rapids_tpu_torch.expressions.conditional import If
from spark_rapids_tpu_torch.expressions.strings import StartsWith, Substring
from spark_rapids_tpu_torch.ops.sortkeys import SortKeySpec
from spark_rapids_tpu_torch.plan import nodes as pn

Table = Dict[str, np.ndarray]

_TYPES = {"l_partkey": dt.INT64, "l_extendedprice": dt.FLOAT64,
          "l_discount": dt.FLOAT64, "l_shipdate": dt.DATE,
          "p_partkey": dt.INT64, "p_type": dt.STRING,
          "c_custkey": dt.INT64, "c_acctbal": dt.FLOAT64,
          "c_phone": dt.STRING, "o_custkey": dt.INT64}

Q14_FROM, Q14_TO = "1995-09-01", "1995-10-01"
Q22_CODES = ("13", "31", "23", "29", "30")


def ref(i, t):
    return BoundReference(i, t)


def _scan(table: Table, columns: List[str]) -> pn.ScanNode:
    return pn.ScanNode(pn.InMemorySource(
        {c: table[c] for c in columns},
        Schema(columns, [_TYPES[c] for c in columns])))


def _lit_one(plan: pn.PlanNode, names) -> pn.PlanNode:
    """A constant key column appended: the decorrelation that turns a
    scalar subquery into an equi-join on lit(1)."""
    types = plan.output_schema().types
    exprs = [ref(i, t) for i, t in enumerate(types)]
    exprs.append(Literal(1, dt.INT64))
    return pn.ProjectNode(exprs, plan, list(names) + ["one"])


def q14(lineitem: Table, part: Table) -> pn.PlanNode:
    """Promotion effect: the promo share of one month's revenue."""
    li = pn.FilterNode(
        P.And(P.GreaterThanOrEqual(ref(3, dt.DATE),
                                   Literal(days(Q14_FROM), dt.DATE)),
              P.LessThan(ref(3, dt.DATE), Literal(days(Q14_TO), dt.DATE))),
        _scan(lineitem, ["l_partkey", "l_extendedprice", "l_discount",
                         "l_shipdate"]))
    # + [p_partkey 4, p_type 5]
    j = pn.JoinNode("inner", li, _scan(part, ["p_partkey", "p_type"]),
                    [0], [0])
    rev = ar.Multiply(ref(1, dt.FLOAT64),
                      ar.Subtract(Literal(1.0), ref(2, dt.FLOAT64)))
    promo = If(StartsWith(ref(5, dt.STRING), "PROMO"), rev, Literal(0.0))
    proj = pn.ProjectNode([Alias(promo, "promo_rev"), Alias(rev, "rev")], j)
    agg = pn.AggregateNode(
        [], [pn.AggCall(Sum(ref(0, dt.FLOAT64)), "sum_promo"),
             pn.AggCall(Sum(ref(1, dt.FLOAT64)), "sum_rev")], proj)
    ratio = ar.Multiply(Literal(100.0), ar.Divide(ref(0, dt.FLOAT64),
                                                  ref(1, dt.FLOAT64)))
    return pn.ProjectNode([Alias(ratio, "promo_revenue")], agg)


def q22(customer: Table, orders: Table) -> pn.PlanNode:
    """Global sales opportunity: phone-prefix filter, above-average
    balance (decorrelated through lit(1)), anti join against orders."""
    cust = _scan(customer, ["c_custkey", "c_acctbal", "c_phone"])
    with_cc = pn.ProjectNode(
        [ref(0, dt.INT64), ref(1, dt.FLOAT64),
         Substring(ref(2, dt.STRING), 1, 2)],
        cust, ["c_custkey", "c_acctbal", "cntrycode"])
    sel = pn.FilterNode(P.In(ref(2, dt.STRING),
                             [Literal(c) for c in Q22_CODES]), with_cc)
    pos = pn.FilterNode(P.GreaterThan(ref(1, dt.FLOAT64), Literal(0.0)),
                        sel)
    avg_bal = pn.AggregateNode(
        [], [pn.AggCall(Average(ref(1, dt.FLOAT64)), "avg_bal")], pos)
    avg_keyed = _lit_one(avg_bal, ["avg_bal"])
    sel_keyed = _lit_one(sel, ["c_custkey", "c_acctbal", "cntrycode"])
    # [c_custkey 0, c_acctbal 1, cntrycode 2, one 3, avg_bal 4, one 5]
    j = pn.JoinNode("inner", sel_keyed, avg_keyed, [3], [1])
    rich = pn.FilterNode(P.GreaterThan(ref(1, dt.FLOAT64),
                                       ref(4, dt.FLOAT64)), j)
    no_orders = pn.JoinNode("left_anti", rich,
                            _scan(orders, ["o_custkey"]), [0], [0])
    agg = pn.AggregateNode(
        [ref(2, dt.STRING)],
        [pn.AggCall(Count(), "numcust"),
         pn.AggCall(Sum(ref(1, dt.FLOAT64)), "totacctbal")],
        no_orders, grouping_names=["cntrycode"])
    return pn.SortNode([SortKeySpec.spark_default(0)], agg)


def q14_numpy(lineitem: Table, part: Table) -> Table:
    """q14 in plain numpy: ``promo_revenue``, None when the month has no
    matched revenue."""
    d = lineitem["l_shipdate"]
    live = (d >= days(Q14_FROM)) & (d < days(Q14_TO))
    key = lineitem["l_partkey"][live]
    rev = lineitem["l_extendedprice"][live] * \
        (1.0 - lineitem["l_discount"][live])
    pk = np.asarray(part["p_partkey"], dtype=np.int64)
    size = int(max(pk.max(initial=0), key.max(initial=0))) + 1
    known = np.zeros(size, dtype=bool)
    known[pk] = True
    promo = np.zeros(size, dtype=bool)
    promo[pk] = np.char.startswith(
        np.asarray(part["p_type"]).astype(str), "PROMO")
    hit = known[key]
    total = rev[hit].sum()
    value = None if not hit.any() or total == 0 else \
        100.0 * (rev[hit & promo[key]].sum() / total)
    return {"promo_revenue": np.array([value], dtype=object
                                      if value is None else np.float64)}


def q22_numpy(customer: Table, orders: Table) -> Table:
    """q22 in plain numpy: per country code, the selected customers whose
    balance exceeds the selection's average positive balance and who
    have no order."""
    cc = np.asarray(customer["c_phone"]).astype("U2")
    bal = customer["c_acctbal"]
    sel = np.isin(cc, Q22_CODES)
    positive = sel & (bal > 0.0)
    keep = np.zeros(len(bal), dtype=bool)
    if positive.any():
        keep = sel & (bal > bal[positive].mean())
    keep &= ~np.isin(customer["c_custkey"], orders["o_custkey"])
    codes, inv = np.unique(cc[keep], return_inverse=True)
    return {"cntrycode": codes.astype(object),
            "numcust": np.bincount(inv, minlength=len(codes)
                                   ).astype(np.int64),
            "totacctbal": np.bincount(inv, weights=bal[keep],
                                      minlength=len(codes)
                                      ).astype(np.float64)}
