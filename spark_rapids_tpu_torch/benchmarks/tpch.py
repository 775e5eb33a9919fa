"""TPC-H q1, q3, q4, q6, q12-q16, q18, q21 and q22 over in-memory tables
(the counterpart of spark_rapids_tpu/benchmarks/tpch.py's functions of
those names, the same plan trees, q18's lowered threshold included), and
numpy oracles. String columns are ``HostStrings``
(``benchmarks/datagen.py``); the oracles read their codes and
dictionaries."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from spark_rapids_tpu_torch.benchmarks.datagen import days
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.expressions import arithmetic as ar
from spark_rapids_tpu_torch.expressions import predicates as P
from spark_rapids_tpu_torch.expressions.aggregates import (Average, Count,
                                                           Max, Sum)
from spark_rapids_tpu_torch.expressions.base import (Alias, BoundReference,
                                                     Literal)
from spark_rapids_tpu_torch.expressions.conditional import If
from spark_rapids_tpu_torch.expressions.strings import StartsWith, Substring
from spark_rapids_tpu_torch.io.hoststrings import HostStrings
from spark_rapids_tpu_torch.ops.sortkeys import SortKeySpec
from spark_rapids_tpu_torch.plan import nodes as pn

Table = Dict[str, np.ndarray]

_TYPES = {"l_orderkey": dt.INT64, "l_partkey": dt.INT64,
          "l_quantity": dt.FLOAT64, "l_extendedprice": dt.FLOAT64,
          "l_discount": dt.FLOAT64, "l_tax": dt.FLOAT64,
          "l_returnflag": dt.STRING, "l_linestatus": dt.STRING,
          "l_shipdate": dt.DATE, "l_commitdate": dt.DATE,
          "l_receiptdate": dt.DATE, "l_shipmode": dt.STRING,
          "p_partkey": dt.INT64, "p_type": dt.STRING,
          "c_custkey": dt.INT64, "c_mktsegment": dt.STRING,
          "c_acctbal": dt.FLOAT64, "c_phone": dt.STRING,
          "o_orderkey": dt.INT64, "o_custkey": dt.INT64,
          "o_orderdate": dt.DATE, "o_orderpriority": dt.STRING,
          "o_shippriority": dt.INT32, "l_suppkey": dt.INT64,
          "o_totalprice": dt.FLOAT64, "o_orderstatus": dt.STRING,
          "c_name": dt.STRING, "c_nationkey": dt.INT64,
          "p_brand": dt.STRING, "p_size": dt.INT32, "s_suppkey": dt.INT64,
          "s_nationkey": dt.INT64, "s_acctbal": dt.FLOAT64,
          "n_nationkey": dt.INT64, "n_name": dt.STRING,
          "r_regionkey": dt.INT64, "r_name": dt.STRING,
          "ps_partkey": dt.INT64, "ps_suppkey": dt.INT64}

Q1_SHIPPED_BY = "1998-09-02"
Q3_SEGMENT, Q3_DATE = "BUILDING", "1995-03-15"
Q6_FROM, Q6_TO = "1994-01-01", "1995-01-01"
Q12_MODES = ("MAIL", "SHIP")
Q12_HIGH = ("1-URGENT", "2-HIGH")
Q12_FROM, Q12_TO = "1994-01-01", "1995-01-01"
Q14_FROM, Q14_TO = "1995-09-01", "1995-10-01"
Q22_CODES = ("13", "31", "23", "29", "30")
Q4_FROM, Q4_TO = "1993-07-01", "1993-10-01"
Q13_EXCLUDED = "1-URGENT"
Q15_FROM, Q15_TO = "1996-01-01", "1996-04-01"
Q16_BRAND, Q16_TYPE = "Brand#45", "MEDIUM"
Q16_SIZES = (49, 14, 23, 45, 19, 3, 36, 9)
Q16_ACCTBAL = -500.0
Q18_QUANTITY = 100.0
Q21_STATUS, Q21_NATION = "F", "SAUDI ARABIA"
#: the tables each query reads, in its function's argument order
INPUTS = {"q1": ("lineitem",), "q3": ("customer", "orders", "lineitem"),
          "q4": ("orders", "lineitem"), "q6": ("lineitem",),
          "q12": ("orders", "lineitem"), "q13": ("customer", "orders"),
          "q14": ("lineitem", "part"), "q15": ("lineitem", "supplier"),
          "q16": ("part", "supplier", "partsupp"),
          "q18": ("lineitem", "orders", "customer"),
          "q21": ("lineitem", "orders", "supplier", "nation"),
          "q22": ("customer", "orders")}


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


def _date(s: str) -> Literal:
    return Literal(days(s), dt.DATE)


def q1(lineitem: Table) -> pn.PlanNode:
    """Pricing summary report: a scan, one filter, a group-by on two
    string columns with eight aggregates, ORDER BY both."""
    scan = _scan(lineitem, ["l_returnflag", "l_linestatus", "l_quantity",
                            "l_extendedprice", "l_discount", "l_tax",
                            "l_shipdate"])
    filt = pn.FilterNode(P.LessThanOrEqual(ref(6, dt.DATE),
                                           _date(Q1_SHIPPED_BY)), scan)
    qty, price = ref(2, dt.FLOAT64), ref(3, dt.FLOAT64)
    disc, tax = ref(4, dt.FLOAT64), ref(5, dt.FLOAT64)
    disc_price = ar.Multiply(price, ar.Subtract(Literal(1.0), disc))
    charge = ar.Multiply(disc_price, ar.Add(Literal(1.0), tax))
    agg = pn.AggregateNode(
        [ref(0, dt.STRING), ref(1, dt.STRING)],
        [pn.AggCall(Sum(qty), "sum_qty"),
         pn.AggCall(Sum(price), "sum_base_price"),
         pn.AggCall(Sum(disc_price), "sum_disc_price"),
         pn.AggCall(Sum(charge), "sum_charge"),
         pn.AggCall(Average(qty), "avg_qty"),
         pn.AggCall(Average(price), "avg_price"),
         pn.AggCall(Average(disc), "avg_disc"),
         pn.AggCall(Count(), "count_order")],
        filt, grouping_names=["l_returnflag", "l_linestatus"])
    return pn.SortNode([SortKeySpec.spark_default(0),
                        SortKeySpec.spark_default(1)], agg)


def q6(lineitem: Table) -> pn.PlanNode:
    """Forecasting revenue change: one tight filter, a grand sum."""
    scan = _scan(lineitem, ["l_extendedprice", "l_discount", "l_quantity",
                            "l_shipdate"])
    d = ref(3, dt.DATE)
    cond = P.And(
        P.And(P.GreaterThanOrEqual(d, _date(Q6_FROM)),
              P.LessThan(d, _date(Q6_TO))),
        P.And(P.And(P.GreaterThanOrEqual(ref(1, dt.FLOAT64),
                                         Literal(0.05)),
                    P.LessThanOrEqual(ref(1, dt.FLOAT64), Literal(0.07))),
              P.LessThan(ref(2, dt.FLOAT64), Literal(24.0))))
    revenue = ar.Multiply(ref(0, dt.FLOAT64), ref(1, dt.FLOAT64))
    return pn.AggregateNode([], [pn.AggCall(Sum(revenue), "revenue")],
                            pn.FilterNode(cond, scan))


def q3(customer: Table, orders: Table, lineitem: Table) -> pn.PlanNode:
    """Shipping priority: customer and orders and lineitem, each
    filtered, joined, grouped by order, top 10 by revenue. As written,
    lineitem builds; ``apply_overrides`` reorders the chain as the
    reference does, so lineitem streams."""
    cust = pn.FilterNode(P.EqualTo(ref(1, dt.STRING), Literal(Q3_SEGMENT)),
                         _scan(customer, ["c_custkey", "c_mktsegment"]))
    ords = pn.FilterNode(
        P.LessThan(ref(2, dt.DATE), _date(Q3_DATE)),
        _scan(orders, ["o_orderkey", "o_custkey", "o_orderdate",
                       "o_shippriority"]))
    li = pn.FilterNode(
        P.GreaterThan(ref(3, dt.DATE), _date(Q3_DATE)),
        _scan(lineitem, ["l_orderkey", "l_extendedprice", "l_discount",
                         "l_shipdate"]))
    # [c_custkey 0, c_mktsegment 1, o_orderkey 2, o_custkey 3,
    #  o_orderdate 4, o_shippriority 5] + lineitem's at 6..9
    co = pn.JoinNode("inner", cust, ords, [0], [1])
    col = pn.JoinNode("inner", co, li, [2], [0])
    revenue = ar.Multiply(ref(7, dt.FLOAT64),
                          ar.Subtract(Literal(1.0), ref(8, dt.FLOAT64)))
    proj = pn.ProjectNode(
        [Alias(ref(6, dt.INT64), "l_orderkey"),
         Alias(ref(4, dt.DATE), "o_orderdate"),
         Alias(ref(5, dt.INT32), "o_shippriority"),
         Alias(revenue, "rev")], col)
    agg = pn.AggregateNode(
        [ref(0, dt.INT64), ref(1, dt.DATE), ref(2, dt.INT32)],
        [pn.AggCall(Sum(ref(3, dt.FLOAT64)), "revenue")],
        proj, grouping_names=["l_orderkey", "o_orderdate",
                              "o_shippriority"])
    sort = pn.SortNode([SortKeySpec.spark_default(3, ascending=False),
                        SortKeySpec.spark_default(1)], agg)
    return pn.LimitNode(10, sort)


def q12(orders: Table, lineitem: Table) -> pn.PlanNode:
    """Shipping modes and order priority: filtered lineitem joined to
    orders, conditional counts per ship mode."""
    li = pn.FilterNode(
        P.And(P.And(P.In(ref(4, dt.STRING),
                         [Literal(m) for m in Q12_MODES]),
                    P.LessThan(ref(2, dt.DATE), ref(3, dt.DATE))),
              P.And(P.LessThan(ref(1, dt.DATE), ref(2, dt.DATE)),
                    P.And(P.GreaterThanOrEqual(ref(3, dt.DATE),
                                               _date(Q12_FROM)),
                          P.LessThan(ref(3, dt.DATE), _date(Q12_TO))))),
        _scan(lineitem, ["l_orderkey", "l_shipdate", "l_commitdate",
                         "l_receiptdate", "l_shipmode"]))
    # [o_orderkey 0, o_orderpriority 1, l_orderkey 2, ..., l_shipmode 6]
    j = pn.JoinNode("inner", _scan(orders, ["o_orderkey",
                                            "o_orderpriority"]),
                    li, [0], [0])
    is_high = P.In(ref(1, dt.STRING), [Literal(p) for p in Q12_HIGH])
    proj = pn.ProjectNode(
        [Alias(ref(6, dt.STRING), "l_shipmode"),
         Alias(If(is_high, Literal(1), Literal(0)), "high"),
         Alias(If(is_high, Literal(0), Literal(1)), "low")], j)
    agg = pn.AggregateNode(
        [ref(0, dt.STRING)],
        [pn.AggCall(Sum(ref(1, dt.INT64)), "high_line_count"),
         pn.AggCall(Sum(ref(2, dt.INT64)), "low_line_count")],
        proj, grouping_names=["l_shipmode"])
    return pn.SortNode([SortKeySpec.spark_default(0)], agg)


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


def q4(orders: Table, lineitem: Table) -> pn.PlanNode:
    """Order priority checking: one quarter's orders with a late line
    (EXISTS as a left semi join), counted per priority."""
    ords = pn.FilterNode(
        P.And(P.GreaterThanOrEqual(ref(1, dt.DATE), _date(Q4_FROM)),
              P.LessThan(ref(1, dt.DATE), _date(Q4_TO))),
        _scan(orders, ["o_orderkey", "o_orderdate", "o_orderpriority"]))
    li = pn.FilterNode(
        P.LessThan(ref(1, dt.DATE), ref(2, dt.DATE)),
        _scan(lineitem, ["l_orderkey", "l_commitdate", "l_receiptdate"]))
    semi = pn.JoinNode("left_semi", ords, li, [0], [0])
    agg = pn.AggregateNode(
        [ref(2, dt.STRING)], [pn.AggCall(Count(), "order_count")],
        semi, grouping_names=["o_orderpriority"])
    return pn.SortNode([SortKeySpec.spark_default(0)], agg)


def q13(customer: Table, orders: Table) -> pn.PlanNode:
    """Customer distribution: a left join keeps the customers without
    orders, then a count of counts."""
    ords = pn.FilterNode(
        P.Not(P.In(ref(2, dt.STRING), [Literal(Q13_EXCLUDED)])),
        _scan(orders, ["o_orderkey", "o_custkey", "o_orderpriority"]))
    # [c_custkey, o_orderkey 1, o_custkey 2, o_orderpriority 3]
    co = pn.JoinNode("left", _scan(customer, ["c_custkey"]), ords, [0], [1])
    counts = pn.AggregateNode(
        [ref(0, dt.INT64)], [pn.AggCall(Count(ref(1, dt.INT64)), "c_count")],
        co, grouping_names=["c_custkey"])
    dist = pn.AggregateNode(
        [ref(1, dt.INT64)], [pn.AggCall(Count(), "custdist")],
        counts, grouping_names=["c_count"])
    return pn.SortNode([SortKeySpec.spark_default(1, ascending=False),
                        SortKeySpec.spark_default(0, ascending=False)],
                       dist)


def q15(lineitem: Table, supplier: Table) -> pn.PlanNode:
    """Top supplier: the suppliers whose quarter's revenue equals the
    greatest (the scalar MAX subquery joined on lit(1))."""
    li = pn.FilterNode(
        P.And(P.GreaterThanOrEqual(ref(3, dt.DATE), _date(Q15_FROM)),
              P.LessThan(ref(3, dt.DATE), _date(Q15_TO))),
        _scan(lineitem, ["l_suppkey", "l_extendedprice", "l_discount",
                         "l_shipdate"]))
    rev = ar.Multiply(ref(1, dt.FLOAT64),
                      ar.Subtract(Literal(1.0), ref(2, dt.FLOAT64)))
    proj = pn.ProjectNode([Alias(ref(0, dt.INT64), "supplier_no"),
                           Alias(rev, "rev")], li)
    revenue = pn.AggregateNode(
        [ref(0, dt.INT64)], [pn.AggCall(Sum(ref(1, dt.FLOAT64)),
                                        "total_revenue")],
        proj, grouping_names=["supplier_no"])
    max_rev = pn.AggregateNode(
        [], [pn.AggCall(Max(ref(1, dt.FLOAT64)), "max_rev")], revenue)
    # [supplier_no, total_revenue, one 2, max_rev 3, one 4]
    j = pn.JoinNode("inner", _lit_one(revenue, ["supplier_no",
                                                "total_revenue"]),
                    _lit_one(max_rev, ["max_rev"]), [2], [1])
    top = pn.FilterNode(P.EqualTo(ref(1, dt.FLOAT64), ref(3, dt.FLOAT64)),
                        j)
    # + [s_suppkey 5, s_acctbal 6]
    js = pn.JoinNode("inner", top,
                     _scan(supplier, ["s_suppkey", "s_acctbal"]), [0], [0])
    proj2 = pn.ProjectNode([Alias(ref(5, dt.INT64), "s_suppkey"),
                            Alias(ref(1, dt.FLOAT64), "total_revenue")], js)
    return pn.SortNode([SortKeySpec.spark_default(0)], proj2)


def q16(part: Table, supplier: Table, partsupp: Table) -> pn.PlanNode:
    """Parts/supplier relationship: the suppliers of each brand, type and
    size, past a left anti join of the bad suppliers, counted distinct."""
    good_part = pn.FilterNode(
        P.And(P.Not(P.EqualTo(ref(1, dt.STRING), Literal(Q16_BRAND))),
              P.And(P.Not(StartsWith(ref(2, dt.STRING), Q16_TYPE)),
                    P.In(ref(3, dt.INT32), [Literal(k, dt.INT32)
                                            for k in Q16_SIZES]))),
        _scan(part, ["p_partkey", "p_brand", "p_type", "p_size"]))
    bad = pn.FilterNode(
        P.LessThan(ref(1, dt.FLOAT64), Literal(Q16_ACCTBAL)),
        _scan(supplier, ["s_suppkey", "s_acctbal"]))
    ps_ok = pn.JoinNode("left_anti",
                        _scan(partsupp, ["ps_partkey", "ps_suppkey"]), bad,
                        [1], [0])
    # + [p_partkey 2, p_brand 3, p_type 4, p_size 5]
    pp = pn.JoinNode("inner", ps_ok, good_part, [0], [0])
    agg = pn.AggregateNode(
        [ref(3, dt.STRING), ref(4, dt.STRING), ref(5, dt.INT32)],
        [pn.AggCall(Count(ref(1, dt.INT64), distinct=True),
                    "supplier_cnt")],
        pp, grouping_names=["p_brand", "p_type", "p_size"])
    return pn.SortNode([SortKeySpec.spark_default(3, ascending=False),
                        SortKeySpec.spark_default(0),
                        SortKeySpec.spark_default(1),
                        SortKeySpec.spark_default(2)], agg)


def q18(lineitem: Table, orders: Table, customer: Table) -> pn.PlanNode:
    """Large volume customer: the orders of more than ``Q18_QUANTITY``
    units (a grouped filter as a left semi join), joined back to their
    customer and lines, top 100 by price."""
    big = pn.FilterNode(
        P.GreaterThan(ref(1, dt.FLOAT64), Literal(Q18_QUANTITY)),
        pn.AggregateNode([ref(0, dt.INT64)],
                         [pn.AggCall(Sum(ref(1, dt.FLOAT64)), "sq")],
                         _scan(lineitem, ["l_orderkey", "l_quantity"]),
                         grouping_names=["l_orderkey"]))
    ord_big = pn.JoinNode(
        "left_semi", _scan(orders, ["o_orderkey", "o_custkey",
                                    "o_totalprice", "o_orderdate"]),
        big, [0], [0])
    # [o... 0-3, c_custkey 4, c_name 5]
    oc = pn.JoinNode("inner", ord_big,
                     _scan(customer, ["c_custkey", "c_name"]), [1], [0])
    # + [l_orderkey 6, l_quantity 7]
    ocl = pn.JoinNode("inner", oc,
                      _scan(lineitem, ["l_orderkey", "l_quantity"]),
                      [0], [0])
    agg = pn.AggregateNode(
        [ref(5, dt.STRING), ref(4, dt.INT64), ref(0, dt.INT64),
         ref(3, dt.DATE), ref(2, dt.FLOAT64)],
        [pn.AggCall(Sum(ref(7, dt.FLOAT64)), "sum_qty")],
        ocl, grouping_names=["c_name", "c_custkey", "o_orderkey",
                             "o_orderdate", "o_totalprice"])
    sort = pn.SortNode([SortKeySpec.spark_default(4, ascending=False),
                        SortKeySpec.spark_default(3)], agg)
    return pn.LimitNode(100, sort)


def q21(lineitem: Table, orders: Table, supplier: Table, nation: Table
        ) -> pn.PlanNode:
    """Suppliers who kept orders waiting: per order, distinct suppliers
    at all and late (EXISTS / NOT EXISTS decorrelated), failed orders
    with several suppliers and one late, the late lines of those orders,
    counted per Saudi supplier."""
    def li():
        return _scan(lineitem, ["l_orderkey", "l_suppkey", "l_commitdate",
                                "l_receiptdate"])

    def late():
        return pn.FilterNode(P.GreaterThan(ref(3, dt.DATE),
                                           ref(2, dt.DATE)), li())

    def suppliers(child):
        return pn.AggregateNode(
            [ref(0, dt.INT64)],
            [pn.AggCall(Count(ref(1, dt.INT64), distinct=True), "n")],
            child, grouping_names=["l_orderkey"])

    multi = pn.FilterNode(P.GreaterThan(ref(1, dt.INT64),
                                        Literal(1, dt.INT64)),
                          suppliers(li()))
    solo_late = pn.FilterNode(P.EqualTo(ref(1, dt.INT64),
                                        Literal(1, dt.INT64)),
                              suppliers(late()))
    ords = pn.FilterNode(
        P.EqualTo(ref(1, dt.STRING), Literal(Q21_STATUS)),
        _scan(orders, ["o_orderkey", "o_orderstatus"]))
    o1 = pn.JoinNode("left_semi", ords, multi, [0], [0])
    o2 = pn.JoinNode("left_semi", o1, solo_late, [0], [0])
    late_on = pn.JoinNode("left_semi", late(), o2, [0], [0])
    nation_f = pn.FilterNode(
        P.EqualTo(ref(1, dt.STRING), Literal(Q21_NATION)),
        _scan(nation, ["n_nationkey", "n_name"]))
    sn = pn.JoinNode("inner", _scan(supplier, ["s_suppkey", "s_nationkey"]),
                     nation_f, [1], [0])
    # [late 0-3, s_suppkey 4, s_nationkey 5, n_nationkey 6, n_name 7]
    ls = pn.JoinNode("inner", late_on, sn, [1], [0])
    agg = pn.AggregateNode(
        [ref(4, dt.INT64)], [pn.AggCall(Count(), "numwait")],
        ls, grouping_names=["s_suppkey"])
    sort = pn.SortNode([SortKeySpec.spark_default(1, ascending=False),
                        SortKeySpec.spark_default(0)], agg)
    return pn.LimitNode(100, sort)


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
    promo[pk] = _entries(part["p_type"], lambda e: np.char.startswith(
        e, "PROMO"))
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
    cc = _entries(customer["c_phone"], lambda e: e.astype("U2"))
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


# -- oracles of q1, q3, q6 and q12 -------------------------------------------


def _entries(col: HostStrings, fn) -> np.ndarray:
    """``fn`` over the dictionary's entries (a str array), per row."""
    return fn(col.dictionary.astype(str))[col.codes]


def _is(col: HostStrings, values) -> np.ndarray:
    """Per row: whether the string is one of ``values``."""
    return _entries(col, lambda e: np.isin(e, list(values)))


def _lookup(keys: np.ndarray, values: np.ndarray, fill) -> np.ndarray:
    """A dense table over non-negative keys: ``out[keys] = values``, the
    rest ``fill``."""
    out = np.full(int(keys.max(initial=0)) + 1, fill, dtype=values.dtype)
    out[keys] = values
    return out


def q1_numpy(lineitem: Table) -> Table:
    """q1 in plain numpy: per (returnflag, linestatus) in string order."""
    live = lineitem["l_shipdate"] <= days(Q1_SHIPPED_BY)
    rf, ls = lineitem["l_returnflag"], lineitem["l_linestatus"]
    # the dictionaries are sorted, so code order is string order
    pair = rf.codes[live].astype(np.int64) * len(ls.dictionary) + \
        ls.codes[live]
    # the (few) pairs present, in order, and each row's group
    groups = np.flatnonzero(np.bincount(
        pair, minlength=len(rf.dictionary) * len(ls.dictionary)))
    inv = np.searchsorted(groups, pair)
    qty = lineitem["l_quantity"][live]
    price = lineitem["l_extendedprice"][live]
    disc = lineitem["l_discount"][live]
    disc_price = price * (1.0 - disc)
    charge = disc_price * (1.0 + lineitem["l_tax"][live])
    count = np.bincount(inv, minlength=len(groups))

    def total(x):
        return np.bincount(inv, weights=x, minlength=len(groups))

    return {"l_returnflag": rf.dictionary[groups // len(ls.dictionary)],
            "l_linestatus": ls.dictionary[groups % len(ls.dictionary)],
            "sum_qty": total(qty), "sum_base_price": total(price),
            "sum_disc_price": total(disc_price),
            "sum_charge": total(charge), "avg_qty": total(qty) / count,
            "avg_price": total(price) / count,
            "avg_disc": total(disc) / count,
            "count_order": count.astype(np.int64)}


def q6_numpy(lineitem: Table) -> Table:
    """q6 in plain numpy: one row, None when no row passes."""
    d, disc = lineitem["l_shipdate"], lineitem["l_discount"]
    live = ((d >= days(Q6_FROM)) & (d < days(Q6_TO)) & (disc >= 0.05) &
            (disc <= 0.07) & (lineitem["l_quantity"] < 24.0))
    if not live.any():
        return {"revenue": np.array([None], dtype=object)}
    return {"revenue": np.array([(lineitem["l_extendedprice"][live] *
                                  disc[live]).sum()])}


def q3_numpy(customer: Table, orders: Table, lineitem: Table) -> Table:
    """q3 in plain numpy: order keys are unique, so each lineitem row
    looks its order (and the order its customer) up by key."""
    building = _lookup(customer["c_custkey"],
                       _is(customer["c_mktsegment"], [Q3_SEGMENT]), False)
    ok = orders["o_orderdate"] < days(Q3_DATE)
    cust = orders["o_custkey"]
    ok &= (cust < len(building)) & building[np.minimum(cust,
                                                       len(building) - 1)]
    okey = orders["o_orderkey"]
    order_at = _lookup(okey[ok], np.flatnonzero(ok), -1)
    li = lineitem["l_shipdate"] > days(Q3_DATE)
    lk = lineitem["l_orderkey"]
    at = np.full(len(lk), -1, dtype=np.int64)
    inside = li & (lk < len(order_at))
    at[inside] = order_at[lk[inside]]
    hit = at >= 0
    rev = lineitem["l_extendedprice"][hit] * \
        (1.0 - lineitem["l_discount"][hit])
    keys, inv = np.unique(lk[hit], return_inverse=True)
    sums = np.bincount(inv, weights=rev, minlength=len(keys))
    first = at[hit][np.unique(inv, return_index=True)[1]]
    date = orders["o_orderdate"][first]
    top = np.lexsort((date, -sums))[:10]
    return {"l_orderkey": keys[top], "o_orderdate": date[top],
            "o_shippriority": orders["o_shippriority"][first][top],
            "revenue": sums[top]}


def q12_numpy(orders: Table, lineitem: Table) -> Table:
    """q12 in plain numpy: per ship mode in string order, the matched
    lines of urgent or high priority orders and of the rest."""
    ship, commit = lineitem["l_shipdate"], lineitem["l_commitdate"]
    receipt = lineitem["l_receiptdate"]
    mode = lineitem["l_shipmode"]
    live = (_is(mode, Q12_MODES) & (commit < receipt) & (ship < commit) &
            (receipt >= days(Q12_FROM)) & (receipt < days(Q12_TO)))
    high = _lookup(orders["o_orderkey"],
                   _is(orders["o_orderpriority"], Q12_HIGH).astype(np.int8),
                   -1)
    lk = lineitem["l_orderkey"][live]
    h = np.where(lk < len(high), high[np.minimum(lk, len(high) - 1)], -1)
    codes = mode.codes[live][h >= 0]
    h = h[h >= 0]
    groups, inv = np.unique(codes, return_inverse=True)
    return {"l_shipmode": mode.dictionary[groups],
            "high_line_count": np.bincount(inv, weights=h,
                                           minlength=len(groups)
                                           ).astype(np.int64),
            "low_line_count": np.bincount(inv, weights=1 - h,
                                          minlength=len(groups)
                                          ).astype(np.int64)}


# -- oracles of q4, q13, q15, q16, q18 and q21 -------------------------------


def _counted(codes: np.ndarray, dictionary: np.ndarray, name: str,
             count: str) -> Table:
    """Rows per string code, the codes present in string order."""
    groups, n = np.unique(codes, return_counts=True)
    return {name: dictionary[groups], count: n.astype(np.int64)}


def _runs(sorted_keys: np.ndarray) -> Tuple:
    """(each distinct key of a sorted array, its run length)."""
    starts = np.flatnonzero(np.r_[True, sorted_keys[1:] != sorted_keys[:-1]]
                            ) if len(sorted_keys) else np.zeros(0, np.int64)
    return sorted_keys[starts], np.diff(np.r_[starts, len(sorted_keys)])


def _distinct_per(key: np.ndarray, value: np.ndarray) -> Tuple:
    """(keys, the number of distinct values of each), for non-negative
    values whose product with the keys fits an int64; by one sort (no
    ``np.unique``, which numpy 2.3 runs in minutes on 60M sorted
    integers)."""
    span = int(value.max(initial=0)) + 1
    pairs = _runs(np.sort(key.astype(np.int64) * span + value))[0]
    return _runs(pairs // span)


def _member(a: np.ndarray, of: np.ndarray) -> np.ndarray:
    """Per element of ``a`` (non-negative integers): whether it is in
    ``of``, looked up in a table over their range."""
    table = np.zeros(int(max(a.max(initial=0), of.max(initial=0))) + 1,
                     dtype=bool)
    table[of] = True
    return table[a]


def q4_numpy(orders: Table, lineitem: Table) -> Table:
    """q4 in plain numpy: per priority, in string order."""
    d = orders["o_orderdate"]
    late = lineitem["l_commitdate"] < lineitem["l_receiptdate"]
    live = (d >= days(Q4_FROM)) & (d < days(Q4_TO)) & \
        np.isin(orders["o_orderkey"], lineitem["l_orderkey"][late])
    prio = orders["o_orderpriority"]
    return _counted(prio.codes[live], prio.dictionary, "o_orderpriority",
                    "order_count")


def q13_numpy(customer: Table, orders: Table) -> Table:
    """q13 in plain numpy: customers per order count (orders of priority
    ``Q13_EXCLUDED`` left out), most customers first."""
    keep = ~_is(orders["o_orderpriority"], [Q13_EXCLUDED])
    cust = customer["c_custkey"]
    per = np.bincount(orders["o_custkey"][keep],
                      minlength=int(cust.max(initial=0)) + 1)
    c_count, custdist = np.unique(per[cust], return_counts=True)
    top = np.lexsort((-c_count, -custdist))
    return {"c_count": c_count[top].astype(np.int64),
            "custdist": custdist[top].astype(np.int64)}


def q15_numpy(lineitem: Table, supplier: Table) -> Table:
    """q15 in plain numpy: the suppliers of the greatest revenue."""
    d = lineitem["l_shipdate"]
    live = (d >= days(Q15_FROM)) & (d < days(Q15_TO))
    key = lineitem["l_suppkey"][live]
    rev = lineitem["l_extendedprice"][live] * \
        (1.0 - lineitem["l_discount"][live])
    keys, inv = np.unique(key, return_inverse=True)
    total = np.bincount(inv, weights=rev, minlength=len(keys))
    top = (total == total.max()) & np.isin(keys, supplier["s_suppkey"]) \
        if len(keys) else np.zeros(0, dtype=bool)
    return {"s_suppkey": keys[top], "total_revenue": total[top]}


def q16_numpy(part: Table, supplier: Table, partsupp: Table) -> Table:
    """q16 in plain numpy: distinct good suppliers per brand, type and
    size of the chosen parts."""
    ok = (~_is(part["p_brand"], [Q16_BRAND]) &
          ~_entries(part["p_type"],
                    lambda e: np.char.startswith(e, Q16_TYPE)) &
          np.isin(part["p_size"], Q16_SIZES))
    at = _lookup(part["p_partkey"][ok], np.flatnonzero(ok), -1)
    bad = supplier["s_suppkey"][supplier["s_acctbal"] < Q16_ACCTBAL]
    pk, sk = partsupp["ps_partkey"], partsupp["ps_suppkey"]
    row = np.where(pk < len(at), at[np.minimum(pk, len(at) - 1)], -1)
    keep = (row >= 0) & ~np.isin(sk, bad)
    row, sk = row[keep], sk[keep]
    brand, ptype = part["p_brand"], part["p_type"]
    b, t, z = (brand.codes[row].astype(np.int64),
               ptype.codes[row].astype(np.int64),
               part["p_size"][row].astype(np.int64))
    group = (b * len(ptype.dictionary) + t) * 64 + z
    groups, cnt = _distinct_per(group, sk)
    b = groups // 64 // len(ptype.dictionary)
    t = groups // 64 % len(ptype.dictionary)
    z = groups % 64
    top = np.lexsort((z, t, b, -cnt))
    return {"p_brand": brand.dictionary[b[top]],
            "p_type": ptype.dictionary[t[top]],
            "p_size": z[top].astype(np.int32),
            "supplier_cnt": cnt[top].astype(np.int64)}


def q18_numpy(lineitem: Table, orders: Table, customer: Table) -> Table:
    """q18 in plain numpy: orders are unique by key and customers by key,
    so each big order is one group."""
    lk = lineitem["l_orderkey"]
    qty = np.bincount(lk, weights=lineitem["l_quantity"])
    okey = orders["o_orderkey"]
    big = np.flatnonzero((okey < len(qty)) &
                         (qty[np.minimum(okey, len(qty) - 1)] >
                          Q18_QUANTITY))
    name_at = _lookup(customer["c_custkey"],
                      np.arange(len(customer["c_custkey"])), -1)
    cust = orders["o_custkey"][big]
    big = big[name_at[np.minimum(cust, len(name_at) - 1)] >= 0]
    price, date = orders["o_totalprice"][big], orders["o_orderdate"][big]
    top = big[np.lexsort((date, -price))[:100]]
    cust = orders["o_custkey"][top]
    names = customer["c_name"]
    return {"c_name": names.dictionary[names.codes[name_at[cust]]],
            "c_custkey": cust, "o_orderkey": okey[top],
            "o_orderdate": orders["o_orderdate"][top],
            "o_totalprice": orders["o_totalprice"][top],
            "sum_qty": qty[okey[top]]}


def q21_numpy(lineitem: Table, orders: Table, supplier: Table,
              nation: Table) -> Table:
    """q21 in plain numpy: per Saudi supplier, its late lines on failed
    orders with several suppliers of which it alone was late."""
    lk, sk = lineitem["l_orderkey"], lineitem["l_suppkey"]
    late = lineitem["l_receiptdate"] > lineitem["l_commitdate"]
    keys, n_all = _distinct_per(lk, sk)
    late_keys, n_late = _distinct_per(lk[late], sk[late])
    ok = _is(orders["o_orderstatus"], [Q21_STATUS])
    okey = orders["o_orderkey"]
    ok &= _member(okey, keys[n_all > 1]) & \
        _member(okey, late_keys[n_late == 1])
    saudi = nation["n_nationkey"][_is(nation["n_name"], [Q21_NATION])]
    supp = supplier["s_suppkey"][_member(supplier["s_nationkey"], saudi)]
    rows = late & _member(lk, okey[ok]) & _member(sk, supp)
    s_key, numwait = np.unique(sk[rows], return_counts=True)
    top = np.lexsort((s_key, -numwait))[:100]
    return {"s_suppkey": s_key[top], "numwait": numwait[top].astype(np.int64)}
