"""The 22 TPC-H queries over in-memory tables (the counterpart of
spark_rapids_tpu/benchmarks/tpch.py's functions of those names, the same
plan trees, q18's lowered threshold included), and numpy oracles. String
columns are ``HostStrings`` (``benchmarks/datagen.py``); the oracles read
their codes and dictionaries."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from spark_rapids_tpu_torch.benchmarks.datagen import days
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.expressions import arithmetic as ar
from spark_rapids_tpu_torch.expressions import predicates as P
from spark_rapids_tpu_torch.expressions.aggregates import (Average, Count,
                                                           Max, Min, Sum)
from spark_rapids_tpu_torch.expressions.base import (Alias, BoundReference,
                                                     Literal)
from spark_rapids_tpu_torch.expressions.cast import Cast
from spark_rapids_tpu_torch.expressions.conditional import If
from spark_rapids_tpu_torch.expressions.datetime import Year
from spark_rapids_tpu_torch.expressions.strings import (Contains, EndsWith,
                                                        StartsWith,
                                                        Substring)
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
          "ps_partkey": dt.INT64, "ps_suppkey": dt.INT64,
          "l_shipinstruct": dt.STRING, "p_container": dt.STRING,
          "ps_availqty": dt.INT32, "ps_supplycost": dt.FLOAT64,
          "n_regionkey": dt.INT64}

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
Q5_REGION, Q5_FROM, Q5_TO = "ASIA", "1994-01-01", "1995-01-01"
Q10_FROM, Q10_TO, Q10_FLAG = "1993-10-01", "1994-01-01", "R"
Q19_MODES, Q19_INSTRUCT = ("AIR", "REG AIR"), "DELIVER IN PERSON"
#: q19's arms: brand, container prefix, quantity from, to, greatest size
Q19_ARMS = (("Brand#12", "SM", 1, 11, 5), ("Brand#23", "MED", 10, 20, 10),
            ("Brand#34", "LG", 20, 30, 15))
Q2_SIZE, Q2_TYPE, Q2_REGION = 15, "BRASS", "EUROPE"
Q17_BRAND, Q17_CONTAINER = "Brand#23", "MED"
Q7_FROM, Q7_TO, Q7_NATIONS = "1995-01-01", "1996-12-31", ("FRANCE",
                                                          "GERMANY")
Q8_TYPE, Q8_REGION, Q8_NATION = "ECONOMY ANODIZED STEEL", "AMERICA", \
    "BRAZIL"
Q8_FROM, Q8_TO = "1995-01-01", "1996-12-31"
Q9_TYPE = "BRASS"
Q11_NATION, Q11_FRACTION = "GERMANY", 0.0001
Q20_TYPE, Q20_NATION = "STANDARD", "CANADA"
Q20_FROM, Q20_TO = "1994-01-01", "1995-01-01"
#: the tables each query reads, in its function's argument order
INPUTS = {"q1": ("lineitem",), "q3": ("customer", "orders", "lineitem"),
          "q4": ("orders", "lineitem"), "q6": ("lineitem",),
          "q12": ("orders", "lineitem"), "q13": ("customer", "orders"),
          "q14": ("lineitem", "part"), "q15": ("lineitem", "supplier"),
          "q16": ("part", "supplier", "partsupp"),
          "q18": ("lineitem", "orders", "customer"),
          "q21": ("lineitem", "orders", "supplier", "nation"),
          "q22": ("customer", "orders"),
          "q5": ("customer", "orders", "lineitem", "supplier", "nation",
                 "region"),
          "q10": ("customer", "orders", "lineitem", "nation"),
          "q19": ("lineitem", "part"),
          "q2": ("part", "supplier", "partsupp", "nation", "region"),
          "q17": ("lineitem", "part"),
          "q7": ("lineitem", "orders", "customer", "supplier", "nation"),
          "q8": ("lineitem", "part", "orders", "customer", "supplier",
                 "nation", "region"),
          "q9": ("lineitem", "part", "supplier", "partsupp", "orders",
                 "nation"),
          "q11": ("partsupp", "supplier", "nation"),
          "q20": ("lineitem", "part", "partsupp", "supplier", "nation")}


#: a query's conf for ``apply_overrides``: q5's greedy join order (the
#: reference's) joins customer on the nation key alone, about 7e11 rows
#: at sf 10, so it runs in its written order
QUERY_CONF = {"q5": {"rapids.tpu.sql.optimizer.enabled": False}}


def query_conf(query: str, fused: bool = True) -> dict:
    """The conf a query runs with (any of the port's TPC queries): its
    ``QUERY_CONF`` on the default, fused, exec tree, or with
    ``rapids.tpu.sql.fusion.enabled`` false on the unfused one."""
    conf = dict(QUERY_CONF.get(query, {}))
    if not fused:
        conf["rapids.tpu.sql.fusion.enabled"] = False
    return conf


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


# -- q5, q10, q19, q2 and q17 -----------------------------------------------


def _date_range(i: int, lo: str, hi: str, closed: bool = False):
    """``lo <= col i < hi`` (``<= hi`` when ``closed``) over a DATE."""
    upper = P.LessThanOrEqual if closed else P.LessThan
    return P.And(P.GreaterThanOrEqual(ref(i, dt.DATE), _date(lo)),
                 upper(ref(i, dt.DATE), _date(hi)))


def _revenue(price: int, disc: int):
    return ar.Multiply(ref(price, dt.FLOAT64),
                       ar.Subtract(Literal(1.0), ref(disc, dt.FLOAT64)))


def q5(customer: Table, orders: Table, lineitem: Table, supplier: Table,
       nation: Table, region: Table) -> pn.PlanNode:
    """Local supplier volume: a six-table chain whose last join is on two
    keys (supplier and nation), revenue per nation of one region."""
    reg = pn.FilterNode(P.EqualTo(ref(1, dt.STRING), Literal(Q5_REGION)),
                        _scan(region, ["r_regionkey", "r_name"]))
    # [n_nationkey, n_name, n_regionkey, r_regionkey, r_name]
    nr = pn.JoinNode("inner", _scan(nation, ["n_nationkey", "n_name",
                                             "n_regionkey"]),
                     reg, [2], [0])
    # [s_suppkey, s_nationkey, n_nationkey, n_name, ...]
    snr = pn.JoinNode("inner", _scan(supplier, ["s_suppkey", "s_nationkey"]),
                      nr, [1], [0])
    ords = pn.FilterNode(_date_range(2, Q5_FROM, Q5_TO),
                         _scan(orders, ["o_orderkey", "o_custkey",
                                        "o_orderdate"]))
    # [c_custkey, c_nationkey, o_orderkey 2, o_custkey, o_orderdate]
    co = pn.JoinNode("inner", _scan(customer, ["c_custkey", "c_nationkey"]),
                     ords, [0], [1])
    # + [l_orderkey 5, l_suppkey 6, l_extendedprice 7, l_discount 8]
    col = pn.JoinNode("inner", co,
                      _scan(lineitem, ["l_orderkey", "l_suppkey",
                                       "l_extendedprice", "l_discount"]),
                      [2], [0])
    # l_suppkey = s_suppkey and c_nationkey = s_nationkey; n_name at 12
    full = pn.JoinNode("inner", col, snr, [6, 1], [0, 1])
    proj = pn.ProjectNode([Alias(ref(12, dt.STRING), "n_name"),
                           Alias(_revenue(7, 8), "rev")], full)
    agg = pn.AggregateNode(
        [ref(0, dt.STRING)], [pn.AggCall(Sum(ref(1, dt.FLOAT64)),
                                         "revenue")],
        proj, grouping_names=["n_name"])
    return pn.SortNode([SortKeySpec.spark_default(1, ascending=False)], agg)


def q10(customer: Table, orders: Table, lineitem: Table, nation: Table
        ) -> pn.PlanNode:
    """Returned item reporting: a four-table join, a group-by on five
    keys (one a float, two of 1.5M-entry dictionaries), top 20."""
    ords = pn.FilterNode(_date_range(2, Q10_FROM, Q10_TO),
                         _scan(orders, ["o_orderkey", "o_custkey",
                                        "o_orderdate"]))
    li = pn.FilterNode(
        P.EqualTo(ref(3, dt.STRING), Literal(Q10_FLAG)),
        _scan(lineitem, ["l_orderkey", "l_extendedprice", "l_discount",
                         "l_returnflag"]))
    # [c... 0-4, o_orderkey 5, o_custkey 6, o_orderdate 7]
    co = pn.JoinNode("inner", _scan(customer, ["c_custkey", "c_nationkey",
                                               "c_acctbal", "c_name",
                                               "c_phone"]),
                     ords, [0], [1])
    # + [l_orderkey 8, l_extendedprice 9, l_discount 10, l_returnflag 11]
    col = pn.JoinNode("inner", co, li, [5], [0])
    # + [n_nationkey 12, n_name 13]
    con = pn.JoinNode("inner", col, _scan(nation, ["n_nationkey", "n_name"]),
                      [1], [0])
    proj = pn.ProjectNode(
        [Alias(ref(0, dt.INT64), "c_custkey"),
         Alias(ref(3, dt.STRING), "c_name"),
         Alias(ref(2, dt.FLOAT64), "c_acctbal"),
         Alias(ref(4, dt.STRING), "c_phone"),
         Alias(ref(13, dt.STRING), "n_name"),
         Alias(_revenue(9, 10), "rev")], con)
    agg = pn.AggregateNode(
        [ref(0, dt.INT64), ref(1, dt.STRING), ref(2, dt.FLOAT64),
         ref(3, dt.STRING), ref(4, dt.STRING)],
        [pn.AggCall(Sum(ref(5, dt.FLOAT64)), "revenue")],
        proj, grouping_names=["c_custkey", "c_name", "c_acctbal",
                              "c_phone", "n_name"])
    sort = pn.SortNode([SortKeySpec.spark_default(5, ascending=False)], agg)
    return pn.LimitNode(20, sort)


def q19(lineitem: Table, part: Table) -> pn.PlanNode:
    """Discounted revenue: a join on the part key whose residual is an OR
    of three arms over both sides (brand, container prefix, size and
    quantity bands)."""
    li = pn.FilterNode(
        P.And(P.In(ref(4, dt.STRING), [Literal(m) for m in Q19_MODES]),
              P.EqualTo(ref(5, dt.STRING), Literal(Q19_INSTRUCT))),
        _scan(lineitem, ["l_partkey", "l_quantity", "l_extendedprice",
                         "l_discount", "l_shipmode", "l_shipinstruct"]))
    qty = ref(1, dt.FLOAT64)
    # the part's columns land at 6..9
    brand, size, container = ref(7, dt.STRING), ref(8, dt.INT32), \
        ref(9, dt.STRING)

    def arm(brand_lit, prefix, qlo, qhi, smax):
        return P.And(
            P.And(P.EqualTo(brand, Literal(brand_lit)),
                  StartsWith(container, prefix)),
            P.And(P.And(P.GreaterThanOrEqual(qty, Literal(float(qlo))),
                        P.LessThanOrEqual(qty, Literal(float(qhi)))),
                  P.LessThanOrEqual(size, Literal(smax, dt.INT32))))

    a, b, c = (arm(*x) for x in Q19_ARMS)
    j = pn.JoinNode("inner", li,
                    _scan(part, ["p_partkey", "p_brand", "p_size",
                                 "p_container"]),
                    [0], [0], condition=P.Or(P.Or(a, b), c))
    proj = pn.ProjectNode([Alias(_revenue(2, 3), "rev")], j)
    return pn.AggregateNode(
        [], [pn.AggCall(Sum(ref(0, dt.FLOAT64)), "revenue")], proj)


def q2(part: Table, supplier: Table, partsupp: Table, nation: Table,
       region: Table) -> pn.PlanNode:
    """Minimum cost supplier: the least supply cost per part within a
    region (the correlated MIN decorrelated into a group-by), joined back
    to the region's offers of the chosen parts, top 100."""
    prt = pn.FilterNode(
        P.And(P.EqualTo(ref(2, dt.INT32), Literal(Q2_SIZE, dt.INT32)),
              EndsWith(ref(1, dt.STRING), Q2_TYPE)),
        _scan(part, ["p_partkey", "p_type", "p_size"]))
    reg = pn.FilterNode(P.EqualTo(ref(1, dt.STRING), Literal(Q2_REGION)),
                        _scan(region, ["r_regionkey", "r_name"]))
    nr = pn.JoinNode("inner", _scan(nation, ["n_nationkey", "n_name",
                                             "n_regionkey"]),
                     reg, [2], [0])
    # [s_suppkey, s_nationkey, s_acctbal, n_nationkey 3, n_name 4, ...]
    snr = pn.JoinNode("inner", _scan(supplier, ["s_suppkey", "s_nationkey",
                                                "s_acctbal"]),
                      nr, [1], [0])
    # [ps_partkey, ps_suppkey, ps_supplycost, snr 3..10]
    ps_eu = pn.JoinNode("inner", _scan(partsupp, ["ps_partkey", "ps_suppkey",
                                                  "ps_supplycost"]),
                        snr, [1], [0])
    min_cost = pn.AggregateNode(
        [ref(0, dt.INT64)], [pn.AggCall(Min(ref(2, dt.FLOAT64)),
                                        "min_cost")],
        ps_eu, grouping_names=["ps_partkey"])
    # + [p_partkey 11, p_type 12, p_size 13]
    psp = pn.JoinNode("inner", ps_eu, prt, [0], [0])
    # + [ps_partkey 14, min_cost 15]
    pspm = pn.JoinNode("inner", psp, min_cost, [0], [0])
    best = pn.FilterNode(P.EqualTo(ref(2, dt.FLOAT64), ref(15, dt.FLOAT64)),
                         pspm)
    proj = pn.ProjectNode(
        [Alias(ref(5, dt.FLOAT64), "s_acctbal"),
         Alias(ref(7, dt.STRING), "n_name"),
         Alias(ref(0, dt.INT64), "p_partkey"),
         Alias(ref(12, dt.STRING), "p_type"),
         Alias(ref(2, dt.FLOAT64), "ps_supplycost")], best)
    sort = pn.SortNode([SortKeySpec.spark_default(0, ascending=False),
                        SortKeySpec.spark_default(1),
                        SortKeySpec.spark_default(2)], proj)
    return pn.LimitNode(100, sort)


def q17(lineitem: Table, part: Table) -> pn.PlanNode:
    """Small-quantity-order revenue: the average quantity per part over
    all of lineitem, joined back to the lines of the chosen parts."""
    prt = pn.FilterNode(
        P.And(P.EqualTo(ref(1, dt.STRING), Literal(Q17_BRAND)),
              StartsWith(ref(2, dt.STRING), Q17_CONTAINER)),
        _scan(part, ["p_partkey", "p_brand", "p_container"]))

    def li():
        return _scan(lineitem, ["l_partkey", "l_quantity",
                                "l_extendedprice"])

    per_part_avg = pn.AggregateNode(
        [ref(0, dt.INT64)], [pn.AggCall(Average(ref(1, dt.FLOAT64)),
                                        "avg_qty")],
        li(), grouping_names=["l_partkey"])
    # [l... 0-2, p_partkey 3, p_brand 4, p_container 5]
    lp = pn.JoinNode("inner", li(), prt, [0], [0])
    # + [l_partkey 6, avg_qty 7]
    lpa = pn.JoinNode("inner", lp, per_part_avg, [0], [0])
    filt = pn.FilterNode(
        P.LessThan(ref(1, dt.FLOAT64),
                   ar.Multiply(Literal(0.2), ref(7, dt.FLOAT64))), lpa)
    agg = pn.AggregateNode(
        [], [pn.AggCall(Sum(ref(2, dt.FLOAT64)), "sum_rev")], filt)
    return pn.ProjectNode(
        [Alias(ar.Divide(ref(0, dt.FLOAT64), Literal(7.0)), "avg_yearly")],
        agg)


# -- q7, q8, q9, q11 and q20: Year and Cast ---------------------------------


def q7(lineitem: Table, orders: Table, customer: Table, supplier: Table,
       nation: Table) -> pn.PlanNode:
    """Volume shipping: revenue between two nations either way, per
    supplier nation, customer nation and year of shipping."""
    def with_nation(table, cols):
        return pn.JoinNode("inner", _scan(table, cols),
                           _scan(nation, ["n_nationkey", "n_name"]),
                           [1], [0])

    # [s_suppkey, s_nationkey, n_nationkey, supp_nation 3]
    sn = with_nation(supplier, ["s_suppkey", "s_nationkey"])
    # [c_custkey, c_nationkey, n_nationkey, cust_nation 3]
    cn = with_nation(customer, ["c_custkey", "c_nationkey"])
    li = pn.FilterNode(
        _date_range(4, Q7_FROM, Q7_TO, closed=True),
        _scan(lineitem, ["l_orderkey", "l_suppkey", "l_extendedprice",
                         "l_discount", "l_shipdate"]))
    # + [o_orderkey 5, o_custkey 6]
    lo = pn.JoinNode("inner", li, _scan(orders, ["o_orderkey", "o_custkey"]),
                     [0], [0])
    los = pn.JoinNode("inner", lo, sn, [1], [0])        # supp_nation 10
    losc = pn.JoinNode("inner", los, cn, [6], [0])      # cust_nation 14
    a, b = Q7_NATIONS

    def pair(x, y):
        return P.And(P.EqualTo(ref(10, dt.STRING), Literal(x)),
                     P.EqualTo(ref(14, dt.STRING), Literal(y)))

    filt = pn.FilterNode(P.Or(pair(a, b), pair(b, a)), losc)
    proj = pn.ProjectNode(
        [Alias(ref(10, dt.STRING), "supp_nation"),
         Alias(ref(14, dt.STRING), "cust_nation"),
         Alias(Year(ref(4, dt.DATE)), "l_year"),
         Alias(_revenue(2, 3), "volume")], filt)
    agg = pn.AggregateNode(
        [ref(0, dt.STRING), ref(1, dt.STRING), ref(2, dt.INT32)],
        [pn.AggCall(Sum(ref(3, dt.FLOAT64)), "revenue")],
        proj, grouping_names=["supp_nation", "cust_nation", "l_year"])
    return pn.SortNode([SortKeySpec.spark_default(0),
                        SortKeySpec.spark_default(1),
                        SortKeySpec.spark_default(2)], agg)


def q8(lineitem: Table, part: Table, orders: Table, customer: Table,
       supplier: Table, nation: Table, region: Table) -> pn.PlanNode:
    """National market share: one nation's share of a region's revenue
    on one part type, per year (a conditional sum over a ratio)."""
    prt = pn.FilterNode(P.EqualTo(ref(1, dt.STRING), Literal(Q8_TYPE)),
                        _scan(part, ["p_partkey", "p_type"]))
    # + [p_partkey 5, p_type 6]
    lp = pn.JoinNode("inner",
                     _scan(lineitem, ["l_orderkey", "l_partkey", "l_suppkey",
                                      "l_extendedprice", "l_discount"]),
                     prt, [1], [0])
    ords = pn.FilterNode(_date_range(2, Q8_FROM, Q8_TO, closed=True),
                         _scan(orders, ["o_orderkey", "o_custkey",
                                        "o_orderdate"]))
    lpo = pn.JoinNode("inner", lp, ords, [0], [0])      # o_orderdate 9
    # + [c_custkey 10, c_nationkey 11]
    lpoc = pn.JoinNode("inner", lpo,
                       _scan(customer, ["c_custkey", "c_nationkey"]),
                       [8], [0])
    reg = pn.FilterNode(P.EqualTo(ref(1, dt.STRING), Literal(Q8_REGION)),
                        _scan(region, ["r_regionkey", "r_name"]))
    n1r = pn.JoinNode("inner", _scan(nation, ["n_nationkey", "n_regionkey"]),
                      reg, [1], [0])
    lpocn = pn.JoinNode("inner", lpoc, n1r, [11], [0])
    sn = pn.JoinNode("inner", _scan(supplier, ["s_suppkey", "s_nationkey"]),
                     _scan(nation, ["n_nationkey", "n_name"]), [1], [0])
    # + [s_suppkey 16, s_nationkey 17, n_nationkey 18, supp_nation 19]
    full = pn.JoinNode("inner", lpocn, sn, [2], [0])
    vol = _revenue(3, 4)
    nation_vol = If(P.EqualTo(ref(19, dt.STRING), Literal(Q8_NATION)),
                    vol, Literal(0.0))
    proj = pn.ProjectNode(
        [Alias(Year(ref(9, dt.DATE)), "o_year"), Alias(vol, "volume"),
         Alias(nation_vol, "brazil_volume")], full)
    agg = pn.AggregateNode(
        [ref(0, dt.INT32)],
        [pn.AggCall(Sum(ref(2, dt.FLOAT64)), "brazil"),
         pn.AggCall(Sum(ref(1, dt.FLOAT64)), "total")],
        proj, grouping_names=["o_year"])
    share = pn.ProjectNode(
        [Alias(ref(0, dt.INT32), "o_year"),
         Alias(ar.Divide(ref(1, dt.FLOAT64), ref(2, dt.FLOAT64)),
               "mkt_share")], agg)
    return pn.SortNode([SortKeySpec.spark_default(0)], share)


def q9(lineitem: Table, part: Table, supplier: Table, partsupp: Table,
       orders: Table, nation: Table) -> pn.PlanNode:
    """Product type profit: a five-way join (one on two keys), profit per
    nation and year of order."""
    prt = pn.FilterNode(Contains(ref(1, dt.STRING), Q9_TYPE),
                        _scan(part, ["p_partkey", "p_type"]))
    # + [p_partkey 6, p_type 7]
    lp = pn.JoinNode("inner",
                     _scan(lineitem, ["l_orderkey", "l_partkey", "l_suppkey",
                                      "l_quantity", "l_extendedprice",
                                      "l_discount"]),
                     prt, [1], [0])
    # + [s_suppkey 8, s_nationkey 9]
    lps = pn.JoinNode("inner", lp,
                      _scan(supplier, ["s_suppkey", "s_nationkey"]),
                      [2], [0])
    # + [ps_partkey 10, ps_suppkey 11, ps_supplycost 12]
    lpsp = pn.JoinNode("inner", lps,
                       _scan(partsupp, ["ps_partkey", "ps_suppkey",
                                        "ps_supplycost"]),
                       [1, 2], [0, 1])
    # + [o_orderkey 13, o_orderdate 14]
    lpspo = pn.JoinNode("inner", lpsp,
                        _scan(orders, ["o_orderkey", "o_orderdate"]),
                        [0], [0])
    # + [n_nationkey 15, n_name 16]
    full = pn.JoinNode("inner", lpspo,
                       _scan(nation, ["n_nationkey", "n_name"]), [9], [0])
    profit = ar.Subtract(_revenue(4, 5),
                         ar.Multiply(ref(12, dt.FLOAT64),
                                     ref(3, dt.FLOAT64)))
    proj = pn.ProjectNode(
        [Alias(ref(16, dt.STRING), "nation"),
         Alias(Year(ref(14, dt.DATE)), "o_year"),
         Alias(profit, "amount")], full)
    agg = pn.AggregateNode(
        [ref(0, dt.STRING), ref(1, dt.INT32)],
        [pn.AggCall(Sum(ref(2, dt.FLOAT64)), "sum_profit")],
        proj, grouping_names=["nation", "o_year"])
    return pn.SortNode([SortKeySpec.spark_default(0),
                        SortKeySpec.spark_default(1, ascending=False)], agg)


def q11(partsupp: Table, supplier: Table, nation: Table,
        fraction: float = Q11_FRACTION) -> pn.PlanNode:
    """Important stock: the stock value of each part held by one nation's
    suppliers, above ``fraction`` of the total (the scalar subquery
    joined on lit(1)). The reference's literal is TPC-H's fraction at
    sf 1; the benchmark scales it as 0.0001 / sf, and at sf 10 the
    literal keeps no part."""
    nat = pn.FilterNode(P.EqualTo(ref(1, dt.STRING), Literal(Q11_NATION)),
                        _scan(nation, ["n_nationkey", "n_name"]))
    sn = pn.JoinNode("inner", _scan(supplier, ["s_suppkey", "s_nationkey"]),
                     nat, [1], [0])
    # [ps... 0-3, s_suppkey 4, s_nationkey 5, n_nationkey 6, n_name 7]
    psn = pn.JoinNode("inner",
                      _scan(partsupp, ["ps_partkey", "ps_suppkey",
                                       "ps_availqty", "ps_supplycost"]),
                      sn, [1], [0])
    value = ar.Multiply(ref(3, dt.FLOAT64),
                        Cast(ref(2, dt.INT32), dt.FLOAT64))
    vals = pn.ProjectNode([Alias(ref(0, dt.INT64), "ps_partkey"),
                           Alias(value, "value")], psn)
    per_part = pn.AggregateNode(
        [ref(0, dt.INT64)], [pn.AggCall(Sum(ref(1, dt.FLOAT64)), "value")],
        vals, grouping_names=["ps_partkey"])
    total = pn.AggregateNode(
        [], [pn.AggCall(Sum(ref(1, dt.FLOAT64)), "total")], vals)
    thresh = pn.ProjectNode(
        [Alias(ar.Multiply(ref(0, dt.FLOAT64), Literal(fraction)),
               "threshold"), Alias(Literal(1, dt.INT64), "one")], total)
    # [ps_partkey, value, one 2, threshold 3, one 4]
    j = pn.JoinNode("inner", _lit_one(per_part, ["ps_partkey", "value"]),
                    thresh, [2], [1])
    filt = pn.FilterNode(P.GreaterThan(ref(1, dt.FLOAT64),
                                       ref(3, dt.FLOAT64)), j)
    proj = pn.ProjectNode([Alias(ref(0, dt.INT64), "ps_partkey"),
                           Alias(ref(1, dt.FLOAT64), "value")], filt)
    return pn.SortNode([SortKeySpec.spark_default(1, ascending=False)], proj)


def q20(lineitem: Table, part: Table, partsupp: Table, supplier: Table,
        nation: Table) -> pn.PlanNode:
    """Potential part promotion: one nation's suppliers whose stock of a
    part type exceeds half of a year's shipments (two semi joins and a
    join on two keys)."""
    prt = pn.FilterNode(StartsWith(ref(1, dt.STRING), Q20_TYPE),
                        _scan(part, ["p_partkey", "p_type"]))
    li = pn.FilterNode(
        _date_range(3, Q20_FROM, Q20_TO),
        _scan(lineitem, ["l_partkey", "l_suppkey", "l_quantity",
                         "l_shipdate"]))
    shipped = pn.AggregateNode(
        [ref(0, dt.INT64), ref(1, dt.INT64)],
        [pn.AggCall(Sum(ref(2, dt.FLOAT64)), "qty")],
        li, grouping_names=["l_partkey", "l_suppkey"])
    ps_f = pn.JoinNode("left_semi",
                       _scan(partsupp, ["ps_partkey", "ps_suppkey",
                                        "ps_availqty"]),
                       prt, [0], [0])
    # + [l_partkey 3, l_suppkey 4, qty 5]
    psq = pn.JoinNode("inner", ps_f, shipped, [0, 1], [0, 1])
    over = pn.FilterNode(
        P.GreaterThan(Cast(ref(2, dt.INT32), dt.FLOAT64),
                      ar.Multiply(Literal(0.5), ref(5, dt.FLOAT64))), psq)
    nat = pn.FilterNode(P.EqualTo(ref(1, dt.STRING), Literal(Q20_NATION)),
                        _scan(nation, ["n_nationkey", "n_name"]))
    sn = pn.JoinNode("inner", _scan(supplier, ["s_suppkey", "s_nationkey"]),
                     nat, [1], [0])
    good = pn.JoinNode("left_semi", sn, over, [0], [1])
    proj = pn.ProjectNode([Alias(ref(0, dt.INT64), "s_suppkey")], good)
    return pn.SortNode([SortKeySpec.spark_default(0)], proj)


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


# -- oracles of q5, q10, q19, q2, q17, q7, q8, q9, q11 and q20 ---------------


def _at(table: np.ndarray, keys: np.ndarray, fill=-1) -> np.ndarray:
    """``table[keys]``, ``fill`` where a key is past the table's end."""
    inside = keys < len(table)
    out = np.full(len(keys), fill, dtype=table.dtype)
    out[inside] = table[keys[inside]]
    return out


def _nation_of(nation: Table, names) -> np.ndarray:
    """Per nation key: whether its name is one of ``names``."""
    return _lookup(nation["n_nationkey"], _is(nation["n_name"], names),
                   False)


def _in_region(nation: Table, region: Table, name: str) -> np.ndarray:
    """Per nation key: whether the nation lies in region ``name``."""
    keys = region["r_regionkey"][_is(region["r_name"], [name])]
    return _lookup(nation["n_nationkey"],
                   _member(nation["n_regionkey"], keys), False)


def _names(col: HostStrings, rows: np.ndarray) -> np.ndarray:
    return col.dictionary[col.codes[rows]]


def _sums_by(keys: np.ndarray, values: np.ndarray):
    """(the distinct non-negative keys in order, the sum of ``values``
    per key), by one sort."""
    order = np.argsort(keys, kind="stable")
    k, runs = _runs(keys[order])
    starts = np.r_[0, np.cumsum(runs)[:-1]].astype(np.int64)
    sums = np.add.reduceat(values[order], starts) if len(k) else \
        np.zeros(0)
    return k, sums


def _search(sorted_keys: np.ndarray, needles: np.ndarray) -> Tuple:
    """(left, right) ``np.searchsorted`` of each needle, the needles
    visited in sorted order (a random order misses the cache on every
    probe: minutes at sf 10)."""
    order = np.argsort(needles)
    lo = np.empty(len(needles), dtype=np.int64)
    hi = np.empty(len(needles), dtype=np.int64)
    lo[order] = np.searchsorted(sorted_keys, needles[order], "left")
    hi[order] = np.searchsorted(sorted_keys, needles[order], "right")
    return lo, hi


def _year(days_: np.ndarray) -> np.ndarray:
    return (days_.astype("datetime64[D]").astype("datetime64[Y]")
            .astype(np.int64) + 1970).astype(np.int32)


def _order_rows(orders: Table, keys: np.ndarray, live=None) -> np.ndarray:
    """Per order key of ``keys``: its row in orders (keys are unique),
    -1 where there is none or the row is not ``live``."""
    okey = orders["o_orderkey"]
    rows = np.arange(len(okey))
    if live is not None:
        okey, rows = okey[live], rows[live]
    return _at(_lookup(okey, rows, -1), keys)


def q5_numpy(customer: Table, orders: Table, lineitem: Table,
             supplier: Table, nation: Table, region: Table) -> Table:
    """q5 in plain numpy: keys of orders, customers and suppliers are
    unique, so each line finds its order, customer and supplier."""
    d = orders["o_orderdate"]
    row = _order_rows(orders, lineitem["l_orderkey"],
                      (d >= days(Q5_FROM)) & (d < days(Q5_TO)))
    cust_nat = _lookup(customer["c_custkey"], customer["c_nationkey"], -1)
    c_nat = np.where(row >= 0, _at(cust_nat, orders["o_custkey"][row]), -1)
    s_nat = _at(_lookup(supplier["s_suppkey"], supplier["s_nationkey"], -1),
                lineitem["l_suppkey"])
    asia = _in_region(nation, region, Q5_REGION)
    keep = (row >= 0) & (c_nat >= 0) & (c_nat == s_nat) & \
        _at(asia, np.maximum(c_nat, 0), False)
    rev = lineitem["l_extendedprice"][keep] * \
        (1.0 - lineitem["l_discount"][keep])
    nat, total = _sums_by(c_nat[keep], rev)
    name_row = _lookup(nation["n_nationkey"],
                       np.arange(len(nation["n_nationkey"])), -1)
    top = np.argsort(-total, kind="stable")
    return {"n_name": _names(nation["n_name"], name_row[nat[top]]),
            "revenue": total[top]}


def q10_numpy(customer: Table, orders: Table, lineitem: Table,
              nation: Table) -> Table:
    """q10 in plain numpy: revenue of returned lines per customer (the
    five keys are one customer's), top 20."""
    d = orders["o_orderdate"]
    live = _is(lineitem["l_returnflag"], [Q10_FLAG])
    row = _order_rows(orders, lineitem["l_orderkey"][live],
                      (d >= days(Q10_FROM)) & (d < days(Q10_TO)))
    hit = row >= 0
    rev = (lineitem["l_extendedprice"][live] *
           (1.0 - lineitem["l_discount"][live]))[hit]
    cust_row = _lookup(customer["c_custkey"],
                       np.arange(len(customer["c_custkey"])), -1)
    crow = _at(cust_row, orders["o_custkey"][row[hit]])
    rev = rev[crow >= 0]
    crow = crow[crow >= 0]
    rows, total = _sums_by(crow, rev)
    top = rows[np.argsort(-total, kind="stable")[:20]]
    total = total[np.argsort(-total, kind="stable")[:20]]
    name_row = _lookup(nation["n_nationkey"],
                       np.arange(len(nation["n_nationkey"])), -1)
    return {"c_custkey": customer["c_custkey"][top],
            "c_name": _names(customer["c_name"], top),
            "c_acctbal": customer["c_acctbal"][top],
            "c_phone": _names(customer["c_phone"], top),
            "n_name": _names(nation["n_name"],
                             name_row[customer["c_nationkey"][top]]),
            "revenue": total}


def q19_numpy(lineitem: Table, part: Table) -> Table:
    """q19 in plain numpy: one row, None when no line passes."""
    live = _is(lineitem["l_shipmode"], Q19_MODES) & \
        _is(lineitem["l_shipinstruct"], [Q19_INSTRUCT])
    prow = _at(_lookup(part["p_partkey"], np.arange(len(part["p_partkey"])),
                       -1), lineitem["l_partkey"])
    live &= prow >= 0
    prow = np.maximum(prow, 0)
    qty = lineitem["l_quantity"]
    ok = np.zeros(len(qty), dtype=bool)
    for brand, prefix, qlo, qhi, smax in Q19_ARMS:
        b = _is(part["p_brand"], [brand])[prow]
        c = _entries(part["p_container"],
                     lambda e, p=prefix: np.char.startswith(e, p))[prow]
        ok |= b & c & (qty >= qlo) & (qty <= qhi) & \
            (part["p_size"][prow] <= smax)
    keep = live & ok
    if not keep.any():
        return {"revenue": np.array([None], dtype=object)}
    return {"revenue": np.array([(lineitem["l_extendedprice"][keep] *
                                  (1.0 - lineitem["l_discount"][keep])
                                  ).sum()])}


def q2_numpy(part: Table, supplier: Table, partsupp: Table, nation: Table,
             region: Table) -> Table:
    """q2 in plain numpy: the region's offers, the least cost per part,
    the offers of the chosen parts at that cost."""
    srow = _at(_lookup(supplier["s_suppkey"],
                       np.arange(len(supplier["s_suppkey"])), -1),
               partsupp["ps_suppkey"])
    eu = _in_region(nation, region, Q2_REGION)
    s_nat = np.where(srow >= 0, supplier["s_nationkey"][np.maximum(srow, 0)],
                     -1)
    offer = (srow >= 0) & _at(eu, np.maximum(s_nat, 0), False) & (s_nat >= 0)
    pk, cost = partsupp["ps_partkey"][offer], \
        partsupp["ps_supplycost"][offer]
    least = np.full(int(pk.max(initial=0)) + 1, np.inf)
    np.minimum.at(least, pk, cost)
    chosen = (part["p_size"] == Q2_SIZE) & _entries(
        part["p_type"], lambda e: np.char.endswith(e, Q2_TYPE))
    prow = _at(_lookup(part["p_partkey"][chosen], np.flatnonzero(chosen),
                       -1), pk)
    keep = (prow >= 0) & (cost == least[pk])
    rows = np.flatnonzero(offer)[keep]
    sr = srow[rows]
    acct = supplier["s_acctbal"][sr]
    name_row = _lookup(nation["n_nationkey"],
                       np.arange(len(nation["n_nationkey"])), -1)
    n_name = _names(nation["n_name"], name_row[supplier["s_nationkey"][sr]])
    p_key = partsupp["ps_partkey"][rows]
    n_code = nation["n_name"].codes[name_row[supplier["s_nationkey"][sr]]]
    top = np.lexsort((p_key, n_code, -acct))[:100]
    return {"s_acctbal": acct[top], "n_name": n_name[top],
            "p_partkey": p_key[top],
            "p_type": _names(part["p_type"], prow[keep][top]),
            "ps_supplycost": partsupp["ps_supplycost"][rows][top]}


def q17_numpy(lineitem: Table, part: Table) -> Table:
    """q17 in plain numpy: one row, None when no line passes."""
    pk, qty = lineitem["l_partkey"], lineitem["l_quantity"]
    avg = np.bincount(pk, weights=qty) / np.maximum(np.bincount(pk), 1)
    chosen = _is(part["p_brand"], [Q17_BRAND]) & _entries(
        part["p_container"],
        lambda e: np.char.startswith(e, Q17_CONTAINER))
    keep = _member(pk, part["p_partkey"][chosen]) & (qty < avg[pk] * 0.2)
    if not keep.any():
        return {"avg_yearly": np.array([None], dtype=object)}
    return {"avg_yearly": np.array(
        [lineitem["l_extendedprice"][keep].sum() / 7.0])}


def q7_numpy(lineitem: Table, orders: Table, customer: Table,
             supplier: Table, nation: Table) -> Table:
    """q7 in plain numpy: per (supplier nation, customer nation, year)."""
    d = lineitem["l_shipdate"]
    live = (d >= days(Q7_FROM)) & (d <= days(Q7_TO))
    row = _order_rows(orders, lineitem["l_orderkey"][live])
    c_nat = np.where(row >= 0, _at(_lookup(customer["c_custkey"],
                                           customer["c_nationkey"], -1),
                                   orders["o_custkey"][np.maximum(row, 0)]),
                     -1)
    s_nat = _at(_lookup(supplier["s_suppkey"], supplier["s_nationkey"], -1),
                lineitem["l_suppkey"][live])
    code = _lookup(nation["n_nationkey"], nation["n_name"].codes, -1)
    names = nation["n_name"].dictionary
    sc, cc = _at(code, np.maximum(s_nat, 0)), _at(code, np.maximum(c_nat, 0))
    sname, cname = names[np.maximum(sc, 0)], names[np.maximum(cc, 0)]
    a, b = Q7_NATIONS
    keep = (row >= 0) & (c_nat >= 0) & (s_nat >= 0) & (
        ((sname == a) & (cname == b)) | ((sname == b) & (cname == a)))
    vol = (lineitem["l_extendedprice"][live] *
           (1.0 - lineitem["l_discount"][live]))[keep]
    year = _year(d[live][keep]).astype(np.int64)
    group = (sc[keep].astype(np.int64) * 64 + cc[keep]) * 4096 + year - 1900
    g, total = _sums_by(group, vol)
    return {"supp_nation": names[g // 4096 // 64],
            "cust_nation": names[g // 4096 % 64],
            "l_year": (g % 4096 + 1900).astype(np.int32),
            "revenue": total}


def q8_numpy(lineitem: Table, part: Table, orders: Table, customer: Table,
             supplier: Table, nation: Table, region: Table) -> Table:
    """q8 in plain numpy: per order year, the nation's revenue over the
    region's, on one part type."""
    chosen = _is(part["p_type"], [Q8_TYPE])
    live = _member(lineitem["l_partkey"], part["p_partkey"][chosen])
    od = orders["o_orderdate"]
    row = _order_rows(orders, lineitem["l_orderkey"][live],
                      (od >= days(Q8_FROM)) & (od <= days(Q8_TO)))
    c_nat = np.where(row >= 0, _at(_lookup(customer["c_custkey"],
                                           customer["c_nationkey"], -1),
                                   orders["o_custkey"][np.maximum(row, 0)]),
                     -1)
    america = _in_region(nation, region, Q8_REGION)
    s_nat = _at(_lookup(supplier["s_suppkey"], supplier["s_nationkey"], -1),
                lineitem["l_suppkey"][live])
    keep = (row >= 0) & (c_nat >= 0) & (s_nat >= 0) & \
        _at(america, np.maximum(c_nat, 0), False)
    vol = (lineitem["l_extendedprice"][live] *
           (1.0 - lineitem["l_discount"][live]))[keep]
    mine = _nation_of(nation, [Q8_NATION])[s_nat[keep]]
    year = _year(od[row[keep]]).astype(np.int64)
    years, total = _sums_by(year, vol)
    _, brazil = _sums_by(year, np.where(mine, vol, 0.0))
    return {"o_year": years.astype(np.int32), "mkt_share": brazil / total}


def q9_numpy(lineitem: Table, part: Table, supplier: Table,
             partsupp: Table, orders: Table, nation: Table) -> Table:
    """q9 in plain numpy: a (part, supplier) pair may have several
    partsupp rows, and each one is a joined row."""
    chosen = _entries(part["p_type"], lambda e: np.char.find(e, Q9_TYPE)
                      >= 0)
    live = np.flatnonzero(_member(lineitem["l_partkey"],
                                  part["p_partkey"][chosen]))
    s_nat = _at(_lookup(supplier["s_suppkey"], supplier["s_nationkey"], -1),
                lineitem["l_suppkey"][live])
    live, s_nat = live[s_nat >= 0], s_nat[s_nat >= 0]
    span = int(max(partsupp["ps_suppkey"].max(initial=0),
                   lineitem["l_suppkey"].max(initial=0))) + 1
    ps_key = partsupp["ps_partkey"] * span + partsupp["ps_suppkey"]
    order = np.argsort(ps_key, kind="stable")
    sorted_key = ps_key[order]
    want = lineitem["l_partkey"][live] * span + lineitem["l_suppkey"][live]
    lo, hi = _search(sorted_key, want)
    n = hi - lo
    line = np.repeat(live, n)
    nat = np.repeat(s_nat, n)
    ps_row = order[np.repeat(lo, n) + (np.arange(n.sum()) -
                                       np.repeat(np.cumsum(n) - n, n))]
    row = _order_rows(orders, lineitem["l_orderkey"][line])
    line, nat, ps_row, row = (x[row >= 0] for x in (line, nat, ps_row, row))
    amount = lineitem["l_extendedprice"][line] * \
        (1.0 - lineitem["l_discount"][line]) - \
        partsupp["ps_supplycost"][ps_row] * lineitem["l_quantity"][line]
    code = _lookup(nation["n_nationkey"], nation["n_name"].codes, -1)[nat]
    year = _year(orders["o_orderdate"][row]).astype(np.int64)
    g, total = _sums_by(code.astype(np.int64) * 4096 + (5000 - year),
                        amount)
    return {"nation": nation["n_name"].dictionary[g // 4096],
            "o_year": (5000 - g % 4096).astype(np.int32),
            "sum_profit": total}


def q11_numpy(partsupp: Table, supplier: Table, nation: Table,
              fraction: float = Q11_FRACTION) -> Table:
    """q11 in plain numpy: per part, the stock value held by the nation's
    suppliers, where it passes ``fraction`` of the total."""
    mine = _nation_of(nation, [Q11_NATION])
    s_nat = _at(_lookup(supplier["s_suppkey"], supplier["s_nationkey"], -1),
                partsupp["ps_suppkey"])
    keep = (s_nat >= 0) & _at(mine, np.maximum(s_nat, 0), False)
    value = partsupp["ps_supplycost"][keep] * \
        partsupp["ps_availqty"][keep].astype(np.float64)
    parts, per = _sums_by(partsupp["ps_partkey"][keep], value)
    big = per > value.sum() * fraction
    top = np.argsort(-per[big], kind="stable")
    return {"ps_partkey": parts[big][top], "value": per[big][top]}


def q20_numpy(lineitem: Table, part: Table, partsupp: Table,
              supplier: Table, nation: Table) -> Table:
    """q20 in plain numpy: a year's shipped quantity per (part, supplier)
    by one sort; the offers of the part type above half of it."""
    d = lineitem["l_shipdate"]
    live = (d >= days(Q20_FROM)) & (d < days(Q20_TO))
    span = int(max(partsupp["ps_suppkey"].max(initial=0),
                   lineitem["l_suppkey"].max(initial=0))) + 1
    pairs, qty = _sums_by(lineitem["l_partkey"][live] * span +
                          lineitem["l_suppkey"][live],
                          lineitem["l_quantity"][live])
    chosen = _entries(part["p_type"],
                      lambda e: np.char.startswith(e, Q20_TYPE))
    ps_pair = partsupp["ps_partkey"] * span + partsupp["ps_suppkey"]
    at = _search(pairs, ps_pair)[0]
    found = (at < len(pairs)) & (pairs[np.minimum(at, len(pairs) - 1)]
                                 == ps_pair)
    found &= _member(partsupp["ps_partkey"], part["p_partkey"][chosen])
    over = found & (partsupp["ps_availqty"].astype(np.float64) >
                    qty[np.minimum(at, len(qty) - 1)] * 0.5)
    keys = partsupp["ps_suppkey"][over]
    mine = _nation_of(nation, [Q20_NATION])
    s_nat = supplier["s_nationkey"]
    ok = _at(mine, s_nat, False) & _member(supplier["s_suppkey"], keys)
    return {"s_suppkey": np.sort(supplier["s_suppkey"][ok])}
