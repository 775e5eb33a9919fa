"""TPCx-BB over in-memory tables (the counterpart of
spark_rapids_tpu/benchmarks/tpcxbb.py): the benchmark's own generators,
q26, q5, q6, q9 and q11 as plan trees, q12, q14-q17 and q20-q23 as SQL
text through the port's ``api`` and ``sql`` (q23 through a temp view),
and a numpy oracle for each. The plans run on the default (fused) exec
tree; ``tpch.query_conf(q, fused=False)`` is the conf of the unfused one.

The generators replay the reference's ``default_rng`` draws seed for
seed (``benchmarks/tpcds.py`` holds the retail tables the benchmark
shares with TPC-DS); a column with nulls is a numpy masked array. Each
query scans only the columns it reads (``READS``).

q22 and q23 as the reference writes them select the inventory snapshots
of a window in 2001, and the generated inventory has one snapshot date
there (2001-05-03), so both are empty at every scale. ``q22_2002`` and
``q23_2002`` are the same texts with the dates moved to the 2002
snapshots (the literals only), so their group-bys, moments and joins
run on rows. The oracles avoid ``np.unique`` and random-order
``searchsorted`` over big arrays (minutes at sf 10 with numpy 2.3).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from spark_rapids_tpu_torch.benchmarks import tpcds
from spark_rapids_tpu_torch.benchmarks.tpch import _search
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.expressions import aggregates as A
from spark_rapids_tpu_torch.expressions import arithmetic as ar
from spark_rapids_tpu_torch.expressions import predicates as P
from spark_rapids_tpu_torch.expressions.aggregates import Count
from spark_rapids_tpu_torch.expressions.base import (Alias, BoundReference,
                                                     Literal)
from spark_rapids_tpu_torch.expressions.cast import Cast
from spark_rapids_tpu_torch.expressions.conditional import If
from spark_rapids_tpu_torch.expressions.math import Sqrt
from spark_rapids_tpu_torch.io.hoststrings import HostStrings
from spark_rapids_tpu_torch.ops.sortkeys import SortKeySpec
from spark_rapids_tpu_torch.plan import nodes as pn

Table = Dict[str, np.ndarray]

EDUCATION = np.array(["Advanced Degree", "College", "4 yr Degree",
                      "2 yr Degree", "Secondary", "Primary", "Unknown"],
                     dtype=object)
MARITAL = np.array(["M", "S", "D", "W", "U"], dtype=object)
DATE_SK_LO = 2450815
DATE_SK_HI = 2450815 + 5 * 365


# -- generators ---------------------------------------------------------------


def gen_web_clickstreams(sf: float, seed: int = 41) -> Table:
    """``tpcxbb.gen_web_clickstreams`` (50M rows at sf 10): 5% of the
    users and 90% of the sales null."""
    rng = np.random.default_rng(seed)
    n = max(int(5_000_000 * sf), 300)
    n_item = max(int(18_000 * sf), 50)
    n_cust = max(int(100_000 * sf), 20)
    user = rng.integers(1, n_cust + 1, n).astype(np.int64)
    user_null = rng.random(n) < 0.05
    sales = rng.integers(1, 1 << 30, n)
    sales_null = rng.random(n) < 0.9
    return {"wcs_user_sk": np.ma.masked_array(user, user_null),
            "wcs_item_sk": rng.integers(1, n_item + 1, n).astype(np.int64),
            "wcs_click_date_sk": rng.integers(DATE_SK_LO, DATE_SK_HI, n
                                              ).astype(np.int64),
            "wcs_sales_sk": np.ma.masked_array(sales.astype(np.int64),
                                               sales_null)}


def gen_customer_demographics(sf: float, seed: int = 43) -> Table:
    """``tpcxbb.gen_customer_demographics`` (the benchmark's own, not
    TPC-DS's)."""
    rng = np.random.default_rng(seed)
    n = max(int(1_000 * sf), 10)
    return {"cd_demo_sk": np.arange(1, n + 1, dtype=np.int64),
            "cd_gender": HostStrings.from_table(
                np.array(["M", "F"], dtype=object), rng.integers(0, 2, n)),
            "cd_education_status": HostStrings.from_table(
                EDUCATION, rng.integers(0, 7, n)),
            "cd_marital_status": HostStrings.from_table(
                MARITAL, rng.integers(0, 5, n))}


_WORDS = np.array(["great", "poor", "fine", "broken", "love", "meh"],
                  dtype=object)


def gen_product_reviews(sf: float, seed: int = 47) -> Table:
    """``tpcxbb.gen_product_reviews``: 3% of the item keys null."""
    rng = np.random.default_rng(seed)
    n = max(int(60_000 * sf), 100)
    n_item = max(int(18_000 * sf), 50)
    item = rng.integers(1, n_item + 1, n).astype(np.int64)
    null = rng.random(n) < 0.03
    rows = np.arange(n)
    # "{word} product {i % 97}" repeats every 6 * 97 rows
    content = np.array([f"{_WORDS[i % 6]} product {i % 97}"
                        for i in range(min(n, 582))], dtype=object)
    return {"pr_review_sk": rows.astype(np.int64) + 1,
            "pr_item_sk": np.ma.masked_array(item, null),
            "pr_review_rating": rng.integers(1, 6, n).astype(np.int32),
            "pr_review_content": HostStrings.from_table(content,
                                                        rows % 582)}


def gen_item_marketprices(sf: float, seed: int = 49) -> Table:
    """``tpcxbb.gen_item_marketprices``: three competitor prices an
    item."""
    rng = np.random.default_rng(seed)
    n_item = max(int(18_000 * sf), 50)
    n = n_item * 3
    start = rng.integers(2450915, 2450815 + 4 * 365, n).astype(np.int64)
    return {"imp_sk": np.arange(1, n + 1, dtype=np.int64),
            "imp_item_sk": np.repeat(np.arange(1, n_item + 1,
                                               dtype=np.int64), 3),
            "imp_competitor_price": np.round(0.3 + rng.random(n) * 2.5, 2),
            "imp_start_date": start,
            "imp_end_date": start + rng.integers(30, 120, n)}


#: the benchmark's own tables, registered before the shared ones (the
#: reference's ``_session`` order: its customer_demographics wins)
GENERATORS = {"web_clickstreams": gen_web_clickstreams,
              "customer_demographics": gen_customer_demographics,
              "product_reviews": gen_product_reviews,
              "item_marketprices": gen_item_marketprices}


def gen_tables(sf: float, store_sales: Optional[Table] = None,
               item: Optional[Table] = None) -> Dict[str, Table]:
    """Every table the queries read, each generated once (the returns
    sample the sales tables generated here); ``store_sales`` and ``item``
    may be given. date_dim carries ``d_date`` (a DATE)."""
    ss = tpcds.gen_store_sales(sf) if store_sales is None else store_sales
    ws = tpcds.gen_web_sales(sf)
    out = {name: gen(sf) for name, gen in GENERATORS.items()}
    out.update(
        store_sales=ss, web_sales=ws,
        item=tpcds.gen_item(sf) if item is None else item,
        date_dim=dict(tpcds.gen_date_dim(sf), d_date=tpcds.date_dim_days()),
        store=tpcds.gen_store(sf), warehouse=tpcds.gen_warehouse(sf),
        promotion=tpcds.gen_promotion(sf),
        household_demographics=tpcds.gen_household_demographics(sf),
        time_dim=tpcds.gen_time_dim(sf), web_page=tpcds.gen_web_page(sf),
        customer=tpcds.gen_customer(sf),
        customer_address=tpcds.gen_customer_address(sf),
        store_returns=tpcds.gen_store_returns(sf, sales=ss),
        web_returns=tpcds.gen_web_returns(sf, sales=ws),
        inventory=tpcds.gen_inventory(sf))
    return out


# -- what each query reads ----------------------------------------------------

_SS = "store_sales"
READS = {
    "q26": {_SS: ["ss_item_sk", "ss_customer_sk"],
            "item": ["i_item_sk", "i_category", "i_class_id"]},
    "q5": {"web_clickstreams": ["wcs_user_sk", "wcs_item_sk"],
           "item": ["i_item_sk", "i_category", "i_category_id"],
           "customer": ["c_customer_sk", "c_current_cdemo_sk"],
           "customer_demographics": ["cd_demo_sk", "cd_gender",
                                     "cd_education_status"]},
    "q6": {_SS: ["ss_sold_date_sk", "ss_customer_sk", "ss_ext_list_price",
                 "ss_ext_wholesale_cost", "ss_ext_discount_amt",
                 "ss_ext_sales_price"],
           "web_sales": ["ws_sold_date_sk", "ws_bill_customer_sk",
                         "ws_ext_list_price", "ws_ext_wholesale_cost",
                         "ws_ext_discount_amt", "ws_ext_sales_price"],
           "date_dim": ["d_date_sk", "d_year"]},
    "q9": {_SS: ["ss_sold_date_sk", "ss_item_sk", "ss_customer_sk",
                 "ss_store_sk", "ss_quantity", "ss_sales_price",
                 "ss_net_profit"],
           "date_dim": ["d_date_sk", "d_year"],
           "customer_address": ["ca_address_sk", "ca_country", "ca_state"],
           "store": ["s_store_sk"],
           "customer_demographics": ["cd_demo_sk", "cd_marital_status",
                                     "cd_education_status"]},
    "q11": {"product_reviews": ["pr_item_sk", "pr_review_rating"],
            "date_dim": ["d_date_sk", "d_year"],
            "web_sales": ["ws_sold_date_sk", "ws_item_sk", "ws_net_paid"]},
    "q12": {"web_clickstreams": ["wcs_user_sk", "wcs_item_sk",
                                 "wcs_click_date_sk", "wcs_sales_sk"],
            "item": ["i_item_sk", "i_category"],
            _SS: ["ss_sold_date_sk", "ss_item_sk", "ss_customer_sk"]},
    "q14": {"web_sales": ["ws_sold_time_sk", "ws_web_page_sk",
                          "ws_ship_hdemo_sk"],
            "household_demographics": ["hd_demo_sk", "hd_dep_count"],
            "web_page": ["wp_web_page_sk", "wp_char_count"],
            "time_dim": ["t_time_sk", "t_hour"]},
    "q15": {_SS: ["ss_sold_date_sk", "ss_item_sk", "ss_store_sk",
                  "ss_net_paid"],
            "date_dim": ["d_date_sk", "d_date"],
            "item": ["i_item_sk", "i_category_id"]},
    "q16": {"web_sales": ["ws_sold_date_sk", "ws_item_sk",
                          "ws_order_number", "ws_warehouse_sk",
                          "ws_sales_price"],
            "web_returns": ["wr_order_number", "wr_item_sk",
                            "wr_refunded_cash"],
            "item": ["i_item_sk", "i_item_id"],
            "warehouse": ["w_warehouse_sk", "w_state"],
            "date_dim": ["d_date_sk", "d_date"]},
    "q17": {_SS: ["ss_sold_date_sk", "ss_item_sk", "ss_customer_sk",
                  "ss_promo_sk", "ss_store_sk", "ss_ext_sales_price"],
            "date_dim": ["d_date_sk", "d_year", "d_moy"],
            "item": ["i_item_sk", "i_category"],
            "store": ["s_store_sk", "s_gmt_offset"],
            "customer": ["c_customer_sk", "c_current_addr_sk"],
            "customer_address": ["ca_address_sk", "ca_gmt_offset"],
            "promotion": ["p_promo_sk", "p_channel_email",
                          "p_channel_dmail", "p_channel_tv"]},
    "q20": {_SS: ["ss_item_sk", "ss_customer_sk", "ss_ticket_number",
                  "ss_net_paid"],
            "store_returns": ["sr_item_sk", "sr_customer_sk",
                              "sr_ticket_number", "sr_return_amt"]},
    "q21": {"store_returns": ["sr_item_sk", "sr_customer_sk",
                              "sr_ticket_number", "sr_returned_date_sk",
                              "sr_return_quantity"],
            "date_dim": ["d_date_sk", "d_year", "d_moy"],
            "web_sales": ["ws_sold_date_sk", "ws_bill_customer_sk",
                          "ws_item_sk", "ws_quantity"],
            _SS: ["ss_sold_date_sk", "ss_item_sk", "ss_customer_sk",
                  "ss_store_sk", "ss_ticket_number", "ss_quantity"],
            "store": ["s_store_sk", "s_store_id", "s_store_name"],
            "item": ["i_item_sk", "i_item_id", "i_item_desc"]},
    "q22": {"inventory": ["inv_date_sk", "inv_item_sk", "inv_warehouse_sk",
                          "inv_quantity_on_hand"],
            "item": ["i_item_sk", "i_item_id", "i_current_price"],
            "warehouse": ["w_warehouse_sk", "w_warehouse_name"],
            "date_dim": ["d_date_sk", "d_date"]},
    "q23": {"inventory": ["inv_date_sk", "inv_item_sk", "inv_warehouse_sk",
                          "inv_quantity_on_hand"],
            "date_dim": ["d_date_sk", "d_year", "d_moy"]},
}
READS["q22_2002"], READS["q23_2002"] = READS["q22"], READS["q23"]


def _source(cols: Table, names: List[str]) -> pn.InMemorySource:
    """The named columns as a scan source (``d_date`` a DATE)."""
    data = {c: cols[c] for c in names}
    types = [dt.DATE if c == "d_date" else
             dt.STRING if isinstance(v, HostStrings) else
             dt.from_numpy(np.asarray(v).dtype) for c, v in data.items()]
    return pn.InMemorySource(data, Schema(list(data), types))


def _scan(tables: Dict[str, Table], query: str, table: str) -> pn.ScanNode:
    return pn.ScanNode(_source(tables[table], READS[query][table]))


def ref(i, t):
    return BoundReference(i, t)


def _count_if(cond):
    """count(CASE WHEN cond THEN 1 ELSE NULL END)"""
    return Count(If(cond, Literal(1, dt.INT64), Literal(None, dt.INT64)))


def _sum_if(cond):
    """SUM(CASE WHEN cond THEN 1 ELSE 0 END)"""
    return A.Sum(If(cond, Literal(1, dt.INT64), Literal(0, dt.INT64)))


# -- plan trees ---------------------------------------------------------------


def q26(store_sales: Table, item: Table) -> pn.PlanNode:
    """Per-customer class-id purchase counts over Books, HAVING count > 5,
    ORDER BY customer (TpcxbbLikeSpark.scala:1968-2014; class ids reduced
    to 8 as in the reference)."""
    t = {_SS: store_sales, "item": item}
    ss = pn.FilterNode(P.IsNotNull(ref(1, dt.INT64)), _scan(t, "q26", _SS))
    it = pn.FilterNode(P.In(ref(1, dt.STRING), [Literal("Books")]),
                       _scan(t, "q26", "item"))
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


def q5(t: Dict[str, Table]) -> pn.PlanNode:
    """Per-user clicks per category joined to demographics
    (TpcxbbLikeSpark.scala:832-890)."""
    clicks = pn.FilterNode(P.IsNotNull(ref(0, dt.INT64)),
                           _scan(t, "q5", "web_clickstreams"))
    # [wcs_user_sk 0, wcs_item_sk 1, i_item_sk 2, i_category 3,
    #  i_category_id 4]
    ci = pn.JoinNode("inner", clicks, _scan(t, "q5", "item"), [1], [0])
    aggs = [pn.AggCall(_sum_if(P.EqualTo(ref(3, dt.STRING),
                                         Literal("Books"))),
                       "clicks_in_category")]
    for k in range(1, 8):
        aggs.append(pn.AggCall(
            _sum_if(P.EqualTo(ref(4, dt.INT32), Literal(k, dt.INT32))),
            f"clicks_in_{k}"))
    user_clicks = pn.AggregateNode([ref(0, dt.INT64)], aggs, ci,
                                   grouping_names=["wcs_user_sk"])
    # + [c_customer_sk 9, c_current_cdemo_sk 10]
    uc = pn.JoinNode("inner", user_clicks, _scan(t, "q5", "customer"),
                     [0], [0])
    # + [cd_demo_sk 11, cd_gender 12, cd_education_status 13]
    ucd = pn.JoinNode("inner", uc,
                      _scan(t, "q5", "customer_demographics"), [10], [0])
    college = If(
        P.In(ref(13, dt.STRING),
             [Literal("Advanced Degree"), Literal("College"),
              Literal("4 yr Degree"), Literal("2 yr Degree")]),
        Literal(1, dt.INT64), Literal(0, dt.INT64))
    male = If(P.EqualTo(ref(12, dt.STRING), Literal("M")),
              Literal(1, dt.INT64), Literal(0, dt.INT64))
    outs = [Alias(ref(1, dt.INT64), "clicks_in_category"),
            Alias(college, "college_education"), Alias(male, "male")]
    for k in range(1, 8):
        outs.append(Alias(ref(1 + k, dt.INT64), f"clicks_in_{k}"))
    return pn.ProjectNode(outs, ucd)


def q9(t: Dict[str, Table]) -> pn.PlanNode:
    """Banded OR-predicate multi-join global sum
    (TpcxbbLikeSpark.scala:1044-1119)."""
    dd = pn.FilterNode(
        P.EqualTo(ref(1, dt.INT32), Literal(2000, dt.INT32)),
        _scan(t, "q9", "date_dim"))
    # [ss 0-6, d_date_sk 7, d_year 8]
    s1 = pn.JoinNode("inner", _scan(t, "q9", _SS), dd, [0], [0])
    # + [ca_address_sk 9, ca_country 10, ca_state 11]
    s2 = pn.JoinNode("inner", s1, _scan(t, "q9", "customer_address"),
                     [2], [0])
    # + [s_store_sk 12]
    s3 = pn.JoinNode("inner", s2, _scan(t, "q9", "store"), [3], [0])
    # + [cd_demo_sk 13, cd_marital_status 14, cd_education_status 15]
    s4 = pn.JoinNode("inner", s3, _scan(t, "q9", "customer_demographics"),
                     [2], [0])
    price = ref(5, dt.FLOAT64)
    profit = ref(6, dt.FLOAT64)
    md = P.And(P.EqualTo(ref(14, dt.STRING), Literal("M")),
               P.EqualTo(ref(15, dt.STRING), Literal("4 yr Degree")))

    def band(e, lo, hi):
        return P.And(P.GreaterThanOrEqual(e, Literal(float(lo))),
                     P.LessThanOrEqual(e, Literal(float(hi))))

    arm_a = P.Or(P.Or(P.And(md, band(price, 100, 150)),
                      P.And(md, band(price, 50, 200))),
                 P.And(md, band(price, 150, 200)))
    us = P.EqualTo(ref(10, dt.STRING), Literal("United States"))

    def states(*ss):
        return P.In(ref(11, dt.STRING), [Literal(s) for s in ss])

    arm_b = P.Or(
        P.Or(P.And(P.And(us, states("KY", "GA", "NM")),
                   band(profit, 0, 2000)),
             P.And(P.And(us, states("MT", "OR", "IN")),
                   band(profit, 150, 3000))),
        P.And(P.And(us, states("WI", "MO", "WV")),
              band(profit, 50, 25000)))
    filt = pn.FilterNode(P.And(arm_a, arm_b), s4)
    return pn.AggregateNode(
        [], [pn.AggCall(A.Sum(ref(4, dt.INT32)), "sum_quantity")], filt)


def _channel_year_totals(t, table, cust_name):
    """The q6 per-channel view: conditional first/second-year totals per
    customer with HAVING first_year_total > 0
    (TpcxbbLikeSpark.scala:891-970)."""
    scan = _scan(t, "q6", table)
    dd = pn.FilterNode(
        P.And(P.GreaterThanOrEqual(ref(1, dt.INT32),
                                   Literal(2000, dt.INT32)),
              P.LessThanOrEqual(ref(1, dt.INT32),
                                Literal(2001, dt.INT32))),
        _scan(t, "q6", "date_dim"))
    ncols = len(scan.output_schema().names)
    j = pn.JoinNode("inner", scan, dd, [0], [0])
    lp, wc, da, sp = 2, 3, 4, 5
    half = ar.Divide(
        ar.Add(ar.Subtract(ar.Subtract(ref(lp, dt.FLOAT64),
                                       ref(wc, dt.FLOAT64)),
                           ref(da, dt.FLOAT64)),
               ref(sp, dt.FLOAT64)), Literal(2.0))
    is_y1 = P.EqualTo(ref(ncols + 1, dt.INT32), Literal(2000, dt.INT32))
    proj = pn.ProjectNode(
        [Alias(ref(1, dt.INT64), cust_name),
         Alias(If(is_y1, half, Literal(0.0)), "y1"),
         Alias(If(P.Not(is_y1), half, Literal(0.0)), "y2")], j)
    agg = pn.AggregateNode(
        [ref(0, dt.INT64)],
        [pn.AggCall(A.Sum(ref(1, dt.FLOAT64)), "first_year_total"),
         pn.AggCall(A.Sum(ref(2, dt.FLOAT64)), "second_year_total")],
        proj, grouping_names=[cust_name])
    return pn.FilterNode(P.GreaterThan(ref(1, dt.FLOAT64),
                                       Literal(0.0)), agg)


def q6(t: Dict[str, Table]) -> pn.PlanNode:
    """Store-to-web purchase-habit shift: per-channel year-over-year
    ratio comparison, top customers by web increase
    (TpcxbbLikeSpark.scala:891-970)."""
    store = _channel_year_totals(t, _SS, "customer_sk")
    web = _channel_year_totals(t, "web_sales", "customer_sk")
    # [w_cust 0, w_y1 1, w_y2 2, s_cust 3, s_y1 4, s_y2 5]
    j = pn.JoinNode("inner", web, store, [0], [0])
    web_ratio = ar.Divide(ref(2, dt.FLOAT64), ref(1, dt.FLOAT64))
    store_ratio = ar.Divide(ref(5, dt.FLOAT64), ref(4, dt.FLOAT64))
    shifted = pn.FilterNode(P.GreaterThan(web_ratio, store_ratio), j)
    proj = pn.ProjectNode(
        [Alias(web_ratio, "web_sales_increase_ratio"),
         Alias(ref(0, dt.INT64), "c_customer_sk")], shifted)
    sort = pn.SortNode([SortKeySpec.spark_default(0, ascending=False),
                        SortKeySpec.spark_default(1)], proj)
    return pn.LimitNode(100, sort)


def q11(t: Dict[str, Table]) -> pn.PlanNode:
    """Review-sentiment vs revenue correlation
    (TpcxbbLikeSpark.scala:1126-1180): per-item review stats joined to
    per-item revenue, then Pearson's r from moment sums."""
    reviews = pn.FilterNode(P.IsNotNull(ref(0, dt.INT64)),
                            _scan(t, "q11", "product_reviews"))
    stats = pn.AggregateNode(
        [ref(0, dt.INT64)],
        [pn.AggCall(Count(), "r_count"),
         pn.AggCall(A.Average(Cast(ref(1, dt.INT32), dt.FLOAT64)),
                    "avg_rating")],
        reviews, grouping_names=["pr_item_sk"])
    dd = pn.FilterNode(
        P.EqualTo(ref(1, dt.INT32), Literal(2001, dt.INT32)),
        _scan(t, "q11", "date_dim"))
    ws = pn.FilterNode(P.IsNotNull(ref(1, dt.INT64)),
                       _scan(t, "q11", "web_sales"))
    ws_in = pn.JoinNode("left_semi", ws, dd, [0], [0])
    revenue = pn.AggregateNode(
        [ref(1, dt.INT64)],
        [pn.AggCall(A.Sum(ref(2, dt.FLOAT64)), "revenue")],
        ws_in, grouping_names=["ws_item_sk"])
    # [pr_item_sk 0, r_count 1, avg_rating 2, ws_item_sk 3, revenue 4]
    j = pn.JoinNode("inner", stats, revenue, [0], [0])
    x = Cast(ref(1, dt.INT64), dt.FLOAT64)   # reviews_count
    y = ref(2, dt.FLOAT64)                   # avg_rating
    moments = pn.ProjectNode(
        [Alias(x, "x"), Alias(y, "y"),
         Alias(ar.Multiply(x, y), "xy"),
         Alias(ar.Multiply(x, x), "xx"),
         Alias(ar.Multiply(y, y), "yy")], j)
    sums = pn.AggregateNode(
        [], [pn.AggCall(Count(), "n"),
             pn.AggCall(A.Sum(ref(0, dt.FLOAT64)), "sx"),
             pn.AggCall(A.Sum(ref(1, dt.FLOAT64)), "sy"),
             pn.AggCall(A.Sum(ref(2, dt.FLOAT64)), "sxy"),
             pn.AggCall(A.Sum(ref(3, dt.FLOAT64)), "sxx"),
             pn.AggCall(A.Sum(ref(4, dt.FLOAT64)), "syy")], moments)
    n = Cast(ref(0, dt.INT64), dt.FLOAT64)
    sx, sy = ref(1, dt.FLOAT64), ref(2, dt.FLOAT64)
    sxy, sxx, syy = (ref(3, dt.FLOAT64), ref(4, dt.FLOAT64),
                     ref(5, dt.FLOAT64))
    cov = ar.Subtract(ar.Multiply(n, sxy), ar.Multiply(sx, sy))
    vx = ar.Subtract(ar.Multiply(n, sxx), ar.Multiply(sx, sx))
    vy = ar.Subtract(ar.Multiply(n, syy), ar.Multiply(sy, sy))
    corr = ar.Divide(cov, ar.Multiply(Sqrt(vx), Sqrt(vy)))
    return pn.ProjectNode([Alias(corr, "corr")], sums)


# -- SQL texts (the reference's, verbatim) ------------------------------------

Q12_SQL = """
SELECT DISTINCT wcs_user_sk
FROM
( SELECT wcs_user_sk, wcs_click_date_sk
  FROM web_clickstreams, item
  WHERE wcs_click_date_sk BETWEEN 2451300 AND (2451300 + 30)
  AND i_category IN ('Books', 'Electronics')
  AND wcs_item_sk = i_item_sk
  AND wcs_user_sk IS NOT NULL
  AND wcs_sales_sk IS NULL
) webInRange,
( SELECT ss_customer_sk, ss_sold_date_sk
  FROM store_sales, item
  WHERE ss_sold_date_sk BETWEEN 2451300 AND (2451300 + 90)
  AND i_category IN ('Books', 'Electronics')
  AND ss_item_sk = i_item_sk
  AND ss_customer_sk IS NOT NULL
) storeInRange
WHERE wcs_user_sk = ss_customer_sk
AND wcs_click_date_sk < ss_sold_date_sk
ORDER BY wcs_user_sk
"""

Q14_SQL = """
SELECT CASE WHEN pmc > 0 THEN amc / pmc ELSE -1.00 END AS am_pm_ratio
FROM (
  SELECT SUM(amc1) AS amc, SUM(pmc1) AS pmc
  FROM (
    SELECT
      CASE WHEN t_hour BETWEEN 7 AND 8 THEN COUNT(1) ELSE 0 END AS amc1,
      CASE WHEN t_hour BETWEEN 19 AND 20 THEN COUNT(1) ELSE 0 END AS pmc1
    FROM web_sales ws
    JOIN household_demographics hd
      ON (hd.hd_demo_sk = ws.ws_ship_hdemo_sk AND hd.hd_dep_count = 5)
    JOIN web_page wp
      ON (wp.wp_web_page_sk = ws.ws_web_page_sk
          AND wp.wp_char_count BETWEEN 5000 AND 6000)
    JOIN time_dim td
      ON (td.t_time_sk = ws.ws_sold_time_sk
          AND td.t_hour IN (7, 8, 19, 20))
    GROUP BY t_hour) cnt_am_pm
  ) sum_am_pm
"""

Q15_SQL = """
SELECT * FROM (
  SELECT cat,
    ((count(x) * SUM(xy) - SUM(x) * SUM(y)) /
     (count(x) * SUM(xx) - SUM(x) * SUM(x))) AS slope,
    (SUM(y) - ((count(x) * SUM(xy) - SUM(x) * SUM(y)) /
     (count(x) * SUM(xx) - SUM(x) * SUM(x))) * SUM(x)) / count(x)
        AS intercept
  FROM (
    SELECT i.i_category_id AS cat,
      s.ss_sold_date_sk AS x,
      SUM(s.ss_net_paid) AS y,
      s.ss_sold_date_sk * SUM(s.ss_net_paid) AS xy,
      s.ss_sold_date_sk * s.ss_sold_date_sk AS xx
    FROM store_sales s
    LEFT SEMI JOIN (
      SELECT d_date_sk FROM date_dim d
      WHERE d.d_date >= '2001-09-02' AND d.d_date <= '2002-09-02'
    ) dd ON (s.ss_sold_date_sk = dd.d_date_sk)
    INNER JOIN item i ON s.ss_item_sk = i.i_item_sk
    WHERE i.i_category_id IS NOT NULL
    AND s.ss_store_sk = 1
    GROUP BY i.i_category_id, s.ss_sold_date_sk
  ) temp
  GROUP BY cat
) regression
WHERE slope <= 0
ORDER BY cat
"""

Q16_SQL = """
SELECT w_state, i_item_id,
  SUM(CASE WHEN datediff(d_date, '2001-03-16') < 0
      THEN ws_sales_price - COALESCE(wr_refunded_cash, 0)
      ELSE 0.0 END) AS sales_before,
  SUM(CASE WHEN datediff(d_date, '2001-03-16') >= 0
      THEN ws_sales_price - COALESCE(wr_refunded_cash, 0)
      ELSE 0.0 END) AS sales_after
FROM (
  SELECT * FROM web_sales ws
  LEFT OUTER JOIN web_returns wr
    ON (ws.ws_order_number = wr.wr_order_number
        AND ws.ws_item_sk = wr.wr_item_sk)
) a1
JOIN item i ON a1.ws_item_sk = i.i_item_sk
JOIN warehouse w ON a1.ws_warehouse_sk = w.w_warehouse_sk
JOIN date_dim d ON a1.ws_sold_date_sk = d.d_date_sk
AND datediff(d.d_date, '2001-03-16') >= -30
AND datediff(d.d_date, '2001-03-16') <= 30
GROUP BY w_state, i_item_id
ORDER BY w_state, i_item_id
LIMIT 100
"""

Q17_SQL = """
SELECT sum(promotional) AS promotional, sum(total) AS total,
       CASE WHEN sum(total) > 0
            THEN 100 * sum(promotional) / sum(total)
            ELSE 0.0 END AS promo_percent
FROM (
  SELECT p_channel_email, p_channel_dmail, p_channel_tv,
    CASE WHEN (p_channel_dmail = 'Y' OR p_channel_email = 'Y'
               OR p_channel_tv = 'Y')
    THEN SUM(ss_ext_sales_price) ELSE 0 END AS promotional,
    SUM(ss_ext_sales_price) AS total
  FROM store_sales ss
  LEFT SEMI JOIN date_dim dd
    ON ss.ss_sold_date_sk = dd.d_date_sk AND dd.d_year = 2001
       AND dd.d_moy = 12
  LEFT SEMI JOIN item i
    ON ss.ss_item_sk = i.i_item_sk
       AND i.i_category IN ('Books', 'Music')
  LEFT SEMI JOIN store s
    ON ss.ss_store_sk = s.s_store_sk AND s.s_gmt_offset = -5.0
  LEFT SEMI JOIN (SELECT c.c_customer_sk FROM customer c
                  LEFT SEMI JOIN customer_address ca
                  ON c.c_current_addr_sk = ca.ca_address_sk
                     AND ca.ca_gmt_offset = -5.0) sub_c
    ON ss.ss_customer_sk = sub_c.c_customer_sk
  JOIN promotion p ON ss.ss_promo_sk = p.p_promo_sk
  GROUP BY p_channel_email, p_channel_dmail, p_channel_tv
  ) sum_promotional
ORDER BY promotional, total
LIMIT 100
"""

Q20_SQL = """
SELECT
  ss_customer_sk AS user_sk,
  round(CASE WHEN ((returns_count IS NULL) OR (orders_count IS NULL)
        OR ((returns_count / orders_count) IS NULL)) THEN 0.0
        ELSE (returns_count / orders_count) END, 7) AS orderRatio,
  round(CASE WHEN ((returns_items IS NULL) OR (orders_items IS NULL)
        OR ((returns_items / orders_items) IS NULL)) THEN 0.0
        ELSE (returns_items / orders_items) END, 7) AS itemsRatio,
  round(CASE WHEN ((returns_money IS NULL) OR (orders_money IS NULL)
        OR ((returns_money / orders_money) IS NULL)) THEN 0.0
        ELSE (returns_money / orders_money) END, 7) AS monetaryRatio,
  round(CASE WHEN (returns_count IS NULL) THEN 0.0
        ELSE returns_count END, 0) AS frequency
FROM (
  SELECT ss_customer_sk,
    COUNT(DISTINCT ss_ticket_number) AS orders_count,
    COUNT(ss_item_sk) AS orders_items,
    SUM(ss_net_paid) AS orders_money
  FROM store_sales s GROUP BY ss_customer_sk
) orders
LEFT OUTER JOIN (
  SELECT sr_customer_sk,
    count(DISTINCT sr_ticket_number) AS returns_count,
    COUNT(sr_item_sk) AS returns_items,
    SUM(sr_return_amt) AS returns_money
  FROM store_returns GROUP BY sr_customer_sk
) returned ON ss_customer_sk = sr_customer_sk
ORDER BY user_sk
"""

Q21_SQL = """
SELECT
  part_i.i_item_id AS i_item_id,
  part_i.i_item_desc AS i_item_desc,
  part_s.s_store_id AS s_store_id,
  part_s.s_store_name AS s_store_name,
  SUM(part_ss.ss_quantity) AS store_sales_quantity,
  SUM(part_sr.sr_return_quantity) AS store_returns_quantity,
  SUM(part_ws.ws_quantity) AS web_sales_quantity
FROM (
  SELECT sr_item_sk, sr_customer_sk, sr_ticket_number,
         sr_return_quantity
  FROM store_returns sr, date_dim d2
  WHERE d2.d_year = 2001
  AND d2.d_moy BETWEEN 1 AND 1 + 6
  AND sr.sr_returned_date_sk = d2.d_date_sk
) part_sr
INNER JOIN (
  SELECT ws_item_sk, ws_bill_customer_sk, ws_quantity
  FROM web_sales ws, date_dim d3
  WHERE d3.d_year BETWEEN 2001 AND 2001 + 1
  AND ws.ws_sold_date_sk = d3.d_date_sk
) part_ws ON (
  part_sr.sr_item_sk = part_ws.ws_item_sk
  AND part_sr.sr_customer_sk = part_ws.ws_bill_customer_sk
)
INNER JOIN (
  SELECT ss_item_sk, ss_store_sk, ss_customer_sk, ss_ticket_number,
         ss_quantity
  FROM store_sales ss, date_dim d1
  WHERE d1.d_year = 2001
  AND d1.d_moy = 1
  AND ss.ss_sold_date_sk = d1.d_date_sk
) part_ss ON (
  part_ss.ss_ticket_number = part_sr.sr_ticket_number
  AND part_ss.ss_item_sk = part_sr.sr_item_sk
  AND part_ss.ss_customer_sk = part_sr.sr_customer_sk
)
INNER JOIN store part_s ON (part_s.s_store_sk = part_ss.ss_store_sk)
INNER JOIN item part_i ON (part_i.i_item_sk = part_ss.ss_item_sk)
GROUP BY part_i.i_item_id, part_i.i_item_desc, part_s.s_store_id,
         part_s.s_store_name
ORDER BY part_i.i_item_id, part_i.i_item_desc, part_s.s_store_id,
         part_s.s_store_name
LIMIT 100
"""

_Q22_SQL = """
SELECT w_warehouse_name, i_item_id,
  SUM(CASE WHEN datediff(d_date, '{day}') < 0
      THEN inv_quantity_on_hand ELSE 0 END) AS inv_before,
  SUM(CASE WHEN datediff(d_date, '{day}') >= 0
      THEN inv_quantity_on_hand ELSE 0 END) AS inv_after
FROM inventory inv, item i, warehouse w, date_dim d
WHERE i_current_price BETWEEN 0.98 AND 1.5
AND i_item_sk = inv_item_sk
AND inv_warehouse_sk = w_warehouse_sk
AND inv_date_sk = d_date_sk
AND datediff(d_date, '{day}') >= -30
AND datediff(d_date, '{day}') <= 30
GROUP BY w_warehouse_name, i_item_id
HAVING inv_before > 0
AND inv_after / inv_before >= 2.0 / 3.0
AND inv_after / inv_before <= 3.0 / 2.0
ORDER BY w_warehouse_name, i_item_id
LIMIT 100
"""

_Q23_SQL = """
SELECT
  inv1.inv_warehouse_sk, inv1.inv_item_sk, inv1.d_moy AS d_moy,
  inv1.cov AS cov, inv2.d_moy AS d_moy2, inv2.cov AS cov2
FROM q23_temp_table inv1
JOIN q23_temp_table inv2
  ON (inv1.inv_warehouse_sk = inv2.inv_warehouse_sk
      AND inv1.inv_item_sk = inv2.inv_item_sk
      AND inv1.d_moy = {moy} AND inv2.d_moy = {moy} + 1)
ORDER BY inv1.inv_warehouse_sk, inv1.inv_item_sk
"""

_Q23_VIEW = """
SELECT inv_warehouse_sk, inv_item_sk, d_moy, (stdev / mean) AS cov
FROM (
  SELECT inv_warehouse_sk, inv_item_sk, d_moy,
    stddev_samp(inv_quantity_on_hand) AS stdev,
    avg(inv_quantity_on_hand) AS mean
  FROM inventory inv
  JOIN date_dim d
    ON (inv.inv_date_sk = d.d_date_sk AND d.d_year = {year}
        AND d_moy BETWEEN {moy} AND ({moy} + 1))
  GROUP BY inv_warehouse_sk, inv_item_sk, d_moy
) q23_tmp_inv_part
WHERE mean > 0 AND stdev / mean >= 1.3
"""

#: query -> (final SQL, [(view name, view SQL)])
SQL = {"q12": (Q12_SQL, []), "q14": (Q14_SQL, []), "q15": (Q15_SQL, []),
       "q16": (Q16_SQL, []), "q17": (Q17_SQL, []), "q20": (Q20_SQL, []),
       "q21": (Q21_SQL, []),
       "q22": (_Q22_SQL.format(day="2001-05-08"), []),
       "q23": (_Q23_SQL.format(moy=1), [
           ("q23_temp_table", _Q23_VIEW.format(year=2001, moy=1))]),
       # the 2002 snapshots: 2002-08-27, -28, -29 and -09-18 in q22's
       # window; two July and three August ones in q23's
       "q22_2002": (_Q22_SQL.format(day="2002-08-28"), []),
       "q23_2002": (_Q23_SQL.format(moy=7), [
           ("q23_temp_table", _Q23_VIEW.format(year=2002, moy=7))])}

PLANS: Dict[str, Callable] = {"q5": q5, "q6": q6, "q9": q9, "q11": q11}

#: the queries of the reference's suite that the port runs, then the two
#: variants over the 2002 snapshots
QUERIES = ("q5", "q6", "q9", "q11", "q12", "q14", "q15", "q16", "q17",
           "q20", "q21", "q22", "q23")
VARIANTS = ("q22_2002", "q23_2002")


def plan(query: str, t: Dict[str, Table]) -> pn.PlanNode:
    """The plan of ``query`` over the tables ``t`` (``gen_tables``); an
    SQL text is planned by a ``Session`` whose catalog holds the columns
    the query reads, its views registered first."""
    if query in PLANS:
        return PLANS[query](t)
    from spark_rapids_tpu_torch.api import Session

    final, views = SQL[query]
    s = Session(device="cpu")
    for name, cols in READS[query].items():
        s.create_temp_view(name, _source(t[name], cols))
    for name, text in views:
        s.create_temp_view(name, s.sql(text))
    return s.sql(final)._plan


# -- numpy oracles ------------------------------------------------------------


def _valid(col) -> np.ndarray:
    return ~np.ma.getmaskarray(col)


def _data(col) -> np.ndarray:
    return np.ma.getdata(col)


def _date_idx(sk: np.ndarray, d) -> tuple:
    """(a row of date_dim per date key, whether the key is in it): its
    keys are dense from ``DATE_SK_LO``."""
    i = sk - DATE_SK_LO
    ok = (i >= 0) & (i < len(d["d_date_sk"]))
    return np.where(ok, i, 0), ok


def _is(col: HostStrings, values) -> np.ndarray:
    return np.isin(col.dictionary.astype(str), list(values))[col.codes]


def _lex(keys: List[np.ndarray]) -> np.ndarray:
    """The stable order of rows by ``keys``, the first most significant."""
    return np.lexsort(keys[::-1]) if keys and len(keys[0]) else \
        np.zeros(0, np.int64)


def _group(key: np.ndarray):
    """(the sorted distinct keys, each row's group, the order) by one
    stable sort."""
    order = np.argsort(key, kind="stable")
    sk = key[order]
    start = np.r_[True, sk[1:] != sk[:-1]] if len(sk) else \
        np.zeros(0, bool)
    gid = np.empty(len(key), np.int64)
    gid[order] = np.cumsum(start) - 1
    return sk[start], gid


def q5_numpy(t) -> Table:
    """The rows of q5 (no order: compare them sorted)."""
    wc = t["web_clickstreams"]
    ok = _valid(wc["wcs_user_sk"])
    user, item = _data(wc["wcs_user_sk"])[ok], wc["wcs_item_sk"][ok] - 1
    it = t["item"]
    books = _is(it["i_category"], ["Books"])[item]
    cat = it["i_category_id"][item]
    span = int(user.max(initial=0)) + 1
    users = np.flatnonzero(np.bincount(user, minlength=span))
    counts = {"clicks_in_category": np.bincount(user[books],
                                                minlength=span)}
    for k in range(1, 8):
        counts[f"clicks_in_{k}"] = np.bincount(user[cat == k],
                                               minlength=span)
    cust, cd = t["customer"], t["customer_demographics"]
    users = users[users <= len(cust["c_customer_sk"])]
    cdemo = cust["c_current_cdemo_sk"][users - 1] - 1
    inside = cdemo < len(cd["cd_demo_sk"])
    users, cdemo = users[inside], cdemo[inside]
    out = {"clicks_in_category": counts["clicks_in_category"][users],
           "college_education": _is(cd["cd_education_status"],
                                    EDUCATION[:4])[cdemo].astype(np.int64),
           "male": _is(cd["cd_gender"], ["M"])[cdemo].astype(np.int64)}
    for k in range(1, 8):
        out[f"clicks_in_{k}"] = counts[f"clicks_in_{k}"][users]
    return out


def _year_totals(t, table, prefix, cust_col):
    s = t[table]
    d = t["date_dim"]
    di, ok = _date_idx(s[f"{prefix}_sold_date_sk"], d)
    year = d["d_year"][di]
    ok &= (year >= 2000) & (year <= 2001)
    half = ((s[f"{prefix}_ext_list_price"] -
             s[f"{prefix}_ext_wholesale_cost"]) -
            s[f"{prefix}_ext_discount_amt"] +
            s[f"{prefix}_ext_sales_price"]) / 2.0
    cust = s[cust_col][ok]
    y1 = year[ok] == 2000
    span = int(cust.max(initial=0)) + 1
    present = np.bincount(cust, minlength=span) > 0
    first = np.bincount(cust, np.where(y1, half[ok], 0.0), span)
    second = np.bincount(cust, np.where(y1, 0.0, half[ok]), span)
    keep = present & (first > 0)
    return np.flatnonzero(keep), first[keep], second[keep]


def q6_numpy(t) -> Table:
    sk, s1, s2 = _year_totals(t, _SS, "ss", "ss_customer_sk")
    wk, w1, w2 = _year_totals(t, "web_sales", "ws", "ws_bill_customer_sk")
    both, wi, si = np.intersect1d(wk, sk, assume_unique=True,
                                  return_indices=True)
    wr = w2[wi] / w1[wi]
    sr = s2[si] / s1[si]
    keep = wr > sr
    ratio, cust = wr[keep], both[keep]
    order = _lex([-ratio, cust])[:100]
    return {"web_sales_increase_ratio": ratio[order],
            "c_customer_sk": cust[order]}


def q9_numpy(t) -> Table:
    ss, d = t[_SS], t["date_dim"]
    di, ok = _date_idx(ss["ss_sold_date_sk"], d)
    ok &= d["d_year"][di] == 2000
    ok &= _valid(ss["ss_store_sk"])
    store = _data(ss["ss_store_sk"])
    ok &= (store >= 1) & (store <= len(t["store"]["s_store_sk"]))
    cust = ss["ss_customer_sk"]
    ca, cd = t["customer_address"], t["customer_demographics"]
    ok &= (cust >= 1) & (cust <= len(ca["ca_address_sk"])) & \
        (cust <= len(cd["cd_demo_sk"]))
    c = np.where(ok, cust - 1, 0)
    md = _is(cd["cd_marital_status"], ["M"])[c] & \
        _is(cd["cd_education_status"], ["4 yr Degree"])[c]
    price, profit = ss["ss_sales_price"], ss["ss_net_profit"]

    def band(x, lo, hi):
        return (x >= lo) & (x <= hi)

    arm_a = md & (band(price, 100, 150) | band(price, 50, 200) |
                  band(price, 150, 200))
    us = _is(ca["ca_country"], ["United States"])[c]

    def states(*s):
        return _is(ca["ca_state"], s)[c]

    arm_b = (us & states("KY", "GA", "NM") & band(profit, 0, 2000)) | \
        (us & states("MT", "OR", "IN") & band(profit, 150, 3000)) | \
        (us & states("WI", "MO", "WV") & band(profit, 50, 25000))
    keep = ok & arm_a & arm_b
    total = ss["ss_quantity"][keep].astype(np.int64).sum()
    return {"sum_quantity": np.array([total if keep.any() else None],
                                     dtype=object if not keep.any()
                                     else np.int64)}


def q11_numpy(t) -> Table:
    pr = t["product_reviews"]
    ok = _valid(pr["pr_item_sk"])
    items, gid = _group(_data(pr["pr_item_sk"])[ok])
    cnt = np.bincount(gid, minlength=len(items))
    avg = np.bincount(gid, pr["pr_review_rating"][ok].astype(np.float64),
                      len(items)) / cnt
    ws, d = t["web_sales"], t["date_dim"]
    di, in_dd = _date_idx(ws["ws_sold_date_sk"], d)
    in_dd &= d["d_year"][di] == 2001
    sold = np.zeros(int(ws["ws_item_sk"].max(initial=0)) + 1, bool)
    sold[ws["ws_item_sk"][in_dd]] = True
    keep = (items < len(sold)) & sold[np.minimum(items, len(sold) - 1)]
    x = cnt[keep].astype(np.longdouble)
    y = avg[keep].astype(np.longdouble)
    n = np.longdouble(len(x))
    cov = n * (x * y).sum() - x.sum() * y.sum()
    vx = n * (x * x).sum() - x.sum() ** 2
    vy = n * (y * y).sum() - y.sum() ** 2
    return {"corr": np.array([np.float64(cov / np.sqrt(vx * vy))])}


def q12_numpy(t) -> Table:
    wc, it, ss = t["web_clickstreams"], t["item"], t[_SS]
    books = _is(it["i_category"], ["Books", "Electronics"])
    click = wc["wcs_click_date_sk"]
    ok = (click >= 2451300) & (click <= 2451330) & \
        books[wc["wcs_item_sk"] - 1] & _valid(wc["wcs_user_sk"]) & \
        ~_valid(wc["wcs_sales_sk"])
    user, click = _data(wc["wcs_user_sk"])[ok], click[ok]
    sold = ss["ss_sold_date_sk"]
    sok = (sold >= 2451300) & (sold <= 2451390) & \
        books[ss["ss_item_sk"] - 1]
    cust, sold = ss["ss_customer_sk"][sok], sold[sok]
    size = int(max(user.max(initial=0), cust.max(initial=0))) + 1
    first_click = np.full(size, np.iinfo(np.int64).max)
    np.minimum.at(first_click, user, click)
    last_sale = np.full(size, np.iinfo(np.int64).min)
    np.maximum.at(last_sale, cust, sold)
    return {"wcs_user_sk": np.flatnonzero(first_click < last_sale
                                          ).astype(np.int64)}


def q14_numpy(t) -> Table:
    ws, hd, wp, td = (t["web_sales"], t["household_demographics"],
                      t["web_page"], t["time_dim"])
    ok = hd["hd_dep_count"][ws["ws_ship_hdemo_sk"] - 1] == 5
    cc = wp["wp_char_count"][ws["ws_web_page_sk"] - 1]
    ok &= (cc >= 5000) & (cc <= 6000)
    hour = td["t_hour"][ws["ws_sold_time_sk"]]
    amc = int((ok & ((hour == 7) | (hour == 8))).sum())
    pmc = int((ok & ((hour == 19) | (hour == 20))).sum())
    if not (ok & np.isin(hour, [7, 8, 19, 20])).any():
        ratio = -1.0  # no group: the sums are null, CASE takes ELSE
    else:
        ratio = amc / pmc if pmc > 0 else -1.0
    return {"am_pm_ratio": np.array([ratio])}


def q15_numpy(t, bounds: Optional[Dict[str, np.ndarray]] = None) -> Table:
    """q15's regression per category, its sums in extended precision.
    slope = (n sxy - sx sy) / (n sxx - sx^2) cancels: its numerator is
    some 1e6 times smaller than its terms, so a double's rounding of the
    sums moves it by up to about 1e-9 of itself (the port's fused
    multiply-add halves that, a plain double evaluation has 2e-8).
    ``bounds`` gets the absolute bound of each: 1e-9 of the terms,
    carried through."""
    ss, d, it = t[_SS], t["date_dim"], t["item"]
    di, ok = _date_idx(ss["ss_sold_date_sk"], d)
    ok &= (d["d_date"][di] >= _day("2001-09-02")) & \
        (d["d_date"][di] <= _day("2002-09-02"))
    ok &= _valid(ss["ss_store_sk"]) & (_data(ss["ss_store_sk"]) == 1)
    cat = it["i_category_id"][ss["ss_item_sk"][ok] - 1].astype(np.int64)
    x = ss["ss_sold_date_sk"][ok]
    keys, gid = _group(cat * (1 << 32) + x)
    y = np.zeros(len(keys), np.longdouble)
    np.add.at(y, gid, ss["ss_net_paid"][ok].astype(np.longdouble))
    gx, gcat = keys % (1 << 32), keys >> 32
    cats, cid = _group(gcat)
    nc = len(cats)

    def total(v):
        out = np.zeros(nc, np.longdouble)
        np.add.at(out, cid, v)
        return out

    n = np.bincount(cid, minlength=nc).astype(np.longdouble)
    xl = gx.astype(np.longdouble)
    sx, sy, sxy, sxx = total(xl), total(y), total(xl * y), total(xl * xl)
    den = n * sxx - sx * sx
    slope = (n * sxy - sx * sy) / den
    intercept = (sy - slope * sx) / n
    keep = slope <= 0
    slope_tol = 1e-9 * (abs(n * sxy) + abs(sx * sy)) / abs(den)
    icpt_tol = 1e-9 * (abs(sy) + abs(slope * sx)) / n + \
        slope_tol * abs(sx) / n
    if bounds is not None:
        bounds.update(slope=slope_tol[keep].astype(np.float64),
                      intercept=icpt_tol[keep].astype(np.float64))
    return {"cat": cats[keep].astype(np.int32),
            "slope": slope[keep].astype(np.float64),
            "intercept": intercept[keep].astype(np.float64)}


def _day(s: str) -> int:
    return int(np.datetime64(s, "D").astype(np.int64))


def q16_numpy(t) -> Table:
    ws, wr, it, w, d = (t["web_sales"], t["web_returns"], t["item"],
                        t["warehouse"], t["date_dim"])
    span = int(ws["ws_item_sk"].max(initial=0)) + 1
    key = ws["ws_order_number"] * span + ws["ws_item_sk"]
    rkey = wr["wr_order_number"] * span + wr["wr_item_sk"]
    order = np.argsort(rkey, kind="stable")
    rs = rkey[order]
    lo, hi = _search(rs, key)
    cnt = hi - lo
    # the left join: a row per matching return, one null-padded if none
    rows = np.repeat(np.arange(len(key)), np.maximum(cnt, 1))
    first = np.repeat(lo, np.maximum(cnt, 1))
    within = np.arange(len(rows)) - np.repeat(
        np.r_[0, np.cumsum(np.maximum(cnt, 1))[:-1]], np.maximum(cnt, 1))
    matched = np.repeat(cnt > 0, np.maximum(cnt, 1))
    refund = np.where(matched, wr["wr_refunded_cash"][
        order[np.minimum(first + within, max(len(rs) - 1, 0))]]
        if len(rs) else 0.0, 0.0)
    di, ok = _date_idx(ws["ws_sold_date_sk"][rows], d)
    diff = d["d_date"][di].astype(np.int64) - _day("2001-03-16")
    ok &= (diff >= -30) & (diff <= 30)
    ok &= ws["ws_warehouse_sk"][rows] <= len(w["w_warehouse_sk"])
    rows, refund, diff = rows[ok], refund[ok], diff[ok]
    value = ws["ws_sales_price"][rows] - refund
    state = w["w_state"].codes[ws["ws_warehouse_sk"][rows] - 1]
    item_id = it["i_item_id"].codes[ws["ws_item_sk"][rows] - 1]
    keys, gid = _group(state.astype(np.int64) * (1 << 32) + item_id)
    before = np.bincount(gid, np.where(diff < 0, value, 0.0), len(keys))
    after = np.bincount(gid, np.where(diff >= 0, value, 0.0), len(keys))
    keys, before, after = keys[:100], before[:100], after[:100]
    return {"w_state": w["w_state"].dictionary[keys >> 32],
            "i_item_id": it["i_item_id"].dictionary[keys % (1 << 32)],
            "sales_before": before, "sales_after": after}


def q17_numpy(t) -> Table:
    ss, d, it, st = t[_SS], t["date_dim"], t["item"], t["store"]
    di, ok = _date_idx(ss["ss_sold_date_sk"], d)
    ok &= (d["d_year"][di] == 2001) & (d["d_moy"][di] == 12)
    ok &= _is(it["i_category"], ["Books", "Music"])[ss["ss_item_sk"] - 1]
    store = _data(ss["ss_store_sk"])
    ok &= _valid(ss["ss_store_sk"]) & \
        (st["s_gmt_offset"][np.clip(store - 1, 0, len(
            st["s_store_sk"]) - 1)] == -5.0)
    c, ca = t["customer"], t["customer_address"]
    addr_ok = ca["ca_gmt_offset"][c["c_current_addr_sk"] - 1] == -5.0
    cust = ss["ss_customer_sk"]
    ok &= addr_ok[np.clip(cust - 1, 0, len(addr_ok) - 1)] & \
        (cust <= len(addr_ok))
    p = t["promotion"]
    promo = ss["ss_promo_sk"][ok] - 1
    flags = [_is(p[f"p_channel_{k}"], ["Y"])[promo]
             for k in ("email", "dmail", "tv")]
    price = ss["ss_ext_sales_price"][ok]
    if not ok.any():
        return {"promotional": np.array([None], object),
                "total": np.array([None], object),
                "promo_percent": np.array([0.0])}
    code = flags[0] * 4 + flags[1] * 2 + flags[2]
    sums = np.bincount(code, price, 8)
    present = np.bincount(code, minlength=8) > 0
    promotional = sums[present & (np.arange(8) > 0)].sum()
    total = sums[present].sum()
    pct = 100 * promotional / total if total > 0 else 0.0
    return {"promotional": np.array([promotional]),
            "total": np.array([total]), "promo_percent": np.array([pct])}


def _round7(x: np.ndarray, scale: int) -> np.ndarray:
    """Round as ``math.Round`` computes it (see there)."""
    p = np.float64(10.0) ** scale
    s = x * p if p != 1 else x
    r = np.where(s >= 0, np.floor(s + 0.5), np.ceil(s - 0.5))
    return r * (np.float64(1.0) / p) if p != 1 else r


def _per_customer(cust, ticket, money, span):
    """Per customer key below ``span``: distinct tickets, rows and the
    sum of ``money`` (the distinct pairs by one sort)."""
    tspan = int(ticket.max(initial=0)) + 1
    pairs = np.sort(cust * tspan + ticket)
    first = np.r_[True, pairs[1:] != pairs[:-1]] if len(pairs) else \
        np.zeros(0, bool)
    return (np.bincount(pairs[first] // tspan, minlength=span),
            np.bincount(cust, minlength=span),
            np.bincount(cust, money, span))


def q20_numpy(t, bounds: Optional[Dict[str, np.ndarray]] = None
              ) -> Table:
    """q20's ratios, rounded as ``math.Round`` rounds. ``bounds`` gets,
    for monetaryRatio (a ratio of two float sums), one rounding step
    (1e-7) on the rows whose unrounded ratio lies within 1e-9 of itself
    of a tie: the order of the sums decides the rounding there."""
    ss, sr = t[_SS], t["store_returns"]
    span = int(max(ss["ss_customer_sk"].max(initial=0),
                   sr["sr_customer_sk"].max(initial=0))) + 1
    o_n, o_i, o_m = _per_customer(ss["ss_customer_sk"],
                                  ss["ss_ticket_number"], ss["ss_net_paid"],
                                  span)
    r_n, r_i, r_m = _per_customer(sr["sr_customer_sk"],
                                  sr["sr_ticket_number"],
                                  sr["sr_return_amt"], span)
    users = np.flatnonzero(o_i > 0)
    hit = r_i[users] > 0

    def ratio(r, o):
        out = np.zeros(len(users))
        out[hit] = r[users][hit] / o[users][hit]
        return out

    money = ratio(r_m, o_m)
    if bounds is not None:
        scaled = money * 1e7
        tie = np.abs(scaled - np.floor(scaled) - 0.5) <= 1e-9 * scaled
        bounds["monetaryRatio"] = np.where(tie, 1e-7, 0.0)
    return {"user_sk": users.astype(np.int64),
            "orderRatio": _round7(ratio(r_n, o_n), 7),
            "itemsRatio": _round7(ratio(r_i, o_i), 7),
            "monetaryRatio": _round7(money, 7),
            "frequency": _round7(np.where(hit, r_n[users], 0).astype(
                np.float64), 0)}


def q21_numpy(t) -> Table:
    sr, ws, ss, d = t["store_returns"], t["web_sales"], t[_SS], t["date_dim"]
    st, it = t["store"], t["item"]
    di, ok = _date_idx(sr["sr_returned_date_sk"], d)
    ok &= (d["d_year"][di] == 2001) & (d["d_moy"][di] >= 1) & \
        (d["d_moy"][di] <= 7)
    r_item, r_cust = sr["sr_item_sk"][ok], sr["sr_customer_sk"][ok]
    r_ticket = sr["sr_ticket_number"][ok]
    r_qty = sr["sr_return_quantity"][ok].astype(np.int64)
    wi, wok = _date_idx(ws["ws_sold_date_sk"], d)
    wok &= (d["d_year"][wi] >= 2001) & (d["d_year"][wi] <= 2002)
    cspan = int(max(ws["ws_bill_customer_sk"].max(initial=0),
                    r_cust.max(initial=0), ss["ss_customer_sk"].max(
                        initial=0))) + 1
    ispan = int(max(ws["ws_item_sk"].max(initial=0), r_item.max(initial=0),
                    ss["ss_item_sk"].max(initial=0))) + 1
    wkey = np.sort(ws["ws_item_sk"][wok] * cspan +
                   ws["ws_bill_customer_sk"][wok])
    worder = np.argsort(ws["ws_item_sk"][wok] * cspan +
                        ws["ws_bill_customer_sk"][wok], kind="stable")
    wqty = ws["ws_quantity"][wok].astype(np.int64)[worder]
    wcum = np.r_[0, np.cumsum(wqty)]
    rkey = r_item * cspan + r_cust
    lo = np.searchsorted(wkey, rkey, "left")
    hi = np.searchsorted(wkey, rkey, "right")
    m_ws, sum_ws = hi - lo, wcum[hi] - wcum[lo]
    si, sok = _date_idx(ss["ss_sold_date_sk"], d)
    sok &= (d["d_year"][si] == 2001) & (d["d_moy"][si] == 1)
    store = _data(ss["ss_store_sk"])
    sok &= _valid(ss["ss_store_sk"]) & (store >= 1) & \
        (store <= len(st["s_store_sk"]))
    skey_all = (ss["ss_ticket_number"] * ispan + ss["ss_item_sk"]) * \
        cspan + ss["ss_customer_sk"]
    srows = np.flatnonzero(sok)
    sorder = np.argsort(skey_all[srows], kind="stable")
    skey = skey_all[srows][sorder]
    rskey = (r_ticket * ispan + r_item) * cspan + r_cust
    slo = np.searchsorted(skey, rskey, "left")
    shi = np.searchsorted(skey, rskey, "right")
    m_ss = shi - slo
    # every (return, its sale) pair, the return's web matches folded in
    pair_r = np.repeat(np.arange(len(rkey)), m_ss)
    pair_s = srows[sorder][np.repeat(slo, m_ss) + (
        np.arange(len(pair_r)) - np.repeat(np.r_[0, np.cumsum(m_ss)[:-1]],
                                           m_ss))]
    keep = m_ws[pair_r] > 0
    pair_r, pair_s = pair_r[keep], pair_s[keep]
    item = ss["ss_item_sk"][pair_s]
    store = store[pair_s]
    keys, gid = _group(item * (1 << 20) + store)
    n = len(keys)
    sales = np.zeros(n, np.int64)
    np.add.at(sales, gid, ss["ss_quantity"][pair_s].astype(np.int64) *
              m_ws[pair_r])
    returns = np.zeros(n, np.int64)
    np.add.at(returns, gid, r_qty[pair_r] * m_ws[pair_r])
    web = np.zeros(n, np.int64)
    np.add.at(web, gid, sum_ws[pair_r])
    gi, gs = keys >> 20, keys % (1 << 20)
    order = _lex([it["i_item_id"].codes[gi - 1],
                  it["i_item_desc"].codes[gi - 1],
                  st["s_store_id"].codes[gs - 1],
                  st["s_store_name"].codes[gs - 1]])[:100]
    gi, gs = gi[order], gs[order]

    def names(table, col, rows):
        return table[col].dictionary[table[col].codes[rows - 1]]

    return {"i_item_id": names(it, "i_item_id", gi),
            "i_item_desc": names(it, "i_item_desc", gi),
            "s_store_id": names(st, "s_store_id", gs),
            "s_store_name": names(st, "s_store_name", gs),
            "store_sales_quantity": sales[order],
            "store_returns_quantity": returns[order],
            "web_sales_quantity": web[order]}


def _inventory_rows(t, keep_day):
    """The inventory rows whose date's row of date_dim passes
    ``keep_day`` (a bool per date_dim row), by the 26 snapshot dates."""
    inv, d = t["inventory"], t["date_dim"]
    days = inv["inv_date_sk"]
    di, ok = _date_idx(days, d)
    return np.flatnonzero(ok & keep_day[di]), di


def _q22_numpy(t, day: str) -> Table:
    inv, it, w, d = t["inventory"], t["item"], t["warehouse"], t["date_dim"]
    diff_of = d["d_date"].astype(np.int64) - _day(day)
    rows, di = _inventory_rows(t, (diff_of >= -30) & (diff_of <= 30))
    price = it["i_current_price"][inv["inv_item_sk"][rows] - 1]
    rows = rows[(price >= 0.98) & (price <= 1.5)]
    wh = inv["inv_warehouse_sk"][rows]
    rows = rows[wh <= len(w["w_warehouse_sk"])]
    diff = diff_of[di[rows]]
    qoh = inv["inv_quantity_on_hand"][rows].astype(np.int64)
    wname = w["w_warehouse_name"].codes[inv["inv_warehouse_sk"][rows] - 1]
    iid = it["i_item_id"].codes[inv["inv_item_sk"][rows] - 1]
    keys, gid = _group(wname.astype(np.int64) * (1 << 32) + iid)
    n = len(keys)
    before = np.zeros(n, np.int64)
    np.add.at(before, gid, np.where(diff < 0, qoh, 0))
    after = np.zeros(n, np.int64)
    np.add.at(after, gid, np.where(diff >= 0, qoh, 0))
    with np.errstate(divide="ignore", invalid="ignore"):
        r = after / before
    keep = (before > 0) & (r >= 2.0 / 3.0) & (r <= 3.0 / 2.0)
    keys, before, after = keys[keep][:100], before[keep][:100], \
        after[keep][:100]
    return {"w_warehouse_name": w["w_warehouse_name"].dictionary[keys >> 32],
            "i_item_id": it["i_item_id"].dictionary[keys % (1 << 32)],
            "inv_before": before, "inv_after": after}


def _q23_numpy(t, year: int, moy: int) -> Table:
    inv, d = t["inventory"], t["date_dim"]
    rows, di = _inventory_rows(t, (d["d_year"] == year) &
                               (d["d_moy"] >= moy) & (d["d_moy"] <= moy + 1))
    month = d["d_moy"][di[rows]].astype(np.int64)
    wh, item = inv["inv_warehouse_sk"][rows], inv["inv_item_sk"][rows]
    q = inv["inv_quantity_on_hand"][rows].astype(np.float64)
    ispan = int(item.max(initial=0)) + 1
    keys, gid = _group((wh * ispan + item) * 13 + month)
    n = len(keys)
    cnt = np.bincount(gid, minlength=n).astype(np.float64)
    mean = np.bincount(gid, q, n) / cnt
    dev = q - mean[gid]
    with np.errstate(divide="ignore", invalid="ignore"):
        stdev = np.sqrt(np.bincount(gid, dev * dev, n) / (cnt - 1))
        stdev = np.where(cnt == 1, np.nan, stdev)
        cov = stdev / mean
        keep = (mean > 0) & (cov >= 1.3)
    keys, cov = keys[keep], cov[keep]
    m = keys % 13
    whi = keys // 13
    first, second = m == moy, m == moy + 1
    both, i1, i2 = np.intersect1d(whi[first], whi[second],
                                  assume_unique=True, return_indices=True)
    return {"inv_warehouse_sk": both // ispan, "inv_item_sk": both % ispan,
            "d_moy": np.full(len(both), moy, np.int32),
            "cov": cov[first][i1],
            "d_moy2": np.full(len(both), moy + 1, np.int32),
            "cov2": cov[second][i2]}


ORACLES: Dict[str, Callable] = {
    "q5": q5_numpy, "q6": q6_numpy, "q9": q9_numpy, "q11": q11_numpy,
    "q12": q12_numpy, "q14": q14_numpy, "q15": q15_numpy,
    "q16": q16_numpy, "q17": q17_numpy, "q20": q20_numpy,
    "q21": q21_numpy,
    "q22": lambda t: _q22_numpy(t, "2001-05-08"),
    "q23": lambda t: _q23_numpy(t, 2001, 1),
    "q22_2002": lambda t: _q22_numpy(t, "2002-08-28"),
    "q23_2002": lambda t: _q23_numpy(t, 2002, 7)}

#: q5 has no ORDER BY: its rows compare as a sorted set
UNORDERED = ("q5",)


def oracle(query: str, t: Dict[str, Table]):
    """(the oracle's rows of ``query``, an absolute bound per float
    column that needs one beyond 1e-9 relative: q15's, q20's)."""
    bounds: Dict[str, np.ndarray] = {}
    if query in ("q15", "q20"):
        return ORACLES[query](t, bounds), bounds
    return ORACLES[query](t), bounds


def _as_rows(cols: Table) -> List[tuple]:
    return sorted(zip(*(np.asarray(c).tolist() for c in cols.values())),
                  key=repr)


def check(query: str, got: Table, want: Table,
          bounds: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Raise unless ``got`` equals ``want``: the same columns in the same
    order, keys, strings and counts exact, floats within 1e-9 relative
    (plus ``bounds``, absolute), NaN where NaN, null where null."""
    if list(got) != list(want):
        raise AssertionError(f"{query}: columns {list(got)} != "
                             f"{list(want)}")
    if query in UNORDERED:
        got = dict(zip(got, zip(*_as_rows(got)))) if len(
            next(iter(got.values()))) else got
        want = dict(zip(want, zip(*_as_rows(want)))) if len(
            next(iter(want.values()))) else want
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        if len(g) != len(w):
            raise AssertionError(f"{query}: {name} has {len(g)} rows, "
                                 f"the oracle {len(w)}")
        if w.dtype.kind == "f":
            g = g.astype(np.float64)
            tol = 1e-9 * np.abs(w) + (bounds or {}).get(name, 0.0)
            bad = ~((np.abs(g - w) <= tol) | (np.isnan(g) & np.isnan(w)))
            if bad.any():
                i = int(np.flatnonzero(bad)[0])
                raise AssertionError(f"{query}: {name}[{i}] = {g[i]!r}, "
                                     f"the oracle {w[i]!r}")
        elif g.tolist() != w.tolist():
            raise AssertionError(f"{query}: column {name} differs")


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
