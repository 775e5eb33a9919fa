"""The TPC-DS-like generators, in numpy alone, and TPC-DS q91's SQL
text and numpy oracle.

Each function replays spark_rapids_tpu/benchmarks/tpcds.py's
``default_rng`` draws in the same order with the same bounds (a bounded
draw's consumption of the stream depends on its bounds), so the columns
equal the reference's seed for seed; q91's generators stop after the
last column q91 reads. A string column is a ``HostStrings``: the drawn
indices remapped through the sorted table of its distinct strings. A
column with nulls is a numpy masked array (the reference's
``pa.array(..., mask=...)``; ``plan.nodes.InMemorySource`` takes the
mask as its validity).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from spark_rapids_tpu_torch.io.hoststrings import HostStrings

CATEGORIES = np.array(["Books", "Electronics", "Home", "Jewelry", "Men",
                       "Music", "Shoes", "Sports", "Children", "Women"],
                      dtype=object)

_DATE_SK_LO = 2450815


def _date_sks(rng, n):
    return rng.integers(_DATE_SK_LO, _DATE_SK_LO + 5 * 365, n).astype(
        np.int64)


def _prices(rng, n, scale, offset=0.0):
    return np.round(offset + rng.random(n) * scale, 2)


def _strings(fmt, values) -> HostStrings:
    """``fmt.format(v)`` for each row's value, through the table of the
    distinct values (one Python string per distinct value)."""
    uniq, inv = np.unique(np.asarray(values), return_inverse=True)
    return HostStrings.from_table(
        np.array([fmt.format(v) for v in uniq], dtype=object),
        inv.reshape(-1))


def _numbered(fmt, n) -> HostStrings:
    """``fmt.format(i)`` for i from 1 to n, one row each."""
    return HostStrings.from_table(
        np.array([fmt.format(i) for i in range(1, n + 1)], dtype=object),
        np.arange(n))


def gen_store_sales(sf: float, seed: int = 33) -> dict:
    """``tpcds.gen_store_sales``, every column (``ss_hdemo_sk`` and
    ``ss_store_sk`` with their ~2% nulls)."""
    rng = np.random.default_rng(seed)
    n = max(int(2_880_000 * sf), 200)
    n_item = max(int(18_000 * sf), 50)
    out = {"ss_sold_date_sk": _date_sks(rng, n),
           "ss_sold_time_sk": rng.integers(0, 86_400, n).astype(np.int64),
           "ss_item_sk": rng.integers(1, n_item + 1, n).astype(np.int64),
           "ss_customer_sk": rng.integers(1, max(int(100_000 * sf), 20), n
                                          ).astype(np.int64),
           "ss_cdemo_sk": rng.integers(1, max(int(1_000 * sf), 20) + 1, n
                                       ).astype(np.int64)}
    hdemo = rng.integers(1, 7201, n).astype(np.int64)
    out["ss_hdemo_sk"] = np.ma.masked_array(hdemo, rng.random(n) < 0.02)
    out["ss_promo_sk"] = rng.integers(1, max(int(300 * sf), 10) + 1, n
                                      ).astype(np.int64)
    store = rng.integers(1, max(int(12 * sf), 2) + 1, n).astype(np.int64)
    out["ss_store_sk"] = np.ma.masked_array(store, rng.random(n) < 0.02)
    out["ss_ticket_number"] = rng.integers(1, max(n // 3, 2), n
                                           ).astype(np.int64)
    out["ss_addr_sk"] = rng.integers(1, max(int(50_000 * sf), 15) + 1, n
                                     ).astype(np.int64)
    out["ss_quantity"] = rng.integers(1, 101, n).astype(np.int32)
    for name, scale in (("ss_sales_price", 200), ("ss_net_paid", 250),
                        ("ss_ext_tax", 20), ("ss_wholesale_cost", 100),
                        ("ss_list_price", 250), ("ss_coupon_amt", 50),
                        ("ss_ext_list_price", 25_000),
                        ("ss_ext_wholesale_cost", 10_000),
                        ("ss_ext_discount_amt", 4_000),
                        ("ss_ext_sales_price", 20_000)):
        out[name] = _prices(rng, n, scale)
    out["ss_net_profit"] = _prices(rng, n, 4_000, -2_000)
    return out


def gen_item(sf: float, seed: int = 32) -> dict:
    """``tpcds.gen_item``, every column."""
    rng = np.random.default_rng(seed)
    n = max(int(18_000 * sf), 50)
    brand_id = rng.integers(1, 1000, n).astype(np.int32)
    cat_id = rng.integers(0, 10, n)
    out = {"i_item_sk": np.arange(1, n + 1, dtype=np.int64),
           "i_brand_id": brand_id,
           "i_brand": _strings("brand#{}", brand_id),
           "i_category_id": cat_id.astype(np.int32),
           "i_category": HostStrings.from_table(CATEGORIES, cat_id),
           "i_class_id": rng.integers(1, 9, n).astype(np.int32),
           "i_manufact_id": rng.integers(1, 1000, n).astype(np.int32),
           "i_manager_id": rng.integers(1, 100, n).astype(np.int32),
           "i_item_id": _numbered("AAAAAAAA{:08d}", n),
           "i_current_price": _prices(rng, n, 2.0, 0.5),
           "i_wholesale_cost": _prices(rng, n, 1.5, 0.2),
           "i_manufact": _strings("manufact{}",
                                  rng.integers(1, 1000, n) % 200),
           "i_class": _strings("class{}", rng.integers(1, 9, n)),
           "i_item_desc": _strings("item description {}",
                                   np.arange(n) % 997),
           "i_product_name": _numbered("product{}", n)}
    for name, table in (
            ("i_color", ["red", "blue", "green", "yellow", "white",
                         "black", "orange", "purple", "beige", "slate"]),
            ("i_size", ["small", "medium", "large", "extra large",
                        "petite", "economy"]),
            ("i_units", ["Each", "Dozen", "Case", "Pallet", "Gross",
                         "Ounce"])):
        out[name] = HostStrings.from_table(
            np.array(table, dtype=object),
            rng.integers(0, len(table), n))
    return out


def gen_web_sales(sf: float, seed: int = 46) -> dict:
    """``tpcds.gen_web_sales``, every column (``ws_ship_customer_sk``
    with its ~2% nulls)."""
    rng = np.random.default_rng(seed)
    n = max(int(700_000 * sf), 200)
    n_cust = max(int(100_000 * sf), 20)
    n_item = max(int(18_000 * sf), 50)
    n_addr = max(int(50_000 * sf), 15)
    n_wp = max(int(60 * sf), 5)
    n_wh = max(int(5 * sf), 2)

    def keys(lo, hi):
        return rng.integers(lo, hi, n).astype(np.int64)

    out = {"ws_sold_date_sk": keys(_DATE_SK_LO, _DATE_SK_LO + 5 * 365),
           "ws_sold_time_sk": keys(0, 86_400),
           "ws_bill_customer_sk": keys(1, n_cust + 1),
           "ws_bill_addr_sk": keys(1, n_addr + 1),
           "ws_item_sk": keys(1, n_item + 1),
           "ws_order_number": keys(1, max(n // 3, 2)),
           "ws_quantity": rng.integers(1, 101, n).astype(np.int32),
           "ws_warehouse_sk": keys(1, n_wh + 1),
           "ws_web_page_sk": keys(1, n_wp + 1),
           "ws_ship_hdemo_sk": keys(1, 7201)}
    for name, scale in (("ws_sales_price", 200), ("ws_net_paid", 300),
                        ("ws_ext_list_price", 250),
                        ("ws_ext_wholesale_cost", 100),
                        ("ws_ext_discount_amt", 40),
                        ("ws_ext_sales_price", 200)):
        out[name] = _prices(rng, n, scale)
    out["ws_net_profit"] = _prices(rng, n, 300, -150)
    out["ws_web_site_sk"] = keys(1, 31)
    ship = rng.integers(_DATE_SK_LO, _DATE_SK_LO + 5 * 365, n)
    out["ws_ship_date_sk"] = (ship + rng.integers(1, 30, n)).astype(
        np.int64)
    out["ws_ship_addr_sk"] = keys(1, n_addr + 1)
    ship_cust = keys(1, n_cust + 1)
    out["ws_ship_customer_sk"] = np.ma.masked_array(
        ship_cust, rng.random(n) < 0.02)
    out["ws_ship_mode_sk"] = keys(1, 21)
    out["ws_ext_ship_cost"] = _prices(rng, n, 100)
    out["ws_wholesale_cost"] = _prices(rng, n, 80, 0.2)
    out["ws_list_price"] = _prices(rng, n, 200, 0.5)
    out["ws_promo_sk"] = keys(1, max(int(300 * sf), 10) + 1)
    out["ws_coupon_amt"] = _prices(rng, n, 50)
    return out


def gen_web_returns(sf: float, seed: int = 48,
                    sales: Optional[dict] = None) -> dict:
    """``tpcds.gen_web_returns``: a tenth of ``gen_web_sales``' rows
    (``sales``, generated here when not given) and their draws."""
    sales = gen_web_sales(sf) if sales is None else sales
    rng = np.random.default_rng(seed)
    n_s = len(sales["ws_order_number"])
    n = max(n_s // 10, 20)
    idx = rng.choice(n_s, n, replace=False)
    out = {"wr_order_number": sales["ws_order_number"][idx],
           "wr_item_sk": sales["ws_item_sk"][idx],
           "wr_refunded_cash": _prices(rng, n, 100)}
    out["wr_returned_date_sk"] = sales["ws_sold_date_sk"][idx] + \
        rng.integers(1, 90, n)
    for name in ("wr_returning_customer_sk", "wr_refunded_customer_sk"):
        out[name] = sales["ws_bill_customer_sk"][idx]
    for name in ("wr_returning_addr_sk", "wr_refunded_addr_sk"):
        out[name] = sales["ws_bill_addr_sk"][idx]
    for name in ("wr_refunded_cdemo_sk", "wr_returning_cdemo_sk"):
        out[name] = rng.integers(1, max(int(1_000 * sf), 20) + 1, n
                                 ).astype(np.int64)
    out["wr_web_page_sk"] = sales["ws_web_page_sk"][idx]
    out["wr_reason_sk"] = rng.integers(1, 36, n).astype(np.int64)
    out["wr_return_quantity"] = rng.integers(1, 20, n).astype(np.int32)
    out["wr_return_amt"] = _prices(rng, n, 150)
    out["wr_net_loss"] = _prices(rng, n, 80)
    out["wr_fee"] = _prices(rng, n, 100)
    return out


def gen_store_returns(sf: float, seed: int = 48,
                      sales: Optional[dict] = None) -> dict:
    """``tpcds.gen_store_returns``: a twelfth of ``gen_store_sales``'
    rows (``sales``, generated here when not given) and their draws."""
    sales = gen_store_sales(sf) if sales is None else sales
    rng = np.random.default_rng(seed)
    n_s = len(sales["ss_ticket_number"])
    n = max(n_s // 12, 30)
    idx = rng.choice(n_s, n, replace=False)
    store_sk = rng.integers(1, max(int(12 * sf), 2) + 1, n).astype(
        np.int64)
    hdemo = rng.integers(1, 7201, n).astype(np.int64)
    out = {"sr_item_sk": sales["ss_item_sk"][idx],
           "sr_customer_sk": sales["ss_customer_sk"][idx],
           "sr_ticket_number": sales["ss_ticket_number"][idx]}
    out["sr_returned_date_sk"] = sales["ss_sold_date_sk"][idx] + \
        rng.integers(1, 90, n)
    out["sr_return_quantity"] = rng.integers(1, 20, n).astype(np.int32)
    out["sr_return_amt"] = _prices(rng, n, 150)
    out["sr_net_loss"] = _prices(rng, n, 80)
    out["sr_reason_sk"] = rng.integers(1, 36, n).astype(np.int64)
    out.update(sr_store_sk=store_sk, sr_cdemo_sk=sales["ss_cdemo_sk"][idx],
               sr_hdemo_sk=hdemo)
    for name, scale in (("sr_fee", 100), ("sr_refunded_cash", 100),
                        ("sr_reversed_charge", 50),
                        ("sr_store_credit", 50),
                        ("sr_return_ship_cost", 30),
                        ("sr_return_amt_inc_tax", 160),
                        ("sr_return_tax", 12)):
        out[name] = _prices(rng, n, scale)
    return out


def gen_inventory(sf: float, seed: int = 35) -> dict:
    """``tpcds.gen_inventory``: every item in every warehouse in each of
    26 weekly snapshots (234M rows at sf 10)."""
    rng = np.random.default_rng(seed)
    n_item = max(int(18_000 * sf), 50)
    n_wh = max(int(5 * sf), 2)
    weeks = 26
    n = n_item * n_wh * weeks
    week_start = rng.integers(_DATE_SK_LO, _DATE_SK_LO + 5 * 365 - 7,
                              weeks)
    return {"inv_date_sk": np.tile(np.repeat(week_start, n_item),
                                   n_wh).astype(np.int64),
            "inv_item_sk": np.tile(np.arange(1, n_item + 1, dtype=np.int64),
                                   n_wh * weeks),
            "inv_warehouse_sk": np.repeat(
                np.arange(1, n_wh + 1, dtype=np.int64), n_item * weeks),
            "inv_quantity_on_hand": rng.integers(0, 120, n).astype(
                np.int32)}


def gen_warehouse(sf: float, seed: int = 36) -> dict:
    """``tpcds.gen_warehouse``, every column."""
    rng = np.random.default_rng(seed)
    n = max(int(5 * sf), 2)

    def pick(table):
        return HostStrings.from_table(np.array(table, dtype=object),
                                      rng.integers(0, len(table), n))

    out = {"w_warehouse_sk": np.arange(1, n + 1, dtype=np.int64),
           "w_warehouse_name": _numbered("Warehouse {}", n),
           "w_state": pick(["CA", "TX", "NY", "WA", "GA"])}
    out["w_warehouse_sq_ft"] = rng.integers(50_000, 1_000_000, n).astype(
        np.int32)
    out["w_city"] = pick(["Midway", "Fairview", "Oakdale"])
    out["w_county"] = pick(["Williamson County", "Bronx County"])
    out["w_country"] = HostStrings.from_table(
        np.array(["United States"], dtype=object), np.zeros(n, np.int64))
    return out


def gen_promotion(sf: float, seed: int = 38) -> dict:
    """``tpcds.gen_promotion``: the four Y/N channel flags."""
    rng = np.random.default_rng(seed)
    n = max(int(300 * sf), 10)
    out = {"p_promo_sk": np.arange(1, n + 1, dtype=np.int64)}
    for name in ("p_channel_email", "p_channel_event", "p_channel_dmail",
                 "p_channel_tv"):
        out[name] = HostStrings.from_table(
            np.array(["Y", "N"], dtype=object), rng.integers(0, 2, n))
    return out


def gen_time_dim(sf: float, seed: int = 40) -> dict:
    """``tpcds.gen_time_dim``: one row a second of a day (no draw)."""
    secs = np.arange(86_400, dtype=np.int64)
    hours = secs // 3600
    meal = np.where((hours >= 6) & (hours <= 9), 1,
                    np.where((hours >= 11) & (hours <= 13), 2,
                             np.where((hours >= 17) & (hours <= 20), 3, 0)))
    return {"t_time_sk": secs, "t_time": secs.astype(np.int32),
            "t_hour": hours.astype(np.int32),
            "t_minute": (secs // 60 % 60).astype(np.int32),
            "t_meal_time": HostStrings.from_table(np.array(
                ["", "breakfast", "lunch", "dinner"], dtype=object), meal),
            "t_am_pm": HostStrings.from_table(
                np.array(["AM", "PM"], dtype=object),
                (hours >= 12).astype(np.int64))}


def gen_web_page(sf: float, seed: int = 49) -> dict:
    """``tpcds.gen_web_page``."""
    rng = np.random.default_rng(seed)
    n = max(int(60 * sf), 5)
    return {"wp_web_page_sk": np.arange(1, n + 1, dtype=np.int64),
            "wp_char_count": rng.integers(4000, 7001, n).astype(np.int32)}


_ZIPS = np.array(["85669", "86197", "88274", "83405", "86475", "85392",
                  "85460", "80348", "81792", "10001", "94103", "73301",
                  "30301", "98101", "60601", "33101"], dtype=object)


def gen_store(sf: float, seed: int = 41) -> dict:
    """``tpcds.gen_store``, every column."""
    n = max(int(12 * sf), 2)
    rng = np.random.default_rng(seed)

    def pick(table):
        table = np.array(table, dtype=object)
        return HostStrings.from_table(table, rng.integers(0, len(table), n))

    out = {"s_store_sk": np.arange(1, n + 1, dtype=np.int64),
           "s_store_id": _numbered("AAAAAAAA{:04d}", n),
           "s_store_name": _numbered("ese{}", n),
           "s_gmt_offset": np.where(rng.random(n) < 0.7, -5.0, -6.0)}
    out["s_city"] = pick(["Midway", "Fairview", "Oakdale", "Riverside"])
    out["s_county"] = pick(["Williamson County", "Franklin Parish",
                            "Bronx County", "Orange County"])
    out["s_state"] = pick(["TN", "TX", "OH", "CA"])
    out["s_zip"] = pick(_ZIPS)
    out["s_street_number"] = _strings("{}", np.arange(1, n + 1) * 10)
    out["s_street_name"] = _numbered("Main {}", n)
    out["s_street_type"] = pick(["Ave", "St", "Blvd"])
    out["s_suite_number"] = _numbered("Suite {}", n)
    out["s_number_employees"] = rng.integers(200, 300, n).astype(np.int32)
    out["s_company_id"] = rng.integers(1, 3, n).astype(np.int32)
    out["s_company_name"] = pick(["Unknown", "ought"])
    out["s_market_id"] = rng.integers(1, 11, n).astype(np.int32)
    out["s_floor_space"] = rng.integers(5_000_000, 10_000_000, n).astype(
        np.int32)
    return out


# -- TPC-DS q91 ---------------------------------------------------------------

#: q91's SQL text (the reference's ``TPCDS_SQL["q91"]``, verbatim)
Q91_SQL = """
SELECT cc_call_center_id AS call_center, cc_name AS call_center_name,
  cc_manager AS manager, sum(cr_net_loss) AS returns_loss
FROM call_center, catalog_returns, date_dim, customer,
  customer_address, customer_demographics, household_demographics
WHERE cr_call_center_sk = cc_call_center_sk
  AND cr_returned_date_sk = d_date_sk
  AND cr_returning_customer_sk = c_customer_sk
  AND cd_demo_sk = c_current_cdemo_sk
  AND hd_demo_sk = c_current_hdemo_sk
  AND ca_address_sk = c_current_addr_sk
  AND d_year = 1998 AND d_moy = 11
  AND ((cd_marital_status = 'M' AND cd_education_status = 'Unknown')
    OR (cd_marital_status = 'W'
        AND cd_education_status = 'Advanced Degree'))
  AND hd_buy_potential LIKE 'unknown%' AND ca_gmt_offset = -7.0
GROUP BY cc_call_center_id, cc_name, cc_manager, cd_marital_status,
  cd_education_status
ORDER BY returns_loss DESC
"""

_MARITAL = np.array(["M", "S", "D", "W", "U"], dtype=object)
_EDUCATION = np.array(["Primary", "Secondary", "College", "2 yr Degree",
                       "4 yr Degree", "Advanced Degree", "Unknown"],
                      dtype=object)
_BUY_POTENTIAL = np.array([">10000", "5001-10000", "1001-5000", "unknown"],
                          dtype=object)


def gen_catalog_returns(sf: float, seed: int = 51,
                        sales_seed: int = 34) -> dict:
    """``cr_returned_date_sk``, ``cr_returning_customer_sk``,
    ``cr_call_center_sk`` and ``cr_net_loss`` of
    ``tpcds.gen_catalog_returns``: catalog_sales' draws up to
    ``cs_call_center_sk`` (every column's draw consumed in order), then
    the returns' sample of it and its own draws up to ``cr_net_loss``."""
    rng = np.random.default_rng(sales_seed)
    n_s = max(int(1_440_000 * sf), 150)
    n_item = max(int(18_000 * sf), 50)
    n_cust = max(int(100_000 * sf), 20)
    n_addr = max(int(50_000 * sf), 15)
    n_wh = max(int(5 * sf), 2)
    sold = rng.integers(_DATE_SK_LO, _DATE_SK_LO + 5 * 365, n_s)
    rng.integers(_DATE_SK_LO, _DATE_SK_LO + 5 * 365, n_s)  # ship date
    rng.integers(1, 30, n_s)                            # ... its offset
    rng.integers(1, n_item + 1, n_s)                    # cs_item_sk
    bill_customer = rng.integers(1, n_cust + 1, n_s)
    rng.integers(1, n_addr + 1, n_s)                    # cs_bill_addr_sk
    rng.integers(1, max(n_s // 3, 2), n_s)              # cs_order_number
    rng.integers(1, n_wh + 1, n_s)                      # cs_warehouse_sk
    rng.integers(0, 86_400, n_s)                        # cs_sold_time_sk
    rng.integers(1, 101, n_s)                           # cs_quantity
    for _ in range(4):  # sales_price, ext_discount, net_profit, ext_sales
        rng.random(n_s)
    rng.integers(1, max(int(1_000 * sf), 20) + 1, n_s)  # cs_bill_cdemo_sk
    rng.integers(1, 7201, n_s)                          # cs_bill_hdemo_sk
    rng.integers(1, max(int(300 * sf), 10) + 1, n_s)    # cs_promo_sk
    rng.integers(1, n_cust + 1, n_s)                    # cs_ship_customer
    rng.integers(1, n_addr + 1, n_s)                    # cs_ship_addr_sk
    rng.random(n_s)                                     # ... its null mask
    call_center = rng.integers(1, 7, n_s)
    rng = np.random.default_rng(seed)
    n = max(n_s // 12, 20)
    idx = rng.choice(n_s, n, replace=False)
    rng.random(n)                                       # cr_refunded_cash
    returned = sold[idx] + rng.integers(1, 90, n)
    rng.integers(1, 20, n)                              # cr_return_quantity
    rng.random(n)                                       # cr_return_amount
    rng.random(n)                                       # cr_return_amt_inc_tax
    net_loss = np.round(rng.random(n) * 80, 2)
    return {"cr_returned_date_sk": returned.astype(np.int64),
            "cr_returning_customer_sk": bill_customer[idx].astype(np.int64),
            "cr_call_center_sk": call_center[idx].astype(np.int64),
            "cr_net_loss": net_loss}


def gen_call_center(sf: float, seed: int = 54) -> dict:
    """``cc_call_center_sk``, ``cc_call_center_id``, ``cc_name`` and
    ``cc_manager`` of ``tpcds.gen_call_center`` (no draw reaches them)."""
    n = 6
    rows = np.arange(n)

    def strings(fmt):
        return HostStrings.from_table(
            np.array([fmt.format(i) for i in range(1, n + 1)],
                     dtype=object), rows)

    return {"cc_call_center_sk": np.arange(1, n + 1, dtype=np.int64),
            "cc_call_center_id": strings("AAAAAAAA{:04d}"),
            "cc_name": strings("call center {}"),
            "cc_manager": strings("Manager {}")}


def date_dim_days() -> np.ndarray:
    """``d_date`` of ``tpcds.gen_date_dim`` as the port's DATE: int32
    days since the epoch, one a day of 1998-2002."""
    return (np.arange(np.datetime64("1998-01-01"),
                      np.datetime64("2003-01-01")) -
            np.datetime64("1970-01-01")).astype(np.int32)


def gen_date_dim(sf: float, seed: int = 31) -> dict:
    """``d_date_sk``, ``d_year`` and ``d_moy`` of ``tpcds.gen_date_dim``:
    one row per day of 1998-2002 (no draw)."""
    days = np.arange(np.datetime64("1998-01-01"),
                     np.datetime64("2003-01-01"))
    n = len(days)
    years = days.astype("datetime64[Y]").astype(int) + 1970
    months = days.astype("datetime64[M]").astype(int) % 12 + 1
    return {"d_date_sk": np.arange(_DATE_SK_LO, _DATE_SK_LO + n,
                                   dtype=np.int64),
            "d_year": years.astype(np.int32),
            "d_moy": months.astype(np.int32)}


def gen_customer(sf: float, seed: int = 42) -> dict:
    """``c_customer_sk`` and the three ``c_current_*_sk`` of
    ``tpcds.gen_customer``."""
    rng = np.random.default_rng(seed)
    n = max(int(100_000 * sf), 20)
    n_demo = max(int(1_000 * sf), 10)
    n_addr = max(int(50_000 * sf), 15)
    cdemo = rng.integers(1, n_demo + 1, n).astype(np.int64)
    hdemo = rng.integers(1, 7201, n).astype(np.int64)
    addr = rng.integers(1, n_addr + 1, n).astype(np.int64)
    return {"c_customer_sk": np.arange(1, n + 1, dtype=np.int64),
            "c_current_cdemo_sk": cdemo, "c_current_hdemo_sk": hdemo,
            "c_current_addr_sk": addr}


_COUNTRIES = np.array(["United States", "Canada", "Mexico"], dtype=object)
_CA_STATES = np.array(["KY", "GA", "NM", "MT", "OR", "IN", "WI", "MO",
                       "WV", "CA", "TX", "NY"], dtype=object)


def gen_customer_address(sf: float, seed: int = 44) -> dict:
    """``ca_address_sk``, ``ca_country``, ``ca_state`` and
    ``ca_gmt_offset`` of ``tpcds.gen_customer_address``."""
    rng = np.random.default_rng(seed)
    n = max(int(50_000 * sf), 15)
    country = HostStrings.from_table(_COUNTRIES, rng.integers(0, 3, n))
    state = HostStrings.from_table(_CA_STATES, rng.integers(0, 12, n))
    rng.integers(0, 5, n)                               # ca_city
    rng.integers(0, 16, n)                              # ca_zip
    return {"ca_address_sk": np.arange(1, n + 1, dtype=np.int64),
            "ca_country": country, "ca_state": state,
            "ca_gmt_offset": np.where(rng.random(n) < 0.6, -5.0, -7.0)}


def gen_customer_demographics(sf: float, seed: int = 37) -> dict:
    """``cd_demo_sk``, ``cd_marital_status`` and ``cd_education_status``
    of ``tpcds.gen_customer_demographics``."""
    rng = np.random.default_rng(seed)
    n = max(int(1_000 * sf), 20)
    rng.integers(0, 2, n)                               # cd_gender
    marital = HostStrings.from_table(_MARITAL, rng.integers(0, 5, n))
    education = HostStrings.from_table(_EDUCATION, rng.integers(0, 7, n))
    return {"cd_demo_sk": np.arange(1, n + 1, dtype=np.int64),
            "cd_marital_status": marital,
            "cd_education_status": education}


def gen_household_demographics(sf: float, seed: int = 39) -> dict:
    """``tpcds.gen_household_demographics``, every column (7,200 rows at
    every scale)."""
    rng = np.random.default_rng(seed)
    n = 7200
    dep = rng.integers(0, 10, n).astype(np.int32)
    vehicles = rng.integers(0, 6, n).astype(np.int32)
    return {"hd_demo_sk": np.arange(1, n + 1, dtype=np.int64),
            "hd_dep_count": dep, "hd_vehicle_count": vehicles,
            "hd_buy_potential": HostStrings.from_table(
                _BUY_POTENTIAL, rng.integers(0, 4, n)),
            "hd_income_band_sk": rng.integers(1, 21, n).astype(np.int64)}


#: q91's tables, name -> generator of the columns q91 reads
Q91_GENERATORS = {
    "call_center": gen_call_center,
    "catalog_returns": gen_catalog_returns,
    "date_dim": gen_date_dim,
    "customer": gen_customer,
    "customer_address": gen_customer_address,
    "customer_demographics": gen_customer_demographics,
    "household_demographics": gen_household_demographics,
}


def q91_tables(sf: float) -> Dict[str, dict]:
    return {name: gen(sf) for name, gen in Q91_GENERATORS.items()}


def q91_numpy(t: Dict[str, dict]) -> Dict[str, np.ndarray]:
    """q91 in plain numpy: every surrogate key is dense from 1 (the
    dates from their first day), so each return looks its rows up by
    index; filter, group by the five string keys in their sorted order,
    sum, and order by the sum, descending (stable over the key order)."""
    t = {name: {k: v.to_objects() if isinstance(v, HostStrings) else v
                for k, v in cols.items()} for name, cols in t.items()}
    cr, cc, d = t["catalog_returns"], t["call_center"], t["date_dim"]
    c, ca = t["customer"], t["customer_address"]
    cd, hd = t["customer_demographics"], t["household_demographics"]
    di = cr["cr_returned_date_sk"] - d["d_date_sk"][0]
    in_dates = (di >= 0) & (di < len(d["d_date_sk"]))
    di = np.where(in_dates, di, 0)
    ci = cr["cr_returning_customer_sk"] - 1
    cdi = c["c_current_cdemo_sk"][ci] - 1
    hdi = c["c_current_hdemo_sk"][ci] - 1
    cai = c["c_current_addr_sk"][ci] - 1
    cci = cr["cr_call_center_sk"] - 1
    ms = cd["cd_marital_status"][cdi]
    es = cd["cd_education_status"][cdi]
    keep = (in_dates & (d["d_year"][di] == 1998) & (d["d_moy"][di] == 11)
            & (((ms == "M") & (es == "Unknown")) |
               ((ms == "W") & (es == "Advanced Degree")))
            & np.array([s.startswith("unknown") for s in
                        hd["hd_buy_potential"]])[hdi]
            & (ca["ca_gmt_offset"][cai] == -7.0))
    keys = np.stack([cc["cc_call_center_id"][cci][keep].astype(str),
                     cc["cc_name"][cci][keep].astype(str),
                     cc["cc_manager"][cci][keep].astype(str),
                     ms[keep].astype(str), es[keep].astype(str)], axis=1)
    loss = cr["cr_net_loss"][keep]
    if not len(loss):
        groups = np.zeros((0, 5), dtype=str)
        sums = np.zeros(0)
    else:
        groups, inv = np.unique(keys, axis=0, return_inverse=True)
        sums = np.array([loss[inv.reshape(-1) == g].sum()
                         for g in range(len(groups))])
    order = np.argsort(-sums, kind="stable")
    return {"call_center": groups[order, 0].astype(object),
            "call_center_name": groups[order, 1].astype(object),
            "manager": groups[order, 2].astype(object),
            "returns_loss": sums[order]}
