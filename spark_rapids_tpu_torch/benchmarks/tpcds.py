"""The q26 and q91 columns of the TPC-DS-like generators, in numpy
alone, and TPC-DS q91's SQL text and numpy oracle.

Each function replays spark_rapids_tpu/benchmarks/tpcds.py's
``default_rng`` draws in the same order with the same bounds (a bounded
draw's consumption of the stream depends on its bounds), stopping after
the last column its query reads, so the columns equal the reference's
seed for seed. A string column is a ``HostStrings``: the drawn indices
remapped through the sorted table of its distinct strings.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from spark_rapids_tpu_torch.io.hoststrings import HostStrings

CATEGORIES = np.array(["Books", "Electronics", "Home", "Jewelry", "Men",
                       "Music", "Shoes", "Sports", "Children", "Women"],
                      dtype=object)

_DATE_SK_LO = 2450815


def gen_store_sales(sf: float, seed: int = 33) -> dict:
    """``ss_item_sk`` and ``ss_customer_sk`` of ``tpcds.gen_store_sales``."""
    rng = np.random.default_rng(seed)
    n = max(int(2_880_000 * sf), 200)
    n_item = max(int(18_000 * sf), 50)
    rng.integers(_DATE_SK_LO, _DATE_SK_LO + 5 * 365, n)  # ss_sold_date_sk
    rng.integers(0, 86_400, n)                           # ss_sold_time_sk
    item = rng.integers(1, n_item + 1, n).astype(np.int64)
    customer = rng.integers(1, max(int(100_000 * sf), 20), n
                            ).astype(np.int64)
    return {"ss_item_sk": item, "ss_customer_sk": customer}


def gen_item(sf: float, seed: int = 32) -> dict:
    """``i_item_sk``, ``i_category`` and ``i_class_id`` of
    ``tpcds.gen_item``."""
    rng = np.random.default_rng(seed)
    n = max(int(18_000 * sf), 50)
    rng.integers(1, 1000, n)                             # i_brand_id
    cat_id = rng.integers(0, 10, n)
    class_id = rng.integers(1, 9, n).astype(np.int32)
    return {"i_item_sk": np.arange(1, n + 1, dtype=np.int64),
            "i_category": HostStrings.from_table(CATEGORIES, cat_id),
            "i_class_id": class_id}


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


def gen_customer_address(sf: float, seed: int = 44) -> dict:
    """``ca_address_sk`` and ``ca_gmt_offset`` of
    ``tpcds.gen_customer_address``."""
    rng = np.random.default_rng(seed)
    n = max(int(50_000 * sf), 15)
    rng.integers(0, 3, n)                               # ca_country
    rng.integers(0, 12, n)                              # ca_state
    rng.integers(0, 5, n)                               # ca_city
    rng.integers(0, 16, n)                              # ca_zip
    return {"ca_address_sk": np.arange(1, n + 1, dtype=np.int64),
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
    """``hd_demo_sk`` and ``hd_buy_potential`` of
    ``tpcds.gen_household_demographics`` (7,200 rows at every scale)."""
    rng = np.random.default_rng(seed)
    n = 7200
    rng.integers(0, 10, n)                              # hd_dep_count
    rng.integers(0, 6, n)                               # hd_vehicle_count
    return {"hd_demo_sk": np.arange(1, n + 1, dtype=np.int64),
            "hd_buy_potential": HostStrings.from_table(
                _BUY_POTENTIAL, rng.integers(0, 4, n))}


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
