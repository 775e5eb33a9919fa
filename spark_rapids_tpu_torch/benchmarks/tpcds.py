"""The q26 columns of the TPC-DS-like generators, in numpy alone.

Each function replays spark_rapids_tpu/benchmarks/tpcds.py's
``default_rng`` draws in the same order with the same bounds (a bounded
draw's consumption of the stream depends on its bounds), stopping after
the last column q26 reads, so the columns equal the reference's seed for
seed.
"""
from __future__ import annotations

import numpy as np

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
            "i_category": CATEGORIES[cat_id],
            "i_class_id": class_id}
