"""The columns of the TPC-H generators that the port's queries read (all
22 of the reference's plans), in numpy alone.

Each function replays spark_rapids_tpu/benchmarks/datagen.py's
``default_rng`` draws in the same order with the same bounds (a bounded
draw's consumption of the stream depends on its bounds), stopping after
the last column these queries read, so the columns equal the
reference's seed for seed. A column drawn but not read is drawn and
dropped. A string column is a ``HostStrings``: the drawn indices,
remapped through the table of its distinct strings sorted once, and
that one sorted dictionary for the whole table; no Python string is
made per row.

As the reference's ``gen_table_chunks``, a table of up to ``chunk_rows``
rows (``CHUNK_ROWS`` by default) is one whole-table draw from
``default_rng(seed)``; a larger one is drawn in chunks from
``default_rng([seed, chunk])``, and lineitem's chunks get consecutive
``l_shipdate`` windows. DATE columns are int32 days since the epoch.
"""
from __future__ import annotations

import numpy as np

from spark_rapids_tpu_torch.io.hoststrings import HostStrings

CHUNK_ROWS = 1 << 23
_SEEDS = {"lineitem": 11, "orders": 12, "customer": 13, "supplier": 14,
          "nation": 15, "region": 16, "part": 17, "partsupp": 18}
_EPOCH = np.datetime64("1970-01-01")

RETURN_FLAGS = np.array(["A", "N", "R"], dtype=object)
LINE_STATUS = np.array(["F", "O"], dtype=object)
SEGMENTS = np.array(["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD",
                     "MACHINERY"], dtype=object)
PRIORITIES = np.array(["1-URGENT", "2-HIGH", "3-MEDIUM",
                       "4-NOT SPECIFIED", "5-LOW"], dtype=object)
SHIP_MODES = np.array(["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP",
                       "TRUCK"], dtype=object)
P_TYPES_1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
P_TYPES_2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
P_TYPES_3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
NATIONS = np.array(
    ["ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA",
     "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ", "JAPAN",
     "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE", "PERU", "CHINA",
     "ROMANIA", "SAUDI ARABIA", "VIETNAM", "RUSSIA", "UNITED KINGDOM",
     "UNITED STATES"], dtype=object)
REGIONS = np.array(["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"],
                   dtype=object)
ORDER_STATUS = np.array(["F", "O", "P"], dtype=object)
BRANDS = np.array([f"Brand#{b}" for b in range(11, 56)], dtype=object)
P_CONTAINERS_1 = ["SM", "MED", "LG", "JUMBO", "WRAP"]
P_CONTAINERS_2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
SHIP_INSTRUCT = np.array(["DELIVER IN PERSON", "COLLECT COD", "NONE",
                          "TAKE BACK RETURN"], dtype=object)
# TPC-H nation -> region (nation.tbl column 2)
NATION_REGION = np.array([0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0,
                          0, 1, 2, 3, 4, 2, 3, 3, 1], dtype=np.int64)

LINEITEM_COLUMNS = ["l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
                    "l_extendedprice", "l_discount", "l_tax",
                    "l_returnflag", "l_linestatus", "l_shipdate",
                    "l_commitdate", "l_receiptdate", "l_shipmode",
                    "l_shipinstruct"]
ORDERS_COLUMNS = ["o_orderkey", "o_custkey", "o_totalprice", "o_orderdate",
                  "o_orderpriority", "o_orderstatus", "o_shippriority"]
CUSTOMER_COLUMNS = ["c_custkey", "c_mktsegment", "c_acctbal",
                    "c_nationkey", "c_name", "c_phone"]
PART_COLUMNS = ["p_partkey", "p_brand", "p_type", "p_size", "p_container"]
SUPPLIER_COLUMNS = ["s_suppkey", "s_nationkey", "s_acctbal"]
NATION_COLUMNS = ["n_nationkey", "n_name", "n_regionkey"]
REGION_COLUMNS = ["r_regionkey", "r_name"]
PARTSUPP_COLUMNS = ["ps_partkey", "ps_suppkey", "ps_availqty",
                    "ps_supplycost"]


def days(s: str) -> int:
    """Days since the epoch of an ISO date."""
    return int((np.datetime64(s) - _EPOCH).astype(int))


_LO, _HI = days("1992-01-01"), days("1998-12-31")


def table_rows(name: str, sf: float) -> int:
    return {"lineitem": max(int(6_000_000 * sf), 100),
            "orders": max(int(1_500_000 * sf), 25),
            "customer": max(int(150_000 * sf), 10),
            "supplier": max(int(10_000 * sf), 5),
            "nation": 25, "region": 5,
            "part": max(int(200_000 * sf), 10),
            "partsupp": max(int(200_000 * sf), 10) * 4}[name]


def _chunks(name: str, sf: float, chunk_rows: int):
    """(rng, start, count, chunk index, chunk count) per generation
    chunk, as ``gen_table_chunks`` seeds them."""
    n = table_rows(name, sf)
    seed = _SEEDS[name]
    if n <= chunk_rows:
        yield np.random.default_rng(seed), 0, n, 0, 1
        return
    nchunks = -(-n // chunk_rows)
    for ci in range(nchunks):
        start = ci * chunk_rows
        yield (np.random.default_rng([seed, ci]), start,
               min(chunk_rows, n - start), ci, nchunks)


def _concat(parts, names, strings=None):
    """The chunks' columns joined; ``strings`` maps a string column to its
    table of distinct strings (the chunks hold indices into it)."""
    strings = strings or {}
    out = {}
    for c in names:
        col = np.concatenate([p[c] for p in parts])
        out[c] = HostStrings.from_table(strings[c], col) \
            if c in strings else col
    return out


def gen_lineitem(sf: float, chunk_rows: int = CHUNK_ROWS) -> dict:
    """``LINEITEM_COLUMNS``: the draws of ``_lineitem_chunk``."""
    parts = []
    for rng, _start, n, ci, nchunks in _chunks("lineitem", sf, chunk_rows):
        orderkey = rng.integers(1, max(int(1_500_000 * sf), 25) * 4, n
                                ).astype(np.int64)
        if nchunks == 1:
            lo, hi = _LO, _HI
        else:
            span = _HI - _LO + 1
            lo = _LO + (span * ci) // nchunks
            hi = _LO + (span * (ci + 1)) // nchunks - 1
        shipdate = rng.integers(lo, hi + 1, n).astype(np.int32)
        commit_delta = rng.integers(-30, 61, n)
        receipt_delta = rng.integers(1, 31, n)
        partkey = rng.integers(1, max(int(200_000 * sf), 10), n
                               ).astype(np.int64)
        suppkey = rng.integers(1, max(int(10_000 * sf), 5), n
                               ).astype(np.int64)
        quantity = rng.integers(1, 51, n).astype(np.float64)
        price = np.round(rng.random(n) * 100_000 + 900, 2)
        discount = np.round(rng.integers(0, 11, n) / 100.0, 2)
        tax = np.round(rng.integers(0, 9, n) / 100.0, 2)
        returnflag = rng.integers(0, 3, n).astype(np.int32)
        linestatus = rng.integers(0, 2, n).astype(np.int32)
        shipmode = rng.integers(0, 7, n).astype(np.int32)
        shipinstruct = rng.integers(0, 4, n).astype(np.int32)
        parts.append({
            "l_orderkey": orderkey, "l_partkey": partkey,
            "l_suppkey": suppkey,
            "l_quantity": quantity, "l_extendedprice": price,
            "l_discount": discount, "l_tax": tax,
            "l_returnflag": returnflag, "l_linestatus": linestatus,
            "l_shipdate": shipdate,
            "l_commitdate": (shipdate + commit_delta).astype(np.int32),
            "l_receiptdate": (shipdate + receipt_delta).astype(np.int32),
            "l_shipmode": shipmode, "l_shipinstruct": shipinstruct})
    return _concat(parts, LINEITEM_COLUMNS, {
        "l_returnflag": RETURN_FLAGS, "l_linestatus": LINE_STATUS,
        "l_shipmode": SHIP_MODES, "l_shipinstruct": SHIP_INSTRUCT})


def gen_part(sf: float, chunk_rows: int = CHUNK_ROWS) -> dict:
    """``PART_COLUMNS``: ``p_type`` is ``f"{t1} {t2} {t3}"`` and
    ``p_container`` ``f"{c1} {c2}"``, whose two draws come between
    ``p_type``'s and ``p_brand``'s."""
    types = np.array([f"{a} {b} {c}" for a in P_TYPES_1 for b in P_TYPES_2
                      for c in P_TYPES_3], dtype=object)
    containers = np.array([f"{a} {b}" for a in P_CONTAINERS_1
                           for b in P_CONTAINERS_2], dtype=object)
    parts = []
    for rng, start, n, _ci, _nc in _chunks("part", sf, chunk_rows):
        t1 = rng.integers(0, 6, n)
        t2 = rng.integers(0, 5, n)
        t3 = rng.integers(0, 5, n)
        c1 = rng.integers(0, 5, n)
        c2 = rng.integers(0, 8, n)
        parts.append({
            "p_partkey": np.arange(start + 1, start + n + 1, dtype=np.int64),
            "p_brand": rng.integers(11, 56, n) - 11,
            "p_type": t1 * 25 + t2 * 5 + t3,
            "p_size": rng.integers(1, 51, n).astype(np.int32),
            "p_container": c1 * 8 + c2})
    return _concat(parts, PART_COLUMNS, {"p_type": types,
                                         "p_brand": BRANDS,
                                         "p_container": containers})


def gen_customer(sf: float, chunk_rows: int = CHUNK_ROWS) -> dict:
    """``CUSTOMER_COLUMNS``. The reference draws the phone's country code
    with one scalar ``rng.integers(10, 35)`` per row inside an f-string;
    a vector draw of the same bounds gives the same values from the same
    stream. ``c_name`` is ``Customer#`` and the key in nine digits, so
    key order is string order and the names are their own dictionary."""
    suffix = np.arange(9000)
    phones = np.array([f"{cc}-{i % 900 + 100}-{i + 1000}"
                       for cc in range(10, 35) for i in suffix],
                      dtype=object)
    parts = []
    for rng, start, n, _ci, _nc in _chunks("customer", sf, chunk_rows):
        segment = rng.integers(0, 5, n)
        acctbal = np.round(rng.random(n) * 11_000 - 1_000, 2)
        nation = rng.integers(0, 25, n).astype(np.int64)
        cc = rng.integers(10, 35, n)
        row = np.arange(start, start + n)
        parts.append({
            "c_custkey": np.arange(start + 1, start + n + 1, dtype=np.int64),
            "c_mktsegment": segment, "c_acctbal": acctbal,
            "c_nationkey": nation, "c_name": row,
            "c_phone": (cc - 10) * 9000 + row % 9000})
    out = _concat(parts, [c for c in CUSTOMER_COLUMNS if c != "c_name"],
                  {"c_mktsegment": SEGMENTS, "c_phone": phones})
    n = table_rows("customer", sf)
    names = np.char.mod("Customer#%09d", np.arange(1, n + 1)).astype(object)
    out["c_name"] = HostStrings(np.arange(n, dtype=np.int32), names)
    return {c: out[c] for c in CUSTOMER_COLUMNS}


def gen_orders(sf: float, chunk_rows: int = CHUNK_ROWS) -> dict:
    """``ORDERS_COLUMNS``: the draws of ``_orders_chunk``, and
    ``o_shippriority``, 0 on every row."""
    parts = []
    for rng, start, n, _ci, _nc in _chunks("orders", sf, chunk_rows):
        custkey = rng.integers(1, max(int(150_000 * sf), 10), n
                               ).astype(np.int64)
        totalprice = np.round(rng.random(n) * 400_000 + 800, 2)
        orderdate = rng.integers(_LO, _HI + 1, n).astype(np.int32)
        priority = rng.integers(0, 5, n)
        parts.append({
            "o_orderkey": np.arange(start + 1, start + n + 1,
                                    dtype=np.int64) * 4,
            "o_custkey": custkey, "o_totalprice": totalprice,
            "o_orderdate": orderdate, "o_orderpriority": priority,
            "o_orderstatus": rng.integers(0, 3, n),
            "o_shippriority": np.zeros(n, dtype=np.int32)})
    return _concat(parts, ORDERS_COLUMNS, {"o_orderpriority": PRIORITIES,
                                           "o_orderstatus": ORDER_STATUS})


def gen_supplier(sf: float, chunk_rows: int = CHUNK_ROWS) -> dict:
    """``SUPPLIER_COLUMNS``."""
    parts = []
    for rng, start, n, _ci, _nc in _chunks("supplier", sf, chunk_rows):
        parts.append({
            "s_suppkey": np.arange(start + 1, start + n + 1, dtype=np.int64),
            "s_nationkey": rng.integers(0, 25, n).astype(np.int64),
            "s_acctbal": np.round(rng.random(n) * 11_000 - 1_000, 2)})
    return _concat(parts, SUPPLIER_COLUMNS)


def gen_nation(sf: float = 1.0, chunk_rows: int = CHUNK_ROWS) -> dict:
    """``NATION_COLUMNS``: the 25 nations, at every scale."""
    return {"n_nationkey": np.arange(25, dtype=np.int64),
            "n_name": HostStrings.from_table(NATIONS, np.arange(25)),
            "n_regionkey": NATION_REGION.copy()}


def gen_region(sf: float = 1.0, chunk_rows: int = CHUNK_ROWS) -> dict:
    """``REGION_COLUMNS``: the 5 regions, at every scale."""
    return {"r_regionkey": np.arange(5, dtype=np.int64),
            "r_name": HostStrings.from_table(REGIONS, np.arange(5))}


def gen_partsupp(sf: float, chunk_rows: int = CHUNK_ROWS) -> dict:
    """``PARTSUPP_COLUMNS``: four suppliers drawn per part (a part's rows
    are consecutive; row r is of part r // 4 + 1)."""
    n_supp = table_rows("supplier", sf)
    parts = []
    for rng, start, n, _ci, _nc in _chunks("partsupp", sf, chunk_rows):
        parts.append({
            "ps_partkey": np.arange(start, start + n, dtype=np.int64) // 4
            + 1,
            "ps_suppkey": rng.integers(1, n_supp + 1, n).astype(np.int64),
            "ps_availqty": rng.integers(1, 10_000, n).astype(np.int32),
            "ps_supplycost": np.round(rng.random(n) * 1_000 + 1, 2)})
    return _concat(parts, PARTSUPP_COLUMNS)


#: table name -> generator
GENERATORS = {"lineitem": gen_lineitem, "orders": gen_orders,
              "customer": gen_customer, "supplier": gen_supplier,
              "nation": gen_nation, "region": gen_region, "part": gen_part,
              "partsupp": gen_partsupp}
