"""The q14 and q22 columns of the TPC-H generators, in numpy alone.

Each function replays spark_rapids_tpu/benchmarks/datagen.py's
``default_rng`` draws in the same order with the same bounds (a bounded
draw's consumption of the stream depends on its bounds), stopping after
the last column q14 and q22 read, so the columns equal the reference's
seed for seed. A column drawn but not read is drawn and dropped; string
columns are built from their drawn indices through a table of the
distinct strings, never one Python string per row.

As the reference's ``gen_table_chunks``, a table of up to ``chunk_rows``
rows (``CHUNK_ROWS`` by default) is one whole-table draw from
``default_rng(seed)``; a larger one is drawn in chunks from
``default_rng([seed, chunk])``, and lineitem's chunks get consecutive
``l_shipdate`` windows. DATE columns are int32 days since the epoch.
"""
from __future__ import annotations

import numpy as np

CHUNK_ROWS = 1 << 23
_SEEDS = {"lineitem": 11, "orders": 12, "customer": 13, "part": 17}
_EPOCH = np.datetime64("1970-01-01")

P_TYPES_1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
P_TYPES_2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
P_TYPES_3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]

LINEITEM_COLUMNS = ["l_partkey", "l_extendedprice", "l_discount",
                    "l_shipdate"]


def days(s: str) -> int:
    """Days since the epoch of an ISO date."""
    return int((np.datetime64(s) - _EPOCH).astype(int))


_LO, _HI = days("1992-01-01"), days("1998-12-31")


def table_rows(name: str, sf: float) -> int:
    return {"lineitem": max(int(6_000_000 * sf), 100),
            "orders": max(int(1_500_000 * sf), 25),
            "customer": max(int(150_000 * sf), 10),
            "part": max(int(200_000 * sf), 10)}[name]


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


def _concat(parts, names):
    return {c: np.concatenate([p[c] for p in parts]) for c in names}


def gen_lineitem(sf: float, chunk_rows: int = CHUNK_ROWS) -> dict:
    """``l_partkey``, ``l_extendedprice``, ``l_discount`` and
    ``l_shipdate`` (the draws of ``_lineitem_chunk`` up to
    ``l_discount``)."""
    parts = []
    for rng, _start, n, ci, nchunks in _chunks("lineitem", sf, chunk_rows):
        rng.integers(1, max(int(1_500_000 * sf), 25) * 4, n)  # l_orderkey
        if nchunks == 1:
            lo, hi = _LO, _HI
        else:
            span = _HI - _LO + 1
            lo = _LO + (span * ci) // nchunks
            hi = _LO + (span * (ci + 1)) // nchunks - 1
        shipdate = rng.integers(lo, hi + 1, n).astype(np.int32)
        rng.integers(-30, 61, n)                           # commit delta
        rng.integers(1, 31, n)                             # receipt delta
        partkey = rng.integers(1, max(int(200_000 * sf), 10), n
                               ).astype(np.int64)
        rng.integers(1, max(int(10_000 * sf), 5), n)       # l_suppkey
        rng.integers(1, 51, n)                             # l_quantity
        price = np.round(rng.random(n) * 100_000 + 900, 2)
        discount = np.round(rng.integers(0, 11, n) / 100.0, 2)
        parts.append({"l_partkey": partkey, "l_extendedprice": price,
                      "l_discount": discount, "l_shipdate": shipdate})
    return _concat(parts, LINEITEM_COLUMNS)


def gen_part(sf: float, chunk_rows: int = CHUNK_ROWS) -> dict:
    """``p_partkey`` and ``p_type`` (``f"{t1} {t2} {t3}"``)."""
    types = np.array([f"{a} {b} {c}" for a in P_TYPES_1 for b in P_TYPES_2
                      for c in P_TYPES_3], dtype=object)
    parts = []
    for rng, start, n, _ci, _nc in _chunks("part", sf, chunk_rows):
        t1 = rng.integers(0, 6, n)
        t2 = rng.integers(0, 5, n)
        t3 = rng.integers(0, 5, n)
        parts.append({
            "p_partkey": np.arange(start + 1, start + n + 1, dtype=np.int64),
            "p_type": types[t1 * 25 + t2 * 5 + t3]})
    return _concat(parts, ["p_partkey", "p_type"])


def gen_customer(sf: float, chunk_rows: int = CHUNK_ROWS) -> dict:
    """``c_custkey``, ``c_acctbal`` and ``c_phone``. The reference draws
    the phone's country code with one scalar ``rng.integers(10, 35)`` per
    row inside an f-string; a vector draw of the same bounds gives the
    same values from the same stream."""
    suffix = np.arange(9000)
    phones = np.array([f"{cc}-{i % 900 + 100}-{i + 1000}"
                       for cc in range(10, 35) for i in suffix],
                      dtype=object)
    parts = []
    for rng, start, n, _ci, _nc in _chunks("customer", sf, chunk_rows):
        rng.integers(0, 5, n)                              # c_mktsegment
        acctbal = np.round(rng.random(n) * 11_000 - 1_000, 2)
        rng.integers(0, 25, n)                             # c_nationkey
        cc = rng.integers(10, 35, n)
        row = np.arange(start, start + n)
        parts.append({
            "c_custkey": np.arange(start + 1, start + n + 1, dtype=np.int64),
            "c_acctbal": acctbal,
            "c_phone": phones[(cc - 10) * 9000 + row % 9000]})
    return _concat(parts, ["c_custkey", "c_acctbal", "c_phone"])


def gen_orders(sf: float, chunk_rows: int = CHUNK_ROWS) -> dict:
    """``o_custkey`` (each chunk's first draw)."""
    parts = [{"o_custkey": rng.integers(1, max(int(150_000 * sf), 10), n
                                        ).astype(np.int64)}
             for rng, _s, n, _ci, _nc in _chunks("orders", sf, chunk_rows)]
    return _concat(parts, ["o_custkey"])
