#!/usr/bin/env python3
"""Chip smoke for spark_rapids_tpu_torch on one NVIDIA Hopper card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

``python3 chip_smoke.py --strings`` runs phases 1-2 and the LIKE and
substring cases of phase 3 alone, with the package beside the script, so
a copy of the script in another tree of the port times that tree's
kernels at the same cases (it prints no ``ok`` line).

Phases, each of which fails the run (nonzero exit, no ``ok`` line):

1. the card: ``nvidia-smi`` name and power limit, the torch device name;
2. build: every CUDA source of the port through ``nvcc`` for sm_90a, all
   at once, with the compiler's register and shared-memory report;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main paths' shapes (TPCx-BB sf 10: a 28.8M-row mask for the
   partition kernel and its first 2,097,152 rows, one scan batch, each
   with its true count checked against ``mask.sum()``; an
   ~18k-row Books build probed by 28.8M stream hashes and by one scan
   batch of them, and builds of 26,000 and 28,000 item ids, either side
   of the probe's shared-memory cutoff, probed by the same stream; a
   radix argsort over the ~70k HAVING survivors, over 28.8M customer
   keys and over 28.8M uniform int64 keys; TPC-DS q91 sf 10: its first
   join, the 1.2M-row catalog_returns build on 6 call-center keys
   probed by the 6 call centers and by a 2M-row stream drawn from
   them; TPC-H sf 10: the match table over part's p_type
   dictionary and the sf-10 c_phone dictionary, over a 1M-entry
   table past the reference's 64 MiB window budget, and over a 65,536 x
   512 table (a group of lanes per row; a 70-byte needle takes the
   window path); substring over the
   c_phone dictionary and over a table of pos / length edges; TPC-DS q91:
   the LIKE table over household_demographics' hd_buy_potential, then
   over the sf-10 c_phone dictionary and the 1M-entry table with the
   reference's test patterns and patterns past its budget, then at
   every width from 1 to 512 with each anchoring, '_' at segment edges,
   escapes and a body past 64 bytes; substring's pos / length edges at
   widths 8, 16, 32, 64 and 512). Results must be equal; times come
   from CUDA events over warmed repeated launches, beside the bytes
   bound at 3.35 TB/s and, where one exists, one PyTorch library call
   computing the same function; the partition, match-table, LIKE and
   substring kernels also give their device time alone
   (``torch.profiler``, kernel durations only) beside the wrapper's;
   then the fused multiply-add (C3): three float expressions over 4,096
   seeded rows through the SQL front end, each bit-equal to a * b + c
   rounded once (computed exactly on the host);
4. the q5lite step: 4M rows, 65,536 keys, seed 7, against a numpy
   oracle (groups, keys and counts exact, sums within 1e-9 relative);
5. TPCx-BB q26 at sf 10 (store_sales 28.8M rows, item 180k, 1M
   customers) through apply_overrides -> collect, exactly equal to a
   numpy oracle; every query phase from here on runs the default exec
   tree (fused, ``execs/fused.py``) and then the unfused one
   (``rapids.tpu.sql.fusion.enabled`` false), each checked, each with a
   line of its own (``"tree"``) and, for the fused tree, its fused execs,
   the ones that fell back to their unfused subtree and each chain
   join's probe mode (dense or hash); each tree must launch the kernels
   ``PATH_KERNELS`` gives it, and the fused tree also K1 wherever a
   standalone chain ran and K3 wherever a chain join probed by hash;
6. TPC-H q14 at sf 10 (lineitem 60M rows in 8 generation chunks, part
   2M), within 1e-9 relative of a numpy oracle;
7. the other TPC-H queries of ``tpch.INPUTS`` at sf 10 over the same
   lineitem (and orders 15M, customer 1.5M, supplier 100k, nation 25,
   region 5, partsupp 8M), generated once with its string columns as
   ``HostStrings`` (one sorted dictionary per table): q1, q3, q6 and
   q12, q4, q13, q15, q16, q18 and q21, then q5, q10, q19, q2, q17, q7,
   q8, q9, q11 and q20, each against its numpy oracle (strings, keys
   and counts exact, float sums and averages within 1e-9 relative),
   with rows (a grand aggregate's not null), failing unless it launched
   every kernel of its path (every launch count printed), with its warm
   wall, its peak device memory (and what was allocated before it
   started), and q3's
   build rows; q5 with ``tpch.QUERY_CONF`` (its written join order: the
   greedy one joins customer on the nation key alone), q11 with TPC-H's
   fraction for the scale (0.0001 / sf; the reference's literal is the
   sf-1 value and keeps no part at sf 10);
   q1 also in a profiled run of the default tree: its group-by calls'
   device time (the dense path), failing if ``index_add_`` ran; q21
   again with every aggregate step timed apart (the merge loop of its
   distinct counts);
   then the group-by's float sums at q1's shape (the dense path, 6
   groups over 2,097,152 rows, q1's eight aggregates) and the sort
   path's fold kernel (S1, ``seg_reduce``, counted as ``seg_sum``):
   sums at q13's second aggregate (a few dozen keys over 1.5M rows), the
   q5lite step's live rows and q18's last merge (its running partial of
   about 36M order keys and one 2,097,152-row batch), min and max at
   the last two, the kernel equal to its plain version bit for bit,
   each against the host's values, beside ``index_add_`` or
   ``scatter_reduce_`` (the one PyTorch call that does the same per
   group), the kernel's device time and the bytes bound; then the C5
   groups' float sums, min, max and any_valid on the dense and sort
   paths and with no key, the card equal to the CPU bit for bit; then
   left, left semi and full joins of a 2,097,152-row
   lineitem batch against the filtered orders on the card, each equal
   to the same call on the CPU;
   then TPC-H q22 at sf 10 (customer 1.5M rows, orders 15M), country
   codes and counts exact and balances within 1e-9 relative of a numpy
   oracle, and the substring step split into kernel time and host
   dictionary rebuild;
8. TPC-DS q91 at sf 10 (catalog_returns 1.2M rows sampled from 14.4M
   catalog_sales, customer 1M, customer_address 500k) through the SQL
   front end (Session.create_temp_view -> sql -> collect), group keys
   exact and sums within 1e-9 relative of a numpy oracle; then the C7
   queries (a small-range key that keeps its statistics through a
   string filter, a filter below a projection, a join's stream side
   and a pmod by a positive literal in the fused tree) on the card
   against the CPU, bit for bit;
   then TPCx-BB at sf 10 (its tables' sizes printed first: store_sales
   28.8M rows, web_sales 7M, web_clickstreams 50M, inventory 234M,
   store_returns 2.4M, web_returns 700k, product_reviews 600k): the
   reference's q5, q6, q9, q11 (plan trees) and q12, q14, q15, q16,
   q17, q20, q21, q22, q23 (SQL text, q23 through a temp view), and
   q22 and q23 with their dates moved to the 2002 inventory snapshots
   (``tpcxbb.VARIANTS``; as written both are empty at every scale),
   each on both trees against its numpy oracle (``tpcxbb.check``), with
   rows but for the verbatim q22 and q23, each scanning only the
   columns it reads;
9. the partition kernel at the sizes the timed query runs launched it
   with (a histogram of them, then cases at their quantiles, each
   against its plain version and its count against ``mask.sum()``);
10. a ``{"kernels": [...]}`` line, the card's name and power limit, and
   last the ``{"ok": true, ...}`` line.

Each query phase sets the launch counts to 0 just before its timed run
and reads them just after; the launch sizes are kept during those runs
only.

It imports nothing of JAX or of spark_rapids_tpu. It needs one CUDA card
and this repository around it; without either it fails.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# the table's highest integer rate (int8, dense): a byte comparison is
# one operation, so operations over this rate are a lower bound
INT8_OPS_PER_S = 1.979e15
SF = 10
SEED_Q5 = 7
FUSION = "rapids.tpu.sql.fusion.enabled"
# each query runs on the default (fused) tree, then on the unfused one
TREES = ("fused", "unfused")
# kernels of each timed query, per tree (launch counts must be positive
# there; the fused tree must also launch what its chains reach: K1 at a
# standalone chain's end, K3 for a hash-mode chain join)
PATH_KERNELS = {"fused": {
    "q26": ("partition_order", "radix_order"),
    "q14": ("match_table", "partition_order"),
    "q22": ("substring", "radix_order", "probe", "partition_order"),
    "q91": ("like_table", "partition_order", "seg_sum"),
    "q1": ("radix_order",), "q6": (),
    "q12": ("partition_order", "radix_order", "probe"),
    "q3": ("partition_order", "probe", "seg_sum"),
    "q4": ("partition_order", "radix_order", "probe"),
    "q13": ("partition_order", "radix_order", "probe"),
    "q15": ("seg_sum", "radix_order"),
    "q16": ("partition_order", "radix_order", "match_table"),
    "q18": ("partition_order", "probe", "seg_sum"),
    "q21": ("partition_order", "radix_order", "probe"),
    "q5": ("partition_order", "probe"),
    "q10": ("partition_order", "probe", "seg_sum"),
    "q19": ("partition_order", "probe", "match_table"),
    "q2": ("partition_order", "match_table", "seg_sum"),
    "q17": ("partition_order", "match_table", "seg_sum"),
    "q7": ("probe", "radix_order", "seg_sum"),
    "q8": ("partition_order", "radix_order", "probe"),
    "q9": ("partition_order", "radix_order", "probe", "match_table",
           "seg_sum"),
    "q11": ("partition_order", "seg_sum"),
    "q20": ("partition_order", "probe", "radix_order", "match_table",
            "seg_sum"),
    "bb_q5": ("partition_order",), "bb_q6": ("partition_order", "seg_sum"),
    "bb_q9": ("partition_order",), "bb_q11": ("partition_order", "seg_sum"),
    "bb_q12": ("partition_order", "radix_order", "probe"), "bb_q14": (),
    "bb_q15": ("partition_order", "radix_order", "seg_sum"),
    "bb_q16": ("radix_order", "probe", "seg_sum"),
    "bb_q17": ("partition_order",), "bb_q20": ("radix_order", "seg_sum"),
    "bb_q21": ("partition_order", "radix_order", "probe"),
    "bb_q22": ("partition_order",), "bb_q23": (),
    "bb_q22_2002": ("partition_order", "radix_order"),
    "bb_q23_2002": ("partition_order", "radix_order", "probe",
                    "seg_sum")}, "unfused": {
    "q26": ("partition_order", "radix_order", "probe"),
    "q14": ("match_table", "probe", "partition_order"),
    "q22": ("substring", "probe", "radix_order", "partition_order"),
    "q91": ("like_table", "probe", "partition_order", "seg_sum"),
    "q1": ("partition_order", "radix_order"),
    "q6": ("partition_order",),
    "q12": ("partition_order", "probe", "radix_order"),
    "q3": ("partition_order", "probe", "seg_sum"),
    "q4": ("partition_order", "probe", "radix_order"),
    "q13": ("partition_order", "probe", "radix_order"),
    "q15": ("partition_order", "probe", "radix_order", "seg_sum"),
    "q16": ("partition_order", "probe", "radix_order", "match_table"),
    "q18": ("partition_order", "probe", "seg_sum"),
    "q21": ("partition_order", "probe", "radix_order"),
    "q5": ("partition_order", "probe"),
    "q10": ("partition_order", "probe", "seg_sum"),
    "q19": ("partition_order", "probe", "match_table"),
    "q2": ("partition_order", "probe", "match_table", "seg_sum"),
    "q17": ("partition_order", "probe", "match_table", "seg_sum"),
    "q7": ("partition_order", "probe", "radix_order", "seg_sum"),
    "q8": ("partition_order", "probe", "radix_order", "seg_sum"),
    "q9": ("partition_order", "probe", "radix_order", "match_table",
           "seg_sum"),
    "q11": ("partition_order", "probe", "seg_sum"),
    "q20": ("partition_order", "probe", "radix_order", "match_table",
            "seg_sum"),
    **{f"bb_{q}": ("partition_order", "probe") for q in (
        "q5", "q9", "q14", "q17", "q22", "q23")},
    **{f"bb_{q}": ("partition_order", "probe", "seg_sum") for q in (
        "q6", "q11")},
    **{f"bb_{q}": ("partition_order", "probe", "radix_order") for q in (
        "q12", "q21", "q22_2002")},
    **{f"bb_{q}": ("partition_order", "probe", "radix_order", "seg_sum")
       for q in ("q15", "q16", "q20", "q23_2002")}}}
# the C7 queries (tests/test_torch_groupby.py's C6 paths)
C7_QUERIES = (
    "SELECT k, min(z) AS m FROM a GROUP BY k",
    "SELECT k, min(z) AS m FROM (SELECT k, z FROM a) x GROUP BY k",
    "SELECT k, min(z) AS m FROM a WHERE v > 0.0 GROUP BY k",
    "SELECT k, min(z) AS m FROM a WHERE s = 'x' GROUP BY k",
    "SELECT k, min(z) AS m FROM (SELECT k, z FROM a WHERE v > 0.0) x "
    "GROUP BY k",
    "SELECT k2, min(z) AS m FROM (SELECT k + 1 AS k2, z FROM a) x "
    "GROUP BY k2",
    "SELECT k2, min(z) AS m FROM (SELECT k * 1000 AS k2, z FROM a) x "
    "GROUP BY k2",
    "SELECT k2, min(z) AS m FROM (SELECT CAST(k AS int) AS k2, z FROM a) x "
    "GROUP BY k2",
    "SELECT y, min(z) AS m FROM (SELECT year(dt) AS y, z FROM a) x "
    "GROUP BY y",
    "SELECT k2, min(z) AS m FROM (SELECT k + 1 AS k2, substring(s, 1, 1) "
    "AS c, z FROM a) x GROUP BY k2",
    "SELECT a.k, min(b.w) AS m FROM a JOIN b ON a.k = b.k GROUP BY a.k",
    "SELECT wide, min(z) AS m FROM a GROUP BY wide",
    "SELECT k, dt, min(z) AS m FROM a GROUP BY k, dt",
    "SELECT p, min(z) AS m FROM (SELECT pmod(wide, 4) AS p, z FROM a) x "
    "GROUP BY p",
)
# the TPCx-BB queries that are empty at every scale as the reference
# writes them (their 2001 window holds one inventory snapshot)
TPCXBB_EMPTY = ("q22", "q23")
# q11's fraction as TPC-H scales it (0.0001 / sf): the reference's literal
# is the sf-1 value, which keeps no part at sf 10
Q11_FRACTION = 0.0001 / SF
KERNELS = ("partition_order", "radix_order", "probe", "match_table",
           "like_table", "substring", "seg_sum")
# the reference's window budget (native/kernels/strings.py _WINDOW_BUDGET)
WINDOW_BUDGET = 64 << 20


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip()


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call from CUDA events around ``iters`` warmed calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, kernel: str, iters: int = 20):
    """Mean device time per call of the kernels whose name holds
    ``kernel``, from ``torch.profiler`` (their durations alone, no host
    work or gaps); None where the profiler shows no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a window in which the profiler recorded no such kernel is redone
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = count = 0
        for e in prof.key_averages():
            if kernel in e.key:
                us += getattr(e, "device_time_total", None) or \
                    getattr(e, "cuda_time_total", 0)
                count += e.count
        if count:
            return us / 1e3 / count
    return None


def _max_abs_err(a, b) -> float:
    import torch

    if a.shape != b.shape:
        return float("inf")
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def phase_build(nk):
    t0 = time.perf_counter()
    nk.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{', '.join(s + '.cu' for s in nk.SOURCES)}")
    for stem in nk.SOURCES:
        for line in nk.PTXAS_REPORT.get(stem, "").splitlines():
            if "Compiling entry" in line or "Used" in line or \
                    "stack frame" in line:
                print(f"ptxas {stem}: {line.strip()}")


def _record(name, source, replaces, got, want, ms, plain_ms, lib_ms,
            nbytes, shape, ops=0, show=True):
    """One kernel-vs-plain case (a JSON line unless ``show`` is False);
    raises if they differ. The bound is the larger of the bytes over the
    memory rate and the operations over the integer rate."""
    import torch

    equal = all(torch.equal(g, w) for g, w in zip(got, want))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT8_OPS_PER_S * 1e3
    rec = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "shape": shape, "equal": equal,
           "max_abs_err": max(_max_abs_err(g, w)
                              for g, w in zip(got, want)),
           "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    if show:
        print(json.dumps(rec))
    if not equal:
        raise AssertionError(f"{name} ({shape}) differs from its "
                             f"plain version")
    return rec


def _hashes(col, dev):
    """The port's int64 join hashes of one int64 column."""
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.batch import batch_from_numpy
    from spark_rapids_tpu_torch.ops import hashing

    batch = batch_from_numpy([col], [dt.INT64], device=dev)
    return hashing.hash_columns(batch, [0], [dt.INT64])


def _probe_bytes(table, h_p):
    """Bytes a probe of ``h_p`` must move: the stream's hash in and
    (lo, cnt) out per row, the two offsets of every bucket it hits, and
    the build hashes its searches need: all of a bucket of at most 4
    entries, else two binary searches (2 x bit_length(occupancy)
    entries) per distinct hash in it, never more than the bucket."""
    import torch

    from spark_rapids_tpu_torch.kernels import join as kjoin

    n = h_p.numel()
    if n == 0:
        return 0
    uh = torch.unique(h_p)
    ub = kjoin._bucket(uh, table.table_bits)
    buckets, per = torch.unique(ub, return_counts=True)
    occ = (table.part[buckets + 1] - table.part[buckets]).to(torch.int64)
    steps = torch.floor(torch.log2(occ.clamp(min=1).to(
        torch.float64))).to(torch.int64) + 1
    need = torch.where(occ <= 4, occ, torch.minimum(occ, 2 * steps * per))
    return (16 * n + 8 * int(need.sum()) +
            4 * min(table.part.numel(), 2 * buckets.numel()))


def _case(rec):
    return {k: rec[k] for k in ("shape", "equal", "kernel_ms", "plain_ms",
                                "library_ms", "bound_ms", "bound_by",
                                "device_ms", "count_ms") if k in rec}


def _k1_case(mask, label, iters, lib_iters, show=True):
    """K1 against its plain version on ``mask``, its count against
    ``mask.sum()``; the wrapper's time without and with the count, and
    the kernel's device time alone."""
    import torch

    from spark_rapids_tpu_torch.kernels import sort as ksort

    n = mask.numel()
    got, n_true = ksort.partition_order_count(mask)
    want_n = int(mask.sum())
    if n_true != want_n:
        raise AssertionError(f"partition_order ({label}) counted {n_true} "
                             f"trues, mask.sum() {want_n}")
    rec = _record(
        "partition_order", "spark_rapids_tpu_torch/kernels/csrc/sort.cu",
        "spark_rapids_tpu/native/kernels/sort.py:41",
        [got, ksort.partition_order(mask)],
        [ksort.partition_order_plain(mask)] * 2,
        _time_ms(lambda: ksort.partition_order(mask), iters),
        _time_ms(lambda: ksort.partition_order_plain(mask), 5),
        _time_ms(lambda: torch.argsort(~mask, stable=True), lib_iters),
        n * 1 + n * 4, f"mask[{n}] {label}".strip(), show=False)
    rec.update(n_true=n_true,
               count_ms=_time_ms(lambda: ksort.partition_order_count(mask),
                                 iters),
               device_ms=_device_ms(lambda: ksort.partition_order(mask),
                                    "k1_"))
    if show:
        print(json.dumps(rec))
    return rec


def _k3_tpch_cases(k3_case, dev, tables):
    """K3 at the shapes of TPC-H q3's two joins and q12's join: each
    build whole, each stream one scan batch as its join sees it."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.benchmarks.datagen import days
    from spark_rapids_tpu_torch.kernels import join as kjoin

    def build(keys):
        h = torch.sort(_hashes(keys, dev)).values
        return kjoin.build_table(h), h

    def is_in(col, values):
        return np.isin(col.codes, np.flatnonzero(np.isin(col.dictionary,
                                                         values)))

    batch = 1 << 21  # plan/overrides.py BATCH_SIZE_ROWS
    li, orders, cust = (tables["lineitem"], tables["orders"],
                        tables["customer"])
    # q3's first join: the filtered orders (unique keys) build; the
    # stream is the lineitem scan batch with the most rows after q3's
    # filter (lineitem's ship dates rise along the table)
    ok = orders["o_orderdate"] < days(tpch.Q3_DATE)
    o_table, o_h = build(orders["o_orderkey"][ok])
    live = li["l_shipdate"] > days(tpch.Q3_DATE)
    per = np.add.reduceat(live, np.arange(0, len(live), batch),
                          dtype=np.int64)
    top = int(np.argmax(per))
    sl = slice(top * batch, (top + 1) * batch)
    lk = li["l_orderkey"][sl][live[sl]]
    k3_case("q3 orders build, one lineitem batch", o_table, o_h,
            _hashes(lk, dev), show=False)
    # q3's second join: the BUILDING customers build; the stream is the
    # o_custkey of that batch's matches (orders are sorted by key)
    okeys = orders["o_orderkey"]
    pos = np.searchsorted(okeys, lk).clip(max=len(okeys) - 1)
    hit = (okeys[pos] == lk) & ok[pos]
    c_table, c_h = build(cust["c_custkey"][is_in(cust["c_mktsegment"],
                                                  [tpch.Q3_SEGMENT])])
    k3_case("q3 customer build, that batch's matches", c_table, c_h,
            _hashes(orders["o_custkey"][pos[hit]], dev), show=False)
    del o_table, o_h, c_table, c_h
    # q12: the filtered lineitem (up to 7 lines an order) builds, one
    # orders scan batch streams
    ship, commit = li["l_shipdate"], li["l_commitdate"]
    receipt = li["l_receiptdate"]
    keep = (is_in(li["l_shipmode"], tpch.Q12_MODES) & (commit < receipt) &
            (ship < commit) & (receipt >= days(tpch.Q12_FROM)) &
            (receipt < days(tpch.Q12_TO)))
    l_table, l_h = build(li["l_orderkey"][keep])
    k3_case("q12 lineitem build, one orders batch", l_table, l_h,
            _hashes(orders["o_orderkey"][:batch], dev), show=False)


def phase_kernels(dev, ss, item, q26_cid, q91, tpch_tables):
    """Kernel vs plain at the path's shapes. Returns name -> record of
    the main path's case, with every case under ``cases``."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.kernels import join as kjoin
    from spark_rapids_tpu_torch.kernels import sort as ksort

    recs = {}

    # K1: which of the 28.8M sales are of a Books item
    books = np.zeros(int(item["i_item_sk"].max()) + 1, dtype=bool)
    bmask = item["i_category"].to_objects() == "Books"
    books[item["i_item_sk"][bmask]] = True
    mask = torch.from_numpy(books[ss["ss_item_sk"]]).to(dev)
    recs["partition_order"] = _k1_case(mask, "", 20, 5)
    # K1 at one scan batch (plan/overrides.py BATCH_SIZE_ROWS), the most
    # rows one launch sees on the query paths
    k1_batch = _k1_case(mask[: 1 << 21].clone(), "(one scan batch)", 50, 20)
    recs["partition_order"]["cases"] = [dict(recs["partition_order"]),
                                        k1_batch]

    # K3: the Books build's hashes, probed by every sale's item hash
    sb_h = torch.sort(_hashes(item["i_item_sk"][bmask], dev)).values
    h_p = _hashes(ss["ss_item_sk"], dev)
    table = kjoin.build_table(sb_h)
    k3 = []

    def k3_case(label, table, sb_h, h_p, iters=20, show=True):
        got = kjoin.probe(table, h_p)
        want = kjoin.probe_plain(table, h_p)
        rec = _record(
            "probe", "spark_rapids_tpu_torch/kernels/csrc/join.cu",
            "spark_rapids_tpu/native/kernels/join.py:114",
            list(got), list(want),
            _time_ms(lambda: kjoin.probe(table, h_p), iters),
            _time_ms(lambda: kjoin.probe_plain(table, h_p), 3),
            _time_ms(lambda: (torch.searchsorted(sb_h, h_p),
                              torch.searchsorted(sb_h, h_p, right=True)), 5),
            _probe_bytes(table, h_p), f"{label}: build[{sb_h.numel()}] x "
            f"stream[{h_p.numel()}]", show=show)
        rec["longest_run"] = int(got[1].max()) if h_p.numel() else 0
        if not show:
            print(json.dumps(rec))
        k3.append(rec)
        return rec

    k3_case("q26 Books", table, sb_h, h_p)
    k3_case("q26 Books, one scan batch", table, sb_h,
            h_p[: 1 << 21].clone(), iters=50, show=False)
    # the same stream against builds of the first 26,000 and 28,000 item
    # ids: either side of the ~27,000 rows the staged probe holds in
    # shared memory
    for rows in (26_000, 28_000):
        ids = np.arange(1, rows + 1, dtype=np.int64)
        side_h = torch.sort(_hashes(ids, dev)).values
        k3_case(f"{rows} item ids", kjoin.build_table(side_h), side_h, h_p,
                show=False)
    # q91's first join: catalog_returns (1.2M rows, 6 call centers) is
    # the build, the 6 call_center rows the stream; then a 2M-row stream
    # (one scan batch) drawn from the same 6 keys
    cr_h = torch.sort(_hashes(q91["catalog_returns"]["cr_call_center_sk"],
                              dev)).values
    cr_table = kjoin.build_table(cr_h)
    cc_h = _hashes(q91["call_center"]["cc_call_center_sk"], dev)
    k3_case("q91 first join", cr_table, cr_h, cc_h, iters=50, show=False)
    pick = torch.from_numpy(np.random.default_rng(91).integers(
        0, cc_h.numel(), 1 << 21)).to(dev)
    k3_case("q91 keys, one scan batch", cr_table, cr_h, cc_h[pick],
            show=False)
    _k3_tpch_cases(k3_case, dev, tpch_tables)
    recs["probe"] = dict(k3[0])
    recs["probe"]["cases"] = [_case(c) for c in k3]

    # K2: ORDER BY cid over the HAVING survivors (the lexsort keys: a
    # 1-bit liveness rank, then the int64 key), and over 28.8M int64 keys
    cid = torch.from_numpy(q26_cid).to(dev)
    rank = torch.zeros(cid.shape[0], dtype=torch.int32, device=dev)
    keys, widths = [rank, cid], [1, None]
    got = ksort.radix_order(keys, widths)
    want = ksort.radix_order_plain(keys, widths)
    recs["radix_order"] = _record(
        "radix_order", "spark_rapids_tpu_torch/kernels/csrc/sort.cu",
        "spark_rapids_tpu/native/kernels/sort.py:87",
        [got], [want],
        _time_ms(lambda: ksort.radix_order(keys, widths), 50),
        _time_ms(lambda: ksort.radix_order_plain(keys, widths), 3),
        _time_ms(lambda: torch.argsort(cid, stable=True), 50),
        cid.numel() * (4 + 8 + 4), f"survivors[{cid.numel()}]")
    big = torch.from_numpy(ss["ss_customer_sk"]).to(dev)
    rnd = torch.from_numpy(np.random.default_rng(5).integers(
        -2**63, 2**63 - 1, big.numel(), dtype=np.int64)).to(dev)
    k2 = [recs["radix_order"]]
    for label, k in (("ss_customer_sk", big), ("uniform int64", rnd)):
        got = ksort.radix_order([k])
        want = ksort.radix_order_plain([k])
        k2.append(_record(
            "radix_order", "spark_rapids_tpu_torch/kernels/csrc/sort.cu",
            "spark_rapids_tpu/native/kernels/sort.py:87",
            [got], [want],
            _time_ms(lambda: ksort.radix_order([k]), 5),
            _time_ms(lambda: ksort.radix_order_plain([k]), 1, warmup=1),
            _time_ms(lambda: torch.argsort(k, stable=True), 5),
            k.numel() * (8 + 4), f"{label} keys[{k.numel()}]"))
        del got, want
    recs["radix_order"]["cases"] = [_case(c) for c in k2]
    torch.cuda.synchronize()
    return recs


def _to_dev(a, dev):
    import torch

    return torch.from_numpy(a).to(dev)


def _string_table(dic, dev):
    """(chars, lens) of a dictionary's char table on ``dev``."""
    from spark_rapids_tpu_torch.kernels import strings as kstr

    chars, lens, _ = kstr.encode_dictionary(dic)
    return _to_dev(chars, dev), _to_dev(lens, dev)


def _substring_bytes(lens, L, pos, length):
    """Bytes substring must move: per entry the aligned chunks (16 bytes,
    or the row below L = 16) that cover the slice it outputs, the
    lengths read, and the whole output table and its lengths written."""
    import torch

    lv = lens.to(torch.int64)
    start = torch.full_like(lv, pos - 1) if pos > 0 else \
        lv + pos if pos < 0 else torch.zeros_like(lv)
    end = lv if length is None else start + length
    start_c = torch.minimum(start.clamp(min=0), lv)
    out_len = (torch.minimum(end, lv).clamp(min=0) - start_c).clamp(min=0)
    c = min(16, L)
    chunks = torch.where(out_len > 0, (start_c + out_len + c - 1) // c -
                         start_c // c, torch.zeros_like(lv))
    n = lv.numel()
    return int(chunks.sum()) * c + n * 4 + n * L + n * 4


def _like_bytes(lens, L):
    """Bytes LIKE must move: per entry its 16-byte chunks below its
    length (the row, below L = 16), the lengths read and one byte out."""
    import torch

    lv = lens.to(torch.int64)
    return int(torch.minimum((lv + 15) // 16 * 16,
                             torch.full_like(lv, L)).sum()) + lv.numel() * 5


def phase_string_kernels(dev, part, customer):
    """K4 and K6 against their plain versions at q14's and q22's shapes
    and past the reference's limits. Returns name -> record of the main
    path's case, with every case under ``cases``."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.kernels import strings as kstr

    src = "spark_rapids_tpu_torch/kernels/csrc/strings.cu"
    k4, k6 = [], []

    def k4_case(label, chars, lens, kind, needle):
        nb = needle.encode()
        n, L = chars.shape
        got = kstr.match_table(chars, lens, kind, nb)
        want = kstr.match_table_plain(chars, lens, kind, nb)
        m = len(nb)
        # byte comparisons of a scan without early exits, over this data
        win = (lens.to(torch.int64) - m + 1).clamp(min=0) if \
            kind == "contains" else (lens >= m).to(torch.int64)
        rec = _record(
            "match_table", src, "spark_rapids_tpu/native/kernels/"
            "strings.py:79", [got], [want],
            _time_ms(lambda: kstr.match_table(chars, lens, kind, nb), 50),
            _time_ms(lambda: kstr.match_table_plain(chars, lens, kind, nb),
                     3),
            None, n * L + n * 4 + m + n, f"{label} {kind} {needle!r} "
            f"[{n}, {L}]", ops=int(win.sum()) * m, show=False)
        rec["device_ms"] = _device_ms(
            lambda: kstr.match_table(chars, lens, kind, nb), "k4_")
        rec["matches"] = int(got.sum())
        print(json.dumps(rec))
        k4.append(rec)

    def k6_case(label, chars, lens, pos, length, iters=50, show=True,
                dev_iters=20):
        n, L = chars.shape
        got = kstr.substring_table(chars, lens, pos, length)
        want = kstr.substring_table_plain(chars, lens, pos, length)
        rec = _record(
            "substring", src, "spark_rapids_tpu/native/kernels/"
            "strings.py:285", list(got), list(want),
            _time_ms(lambda: kstr.substring_table(chars, lens, pos, length),
                     iters),
            _time_ms(lambda: kstr.substring_table_plain(chars, lens, pos,
                                                        length), 3),
            None, _substring_bytes(lens, L, pos, length),
            f"{label} substring({pos}, "
            f"{length}) [{n}, {L}]", show=False)
        rec["device_ms"] = _device_ms(
            lambda: kstr.substring_table(chars, lens, pos, length), "k6_",
            dev_iters)
        if show:
            print(json.dumps(rec))
        k6.append(rec)

    # q14: StartsWith(p_type, 'PROMO') over part's dictionary
    p_type = _string_table(part["p_type"].dictionary, dev)
    k4_case("p_type", *p_type, "starts", "PROMO")
    # q22: the sf-10 c_phone dictionary
    phone = _string_table(customer["c_phone"].dictionary, dev)
    for kind, needle in (("starts", "13-"), ("ends", "-1000"),
                         ("contains", "99-1")):
        k4_case("c_phone", *phone, kind, needle)
    # contains past the reference's window budget: 1M entries, L = 64
    r = np.random.default_rng(2)
    n, L = 1 << 20, 64
    lens = r.integers(0, L + 1, n).astype(np.int32)
    chars = np.frombuffer(b"abcd-", np.uint8)[r.integers(0, 5, (n, L))]
    chars[np.arange(L)[None, :] >= lens[:, None]] = 0
    needle = "dc-ba"
    if n * (L - len(needle) + 1) * len(needle) <= 64 << 20:
        raise AssertionError("the seeded table must exceed the budget")
    seeded = (_to_dev(chars, dev), _to_dev(lens, dev))
    k4_case("seeded", *seeded, "contains", needle)
    # the widest rows the encoder gives (L = 512, a group of 32 lanes a
    # row), with a 70-byte needle planted in every ninth entry: past the
    # 64 bytes of the shift-and path
    n5, L5 = 1 << 16, 512
    lens5 = r.integers(0, L5 + 1, n5).astype(np.int32)
    chars5 = np.frombuffer(b"abcd-", np.uint8)[r.integers(0, 5, (n5, L5))]
    long_needle = "abcd-" * 14
    for i in range(0, n5, 9):
        if lens5[i] >= len(long_needle):
            at = int(r.integers(0, lens5[i] - len(long_needle) + 1))
            chars5[i, at:at + len(long_needle)] = np.frombuffer(
                long_needle.encode(), np.uint8)
    chars5[np.arange(L5)[None, :] >= lens5[:, None]] = 0
    wide = (_to_dev(chars5, dev), _to_dev(lens5, dev))
    for kind, nd in (("contains", long_needle), ("contains", "dc-ba"),
                     ("starts", "abc"), ("ends", "-d")):
        k4_case("wide", *wide, kind, nd)
    del wide
    # q22: substring(c_phone, 1, 2), then the pos / length edges at
    # 100,000 x 32 and at L = 8, 16, 64 and 512 (a thread a row below 16
    # bytes, a thread a 16-byte chunk from 16)
    k6_case("c_phone", *phone, 1, 2)
    summaries = []
    widths = [("edges", chars[:100_000, :32], 32)]
    for L6 in (8, 16, 64, 512):
        widths.append((f"edges L={L6}", np.frombuffer(b"abcd-", np.uint8)[
            r.integers(0, 5, (50_000, L6))], L6))
    for label, base, L6 in widths:
        lens6 = np.minimum(lens[:base.shape[0]], L6) if L6 == 32 else \
            r.integers(0, L6 + 1, base.shape[0]).astype(np.int32)
        base = base.copy()
        base[np.arange(L6)[None, :] >= lens6[:, None]] = 0
        edge = (_to_dev(base, dev), _to_dev(lens6, dev))
        first = len(k6)
        for pos in (-20, -3, 0, 1, 5, 40):
            for length in (None, 0, -1, 2, 100):
                k6_case(label, *edge, pos, length, iters=5, show=False,
                        dev_iters=5)
        edges = k6[first:]
        # the wrapper's slowest case, and the case of the most device
        # time with its own bound
        slowest = max(edges, key=lambda c: c["kernel_ms"])
        busiest = max(edges, key=lambda c: c["device_ms"] or 0.0)
        summary = {k: busiest[k] for k in ("name", "bound_ms", "bound_by",
                                           "device_ms")}
        summary.update(
            shape=f"{label} [{edge[0].shape[0]}, {edge[0].shape[1]}] x "
            f"{len(edges)} (pos, length) cases", equal=True,
            kernel_ms=slowest["kernel_ms"],
            plain_ms=max(c["plain_ms"] for c in edges), library_ms=None,
            slowest=slowest["shape"], busiest=busiest["shape"])
        print(json.dumps(summary))
        summaries.append(summary)
    torch.cuda.synchronize()
    recs = {"match_table": dict(k4[0]), "substring": dict(k6[0])}
    recs["match_table"]["cases"] = k4
    recs["substring"]["cases"] = [k6[0]] + summaries
    return recs, phone, seeded


def _like_ops(lens, pattern, escape):
    """Byte comparisons of LIKE over this data without early exits: m per
    entry long enough for an anchored segment, m per window of a
    searched one."""
    import torch

    from spark_rapids_tpu_torch.kernels import strings as kstr

    lv = lens.to(torch.int64)
    ops = 0
    for mode, seg in kstr.like_segments(kstr.parse_like(pattern, escape)):
        m = len(seg)
        if mode == kstr.LIKE_SEARCH:
            ops += int((lv - m + 1).clamp(min=0).sum()) * m
        else:
            ops += int((lv >= m).sum()) * m
    return ops


def _body_bytes(pattern, escape):
    """The bytes of a LIKE pattern's segments, '_' included."""
    from spark_rapids_tpu_torch.kernels import strings as kstr

    return sum(len(seg) for _, seg in
               kstr.like_segments(kstr.parse_like(pattern, escape)))


def phase_like_kernel(dev, hd, phone, seeded):
    """K5 against its plain version: q91's hd_buy_potential table, the
    sf-10 c_phone dictionary with the reference's test patterns and a
    phone pattern, and the 1M x 64 table with multi-segment patterns at
    and past the reference's window budget. Returns the q91 case's
    record, with every case under ``cases``."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.kernels import strings as kstr

    cases = []

    def case(label, chars, lens, pattern, escape="\\", iters=50):
        n, L = chars.shape
        shown = pattern if len(pattern) <= 24 else \
            f"{pattern[:20]}... ({len(pattern)} chars)"
        ascii_only = bool((chars < 0x80).all())
        got = kstr.like_table(chars, lens, pattern, escape, ascii_only)
        want = kstr.like_table_plain(chars, lens, pattern, escape)
        segs = kstr.like_segments(kstr.parse_like(pattern, escape))
        budget = max((n * (L - len(sg) + 1) * max(len(sg), 1)
                      for _, sg in segs), default=0)
        rec = _record(
            "like_table", "spark_rapids_tpu_torch/kernels/csrc/strings.cu",
            "spark_rapids_tpu/native/kernels/strings.py:149", [got], [want],
            _time_ms(lambda: kstr.like_table(chars, lens, pattern, escape,
                                             ascii_only), iters),
            _time_ms(lambda: kstr.like_table_plain(chars, lens, pattern,
                                                   escape), 3),
            None, _like_bytes(lens, L), f"{label} like {shown!r} [{n}, {L}]",
            ops=_like_ops(lens, pattern, escape), show=False)
        rec["device_ms"] = _device_ms(
            lambda: kstr.like_table(chars, lens, pattern, escape,
                                    ascii_only), "k5_", min(iters, 20))
        rec["matches"] = int(got.sum())
        rec["body_bytes"] = _body_bytes(pattern, escape)
        rec["past_window_budget"] = budget > WINDOW_BUDGET
        print(json.dumps(rec))
        cases.append(rec)
        return rec

    hd_dic = hd["hd_buy_potential"].dictionary
    main = case("hd_buy_potential", *_string_table(hd_dic, dev), "unknown%")
    if main["matches"] != 1:
        raise AssertionError("'unknown%' must match one buy potential")
    for pattern in ("%apple%", "a%b\\_c", "100\\%", "_pple", "%quick%fox",
                    "2_-%-%"):
        case("c_phone", *phone, pattern)
    for pattern in ("%a%b%c%", "%ab%cd%-%"):
        case("seeded", *seeded, pattern, iters=20)
    if not cases[-1]["past_window_budget"]:
        raise AssertionError("the last pattern must pass the budget")
    # every path of the kernel at every width the encoder gives: a body
    # past the 64 bytes of the shift-and path, each anchoring, '_' at the
    # edges of segments, an escaped '%' and '_', over rows of a-d, '-',
    # '%' and '_' with every ninth one planted with a match of the
    # pattern's literal form
    r = np.random.default_rng(5)
    alphabet = np.frombuffer(b"abcd-%_", np.uint8)
    first_width, summaries = len(cases), []
    for L in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512):
        n = 20_000
        lens = r.integers(0, L + 1, n).astype(np.int32)
        chars = alphabet[r.integers(0, len(alphabet), (n, L))]
        patterns = ["a%", "%a", "_%", "%_", "a_%_b", "%_a%b_%", "ab%cd",
                    "%a%b%a%", "%d\\%%", "%\\_a%", "_a%\\%_",
                    "%" + "ab" * 16 + "%", "%" + "a_c-" * 12,
                    "ab%" + "cd-" * 23 + "%", "%" + "abcd_" * 20 + "%",
                    "a" * L, "_" * L]
        for i in range(0, n, 9):
            pat = patterns[(i // 9) % len(patterns)]
            lit = pat.replace("\\", "").replace("%", "").replace("_", "a")
            if 0 < len(lit) <= lens[i]:
                chars[i, :len(lit)] = np.frombuffer(lit.encode(), np.uint8)
        chars[np.arange(L)[None, :] >= lens[:, None]] = 0
        table = (_to_dev(chars, dev), _to_dev(lens, dev))
        first = len(cases)
        for pattern in patterns:
            if _body_bytes(pattern, "\\") <= L:
                case(f"widths L={L}", *table, pattern, iters=5)
        width = cases[first:]
        slowest = max(width, key=lambda c: c["kernel_ms"])
        busiest = max(width, key=lambda c: c["device_ms"] or 0.0)
        summary = {k: busiest[k] for k in ("name", "bound_ms", "bound_by",
                                           "device_ms")}
        summary.update(
            shape=f"widths [{n}, {L}] x {len(width)} patterns", equal=True,
            kernel_ms=slowest["kernel_ms"],
            plain_ms=max(c["plain_ms"] for c in width), library_ms=None,
            slowest=slowest["shape"], busiest=busiest["shape"],
            longest_body=max(c["body_bytes"] for c in width))
        print(json.dumps(summary))
        summaries.append(summary)
    if not any(c["longest_body"] > 64 for c in summaries):
        raise AssertionError("a body past 64 bytes must run")
    torch.cuda.synchronize()
    rec = dict(main)
    rec["cases"] = cases[:first_width] + summaries
    return rec


def phase_fma(dev):
    """C3 on the card: float products that feed an add, through the SQL
    front end (which folds each into one ``MultiplyAdd``), against a * b
    + c rounded once, computed exactly on the host with fractions."""
    from fractions import Fraction

    import numpy as np

    from spark_rapids_tpu_torch.api import Session
    from spark_rapids_tpu_torch.plan.nodes import InMemorySource

    r = np.random.default_rng(3)
    n = 4097
    a, b, c = (r.standard_normal(n) * 10.0 ** r.integers(-3, 3, n)
               for _ in range(3))
    s = Session(device=dev)
    s.create_temp_view("t", InMemorySource({"a": a, "b": b, "c": c}))
    got = s.sql("SELECT a * b + c AS x, a * 0.3 - c AS y, 0.1 - a * b AS z "
                "FROM t").collect()
    fa, fb, fc = ([Fraction(float(v)) for v in x] for x in (a, b, c))
    want = {"x": [p * q + o for p, q, o in zip(fa, fb, fc)],
            "y": [p * Fraction(0.3) - o for p, o in zip(fa, fc)],
            "z": [Fraction(0.1) - p * q for p, q in zip(fa, fb)]}
    twice = {"x": a * b + c, "y": a * 0.3 - c, "z": 0.1 - a * b}
    rec = {"phase": "fma", "rows": n, "exact": True, "twice_rounded_rows": {}}
    for col, exact in want.items():
        w = np.array([float(v) for v in exact])
        g = np.asarray(got[col], np.float64)
        if not np.array_equal(g.view(np.int64), w.view(np.int64)):
            raise AssertionError(f"fma: {col} is not a * b + c rounded once "
                                 f"({int((g != w).sum())} rows)")
        rec["twice_rounded_rows"][col] = int((twice[col] != w).sum())
    print(json.dumps(rec))
    return rec


def phase_q5lite(dev):
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.benchmarks import q5lite

    keys, valid, vals = q5lite.gen_data(q5lite.N_ROWS, SEED_Q5)
    want = q5lite.step_numpy(keys, valid, vals)
    dk, dv, dx = (torch.from_numpy(a).to(dev) for a in (keys, valid, vals))
    for _ in range(2):
        out = q5lite.step(dk, dv, dx)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = q5lite.step(dk, dv, dx)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    k, s, c, cs, ng = out
    if ng != len(want[0]):
        raise AssertionError(f"q5lite: {ng} groups, oracle {len(want[0])}")
    np.testing.assert_array_equal(k.cpu().numpy(), want[0])
    np.testing.assert_allclose(s.cpu().numpy(), want[1], rtol=1e-9, atol=0)
    np.testing.assert_array_equal(c.cpu().numpy(), want[2])
    np.testing.assert_array_equal(cs.cpu().numpy(), want[3])
    rec = {"phase": "q5lite", "rows": q5lite.N_ROWS, "keys": q5lite.N_KEYS,
           "groups": ng, "step_ms_median": sorted(times)[2] * 1e3,
           "step_ms_all": [t * 1e3 for t in times], "matches_oracle": True}
    print(json.dumps(rec))
    return rec


def _plan_runner(dev, plan_fn, conf=None):
    """A query run: the plan through apply_overrides -> collect; returns
    (its rows, the exec tree that ran)."""
    from spark_rapids_tpu_torch.execs.base import collect
    from spark_rapids_tpu_torch.plan.overrides import apply_overrides

    def run():
        tree = apply_overrides(plan_fn(), conf, device=dev)
        return collect(tree), tree
    return run


def _tree_conf(conf, tree):
    """``conf`` for the default (fused) or the unfused exec tree."""
    return {**(conf or {}), FUSION: tree == "fused"}


def _fused_reach(tree):
    """The kernels a fused tree that ran must have launched: K1 where a
    standalone chain (one that does not end in a sort) ran, K3 where a
    chain join probed in hash mode; a fused exec that fell back to its
    unfused subtree counts as that subtree. -> (kernels, summary)."""
    from spark_rapids_tpu_torch.execs.fused import (FusedChainExec,
                                                    SortStep, fused_nodes,
                                                    fusion_summary)

    need = set()
    for n in fused_nodes(tree):
        if n.fell_back:
            continue
        if isinstance(n, FusedChainExec) and \
                not any(isinstance(s, SortStep) for s in n.chain.steps):
            need.add("partition_order")
        if "hash" in n.join_modes:
            need.add("probe")
    summary = fusion_summary(tree)
    summary["join_modes"] = [m for n in fused_nodes(tree)
                             for m in n.join_modes]
    return need, summary


def _run_query(name, run, nk, tree_kind="fused", reach=True):
    """One warm run, then a timed run with the launch counts set to 0
    just before it and read just after; it fails unless every kernel of
    the path launched (``PATH_KERNELS`` of its tree, and for the fused
    tree what its chains reach, unless ``reach`` is false: a query empty
    by construction, whose chains compact no row). Returns (result,
    record)."""
    import torch

    run()  # warm: caching allocator, library handles, built kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # what earlier phases left alive
    nk.reset_launches()
    nk.record_sizes(True)
    t0 = time.perf_counter()
    got, tree = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sizes = nk.record_sizes(False)
    launches = dict(nk.LAUNCHES)
    need = set(PATH_KERNELS[tree_kind][name])
    rec = {"phase": name, "tree": tree_kind, "sf": SF, "warm_wall_s": wall,
           "held_bytes": held,
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches,
           "k1_sizes": sizes.get("partition_order", [])}
    if tree_kind == "fused":
        reached, rec["fusion"] = _fused_reach(tree)
        if reach:
            need |= reached
    missing = sorted(k for k in need if launches[k] <= 0)
    if missing:
        print(json.dumps(rec))
        raise AssertionError(f"{name} ({tree_kind}) never launched "
                             f"{missing}")
    return got, rec


def _run_trees(name, make_run, nk, check, runs, reach=True):
    """The query on the default (fused) tree, then the unfused one, each
    checked by ``check(rows)`` (its oracle) and printed; ``runs`` gets
    both records (the fused one under ``name``). -> the fused rows."""
    out = None
    for tree_kind in TREES:
        got, rec = _run_query(name, make_run(tree_kind), nk, tree_kind,
                              reach)
        rec.update(check(got) or {})
        print(json.dumps(rec))
        runs[name if tree_kind == "fused" else f"{name} unfused"] = rec
        if out is None:
            out = got
    return out


def _check_columns(name, got, want):
    import numpy as np

    if list(got) != list(want):
        raise AssertionError(f"{name} columns {list(got)} != {list(want)}")
    for col, w in want.items():
        if w.dtype.kind == "f":
            np.testing.assert_allclose(np.asarray(got[col], np.float64), w,
                                       rtol=1e-9, atol=0, err_msg=col)
        elif not np.array_equal(np.asarray(got[col]), w):
            raise AssertionError(f"{name}: column {col} differs")


def phase_q26(dev, ss, item, want, nk, runs):
    from spark_rapids_tpu_torch.benchmarks import tpcxbb

    def check(got):
        _check_columns("q26", got, want)
        return dict(store_sales_rows=len(ss["ss_item_sk"]),
                    item_rows=len(item["i_item_sk"]),
                    result_rows=len(want["cid"]), matches_oracle=True)

    _run_trees("q26", lambda t: _plan_runner(
        dev, lambda: tpcxbb.q26(ss, item), _tree_conf(None, t)), nk, check,
        runs)


def phase_q14(dev, lineitem, part, nk, runs):
    from spark_rapids_tpu_torch.benchmarks import tpch

    want = tpch.q14_numpy(lineitem, part)

    def check(got):
        _check_columns("q14", got, want)
        return dict(lineitem_rows=len(lineitem["l_partkey"]),
                    part_rows=len(part["p_partkey"]),
                    promo_revenue=float(got["promo_revenue"][0]),
                    oracle=float(want["promo_revenue"][0]),
                    matches_oracle=True)

    _run_trees("q14", lambda t: _plan_runner(
        dev, lambda: tpch.q14(lineitem, part), _tree_conf(None, t)), nk,
        check, runs)


def phase_tpch(dev, name, tables, nk, runs):
    """A TPC-H query of ``tpch.INPUTS`` at sf 10 against its numpy
    oracle, on both trees."""
    import numpy as np

    from spark_rapids_tpu_torch.benchmarks import datagen, tpch

    args = [tables[t] for t in tpch.INPUTS[name]]
    if name == "q11":
        args.append(Q11_FRACTION)
    t0 = time.perf_counter()
    want = getattr(tpch, f"{name}_numpy")(*args)
    oracle_s = time.perf_counter() - t0
    conf = tpch.QUERY_CONF.get(name)

    def check(got):
        _check_columns(name, got, want)
        rows = len(next(iter(want.values())))
        if not rows or any(c[0] is None for c in want.values()):
            raise AssertionError(f"{name} at sf {SF} must return rows")
        rec = {f"{t}_rows": len(next(iter(tables[t].values())))
               for t in tpch.INPUTS[name]}
        if name == "q11":
            rec.update(fraction=Q11_FRACTION)
        rec.update(result_rows=rows, oracle_s=oracle_s,
                   matches_oracle=True, conf=conf)
        if name == "q3":
            # the reordered chain: filtered lineitem streams, filtered
            # orders build the first join, filtered customer the second
            orders, customer = tables["orders"], tables["customer"]
            rec.update(orders_build_rows=int(
                (orders["o_orderdate"] < datagen.days(tpch.Q3_DATE)).sum()),
                customer_build_rows=int(np.isin(
                    customer["c_mktsegment"].codes,
                    np.flatnonzero(customer["c_mktsegment"].dictionary ==
                                   tpch.Q3_SEGMENT)).sum()))
        return rec

    _run_trees(name, lambda t: _plan_runner(
        dev, lambda: getattr(tpch, name)(*args), _tree_conf(conf, t)), nk,
        check, runs)
    if name in ("q1", "q21"):  # the default tree, profiled
        run = _plan_runner(dev, lambda: getattr(tpch, name)(*args), conf)
        rec = {"phase": name, "tree": "fused"}
        rec.update(_groupby_profile(run) if name == "q1" else
                   _aggregate_steps(run))
        print(json.dumps(rec))
        if rec.get("index_add_ran"):
            raise AssertionError(f"{name} ran index_add_: its float sums "
                                 "must take the dense path")


def _groupby_profile(run):
    """One profiled run: the device time of the kernels the aggregate
    exec's group-by calls launch (a ``record_function`` around each
    call), the run's busy device time, and whether ``index_add_`` ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from spark_rapids_tpu_torch.execs import aggregate as agg_exec

    orig = agg_exec.groupby_aggregate

    def marked(*a, **k):
        with record_function("port_groupby"):
            return orig(*a, **k)

    agg_exec.groupby_aggregate = marked
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    finally:
        agg_exec.groupby_aggregate = orig
    # the CPU side of each marked call: the device time of the kernels
    # launched inside it (the profiler's device-side range of the mark
    # spans idle gaps too, so it is left out)
    marks = [e for e in prof.events() if e.name == "port_groupby" and
             e.device_type == DeviceType.CPU]
    gb_us = sum(e.device_time_total for e in marks)
    calls = len(marks)
    busy_us = 0.0
    index_add = False
    top = []
    for e in prof.key_averages():
        if "index_add" in e.key or "indexFuncLargeIndex" in e.key:
            index_add = True
        if e.device_type == DeviceType.CUDA and e.key != "port_groupby":
            busy_us += e.self_device_time_total
            top.append((e.self_device_time_total, e.key[:60], e.count))
    top.sort(reverse=True)
    return {"groupby_device_ms": gb_us / 1e3,
            "groupby_calls": calls,
            "profiled_busy_ms": busy_us / 1e3, "index_add_ran": index_add,
            "top_device_ms": [{"name": k, "calls": c, "ms": us / 1e3}
                              for us, k, c in top[:6]]}


def _aggregate_steps(run):
    """One run with every aggregate step of the aggregate exec timed
    apart (a synchronize on each side): the update of each batch, and
    the merge loop, the concatenation with the running partials and
    their re-aggregation."""
    import torch

    from spark_rapids_tpu_torch.execs import aggregate as agg_exec

    spent = {"update_s": 0.0, "merge_s": 0.0, "concat_s": 0.0,
             "merges": 0, "largest_merge_rows": 0}
    orig_agg = agg_exec.HashAggregateExec._aggregate
    orig_cat = agg_exec.concat_batches

    def timed(key, fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        spent[key] += time.perf_counter() - t0
        return out

    def aggregate(self, batch, specs, types, live_mask=None):
        if specs is self.merge_specs:
            spent["merges"] += 1
            spent["largest_merge_rows"] = max(spent["largest_merge_rows"],
                                              batch.num_rows)
            return timed("merge_s", orig_agg, self, batch, specs, types,
                         live_mask)
        return timed("update_s", orig_agg, self, batch, specs, types,
                     live_mask)

    agg_exec.HashAggregateExec._aggregate = aggregate
    agg_exec.concat_batches = lambda parts: timed("concat_s", orig_cat,
                                                  parts)
    try:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        spent["steps_wall_s"] = time.perf_counter() - t0
    finally:
        agg_exec.HashAggregateExec._aggregate = orig_agg
        agg_exec.concat_batches = orig_cat
    spent["merge_loop_s"] = spent["merge_s"] + spent["concat_s"]
    return {"aggregate_steps": spent}


def _sums_record(case, got, want, ms, lib_ms, nbytes, rows, groups,
                 plain_ms=None):
    """One group-by case: float sums against the host's, relative."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                       1e-300))) \
        if got.size else 0.0
    rec = {"phase": "groupby", "case": case, "rows": rows,
           "groups": groups, "max_rel_err": err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms,
           "library": "index_add_",
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    print(json.dumps(rec))
    if got.shape != want.shape or not err <= 1e-9:
        raise AssertionError(f"group-by {case}: sums differ from the "
                             f"host's (relative {err})")
    return rec


def _fold_case(dev, case, keys, x, iters, op="sum"):
    """The sort path's fold over rows sorted by key: the S1 kernel
    (``seg_reduce``, one launch) against its plain version (``seg_fold``
    on the card, bit for bit) and the host's per-group values (sums 1e-9
    relative, min and max exact), beside the one PyTorch call that does
    the same per group (``index_add_``; ``scatter_reduce_`` with amin or
    amax). Returns the kernel's record."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.kernels import groupby as kgb

    order = np.argsort(keys, kind="stable")
    ks, xs = keys[order], x[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    sizes = np.diff(np.r_[starts, len(ks)])
    host = {"sum": np.add, "min": np.minimum, "max": np.maximum}[op]
    want = host.reduceat(xs, starts) if len(xs) else xs
    d_x = torch.from_numpy(xs).to(dev)
    d_st = torch.from_numpy(starts).to(dev)
    d_sz = torch.from_numpy(sizes).to(dev)
    longest = int(sizes.max())
    seg = torch.from_numpy(np.repeat(np.arange(len(starts)), sizes)).to(dev)
    groups = len(starts)

    def kernel():
        return kgb.seg_reduce(d_x, d_st, d_sz, op)

    def plain():
        return kgb.seg_fold(d_x, d_st, d_sz, longest, kgb.OPS[op])

    if op == "sum":
        def library():
            return torch.zeros(groups, dtype=d_x.dtype,
                               device=dev).index_add_(0, seg, d_x)
    else:
        fill = float("inf") if op == "min" else float("-inf")

        def library():
            return torch.full((groups,), fill, dtype=d_x.dtype,
                              device=dev).scatter_reduce_(
                                  0, seg, d_x, "amin" if op == "min"
                                  else "amax")
    nbytes = len(xs) * d_x.element_size() + groups * (16 +
                                                       d_x.element_size())
    got = kernel()
    rec = _record(
        "seg_sum", "spark_rapids_tpu_torch/kernels/csrc/groupby.cu",
        "spark_rapids_tpu/ops/groupby.py:903 (_seg_scan, a jnp scan; no "
        "pallas_call)", [got], [plain()], _time_ms(kernel, iters),
        _time_ms(plain, iters), _time_ms(library, iters), nbytes,
        f"{case}, {op}: {len(xs)} rows, {groups} groups, longest "
        f"{longest}", show=False)
    rec["op"] = op
    rec["library"] = "index_add_" if op == "sum" else \
        f"scatter_reduce_ a{op}"
    rec["device_ms"] = _device_ms(kernel, "seg_fold_kernel")
    print(json.dumps(rec))
    if op == "sum":
        _sums_record(case, got.cpu().numpy(), want, rec["kernel_ms"],
                     rec["library_ms"], nbytes, len(xs), groups,
                     plain_ms=rec["plain_ms"])
    elif not np.array_equal(got.cpu().numpy(), want):
        raise AssertionError(f"group-by {case}: {op} differs from the "
                             f"host's")
    return rec


# the groups of C5 (tests/test_torch_groupby.py holds them against the
# reference engine on the CPU)
C5_GROUPS = ([-0.0], [-0.0, -0.0], [-0.0, -1e-310], [0.0, -0.0],
             [-0.0, 0.0], [0.0, -0.0, 5.0], [-0.0, -0.0, 1.0],
             [1e-310, -0.0])


def _c5_case(dev):
    """sum, min, max and any_valid of the C5 groups, float64 and
    float32, on the dense path (a string key), the sort path (an integer
    key: the S1 kernel) and alone with no key, on the card and on the
    CPU: equal bit for bit."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.batch import batch_from_numpy
    from spark_rapids_tpu_torch.ops import groupby as gb

    d = np.concatenate(C5_GROUPS)
    which = np.concatenate([[i] * len(g) for i, g in enumerate(C5_GROUPS)])
    f = d.astype(np.float32)
    specs = [gb.AggSpec(op, o) for o in (1, 2)
             for op in ("sum", "min", "max", "any_valid")]
    dic = np.array([f"g{i}" for i in range(len(C5_GROUPS))], dtype=object)
    runs = {"dense": [([which.astype(np.int32), d, f], dt.STRING, dic)],
            "sort": [([which.astype(np.int64), d, f], dt.INT64, None)],
            "grand": [([which[which == i], d[which == i], f[which == i]],
                       dt.INT64, None) for i in range(len(C5_GROUPS))]}
    for path, inputs in runs.items():
        for datas, ktype, kdic in inputs:
            types = [ktype, dt.FLOAT64, dt.FLOAT32]
            out = []
            for on in (dev, "cpu"):
                b = batch_from_numpy(datas, types,
                                     dictionaries=[kdic, None, None],
                                     device=on)
                got = gb.reduce_aggregate(b, specs, types, on)[0] \
                    if path == "grand" else \
                    gb.groupby_aggregate(b, [0], specs, types)[0]
                out.append([c.data.cpu() for c in got.columns])
            for g, w in zip(*out):
                same = g.dtype == w.dtype and (
                    torch.equal(g.view(torch.int64 if g.element_size() == 8
                                       else torch.int32),
                                w.view(torch.int64 if w.element_size() == 8
                                       else torch.int32))
                    if g.is_floating_point() else torch.equal(g, w))
                if not same:
                    raise AssertionError(f"C5 groups, {path} path: the "
                                         f"card differs from the CPU")
    print(json.dumps({"phase": "groupby", "case": "C5 zero signs (dense, "
                      "sort and grand; card against CPU)", "equal": True}))


def phase_groupby(dev, lineitem, orders, customer):
    """Float sums on the two group-by paths at the queries' shapes: the
    dense path at q1's, the sort path's S1 kernel at q13's, q5lite's and
    q18's, with its min and max at the last two; then the C5 groups, card
    against CPU. Returns the kernel's record (q18's sums, every case
    under ``cases``)."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.benchmarks import q5lite, tpch
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.batch import batch_from_numpy
    from spark_rapids_tpu_torch.ops import groupby as gb

    # q1: one scan batch, the columns its eight aggregates read
    n = 1 << 21
    rf, ls = lineitem["l_returnflag"], lineitem["l_linestatus"]
    qty = lineitem["l_quantity"][:n]
    price = lineitem["l_extendedprice"][:n]
    disc = lineitem["l_discount"][:n]
    disc_price = price * (1.0 - disc)
    charge = disc_price * (1.0 + lineitem["l_tax"][:n])
    floats = [qty, price, disc_price, charge, disc]
    types = [dt.STRING, dt.STRING] + [dt.FLOAT64] * 5
    specs = [gb.AggSpec("sum", o) for o in (2, 3, 4, 5)] + \
        [gb.AggSpec(op, o) for o in (2, 3, 6) for op in ("sum", "count")] + \
        [gb.AggSpec("count_star")]
    batch = batch_from_numpy([rf.codes[:n], ls.codes[:n]] + floats, types,
                             dictionaries=[rf.dictionary, ls.dictionary] +
                             [None] * 5, device=dev)
    got, _ = gb.groupby_aggregate(batch, [0, 1], specs, types)
    codes = rf.codes[:n].astype(np.int64) * len(ls.dictionary) + \
        ls.codes[:n]
    slots = np.unique(codes)
    inv = np.searchsorted(slots, codes)
    cols = [2, 3, 4, 5, 2, 3, 6]
    want = np.stack([np.bincount(inv, weights=floats[o - 2],
                                 minlength=len(slots)) for o in cols], 1)
    sums = torch.stack([got.columns[2 + i].data for i, s in
                        enumerate(specs) if s.op == "sum"], 1)
    counts = got.columns[-1].data.cpu().numpy()
    if not np.array_equal(counts, np.bincount(inv)):
        raise AssertionError("q1 group-by counts differ")
    d_codes = torch.from_numpy(inv).to(dev)
    x = torch.from_numpy(np.stack([floats[o - 2] for o in cols], 1)).to(dev)
    _sums_record(
        "dense float sums, q1 shape (6 groups, 2,097,152 rows, q1's "
        "eight aggregates)", sums.cpu().numpy(), want,
        _time_ms(lambda: gb.groupby_aggregate(batch, [0, 1], specs, types),
                 20),
        _time_ms(lambda: torch.zeros(len(slots), len(cols),
                                     dtype=torch.float64, device=dev
                                     ).index_add_(0, d_codes, x), 20),
        n * (2 * 4 + 5 * 8), n, len(slots),
        plain_ms=_time_ms(lambda: [gb._sweep(d_codes, x[:, j], len(slots),
                                             "sum", 0.0)
                                   for j in range(len(cols))], 5))
    del batch, x
    # q13's second aggregate: orders per customer, then customers per
    # order count (a few dozen keys; a float column to sum)
    keep = ~np.isin(orders["o_orderpriority"].codes, np.flatnonzero(
        orders["o_orderpriority"].dictionary == tpch.Q13_EXCLUDED))
    cust = customer["c_custkey"]
    per = np.bincount(orders["o_custkey"][keep],
                      minlength=int(cust.max()) + 1)[cust]
    cases = [_fold_case(dev, "q13 second aggregate (order counts over "
                        "1.5M customers)", per.astype(np.int64),
                        customer["c_acctbal"], 100)]
    # the q5lite step's live rows
    keys, valid, vals = q5lite.gen_data(q5lite.N_ROWS, SEED_Q5)
    live = (vals > 0.5) & valid
    for op in ("sum", "min", "max"):
        cases.append(_fold_case(dev, "q5lite step (65,536 keys)",
                                keys[live], vals[live], 100, op))
    # q18's last merge: the running partial (the order keys of every
    # batch but the last, with their quantity sums) and the last batch
    lk, lq = lineitem["l_orderkey"], lineitem["l_quantity"]
    cut = (len(lk) - 1) // n * n
    part = np.bincount(lk[:cut], weights=lq[:cut])
    pkeys = np.flatnonzero(np.bincount(lk[:cut]))
    keys = np.concatenate([pkeys, lk[cut:]])
    vals = np.concatenate([part[pkeys], lq[cut:]])
    q18 = "q18 last merge (running partial and one scan batch)"
    main = _fold_case(dev, q18, keys, vals, 20)
    for op in ("min", "max"):
        cases.append(_fold_case(dev, q18, keys, vals, 20, op))
    _c5_case(dev)
    torch.cuda.synchronize()
    main["cases"] = cases + [dict(main)]
    return main


def phase_join_kinds(dev, lineitem, orders):
    """Left, left semi and full joins on the card against the same call
    on the CPU: one 2,097,152-row lineitem batch probing the orders of
    q3's date filter."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.benchmarks.datagen import days
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.batch import batch_from_numpy
    from spark_rapids_tpu_torch.ops import join as oj

    n = 1 << 21
    ok = orders["o_orderdate"] < days(tpch.Q3_DATE)
    s_cols = [lineitem["l_orderkey"][:n], lineitem["l_quantity"][:n]]
    b_cols = [orders["o_orderkey"][ok], orders["o_custkey"][ok]]
    s_t, b_t = [dt.INT64, dt.FLOAT64], [dt.INT64, dt.INT64]
    recs = []
    for kind in ("left", "leftsemi", "full"):
        out = []
        for d in (dev, "cpu"):
            s = batch_from_numpy(s_cols, s_t, device=d)
            b = batch_from_numpy(b_cols, b_t, device=d)
            got, _ = oj.equi_join(s, b, [0], [0], s_t, b_t, kind)
            out.append([c.data.cpu().numpy() for c in got.columns] +
                       [c.validity.cpu().numpy() for c in got.columns
                        if c.validity is not None])
            if d == dev:
                ms = _time_ms(lambda: oj.equi_join(s, b, [0], [0], s_t,
                                                   b_t, kind), 5)
                rows = got.num_rows
        equal = len(out[0]) == len(out[1]) and all(
            np.array_equal(a, b) for a, b in zip(*out))
        rec = {"phase": "join_kinds", "kind": kind, "stream_rows": n,
               "build_rows": int(ok.sum()), "out_rows": rows,
               "equal_to_cpu": equal, "ms": ms}
        print(json.dumps(rec))
        if not equal:
            raise AssertionError(f"{kind} join on the card differs from "
                                 f"the CPU")
        recs.append(rec)
    torch.cuda.synchronize()
    return recs


def phase_q22(dev, customer, orders, phone, nk, runs):
    import torch

    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.kernels import strings as kstr

    want = tpch.q22_numpy(customer, orders)

    def check(got):
        _check_columns("q22", got, want)
        return dict(customer_rows=len(customer["c_custkey"]),
                    orders_rows=len(orders["o_custkey"]),
                    groups=len(want["cntrycode"]),
                    cntrycode=list(got["cntrycode"]),
                    numcust=[int(x) for x in got["numcust"]],
                    matches_oracle=True)

    _run_trees("q22", lambda t: _plan_runner(
        dev, lambda: tpch.q22(customer, orders), _tree_conf(None, t)), nk,
        check, runs)
    # the substring step on the c_phone dictionary, split: host encode of
    # the dictionary, the kernel, the host rebuild of the sliced one
    dic = customer["c_phone"].dictionary
    t0 = time.perf_counter()
    kstr.encode_dictionary(dic)
    encode_s = time.perf_counter() - t0
    kernel_ms = _time_ms(lambda: kstr.substring_table(*phone, 1, 2), 20)
    out_chars, _ = kstr.substring_table(*phone, 1, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new_dict, _ = kstr.rebuild_dictionary(out_chars)
    rebuild_s = time.perf_counter() - t0
    print(json.dumps({"phase": "q22 substring step",
                      "c_phone_entries": len(dic),
                      "cntrycode_entries": len(new_dict),
                      "substring_kernel_ms": kernel_ms,
                      "substring_host_rebuild_ms": rebuild_s * 1e3,
                      "c_phone_host_encode_ms": encode_s * 1e3}))


def phase_q91(dev, tables, nk, runs):
    """q91 through the SQL front end at sf 10, against the numpy oracle,
    on both trees (the session's conf chooses)."""
    from spark_rapids_tpu_torch.api import Session
    from spark_rapids_tpu_torch.benchmarks import tpcds
    from spark_rapids_tpu_torch.execs.base import collect
    from spark_rapids_tpu_torch.plan.overrides import apply_overrides
    from spark_rapids_tpu_torch.plan.nodes import InMemorySource

    want = tpcds.q91_numpy(tables)

    def make_run(tree_kind):
        def run():
            s = Session(_tree_conf(None, tree_kind), device=dev)
            for name, cols in tables.items():
                s.create_temp_view(name, InMemorySource(cols))
            tree = apply_overrides(s.sql(tpcds.Q91_SQL)._plan, s.conf,
                                   device=dev)
            return collect(tree), tree
        return run

    def check(got):
        _check_columns("q91", got, want)
        if not len(want["returns_loss"]):
            raise AssertionError("q91 at sf 10 must return groups")
        rec = {f"{name}_rows": len(next(iter(cols.values())))
               for name, cols in tables.items()}
        rec.update(groups=len(want["returns_loss"]),
                   returns_loss=[float(x) for x in got["returns_loss"]],
                   matches_oracle=True)
        return rec

    _run_trees("q91", make_run, nk, check, runs)


def phase_tpcxbb(dev, tables, nk, runs):
    """The reference's TPCx-BB q5, q6, q9, q11, q12, q14-q17, q20-q23 and
    the two 2002 variants at sf 10, each on both trees against its numpy
    oracle (keys, strings and counts exact, floats within 1e-9 relative,
    q15's within its oracle's bound); every result but the verbatim q22
    and q23 (empty at every scale) must have rows."""
    from spark_rapids_tpu_torch.benchmarks import tpcxbb
    from spark_rapids_tpu_torch.benchmarks.tpcxbb import READS

    for q in tpcxbb.QUERIES + tpcxbb.VARIANTS:
        t0 = time.perf_counter()
        want, bounds = tpcxbb.oracle(q, tables)
        oracle_s = time.perf_counter() - t0
        rows = len(next(iter(want.values())))

        def check(got, q=q, want=want, bounds=bounds, rows=rows,
                  oracle_s=oracle_s):
            tpcxbb.check(q, got, want, bounds)
            if not rows and q not in TPCXBB_EMPTY:
                raise AssertionError(f"TPCx-BB {q} at sf {SF} must return "
                                     "rows")
            rec = {f"{t}_rows": len(next(iter(tables[t].values())))
                   for t in READS[q]}
            rec.update(result_rows=rows, oracle_s=oracle_s,
                       matches_oracle=True)
            return rec

        _run_trees(f"bb_{q}", lambda tree, q=q: _plan_runner(
            dev, lambda: tpcxbb.plan(q, tables), _tree_conf(None, tree)),
            nk, check, runs, reach=q not in TPCXBB_EMPTY)


def phase_c7(dev):
    """The C7 queries (a small-range key on the dense path through a
    string filter, a filter below a projection and a join's stream side,
    where the reference's fused tree keeps its statistics) on the card
    and on the CPU, both default sessions: every value bit for bit."""
    import numpy as np

    from spark_rapids_tpu_torch.api import Session
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.batch import Schema
    from spark_rapids_tpu_torch.plan.nodes import InMemorySource

    r = np.random.default_rng(6)
    n = 300
    a = {"k": r.integers(-5, 20, n).astype(np.int64),
         "v": r.standard_normal(n), "z": np.full(n, -0.0),
         "s": np.array(["x", "y"], dtype=object)[r.integers(0, 2, n)],
         "dt": r.integers(9000, 9060, n).astype(np.int32),
         "wide": r.integers(0, 5000, n).astype(np.int64)}
    b = {"k": np.arange(-5, 20, dtype=np.int64), "w": np.full(25, -0.0)}
    types = {"k": dt.INT64, "v": dt.FLOAT64, "z": dt.FLOAT64,
             "s": dt.STRING, "dt": dt.DATE, "wide": dt.INT64,
             "w": dt.FLOAT64}
    sessions = [Session(device=dev), Session(device="cpu")]
    for s in sessions:
        for name, cols in (("a", a), ("b", b)):
            s.create_temp_view(name, InMemorySource(
                dict(cols), Schema(list(cols), [types[c] for c in cols])))
    signs = []
    for text in C7_QUERIES:
        card, cpu = (s.sql(text).collect() for s in sessions)
        for col in cpu:
            g, w = np.asarray(card[col]), np.asarray(cpu[col])
            if g.dtype.kind == "f":
                g, w = g.view(np.int64), w.view(np.int64)
            if list(g) != list(w):
                raise AssertionError(f"C7 {text!r}: column {col} differs "
                                     "on the card")
        signs.append(bool(np.signbit(np.asarray(card["m"],
                                                np.float64)).all()))
    print(json.dumps({"phase": "c7", "queries": len(C7_QUERIES),
                      "card_equal_cpu": True,
                      "min_is_negative_zero": signs}))


def phase_k1_sizes(dev, runs, rec):
    """K1's launch sizes over the timed query runs, as one histogram line,
    then K1 against its plain version at their quantiles (a seeded mask,
    half true, of each size), appended to ``rec``'s cases."""
    import numpy as np
    import torch

    by_query = {q: r.pop("k1_sizes") for q, r in runs.items()}
    sizes = sorted(x for v in by_query.values() for x in v)
    edges = [1 << k for k in range(10, 23, 2)]  # 1 Ki .. 4 Mi rows
    hist = {}
    for x in sizes:
        top = next((e for e in edges if x <= e), None)
        label = f"<={top}" if top else f">{edges[-1]}"
        hist[label] = hist.get(label, 0) + 1
    print(json.dumps({"phase": "k1_launch_sizes", "launches": len(sizes),
                      "rows": sum(sizes), "histogram": hist,
                      "by_query": {q: sorted(v) for q, v in
                                   by_query.items()}}))
    picks = sorted({sizes[int(q * (len(sizes) - 1))]
                    for q in (0.0, 0.25, 0.5, 0.75, 1.0)}) if sizes else []
    r = np.random.default_rng(26)
    for n in picks:
        mask = torch.from_numpy(r.random(n) < 0.5).to(dev)
        rec["cases"].append(_k1_case(mask, "(a query's launch size)", 50,
                                     20))
    torch.cuda.synchronize()


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed")
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from spark_rapids_tpu_torch import kernels as nk
        from spark_rapids_tpu_torch.benchmarks import datagen, tpcds, tpch, \
            tpcxbb
    except ImportError as e:
        print(f"FAIL: run chip_smoke.py from a checkout of the "
              f"repository ({e})")
        return 1
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    phase, t_phase = "device", t_start
    runs = {}

    def enter(name):
        """Print the seconds of the phase that ends, start ``name``."""
        nonlocal phase, t_phase
        now = time.perf_counter()
        print(f"phase {phase}: {now - t_phase:.1f} s")
        phase, t_phase = name, now

    try:
        smi = _smi()
        print(f"nvidia-smi: {smi}")
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)} "
              f"count {torch.cuda.device_count()}")
        enter("build")
        phase_build(nk)
        if sys.argv[1:] == ["--strings"]:
            enter("string kernels")
            srecs, phone, seeded = phase_string_kernels(
                dev, datagen.gen_part(SF), datagen.gen_customer(SF))
            enter("like kernel")
            phase_like_kernel(dev, tpcds.gen_household_demographics(SF),
                              phone, seeded)
            enter("end")
            print(_smi())
            return 0
        enter("data")
        ss = tpcds.gen_store_sales(SF)
        item = tpcds.gen_item(SF)
        want = tpcxbb.q26_numpy(ss, item)
        # one lineitem for q14 and the TPC-H queries after it
        lineitem, part = datagen.gen_lineitem(SF), datagen.gen_part(SF)
        customer, orders = datagen.gen_customer(SF), datagen.gen_orders(SF)
        q91_tables = tpcds.q91_tables(SF)
        tables = {"lineitem": lineitem, "orders": orders,
                  "customer": customer, "part": part,
                  "supplier": datagen.gen_supplier(SF),
                  "nation": datagen.gen_nation(SF),
                  "region": datagen.gen_region(SF),
                  "partsupp": datagen.gen_partsupp(SF)}
        print(f"data: sf {SF}, {len(ss['ss_item_sk'])} sales, "
              f"{len(item['i_item_sk'])} items, {len(want['cid'])} q26 "
              f"rows; {len(lineitem['l_partkey'])} lineitem, "
              f"{len(part['p_partkey'])} part, "
              f"{len(customer['c_custkey'])} customer, "
              f"{len(orders['o_custkey'])} orders; q91: "
              f"{len(q91_tables['catalog_returns']['cr_net_loss'])} "
              f"catalog_returns")
        enter("kernels")
        recs = phase_kernels(dev, ss, item, want["cid"], q91_tables,
                             tables)
        enter("string kernels")
        srecs, phone, seeded = phase_string_kernels(dev, part, customer)
        recs.update(srecs)
        enter("like kernel")
        recs["like_table"] = phase_like_kernel(
            dev, q91_tables["household_demographics"], phone, seeded)
        del seeded
        enter("fma")
        phase_fma(dev)
        enter("q5lite")
        phase_q5lite(dev)
        enter("q26")
        phase_q26(dev, ss, item, want, nk, runs)
        enter("q14")
        phase_q14(dev, lineitem, part, nk, runs)
        for name in (q for q in tpch.INPUTS if q not in ("q14", "q22")):
            enter(name)
            phase_tpch(dev, name, tables, nk, runs)
        enter("groupby")
        recs["seg_sum"] = phase_groupby(dev, lineitem, orders, customer)
        enter("join kinds")
        phase_join_kinds(dev, lineitem, orders)
        del lineitem, tables
        enter("q22")
        phase_q22(dev, customer, orders, phone, nk, runs)
        del customer, orders
        enter("q91")
        phase_q91(dev, q91_tables, nk, runs)
        enter("c7")
        phase_c7(dev)
        enter("tpcxbb data")
        bb_tables = tpcxbb.gen_tables(SF, store_sales=ss, item=item)
        del ss, item
        print("tpcxbb tables: " + ", ".join(
            f"{name} {len(next(iter(cols.values())))}"
            for name, cols in bb_tables.items()))
        enter("tpcxbb")
        phase_tpcxbb(dev, bb_tables, nk, runs)
        del bb_tables
        enter("k1 launch sizes")
        phase_k1_sizes(dev, runs, recs["partition_order"])
        enter("end")
    except Exception as e:  # report the failing phase, print no result
        import traceback

        traceback.print_exc()
        print(f"FAIL in phase {phase}: {type(e).__name__}: {e}")
        return 1
    kernels = []
    for key in KERNELS:
        r = recs[key]
        entry = {k: r[k] for k in ("name", "route", "source", "replaces",
                                   "equal", "max_abs_err", "bound_ms",
                                   "bound_by", "library_ms", "shape")}
        by_path = {q: run["launches"][key] for q, run in runs.items()}
        entry.update(launches=sum(by_path.values()),
                     launches_by_path=by_path, ms=r["kernel_ms"],
                     plain_ms=r["plain_ms"], device_ms=r.get("device_ms"))
        if "cases" in r:
            entry["cases"] = [_case(c) for c in r["cases"]]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
