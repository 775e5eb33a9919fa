#!/usr/bin/env python3
"""Chip smoke for spark_rapids_tpu_torch on one NVIDIA Hopper card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no ``ok`` line):

1. the card: ``nvidia-smi`` name and power limit, the torch device name;
2. build: every CUDA source of the port through ``nvcc`` for sm_90a, all
   at once, with the compiler's register and shared-memory report;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main paths' shapes (TPCx-BB sf 10: a 28.8M-row mask for the
   partition kernel and its first 2,097,152 rows, one scan batch; an
   ~18k-row Books build probed by 28.8M stream hashes and by one scan
   batch of them, and builds of 26,000 and 28,000 item ids, either side
   of the probe's shared-memory cutoff, probed by the same stream; a
   radix argsort over the ~70k HAVING survivors, over 28.8M customer
   keys and over 28.8M uniform int64 keys; TPC-DS q91 sf 10: its first
   join, the 1.2M-row catalog_returns build on 6 call-center keys
   probed by the 6 call centers and by a 2M-row stream drawn from
   them; TPC-H sf 10: the match table over part's p_type
   dictionary and the sf-10 c_phone dictionary, and over a 1M-entry
   table past the reference's 64 MiB window budget; substring over the
   c_phone dictionary and over a table of pos / length edges; TPC-DS q91:
   the LIKE table over household_demographics' hd_buy_potential, then
   over the sf-10 c_phone dictionary and the 1M-entry table with the
   reference's test patterns and patterns past its budget). Results
   must be equal; times come from CUDA events over warmed repeated
   launches, beside the bytes bound at 3.35 TB/s and, where one exists,
   one PyTorch library call computing the same function;
4. the q5lite step: 4M rows, 65,536 keys, seed 7, against a numpy
   oracle (groups, keys and counts exact, sums within 1e-9 relative);
5. TPCx-BB q26 at sf 10 (store_sales 28.8M rows, item 180k, 1M
   customers) through apply_overrides -> collect, exactly equal to a
   numpy oracle, with K1, K2 and K3 launched during the query;
6. TPC-H q14 at sf 10 (lineitem 60M rows in 8 generation chunks, part
   2M), within 1e-9 relative of a numpy oracle, with K4, K3 and K1
   launched during the query;
7. TPC-H q22 at sf 10 (customer 1.5M rows, orders 15M), country codes
   and counts exact and balances within 1e-9 relative of a numpy
   oracle, with K6, K3, K2 and K1 launched during the query, and the
   substring step split into kernel time and host dictionary rebuild;
8. TPC-DS q91 at sf 10 (catalog_returns 1.2M rows sampled from 14.4M
   catalog_sales, customer 1M, customer_address 500k) through the SQL
   front end (Session.create_temp_view -> sql -> collect), group keys
   exact and sums within 1e-9 relative of a numpy oracle, with K5, K3
   and K1 launched during the query;
9. a ``{"kernels": [...]}`` line, the card's name and power limit, and
   last the ``{"ok": true, ...}`` line.

Each query phase sets the launch counts to 0 just before its timed run
and reads them just after.

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
# kernels of each timed query (launch counts must be positive there)
PATH_KERNELS = {"q26": ("partition_order", "radix_order", "probe"),
                "q14": ("match_table", "probe", "partition_order"),
                "q22": ("substring", "probe", "radix_order",
                        "partition_order"),
                "q91": ("like_table", "probe", "partition_order")}
KERNELS = ("partition_order", "radix_order", "probe", "match_table",
           "like_table", "substring")
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
            if "Compiling entry" in line or "Used" in line:
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
                                "library_ms", "bound_ms", "bound_by")}


def phase_kernels(dev, ss, item, q26_cid, q91):
    """Kernel vs plain at the path's shapes. Returns name -> record of
    the main path's case, with every case under ``cases``."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.kernels import join as kjoin
    from spark_rapids_tpu_torch.kernels import sort as ksort

    recs = {}

    # K1: which of the 28.8M sales are of a Books item
    books = np.zeros(int(item["i_item_sk"].max()) + 1, dtype=bool)
    books[item["i_item_sk"][item["i_category"] == "Books"]] = True
    mask = torch.from_numpy(books[ss["ss_item_sk"]]).to(dev)
    n = mask.shape[0]
    got = ksort.partition_order(mask)
    want = ksort.partition_order_plain(mask)
    recs["partition_order"] = _record(
        "partition_order", "spark_rapids_tpu_torch/kernels/csrc/sort.cu",
        "spark_rapids_tpu/native/kernels/sort.py:41",
        [got], [want.to(torch.int32)],
        _time_ms(lambda: ksort.partition_order(mask), 20),
        _time_ms(lambda: ksort.partition_order_plain(mask), 5),
        _time_ms(lambda: torch.argsort(~mask, stable=True), 5),
        n * 1 + n * 4, f"mask[{n}]")
    # K1 at one scan batch (plan/overrides.py BATCH_SIZE_ROWS), the most
    # rows one launch sees on the query paths
    m2 = mask[: 1 << 21].clone()
    k1_batch = _record(
        "partition_order", "spark_rapids_tpu_torch/kernels/csrc/sort.cu",
        "spark_rapids_tpu/native/kernels/sort.py:41",
        [ksort.partition_order(m2)], [ksort.partition_order_plain(m2)],
        _time_ms(lambda: ksort.partition_order(m2), 50),
        _time_ms(lambda: ksort.partition_order_plain(m2), 5),
        _time_ms(lambda: torch.argsort(~m2, stable=True), 20),
        m2.numel() * 5, f"mask[{m2.numel()}] (one scan batch)")
    recs["partition_order"]["cases"] = [
        _case(recs["partition_order"]), _case(k1_batch)]

    # K3: the Books build's hashes, probed by every sale's item hash
    bmask = item["i_category"] == "Books"
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
            f"[{n}, {L}]", ops=int(win.sum()) * m)
        k4.append(rec)

    def k6_case(label, chars, lens, pos, length, iters=50, show=True):
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
            None, 2 * (n * L + n * 4), f"{label} substring({pos}, "
            f"{length}) [{n}, {L}]", show=show)
        k6.append(rec)

    # q14: StartsWith(p_type, 'PROMO') over part's dictionary
    p_type = _string_table(np.unique(part["p_type"].astype(str))
                           .astype(object), dev)
    k4_case("p_type", *p_type, "starts", "PROMO")
    # q22: the sf-10 c_phone dictionary
    phone = _string_table(np.unique(customer["c_phone"].astype(str))
                          .astype(object), dev)
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
    # q22: substring(c_phone, 1, 2), then the pos / length edges
    k6_case("c_phone", *phone, 1, 2)
    edge = (_to_dev(chars[:100_000, :32].copy(), dev),
            _to_dev(np.minimum(lens[:100_000], 32), dev))
    for pos in (-20, -3, 0, 1, 5, 40):
        for length in (None, 0, -1, 2, 100):
            k6_case("edges", *edge, pos, length, iters=5, show=False)
    edges = k6[1:]
    summary = {k: edges[0][k] for k in ("name", "bound_ms", "bound_by")}
    summary.update(
        shape=f"edges [{edge[0].shape[0]}, {edge[0].shape[1]}] x "
        f"{len(edges)} (pos, length) cases", equal=True,
        kernel_ms=max(c["kernel_ms"] for c in edges),
        plain_ms=max(c["plain_ms"] for c in edges), library_ms=None)
    print(json.dumps(summary))
    torch.cuda.synchronize()
    recs = {"match_table": dict(k4[0]), "substring": dict(k6[0])}
    recs["match_table"]["cases"] = k4
    recs["substring"]["cases"] = [k6[0], summary]
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
            None, n * L + n * 4 + n, f"{label} like {pattern!r} [{n}, {L}]",
            ops=_like_ops(lens, pattern, escape), show=False)
        rec["matches"] = int(got.sum())
        rec["past_window_budget"] = budget > WINDOW_BUDGET
        print(json.dumps(rec))
        cases.append(rec)
        return rec

    hd_dic = np.unique(hd["hd_buy_potential"].astype(str)).astype(object)
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
    torch.cuda.synchronize()
    rec = dict(main)
    rec["cases"] = cases
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


def _plan_runner(dev, plan_fn):
    """A query run: the plan through apply_overrides -> collect."""
    from spark_rapids_tpu_torch.execs.base import collect
    from spark_rapids_tpu_torch.plan.overrides import apply_overrides

    return lambda: collect(apply_overrides(plan_fn(), device=dev))


def _run_query(name, run, nk):
    """One warm run, then a timed run with the launch counts set to 0
    just before it and read just after. Returns (result, record)."""
    import torch

    run()  # warm: caching allocator, library handles, built kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nk.reset_launches()
    t0 = time.perf_counter()
    got = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(nk.LAUNCHES)
    missing = [k for k in PATH_KERNELS[name] if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{name} never launched {missing}")
    return got, {"phase": name, "sf": SF, "warm_wall_s": wall,
                 "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                 "launches": launches}


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


def phase_q26(dev, ss, item, want, nk):
    from spark_rapids_tpu_torch.benchmarks import tpcxbb

    got, rec = _run_query("q26", _plan_runner(dev, lambda: tpcxbb.q26(
        ss, item)), nk)
    _check_columns("q26", got, want)
    rec.update(store_sales_rows=len(ss["ss_item_sk"]),
               item_rows=len(item["i_item_sk"]),
               result_rows=len(want["cid"]), matches_oracle=True)
    print(json.dumps(rec))
    return rec


def phase_q14(dev, lineitem, part, nk):
    from spark_rapids_tpu_torch.benchmarks import tpch

    want = tpch.q14_numpy(lineitem, part)
    got, rec = _run_query("q14", _plan_runner(dev, lambda: tpch.q14(
        lineitem, part)), nk)
    _check_columns("q14", got, want)
    rec.update(lineitem_rows=len(lineitem["l_partkey"]),
               part_rows=len(part["p_partkey"]),
               promo_revenue=float(got["promo_revenue"][0]),
               oracle=float(want["promo_revenue"][0]), matches_oracle=True)
    print(json.dumps(rec))
    return rec


def phase_q22(dev, customer, orders, phone, nk):
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.kernels import strings as kstr

    want = tpch.q22_numpy(customer, orders)
    got, rec = _run_query("q22", _plan_runner(dev, lambda: tpch.q22(
        customer, orders)), nk)
    _check_columns("q22", got, want)
    # the substring step on the c_phone dictionary, split: host encode of
    # the dictionary, the kernel, the host rebuild of the sliced one
    dic = np.unique(customer["c_phone"].astype(str)).astype(object)
    t0 = time.perf_counter()
    kstr.encode_dictionary(dic)
    encode_s = time.perf_counter() - t0
    kernel_ms = _time_ms(lambda: kstr.substring_table(*phone, 1, 2), 20)
    out_chars, _ = kstr.substring_table(*phone, 1, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new_dict, _ = kstr.rebuild_dictionary(out_chars)
    rebuild_s = time.perf_counter() - t0
    rec.update(customer_rows=len(customer["c_custkey"]),
               orders_rows=len(orders["o_custkey"]),
               c_phone_entries=len(dic), cntrycode_entries=len(new_dict),
               groups=len(want["cntrycode"]),
               cntrycode=list(got["cntrycode"]),
               numcust=[int(x) for x in got["numcust"]],
               substring_kernel_ms=kernel_ms,
               substring_host_rebuild_ms=rebuild_s * 1e3,
               c_phone_host_encode_ms=encode_s * 1e3, matches_oracle=True)
    print(json.dumps(rec))
    return rec


def phase_q91(dev, tables, nk):
    """q91 through the SQL front end at sf 10, against the numpy oracle."""
    from spark_rapids_tpu_torch.api import Session
    from spark_rapids_tpu_torch.benchmarks import tpcds
    from spark_rapids_tpu_torch.plan.nodes import InMemorySource

    want = tpcds.q91_numpy(tables)

    def run():
        s = Session(device=dev)
        for name, cols in tables.items():
            s.create_temp_view(name, InMemorySource(cols))
        return s.sql(tpcds.Q91_SQL).collect()

    got, rec = _run_query("q91", run, nk)
    _check_columns("q91", got, want)
    if not len(want["returns_loss"]):
        raise AssertionError("q91 at sf 10 must return groups")
    rec.update({f"{name}_rows": len(next(iter(cols.values())))
                for name, cols in tables.items()})
    rec.update(groups=len(want["returns_loss"]),
               returns_loss=[float(x) for x in got["returns_loss"]],
               matches_oracle=True)
    print(json.dumps(rec))
    return rec


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
        from spark_rapids_tpu_torch.benchmarks import datagen, tpcds, tpcxbb
    except ImportError as e:
        print(f"FAIL: run chip_smoke.py from a checkout of the "
              f"repository ({e})")
        return 1
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    phase = "device"
    runs = {}
    try:
        smi = _smi()
        print(f"nvidia-smi: {smi}")
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)} "
              f"count {torch.cuda.device_count()}")
        phase = "build"
        phase_build(nk)
        phase = "data"
        t0 = time.perf_counter()
        ss = tpcds.gen_store_sales(SF)
        item = tpcds.gen_item(SF)
        want = tpcxbb.q26_numpy(ss, item)
        lineitem, part = datagen.gen_lineitem(SF), datagen.gen_part(SF)
        customer, orders = datagen.gen_customer(SF), datagen.gen_orders(SF)
        q91_tables = tpcds.q91_tables(SF)
        print(f"data: sf {SF}, {len(ss['ss_item_sk'])} sales, "
              f"{len(item['i_item_sk'])} items, {len(want['cid'])} q26 "
              f"rows; {len(lineitem['l_partkey'])} lineitem, "
              f"{len(part['p_partkey'])} part, "
              f"{len(customer['c_custkey'])} customer, "
              f"{len(orders['o_custkey'])} orders; q91: "
              f"{len(q91_tables['catalog_returns']['cr_net_loss'])} "
              f"catalog_returns; {time.perf_counter() - t0:.1f} s")
        phase = "kernels"
        recs = phase_kernels(dev, ss, item, want["cid"], q91_tables)
        phase = "string kernels"
        srecs, phone, seeded = phase_string_kernels(dev, part, customer)
        recs.update(srecs)
        phase = "like kernel"
        recs["like_table"] = phase_like_kernel(
            dev, q91_tables["household_demographics"], phone, seeded)
        del seeded
        phase = "q5lite"
        phase_q5lite(dev)
        phase = "q26"
        runs["q26"] = phase_q26(dev, ss, item, want, nk)
        del ss, item
        phase = "q14"
        runs["q14"] = phase_q14(dev, lineitem, part, nk)
        del lineitem
        phase = "q22"
        runs["q22"] = phase_q22(dev, customer, orders, phone, nk)
        del customer, orders
        phase = "q91"
        runs["q91"] = phase_q91(dev, q91_tables, nk)
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
                     plain_ms=r["plain_ms"])
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
