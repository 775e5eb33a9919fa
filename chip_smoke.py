#!/usr/bin/env python3
"""Chip smoke for spark_rapids_tpu_torch on one NVIDIA Hopper card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no ``ok`` line):

1. the card: ``nvidia-smi`` name and power limit, the torch device name;
2. build: every CUDA source of the port through ``nvcc`` for sm_90a, all
   at once, with the compiler's register and shared-memory report;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (TPCx-BB sf 10: a 28.8M-row mask for the
   partition kernel, an ~18k-row Books build probed by 28.8M stream
   hashes, a radix argsort over the ~70k HAVING survivors and over
   28.8M int64 keys). Results must be equal; times come from CUDA events
   over warmed repeated launches, beside the bytes bound at 3.35 TB/s and
   one PyTorch library call computing the same function;
4. the q5lite step: 4M rows, 65,536 keys, seed 7, against a numpy
   oracle (groups, keys and counts exact, sums within 1e-9 relative);
5. TPCx-BB q26 at sf 10 (store_sales 28.8M rows, item 180k, 1M
   customers) through apply_overrides -> collect, exactly equal to a
   numpy oracle, with every kernel launched during the query;
6. a ``{"kernels": [...]}`` line, the card's name and power limit, and
   last the ``{"ok": true, ...}`` line.

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
SF = 10
SEED_Q5 = 7


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


def phase_kernels(dev, ss, item, q26_cid):
    """Kernel vs plain at the path's shapes. Returns name -> record."""
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.batch import batch_from_numpy
    from spark_rapids_tpu_torch.kernels import join as kjoin
    from spark_rapids_tpu_torch.kernels import sort as ksort
    from spark_rapids_tpu_torch.ops import hashing

    recs = {}

    def record(name, source, replaces, got, want, ms, plain_ms, lib_ms,
               nbytes, shape):
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "shape": shape, "equal": equal,
               "max_abs_err": max(_max_abs_err(g, w)
                                  for g, w in zip(got, want)),
               "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes"}
        print(json.dumps(rec))
        if not equal:
            raise AssertionError(f"{name} ({shape}) differs from its "
                                 f"plain version")
        return rec

    # K1: which of the 28.8M sales are of a Books item
    books = np.zeros(int(item["i_item_sk"].max()) + 1, dtype=bool)
    books[item["i_item_sk"][item["i_category"] == "Books"]] = True
    mask = torch.from_numpy(books[ss["ss_item_sk"]]).to(dev)
    n = mask.shape[0]
    got = ksort.partition_order(mask)
    want = ksort.partition_order_plain(mask)
    recs["partition_order"] = record(
        "partition_order", "spark_rapids_tpu_torch/kernels/csrc/sort.cu",
        "spark_rapids_tpu/native/kernels/sort.py:41",
        [got], [want.to(torch.int32)],
        _time_ms(lambda: ksort.partition_order(mask), 20),
        _time_ms(lambda: ksort.partition_order_plain(mask), 5),
        _time_ms(lambda: torch.argsort(~mask, stable=True), 5),
        n * 1 + n * 4, f"mask[{n}]")

    # K3: the Books build's hashes, probed by every sale's item hash
    bmask = item["i_category"] == "Books"
    build = batch_from_numpy([item["i_item_sk"][bmask]], [dt.INT64],
                             device=dev)
    stream = batch_from_numpy([ss["ss_item_sk"]], [dt.INT64], device=dev)
    sb_h = torch.sort(hashing.hash_columns(build, [0], [dt.INT64])).values
    h_p = hashing.hash_columns(stream, [0], [dt.INT64])
    table = kjoin.build_table(sb_h)
    got = kjoin.probe(table, h_p)
    want = kjoin.probe_plain(table, h_p)
    recs["probe"] = record(
        "probe", "spark_rapids_tpu_torch/kernels/csrc/join.cu",
        "spark_rapids_tpu/native/kernels/join.py:114",
        list(got), list(want),
        _time_ms(lambda: kjoin.probe(table, h_p), 20),
        _time_ms(lambda: kjoin.probe_plain(table, h_p), 3),
        _time_ms(lambda: (torch.searchsorted(sb_h, h_p),
                          torch.searchsorted(sb_h, h_p, right=True)), 5),
        h_p.numel() * 8 + sb_h.numel() * 8 + table.part.numel() * 4 +
        h_p.numel() * 8, f"build[{sb_h.numel()}] x stream[{h_p.numel()}]")

    # K2: ORDER BY cid over the HAVING survivors (the lexsort keys: a
    # 1-bit liveness rank, then the int64 key), and over 28.8M int64 keys
    cid = torch.from_numpy(q26_cid).to(dev)
    rank = torch.zeros(cid.shape[0], dtype=torch.int32, device=dev)
    keys, widths = [rank, cid], [1, None]
    got = ksort.radix_order(keys, widths)
    want = ksort.radix_order_plain(keys, widths)
    recs["radix_order"] = record(
        "radix_order", "spark_rapids_tpu_torch/kernels/csrc/sort.cu",
        "spark_rapids_tpu/native/kernels/sort.py:87",
        [got], [want],
        _time_ms(lambda: ksort.radix_order(keys, widths), 50),
        _time_ms(lambda: ksort.radix_order_plain(keys, widths), 3),
        _time_ms(lambda: torch.argsort(cid, stable=True), 50),
        cid.numel() * (4 + 8 + 4), f"survivors[{cid.numel()}]")
    big = torch.from_numpy(ss["ss_customer_sk"]).to(dev)
    got = ksort.radix_order([big])
    want = ksort.radix_order_plain([big])
    recs["radix_order_28m"] = record(
        "radix_order", "spark_rapids_tpu_torch/kernels/csrc/sort.cu",
        "spark_rapids_tpu/native/kernels/sort.py:87",
        [got], [want],
        _time_ms(lambda: ksort.radix_order([big]), 5),
        _time_ms(lambda: ksort.radix_order_plain([big]), 1, warmup=1),
        _time_ms(lambda: torch.argsort(big, stable=True), 5),
        big.numel() * (8 + 4), f"keys[{big.numel()}]")
    torch.cuda.synchronize()
    return recs


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


def phase_q26(dev, ss, item, want, nk):
    import numpy as np
    import torch

    from spark_rapids_tpu_torch.benchmarks import tpcxbb
    from spark_rapids_tpu_torch.execs.base import collect
    from spark_rapids_tpu_torch.plan.overrides import apply_overrides

    def run():
        return collect(apply_overrides(tpcxbb.q26(ss, item), device=dev))

    run()  # warm: caching allocator and library handles
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nk.reset_launches()
    t0 = time.perf_counter()
    got = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(nk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if list(got) != list(want):
        raise AssertionError(f"q26 columns {list(got)} != {list(want)}")
    for name, col in want.items():
        np.testing.assert_array_equal(got[name], col)
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"q26 never launched {missing}")
    rec = {"phase": "q26", "sf": SF, "store_sales_rows":
           len(ss["ss_item_sk"]), "item_rows": len(item["i_item_sk"]),
           "result_rows": len(want["cid"]), "warm_wall_s": wall,
           "peak_allocated_bytes": peak, "launches": launches,
           "matches_oracle": True}
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
        from spark_rapids_tpu_torch.benchmarks import datagen, tpcxbb
    except ImportError as e:
        print(f"FAIL: run chip_smoke.py from a checkout of the "
              f"repository ({e})")
        return 1
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    phase = "device"
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
        ss = datagen.gen_store_sales(SF)
        item = datagen.gen_item(SF)
        want = tpcxbb.q26_numpy(ss, item)
        print(f"data: sf {SF}, {len(ss['ss_item_sk'])} sales, "
              f"{len(item['i_item_sk'])} items, {len(want['cid'])} result "
              f"rows, {time.perf_counter() - t0:.1f} s")
        phase = "kernels"
        recs = phase_kernels(dev, ss, item, want["cid"])
        phase = "q5lite"
        phase_q5lite(dev)
        phase = "q26"
        q26 = phase_q26(dev, ss, item, want, nk)
    except Exception as e:  # report the failing phase, print no result
        import traceback

        traceback.print_exc()
        print(f"FAIL in phase {phase}: {type(e).__name__}: {e}")
        return 1
    kernels = []
    for key in ("partition_order", "radix_order", "probe"):
        r = recs[key]
        entry = {k: r[k] for k in ("name", "route", "source", "replaces",
                                   "equal", "max_abs_err", "bound_ms",
                                   "bound_by", "library_ms", "shape")}
        entry.update(launches=q26["launches"][key], ms=r["kernel_ms"],
                     plain_ms=r["plain_ms"])
        if key == "radix_order":
            big = recs["radix_order_28m"]
            entry["at_28800000_keys"] = {
                k: big[k] for k in ("equal", "kernel_ms", "plain_ms",
                                    "library_ms", "bound_ms")}
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
