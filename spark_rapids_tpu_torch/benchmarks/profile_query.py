"""Where a query's time goes on the card: one warm run of TPCx-BB q26,
a TPC-H query (any of the 22; q5 in its written join order,
``tpch.QUERY_CONF``), or TPC-DS q91
(through ``Session.sql``) under
``torch.profiler`` (device time by kernel name,
the run's wall time, the device's busy share of it and the port's kernel
launches), then one under
``cProfile`` (host time by Python function; cProfile slows Python calls,
not native work, so its shares only point at candidates).

    python -m spark_rapids_tpu_torch.benchmarks.profile_query \\
        [--query q26|q14|q22|q91|q1|q3|q4|...] [--sf 10] [--unfused]

The default exec tree is fused; ``--unfused`` profiles the unfused one.
Prints one JSON line per query. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import cProfile
import functools
import json
import pstats
import subprocess
import time

from spark_rapids_tpu_torch.benchmarks import tpch


#: the queries the port runs: TPCx-BB q26, TPC-DS q91 and the TPC-H
#: queries of ``tpch.INPUTS``
QUERIES = ("q26", "q91") + tuple(tpch.INPUTS)


@functools.lru_cache(maxsize=None)
def _tpch_table(name: str, sf: float):
    """A TPC-H table, generated once per process (the queries read it and
    change nothing)."""
    from spark_rapids_tpu_torch.benchmarks import datagen

    return datagen.GENERATORS[name](sf)


def _plan_fn(query: str, sf: float):
    from spark_rapids_tpu_torch.benchmarks import tpcds, tpcxbb

    if query == "q26":
        ss, item = tpcds.gen_store_sales(sf), tpcds.gen_item(sf)
        return lambda: tpcxbb.q26(ss, item)
    if query == "q91":
        return _q91_plan_fn(tpcds.q91_tables(sf))
    tables = [_tpch_table(t, sf) for t in tpch.INPUTS[query]]
    return lambda: getattr(tpch, query)(*tables)


def _q91_plan_fn(tables):
    """q91's plan as ``Session.sql`` builds it, over fresh registrations
    of the in-memory tables on every call."""
    from spark_rapids_tpu_torch.api import Session
    from spark_rapids_tpu_torch.benchmarks import tpcds
    from spark_rapids_tpu_torch.plan.nodes import InMemorySource

    def plan():
        s = Session()
        for name, cols in tables.items():
            s.create_temp_view(name, InMemorySource(cols))
        return s.sql(tpcds.Q91_SQL)._plan
    return plan


def profile(query: str, sf: float, top: int, unfused: bool = False
            ) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from spark_rapids_tpu_torch import kernels as nk
    from spark_rapids_tpu_torch.execs.base import collect
    from spark_rapids_tpu_torch.plan.overrides import apply_overrides

    plan_fn = _plan_fn(query, sf)

    conf = tpch.query_conf(query, fused=not unfused)

    def run():
        collect(apply_overrides(plan_fn(), conf))
        torch.cuda.synchronize()

    run()
    nk.reset_launches()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    launches = dict(nk.LAUNCHES)
    rows = []
    busy_us = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:  # kernels and copies only
            continue
        busy_us += e.self_device_time_total
        rows.append((e.self_device_time_total, e.key, e.count))
    rows.sort(reverse=True)
    host = cProfile.Profile()
    host.runcall(run)
    stats = pstats.Stats(host).stats
    funcs = sorted(((tt, "/".join(fn[0].split("/")[-2:]) +
                     f":{fn[1]}:{fn[2]}", nc)
                    for fn, (_cc, nc, tt, _ct, _callers) in stats.items()),
                   reverse=True)
    return {"query": query, "sf": sf,
            "tree": "unfused" if unfused else "fused", "wall_s": wall,
            "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall if wall else None,
            "launches": launches,
            "top_device_ms": [{"name": k[:80], "calls": c, "ms": us / 1e3}
                              for us, k, c in rows[:top]],
            "top_host_self_ms": [{"function": f[:80], "calls": c,
                                  "ms": tt * 1e3}
                                 for tt, f, c in funcs[:top]]}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--query", choices=QUERIES, action="append")
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--unfused", action="store_true",
                    help="profile the unfused exec tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_query needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    for query in args.query or ["q26", "q14", "q22", "q91"]:
        rec = profile(query, args.sf, args.top, args.unfused)
        rec["card"] = card
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
