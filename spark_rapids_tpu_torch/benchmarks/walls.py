"""Warm wall times of the port's TPC queries on the card, to compare two
trees of the repository on one card in turns:

    python -m spark_rapids_tpu_torch.benchmarks.walls [--query q91] \\
        [--sf 10] [--repeat 3]
    # another tree's package, this script:
    PYTHONPATH=/path/to/other/tree python path/to/walls.py --query q14

Each query runs once to warm up, then ``--repeat`` times, each run
through apply_overrides -> collect ending in a synchronize. The plans
come from ``profile_query._plan_fn`` of the tree being timed, which
every tree of the port has had since TPC-H q14 and q22 (q91, through
``Session.sql``, since the SQL front end; q1, q3, q6 and q12 since
host-encoded strings; q4, q13, q15, q16, q18 and q21 since the outer,
semi and full joins; the other ten TPC-H queries since the date and
cast expressions, q5 in its written join order, ``tpch.QUERY_CONF``).
``--query q5lite`` times the q5lite step (a fused filter and a group-by
of 4M rows over 65,536 keys) on data already on the card. The queries
run on the default exec tree, which is fused;
``--unfused`` runs them with ``rapids.tpu.sql.fusion.enabled`` false
(pass it only to a tree that knows the key: an older one is unfused
anyway). Prints one JSON line per query with the card's name and
power limit: per timed run its wall, the device memory still allocated
when it starts (``held_bytes``: what earlier runs left alive) and its
peak allocation. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time


def _runner(query: str, sf: float, unfused: bool = False):
    """One run of ``query``: the q5lite step (its 4M rows, whatever
    ``sf``) over data already on the card, or the query's plan through
    apply_overrides -> collect (``unfused``: on the unfused tree)."""
    import torch

    if query == "q5lite":
        from spark_rapids_tpu_torch.benchmarks import q5lite

        data = [torch.from_numpy(a).cuda() for a in q5lite.gen_data()]
        return lambda: q5lite.step(*data)
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.benchmarks.profile_query import _plan_fn
    from spark_rapids_tpu_torch.execs.base import collect
    from spark_rapids_tpu_torch.plan.overrides import apply_overrides

    plan_fn = _plan_fn(query, sf)
    # a tree older than the date and cast expressions has no QUERY_CONF
    conf = dict(getattr(tpch, "QUERY_CONF", {}).get(query) or {})
    if unfused:
        conf["rapids.tpu.sql.fusion.enabled"] = False
    return lambda: collect(apply_overrides(plan_fn(), conf, device="cuda"))


def main() -> int:
    import torch

    import spark_rapids_tpu_torch

    ap = argparse.ArgumentParser()
    # q5lite, or any query of the timed tree's ``profile_query._plan_fn``
    ap.add_argument("--query", action="append")
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--unfused", action="store_true",
                    help="run the unfused exec tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("walls needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    for query in args.query or ["q26", "q14", "q22"]:
        run = _runner(query, args.sf, args.unfused)
        walls, held, peaks = [], [], []
        for i in range(args.repeat + 1):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            if i:
                walls.append(time.perf_counter() - t0)
                held.append(before)
                peaks.append(torch.cuda.max_memory_allocated())
        print(json.dumps({"query": query, "sf": args.sf, "warm_wall_s": walls,
                          "held_bytes": held, "peak_allocated_bytes": peaks,
                          "tree": "unfused" if args.unfused else "default",
                          "package": spark_rapids_tpu_torch.__file__,
                          "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
