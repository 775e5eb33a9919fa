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
``Session.sql``, since the SQL front end). Prints one JSON
line per query with the card's name and power limit. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time


def main() -> int:
    import torch

    import spark_rapids_tpu_torch
    from spark_rapids_tpu_torch.benchmarks.profile_query import _plan_fn
    from spark_rapids_tpu_torch.execs.base import collect
    from spark_rapids_tpu_torch.plan.overrides import apply_overrides

    ap = argparse.ArgumentParser()
    ap.add_argument("--query", choices=("q26", "q14", "q22", "q91"),
                    action="append")
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("walls needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    for query in args.query or ["q26", "q14", "q22"]:
        plan_fn = _plan_fn(query, args.sf)
        walls = []
        for i in range(args.repeat + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            collect(apply_overrides(plan_fn(), device="cuda"))
            torch.cuda.synchronize()
            if i:
                walls.append(time.perf_counter() - t0)
        print(json.dumps({"query": query, "sf": args.sf, "warm_wall_s": walls,
                          "package": spark_rapids_tpu_torch.__file__,
                          "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
