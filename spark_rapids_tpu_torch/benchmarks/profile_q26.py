"""Where q26's time goes on the card: one warm run of TPCx-BB q26 under
``torch.profiler``, printed as device time by kernel name, the run's
wall time and the device's busy share of it.

    python -m spark_rapids_tpu_torch.benchmarks.profile_q26 [--sf 10]

Prints one JSON line (card name, wall s, device-busy s, top kernels by
device time). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spark_rapids_tpu_torch.benchmarks import datagen, tpcxbb
    from spark_rapids_tpu_torch.execs.base import collect
    from spark_rapids_tpu_torch.plan.overrides import apply_overrides

    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_q26 needs a CUDA device")
    ss = datagen.gen_store_sales(args.sf)
    item = datagen.gen_item(args.sf)

    def run():
        return collect(apply_overrides(tpcxbb.q26(ss, item)))

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    busy_us = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:  # kernels and copies only
            continue
        dev_us = e.self_device_time_total
        busy_us += dev_us
        rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({
        "card": card, "sf": args.sf, "wall_s": wall,
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall if wall else None,
        "top_device_ms": [{"name": k[:80], "calls": c, "ms": us / 1e3}
                          for us, k, c in rows[:args.top]]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
