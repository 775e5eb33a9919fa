"""The q5lite step: filter (val > 0.5 and key not null) fused as a live
mask into a group-by of sum, count and count(*) over one int64 key with
a known range (the counterpart of ``__graft_entry__.entry``'s step and
``bench.gen_data``), and a numpy oracle."""
from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.ops import groupby as gb

N_ROWS = 4_000_000
N_KEYS = 65_536
AGGS = (gb.AggSpec("sum", 1), gb.AggSpec("count", 1),
        gb.AggSpec("count_star"))


def gen_data(n: int = N_ROWS, seed: int = 7):
    """(keys int64, key_valid bool, vals float64), as ``bench.gen_data``."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, N_KEYS, n).astype(np.int64)
    key_valid = rng.random(n) > 0.02
    vals = rng.random(n)
    return keys, key_valid, vals


def step(key_data: torch.Tensor, key_valid: torch.Tensor,
         val_data: torch.Tensor):
    """-> (keys, sums, counts, count_stars, num_groups), groups in key
    order; the key range selects the single packed-lane sort."""
    keep = (val_data > 0.5) & key_valid
    cols = [(key_data, key_valid), (val_data, None)]
    (key_d, _), (agg_d, _), ng = gb._groupby(
        cols, (dt.INT64, dt.FLOAT64), (0,), AGGS, live_mask=keep,
        key_ranges=((0, N_KEYS - 1),))
    return key_d[0], agg_d[0], agg_d[1], agg_d[2], ng


def step_numpy(keys, key_valid, vals):
    """The same result in numpy: (keys, sums, counts, count_stars)."""
    keep = (vals > 0.5) & key_valid
    k, v = keys[keep], vals[keep]
    uniq, inv = np.unique(k, return_inverse=True)
    sums = np.bincount(inv, weights=v, minlength=len(uniq))
    counts = np.bincount(inv, minlength=len(uniq)).astype(np.int64)
    return uniq, sums, counts, counts.copy()
