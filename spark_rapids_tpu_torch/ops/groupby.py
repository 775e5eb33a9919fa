"""Group-by aggregation by sorting (the counterpart of
spark_rapids_tpu/ops/groupby.py).

1. One stable sort clusters equal keys (nulls group first; NaN == NaN and
   -0.0 == 0.0). When every key's value range is known on the host
   (string dictionaries always; numeric keys when the caller passes
   ``key_ranges``, as the q5lite step does) all keys pack into one
   int32/int64 lane and the sort is a single ``torch.sort``; otherwise
   the keys sort as (validity-rank, equality lanes...) over the live rows.
2. Group boundaries are rows where a sorted lane changes.
3. Aggregates reduce each segment.

Float sums are per-segment sums, never differences of one global prefix
sum: the global prefix's differences carry rounding error that scales
with the running prefix of OTHER groups (catastrophic cancellation when a
huge group precedes a tiny one) and an Inf/NaN would poison every later
group. Per-segment sums confine both to the group they belong to. Integer
sums and counts are exact prefix-sum differences (exact under wrap).

Rows masked out by ``live_mask`` (a fused filter) never reach a group.
Only the ops the ported paths use are here: sum, count and count_star,
which is also the merge set of Count, Sum and Average. Others raise.
Grand aggregates (no keys) are whole-batch reductions
(:func:`reduce_aggregate`), with no sort.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import Column, StringColumn
from spark_rapids_tpu_torch.ops.sortkeys import stable_lexsort

AGG_OPS = ("sum", "count", "count_star")


@dataclasses.dataclass(frozen=True)
class AggSpec:
    """One aggregation: op name + input ordinal (-1 for count_star)."""

    op: str
    ordinal: int = -1


def quantize_range(lo: int, hi: int) -> Tuple[int, int]:
    """Widen (lo, hi) to a power-of-two span on an aligned base, as the
    reference does (only a superset of the true range is needed)."""
    span = max(hi - lo + 1, 1)
    grid = 1 << (span - 1).bit_length()
    qlo = (lo // grid) * grid
    need = hi - qlo + 1
    p = 1 << (need - 1).bit_length()
    return (qlo, qlo + p - 1)


def key_range_of(col: Column, dtype: dt.DType) -> Optional[Tuple[int, int]]:
    """Host-known closed value range for packed-key grouping: string
    dictionaries and booleans have one (the port's columns carry no
    numeric statistics)."""
    if isinstance(col, StringColumn):
        return quantize_range(0, max(len(col.dictionary) - 1, 0))
    if dtype is dt.BOOLEAN:
        return (0, 1)
    return None


def agg_result_dtype(spec: AggSpec, dtypes: Sequence[dt.DType]) -> dt.DType:
    if spec.op in ("count", "count_star"):
        return dt.INT64
    if spec.op == "sum":
        in_t = dtypes[spec.ordinal]
        return dt.INT64 if in_t.is_integral or in_t is dt.BOOLEAN \
            else dt.FLOAT64
    raise NotImplementedError(f"aggregate op {spec.op!r} is not ported")


def groupby_aggregate(batch: ColumnarBatch, key_ordinals: List[int],
                      aggs: List[AggSpec], dtypes: List[dt.DType],
                      live_mask: Optional[torch.Tensor] = None
                      ) -> Tuple[ColumnarBatch, List[dt.DType]]:
    """(batch of [keys..., aggregates...], their types)."""
    cols = [(c.data, c.validity) for c in batch.columns]
    key_ranges = tuple(key_range_of(batch.columns[o], dtypes[o])
                       for o in key_ordinals)
    (key_d, key_v), (agg_d, agg_v), num_groups = _groupby(
        cols, tuple(dtypes), tuple(key_ordinals), tuple(aggs),
        live_mask=live_mask, key_ranges=key_ranges)
    out_cols: List[Column] = []
    out_types: List[dt.DType] = []
    for i, o in enumerate(key_ordinals):
        out_cols.append(batch.columns[o]._like(key_d[i], key_v[i]))
        out_types.append(dtypes[o])
    for i, spec in enumerate(aggs):
        rtype = agg_result_dtype(spec, dtypes)
        out_cols.append(Column(rtype, agg_d[i], agg_v[i]))
        out_types.append(rtype)
    return ColumnarBatch(out_cols, num_groups), out_types


def reduce_aggregate(batch: ColumnarBatch, aggs: List[AggSpec],
                     dtypes: List[dt.DType], device
                     ) -> Tuple[ColumnarBatch, List[dt.DType]]:
    """Whole-batch reduction (no keys): a 1-row batch of the aggregates
    (the reference's ``reduce_aggregate``). A sum over no valid rows is
    null; the results stay on the device."""
    n = batch.num_rows
    out_cols: List[Column] = []
    out_types: List[dt.DType] = []
    for spec in aggs:
        if spec.op not in AGG_OPS:
            raise NotImplementedError(
                f"aggregate op {spec.op!r} is not ported")
        rtype = agg_result_dtype(spec, dtypes)
        validity = None
        if spec.op == "count_star":
            data = torch.full((1,), n, dtype=torch.int64, device=device)
        else:
            c = batch.columns[spec.ordinal]
            n_valid = torch.full((1,), n, dtype=torch.int64, device=device) \
                if c.validity is None else \
                c.validity.to(torch.int64).sum().reshape(1)
            if spec.op == "count":
                data = n_valid
            else:
                x = c.data.to(rtype.torch_dtype)
                if c.validity is not None:
                    x = torch.where(c.validity, x, torch.zeros_like(x))
                data = x.sum().reshape(1)
                validity = n_valid > 0
        out_cols.append(Column(rtype, data, validity))
        out_types.append(rtype)
    return ColumnarBatch(out_cols, 1), out_types


def _pack_plan(dtypes, key_ordinals, key_ranges):
    """Validated per-key ranges when every key may pack into one integer
    lane, else None."""
    if key_ranges is None or len(key_ranges) != len(key_ordinals) or \
            not key_ordinals:
        return None
    for r, o in zip(key_ranges, key_ordinals):
        if r is None:
            return None
        if not (dtypes[o].is_integral or dtypes[o] in
                (dt.DATE, dt.TIMESTAMP, dt.BOOLEAN, dt.STRING)):
            return None
    return key_ranges


def _equality_lanes(d: torch.Tensor, v: Optional[torch.Tensor],
                    dtype: dt.DType) -> List[torch.Tensor]:
    """Sort lanes for one unpacked key, each directly comparable row to
    row (floats: NaN-zeroed value plus an isnan flag)."""
    if dtype.is_floating:
        # -0.0 and subnormals group with +0.0 (sortkeys.canonicalize_floats)
        x = torch.where(d.abs() < torch.finfo(d.dtype).tiny,
                        torch.zeros_like(d), d)
        isn = torch.isnan(x)
        if v is not None:
            isn = isn & v
            x = torch.where(v, x, torch.zeros_like(x))
        x = torch.where(isn, torch.zeros_like(x), x)
        return [x, isn]
    k = d.to(torch.int8) if dtype is dt.BOOLEAN else d
    if v is not None:
        k = torch.where(v, k, torch.zeros_like(k))
    return [k]


def _groupby(cols, dtypes, key_ordinals, aggs, live_mask=None,
             key_ranges=None):
    """Returns ((key datas, key validities), (agg datas, agg
    validities), num_groups); every output has num_groups rows and
    groups come in key order."""
    for spec in aggs:
        if spec.op not in AGG_OPS:
            raise NotImplementedError(
                f"aggregate op {spec.op!r} is not ported")
    n = cols[key_ordinals[0]][0].shape[0]
    dev = cols[key_ordinals[0]][0].device
    key_has_v = tuple(cols[o][1] is not None for o in key_ordinals)
    ranges = _pack_plan(dtypes, key_ordinals, key_ranges)

    # ---- 1. sort ----------------------------------------------------------
    lane_dt = None
    if ranges is not None:
        cards = [(hi - lo + 1) + (1 if hv else 0)
                 for (lo, hi), hv in zip(ranges, key_has_v)]
        total = 1
        for c in cards:
            total *= max(c, 1)
        if total + 1 <= 0x7FFFFFFF:
            lane_dt = torch.int32
        elif total + 1 <= (1 << 62):
            lane_dt = torch.int64
        else:
            ranges = None
    if ranges is not None:
        strides = []
        stride = 1
        for card in reversed(cards):
            strides.append(stride)
            stride *= max(card, 1)
        strides.reverse()
        pack = torch.zeros(n, dtype=lane_dt, device=dev)
        for (lo, _hi), has_v, strd, o in zip(ranges, key_has_v, strides,
                                             key_ordinals):
            d, v = cols[o]
            dd = d.to(torch.int32) if dtypes[o] is dt.BOOLEAN else d
            # subtract the base before narrowing: a small span at a large
            # magnitude must not wrap
            code = (dd - lo).to(lane_dt)
            if has_v:
                code = torch.where(v, code + 1, torch.zeros_like(code))
            pack = pack + code * strd
        if live_mask is not None:
            pack = torch.where(live_mask, pack,
                               torch.full_like(pack, total))
        s_pack, order = torch.sort(pack, stable=True)
        n_live = n if live_mask is None else int(live_mask.sum())
        lanes = [s_pack[:n_live]]
        order = order[:n_live]
    else:
        idx = torch.arange(n, device=dev) if live_mask is None else \
            torch.nonzero(live_mask).squeeze(1)
        rank = torch.zeros(idx.shape[0], dtype=torch.int32, device=dev)
        for o, has_v in zip(key_ordinals, key_has_v):
            if has_v:  # valid rows rank 1: nulls group first
                rank = (rank << 1) | cols[o][1][idx].to(torch.int32)
        lanes = [rank]
        key_lane_at = []
        for o in key_ordinals:
            d, v = cols[o]
            key_lane_at.append(len(lanes))
            lanes.extend(_equality_lanes(
                d[idx], None if v is None else v[idx], dtypes[o]))
        perm = stable_lexsort(lanes)
        order = idx[perm]
        lanes = [lane[perm] for lane in lanes]
        n_live = int(idx.shape[0])

    # ---- 2. boundaries ----------------------------------------------------
    boundary = torch.zeros(n_live, dtype=torch.bool, device=dev)
    if n_live:
        boundary[0] = True
        for lane in lanes:
            boundary[1:] |= lane[1:] != lane[:-1]
    starts = torch.nonzero(boundary).squeeze(1)
    num_groups = int(starts.shape[0])
    ends = torch.cat([starts[1:], torch.full((min(num_groups, 1),), n_live,
                                             dtype=starts.dtype,
                                             device=dev)])
    sizes = ends - starts
    seg_id = torch.cumsum(boundary.to(torch.int64), 0) - 1

    def seg_sum_exact(x: torch.Tensor) -> torch.Tensor:
        prefix = torch.cat([x.new_zeros(1), torch.cumsum(x, 0)])
        return prefix[ends] - prefix[starts]

    sorted_cols = {}

    def sorted_col(o):
        if o not in sorted_cols:
            d, v = cols[o]
            sorted_cols[o] = (d[order], None if v is None else v[order])
        return sorted_cols[o]

    def nvalid(o):
        v = sorted_col(o)[1]
        return sizes if v is None else seg_sum_exact(v.to(torch.int64))

    # ---- 3. aggregates ----------------------------------------------------
    agg_d, agg_v = [], []
    for spec in aggs:
        if spec.op == "count_star":
            agg_d.append(sizes.to(torch.int64))
            agg_v.append(None)
            continue
        d, v = sorted_col(spec.ordinal)
        if spec.op == "count":
            agg_d.append(nvalid(spec.ordinal).to(torch.int64))
            agg_v.append(None)
            continue
        # sum
        if dtypes[spec.ordinal].is_floating:
            x = d.to(torch.float64)
            if v is not None:
                x = torch.where(v, x, torch.zeros_like(x))
            s = torch.zeros(num_groups, dtype=torch.float64, device=dev)
            s.index_add_(0, seg_id, x)
        else:
            x = d.to(torch.int64)
            if v is not None:
                x = torch.where(v, x, torch.zeros_like(x))
            s = seg_sum_exact(x)
        agg_d.append(s)
        agg_v.append(nvalid(spec.ordinal) > 0)

    # ---- keys -------------------------------------------------------------
    key_d, key_v = [], []
    for ki, o in enumerate(key_ordinals):
        wide = torch.int32 if dtypes[o] is dt.BOOLEAN else cols[o][0].dtype
        if ranges is not None:
            sp = lanes[0][starts]
            code = (sp // strides[ki]) % max(cards[ki], 1)
            lo = ranges[ki][0]
            if key_has_v[ki]:
                kv = code > 0
                kd = (code - 1).to(wide) + lo
            else:
                kv = None
                kd = code.to(wide) + lo
        else:
            at = key_lane_at[ki]
            if dtypes[o].is_floating:
                val, isn = lanes[at][starts], lanes[at + 1][starts]
                kd = torch.where(isn, torch.full_like(val, float("nan")),
                                 val)
            else:
                kd = lanes[at][starts]
            kv = sorted_col(o)[1][starts] if key_has_v[ki] else None
        if dtypes[o] is dt.BOOLEAN:
            kd = kd.to(torch.bool)
        key_d.append(kd)
        key_v.append(kv)
    return (key_d, key_v), (agg_d, agg_v), num_groups
