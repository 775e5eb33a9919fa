"""Group-by aggregation (the counterpart of spark_rapids_tpu/ops/groupby.py).

Two paths, chosen as the reference chooses them:

- **Dense** (``_dense_groupby``): when every key's value range is known on
  the host (string dictionaries and booleans always, a numeric key from
  its column's statistics, ``key_range_of``) and the packed key
  space has at most ``_DENSE_MAX_GROUPS`` slots (TPC-H q1's returnflag x
  linestatus, q4's priorities, q12's ship modes), each row maps to a
  slot code and each aggregate reduces per slot with no sort. The counts
  are one ``torch.bincount`` over the codes and the float sums another,
  over slot x column (on the card each block adds its rows into a
  histogram in shared memory, then each bin of each block into the
  result: atomic adds whose order is not fixed, so the last bits of a
  float sum may differ from run to run); integer sums, min, max,
  first and last reduce a masked [slots, rows] broadcast in chunks, as
  the reference's sweep does.
- **Sort** (``_groupby``): one stable sort clusters equal keys (nulls
  group first; NaN == NaN and -0.0 == 0.0). When every key's range is
  known all keys pack into one int32/int64 lane and the sort is a single
  ``torch.sort``; otherwise the keys sort as (validity-rank, equality
  lanes...) over the live rows. Group boundaries are rows where a sorted
  lane changes, and each aggregate reduces each group's contiguous rows.

Float sums are per-group sums, never differences of one global prefix
sum: the global prefix's differences carry rounding error that scales
with the running prefix of OTHER groups (catastrophic cancellation when a
huge group precedes a tiny one) and an Inf/NaN would poison every later
group. On the sort path each group's rows fold in row order in pieces
of 8, then the pieces the same way, and so do its min and max
(``kernels.groupby.seg_reduce``: one kernel launch a call on the card,
``seg_fold`` on the CPU; in the role of the reference's ``_seg_scan``):
no step combines rows of two groups, so error and poison stay in the
group they belong to, and no float is added atomically. Integer sums
and counts are exact prefix-sum differences (exact under wrap).

The ops are the reference's: sum, min, max, count, count_star, first,
last, any_valid (the first valid value) and the central moments' lanes:
``sum_of_squares``, ``rterm`` ((sum x)^2 / n) and ``m2`` (the exact
centred second moment: every row shifted by its group's first valid
value d, then sum(d^2) - (sum d)^2 / n, clamped at 0; the whole-batch
reduction centres on the mean). Their float lanes ride the float sums:
the dense path's histogram, the sort path's fold.
As on the reference's XLA backend, a float min, max or sum that is
subnormal is a zero of its sign (``sortkeys.flush_subnormals``, C1), and
so is the sort path's any_valid; first, last and the dense path's
any_valid return the row's value untouched. The sign of a zero follows
the reference too (C5): a float sum of zeros is +0.0 on both paths and
in the grand reduction; the dense path's and the grand min and max
order -0.0 below +0.0; the sort path's min, max and any_valid give
+0.0 for every zero.
Rows masked out by ``live_mask`` (a fused filter) never reach a group.
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
from spark_rapids_tpu_torch.kernels import groupby as kgb
from spark_rapids_tpu_torch.ops.sortkeys import (flush_subnormals,
                                                 stable_lexsort)

AGG_OPS = ("sum", "min", "max", "count", "count_star", "first", "last",
           "any_valid", "sum_of_squares", "m2", "rterm")
#: the central moments' ops: float64 lanes over the input as a double
MOMENT_OPS = ("sum_of_squares", "m2", "rterm")

#: above this many slots the per-slot sweep loses to the sort (the
#: reference's bound)
_DENSE_MAX_GROUPS = 128
#: elements of one masked [slots, rows] chunk of the dense sweep
_SWEEP_ELEMS = 1 << 24


@dataclasses.dataclass(frozen=True)
class AggSpec:
    """One aggregation: op name + input ordinal (-1 for count_star).
    ``first`` and ``last`` take a group's first and last row, null or
    not (Spark's first/last with ignoreNulls false); ``any_valid`` its
    first valid value."""

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
    """Host-known closed value range for packed-key grouping (quantized):
    string dictionaries and booleans always have one; an integral, DATE
    or TIMESTAMP key when its column carries statistics
    (``Column.stats``: the scan's, reduced here on first use)."""
    if isinstance(col, StringColumn):
        return quantize_range(0, max(len(col.dictionary) - 1, 0))
    if dtype is dt.BOOLEAN:
        return (0, 1)
    if (dtype.is_integral or dtype in (dt.DATE, dt.TIMESTAMP)) and \
            col.stats is not None:
        s = col.stats.get()
        if s is not None:
            return quantize_range(s[0], s[1])
    return None


def agg_result_dtype(spec: AggSpec, dtypes: Sequence[dt.DType]) -> dt.DType:
    if spec.op not in AGG_OPS:
        raise NotImplementedError(f"aggregate op {spec.op!r} is not ported")
    if spec.op in ("count", "count_star"):
        return dt.INT64
    if spec.op in MOMENT_OPS:
        return dt.FLOAT64
    in_t = dtypes[spec.ordinal]
    if spec.op == "sum":
        return dt.INT64 if in_t.is_integral or in_t is dt.BOOLEAN \
            else dt.FLOAT64
    return in_t  # min, max, first, last, any_valid keep the type


def _agg_column(batch: ColumnarBatch, spec: AggSpec, rtype: dt.DType,
                data, validity) -> Column:
    """An aggregate's output column; a string input keeps its dictionary
    (codes are in string order, so min/max/first/last of codes are those
    of the strings)."""
    if spec.ordinal >= 0 and rtype is dt.STRING:
        return batch.columns[spec.ordinal]._like(data, validity)
    return Column(rtype, data, validity)


def groupby_aggregate(batch: ColumnarBatch, key_ordinals: List[int],
                      aggs: List[AggSpec], dtypes: List[dt.DType],
                      live_mask: Optional[torch.Tensor] = None
                      ) -> Tuple[ColumnarBatch, List[dt.DType]]:
    """(batch of [keys..., aggregates...], their types), groups in key
    order: on the dense path when ``_dense_layout`` allows it, else on
    the sort path."""
    for spec in aggs:
        agg_result_dtype(spec, dtypes)
    cols = [(c.data, c.validity) for c in batch.columns]
    key_ranges = tuple(key_range_of(batch.columns[o], dtypes[o])
                       for o in key_ordinals)
    key_has_v = tuple(batch.columns[o].validity is not None
                      for o in key_ordinals)
    layout = _dense_layout(dtypes, key_ordinals, key_ranges, key_has_v)
    if layout is not None:
        out = _dense_groupby(cols, dtypes, key_ordinals, aggs, live_mask,
                             layout)
    else:
        out = _groupby(cols, tuple(dtypes), tuple(key_ordinals),
                       tuple(aggs), live_mask=live_mask,
                       key_ranges=key_ranges)
    (key_d, key_v), (agg_d, agg_v), num_groups = out
    out_cols: List[Column] = []
    out_types: List[dt.DType] = []
    for i, o in enumerate(key_ordinals):
        out_cols.append(batch.columns[o]._like(key_d[i], key_v[i]))
        out_types.append(dtypes[o])
    for i, spec in enumerate(aggs):
        rtype = agg_result_dtype(spec, dtypes)
        out_cols.append(_agg_column(batch, spec, rtype, agg_d[i], agg_v[i]))
        out_types.append(rtype)
    return ColumnarBatch(out_cols, num_groups), out_types


def _fills(in_t: dt.DType, kd: torch.dtype):
    """(greatest, least) of a min/max input's lane type: the value a row
    that does not take part holds (the reference's big and small)."""
    if in_t.is_floating:
        return float("inf"), float("-inf")
    if in_t is dt.BOOLEAN:
        return 1, 0
    info = torch.iinfo(kd)
    return info.max, info.min


def _plus_zero(x: torch.Tensor) -> torch.Tensor:
    """``x + 0``: a float -0.0 becomes +0.0, all else stays (C5). The
    reference's float sums start from +0.0 (XLA's reduce), and every
    output of its sort path's segmented scans passes through ``+ 0.0``:
    ``jax.lax.associative_scan`` interleaves its even and odd results by
    padding each with zeros and adding the two."""
    return x + 0 if x.is_floating_point() else x


def _zeros_ordered(x: torch.Tensor) -> torch.Tensor:
    """-0.0 as the negative float closest to zero, so that a min or max
    orders it below +0.0 and above every negative value, as XLA's min
    and max do (C5); ``flush_subnormals`` of the result makes it -0.0
    again."""
    if not x.is_floating_point():
        return x
    fi = torch.finfo(x.dtype)  # tiny * eps: the least subnormal
    return torch.where((x == 0) & torch.signbit(x), -fi.tiny * fi.eps, x)


def _f64_rows(d: torch.Tensor, v: Optional[torch.Tensor]) -> torch.Tensor:
    """The input as doubles, a null row 0.0."""
    x = d.to(torch.float64)
    return x if v is None else torch.where(v, x, torch.zeros_like(x))


def _square(x: torch.Tensor) -> torch.Tensor:
    x = flush_subnormals(x)
    return flush_subnormals(x * x)


def _rterm(s: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """(sum x)^2 / n, n at least 1."""
    return flush_subnormals(_square(s) / n.clamp(min=1).to(torch.float64))


def _m2(sd: torch.Tensor, sd2: torch.Tensor, n: torch.Tensor
        ) -> torch.Tensor:
    """max(sum(d^2) - (sum d)^2 / n, 0), the zeros ordered as XLA's max
    orders them (-0.0 below +0.0)."""
    m2 = flush_subnormals(sd2 - _rterm(sd, n))
    return flush_subnormals(torch.maximum(_zeros_ordered(m2),
                                          torch.zeros_like(m2)))


def _centred(x: torch.Tensor, first: torch.Tensor,
             v: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d, d^2) for each row: its value minus ``first`` (its group's
    first valid value), 0.0 on a null row."""
    d = flush_subnormals(flush_subnormals(x) - flush_subnormals(first))
    if v is not None:
        d = torch.where(v, d, torch.zeros_like(d))
    return d, _square(d)


def _moment_lanes(op: str, x: torch.Tensor, v: Optional[torch.Tensor],
                  first) -> List[torch.Tensor]:
    """The per-row lanes a moment op sums per group (``first()``: each
    row's group's first valid value, asked for by ``m2`` only)."""
    if op == "sum_of_squares":
        return [_square(x)]
    if op == "rterm":
        return [x]
    return list(_centred(x, first(), v))


def _moment_value(op: str, sums: List[torch.Tensor],
                  n: torch.Tensor) -> torch.Tensor:
    """A moment op's value per group from its lanes' sums and the
    group's valid rows ``n``."""
    if op == "rterm":
        return _rterm(sums[0], n)
    if op == "m2":
        return _m2(sums[0], sums[1], n)
    return sums[0]


def reduce_aggregate(batch: ColumnarBatch, aggs: List[AggSpec],
                     dtypes: List[dt.DType], device,
                     live_mask: Optional[torch.Tensor] = None
                     ) -> Tuple[ColumnarBatch, List[dt.DType]]:
    """Whole-batch reduction (no keys): a 1-row batch of the aggregates
    (the reference's ``reduce_aggregate``). Every aggregate but a count
    over no valid rows is null; the results stay on the device. Rows
    masked out by ``live_mask`` are dropped first, so the sums add the
    live rows in the order a compacted batch holds them."""
    if live_mask is not None:
        batch = batch.gather(torch.nonzero(live_mask).squeeze(1))
    n = batch.num_rows
    out_cols: List[Column] = []
    out_types: List[dt.DType] = []
    for spec in aggs:
        rtype = agg_result_dtype(spec, dtypes)
        validity = None
        if spec.op == "count_star":
            data = torch.full((1,), n, dtype=torch.int64, device=device)
            out_cols.append(Column(rtype, data))
            out_types.append(rtype)
            continue
        c = batch.columns[spec.ordinal]
        d, v = c.data, c.validity
        n_valid = torch.full((1,), n, dtype=torch.int64, device=device) \
            if v is None else v.to(torch.int64).sum().reshape(1)
        if spec.op == "count":
            data = n_valid
        elif n == 0:  # nothing to reduce: null
            data = torch.zeros(1, dtype=rtype.torch_dtype, device=device)
            validity = torch.zeros(1, dtype=torch.bool, device=device)
        elif spec.op == "sum":
            x = d.to(rtype.torch_dtype)
            if v is not None:
                x = torch.where(v, x, torch.zeros_like(x))
            data = _plus_zero(flush_subnormals(x.sum().reshape(1)))
            validity = n_valid > 0
        elif spec.op in MOMENT_OPS:
            x = _f64_rows(d, v)

            def total(y):
                return _plus_zero(flush_subnormals(y.sum().reshape(1)))

            if spec.op == "sum_of_squares":
                data = total(_square(x))
            elif spec.op == "rterm":
                data = _rterm(total(x), n_valid)
            else:  # the whole batch centres on its mean
                mean = flush_subnormals(
                    total(x) / n_valid.clamp(min=1).to(torch.float64))
                dd = _centred(x, mean, v)[1]
                data = flush_subnormals(torch.maximum(
                    _zeros_ordered(total(dd)), torch.zeros(
                        1, dtype=torch.float64, device=device)))
            validity = n_valid > 0
        elif spec.op in ("min", "max"):
            dd = d.to(torch.int8) if rtype is dt.BOOLEAN else \
                _zeros_ordered(d)
            big, small = _fills(rtype, dd.dtype)
            fill = big if spec.op == "min" else small
            if v is not None:
                dd = torch.where(v, dd, torch.full_like(dd, fill))
            data = flush_subnormals(
                (dd.amin() if spec.op == "min" else dd.amax()).reshape(1))
            if rtype is dt.BOOLEAN:
                data = data.to(torch.bool)
            validity = n_valid > 0
        else:  # first, last, any_valid: one row's value
            if spec.op == "any_valid" and v is not None:
                at = torch.argmax(v.to(torch.int8)).reshape(1)
            else:
                at = torch.full((1,), 0 if spec.op != "last" else n - 1,
                                dtype=torch.int64, device=device)
            data = d.index_select(0, at)
            if spec.op == "any_valid":
                validity = n_valid > 0
            elif v is not None:
                validity = v.index_select(0, at)
        out_cols.append(_agg_column(batch, spec, rtype, data, validity))
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


def _cards_strides(ranges, key_has_v):
    """Per key: its slot count (a null takes slot 0 when it has nulls)
    and its stride in the packed code; and the product of the counts."""
    cards = [(hi - lo + 1) + (1 if hv else 0)
             for (lo, hi), hv in zip(ranges, key_has_v)]
    strides, stride = [], 1
    for card in reversed(cards):
        strides.append(stride)
        stride *= max(card, 1)
    strides.reverse()
    return cards, strides, stride


def _pack(cols, dtypes, key_ordinals, ranges, strides, lane_dt, n, dev):
    """Every key's slot code, packed into one integer lane."""
    pack = torch.zeros(n, dtype=lane_dt, device=dev)
    for (lo, _hi), strd, o in zip(ranges, strides, key_ordinals):
        d, v = cols[o]
        dd = d.to(torch.int32) if dtypes[o] is dt.BOOLEAN else d
        # subtract the base before narrowing: a small span at a large
        # magnitude must not wrap
        code = (dd - lo).to(lane_dt)
        if v is not None:
            code = torch.where(v, code + 1, torch.zeros_like(code))
        pack = pack + code * strd
    return pack


def _decode_key(code, lo, has_v, dtype, wide):
    """(data, validity) of one key from its slot code."""
    if has_v:
        kd, kv = (code - 1).to(wide) + lo, code > 0
    else:
        kd, kv = code.to(wide) + lo, None
    if dtype is dt.BOOLEAN:
        kd = kd.to(torch.bool)
    return kd, kv


# ---------------------------------------------------------------------------
# dense path: a small host-known key space needs no sort
# ---------------------------------------------------------------------------


def _dense_layout(dtypes, key_ordinals, key_ranges, key_has_v):
    """(ranges, cards, strides, slots) when every key packs and the packed
    space has at most ``_DENSE_MAX_GROUPS`` slots, else None."""
    ranges = _pack_plan(dtypes, key_ordinals, key_ranges)
    if ranges is None:
        return None
    cards, strides, total = _cards_strides(ranges, key_has_v)
    if total > _DENSE_MAX_GROUPS:
        return None
    return ranges, cards, strides, total


def _sweep(codes: torch.Tensor, x: torch.Tensor, slots: int, op: str,
           fill) -> torch.Tensor:
    """Per slot s < ``slots``: ``op`` (sum, amin or amax) over x's rows
    whose code is s, ``fill`` where none is. The masked [slots, rows]
    broadcast of the reference, in chunks of rows."""
    sl = torch.arange(slots, device=codes.device)[:, None]
    step = max(_SWEEP_ELEMS // max(slots, 1), 1)
    out = torch.full((slots,), fill, dtype=x.dtype, device=x.device)
    for lo in range(0, codes.shape[0], step):
        eq = codes[None, lo:lo + step] == sl
        part = getattr(torch.where(eq, x[None, lo:lo + step],
                                   torch.full((), fill, dtype=x.dtype,
                                              device=x.device)),
                       op)(dim=1)
        out = out + part if op == "sum" else \
            (torch.minimum if op == "amin" else torch.maximum)(out, part)
    return out


def _dense_groupby(cols, dtypes, key_ordinals, aggs, live_mask, layout):
    """Sort-free group-by over at most ``_DENSE_MAX_GROUPS`` slots (the
    reference's ``_dense_groupby``): the same null-first slot encoding
    and validity rules as the sort path; groups come in slot order."""
    ranges, cards, strides, total = layout
    n = cols[key_ordinals[0]][0].shape[0]
    dev = cols[key_ordinals[0]][0].device
    codes = _pack(cols, dtypes, key_ordinals, ranges, strides, torch.int64,
                  n, dev)
    if live_mask is not None:  # a dead row counts in the spare slot
        codes = torch.where(live_mask, codes, torch.full_like(codes, total))

    def per_slot(idx, weights=None):
        """Per slot but the spare one, per column of ``idx`` ([n, m]
        codes): its rows' count, or the sum of ``weights`` ([n, m]) over
        them; one histogram over slot * m + column for all columns."""
        m = idx.shape[1]
        flat = (idx * m + torch.arange(m, device=dev)).reshape(-1)
        return torch.bincount(
            flat, weights=None if weights is None else weights.reshape(-1),
            minlength=(total + 1) * m).view(total + 1, m)[:total]

    def contributing(o):
        """Codes with the rows where input ``o`` is null in the spare
        slot."""
        v = cols[o][1]
        return codes if v is None else \
            torch.where(v, codes, torch.full_like(codes, total))

    # every count in one histogram: the rows, then each nullable input's
    # valid rows
    nullable = list(dict.fromkeys(
        s.ordinal for s in aggs if s.op != "count_star" and
        cols[s.ordinal][1] is not None))
    counts = per_slot(torch.stack([codes] + [contributing(o)
                                             for o in nullable], 1))
    sizes = counts[:, 0]
    slots = torch.nonzero(sizes).squeeze(1)  # the groups, in slot order
    num_groups = int(slots.shape[0])
    iota = torch.arange(n, device=dev)

    def nvalid(o):
        return sizes if cols[o][1] is None else \
            counts[:, 1 + nullable.index(o)]

    def first_valid(o):
        """Per row, the value of the first valid row of its slot."""
        at = _sweep(contributing(o), iota, total + 1, "amin", n)
        d = cols[o][0].to(torch.float64)
        return d[at.clamp(0, max(n - 1, 0))][codes]

    # every float sum in one histogram: the float sums' inputs, then
    # each moment's lanes (x^2; x; d and d^2)
    lanes, at = [], {}
    for i, spec in enumerate(aggs):
        if spec.op == "count_star":
            continue
        d, v = cols[spec.ordinal]
        if spec.op == "sum" and dtypes[spec.ordinal].is_floating:
            at[i] = [len(lanes)]
            lanes.append(_f64_rows(d, v))
        elif spec.op in MOMENT_OPS:
            new = _moment_lanes(spec.op, _f64_rows(d, v), v,
                                lambda: first_valid(spec.ordinal))
            at[i] = list(range(len(lanes), len(lanes) + len(new)))
            lanes.extend(new)
    sums = {}
    if lanes:
        totals = _plus_zero(flush_subnormals(per_slot(
            codes[:, None].expand(n, len(lanes)),
            torch.stack(lanes, 1))[slots]))
        sums = {i: _moment_value(aggs[i].op, [totals[:, j] for j in js],
                                 nvalid(aggs[i].ordinal)[slots])
                for i, js in at.items()}

    agg_d, agg_v = [], []
    for i, spec in enumerate(aggs):
        if spec.op == "count_star":
            agg_d.append(sizes[slots])
            agg_v.append(None)
            continue
        o = spec.ordinal
        d, v = cols[o]
        if spec.op == "count":
            agg_d.append(nvalid(o)[slots])
            agg_v.append(None)
            continue
        valid = (nvalid(o) > 0)[slots]
        if i in sums:
            agg_d.append(sums[i])
            agg_v.append(valid)
        elif spec.op == "sum":
            agg_d.append(_sweep(contributing(o), d.to(torch.int64),
                                total + 1, "sum", 0)[slots])
            agg_v.append(valid)
        elif spec.op in ("min", "max"):
            dd = d.to(torch.int8) if dtypes[o] is dt.BOOLEAN else \
                _zeros_ordered(d)
            fill = _fills(dtypes[o], dd.dtype)[spec.op == "max"]
            vals = flush_subnormals(_sweep(
                contributing(o), dd, total + 1,
                "amin" if spec.op == "min" else "amax", fill)[slots])
            if dtypes[o] is dt.BOOLEAN:
                vals = vals.to(torch.bool)
            agg_d.append(vals)
            agg_v.append(valid)
        else:  # first, last, any_valid: one row of each group
            c = contributing(o) if spec.op == "any_valid" else codes
            if spec.op == "last":
                at = _sweep(c, iota, total + 1, "amax", -1)[slots]
            else:
                at = _sweep(c, iota, total + 1, "amin", n)[slots]
            at = at.clamp(0, max(n - 1, 0))
            agg_d.append(d[at])
            agg_v.append(valid if spec.op == "any_valid" else
                         None if v is None else v[at])
    key_d, key_v = [], []
    for ki, o in enumerate(key_ordinals):
        wide = torch.int32 if dtypes[o] is dt.BOOLEAN else cols[o][0].dtype
        code = (slots // strides[ki]) % max(cards[ki], 1)
        kd, kv = _decode_key(code, ranges[ki][0], cols[o][1] is not None,
                             dtypes[o], wide)
        key_d.append(kd)
        key_v.append(kv)
    return (key_d, key_v), (agg_d, agg_v), num_groups


# ---------------------------------------------------------------------------
# sort path
# ---------------------------------------------------------------------------


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
    n = cols[key_ordinals[0]][0].shape[0]
    dev = cols[key_ordinals[0]][0].device
    key_has_v = tuple(cols[o][1] is not None for o in key_ordinals)
    ranges = _pack_plan(dtypes, key_ordinals, key_ranges)

    # ---- 1. sort ----------------------------------------------------------
    if ranges is not None:
        cards, strides, total = _cards_strides(ranges, key_has_v)
        if total + 1 <= 0x7FFFFFFF:
            lane_dt = torch.int32
        elif total + 1 <= (1 << 62):
            lane_dt = torch.int64
        else:
            ranges = None
    if ranges is not None:
        pack = _pack(cols, dtypes, key_ordinals, ranges, strides, lane_dt,
                     n, dev)
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
    lasts = ends - 1

    def fold(x, op):
        """``op`` ("sum", "min" or "max") over each group's sorted rows,
        through the S1 kernel on the card: one value per group, its
        subnormals flushed (C4) and a float zero +0.0 (C5)."""
        return _plus_zero(flush_subnormals(kgb.seg_reduce(x, starts, sizes,
                                                          op)))

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

    def first_valid_row(o):
        """Each group's first valid row (its first row when none is)."""
        v = sorted_col(o)[1]
        if v is None:
            return starts
        seen = torch.cumsum(v.to(torch.int64), 0)
        before = (seen - v.to(torch.int64))[starts]
        return torch.searchsorted(seen, before + 1).clamp(
            max=max(n_live - 1, 0))

    def first_valid(o):
        """Per sorted row, its group's first valid value, through
        ``+ 0.0`` as the reference's segmented scan gives it."""
        d = sorted_col(o)[0].to(torch.float64)
        first = _plus_zero(flush_subnormals(d[first_valid_row(o)]))
        return first[torch.cumsum(boundary.to(torch.int64), 0) - 1]

    # ---- 3. aggregates ----------------------------------------------------
    agg_d, agg_v = [None] * len(aggs), [None] * len(aggs)
    float_sums = []
    for i, spec in enumerate(aggs):
        if spec.op == "count_star":
            agg_d[i] = sizes.to(torch.int64)
            continue
        o = spec.ordinal
        d, v = sorted_col(o)
        if spec.op == "count":
            agg_d[i] = nvalid(o).to(torch.int64)
            continue
        if spec.op in ("first", "last"):
            at = starts if spec.op == "first" else lasts
            agg_d[i] = d[at]
            agg_v[i] = None if v is None else v[at]
            continue
        agg_v[i] = nvalid(o) > 0
        if spec.op == "any_valid":
            agg_d[i] = _plus_zero(flush_subnormals(d[first_valid_row(o)]))
        elif spec.op in ("min", "max"):
            dd = d.to(torch.int8) if dtypes[o] is dt.BOOLEAN else d
            fill = _fills(dtypes[o], dd.dtype)[spec.op == "max"]
            if v is not None:
                dd = torch.where(v, dd, torch.full_like(dd, fill))
            vals = fold(dd, spec.op)
            agg_d[i] = vals.to(torch.bool) if dtypes[o] is dt.BOOLEAN \
                else vals
        elif spec.op in MOMENT_OPS:
            float_sums.extend((i, y) for y in _moment_lanes(
                spec.op, _f64_rows(d, v), v, lambda: first_valid(o)))
        elif dtypes[o].is_floating:  # float sums: one scan for all
            float_sums.append((i, _f64_rows(d, v)))
        else:
            x = d.to(torch.int64)
            if v is not None:
                x = torch.where(v, x, torch.zeros_like(x))
            agg_d[i] = seg_sum_exact(x)
    if float_sums:
        sums = fold(torch.stack([x for _, x in float_sums], dim=1), "sum")
        parts = {}
        for j, (i, _) in enumerate(float_sums):
            parts.setdefault(i, []).append(sums[:, j])
        for i, got in parts.items():
            agg_d[i] = _moment_value(aggs[i].op, got, nvalid(aggs[i].ordinal))

    # ---- keys -------------------------------------------------------------
    key_d, key_v = [], []
    for ki, o in enumerate(key_ordinals):
        wide = torch.int32 if dtypes[o] is dt.BOOLEAN else cols[o][0].dtype
        if ranges is not None:
            code = (lanes[0][starts] // strides[ki]) % max(cards[ki], 1)
            kd, kv = _decode_key(code, ranges[ki][0], key_has_v[ki],
                                 dtypes[o], wide)
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
