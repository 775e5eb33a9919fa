"""Equi-joins: hash-sorted build, bucket probe, exact verification (the
counterpart of spark_rapids_tpu/ops/join.py).

  build:  h_b = hash64(keys); sort build rows by h_b; bucket table
  probe:  h_p = hash64(keys); (lo, counts) per probe row  (kernel K3)
  expand: pair k -> (probe row, build row lo + offset within the run)
  verify: exact key equality per pair kills hash collisions
  emit:   matched pairs compacted in order              (kernel K1)

The kinds are the reference's: ``inner``; ``leftsemi`` and ``leftanti``
(the stream rows with, or without, a matched pair, stream columns
only); ``left`` (the inner pairs, then the unmatched stream rows with an
all-null build side); ``full`` (those, then the unmatched build rows
with an all-null stream side). Every compaction goes through the
partition kernel. A right join is a flipped left join, planned so by
``plan/overrides``.

Null keys never match: build and probe nulls take disjoint sentinel
hashes, and exact verification rejects a null key, so a left, anti or
full join keeps the rows with a null key unmatched. The build side is
prepared once and probed by every stream batch.

A fused chain's join (``execs/fused.py``) probes a build whose key
hashes are unique, so each stream row has at most one candidate:
``prepare_unique_build`` (the reference's ``_prep_build_arrays``) sorts
the build by hash, raises the duplicate flag from the hashes, and makes
either a dense inverse table over the single integral key's span or the
K3 probe table.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import Column, StringColumn
from spark_rapids_tpu_torch.kernels import join as kjoin
from spark_rapids_tpu_torch.kernels import sort as ksort
from spark_rapids_tpu_torch.ops import hashing, sortkeys
from spark_rapids_tpu_torch.ops.concat import concat_batches
from spark_rapids_tpu_torch.ops.filter import compact_batch

JOIN_TYPES = ("inner", "left", "leftsemi", "leftanti", "full")

_BUILD_NULL = -0x6789ABCDEF01
_PROBE_NULL = 0x13579BDF2468


def common_key_type(a: dt.DType, b: dt.DType) -> Optional[dt.DType]:
    """Comparison type of a mixed-type key pair (bigint = double compares
    as double); None when there is no numeric common type."""
    if a is b:
        return a

    def _num(t):
        return t.is_floating or t.is_integral or t is dt.BOOLEAN
    if _num(a) and _num(b):
        return dt.FLOAT64 if (a.is_floating or b.is_floating) else dt.INT64
    return None


def _key_hashes(batch: ColumnarBatch, ordinals: List[int],
                dtypes: List[dt.DType], null_sentinel: int,
                target_types: Optional[List[dt.DType]] = None
                ) -> torch.Tensor:
    """Row hashes of the key columns, each cast to its comparison type;
    rows with any null key take ``null_sentinel``."""
    if target_types is not None and any(
            t is not dtypes[o] for t, o in zip(target_types, ordinals)):
        cols = list(batch.columns)
        dtypes = list(dtypes)
        for t, o in zip(target_types, ordinals):
            if t is not dtypes[o] and not isinstance(cols[o], StringColumn):
                cols[o] = Column(t, cols[o].data.to(t.torch_dtype),
                                 cols[o].validity)
                dtypes[o] = t
        batch = ColumnarBatch(cols, batch.num_rows)
    h = hashing.hash_columns(batch, ordinals, dtypes)
    any_null = None
    for o in ordinals:
        v = batch.columns[o].validity
        if v is not None:
            any_null = ~v if any_null is None else (any_null | ~v)
    if any_null is not None:
        h = torch.where(any_null, torch.full_like(h, null_sentinel), h)
    return h


def hash_keys(keys, types: List[dt.DType], targets: List[dt.DType],
              sentinel: int) -> torch.Tensor:
    """Row hashes of ``keys`` ((data, validity) pairs of ``types``), each
    cast to its pair's comparison type first; a row with any null key
    takes ``sentinel`` (the reference's fused ``_hash_keys``)."""
    vals = []
    any_null = None
    for (d, v), t, tgt in zip(keys, types, targets):
        if tgt is dt.STRING:
            raise AssertionError("string join keys are not fusable")
        h = hashing._numeric_to_int64(
            d if t is tgt else d.to(tgt.torch_dtype), tgt)
        if v is not None:
            any_null = ~v if any_null is None else (any_null | ~v)
            h = torch.where(v, h, torch.full_like(h, hashing._NULL_HASH))
        vals.append(h)
    h = hashing._combine(vals)
    if any_null is not None:
        h = torch.where(any_null, torch.full_like(h, sentinel), h)
    return h


_MAXH = (1 << 63) - 1


class UniqueBuild(NamedTuple):
    """A build prepared for probes that find at most one row (the
    reference's ``PreparedBuild``). ``ok`` False: two matchable rows
    share a key hash, and the chain falls back to its unfused subtree.
    ``h_sorted``: the hashes ascending, the rows that cannot match (a
    null key) last as int64 max; ``datas``/``vals`` the build columns in
    that order; ``n_valid`` the matchable rows. ``table`` (dense mode):
    ``table[key - dense_lo]`` is the sorted row of that key, -1 absent;
    else ``ptable`` is K3's probe table over the matchable hashes."""

    ok: bool
    h_sorted: Optional[torch.Tensor] = None
    datas: tuple = ()
    vals: tuple = ()
    n_valid: int = 0
    table: Optional[torch.Tensor] = None
    dense_lo: int = 0
    ptable: Optional[kjoin.ProbeTable] = None


def prepare_unique_build(build: ColumnarBatch, key_ords: List[int],
                         types: List[dt.DType], hash_types: List[dt.DType],
                         span_max: int) -> UniqueBuild:
    """Hash and sort the build, flag repeated hashes (the reference's
    test: hashes, not keys, so two keys of one hash fall back), and make
    the dense table when the single integral key's span, quantized, is
    at most ``span_max``, else K3's table. The span comes from the key
    column's statistics when it has them, else from one reduction of
    its matchable rows."""
    from spark_rapids_tpu_torch.ops.groupby import quantize_range

    datas = [c.data for c in build.columns]
    vals = [c.validity for c in build.columns]
    h = hash_keys([(datas[o], vals[o]) for o in key_ords],
                  [types[o] for o in key_ords], hash_types, _BUILD_NULL)
    matchable = h != _BUILD_NULL
    h_l = torch.where(matchable, h, torch.full_like(h, _MAXH))
    sh, order = torch.sort(h_l, stable=True)
    valid_s = sh != _MAXH
    dup = bool(((sh[1:] == sh[:-1]) & valid_s[:-1]).any()) \
        if sh.shape[0] > 1 else False
    if dup:
        return UniqueBuild(ok=False)
    n_valid = int(valid_s.sum())
    sdatas = tuple(d[order] for d in datas)
    svals = tuple(None if v is None else v[order] for v in vals)
    want_range = span_max > 0 and len(key_ords) == 1 and (
        hash_types[0].is_integral or
        hash_types[0] in (dt.DATE, dt.TIMESTAMP, dt.BOOLEAN))
    rng = None
    if want_range and n_valid:
        st = build.columns[key_ords[0]].stats
        st = None if st is None else st.get()
        if st is not None:
            qlo, qhi = quantize_range(int(st[0]), int(st[1]))
            if qhi - qlo + 1 <= span_max:
                rng = (qlo, qhi)
        if rng is None:
            kd = sdatas[key_ords[0]][:n_valid].to(torch.int64)
            lo, hi = torch.stack([kd.min(), kd.max()]).tolist()
            qlo, qhi = quantize_range(int(lo), int(hi))
            if qhi - qlo + 1 <= span_max:
                rng = (qlo, qhi)
    if rng is not None:
        span = rng[1] - rng[0] + 1
        keys = sdatas[key_ords[0]][:n_valid].to(torch.int64) - rng[0]
        table = torch.full((span,), -1, dtype=torch.int32, device=sh.device)
        table[keys] = torch.arange(n_valid, dtype=torch.int32,
                                   device=sh.device)
        return UniqueBuild(True, sh, sdatas, svals, n_valid, table, rng[0])
    return UniqueBuild(True, sh, sdatas, svals, n_valid,
                       ptable=kjoin.build_table(sh[:n_valid]))


class PreparedBuild(NamedTuple):
    """The build side prepared once for every stream batch: rows sorted
    by hash and the probe table over those hashes."""

    sorted_build: ColumnarBatch
    table: kjoin.ProbeTable


def prepare_build(build: ColumnarBatch, build_keys: List[int],
                  build_types: List[dt.DType],
                  stream_types_for_keys: List[dt.DType]) -> PreparedBuild:
    """Hash, sort and table the build side. String join keys are not
    ported (the reference unifies their dictionaries per stream batch)."""
    if any(isinstance(build.columns[o], StringColumn) for o in build_keys):
        raise NotImplementedError("string join keys are not ported")
    commons = [common_key_type(st, build_types[bo])
               for st, bo in zip(stream_types_for_keys, build_keys)]
    if any(c is None for c in commons):
        raise ValueError("no common comparison type for join keys")
    h_b = _key_hashes(build, build_keys, build_types, _BUILD_NULL,
                      target_types=commons)
    sb_h, order = _sort_build(h_b)
    return PreparedBuild(build.gather(order), kjoin.build_table(sb_h))


def _sort_build(h_b: torch.Tensor):
    """Build rows in ascending hash order (stable, so equal hashes keep
    build order). Exact lengths need no padding sentinel."""
    return torch.sort(h_b, stable=True)


def _hash_probe(table: kjoin.ProbeTable, h_p: torch.Tensor):
    """(lo, counts, total): leftmost hash match, run length, and their
    sum (the one host sync, which sizes the pair expansion)."""
    lo, cnt = kjoin.probe(table, h_p)
    counts = cnt.to(torch.int64)
    return lo, counts, int(counts.sum())


def _expand_verify(lo, counts, total: int, key_pairs, key_types):
    """Pair k: probe row pi[k], build row bi[k], and whether the pair's
    keys are exactly equal (on the pair's comparison type)."""
    dev = lo.device
    n_s = lo.shape[0]
    pi = torch.repeat_interleave(torch.arange(n_s, device=dev), counts,
                                 output_size=total)
    excl = torch.cumsum(counts, 0) - counts
    k = torch.arange(total, dtype=torch.int64, device=dev)
    bi = lo.to(torch.int64)[pi] + (k - excl[pi])
    match = torch.ones(total, dtype=torch.bool, device=dev)
    for (sd, sv, bd, bv), t in zip(key_pairs, key_types):
        s_comps, s_valid = sortkeys.equality_parts(sd, sv, t)
        b_comps, b_valid = sortkeys.equality_parts(bd, bv, t)
        match &= s_valid[pi] & b_valid[bi]
        for sc, bc in zip(s_comps, b_comps):
            match &= sc[pi] == bc[bi]
    return pi, bi, match


def _emit(stream: ColumnarBatch, build: ColumnarBatch, stream_types,
          build_types, pi, bi, match, join_type: str
          ) -> Tuple[ColumnarBatch, List]:
    """Inner pairs compacted in pair order (the partition kernel), stream
    columns gathered by probe row and build columns by build row; then,
    by kind, the unmatched rows (the reference's ``_emit``)."""
    if join_type in ("leftsemi", "leftanti"):
        matched = _matched(stream.num_rows, pi, match)
        keep = matched if join_type == "leftsemi" else ~matched
        return compact_batch(stream, keep), list(stream_types)
    order, n_match = ksort.partition_order_count(match)
    sel = order[:n_match]
    pi_s, bi_s = pi[sel], bi[sel]
    cols = [c.gather(pi_s) for c in stream.columns] + \
        [c.gather(bi_s) for c in build.columns]
    out_types = list(stream_types) + list(build_types)
    inner = ColumnarBatch(cols, n_match)
    if join_type == "inner":
        return inner, out_types
    # left and full: the stream rows no pair matched, build side null
    un_stream = compact_batch(stream, ~_matched(stream.num_rows, pi, match))
    pieces = [inner, ColumnarBatch(
        list(un_stream.columns) +
        [_all_null(c, un_stream.num_rows) for c in build.columns],
        un_stream.num_rows)]
    if join_type == "full":
        un_build = compact_batch(build, ~_matched(build.num_rows, bi, match))
        pieces.append(ColumnarBatch(
            [_all_null(c, un_build.num_rows) for c in stream.columns] +
            list(un_build.columns), un_build.num_rows))
    return concat_batches(pieces), out_types


def _matched(n: int, rows, match) -> torch.Tensor:
    """Per row of one side (``n`` rows; ``rows`` is each pair's row of
    it): whether a matched pair has it (the reference's
    ``_probe_matched`` and ``_build_matched``)."""
    matched = torch.zeros(n, dtype=torch.bool, device=match.device)
    matched[rows[match]] = True
    return matched


def _all_null(like: Column, n: int) -> Column:
    """``n`` null rows of ``like``'s type (and dictionary)."""
    dev = like.data.device
    return like._like(torch.zeros(n, dtype=like.data.dtype, device=dev),
                      torch.zeros(n, dtype=torch.bool, device=dev))


def equi_join(stream: ColumnarBatch, build: ColumnarBatch,
              stream_keys: List[int], build_keys: List[int],
              stream_types: List[dt.DType], build_types: List[dt.DType],
              join_type: str = "inner",
              prepared: Optional[PreparedBuild] = None
              ) -> Tuple[ColumnarBatch, List[dt.DType]]:
    """Join ``stream`` (probe side) against ``build``. Output columns:
    stream columns then build columns (semi and anti: stream columns
    only). Inner pairs come in probe-row order and, within a probe row,
    in hash-sorted build order; a left join appends the unmatched stream
    rows, and a full join then the unmatched build rows in hash-sorted
    order."""
    if join_type not in JOIN_TYPES:
        raise NotImplementedError(f"{join_type} join is not ported")
    commons = [common_key_type(stream_types[so], build_types[bo])
               for so, bo in zip(stream_keys, build_keys)]
    if any(c is None for c in commons):
        raise ValueError("no common comparison type for join keys")
    if prepared is None:
        prepared = prepare_build(build, build_keys, build_types,
                                 [stream_types[o] for o in stream_keys])
    h_p = _key_hashes(stream, stream_keys, stream_types, _PROBE_NULL,
                      target_types=commons)
    lo, counts, total = _hash_probe(prepared.table, h_p)
    sorted_build = prepared.sorted_build

    def _cast(d, t, c):
        return d if t is c else d.to(c.torch_dtype)

    key_pairs = [
        (_cast(stream.columns[so].data, stream_types[so], c),
         stream.columns[so].validity,
         _cast(sorted_build.columns[bo].data, build_types[bo], c),
         sorted_build.columns[bo].validity)
        for so, bo, c in zip(stream_keys, build_keys, commons)]
    pi, bi, match = _expand_verify(lo, counts, total, key_pairs, commons)
    return _emit(stream, sorted_build, stream_types, build_types, pi, bi,
                 match, join_type)
