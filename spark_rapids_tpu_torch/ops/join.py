"""Inner and left-anti equi-joins: hash-sorted build, bucket probe, exact
verification (the counterpart of spark_rapids_tpu/ops/join.py).

  build:  h_b = hash64(keys); sort build rows by h_b; bucket table
  probe:  h_p = hash64(keys); (lo, counts) per probe row  (kernel K3)
  expand: pair k -> (probe row, build row lo + offset within the run)
  verify: exact key equality per pair kills hash collisions
  emit:   matched pairs compacted in order              (kernel K1)
          (left anti: the stream rows with no matched pair, in order)

Null keys never match: build and probe nulls take disjoint sentinel
hashes, and exact verification rejects a null key, so a left anti join
keeps the stream rows with a null key. The build side is prepared once
and probed by every stream batch. Other join kinds raise.
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
from spark_rapids_tpu_torch.ops.filter import compact_batch

JOIN_TYPES = ("inner", "leftanti")

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
    """Inner: matched pairs compacted in pair order (the partition
    kernel), then stream columns gathered by probe row and build columns
    by build row. Left anti: the stream rows that no pair matched."""
    if join_type == "leftanti":
        matched = torch.zeros(stream.num_rows, dtype=torch.bool,
                              device=match.device)
        matched[pi[match]] = True
        return compact_batch(stream, ~matched), list(stream_types)
    order, n_match = ksort.partition_order_count(match)
    sel = order[:n_match]
    pi_s, bi_s = pi[sel], bi[sel]
    cols = [c.gather(pi_s) for c in stream.columns] + \
        [c.gather(bi_s) for c in build.columns]
    return ColumnarBatch(cols, n_match), \
        list(stream_types) + list(build_types)


def equi_join(stream: ColumnarBatch, build: ColumnarBatch,
              stream_keys: List[int], build_keys: List[int],
              stream_types: List[dt.DType], build_types: List[dt.DType],
              join_type: str = "inner",
              prepared: Optional[PreparedBuild] = None
              ) -> Tuple[ColumnarBatch, List[dt.DType]]:
    """Join ``stream`` (probe side) against ``build``. Inner output:
    stream columns then build columns, pairs in probe-row order and,
    within a probe row, in hash-sorted build order. Left anti output: the
    unmatched stream rows, stream columns only."""
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
