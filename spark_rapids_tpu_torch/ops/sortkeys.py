"""Sort and equality keys (the counterpart of spark_rapids_tpu/ops/sortkeys.py).

Every ORDER BY term reduces to a few key arrays, most significant first:
a null-rank key for NULLS FIRST/LAST, then the value (descending integers
are bit-inverted; descending floats are negated behind a NaN-rank key so
NaN comes first). A leading liveness rank key puts rows masked out by a
fused filter last. These arrays carry the semantics; the radix kernel
(kernels/sort.radix_order) only sorts integers ascending.

Equality (grouping, join verification) uses component lists: floats give
(value with NaN zeroed, isnan), so NaN == NaN and -0.0 == 0.0 without
bit tricks.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt

ColPair = Tuple[torch.Tensor, Optional[torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class SortKeySpec:
    """One ORDER BY term: column ordinal + direction + null ordering."""

    ordinal: int
    ascending: bool = True
    nulls_first: bool = True  # Spark default: NULLS FIRST for ASC

    @staticmethod
    def spark_default(ordinal: int, ascending: bool = True) -> "SortKeySpec":
        # Spark: ASC -> NULLS FIRST, DESC -> NULLS LAST
        return SortKeySpec(ordinal, ascending, nulls_first=ascending)


def canonicalize_floats(x: torch.Tensor) -> torch.Tensor:
    """-0.0 -> +0.0 and every NaN -> one quiet NaN. Subnormals count as
    zero, as on the reference's backends (XLA flushes them), so they
    group, join and hash like +0.0 there and here."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    x = torch.where(x.abs() < torch.finfo(x.dtype).tiny, zero, x)
    return torch.where(torch.isnan(x),
                       torch.full((), float("nan"), dtype=x.dtype,
                                  device=x.device), x)


def flush_subnormals(x: torch.Tensor) -> torch.Tensor:
    """Subnormal floats -> a zero of the same sign; zeros, normal values,
    infinities and NaN unchanged, and integer tensors returned as they
    are. The reference's XLA backends treat the float operands and
    results of comparisons and arithmetic so (``-1e-310 * 2.0`` is
    ``-0.0``, ``1e-310 = 0.0`` holds), and the expressions flush with
    this helper to agree with them."""
    if not x.is_floating_point():
        return x
    return torch.where(x.abs() < torch.finfo(x.dtype).tiny, x * 0, x)


def sort_key_arrays(data: torch.Tensor, validity: Optional[torch.Tensor],
                    dtype: dt.DType, spec: SortKeySpec) -> List[torch.Tensor]:
    """Key arrays for one ORDER BY term, most significant first."""
    keys: List[torch.Tensor] = []
    if validity is not None:
        # valid rows rank 1 when nulls first, rank 0 when nulls last
        keys.append(validity.to(torch.int32) if spec.nulls_first
                    else (~validity).to(torch.int32))
    if dtype.is_floating:
        x = canonicalize_floats(data)
        if validity is not None:
            x = torch.where(validity, x, torch.zeros_like(x))
        if spec.ascending:
            keys.append(x)  # NaN sorts greatest: Spark's ASC order
        else:
            isn = torch.isnan(x)
            keys.append((~isn).to(torch.int32))
            keys.append(torch.where(isn, torch.zeros_like(x), -x))
        return keys
    k = data.to(torch.int8) if dtype is dt.BOOLEAN else data
    if validity is not None:
        k = torch.where(validity, k, torch.zeros_like(k))
    if not spec.ascending:
        k = ~k if k.dtype != torch.int8 else -k.to(torch.int32)
    keys.append(k)
    return keys


def order_key_arrays(cols: Sequence[ColPair], dtypes: List[dt.DType],
                     specs: List[SortKeySpec],
                     live_mask: Optional[torch.Tensor] = None
                     ) -> List[torch.Tensor]:
    """Liveness rank (masked-out rows last), then each spec's keys."""
    n = cols[specs[0].ordinal][0].shape[0]
    dev = cols[specs[0].ordinal][0].device
    rank = torch.zeros(n, dtype=torch.int32, device=dev) \
        if live_mask is None else (~live_mask).to(torch.int32)
    keys: List[torch.Tensor] = [rank]
    for spec in specs:
        data, validity = cols[spec.ordinal]
        keys.extend(sort_key_arrays(data, validity, dtypes[spec.ordinal],
                                    spec))
    return keys


def stable_lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable ascending permutation (int64) over ``keys``, most
    significant first: one stable sort per key, least significant first
    (the reference's ``jnp.lexsort``; NaN sorts last)."""
    n = keys[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def lexsort_indices(cols: Sequence[ColPair], dtypes: List[dt.DType],
                    specs: List[SortKeySpec],
                    live_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Stable permutation ordering rows by ``specs`` (masked-out rows
    last). Integral keys go through the radix kernel; a floating key
    takes the multi-key stable sort, as in the reference."""
    from spark_rapids_tpu_torch.kernels import sort as ksort

    order = ksort.lexsort_order(cols, dtypes, specs, live_mask)
    if order is not None:
        return order
    return stable_lexsort(order_key_arrays(cols, dtypes, specs, live_mask))


def sort_with_payloads(cols: Sequence[ColPair], dtypes: List[dt.DType],
                       specs: List[SortKeySpec],
                       payloads: Sequence[torch.Tensor],
                       live_mask: Optional[torch.Tensor] = None
                       ) -> List[torch.Tensor]:
    """``payloads`` in the stable order of ``specs``, rows masked out by
    ``live_mask`` last (the reference's ``sort_with_payloads``): ties
    keep row order, nulls, NaN and -0.0 order as in every other sort
    here. Like the reference, the permutation comes from the radix
    kernel where every key is integral (``lexsort_indices``), else from
    the multi-key stable sort, and gathers each payload."""
    perm = lexsort_indices(cols, dtypes, specs, live_mask)
    return [p[perm] for p in payloads]


def equality_parts(data: torch.Tensor, validity: Optional[torch.Tensor],
                   dtype: dt.DType
                   ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """(components, valid): rows are equal iff both valid and every
    component compares equal."""
    valid = validity if validity is not None else \
        torch.ones(data.shape[0], dtype=torch.bool, device=data.device)
    if dtype.is_floating:
        x = canonicalize_floats(data)
        isn = torch.isnan(x)
        xz = torch.where(isn | ~valid, torch.zeros_like(x), x)
        return [xz, isn & valid], valid
    z = torch.where(valid, data, torch.zeros_like(data))
    return [z], valid
