"""The port's kernels against the reference's Pallas kernels.

On the CPU every wrapper of spark_rapids_tpu_torch.kernels runs its plain
PyTorch version; here each is held BIT-exactly against the reference
kernel run in Pallas interpret mode with the kernel gate on, on the
input families of tests/test_kernels.py. Numpy arrays carry the inputs
between the two frameworks. The CUDA kernels themselves are held against
the plain versions on the card by tests/test_torch_cuda.py.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spark_rapids_tpu.columnar import dtypes as rdt  # noqa: E402
from spark_rapids_tpu.native import kernels as rnk  # noqa: E402
from spark_rapids_tpu.native.kernels import join as rjoin  # noqa: E402
from spark_rapids_tpu.native.kernels import sort as rsort  # noqa: E402
from spark_rapids_tpu.ops import sortkeys as rsortkeys  # noqa: E402
from spark_rapids_tpu.ops.sortkeys import SortKeySpec as RSpec  # noqa: E402

from spark_rapids_tpu_torch.columnar import dtypes as tdt  # noqa: E402
from spark_rapids_tpu_torch.columnar.batch import batch_from_numpy  # noqa: E402
from spark_rapids_tpu_torch.kernels import join as kjoin  # noqa: E402
from spark_rapids_tpu_torch.kernels import sort as ksort  # noqa: E402
from spark_rapids_tpu_torch.ops import sort as tops_sort  # noqa: E402
from spark_rapids_tpu_torch.ops.sortkeys import SortKeySpec  # noqa: E402


@pytest.fixture(autouse=True)
def _reference_kernels_on():
    rnk.reset_config()
    rnk.configure(enabled=True)
    yield
    rnk.reset_config()


def _np(x):
    return np.array(jax.device_get(x))


# -- K1 ----------------------------------------------------------------------

_R11 = np.random.default_rng(11)


@pytest.mark.parametrize("mask", [_R11.random(257) > 0.5, np.ones(64, bool),
                                  np.zeros(64, bool), np.array([True])],
                         ids=["random", "ones", "zeros", "single"])
def test_partition_order_plain_matches_reference(mask):
    want = _np(rsort.partition_order(jnp.asarray(mask)))
    got = ksort.partition_order(torch.from_numpy(mask)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


# -- K2 ----------------------------------------------------------------------


def _sort_batch_arrays(cap, seed, float_key=False):
    """The columns of tests/test_kernels.py::_sort_batch."""
    r = np.random.default_rng(seed)
    k1 = r.integers(-50, 50, size=cap).astype(np.int64)
    v1 = r.random(cap) > 0.2
    k2 = r.random(cap) if float_key else \
        r.integers(0, 5, size=cap).astype(np.int32)
    pay = r.integers(0, 10**6, size=cap).astype(np.int64)
    types = ["bigint", "double" if float_key else "int", "bigint"]
    return [k1, k2, pay], [v1, None, None], types


_SORT_FAMILIES = {
    # (capacity, live rows, seed, specs as (ordinal, asc, nulls_first))
    "sort_indices": (96, 96, 9, [(0, True, False)]),
    "empty_partition": (64, 0, 13, [(0, True, True)]),
}


@pytest.mark.parametrize("family", sorted(_SORT_FAMILIES))
def test_radix_order_plain_matches_reference(family):
    """The reference's order-key arrays (padding rows included) through
    the reference radix kernel and the port's plain version; then the
    port's own sort op, whose exact-length permutation must equal the
    head of the reference's (padding sorts last there)."""
    cap, n, seed, specs = _SORT_FAMILIES[family]
    datas, valids, types = _sort_batch_arrays(cap, seed)
    cols = [(jnp.asarray(d), None if v is None else jnp.asarray(v))
            for d, v in zip(datas, valids)]
    rtypes = [rdt.by_name(t) for t in types]
    keys = rsortkeys.order_key_arrays(cols, rtypes,
                                      [RSpec(*s) for s in specs],
                                      jnp.asarray(n, jnp.int32))
    widths = [1] + [None] * (len(keys) - 1)
    want = _np(rsort.radix_order(keys, widths))
    got = ksort.radix_order([torch.from_numpy(_np(k)) for k in keys],
                            widths)
    np.testing.assert_array_equal(got.numpy(), want)

    ttypes = [tdt.by_name(t) for t in types]
    tbatch = batch_from_numpy(datas, ttypes, valids, num_rows=n,
                              device="cpu")
    got = tops_sort.sort_indices(tbatch, [SortKeySpec(*s) for s in specs],
                                 ttypes)
    np.testing.assert_array_equal(got.numpy(), want[:n])


# -- K3 ----------------------------------------------------------------------


def _reference_table(h_b: np.ndarray, n_valid: int, cap: int):
    maxh = np.iinfo(np.int64).max
    h = np.where(np.arange(cap) < n_valid, h_b, maxh)
    sh = jnp.sort(jnp.asarray(h))
    return rjoin.build_table(sh, jnp.asarray(n_valid),
                             rjoin.table_bits_for(cap)), _np(sh)


def test_probe_plain_matches_reference():
    """test_probe_table_matches_searchsorted's inputs: 48 live build
    hashes in 64 slots, probes half hits and half random."""
    r = np.random.default_rng(7)
    h_b = r.integers(-2**62, 2**62, size=64)
    table, sh = _reference_table(h_b, 48, 64)
    h_p = np.concatenate([r.choice(sh[:48], 20),
                          r.integers(-2**62, 2**62, size=12)])
    lo_r, cnt_r = (_np(x) for x in rjoin.probe(table, jnp.asarray(h_p)))
    # the reference's own table, carried across
    ptable = kjoin.table_from_reference(_np(table.u_sorted),
                                        _np(table.part), device="cpu")
    lo, cnt = kjoin.probe(ptable, torch.from_numpy(h_p))
    np.testing.assert_array_equal(lo.numpy(), lo_r)
    np.testing.assert_array_equal(cnt.numpy(), cnt_r)
    # and the port's table, built from the live hashes alone
    own = kjoin.build_table(torch.from_numpy(sh[:48]))
    lo, cnt = kjoin.probe(own, torch.from_numpy(h_p))
    np.testing.assert_array_equal(lo.numpy(), lo_r)
    np.testing.assert_array_equal(cnt.numpy(), cnt_r)


def test_probe_plain_empty_build():
    """test_join_probe_kernel_empty_build's shape: no live build rows."""
    r = np.random.default_rng(4)
    table, _ = _reference_table(r.integers(-2**62, 2**62, size=8), 0, 8)
    h_p = r.integers(-2**62, 2**62, size=16)
    lo_r, cnt_r = (_np(x) for x in rjoin.probe(table, jnp.asarray(h_p)))
    for ptable in (kjoin.table_from_reference(_np(table.u_sorted),
                                              _np(table.part), "cpu"),
                   kjoin.build_table(torch.zeros(0, dtype=torch.int64))):
        lo, cnt = kjoin.probe(ptable, torch.from_numpy(h_p))
        np.testing.assert_array_equal(lo.numpy(), lo_r)
        np.testing.assert_array_equal(cnt.numpy(), cnt_r)
