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
    order, n_true = ksort.partition_order_count(torch.from_numpy(mask))
    np.testing.assert_array_equal(order.numpy(), want)
    assert n_true == int(mask.sum())


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


def test_probe_plain_long_runs_match_reference_and_searchsorted():
    """A build of 600 hashes over 3 distinct values (runs of 200, 190 and
    210, each filling its bucket), in 640 slots with padding at int64
    max. Probes hit each run, miss it by one inside its bucket, miss at
    random, and sit at int64 min and max. The port's binary search must
    give the reference's scan and two searchsorted calls, on the
    reference's table carried across and on its own table."""
    r = np.random.default_rng(23)
    lo64, hi64 = np.iinfo(np.int64).min, np.iinfo(np.int64).max
    vals = np.array([-2**62 + 5, 7, 2**62 - 9], dtype=np.int64)
    h_b = np.repeat(vals, [200, 190, 210])
    table, sh = _reference_table(
        np.concatenate([r.permutation(h_b), np.zeros(40, np.int64)]), 600,
        640)
    h_p = np.concatenate([vals, vals - 1, vals + 1, [lo64, hi64],
                          r.integers(lo64, hi64, size=9, dtype=np.int64)])
    lo_r, cnt_r = (_np(x) for x in rjoin.probe(table, jnp.asarray(h_p)))
    assert list(cnt_r[:3]) == [200, 190, 210]
    live = torch.from_numpy(sh[:600])
    hp = torch.from_numpy(h_p)
    left = torch.searchsorted(live, hp).numpy()
    right = torch.searchsorted(live, hp, right=True).numpy()
    np.testing.assert_array_equal(lo_r, left)
    np.testing.assert_array_equal(cnt_r, right - left)
    for ptable in (kjoin.table_from_reference(_np(table.u_sorted),
                                              _np(table.part), "cpu"),
                   kjoin.build_table(live)):
        assert int((ptable.part[1:] - ptable.part[:-1]).max()) >= 200
        lo, cnt = kjoin.probe(ptable, hp)
        np.testing.assert_array_equal(lo.numpy(), lo_r)
        np.testing.assert_array_equal(cnt.numpy(), cnt_r)


@pytest.mark.parametrize("constant", ["one", "all"])
def test_radix_order_plain_constant_keys_match_reference(constant):
    """Keys whose digits are the same for every row (the passes the card
    skips): one constant key beside a varying one, and every key
    constant, where the permutation is the identity."""
    r = np.random.default_rng(29)
    n = 77
    first = np.full(n, -100, np.int8)
    second = np.full(n, 5, np.int8) if constant == "all" else \
        r.integers(-128, 128, n).astype(np.int8)
    keys = [first, second]
    want = _np(rsort.radix_order([jnp.asarray(k) for k in keys]))
    got = ksort.radix_order([torch.from_numpy(k) for k in keys])
    np.testing.assert_array_equal(got.numpy(), want)
    if constant == "all":
        np.testing.assert_array_equal(want, np.arange(n))
