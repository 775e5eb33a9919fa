"""The port's hashing, join and group-by against the reference's.

The same numpy inputs, made from a seed, go through spark_rapids_tpu
(on the JAX CPU backend, kernels in Pallas interpret mode where the
reference reaches one) and through spark_rapids_tpu_torch on the CPU.
Hashes and join output must be bit-identical; group-by keys and counts
exact and float sums within 1e-9 relative (the reference's own tolerance
against its CPU oracle; the two engines sum each group in a different
order).
"""
from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spark_rapids_tpu.columnar import dtypes as rdt  # noqa: E402
from spark_rapids_tpu.columnar.batch import ColumnarBatch  # noqa: E402
from spark_rapids_tpu.columnar.column import Column, StringColumn  # noqa: E402
from spark_rapids_tpu.native import kernels as rnk  # noqa: E402
from spark_rapids_tpu.ops import groupby as rgb  # noqa: E402
from spark_rapids_tpu.ops import hashing as rhash  # noqa: E402
from spark_rapids_tpu.ops import join as rjoin  # noqa: E402

from spark_rapids_tpu_torch.benchmarks import q5lite  # noqa: E402
from spark_rapids_tpu_torch.columnar import dtypes as tdt  # noqa: E402
from spark_rapids_tpu_torch.columnar.batch import batch_from_numpy  # noqa: E402
from spark_rapids_tpu_torch.ops import groupby as tgb  # noqa: E402
from spark_rapids_tpu_torch.ops import hashing as thash  # noqa: E402
from spark_rapids_tpu_torch.ops import join as tjoin  # noqa: E402


@pytest.fixture(autouse=True)
def _reference_kernels_on():
    rnk.reset_config()
    rnk.configure(enabled=True)
    yield
    rnk.reset_config()


def _np(x):
    return np.array(jax.device_get(x))


def _reference_batch(datas, types, valids, n):
    cols = []
    for d, t, v in zip(datas, types, valids):
        if t == "string":
            cols.append(StringColumn.from_strings(list(d)))
        else:
            cols.append(Column.from_numpy(d, rdt.by_name(t), v))
    return ColumnarBatch(cols, n), [rdt.by_name(t) for t in types]


def _port_batch(datas, types, valids):
    ttypes = [tdt.by_name(t) for t in types]
    return batch_from_numpy(datas, ttypes, valids, device="cpu"), ttypes


# -- hashing -----------------------------------------------------------------


def _hash_inputs(n=200):
    r = np.random.default_rng(21)
    i32 = r.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    i64 = r.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
    f64 = r.standard_normal(n) * 10.0 ** r.integers(-300, 300, n)
    f64[:12] = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 1e-310,
                -1e-310, 3.4e38, 1e39, np.float64(np.float32(0.1)), 0.1]
    f32 = r.standard_normal(n).astype(np.float32)
    f32[:4] = [np.nan, -0.0, 0.0, np.inf]
    words = np.array(["", "Books", "a", "ünïcode", "x" * 40, None],
                     dtype=object)
    strs = words[r.integers(0, len(words), n)]
    nulls = r.random(n) < 0.2
    datas = [i32, i64, f64, f32, strs]
    types = ["int", "bigint", "double", "float", "string"]
    valids = [nulls, None, ~nulls, None, None]
    return datas, types, valids, n


@pytest.mark.parametrize("keys", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]],
                         ids=["int32_nulls", "int64", "float64_nulls",
                              "float32", "string_nulls", "all"])
def test_hash_columns_bit_identical(keys):
    datas, types, valids, n = _hash_inputs()
    rb, rtypes = _reference_batch(datas, types, valids, n)
    tb, ttypes = _port_batch(datas, types, valids)
    want = _np(rhash.hash_columns(rb, keys, rtypes))[:n]
    got = thash.hash_columns(tb, keys, ttypes).numpy()
    np.testing.assert_array_equal(got, want)
    # the same batch carried across from the reference's own arrays
    # (padded columns cut to num_rows, string codes with their dictionary)
    carried = batch_from_numpy(
        [_np(c.data) for c in rb.columns], ttypes,
        [None if c.validity is None else _np(c.validity)
         for c in rb.columns],
        [getattr(c, "dictionary", None) for c in rb.columns],
        num_rows=n, device="cpu")
    got = thash.hash_columns(carried, keys, ttypes).numpy()
    np.testing.assert_array_equal(got, want)


def test_fnv1a64_matches():
    for s in ["", "Books", "ünïcode", "x" * 100]:
        assert thash.fnv1a64(s) == rhash.fnv1a64(s)


# -- inner equi-join ---------------------------------------------------------


def _join_arrays(n, keyspace, seed):
    """The columns of tests/test_kernels.py::_join_batch."""
    r = np.random.default_rng(seed)
    k1 = r.integers(0, keyspace, size=n).astype(np.int64)
    k2 = r.integers(0, 3, size=n).astype(np.int32)
    val = r.integers(0, 1000, size=n).astype(np.int64)
    v1 = r.random(n) > 0.15          # nulls on the first key column
    return [k1, k2, val], ["bigint", "int", "bigint"], [v1, None, None]


def _reference_rows(batch):
    n = int(jax.device_get(batch.num_rows_device()))
    return [(_np(c.data)[:n],
             None if c.validity is None else _np(c.validity)[:n])
            for c in batch.columns]


def _port_rows(batch):
    return [(c.data.numpy(),
             None if c.validity is None else c.validity.numpy())
            for c in batch.columns]


def _assert_same_rows(got, want):
    assert len(got) == len(want)
    for (gd, gv), (wd, wv) in zip(got, want):
        assert len(gd) == len(wd)
        gv = np.ones(len(gd), bool) if gv is None else gv
        wv = np.ones(len(wd), bool) if wv is None else wv
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gd[gv], wd[wv])


@pytest.mark.parametrize("sk,bk", [([0], [0]), ([0, 1], [0, 1]),
                                   ([1], [0])],
                         ids=["int64_nulls", "composite", "int32_int64"])
@pytest.mark.parametrize("n_build", [50, 0], ids=["build", "empty_build"])
def test_equi_join_inner_matches_reference(sk, bk, n_build):
    """Row for row, in order: probe-row order, then hash-sorted build
    order within a probe row. The reference probes its prepared build
    table (the exec's path) with the join kernel on."""
    sd, st, sv = _join_arrays(90, 40, seed=1)
    bd, bt, bv = _join_arrays(n_build, 40, seed=2)
    rs, rst = _reference_batch(sd, st, sv, 90)
    rb, rbt = _reference_batch(bd, bt, bv, n_build)
    prep = rjoin.prepare_build(rb, bk, rbt, [rst[o] for o in sk])
    want, _ = rjoin.equi_join(rs, rb, sk, bk, rst, rbt, "inner",
                              prepared=prep)
    ts, tst = _port_batch(sd, st, sv)
    tb, tbt = _port_batch(bd, bt, bv)
    got, _ = tjoin.equi_join(ts, tb, sk, bk, tst, tbt, "inner")
    _assert_same_rows(_port_rows(got), _reference_rows(want))


@pytest.mark.parametrize("sk,bk", [([0], [0]), ([0, 1], [0, 1])],
                         ids=["int64_nulls", "composite"])
@pytest.mark.parametrize("n_build", [50, 0], ids=["build", "empty_build"])
def test_equi_join_leftanti_matches_reference(sk, bk, n_build):
    """The stream rows without a match, in stream order; a null stream
    key never matches, so its row is kept."""
    sd, st, sv = _join_arrays(90, 40, seed=3)
    bd, bt, bv = _join_arrays(n_build, 40, seed=4)
    rs, rst = _reference_batch(sd, st, sv, 90)
    rb, rbt = _reference_batch(bd, bt, bv, n_build)
    prep = rjoin.prepare_build(rb, bk, rbt, [rst[o] for o in sk])
    want, wtypes = rjoin.equi_join(rs, rb, sk, bk, rst, rbt, "leftanti",
                                   prepared=prep)
    ts, tst = _port_batch(sd, st, sv)
    tb, tbt = _port_batch(bd, bt, bv)
    got, gtypes = tjoin.equi_join(ts, tb, sk, bk, tst, tbt, "leftanti")
    assert [t.name for t in gtypes] == [t.name for t in wtypes]
    _assert_same_rows(_port_rows(got), _reference_rows(want))
    assert 0 < got.num_rows <= 90


# -- group-by ----------------------------------------------------------------


def test_q5lite_step_matches_graft_entry():
    """``__graft_entry__.entry()``'s step on its seeded 4096-row input
    (3000 live rows): the packed-lane path with a live mask."""
    import __graft_entry__

    step, args = __graft_entry__.entry()
    rk, rsum, rcnt, rstar, rng_ = jax.jit(step)(*args)
    ng = int(rng_)
    n = int(args[3])
    kd, kv, vd = (_np(a)[:n] for a in args[:3])
    tk, tsum, tcnt, tstar, tng = q5lite.step(
        torch.from_numpy(kd), torch.from_numpy(kv), torch.from_numpy(vd))
    assert tng == ng
    np.testing.assert_array_equal(tk.numpy(), _np(rk)[:ng])
    np.testing.assert_array_equal(tcnt.numpy(), _np(rcnt)[:ng])
    np.testing.assert_array_equal(tstar.numpy(), _np(rstar)[:ng])
    np.testing.assert_allclose(tsum.numpy(), _np(rsum)[:ng], rtol=1e-9,
                               atol=0)


def test_groupby_generic_int64_key_matches_reference():
    """An int64 key of unknown range (q26's path): validity-ranked
    stable sort over the live rows, sum/count/count_star."""
    r = np.random.default_rng(5)
    n = 3000
    key = r.integers(-2**40, 2**40, 300)[r.integers(0, 300, n)]
    kval = r.random(n) > 0.05
    ival = r.integers(-1000, 1000, n).astype(np.int64)
    fval = r.random(n)
    vval = r.random(n) > 0.1
    live = r.random(n) > 0.3
    aggs = (rgb.AggSpec("sum", 1), rgb.AggSpec("count", 1),
            rgb.AggSpec("sum", 2), rgb.AggSpec("count_star"))
    rdtypes = (rdt.INT64, rdt.INT64, rdt.FLOAT64)
    rcols = [(jnp.asarray(key), jnp.asarray(kval)),
             (jnp.asarray(ival), jnp.asarray(vval)),
             (jnp.asarray(fval), None)]
    (rkd, rkv), (rad, rav), rng_ = rgb._groupby(
        rcols, rdtypes, (0,), aggs, jnp.int32(n),
        live_mask=jnp.asarray(live))
    ng = int(rng_)
    taggs = tuple(tgb.AggSpec(a.op, a.ordinal) for a in aggs)
    tcols = [(torch.from_numpy(key), torch.from_numpy(kval)),
             (torch.from_numpy(ival), torch.from_numpy(vval)),
             (torch.from_numpy(fval), None)]
    (tkd, tkv), (tad, tav), tng = tgb._groupby(
        tcols, (tdt.INT64, tdt.INT64, tdt.FLOAT64), (0,), taggs,
        live_mask=torch.from_numpy(live))
    assert tng == ng
    kvalid = _np(rkv[0])[:ng]
    np.testing.assert_array_equal(tkv[0].numpy(), kvalid)
    np.testing.assert_array_equal(tkd[0].numpy()[kvalid],
                                  _np(rkd[0])[:ng][kvalid])
    for i in (0, 1, 3):
        np.testing.assert_array_equal(tad[i].numpy(), _np(rad[i])[:ng])
    np.testing.assert_allclose(tad[2].numpy(), _np(rad[2])[:ng], rtol=1e-9,
                               atol=0)
    for i in (0, 2):
        np.testing.assert_array_equal(tav[i].numpy(), _np(rav[i])[:ng])


# -- the package boundary ----------------------------------------------------


def test_import_leaves_reference_and_host_libraries_out():
    code = ("import sys, spark_rapids_tpu_torch.plan.overrides, "
            "spark_rapids_tpu_torch.execs.fused, "
            "spark_rapids_tpu_torch.benchmarks.tpcxbb, "
            "spark_rapids_tpu_torch.benchmarks.tpcds, "
            "spark_rapids_tpu_torch.benchmarks.tpch, "
            "spark_rapids_tpu_torch.benchmarks.q5lite, "
            "spark_rapids_tpu_torch.benchmarks.profile_query, "
            "spark_rapids_tpu_torch.sql, spark_rapids_tpu_torch.api; "
            "print(sorted(m for m in ('jax', 'spark_rapids_tpu', 'pandas', "
            "'pyarrow') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


@pytest.mark.parametrize("n", [200, 0], ids=["rows", "empty"])
def test_reduce_aggregate_matches_reference(n):
    """Grand aggregates (no keys) over sum, count and count(*), with
    nulls: one row; a sum over no valid rows is null."""
    r = np.random.default_rng(5)
    datas = [r.integers(-50, 50, n).astype(np.int64), r.standard_normal(n)]
    valids = [r.random(n) > 0.3, np.zeros(n, bool)]
    types = ["bigint", "double"]
    aggs = [("sum", 0), ("count", 0), ("count_star", -1), ("sum", 1),
            ("count", 1)]
    rb, rtypes = _reference_batch(datas, types, valids, n)
    want, _ = rgb.reduce_aggregate(rb, [rgb.AggSpec(o, i) for o, i in aggs],
                                   rtypes)
    tb, ttypes = _port_batch(datas, types, valids)
    got, _ = tgb.reduce_aggregate(tb, [tgb.AggSpec(o, i) for o, i in aggs],
                                  ttypes, "cpu")
    assert got.num_rows == 1
    _assert_same_rows(_port_rows(got), _reference_rows(want))
