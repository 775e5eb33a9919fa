"""The port's group-by ops, dense path and distinct rewrite against the
reference's.

The same seeded numpy columns go through spark_rapids_tpu (JAX on the
CPU) and spark_rapids_tpu_torch on the CPU: min, max, first, last,
any_valid, count and sum over ints, floats with NaN, -0.0 and nulls, and
strings, per group of a numeric key (the sort path), of a string key (the
dense path) and of a string key past 128 slots (the packed sort path),
with one group whose values are all null. Keys, counts, ints and strings
exact, floats within 1e-9 relative. Then the grand reductions, the
boundary between the two paths, and ``rewrite_distinct_aggregates``:
the reference's plan shape and its results.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from spark_rapids_tpu.config import RapidsConf  # noqa: E402
from spark_rapids_tpu.execs.base import collect as rcollect  # noqa: E402
from spark_rapids_tpu.expressions import aggregates as RA  # noqa: E402
from spark_rapids_tpu.expressions.base import (  # noqa: E402
    BoundReference as RRef)
from spark_rapids_tpu.ops import groupby as rgb  # noqa: E402
from spark_rapids_tpu.plan import nodes as rpn  # noqa: E402
from spark_rapids_tpu.plan.optimizer import (  # noqa: E402
    rewrite_distinct_aggregates as rrewrite)
from spark_rapids_tpu.plan.overrides import (  # noqa: E402
    apply_overrides as rapply)

from spark_rapids_tpu_torch.columnar import dtypes as tdt  # noqa: E402
from spark_rapids_tpu_torch.columnar.column import HostRange  # noqa: E402
from spark_rapids_tpu_torch.execs.base import collect  # noqa: E402
from spark_rapids_tpu_torch.expressions import aggregates as TA  # noqa: E402
from spark_rapids_tpu_torch.expressions.base import (  # noqa: E402
    BoundReference as TRef)
from spark_rapids_tpu_torch.ops import groupby as tgb  # noqa: E402
from spark_rapids_tpu_torch.plan import nodes as pn  # noqa: E402
from spark_rapids_tpu_torch.plan.optimizer import (  # noqa: E402
    rewrite_distinct_aggregates)
from spark_rapids_tpu_torch.plan.overrides import (  # noqa: E402
    apply_overrides)
from tests.test_torch_ops import _port_batch, _reference_batch  # noqa: E402

_TYPES = ["bigint", "string", "string", "bigint", "double", "string"]
_VALUES = (3, 4, 5)  # the aggregated columns
_OPS = ("min", "max", "first", "last", "any_valid", "count")


def _columns(n=400, seed=11):
    """A numeric key, a string key of 6 values and one of 300, then an
    int, a float (NaN, -0.0, subnormal, infinities) and a string column,
    each with nulls; every value of key group 3 (of the numeric key) and
    of "k2" (of the small string key) is null."""
    r = np.random.default_rng(seed)
    key = r.integers(0, 12, n).astype(np.int64)
    small = np.array([f"k{i}" for i in r.integers(0, 6, n)], dtype=object)
    wide = np.array([f"w{i:03d}" for i in r.integers(0, 300, n)],
                    dtype=object)
    ints = r.integers(-10**12, 10**12, n).astype(np.int64)
    floats = r.standard_normal(n) * 10.0 ** r.integers(-3, 3, n)
    floats[r.integers(0, n, 12)] = np.nan
    floats[r.integers(0, n, 12)] = -0.0
    floats[:4] = [np.inf, -np.inf, 1e-310, -0.0]
    words = np.array([f"v{i}" for i in r.integers(0, 50, n)], dtype=object)
    dead = (key == 3) | (small == "k2")
    valids = [r.random(n) > 0.1, None, None] + \
        [(r.random(n) > 0.2) & ~dead for _ in range(3)]
    words[~valids[5]] = None  # a string's null is None in its data
    valids[5] = None
    return [key, small, wide, ints, floats, words], valids


def _decode(col, n):
    """(values, validity) of a column's first ``n`` rows, strings
    decoded."""
    data = np.array(jax.device_get(col.data))[:n] if not \
        isinstance(col.data, torch.Tensor) else col.data.numpy()[:n]
    v = col.validity
    valid = np.ones(n, bool) if v is None else (
        v.numpy()[:n] if isinstance(v, torch.Tensor)
        else np.array(jax.device_get(v))[:n])
    dic = getattr(col, "dictionary", None)
    if dic is not None:
        dic = np.asarray(dic, dtype=object)
        data = np.array([dic[c] if ok else None
                         for c, ok in zip(data, valid)], dtype=object)
    return data, valid


def _assert_columns_equal(got, want, n, words=None):
    """``words``: the dictionary of the string input, for a reference
    column that lost it (its grand reductions return bare codes)."""
    for i, (gc, wc) in enumerate(zip(got.columns, want.columns)):
        gd, gv = _decode(gc, n)
        wd, wv = _decode(wc, n)
        if gd.dtype == object and wd.dtype != object:
            wd = np.array([words[c] if ok else None
                           for c, ok in zip(wd, wv)], dtype=object)
        np.testing.assert_array_equal(gv, wv, err_msg=f"column {i}")
        if gd.dtype.kind == "f":
            np.testing.assert_allclose(gd[gv], wd[wv], rtol=1e-9, atol=0)
        else:
            assert list(gd[gv]) == list(wd[wv])


def _specs(mod, ops=_OPS):
    specs = [mod.AggSpec(op, o) for o in _VALUES for op in ops]
    specs += [mod.AggSpec("sum", 3), mod.AggSpec("sum", 4),
              mod.AggSpec("count_star")]
    return specs


@pytest.mark.parametrize("key", [0, 1, 2],
                         ids=["int_key_sort", "string_key_dense",
                              "string_key_300_slots"])
def test_groupby_ops_match_reference(key):
    datas, valids = _columns()
    n = len(datas[0])
    rb, rtypes = _reference_batch(datas, _TYPES, valids, n)
    want, _ = rgb.groupby_aggregate(rb, [key], _specs(rgb), rtypes)
    tb, ttypes = _port_batch(datas, _TYPES, valids)
    got, _ = tgb.groupby_aggregate(tb, [key], _specs(tgb), ttypes)
    ng = int(jax.device_get(want.num_rows_device()))
    assert got.num_rows == ng
    _assert_columns_equal(got, want, ng)
    dense = tgb._dense_layout(ttypes, [key], (tgb.key_range_of(
        tb.columns[key], ttypes[key]),), (tb.columns[key].validity
                                          is not None,))
    assert (dense is not None) == (key == 1)


@pytest.mark.parametrize("n", [400, 0], ids=["rows", "empty"])
def test_reduce_aggregate_new_ops_match_reference(n):
    """Grand min, max, first and last against the reference's
    ``reduce_aggregate``; any_valid against the first valid value, as
    the reference's group-by and its CPU oracle take it (its whole-batch
    reduction takes the first row's value even when that row is null)."""
    datas, valids = _columns()
    datas = [d[:n] for d in datas]
    valids = [None if v is None else v[:n] for v in valids]
    valids[3] = valids[3].copy()
    if n:
        valids[3][0] = False  # the first row's int is null
    ops = ("min", "max", "first", "last")
    rb, rtypes = _reference_batch(datas, _TYPES, valids, n)
    want, _ = rgb.reduce_aggregate(rb, _specs(rgb, ops), rtypes)
    tb, ttypes = _port_batch(datas, _TYPES, valids)
    got, _ = tgb.reduce_aggregate(tb, _specs(tgb, ops), ttypes, "cpu")
    assert got.num_rows == 1
    _assert_columns_equal(got, want, 1, rb.columns[5].dictionary)
    got, _ = tgb.reduce_aggregate(tb, [tgb.AggSpec("any_valid", o)
                                       for o in _VALUES], ttypes, "cpu")
    for o, col in zip(_VALUES, got.columns):
        ok = np.ones(n, bool) if valids[o] is None else valids[o]
        ok = ok & np.array([x is not None for x in datas[o]], dtype=bool)
        data, valid = _decode(col, 1)
        assert valid[0] == ok.any()
        if ok.any():
            assert data[0] == datas[o][np.argmax(ok)]


@pytest.mark.parametrize("slots", [128, 129])
def test_dense_and_sort_paths_agree_at_the_boundary(slots):
    """A string key of 128 values packs into 128 slots (the dense path);
    with nulls it needs 129 (the sort path). Both equal the reference,
    and at both sizes the dense sweep and the sort give the same groups."""
    r = np.random.default_rng(3)
    n = 2000
    key = np.array([f"g{i:03d}" for i in r.integers(0, 128, n)],
                   dtype=object)
    vals = r.standard_normal(n)
    ints = r.integers(-100, 100, n).astype(np.int64)
    if slots == 129:
        key[r.random(n) < 0.05] = None  # a string's null is None
    datas, types = [key, vals, ints], ["string", "double", "bigint"]
    valids = [None, r.random(n) > 0.1, None]
    specs = [("sum", 1), ("min", 1), ("max", 2), ("first", 1), ("last", 2),
             ("count", 1), ("count_star", -1), ("sum", 2)]
    rb, rtypes = _reference_batch(datas, types, valids, n)
    want, _ = rgb.groupby_aggregate(rb, [0], [rgb.AggSpec(*s)
                                              for s in specs], rtypes)
    tb, ttypes = _port_batch(datas, types, valids)
    tspecs = [tgb.AggSpec(*s) for s in specs]
    got, _ = tgb.groupby_aggregate(tb, [0], tspecs, ttypes)
    ng = int(jax.device_get(want.num_rows_device()))
    _assert_columns_equal(got, want, ng)
    cols = [(c.data, c.validity) for c in tb.columns]
    ranges = (tgb.key_range_of(tb.columns[0], ttypes[0]),)
    layout = tgb._dense_layout(ttypes, [0], ranges,
                               (tb.columns[0].validity is not None,))
    assert (layout is not None) == (slots == 128)
    sort = tgb._groupby(cols, tuple(ttypes), (0,), tuple(tspecs),
                        key_ranges=ranges)
    if layout is not None:
        dense = tgb._dense_groupby(cols, ttypes, [0], tspecs, None, layout)
        assert dense[2] == sort[2] == ng
        for part in (0, 1):
            for a, b in zip(dense[part][0] + dense[part][1],
                            sort[part][0] + sort[part][1]):
                if a is None or b is None:
                    assert a is None and b is None
                elif a.is_floating_point():
                    np.testing.assert_allclose(a.numpy(), b.numpy(),
                                               rtol=1e-9, atol=0)
                else:
                    assert torch.equal(a, b)


# -- the sort path's segmented sum -------------------------------------------


def _group_sizes(case, r):
    """Group sizes by case: every group one row; one to eight rows (one
    piece each); groups past 64 rows beside short ones (three levels of
    pieces)."""
    if case == "one_row":
        return np.ones(3000, dtype=np.int64)
    if case == "short":
        return r.integers(1, 9, 2000).astype(np.int64)
    return np.concatenate([r.integers(1, 9, 300), [600, 65, 1],
                           r.integers(9, 200, 40)]).astype(np.int64)


@pytest.mark.parametrize("case", ["one_row", "short", "long"])
def test_seg_sum_matches_reference_seg_scan(case):
    """``kernels.groupby.seg_sum`` (its plain version on the CPU) over two
    columns against the reference's segmented scan at each group's last
    row: positive values within 1e-12 relative (the two add in different
    orders), and an Inf and a NaN stay in their groups."""
    import jax.numpy as jnp

    from spark_rapids_tpu_torch.kernels import groupby as kgb

    r = np.random.default_rng(len(case))
    sizes = _group_sizes(case, r)
    starts = np.r_[0, np.cumsum(sizes)[:-1]]
    n = int(sizes.sum())
    x = r.random((n, 2)) * 10.0 ** r.integers(-3, 4, (n, 2))
    x[starts[1], 0], x[starts[-1], 1] = np.inf, np.nan
    boundary = np.zeros((n, 1), dtype=bool)
    boundary[starts] = True
    got = kgb.seg_sum(torch.from_numpy(x), torch.from_numpy(starts),
                      torch.from_numpy(sizes)).numpy()
    scan = jax.jit(lambda v, b: rgb._seg_scan(v, b, jnp.add))
    want = np.asarray(scan(jnp.asarray(x), jnp.asarray(boundary)))
    np.testing.assert_allclose(got, want[starts + sizes - 1], rtol=1e-12,
                               atol=0)
    assert np.isinf(got[1, 0]) and np.isnan(got[-1, 1])
    assert np.isfinite(got[:, 0]).sum() == len(sizes) - 1
    # a group of at most eight rows sums in row order
    for g in np.flatnonzero(sizes <= 8)[:50]:
        acc = x[starts[g], 0]
        for i in range(starts[g] + 1, starts[g] + sizes[g]):
            acc = acc + x[i, 0]
        assert got[g, 0] == acc or g == 1


def test_seg_sum_and_seg_reduce_take_no_longest():
    """The folds find each group's levels themselves: no ``longest``
    (on the card that was a read of the device each batch)."""
    import inspect

    from spark_rapids_tpu_torch.kernels import groupby as kgb

    assert list(inspect.signature(kgb.seg_sum).parameters) == \
        ["x", "starts", "sizes"]
    assert list(inspect.signature(kgb.seg_reduce).parameters) == \
        ["x", "starts", "sizes", "op"]
    x = torch.tensor([3.0, -1.0, 2.0, 7.0], dtype=torch.float64)
    starts = torch.tensor([0, 1], dtype=torch.int64)
    sizes = torch.tensor([1, 3], dtype=torch.int64)
    with pytest.raises(TypeError):
        kgb.seg_sum(x, starts, sizes, 3)
    assert kgb.seg_sum(x, starts, sizes).tolist() == [3.0, 8.0]
    assert kgb.seg_reduce(x, starts, sizes, "min").tolist() == [3.0, -1.0]
    assert kgb.seg_reduce(x.to(torch.int32), starts, sizes,
                          "max").tolist() == [3, 7]


# -- C5: the sign of a zero in float aggregates -------------------------------

# Groups of one double column. The reference's dense path and grand
# reduction sum from +0.0 and order -0.0 below +0.0 in min and max; its
# sort path gives +0.0 for every zero result (each output of its
# segmented scans passes through a + 0.0). -1e-310 counts as -0.0 (C1).
_C5_GROUPS = {
    "neg_zero": [-0.0],
    "neg_zeros": [-0.0, -0.0],
    "neg_zero_neg_subnormal": [-0.0, -1e-310],
    "zero_neg_zero": [0.0, -0.0],
    "neg_zero_zero": [-0.0, 0.0],
    "zeros_five": [0.0, -0.0, 5.0],
    "neg_zeros_one": [-0.0, -0.0, 1.0],
    "subnormal_neg_zero": [1e-310, -0.0],
}
_C5_AGGS = "sum(d) AS s, min(d) AS lo, max(d) AS hi, min(f) AS flo, " \
    "max(f) AS fhi"


def _c5_tables():
    """Name -> columns: ``t_dense`` (a string key, 8 slots: the dense
    path), ``t_sort`` (an integer key plus a row of key 100000: past 128
    slots, the sort path) and one keyless table per group."""
    names = sorted(_C5_GROUPS)
    d = np.concatenate([_C5_GROUPS[g] for g in names])
    which = np.concatenate([[i] * len(_C5_GROUPS[g])
                            for i, g in enumerate(names)])
    tables = {"t_dense": {"k": np.array([f"g{i}" for i in which],
                                        dtype=object), "d": d},
              "t_sort": {"k": np.r_[which, 100000].astype(np.int64),
                         "d": np.r_[d, 1.0]}}
    for i, g in enumerate(names):
        tables[f"t{i}"] = {"d": np.array(_C5_GROUPS[g])}
    # C6: numeric keys with upload statistics, the groups in key order
    tables["t_int"] = {"k": which.astype(np.int64), "d": d}
    tables["t_wide"] = {"k": which.astype(np.int64) * 1000 - 3000, "d": d}
    tables["t_date"] = {"k": (which + 19000).astype(np.int32), "d": d}
    for cols in tables.values():
        cols["f"] = cols["d"].astype(np.float32)
    return tables


# C6: path -> the query over numeric keys (the reference reads their
# upload statistics: a small range takes its dense path, a wide one its
# packed sort path)
_C6_QUERIES = {
    "int_scan": "SELECT k, {aggs} FROM t_int GROUP BY k ORDER BY k",
    "int_projected": "SELECT k, {aggs} FROM (SELECT k, d, f FROM t_int) x "
                     "GROUP BY k ORDER BY k",
    "int_filtered": "SELECT k, {aggs} FROM t_int WHERE k < 100 "
                    "GROUP BY k ORDER BY k",
    "int64_wide": "SELECT k, {aggs} FROM t_wide GROUP BY k ORDER BY k",
    "date": "SELECT k, {aggs} FROM t_date GROUP BY k ORDER BY k",
}


@pytest.fixture(scope="module")
def c5_results():
    """(path, group) -> (reference row, port row), each aggregate as a
    bit pattern; one reference and one port session for all cases."""
    from spark_rapids_tpu.api import Session as RSession

    from spark_rapids_tpu_torch.api import Session

    from spark_rapids_tpu.columnar import dtypes as rdt
    from spark_rapids_tpu.columnar.batch import Schema as RSchema

    from spark_rapids_tpu_torch.columnar.batch import Schema

    rs, s = RSession(), Session(device="cpu")
    for name, cols in _c5_tables().items():
        names = list(cols)
        types = [tdt.DATE if name == "t_date" and c == "k" else
                 tdt.from_numpy(cols[c].dtype) for c in names]
        rs.create_temp_view(name, rpn.InMemorySource(dict(cols), RSchema(
            names, [rdt.by_name(t.name) for t in types])))
        s.create_temp_view(name, pn.InMemorySource(dict(cols),
                                                   Schema(names, types)))
    names = sorted(_C5_GROUPS)
    out = {}

    def bits(frame, i):
        return [("nan",) if np.isnan(frame[c][i]) else
                ("f", np.asarray(frame[c][i], np.float64).view(np.int64))
                for c in frame if c != "k"]

    def run(text):
        want = rs.sql(text).collect()
        return ({c: want[c].to_numpy() for c in want.columns},
                {c: np.asarray(v) for c, v in s.sql(text).collect().items()})

    queries = {path: f"SELECT k, {{aggs}} FROM t_{path} GROUP BY k "
                     f"ORDER BY k" for path in ("dense", "sort")}
    for path, text in {**queries, **_C6_QUERIES}.items():
        want, got = run(text.format(aggs=_C5_AGGS))
        for i, g in enumerate(names):
            out[path, g] = bits(want, i), bits(got, i)
    for i, g in enumerate(names):  # an average too: a grand query is cheap
        want, got = run(f"SELECT {_C5_AGGS}, avg(d) AS a FROM t{i}")
        out["grand", g] = bits(want, 0), bits(got, 0)
    return out


@pytest.mark.parametrize("group", sorted(_C5_GROUPS))
@pytest.mark.parametrize("path", ["dense", "sort", "grand"] +
                         list(_C6_QUERIES))
def test_zero_signs_of_float_aggregates_match_reference_engine(
        c5_results, path, group):
    """sum, min and max of a double column (and its avg with no key) and
    min and max of a float column, bit for bit against the reference
    engine (C5); and per numeric key (C6): a small-range integer key
    straight from the scan, through a bare projection and after a filter
    (dense in the reference, from its upload statistics), an int64 key
    whose range passes 128 slots (its packed sort path) and a DATE
    key."""
    want, got = c5_results[path, group]
    assert got == want


# -- C6: numeric keys with statistics on the dense path -----------------------

# key type -> (values, a null every k-th row or 0): negative ranges, int8
# to int64 and DATE, each packing into at most 128 slots with its nulls
_C6_KEYS = {"tinyint_negative": ("tinyint", -40, -10, 7),
            "int_nulls": ("int", 0, 30, 5),
            "bigint": ("bigint", 2**40, 2**40 + 90, 0),
            "bigint_negative_nulls": ("bigint", -2**50 - 30, -2**50, 3),
            "date": ("date", -400, -370, 11)}


@pytest.mark.parametrize("case", sorted(_C6_KEYS))
def test_numeric_key_dense_path_matches_reference(case):
    """A numeric key whose (min, max) is known packs into slots on the
    dense path in both engines: every op, exact against the reference
    (float sums within 1e-9, their order being outside the contract)."""
    t, lo, hi, null_every = _C6_KEYS[case]
    datas, valids = _columns(n=500, seed=4)
    r = np.random.default_rng(12)
    key = r.integers(lo, hi + 1, 500).astype(tdt.by_name(t).np_dtype)
    kv = None if not null_every else np.arange(500) % null_every != 0
    types = [t] + _TYPES[1:]
    rb, rtypes = _reference_batch([key] + datas[1:], types,
                                  [kv] + valids[1:], 500)
    live = key if kv is None else key[kv]
    rb.columns[0].stats = (int(live.min()), int(live.max()))
    tb, ttypes = _port_batch([key] + datas[1:], types, [kv] + valids[1:])
    tb.columns[0].stats = HostRange(tb.columns[0].data,
                                    tb.columns[0].validity)
    want, _ = rgb.groupby_aggregate(rb, [0], _specs(rgb), rtypes)
    calls = []
    orig = tgb._dense_groupby
    tgb._dense_groupby = lambda *a: calls.append(1) or orig(*a)
    try:
        got, _ = tgb.groupby_aggregate(tb, [0], _specs(tgb), ttypes)
    finally:
        tgb._dense_groupby = orig
    assert calls == [1]
    ng = int(jax.device_get(want.num_rows_device()))
    assert got.num_rows == ng
    _assert_columns_equal(got, want, ng)


# Where does a numeric key take the dense path? Seen through C5: a min of
# -0.0 stays -0.0 on the dense path and is +0.0 on the sort path. Every
# table comes from a scan, so its integer and DATE columns carry
# statistics; ``z`` is -0.0 on every row.
_C6_PATHS = [
    "SELECT k, min(z) AS m FROM a GROUP BY k",
    "SELECT k, min(z) AS m FROM (SELECT k, z FROM a) x GROUP BY k",
    "SELECT k, min(z) AS m FROM a WHERE v > 0.0 GROUP BY k",
    "SELECT k, min(z) AS m FROM a WHERE s = 'x' GROUP BY k",
    "SELECT k, min(z) AS m FROM (SELECT k, z FROM a WHERE v > 0.0) x "
    "GROUP BY k",
    "SELECT k2, min(z) AS m FROM (SELECT k + 1 AS k2, z FROM a) x "
    "GROUP BY k2",
    "SELECT k2, min(z) AS m FROM (SELECT k * 1000 AS k2, z FROM a) x "
    "GROUP BY k2",
    "SELECT k2, min(z) AS m FROM (SELECT CAST(k AS int) AS k2, z FROM a) x "
    "GROUP BY k2",
    "SELECT y, min(z) AS m FROM (SELECT year(dt) AS y, z FROM a) x "
    "GROUP BY y",
    "SELECT k2, min(z) AS m FROM (SELECT k + 1 AS k2, substring(s, 1, 1) "
    "AS c, z FROM a) x GROUP BY k2",
    "SELECT a.k, min(b.w) AS m FROM a JOIN b ON a.k = b.k GROUP BY a.k",
    "SELECT wide, min(z) AS m FROM a GROUP BY wide",
    "SELECT k, dt, min(z) AS m FROM a GROUP BY k, dt",
    "SELECT p, min(z) AS m FROM (SELECT pmod(wide, 4) AS p, z FROM a) x "
    "GROUP BY p",
    "SELECT p, min(z) AS m FROM (SELECT pmod(wide, -4) AS p, z FROM a) x "
    "GROUP BY p",
]


@pytest.fixture(scope="module")
def c6_paths():
    """query -> (the reference's signs of min, the port's), one session
    each; both exec trees unfused (with fusion on, the default, the
    statistics also survive a string filter, a projection over a filter
    and a join's stream side: ROADMAP C7, ``tests/test_torch_fusion.py``)."""
    from spark_rapids_tpu.api import Session as RSession
    from spark_rapids_tpu.columnar import dtypes as rdt
    from spark_rapids_tpu.columnar.batch import Schema as RSchema

    from spark_rapids_tpu_torch.api import Session
    from spark_rapids_tpu_torch.columnar.batch import Schema

    r = np.random.default_rng(6)
    n = 300
    a = {"k": r.integers(-5, 20, n).astype(np.int64),
         "v": r.standard_normal(n), "z": np.full(n, -0.0),
         "s": np.array(["x", "y"], dtype=object)[r.integers(0, 2, n)],
         "dt": r.integers(9000, 9060, n).astype(np.int32),
         "wide": r.integers(0, 5000, n).astype(np.int64)}
    b = {"k": np.arange(-5, 20, dtype=np.int64), "w": np.full(25, -0.0)}
    types = {"k": tdt.INT64, "v": tdt.FLOAT64, "z": tdt.FLOAT64,
             "s": tdt.STRING, "dt": tdt.DATE, "wide": tdt.INT64,
             "w": tdt.FLOAT64}
    rs = RSession({"rapids.tpu.sql.fusion.enabled": False,
                   "rapids.tpu.sql.adaptive.enabled": False})
    s = Session({"rapids.tpu.sql.fusion.enabled": False}, device="cpu")
    for name, cols in (("a", a), ("b", b)):
        names = list(cols)
        ts = [types[c] for c in names]
        rs.create_temp_view(name, rpn.InMemorySource(dict(cols), RSchema(
            names, [rdt.by_name(t.name) for t in ts])))
        s.create_temp_view(name, pn.InMemorySource(dict(cols),
                                                   Schema(names, ts)))
    return {text: (np.signbit(rs.sql(text).collect()["m"].to_numpy())
                   .tolist(),
                   np.signbit(np.asarray(s.sql(text).collect()["m"],
                                         np.float64)).tolist())
            for text in _C6_PATHS}


@pytest.mark.parametrize("case", range(len(_C6_PATHS)))
def test_numeric_key_takes_dense_path_where_reference_does(c6_paths, case):
    """A numeric key takes the dense path in the port exactly where the
    reference's does (a min of -0.0 is -0.0 there, +0.0 on the sort
    path): straight from the scan, through a projection of device-only
    expressions (a reference, a cast, ``+ - *`` by an integer literal,
    ``year``, ``pmod`` by a positive literal, even of a key past 128
    slots), after a device-only filter the aggregate takes as a live
    mask; not after a string predicate, a filter below a projection, a
    projection with a string function or a join, nor past 128 slots."""
    want, got = c6_paths[_C6_PATHS[case]]
    assert len(got) == len(want) > 0
    assert got == want


def test_sort_path_any_valid_zero_sign_matches_reference():
    """The sort path's any_valid rides the same segmented scan, so a
    -0.0 there is +0.0 as well; first keeps the row's -0.0 (C5)."""
    k = np.array([0, 0, 1, 2, 2], dtype=np.int64)
    d = np.array([-0.0, 1.0, -1e-310, 0.0, -0.0])
    valid = np.array([True, True, True, False, True])
    types = ["bigint", "double"]
    specs = [("any_valid", 1), ("first", 1), ("last", 1)]
    rb, rtypes = _reference_batch([k, d], types, [None, valid], len(k))
    want, _ = rgb.groupby_aggregate(rb, [0], [rgb.AggSpec(*a)
                                              for a in specs], rtypes)
    tb, ttypes = _port_batch([k, d], types, [None, valid])
    got, _ = tgb.groupby_aggregate(tb, [0], [tgb.AggSpec(*a)
                                             for a in specs], ttypes)
    for i in range(1, 4):
        gd, gv = _decode(got.columns[i], 3)
        wd, wv = _decode(want.columns[i], 3)
        np.testing.assert_array_equal(gv, wv)
        assert gd[gv].view(np.int64).tolist() == \
            wd[wv].view(np.int64).tolist(), specs[i - 1]


# -- count(DISTINCT) ----------------------------------------------------------


def _agg_plans(mod, ref, fns, grouped):
    """One AggregateNode over (k, x, v) with ``fns`` as
    (class name, input ordinal, distinct)."""
    calls = []
    for i, (name, o, distinct) in enumerate(fns):
        cls = getattr(mod, name)
        args = [] if o is None else [ref(o, _DIST_T[o])]
        fn = cls(*args, distinct=distinct) if name in ("Count", "Sum") \
            else cls(*args)
        calls.append((fn, f"a{i}"))
    return calls


def _shape(node):
    """The plan as (node type, grouping count, [(fn, distinct)...])
    nested."""
    aggs = getattr(node, "aggs", [])
    return (type(node).__name__, len(getattr(node, "grouping", [])),
            [(type(a.fn).__name__, bool(getattr(a.fn, "distinct", False)))
             for a in aggs], [_shape(c) for c in node.children])


_DIST_T = {}
_DISTINCT_CASES = {
    "with_plain": ([("Count", 1, True), ("Sum", 2, False), ("Count", None,
                                                            False),
                    ("Average", 2, False), ("Min", 2, False),
                    ("Max", 1, False), ("Sum", 1, True)], True),
    "ungrouped": ([("Count", 1, True), ("Count", 2, False),
                   ("Sum", 2, False)], False),
}


@pytest.mark.parametrize("case", sorted(_DISTINCT_CASES))
def test_rewrite_distinct_aggregates_matches_reference(case):
    from spark_rapids_tpu.columnar import dtypes as rdt

    fns, grouped = _DISTINCT_CASES[case]
    r = np.random.default_rng(9)
    n = 300
    cols = {"k": r.integers(0, 7, n).astype(np.int64),
            "x": r.integers(0, 20, n).astype(np.int64),
            "v": np.round(r.random(n) * 100, 2)}
    valid = {"x": r.random(n) > 0.1, "v": r.random(n) > 0.2}
    plans = []
    for mod, nodes, ref, dtm in ((RA, rpn, RRef, rdt), (TA, pn, TRef, tdt)):
        _DIST_T.update({0: dtm.INT64, 1: dtm.INT64, 2: dtm.FLOAT64})
        scan = nodes.ScanNode(nodes.InMemorySource(dict(cols),
                                                   validity=valid))
        calls = [nodes.AggCall(fn, name)
                 for fn, name in _agg_plans(mod, ref, fns, grouped)]
        plans.append(nodes.AggregateNode(
            [ref(0, dtm.INT64)] if grouped else [], calls, scan,
            grouping_names=["k"] if grouped else None))
    rplan, tplan = plans
    assert _shape(rewrite_distinct_aggregates(tplan)) == \
        _shape(rrewrite(rplan))
    want = rcollect(rapply(rplan, RapidsConf()))
    got = collect(apply_overrides(
        tplan, {"rapids.tpu.sql.reader.batchSizeRows": 64}, device="cpu"))
    assert list(got) == list(want.columns)
    order = np.argsort(got["k"], kind="stable") if grouped else [0]
    worder = np.argsort(want["k"].to_numpy(), kind="stable") \
        if grouped else [0]
    for name in want.columns:
        w = want[name].to_numpy()[worder]
        g = np.asarray(got[name])[order]
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(np.float64), w, rtol=1e-9)
        else:
            assert list(g) == list(w), name


def test_multi_distinct_is_refused():
    scan = pn.ScanNode(pn.InMemorySource({
        "k": np.arange(4, dtype=np.int64), "x": np.arange(4, dtype=np.int64),
        "y": np.arange(4, dtype=np.int64)}))
    node = pn.AggregateNode(
        [], [pn.AggCall(TA.Count(TRef(1, tdt.INT64), distinct=True), "a"),
             pn.AggCall(TA.Count(TRef(2, tdt.INT64), distinct=True), "b")],
        scan)
    with pytest.raises(NotImplementedError, match="more than one input"):
        apply_overrides(node, device="cpu")


def test_first_last_min_max_aggregates_match_reference_engine():
    """``First`` (with and without ignoring nulls), ``Last``, ``Min`` and
    ``Max`` through the aggregate exec, the port in 64-row batches (each
    merge keeps the running partial's first and the new part's last),
    against the reference engine in one."""
    from spark_rapids_tpu.columnar import dtypes as rdt

    r = np.random.default_rng(4)
    n = 500
    cols = {"k": r.integers(0, 9, n).astype(np.int64),
            "x": np.round(r.standard_normal(n) * 100, 2)}
    valid = {"x": r.random(n) > 0.3}
    outs = []
    for mod, nodes, ref, dtm, conf, run in (
            (RA, rpn, RRef, rdt, RapidsConf(),
             lambda p, c: rcollect(rapply(p, c))),
            (TA, pn, TRef, tdt, {"rapids.tpu.sql.reader.batchSizeRows": 64},
             lambda p, c: collect(apply_overrides(p, c, device="cpu")))):
        x = ref(1, dtm.FLOAT64)
        calls = [nodes.AggCall(fn, name) for fn, name in (
            (mod.First(x), "f"), (mod.First(x, ignore_nulls=True), "fv"),
            (mod.Last(x), "l"), (mod.Min(x), "lo"), (mod.Max(x), "hi"))]
        plan = nodes.AggregateNode([ref(0, dtm.INT64)], calls, nodes.ScanNode(
            nodes.InMemorySource(dict(cols), validity=valid)),
            grouping_names=["k"])
        outs.append(run(plan, conf))
    want, got = outs
    order = np.argsort(want["k"].to_numpy(), kind="stable")
    assert list(got["k"]) == list(want["k"].to_numpy()[order])
    for name in ("f", "fv", "l", "lo", "hi"):
        w, g = (np.array([np.nan if v is None else v for v in c],
                         dtype=np.float64)
                for c in (want[name].to_numpy()[order], got[name]))
        np.testing.assert_array_equal(g, w, err_msg=name)
