"""TPCx-BB through the port against the reference engine.

The port's generators (``benchmarks/tpcxbb.py`` and the retail tables of
``benchmarks/tpcds.py``) must give the reference generators' columns
seed for seed, nulls included. Then the reference's q5, q6, q9, q11,
q12, q14, q15, q16, q17, q20, q21, q22 and q23 at sf 0.01, and the two
variants over the 2002 inventory snapshots (``q22_2002``, ``q23_2002``,
the same SQL texts as the port's through the reference's own SQL
factory), each run once by the reference per conf in a module-scoped
fixture: unfused (fusion and adaptive execution off) against the port's
unfused tree, and its default (adaptive execution off) against the
port's default, fused, tree, whose shape (its fused execs and their
steps, ``test_torch_fusion.shape``) must be the reference's. Keys,
strings and counts exact; floats within 1e-9 relative (q15's slope and
intercept within the bound its oracle carries through the cancellation,
``tpcxbb.q15_numpy``); q5, which has no ORDER BY, as a set of rows.
q23_2002 is empty at sf 0.01, so it runs on the rows of its July and
August 2002 snapshots at sf 0.1, in 256-row batches (the standard
deviations merge across batches) and in one. Every query also holds
against its numpy oracle.
"""
from __future__ import annotations

import functools

import numpy as np
import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")

from spark_rapids_tpu.benchmarks import tpcds as rtpcds  # noqa: E402
from spark_rapids_tpu.benchmarks import tpcxbb as rtx  # noqa: E402
from spark_rapids_tpu.config import RapidsConf  # noqa: E402
from spark_rapids_tpu.execs.base import collect as rcollect  # noqa: E402
from spark_rapids_tpu.plan.overrides import (  # noqa: E402
    apply_overrides as rapply)

from spark_rapids_tpu_torch import kernels as tnk  # noqa: E402
from spark_rapids_tpu_torch.benchmarks import tpcds, tpcxbb  # noqa: E402
from spark_rapids_tpu_torch.execs.base import collect  # noqa: E402
from spark_rapids_tpu_torch.io.hoststrings import HostStrings  # noqa: E402
from spark_rapids_tpu_torch.plan.overrides import (  # noqa: E402
    apply_overrides)

SF = 0.01
_UNFUSED = {"rapids.tpu.sql.fusion.enabled": False,
            "rapids.tpu.sql.adaptive.enabled": False}
_FUSED = {"rapids.tpu.sql.adaptive.enabled": False}
_PORT_UNFUSED = {"rapids.tpu.sql.fusion.enabled": False}
_BATCH = "rapids.tpu.sql.reader.batchSizeRows"
_QUERIES = tpcxbb.QUERIES + tpcxbb.VARIANTS
# q23_2002 is empty at sf 0.01: it runs on the sf-0.1 rows below
_SF001 = tuple(q for q in _QUERIES if q != "q23_2002")

# table -> (the port's generator over the shared tables, the reference's)
_GENERATED = {
    **{name: (lambda t, name=name: t[name],
              functools.partial(rtx.GENERATORS[name], SF))
       for name in tpcxbb.GENERATORS},
    **{name: (lambda t, name=name: t[name],
              functools.partial(rtpcds.GENERATORS[name], SF))
       for name in ("store_sales", "item", "web_sales", "web_returns",
                    "store_returns", "inventory", "warehouse", "promotion",
                    "time_dim", "web_page", "store", "customer_address",
                    "household_demographics", "date_dim", "customer")}}


@functools.lru_cache(maxsize=None)
def _tables(sf=SF):
    return tpcxbb.gen_tables(sf)


def _decoded(v):
    """A generated column as the reference's arrow column reads: strings
    decoded, a masked array's nulls None."""
    if isinstance(v, HostStrings):
        return list(v.to_objects())
    if isinstance(v, np.ma.MaskedArray):
        return [None if m else x for x, m in
                zip(np.ma.getdata(v).tolist(), np.ma.getmaskarray(v))]
    return np.asarray(v).tolist()


@pytest.mark.parametrize("table", sorted(_GENERATED))
def test_generators_match_reference(table):
    """Every column the reference generates, in its order, with its
    values, nulls and types (d_date as days since the epoch)."""
    port, ref = _GENERATED[table]
    got, want = port(_tables()), ref()
    names = want.column_names
    if table in ("customer_address", "customer", "date_dim"):
        names = [c for c in names if c in got]  # the columns the port
        # draws: the queries' (the rest are drawn and dropped)
    else:
        assert list(got) == names
    for name in names:
        w = want.column(name)
        if pa.types.is_date(w.type):
            w = pa.array(w.to_numpy(zero_copy_only=False).astype(
                "datetime64[D]").astype(np.int64))
        assert _decoded(got[name]) == w.to_pylist(), name
        g = got[name]
        if not isinstance(g, HostStrings) and name != "d_date":
            assert np.asarray(g).dtype == w.type.to_pandas_dtype(), name


def test_sql_texts_are_the_reference_texts():
    """The port's SQL texts are the reference's (its factories keep the
    text and the views in their closures)."""
    for q in _QUERIES:
        if q in tpcxbb.PLANS or q.endswith("_2002"):
            continue
        factory = rtx.QUERIES[f"tpcxbb_{q}"]
        cells = dict(zip(factory.__code__.co_freevars,
                         (c.cell_contents for c in factory.__closure__)))
        final, views = tpcxbb.SQL[q]
        assert cells["final_sql"] == final, q
        assert list(cells["views"]) == views, q


def _reference_plan(q, data_dir):
    if q.endswith("_2002") or q not in tpcxbb.PLANS:
        final, views = tpcxbb.SQL[q]
        return rtx._sql_query(final, views)(data_dir)
    return rtx.QUERIES[f"tpcxbb_{q}"](data_dir)


@pytest.fixture(scope="module")
def reference_results(tmp_path_factory):
    """query -> conf -> the reference engine's rows; "fused_shape" -> its
    default tree's shape."""
    from test_torch_fusion import shape

    d = str(tmp_path_factory.mktemp("tpcxbb"))
    rtx.write_tables(d, SF, files_per_table=1)
    out = {}
    for q in _SF001:
        res = {"unfused": rcollect(rapply(_reference_plan(q, d),
                                          RapidsConf(_UNFUSED)))}
        fused = rapply(_reference_plan(q, d), RapidsConf(_FUSED))
        res["fused"], res["fused_shape"] = rcollect(fused), shape(fused)
        out[q] = res
    return out


def _column(values):
    """A result column as Python values, null and NaN as None."""
    out = []
    for v in np.asarray(values, dtype=object).tolist():
        if v is None or (isinstance(v, float) and v != v):
            out.append(None)
        else:
            out.append(v)
    return out


def _assert_matches(q, got, want, bounds=None):
    """``got`` (the port's dict) against ``want`` (a frame or a dict)."""
    names = list(want.columns) if hasattr(want, "columns") else list(want)
    assert list(got) == names, q
    cols_g = [_column(got[n]) for n in names]
    cols_w = [_column(want[n].to_numpy() if hasattr(want, "columns")
                      else want[n]) for n in names]
    if q in tpcxbb.UNORDERED:
        def rows(cols):
            return sorted(zip(*cols), key=repr)
        cols_g = [list(c) for c in zip(*rows(cols_g))] or cols_g
        cols_w = [list(c) for c in zip(*rows(cols_w))] or cols_w
    for n, g, w in zip(names, cols_g, cols_w):
        assert len(g) == len(w), (q, n)
        atol = (bounds or {}).get(n)
        for i, (a, b) in enumerate(zip(g, w)):
            if isinstance(a, float) or isinstance(b, float):
                assert (a is None) == (b is None), (q, n, i, a, b)
                if a is not None:
                    tol = 1e-9 * abs(b) + (0.0 if atol is None else atol[i])
                    assert abs(a - b) <= tol, (q, n, i, a, b)
            else:
                assert a == b, (q, n, i, a, b)


@pytest.mark.parametrize("tree", ["unfused", "fused"])
@pytest.mark.parametrize("query", _SF001)
def test_query_matches_reference_engine(reference_results, query, tree):
    """The port's tree against the reference's of the same kind; the
    fused one with the reference's fused execs and steps. On the CPU the
    kernel wrappers run their plain versions: nothing launches."""
    from test_torch_fusion import shape

    t = _tables()
    tnk.reset_launches()
    texec = apply_overrides(tpcxbb.plan(query, t),
                            _PORT_UNFUSED if tree == "unfused" else {},
                            device="cpu")
    got = collect(texec)
    _, bounds = tpcxbb.oracle(query, t)
    _assert_matches(query, got, reference_results[query][tree], bounds)
    assert all(v == 0 for v in tnk.LAUNCHES.values())
    if tree == "fused":
        assert shape(texec) == reference_results[query]["fused_shape"]


@pytest.mark.parametrize("query", _QUERIES)
def test_query_matches_numpy_oracle(query):
    t = _tables()
    want, bounds = tpcxbb.oracle(query, t)
    got = collect(apply_overrides(tpcxbb.plan(query, t), device="cpu"))
    tpcxbb.check(query, got, want, bounds)


@pytest.fixture(scope="module")
def july_august_2002(tmp_path_factory):
    """The sf-0.1 inventory rows of the five July and August 2002
    snapshots (18,000 rows; the only rows q23_2002's join keeps) with
    date_dim: a parquet directory for the reference and the port's
    tables."""
    import pyarrow.parquet as pq

    sf = 0.1
    inv = rtpcds.gen_inventory(sf)
    day = inv.column("inv_date_sk").to_numpy() - tpcxbb.DATE_SK_LO + \
        np.datetime64("1998-01-01")
    keep = (day >= np.datetime64("2002-07-01")) & \
        (day < np.datetime64("2002-09-01"))
    d = tmp_path_factory.mktemp("q23")
    for name, table in (("inventory", inv.filter(pa.array(keep))),
                        ("date_dim", rtpcds.gen_date_dim(sf))):
        (d / name).mkdir()
        pq.write_table(table, str(d / name / "part-000.parquet"))
    t = dict(_tables(sf))
    t["inventory"] = {k: v[keep] for k, v in t["inventory"].items()}
    return str(d), t


@pytest.mark.parametrize("batch_rows, tree", [(256, "unfused"),
                                               (1 << 21, "fused")])
def test_moments_across_batches_match_reference(july_august_2002,
                                                batch_rows, tree):
    """q23_2002's standard deviations over those rows: every group's
    rows in five batches of 256 rows (the merge adds m2 and rterm per
    batch) on the unfused trees, in one batch on the default ones;
    against the reference at the same batch size, and the oracle."""
    d, t = july_august_2002
    conf = {_BATCH: batch_rows}
    want, _ = tpcxbb.oracle("q23_2002", t)
    assert len(want["cov"]) > 0
    rconf, pconf = (_UNFUSED, _PORT_UNFUSED) if tree == "unfused" else \
        (_FUSED, {})
    ref = rcollect(rapply(_reference_plan("q23_2002", d),
                          RapidsConf({**rconf, **conf})))
    got = collect(apply_overrides(tpcxbb.plan("q23_2002", t),
                                  {**pconf, **conf}, device="cpu"))
    _assert_matches("q23_2002", got, ref)
    tpcxbb.check("q23_2002", got, want)


def test_verbatim_q22_q23_are_empty_and_variants_are_not():
    """The reference's q22 and q23 select a 2001 window that holds one
    inventory snapshot (2001-05-03), so they are empty at every scale;
    their 2002 variants keep rows (q23_2002 from sf 0.1)."""
    t = _tables()
    for q in ("q22", "q23"):
        assert len(tpcxbb.oracle(q, t)[0]["inv_warehouse_sk" if q == "q23"
                                           else "i_item_id"]) == 0
    assert len(tpcxbb.oracle("q22_2002", t)[0]["i_item_id"]) > 0
    week = tpcds.gen_inventory(SF)["inv_date_sk"]
    days = np.unique(week) - tpcxbb.DATE_SK_LO + np.datetime64("1998-01-01")
    assert [str(x) for x in days if str(x).startswith("2001")] == \
        ["2001-05-03"]
