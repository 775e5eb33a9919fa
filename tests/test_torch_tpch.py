"""The 22 TPC-H queries through the port against the reference engine.

The port's numpy generators must give the reference generators' columns
seed for seed, on the whole-table path and on the chunked one (string
columns come as ``HostStrings`` and are decoded to compare). The port's
queries (apply_overrides -> collect on the CPU) must equal the reference
engine's, run from the reference's own query functions over parquet
written from the reference's generators. q14 and q22 run the reference
twice: with fusion and adaptive execution off and the native kernels on
(against the port's unfused tree), and with the default conf (against
the port's default, fused, tree). The others run it unfused, on its
default plain path, against the port's unfused tree at 256-row scan
batches (2,048 for the ten queries that need `Year`, `Cast` or the
generators' last columns), so many batches share one dictionary (and
the aggregates merge many partials: q21's distinct counts, q18's sums),
and with its default fusion (adaptive execution off) against the port's
default tree at the same batches. The fused trees have the reference's
shape (the fused execs and their steps, ``test_torch_fusion.shape``).
Strings, keys and counts exact, float sums within 1e-9 relative (the
reference's own tolerance against its CPU oracle; the two engines sum in
different orders).

At sf 0.01 every customer has an order, so q22 is empty; it runs again
over the first 10% of the orders rows, where the anti join keeps rows and
the group-by, sort and average run on real data. A small scan batch size
splits every scan into many batches.
"""
from __future__ import annotations

import functools

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

from spark_rapids_tpu.benchmarks import datagen as rdatagen  # noqa: E402
from spark_rapids_tpu.benchmarks import tpch as rtpch  # noqa: E402
from spark_rapids_tpu.config import RapidsConf  # noqa: E402
from spark_rapids_tpu.execs.base import collect as rcollect  # noqa: E402
from spark_rapids_tpu.native import kernels as rnk  # noqa: E402
from spark_rapids_tpu.plan.overrides import (  # noqa: E402
    apply_overrides as rapply)

from spark_rapids_tpu_torch import kernels as tnk  # noqa: E402
from spark_rapids_tpu_torch.benchmarks import datagen, tpch  # noqa: E402
from spark_rapids_tpu_torch.columnar.column import StringColumn  # noqa: E402
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

_GENERATORS = {
    "lineitem": (datagen.gen_lineitem, datagen.LINEITEM_COLUMNS),
    "part": (datagen.gen_part, datagen.PART_COLUMNS),
    "customer": (datagen.gen_customer, datagen.CUSTOMER_COLUMNS),
    "orders": (datagen.gen_orders, datagen.ORDERS_COLUMNS),
    "supplier": (datagen.gen_supplier, datagen.SUPPLIER_COLUMNS),
    "nation": (datagen.gen_nation, datagen.NATION_COLUMNS),
    "region": (datagen.gen_region, datagen.REGION_COLUMNS),
    "partsupp": (datagen.gen_partsupp, datagen.PARTSUPP_COLUMNS)}


def _assert_columns_equal(got: dict, table: pa.Table, columns):
    for name in columns:
        want = table.column(name).to_numpy(zero_copy_only=False)
        if want.dtype.kind == "M":
            want = want.astype("datetime64[D]").astype(np.int64)
        g = got[name]
        if isinstance(g, HostStrings):  # decoded to compare
            assert list(g.dictionary) == sorted(set(g.dictionary)), name
            g = g.to_objects()
        assert len(g) == len(want), name
        assert list(g) == list(want), name


@pytest.mark.parametrize("table", sorted(_GENERATORS))
@pytest.mark.parametrize("chunked", [False, True],
                         ids=["whole_table", "chunked"])
def test_generators_match_reference(table, chunked):
    """The whole-table draw (``datagen.gen_*``) and the chunked one
    (``gen_table_chunks`` with 16,384-row chunks, lineitem's shipdate
    windows included)."""
    gen, columns = _GENERATORS[table]
    if chunked:
        want = pa.concat_tables(list(rdatagen.gen_table_chunks(
            table, SF, chunk_rows=16384)))
        got = gen(SF, chunk_rows=16384)
    else:
        want = rdatagen.GENERATORS[table](SF)
        got = gen(SF)
    _assert_columns_equal(got, want, columns)


@functools.lru_cache(maxsize=None)
def _tables(orders_fraction=1.0):
    """The generated tables, made once per fraction (the queries read
    them and change nothing)."""
    orders = datagen.gen_orders(SF)
    n = int(len(orders["o_custkey"]) * orders_fraction)
    tables = {name: gen(SF) for name, (gen, _) in _GENERATORS.items()
              if name != "orders"}
    return dict(tables, orders={k: v[:n] for k, v in orders.items()})


def _write(d, names, orders_fraction=1.0):
    for name in names:
        table = rdatagen.GENERATORS[name](SF)
        if name == "orders":
            table = table.slice(0, int(table.num_rows * orders_fraction))
        (d / name).mkdir()
        pq.write_table(table, str(d / name / "part-000.parquet"))


_QUERIES = {q: (lambda t, q=q: getattr(tpch, q)(
    *(t[n] for n in tpch.INPUTS[q]))) for q in tpch.INPUTS}
# q22 over the first 10% of the orders rows
_CASES = {"q14": ("q14", 1.0), "q22": ("q22", 1.0), "q22_few_orders":
          ("q22", 0.1)}
# the ten queries that came with `Year`, `Cast` and the generators' last
# columns: every one keeps rows at sf 0.01
_NEW_QUERIES = ("q5", "q10", "q19", "q2", "q17", "q7", "q8", "q9", "q11",
                "q20")
# run by the reference once each, unfused, on its plain path
_HOST_STRING_QUERIES = ("q1", "q3", "q4", "q6", "q12", "q13", "q15", "q16",
                        "q18", "q21") + _NEW_QUERIES


@pytest.fixture(scope="module")
def parquet_dirs(tmp_path_factory):
    """orders fraction -> a directory of the reference's tables."""
    dirs = {}
    for frac, names in ((1.0, tuple(_GENERATORS)),
                        (0.1, ("customer", "orders"))):
        d = tmp_path_factory.mktemp(f"tpch_{int(frac * 100)}")
        _write(d, names, frac)
        dirs[frac] = str(d)
    return dirs


@pytest.fixture(scope="module")
def reference_results(parquet_dirs):
    """case -> conf -> the reference engine's result; query + ":fused"
    -> (its default tree's result, that tree's shape)."""
    from test_torch_fusion import shape

    dirs = parquet_dirs
    out = {}
    for case, (query, frac) in _CASES.items():
        build = getattr(rtpch, query)
        res = {}
        try:
            rnk.configure(enabled=True)
            res["unfused_kernels"] = rcollect(rapply(build(dirs[frac]),
                                                     RapidsConf(_UNFUSED)))
        finally:
            rnk.reset_config()
        res["default"] = rcollect(rapply(build(dirs[frac]), RapidsConf()))
        out[case] = res
    for query in _HOST_STRING_QUERIES:
        out[query] = rcollect(rapply(getattr(rtpch, query)(dirs[1.0]),
                                     RapidsConf(_UNFUSED)))
        fused = rapply(getattr(rtpch, query)(dirs[1.0]), RapidsConf(_FUSED))
        out[query + ":fused"] = (rcollect(fused), shape(fused))
    return out


def _assert_result_equal(got: dict, want):
    assert list(got) == list(want.columns)
    for name in want.columns:
        w = want[name].to_numpy()
        if w.dtype.kind == "M":  # a DATE: days since the epoch, as the port
            w = w.astype("datetime64[D]").astype(np.int64)
        g = got[name]
        assert len(g) == len(w), name
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(np.float64), w, rtol=1e-9,
                                       atol=0, err_msg=name)
        else:
            assert list(g) == list(w), name


@pytest.mark.parametrize("conf", ["unfused_kernels", "default"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_query_matches_reference_engine(reference_results, case, conf):
    query, frac = _CASES[case]
    want = reference_results[case][conf]
    tnk.reset_launches()
    got = collect(apply_overrides(
        _QUERIES[query](_tables(frac)),
        _PORT_UNFUSED if conf == "unfused_kernels" else {}, device="cpu"))
    _assert_result_equal(got, want)
    # on the CPU the wrappers run their plain versions: nothing launches
    assert all(v == 0 for v in tnk.LAUNCHES.values())
    if case == "q14":
        assert got["promo_revenue"][0] == pytest.approx(15.664195, abs=1e-6)
    if case == "q22_few_orders":
        assert len(got["cntrycode"]) == 5


@pytest.mark.parametrize("batch_rows", [4096, 256])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_query_in_small_batches(reference_results, case, batch_rows):
    """Many scan batches: the broadcast build, the aggregate's merges and
    the sort meet string columns that share their table's dictionary,
    and q22's substring results, whose dictionaries differ per batch."""
    query, frac = _CASES[case]
    got = collect(apply_overrides(_QUERIES[query](_tables(frac)),
                                  {_BATCH: batch_rows}, device="cpu"))
    _assert_result_equal(got, reference_results[case]["default"])


@pytest.mark.parametrize("query", _HOST_STRING_QUERIES)
def test_host_string_query_matches_reference_engine(reference_results,
                                                    query):
    """256-row scan batches over ``HostStrings`` tables (2,048 for the
    ten queries of ``_NEW_QUERIES``, their joins' stream side still 30
    lineitem batches): every batch of a scan shares its table's
    dictionary, through filters, joins, the aggregate's merges and the
    sort. Nothing calls ``StringColumn.from_strings``. Both engines'
    trees unfused."""
    calls = []
    orig = StringColumn.from_strings
    StringColumn.from_strings = staticmethod(
        lambda *a, **k: calls.append(1) or orig(*a, **k))
    try:
        rows = 2048 if query in _NEW_QUERIES else 256
        got = collect(apply_overrides(_QUERIES[query](_tables()),
                                      {_BATCH: rows, **_PORT_UNFUSED},
                                      device="cpu"))
    finally:
        StringColumn.from_strings = staticmethod(orig)
    assert not calls
    want = reference_results[query]
    assert len(want) > 0
    _assert_result_equal(got, want)


@pytest.mark.parametrize("query", _HOST_STRING_QUERIES)
def test_fused_query_matches_reference_default_session(reference_results,
                                                        query):
    """The port's default tree (fused) against the reference's default
    one (adaptive execution off) at the batches above: the same rows
    and the same fused execs with the same steps."""
    from test_torch_fusion import shape

    rows = 2048 if query in _NEW_QUERIES else 256
    texec = apply_overrides(_QUERIES[query](_tables()), {_BATCH: rows},
                            device="cpu")
    got = collect(texec)
    want, want_shape = reference_results[query + ":fused"]
    assert len(want) > 0
    _assert_result_equal(got, want)
    assert shape(texec) == want_shape
    assert any(name.startswith("Fused") for name, _ in want_shape)


def _join_order(node):
    """The column names of each relation of a join chain, in join order
    (the stream side first), found below any projection."""
    while type(node).__name__ in ("ProjectNode", "LimitNode", "SortNode",
                                  "AggregateNode", "FilterNode"):
        node = node.children[0]
    if type(node).__name__ == "JoinNode":
        return _join_order(node.children[0]) + \
            [tuple(node.children[1].output_schema().names)]
    return [tuple(node.output_schema().names)]


def _decoded(cols):
    return {k: v.to_objects() if isinstance(v, HostStrings) else v
            for k, v in cols.items()}


@pytest.mark.parametrize("query", _NEW_QUERIES)
def test_new_query_keeps_rows(reference_results, query):
    """A result with rows at sf 0.01 (a grand aggregate's one row not
    null), so the comparisons above hold something."""
    want = reference_results[query]
    assert len(want) > 0
    assert all(want[c].notna().all() for c in want.columns)


@pytest.mark.parametrize("case", ["q3", "q91_sf0.01", "q91_sf1"] +
                         list(_NEW_QUERIES))
def test_join_chain_in_the_reference_order(case, parquet_dirs):
    """The reference's default optimizer puts a join chain in its greedy
    order: q3's filtered lineitem streams, orders then customer build;
    q91's chain (as ``plan_statement`` gives it) starts from
    household_demographics at sf 0.01 and from catalog_returns at sf 1;
    q5, q7, q8 and q9 stream lineitem into supplier first, q10 into
    orders. The port's ``reorder_joins`` gives the same order for every
    plan (q5's puts customer after the region, joined on the nation key
    alone: ROADMAP, Queue C)."""
    from spark_rapids_tpu.benchmarks import tpcds as rtpcds
    from spark_rapids_tpu.plan import nodes as rpn
    from spark_rapids_tpu.plan.optimizer import optimize as roptimize
    from spark_rapids_tpu.sql import parse as rparse
    from spark_rapids_tpu.sql import plan_statement as rplan

    from spark_rapids_tpu_torch.benchmarks import tpcds
    from spark_rapids_tpu_torch.plan import nodes as pn
    from spark_rapids_tpu_torch.plan.optimizer import reorder_joins
    from spark_rapids_tpu_torch.sql import parse, plan_statement

    if not case.startswith("q91"):
        want = _join_order(roptimize(getattr(rtpch, case)(
            parquet_dirs[1.0])))
        got = _join_order(reorder_joins(_QUERIES[case](_tables())))
        first = {"q3": ("l_orderkey", "o_orderkey"),
                 "q5": ("l_orderkey", "s_suppkey"),
                 "q10": ("l_orderkey", "o_orderkey"),
                 "q7": ("l_orderkey", "s_suppkey"),
                 "q8": ("l_orderkey", "s_suppkey"),
                 "q9": ("l_orderkey", "s_suppkey")}.get(case)
        if first is None:  # no chain of three: the written order
            first = (got[0][0], got[1][0])
    else:
        sf = float(case.split("_sf")[1])
        tables = tpcds.q91_tables(sf)
        rcat = {n: rpn.InMemorySource(_decoded(c))
                for n, c in tables.items()}
        tcat = {n: pn.InMemorySource(c) for n, c in tables.items()}
        want = _join_order(roptimize(rplan(rparse(rtpcds.TPCDS_SQL["q91"]),
                                           rcat)))
        got = _join_order(reorder_joins(plan_statement(parse(tpcds.Q91_SQL),
                                                       tcat)))
        first = (("hd_demo_sk", "c_customer_sk") if sf < 1 else
                 ("cr_returned_date_sk", "cc_call_center_sk"))
    assert got == want
    assert (got[0][0], got[1][0]) == first


@pytest.mark.parametrize("case", sorted(_CASES) + list(_HOST_STRING_QUERIES))
def test_query_matches_numpy_oracle(case):
    query, frac = _CASES.get(case, (case, 1.0))
    t = _tables(frac)
    got = collect(apply_overrides(_QUERIES[query](t), device="cpu"))
    want = getattr(tpch, f"{query}_numpy")(
        *(t[n] for n in tpch.INPUTS[query]))
    assert list(got) == list(want)
    for name, col in want.items():
        if col.dtype.kind == "f":
            np.testing.assert_allclose(got[name], col, rtol=1e-9, atol=0)
        else:
            assert list(got[name]) == list(col)


def test_q5_as_written_matches_numpy_oracle():
    """With ``rapids.tpu.sql.optimizer.enabled`` off (the reference's
    switch) a plan runs in its written order: q5's customer, orders,
    lineitem, then the supplier chain on two keys (the greedy order
    joins customer on the nation key alone, about 7e11 rows at sf 10)."""
    t = _tables()
    args = [t[n] for n in tpch.INPUTS["q5"]]
    assert tpch.QUERY_CONF["q5"] == {"rapids.tpu.sql.optimizer.enabled":
                                     False}
    got = collect(apply_overrides(tpch.q5(*args), tpch.QUERY_CONF["q5"],
                                  device="cpu"))
    want = tpch.q5_numpy(*args)
    assert list(got["n_name"]) == list(want["n_name"])
    np.testing.assert_allclose(got["revenue"], want["revenue"], rtol=1e-9,
                               atol=0)


def test_grand_aggregate_over_no_rows_yields_one_null_row():
    """q14 over a month with no lineitem rows: the grand aggregate still
    yields one row, its sums are null, and so is the ratio. q22 whose
    selection has no positive balance, or no customer at all: the
    average is null, so no customer is above it and the result is
    empty."""
    t = _tables(0.1)
    li = {k: v[:0] for k, v in t["lineitem"].items()}
    got = collect(apply_overrides(tpch.q14(li, t["part"]), device="cpu"))
    assert list(got["promo_revenue"]) == [None]
    assert list(tpch.q14_numpy(li, t["part"])["promo_revenue"]) == [None]
    broke = dict(t["customer"], c_acctbal=-np.abs(t["customer"]["c_acctbal"]))
    nobody = {k: v[:0] for k, v in t["customer"].items()}
    for cust in (broke, nobody):
        got = collect(apply_overrides(tpch.q22(cust, t["orders"]),
                                      device="cpu"))
        assert [len(c) for c in got.values()] == [0, 0, 0]
        assert len(tpch.q22_numpy(cust, t["orders"])["cntrycode"]) == 0
