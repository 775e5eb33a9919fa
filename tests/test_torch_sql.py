"""The port's SQL and DataFrame front end, and TPC-DS q91 through it,
against the reference.

The port's parser must give the reference's AST on every TPC-DS text
and on the SQL strings of tests/test_sql.py; its planner the reference's
plan, node for node, on q91 (so the same join order and build sides).
The shapes of tests/test_sql.py that the port can run, a ``Column.like``
DataFrame query and q91 at sf 1 (7 rows) run through both engines on the
same in-memory tables: keys, strings and counts exact, float sums within
1e-9 relative (the reference's own tolerance against its CPU oracle; the
engines sum in different orders). q91 also runs at 256-row scan batches,
where every dimension batch has its own string dictionaries, and against
the numpy oracle; its default trees are fused in both engines, of one
shape, and with fusion off both engines give the same rows too. What
the port cannot plan must raise SqlError.
"""
from __future__ import annotations

import ast as pyast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spark_rapids_tpu.api import Session as RSession  # noqa: E402
from spark_rapids_tpu.api import col as rcol  # noqa: E402
from spark_rapids_tpu.benchmarks import tpcds as rtpcds  # noqa: E402
from spark_rapids_tpu.config import RapidsConf  # noqa: E402
from spark_rapids_tpu.execs.base import collect as rcollect  # noqa: E402
from spark_rapids_tpu.plan import nodes as rpn  # noqa: E402
from spark_rapids_tpu.plan.overrides import (  # noqa: E402
    apply_overrides as rapply)
from spark_rapids_tpu.sql import parse as rparse  # noqa: E402
from spark_rapids_tpu.sql import plan_statement as rplan  # noqa: E402
from spark_rapids_tpu.sql.parser import SqlError as RSqlError  # noqa: E402

from spark_rapids_tpu_torch import kernels as tnk  # noqa: E402
from spark_rapids_tpu_torch.api import Session, col  # noqa: E402
from spark_rapids_tpu_torch.api import functions as F  # noqa: E402
from spark_rapids_tpu_torch.benchmarks import tpcds  # noqa: E402
from spark_rapids_tpu_torch.io.hoststrings import HostStrings  # noqa: E402
from spark_rapids_tpu_torch.plan import nodes as pn  # noqa: E402
from spark_rapids_tpu_torch.sql import SqlError, parse, plan_statement  # noqa: E402

_BATCH = "rapids.tpu.sql.reader.batchSizeRows"


# -- the parser --------------------------------------------------------------


def _test_sql_strings():
    """Every string literal of tests/test_sql.py that starts a SELECT."""
    path = os.path.join(os.path.dirname(__file__), "test_sql.py")
    with open(path) as f:
        tree = pyast.parse(f.read())
    return sorted({n.value for n in pyast.walk(tree)
                   if isinstance(n, pyast.Constant) and
                   isinstance(n.value, str) and
                   n.value.strip().lower().startswith("select")})


def _parse_both(text):
    try:
        want = ("ok", rparse(text))
    except RSqlError as e:
        want = ("error", str(e))
    try:
        got = ("ok", parse(text))
    except SqlError as e:
        got = ("error", str(e))
    return got, want


def test_parser_matches_reference_on_tpcds_texts():
    assert len(rtpcds.TPCDS_SQL) == 91
    for name, text in sorted(rtpcds.TPCDS_SQL.items()):
        got, want = _parse_both(text)
        assert want[0] == "ok", name
        assert got == want, name
    assert parse(tpcds.Q91_SQL) == rparse(rtpcds.TPCDS_SQL["q91"])


def test_parser_matches_reference_on_test_sql_strings():
    texts = _test_sql_strings()
    assert len(texts) >= 20
    outcomes = set()
    for text in texts:
        got, want = _parse_both(text)
        assert got == want, text
        outcomes.add(got[0])
    assert outcomes == {"ok", "error"}


# -- plans -------------------------------------------------------------------


def _expr_sig(e):
    """A reference or port expression as a comparable tuple."""
    if e is None:
        return None
    attrs = {}
    for a in ("ordinal", "value", "alias", "pattern", "escape", "needle",
              "values", "pos", "length"):
        if hasattr(e, a):
            attrs[a] = getattr(e, a)
    return (type(e).__name__, e.dtype.name, tuple(sorted(attrs.items())),
            tuple(_expr_sig(c) for c in e.children))


def _plan_sig(node):
    """A reference or port plan node, and its subtree, as a tuple."""
    schema = node.output_schema()
    attrs = {"schema": (tuple(schema.names),
                        tuple(t.name for t in schema.types))}
    kind = type(node).__name__
    if kind == "JoinNode":
        attrs.update(kind=node.kind, keys=(tuple(node.left_keys),
                                           tuple(node.right_keys)),
                     condition=_expr_sig(node.condition))
    elif kind == "FilterNode":
        attrs["condition"] = _expr_sig(node.condition)
    elif kind == "ProjectNode":
        attrs["exprs"] = tuple(_expr_sig(e) for e in node.exprs)
    elif kind == "AggregateNode":
        attrs["grouping"] = tuple(_expr_sig(e) for e in node.grouping)
        attrs["aggs"] = tuple((a.name, _expr_sig(a.fn)) for a in node.aggs)
    elif kind == "SortNode":
        attrs["specs"] = tuple((s.ordinal, s.ascending, s.nulls_first)
                               for s in node.specs)
    elif kind == "LimitNode":
        attrs["n"] = node.n
    return (kind, tuple(sorted(attrs.items())),
            tuple(_plan_sig(c) for c in node.children))


def _decoded(cols):
    """The columns with each ``HostStrings`` as an object array, the form
    the reference's in-memory source takes."""
    return {k: v.to_objects() if isinstance(v, HostStrings) else v
            for k, v in cols.items()}


def _catalogs(tables):
    """The same columns as a reference and a port catalog."""
    return ({n: rpn.InMemorySource(_decoded(cols))
             for n, cols in tables.items()},
            {n: pn.InMemorySource(dict(cols)) for n, cols in tables.items()})


def test_q91_plan_matches_reference_node_for_node():
    rcat, tcat = _catalogs(tpcds.q91_tables(0.01))
    want = _plan_sig(rplan(rparse(rtpcds.TPCDS_SQL["q91"]), rcat))
    got = _plan_sig(plan_statement(parse(tpcds.Q91_SQL), tcat))
    assert got == want
    # the plan holds the LIKE the port now runs through K5
    assert "'unknown%'" in repr(got)


# -- tests/test_sql.py's shapes through both engines -------------------------


def _small_tables(seed=0, n=300):
    """tests/test_sql.py's catalog, without its date column."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 10, n).astype(np.int64)
    v = np.round(rng.random(n) * 100, 3)
    s = np.array([f"name{i % 7}" for i in range(n)], dtype=object)
    valid = rng.random(n) > 0.1
    rng.integers(0, 1000, n)
    u = {"k2": rng.integers(0, 10, 40).astype(np.int64),
         "w": rng.integers(0, 50, 40).astype(np.int64)}
    return {"t": ({"k": k, "v": v, "s": s}, {"v": valid}), "u": (u, None)}


def _small_catalogs():
    tables = _small_tables()
    return ({n: rpn.InMemorySource(c, validity=v)
             for n, (c, v) in tables.items()},
            {n: pn.InMemorySource(c, validity=v)
             for n, (c, v) in tables.items()})


def _rows(cols: dict, ordered: bool):
    names = list(cols)
    rows = list(zip(*[list(cols[n]) for n in names])) if names else []
    key = [tuple((x is None, "" if x is None else str(type(x)), x)
                 for x in r) for r in rows]
    return rows if ordered else [rows[i] for i in
                                 sorted(range(len(rows)), key=key.__getitem__)]


def _assert_same(got: dict, want_df, ordered: bool):
    assert list(got) == list(want_df.columns)
    want = {n: [None if (isinstance(x, float) and np.isnan(x)) or x is None
                else x for x in want_df[n].tolist()] for n in want_df.columns}
    g_rows = _rows({n: [None if x is None else
                        (x.item() if hasattr(x, "item") else x)
                        for x in got[n]] for n in got}, ordered)
    w_rows = _rows(want, ordered)
    assert len(g_rows) == len(w_rows)
    for g, w in zip(g_rows, w_rows):
        for a, b in zip(g, w):
            if isinstance(b, float) and a is not None:
                assert a == pytest.approx(b, rel=1e-9, abs=0)
            else:
                assert a == b, (g, w)


_SHAPES = {
    "where_order_limit": ("SELECT k, v FROM t WHERE v > 50.0 AND k <> 3 "
                          "ORDER BY v DESC, k LIMIT 17", True),
    "global_aggregate": ("SELECT sum(v) AS s, count(*) AS n FROM t", True),
    "aggregate_having": ("SELECT k, sum(v) / count(v) AS manual_avg FROM t "
                         "GROUP BY k HAVING count(*) > 20 ORDER BY k", True),
    "join_residual": ("SELECT t.k, t.v, u.w FROM t JOIN u ON t.k = u.k2 "
                      "AND u.w > 25", False),
    "subquery_in_from": ("SELECT kk, total FROM (SELECT k AS kk, sum(v) AS "
                         "total FROM t GROUP BY k) agg WHERE total > 100.0 "
                         "ORDER BY kk", True),
    "in_between": ("SELECT k FROM t WHERE k IN (1, 3, 5) OR v BETWEEN "
                   "10.0 AND 20.0", False),
    "like": ("SELECT s FROM t WHERE s LIKE 'name1%'", False),
    "left_anti": ("SELECT k, v FROM t LEFT ANTI JOIN u ON t.k = u.k2",
                  False),
    "distinct": ("SELECT DISTINCT k FROM t ORDER BY k", True),
    "order_by_alias": ("SELECT k, sum(v) AS sv, avg(v) AS av FROM t "
                       "GROUP BY k ORDER BY sv", True),
    "comma_join": ("SELECT K, w FROM T, u WHERE k = k2 AND w < 10 "
                   "ORDER BY w, k LIMIT 5", True),
    "cte": ("WITH a AS (SELECT k, sum(v) AS sv FROM t GROUP BY k) "
            "SELECT k, sv FROM a WHERE sv > 1000.0 ORDER BY k", True),
    "order_by_hidden": ("SELECT s FROM t WHERE k < 3 ORDER BY v DESC, k, s "
                        "LIMIT 9", True),
    # the joins and aggregates of the tenth slice; u's k2 misses some of
    # t's keys and holds keys t lacks, and t's v has nulls
    "left_join_distinct_min_max": (
        "SELECT t.s, count(f.w) AS n, count(DISTINCT f.w) AS nd, "
        "sum(t.v) AS sv, min(t.v) AS lo, max(f.w) AS hi, min(t.s) AS ms "
        "FROM t LEFT OUTER JOIN (SELECT k2, w FROM u WHERE w > 25) f "
        "ON t.k = f.k2 GROUP BY t.s ORDER BY t.s", True),
    "right_join": ("SELECT f.v, u.k2, u.w FROM (SELECT k, v FROM t WHERE "
                   "k < 6) f RIGHT JOIN u ON f.k = u.k2", False),
    "full_join": ("SELECT f.k, f.s, g.w FROM (SELECT k, s FROM t WHERE "
                  "k < 6) f FULL OUTER JOIN (SELECT k2, w FROM u WHERE "
                  "k2 > 3) g ON f.k = g.k2", False),
    "left_semi": ("SELECT k, v FROM t LEFT SEMI JOIN u ON t.k = u.k2 AND "
                  "u.w > 40 AND t.v > 30.0", False),
}


@pytest.mark.parametrize("shape", sorted(_SHAPES))
def test_sql_shapes_match_reference_engine(shape):
    text, ordered = _SHAPES[shape]
    rcat, tcat = _small_catalogs()
    rplan_ = rplan(rparse(text), rcat)
    want = rcollect(rapply(rplan_, RapidsConf()))
    tplan = plan_statement(parse(text), tcat)
    assert _plan_sig(tplan) == _plan_sig(rplan_)
    got = Session(device="cpu")
    got._catalog = tcat
    _assert_same(got.sql(text).collect(), want, ordered)


def test_dataframe_like_query_matches_reference():
    """``Column.like`` through the DataFrame API: a filter, a computed
    column, a group-by with sum / count / avg, an ordering."""
    import pandas as pd

    from spark_rapids_tpu.api import functions as RF

    tc, tv = _small_tables()["t"]
    rs = RSession()
    pdf = pd.DataFrame({"k": tc["k"], "v": np.where(tv["v"], tc["v"], np.nan),
                        "s": tc["s"]})
    rdf = (rs.create_dataframe(pdf)
           .filter(rcol("s").like("name_%") & ~rcol("s").like("%3"))
           .with_column("v2", rcol("v") * 2.0))
    want = (rdf.group_by("s").agg(RF.sum(rcol("v2")).alias("sv"),
                                  RF.count("*").alias("n"),
                                  RF.avg(rcol("k")).alias("ak"))
            .order_by("s").collect())
    s = Session(device="cpu")
    df = (s.create_dataframe(tc, validity=tv)
          .filter(col("s").like("name_%") & ~col("s").like("%3"))
          .with_column("v2", col("v") * 2.0))
    got = (df.group_by("s").agg(F.sum(col("v2")).alias("sv"),
                                F.count("*").alias("n"),
                                F.avg(col("k")).alias("ak"))
           .order_by("s").collect())
    _assert_same(got, want, True)
    assert list(got["s"]) == [f"name{i}" for i in (0, 1, 2, 4, 5, 6)]
    lim = s.create_dataframe(tc).select(col("k"), col("s").alias("name")) \
        .limit(4).collect()
    assert list(lim) == ["k", "name"] and len(lim["k"]) == 4


def test_dataframe_join_isin_startswith_substr_match_reference():
    import pandas as pd

    from spark_rapids_tpu.api import functions as RF

    tc, tv = _small_tables()["t"]
    u, _ = _small_tables()["u"]
    rs = RSession()
    rt = rs.create_dataframe(pd.DataFrame(
        {"k": tc["k"], "v": np.where(tv["v"], tc["v"], np.nan),
         "s": tc["s"]}))
    ru = rs.create_dataframe(pd.DataFrame(u))
    want = (rt.filter(rcol("k").isin(1, 3, 5) |
                      rcol("s").startswith("name2"))
            .join(ru, on=[("k", "k2")], how="inner")
            .select(rcol("s").substr(1, 5).alias("p"), rcol("w"),
                    rcol("v"))
            .group_by("p").agg(RF.sum(rcol("w")).alias("sw"),
                                RF.count(rcol("v")).alias("nv"))
            .order_by("p").collect())
    s = Session(device="cpu")
    t = s.create_dataframe(tc, validity=tv)
    got = (t.filter(col("k").isin(1, 3, 5) | col("s").startswith("name2"))
           .join(s.create_dataframe(u), on=[("k", "k2")], how="inner")
           .select(col("s").substr(1, 5).alias("p"), col("w"), col("v"))
           .group_by("p").agg(F.sum(col("w")).alias("sw"),
                              F.count(col("v")).alias("nv"))
           .order_by("p").collect())
    _assert_same(got, want, True)
    anti = t.join(s.create_dataframe(u).filter(col("w") > 40), on=[(
        "k", "k2")], how="leftanti").collect()
    want_anti = rt.join(ru.filter(rcol("w") > 40), on=[("k", "k2")],
                        how="leftanti").collect()
    _assert_same(anti, want_anti, False)


@pytest.mark.parametrize("batch_rows", [64, 1 << 21])
def test_limit_spans_scan_batches(batch_rows):
    tables = _small_tables()
    s = Session({_BATCH: batch_rows}, device="cpu")
    data, validity = tables["t"]
    s.create_temp_view("t", pn.InMemorySource(data, validity=validity))
    got = s.sql("SELECT k, s FROM t LIMIT 100").collect()
    assert list(got["k"]) == list(tables["t"][0]["k"][:100])
    assert list(got["s"]) == list(tables["t"][0]["s"][:100])
    assert len(s.sql("SELECT k FROM t LIMIT 0").collect()["k"]) == 0


def test_join_condition_only_on_inner_joins():
    from spark_rapids_tpu_torch.expressions import predicates as P
    from spark_rapids_tpu_torch.expressions.base import (BoundReference,
                                                         Literal)
    from spark_rapids_tpu_torch.plan.overrides import apply_overrides

    _, cat = _small_catalogs()
    cond = P.GreaterThan(BoundReference(0, cat["t"].schema().types[0]),
                         Literal(3))
    node = pn.JoinNode("left_anti", pn.ScanNode(cat["t"]),
                       pn.ScanNode(cat["u"]), [0], [0], condition=cond)
    with pytest.raises(NotImplementedError, match="residual condition"):
        apply_overrides(node, device="cpu")


# -- subnormal floats ------------------------------------------------------------

# The reference's XLA backend counts a subnormal operand or result of a
# comparison or of arithmetic as a zero of its sign, except where XLA
# folds the operation away before it runs (a literal identity or
# negation, two literals). -0.0 and NaN ride along to show that they
# keep their behaviour.

_SUBNORMAL_SHAPES = {
    "eq": ("SELECT i FROM t WHERE d = 0.0", False),
    "gt": ("SELECT i FROM t WHERE d > 0.0", False),
    "lt": ("SELECT i FROM t WHERE d < 0.0", False),
    "ge": ("SELECT i FROM t WHERE d >= 0.0", False),
    "le": ("SELECT i FROM t WHERE d <= 0.0", False),
    "ne": ("SELECT i FROM t WHERE d <> 0.0", False),
    "in": ("SELECT i FROM t WHERE d IN (0.0, 1.5)", False),
    "between": ("SELECT i FROM t WHERE d BETWEEN 0.0 AND 1.0", False),
    "eq_subnormal_literal": ("SELECT i FROM t WHERE d = 1e-310", False),
    "div_column": ("SELECT i, d / i AS q FROM t", False),
    "div_by_subnormal": ("SELECT i, 1.0 / d AS q FROM t", False),
    "mul_two": ("SELECT i, d * 2.0 AS q FROM t", False),
    "mul_tiny": ("SELECT i, d * 1e-10 AS q FROM t", False),
    "mul_column": ("SELECT i, d * i AS q FROM t", False),
    "add_self": ("SELECT i, d + d AS q FROM t", False),
    "sub_self": ("SELECT i, d - d AS q FROM t", False),
    "zero_minus": ("SELECT i, 0.0 - d AS q FROM t", False),
    "mul_one": ("SELECT i, d * 1.0 AS q FROM t", False),
    "one_mul": ("SELECT i, 1.0 * d AS q FROM t", False),
    "add_zero": ("SELECT i, d + 0.0 AS q FROM t", False),
    "zero_add": ("SELECT i, 0.0 + d AS q FROM t", False),
    "sub_zero": ("SELECT i, d - 0.0 AS q FROM t", False),
    "add_negative_zero": ("SELECT i, d + -0.0 AS q FROM t", False),
    "div_one": ("SELECT i, d / 1.0 AS q FROM t", False),
    "mul_int_one": ("SELECT i, d * 1 AS q FROM t", False),
    "mul_minus_one": ("SELECT i, d * -1.0 AS q FROM t", False),
    "minus_one_mul": ("SELECT i, -1.0 * d AS q FROM t", False),
    "div_minus_one": ("SELECT i, d / -1.0 AS q FROM t", False),
    "identity_then_mul": ("SELECT i, d * 1.0 * 2.0 AS q FROM t", False),
    "identity_then_compare": ("SELECT i FROM t WHERE d * 1.0 > 0.0", False),
    "select": ("SELECT i, d FROM t", False),
    "sum": ("SELECT sum(d) AS s FROM t", True),
    "group_by": ("SELECT d, count(*) AS n FROM t GROUP BY d", False),
    "order_by": ("SELECT i, d FROM t ORDER BY d, i", True),
    "join": ("SELECT t.i, z.z FROM t JOIN z ON t.d = z.z", False),
}


@pytest.fixture(scope="module")
def subnormal_sessions():
    """One reference and one port session over the same two tables."""
    t = {"d": np.array([1e-310, 0.0, 1.5, -1e-310, 1e-300, -0.0,
                        float("nan")]),
         "i": np.array([-3, 1, 2, 5, 7, 11, 13], dtype=np.int64)}
    z = {"z": np.array([0.0, 1.5])}
    rs = RSession()
    s = Session(device="cpu")
    for name, cols in (("t", t), ("z", z)):
        rs.create_temp_view(name, rpn.InMemorySource(dict(cols)))
        s.create_temp_view(name, pn.InMemorySource(dict(cols)))
    return rs, s


def _exact_rows(columns, ordered: bool):
    """Rows with every float as its bit pattern (one token for NaN), so
    -0.0 against 0.0 and 1e-320 against 0.0 differ."""
    def cell(x):
        if x is None:
            return ("null",)
        if isinstance(x, (float, np.floating)):
            x = float(x)
            return ("nan",) if np.isnan(x) else \
                ("f", int(np.float64(x).view(np.int64)))
        return ("v", int(x))
    rows = list(zip(*[[cell(x) for x in c] for c in columns]))
    return rows if ordered else sorted(rows)


@pytest.mark.parametrize("shape", sorted(_SUBNORMAL_SHAPES))
def test_subnormal_floats_match_reference_engine_bit_for_bit(
        subnormal_sessions, shape):
    text, ordered = _SUBNORMAL_SHAPES[shape]
    rs, s = subnormal_sessions
    want = rs.sql(text).collect()
    got = s.sql(text).collect()
    assert list(got) == list(want.columns)
    assert _exact_rows([list(got[n]) for n in got], ordered) == \
        _exact_rows([want[n].to_numpy().tolist() for n in want.columns],
                    ordered)


# -- q91 -----------------------------------------------------------------------


@pytest.mark.parametrize("sf", [0.01, 1])
@pytest.mark.parametrize("table", sorted(tpcds.Q91_GENERATORS))
def test_q91_generators_match_reference(table, sf):
    got = _decoded(tpcds.Q91_GENERATORS[table](sf))
    want = rtpcds.GENERATORS[table](sf)
    for name, values in got.items():
        w = want.column(name).to_numpy(zero_copy_only=False)
        assert len(values) == len(w), name
        assert values.dtype == w.dtype, name
        np.testing.assert_array_equal(values, w, err_msg=name)


@pytest.fixture(scope="module")
def q91_sf1():
    """The q91 tables at sf 1 and the reference engine's answer."""
    tables = tpcds.q91_tables(1)
    rcat, _ = _catalogs(tables)
    rs = RSession()
    for name, src in rcat.items():
        rs.create_temp_view(name, src)
    return tables, rs.sql(rtpcds.TPCDS_SQL["q91"]).collect()


def test_q91_trees_match_reference(q91_sf1):
    """The port's default tree has the reference's default tree's shape
    (the same fused execs with the same steps; adaptive execution off),
    and the port's unfused tree gives the rows of the reference's with
    fusion off."""
    from test_torch_fusion import shape

    from spark_rapids_tpu_torch.plan.overrides import apply_overrides

    tables, _ = q91_sf1
    rcat, tcat = _catalogs(tables)
    rtree = rapply(rplan(rparse(rtpcds.TPCDS_SQL["q91"]), rcat),
                   RapidsConf({"rapids.tpu.sql.adaptive.enabled": False}))
    ttree = apply_overrides(plan_statement(parse(tpcds.Q91_SQL), tcat),
                            device="cpu")
    assert shape(ttree) == shape(rtree)
    assert any(n.startswith("Fused") for n, _ in shape(ttree))
    unfused = {"rapids.tpu.sql.fusion.enabled": False}
    rs = RSession(unfused)
    for name, src in rcat.items():
        rs.create_temp_view(name, src)
    want = rs.sql(rtpcds.TPCDS_SQL["q91"]).collect()
    s = Session(unfused, device="cpu")
    for name, cols in tables.items():
        s.create_temp_view(name, pn.InMemorySource(cols))
    assert len(want) == 7
    _assert_same(s.sql(tpcds.Q91_SQL).collect(), want, True)


@pytest.mark.parametrize("batch_rows", [None, 256], ids=["default", "256"])
def test_q91_matches_reference_engine_and_oracle(q91_sf1, batch_rows):
    tables, want = q91_sf1
    s = Session({} if batch_rows is None else {_BATCH: batch_rows},
                device="cpu")
    for name, cols in tables.items():
        s.create_temp_view(name, pn.InMemorySource(cols))
    tnk.reset_launches()
    got = s.sql(tpcds.Q91_SQL).collect()
    assert all(v == 0 for v in tnk.LAUNCHES.values())
    assert len(want) == 7
    _assert_same(got, want, True)
    oracle = tpcds.q91_numpy(tables)
    assert list(got) == list(oracle)
    for name, values in oracle.items():
        if values.dtype.kind == "f":
            np.testing.assert_allclose(got[name].astype(np.float64), values,
                                       rtol=1e-9, atol=0)
        else:
            assert list(got[name]) == list(values), name


def test_q91_small_scale_is_empty():
    tables = tpcds.q91_tables(0.01)
    s = Session(device="cpu")
    for name, cols in tables.items():
        s.create_temp_view(name, pn.InMemorySource(cols))
    got = s.sql(tpcds.Q91_SQL).collect()
    assert [len(v) for v in got.values()] == [0, 0, 0, 0]
    assert all(len(v) == 0 for v in tpcds.q91_numpy(tables).values())


# -- what is not ported --------------------------------------------------------


@pytest.mark.parametrize("text, what", [
    ("SELECT k, rank() OVER (ORDER BY v) AS r FROM t", "window"),
    ("SELECT k FROM t UNION SELECT k2 FROM u", "UNION"),
    ("SELECT k, sum(v) FROM t GROUP BY ROLLUP(k)", "ROLLUP"),
    ("SELECT k FROM t WHERE k IN (SELECT k2 FROM u)", "subquer"),
    ("SELECT k FROM t WHERE EXISTS (SELECT k2 FROM u WHERE k2 = k)",
     "subquer"),
    ("SELECT lower(s) AS c FROM t", "lower()"),
    ("SELECT k, length(s) AS n FROM t", "length()"),
    ("SELECT upper(s) FROM t", "upper()"),
    ("SELECT t.k FROM t LEFT JOIN u ON t.k = u.k2 AND t.v > u.w",
     "LEFT JOIN with a non-equi condition"),
    ("SELECT k FROM t INTERSECT SELECT k2 FROM u", "INTERSECT"),
    ("SELECT k, count(DISTINCT s), count(DISTINCT v) FROM t GROUP BY k",
     "distinct aggregates over more than one input"),
    ("SELECT trim(s) AS x FROM t", "trim()"),
    ("SELECT k FROM t WHERE v > (SELECT max(w) FROM u)", "subquer"),
    ("SELECT concat(s, s) AS c FROM t", "concat()"),
])
def test_unported_clause_raises_sql_error(text, what):
    _, tcat = _small_catalogs()
    with pytest.raises(SqlError, match="not ported yet") as err:
        plan_statement(parse(text), tcat)
    assert what in str(err.value)


def test_sql_errors_are_loud():
    _, cat = _small_catalogs()
    with pytest.raises(SqlError, match="not found"):
        plan_statement(parse("SELECT z FROM t"), cat)
    with pytest.raises(SqlError, match="table"):
        plan_statement(parse("SELECT a FROM missing"), cat)
    with pytest.raises(SqlError, match="equi"):
        plan_statement(parse("SELECT t.k FROM t JOIN u ON t.v > u.w"), cat)
    with pytest.raises(SqlError, match="unknown function"):
        plan_statement(parse("SELECT nosuch(k) FROM t"), cat)
