"""The port's default exec tree, fused as the reference's default is
(``execs/fused.py``), against the reference's default ``Session``
(adaptive execution off), bit for bit: the same rows (floats by bit
pattern, a null and a NaN alike, as the reference's frames hold both as
NaN) and the same tree shape, its fused execs and their steps in order.

Cases: the C7 queries (a numeric key keeps its statistics through a
string filter, a filter below a projection and a join's stream side, so
a min of -0.0 stays -0.0 on the dense path, as in the reference; these
three fail on the unfused port), chains of numeric and string filters
(``=``, ``IN``, ``<`` ride in the chain, ``StartsWith`` breaks it),
projections below and above filters and joins, float products that fuse
into an add of a later step (C3 across steps), inner joins with and
without a residual, left, semi and anti joins over unique builds in
dense and hash mode, a build with repeated keys (the fallback to the
unfused subtree), an empty build and one of null keys only, a shared
subtree (a CTE), and sort tails with ties, nulls, NaN and -0.0 under a
LIMIT (on integral and string keys too, where the sort is the radix
kernel's; and with ``rapids.tpu.sql.fusion.sortTail`` off in both
engines). The scans run in 64-row batches, so every chain sees many.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

_REF = {"rapids.tpu.sql.adaptive.enabled": False}
_BATCH = {"rapids.tpu.sql.reader.batchSizeRows": 64}
_HASH = {"rapids.tpu.sql.fusion.denseProbe.maxSpan": 16}
_NO_SORT_TAIL = {"rapids.tpu.sql.fusion.sortTail": False}
_SKIP = {"_ReplayExec", "BroadcastExchangeExec", "CoalesceBatchesExec"}
_ALIAS = {"LocalLimitExec": "LimitExec", "GlobalLimitExec": "LimitExec"}

# the three C7 queries that differ from the reference on the unfused port
C7_FAILING_UNFUSED = (
    "SELECT k, min(z) AS m FROM a WHERE s = 'x' GROUP BY k",
    "SELECT k, min(z) AS m FROM (SELECT k, z FROM a WHERE v > 0.0) x "
    "GROUP BY k",
    "SELECT a.k, min(b.w) AS m FROM a JOIN b ON a.k = b.k GROUP BY a.k",
)

_CASES = {
    # chains of filters
    "string_eq_and_numeric": "SELECT i, f FROM t WHERE s = 'x' AND k < 10",
    "string_in": "SELECT i, k FROM t WHERE s IN ('x', 'zz') AND f > 0.0",
    "string_lt": "SELECT i FROM t WHERE s < 'y'",
    "string_ge_literal_left": "SELECT i, s FROM t WHERE 'ab' <= s AND k > 3",
    "starts_with_breaks": "SELECT i, k + 1 AS j FROM t "
                          "WHERE s LIKE 'z%' AND k < 5",
    # projections below and above filters
    "project_over_filter": "SELECT i, k * 2 + 1 AS j, f + g AS x FROM t "
                           "WHERE h > 0.0",
    "filter_over_project": "SELECT i, x FROM (SELECT i, f * g AS x, h "
                           "FROM t) q WHERE x > h",
    # C3 across steps
    "product_in_filter_and_project": "SELECT i, f * g + h AS x FROM t "
                                     "WHERE f * g > h",
    "product_below_add": "SELECT i, x + h AS y FROM (SELECT i, f * g AS x, "
                         "h FROM t) q",
    "product_below_join": "SELECT i, x + h AS y FROM (SELECT i, f * g AS x, "
                          "h, k FROM t) q JOIN d ON q.k = d.dk",
    "product_below_join_build_addend": "SELECT i, x + w AS y FROM (SELECT "
                                       "i, f * g AS x, k FROM t) q "
                                       "JOIN d ON q.k = d.dk",
    # joins over unique builds
    "inner": "SELECT t.i, d.name, d.w FROM t JOIN d ON t.k = d.dk",
    "inner_residual": "SELECT t.i, d.w FROM t JOIN d ON t.k = d.dk "
                      "AND t.f < d.w",
    "left_null_keys": "SELECT t.i, n.w FROM t LEFT JOIN dn n "
                      "ON t.k = n.dk",
    "semi": "SELECT i, f FROM t LEFT SEMI JOIN dn ON t.k = dn.dk",
    "anti": "SELECT i FROM t LEFT ANTI JOIN dn ON t.k = dn.dk",
    "two_joins_aggregate": "SELECT d.name, sum(t.f) AS sf, count(*) AS c "
                           "FROM t JOIN d ON t.k = d.dk JOIN dn "
                           "ON t.k = dn.dk GROUP BY d.name",
    "join_float_key": "SELECT t.i, e.w FROM t JOIN fk e ON t.g = e.key",
    # builds that cannot probe uniquely, or match nothing
    "repeated_keys_fall_back": "SELECT t.i, u.w FROM t JOIN dup u "
                               "ON t.k = u.dk",
    "repeated_keys_aggregate": "SELECT t.k, min(u.w) AS m FROM t JOIN dup u "
                               "ON t.k = u.dk GROUP BY t.k",
    "empty_build_inner": "SELECT t.i FROM t JOIN e ON t.k = e.dk",
    "empty_build_left": "SELECT t.i, e.w FROM t LEFT JOIN e ON t.k = e.dk",
    "null_keys_only": "SELECT t.i, z.w FROM t LEFT JOIN nk z "
                      "ON t.k = z.dk",
    # a shared subtree
    "cte_twice": "WITH q AS (SELECT k, sum(f) AS sf FROM t GROUP BY k) "
                 "SELECT q1.k, q1.sf, q2.sf AS sf2 FROM q q1 JOIN q q2 "
                 "ON q1.k = q2.k",
    # sort tails under a LIMIT (the order is compared)
    "sort_tail_min": "SELECT k, min(h) AS m, count(*) AS c FROM t GROUP BY k "
                     "ORDER BY m DESC, k LIMIT 7",
    "sort_tail_nulls_first": "SELECT k, min(h) AS m FROM t GROUP BY k "
                             "ORDER BY m, k LIMIT 9",
    "sort_tail_having": "SELECT k, sum(f) AS sf FROM t GROUP BY k "
                        "HAVING count(*) > 10 ORDER BY sf LIMIT 5",
    "sort_tail_ties": "SELECT s, max(z) AS m, count(*) AS c FROM t "
                      "GROUP BY s ORDER BY m, c DESC LIMIT 3",
    "sort_tail_integral_keys": "SELECT k, count(*) AS c FROM t GROUP BY k "
                               "ORDER BY c DESC, k LIMIT 8",
    "sort_tail_string_key": "SELECT s, count(*) AS c, min(f) AS m FROM t "
                            "GROUP BY s ORDER BY s DESC LIMIT 4",
}
_ORDERED = {c for c in _CASES if c.startswith("sort_tail")}
# float sums: within 1e-9 relative (their order of addition is outside the
# bit-for-bit contract, ROADMAP Queue C); everything else bit for bit
_SUMS = {"two_joins_aggregate", "cte_twice", "sort_tail_having"}


def _tables():
    """name -> (columns, port types by name, validity): seeded; floats
    hold -0.0, NaN and +-1e-310; ``h`` has nulls and a group of only
    nulls; ``d`` and ``dn`` have unique keys (``dn``'s with nulls), ``dup``
    repeats them, ``e`` is empty, ``nk`` has null keys only."""
    r = np.random.default_rng(13)
    n = 400
    specials = np.array([-0.0, 0.0, np.nan, 1e-310, -1e-310])

    def floats():
        x = r.standard_normal(n)
        at = r.choice(n, 40, replace=False)
        x[at] = specials[r.integers(0, len(specials), 40)]
        return x

    k = r.integers(-5, 20, n).astype(np.int64)
    h_valid = (r.random(n) > 0.2) & (k != 7)
    t = ({"i": np.arange(n, dtype=np.int64), "k": k, "f": floats(),
          "g": floats(), "h": floats(), "z": np.full(n, -0.0),
          "s": np.array(["x", "y", "zz", "ab", "b"],
                        dtype=object)[r.integers(0, 5, n)]},
         {"i": "bigint", "k": "bigint", "f": "double", "g": "double",
          "h": "double", "z": "double", "s": "string"}, {"h": h_valid})
    keys = np.arange(-5, 20, dtype=np.int64)
    d = ({"dk": keys, "name": np.array([f"n{j % 6}" for j in range(25)],
                                       dtype=object),
          "w": r.standard_normal(25)},
         {"dk": "bigint", "name": "string", "w": "double"}, {})
    dn = ({"dk": keys[::2].copy(), "w": r.standard_normal(13)},
          {"dk": "bigint", "w": "double"},
          {"dk": np.arange(13) % 4 != 1, "w": np.arange(13) % 3 != 0})
    dup = ({"dk": np.concatenate([keys, keys[:5]]),
            "w": r.standard_normal(30)}, {"dk": "bigint", "w": "double"}, {})
    e = ({"dk": np.zeros(0, np.int64), "w": np.zeros(0)},
         {"dk": "bigint", "w": "double"}, {})
    nk = ({"dk": np.arange(4, dtype=np.int64), "w": r.standard_normal(4)},
          {"dk": "bigint", "w": "double"}, {"dk": np.zeros(4, dtype=bool)})
    gk = np.unique(t[0]["g"][np.isfinite(t[0]["g"]) &
                             (np.abs(t[0]["g"]) > 1e-300)])[:50]
    fk = ({"key": gk, "w": r.standard_normal(len(gk))},
          {"key": "double", "w": "double"}, {})
    return {"t": t, "d": d, "dn": dn, "dup": dup, "e": e, "nk": nk,
            "fk": fk}


def _c7_tables():
    """The tables of ``tests/test_torch_groupby.py``'s C6 paths."""
    r = np.random.default_rng(6)
    n = 300
    a = {"k": r.integers(-5, 20, n).astype(np.int64),
         "v": r.standard_normal(n), "z": np.full(n, -0.0),
         "s": np.array(["x", "y"], dtype=object)[r.integers(0, 2, n)],
         "dt": r.integers(9000, 9060, n).astype(np.int32),
         "wide": r.integers(0, 5000, n).astype(np.int64)}
    b = {"k": np.arange(-5, 20, dtype=np.int64), "w": np.full(25, -0.0)}
    types = {"k": "bigint", "v": "double", "z": "double", "s": "string",
             "dt": "date", "wide": "bigint", "w": "double"}
    return {"a": (a, {c: types[c] for c in a}, {}),
            "b": (b, {c: types[c] for c in b}, {})}


def _sessions(tables, conf):
    from spark_rapids_tpu.api import Session as RSession
    from spark_rapids_tpu.columnar import dtypes as rdt
    from spark_rapids_tpu.columnar.batch import Schema as RSchema
    from spark_rapids_tpu.plan import nodes as rpn

    from spark_rapids_tpu_torch.api import Session
    from spark_rapids_tpu_torch.columnar import dtypes as tdt
    from spark_rapids_tpu_torch.columnar.batch import Schema
    from spark_rapids_tpu_torch.plan import nodes as pn

    rs, s = RSession({**_REF, **conf}), Session(dict(conf), device="cpu")
    for name, (cols, types, valid) in tables.items():
        names = list(cols)
        rs.create_temp_view(name, rpn.InMemorySource(
            dict(cols), RSchema(names, [rdt.by_name(types[c])
                                        for c in names]),
            validity=dict(valid)))
        s.create_temp_view(name, pn.InMemorySource(
            dict(cols), Schema(names, [tdt.by_name(types[c])
                                       for c in names]),
            validity=dict(valid)))
    return rs, s


def shape(exec_):
    """The exec tree in pre-order, each fused exec's builds after its
    children: (class, the fused steps in order, or a join's kind);
    exchange wrappers, which the port has none of, left out. Works on
    both engines' trees."""
    out = []

    def walk(n):
        name = type(n).__name__
        if name not in _SKIP:
            extra = None
            if name.startswith("Fused"):
                extra = "".join(
                    "J" + st.kind if type(st).__name__ == "JoinStep"
                    else type(st).__name__[0] for st in n.chain.steps)
            elif name == "BroadcastHashJoinExec":
                extra = n.kind
            out.append((_ALIAS.get(name, name), extra))
        for c in n.children:
            walk(c)
        if name.startswith("Fused"):
            for b in n.builds:
                walk(b)
    walk(exec_)
    return out


def _token(v, floating):
    if v is None or (isinstance(v, float) and np.isnan(v)):
        return ("null",)
    if floating:
        return ("f", int(np.float64(v).view(np.int64)))
    if isinstance(v, (str, bytes)):
        return str(v)
    return int(v)


def _rows(frame: dict, ordered: bool, floating):
    """The rows as tuples of tokens; ``floating``: per column, whether
    its values compare by bit pattern (the port's column types decide,
    as the reference's frames hold an integer column with nulls as
    floats)."""
    cols = [[_token(v, f) for v in frame[name]]
            for name, f in zip(frame, floating)]
    rows = list(zip(*cols)) if cols else []
    return rows if ordered else sorted(rows, key=repr)


class _Pair:
    """One reference and one port session over the same tables; each
    query runs once per engine, its result and tree kept."""

    def __init__(self, tables, conf):
        self.rs, self.s = _sessions(tables, conf)
        self.conf = conf
        self.memo = {}

    def run(self, text: str):
        if text not in self.memo:
            from spark_rapids_tpu.config import RapidsConf
            from spark_rapids_tpu.execs.base import collect as rcollect
            from spark_rapids_tpu.plan.overrides import \
                apply_overrides as rapply

            from spark_rapids_tpu_torch.execs.base import collect
            from spark_rapids_tpu_torch.plan.overrides import \
                apply_overrides

            rexec = rapply(self.rs.sql(text)._plan,
                           RapidsConf({**_REF, **self.conf}))
            want = rcollect(rexec)
            texec = apply_overrides(self.s.sql(text)._plan, self.conf,
                                    device="cpu")
            got = collect(texec)
            self.memo[text] = ({c: list(want[c].to_numpy(dtype=object)
                                        if want[c].dtype.kind != "f"
                                        else want[c].to_numpy())
                                for c in want.columns},
                               got, shape(rexec), shape(texec), texec)
        return self.memo[text]


@pytest.fixture(scope="module")
def pairs():
    return {"dense": _Pair(_tables(), dict(_BATCH)),
            "hash": _Pair(_tables(), {**_BATCH, **_HASH}),
            "no_sort_tail": _Pair(_tables(), {**_BATCH, **_NO_SORT_TAIL}),
            "c7": _Pair(_c7_tables(), {})}


def _floating(exec_):
    return [t.is_floating for t in exec_.schema.types]


def _check(pair, text, ordered=False, sums=False):
    """Rows bit for bit (``sums``: float columns within 1e-9 relative,
    rows matched on the others) and the tree shape."""
    want, got, rshape, tshape, texec = pair.run(text)
    assert list(got) == list(want)
    fl = _floating(texec)
    if not sums:
        assert _rows(got, ordered, fl) == _rows(want, ordered, fl)
    else:
        exact = [not f for f in fl]
        g, w = (_rows({c: frame[c] for c, e in zip(frame, exact) if e},
                      True, [False] * sum(exact)) for frame in (got, want))
        go = list(range(len(g))) if ordered else \
            sorted(range(len(g)), key=lambda i: repr(g[i]))
        wo = list(range(len(w))) if ordered else \
            sorted(range(len(w)), key=lambda i: repr(w[i]))
        assert [g[i] for i in go] == [w[i] for i in wo]
        for c, f in zip(got, fl):
            if f:
                gv, wv = (np.array([np.nan if v is None else v
                                    for v in frame[c]],
                                   np.float64)[order]
                          for frame, order in ((got, go), (want, wo)))
                np.testing.assert_allclose(gv, wv, rtol=1e-9, atol=0,
                                           err_msg=c)
    assert tshape == rshape
    return texec


@pytest.mark.parametrize("case", range(13))
def test_c7_queries_match_reference_default_session(pairs, case):
    """Every query of ``tests/test_torch_groupby.py::_C6_PATHS`` gives the
    reference's signs of min(z) in the port's default session (C7), with
    the reference's fused tree."""
    from test_torch_groupby import _C6_PATHS

    assert all(q in _C6_PATHS for q in C7_FAILING_UNFUSED)
    _check(pairs["c7"], _C6_PATHS[case])


@pytest.mark.parametrize("text", C7_FAILING_UNFUSED)
def test_c7_queries_keep_negative_zero(pairs, text):
    """The three queries where the unfused tree loses the key's
    statistics: the dense path keeps min(-0.0) = -0.0, and the port's
    tree holds fused execs where the unfused one has none."""
    got = pairs["c7"].run(text)[1]
    assert len(got["m"]) > 0
    assert np.signbit(np.asarray(got["m"], np.float64)).all()
    assert any(name.startswith("Fused") for name, _ in
               pairs["c7"].run(text)[3])


@pytest.mark.parametrize("case", sorted(_CASES))
def test_fused_tree_matches_reference_default_session(pairs, case):
    _check(pairs["dense"], _CASES[case], case in _ORDERED, case in _SUMS)


@pytest.mark.parametrize("case", sorted(c for c in _CASES
                                        if "JOIN" in _CASES[c]))
def test_hash_mode_joins_match_reference_default_session(pairs, case):
    """The join cases again with a 16-slot dense-probe ceiling in both
    engines, so every integral build key probes by hash."""
    _check(pairs["hash"], _CASES[case], case in _ORDERED, case in _SUMS)


@pytest.mark.parametrize("case", sorted(_ORDERED))
def test_sort_tail_off_matches_reference(pairs, case):
    """``rapids.tpu.sql.fusion.sortTail`` false in both engines: the
    ORDER BY stays a ``SortExec`` over the chain, with the same rows in
    the same order."""
    texec = _check(pairs["no_sort_tail"], _CASES[case], True,
                   case in _SUMS)
    assert shape(texec)[0][0] in ("LimitExec", "SortExec")
    assert any(name == "SortExec" for name, _ in shape(texec))


@pytest.mark.parametrize("mode", ["dense", "hash"])
def test_chain_join_modes(pairs, mode):
    """A build key of 25 values probes through the dense table by
    default and by hash past a 16-slot ``denseProbe.maxSpan``; a float
    key always by hash."""
    from spark_rapids_tpu_torch.execs.fused import fusion_summary

    texec = _check(pairs[mode], _CASES["inner"])
    summary = fusion_summary(texec)
    assert summary["chains"] == 1 and summary["fell_back"] == 0
    assert summary["dense_joins" if mode == "dense" else "hash_joins"] == 1
    fexec = _check(pairs[mode], _CASES["join_float_key"])
    assert fusion_summary(fexec)["hash_joins"] == 1


def test_repeated_build_keys_fall_back(pairs):
    """A build whose key hashes repeat runs the unfused subtree, which
    the tree shows, and its rows are the reference's."""
    from spark_rapids_tpu_torch.execs.fused import (fusion_summary,
                                                    tree_string)

    for case in ("repeated_keys_fall_back", "repeated_keys_aggregate"):
        texec = _check(pairs["dense"], _CASES[case])
        assert fusion_summary(texec)["fell_back"] == 1
        assert "FELL BACK" in tree_string(texec)


def test_unique_build_flags_repeated_hashes_not_keys():
    """The duplicate test reads hashes: two different keys of one hash
    fall back, as in the reference (here the hash is forced equal)."""
    from spark_rapids_tpu_torch.columnar import dtypes as tdt
    from spark_rapids_tpu_torch.columnar.batch import batch_from_numpy
    from spark_rapids_tpu_torch.ops import join as join_ops

    b = batch_from_numpy([np.array([3, 9], np.int64)], [tdt.INT64],
                         device="cpu")
    ok = join_ops.prepare_unique_build(b, [0], [tdt.INT64], [tdt.INT64], 0)
    assert ok.ok and ok.ptable is not None and ok.n_valid == 2
    orig = join_ops.hash_keys
    join_ops.hash_keys = lambda *a: torch.zeros(2, dtype=torch.int64)
    try:
        same = join_ops.prepare_unique_build(b, [0], [tdt.INT64],
                                             [tdt.INT64], 0)
    finally:
        join_ops.hash_keys = orig
    assert not same.ok


def test_fusion_off_gives_the_unfused_tree():
    """``rapids.tpu.sql.fusion.enabled`` false: no fused exec, the
    tree the port ran before fusion, and the same rows."""
    from spark_rapids_tpu_torch.execs.base import collect
    from spark_rapids_tpu_torch.plan.overrides import apply_overrides

    _rs, s = _sessions(_tables(), dict(_BATCH))
    text = _CASES["two_joins_aggregate"]
    off = apply_overrides(s.sql(text)._plan,
                          {**_BATCH, "rapids.tpu.sql.fusion.enabled": False},
                          device="cpu")
    assert not any(n.startswith("Fused") for n, _ in shape(off))
    on = apply_overrides(s.sql(text)._plan, dict(_BATCH), device="cpu")
    assert any(n.startswith("Fused") for n, _ in shape(on))
    fl = _floating(on)
    assert _rows(collect(on), False, fl) == _rows(collect(off), False, fl)


def test_unknown_fusion_key_is_refused():
    from spark_rapids_tpu_torch.plan.overrides import apply_overrides
    from spark_rapids_tpu_torch.plan.nodes import InMemorySource, ScanNode

    scan = ScanNode(InMemorySource({"x": np.arange(3, dtype=np.int64)}))
    with pytest.raises(ValueError, match="unknown conf keys"):
        apply_overrides(scan, {"rapids.tpu.sql.fusion.inProgramBuild."
                               "enabled": False}, device="cpu")


def test_float_sums_equal_between_the_ports_trees():
    """The live mask keeps rows in place, so a group's floats fold in the
    order the unfused tree's compaction gives them: the sums are bit
    equal, on the sort path (S1's order) and in the grand sum."""
    from spark_rapids_tpu_torch.execs.base import collect
    from spark_rapids_tpu_torch.plan.overrides import apply_overrides

    _rs, s = _sessions(_tables(), dict(_BATCH))
    for text in ("SELECT h, sum(f) AS sf FROM t WHERE g > 0.0 GROUP BY h",
                 "SELECT k, sum(f) AS sf, sum(g) AS sg FROM t "
                 "WHERE s IN ('x', 'b') GROUP BY k",
                 "SELECT sum(f * g) AS p FROM t WHERE h > 0.0"):
        plan = s.sql(text)._plan
        on = apply_overrides(plan, dict(_BATCH), device="cpu")
        off = apply_overrides(plan, {**_BATCH,
                                     "rapids.tpu.sql.fusion.enabled": False},
                              device="cpu")
        assert any(n.startswith("Fused") for n, _ in shape(on)), text
        fl = _floating(on)
        assert _rows(collect(on), False, fl) == \
            _rows(collect(off), False, fl), text
