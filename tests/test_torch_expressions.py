"""The expressions of ROADMAP A5 against the reference engine on the CPU:
``expressions/arithmetic`` (remainder, pmod, integral divide, unary
minus and plus, abs, signum), ``expressions/predicates`` (IS NULL,
isnan, ``<=>``, AtLeastNNonNulls), ``expressions/conditional`` (CASE,
coalesce, nvl, nanvl, greatest, least), ``expressions/math`` whole and
the central moments (variance and stddev, sample and population).

Each expression of each module runs in one projection per engine over
the same seeded columns: doubles with -0.0, NaN, the infinities, 1e-310
and the halves that round away from zero at scales 0, 2 and 7; int32
and int64 with their limits, -1 and 0; nulls in one column of each. The
reference runs its compiled projection, as its engine does, so its XLA
backend's flush of subnormals, its folding and its fused multiply-adds
are in what it gives. Results compare by bit pattern where valid, and
validity exactly; the incompatible transcendentals (run with
``rapids.tpu.sql.incompatibleOps.enabled`` in both engines) and cbrt
within the ulps ``_INCOMPAT_ULPS`` states, and the port refuses the
incompatible ones without the key.
Then the SQL forms of the reference's planner through both ``Session``s,
and the moments on the dense path, the sort path and with no key
(single-row, all-null and constant groups), in one batch and in 16-row
batches.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spark_rapids_tpu.api import Session as RSession  # noqa: E402
from spark_rapids_tpu.columnar import dtypes as rdt  # noqa: E402
from spark_rapids_tpu.config import RapidsConf  # noqa: E402
from spark_rapids_tpu.execs.base import collect as rcollect  # noqa: E402
from spark_rapids_tpu.expressions import arithmetic as rar  # noqa: E402
from spark_rapids_tpu.expressions import conditional as rcond  # noqa: E402
from spark_rapids_tpu.expressions import math as rmath  # noqa: E402
from spark_rapids_tpu.expressions import predicates as rpred  # noqa: E402
from spark_rapids_tpu.expressions.base import Alias as RAlias  # noqa: E402
from spark_rapids_tpu.expressions.base import (  # noqa: E402
    BoundReference as RRef)
from spark_rapids_tpu.expressions.base import Literal as RLit  # noqa: E402
from spark_rapids_tpu.plan import nodes as rpn  # noqa: E402
from spark_rapids_tpu.plan.overrides import (  # noqa: E402
    apply_overrides as rapply)

from spark_rapids_tpu_torch.api import Session  # noqa: E402
from spark_rapids_tpu_torch.columnar import dtypes as tdt  # noqa: E402
from spark_rapids_tpu_torch.execs.base import collect  # noqa: E402
from spark_rapids_tpu_torch.expressions import (  # noqa: E402
    arithmetic as tar)
from spark_rapids_tpu_torch.expressions import (  # noqa: E402
    conditional as tcond)
from spark_rapids_tpu_torch.expressions import math as tmath  # noqa: E402
from spark_rapids_tpu_torch.expressions import (  # noqa: E402
    predicates as tpred)
from spark_rapids_tpu_torch.expressions.base import Alias  # noqa: E402
from spark_rapids_tpu_torch.expressions.base import (  # noqa: E402
    BoundReference, Literal)
from spark_rapids_tpu_torch.plan import nodes as pn  # noqa: E402
from spark_rapids_tpu_torch.plan.overrides import (  # noqa: E402
    apply_overrides)

_INCOMPAT = "rapids.tpu.sql.incompatibleOps.enabled"
_N = 320

# the columns: name -> (type name, nullable)
_COLS = {"d": ("double", False), "e": ("double", True),
         "r": ("double", False), "i": ("int", True), "l": ("bigint", False),
         "j": ("bigint", True), "b": ("tinyint", False)}


def _data():
    """The seeded columns and their validity."""
    r = np.random.default_rng(14)
    edges = [0.0, -0.0, 1e-310, -1e-310, np.nan, np.inf, -np.inf, 0.5,
             -0.5, 1.5, -2.5, 1e308, -1e308, 3.0, 7.0, -7.0, 1.0, -1.0,
             2.0 ** 53, -(2.0 ** 63), 2.0 ** 63, 1e-300]
    d = r.standard_normal(_N) * 10.0 ** r.integers(-6, 7, _N)
    d[:len(edges)] = edges
    e = r.standard_normal(_N) * 10.0 ** r.integers(-3, 4, _N)
    e[:len(edges)] = edges[::-1]
    e[len(edges):2 * len(edges)] = edges
    # halves at scales 0, 2 and 7: k + 0.5, k / 100 + 0.005, k / 1e7 +
    # 5e-8, either sign
    k = r.integers(-10_000, 10_000, _N)
    half = np.choose(r.integers(0, 3, _N),
                     [k + 0.5, k / 100 + 0.005, k / 1e7 + 5e-8])
    half[:len(edges)] = edges
    i = r.integers(-100, 100, _N).astype(np.int32)
    i[:6] = [0, -1, 1, -2 ** 31, 2 ** 31 - 1, 7]
    l = r.integers(-2 ** 62, 2 ** 62, _N).astype(np.int64)
    l[:6] = [0, -1, 1, -2 ** 63, 2 ** 63 - 1, -7]
    j = r.integers(-6, 6, _N).astype(np.int64)
    j[6:12] = [0, -1, 1, 0, -1, 1]
    b = r.integers(-128, 128, _N).astype(np.int8)
    cols = {"d": d, "e": e, "r": half, "i": i, "l": l, "j": j, "b": b}
    valid = {name: r.random(_N) > 0.15 for name, (_, nullable)
             in _COLS.items() if nullable}
    return cols, valid


def _sources():
    from spark_rapids_tpu.columnar.batch import Schema as RSchema

    from spark_rapids_tpu_torch.columnar.batch import Schema

    cols, valid = _data()
    names = list(_COLS)
    types = [t for t, _ in _COLS.values()]
    return (rpn.InMemorySource(dict(cols), RSchema(
                names, [rdt.by_name(t) for t in types]), validity=valid),
            pn.InMemorySource(dict(cols), Schema(
                names, [tdt.by_name(t) for t in types]), validity=valid))


# each case: (class name, arguments): a str is a column, a tuple a literal
# (type name, value), a list a nested case
_ARITH = {
    "remainder_dd": ("Remainder", ["d", "e"]),
    "remainder_ii": ("Remainder", ["i", "j"]),
    "remainder_li": ("Remainder", ["l", "i"]),
    "remainder_lit_subnormal": ("Remainder", ["d", ("double", 1e-310)]),
    "remainder_lit_zero": ("Remainder", ["e", ("double", 0.0)]),
    "remainder_lit_neg1": ("Remainder", ["l", ("bigint", -1)]),
    "pmod_dd": ("Pmod", ["d", "e"]),
    "pmod_ij": ("Pmod", ["i", "j"]),
    "pmod_li": ("Pmod", ["l", "i"]),
    "pmod_lit": ("Pmod", ["d", ("double", 0.7)]),
    "pmod_neg_lit": ("Pmod", ["e", ("double", -0.5)]),
    "pmod_int_lit": ("Pmod", ["l", ("bigint", -3)]),
    "pmod_byte": ("Pmod", ["b", ("tinyint", 5)]),
    "div_li": ("IntegralDivide", ["l", "i"]),
    "div_ij": ("IntegralDivide", ["i", "j"]),
    "div_lit_neg1": ("IntegralDivide", ["l", ("bigint", -1)]),
    "minus_d": ("UnaryMinus", ["d"]),
    "minus_i": ("UnaryMinus", ["i"]),
    "minus_l": ("UnaryMinus", ["l"]),
    "plus_e": ("UnaryPositive", ["e"]),
    "abs_d": ("Abs", ["d"]),
    "abs_i": ("Abs", ["i"]),
    "abs_l": ("Abs", ["l"]),
    "signum_d": ("Signum", ["d"]),
    "signum_l": ("Signum", ["l"]),
}
_PRED = {
    "is_null_e": ("IsNull", ["e"]),
    "is_null_d": ("IsNull", ["d"]),
    "is_nan_e": ("IsNaN", ["e"]),
    "is_nan_d": ("IsNaN", ["d"]),
    "null_safe_dd": ("EqualNullSafe", ["d", "e"]),
    "null_safe_ij": ("EqualNullSafe", ["i", "j"]),
    "null_safe_null": ("EqualNullSafe", ["j", ("bigint", None)]),
}
_COND = {
    "case_two": ("CaseWhen", [("GreaterThan", ["d", ("double", 0.0)]),
                              "d", ("IsNull", ["j"]), "e", "r"]),
    "case_no_else": ("CaseWhen", [("LessThan", ["i", ("int", 0)]), "l"]),
    "case_null_pred": ("CaseWhen", [("GreaterThan", ["e", ("double", 1.0)]),
                                    "e", ("double", -1.5)]),
    "coalesce": ("Coalesce", ["e", "r", ("double", 0.0)]),
    "coalesce_int": ("Coalesce", ["j", "l"]),
    "nvl": ("Nvl", ["i", ("int", 3)]),
    "nanvl": ("NaNvl", ["e", "d"]),
    "greatest_dd": ("Greatest", ["d", "e"]),
    "greatest_ddr": ("Greatest", ["e", "d", ("double", -0.0)]),
    "least_dd": ("Least", ["d", "e"]),
    "least_ed0": ("Least", ["e", "d", ("double", 0.0)]),
    "greatest_jl": ("Greatest", ["j", "l"]),
    "least_jl": ("Least", ["j", "l"]),
}
_MATH = {
    "sqrt_d": ("Sqrt", ["d"]),
    "sqrt_abs_e": ("Sqrt", [("Abs", ["e"])]),
    "sqrt_l": ("Sqrt", ["l"]),
    "floor_d": ("Floor", ["d"]),
    "floor_r": ("Floor", ["r"]),
    "ceil_d": ("Ceil", ["d"]),
    "ceil_i": ("Ceil", ["i"]),
    "rint_r": ("Rint", ["r"]),
    "degrees": ("ToDegrees", ["d"]),
    "radians": ("ToRadians", ["e"]),
    "round_d": ("Round", ["d"]),
    "round_r0": ("Round", ["r"]),
    "round_r2": ("Round", ["r", 2]),
    "round_r7": ("Round", ["r", 7]),
    "round_d7": ("Round", ["d", 7]),
    "round_e2": ("Round", ["e", 2]),
    "round_neg_scale": ("Round", ["d", -2]),
    "round_int_neg": ("Round", ["i", -1]),
    "round_long_neg": ("Round", ["l", -3]),
    "round_int_pos": ("Round", ["j", 2]),
}
# the incompatible functions: case -> (class, arguments, ulps); the gap
# between XLA's and torch's CPU approximations over these inputs
_INCOMPAT_CASES = {
    "exp": ("Exp", ["e"]), "expm1": ("Expm1", ["e"]),
    "log": ("Log", ["d"]), "log1p": ("Log1p", ["e"]),
    "log2": ("Log2", ["d"]), "log10": ("Log10", ["d"]),
    "sin": ("Sin", ["e"]), "cos": ("Cos", ["e"]), "tan": ("Tan", ["e"]),
    "asin": ("Asin", ["r"]), "acos": ("Acos", ["r"]),
    "atan": ("Atan", ["d"]), "sinh": ("Sinh", ["e"]),
    "cosh": ("Cosh", ["e"]), "tanh": ("Tanh", ["d"]),
    "asinh": ("Asinh", ["d"]), "acosh": ("Acosh", ["d"]),
    "atanh": ("Atanh", ["r"]), "cot": ("Cot", ["e"]),
    "pow": ("Pow", ["e", "r"]), "logarithm": ("Logarithm", ["r", "d"]),
    "atan2": ("Atan2", ["d", "e"]), "cbrt": ("Cbrt", ["d"]),
}
# (cbrt over d's subnormals is left out: see ``_INCOMPAT_ULPS``)
#: the largest gap in units in the last place over the inputs above,
#: per function (XLA's sinh and cosh of |x| near 700 and its log1p are
#: the least accurate); cbrt is not incompatible in the reference, but
#: XLA's misses the true root by up to 101 ulps and reads a subnormal
#: as a number near 2^-356 of it
_INCOMPAT_ULPS = {"exp": 1, "expm1": 3, "log": 0, "log1p": 32,
                  "log2": 1, "log10": 1, "sin": 1, "cos": 1, "tan": 0,
                  "asin": 1, "acos": 0, "atan": 0, "sinh": 398,
                  "cosh": 398, "tanh": 4, "asinh": 1, "acosh": 1,
                  "atanh": 1, "cot": 0, "pow": 0, "logarithm": 0,
                  "atan2": 1, "cbrt": 101}
_MODULES = {"arith": _ARITH, "pred": _PRED, "cond": _COND, "math": _MATH}


def _ns(engine):
    mods = ((rar, rpred, rcond, rmath) if engine == "ref" else
            (tar, tpred, tcond, tmath))
    lit, ref, dtm = ((RLit, RRef, rdt) if engine == "ref" else
                     (Literal, BoundReference, tdt))
    return mods, lit, ref, dtm


def _build(engine, spec):
    mods, lit, ref, dtm = _ns(engine)
    if isinstance(spec, str):
        o = list(_COLS).index(spec)
        return ref(o, dtm.by_name(_COLS[spec][0]))
    if isinstance(spec, tuple) and isinstance(spec[1], list):
        name, args = spec
        klass = next(getattr(m, name) for m in mods if hasattr(m, name))
        if name == "Round":
            return klass(_build(engine, args[0]),
                         *(args[1:] if len(args) > 1 else []))
        built = [_build(engine, a) for a in args]
        if name == "CaseWhen":
            pairs = list(zip(built[0::2], built[1::2]))
            els = built[-1] if len(built) % 2 else None
            return klass(pairs[:len(built) // 2], els)
        if name in ("Coalesce", "Greatest", "Least"):
            return klass(built)
        return klass(*built)
    t, v = spec
    return lit(v, dtm.by_name(t))


def _run(cases, conf=None):
    """Both engines' projections of ``cases``: {case: (ref, port)}."""
    rsrc, tsrc = _sources()
    names = list(cases)
    rplan = rpn.ProjectNode([RAlias(_build("ref", cases[c]), c)
                             for c in names], rpn.ScanNode(rsrc))
    tplan = pn.ProjectNode([Alias(_build("port", cases[c]), c)
                            for c in names], pn.ScanNode(tsrc))
    want = rcollect(rapply(rplan, RapidsConf(dict(conf or {}))))
    got = collect(apply_overrides(tplan, conf, device="cpu"))
    return {c: (want[c].to_numpy(), np.asarray(got[c])) for c in names}


@pytest.fixture(scope="module")
def projected():
    cases = {f"{m}-{c}": spec for m, table in _MODULES.items()
             for c, spec in table.items()}
    return _run(cases)


def _null(v) -> bool:
    return v is None or (isinstance(v, float) and v != v)


def _assert_same(got, want, what):
    """Value for value: a float by its bit pattern, anything else by
    equality; a null and a NaN alike, as the reference's frames hold a
    null float as NaN."""
    got = np.asarray(got, dtype=object).tolist()
    want = np.asarray(want, dtype=object).tolist()
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        if _null(a) or _null(b):
            assert _null(a) and _null(b), (what, i, a, b)
        elif isinstance(a, float) or isinstance(b, float):
            assert np.float64(a).view(np.int64) == \
                np.float64(b).view(np.int64), (what, i, a, b)
        else:
            assert a == b, (what, i, a, b)


@pytest.mark.parametrize("case", [f"{m}-{c}" for m, table in
                                  _MODULES.items() for c in table])
def test_expression_matches_reference_bit_for_bit(projected, case):
    want, got = projected[case]
    assert len(got) == len(want) == _N
    _assert_same(got, want, case)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The distance of two doubles in units in the last place (0 for two
    NaN)."""
    ia = a.view(np.int64).astype(object)
    ib = b.view(np.int64).astype(object)
    out = []
    for x, y, fa, fb in zip(ia, ib, a, b):
        if np.isnan(fa) and np.isnan(fb):
            out.append(0)
            continue
        if np.isnan(fa) or np.isnan(fb):
            out.append(1 << 62)
            continue
        # order the bit patterns as integers of the doubles' order
        sx = x if x >= 0 else -(x & ((1 << 63) - 1))
        sy = y if y >= 0 else -(y & ((1 << 63) - 1))
        out.append(abs(sx - sy))
    return np.array(out)


def test_incompatible_functions_within_stated_ulps():
    """With ``rapids.tpu.sql.incompatibleOps.enabled`` in both engines:
    every value within ``_INCOMPAT_ULPS`` of the reference's, nulls
    alike (the gap is listed in ROADMAP Queue C)."""
    res = _run(_INCOMPAT_CASES, {_INCOMPAT: True})
    worst = {}
    normal = np.abs(_data()[0]["d"]) >= np.finfo(np.float64).tiny
    for case, (want, got) in res.items():
        w = np.array([np.nan if v is None else v for v in want], np.float64)
        g = np.array([np.nan if v is None else v for v in got], np.float64)
        u = _ulps(g, w)
        worst[case] = int((u[normal | (_data()[0]["d"] == 0)]
                           if case == "cbrt" else u).max())
    assert all(worst[c] <= _INCOMPAT_ULPS[c] for c in worst), \
        sorted(worst.items())


@pytest.mark.parametrize("text", [
    "SELECT exp(d) AS x FROM t", "SELECT pow(d, 2.0) AS x FROM t",
    "SELECT k FROM t WHERE sin(d) > 0.5"])
def test_incompatible_function_refused_without_the_key(text):
    """Without the key the reference runs such a projection on its CPU
    engine, which is not ported: the port refuses the plan, naming the
    key and where the CPU engine waits (ROADMAP A6)."""
    s = Session(device="cpu")
    s.create_temp_view("t", pn.InMemorySource(
        {"k": np.arange(4, dtype=np.int64), "d": np.linspace(0, 1, 4)}))
    df = s.sql(text)
    with pytest.raises(NotImplementedError, match=_INCOMPAT) as err:
        df.collect()
    assert "A6" in str(err.value)


# -- SQL forms ----------------------------------------------------------------

_SQL_FORMS = {
    "case_searched": "CASE WHEN d > 0.0 THEN d WHEN j IS NULL THEN e "
                     "ELSE -1.5 END",
    "case_simple": "CASE j WHEN 1 THEN d WHEN 2 THEN e END",
    "case_null_branch": "CASE WHEN j > 0 THEN NULL ELSE d END",
    "is_null": "j IS NULL",
    "is_not_null": "e IS NOT NULL",
    "unary_minus": "-d",
    "unary_minus_int": "-i",
    "negated_product_plus": "-(d * e) + r",
    "remainder": "d % e",
    "remainder_int": "i % j",
    "abs": "abs(d)",
    "sqrt": "sqrt(r)",
    "floor": "floor(d)",
    "ceil": "ceil(e)",
    "coalesce": "coalesce(e, r, 0.0)",
    "nvl": "nvl(j, 3)",
    "round2": "round(r, 2)",
    "round7": "round(r, 7)",
    "round0": "round(d)",
    "pmod": "pmod(l, i)",
    "pmod_float": "pmod(d, 0.25)",
    "nullif": "nullif(i, 7)",
    "greatest": "greatest(d, e, r)",
    "least": "least(d, e)",
    "datediff": "datediff(dt, '2001-03-16')",
    "to_date": "datediff(to_date('2001-01-01'), dt)",
    "date_plus_interval": "datediff(dt + INTERVAL '3' DAY, dt)",
    "unix_timestamp": "unix_timestamp(dt)",
}


def _sessions(batch_rows=None):
    """The two engines' sessions over t = the columns plus a DATE dt."""
    from spark_rapids_tpu.columnar.batch import Schema as RSchema

    from spark_rapids_tpu_torch.columnar.batch import Schema

    cols, valid = _data()
    cols = dict(cols, dt=np.random.default_rng(3).integers(
        11000, 12000, _N).astype(np.int32))
    names = list(cols)
    types = [t for t, _ in _COLS.values()] + ["date"]
    conf = {} if batch_rows is None else \
        {"rapids.tpu.sql.reader.batchSizeRows": batch_rows}
    rs = RSession(conf)
    rs.create_temp_view("t", rpn.InMemorySource(dict(cols), RSchema(
        names, [rdt.by_name(t) for t in types]), validity=valid))
    s = Session(conf, device="cpu")
    s.create_temp_view("t", pn.InMemorySource(dict(cols), Schema(
        names, [tdt.by_name(t) for t in types]), validity=valid))
    return rs, s


@pytest.fixture(scope="module")
def sql_forms():
    rs, s = _sessions()
    text = "SELECT " + ", ".join(f"{e} AS {c}" for c, e in
                                  _SQL_FORMS.items()) + " FROM t"
    return rs.sql(text).collect(), s.sql(text).collect()


@pytest.mark.parametrize("form", sorted(_SQL_FORMS))
def test_sql_form_matches_reference_engine(sql_forms, form):
    """Each form the reference's planner maps, planned by the port's and
    run over the same table, bit for bit."""
    want, got = sql_forms
    _assert_same(got[form], want[form].to_numpy(), form)


def test_case_takes_its_first_typed_branch_type():
    """CASE's type is its first typed branch's in both planners, even
    where Spark would widen: ``CASE WHEN j > 0 THEN j ELSE 0.5 END`` is a
    bigint. The reference's column holds 0.5 where the ELSE branch is
    taken (its select promotes the data, not the declared type: ROADMAP
    Queue C, found in the reference); the port's holds the bigint 0."""
    rs, s = _sessions()
    text = "SELECT CASE WHEN j > 0 THEN j ELSE 0.5 END AS c FROM t"
    assert rs.sql(text)._plan.output_schema().types[0].name == "bigint"
    assert s.sql(text)._plan.output_schema().types == [tdt.INT64]
    want = rs.sql(text).collect()["c"].to_numpy()
    got = s.sql(text).collect()["c"]
    then = np.array([w is not None and w == w and w != 0.5 for w in want])
    assert then.sum() > 0 and (~then).sum() > 0
    assert [int(v) for v in got[then]] == [int(v) for v in want[then]]
    assert all(v in (0, None) for v in got[~then])


# -- central moments ----------------------------------------------------------


def _moment_sessions(batch_rows):
    """Sessions over m: a small key (dense path), a wide one (sort path),
    x ~ N(3, 10) with -0.0, a subnormal and a NaN, and xi (int) with
    nulls; group 0 has one row, group 1 only null xi, group 2 a constant
    x."""
    r = np.random.default_rng(23)
    n = 600
    k = r.integers(3, 40, n).astype(np.int64)
    k[:1] = 0
    k[1:5] = 1
    k[5:12] = 2
    x = r.standard_normal(n) * 10 + 3
    x[5:12] = 2.5
    x[20:23] = [-0.0, 1e-310, np.nan]
    xi = r.integers(-50, 50, n).astype(np.int32)
    valid = r.random(n) > 0.2
    valid[1:5] = False
    cols = {"k": k, "w": k * 1_000_003, "x": x, "xi": xi}
    conf = {"rapids.tpu.sql.reader.batchSizeRows": batch_rows}
    rs = RSession(conf)
    rs.create_temp_view("m", rpn.InMemorySource(dict(cols),
                                                validity={"xi": valid}))
    s = Session(conf, device="cpu")
    s.create_temp_view("m", pn.InMemorySource(dict(cols),
                                              validity={"xi": valid}))
    return rs, s


_MOMENTS = ("stddev_samp(x) AS a, var_pop(x) AS b, stddev_pop(xi) AS c, "
            "variance(xi) AS d, var_samp(x) AS e, stddev(xi) AS f")


@pytest.mark.parametrize("batch_rows", [16, 1 << 21])
@pytest.mark.parametrize("path", ["dense", "sort", "grand",
                                  "grand_empty"])
def test_moments_match_reference_engine(path, batch_rows):
    """variance and stddev on the dense path (k: 38 slots), the sort path
    (w: past 128) and with no key: within 1e-9 relative, NaN for a
    sample moment of one row, null for no valid row, 0 for a constant
    group; in one batch and in 16-row batches (the merge adds each
    batch's m2 and rterm)."""
    text = {"dense": f"SELECT k, {_MOMENTS} FROM m GROUP BY k ORDER BY k",
            "sort": f"SELECT w, {_MOMENTS} FROM m GROUP BY w ORDER BY w",
            "grand": f"SELECT {_MOMENTS} FROM m WHERE k <> 7",
            "grand_empty": f"SELECT {_MOMENTS} FROM m WHERE k > 100"}[path]
    rs, s = _moment_sessions(batch_rows)
    want, got = rs.sql(text).collect(), s.sql(text).collect()
    assert list(got) == list(want.columns)
    for name in want.columns:
        w = want[name].to_numpy()
        g = np.array([np.nan if v is None else v for v in got[name]],
                     np.float64)
        assert len(g) == len(w), name
        np.testing.assert_allclose(g, w.astype(np.float64), rtol=1e-9,
                                   atol=0, err_msg=name)
        if name == "b" and path in ("dense", "sort"):
            assert w[2] == 0.0 and g[2] == 0.0  # the constant group
    if path in ("dense", "sort"):
        assert np.isnan(got["a"][0])  # one row: NaN, not null
        assert got["d"][1] is None  # no valid row: null
    if path == "grand_empty":
        assert all(got[c][0] is None for c in got)
