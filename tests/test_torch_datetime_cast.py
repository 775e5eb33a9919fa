"""The port's ``expressions/datetime.py`` and ``expressions/cast.py``
against the reference's, bit for bit on the CPU.

The same seeded numpy columns become a reference batch and a port batch,
and each expression of both modules is evaluated over both (the
reference's eager evaluation: a probe of its compiled projection through
``Session.sql`` gives the same bits for these casts, subnormals
included). Dates run from 1600 to 2400 with nulls; TIMESTAMPs lie either
side of the epoch. Casts cover every pair of the device types with
-0.0, NaN, infinities, subnormals and the saturation edges, string to
every type over a dictionary with invalid entries, and every type to
string. Values are compared by bit pattern where valid, and validity
exactly. Then ``CAST`` and the date functions through the port's SQL
front end against the reference's, and a cast of a literal folding to a
literal (``expressions.folding``), as both SQL planners fold it.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from spark_rapids_tpu.columnar import dtypes as rdt  # noqa: E402
from spark_rapids_tpu.expressions import base as rbase  # noqa: E402
from spark_rapids_tpu.expressions import cast as rcast  # noqa: E402
from spark_rapids_tpu.expressions import datetime as rdate  # noqa: E402

from spark_rapids_tpu_torch.columnar import dtypes as tdt  # noqa: E402
from spark_rapids_tpu_torch.expressions import base as tbase  # noqa: E402
from spark_rapids_tpu_torch.expressions import cast as tcast  # noqa: E402
from spark_rapids_tpu_torch.expressions import (  # noqa: E402
    datetime as tdate)
from tests.test_torch_ops import _port_batch, _reference_batch  # noqa: E402

_DAY_US = 86_400_000_000
_N = 240


def _dates(r):
    """int32 days from 1600-01-01 to 2400-12-31, the month edges of leap
    and common years and the epoch among them."""
    lo = int((np.datetime64("1600-01-01") -
              np.datetime64("1970-01-01")).astype(int))
    hi = int((np.datetime64("2400-12-31") -
              np.datetime64("1970-01-01")).astype(int))
    d = r.integers(lo, hi + 1, _N)
    edges = ["1600-02-29", "1700-02-28", "1700-03-01", "1900-02-28",
             "1969-12-31", "1970-01-01", "2000-02-29", "2000-12-31",
             "2100-03-01", "2400-02-29", "2400-12-31", "1600-01-01"]
    d[:len(edges)] = [int((np.datetime64(e) - np.datetime64("1970-01-01"))
                          .astype(int)) for e in edges]
    return d.astype(np.int32)


def _timestamps(r):
    """int64 microseconds either side of the epoch, on and off day and
    second boundaries."""
    t = r.integers(-400 * 365 * _DAY_US, 400 * 365 * _DAY_US, _N)
    t[:8] = [0, -1, 1, -_DAY_US, _DAY_US - 1, -_DAY_US - 1, -1_000_000,
             -3_600_000_001]
    return t.astype(np.int64)


def _columns():
    """date, date2, int days, timestamp, seconds; each with nulls."""
    r = np.random.default_rng(31)
    datas = [_dates(r), _dates(r), r.integers(-40000, 40000, _N).astype(
        np.int32), _timestamps(r), r.integers(-2**40, 2**40, _N)]
    types = ["date", "date", "int", "timestamp", "bigint"]
    valids = [r.random(_N) > 0.1 for _ in datas]
    return datas, types, valids


def _ref_eval(expr, batch, n):
    ctx = rbase.EvalContext.from_batch(batch)
    v = rbase.broadcast(expr.eval(ctx), ctx)
    data = np.asarray(jax.device_get(v.data))[:n]
    valid = np.ones(n, bool) if v.validity is None else \
        np.asarray(jax.device_get(v.validity))[:n]
    return data, valid, v


def _port_eval(expr, batch, n):
    ctx = tbase.EvalContext.from_batch(batch, "cpu")
    v = tbase.broadcast(expr.eval(ctx), ctx)
    valid = np.ones(n, bool) if v.validity is None else \
        v.validity.numpy()
    return v.data.numpy(), valid, v


def _bits(x: np.ndarray) -> np.ndarray:
    if x.dtype.kind == "f":
        return x.view(np.int64 if x.itemsize == 8 else np.int32)
    return x


def _assert_same(want, got, what):
    (wd, wv, _), (gd, gv, _) = want, got
    np.testing.assert_array_equal(gv, wv, err_msg=what)
    assert gd.dtype == wd.dtype, what
    np.testing.assert_array_equal(_bits(gd[gv]), _bits(wd[wv]),
                                  err_msg=what)


# -- datetime -----------------------------------------------------------------

# name -> (class, argument ordinals; an int is a column, a tuple a literal)
_DATETIME = {
    "year_date": ("Year", [0]), "month_date": ("Month", [0]),
    "dayofmonth_date": ("DayOfMonth", [0]),
    "year_timestamp": ("Year", [3]), "month_timestamp": ("Month", [3]),
    "dayofmonth_timestamp": ("DayOfMonth", [3]),
    "hour": ("Hour", [3]), "minute": ("Minute", [3]),
    "second": ("Second", [3]), "dayofweek": ("DayOfWeek", [0]),
    "weekday": ("WeekDay", [0]), "dayofyear": ("DayOfYear", [0]),
    "quarter": ("Quarter", [0]), "last_day": ("LastDay", [0]),
    "date_add_column": ("DateAdd", [0, 2]),
    "date_add_literal": ("DateAdd", [0, ("int", -400)]),
    "date_sub_column": ("DateSub", [0, 2]),
    "date_sub_literal": ("DateSub", [0, ("int", 36524)]),
    "datediff": ("DateDiff", [0, 1]),
    "unix_timestamp_date": ("UnixTimestamp", [0]),
    "unix_timestamp_timestamp": ("UnixTimestamp", [3]),
    "to_unix_timestamp": ("ToUnixTimestamp", [3]),
    "from_unixtime": ("FromUnixTime", [4]),
    "time_add": ("TimeAdd", [3, ("bigint", -90_061_000_001)]),
    "year_of_literal": ("Year", [("date", -135_140)]),
    "last_day_of_literal": ("LastDay", [("date", -1)]),
}


def _args(mod_base, dtm, spec, types):
    out = []
    for a in spec:
        if isinstance(a, tuple):
            out.append(mod_base.Literal(a[1], dtm.by_name(a[0])))
        else:
            out.append(mod_base.BoundReference(a, dtm.by_name(types[a])))
    return out


@pytest.mark.parametrize("case", sorted(_DATETIME))
def test_datetime_matches_reference(case):
    datas, types, valids = _columns()
    name, spec = _DATETIME[case]
    rb, _ = _reference_batch(datas, types, valids, _N)
    tb, _ = _port_batch(datas, types, valids)
    want = _ref_eval(getattr(rdate, name)(*_args(rbase, rdt, spec, types)),
                     rb, _N)
    got = _port_eval(getattr(tdate, name)(*_args(tbase, tdt, spec, types)),
                     tb, _N)
    _assert_same(want, got, case)


def test_every_datetime_class_is_ported():
    def public(mod):
        return {n for n, v in vars(mod).items() if isinstance(v, type) and
                v.__module__ == mod.__name__ and not n.startswith("_")}

    assert public(tdate) == public(rdate)
    assert {c for c, _ in _DATETIME.values()} == public(tdate)
    assert {n for n, v in vars(tcast).items() if callable(v) and
            getattr(v, "__module__", "") == tcast.__name__} >= {
        n for n, v in vars(rcast).items() if callable(v) and
        getattr(v, "__module__", "") == rcast.__name__}


# -- numeric, boolean, date and timestamp casts -------------------------------

_DEVICE_TYPES = ["boolean", "tinyint", "smallint", "int", "bigint", "float",
                 "double", "date", "timestamp"]


def _cast_source(t: str):
    """Values of type ``t`` with its edges: for floats -0.0, NaN, the
    infinities, subnormals of both widths, 2^63 and 2^31 either side, and
    halves; for integers the type's least and greatest."""
    r = np.random.default_rng(5)
    if t in ("float", "double"):
        edge = [0.0, -0.0, np.nan, np.inf, -np.inf, 1e-310, -1e-310, 1e-40,
                -1e-40, 3e-39, 1.5e-38, 2.0 ** 63, -2.0 ** 63,
                2.0 ** 63 - 1024, 2.0 ** 31, -2.0 ** 31 - 1, 2.0 ** 31 - 1,
                2.0 ** 15, 128.0, -129.0, 1e20, -1e20, 0.5, -0.5, 1.5, -1.5,
                2.5, -2.7, 3.4e38, 1e39, 1e300, 86400e6 * 3.5]
        rest = r.standard_normal(64) * 10.0 ** r.integers(-6, 20, 64)
        x = np.r_[edge, rest]
        with np.errstate(over="ignore"):  # 1e39 and up are float inf
            return x.astype(np.float32 if t == "float" else np.float64)
    if t == "boolean":
        return r.random(48) > 0.5
    npt = {"tinyint": np.int8, "smallint": np.int16, "int": np.int32,
           "bigint": np.int64, "date": np.int32, "timestamp": np.int64}[t]
    info = np.iinfo(npt)
    edge = [0, -1, 1, info.min, info.max, info.min + 1, info.max - 1, 127,
            -128, 255]
    rest = r.integers(info.min, info.max, 64, dtype=npt, endpoint=True)
    return np.r_[np.array(edge).astype(npt), rest].astype(npt)


def _cast_pair(src, to, data, valid):
    rb, rtypes = _reference_batch([data], [src], [valid], len(data))
    tb, ttypes = _port_batch([data], [src], [valid])
    want = _ref_eval(rcast.Cast(rbase.BoundReference(0, rtypes[0]),
                                rdt.by_name(to)), rb, len(data))
    got = _port_eval(tcast.Cast(tbase.BoundReference(0, ttypes[0]),
                                tdt.by_name(to)), tb, len(data))
    return want, got


@pytest.mark.parametrize("src,to", [(a, b) for a in _DEVICE_TYPES
                                    for b in _DEVICE_TYPES if a != b])
def test_device_cast_matches_reference(src, to):
    """Java's ``(long)double`` (NaN is 0, saturation, truncation), wrap on
    narrowing, DATE <-> TIMESTAMP with floor division, bool in and out,
    and the reference backend's flush of subnormal float operands and
    results, bit for bit; one row in seven is null."""
    data = _cast_source(src)
    valid = np.arange(len(data)) % 7 != 3
    want, got = _cast_pair(src, to, data, valid)
    _assert_same(want, got, f"{src} -> {to}")


_TEXT = ["1", " 42 ", "-7", "1e5", "abc", "", "3.5", "9999999999", "true",
         "no", "Y", "2020-02-29", "2020-13-01", "1969-12-31 23:59:59.5",
         "NaN", "inf", "-0.0", "128", "-129", "2019-03-04T05:06:07",
         "1600-01-01", "0", "1e400", "  false", "2^3", "1.0e-310",
         "9223372036854775808", "-9223372036854775808", "0x10"]


@pytest.mark.parametrize("to", _DEVICE_TYPES)
def test_string_cast_matches_reference(to):
    """Every entry of a dictionary that holds invalid ones parsed once:
    what does not parse, or overflows the type, is null."""
    r = np.random.default_rng(8)
    words = np.array(_TEXT + [None], dtype=object)
    data = words[r.integers(0, len(words), 200)]
    data[:len(words)] = words
    want, got = _cast_pair("string", to, data, None)
    _assert_same(want, got, f"string -> {to}")


def _decoded(v, n, validity):
    dic = v.scol.dictionary
    codes = np.asarray(jax.device_get(v.data))[:n] if not \
        isinstance(v.data, torch.Tensor) else v.data.numpy()
    return [str(dic[c]) if ok else None for c, ok in zip(codes, validity)]


@pytest.mark.parametrize("src", _DEVICE_TYPES)
def test_cast_to_string_matches_reference(src):
    """Each distinct value formatted once (Java's ``Double.toString``
    near enough, ISO dates and UTC timestamps), nulls kept."""
    data = _cast_source(src)
    if src == "timestamp":  # in datetime's range
        data = np.r_[_timestamps(np.random.default_rng(2))[:40], 0,
                     -1, 1_500_000].astype(np.int64)
    if src == "date":
        data = _dates(np.random.default_rng(2))[:60]
    valid = np.arange(len(data)) % 5 != 1
    want, got = _cast_pair(src, "string", data, valid)
    np.testing.assert_array_equal(got[1], want[1])
    assert _decoded(got[2], len(data), got[1]) == \
        _decoded(want[2], len(data), want[1])


def test_string_casts_run_once_per_dictionary():
    """The parse of a dictionary is cached per dictionary object: a second
    batch that shares the dictionary parses nothing."""
    from spark_rapids_tpu_torch.columnar.column import StringColumn

    calls = []
    orig = tcast._parse_one
    col = StringColumn.from_strings(np.array(_TEXT, dtype=object),
                                    device="cpu")
    expr = tcast.Cast(tbase.BoundReference(0, tdt.STRING), tdt.INT64)
    ctx = tbase.EvalContext([tbase.ColV(tdt.STRING, col.data, None, col)],
                            len(_TEXT), "cpu")
    tcast._parse_one = lambda *a: calls.append(1) or orig(*a)
    try:
        first = expr.eval(ctx).data.tolist()
        n = len(calls)
        assert expr.eval(ctx).data.tolist() == first
    finally:
        tcast._parse_one = orig
    assert n == len(col.dictionary) and len(calls) == n


# -- literals -----------------------------------------------------------------

_SCALARS = [("double", -0.0, "int"), ("double", float("nan"), "bigint"),
            ("double", 1e20, "int"), ("double", -2.0 ** 63, "bigint"),
            ("float", 1e-40, "double"), ("bigint", 2 ** 40, "int"),
            ("int", 19000, "timestamp"), ("timestamp", -1, "date"),
            ("string", " 12 ", "int"), ("string", "x", "double"),
            ("double", 0.1, "string"), ("date", -1, "string"),
            ("boolean", True, "double"), ("double", 1e-310, "boolean")]


@pytest.mark.parametrize("case", range(len(_SCALARS)))
def test_cast_of_a_literal_matches_reference(case):
    """``_cast_scalar``: a cast of a literal is a literal of the same
    value in both engines."""
    src, value, to = _SCALARS[case]
    want = rcast.Cast(rbase.Literal(value, rdt.by_name(src)),
                      rdt.by_name(to)).eval(None)
    got = tcast.Cast(tbase.Literal(value, tdt.by_name(src)),
                     tdt.by_name(to)).eval(None)
    assert type(got.value) is type(want.value)
    if isinstance(want.value, float):
        assert np.float64(got.value).view(np.int64) == \
            np.float64(want.value).view(np.int64)
    else:
        assert got.value == want.value


def test_fold_makes_a_cast_of_a_literal_a_literal():
    """A plan tree's ``Cast`` of a literal, which the reference's compiled
    projection cannot trace (its SQL planner folds it first), is the
    literal it makes before XLA's passes: ``(d + CAST(1 AS DOUBLE)) +
    0.1`` and ``d - CAST(0.1f AS DOUBLE)`` give the bits of the
    reference's ``(d + 1.0) + 0.1`` and ``d - 0.10000000149011612``."""
    from spark_rapids_tpu.config import RapidsConf
    from spark_rapids_tpu.execs.base import collect as rcollect
    from spark_rapids_tpu.expressions import arithmetic as rar
    from spark_rapids_tpu.plan import nodes as rpn
    from spark_rapids_tpu.plan.overrides import apply_overrides as rapply

    from spark_rapids_tpu_torch.execs.base import collect
    from spark_rapids_tpu_torch.expressions import arithmetic as tar
    from spark_rapids_tpu_torch.plan import nodes as tpn
    from spark_rapids_tpu_torch.plan.overrides import apply_overrides

    r = np.random.default_rng(3)
    d = r.standard_normal(64) * 10.0 ** r.integers(-5, 5, 64)
    d[:4] = [1e-310, -0.0, 0.1, 3.0]
    f01 = float(np.float32(0.1))
    want_exprs = [
        rar.Add(rar.Add(rbase.BoundReference(0, rdt.FLOAT64),
                        rbase.Literal(1.0)), rbase.Literal(0.1)),
        rar.Subtract(rbase.BoundReference(0, rdt.FLOAT64),
                     rbase.Literal(f01))]
    x = tbase.BoundReference(0, tdt.FLOAT64)
    got_exprs = [
        tar.Add(tar.Add(x, tcast.Cast(tbase.Literal(1, tdt.INT32),
                                      tdt.FLOAT64)), tbase.Literal(0.1)),
        tar.Subtract(x, tcast.Cast(tbase.Literal(0.1, tdt.FLOAT32),
                                   tdt.FLOAT64))]
    names = ["a", "b"]
    want = rcollect(rapply(rpn.ProjectNode(
        [rbase.Alias(e, n) for e, n in zip(want_exprs, names)],
        rpn.ScanNode(rpn.InMemorySource({"d": d})), names), RapidsConf()))
    got = collect(apply_overrides(tpn.ProjectNode(
        [tbase.Alias(e, n) for e, n in zip(got_exprs, names)],
        tpn.ScanNode(tpn.InMemorySource({"d": d})), names), device="cpu"))
    for n in names:
        assert np.asarray(got[n], np.float64).view(np.int64).tolist() == \
            want[n].to_numpy().view(np.int64).tolist(), n


# -- SQL ----------------------------------------------------------------------

_SQL = [
    "SELECT CAST(d AS int) AS a, CAST(d AS float) AS b, CAST(i AS double) "
    "AS c, CAST(dt AS timestamp) AS e, CAST(i AS boolean) AS f FROM t",
    "SELECT CAST(s AS int) AS a, CAST(s AS double) AS b, "
    "CAST(i AS string) AS c, CAST(dt AS string) AS e FROM t",
    "SELECT year(dt) AS y, month(dt) AS m, quarter(dt) AS q, "
    "weekday(dt) AS w, dayofweek(dt) AS dw, day(dt) AS d1, "
    "dayofmonth(dt) AS d2 FROM t",
    "SELECT year(dt) AS y, sum(d) AS s, count(*) AS n FROM t "
    "GROUP BY year(dt) ORDER BY y",
    "SELECT d + CAST(1 AS double) + 0.1 AS a, CAST(i AS double) * 0.1 + d "
    "AS b FROM t WHERE CAST(d AS int) > -5",
]


@pytest.fixture(scope="module")
def sql_results():
    """case -> (reference frame, port frame), one session each."""
    from spark_rapids_tpu.api import Session as RSession
    from spark_rapids_tpu.plan import nodes as rpn

    from spark_rapids_tpu_torch.api import Session
    from spark_rapids_tpu_torch.plan import nodes as tpn

    r = np.random.default_rng(17)
    n = 300
    d = r.standard_normal(n) * 10.0 ** r.integers(-3, 12, n)
    d[:6] = [np.nan, -0.0, 1e-310, 3e9, -3e9, 2.5]
    cols = {"d": d, "i": r.integers(-1000, 1000, n).astype(np.int64),
            "dt": _dates(r)[:n] if n <= _N else np.r_[
                _dates(r), _dates(r)][:n],
            "s": np.array(_TEXT, dtype=object)[r.integers(0, len(_TEXT),
                                                          n)]}
    rs, s = RSession(), Session(device="cpu")
    types = {"dt": (rdt.DATE, tdt.DATE)}
    from spark_rapids_tpu.columnar.batch import Schema as RSchema
    from spark_rapids_tpu_torch.columnar.batch import Schema as TSchema

    names = list(cols)
    rtypes = [types.get(c, (None, None))[0] or rdt.by_name(
        {"d": "double", "i": "bigint", "s": "string"}[c]) for c in names]
    ttypes = [tdt.by_name(t.name) for t in rtypes]
    rs.create_temp_view("t", rpn.InMemorySource(dict(cols),
                                                 RSchema(names, rtypes)))
    s.create_temp_view("t", tpn.InMemorySource(dict(cols),
                                               TSchema(names, ttypes)))
    out = {}
    for i, text in enumerate(_SQL):
        want = rs.sql(text).collect()
        out[i] = ({c: want[c].to_numpy() for c in want.columns},
                  s.sql(text).collect())
    return out


@pytest.mark.parametrize("case", range(len(_SQL)))
def test_cast_and_date_functions_through_sql_match_reference(sql_results,
                                                             case):
    want, got = sql_results[case]
    assert list(got) == list(want)
    for c in want:
        w, g = want[c], got[c]
        assert len(g) == len(w), c
        if w.dtype.kind == "M":
            w = w.astype("datetime64[us]").astype(np.int64) if \
                "us" in str(w.dtype) or "ns" in str(w.dtype) else \
                w.astype("datetime64[D]").astype(np.int64)
        if w.dtype.kind == "f" and c == "s":
            # a float sum's order is outside the bit-for-bit contract
            np.testing.assert_allclose(np.asarray(g, np.float64), w,
                                       rtol=1e-9, atol=0, err_msg=c)
        elif w.dtype.kind == "f":
            assert np.asarray(g, np.float64).view(np.int64).tolist() == \
                w.astype(np.float64).view(np.int64).tolist(), c
        else:
            assert [None if x is None or x != x else x for x in g] == \
                [None if x is None or x != x else x for x in w], c
