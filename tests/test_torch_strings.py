"""The port's string kernels, string expressions and dictionary
unification against the reference's.

On the CPU the K4 (match table) and K6 (substring) wrappers run their
plain PyTorch versions; here they are held bit-exactly against the
reference's Pallas kernels in interpret mode with the kernel gate on, on
the input families of tests/test_kernels.py plus a seeded dictionary
with empty strings and multi-byte UTF-8. Numpy arrays carry the inputs
between the two frameworks. The CUDA kernels are held against the plain
versions on the card by tests/test_torch_cuda.py.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spark_rapids_tpu.columnar import dtypes as rdt  # noqa: E402
from spark_rapids_tpu.columnar import column as rcolumn  # noqa: E402
from spark_rapids_tpu.columnar.batch import ColumnarBatch as RBatch  # noqa: E402
from spark_rapids_tpu.expressions import base as rbase  # noqa: E402
from spark_rapids_tpu.expressions import strings as rstr  # noqa: E402
from spark_rapids_tpu.native import kernels as rnk  # noqa: E402
from spark_rapids_tpu.native.kernels import strings as rks  # noqa: E402
from spark_rapids_tpu.ops import concat as rconcat  # noqa: E402

from spark_rapids_tpu_torch import kernels as tnk  # noqa: E402
from spark_rapids_tpu_torch.columnar import dtypes as tdt  # noqa: E402
from spark_rapids_tpu_torch.columnar.batch import (  # noqa: E402
    ColumnarBatch, batch_from_numpy)
from spark_rapids_tpu_torch.columnar.column import (  # noqa: E402
    StringColumn, unify_dictionaries)
from spark_rapids_tpu_torch.expressions import base as tbase  # noqa: E402
from spark_rapids_tpu_torch.expressions import strings as tstr  # noqa: E402
from spark_rapids_tpu_torch.kernels import strings as kstr  # noqa: E402
from spark_rapids_tpu_torch.ops.concat import concat_batches  # noqa: E402


@pytest.fixture(autouse=True)
def _reference_kernels_on():
    rnk.reset_config()
    rnk.configure(enabled=True)
    yield
    rnk.reset_config()


def _np(x):
    return np.array(jax.device_get(x))


# tests/test_kernels.py's words, its non-ASCII family, and a seeded
# dictionary with empty strings, multi-byte UTF-8 and long entries
_WORDS = ["", "a", "apple", "APPLESAUCE", "banana split", "a%b_c", "100%",
          "under_score", "the quick brown fox", "x", "ab" * 40]
_NON_ASCII = ["café", "naïve", "日本語", "plain"]


def _seeded_words(seed=5, n=300):
    r = np.random.default_rng(seed)
    alphabet = list("ab-9 ") + ["é", "ï", "日", "本"]
    words = {"", "日本", "ab-9", "-", "é"}
    for _ in range(n):
        k = int(r.integers(0, 40))
        words.add("".join(alphabet[i] for i in r.integers(0, 9, k)))
    return sorted(words)


_FAMILIES = {"words": _WORDS, "non_ascii": _NON_ASCII,
             "seeded": _seeded_words()}


def _dictionary(words):
    return np.unique(np.array(words, dtype=object).astype(str)).astype(
        object)


def _table(words):
    chars, lens, ascii_only = kstr.encode_dictionary(_dictionary(words))
    return torch.from_numpy(chars), torch.from_numpy(lens), ascii_only


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_encode_dictionary_matches_reference(family):
    dic = _dictionary(_FAMILIES[family])
    want = rks.encode_dictionary(dic)
    got = kstr.encode_dictionary(dic)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    assert kstr.table_from_reference(*want[:2], device="cpu").ascii_only \
        == want[2]
    assert kstr.encode_dictionary(np.array(["x" * 513], dtype=object)) \
        is None


_NEEDLES = ["a", "an", "ab" * 12, "é", "日本", "-9", "", "z" * 200]


@pytest.mark.parametrize("family", sorted(_FAMILIES))
@pytest.mark.parametrize("kind", ["starts", "ends", "contains"])
def test_match_table_plain_matches_reference(family, kind):
    """Bit-exact against the Pallas kernel, including the short cuts
    (m > L: all false, m == 0: all true)."""
    dic = _dictionary(_FAMILIES[family])
    chars, lens, _ = rks.encode_dictionary(dic)
    tc, tl, _ = kstr.table_from_reference(chars, lens, device="cpu")
    for needle in _NEEDLES:
        nb = needle.encode("utf-8")
        want = _np(rks._match_table(chars, lens, kind, nb))
        got = kstr.match_table(tc, tl, kind, nb)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want, err_msg=needle)
        # and the host truth on the strings themselves
        host = np.array([getattr(str, {"starts": "startswith",
                                       "ends": "endswith"}[kind])(s, needle)
                         if kind != "contains" else needle in s
                         for s in dic])
        np.testing.assert_array_equal(got.numpy(), host, err_msg=needle)


def test_contains_over_the_reference_window_budget():
    """A table whose (n, P, m) window tensor exceeds the reference's
    64 MiB budget: the reference sends it to its host transform, the port
    runs it through the match table; both answer the same."""
    r = np.random.default_rng(9)
    n, needle = 120_000, "dc-ba-dc-abc"
    lens = r.integers(0, 52, n)
    words = ["".join("abcd-"[i] for i in r.integers(0, 5, k)) for k in lens]
    for i in range(0, n, 7):  # a needle inside every 7th word
        cut = int(r.integers(0, len(words[i]) + 1))
        words[i] = words[i][:cut] + needle + words[i][cut:]
    dic = _dictionary(words)
    chars, clens, _ = rks.encode_dictionary(dic)
    m = len(needle)
    assert chars.shape[1] == 64
    assert len(dic) * (64 - m + 1) * m > rks._WINDOW_BUDGET
    assert rks._match_table(chars, clens, "contains",
                            needle.encode()) is None
    ref_colv = _ref_colv(dic, n_rows=64, seed=2)
    want = rstr.Contains(rbase.BoundReference(0, rdt.STRING), needle).eval(
        _ref_ctx(ref_colv))
    got = tstr.Contains(tbase.BoundReference(0, tdt.STRING), needle).eval(
        _port_ctx(ref_colv))
    np.testing.assert_array_equal(got.data.numpy(), _np(want.data))
    table = kstr.table_from_reference(chars, clens, device="cpu")
    hit = kstr.match_table(table.chars, table.lens, "contains",
                           needle.encode())
    np.testing.assert_array_equal(hit.numpy(), [needle in s for s in dic])


_SUBSTRING_CASES = [(p, ln) for p in (-20, -3, 0, 1, 5, 40)
                    for ln in (None, 0, -1, 2, 100)] + \
    [(1, 3), (2, 100), (-3, 2), (0, 2), (5, 0)]
# the cases also run through the reference's Pallas kernel (interpret
# mode costs a trace per call): tests/test_kernels.py's and the edges
_SUBSTRING_KERNEL_CASES = [(1, 3), (2, 100), (-3, 2), (0, 2), (5, 0),
                           (-20, 2), (40, None), (-3, -1), (1, None)]


@pytest.mark.parametrize("family", ["words", "seeded_ascii"])
def test_substring_table_plain_matches_reference(family):
    """The plain K6 against Spark's substring on every entry, and the
    port's whole route (kernel, dictionary rebuild, remap) against the
    reference's ``substring_colv`` with the gate on (the Pallas kernel in
    interpret mode)."""
    words = _WORDS if family == "words" else \
        [w for w in _seeded_words(7) if w.isascii()]
    dic = _dictionary(words)
    tc, tl, ascii_only = _table(words)
    assert ascii_only
    ref_colv = _ref_colv(dic, n_rows=96, seed=4)
    for pos, length in _SUBSTRING_CASES:
        expr = rstr.Substring(None, pos, length)
        oc, ol = kstr.substring_table(tc, tl, pos, length)
        want = kstr.encode_dictionary(np.array(
            [expr.fn(str(s)) for s in dic], dtype=object))
        L = tc.shape[1]
        exp_chars = np.zeros((len(dic), L), np.uint8)
        exp_chars[:, :want[0].shape[1]] = want[0][:, :L]
        np.testing.assert_array_equal(oc.numpy(), exp_chars)
        np.testing.assert_array_equal(ol.numpy(), want[1])
        if (pos, length) not in _SUBSTRING_KERNEL_CASES:
            continue
        r = rks.substring_colv(ref_colv, pos, length)
        t = kstr.substring_colv(_port_colv(ref_colv), pos, length)
        assert list(t.scol.dictionary) == list(r.scol.dictionary)
        np.testing.assert_array_equal(t.data.numpy(), _np(r.data))


def test_substring_refuses_non_ascii():
    """Substring counts characters: a non-ASCII dictionary gets no kernel
    route (as the reference's), and the host transform answers."""
    dic = _dictionary(_NON_ASCII)
    ref_colv = _ref_colv(dic, n_rows=16, seed=1)
    assert rks.substring_colv(ref_colv, 1, 2) is None
    assert kstr.substring_colv(_port_colv(ref_colv), 1, 2) is None
    assert kstr.predicate_colv(_port_colv(ref_colv), "contains", "ai") \
        is not None


# -- expressions -------------------------------------------------------------


def _ref_colv(dic, n_rows, seed, with_nulls=True):
    r = np.random.default_rng(seed)
    codes = jnp.asarray(r.integers(0, len(dic), n_rows).astype(np.int32))
    validity = jnp.asarray(r.random(n_rows) > 0.2) if with_nulls else None
    col = rcolumn.StringColumn(codes, dic, validity)
    return rbase.ColV(rdt.STRING, codes, validity, col)


def _port_colv(ref_colv):
    """The port's ColV over a reference StringColumn's codes, dictionary
    and validity."""
    col = batch_from_numpy(
        [_np(ref_colv.data)], [tdt.STRING],
        [None if ref_colv.validity is None else _np(ref_colv.validity)],
        [ref_colv.scol.dictionary], device="cpu").columns[0]
    return tbase.ColV(tdt.STRING, col.data, col.validity, col)


def _ref_ctx(colv):
    return rbase.EvalContext([colv], colv.data.shape[0], colv.data.shape[0])


def _port_ctx(ref_colv):
    colv = _port_colv(ref_colv)
    return tbase.EvalContext([colv], colv.data.shape[0], "cpu")


_PREDICATES = [("StartsWith", "a"), ("StartsWith", "日"),
               ("EndsWith", "x"), ("EndsWith", "é"), ("Contains", "an"),
               ("Contains", "-9"), ("Contains", ""), ("StartsWith", "z" * 90)]


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_string_expressions_match_reference(family):
    """StartsWith / EndsWith / Contains / Substring over the same column
    with nulls: data and validity equal, substring's strings equal. The
    reference runs its host transforms here (gate off); its kernels are
    held against them by its own tests and against the port's above."""
    rnk.configure(enabled=False)
    dic = _dictionary(_FAMILIES[family])
    ref_colv = _ref_colv(dic, n_rows=128, seed=3)
    for name, needle in _PREDICATES:
        want = getattr(rstr, name)(rbase.BoundReference(0, rdt.STRING),
                                   needle).eval(_ref_ctx(ref_colv))
        got = getattr(tstr, name)(tbase.BoundReference(0, tdt.STRING),
                                  needle).eval(_port_ctx(ref_colv))
        np.testing.assert_array_equal(got.data.numpy(), _np(want.data))
        np.testing.assert_array_equal(got.validity.numpy(),
                                      _np(want.validity))
    for pos, length in _SUBSTRING_CASES:
        want = rstr.Substring(rbase.BoundReference(0, rdt.STRING), pos,
                              length).eval(_ref_ctx(ref_colv))
        got = tstr.Substring(tbase.BoundReference(0, tdt.STRING), pos,
                             length).eval(_port_ctx(ref_colv))
        valid = _np(want.validity)
        rs = np.asarray(want.scol.dictionary)[_np(want.data)]
        ts = np.asarray(got.scol.dictionary)[got.data.numpy()]
        assert list(ts[valid]) == list(rs[valid]), (pos, length)
        np.testing.assert_array_equal(got.validity.numpy(), valid)


def test_string_scalars():
    ctx = tbase.EvalContext([], 0, "cpu")
    lit = tbase.Literal("PROMO BRUSHED TIN")
    assert tstr.StartsWith(lit, "PROMO").eval(ctx).value is True
    assert tstr.Substring(lit, -3, 2).eval(ctx).value == "TI"
    null = tbase.Literal(None, tdt.STRING)
    assert tstr.Contains(null, "x").eval(ctx).is_null
    assert tstr.Substring(null, 1, 2).eval(ctx).is_null


def test_kernel_wrappers_launch_nothing_on_the_cpu():
    tnk.reset_launches()
    tc, tl, _ = _table(_WORDS)
    kstr.match_table(tc, tl, "contains", b"a")
    kstr.substring_table(tc, tl, 1, 2)
    assert tnk.LAUNCHES["match_table"] == tnk.LAUNCHES["substring"] == 0


# -- dictionary unification and concat ---------------------------------------


def _string_parts(seed):
    r = np.random.default_rng(seed)
    pool = _seeded_words(seed, n=60)
    parts = []
    for k, n in enumerate((40, 0, 25, 33)):
        words = [pool[i] for i in r.integers(0, len(pool), n)]
        if k == 3:  # an all-null part with an empty dictionary
            words = [None] * n
        valid = np.array([w is not None for w in words])
        if k == 0:
            valid &= r.random(n) > 0.3
        parts.append((np.array(words, dtype=object), valid))
    return parts


def test_unify_dictionaries_matches_reference():
    """Re-encoding onto the merged dictionary, over parts with nulls, an
    empty part and an all-null part whose dictionary is empty."""
    rcols, tcols = [], []
    for words, valid in _string_parts(3):
        n = len(words)
        rc = rcolumn.StringColumn.from_strings(
            [w if v else None for w, v in zip(words, valid)])
        rcols.append(rc)
        tcols.append(batch_from_numpy(
            [_np(rc.data)[:n]], [tdt.STRING],
            [None if rc.validity is None else _np(rc.validity)[:n]],
            [rc.dictionary], device="cpu").columns[0])
    want = rcolumn.unify_dictionaries(rcols)
    got = unify_dictionaries(tcols)
    for w, g in zip(want, got):
        assert list(g.dictionary) == list(w.dictionary)
        valid = np.ones(g.num_rows, bool) if g.validity is None else \
            g.validity.numpy()
        np.testing.assert_array_equal(g.data.numpy()[valid],
                                      _np(w.data)[:g.num_rows][valid])


def test_string_concat_matches_reference():
    """concat_batches over string columns whose dictionaries differ (an
    empty batch and an all-null one included): the reference unifies
    and so does the port."""
    rb, tb = [], []
    for words, valid in _string_parts(8):
        n = len(words)
        keys = np.arange(n, dtype=np.int64)
        rb.append(RBatch([rcolumn.Column.from_numpy(keys, rdt.INT64),
                          rcolumn.StringColumn.from_strings(
                              [w if v else None
                               for w, v in zip(words, valid)])], n))
        tb.append(batch_from_numpy(
            [keys, words], [tdt.INT64, tdt.STRING], [None, valid],
            device="cpu"))
    want = rconcat.concat_batches(rb)
    got = concat_batches(tb)
    assert isinstance(got, ColumnarBatch)
    n = got.num_rows
    assert n == int(want.realized_num_rows())
    ws, wv = want.columns[1]._decode_host(want.columns[1].data,
                                          want.columns[1].validity, n)
    gs, gv = got.columns[1].to_numpy()
    assert list(gs) == list(ws)
    assert list(got.columns[1].dictionary) == list(want.columns[1].dictionary)
    np.testing.assert_array_equal(got.columns[0].data.numpy(),
                                  _np(want.columns[0].data)[:n])
