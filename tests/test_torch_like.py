"""The port's SQL LIKE (K5 and the ``Like`` expression) against the
reference's.

On the CPU the K5 wrapper runs its plain PyTorch version; it is held
bit-exactly against the reference's ``_like_table`` Pallas kernel in
interpret mode with the kernel gate on, over tests/test_kernels.py's
patterns and the edges of the pattern grammar, on three dictionary
families. Where the reference declines (``_`` over a non-ASCII table, or
a table past its 64 MiB window budget) the answer is held against its
host regex instead. The CUDA kernel is held against the plain version on
the card by tests/test_torch_cuda.py.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spark_rapids_tpu.columnar import column as rcolumn  # noqa: E402
from spark_rapids_tpu.columnar import dtypes as rdt  # noqa: E402
from spark_rapids_tpu.expressions import base as rbase  # noqa: E402
from spark_rapids_tpu.expressions import strings as rstr  # noqa: E402
from spark_rapids_tpu.native import kernels as rnk  # noqa: E402
from spark_rapids_tpu.native.kernels import strings as rks  # noqa: E402

from spark_rapids_tpu_torch import kernels as tnk  # noqa: E402
from spark_rapids_tpu_torch.columnar import dtypes as tdt  # noqa: E402
from spark_rapids_tpu_torch.columnar.batch import batch_from_numpy  # noqa: E402
from spark_rapids_tpu_torch.expressions import base as tbase  # noqa: E402
from spark_rapids_tpu_torch.expressions import strings as tstr  # noqa: E402
from spark_rapids_tpu_torch.kernels import strings as kstr  # noqa: E402


@pytest.fixture(autouse=True)
def _reference_kernels_on():
    rnk.reset_config()
    rnk.configure(enabled=True)
    yield
    rnk.reset_config()


def _np(x):
    return np.array(jax.device_get(x))


# tests/test_kernels.py's words, its non-ASCII family, and a seeded
# dictionary with empty strings, multi-byte UTF-8 and '%', '_', '\'
_WORDS = ["", "a", "apple", "APPLESAUCE", "banana split", "a%b_c", "100%",
          "under_score", "the quick brown fox", "x", "ab" * 40, "aba",
          "abba", "ab\\", "pple", "%"]
_NON_ASCII = ["café", "naïve", "日本語", "plain", "pl_in", "日%本"]


def _seeded_words(seed=11, n=300):
    r = np.random.default_rng(seed)
    alphabet = list("ab%_\\") + ["é", "日"]
    words = {"", "ab", "ba", "a%b", "日本", "é"}
    for _ in range(n):
        k = int(r.integers(0, 24))
        words.add("".join(alphabet[i] for i in r.integers(0, 7, k)))
    return sorted(words)


_FAMILIES = {"words": _WORDS, "non_ascii": _NON_ASCII,
             "seeded": _seeded_words()}

# tests/test_kernels.py:299-303, then the edges of the grammar: empty,
# all-wildcard, exact, trailing escape, escaped trailing %, a segment
# longer than L, '_' (declined on non-ASCII tables), the suffix cursor
# (ab%ba over 'aba'), several unanchored segments, and a custom escape
_PATTERNS = [("%apple%", "\\"), ("a%b\\_c", "\\"), ("100\\%", "\\"),
             ("_pple", "\\"), ("%quick%fox", "\\"), ("", "\\"), ("%", "\\"),
             ("%%", "\\"), ("apple", "\\"), ("ab\\", "\\"), ("%0\\%", "\\"),
             ("%" + "z" * 200 + "%", "\\"), ("_", "\\"), ("a_a", "\\"),
             ("%_b%", "\\"), ("ab%ba", "\\"), ("ab%b%a", "\\"),
             ("%a%b%a%", "\\"), ("a%", "\\"), ("%a", "\\"), ("日%", "\\"),
             ("%é%", "\\"), ("%\\\\%", "\\"), ("a!%%", "!"), ("!_%", "!")]


def _dictionary(words):
    return np.unique(np.array(words, dtype=object).astype(str)).astype(
        object)


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_like_table_plain_matches_reference(family):
    """Bit-exact against the Pallas kernel, or against the reference's
    regex where the kernel declines; the port declines exactly where the
    reference declines for ``_`` on non-ASCII."""
    dic = _dictionary(_FAMILIES[family])
    chars, lens, ascii_only = rks.encode_dictionary(dic)
    tc, tl, t_ascii = kstr.table_from_reference(chars, lens, device="cpu")
    assert t_ascii == ascii_only
    declined = 0
    for pattern, escape in _PATTERNS:
        want = rks._like_table(chars, lens, pattern, escape, ascii_only)
        got = kstr.like_table(tc, tl, pattern, escape, ascii_only)
        host = np.array([rstr.Like(None, pattern, escape).test(str(s))
                         for s in dic])
        if want is None:
            declined += 1
            assert got is None, pattern
            continue
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), _np(want),
                                      err_msg=pattern)
        np.testing.assert_array_equal(got.numpy(), host, err_msg=pattern)
        if ascii_only or "_" not in pattern:
            plain = kstr.like_table_plain(tc, tl, pattern, escape)
            np.testing.assert_array_equal(plain.numpy(), host,
                                          err_msg=pattern)
    assert (declined > 0) == (not ascii_only)


def test_parse_like_anchoring():
    """Anchoring comes from the token stream: an escaped trailing % is a
    literal, a lone trailing escape is a literal, % runs make empty
    segments."""
    p = kstr.parse_like("100\\%", "\\")
    assert p == ([[ord("1"), ord("0"), ord("0"), ord("%")]], True, True)
    p = kstr.parse_like("%a_%", "\\")
    assert p == ([[], [ord("a"), None], []], False, False)
    p = kstr.parse_like("ab\\", "\\")
    assert p == ([[ord("a"), ord("b"), ord("\\")]], True, True)
    assert kstr.parse_like("", "\\") == ([[]], True, True)
    assert kstr.parse_like("%%", "\\") == ([[], [], []], False, False)


def test_like_over_the_reference_window_budget():
    """A table whose window tensor exceeds the reference's 64 MiB budget:
    the reference sends it to its host regex, the port runs it through
    the LIKE table; both answer the same."""
    r = np.random.default_rng(9)
    n, seg, pattern = 120_000, "dc-ba-dc-abc", "%dc-ba-dc-abc%a-b%"
    lens = r.integers(0, 52, n)
    words = ["".join("abcd-"[i] for i in r.integers(0, 5, k)) for k in lens]
    for i in range(0, n, 7):  # the long segment inside every 7th word
        cut = int(r.integers(0, len(words[i]) + 1))
        words[i] = words[i][:cut] + seg + words[i][cut:]
    dic = _dictionary(words)
    chars, clens, ascii_only = rks.encode_dictionary(dic)
    m = len(seg)
    assert chars.shape[1] == 64
    assert len(dic) * (64 - m + 1) * m > rks._WINDOW_BUDGET
    assert rks._like_table(chars, clens, pattern, "\\", ascii_only) is None
    table = kstr.table_from_reference(chars, clens, device="cpu")
    got = kstr.like_table(table.chars, table.lens, pattern, "\\",
                          table.ascii_only)
    host = rstr.Like(None, pattern)
    want = np.array([host.test(str(s)) for s in dic])
    assert 0 < want.sum() < len(dic)
    np.testing.assert_array_equal(got.numpy(), want)


# -- the expression ----------------------------------------------------------


def _ref_colv(dic, n_rows, seed, with_nulls=True):
    r = np.random.default_rng(seed)
    codes = jnp.asarray(r.integers(0, len(dic), n_rows).astype(np.int32))
    validity = jnp.asarray(r.random(n_rows) > 0.2) if with_nulls else None
    col = rcolumn.StringColumn(codes, dic, validity)
    return rbase.ColV(rdt.STRING, codes, validity, col)


def _port_ctx(ref_colv):
    col = batch_from_numpy(
        [_np(ref_colv.data)], [tdt.STRING],
        [None if ref_colv.validity is None else _np(ref_colv.validity)],
        [ref_colv.scol.dictionary], device="cpu").columns[0]
    colv = tbase.ColV(tdt.STRING, col.data, col.validity, col)
    return tbase.EvalContext([colv], colv.data.shape[0], "cpu")


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_like_expression_matches_reference(family):
    """``Like`` over a column with nulls: data and validity equal to the
    reference's. The reference runs its host regex here (gate off); its
    kernel is held against the port's above."""
    rnk.configure(enabled=False)
    dic = _dictionary(_FAMILIES[family])
    ref_colv = _ref_colv(dic, n_rows=96, seed=3)
    ctx = rbase.EvalContext([ref_colv], 96, 96)
    for pattern, escape in _PATTERNS:
        want = rstr.Like(rbase.BoundReference(0, rdt.STRING), pattern,
                         escape).eval(ctx)
        got = tstr.Like(tbase.BoundReference(0, tdt.STRING), pattern,
                        escape).eval(_port_ctx(ref_colv))
        valid = _np(want.validity)
        np.testing.assert_array_equal(got.validity.numpy(), valid)
        np.testing.assert_array_equal(got.data.numpy()[valid],
                                      _np(want.data)[valid],
                                      err_msg=pattern)


def test_like_scalars_and_nulls():
    ctx = tbase.EvalContext([], 0, "cpu")
    rctx = rbase.EvalContext([], 0, 0)
    for value in ("unknown", "unknown buyer", "Unknown", "", "a%b_c"):
        for pattern in ("unknown%", "a\\%b\\_c", "_nknown", "%"):
            want = rstr.Like(rbase.Literal(value), pattern).eval(rctx)
            got = tstr.Like(tbase.Literal(value), pattern).eval(ctx)
            assert got.value is want.value, (value, pattern)
    null = tstr.Like(tbase.Literal(None, tdt.STRING), "%").eval(ctx)
    assert null.is_null


def test_non_ascii_underscore_takes_the_host_path():
    """`_` counts characters: over a non-ASCII dictionary both packages
    decline the kernel route and the host regex answers."""
    dic = _dictionary(["café", "naïve", "日本語", "plain"])
    ref_colv = _ref_colv(dic, n_rows=16, seed=1, with_nulls=False)
    ctx = _port_ctx(ref_colv)
    assert rks.predicate_colv(ref_colv, "like", "pl_in", "\\") is None
    assert kstr.predicate_colv(ctx.columns[0], "like", "pl_in", "\\") is None
    assert kstr.predicate_colv(ctx.columns[0], "like", "%a%", "\\") \
        is not None
    got = tstr.Like(tbase.BoundReference(0, tdt.STRING), "caf_").eval(ctx)
    words = np.asarray(dic)[ctx.columns[0].data.numpy()]
    np.testing.assert_array_equal(got.data.numpy(), words == "café")


def test_like_launches_nothing_on_the_cpu():
    tnk.reset_launches()
    chars, lens, _ = kstr.encode_dictionary(_dictionary(_WORDS))
    kstr.like_table(torch.from_numpy(chars), torch.from_numpy(lens),
                    "%a%", "\\", True)
    assert tnk.LAUNCHES["like_table"] == 0
