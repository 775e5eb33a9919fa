"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here carries the ``cuda`` marker and skips without a
CUDA device. This file imports neither JAX nor the reference, so it runs
where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spark_rapids_tpu_torch import kernels as nk  # noqa: E402
from spark_rapids_tpu_torch.kernels import join as kjoin  # noqa: E402
from spark_rapids_tpu_torch.kernels import sort as ksort  # noqa: E402
from spark_rapids_tpu_torch.kernels import strings as kstr  # noqa: E402

# sizes around the kernels' tiles (2048 rows for the partition kernel,
# 4096 for a radix pass)
_SIZES = (0, 1, 2047, 2049, 4097, 100_003)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", _SIZES)
def test_partition_order_kernel_equals_plain(n):
    dev = _card()
    r = np.random.default_rng(n)
    for p in (0.0, 0.4, 1.0):
        m = torch.from_numpy(r.random(n) < p).to(dev)
        assert torch.equal(ksort.partition_order(m),
                           ksort.partition_order_plain(m))


@pytest.mark.cuda
@pytest.mark.parametrize("n", _SIZES)
def test_radix_order_kernel_equals_plain(n):
    dev = _card()
    r = np.random.default_rng(n)
    keys = [torch.from_numpy(r.random(n) < 0.5).to(dev),
            torch.from_numpy(r.integers(-9, 9, n).astype(np.int8)).to(dev),
            torch.from_numpy(r.integers(-300, 300, n).astype(np.int16))
            .to(dev),
            torch.from_numpy(r.integers(-9, 9, n).astype(np.int32)).to(dev),
            torch.from_numpy(r.integers(-2**63, 2**63 - 1, n,
                                        dtype=np.int64)).to(dev)]
    widths = [1, None, None, None, None]
    assert torch.equal(ksort.radix_order(keys, widths),
                       ksort.radix_order_plain(keys, widths))


@pytest.mark.cuda
@pytest.mark.parametrize("n", _SIZES)
def test_probe_kernel_equals_plain(n):
    dev = _card()
    r = np.random.default_rng(n)
    sb = torch.sort(torch.from_numpy(
        r.integers(-2**63, 2**63 - 1, n // 3 + 1, dtype=np.int64))
        .to(dev)).values
    sb = torch.sort(torch.cat([sb, sb[: n // 7]])).values  # duplicates
    table = kjoin.build_table(sb)
    h_p = torch.cat([sb[torch.from_numpy(r.integers(0, sb.shape[0], n // 2))
                        .to(dev)],
                     torch.from_numpy(r.integers(-2**63, 2**63 - 1,
                                                 n - n // 2, dtype=np.int64))
                     .to(dev)])
    for a, b in zip(kjoin.probe(table, h_p), kjoin.probe_plain(table, h_p)):
        assert torch.equal(a, b)
    empty = kjoin.build_table(torch.zeros(0, dtype=torch.int64, device=dev))
    for a, b in zip(kjoin.probe(empty, h_p), kjoin.probe_plain(empty, h_p)):
        assert torch.equal(a, b)


def _string_table(n, seed, dev, alphabet="ab-9 ", max_len=40):
    """A seeded dictionary's char table (empty entries and, unless the
    alphabet is ASCII, multi-byte UTF-8 included)."""
    r = np.random.default_rng(seed)
    words = sorted({"".join(alphabet[i] for i in
                            r.integers(0, len(alphabet), k))
                    for k in r.integers(0, max_len, n)} | {""})
    chars, lens, _ = kstr.encode_dictionary(np.array(words, dtype=object))
    return torch.from_numpy(chars).to(dev), torch.from_numpy(lens).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n", (1, 257, 100_003))
@pytest.mark.parametrize("kind", ["starts", "ends", "contains"])
def test_match_table_kernel_equals_plain(n, kind):
    dev = _card()
    for alphabet in ("ab-9 ", "ab-éï日"):
        chars, lens = _string_table(n, n, dev, alphabet)
        for needle in ("a", "-9", "ab-", "é", "日", "a" * 30, "b" * 64, ""):
            nb = needle.encode()
            assert torch.equal(kstr.match_table(chars, lens, kind, nb),
                               kstr.match_table_plain(chars, lens, kind, nb)
                               if 0 < len(nb) <= chars.shape[1] else
                               kstr.match_table(chars.cpu(), lens.cpu(),
                                                kind, nb).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("n", (1, 257, 100_003))
def test_substring_kernel_equals_plain(n):
    dev = _card()
    chars, lens = _string_table(n, n + 1, dev)
    for pos in (-20, -3, 0, 1, 5, 40):
        for length in (None, 0, -1, 2, 100):
            got = kstr.substring_table(chars, lens, pos, length)
            want = kstr.substring_table_plain(chars, lens, pos, length)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


# tests/test_kernels.py's LIKE patterns and the edges of the grammar (the
# CPU tests hold the plain version against the reference on the same)
_LIKE_PATTERNS = [("%apple%", "\\"), ("a%b\\_c", "\\"), ("100\\%", "\\"),
                  ("_pple", "\\"), ("%quick%fox", "\\"), ("", "\\"),
                  ("%", "\\"), ("%%", "\\"), ("ab", "\\"), ("ab\\", "\\"),
                  ("%0\\%", "\\"), ("%" + "z" * 200 + "%", "\\"),
                  ("_", "\\"), ("a_a", "\\"), ("%_b%", "\\"),
                  ("ab%ba", "\\"), ("%a%b%a%", "\\"), ("a%", "\\"),
                  ("%a", "\\"), ("%-9%", "\\"), ("%é%", "\\"), ("a!%%", "!")]


@pytest.mark.cuda
@pytest.mark.parametrize("n", (1, 257, 100_003))
def test_like_table_kernel_equals_plain(n):
    dev = _card()
    for alphabet in ("ab-9 %_", "ab-éï日"):
        chars, lens = _string_table(n, n + 2, dev, alphabet)
        ascii_only = bool((chars < 0x80).all())
        for pattern, escape in _LIKE_PATTERNS:
            got = kstr.like_table(chars, lens, pattern, escape, ascii_only)
            if got is None:  # '_' over a non-ASCII table: the host's
                assert not ascii_only and "_" in pattern
                continue
            want = kstr.like_table_plain(chars, lens, pattern, escape)
            assert torch.equal(got, want), pattern


@pytest.mark.cuda
def test_session_sql_launches_like_table():
    from spark_rapids_tpu_torch.api import Session

    dev = _card()
    r = np.random.default_rng(3)
    words = np.array(["unknown", "unknown buyer", ">10000", "Unknown"],
                     dtype=object)
    data = {"k": r.integers(0, 5, 1000).astype(np.int64),
            "s": words[r.integers(0, 4, 1000)], "v": r.random(1000)}
    s = Session(device=dev)
    s.create_temp_view("t", s.create_dataframe(data))
    text = ("SELECT k, sum(v) AS sv, count(*) AS n FROM t "
            "WHERE s LIKE 'unknown%' GROUP BY k ORDER BY k")
    nk.reset_launches()
    got = s.sql(text).collect()
    assert nk.LAUNCHES["like_table"] >= 1
    want = Session(device="cpu")
    want.create_temp_view("t", want.create_dataframe(data))
    expect = want.sql(text).collect()
    assert list(got["k"]) == list(expect["k"])
    assert list(got["n"]) == list(expect["n"])
    np.testing.assert_allclose(got["sv"], expect["sv"], rtol=1e-9, atol=0)
