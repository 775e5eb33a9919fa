"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here carries the ``cuda`` marker and skips without a
CUDA device. This file imports neither JAX nor the reference, so it runs
where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spark_rapids_tpu_torch import kernels as nk  # noqa: E402
from spark_rapids_tpu_torch.kernels import groupby as kgb  # noqa: E402
from spark_rapids_tpu_torch.kernels import join as kjoin  # noqa: E402
from spark_rapids_tpu_torch.kernels import sort as ksort  # noqa: E402
from spark_rapids_tpu_torch.kernels import strings as kstr  # noqa: E402

# sizes around the kernels' tiles (3072 rows for a radix pass, 1024 probe
# rows for a probe block; the partition kernel's 4096-row tiles have
# their own sizes below)
_SIZES = (0, 1, 2047, 2049, 4097, 100_003)
_I64 = (-2**63, 2**63 - 1)


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
@pytest.mark.parametrize("n", (1, 4095, 4096, 4097, 100_003, 3_000_017))
def test_partition_order_kernel_one_launch_with_count(n):
    """Around the 4096-row tile, one block and many; masks all true, all
    false, alternating and random, starting on and off a 16-byte
    boundary; two calls queued back to back on one stream (stale status
    words of the first must not feed the second), then the count."""
    dev = _card()
    r = np.random.default_rng(n)
    masks = {"true": np.ones(n, bool), "false": np.zeros(n, bool),
             "alternating": np.arange(n) % 2 == 0,
             "random": r.random(n) < 0.3}
    for name, m in masks.items():
        whole = torch.from_numpy(m).to(dev)
        for offset in (0, 3):
            mask = whole[offset:]
            if mask.numel() == 0:
                continue
            want = ksort.partition_order_plain(mask)
            before = nk.LAUNCHES["partition_order"]
            first = ksort.partition_order(mask)
            second = ksort.partition_order(mask)
            got, n_true = ksort.partition_order_count(mask)
            assert nk.LAUNCHES["partition_order"] == before + 3
            for out in (first, second, got):
                assert torch.equal(out, want), (name, offset)
            assert n_true == int(mask.sum()), (name, offset)


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


def _radix_key_sets(n, r, dev):
    """Key sets whose 8-bit passes are some, all or none trivial."""
    def t(a):
        return torch.from_numpy(a).to(dev)

    return {
        # ids below 2^20 in int64 behind a 1-bit rank: 3 of 9 passes run
        "some": ([t(np.zeros(n, np.int32)),
                  t(r.integers(1, 1_000_000, n).astype(np.int64))],
                 [1, None]),
        "all": ([t(np.full(n, 7, np.int64)), t(np.full(n, -2, np.int16))],
                None),
        "none": ([t(r.integers(*_I64, n, dtype=np.int64))], None),
        "negative": ([t(r.integers(_I64[0], 0, n, dtype=np.int64))], None),
        # two digits varying at the top of the key only
        "high": ([t(r.integers(0, 300, n).astype(np.int64) << 48)], None),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("n", _SIZES)
def test_radix_order_kernel_skips_trivial_passes(n):
    dev = _card()
    r = np.random.default_rng(n + 5)
    for name, (keys, widths) in _radix_key_sets(n, r, dev).items():
        got = ksort.radix_order(keys, widths)
        assert torch.equal(got, ksort.radix_order_plain(keys, widths)), name
        if name == "all":
            assert torch.equal(got, torch.arange(n, dtype=torch.int32,
                                                 device=dev))


@pytest.mark.cuda
def test_radix_order_kernel_many_tiles():
    """977 tiles of 3072 rows: the look-back order across many blocks."""
    dev = _card()
    n = 3_000_017
    r = np.random.default_rng(17)
    for keys, widths in _radix_key_sets(n, r, dev).values():
        assert torch.equal(ksort.radix_order(keys, widths),
                           ksort.radix_order_plain(keys, widths))
    keys = [torch.from_numpy(r.integers(-3, 3, n).astype(np.int8)).to(dev),
            torch.from_numpy(r.integers(*_I64, n, dtype=np.int64)).to(dev)]
    assert torch.equal(ksort.radix_order(keys), ksort.radix_order_plain(keys))


def _long_run_table(dev, n_build, keys):
    """A hash-sorted build of ``n_build`` rows over the given keys."""
    r = np.random.default_rng(n_build)
    sb = torch.sort(torch.from_numpy(r.choice(keys, n_build)).to(dev)).values
    return kjoin.build_table(sb)


@pytest.mark.cuda
@pytest.mark.parametrize("n", _SIZES)
def test_probe_kernel_equals_plain_on_long_runs(n):
    dev = _card()
    r = np.random.default_rng(n + 9)
    keys = r.integers(*_I64, 3, dtype=np.int64)
    table = _long_run_table(dev, 3 * n + 30, keys)
    probes = np.concatenate([keys, keys - 1, keys + 1,
                             r.integers(*_I64, n, dtype=np.int64)])
    h_p = torch.from_numpy(r.choice(probes, n)).to(dev)
    for a, b in zip(kjoin.probe(table, h_p), kjoin.probe_plain(table, h_p)):
        assert torch.equal(a, b)
    # a stream that starts off the 16-byte alignment
    for a, b in zip(kjoin.probe(table, h_p[1:]),
                    kjoin.probe_plain(table, h_p[1:])):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n_build", (600, 40_000))
def test_probe_kernel_equals_plain_on_padded_table(n_build):
    """A table whose build column carries padding rows at int64 max past
    its live rows, as one carried from the reference does; 600 rows are
    probed from shared memory, 40,000 from L2."""
    dev = _card()
    r = np.random.default_rng(n_build)
    live = torch.sort(torch.from_numpy(
        r.integers(-2**62, 2**62, n_build, dtype=np.int64)).to(dev)).values
    pad = torch.full((n_build // 4,), _I64[1], dtype=torch.int64, device=dev)
    table = kjoin.ProbeTable(torch.cat([live, pad]),
                             kjoin.build_table(live).part)
    h_p = torch.cat([live[:99], pad[:1], live.new_tensor([_I64[0]])])
    for a, b in zip(kjoin.probe(table, h_p), kjoin.probe_plain(table, h_p)):
        assert torch.equal(a, b)
    assert int(kjoin.probe(table, pad[:1])[1][0]) == 0


@pytest.mark.cuda
def test_probe_kernel_equals_plain_at_q91_first_join_shape():
    """1.2M build rows on 6 keys (runs of ~200k), probed by the 6 keys
    and by a 2,097,152-row stream drawn from them."""
    dev = _card()
    r = np.random.default_rng(91)
    keys = r.integers(*_I64, 6, dtype=np.int64)
    table = _long_run_table(dev, 1_200_000, keys)
    for h in (keys, r.choice(np.concatenate([keys, keys + 1]), 1 << 21)):
        h_p = torch.from_numpy(h).to(dev)
        got = kjoin.probe(table, h_p)
        want = kjoin.probe_plain(table, h_p)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert int(got[1].max()) > 150_000


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
@pytest.mark.parametrize("L", (1, 16, 64, 512))
@pytest.mark.parametrize("kind", ["starts", "ends", "contains"])
def test_match_table_kernel_equals_plain_at_widths(L, kind):
    """Each path of the kernel (a row a thread up to 64 bytes, a group of
    lanes past that; shift-and up to 64-byte needles, windows past that)
    at needle lengths 1, 63, 64, 65 and L, over bytes that include 0 and
    non-ASCII ones, with entries shorter than the needle. Every needle
    holds a 0 byte, and is planted in every fifth entry long enough."""
    dev = _card()
    r = np.random.default_rng(L)
    n = 3000
    alphabet = np.array([0x61, 0x62, 0x00, 0xC3, 0xA9], np.uint8)
    lens = r.integers(0, L + 1, n)
    base = alphabet[r.integers(0, len(alphabet), (n, L))]
    for m in sorted({1, 63, 64, 65, L}):
        if m > L:
            continue
        needle = alphabet[r.integers(0, len(alphabet), m)]
        needle[m // 2] = 0
        chars = base.copy()
        for i in range(0, n, 5):
            if lens[i] >= m:
                at = {"starts": 0, "ends": lens[i] - m}.get(
                    kind, int(r.integers(0, lens[i] - m + 1)))
                chars[i, at:at + m] = needle
        chars[np.arange(L)[None, :] >= lens[:, None]] = 0
        tc = torch.from_numpy(chars).to(dev)
        tl = torch.from_numpy(lens.astype(np.int32)).to(dev)
        nb = needle.tobytes()
        got = kstr.match_table(tc, tl, kind, nb)
        want = kstr.match_table_plain(tc, tl, kind, nb)
        assert torch.equal(got, want), m
        assert bool(want.any()) or m > int(lens.max()), m
        # a table that starts off a 16-byte boundary (L = 1 only)
        got = kstr.match_table(tc[1:], tl[1:], kind, nb)
        assert torch.equal(got, want[1:]), m


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


# every path of K5 at one width: each anchoring, '_' at the edges of
# segments, escaped '%' and '_', bodies of 32, 33-64 and past 64 bytes
_WIDTH_PATTERNS = ["a%", "%a", "_%", "%_", "a_%_b", "%_a%b_%", "ab%cd",
                   "%a%b%a%", "%d\\%%", "%\\_a%", "_a%\\%_",
                   "%" + "ab" * 16 + "%", "%" + "a_c-" * 12,
                   "ab%" + "cd-" * 23 + "%", "%" + "abcd_" * 20 + "%"]


@pytest.mark.cuda
@pytest.mark.parametrize("L", (1, 2, 4, 8, 16, 32, 64, 128, 256, 512))
def test_like_table_kernel_equals_plain_at_widths(L):
    """Rows of a-d, '-', '%' and '_' (every seventh planted with a
    pattern's literal form), on and off a 16-byte boundary."""
    dev = _card()
    r = np.random.default_rng(L)
    n = 3000
    alphabet = np.frombuffer(b"abcd-%_", np.uint8)
    lens = r.integers(0, L + 1, n).astype(np.int32)
    chars = alphabet[r.integers(0, len(alphabet), (n, L))]
    patterns = _WIDTH_PATTERNS + ["a" * L, "_" * L]
    for i in range(0, n, 7):
        lit = patterns[(i // 7) % len(patterns)].replace("\\", "") \
            .replace("%", "").replace("_", "a")
        if 0 < len(lit) <= lens[i]:
            chars[i, :len(lit)] = np.frombuffer(lit.encode(), np.uint8)
    chars[np.arange(L)[None, :] >= lens[:, None]] = 0
    tc = torch.from_numpy(chars).to(dev)
    tl = torch.from_numpy(lens).to(dev)
    for pattern in patterns:
        want = kstr.like_table_plain(tc, tl, pattern)
        if len(kstr.like_spec(pattern, "\\").body) > L:
            want = torch.zeros_like(want)
        assert torch.equal(kstr.like_table(tc, tl, pattern, "\\", True),
                           want), pattern
        assert torch.equal(kstr.like_table(tc[1:], tl[1:], pattern, "\\",
                                           True), want[1:]), pattern


@pytest.mark.cuda
@pytest.mark.parametrize("L", (8, 16, 64, 512))
def test_substring_kernel_equals_plain_at_widths(L):
    """The 30 pos / length edges of the smoke run at one width (a thread
    a row below 16 bytes, a thread a 16-byte chunk from 16), on and off a
    16-byte boundary."""
    dev = _card()
    r = np.random.default_rng(L + 1)
    n = 3000
    lens = r.integers(0, L + 1, n).astype(np.int32)
    chars = np.frombuffer(b"abcd-", np.uint8)[r.integers(0, 5, (n, L))]
    chars[np.arange(L)[None, :] >= lens[:, None]] = 0
    tc = torch.from_numpy(chars).to(dev)
    tl = torch.from_numpy(lens).to(dev)
    for pos in (-20, -3, 0, 1, 5, 40):
        for length in (None, 0, -1, 2, 100):
            for c, ln in ((tc, tl), (tc[1:], tl[1:])):
                got = kstr.substring_table(c, ln, pos, length)
                want = kstr.substring_table_plain(c, ln, pos, length)
                assert torch.equal(got[0], want[0]), (pos, length)
                assert torch.equal(got[1], want[1]), (pos, length)


# C3: float products that feed an add, each against a * b + c rounded
# once (computed exactly with fractions)
_FMA = {"a * b + c": lambda a, b, c: a * b + c,
        "a * 0.3 - c": lambda a, b, c: a * Fraction(0.3) - c,
        "0.1 - a * b": lambda a, b, c: Fraction(0.1) - a * b,
        # a / 3.0 is a * (1 / 3.0), rounded before it meets b
        "c + (a / 3.0) * b":
            lambda a, b, c: c + Fraction(float(a * Fraction(1 / 3.0))) * b}


@pytest.mark.cuda
@pytest.mark.parametrize("expr", sorted(_FMA))
def test_multiply_add_rounds_once_on_the_card(expr):
    from spark_rapids_tpu_torch.api import Session
    from spark_rapids_tpu_torch.plan.nodes import InMemorySource

    dev = _card()
    r = np.random.default_rng(3)
    n = 3001
    cols = {k: r.standard_normal(n) * 10.0 ** r.integers(-3, 3, n)
            for k in "abc"}
    s = Session(device=dev)
    s.create_temp_view("t", InMemorySource(cols))
    got = np.asarray(s.sql(f"SELECT {expr} AS x FROM t").collect()["x"],
                     np.float64)
    want = np.array([float(_FMA[expr](Fraction(a), Fraction(b),
                                      Fraction(c)))
                     for a, b, c in zip(cols["a"], cols["b"], cols["c"])])
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))


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


@pytest.mark.cuda
@pytest.mark.parametrize("query", ["q1", "q12", "q13", "q21"])
def test_tpch_host_string_query_card_equals_cpu(query):
    """TPC-H q1, q12, q13 and q21 at sf 0.1 over ``HostStrings`` tables on
    the card and on the CPU, each on its unfused and its default (fused)
    tree: strings and counts equal, float sums and averages within 1e-9
    relative; on the unfused tree the partition kernel runs, and the
    probe in every query that joins; on both the radix sort orders the
    result (in the fused tree, the sort tail's)."""
    from spark_rapids_tpu_torch.benchmarks import datagen, tpch
    from spark_rapids_tpu_torch.execs.base import collect
    from spark_rapids_tpu_torch.plan.overrides import apply_overrides

    dev = _card()
    args = [datagen.GENERATORS[t](0.1) for t in tpch.INPUTS[query]]
    plan = getattr(tpch, query)
    for fused in (False, True):
        conf = {"rapids.tpu.sql.fusion.enabled": fused}
        nk.reset_launches()
        got = collect(apply_overrides(plan(*args), conf, device=dev))
        assert nk.LAUNCHES["radix_order"] >= 1
        if not fused:
            assert nk.LAUNCHES["partition_order"] >= 1
            if query != "q1":
                assert nk.LAUNCHES["probe"] >= 1
        want = collect(apply_overrides(plan(*args), conf, device="cpu"))
        assert list(got) == list(want) and len(want[next(iter(want))]) > 0
        for name, w in want.items():
            if w.dtype.kind == "f":
                np.testing.assert_allclose(got[name], w, rtol=1e-9, atol=0)
            else:
                assert list(got[name]) == list(w), name


@pytest.mark.cuda
@pytest.mark.parametrize("keys", ["dense", "sort_few", "sort_many"])
def test_groupby_float_sums_card_equals_cpu(keys):
    """Float sums, min, max and counts on the card and on the CPU: six
    string-keyed groups (the dense path: a histogram per block), a
    handful of numeric keys over 1.5M rows and about 1M numeric keys
    (the sort path: its sums through the ``seg_sum`` kernel); sums within
    1e-9 relative (the card's histogram adds in another order), the rest
    equal."""
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.batch import batch_from_numpy
    from spark_rapids_tpu_torch.ops import groupby as gb

    dev = _card()
    r = np.random.default_rng(13)
    n = 1_500_000
    if keys == "dense":
        key = r.integers(0, 6, n).astype(np.int32)
        kcol, ktype, dic = key, dt.STRING, np.array(
            ["AF", "NF", "NO", "RF", "RO", "ZZ"], dtype=object)
    else:
        key = r.integers(0, 40 if keys == "sort_few" else 1_000_000, n)
        kcol, ktype, dic = key.astype(np.int64), dt.INT64, None
    x = r.standard_normal(n) * 1e3
    x[r.integers(0, n, 50)] = np.nan
    valid = r.random(n) > 0.05
    datas, types = [kcol, x, x * 3.0], [ktype, dt.FLOAT64, dt.FLOAT64]
    specs = [gb.AggSpec("sum", 1), gb.AggSpec("sum", 2),
             gb.AggSpec("min", 1), gb.AggSpec("max", 2),
             gb.AggSpec("count", 1), gb.AggSpec("count_star")]
    out = []
    for d in (dev, "cpu"):
        b = batch_from_numpy(datas, types, [None, valid, None],
                             [dic, None, None], device=d)
        nk.reset_launches()
        got, _ = gb.groupby_aggregate(b, [0], specs, types)
        if d == dev:  # the sums (stacked), the min and the max
            assert nk.LAUNCHES["seg_sum"] == (0 if keys == "dense" else 3)
        out.append([(c.data.cpu().numpy(), None if c.validity is None
                     else c.validity.cpu().numpy()) for c in got.columns])
    for (gd, gv), (wd, wv) in zip(*out):
        assert (gv is None) == (wv is None)
        if gv is not None:
            np.testing.assert_array_equal(gv, wv)
        if gd.dtype.kind == "f":
            np.testing.assert_allclose(gd, wd, rtol=1e-9, atol=0)
        else:
            np.testing.assert_array_equal(gd, wd)


# group sizes by case for the S1 kernel: around its cut-offs (a thread a
# group up to 64 rows, a warp up to 4,096, chunks of 4,096 folded 512 rows
# a warp beyond), and the 8-row pieces' levels
_CUTOFFS = [7, 8, 9, 63, 64, 65, 511, 512, 513, 4095, 4096, 4097, 8191,
            8192, 8193, 12289, 4096 * 9 + 1]


def _fold_sizes(case, r):
    return {"empty": np.zeros(0, np.int64),
            "one_group": np.array([1000], np.int64),
            "one_row": np.ones(100_003, np.int64),
            "short": r.integers(1, 9, 50_000),
            "long": np.concatenate([r.integers(1, 9, 5000),
                                    [300_000, 9, 64, 65, 513]]),
            "columns": r.integers(1, 41, 20_000),
            "cutoffs": np.concatenate([_CUTOFFS, r.integers(1, 9, 100),
                                       _CUTOFFS[::-1]]),
            "huge": np.array([3, (1 << 22) + 3, 5], np.int64),
            "mixed": np.concatenate([r.integers(1, 9, 3000),
                                     r.integers(9, 5000, 300),
                                     r.integers(5000, 70_000, 12)])
            }[case].astype(np.int64)


def _fold_values(n, m, dtype, r):
    """[n] (m == 1) or [n, m] values of ``dtype``: floats over six
    decades with Inf, NaN, -0.0, +0.0 and 1e-310 (flushed to zero in
    float32) spread over the rows; integers over their whole range."""
    shape = n if m == 1 else (n, m)
    if dtype in (torch.float32, torch.float64):
        x = r.standard_normal(shape) * 10.0 ** r.integers(-3, 4, shape)
        flat = x.reshape(-1)
        if flat.size > 10:
            at = r.integers(0, flat.size, 12)
            flat[at] = [np.inf, np.nan, -np.inf, -0.0, 0.0, 1e-310,
                        -1e-310, -0.0, np.nan, -0.0, 0.0, -0.0]
        return torch.from_numpy(x).to(dtype)
    info = torch.iinfo(dtype)
    return torch.from_numpy(r.integers(info.min, info.max, shape,
                                       endpoint=True)).to(dtype)


def _fold_check(x, sizes, op, dev):
    """The kernel on the card against ``seg_fold`` on the CPU: one launch
    (none without groups), equal bit for bit (NaN where NaN)."""
    starts = np.r_[0, np.cumsum(sizes)[:-1]].astype(np.int64)[:len(sizes)]
    st, sz = torch.from_numpy(starts), torch.from_numpy(sizes)
    nk.reset_launches()
    got = kgb.seg_reduce(x.to(dev), st.to(dev), sz.to(dev), op).cpu()
    assert nk.LAUNCHES["seg_sum"] == (1 if len(sizes) else 0)
    want = kgb.seg_fold(x, st, sz, int(sizes.max()) if len(sizes) else 0,
                        kgb.OPS[op])
    assert got.shape == want.shape and got.dtype == want.dtype
    if x.is_floating_point():
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        ok = ~torch.isnan(want)
        bits = torch.int64 if x.dtype == torch.float64 else torch.int32
        assert torch.equal(got[ok].view(bits), want[ok].view(bits))
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["empty", "one_row", "short", "long",
                                  "columns", "one_group", "cutoffs",
                                  "huge", "mixed"])
def test_seg_sum_kernel_equals_plain(case):
    """The S1 kernel's float64 sums on the card against its plain version
    on the CPU, bit for bit, one launch a call: no groups; one group;
    100,003 one-row groups; groups of one to eight rows; groups up to
    300,000 rows beside short ones; three columns; sizes either side of
    each cut-off; a group of 2^22 + 3 rows; a mix of all shapes. Then
    one to five columns over the cut-offs. Values span six decades, with
    Inf, NaN, -0.0 and 1e-310."""
    dev = _card()
    r = np.random.default_rng(len(case))
    sizes = _fold_sizes(case, r)
    n = int(sizes.sum())
    _fold_check(_fold_values(n, 3 if case == "columns" else 1,
                             torch.float64, r), sizes, "sum", dev)
    if case == "cutoffs":
        for m in range(1, 6):
            _fold_check(_fold_values(n, m, torch.float64, r), sizes, "sum",
                        dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int8,
                                   torch.int16, torch.int32, torch.int64],
                         ids=str)
@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("case", ["one_row", "cutoffs", "mixed"])
def test_seg_reduce_min_max_kernel_equals_plain(case, op, dtype):
    """min and max through the same kernel, over every lane type the sort
    path gives it, against ``seg_fold`` with the kernel's ops (NaN wins,
    a tie keeps the earlier row), bit for bit, one launch a call; two
    columns as well at the cut-offs."""
    dev = _card()
    r = np.random.default_rng(len(case) + len(op))
    sizes = _fold_sizes(case, r)
    n = int(sizes.sum())
    _fold_check(_fold_values(n, 1, dtype, r), sizes, op, dev)
    if case == "cutoffs":
        _fold_check(_fold_values(n, 2, dtype, r), sizes, op, dev)


@pytest.mark.cuda
def test_seg_reduce_kernel_refuses_what_it_does_not_take():
    """A CUDA tensor of a type the kernel does not take raises; it does
    not fall back."""
    dev = _card()
    st = torch.zeros(1, dtype=torch.int64, device=dev)
    sz = torch.ones(1, dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        kgb.seg_reduce(torch.ones(1, dtype=torch.float16, device=dev), st,
                       sz, "min")
    with pytest.raises(TypeError):
        kgb.seg_reduce(torch.ones(1, dtype=torch.float32, device=dev), st,
                       sz, "sum")
    with pytest.raises(TypeError):
        kgb.seg_reduce(torch.ones(1, dtype=torch.uint8, device=dev), st,
                       sz, "max")


# the groups of C5 (tests/test_torch_groupby.py holds the CPU against the
# reference engine)
_C5_GROUPS = ([-0.0], [-0.0, -0.0], [-0.0, -1e-310], [0.0, -0.0],
              [-0.0, 0.0], [0.0, -0.0, 5.0], [-0.0, -0.0, 1.0],
              [1e-310, -0.0])


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["dense", "sort", "grand"])
def test_zero_signs_of_float_aggregates_card_equal_cpu(path):
    """sum, min, max, any_valid, first and last of the C5 groups on the
    card and on the CPU, bit for bit: a string key (the dense path), an
    integer key (the sort path, through the S1 kernel) and each group
    alone with no key."""
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.batch import batch_from_numpy
    from spark_rapids_tpu_torch.ops import groupby as gb

    dev = _card()
    d = np.concatenate(_C5_GROUPS)
    which = np.concatenate([[i] * len(g) for i, g in enumerate(_C5_GROUPS)])
    f = d.astype(np.float32)
    specs = [gb.AggSpec(op, o) for o in (1, 2)
             for op in ("sum", "min", "max", "any_valid", "first", "last")]
    types = [dt.INT64, dt.FLOAT64, dt.FLOAT32]
    if path == "dense":
        types[0] = dt.STRING
        dic = np.array([f"g{i}" for i in range(len(_C5_GROUPS))],
                       dtype=object)
        inputs = [([which.astype(np.int32), d, f], [dic, None, None])]
    elif path == "sort":
        inputs = [([which.astype(np.int64), d, f], [None] * 3)]
    else:
        inputs = [([which[which == i].astype(np.int64), d[which == i],
                    f[which == i]], [None] * 3)
                  for i in range(len(_C5_GROUPS))]
    for datas, dics in inputs:
        out = []
        for on in (dev, "cpu"):
            b = batch_from_numpy(datas, types, dictionaries=dics, device=on)
            nk.reset_launches()
            if path == "grand":
                got, _ = gb.reduce_aggregate(b, specs, types, on)
            else:
                got, _ = gb.groupby_aggregate(b, [0], specs, types)
            if on == dev:  # the sums (stacked), then each min and max
                assert nk.LAUNCHES["seg_sum"] == (5 if path == "sort" else 0)
            out.append([c.data.cpu() for c in got.columns])
        for g, w in zip(*out):
            assert g.dtype == w.dtype
            if g.is_floating_point():
                bits = torch.int64 if g.dtype == torch.float64 \
                    else torch.int32
                assert torch.equal(g.view(bits), w.view(bits))
            else:
                assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["left", "leftsemi", "full"])
def test_join_kinds_card_equal_cpu(kind):
    """Left, left semi and full joins of a 2M-row stream with nulls and
    repeated keys on the card and on the CPU: the same rows in the same
    order; the probe and the partition kernel run."""
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.batch import batch_from_numpy
    from spark_rapids_tpu_torch.ops import join as oj

    dev = _card()
    r = np.random.default_rng(17)
    n_s, n_b = 1 << 21, 300_000
    sk = r.integers(0, 500_000, n_s).astype(np.int64)
    bk = r.integers(100_000, 600_000, n_b).astype(np.int64)
    sval, bval = r.random(n_s), r.integers(0, 9, n_b).astype(np.int32)
    svalid = r.random(n_s) > 0.01
    rows = []
    for d in (dev, "cpu"):
        s = batch_from_numpy([sk, sval], [dt.INT64, dt.FLOAT64],
                             [svalid, None], device=d)
        b = batch_from_numpy([bk, bval], [dt.INT64, dt.INT32], device=d)
        nk.reset_launches()
        got, _ = oj.equi_join(s, b, [0], [0], [dt.INT64, dt.FLOAT64],
                              [dt.INT64, dt.INT32], kind)
        if d == dev:
            assert nk.LAUNCHES["probe"] >= 1
            assert nk.LAUNCHES["partition_order"] >= 1
        rows.append([(c.data.cpu().numpy(), None if c.validity is None
                      else c.validity.cpu().numpy()) for c in got.columns])
    for (gd, gv), (wd, wv) in zip(*rows):
        np.testing.assert_array_equal(gd, wd)
        assert (gv is None) == (wv is None)
        if gv is not None:
            np.testing.assert_array_equal(gv, wv)


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["bigint_nulls", "date", "scan"])
def test_numeric_key_dense_path_card_equal_cpu(key):
    """A numeric key whose column carries its (min, max) takes the dense
    path on the card as on the CPU (C6): the C5 groups' sum, min, max,
    any_valid, first and last bit for bit, no S1 launch; an int64 key
    with nulls and a negative range, a DATE key, and an int key straight
    from the scan (``ScanExec`` sets the range) under a query."""
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.batch import batch_from_numpy
    from spark_rapids_tpu_torch.columnar.column import HostRange
    from spark_rapids_tpu_torch.ops import groupby as gb

    dev = _card()
    d = np.concatenate(_C5_GROUPS)
    which = np.concatenate([[i] * len(g) for i, g in enumerate(_C5_GROUPS)])
    f = d.astype(np.float32)
    if key == "scan":
        from spark_rapids_tpu_torch.api import Session
        from spark_rapids_tpu_torch.plan import nodes as pn

        text = ("SELECT k, sum(d) AS s, min(d) AS lo, max(d) AS hi, "
                "min(f) AS flo, max(f) AS fhi FROM t GROUP BY k ORDER BY k")
        out = []
        for on in (dev, "cpu"):
            s = Session(device=on)
            s.create_temp_view("t", pn.InMemorySource(
                {"k": which.astype(np.int32), "d": d, "f": f}))
            nk.reset_launches()
            got = s.sql(text).collect()
            if on == dev:
                assert nk.LAUNCHES["seg_sum"] == 0
            out.append(got)
        for c in out[1]:
            assert np.asarray(out[0][c]).tobytes() == \
                np.asarray(out[1][c]).tobytes(), c
        return
    specs = [gb.AggSpec(op, o) for o in (1, 2)
             for op in ("sum", "min", "max", "any_valid", "first", "last")]
    if key == "date":
        kd, kt, kv = (which + 19000).astype(np.int32), dt.DATE, None
    else:
        kd, kt = which.astype(np.int64) - 2**40 - 7, dt.INT64
        kv = np.arange(len(which)) % 4 != 1
    types = [kt, dt.FLOAT64, dt.FLOAT32]
    out = []
    for on in (dev, "cpu"):
        b = batch_from_numpy([kd, d, f], types, [kv, None, None], device=on)
        b.columns[0].stats = HostRange(b.columns[0].data,
                                       b.columns[0].validity)
        assert gb._dense_layout(types, [0], (gb.key_range_of(
            b.columns[0], kt),), (kv is not None,)) is not None
        nk.reset_launches()
        got, _ = gb.groupby_aggregate(b, [0], specs, types)
        if on == dev:
            assert nk.LAUNCHES["seg_sum"] == 0
        out.append([(c.data.cpu(), None if c.validity is None else
                     c.validity.cpu()) for c in got.columns])
    for (g, gv), (w, wv) in zip(*out):
        assert g.dtype == w.dtype
        assert (gv is None) == (wv is None)
        if gv is not None:
            assert torch.equal(gv, wv)
            g, w = g[gv], w[wv]
        assert g.numpy().tobytes() == w.numpy().tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int8, np.int32, np.int64])
def test_host_range_on_card_equals_host(dtype):
    """A scan column's range reduced on the card (C6) equals numpy's over
    the same valid rows: with nulls, with none, all null and empty."""
    from spark_rapids_tpu_torch.columnar.column import HostRange

    dev = _card()
    r = np.random.default_rng(3)
    info = np.iinfo(dtype)
    x = r.integers(info.min, info.max, 100_003, dtype=dtype, endpoint=True)
    valid = r.random(len(x)) > 0.3
    cases = [(x, None), (x, valid), (x, np.zeros(len(x), bool)),
             (x[:0], None)]
    for vals, v in cases:
        live = vals if v is None else vals[v]
        want = (int(live.min()), int(live.max())) if len(live) else None
        got = HostRange(torch.from_numpy(vals).to(dev),
                        None if v is None else
                        torch.from_numpy(v).to(dev)).get()
        assert got == want


# -- fused chains (execs/fused.py) ---------------------------------------------


def _fusion_sessions(dev, conf):
    """A card and a CPU session over one seeded fact table and a
    dimension of 25 unique keys."""
    from spark_rapids_tpu_torch.api import Session
    from spark_rapids_tpu_torch.plan import nodes as pn

    r = np.random.default_rng(21)
    n = 50_000
    fact = {"i": np.arange(n, dtype=np.int64),
            "k": r.integers(-5, 25, n).astype(np.int64),
            "f": r.standard_normal(n), "g": r.standard_normal(n),
            "s": np.array(["x", "y", "zz"], dtype=object)[
                r.integers(0, 3, n)]}
    dim = {"dk": np.arange(-5, 20, dtype=np.int64),
           "w": r.standard_normal(25)}
    out = []
    for on in (dev, "cpu"):
        s = Session(dict(conf), device=on)
        s.create_temp_view("t", pn.InMemorySource(dict(fact)))
        s.create_temp_view("d", pn.InMemorySource(dict(dim)))
        out.append(s)
    return out


def _bits_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for c in want:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        if w.dtype.kind == "f":
            g, w = g.view(np.int64), w.view(np.int64)
        assert list(g) == list(w), c


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dense", "hash"])
def test_chain_join_card_equals_cpu(mode):
    """A standalone chain (a string filter, a join, a product fused into
    an add across the join) on the card and on the CPU, bit for bit; its
    join probes the dense table, or (past a 16-slot span ceiling) K3; the
    chain's compaction is K1; both counted in ``LAUNCHES``."""
    from spark_rapids_tpu_torch.execs.base import collect
    from spark_rapids_tpu_torch.execs.fused import fusion_summary
    from spark_rapids_tpu_torch.plan.overrides import apply_overrides

    dev = _card()
    conf = {"rapids.tpu.sql.reader.batchSizeRows": 8192}
    if mode == "hash":
        conf["rapids.tpu.sql.fusion.denseProbe.maxSpan"] = 16
    text = ("SELECT i, x + w AS y, k FROM (SELECT i, f * g AS x, k, s FROM "
            "t) q JOIN d ON q.k = d.dk WHERE s IN ('x', 'zz')")
    out = []
    for s in _fusion_sessions(dev, conf):
        tree = apply_overrides(s.sql(text)._plan, s.conf, device=s.device)
        nk.reset_launches()
        out.append(collect(tree))
        summary = fusion_summary(tree)
        assert summary["chains"] == 1 and summary["fell_back"] == 0
        assert summary[f"{mode}_joins"] == 1
        if s.device == dev:
            batches = -(-50_000 // 8192)
            assert nk.LAUNCHES["partition_order"] == batches
            assert nk.LAUNCHES["probe"] == (batches if mode == "hash"
                                            else 0)
    assert len(out[1]["i"]) > 0
    _bits_equal(*out)


@pytest.mark.cuda
def test_c7_queries_card_equal_cpu():
    """The C7 queries (the C6 paths of ``tests/test_torch_groupby.py``)
    on the card and on the CPU, both default (fused) sessions, bit for
    bit; where the key keeps its statistics, min(-0.0) is -0.0."""
    from spark_rapids_tpu_torch.api import Session
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.batch import Schema
    from spark_rapids_tpu_torch.plan import nodes as pn

    dev = _card()
    r = np.random.default_rng(6)
    n = 300
    a = {"k": r.integers(-5, 20, n).astype(np.int64),
         "v": r.standard_normal(n), "z": np.full(n, -0.0),
         "s": np.array(["x", "y"], dtype=object)[r.integers(0, 2, n)],
         "dt": r.integers(9000, 9060, n).astype(np.int32),
         "wide": r.integers(0, 5000, n).astype(np.int64)}
    b = {"k": np.arange(-5, 20, dtype=np.int64), "w": np.full(25, -0.0)}
    types = {"k": dt.INT64, "v": dt.FLOAT64, "z": dt.FLOAT64,
             "s": dt.STRING, "dt": dt.DATE, "wide": dt.INT64,
             "w": dt.FLOAT64}
    texts = [
        "SELECT k, min(z) AS m FROM a WHERE s = 'x' GROUP BY k",
        "SELECT k, min(z) AS m FROM (SELECT k, z FROM a WHERE v > 0.0) x "
        "GROUP BY k",
        "SELECT a.k, min(b.w) AS m FROM a JOIN b ON a.k = b.k GROUP BY a.k",
        "SELECT k2, min(z) AS m FROM (SELECT k + 1 AS k2, z FROM a) x "
        "GROUP BY k2",
        "SELECT wide, min(z) AS m FROM a GROUP BY wide"]
    for text in texts:
        out = []
        for on in (dev, "cpu"):
            s = Session(device=on)
            for name, cols in (("a", a), ("b", b)):
                s.create_temp_view(name, pn.InMemorySource(
                    dict(cols), Schema(list(cols),
                                       [types[c] for c in cols])))
            out.append(s.sql(text).collect())
        _bits_equal(*out)
        signs = np.signbit(np.asarray(out[0]["m"], np.float64))
        assert signs.all() == ("wide" not in text), text


def _same_values(got: dict, want: dict):
    """Bit for bit, a null as None and a NaN by its bits."""
    assert list(got) == list(want)
    for c in want:
        g = np.asarray(got[c], dtype=object).tolist()
        w = np.asarray(want[c], dtype=object).tolist()
        assert len(g) == len(w), c
        for a, b in zip(g, w):
            if a is None or b is None:
                assert a is None and b is None, c
            elif isinstance(a, float) or isinstance(b, float):
                assert np.float64(a).view(np.int64) == \
                    np.float64(b).view(np.int64), c
            else:
                assert a == b, c


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["dense", "sort", "grand"])
def test_moments_card_equal_cpu(path):
    """The central moments' lanes (sum, count, m2, rterm, sum_of_squares)
    on the card and on the CPU, bit for bit: on the sort path through the
    S1 kernel (one launch), on the dense path through the per-block
    histograms (integer-valued doubles, so any order of the adds is
    exact), and with no key; a group of one row, one of nulls only and a
    constant one among them."""
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.batch import batch_from_numpy
    from spark_rapids_tpu_torch.columnar.column import HostRange
    from spark_rapids_tpu_torch.ops import groupby as gb

    dev = _card()
    r = np.random.default_rng(29)
    n = 300_000
    key = r.integers(3, 100 if path == "dense" else 200_000, n)
    key[:1], key[1:5], key[5:12] = 0, 1, 2
    x = (r.integers(-1000, 1000, n).astype(np.float64) if path == "dense"
         else r.standard_normal(n) * 100 + 7)
    x[5:12] = 2.5
    valid = r.random(n) > 0.1
    valid[1:5] = False
    specs = [gb.AggSpec(op, 1) for op in ("sum", "count", "m2", "rterm",
                                          "sum_of_squares")]
    types = [dt.INT64, dt.FLOAT64]
    out = []
    for d in (dev, "cpu"):
        b = batch_from_numpy([key.astype(np.int64), x], types,
                             [None, valid], [None, None], device=d)
        if path == "dense":
            b.columns[0].stats = HostRange.known(0, 99)
        nk.reset_launches()
        if path == "grand":
            got, _ = gb.reduce_aggregate(b, specs, types, d)
        else:
            got, _ = gb.groupby_aggregate(b, [0], specs, types)
        if d == dev:
            assert nk.LAUNCHES["seg_sum"] == (1 if path == "sort" else 0)
        cols = {}
        for i, c in enumerate(got.columns):
            data, v = c.to_numpy()
            vals = data.astype(object)
            if v is not None:
                vals[~v] = None
            cols[str(i)] = vals
        out.append(cols)
    _same_values(*out)


@pytest.mark.cuda
def test_new_expressions_card_equal_cpu():
    """CASE, COALESCE, round at scales 0, 2 and 7, %, pmod and sqrt over
    seeded doubles (with -0.0, NaN, the infinities, 1e-310 and halves)
    and integers (with their limits and -1) on the card and on the CPU,
    bit for bit (the CPU's remainder and square root are libm's, the
    card's CUDA's, both exact)."""
    from spark_rapids_tpu_torch.api import Session
    from spark_rapids_tpu_torch.plan import nodes as pn

    dev = _card()
    r = np.random.default_rng(31)
    n = 20_000
    edges = [0.0, -0.0, 1e-310, -1e-310, np.nan, np.inf, -np.inf, 0.5,
             -2.5, 1e308, 2.0 ** 63]
    d = r.standard_normal(n) * 10.0 ** r.integers(-6, 7, n)
    d[:len(edges)] = edges
    e = r.standard_normal(n) * 10.0 ** r.integers(-3, 4, n)
    e[len(edges):2 * len(edges)] = edges
    k = r.integers(-10_000, 10_000, n)
    h = np.choose(r.integers(0, 3, n), [k + 0.5, k / 100 + 0.005,
                                        k / 1e7 + 5e-8])
    i = r.integers(-100, 100, n).astype(np.int64)
    i[:4] = [-2 ** 63, 2 ** 63 - 1, -1, 0]
    j = r.integers(-5, 5, n).astype(np.int64)
    cols = {"d": d, "e": e, "h": h, "i": i, "j": j}
    valid = {"e": r.random(n) > 0.1, "j": r.random(n) > 0.1}
    text = ("SELECT CASE WHEN d > 0.0 THEN d WHEN j IS NULL THEN e "
            "ELSE -1.5 END AS c, coalesce(e, h, 0.0) AS co, "
            "round(h) AS r0, round(h, 2) AS r2, round(d, 7) AS r7, "
            "d % e AS m, pmod(d, e) AS p, pmod(i, j) AS pi, i % j AS mi, "
            "sqrt(d) AS s FROM t")
    out = []
    for on in (dev, "cpu"):
        s = Session(device=on)
        s.create_temp_view("t", pn.InMemorySource(dict(cols),
                                                  validity=valid))
        out.append(s.sql(text).collect())
    _same_values(*out)


# the functions the reference tags incompat, and cbrt: case -> (class,
# operands), over the columns of ``_incompat_columns``
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
#: the largest gap, card against CPU (CUDA's libm against torch's CPU
#: one), in units in the last place over those columns (ROADMAP Queue C)
_CARD_ULPS = {"exp": 1, "expm1": 1, "log": 1, "log1p": 1, "log2": 1,
              "log10": 1, "sin": 1, "cos": 1, "tan": 2, "asin": 2,
              "acos": 1, "atan": 1, "sinh": 1, "cosh": 1, "tanh": 1,
              "asinh": 2, "acosh": 1, "atanh": 2, "cot": 2, "pow": 1,
              "logarithm": 1, "atan2": 1, "cbrt": 1}


def _incompat_columns(n):
    """Seeded doubles of every magnitude with -0.0, NaN, the infinities,
    1e-310 and the long limits (``d``; ``e`` the same edges reversed and
    nullable) and halves at scales 0, 2 and 7 (``r``)."""
    r = np.random.default_rng(33)
    edges = [0.0, -0.0, 1e-310, -1e-310, np.nan, np.inf, -np.inf, 0.5,
             -0.5, 1.5, -2.5, 1e308, -1e308, 3.0, 7.0, -7.0, 1.0, -1.0,
             2.0 ** 53, -(2.0 ** 63), 2.0 ** 63, 1e-300]
    d = r.standard_normal(n) * 10.0 ** r.integers(-6, 7, n)
    d[:len(edges)] = edges
    e = r.standard_normal(n) * 10.0 ** r.integers(-3, 4, n)
    e[:len(edges)] = edges[::-1]
    e[len(edges):2 * len(edges)] = edges
    k = r.integers(-10_000, 10_000, n)
    h = np.choose(r.integers(0, 3, n), [k + 0.5, k / 100 + 0.005,
                                        k / 1e7 + 5e-8])
    h[:len(edges)] = edges
    return {"d": d, "e": e, "r": h}, {"e": r.random(n) > 0.15}


def _incompat_projection(on, n=20_000):
    """``_INCOMPAT_CASES`` in one projection on ``on``, with
    ``rapids.tpu.sql.incompatibleOps.enabled``."""
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.execs.base import collect
    from spark_rapids_tpu_torch.expressions import math as tmath
    from spark_rapids_tpu_torch.expressions.base import (Alias,
                                                         BoundReference)
    from spark_rapids_tpu_torch.plan import nodes as pn
    from spark_rapids_tpu_torch.plan.overrides import apply_overrides

    cols, valid = _incompat_columns(n)
    names = list(cols)
    projs = [Alias(getattr(tmath, klass)(
                 *[BoundReference(names.index(a), dt.FLOAT64)
                   for a in args]), case)
             for case, (klass, args) in _INCOMPAT_CASES.items()]
    plan = pn.ProjectNode(projs, pn.ScanNode(
        pn.InMemorySource(cols, validity=valid)))
    return collect(apply_overrides(
        plan, {"rapids.tpu.sql.incompatibleOps.enabled": True}, device=on))


def _ulp_gap(got, want) -> np.ndarray:
    """The distance of two columns of doubles in units in the last place
    (the doubles' order on their bit patterns): 0 for two nulls or two
    NaN, 2^62 where only one is null or only one NaN."""
    def ordered(col):
        v = np.asarray(col, dtype=object)
        null = np.array([x is None for x in v.tolist()], dtype=bool)
        f = np.where(null, 0.0, v).astype(np.float64)
        i = f.view(np.int64)
        key = np.where(i < 0, -(i & np.int64(2 ** 63 - 1)), i)
        return key.astype(object), null, np.isnan(f)
    (a, an, anan), (b, bn, bnan) = ordered(got), ordered(want)
    gap = np.abs(a - b)
    gap[(an & bn) | (anan & bnan)] = 0
    gap[(an ^ bn) | (anan ^ bnan)] = 1 << 62
    return gap


@pytest.mark.cuda
def test_incompatible_functions_card_within_stated_ulps():
    """The incompatible transcendentals (and cbrt) with
    ``rapids.tpu.sql.incompatibleOps.enabled`` on the card against the
    CPU: nulls alike, every value within ``_CARD_ULPS``."""
    dev = _card()
    got, want = (_incompat_projection(on) for on in (dev, "cpu"))
    worst = {c: int(_ulp_gap(got[c], want[c]).max()) for c in want}
    assert all(worst[c] <= _CARD_ULPS[c] for c in worst), \
        " ".join(f"{c}={w}" for c, w in worst.items())


@pytest.mark.cuda
@pytest.mark.parametrize("query, tree", [("q16", "unfused"),
                                         ("q23_2002", "fused")])
def test_tpcxbb_query_card_equals_cpu(query, tree):
    """A TPCx-BB query at sf 0.1 on the card and on the CPU, bit for bit
    (the sort path's float sums fold in one order on both; q23_2002's
    standard deviations are over integers): q16 on the unfused tree (its
    two-key left join probes by hash), q23_2002 on the default one."""
    from spark_rapids_tpu_torch.benchmarks import tpcxbb
    from spark_rapids_tpu_torch.execs.base import collect
    from spark_rapids_tpu_torch.plan.overrides import apply_overrides

    dev = _card()
    t = tpcxbb.gen_tables(0.1)
    conf = {"rapids.tpu.sql.fusion.enabled": tree == "fused"}
    out = []
    for on in (dev, "cpu"):
        nk.reset_launches()
        out.append(collect(apply_overrides(tpcxbb.plan(query, t), conf,
                                           device=on)))
        if on == dev:
            assert nk.LAUNCHES["probe"] > 0
    assert len(next(iter(out[1].values()))) > 0
    _same_values(*out)
