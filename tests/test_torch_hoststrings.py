"""Host-encoded strings (``spark_rapids_tpu_torch.io.hoststrings``)
against the reference's ``spark_rapids_tpu.io.hoststrings``, and the scan
over them.

``HostStrings.from_objects``, ``concat``, slicing and ``to_objects`` must
give exactly the reference's codes, dictionaries and objects on seeded
columns with None, empty strings, non-ASCII strings and an empty column.
A scan over a ``HostStrings`` table must give the rows the same table
gives as object arrays (which its source encodes once), without
``StringColumn.from_strings`` and with every batch holding the source's
one dictionary object.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spark_rapids_tpu.io.hoststrings import (  # noqa: E402
    HostStrings as RHostStrings)

from spark_rapids_tpu_torch.columnar.batch import Schema  # noqa: E402
from spark_rapids_tpu_torch.columnar import dtypes as dt  # noqa: E402
from spark_rapids_tpu_torch.columnar.column import (  # noqa: E402
    StringColumn, unify_dictionaries)
from spark_rapids_tpu_torch.execs.basic import ScanExec  # noqa: E402
from spark_rapids_tpu_torch.execs.base import collect  # noqa: E402
from spark_rapids_tpu_torch.io.hoststrings import HostStrings  # noqa: E402
from spark_rapids_tpu_torch.plan import nodes as pn  # noqa: E402
from spark_rapids_tpu_torch.plan.overrides import (  # noqa: E402
    apply_overrides)

_WORDS = np.array(["", "a", "b", "ab", "straße", "日本", "zz", "a b",
                   "Ünïcode", " lead", "trail ", "ä"], dtype=object)


def _column(seed: int, n: int) -> np.ndarray:
    """``n`` seeded strings of ``_WORDS`` with about a fifth None."""
    rng = np.random.default_rng(seed)
    out = _WORDS[rng.integers(0, len(_WORDS), n)].copy()
    out[rng.random(n) < 0.2] = None
    return out


_COLUMNS = {"empty": (0, 0), "one": (1, 1), "small": (2, 17),
            "large": (3, 500), "all_null": (4, 0)}


def _objects(case: str) -> np.ndarray:
    if case == "all_null":
        return np.array([None] * 9, dtype=object)
    return _column(*_COLUMNS[case])


def _same(got: HostStrings, want: RHostStrings):
    assert got.codes.dtype == want.codes.dtype == np.int32
    assert got.codes.tolist() == want.codes.tolist()
    assert got.dictionary.dtype == want.dictionary.dtype == object
    assert got.dictionary.tolist() == want.dictionary.tolist()


@pytest.mark.parametrize("case", sorted(_COLUMNS))
def test_from_objects_and_to_objects_match_reference(case):
    arr = _objects(case)
    got, want = HostStrings.from_objects(arr), RHostStrings.from_objects(arr)
    _same(got, want)
    assert len(got) == len(want) == len(arr)
    assert got.to_objects().tolist() == want.to_objects().tolist()
    valid = np.arange(len(arr)) % 3 != 0
    assert got.to_objects(valid).tolist() == \
        want.to_objects(valid).tolist()


@pytest.mark.parametrize("sl", [slice(0, 0), slice(3, 11), slice(None, 5),
                                slice(480, None), slice(1, 400, 7)])
def test_slices_keep_the_whole_dictionary(sl):
    arr = _objects("large")
    got = HostStrings.from_objects(arr)[sl]
    want = RHostStrings.from_objects(arr)[sl]
    _same(got, want)
    assert got.to_objects().tolist() == want.to_objects().tolist()
    with pytest.raises(TypeError):
        HostStrings.from_objects(arr)[3]


@pytest.mark.parametrize("parts", [
    ("small", "large"), ("empty", "small"), ("all_null", "one", "small"),
    ("empty",), ("all_null", "empty"), ("large", "large")])
def test_concat_matches_reference(parts):
    arrs = [_objects(p) for p in parts]
    got = HostStrings.concat([HostStrings.from_objects(a) for a in arrs])
    want = RHostStrings.concat([RHostStrings.from_objects(a) for a in arrs])
    _same(got, want)
    assert got.to_objects().tolist() == want.to_objects().tolist()


def test_concat_of_slices_of_one_column_matches_reference():
    """Slices that share one dictionary, as a scan's batches do."""
    arr = _objects("large")
    col, rcol = HostStrings.from_objects(arr), RHostStrings.from_objects(arr)
    cuts = [slice(0, 100), slice(100, 250), slice(250, None)]
    got = HostStrings.concat([col[c] for c in cuts])
    _same(got, RHostStrings.concat([rcol[c] for c in cuts]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_from_table_matches_from_objects(seed):
    """The generators' encoding: indices into a table of distinct
    strings, remapped through its sort, equal the encoding of the same
    rows as objects (entries no row uses are left out)."""
    rng = np.random.default_rng(seed)
    table = np.array(["x9", "", "日本", "b", "a", "straße", "zz"],
                     dtype=object)[rng.permutation(7)]
    idx = rng.integers(0, 5, 300)
    got = HostStrings.from_table(table, idx)
    want = RHostStrings.from_objects(table[idx])
    _same(got, want)


def _table(n: int = 61):
    rng = np.random.default_rng(5)
    objs = _column(6, n)
    return ({"k": np.arange(n, dtype=np.int64),
             "s": objs,
             "t": _WORDS[rng.integers(0, 4, n)].copy()},
            {"s": np.array([x is not None for x in objs]) &
             (np.arange(n) % 11 != 4)})


def test_scan_of_host_strings_equals_scan_of_objects(monkeypatch):
    """A scan in 7-row batches over ``HostStrings`` columns (one with
    nulls from None and from the validity mask) gives the rows of the
    same table as object arrays, which the source encodes once: the
    objects themselves, None where null. Neither scan calls
    ``from_strings``, and every batch holds its source's dictionary
    object, so concatenating them merges nothing."""
    data, valid = _table()
    encoded = {k: HostStrings.from_objects(v) if v.dtype == object else v
               for k, v in data.items()}
    # a row masked invalid holds code 0 on the device
    encoded["s"].codes[~valid["s"]] = 3
    calls = []
    orig = StringColumn.from_strings

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(StringColumn, "from_strings", staticmethod(counted))
    objs = pn.InMemorySource(data, validity=valid)
    assert isinstance(objs.data["s"], HostStrings)
    assert isinstance(objs.data["t"], HostStrings)
    assert objs.validity["t"] is None
    want = collect(apply_overrides(pn.ScanNode(objs), {
        "rapids.tpu.sql.reader.batchSizeRows": 7}, device="cpu"))
    assert calls == []
    assert list(want["k"]) == list(data["k"])
    assert list(want["s"]) == [x if v else None
                               for x, v in zip(data["s"], valid["s"])]
    assert list(want["t"]) == list(data["t"])
    src = pn.InMemorySource(encoded, validity=valid)
    assert src.schema().types == [dt.INT64, dt.STRING, dt.STRING]
    got = collect(apply_overrides(pn.ScanNode(src),
                                  {"rapids.tpu.sql.reader.batchSizeRows": 7},
                                  device="cpu"))
    assert calls == []
    assert list(got) == list(want)
    for name in want:
        assert list(got[name]) == list(want[name]), name
    batches = list(ScanExec(src, Schema(["k", "s", "t"], src.schema().types),
                            7, "cpu").execute())
    assert len(batches) == 9
    for b in batches:
        assert b.columns[1].dictionary is encoded["s"].dictionary
        assert b.columns[2].dictionary is encoded["t"].dictionary
        v = b.columns[1].validity
        assert (b.columns[1].data[~v] == 0).all()
    cols = [b.columns[1] for b in batches]
    assert unify_dictionaries(cols) == cols
    for b in ScanExec(objs, Schema(["k", "s", "t"], objs.schema().types),
                      7, "cpu").execute():
        assert b.columns[1].dictionary is objs.data["s"].dictionary
