"""TPC-H q14 and q22 through the port against the reference engine.

The port's numpy generators must give the reference generators' columns
seed for seed, on the whole-table path and on the chunked one. The
port's q14 and q22 (apply_overrides -> collect on the CPU) must equal the
reference engine's, run from the reference's own query functions over
parquet written from the reference's generators: once with fusion and
adaptive execution off and the native kernels on (the exec tree the port
mirrors), once with the default conf. Strings, keys and counts exact,
float sums within 1e-9 relative (the reference's own tolerance against
its CPU oracle; the two engines sum in different orders).

At sf 0.01 every customer has an order, so q22 is empty; it runs again
over the first 10% of the orders rows, where the anti join keeps rows and
the group-by, sort and average run on real data. A small scan batch size
gives every batch its own string dictionaries.
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
from spark_rapids_tpu_torch.execs.base import collect  # noqa: E402
from spark_rapids_tpu_torch.plan.overrides import (  # noqa: E402
    apply_overrides)

SF = 0.01
_UNFUSED = {"rapids.tpu.sql.fusion.enabled": False,
            "rapids.tpu.sql.adaptive.enabled": False}
_BATCH = "rapids.tpu.sql.reader.batchSizeRows"

_GENERATORS = {
    "lineitem": (datagen.gen_lineitem, datagen.LINEITEM_COLUMNS),
    "part": (datagen.gen_part, ["p_partkey", "p_type"]),
    "customer": (datagen.gen_customer, ["c_custkey", "c_acctbal",
                                        "c_phone"]),
    "orders": (datagen.gen_orders, ["o_custkey"])}


def _assert_columns_equal(got: dict, table: pa.Table, columns):
    for name in columns:
        want = table.column(name).to_numpy(zero_copy_only=False)
        if name == "l_shipdate":
            want = want.astype("datetime64[D]").astype(np.int64)
        assert len(got[name]) == len(want), name
        assert list(got[name]) == list(want), name


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
    return {"lineitem": datagen.gen_lineitem(SF),
            "part": datagen.gen_part(SF),
            "customer": datagen.gen_customer(SF),
            "orders": {"o_custkey": orders["o_custkey"][:n]}}


def _write(d, names, orders_fraction=1.0):
    for name in names:
        table = rdatagen.GENERATORS[name](SF)
        if name == "orders":
            table = table.slice(0, int(table.num_rows * orders_fraction))
        (d / name).mkdir()
        pq.write_table(table, str(d / name / "part-000.parquet"))


_QUERIES = {"q14": lambda t: tpch.q14(t["lineitem"], t["part"]),
            "q22": lambda t: tpch.q22(t["customer"], t["orders"])}
# q22 over the first 10% of the orders rows
_CASES = {"q14": ("q14", 1.0), "q22": ("q22", 1.0), "q22_few_orders":
          ("q22", 0.1)}


@pytest.fixture(scope="module")
def reference_results(tmp_path_factory):
    """case -> conf -> the reference engine's result."""
    dirs = {}
    for frac, names in ((1.0, ("lineitem", "part", "customer", "orders")),
                        (0.1, ("customer", "orders"))):
        d = tmp_path_factory.mktemp(f"tpch_{int(frac * 100)}")
        _write(d, names, frac)
        dirs[frac] = str(d)
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
    return out


def _assert_result_equal(got: dict, want):
    assert list(got) == list(want.columns)
    for name in want.columns:
        w = want[name].to_numpy()
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
    got = collect(apply_overrides(_QUERIES[query](_tables(frac)),
                                  device="cpu"))
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
    the sort meet string columns whose dictionaries differ (at 256 rows
    every part and customer batch has its own)."""
    query, frac = _CASES[case]
    got = collect(apply_overrides(_QUERIES[query](_tables(frac)),
                                  {_BATCH: batch_rows}, device="cpu"))
    _assert_result_equal(got, reference_results[case]["default"])


@pytest.mark.parametrize("case", sorted(_CASES))
def test_query_matches_numpy_oracle(case):
    query, frac = _CASES[case]
    t = _tables(frac)
    got = collect(apply_overrides(_QUERIES[query](t), device="cpu"))
    want = getattr(tpch, f"{query}_numpy")(
        *((t["lineitem"], t["part"]) if query == "q14" else
          (t["customer"], t["orders"])))
    assert list(got) == list(want)
    for name, col in want.items():
        if col.dtype.kind == "f":
            np.testing.assert_allclose(got[name], col, rtol=1e-9, atol=0)
        else:
            assert list(got[name]) == list(col)


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
