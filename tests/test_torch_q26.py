"""TPCx-BB q26 through the port against the reference engine.

The port's numpy generators must give the reference generators' q26
columns seed for seed; the port's q26 (apply_overrides -> collect on the
CPU) must equal the reference engine's q26 exactly, run from the
reference's own query builder over parquet written from the reference's
generators: once with fusion and adaptive execution off and the native
kernels on (against the port's unfused tree), once with the default conf
(against the port's default, fused, tree, which has the shape of the
reference's: the same fused execs with the same steps).
"""
from __future__ import annotations

import numpy as np
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

from spark_rapids_tpu.benchmarks import tpcds  # noqa: E402
from spark_rapids_tpu.benchmarks import tpcxbb as rtpcxbb  # noqa: E402
from spark_rapids_tpu.config import RapidsConf  # noqa: E402
from spark_rapids_tpu.execs.base import collect as rcollect  # noqa: E402
from spark_rapids_tpu.native import kernels as rnk  # noqa: E402
from spark_rapids_tpu.plan.overrides import (  # noqa: E402
    apply_overrides as rapply)

from spark_rapids_tpu_torch import kernels as tnk  # noqa: E402
from spark_rapids_tpu_torch.benchmarks import tpcds as ttpcds  # noqa: E402
from spark_rapids_tpu_torch.benchmarks import tpcxbb  # noqa: E402
from spark_rapids_tpu_torch.execs.base import collect  # noqa: E402
from spark_rapids_tpu_torch.io.hoststrings import HostStrings  # noqa: E402
from spark_rapids_tpu_torch.plan.overrides import (  # noqa: E402
    apply_overrides)

SF = 0.01
_UNFUSED = {"rapids.tpu.sql.fusion.enabled": False,
            "rapids.tpu.sql.adaptive.enabled": False}


def test_generators_match_reference():
    ss_ref = tpcds.gen_store_sales(SF)
    it_ref = tpcds.gen_item(SF)
    ss, it = ttpcds.gen_store_sales(SF), ttpcds.gen_item(SF)
    for name in tpcxbb.READS["q26"]["store_sales"]:
        np.testing.assert_array_equal(ss[name],
                                      ss_ref.column(name).to_numpy())
    for name in tpcxbb.READS["q26"]["item"]:
        want = it_ref.column(name).to_numpy(zero_copy_only=False)
        got = it[name]
        if isinstance(got, HostStrings):  # decoded to compare
            got = got.to_objects()
        assert got.dtype == want.dtype or name == "i_category"
        assert list(got) == list(want)


@pytest.fixture(scope="module")
def reference_q26(tmp_path_factory):
    """The reference engine's q26 result, per conf, from parquet of the
    reference generators' tables."""
    d = tmp_path_factory.mktemp("q26")
    for name, table in (("store_sales", tpcds.gen_store_sales(SF)),
                        ("item", tpcds.gen_item(SF))):
        (d / name).mkdir()
        pq.write_table(table, str(d / name / "part-000.parquet"))
    out = {}
    try:
        rnk.configure(enabled=True)
        out["unfused_kernels"] = rcollect(rapply(rtpcxbb.q26(str(d)),
                                                 RapidsConf(_UNFUSED)))
    finally:
        rnk.reset_config()
    out["default"] = rcollect(rapply(rtpcxbb.q26(str(d)), RapidsConf()))
    from test_torch_fusion import shape

    out["fused_shape"] = shape(rapply(rtpcxbb.q26(str(d)), RapidsConf(
        {"rapids.tpu.sql.adaptive.enabled": False})))
    return out


@pytest.mark.parametrize("conf", ["unfused_kernels", "default"])
@pytest.mark.parametrize("batch_rows", [None, 5000],
                         ids=["one_batch", "many_batches"])
def test_q26_matches_reference_engine(reference_q26, conf, batch_rows):
    """Exact equality, row for row, on every column. ``many_batches``
    splits the scans so the aggregate's running merge and the probe of
    one prepared build by many stream batches both run."""
    want = reference_q26[conf]
    tconf = {} if batch_rows is None else \
        {"rapids.tpu.sql.reader.batchSizeRows": batch_rows}
    if conf == "unfused_kernels":
        tconf["rapids.tpu.sql.fusion.enabled"] = False
    ss, it = ttpcds.gen_store_sales(SF), ttpcds.gen_item(SF)
    tnk.reset_launches()
    got = collect(apply_overrides(tpcxbb.q26(ss, it), tconf, device="cpu"))
    assert list(got) == list(want.columns)
    assert len(got["cid"]) == len(want) == 243
    for name in want.columns:
        np.testing.assert_array_equal(got[name],
                                      want[name].to_numpy(np.int64))
    # on the CPU the wrappers run their plain versions: nothing launches
    assert all(v == 0 for v in tnk.LAUNCHES.values())


def test_q26_fused_tree_has_the_reference_shape(reference_q26):
    from test_torch_fusion import shape

    ss, it = ttpcds.gen_store_sales(SF), ttpcds.gen_item(SF)
    texec = apply_overrides(tpcxbb.q26(ss, it), device="cpu")
    assert shape(texec) == reference_q26["fused_shape"]
    assert [n for n, _ in shape(texec)].count("FusedChainExec") == 2


def test_q26_matches_numpy_oracle():
    ss, it = ttpcds.gen_store_sales(0.02), ttpcds.gen_item(0.02)
    got = collect(apply_overrides(tpcxbb.q26(ss, it), device="cpu"))
    want = tpcxbb.q26_numpy(ss, it)
    for name, col in want.items():
        np.testing.assert_array_equal(got[name], col)
