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

from spark_rapids_tpu_torch.kernels import join as kjoin  # noqa: E402
from spark_rapids_tpu_torch.kernels import sort as ksort  # noqa: E402

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
