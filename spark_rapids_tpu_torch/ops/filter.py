"""Filter as stable compaction (the counterpart of
spark_rapids_tpu/ops/filter.py): the partition kernel puts kept rows
first in their original order, and the batch keeps that prefix."""
from __future__ import annotations

from typing import Optional

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.kernels import sort as ksort


def compact_batch(batch: ColumnarBatch, keep: torch.Tensor,
                  keep_validity: Optional[torch.Tensor] = None
                  ) -> ColumnarBatch:
    """Rows where ``keep`` is true AND valid survive (SQL WHERE drops
    rows whose predicate is null)."""
    if keep_validity is not None:
        keep = keep & keep_validity
    order, n_keep = ksort.partition_order_count(keep)
    return batch.gather(order[:n_keep])
