"""Sort (the counterpart of spark_rapids_tpu/ops/sort.py): one stable
permutation from the order keys, then one gather per column."""
from __future__ import annotations

from typing import List

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.ops import sortkeys
from spark_rapids_tpu_torch.ops.sortkeys import SortKeySpec


def sort_indices(batch: ColumnarBatch, specs: List[SortKeySpec],
                 dtypes) -> torch.Tensor:
    cols = [(c.data, c.validity) for c in batch.columns]
    return sortkeys.lexsort_indices(cols, list(dtypes), list(specs))


def sort_batch(batch: ColumnarBatch, specs: List[SortKeySpec],
               dtypes) -> ColumnarBatch:
    if batch.num_rows == 0:
        return batch
    return batch.gather(sort_indices(batch, specs, dtypes))
