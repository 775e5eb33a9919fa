"""Batch concatenation (the counterpart of spark_rapids_tpu/ops/concat.py).

String columns whose dictionaries differ are first re-encoded onto one
(``unify_dictionaries``): a scan of object-array strings builds a sorted
dictionary per batch, and so does substring, so a build, sort or
aggregate merge over more than one batch can meet columns whose codes
mean different strings. The batches of a ``HostStrings`` scan share one
dictionary object and are joined as they are.
"""
from __future__ import annotations

from typing import List

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import (Column, StringColumn,
                                                    unify_dictionaries)


def concat_batches(batches: List[ColumnarBatch]) -> ColumnarBatch:
    """Row-wise concatenation of batches of one schema."""
    if len(batches) == 1:
        return batches[0]
    cols: List[Column] = []
    for i, first in enumerate(batches[0].columns):
        parts = [b.columns[i] for b in batches]
        if isinstance(first, StringColumn):
            parts = unify_dictionaries(parts)
            first = parts[0]
        data = torch.cat([p.data for p in parts])
        validity = None
        if any(p.validity is not None for p in parts):
            validity = torch.cat([
                p.validity if p.validity is not None else
                torch.ones(p.num_rows, dtype=torch.bool, device=p.device)
                for p in parts])
        cols.append(first._like(data, validity))
    return ColumnarBatch(cols, sum(b.num_rows for b in batches))
