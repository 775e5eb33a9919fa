"""Exec base and ``collect`` (the counterpart of
spark_rapids_tpu/execs/base.py). An exec yields columnar batches from
``execute()``; the port runs one partition, in the calling thread."""
from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema


class TorchExec:
    """Base physical operator."""

    def __init__(self, children: List["TorchExec"], schema: Schema):
        self.children = children
        self.schema = schema

    def execute(self) -> Iterator[ColumnarBatch]:
        raise NotImplementedError


def collect(exec_: TorchExec) -> Dict[str, np.ndarray]:
    """Run the plan and return its rows as name -> host array (batches
    in output order; a column with nulls is an object array with None)."""
    parts = [b.to_numpy(exec_.schema) for b in exec_.execute()
             if b.num_rows]
    out = {}
    for i, name in enumerate(exec_.schema.names):
        if parts:
            out[name] = np.concatenate([p[name] for p in parts])
        else:
            t = exec_.schema.types[i]
            out[name] = np.zeros(0, dtype=object if t is dt.STRING
                                 else t.np_dtype)
    return out

