"""Sort exec, in-core (the counterpart of spark_rapids_tpu/execs/sort.py):
the whole input is one batch sorted once. A string key sorts by its codes
after the concatenation has put every batch on one sorted dictionary."""
from __future__ import annotations

from typing import Iterator, List

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.execs.base import TorchExec
from spark_rapids_tpu_torch.ops.concat import concat_batches
from spark_rapids_tpu_torch.ops.sort import sort_batch
from spark_rapids_tpu_torch.ops.sortkeys import SortKeySpec


class SortExec(TorchExec):
    def __init__(self, specs: List[SortKeySpec], child: TorchExec, device):
        super().__init__([child], child.schema)
        self.specs = specs
        self.device = device

    def execute(self) -> Iterator[ColumnarBatch]:
        parts = [b for b in self.children[0].execute() if b.num_rows]
        if not parts:
            yield ColumnarBatch.empty(self.schema, self.device)
            return
        yield sort_batch(concat_batches(parts), self.specs,
                         self.schema.types)
