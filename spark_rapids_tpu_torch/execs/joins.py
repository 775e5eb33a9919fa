"""Broadcast hash join exec (the counterpart of
spark_rapids_tpu/execs/joins.py): the build child is drained and
prepared once (hash, sort, probe table), and every stream batch probes
it. Inner joins emit stream then build columns, filtered by the residual
condition when there is one; left anti joins emit the stream rows
without a match, stream columns only."""
from __future__ import annotations

from typing import Iterator, List, Optional

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.execs.base import TorchExec
from spark_rapids_tpu_torch.execs.basic import filter_batch
from spark_rapids_tpu_torch.expressions.base import Expression
from spark_rapids_tpu_torch.ops.concat import concat_batches
from spark_rapids_tpu_torch.ops.join import equi_join, prepare_build

#: plan join kind -> ops.join join type (the reference's ``_KIND_MAP``)
KIND_MAP = {"inner": "inner", "left_anti": "leftanti"}


class BroadcastHashJoinExec(TorchExec):
    """Equi-join; children[0] streams, children[1] builds."""

    def __init__(self, kind: str, left: TorchExec, right: TorchExec,
                 left_keys: List[int], right_keys: List[int],
                 schema: Schema, device,
                 condition: Optional[Expression] = None):
        super().__init__([left, right], schema)
        if condition is not None and kind != "inner":
            raise NotImplementedError(
                f"a {kind} join with a residual condition is not ported")
        self.join_type = KIND_MAP[kind]
        self.condition = condition
        self.left_keys = left_keys
        self.right_keys = right_keys
        self.device = device

    def execute(self) -> Iterator[ColumnarBatch]:
        left_types = list(self.children[0].schema.types)
        right_types = list(self.children[1].schema.types)
        parts = [b for b in self.children[1].execute() if b.num_rows]
        build = concat_batches(parts) if parts else \
            ColumnarBatch.empty(self.children[1].schema, self.device)
        prepared = prepare_build(build, self.right_keys, right_types,
                                 [left_types[o] for o in self.left_keys])
        saw = False
        for b in self.children[0].execute():
            if b.num_rows == 0 and saw:
                continue
            saw = True
            out = equi_join(b, build, self.left_keys, self.right_keys,
                            left_types, right_types, self.join_type,
                            prepared=prepared)[0]
            if self.condition is not None:
                out = filter_batch(out, self.condition, self.device)
            yield out
