"""Broadcast hash join exec (the counterpart of
spark_rapids_tpu/execs/joins.py): the build child is drained and
prepared once (hash, sort, probe table), and every stream batch probes
it. Inner and left joins emit stream then build columns, semi and anti
joins the stream columns only; only an inner join takes a residual
condition, applied as a filter after the join, as the reference asserts.
A full join emits each unmatched build row once, so, as in the
reference, its stream side is drained into one batch first.

The join keeps its drained build (``build_batch``), as the reference's
broadcast exchange keeps its batch, and the builds prepared from it
(``prepared``): a fused chain that probes the build
(``execs/fused.py``) and this join, its fallback, drain it once."""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.execs.base import TorchExec
from spark_rapids_tpu_torch.execs.basic import filter_batch
from spark_rapids_tpu_torch.expressions.base import Expression
from spark_rapids_tpu_torch.ops.concat import concat_batches
from spark_rapids_tpu_torch.ops.join import equi_join, prepare_build

#: plan join kind -> ops.join join type (the reference's ``_KIND_MAP``)
KIND_MAP = {"inner": "inner", "left": "left", "left_semi": "leftsemi",
            "left_anti": "leftanti", "full": "full"}


def _drain(child: TorchExec, device) -> ColumnarBatch:
    parts = [b for b in child.execute() if b.num_rows]
    return concat_batches(parts) if parts else \
        ColumnarBatch.empty(child.schema, device)


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
        self.kind = kind
        self.join_type = KIND_MAP[kind]
        self.condition = condition
        self.left_keys = left_keys
        self.right_keys = right_keys
        self.device = device
        self._build: Optional[ColumnarBatch] = None
        #: the fused chains' preparations of the build, by key spec
        self.prepared: Dict[tuple, object] = {}

    def build_batch(self) -> ColumnarBatch:
        """The build child's rows as one batch, drained once (one batch
        keeps its columns' statistics; a concatenation has none, as in
        the reference)."""
        if self._build is None:
            self._build = _drain(self.children[1], self.device)
        return self._build

    def execute(self) -> Iterator[ColumnarBatch]:
        left_types = list(self.children[0].schema.types)
        right_types = list(self.children[1].schema.types)
        build = self.build_batch()
        prepared = prepare_build(build, self.right_keys, right_types,
                                 [left_types[o] for o in self.left_keys])
        stream = [_drain(self.children[0], self.device)] \
            if self.join_type == "full" else self.children[0].execute()
        saw = False
        for b in stream:
            if b.num_rows == 0 and saw:
                continue
            saw = True
            out = equi_join(b, build, self.left_keys, self.right_keys,
                            left_types, right_types, self.join_type,
                            prepared=prepared)[0]
            if self.condition is not None:
                out = filter_batch(out, self.condition, self.device)
            yield out
