"""Hash-aggregate exec (the counterpart of
spark_rapids_tpu/execs/aggregate.py) in the reference's "complete" mode:
each batch is projected to (keys, aggregate inputs) and aggregated with
the update ops; the result is concatenated with the running partials and
re-aggregated with the merge ops; after the last batch the final
projection evaluates each aggregate over its partials.

With no grouping keys every step is a whole-batch reduction to one row,
and an empty input still yields one row: count 0, every other aggregate
null (the reference's ``_empty_global_partials``). A distinct aggregate
must have been rewritten by ``plan/optimizer`` first.

Two hooks serve the fused execs (``execs/fused.py``): ``_update_inputs``
gives each batch's update inputs with a live mask (a fused aggregate's
chain leaves its rows in place and masks the dead ones), and
``defer_final`` makes the exec yield its raw (keys..., partials...)
for a chain that took over the final projection."""
from __future__ import annotations

from typing import Iterator, List

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.columnar.column import Column, StringColumn
from spark_rapids_tpu_torch.execs.base import TorchExec
from spark_rapids_tpu_torch.execs.basic import project
from spark_rapids_tpu_torch.expressions.base import (Alias, BoundReference,
                                                     Expression)
from spark_rapids_tpu_torch.ops.concat import concat_batches
from spark_rapids_tpu_torch.ops.groupby import (AggSpec, groupby_aggregate,
                                                reduce_aggregate)
from spark_rapids_tpu_torch.plan.nodes import AggCall


class HashAggregateExec(TorchExec):
    #: yield (keys..., partials...) unfinished: set by the fusion pass
    #: when the consuming chain applies the final projection
    defer_final = False

    def __init__(self, grouping: List[Expression], aggs: List[AggCall],
                 child: TorchExec, schema: Schema, device):
        super().__init__([child], schema)
        self.device = device
        self.grouping = list(grouping)
        self.aggs = list(aggs)
        nkeys = len(grouping)
        # input projection: keys, then each aggregate's input once
        self.input_exprs: List[Expression] = list(grouping)
        self.update_specs: List[AggSpec] = []
        for call in aggs:
            if call.fn.distinct:
                raise NotImplementedError(
                    f"{call.name}: a distinct aggregate reaches the exec "
                    "only through plan/optimizer.rewrite_distinct_"
                    "aggregates")
            ordinal = -1
            if call.fn.input is not None:
                ordinal = len(self.input_exprs)
                self.input_exprs.append(call.fn.input)
            for op in call.fn.update_ops():
                self.update_specs.append(
                    AggSpec(op, ordinal if op != "count_star" else -1))
        self.input_types = [e.dtype for e in self.input_exprs]
        # merge specs re-aggregate (keys..., partials...) batches
        self.merge_specs: List[AggSpec] = []
        self.merge_types: List[dt.DType] = [e.dtype for e in grouping]
        final: List[Expression] = [BoundReference(i, e.dtype)
                                   for i, e in enumerate(grouping)]
        p = nkeys
        for call in aggs:
            refs = []
            for op, t in zip(call.fn.merge_ops(), call.fn.partial_types()):
                self.merge_specs.append(AggSpec(op, p))
                self.merge_types.append(t)
                refs.append(BoundReference(p, t))
                p += 1
            final.append(Alias(call.fn.evaluate(refs), call.name))
        self.final_exprs = final
        self.nkeys = nkeys
        self.partial_types = self.merge_types[nkeys:]

    def _aggregate(self, batch, specs, types, live_mask=None
                   ) -> ColumnarBatch:
        if not self.nkeys:
            return reduce_aggregate(batch, specs, types, self.device,
                                    live_mask)[0]
        return groupby_aggregate(batch, list(range(self.nkeys)), specs,
                                 types, live_mask)[0]

    def _update_inputs(self, b: ColumnarBatch):
        """(the batch's update inputs, live mask or None)."""
        return project(b, self.input_exprs, self.device), None

    def merge_schema(self) -> Schema:
        return Schema([f"_m{i}" for i in range(len(self.merge_types))],
                      self.merge_types)

    def _empty_global_partials(self) -> ColumnarBatch:
        """One row of partials over zero rows: counts 0, the rest null."""
        cols = []
        for spec, t in zip(self.update_specs, self.merge_types):
            data = torch.zeros(1, dtype=t.torch_dtype, device=self.device)
            if spec.op in ("count", "count_star"):
                cols.append(Column(t, data))
                continue
            valid = torch.zeros(1, dtype=torch.bool, device=self.device)
            cols.append(StringColumn(data, np.array([], dtype=object), valid)
                        if t is dt.STRING else Column(t, data, valid))
        return ColumnarBatch(cols, 1)

    def execute(self) -> Iterator[ColumnarBatch]:
        running = None
        for b in self.children[0].execute():
            if b.num_rows == 0:
                continue
            inputs, mask = self._update_inputs(b)
            if mask is not None and not bool(mask.any()):
                continue  # no live row: its partial would change nothing
            part = self._aggregate(inputs, self.update_specs,
                                   self.input_types, mask)
            running = part if running is None else self._aggregate(
                concat_batches([running, part]), self.merge_specs,
                self.merge_types)
        if running is None:
            if self.nkeys:
                yield ColumnarBatch.empty(
                    self.merge_schema() if self.defer_final
                    else self.schema, self.device)
                return
            running = self._empty_global_partials()
        yield running if self.defer_final else \
            project(running, self.final_exprs, self.device)
