"""Scan, filter, project and limit execs (the counterpart of
spark_rapids_tpu/execs/basic.py)."""
from __future__ import annotations

from typing import Iterator, List

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import (ColumnarBatch, Schema,
                                                   batch_from_numpy)
from spark_rapids_tpu_torch.columnar.column import HostRange
from spark_rapids_tpu_torch.execs.base import TorchExec
from spark_rapids_tpu_torch.expressions.base import (EvalContext,
                                                     Expression, broadcast)
from spark_rapids_tpu_torch.expressions.compiler import derive_stats, ranged
from spark_rapids_tpu_torch.io.hoststrings import HostStrings
from spark_rapids_tpu_torch.ops.filter import compact_batch
from spark_rapids_tpu_torch.plan.nodes import InMemorySource


class ScanExec(TorchExec):
    """Host columns uploaded in slices of ``batch_rows`` rows. A string
    column (a ``HostStrings`` in the source) uploads a slice of its codes
    (0 where the row is null), and every batch shares its one dictionary
    object. An integral, DATE or TIMESTAMP column carries the (min, max)
    of its slice's valid rows (``HostRange``, reduced on first use), as
    the reference's upload computes it for a source without footer
    statistics."""

    def __init__(self, source: InMemorySource, schema: Schema,
                 batch_rows: int, device):
        super().__init__([], schema)
        self.source = source
        self.batch_rows = batch_rows
        self.device = device

    def execute(self) -> Iterator[ColumnarBatch]:
        n = self.source.num_rows()
        if n == 0:
            yield ColumnarBatch.empty(self.schema, self.device)
            return
        data, validity = self.source.data, self.source.validity
        names = self.schema.names
        dics = [data[name].dictionary
                if isinstance(data[name], HostStrings) else None
                for name in names]
        for lo in range(0, n, self.batch_rows):
            hi = min(lo + self.batch_rows, n)
            valids = [None if validity.get(name) is None else
                      np.asarray(validity[name], dtype=bool)[lo:hi]
                      for name in names]
            cols = []
            for name, dic, v in zip(names, dics, valids):
                if dic is None:
                    cols.append(np.asarray(data[name])[lo:hi])
                else:
                    codes = data[name].codes[lo:hi]
                    cols.append(codes if v is None else
                                np.where(v, codes, 0))
            batch = batch_from_numpy(cols, self.schema.types, valids, dics,
                                     device=self.device)
            for c in batch.columns:
                if ranged(c.dtype):
                    c.stats = HostRange(c.data, c.validity)
            yield batch


class FilterExec(TorchExec):
    """Predicate, then stable compaction of the rows it keeps. Under an
    aggregate (``keep_stats``) the kept rows keep their columns' ranges:
    there the reference passes the predicate to the group-by as a live
    mask over the child's own columns, so their statistics survive."""

    def __init__(self, condition: Expression, child: TorchExec, device,
                 keep_stats: bool = False):
        super().__init__([child], child.schema)
        self.condition = condition
        self.device = device
        self.keep_stats = keep_stats

    def execute(self) -> Iterator[ColumnarBatch]:
        for b in self.children[0].execute():
            out = filter_batch(b, self.condition, self.device)
            if self.keep_stats:
                for c, src in zip(out.columns, b.columns):
                    c.stats = src.stats
            yield out


def filter_batch(batch: ColumnarBatch, condition: Expression, device
                 ) -> ColumnarBatch:
    """The rows of ``batch`` where ``condition`` is true (not null)."""
    ctx = EvalContext.from_batch(batch, device)
    v = broadcast(condition.eval(ctx), ctx)
    return compact_batch(batch, v.data, v.validity)


class LimitExec(TorchExec):
    """The first ``n`` rows, in the child's order; the child is not run
    past the batch that reaches ``n``."""

    def __init__(self, n: int, child: TorchExec, device):
        super().__init__([child], child.schema)
        self.n = n
        self.device = device

    def execute(self) -> Iterator[ColumnarBatch]:
        left = self.n
        if left <= 0:
            return
        for b in self.children[0].execute():
            if b.num_rows > left:
                b = b.gather(torch.arange(left, device=self.device))
            left -= b.num_rows
            yield b
            if left == 0:
                return


class ProjectExec(TorchExec):
    def __init__(self, exprs: List[Expression], child: TorchExec,
                 schema: Schema, device):
        super().__init__([child], schema)
        self.exprs = exprs
        self.device = device

    def execute(self) -> Iterator[ColumnarBatch]:
        for b in self.children[0].execute():
            yield project(b, self.exprs, self.device)


def project(batch: ColumnarBatch, exprs: List[Expression], device
            ) -> ColumnarBatch:
    """``exprs`` over ``batch``. Where every expression is
    ``device_only`` (the reference compiles such a projection into one
    program), each output column carries the range ``derive_stats``
    gives it; otherwise none does, as on the reference's eager path."""
    ctx = EvalContext.from_batch(batch, device)
    cols = [broadcast(e.eval(ctx), ctx).to_column() for e in exprs]
    if all(e.device_only for e in exprs):
        for c, e in zip(cols, exprs):
            if ranged(c.dtype):
                c.stats = derive_stats(e, ctx.columns)
    return ColumnarBatch(cols, batch.num_rows)
