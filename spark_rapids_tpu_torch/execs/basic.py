"""Scan, filter, project and limit execs (the counterpart of
spark_rapids_tpu/execs/basic.py)."""
from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import (ColumnarBatch, Schema,
                                                   batch_from_numpy)
from spark_rapids_tpu_torch.columnar.column import HostRange
from spark_rapids_tpu_torch.execs.base import TorchExec
from spark_rapids_tpu_torch.expressions import arithmetic as ar
from spark_rapids_tpu_torch.expressions.base import (
    Alias, BoundReference, ColV, EvalContext, Expression, Literal,
    broadcast)
from spark_rapids_tpu_torch.expressions.cast import Cast
from spark_rapids_tpu_torch.expressions.datetime import Year
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
                if _ranged(c.dtype):
                    c.stats = HostRange(c.data, c.validity)
            yield batch


def _ranged(t: dt.DType) -> bool:
    """Whether a column of type ``t`` may carry a ``HostRange``."""
    return t.is_integral or t in (dt.DATE, dt.TIMESTAMP)


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
            if _ranged(c.dtype):
                c.stats = derive_stats(e, ctx.columns)
    return ColumnarBatch(cols, batch.num_rows)


def _range(r: Optional[HostRange]):
    return None if r is None else r.get()


def derive_stats(e: Expression, cols: List[ColV]) -> Optional[HostRange]:
    """The range of a projected expression where the reference's
    ``derive_stats`` computes one: a column's own (not reduced here), a
    cast between discrete types, ``+ - *`` by an integer literal, the
    year of a date. None everywhere else."""
    while isinstance(e, Alias):
        e = e.children[0]
    if isinstance(e, BoundReference):
        return cols[e.ordinal].stats
    if isinstance(e, Cast):
        src = e.children[0].dtype
        if not _ranged(e.to) or (src is dt.TIMESTAMP) != \
                (e.to is dt.TIMESTAMP):
            return None  # a date <-> timestamp cast scales
        s = _range(derive_stats(e.children[0], cols))
        if s is None:
            return None
        if e.to.is_integral:
            info = np.iinfo(e.to.np_dtype)
            if s[0] < info.min or s[1] > info.max:
                return None  # it would wrap
        return HostRange.known(*s)
    if isinstance(e, (ar.Add, ar.Subtract, ar.Multiply)):
        return _arith_range(e, cols)
    if isinstance(e, Year):
        if e.children[0].dtype is not dt.DATE:
            return None
        s = _range(derive_stats(e.children[0], cols))
        if s is None:
            return None
        base = np.datetime64("1970-01-01", "D")
        y = [int((base + np.timedelta64(v, "D")).astype("datetime64[Y]")
                 .astype(int)) + 1970 for v in s]
        return HostRange.known(*y)  # year() is monotone over days
    return None


_I64 = (-(1 << 63), (1 << 63) - 1)


def _arith_range(e: Expression, cols: List[ColV]) -> Optional[HostRange]:
    """``+ - *`` with an integer literal on one side."""
    sides = []
    for c in e.children:
        if isinstance(c, Literal) and isinstance(c.value, int):
            sides.append(("lit", c.value))
        else:
            s = _range(derive_stats(c, cols))
            if s is None:
                return None
            sides.append(("col", s))
    kinds = [k for k, _ in sides]
    add, sub = isinstance(e, ar.Add), isinstance(e, ar.Subtract)
    if kinds == ["lit", "lit"]:
        a, b = sides[0][1], sides[1][1]
        v = a + b if add else a - b if sub else a * b
        lo, hi = v, v
    elif "lit" not in kinds:
        return None  # column-op-column bounds are not tracked
    elif kinds[0] == "lit":
        lit, (lo, hi) = sides[0][1], sides[1][1]
        lo, hi = ((lit - hi, lit - lo) if sub else (lo + lit, hi + lit)
                  if add else tuple(sorted((lo * lit, hi * lit))))
    else:
        (lo, hi), lit = sides[0][1], sides[1][1]
        lo, hi = ((lo - lit, hi - lit) if sub else (lo + lit, hi + lit)
                  if add else tuple(sorted((lo * lit, hi * lit))))
    # the bounds must hold in the expression's type: int32 arithmetic
    # that wraps on the device must not advertise unwrapped bounds
    if e.dtype.is_integral:
        info = np.iinfo(e.dtype.np_dtype)
        bounds = (int(info.min), int(info.max))
    else:
        bounds = _I64
    if lo < bounds[0] or hi > bounds[1]:
        return None
    return HostRange.known(lo, hi)
