"""Expression core (the counterpart of spark_rapids_tpu/expressions/base.py).

Expressions evaluate eagerly over a batch's tensors: a node returns a
``ColV`` (data, validity and, for strings, the column carrying the
dictionary) or a host ``Scalar``. Null semantics follow Spark SQL's
three-valued logic: unless a node says otherwise, output validity is the
AND of its inputs' validities.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import (Column, HostRange,
                                                    Scalar, StringColumn)


@dataclasses.dataclass
class ColV:
    """A column value during evaluation."""

    dtype: dt.DType
    data: torch.Tensor
    validity: Optional[torch.Tensor]
    scol: Optional[StringColumn] = None  # dictionary carrier for strings
    stats: Optional[HostRange] = None  # the batch column's, for a reference

    def to_column(self) -> Column:
        if self.dtype is dt.STRING and self.scol is not None:
            return StringColumn(self.data, self.scol.dictionary,
                                self.validity)
        return Column(self.dtype, self.data, self.validity)


EvalValue = Union[ColV, Scalar]


class EvalContext:
    """What an expression sees: the batch's columns and its row count;
    inside a fused chain also ``aux``, the per-batch dictionary positions
    of its string predicates (``execs.fused._AuxStringPred``)."""

    def __init__(self, columns: List[ColV], num_rows: int, device,
                 aux: tuple = ()):
        self.columns = columns
        self.num_rows = num_rows
        self.device = device
        self.aux = aux

    @staticmethod
    def from_batch(batch: ColumnarBatch, device) -> "EvalContext":
        cols = [ColV(c.dtype, c.data, c.validity,
                     c if isinstance(c, StringColumn) else None, c.stats)
                for c in batch.columns]
        return EvalContext(cols, batch.num_rows, device)


class Expression:
    def __init__(self, children: Sequence["Expression"] = ()):
        self.children = list(children)

    @property
    def dtype(self) -> dt.DType:
        raise NotImplementedError

    def eval(self, ctx: EvalContext) -> EvalValue:
        raise NotImplementedError

    @property
    def device_only(self) -> bool:
        """True where the reference evaluates the node inside one jitted
        program (no host work on a string dictionary): a projection of
        such nodes derives its columns' ranges, and a filter of one
        feeds the aggregate above it as a live mask."""
        return all(c.device_only for c in self.children)

    @property
    def deterministic(self) -> bool:
        """False for a node whose value depends on more than its row (the
        reference's nondeterministic expressions; none is ported yet)."""
        return all(c.deterministic for c in self.children)

    def transform(self, fn: Callable[["Expression"], "Expression"]
                  ) -> "Expression":
        """``fn`` applied bottom up; a node whose children change is
        copied, the tree given is left as it is."""
        kids = [c.transform(fn) for c in self.children]
        node = self
        if any(k is not c for k, c in zip(kids, self.children)):
            node = copy.copy(self)
            node.children = kids
        return fn(node)

    def collect(self, pred: Callable[["Expression"], bool]
                ) -> List["Expression"]:
        """Every node of the tree for which ``pred`` holds, pre-order."""
        out = [self] if pred(self) else []
        for c in self.children:
            out.extend(c.collect(pred))
        return out

    def __repr__(self) -> str:  # pragma: no cover
        name = type(self).__name__
        if self.children:
            return f"{name}({', '.join(map(repr, self.children))})"
        return name


class LeafExpression(Expression):
    def __init__(self):
        super().__init__(())


class BoundReference(LeafExpression):
    """Ordinal-bound input column."""

    def __init__(self, ordinal: int, dtype: dt.DType):
        super().__init__()
        self.ordinal = ordinal
        self._dtype = dtype

    @property
    def dtype(self) -> dt.DType:
        return self._dtype

    def eval(self, ctx: EvalContext) -> EvalValue:
        return ctx.columns[self.ordinal]

    def __repr__(self) -> str:  # pragma: no cover
        return f"input[{self.ordinal}:{self._dtype}]"


class Literal(LeafExpression):
    def __init__(self, value, dtype: Optional[dt.DType] = None):
        super().__init__()
        self._dtype = dtype if dtype is not None else \
            _infer_literal_type(value)
        self.value = value

    @property
    def dtype(self) -> dt.DType:
        return self._dtype

    def eval(self, ctx: EvalContext) -> EvalValue:
        return Scalar(self._dtype, self.value)

    def __repr__(self) -> str:  # pragma: no cover
        return f"lit({self.value!r})"


class Alias(Expression):
    """Named projection output."""

    def __init__(self, child: Expression, alias: str):
        super().__init__([child])
        self.alias = alias

    @property
    def dtype(self) -> dt.DType:
        return self.children[0].dtype

    def eval(self, ctx: EvalContext) -> EvalValue:
        return self.children[0].eval(ctx)


def broadcast(v: EvalValue, ctx: EvalContext) -> ColV:
    """A scalar materialized as a full column."""
    if isinstance(v, ColV):
        return v
    n, dev = ctx.num_rows, ctx.device
    if v.is_null:
        data = torch.zeros(n, dtype=v.dtype.torch_dtype, device=dev)
        valid = torch.zeros(n, dtype=torch.bool, device=dev)
        if v.dtype is dt.STRING:
            sc = StringColumn(data, np.array([], dtype=object), valid)
            return ColV(dt.STRING, data, valid, sc)
        return ColV(v.dtype, data, valid)
    if v.dtype is dt.STRING:
        data = torch.zeros(n, dtype=torch.int32, device=dev)
        sc = StringColumn(data, np.array([str(v.value)], dtype=object))
        return ColV(dt.STRING, data, None, sc)
    return ColV(v.dtype, torch.full((n,), v.value,
                                    dtype=v.dtype.torch_dtype, device=dev),
                None)


def and_validity(*vs: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    out = None
    for v in vs:
        if v is not None:
            out = v if out is None else (out & v)
    return out


def operand(v: EvalValue):
    """Raw operand: a scalar as a 0-d tensor of its type, a ColV's data."""
    if isinstance(v, Scalar):
        return torch.tensor(v.value, dtype=v.dtype.torch_dtype)
    return v.data


def value_validity(v: EvalValue) -> Optional[torch.Tensor]:
    return None if isinstance(v, Scalar) else v.validity


def _infer_literal_type(value) -> dt.DType:
    if value is None:
        raise ValueError("untyped null literal; pass dtype explicitly")
    if isinstance(value, bool):
        return dt.BOOLEAN
    if isinstance(value, int):
        return dt.INT32 if -2**31 <= value < 2**31 else dt.INT64
    if isinstance(value, float):
        return dt.FLOAT64
    if isinstance(value, str):
        return dt.STRING
    raise TypeError(f"cannot infer literal type for {value!r}")
