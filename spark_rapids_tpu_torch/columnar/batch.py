"""Columnar batches (the counterpart of spark_rapids_tpu/columnar/batch.py).

Every column of a batch has the batch's exact row count; the count is a
host int. :func:`batch_from_numpy` carries data across from the
reference: the arrays of an ``InMemorySource`` dict, or those behind a
reference ``ColumnarBatch`` (cut to its ``num_rows``), become the port's
batch on any device. Concatenation, which unifies string dictionaries,
is ``ops/concat.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import DEFAULT_DEVICE
from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.column import Column, StringColumn


class Schema:
    """Ordered (name, DType) pairs."""

    __slots__ = ("names", "types")

    def __init__(self, names: Sequence[str], types: Sequence[dt.DType]):
        if len(names) != len(types):
            raise ValueError("schema names and types differ in length")
        self.names = list(names)
        self.types = list(types)

    def index_of(self, name: str) -> int:
        return self.names.index(name)

    def __repr__(self) -> str:  # pragma: no cover
        return "Schema(" + ", ".join(
            f"{n}:{t}" for n, t in zip(self.names, self.types)) + ")"


class ColumnarBatch:
    __slots__ = ("columns", "num_rows")

    def __init__(self, columns: List[Column], num_rows: int):
        for c in columns:
            if c.num_rows != num_rows:
                raise ValueError(f"column of {c.num_rows} rows in a batch "
                                 f"of {num_rows}")
        self.columns = columns
        self.num_rows = int(num_rows)

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @staticmethod
    def empty(schema: Schema, device) -> "ColumnarBatch":
        cols: List[Column] = []
        for t in schema.types:
            data = torch.zeros(0, dtype=t.torch_dtype, device=device)
            cols.append(StringColumn(data, np.array([], dtype=object))
                        if t is dt.STRING else Column(t, data))
        return ColumnarBatch(cols, 0)

    def gather(self, idx: torch.Tensor) -> "ColumnarBatch":
        return ColumnarBatch([c.gather(idx) for c in self.columns],
                             int(idx.shape[0]))

    def to_numpy(self, schema: Schema) -> Dict[str, np.ndarray]:
        """name -> host array; a column with nulls becomes an object
        array with None in its null slots, strings are object arrays."""
        out = {}
        for name, c in zip(schema.names, self.columns):
            values, validity = c.to_numpy()
            if validity is not None and not isinstance(c, StringColumn):
                values = values.astype(object)
                values[~validity] = None
            out[name] = values
        return out

    def __repr__(self) -> str:  # pragma: no cover
        return f"ColumnarBatch(cols={self.num_columns}, rows={self.num_rows})"


def batch_from_numpy(columns: Sequence[np.ndarray],
                     types: Sequence[dt.DType],
                     validities: Optional[Sequence[Optional[np.ndarray]]]
                     = None,
                     dictionaries: Optional[Sequence[Optional[np.ndarray]]]
                     = None,
                     num_rows: Optional[int] = None,
                     device=DEFAULT_DEVICE) -> ColumnarBatch:
    """A batch from host arrays. A STRING column is either an object
    array of strings, or int codes with its sorted dictionary given in
    ``dictionaries``. ``num_rows`` cuts padded reference arrays to their
    live rows."""
    n = len(columns[0]) if num_rows is None else int(num_rows)
    cols: List[Column] = []
    for i, (vals, t) in enumerate(zip(columns, types)):
        vals = np.asarray(vals)[:n]
        valid = None
        if validities is not None and validities[i] is not None:
            valid = np.asarray(validities[i], dtype=bool)[:n]
        dic = dictionaries[i] if dictionaries is not None else None
        if t is dt.STRING and dic is not None:
            codes = torch.from_numpy(
                vals.astype(np.int32, copy=False)).to(device)
            vt = None if valid is None else torch.from_numpy(
                valid.copy()).to(device)
            cols.append(StringColumn(codes, np.asarray(dic, dtype=object),
                                     vt))
        else:
            cols.append(Column.from_numpy(vals, t, valid, device))
    return ColumnarBatch(cols, n)
