"""Device columns: a torch tensor plus an optional validity mask
(the counterpart of spark_rapids_tpu/columnar/column.py).

Columns have exact lengths: the reference pads to bucketed capacities
for XLA's static shapes, which eager PyTorch does not need. ``validity``
is a bool tensor (True = valid) or None for all-valid. Strings are
``StringColumn``: int32 codes on the device into a sorted dictionary on
the host, so code order is string order.
"""
from __future__ import annotations

import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import DEFAULT_DEVICE
from spark_rapids_tpu_torch.columnar import dtypes as dt


class Scalar:
    """A typed host scalar; ``value`` None is a typed NULL."""

    __slots__ = ("dtype", "value")

    def __init__(self, dtype: dt.DType, value):
        self.dtype = dtype
        self.value = value

    @property
    def is_null(self) -> bool:
        return self.value is None

    def __repr__(self) -> str:  # pragma: no cover
        return f"Scalar({self.dtype}, {self.value})"


class HostRange:
    """The (min, max) over the valid rows of an uploaded column (the
    reference's upload-time ``Column.stats``), reduced on the first
    ``get`` only: one reduction of the column's tensors and one 24-byte
    read (on the card a host pass over each 2M-row slice cost
    milliseconds a key column). None when no row is valid."""

    __slots__ = ("_data", "_validity", "_range")

    def __init__(self, data: Optional[torch.Tensor],
                 validity: Optional[torch.Tensor] = None):
        self._data, self._validity = data, validity
        self._range: Optional[Tuple[int, int]] = None

    @staticmethod
    def known(lo: int, hi: int) -> "HostRange":
        """A range known without a pass over the rows."""
        r = HostRange(None)
        r._range = (int(lo), int(hi))
        return r

    def get(self) -> Optional[Tuple[int, int]]:
        data, validity = self._data, self._validity
        if data is not None and data.numel():
            if validity is None:
                lo, hi = torch.aminmax(data)
                some = torch.ones((), dtype=data.dtype, device=data.device)
            else:
                info = torch.iinfo(data.dtype)
                lo = torch.where(validity, data, info.max).amin()
                hi = torch.where(validity, data, info.min).amax()
                some = validity.any().to(data.dtype)
            lo, hi, some = torch.stack([lo, hi, some]).tolist()
            if some:
                self._range = (int(lo), int(hi))
        self._data = self._validity = None
        return self._range


class Column:
    """``stats``, where set, is a ``HostRange`` of the column's values:
    the scan sets it on the integral and date columns it uploads, a
    projection derives it (``execs.basic.derive_stats``) and a filter
    under an aggregate keeps it; every other column an op builds has
    none."""

    __slots__ = ("dtype", "data", "validity", "stats")

    def __init__(self, dtype: dt.DType, data: torch.Tensor,
                 validity: Optional[torch.Tensor] = None,
                 stats: Optional[HostRange] = None):
        self.dtype = dtype
        self.data = data
        self.validity = validity
        self.stats = stats

    @staticmethod
    def from_numpy(values: np.ndarray, dtype: Optional[dt.DType] = None,
                   validity: Optional[np.ndarray] = None,
                   device=DEFAULT_DEVICE) -> "Column":
        values = np.asarray(values)
        if dtype is None:
            dtype = dt.from_numpy(values.dtype)
        if dtype is dt.STRING:
            return StringColumn.from_strings(values, validity, device)
        buf = values.astype(dtype.np_dtype, copy=True)
        vmask = None
        if validity is not None:
            vmask = np.asarray(validity, dtype=bool)
            # null slots hold the sentinel, as the reference's uploads do
            buf[~vmask] = dt.null_sentinel(dtype)
            vmask = torch.from_numpy(vmask.copy()).to(device)
        return Column(dtype, torch.from_numpy(buf).to(device), vmask)

    @property
    def num_rows(self) -> int:
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    def gather(self, idx: torch.Tensor) -> "Column":
        """Rows ``idx`` (int32 or int64 indices, all in range)."""
        data = torch.index_select(self.data, 0, idx)
        validity = None if self.validity is None else \
            torch.index_select(self.validity, 0, idx)
        return self._like(data, validity)

    def _like(self, data, validity) -> "Column":
        """Same type (and dictionary, for strings) over new tensors."""
        return Column(self.dtype, data, validity)

    def to_numpy(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(values, validity) on the host; validity None if all-valid."""
        data = self.data.cpu().numpy()
        validity = None
        if self.validity is not None:
            validity = self.validity.cpu().numpy()
            if validity.all():
                validity = None
        return data, validity

    def __repr__(self) -> str:  # pragma: no cover
        return (f"{type(self).__name__}({self.dtype}, n={self.num_rows}, "
                f"nulls={'?' if self.validity is not None else 'no'})")


_DICT_CACHES: Dict[int, Tuple[weakref.ref, dict]] = {}


def dictionary_cache(dictionary: np.ndarray) -> dict:
    """A dict for what is derived from one dictionary object (its
    entries' hashes, its char table on a device), shared by every column
    that holds that object, as every batch of a ``HostStrings`` scan
    does; it goes when the dictionary does."""
    key = id(dictionary)
    hit = _DICT_CACHES.get(key)
    if hit is not None and hit[0]() is dictionary:
        return hit[1]

    def drop(ref, key=key):
        if key in _DICT_CACHES and _DICT_CACHES[key][0] is ref:
            del _DICT_CACHES[key]

    store: dict = {}
    _DICT_CACHES[key] = (weakref.ref(dictionary, drop), store)
    return store


class StringColumn(Column):
    """int32 codes into ``dictionary``, a host object array of unique
    strings sorted ascending. What is derived from the dictionary is
    cached per dictionary object (``dictionary_cache``)."""

    __slots__ = ("dictionary",)

    def __init__(self, codes: torch.Tensor, dictionary: np.ndarray,
                 validity: Optional[torch.Tensor] = None):
        super().__init__(dt.STRING, codes, validity)
        self.dictionary = dictionary

    @staticmethod
    def from_strings(values: Sequence[Optional[str]],
                     validity: Optional[np.ndarray] = None,
                     device=DEFAULT_DEVICE) -> "StringColumn":
        """Sorted dictionary of the non-null values plus codes (the
        reference's ``StringColumn.host_codes``); None entries and
        ``validity`` False rows are null, with code 0."""
        arr = np.asarray(values, dtype=object)
        null = np.array([v is None for v in arr], dtype=bool)
        if validity is not None:
            null |= ~np.asarray(validity, dtype=bool)
        present = arr[~null].astype(str)
        if len(present):
            dictionary, inv = np.unique(present, return_inverse=True)
        else:
            dictionary, inv = np.array([], dtype=str), np.array([], int)
        codes = np.zeros(len(arr), dtype=np.int32)
        codes[~null] = inv.astype(np.int32)
        vmask = torch.from_numpy(~null).to(device) if null.any() else None
        return StringColumn(torch.from_numpy(codes).to(device),
                            np.asarray(dictionary, dtype=object), vmask)

    def _like(self, data, validity) -> "StringColumn":
        return StringColumn(data, self.dictionary, validity)

    def to_numpy(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        codes, validity = Column.to_numpy(self)
        if len(self.dictionary):
            out = self.dictionary[np.clip(codes, 0,
                                          len(self.dictionary) - 1)]
        else:
            out = np.full(len(codes), None, dtype=object)
        out = np.asarray(out, dtype=object)
        if validity is not None:
            out[~validity] = None
        return out, validity


def unify_dictionaries(cols: List[StringColumn]) -> List[StringColumn]:
    """The columns re-encoded onto one shared sorted dictionary (the
    reference's ``unify_dictionaries``): the merge of the dictionaries
    runs on the host, the remap of the codes is a gather on the device.
    A column whose dictionary already is the merged one keeps its codes,
    and columns that share one dictionary object come back as they are
    (no merge on the host)."""
    if not cols or all(c.dictionary is cols[0].dictionary for c in cols):
        return cols
    merged = np.unique(np.concatenate([
        c.dictionary.astype(str) if len(c.dictionary) else
        np.array([], dtype=str) for c in cols]))
    merged_obj = merged.astype(object)
    out = []
    for c in cols:
        if len(c.dictionary) == len(merged) and (
                len(merged) == 0 or bool((c.dictionary == merged_obj).all())):
            out.append(StringColumn(c.data, merged_obj, c.validity))
            continue
        if len(c.dictionary):
            remap = np.searchsorted(merged, c.dictionary.astype(str))
        else:
            remap = np.zeros(1, dtype=np.int64)  # every row is null
        remap_t = torch.from_numpy(remap.astype(np.int32)).to(c.device)
        codes = remap_t[c.data.to(torch.int64).clamp(0, len(remap) - 1)]
        out.append(StringColumn(codes, merged_obj, c.validity))
    return out
