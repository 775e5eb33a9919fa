"""Dictionary-encoded host string columns (the counterpart of
spark_rapids_tpu/io/hoststrings.py, the port's own copy).

A string column on the host is int32 codes into one sorted dictionary,
so a scan uploads a slice of the codes and shares the dictionary object
with every batch it makes: no Python string per row, and no sorted
dictionary built per batch. Numpy only.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


class HostStrings:
    """One host string column: ``codes`` (int32, one per row; invalid
    rows hold 0) indexing ``dictionary`` (object ndarray of unique
    strings, sorted ascending). Supports ``len`` and slice indexing; a
    slice keeps the whole dictionary. Row validity travels separately,
    as for numeric columns."""

    __slots__ = ("codes", "dictionary")

    def __init__(self, codes: np.ndarray, dictionary: np.ndarray):
        self.codes = np.asarray(codes, dtype=np.int32)
        self.dictionary = np.asarray(dictionary, dtype=object)

    def __len__(self) -> int:
        return len(self.codes)

    def __getitem__(self, sl) -> "HostStrings":
        if not isinstance(sl, slice):
            raise TypeError("HostStrings supports slice indexing only")
        return HostStrings(self.codes[sl], self.dictionary)

    def to_objects(self, validity: Optional[np.ndarray] = None
                   ) -> np.ndarray:
        """The object-array form (None = null)."""
        if len(self.dictionary):
            out = self.dictionary[
                np.clip(self.codes, 0, len(self.dictionary) - 1)]
            out = np.asarray(out, dtype=object)
        else:
            out = np.full(len(self.codes), None, dtype=object)
        if validity is not None:
            out = out.copy()
            out[~np.asarray(validity, dtype=bool)] = None
        return out

    @staticmethod
    def from_objects(arr: np.ndarray) -> "HostStrings":
        """An object array (None = null) encoded: the sorted dictionary of
        its strings and a code per row (0 for a null)."""
        arr = np.asarray(arr, dtype=object)
        null = np.array([x is None for x in arr], dtype=bool)
        non_null = arr[~null].astype(str) if (~null).any() \
            else np.array([], dtype=str)
        dictionary, inv = (np.unique(non_null, return_inverse=True)
                           if len(non_null) else
                           (np.array([], dtype=object),
                            np.array([], dtype=np.int64)))
        codes = np.zeros(len(arr), dtype=np.int32)
        codes[~null] = inv.reshape(-1).astype(np.int32)
        return HostStrings(codes, np.asarray(dictionary, dtype=object))

    @staticmethod
    def from_table(table: np.ndarray, index: np.ndarray) -> "HostStrings":
        """Row i is ``table[index[i]]``, for a table of distinct strings:
        the entries the rows use, sorted once, and the indices remapped
        through that sort (no Python string per row)."""
        table = np.asarray(table, dtype=object)
        index = np.asarray(index)
        used = np.zeros(len(table), dtype=bool)
        used[index] = True
        keep = np.flatnonzero(used)
        order = np.argsort(table[keep].astype(str), kind="stable")
        rank = np.zeros(len(table), dtype=np.int32)
        rank[keep[order]] = np.arange(len(keep), dtype=np.int32)
        return HostStrings(rank[index], table[keep[order]])

    @staticmethod
    def concat(parts: List["HostStrings"]) -> "HostStrings":
        """The columns one after another, on one merged sorted
        dictionary."""
        dicts = [p.dictionary.astype(str) for p in parts
                 if len(p.dictionary)]
        if not dicts:
            return HostStrings(
                np.concatenate([p.codes for p in parts])
                if parts else np.array([], dtype=np.int32),
                np.array([], dtype=object))
        merged = np.unique(np.concatenate(dicts))
        out_codes = []
        for p in parts:
            if len(p.dictionary):
                remap = np.searchsorted(
                    merged, p.dictionary.astype(str)).astype(np.int32)
                out_codes.append(remap[p.codes])
            else:
                out_codes.append(p.codes)
        return HostStrings(np.concatenate(out_codes),
                           np.asarray(merged, dtype=object))
