"""String expressions (the counterpart of
spark_rapids_tpu/expressions/strings.py): starts_with, ends_with,
contains, like and substring.

A string column is codes into a sorted host dictionary, so each function
is work per dictionary entry plus a gather by code. The per-entry work
runs in the string kernels (kernels/strings.py: K4 for the predicates, K5
for LIKE, K6 for substring) whenever the dictionary has a char table;
where it has none (an empty dictionary, an entry over 512 bytes, or a
non-ASCII dictionary for substring or a LIKE with ``_``, which count
characters) the host transform ``_dict_map_val`` / ``_dict_map_str``
computes the same table in Python, as the reference does. A scalar input
is computed on the host.
"""
from __future__ import annotations

import re
from typing import Callable, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.column import Scalar, StringColumn
from spark_rapids_tpu_torch.expressions.base import ColV, Expression
from spark_rapids_tpu_torch.kernels import strings as kstr


def _dict_map_str(v: ColV, fn: Callable[[str], str]) -> ColV:
    """str -> str: a rebuilt sorted dictionary and a remap of the codes."""
    dic = v.scol.dictionary
    if len(dic) == 0:
        return v
    transformed = np.array([fn(str(s)) for s in dic], dtype=object)
    new_dict, inv = np.unique(transformed.astype(str), return_inverse=True)
    remap = torch.from_numpy(inv.reshape(-1).astype(np.int32)).to(
        v.data.device)
    codes = kstr.gather_table(remap, v.data)
    sc = StringColumn(codes, new_dict.astype(object), v.validity)
    return ColV(dt.STRING, codes, v.validity, sc)


def _dict_map_val(v: ColV, fn: Callable[[str], object],
                  out_dtype: dt.DType) -> ColV:
    """str -> value: a table per entry and a gather by code."""
    dic = v.scol.dictionary
    table = np.array([fn(str(s)) for s in dic] if len(dic) else [0],
                     dtype=out_dtype.np_dtype)
    data = kstr.gather_table(torch.from_numpy(table).to(v.data.device),
                             v.data)
    return ColV(out_dtype, data, v.validity)


class _StrPredicate(Expression):
    """starts_with / ends_with / contains / like against a literal
    needle."""

    kind: str = ""  # the kernel route: a K4 kind, or "like" for K5
    escape = "\\"

    def __init__(self, child: Expression, needle: str):
        super().__init__([child])
        self.needle = needle

    @property
    def dtype(self):
        return dt.BOOLEAN

    @property
    def device_only(self) -> bool:
        return False

    def test(self, s: str) -> bool:
        raise NotImplementedError

    def eval(self, ctx):
        v = self.children[0].eval(ctx)
        if isinstance(v, Scalar):
            if v.is_null:
                return Scalar(dt.BOOLEAN, None)
            return Scalar(dt.BOOLEAN, self.test(str(v.value)))
        out = kstr.predicate_colv(v, self.kind, self.needle, self.escape)
        if out is not None:
            return out
        return _dict_map_val(v, self.test, dt.BOOLEAN)


class StartsWith(_StrPredicate):
    kind = "starts"

    def test(self, s):
        return s.startswith(self.needle)


class EndsWith(_StrPredicate):
    kind = "ends"

    def test(self, s):
        return s.endswith(self.needle)


class Contains(_StrPredicate):
    kind = "contains"

    def test(self, s):
        return self.needle in s


class Like(_StrPredicate):
    """SQL LIKE: ``%`` any sequence, ``_`` any one character, and the
    ``escape`` character makes the next one literal (a lone trailing
    escape is itself a literal). The host test is the reference's
    regex."""

    kind = "like"

    def __init__(self, child: Expression, pattern: str, escape: str = "\\"):
        super().__init__(child, pattern)
        self.pattern = pattern
        self.escape = escape
        regex = []
        i = 0
        while i < len(pattern):
            ch = pattern[i]
            if ch == escape and i + 1 < len(pattern):
                regex.append(re.escape(pattern[i + 1]))
                i += 2
                continue
            if ch == "%":
                regex.append(".*")
            elif ch == "_":
                regex.append(".")
            else:
                regex.append(re.escape(ch))
            i += 1
        self._re = re.compile("(?s)^" + "".join(regex) + "$")

    def test(self, s):
        return self._re.match(s) is not None


class Substring(Expression):
    """substring(str, pos, len) with Spark's 1-based and negative ``pos``;
    ``length`` None runs to the end. ``pos`` and ``length`` are
    literals, as in the reference."""

    def __init__(self, child: Expression, pos: int,
                 length: Optional[int]):
        super().__init__([child])
        self.pos = pos
        self.length = length

    @property
    def dtype(self):
        return dt.STRING

    @property
    def device_only(self) -> bool:
        return False

    def fn(self, s: str) -> str:
        pos, ln = self.pos, self.length
        if pos > 0:
            start = pos - 1
        elif pos < 0:
            start = len(s) + pos
        else:
            start = 0
        # the end derives from the unclamped start: substring('abc', -5, 2)
        # is '' (Spark's UTF8String.substringSQL), not 'ab'
        end = len(s) if ln is None else start + ln
        return s[max(start, 0):max(end, 0)]

    def eval(self, ctx):
        v = self.children[0].eval(ctx)
        if isinstance(v, Scalar):
            if v.is_null:
                return Scalar(dt.STRING, None)
            return Scalar(dt.STRING, self.fn(str(v.value)))
        out = kstr.substring_colv(v, self.pos, self.length)
        if out is not None:
            return out
        return _dict_map_str(v, self.fn)
