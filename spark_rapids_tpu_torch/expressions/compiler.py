"""What the reference's expression compiler derives on the host (the
counterpart of spark_rapids_tpu/expressions/compiler.py): the (min, max)
of a projected column, ``derive_stats``, which the projection exec and
the fused chains (``execs/fused.py``) share, and the substitution of a
projection into the expressions over it, which the optimizer's collapse
and a chain's composition share. The
reference's compiled projections and program caches have no counterpart:
the port evaluates eagerly (``execs.basic.project``)."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.column import HostRange
from spark_rapids_tpu_torch.expressions import arithmetic as ar
from spark_rapids_tpu_torch.expressions.base import (Alias, BoundReference,
                                                     Expression, Literal)
from spark_rapids_tpu_torch.expressions.cast import Cast
from spark_rapids_tpu_torch.expressions.datetime import Year


def ranged(t: dt.DType) -> bool:
    """Whether a column of type ``t`` may carry a ``HostRange``."""
    return t.is_integral or t in (dt.DATE, dt.TIMESTAMP)


def unwrap_alias(e: Expression) -> Expression:
    while isinstance(e, Alias):
        e = e.children[0]
    return e


def substitute(e: Expression, inner: List[Expression]) -> Expression:
    """``e`` with each bound reference replaced by the expression of
    that ordinal in ``inner`` (its alias unwrapped): ``e`` over an inner
    projection's columns as an expression over that projection's input."""
    return e.transform(lambda n: unwrap_alias(inner[n.ordinal])
                       if isinstance(n, BoundReference) else n)


def _range(r: Optional[HostRange]):
    return None if r is None else r.get()


def derive_stats(e: Expression, cols: List) -> Optional[HostRange]:
    """The range of a projected expression where the reference's
    ``derive_stats`` computes one: a column's own (not reduced here), a
    cast between discrete types, ``+ - *`` by an integer literal,
    ``pmod`` by a positive integer literal (in [0, n - 1] whatever its
    input), the year of a date. None everywhere else. ``cols`` are the
    input columns as anything with a ``stats`` (a ``ColV``, a fused
    chain's ghost)."""
    e = unwrap_alias(e)
    if isinstance(e, BoundReference):
        return cols[e.ordinal].stats
    if isinstance(e, Cast):
        src = e.children[0].dtype
        if not ranged(e.to) or (src is dt.TIMESTAMP) != \
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
    if isinstance(e, ar.Pmod):
        m = e.children[1]
        if isinstance(m, Literal) and isinstance(m.value, int) and \
                m.value > 0:
            return HostRange.known(0, m.value - 1)
        return None
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


def _arith_range(e: Expression, cols: List) -> Optional[HostRange]:
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
