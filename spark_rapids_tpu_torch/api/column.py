"""Column DSL (the counterpart of spark_rapids_tpu/api/column.py):
unresolved expression builders.

A ``Column`` wraps ``resolve(schema) -> Expression``: names bind to
ordinals only when the parent DataFrame applies the operation (Spark's
analysis phase). Operators mirror pyspark.sql.Column, over the
expressions the port has.
"""
from __future__ import annotations

from typing import Callable, Optional

from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.expressions import arithmetic as ar
from spark_rapids_tpu_torch.expressions import predicates as pr
from spark_rapids_tpu_torch.expressions import strings as st
from spark_rapids_tpu_torch.expressions.base import (Alias, BoundReference,
                                                     Expression, Literal)


class Column:
    def __init__(self, resolve: Callable[[Schema], Expression],
                 name: Optional[str] = None):
        self._resolve = resolve
        self._name = name

    def resolve(self, schema: Schema) -> Expression:
        return self._resolve(schema)

    def out_name(self, fallback: Optional[str]) -> Optional[str]:
        return self._name or fallback

    # -- naming -----------------------------------------------------------

    def alias(self, name: str) -> "Column":
        return Column(self._resolve, name)

    name = alias

    # -- operators --------------------------------------------------------

    def _bin(self, other, klass, flip=False) -> "Column":
        o = _to_col(other)

        def rf(schema: Schema) -> Expression:
            lhs, rhs = self.resolve(schema), o.resolve(schema)
            if flip:
                lhs, rhs = rhs, lhs
            return klass(lhs, rhs)
        return Column(rf)

    def __add__(self, o):
        return self._bin(o, ar.Add)

    def __radd__(self, o):
        return self._bin(o, ar.Add, flip=True)

    def __sub__(self, o):
        return self._bin(o, ar.Subtract)

    def __rsub__(self, o):
        return self._bin(o, ar.Subtract, flip=True)

    def __mul__(self, o):
        return self._bin(o, ar.Multiply)

    def __rmul__(self, o):
        return self._bin(o, ar.Multiply, flip=True)

    def __truediv__(self, o):
        return self._bin(o, ar.Divide)

    def __rtruediv__(self, o):
        return self._bin(o, ar.Divide, flip=True)

    def __eq__(self, o):  # type: ignore[override]
        return self._bin(o, pr.EqualTo)

    def __ne__(self, o):  # type: ignore[override]
        c = self._bin(o, pr.EqualTo)
        return Column(lambda s: pr.Not(c.resolve(s)))

    def __lt__(self, o):
        return self._bin(o, pr.LessThan)

    def __le__(self, o):
        return self._bin(o, pr.LessThanOrEqual)

    def __gt__(self, o):
        return self._bin(o, pr.GreaterThan)

    def __ge__(self, o):
        return self._bin(o, pr.GreaterThanOrEqual)

    def __and__(self, o):
        return self._bin(o, pr.And)

    def __or__(self, o):
        return self._bin(o, pr.Or)

    def __invert__(self):
        return Column(lambda s: pr.Not(self.resolve(s)))

    def __hash__(self):
        return id(self)

    def __bool__(self):
        raise TypeError(
            "Column is not a boolean; use & | ~ for combinators")

    # -- methods ----------------------------------------------------------

    def is_not_null(self) -> "Column":
        return Column(lambda s: pr.IsNotNull(self.resolve(s)))

    isNotNull = is_not_null

    def isin(self, *values) -> "Column":
        vals = list(values[0]) if len(values) == 1 and \
            isinstance(values[0], (list, tuple, set)) else list(values)
        return Column(lambda s: pr.In(self.resolve(s),
                                      sorted(vals, key=repr)))

    def between(self, lo, hi) -> "Column":
        return (self >= lo) & (self <= hi)

    def startswith(self, prefix: str) -> "Column":
        return Column(lambda s: st.StartsWith(self.resolve(s), prefix))

    def endswith(self, suffix: str) -> "Column":
        return Column(lambda s: st.EndsWith(self.resolve(s), suffix))

    def contains(self, needle: str) -> "Column":
        return Column(lambda s: st.Contains(self.resolve(s), needle))

    def like(self, pattern: str) -> "Column":
        return Column(lambda s: st.Like(self.resolve(s), pattern))

    def substr(self, pos: int, length: Optional[int] = None) -> "Column":
        return Column(lambda s: st.Substring(self.resolve(s), pos,
                                             length))


def col(name: str) -> Column:
    def rf(schema: Schema) -> Expression:
        i = schema.index_of(name)
        return BoundReference(i, schema.types[i])
    return Column(rf, name)


def lit(value) -> Column:
    return Column(lambda s: Literal(value))


def _to_col(v) -> Column:
    if isinstance(v, Column):
        return v
    return lit(v)


def strip_alias(e: Expression) -> Expression:
    return e.children[0] if isinstance(e, Alias) else e
