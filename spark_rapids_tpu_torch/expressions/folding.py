"""Literal folding and fused multiply-adds: the float arithmetic the
reference's XLA backend runs in place of the expression it was given.

XLA's algebraic simplifier rewrites float chains that hold literals
before the program runs, and its CPU code generator then fuses a
product that feeds an add into one fused multiply-add (one rounding).
``fold`` makes the same rewrite of an expression tree, once per plan
(``plan/overrides``), so the SQL and the DataFrame paths compute the
reference's values bit for bit. The rules, each pinned against the
reference engine (``tests/test_torch_folding.py``), in the order XLA
tries them at one operation:

- ``x + 0`` and ``x * 1`` are x untouched (C1's identities); ``x - c``
  is ``x + (-c)``; a literal on the left of ``+`` or ``*`` moves to the
  right; ``x / c`` is ``x * (1 / c)`` for every nonzero literal ``c``
  (``x / 0`` stays a division: null); ``(a / b) / c`` is ``a / (b * c)``
  for any other ``c``.
- integer ``x - x`` (one column twice), ``x * 0`` and ``0 * x`` are a
  zero that keeps the nulls of x (``arithmetic.Zero``); from the next
  pass on it is a constant, so ``d + (i - i)`` is d untouched, null
  where i is; a literal that meets it is a constant that keeps those
  nulls (``arithmetic.Constant``), so ``-0.0 - (i * 0) + d`` is d
  untouched too.
- ``(x + c1) + c2`` is ``x + (c1 + c2)``, ``(c1 - x) + c2`` is
  ``(c1 + c2) - x``, and ``(x * c1) * c2`` is ``x * (c1 * c2)``.
  Nothing else reassociates: ``c2 - (x + c1)``, ``c / x``, and a chain
  that meets a column term (``(d + c1) + (e + c2)``) keep their order.

XLA applies them in passes: a pass visits each operation once, operands
first, and applies at most one rule to it; the constants a rule combines
(``c1 + c2``), and a literal that needs a conversion to the operation's
type (an integer literal in a float operation), are computed between
passes, and become constants for the next pass only. So ``d / 3 / e`` is
``d / (3 * e)`` but ``d / 3.0 / e`` is ``(d * (1 / 3.0)) / e``. The
constants are computed in the operation's type and never flushed.

Then, as LLVM generates the code, ``-x``, ``x * -1`` and ``-0.0 - x``
are the negation of x, and a float product that feeds ``+`` or ``-`` of
its own type is one ``MultiplyAdd``: the left operand's product when
both are products. A product that occurs twice in one tree (``d * e + d * e``)
is computed once and fuses into nothing, and one that LLVM made a
select (``(1.0 / d) * 2.0``) fuses only into an add of a literal.
"""
from __future__ import annotations

import copy
from collections import Counter
from typing import Optional, Tuple

import numpy as np

from spark_rapids_tpu_torch.columnar.column import Scalar
from spark_rapids_tpu_torch.expressions import arithmetic as ar
from spark_rapids_tpu_torch.expressions.base import (BoundReference,
                                                     Expression, Literal)
from spark_rapids_tpu_torch.expressions.cast import Cast, _cast_scalar

_BINARY = (ar.Add, ar.Subtract, ar.Multiply)


def fold(e: Expression) -> Expression:
    """``e`` as the reference computes it."""
    e = _cast_literals(e)
    converted = False
    while True:
        e, changed = _pass(e, converted)
        folded = _fold_constants(e)
        if not changed and folded is e and converted:
            break
        e, converted = folded, True
    return _fuse(e, _Program(e))


def _cast_literals(e: Expression) -> Expression:
    """A cast of a literal is the literal it makes (the reference's Cast
    of a scalar is a scalar before the program is built)."""
    e = _with_children(e, [_cast_literals(c) for c in e.children])
    if isinstance(e, Cast) and isinstance(e.children[0], Literal):
        lit = e.children[0]
        v = _cast_scalar(Scalar(lit.dtype, lit.value), lit.dtype, e.to) \
            if lit.dtype is not e.to else Scalar(e.to, lit.value)
        return Literal(v.value, e.to)
    return e


def _with_children(e: Expression, kids) -> Expression:
    if all(k is c for k, c in zip(kids, e.children)):
        return e
    out = copy.copy(e)
    out.children = list(kids)
    return out


def _literal(e: Expression) -> bool:
    return isinstance(e, Literal) and e.value is not None and \
        isinstance(e.value, (int, float)) and not isinstance(e.value, bool)


def _float_op(e: Expression, kind) -> bool:
    return isinstance(e, kind) and e.dtype.is_floating


def _const(e: Expression, op, *args: Expression) -> Expression:
    """``op`` over the constants, in ``e``'s float type, as XLA's
    constant folder computes it (no flush of subnormals): a literal, or
    a ``Constant`` null where the ``Constant`` arguments are."""
    kt = e.dtype.np_dtype.type
    with np.errstate(all="ignore"):
        v = op(*(kt(a.value) for a in args))
    sources = [s for a in args if isinstance(a, ar.Constant)
               for s in a.children]
    if sources:
        return ar.Constant(e.dtype, sources, float(v))
    return Literal(float(v), e.dtype)


def _constant(e: Expression) -> bool:
    return _literal(e) or isinstance(e, ar.Constant)


def _fold_constants(e: Expression) -> Expression:
    """The constant folding between two passes: a float operation of two
    literals, and the divisors of a division when all are literals."""
    e = _with_children(e, [_fold_constants(c) for c in e.children])
    if any(_float_op(e, k) for k in _BINARY) and \
            all(_constant(c) for c in e.children):
        op = {ar.Add: np.add, ar.Subtract: np.subtract,
              ar.Multiply: np.multiply}[type(e)]
        return _const(e, op, *e.children)
    if isinstance(e, ar.Divide) and len(e.children) > 2 and \
            all(_literal(c) and c.value != 0 for c in e.children[1:]):
        divisor = _const(e, lambda *ks: np.prod(ks), *e.children[1:])
        if divisor.value != 0:
            return ar.Divide(e.children[0], divisor)
    return e


def _pass(e: Expression, converted: bool) -> Tuple[Expression, bool]:
    """One simplifier pass: operands first, then at most one rule here."""
    changed = False
    kids = []
    for c in e.children:
        k, ch = _pass(c, converted)
        kids.append(k)
        changed |= ch
    e = _with_children(e, kids)
    nxt = _rule(e, converted)
    return (e, changed) if nxt is None else (nxt, True)


def _rule(e: Expression, converted: bool) -> Optional[Expression]:
    """The first rule that applies at ``e``, or None. Until the first
    constant folding (``converted``), a literal of another type than
    ``e`` is not a constant."""

    def const(x: Expression) -> bool:
        if isinstance(x, ar.Constant):
            return converted
        return _literal(x) and (converted or x.dtype is e.dtype)

    zero = _integer_zero(e)
    if zero is not None:
        return zero

    if isinstance(e, ar.Divide):
        x, c = e.children[0], e.children[-1]
        if len(e.children) == 2 and const(c) and not _literal(x):
            if c.value == 1:
                return _identity(x, e, c)
            if c.value != 0:
                return ar.Multiply(x, _const(e, np.divide, Literal(1.0), c))
        if isinstance(x, ar.Divide) and \
                not all(_literal(k) for k in x.children) and \
                not (const(c) and c.value != 0):
            return ar.Divide(*x.children, *e.children[1:])
        return None
    if not any(_float_op(e, k) for k in _BINARY):
        return None
    x, y = e.children
    if _literal(x) and _literal(y):
        return None
    unit = 1 if isinstance(e, ar.Multiply) else 0
    if const(y) and y.value == unit:
        return _identity(x, e, y)
    if isinstance(e, ar.Subtract):
        return ar.Add(x, ar.Multiply(y, Literal(-1.0, e.dtype))) \
            if const(y) and not isinstance(y, ar.Zero) else None
    if const(x) and x.value == unit:
        return _identity(y, e, x)
    if const(x):
        return type(e)(y, x)
    if not const(y):
        return None
    if isinstance(e, ar.Add):
        if isinstance(x, ar.Add) and x.dtype is e.dtype and \
                const(x.children[1]):
            return ar.Add(x.children[0], ar.Add(x.children[1], y))
        if isinstance(x, ar.Subtract) and x.dtype is e.dtype and \
                const(x.children[0]):
            return ar.Subtract(ar.Add(x.children[0], y), x.children[1])
        return None
    if isinstance(x, ar.Multiply) and x.dtype is e.dtype and \
            const(x.children[1]):
        return ar.Multiply(x.children[0], ar.Multiply(x.children[1], y))
    return None


def _identity(x: Expression, e: Expression, unit: Expression
              ) -> Expression:
    """What XLA leaves of ``e`` = ``x + 0`` or ``x * 1``: x itself, or x
    converted to ``e``'s type; null where ``unit`` is, when it is a
    ``Zero``. A literal that meets such a zero (``-0.0 - (i * 0)``) is a
    constant from the next pass on, null where the zero is."""
    nulls = [unit] if isinstance(unit, ar.Constant) else []
    if isinstance(x, ar.Zero):
        return ar.Zero(e.dtype, x.children + nulls)
    if nulls and _constant(x):
        return _const(e, lambda v, _zero: v, x, unit)
    if x.dtype is e.dtype and not nulls:
        return x
    return ar.Identity(x, e.dtype, nulls_of=nulls)


def _integer_zero(e: Expression) -> Optional[Expression]:
    """The ``Zero`` XLA makes of integer ``x - x`` (one column twice) and
    ``x * 0`` / ``0 * x`` (a ``Zero`` is a 0 here too), else None."""
    if not (isinstance(e, (ar.Subtract, ar.Multiply)) and
            e.dtype.is_integral):
        return None
    x, y = e.children
    if isinstance(e, ar.Subtract):
        same = isinstance(x, BoundReference) and \
            isinstance(y, BoundReference) and x.ordinal == y.ordinal
        return ar.Zero(e.dtype, [x]) if same else None

    def nulls(k: Expression):
        return list(k.children) if isinstance(k, ar.Zero) else \
            [] if _literal(k) else [k]

    for z, other in ((y, x), (x, y)):
        if isinstance(z, ar.Zero) or (_literal(z) and z.value == 0):
            return ar.Zero(e.dtype, nulls(z) + nulls(other))
    return None


def _key(e: Expression):
    """A structural key: equal keys compute the same value, as XLA's
    common-subexpression elimination sees them (``d * e`` is ``e * d``)."""
    if isinstance(e, BoundReference):
        return ("ref", e.ordinal, e.dtype.name)
    if isinstance(e, Literal):
        return ("lit", repr(e.value), e.dtype.name)
    if type(e) in _BINARY + (ar.Divide,):
        kids = [_key(c) for c in e.children]
        if type(e) in (ar.Add, ar.Multiply):
            kids.sort(key=repr)
        return (type(e).__name__,) + tuple(kids)
    return ("node", id(e))


class _Program:
    """What LLVM sees of the whole tree: how often each float product
    occurs (a product computed for two users fuses into neither), how
    often each divisor occurs (the select that guards it against zero is
    shared then), and which divisions XLA computes in a loop of their
    own (a division inside another division's divisor is needed by the
    validity's loop as well, and XLA does not compute a division twice)."""

    def __init__(self, e: Expression):
        self.uses: Counter = Counter()
        self.divisors: Counter = Counter()
        self.apart = set()
        stack = [(e, False)]
        while stack:
            n, inside = stack.pop()
            if _float_op(n, ar.Multiply):
                self.uses[_key(n)] += 1
            if isinstance(n, ar.Divide):
                if inside:
                    self.apart.add(id(n))
                for k in n.children[1:]:
                    self.divisors[_key(k)] += 1
                stack.append((n.children[0], inside))
                stack.extend((k, True) for k in n.children[1:])
            else:
                stack.extend((k, inside) for k in n.children)


def _select(e: Expression, prog: _Program) -> bool:
    """Whether LLVM turns ``e`` into a select: a literal divided by a
    float column (whose divisor the reference guards with a select
    against zero) when that select has no other user and the division
    runs in its loop, and any operation with a literal operand over one
    such value (LLVM moves the operation into the select's arms). An
    integer divisor's select sits behind a conversion that LLVM leaves
    alone."""
    if isinstance(e, ar.Divide):
        return len(e.children) == 2 and _literal(e.children[0]) and \
            not _literal(e.children[1]) and \
            e.children[1].dtype.is_floating and \
            prog.divisors[_key(e.children[1])] == 1 and id(e) not in prog.apart
    if isinstance(e, _BINARY):
        x, y = e.children
        return (_literal(y) and _select(x, prog)) or \
            (_literal(x) and _select(y, prog))
    return isinstance(e, ar.Identity) and _select(e.children[0], prog)


def _negated(e: Expression) -> Optional[Expression]:
    """x when ``e`` is the float ``-x``, ``x * -1`` or ``-0.0 - x``,
    which LLVM makes a negation (no flush of a subnormal), else None."""
    if isinstance(e, ar.UnaryMinus) and e.dtype.is_floating:
        return e.children[0]
    if not isinstance(e, _BINARY):
        return None
    x, y = e.children
    if _float_op(e, ar.Multiply) and _literal(y) and y.value == -1 and \
            not _literal(x):
        return x
    if _float_op(e, ar.Subtract) and _literal(x) and x.value == 0 and \
            np.signbit(x.value) and not _literal(y):
        return y
    return None


def _product(p: Expression, e: Expression, prog: _Program):
    """``(sign, product)`` when ``p``, an operand of ``e``, is a float
    product of ``e``'s type that XLA computes for ``e`` alone (a negated
    one too: LLVM makes ``-(a * b) + c`` of it), else None. A product
    that LLVM turned into a select fuses only into a literal add, which
    LLVM moves into the select's arms with it."""
    sign, q = 1, _negated(p)
    if q is not None and q.dtype is e.dtype:
        sign, p = -1, q
    if not (_float_op(p, ar.Multiply) and p.dtype is e.dtype) or \
            _negated(p) is not None or \
            all(_literal(k) for k in p.children) or prog.uses[_key(p)] != 1:
        return None
    if _select(p, prog) and not any(_literal(k) for k in e.children):
        return None
    return sign, p


def _fuse(e: Expression, prog: _Program) -> Expression:
    x = _negated(e)
    if x is not None:
        return ar.Identity(_fuse(x, prog), e.dtype, negate=True)
    if _float_op(e, ar.Add) or _float_op(e, ar.Subtract):
        sign = -1 if isinstance(e, ar.Subtract) else 1
        x, y = e.children
        for p, other, first in ((x, y, True), (y, x, False)):
            found = _product(p, e, prog)
            if found is not None:
                s, p = found
                a, b = (_fuse(k, prog) for k in p.children)
                c = _fuse(other, prog)
                if first:
                    return ar.MultiplyAdd(a, b, c, e.dtype, product_sign=s,
                                          addend_sign=sign)
                return ar.MultiplyAdd(a, b, c, e.dtype,
                                      product_sign=s * sign)
    return _with_children(e, [_fuse(c, prog) for c in e.children])
