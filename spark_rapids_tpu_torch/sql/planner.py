"""AST -> plan-node planner with catalog-based name resolution (the
counterpart of spark_rapids_tpu/sql/planner.py).

The analysis layer, as the reference does it: resolve column names
against the FROM scope, split join conditions into equi-keys and a
residual, hoist the WHERE conjuncts of a comma-separated FROM into
inner-join keys (pushing single-relation conjuncts below the joins and
folding the relations left to right), stage aggregates (GROUP BY, HAVING,
aggregates of expressions, DISTINCT through an aggregate), register CTEs,
plan subqueries in FROM, then wrap ORDER BY and LIMIT. The same text
gives the reference's plan shape, so the same join order and build
sides.

Whatever would build an expression or a node the port lacks raises
``SqlError`` naming it ("... is not ported yet"): window functions, set
operations, ROLLUP, IN / EXISTS / scalar subqueries, the string
functions and string concatenation, DISTINCT aggregates the optimizer's
rewrite refuses (other than count and sum, or over more than one
column), cross joins, and left, right and full joins with a non-equi
condition (which the reference runs on its CPU engine). CASE takes its
type from its first typed branch, as the reference's planner does.
None of them is planned differently from the reference; a right join is
a ``JoinNode("right")``, which ``plan/overrides`` runs as a flipped left
join, as the reference's does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.expressions import aggregates as A
from spark_rapids_tpu_torch.expressions import arithmetic as ar
from spark_rapids_tpu_torch.expressions import conditional as cond
from spark_rapids_tpu_torch.expressions import datetime as dte
from spark_rapids_tpu_torch.expressions import math as mth
from spark_rapids_tpu_torch.expressions import predicates as pr
from spark_rapids_tpu_torch.expressions import strings as st
from spark_rapids_tpu_torch.expressions.base import (Alias, BoundReference,
                                                     Expression, Literal)
from spark_rapids_tpu_torch.expressions.cast import Cast
from spark_rapids_tpu_torch.ops.sortkeys import SortKeySpec
from spark_rapids_tpu_torch.plan import nodes as pn
from spark_rapids_tpu_torch.plan.optimizer import rewrite_distinct_aggregates
from spark_rapids_tpu_torch.sql.parser import SqlError

_AGG_FNS = {"sum", "count", "avg", "min", "max", "first", "last",
            "stddev_samp", "stddev", "std", "stddev_pop",
            "var_samp", "variance", "var_pop"}

# the string functions the reference plans: not ported, so they raise
# "not ported yet" rather than "unknown"
_STRING_FNS = {"upper", "lower", "trim", "ltrim", "rtrim", "reverse",
               "initcap", "length", "concat"}

#: the transcendental functions, as the reference's planner maps them
_TRANSCENDENTAL = {"exp": mth.Exp, "log": mth.Log, "log2": mth.Log2,
                   "log10": mth.Log10, "sin": mth.Sin, "cos": mth.Cos,
                   "tan": mth.Tan}

_MOMENTS = {"stddev_samp": A.StddevSamp, "stddev": A.StddevSamp,
            "std": A.StddevSamp, "stddev_pop": A.StddevPop,
            "var_samp": A.VarianceSamp, "variance": A.VarianceSamp,
            "var_pop": A.VariancePop}

#: the date functions, as the reference's planner maps them
_DATE_FIELDS = {"year": dte.Year, "month": dte.Month,
                "quarter": dte.Quarter, "weekday": dte.WeekDay,
                "dayofweek": dte.DayOfWeek, "day": dte.DayOfMonth,
                "dayofmonth": dte.DayOfMonth}

_CAST_TYPES = {
    "tinyint": dt.INT8, "smallint": dt.INT16,
    "int": dt.INT32, "integer": dt.INT32,
    "bigint": dt.INT64, "long": dt.INT64,
    "float": dt.FLOAT32, "real": dt.FLOAT32,
    "double": dt.FLOAT64,
    "string": dt.STRING, "varchar": dt.STRING,
    "date": dt.DATE, "timestamp": dt.TIMESTAMP,
    "boolean": dt.BOOLEAN,
}

_JOIN_KINDS = {"inner": "INNER JOIN", "left_anti": "LEFT ANTI JOIN",
               "left_semi": "LEFT SEMI JOIN", "left": "LEFT JOIN",
               "right": "RIGHT JOIN", "full": "FULL JOIN",
               "cross": "CROSS JOIN"}
_PORTED_JOINS = ("inner", "left", "right", "full", "left_semi",
                 "left_anti")


def _not_ported(what: str) -> SqlError:
    return SqlError(f"{what} is not ported yet")


def _date_days(s: str) -> int:
    try:
        return int((np.datetime64(s) -
                    np.datetime64("1970-01-01")).astype(int))
    except Exception:
        raise SqlError(f"bad DATE literal {s!r}")


def _ts_us(s: str) -> int:
    try:
        return int(np.datetime64(s, "us").astype(np.int64))
    except Exception:
        raise SqlError(f"bad TIMESTAMP literal {s!r}")


class _Scope:
    """Resolved FROM output: [(table_alias, column_name, dtype)]."""

    def __init__(self, entries: List[Tuple[Optional[str], str, dt.DType]]):
        self.entries = entries

    def resolve(self, tab: Optional[str], name: str) -> Tuple[int, dt.DType]:
        hits = [(i, t) for i, (a, n, t) in enumerate(self.entries)
                if n.lower() == name.lower() and
                (tab is None or (a or "").lower() == tab.lower())]
        if not hits:
            raise SqlError(f"column {tab + '.' if tab else ''}{name} "
                           "not found")
        if len(hits) > 1:
            raise SqlError(f"column {name} is ambiguous; qualify it")
        return hits[0]


# ---------------------------------------------------------------------------
# expression planning
# ---------------------------------------------------------------------------


def _fn_scalar(name: str, args: List[Expression]) -> Expression:
    def need(n):
        if len(args) != n:
            raise SqlError(f"{name}() takes {n} arguments")

    if name == "abs":
        need(1)
        return ar.Abs(args[0])
    if name == "sqrt":
        need(1)
        return mth.Sqrt(args[0])
    if name in ("floor", "ceil"):
        need(1)
        return (mth.Floor if name == "floor" else mth.Ceil)(args[0])
    if name == "coalesce":
        return cond.Coalesce(args)
    if name == "nvl":
        need(2)
        return cond.Nvl(args[0], args[1])
    if name in ("pow", "power"):
        need(2)
        return mth.Pow(args[0], args[1])
    if name == "round":
        if len(args) not in (1, 2):
            raise SqlError("round(col[, scale])")
        scale = _want_int_lit(args[1], "round scale") if len(args) == 2 \
            else 0
        return mth.Round(args[0], scale)
    if name == "pmod":
        need(2)
        return ar.Pmod(args[0], args[1])
    if name == "datediff":
        need(2)
        return dte.DateDiff(_as_date(args[0]), _as_date(args[1]))
    if name in ("unix_timestamp", "to_unix_timestamp"):
        # a format argument is taken and ignored, as the reference does
        if not args:
            raise SqlError(f"{name}(col[, fmt])")
        return dte.UnixTimestamp(args[0])
    if name == "to_date":
        need(1)
        return _as_date(args[0])
    if name == "nullif":
        need(2)
        return cond.If(pr.EqualTo(args[0], args[1]),
                       Literal(None, args[0].dtype), args[0])
    if name in ("greatest", "least"):
        if len(args) < 2:
            raise SqlError(f"{name}() takes 2+ arguments")
        if any(a.dtype is dt.STRING for a in args):
            raise SqlError(f"{name}() over strings is unsupported")
        return (cond.Greatest if name == "greatest" else
                cond.Least)(args)
    if name in _TRANSCENDENTAL:
        need(1)
        return _TRANSCENDENTAL[name](args[0])
    if name in ("substr", "substring"):
        if len(args) not in (2, 3):
            raise SqlError("substring(col, pos[, len])")
        pos = _want_int_lit(args[1], "substring position")
        ln = _want_int_lit(args[2], "substring length") \
            if len(args) == 3 else None
        return st.Substring(args[0], pos, ln)
    if name in _DATE_FIELDS:
        if len(args) != 1:
            raise SqlError(f"{name}() takes 1 arguments")
        return _DATE_FIELDS[name](args[0])
    if name in _STRING_FNS:
        raise _not_ported(f"function {name}()")
    raise SqlError(f"unknown function {name}()")


def _as_date(e: Expression) -> Expression:
    """A DATE: a string literal parsed now, any other non-date cast."""
    if e.dtype is dt.DATE:
        return e
    if isinstance(e, Literal) and isinstance(e.value, str):
        return Literal(_date_days(e.value), dt.DATE)
    return Cast(e, dt.DATE)


def _want_int_lit(e: Expression, what: str) -> int:
    if isinstance(e, Literal) and isinstance(e.value, int):
        return e.value
    raise SqlError(f"{what} must be an integer literal")


def _cmp(op: str, lhs: Expression, rhs: Expression) -> Expression:
    # Spark coerces string literals compared against date/timestamp
    # columns; TPC query texts lean on it ("d_date > '2002-01-02'")
    def coerce(a, b):
        if a.dtype in (dt.DATE, dt.TIMESTAMP) and isinstance(b, Literal) \
                and isinstance(b.value, str):
            return Literal(_date_days(b.value) if a.dtype is dt.DATE
                           else _ts_us(b.value), a.dtype)
        return b

    rhs = coerce(lhs, rhs)
    lhs = coerce(rhs, lhs)
    if op == "=":
        return pr.EqualTo(lhs, rhs)
    if op in ("<>", "!="):
        return pr.Not(pr.EqualTo(lhs, rhs))
    return {"<": pr.LessThan, "<=": pr.LessThanOrEqual,
            ">": pr.GreaterThan, ">=": pr.GreaterThanOrEqual}[op](lhs, rhs)


class _ExprPlanner:
    """Plans value expressions against a scope; ``env`` maps canonical
    AST reprs to output ordinals (the post-aggregation namespace)."""

    def __init__(self, scope: _Scope,
                 env: Optional[Dict[str, Tuple[int, dt.DType]]] = None):
        self.scope = scope
        self.env = env or {}

    def plan(self, ast) -> Expression:
        key = repr(ast)
        if key in self.env:
            i, t = self.env[key]
            return BoundReference(i, t)
        kind = ast[0]
        if kind == "col":
            _, tab, name = ast
            i, t = self.scope.resolve(tab, name)
            return BoundReference(i, t)
        if kind == "lit":
            return self._literal(ast)
        if kind == "neg":
            e = self.plan(ast[1])
            if isinstance(e, Literal) and isinstance(e.value, (int, float)):
                return Literal(-e.value)
            return ar.UnaryMinus(e)
        if kind == "interval":
            raise SqlError("INTERVAL only valid in date +/- interval")
        if kind == "arith":
            return self._arith(ast)
        if kind == "concat":
            lhs, rhs = self.plan(ast[1]), self.plan(ast[2])
            if isinstance(lhs, Literal) and isinstance(rhs, Literal) \
                    and isinstance(lhs.value, str) \
                    and isinstance(rhs.value, str):
                return Literal(lhs.value + rhs.value)
            raise _not_ported("string concatenation (||)")
        if kind == "cmp":
            _, op, l, r = ast
            return _cmp(op, self.plan(l), self.plan(r))
        if kind == "and":
            return pr.And(self.plan(ast[1]), self.plan(ast[2]))
        if kind == "or":
            return pr.Or(self.plan(ast[1]), self.plan(ast[2]))
        if kind == "not":
            return pr.Not(self.plan(ast[1]))
        if kind == "isnull":
            e = self.plan(ast[1])
            return pr.IsNotNull(e) if ast[2] else pr.IsNull(e)
        if kind == "between":
            e = self.plan(ast[1])
            lo = self.plan(ast[2])
            hi = self.plan(ast[3])
            return pr.And(pr.GreaterThanOrEqual(e, lo),
                          pr.LessThanOrEqual(e, hi))
        if kind == "in":
            e = self.plan(ast[1])
            vals = [self.plan(v) for v in ast[2]]
            if not all(isinstance(v, Literal) for v in vals):
                raise SqlError("IN list must contain literals")
            return pr.In(e, vals)
        if kind == "like":
            e = self.plan(ast[1])
            pat = self.plan(ast[2])
            if not (isinstance(pat, Literal) and
                    isinstance(pat.value, str)):
                raise SqlError("LIKE pattern must be a string literal")
            return st.Like(e, pat.value)
        if kind == "case":
            return self._case(ast)
        if kind == "cast":
            return self._cast(ast)
        if kind == "call":
            _, name, distinct, args = ast
            if name in _AGG_FNS:
                raise SqlError(
                    f"aggregate {name}() not allowed here")
            if distinct:
                raise SqlError("DISTINCT only applies to aggregates")
            return _fn_scalar(name, [self.plan(a) for a in args])
        if kind == "star":
            raise SqlError("* only allowed as a bare select item or "
                           "inside count(*)")
        if kind == "winfn":
            raise _not_ported("window function")
        if kind in ("in_sub", "exists", "scalar_sub"):
            raise _not_ported("a subquery in an expression")
        raise SqlError(f"unsupported expression {kind!r}")

    def _arith(self, ast) -> Expression:
        _, op, l, r = ast
        # date +/- INTERVAL 'n' DAY (the day count's sign as the
        # reference's planner takes it)
        if isinstance(r, tuple) and r[0] == "interval" and \
                op in ("+", "-"):
            base = _as_date(self.plan(l))
            n = r[1] if op == "+" else -r[1]
            if isinstance(base, Literal):
                return Literal(base.value + n, dt.DATE)
            return (dte.DateAdd if op == "+" else
                    dte.DateSub)(base, Literal(abs(n), dt.INT32))
        if isinstance(l, tuple) and l[0] == "interval" and op == "+":
            base = _as_date(self.plan(r))
            if isinstance(base, Literal):
                return Literal(base.value + l[1], dt.DATE)
            return dte.DateAdd(base, Literal(l[1], dt.INT32))
        lhs, rhs = self.plan(l), self.plan(r)
        if isinstance(lhs, Literal) and isinstance(rhs, Literal) \
                and lhs.value is not None and rhs.value is not None \
                and isinstance(lhs.value, (int, float)) \
                and isinstance(rhs.value, (int, float)) \
                and op in ("+", "-", "*", "/"):
            # constant fold, as the reference: IN-lists and join keys
            # expect literals ("d_year IN (2001, (2001 + 1))")
            if op == "/":
                if rhs.value == 0:
                    return Literal(None, dt.FLOAT64)
                return Literal(float(lhs.value) / float(rhs.value))
            v = {"+": lambda a, b: a + b, "-": lambda a, b: a - b,
                 "*": lambda a, b: a * b}[op](lhs.value, rhs.value)
            return Literal(v)
        klass = {"+": ar.Add, "-": ar.Subtract, "*": ar.Multiply,
                 "/": ar.Divide, "%": ar.Remainder}[op]
        return klass(lhs, rhs)

    def _case(self, ast) -> Expression:
        """CASE WHEN: a bare NULL branch takes the type of the first
        typed branch ("CASE WHEN m = 0 THEN null ELSE s / m END"), and
        so does the result, even where Spark would widen."""
        _, whens, els = ast
        null_ast = ("lit", None, "null")
        pairs = [(self.plan(c), None if v == null_ast else self.plan(v))
                 for c, v in whens]
        els_e = None if (els is None or els == null_ast) else \
            self.plan(els)
        typed = [v for _c, v in pairs if v is not None]
        if els_e is not None:
            typed.append(els_e)
        if not typed:
            raise SqlError("CASE with all-NULL branches is untyped")
        nt = typed[0].dtype
        pairs = [(c, Literal(None, nt) if v is None else v)
                 for c, v in pairs]
        return cond.CaseWhen(pairs, Literal(None, nt) if els_e is None
                             else els_e)

    def _cast(self, ast) -> Expression:
        to = _CAST_TYPES.get(ast[2])
        if to is None:
            raise SqlError(f"unknown cast type {ast[2]!r}")
        e = self.plan(ast[1])
        # literal casts fold, as in the reference
        if isinstance(e, Literal) and isinstance(e.value, str):
            if to is dt.DATE:
                return Literal(_date_days(e.value), dt.DATE)
            if to is dt.TIMESTAMP:
                return Literal(_ts_us(e.value), dt.TIMESTAMP)
        if isinstance(e, Literal) and \
                isinstance(e.value, (int, float, bool)):
            if to.is_floating:
                return Literal(float(e.value), to)
            if to.is_integral:
                return Literal(int(e.value), to)
        return Cast(e, to)

    def _literal(self, ast) -> Expression:
        _, v, k = ast
        if k == "date":
            return Literal(_date_days(v), dt.DATE)
        if k == "timestamp":
            return Literal(_ts_us(v), dt.TIMESTAMP)
        if k == "null":
            return Literal(None)
        return Literal(v)


def _plan_agg_call(ast, scope: _Scope, env=None) -> A.AggregateFunction:
    _, name, distinct, args = ast
    ep = _ExprPlanner(scope, env)
    if name == "count":
        if args and args[0] != ("star",):
            arg = ep.plan(args[0])
            if isinstance(arg, Literal) and arg.value is not None \
                    and not distinct:
                return A.Count()  # count(1) == count(*)
            return A.Count(arg, distinct=distinct)
        if distinct:
            raise SqlError("count(DISTINCT *) is unsupported")
        return A.Count()
    if len(args) != 1:
        raise SqlError(f"{name}() takes one argument")
    arg = ep.plan(args[0])
    if name == "sum":
        return A.Sum(arg, distinct=distinct)
    if distinct:
        raise SqlError(f"{name}(DISTINCT) is unsupported")
    ported = {"avg": A.Average, "min": A.Min, "max": A.Max,
              "first": A.First, "last": A.Last, **_MOMENTS}
    if name not in ported:
        raise _not_ported(f"aggregate {name}()")
    return ported[name](arg)


def _collect_agg_calls(ast, out: List):
    if not isinstance(ast, tuple):
        return
    if ast[0] == "winfn":
        raise _not_ported("window function")
    if ast[0] == "call" and ast[1] in _AGG_FNS:
        if repr(ast) not in {repr(o) for o in out}:
            out.append(ast)
        return  # no nested aggregates
    for part in ast:
        if isinstance(part, tuple):
            _collect_agg_calls(part, out)
        elif isinstance(part, list):
            for p in part:
                if isinstance(p, tuple):
                    _collect_agg_calls(p, out)


# ---------------------------------------------------------------------------
# relation planning
# ---------------------------------------------------------------------------


def _split_join_condition(cond_ast, left_scope: _Scope,
                          right_scope: _Scope):
    """Split ON into equi-key ordinal pairs + residual conjuncts."""
    lk, rk, residual = [], [], []
    for c in _conjuncts(cond_ast):
        pair = _equi_pair(c, left_scope, right_scope)
        if pair is not None:
            lk.append(pair[0])
            rk.append(pair[1])
            continue
        residual.append(c)
    residual_ast = None
    for c in residual:
        residual_ast = c if residual_ast is None else \
            ("and", residual_ast, c)
    return lk, rk, residual_ast


def _col_refs(ast, out: List):
    if not isinstance(ast, tuple):
        return
    if ast[0] == "col":
        out.append(ast)
        return
    for p in ast:
        if isinstance(p, tuple):
            _col_refs(p, out)
        elif isinstance(p, list):
            for x in p:
                _col_refs(x, out)


def _conjunct_side(c, lscope: _Scope, rscope: _Scope):
    """'l'/'r' when every column in ``c`` resolves on exactly that side;
    None when mixed/ambiguous."""
    refs: List = []
    _col_refs(c, refs)
    sides = set()
    for _, tab, name in refs:
        inl = _resolves(lscope, tab, name)
        inr = _resolves(rscope, tab, name)
        if inl == inr:
            return None  # unresolvable or ambiguous
        sides.add("l" if inl else "r")
    if len(sides) == 1:
        return sides.pop()
    return None


def _plan_relation(rel, catalog) -> Tuple[pn.PlanNode, _Scope]:
    kind = rel[0]
    if kind == "table":
        _, name, alias = rel
        matches = [k for k in catalog if k.lower() == name.lower()]
        if not matches:
            raise SqlError(f"table {name!r} not found "
                           f"(known: {sorted(catalog)})")
        entry = catalog[matches[0]]
        node = entry if isinstance(entry, pn.PlanNode) else \
            pn.ScanNode(entry)
        schema = node.output_schema()
        scope = _Scope([(alias, n, t)
                        for n, t in zip(schema.names, schema.types)])
        return node, scope
    if kind == "subquery":
        _, sub, alias = rel
        node = plan_statement(sub, catalog)
        schema = node.output_schema()
        return node, _Scope([(alias, n, t)
                             for n, t in zip(schema.names,
                                             schema.types)])
    if kind == "join":
        _, jkind, lrel, rrel, on = rel
        if jkind == "cross" and on is not None:
            # Spark parses CROSS JOIN ... ON as an inner join
            jkind = "inner"
        if jkind not in _PORTED_JOINS:
            raise _not_ported(_JOIN_KINDS.get(jkind, jkind))
        lnode, lscope = _plan_relation(lrel, catalog)
        rnode, rscope = _plan_relation(rrel, catalog)
        lk, rk, residual = _split_join_condition(on, lscope, rscope)
        if not lk:
            raise SqlError("join requires at least one equi-condition "
                           "(col = col across the two sides)")
        cond_expr = None
        joined_scope = _Scope(
            lscope.entries + rscope.entries
            if jkind not in ("left_semi", "left_anti") else lscope.entries)
        if residual is not None:
            if jkind in ("left_semi", "left_anti"):
                # one-sided ON conjuncts become pre-join filters (an anti
                # join KEEPS left rows whose ON condition is false, so
                # left-side ones move only below a semi join)
                for c in _conjuncts(residual):
                    side = _conjunct_side(c, lscope, rscope)
                    if side == "r":
                        rnode = pn.FilterNode(
                            _ExprPlanner(rscope).plan(c), rnode)
                    elif side == "l" and jkind == "left_semi":
                        lnode = pn.FilterNode(
                            _ExprPlanner(lscope).plan(c), lnode)
                    else:
                        raise SqlError(
                            "semi/anti joins support only equi or "
                            "single-side conditions")
            elif jkind != "inner":
                raise _not_ported(f"{_JOIN_KINDS[jkind]} with a non-equi "
                                  "condition")
            else:
                full_scope = _Scope(lscope.entries + rscope.entries)
                cond_expr = _ExprPlanner(full_scope).plan(residual)
        node = pn.JoinNode(jkind, lnode, rnode, lk, rk,
                           condition=cond_expr)
        return node, joined_scope
    raise SqlError(f"unsupported relation {kind!r}")


# ---------------------------------------------------------------------------
# statement planning
# ---------------------------------------------------------------------------


def _flatten_implicit(rel) -> List:
    if rel[0] == "join" and rel[1] == "implicit":
        return _flatten_implicit(rel[2]) + [rel[3]]
    return [rel]


def _conjuncts(ast) -> List:
    if ast is None:
        return []
    if isinstance(ast, tuple) and ast[0] == "and":
        return _conjuncts(ast[1]) + _conjuncts(ast[2])
    return [ast]


def _equi_pair(c, lscope: _Scope, rscope: _Scope):
    """ordinal pair when conjunct ``c`` is col=col across the scopes."""
    if not (isinstance(c, tuple) and c[0] == "cmp" and c[1] == "=" and
            c[2][0] == "col" and c[3][0] == "col"):
        return None

    def side(colast):
        _, tab, name = colast
        l = r = None
        try:
            l = lscope.resolve(tab, name)[0]
        except SqlError:
            pass
        try:
            r = rscope.resolve(tab, name)[0]
        except SqlError:
            pass
        if (l is None) == (r is None):
            return None  # missing or ambiguous across the scopes
        return ("l", l) if l is not None else ("r", r)

    a, b = side(c[2]), side(c[3])
    if a and b and {a[0], b[0]} == {"l", "r"}:
        left = a if a[0] == "l" else b
        right = a if a[0] == "r" else b
        return left[1], right[1]
    return None


def _resolves(scope_: _Scope, tab, name) -> bool:
    try:
        scope_.resolve(tab, name)
        return True
    except SqlError:
        return False


def _plan_implicit_joins(rels, where_ast, catalog):
    """Comma-FROM planning: hoist WHERE equi-conjuncts into inner-join
    keys, folding relations left-to-right (the analysis step Spark's
    optimizer performs for the classic TPC join syntax)."""
    planned = [_plan_relation(r, catalog) for r in rels]
    conjuncts = _conjuncts(where_ast)
    # push single-relation conjuncts below the joins (Spark's
    # PushDownPredicate)
    kept: List = []
    for c in conjuncts:
        refs: List = []
        _col_refs(c, refs)
        homes = []
        for i, (_n, s_i) in enumerate(planned):
            if refs and all(_resolves(s_i, tab, name)
                            for _, tab, name in refs):
                homes.append(i)
        if len(homes) == 1:
            i = homes[0]
            n_i, s_i = planned[i]
            planned[i] = (pn.FilterNode(_ExprPlanner(s_i).plan(c), n_i),
                          s_i)
        else:
            kept.append(c)
    conjuncts = kept
    node, scope = planned[0]
    remaining = list(planned[1:])
    while remaining:
        progress = False
        for idx, (n2, s2) in enumerate(remaining):
            lk, rk, used = [], [], []
            for ci, c in enumerate(conjuncts):
                pair = _equi_pair(c, scope, s2)
                if pair:
                    lk.append(pair[0])
                    rk.append(pair[1])
                    used.append(ci)
            if lk:
                node = pn.JoinNode("inner", node, n2, lk, rk)
                scope = _Scope(scope.entries + s2.entries)
                for ci in reversed(used):
                    conjuncts.pop(ci)
                remaining.pop(idx)
                progress = True
                break
        if not progress:
            # the reference cross-joins a provably single-row relation
            # here (the TPC-DS q61/q90 shape); the port has no cross join
            names = [r[0] for r in rels]
            raise SqlError(
                "comma-joined tables need WHERE equi-conditions "
                f"linking them (unlinked remain among {names}; a cross "
                "join of a single-row relation is not ported yet)")
    residual = None
    for c in conjuncts:
        residual = c if residual is None else ("and", residual, c)
    if residual is not None:
        node = pn.FilterNode(_ExprPlanner(scope).plan(residual), node)
    return node, scope


def _subst_aliases(ast, alias_map, scope):
    """Replace unqualified column refs that match a SELECT alias (and do
    not resolve as real columns) with the aliased expression — Spark's
    HAVING/ORDER BY alias resolution ("HAVING cnt >= 10")."""
    if not isinstance(ast, tuple):
        return ast
    if ast[0] == "col" and ast[1] is None:
        name = ast[2].lower()
        if name in alias_map:
            try:
                scope.resolve(None, ast[2])
            except SqlError:
                return alias_map[name]
        return ast
    out = []
    for p in ast:
        if isinstance(p, tuple):
            out.append(_subst_aliases(p, alias_map, scope))
        elif isinstance(p, list):
            out.append([_subst_aliases(x, alias_map, scope)
                        if isinstance(x, tuple) else x for x in p])
        else:
            out.append(p)
    return tuple(out)


def _has_subquery(ast) -> bool:
    if not isinstance(ast, tuple):
        return False
    if ast[0] in ("in_sub", "scalar_sub", "exists", "select", "union"):
        return True
    for p in ast:
        if isinstance(p, tuple) and _has_subquery(p):
            return True
        if isinstance(p, list) and any(
                isinstance(x, tuple) and _has_subquery(x) for x in p):
            return True
    return False


def _register_ctes(ctes, catalog):
    """Plan each CTE once into a catalog copy (Spark's CTESubstitution);
    self-references share the plan node, like temp views. Returns the
    original catalog untouched when there are none."""
    if not ctes:
        return catalog
    catalog = dict(catalog)
    for name, sub in ctes:
        catalog[name] = plan_statement(sub, catalog)
    return catalog


def plan_statement(ast, catalog) -> pn.PlanNode:
    """The plan of a parsed statement over ``catalog`` (table name ->
    InMemorySource or plan node)."""
    q = ast[1]
    catalog = _register_ctes(q.get("ctes"), catalog)
    if ast[0] == "union":
        raise _not_ported("UNION / INTERSECT / EXCEPT")
    if ast[0] != "select":
        raise SqlError(f"unsupported statement {ast[0]!r}")
    if q.get("rollup"):
        raise _not_ported("GROUP BY ROLLUP")
    clauses = [e for e, _a in q["sels"]] + [q["where"], q["having"]] + \
        [e for e, _a, _n in q["order"]]
    if any(_has_subquery(c) for c in clauses):
        raise _not_ported("IN / EXISTS / scalar subqueries")
    # WHERE as the left fold of its conjuncts, the shape the reference's
    # subquery extraction hands on
    where_ast = None
    for c in _conjuncts(q["where"]):
        where_ast = c if where_ast is None else ("and", where_ast, c)

    rels = _flatten_implicit(q["from"])
    if len(rels) > 1:
        node, scope = _plan_implicit_joins(rels, where_ast, catalog)
    else:
        node, scope = _plan_relation(q["from"], catalog)
        if where_ast is not None:
            node = pn.FilterNode(_ExprPlanner(scope).plan(where_ast),
                                 node)

    # expand SELECT * / build select item list
    sels: List[Tuple[tuple, Optional[str]]] = []
    for e, alias in q["sels"]:
        if e == ("star",):
            for tab, name, _t in scope.entries:
                sels.append((("col", tab, name), name))
        else:
            sels.append((e, alias))

    alias_map = {a.lower(): e for e, a in sels if a}
    having_ast = _subst_aliases(q["having"], alias_map, scope) \
        if q["having"] is not None else None
    order_items = [(_subst_aliases(e, alias_map, scope), asc, nf)
                   for e, asc, nf in q["order"]]

    agg_calls: List[tuple] = []
    for e, _ in sels:
        _collect_agg_calls(e, agg_calls)
    if having_ast is not None:
        _collect_agg_calls(having_ast, agg_calls)
    for e, _asc, _nf in order_items:
        _collect_agg_calls(e, agg_calls)

    env: Dict[str, Tuple[int, dt.DType]] = {}
    if q["group"] or agg_calls:
        grouping = [_ExprPlanner(scope).plan(g) for g in q["group"]]
        calls = [pn.AggCall(_plan_agg_call(c, scope), f"_a{i}")
                 for i, c in enumerate(agg_calls)]
        gnames = [g[2] if g[0] == "col" else f"_g{i}"
                  for i, g in enumerate(q["group"])]
        node = pn.AggregateNode(grouping, calls, node,
                                grouping_names=gnames)
        try:  # a distinct aggregate the optimizer cannot rewrite
            rewrite_distinct_aggregates(node)
        except NotImplementedError as e:
            raise SqlError(str(e)) from e
        # post-agg namespace: group ASTs then agg-call ASTs
        for i, g in enumerate(q["group"]):
            env[repr(g)] = (i, grouping[i].dtype)
        base = len(grouping)
        agg_schema = node.output_schema()
        for i, c in enumerate(agg_calls):
            env[repr(c)] = (base + i, agg_schema.types[base + i])
        # group columns stay resolvable by name too
        scope = _Scope([(None, n, t)
                        for n, t in zip(agg_schema.names,
                                        agg_schema.types)])

    if having_ast is not None:
        node = pn.FilterNode(
            _ExprPlanner(scope, env).plan(having_ast), node)

    # final projection. ORDER BY expressions that are not select items
    # ride as HIDDEN projection columns, sorted on, then projected away
    # (Spark's planner appends the same hidden sort attributes)
    out_exprs: List[Expression] = []
    out_names: List[str] = []
    for i, (e, alias) in enumerate(sels):
        expr = _ExprPlanner(scope, env).plan(e)
        name = alias or (e[2] if e[0] == "col" else f"col{i}")
        out_exprs.append(Alias(expr, name))
        out_names.append(name)

    sel_keys = {repr(e): i for i, (e, _a) in enumerate(sels)}
    specs = []
    hidden: List[Expression] = []
    for e, asc, nulls_first in order_items:
        if e[0] == "lit" and isinstance(e[1], int):
            ordinal = e[1] - 1  # ORDER BY position
            if not 0 <= ordinal < len(sels):
                raise SqlError(f"ORDER BY position {e[1]} out of range")
        elif repr(e) in sel_keys:
            ordinal = sel_keys[repr(e)]
        elif e[0] == "col" and e[1] is None and e[2] in out_names:
            ordinal = out_names.index(e[2])
        else:
            if q["distinct"]:
                raise SqlError("ORDER BY over a non-selected expression "
                               "cannot combine with DISTINCT")
            ordinal = len(sels) + len(hidden)
            hidden.append(_ExprPlanner(scope, env).plan(e))
        specs.append(SortKeySpec(ordinal, asc, nulls_first))

    if hidden:
        node = pn.ProjectNode(
            out_exprs + [Alias(h, f"_ord{j}")
                         for j, h in enumerate(hidden)],
            node, out_names + [f"_ord{j}"
                               for j in range(len(hidden))])
        node = pn.SortNode(specs, node)
        schema = node.output_schema()
        node = pn.ProjectNode(
            [Alias(BoundReference(i, schema.types[i]), out_names[i])
             for i in range(len(sels))], node, list(out_names))
        if q["limit"] is not None:
            node = pn.LimitNode(q["limit"], node)
        return node

    node = pn.ProjectNode(out_exprs, node, out_names)
    if q["distinct"]:
        schema = node.output_schema()
        node = pn.AggregateNode(
            [BoundReference(i, t) for i, t in enumerate(schema.types)],
            [], node, grouping_names=list(schema.names))
    if specs:
        node = pn.SortNode(specs, node)
    if q["limit"] is not None:
        node = pn.LimitNode(q["limit"], node)
    return node
