"""Recursive-descent SQL parser -> untyped AST: the port's own copy of
spark_rapids_tpu/sql/parser.py (pure Python; the port imports nothing of
the reference), which must give the same AST for the same text.

Grammar (case-insensitive keywords):

    query     := [WITH ctes] core ((UNION [ALL]|INTERSECT|EXCEPT) core)*
                 [ORDER BY order (',' order)*] [LIMIT int]
    core      := SELECT [DISTINCT] sel (',' sel)* FROM relation
                 [WHERE expr]
                 [GROUP BY (expr (',' expr)* | ROLLUP '(' exprs ')')]
                 [HAVING expr]
    sel       := expr [[AS] ident] | '*'
    relation  := table_or_sub ([INNER|LEFT [OUTER]|RIGHT [OUTER]|
                 FULL [OUTER]|LEFT SEMI|LEFT ANTI|CROSS] JOIN
                 table_or_sub [ON expr])*
    table_or_sub := ident [[AS] ident] | '(' query ')' [AS] ident
    order     := expr [ASC|DESC] [NULLS FIRST|NULLS LAST]
    expr      := OR-precedence expression grammar with NOT, comparison,
                 BETWEEN, IN (list | subquery), [NOT] EXISTS (subquery),
                 LIKE, IS [NOT] NULL, additive/multiplicative arithmetic,
                 '||' concatenation, unary -, literals, CASE (searched
                 and simple), CAST(e AS type), DATE 'lit', function
                 calls, [table.]column

AST nodes are plain tuples: ('select', {...}), ('col', tab, name),
('lit', value, kind), ('call', name, distinct, args), ('case', whens,
else_), ('cast', e, type), ('star',), binary ops ('and' 'or' 'not'
'cmp' 'arith' 'in' 'between' 'like' 'isnull'). The parser accepts the
whole grammar; what the port cannot plan yet, the planner refuses.
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple


class SqlError(Exception):
    pass


_TOKEN_RE = re.compile(r"""
    \s+
  | --[^\n]*
  | (?P<num>\d+\.\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|\d+([eE][+-]?\d+)?)
  | (?P<str>'(?:[^']|'')*')
  | (?P<ident>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op>\|\||<=|>=|<>|!=|=|<|>|\(|\)|,|\*|/|%|\+|-|\.)
""", re.VERBOSE)

_KEYWORDS = {
    "select", "distinct", "from", "where", "group", "by", "having",
    "order", "limit", "as", "and", "or", "not", "in", "between", "like",
    "is", "null", "case", "when", "then", "else", "end", "cast", "join",
    "inner", "left", "right", "full", "outer", "semi", "anti", "cross",
    "on", "asc", "desc", "nulls", "first", "last", "date", "timestamp",
    "true", "false", "interval", "with", "union", "all", "over",
    "partition", "rows", "unbounded", "preceding", "following",
    "current", "row", "exists", "intersect", "except", "rollup",
}


def _tokenize(sql: str) -> List[Tuple[str, str]]:
    out: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise SqlError(f"cannot tokenize at: {sql[pos:pos+30]!r}")
        pos = m.end()
        if m.lastgroup is None:
            continue  # whitespace/comment
        text = m.group(m.lastgroup)
        kind = m.lastgroup
        if kind == "ident" and text.lower() in _KEYWORDS:
            out.append(("kw", text.lower()))
        else:
            out.append((kind, text))
    out.append(("eof", ""))
    return out


class _Parser:
    def __init__(self, sql: str):
        self.toks = _tokenize(sql)
        self.i = 0

    # -- token helpers -----------------------------------------------------

    def peek(self, k: int = 0):
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept_kw(self, *kws: str) -> Optional[str]:
        kind, text = self.peek()
        if kind == "kw" and text in kws:
            self.i += 1
            return text
        return None

    def expect_kw(self, kw: str):
        if not self.accept_kw(kw):
            raise SqlError(f"expected {kw.upper()}, got "
                           f"{self.peek()[1]!r}")

    def accept_op(self, *ops: str) -> Optional[str]:
        kind, text = self.peek()
        if kind == "op" and text in ops:
            self.i += 1
            return text
        return None

    def expect_op(self, op: str):
        if not self.accept_op(op):
            raise SqlError(f"expected {op!r}, got {self.peek()[1]!r}")

    def expect_ident(self) -> str:
        kind, text = self.next()
        if kind != "ident":
            raise SqlError(f"expected identifier, got {text!r}")
        return text

    # -- query -------------------------------------------------------------

    def parse_query(self):
        """query := [WITH ctes] core (UNION [ALL] core)* [ORDER BY ...]
        [LIMIT n]. A plain SELECT keeps the legacy ('select', {...})
        shape; unions return ('union', {...})."""
        ctes = []
        if self.accept_kw("with"):
            while True:
                name = self.expect_ident()
                self.expect_kw("as")
                self.expect_op("(")
                sub = self.parse_query()
                self.expect_op(")")
                ctes.append((name, sub))
                if not self.accept_op(","):
                    break
        core = self.parse_select_core()
        cores = [core]
        setops = []  # ("union", all?) | ("intersect",) | ("except",)
        while True:
            if self.accept_kw("union"):
                setops.append(("union", bool(self.accept_kw("all"))))
            elif self.accept_kw("intersect"):
                if self.accept_kw("all"):
                    raise SqlError("INTERSECT ALL (multiset) unsupported")
                setops.append(("intersect",))
            elif self.accept_kw("except"):
                if self.accept_kw("all"):
                    raise SqlError("EXCEPT ALL (multiset) unsupported")
                setops.append(("except",))
            else:
                break
            cores.append(self.parse_select_core())
        order, limit = self.parse_order_limit()
        # INTERSECT binds tighter than UNION/EXCEPT (SQL standard;
        # Spark AstBuilder): fold runs of INTERSECT into nested set-op
        # nodes before the left-associative UNION/EXCEPT chain
        g_cores = [cores[0]]
        g_ops = []
        for op, c in zip(setops, cores[1:]):
            if op[0] == "intersect":
                prev = g_cores[-1]
                if prev[0] == "union" and prev[1].get("ichain"):
                    prev[1]["cores"].append(c)
                    prev[1]["setops"].append(op)
                else:
                    g_cores[-1] = ("union", {
                        "cores": [prev, c], "setops": [op],
                        "order": [], "limit": None, "ctes": [],
                        "ichain": True})
            else:
                g_ops.append(op)
                g_cores.append(c)
        if len(g_cores) == 1:
            out = g_cores[0]
            out[1]["order"] = order
            out[1]["limit"] = limit
            out[1]["ctes"] = ctes
            return out
        return ("union", {"cores": g_cores, "setops": g_ops,
                          "order": order, "limit": limit, "ctes": ctes})

    def parse_order_limit(self):
        order = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            order = [self.parse_order_item()]
            while self.accept_op(","):
                order.append(self.parse_order_item())
        limit = None
        if self.accept_kw("limit"):
            kind, text = self.next()
            if kind != "num" or not re.fullmatch(r"\d+", text):
                raise SqlError("LIMIT needs an integer")
            limit = int(text)
        return order, limit

    def parse_select_core(self):
        self.expect_kw("select")
        distinct = bool(self.accept_kw("distinct"))
        sels = [self.parse_select_item()]
        while self.accept_op(","):
            sels.append(self.parse_select_item())
        self.expect_kw("from")
        rel = self.parse_relation()
        where = None
        if self.accept_kw("where"):
            where = self.parse_expr()
        group = []
        rollup = False
        if self.accept_kw("group"):
            self.expect_kw("by")
            if self.accept_kw("rollup"):
                rollup = True
                self.expect_op("(")
                group = [self.parse_expr()]
                while self.accept_op(","):
                    group.append(self.parse_expr())
                self.expect_op(")")
            else:
                group = [self.parse_expr()]
                while self.accept_op(","):
                    group.append(self.parse_expr())
        having = None
        if self.accept_kw("having"):
            having = self.parse_expr()
        return ("select", {"distinct": distinct, "sels": sels,
                           "from": rel, "where": where, "group": group,
                           "rollup": rollup, "having": having,
                           "order": [], "limit": None, "ctes": []})

    def parse_select_item(self):
        if self.accept_op("*"):
            return (("star",), None)
        e = self.parse_expr()
        alias = None
        if self.accept_kw("as"):
            alias = self.expect_ident()
        elif self.peek()[0] == "ident":
            alias = self.expect_ident()
        return (e, alias)

    def parse_order_item(self):
        e = self.parse_expr()
        asc = True
        if self.accept_kw("desc"):
            asc = False
        else:
            self.accept_kw("asc")
        nulls_first = asc  # Spark default: ASC->FIRST, DESC->LAST
        if self.accept_kw("nulls"):
            which = self.accept_kw("first", "last")
            if which is None:
                raise SqlError("NULLS must be followed by FIRST/LAST")
            nulls_first = which == "first"
        return (e, asc, nulls_first)

    # -- relations ---------------------------------------------------------

    def parse_relation(self):
        rel = self.parse_joined()
        # comma-separated FROM (the classic TPC syntax): implicit joins
        # whose conditions live in WHERE; the planner hoists them
        while self.accept_op(","):
            rel = ("join", "implicit", rel, self.parse_joined(), None)
        return rel

    def parse_joined(self):
        rel = self.parse_table_or_sub()
        while True:
            kind = None
            if self.accept_kw("cross"):
                kind = "cross"
            elif self.accept_kw("inner"):
                kind = "inner"
            elif self.accept_kw("left"):
                if self.accept_kw("semi"):
                    kind = "left_semi"
                elif self.accept_kw("anti"):
                    kind = "left_anti"
                else:
                    self.accept_kw("outer")
                    kind = "left"
            elif self.accept_kw("right"):
                self.accept_kw("outer")
                kind = "right"
            elif self.accept_kw("full"):
                self.accept_kw("outer")
                kind = "full"
            elif self.peek() == ("kw", "join"):
                kind = "inner"
            if kind is None:
                return rel
            self.expect_kw("join")
            right = self.parse_table_or_sub()
            cond = None
            if self.accept_kw("on"):
                cond = self.parse_expr()
            elif kind != "cross":
                raise SqlError(f"{kind.upper()} JOIN requires ON")
            rel = ("join", kind, rel, right, cond)

    def parse_table_or_sub(self):
        if self.accept_op("("):
            sub = self.parse_query()
            self.expect_op(")")
            self.accept_kw("as")
            alias = self.expect_ident()
            return ("subquery", sub, alias)
        name = self.expect_ident()
        alias = None
        if self.accept_kw("as"):
            alias = self.expect_ident()
        elif self.peek()[0] == "ident":
            alias = self.expect_ident()
        return ("table", name, alias or name)

    # -- expressions (precedence climbing) ---------------------------------

    def parse_expr(self):
        return self.parse_or()

    def parse_or(self):
        e = self.parse_and()
        while self.accept_kw("or"):
            e = ("or", e, self.parse_and())
        return e

    def parse_and(self):
        e = self.parse_not()
        while self.accept_kw("and"):
            e = ("and", e, self.parse_not())
        return e

    def parse_not(self):
        if self.accept_kw("not"):
            return ("not", self.parse_not())
        return self.parse_predicate()

    def parse_predicate(self):
        e = self.parse_additive()
        negate = bool(self.accept_kw("not"))
        if self.accept_kw("between"):
            lo = self.parse_additive()
            self.expect_kw("and")
            hi = self.parse_additive()
            out = ("between", e, lo, hi)
            return ("not", out) if negate else out
        if self.accept_kw("in"):
            self.expect_op("(")
            if self.peek() == ("kw", "select"):
                sub = self.parse_query()
                self.expect_op(")")
                # negation carried in-node: NOT IN (subquery) is an
                # anti-join, not a boolean NOT (null semantics differ)
                return ("in_sub", e, sub, negate)
            vals = [self.parse_expr()]
            while self.accept_op(","):
                vals.append(self.parse_expr())
            self.expect_op(")")
            out = ("in", e, vals)
            return ("not", out) if negate else out
        if self.accept_kw("like"):
            pat = self.parse_additive()
            out = ("like", e, pat)
            return ("not", out) if negate else out
        if negate:
            raise SqlError("dangling NOT before a non-predicate")
        if self.accept_kw("is"):
            isnot = bool(self.accept_kw("not"))
            self.expect_kw("null")
            return ("isnull", e, isnot)
        op = self.accept_op("=", "<>", "!=", "<", "<=", ">", ">=")
        if op:
            rhs = self.parse_additive()
            return ("cmp", op, e, rhs)
        return e

    def parse_additive(self):
        e = self.parse_multiplicative()
        while True:
            op = self.accept_op("+", "-", "||")
            if not op:
                return e
            if op == "||":
                e = ("concat", e, self.parse_multiplicative())
            else:
                e = ("arith", op, e, self.parse_multiplicative())

    def parse_multiplicative(self):
        e = self.parse_unary()
        while True:
            op = self.accept_op("*", "/", "%")
            if not op:
                return e
            e = ("arith", op, e, self.parse_unary())

    def parse_unary(self):
        if self.accept_op("-"):
            return ("neg", self.parse_unary())
        if self.accept_op("+"):
            return self.parse_unary()
        return self.parse_primary()

    def parse_primary(self):
        kind, text = self.peek()
        if kind == "op" and text == "(":
            self.next()
            if self.peek() in (("kw", "select"), ("kw", "with")):
                sub = self.parse_query()
                self.expect_op(")")
                return ("scalar_sub", sub)
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if kind == "num":
            self.next()
            if re.fullmatch(r"\d+", text):
                return ("lit", int(text), "int")
            return ("lit", float(text), "float")
        if kind == "str":
            self.next()
            return ("lit", text[1:-1].replace("''", "'"), "str")
        if kind == "kw":
            if text in ("date", "timestamp"):
                # DATE 'yyyy-mm-dd' literal
                if self.peek(1)[0] == "str":
                    self.next()
                    _, s = self.next()
                    return ("lit", s[1:-1], text)
                # else: fall through (it may be a cast type name usage)
            if text == "null":
                self.next()
                return ("lit", None, "null")
            if text == "interval":
                # INTERVAL 'n' DAY -> day-count marker consumed by +/-
                self.next()
                kind2, s = self.next()
                if kind2 == "str":
                    n = int(s[1:-1])
                elif kind2 == "num":
                    n = int(s)
                else:
                    raise SqlError("INTERVAL needs a number")
                unit = self.expect_ident().lower()
                mult = {"day": 1, "days": 1, "week": 7,
                        "weeks": 7}.get(unit)
                if mult is None:
                    raise SqlError(f"unsupported INTERVAL unit {unit!r}")
                return ("interval", n * mult)
            if text in ("true", "false"):
                self.next()
                return ("lit", text == "true", "bool")
            if text == "case":
                return self.parse_case()
            if text == "exists":
                self.next()
                self.expect_op("(")
                sub = self.parse_query()
                self.expect_op(")")
                return ("exists", sub)
            if text == "cast":
                self.next()
                self.expect_op("(")
                e = self.parse_expr()
                self.expect_kw("as")
                tkind, tname = self.next()
                if tkind not in ("ident", "kw"):
                    raise SqlError(f"bad cast type {tname!r}")
                self.expect_op(")")
                return ("cast", e, tname.lower())
        if kind == "ident":
            # function call or column reference
            if self.peek(1) == ("op", "("):
                name = self.expect_ident().lower()
                self.expect_op("(")
                distinct = bool(self.accept_kw("distinct"))
                args = []
                if self.accept_op("*"):
                    args.append(("star",))
                elif self.peek() != ("op", ")"):
                    args.append(self.parse_expr())
                    while self.accept_op(","):
                        args.append(self.parse_expr())
                self.expect_op(")")
                call = ("call", name, distinct, args)
                if self.accept_kw("over"):
                    return self.parse_over(call)
                return call
            tab_or_col = self.expect_ident()
            if self.accept_op("."):
                col = self.expect_ident()
                return ("col", tab_or_col, col)
            return ("col", None, tab_or_col)
        raise SqlError(f"unexpected token {text!r}")

    def parse_over(self, call):
        """OVER '(' [PARTITION BY exprs] [ORDER BY items]
        [ROWS BETWEEN a AND b] ')' -> ('winfn', call, partition,
        order, frame). Frame bounds: None=unbounded, 0=current row,
        +-n=offset rows; default frame is the SQL standard (whole
        partition without ORDER BY, running with it)."""
        self.expect_op("(")
        partition = []
        if self.accept_kw("partition"):
            self.expect_kw("by")
            partition = [self.parse_expr()]
            while self.accept_op(","):
                partition.append(self.parse_expr())
        order = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            order = [self.parse_order_item()]
            while self.accept_op(","):
                order.append(self.parse_order_item())
        frame = None
        if self.accept_kw("rows"):
            self.expect_kw("between")

            def bound(which):
                if self.accept_kw("unbounded"):
                    self.expect_kw("preceding" if which == "lo"
                                   else "following")
                    return None
                if self.accept_kw("current"):
                    self.expect_kw("row")
                    return 0
                kind, text = self.next()
                if kind != "num" or not re.fullmatch(r"\d+", text):
                    raise SqlError("ROWS bound needs an integer")
                n = int(text)
                if self.accept_kw("preceding"):
                    return -n
                self.expect_kw("following")
                return n

            lo = bound("lo")
            self.expect_kw("and")
            hi = bound("hi")
            frame = (lo, hi)
        self.expect_op(")")
        return ("winfn", call, partition, order, frame)

    def parse_case(self):
        """Searched CASE, plus simple CASE (``CASE e WHEN v THEN r``)
        desugared to ``CASE WHEN e = v THEN r`` (base AST shared)."""
        self.expect_kw("case")
        base = None
        if self.peek() != ("kw", "when"):
            base = self.parse_expr()
        whens = []
        while self.accept_kw("when"):
            c = self.parse_expr()
            if base is not None:
                c = ("cmp", "=", base, c)
            self.expect_kw("then")
            v = self.parse_expr()
            whens.append((c, v))
        els = None
        if self.accept_kw("else"):
            els = self.parse_expr()
        self.expect_kw("end")
        if not whens:
            raise SqlError("CASE requires at least one WHEN")
        return ("case", whens, els)


def parse(sql: str):
    p = _Parser(sql)
    q = p.parse_query()
    if p.peek()[0] != "eof":
        raise SqlError(f"trailing tokens at {p.peek()[1]!r}")
    return q
