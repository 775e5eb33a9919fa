"""Float literal folding and fused multiply-adds (ROADMAP Queue C, C2 and
C3): the port's ``expressions.folding`` against the reference engine.

The reference's XLA backend folds chains of float literals, turns a
division by a literal into a multiplication by its reciprocal, and fuses
a product that feeds an add into one correctly rounded fused
multiply-add. The same SQL runs through ``spark_rapids_tpu.api.Session``
(JAX's CPU backend) and ``spark_rapids_tpu_torch.api.Session(device=
"cpu")`` over the same seeded table, and every float is compared by its
bit pattern. The table is 200 seeded doubles ``standard_normal * 10**k``
(k from -5 to 4) plus ``1e-310, -0.0, 1e308, -1e308, 3.0, 0.1`` and the
subnormal test's rows ``1e-310, 0.0, 1.5, -1e-310, 1e-300, -0.0, nan``,
with an integer column ``j`` that is null on every fifth row.

All projected cases run as one query per engine, one column per case;
each column gives the reference the same bits as it does alone (XLA
shares a common subexpression between columns, which can change what it
fuses, so the columns are chosen to share none that matters). The WHERE
and join cases run one query each; the aggregates share one.
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spark_rapids_tpu.api import Session as RSession  # noqa: E402
from spark_rapids_tpu.plan import nodes as rpn  # noqa: E402

from spark_rapids_tpu_torch.api import Session  # noqa: E402
from spark_rapids_tpu_torch.plan import nodes as pn  # noqa: E402

# family -> case -> expression, all in one SELECT over t
_PROJECTED = {
    "add_chain": {
        "plus_one_minus_one": "d + 1.0 - 1.0",
        "literal_left_cancels": "1.5 + d - 1.5",
        "minus_then_plus": "d - 2.5 + 2.5",
        "plus_plus": "d + 0.1 + 0.2",
        "minus_minus": "d - 0.1 - 0.2",
        "literal_minus_d_plus": "0.1 - d + 0.2",
        "literal_minus_d_minus": "0.3 - d - 0.7",
        "int_then_float": "d + 1 + 2.5",
        "int_cancels": "d + 3 - 3",
        "three_literals": "d + 0.4 + 0.8 + 1.6",
    },
    "mul_chain": {
        "times_two_times_half": "d * 2.0 * 0.5",
        "literal_left": "2.5 * d * 0.4",
        "times_then_divide": "(d * 4.0) / 4.0",
        "int_literals": "d * 8 * 0.125",
        "three_times_five": "d * 3.0 * 5.0",
        "divide_then_times": "(d / 3.0) * 7.0",
        "divide_divide": "d / 6.0 / 7.0",
        "times_divide": "(d * 9.0) / 7.0",
        "int_divisor_then_column": "d / 3 / e",
        "column_divisor_then_int": "(d / e) / 5",
        "int_divisors": "d / 11 / 13",
        "three_divisors": "i / 7.0 / 0.8 * 0.3",
    },
    "divide_by_literal": {
        "three": "d / 3.0",
        "seven": "d / 7.0",
        "ten": "d / 10.0",
        "half": "d / 0.5",
        "int_power_of_two": "d / 4",
        "int_column": "i / 3",
        "subnormal_divisor": "d / 1e-310",
        "huge_divisor": "d / 1e308",
        "zero_divisor": "d / 0.0",
    },
    "multiply_add": {
        "column_literal": "d * 0.3 + 0.1",
        "literal_left": "0.7 + d * 0.9",
        "minus_literal": "d * 0.6 - 0.2",
        "literal_minus": "0.4 - d * 0.8",
        "column_column": "d * d + d",
        "int_column": "d * i + 1.0",
        "minus_column": "e * i - d",
        "folds_then_fuses": "d * 0.35 + 0.1 + 0.2",
        "divide_then_fuses": "d / 9.0 + 1.0",
        "negated_product": "(d * e) * -1.0 + 0.3",
        "subnormal_addend": "d * 1e-300 - 2e-308",
        # 1.5 * 3.0e-308 - 4.4e-308 is 1e-309 rounded once: flushed
        "subnormal_result": "d * 3.0e-308 - 4.4e-308",
        "literal_over_column_times_literal": "(3.0 / e) * 10.0 + d",
        "literal_over_column_times_literal_plus_literal":
            "(5.0 / d) * 1.5 + 2.0",
    },
    "stops": {
        "two_column_terms": "(d + 0.1) + (e + 0.2)",
        "chain_across_column": "d + 0.3 + i + 0.4",
        "literal_pair": "d + (0.5 + 0.6)",
        "literal_minus_sum": "0.2 - (d + 0.1)",
        "literal_over_column": "7.0 / (3.0 / d)",
        "product_of_sum": "(d + 1.0) * 2.0",
    },
}

# a nullable integer column: XLA folds integer ``j - j`` and ``j * 0`` to
# 0 in the data, and the reference keeps the validity apart, so a null
# row stays null
_NULLABLE = {
    "int_minus_itself": "j - j",
    "int_times_zero": "j * 0",
    "zero_times_int": "0 * j",
    "int_zero_plus_one": "(j - j) + 1",
    "float_times_int_zero": "f * (j * 0)",
}

# integer zeros in a float add: XLA folds ``i - i`` and ``i * 0`` to 0,
# then drops that 0 from the add, so ``d + (i - i)`` is d untouched
# (-0.0 and subnormals included), null where i is (t's j has nulls)
_INTEGER_ZERO = {
    "d_plus_i_minus_i": "d + (i - i)",
    "i_minus_i_plus_d": "(i - i) + d",
    "d_minus_i_times_zero": "d - (i * 0)",
    "d_times_one_plus_j_minus_j": "d * 1 + (j - j)",
    "d_minus_zero_times_j": "d - (0 * j)",
    "j_times_zero_plus_d": "(j * 0) + d",
    "product_plus_int_zero": "d * e + (i * 0)",
    "product_literal_plus_j_minus_j": "d * 0.3 + (j - j)",
    "int_zero_times_one_plus_d": "(i - i) * 1.0 + d",
    "d_plus_int_zero_times_two": "d + (i - i) * 2",
    "int_zero_minus_d": "(j - j) - d",
    "d_times_int_zero": "d * (j - j)",
    "two_int_zeros": "d + (i - i) - (j * 0)",
    "sum_minus_itself_unfolded": "d + ((i + 1) - (i + 1))",
    "neg_zero_minus_int_zero_plus_d": "-0.0 - (i * 0) + d",
    "zero_plus_j_minus_j_plus_d": "0.0 + (j - j) + d",
}

# the same zeros in sum inputs, one grouped query
_INTEGER_ZERO_SUMS = {
    "sum_d_plus_i_minus_i": "sum(d + (i - i))",
    "sum_i_minus_i_plus_d": "sum((i - i) + d)",
    "sum_d_minus_i_times_zero": "sum(d - (i * 0))",
    "sum_d_times_one_plus_j_minus_j": "sum(d * 1 + (j - j))",
}

_QUERIES = {
    "where_d_plus_i_minus_i": "SELECT i FROM t WHERE d + (i - i) > 0.0",
    "where_i_minus_i_plus_d": "SELECT i FROM t WHERE (i - i) + d < 0.0",
    "where_d_minus_i_times_zero":
        "SELECT i FROM t WHERE d - (i * 0) >= 0.0",
    "where_d_times_one_plus_j_minus_j":
        "SELECT i FROM t WHERE d * 1 + (j - j) <= 0.0",
    "where_neg_zero_minus_int_zero_plus_d":
        "SELECT i FROM t WHERE -0.0 - (i * 0) + d >= 0.0",
    "where_zero_plus_j_minus_j_plus_d":
        "SELECT i FROM t WHERE 0.0 + (j - j) + d <= 0.0",
    "where_int_times_zero": "SELECT f FROM n WHERE j * 0 = 0",
    "where_int_minus_itself": "SELECT f FROM n WHERE j - j < 1",
    "where_multiply_add": "SELECT i FROM t WHERE d * 0.3 + 0.1 > 0.5",
    "where_minus_minus": "SELECT i FROM t WHERE d - 0.1 - 0.2 < 0.0",
    "where_divide": "SELECT i FROM t WHERE d / 3.0 > e",
    "join_residual_multiply_add":
        "SELECT t.i, u.w FROM t JOIN u ON t.g = u.k AND "
        "t.d * 0.3 + 0.1 > u.w",
    "join_residual_chain":
        "SELECT t.i, u.w FROM t JOIN u ON t.g = u.k AND "
        "t.d - 0.1 - 0.2 < u.w * 0.7 + 0.1",
}

# aggregate inputs, one grouped query (groups of 3-4 rows, so the sums'
# order does not enter)
_AGGREGATED = {
    "sum_multiply_add": "sum(d * 0.3 + 0.1)",
    "sum_divide": "sum(d / 3.0)",
    "sum_minus_minus": "sum(d - 0.1 - 0.2)",
    "avg_multiply_sub": "avg(d * 0.6 - 0.2)",
    "avg_cancels": "avg(d + 1.0 - 1.0)",
    "sum_int_column_product": "sum(d * i + 1.0)",
}

_CASES = sorted([(f, c) for f, cases in _PROJECTED.items() for c in cases] +
                [("nullable", c) for c in _NULLABLE] +
                [("integer_zero", c) for c in _INTEGER_ZERO] +
                [("integer_zero_sum", c) for c in _INTEGER_ZERO_SUMS] +
                [("query", c) for c in _QUERIES] +
                [("aggregate", c) for c in _AGGREGATED])


def _tables():
    rng = np.random.default_rng(0)
    k = rng.integers(-5, 5, 200)
    d = np.concatenate([
        rng.standard_normal(200) * 10.0 ** k,
        [1e-310, -0.0, 1e308, -1e308, 3.0, 0.1],
        [1e-310, 0.0, 1.5, -1e-310, 1e-300, -0.0, np.nan]])
    n = len(d)
    t = {"d": d,
         "i": rng.integers(-1000, 1000, n).astype(np.int64),
         "e": rng.standard_normal(n) * 10.0 ** rng.integers(-3, 3, n),
         "g": (np.arange(n) % 69).astype(np.int64)}
    t["j"] = t["i"] % 97
    u = {"k": np.arange(69, dtype=np.int64), "w": rng.standard_normal(69)}
    m = {"j": rng.integers(-50, 50, 40).astype(np.int64),
         "f": np.concatenate([rng.standard_normal(36),
                              [-0.0, 1e-310, -2.5, np.nan]])}
    valid = {"j": np.arange(40) % 3 != 1}
    return {"t": (t, {"j": np.arange(n) % 5 != 2}), "u": (u, None),
            "n": (m, valid)}


class _Engines:
    """Both engines over the same tables; each query runs once."""

    def __init__(self):
        self.rs = RSession()
        self.s = Session(device="cpu")
        for name, (cols, valid) in _tables().items():
            self.rs.create_temp_view(
                name, rpn.InMemorySource(dict(cols), validity=valid))
            self.s.create_temp_view(
                name, pn.InMemorySource(dict(cols), validity=valid))
        self._runs = {}

    def run(self, text: str):
        """(reference columns, port columns), each a list of lists."""
        if text not in self._runs:
            want = self.rs.sql(text).collect()
            got = self.s.sql(text).collect()
            assert list(got) == list(want.columns)
            self._runs[text] = ([want[c].to_numpy().tolist()
                                 for c in want.columns],
                                [list(got[c]) for c in got])
        return self._runs[text]


@pytest.fixture(scope="module")
def engines():
    return _Engines()


def _cell(x):
    """A value as its bit pattern (one token for NaN, one for null)."""
    if x is None:
        return ("null",)
    if isinstance(x, (float, np.floating)):
        return ("nan",) if np.isnan(x) else \
            ("f", int(np.float64(x).view(np.int64)))
    return ("v", int(x))


def _rows(columns):
    return sorted(zip(*[[_cell(x) for x in c] for c in columns]))


@pytest.mark.parametrize("family, case", _CASES)
def test_float_folding_matches_reference_engine_bit_for_bit(engines, family,
                                                             case):
    if family in _PROJECTED:
        exprs = [(f"{f}__{c}", e) for f, cases in _PROJECTED.items()
                 for c, e in cases.items()]
        text = "SELECT " + ", ".join(f"{e} AS {c}" for c, e in exprs) + \
            " FROM t"
        want, got = engines.run(text)
        k = [c for c, _ in exprs].index(f"{family}__{case}")
        assert [_cell(x) for x in got[k]] == [_cell(x) for x in want[k]]
        return
    if family == "nullable":
        names = sorted(_NULLABLE)
        text = "SELECT " + ", ".join(
            f"{_NULLABLE[c]} AS {c}" for c in names) + " FROM n"
        want, got = engines.run(text)
        k = names.index(case)
        assert want[k].count(None) > 0
        assert [_cell(x) for x in got[k]] == [_cell(x) for x in want[k]]
        return
    if family == "integer_zero":
        names = sorted(_INTEGER_ZERO)
        text = "SELECT " + ", ".join(
            f"{_INTEGER_ZERO[c]} AS {c}" for c in names) + " FROM t"
        want, got = engines.run(text)
        k = names.index(case)
        assert [_cell(x) for x in got[k]] == [_cell(x) for x in want[k]]
        return
    if family in ("aggregate", "integer_zero_sum"):
        aggs = _AGGREGATED if family == "aggregate" else _INTEGER_ZERO_SUMS
        names = sorted(aggs)
        text = "SELECT g, " + ", ".join(
            f"{aggs[c]} AS {c}" for c in names) + " FROM t GROUP BY g"
        want, got = engines.run(text)
        k = names.index(case) + 1
        assert _rows([got[0], got[k]]) == _rows([want[0], want[k]])
        return
    want, got = engines.run(_QUERIES[case])
    assert len(want[0]) > 0
    assert _rows(got) == _rows(want)


def test_multiply_add_rounds_once():
    """``MultiplyAdd`` on the CPU equals the correctly rounded a * b + c,
    computed exactly with fractions, on seeded doubles."""
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.expressions.arithmetic import MultiplyAdd
    from spark_rapids_tpu_torch.expressions.base import (BoundReference,
                                                         ColV, EvalContext)

    rng = np.random.default_rng(3)
    a, b, c = (rng.standard_normal(2003) * 10.0 ** rng.integers(-3, 3, 2003)
               for _ in range(3))
    cols = [ColV(dt.FLOAT64, torch.from_numpy(x), None) for x in (a, b, c)]
    ctx = EvalContext(cols, 2003, "cpu")
    refs = [BoundReference(j, dt.FLOAT64) for j in range(3)]
    got = MultiplyAdd(*refs, dt.FLOAT64).eval(ctx).data.numpy()
    exact = np.array([float(Fraction(x) * Fraction(y) + Fraction(z))
                      for x, y, z in zip(a, b, c)])
    np.testing.assert_array_equal(got.view(np.int64), exact.view(np.int64))
    assert (got != a * b + c).any()


def test_q9_profit_fuses_as_the_reference():
    """TPC-H q9's ``e * (1 - d) - c * q`` over the generators' columns:
    the reference fuses the left product (``fma(e, 1 - d, -(c * q))``,
    as the port's rule does), so every row's amount is bit-equal, where
    the right product's fusion or none would differ on many rows."""
    from spark_rapids_tpu.columnar import dtypes as rdt
    from spark_rapids_tpu.config import RapidsConf
    from spark_rapids_tpu.execs.base import collect as rcollect
    from spark_rapids_tpu.expressions import arithmetic as rar
    from spark_rapids_tpu.expressions import base as rbase
    from spark_rapids_tpu.plan.overrides import apply_overrides as rapply

    from spark_rapids_tpu_torch.benchmarks import datagen
    from spark_rapids_tpu_torch.columnar import dtypes as tdt
    from spark_rapids_tpu_torch.execs.base import collect
    from spark_rapids_tpu_torch.expressions import arithmetic as tar
    from spark_rapids_tpu_torch.expressions import base as tbase
    from spark_rapids_tpu_torch.plan.overrides import apply_overrides

    li = datagen.gen_lineitem(0.01)
    cost = datagen.gen_partsupp(0.01)["ps_supplycost"]
    n = 20000
    cols = {"e": li["l_extendedprice"][:n], "d": li["l_discount"][:n],
            "c": cost[np.random.default_rng(1).integers(0, len(cost), n)],
            "q": li["l_quantity"][:n]}

    def plan(ar, base, dtm, nodes):
        x = [base.BoundReference(i, dtm.FLOAT64) for i in range(4)]
        profit = ar.Subtract(
            ar.Multiply(x[0], ar.Subtract(base.Literal(1.0), x[1])),
            ar.Multiply(x[2], x[3]))
        return nodes.ProjectNode([base.Alias(profit, "a")], nodes.ScanNode(
            nodes.InMemorySource(dict(cols))), ["a"])

    want = rcollect(rapply(plan(rar, rbase, rdt, rpn), RapidsConf()))
    got = collect(apply_overrides(plan(tar, tbase, tdt, pn), device="cpu"))
    w = want["a"].to_numpy()
    g = np.asarray(got["a"], np.float64)
    assert g.view(np.int64).tolist() == w.view(np.int64).tolist()
    plain = cols["e"] * (1.0 - cols["d"]) - cols["c"] * cols["q"]
    assert (plain != w).sum() > n // 10
