"""The port's left, left semi and full joins (and right joins, planned as
flipped left joins) against the reference's.

``ops.join.equi_join`` on both sides, the reference probing its prepared
build on its default plain path (its join kernel is held bit-equal to
that path by its own tests, and the port's kernel to its plain version
by the card's): row for row and in order (inner pairs in probe order, then unmatched
stream rows, then unmatched build rows), over null keys, duplicate keys,
an empty build, an empty stream, a build that matches nothing and two
key columns. Then every kind through the plan and exec layers in many
stream batches, against one such call over the whole tables.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spark_rapids_tpu.ops import join as rjoin  # noqa: E402

from spark_rapids_tpu_torch.execs.base import collect  # noqa: E402
from spark_rapids_tpu_torch.ops import join as tjoin  # noqa: E402
from spark_rapids_tpu_torch.plan import nodes as pn  # noqa: E402
from spark_rapids_tpu_torch.plan.overrides import (  # noqa: E402
    apply_overrides)
from tests.test_torch_ops import (  # noqa: E402
    _assert_same_rows, _join_arrays, _port_batch, _port_rows,
    _reference_batch, _reference_rows)

# (stream rows, build rows, build key offset, key columns): the build's
# keys are its drawn keys plus the offset, so 1000 leaves no key in common
_SHAPES = {"nulls_and_duplicates": (90, 50, 0, [0]),
           "two_keys": (90, 50, 0, [0, 1]), "empty_build": (90, 0, 0, [0]),
           "empty_stream": (0, 50, 0, [0, 1]),
           "no_match": (90, 50, 1000, [0])}


@pytest.mark.parametrize("shape", sorted(_SHAPES))
@pytest.mark.parametrize("kind", ["left", "leftsemi", "full"])
def test_equi_join_kind_matches_reference(kind, shape):
    n_s, n_b, offset, sk = _SHAPES[shape]
    bk = sk
    sd, st, sv = _join_arrays(n_s, 40, seed=5)
    bd, bt, bv = _join_arrays(n_b, 40, seed=6)
    bd[0] = bd[0] + offset
    rs, rst = _reference_batch(sd, st, sv, n_s)
    rb, rbt = _reference_batch(bd, bt, bv, n_b)
    prep = rjoin.prepare_build(rb, bk, rbt, [rst[o] for o in sk])
    want, wtypes = rjoin.equi_join(rs, rb, sk, bk, rst, rbt, kind,
                                   prepared=prep)
    ts, tst = _port_batch(sd, st, sv)
    tb, tbt = _port_batch(bd, bt, bv)
    got, gtypes = tjoin.equi_join(ts, tb, sk, bk, tst, tbt, kind)
    assert [t.name for t in gtypes] == [t.name for t in wtypes]
    _assert_same_rows(_port_rows(got), _reference_rows(want))
    if n_s and n_b and not offset:
        # the case holds what it names: a null stream key kept unmatched
        # by the outer kinds, and build keys that repeat
        assert not sv[0].all() and len(np.unique(bd[0])) < n_b
        assert got.num_rows > (0 if kind == "leftsemi" else n_s)


def _tables(seed=7, n=120):
    """t (k nullable, v, s) and u (k2, w, name): u's keys miss some of
    t's and hold some t lacks."""
    r = np.random.default_rng(seed)
    t = {"k": r.integers(0, 12, n).astype(np.int64), "v": r.random(n),
         "s": np.array([f"s{i % 5}" for i in range(n)], dtype=object)}
    u = {"k2": r.integers(4, 16, 30).astype(np.int64),
         "w": r.integers(0, 100, 30).astype(np.int64),
         "name": np.array([f"u{i % 4}" for i in range(30)], dtype=object)}
    return (t, {"k": r.random(n) > 0.1}), (u, None)


def _sorted_rows(cols):
    rows = list(zip(*[[None if x is None or (isinstance(x, float) and
                                              np.isnan(x)) else x
                       for x in c] for c in cols]))
    return sorted(rows, key=lambda r: [(x is None, str(x)) for x in r])


@pytest.mark.parametrize("kind", ["left", "right", "full", "left_semi"])
def test_join_exec_in_batches_equals_one_join(kind):
    """The plan through apply_overrides -> collect, in 7-row scan
    batches, gives the rows of one ``equi_join`` call over the whole
    tables (held to the reference's above): the stream batches each
    probe the build prepared once, a full join's unmatched build rows
    come once, after every batch, and a right join is the left join of
    the flipped sides with its columns put back."""
    (t, tv), (u, _) = _tables()
    got = collect(apply_overrides(pn.JoinNode(
        kind, pn.ScanNode(pn.InMemorySource(t, validity=tv)),
        pn.ScanNode(pn.InMemorySource(u)), [0], [0]),
        {"rapids.tpu.sql.reader.batchSizeRows": 7}, device="cpu"))
    tb, tt = _port_batch([t["k"], t["v"], t["s"]],
                         ["bigint", "double", "string"], [tv["k"], None, None])
    ub, ut = _port_batch([u["k2"], u["w"], u["name"]],
                         ["bigint", "bigint", "string"], [None] * 3)
    flip = kind == "right"
    one, _ = tjoin.equi_join(ub if flip else tb, tb if flip else ub, [0],
                             [0], ut if flip else tt, tt if flip else ut,
                             {"left_semi": "leftsemi", "right": "left"}
                             .get(kind, kind))
    cols = [c.to_numpy() for c in one.columns]
    cols = [np.where(v, d, None) if v is not None else d for d, v in cols]
    if flip:
        cols = cols[3:] + cols[:3]
    assert list(got) == (list(t) + list(u) if kind != "left_semi"
                         else list(t))
    assert _sorted_rows([got[c] for c in got]) == _sorted_rows(cols)


def test_outer_join_with_residual_condition_is_refused():
    (t, _), (u, _) = _tables()
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.expressions.base import BoundReference
    from spark_rapids_tpu_torch.expressions.predicates import GreaterThan

    cond = GreaterThan(BoundReference(4, dt.INT64),
                       BoundReference(0, dt.INT64))
    for kind in ("left", "right", "full"):
        node = pn.JoinNode(kind, pn.ScanNode(pn.InMemorySource(t)),
                           pn.ScanNode(pn.InMemorySource(u)), [0], [0],
                           condition=cond)
        with pytest.raises(NotImplementedError, match="residual"):
            apply_overrides(node, device="cpu")
