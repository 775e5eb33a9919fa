"""Cross-exec fusion (the counterpart of spark_rapids_tpu/execs/fused.py).

The reference compiles a pipeline segment, a unary chain of

    FilterExec | ProjectExec | BroadcastHashJoinExec (probe side)

into one XLA program per batch, and runs it so by default
(``rapids.tpu.sql.fusion.enabled``). The port runs the same steps, in the
same order, over one batch, eagerly:

- a filter ANDs its predicate into a live mask (rows stay in place);
- a projection evaluates its expressions over every row;
- a join probes a build whose key hashes are unique, so each stream row
  has at most one candidate, and folds the match into the live mask
  (inner, semi, anti) or into the gathered columns' validity (left).
  A build with a repeated key hash sends the whole exec to its unfused
  subtree, which the pass keeps;
- a standalone chain compacts once at its end (K1, ``partition_order``);
  one under an aggregate hands its mask to the group-by instead
  (``FusedAggregateExec``), and one over a single-batch aggregate may end
  in its ORDER BY (``SortStep``, the sort tail).

What the reference carries through its program besides the arrays, each
column's dictionary and upload statistics, the port carries the same way:
a host mirror of the working columns (``_Ghost``) walks the steps, kept
through filters and sorts, derived through projections
(``expressions.compiler.derive_stats``), the stream side's kept through a
join and the build's appended. So a group key keeps its (min, max)
wherever the reference's does, and takes the same group-by path.

String predicates against literals (``=``, ``IN``, ``<``...) ride in a
chain as code-range tests whose bounds are each batch's dictionary
positions (``_AuxStringPred``); ``StartsWith``, LIKE and ``substring``
break it. The reference's in-program build, its deferred scan decode and
its mesh checks are not ported (ROADMAP A9, A12): builds are prepared
before the first batch, as the reference does with its in-program build
off.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.columnar.column import (Column, StringColumn,
                                                    dictionary_cache)
from spark_rapids_tpu_torch.execs import aggregate as agg_exec
from spark_rapids_tpu_torch.execs import basic, joins
from spark_rapids_tpu_torch.execs.base import TorchExec
from spark_rapids_tpu_torch.execs.sort import SortExec
from spark_rapids_tpu_torch.expressions import predicates as pr
from spark_rapids_tpu_torch.expressions.base import (BoundReference, ColV,
                                                     EvalContext,
                                                     Expression, Literal,
                                                     broadcast)
from spark_rapids_tpu_torch.expressions.compiler import (derive_stats,
                                                         substitute,
                                                         unwrap_alias)
from spark_rapids_tpu_torch.expressions.folding import fold
from spark_rapids_tpu_torch.kernels import join as kjoin
from spark_rapids_tpu_torch.kernels import sort as ksort
from spark_rapids_tpu_torch.ops import join as join_ops
from spark_rapids_tpu_torch.ops import sortkeys
from spark_rapids_tpu_torch.ops.join import _PROBE_NULL


# ---------------------------------------------------------------------------
# step descriptors
# ---------------------------------------------------------------------------


class _AuxStringPred(Expression):
    """A string-vs-literal predicate inside a chain. Dictionaries are
    sorted, so each comparison is a code-range test whose bounds are the
    literals' positions in that batch's dictionary (``ctx.aux``, slots
    from ``base_slot``). ``op``: 'eq_any' (EqualTo / IN, one [lo, hi)
    pair per literal), 'lt' | 'le' (codes < bound), 'gt' | 'ge' (codes
    >= bound)."""

    def __init__(self, ref, op: str, literals: List[str],
                 base_slot: int = -1):
        super().__init__([ref])
        self.col = ref.ordinal  # the working column, at its own step
        self.op = op
        self.literals = [str(v) for v in literals]
        self.base_slot = base_slot

    @property
    def dtype(self):
        return dt.BOOLEAN

    @property
    def device_only(self) -> bool:
        return True

    def n_slots(self) -> int:
        return 2 * len(self.literals) if self.op == "eq_any" else 1

    def aux_values(self, dictionary) -> List[int]:
        """This predicate's slots for one dictionary (cached with it)."""
        if dictionary is None or not len(dictionary):
            d = np.array([], dtype=str)
            return self._positions(d)
        cache = dictionary_cache(dictionary)
        key = ("aux", self.op, tuple(self.literals))
        if key not in cache:
            if "str" not in cache:
                cache["str"] = dictionary.astype(str)
            cache[key] = self._positions(cache["str"])
        return cache[key]

    def _positions(self, d: np.ndarray) -> List[int]:
        if self.op == "eq_any":
            out = []
            for lit in self.literals:
                out.append(int(np.searchsorted(d, lit, side="left")))
                out.append(int(np.searchsorted(d, lit, side="right")))
            return out
        side = "left" if self.op in ("lt", "ge") else "right"
        return [int(np.searchsorted(d, self.literals[0], side=side))]

    def eval(self, ctx: EvalContext):
        v = broadcast(self.children[0].eval(ctx), ctx)
        codes, aux, b = v.data, ctx.aux, self.base_slot
        if self.op == "eq_any":
            keep = torch.zeros(codes.shape, dtype=torch.bool,
                               device=codes.device)
            for i in range(len(self.literals)):
                keep |= (codes >= aux[b + 2 * i]) & \
                    (codes < aux[b + 2 * i + 1])
        elif self.op in ("lt", "le"):
            keep = codes < aux[b]
        else:
            keep = codes >= aux[b]
        return ColV(dt.BOOLEAN, keep, v.validity)


_CMP = {pr.EqualTo: "eq_any", pr.LessThan: "lt", pr.LessThanOrEqual: "le",
        pr.GreaterThan: "gt", pr.GreaterThanOrEqual: "ge"}
_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq_any": "eq_any"}


def _string_ref(e: Expression) -> bool:
    return isinstance(e, BoundReference) and e.dtype is dt.STRING


def _as_string_pred(node: Expression) -> Optional[_AuxStringPred]:
    """The chain's stand-in for ``node`` when it compares a plain string
    column with string literals; None otherwise."""
    if isinstance(node, pr.In):
        ref = node.children[0]
        if _string_ref(ref) and node.values and \
                all(isinstance(v, str) for v in node.values):
            return _AuxStringPred(ref, "eq_any", list(node.values))
        return None
    op = _CMP.get(type(node))
    if op is None:
        return None
    a, b = node.children
    if _string_ref(a) and isinstance(b, Literal) and \
            isinstance(b.value, str):
        return _AuxStringPred(a, op, [b.value])
    if _string_ref(b) and isinstance(a, Literal) and \
            isinstance(a.value, str):
        return _AuxStringPred(b, _FLIP[op], [a.value])
    return None


def chain_transform(e: Expression) -> Tuple[Expression,
                                            List[_AuxStringPred]]:
    """``e`` with its string-literal predicates as aux-operand nodes; the
    result can run in a chain iff it is ``device_only``."""
    preds: List[_AuxStringPred] = []

    def fn(node):
        repl = _as_string_pred(node)
        if repl is not None:
            preds.append(repl)
            return repl
        return node

    return e.transform(fn), preds


def chain_traceable(e: Expression) -> bool:
    """Can ``e`` run inside a chain (directly or after the transform)?"""
    if not e.deterministic:
        return False
    return e.device_only or chain_transform(e)[0].device_only


@dataclasses.dataclass
class FilterStep:
    condition: Expression
    aux_preds: List[_AuxStringPred] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class ProjectStep:
    exprs: List[Expression]
    aux_preds: List[_AuxStringPred] = dataclasses.field(
        default_factory=list)


def make_filter_step(condition: Expression) -> FilterStep:
    return FilterStep(*chain_transform(condition))


def make_project_step(exprs: Sequence[Expression]) -> ProjectStep:
    out, preds = [], []
    for e in exprs:
        t, p = chain_transform(e)
        out.append(t)
        preds.extend(p)
    return ProjectStep(out, preds)


@dataclasses.dataclass
class SortStep:
    """The ORDER BY at a chain's end; only over a source that yields one
    batch (an aggregate), where a per-batch sort is the global one."""

    specs: tuple


@dataclasses.dataclass
class JoinStep:
    kind: str                   # inner | left | left_semi | left_anti
    stream_keys: List[int]      # ordinals into the working columns
    build_keys: List[int]       # ordinals into the build schema
    build_index: int            # which prepared build feeds this step
    build_types: List[dt.DType]
    key_common: List[dt.DType]  # each key pair's comparison type


# ---------------------------------------------------------------------------
# builds: prepared once per join exec and key spec
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Ghost:
    """Host mirror of one working column: its dictionary and its
    statistics (a ``HostRange``)."""

    dtype: dt.DType
    dictionary: Optional[np.ndarray] = None
    stats: Optional[object] = None


def _ghost_of(col: Column) -> _Ghost:
    return _Ghost(col.dtype, col.dictionary
                  if isinstance(col, StringColumn) else None, col.stats)


@dataclasses.dataclass
class PreparedBuild:
    """A drained build prepared for a unique probe (``build.ok`` False:
    a key hash repeats) and the ghosts of its columns."""

    build: join_ops.UniqueBuild
    ghosts: List[_Ghost]

    @property
    def ok(self) -> bool:
        return self.build.ok

    @property
    def mode(self) -> str:
        """'dense' (one gather in the inverse table), 'hash' (K3's probe)
        or 'empty' (no valid build key: nothing to probe)."""
        if self.build.table is not None:
            return "dense"
        return "hash" if self.build.n_valid else "empty"


def prepare_build(join: "joins.BroadcastHashJoinExec",
                  build_keys: Sequence[int], build_types: Sequence[dt.DType],
                  hash_types: Sequence[dt.DType], span_max: int
                  ) -> PreparedBuild:
    """The join's build drained (once, shared with the join itself, which
    runs if the chain falls back) and prepared (once per key spec)."""
    key = (tuple(build_keys), tuple(hash_types), span_max)
    if key not in join.prepared:
        b = join.build_batch()
        u = join_ops.prepare_unique_build(b, list(build_keys),
                                          list(build_types),
                                          list(hash_types), span_max)
        join.prepared[key] = PreparedBuild(u, [_ghost_of(c)
                                               for c in b.columns])
    return join.prepared[key]


# ---------------------------------------------------------------------------
# the chain
# ---------------------------------------------------------------------------


class FusedChain:
    """A step list run over one batch at a time.

    The reference's chain is one XLA program, so its simplifier and
    code generator see each value as the composition of every step
    before it: a float product made in a projection fuses into an add of
    a later step (C3 across steps), and literal chains fold across steps
    (C2). The port composes each filter, join key and output of the
    chain over its base columns (the source's, then each join's build
    columns) and folds that (``expressions.folding.fold``), once, when
    the chain is made. The steps themselves (as written, their string
    predicates as ``_AuxStringPred``) drive the ghosts."""

    def __init__(self, steps: List, source_types: List[dt.DType]):
        self.steps = list(steps)
        self.source_types = list(source_types)
        slot = 0  # aux slots numbered in (step, predicate) order
        for s in self.steps:
            for p in getattr(s, "aux_preds", ()):
                p.base_slot = slot
                slot += p.n_slots()
        self.n_aux = slot
        env: List[Expression] = [BoundReference(i, t) for i, t in
                                 enumerate(self.source_types)]
        n_base = len(env)
        self.programs: list = []
        for s in self.steps:
            prog = None
            if isinstance(s, FilterStep):
                prog = fold(substitute(s.condition, env))
            elif isinstance(s, ProjectStep):
                env = [substitute(e, env) for e in s.exprs]
            elif isinstance(s, JoinStep):
                prog = [fold(unwrap_alias(env[o])) for o in s.stream_keys]
                if s.kind not in ("left_semi", "left_anti"):
                    env = env + [BoundReference(n_base + j, t)
                                 for j, t in enumerate(s.build_types)]
                    n_base += len(s.build_types)
            self.programs.append(prog)
        self.outputs = [fold(unwrap_alias(e)) for e in env]

    def run(self, batch: ColumnarBatch, preps: List[PreparedBuild],
            compact_out: bool, device):
        """-> (outs as (data, validity) pairs, live mask or row count,
        the output ghosts). ``compact_out``: the live rows only (a
        standalone chain); else every row and the mask."""
        states, final_ghosts = self._ghost_states(batch, preps)
        aux = self._aux_from_states(states)
        n = batch.num_rows
        base = [ColV(c.dtype, c.data, c.validity,
                     c if isinstance(c, StringColumn) else None)
                for c in batch.columns]
        live = torch.ones(n, dtype=torch.bool, device=device)
        sort_step = None
        for step, prog in zip(self.steps, self.programs):
            ctx = EvalContext(base, n, device, aux)
            if isinstance(step, FilterStep):
                v = broadcast(prog.eval(ctx), ctx)
                keep = v.data if v.validity is None else v.data & v.validity
                live = live & keep
            elif isinstance(step, SortStep):
                sort_step = step
            elif isinstance(step, JoinStep):
                keys = [broadcast(k.eval(ctx), ctx) for k in prog]
                base, live = _apply_join(step, keys, base, live,
                                         preps[step.build_index])
        ctx = EvalContext(base, n, device, aux)
        cols = [broadcast(e.eval(ctx), ctx) for e in self.outputs]
        outs = [(c.data, c.validity) for c in cols]
        if sort_step is not None:
            # dead rows sink last; the live count cuts them off
            payloads, layout = [], []
            for d, v in outs:
                layout.append((len(payloads),
                               -1 if v is None else len(payloads) + 1))
                payloads.extend([d] if v is None else [d, v])
            sorted_pl = sortkeys.sort_with_payloads(
                outs, [c.dtype for c in cols], list(sort_step.specs),
                payloads, live_mask=live)
            count = int(live.sum())
            return ([(sorted_pl[di][:count],
                      None if vi < 0 else sorted_pl[vi][:count])
                     for di, vi in layout], count, final_ghosts)
        if not compact_out:
            return outs, live, final_ghosts
        order, count = ksort.partition_order_count(live)
        sel = order[:count]
        return ([(torch.index_select(d, 0, sel),
                  None if v is None else torch.index_select(v, 0, sel))
                 for d, v in outs], count, final_ghosts)

    def _ghost_states(self, batch: ColumnarBatch,
                      preps: List[PreparedBuild]):
        """Each step's input ghosts, and the output ghosts."""
        ghosts = [_ghost_of(c) for c in batch.columns]
        states = []
        for step in self.steps:
            states.append(ghosts)
            if isinstance(step, (FilterStep, SortStep)):
                continue
            if isinstance(step, ProjectStep):
                ghosts = [self._project_ghost(e, ghosts)
                          for e in step.exprs]
                continue
            if step.kind in ("left_semi", "left_anti"):
                continue
            ghosts = ghosts + list(preps[step.build_index].ghosts)
        return states, ghosts

    def _aux_from_states(self, states) -> tuple:
        if self.n_aux == 0:
            return ()
        aux: List[int] = []
        for step, ghosts in zip(self.steps, states):
            for p in getattr(step, "aux_preds", ()):
                aux.extend(p.aux_values(ghosts[p.col].dictionary))
        return tuple(aux)

    @staticmethod
    def _project_ghost(e: Expression, ghosts: List[_Ghost]) -> _Ghost:
        u = unwrap_alias(e)
        if isinstance(u, BoundReference):
            g = ghosts[u.ordinal]
            return _Ghost(e.dtype, g.dictionary, g.stats)
        if e.dtype is dt.STRING:
            assert isinstance(u, Literal), \
                "a device-only string expression is a reference or literal"
            return _Ghost(dt.STRING, np.array(
                [] if u.value is None else [u.value], dtype=object))
        return _Ghost(e.dtype, None, derive_stats(e, ghosts))

    @staticmethod
    def wrap(outs, ghosts: List[_Ghost], num_rows: int) -> ColumnarBatch:
        cols: List[Column] = []
        for (data, validity), g in zip(outs, ghosts):
            if g.dtype is dt.STRING:
                cols.append(StringColumn(data, g.dictionary, validity))
            else:
                cols.append(Column(g.dtype, data, validity, stats=g.stats))
        return ColumnarBatch(cols, num_rows)


def _apply_join(step: JoinStep, keys: List[ColV], base: List[ColV],
                live: torch.Tensor, prep: PreparedBuild):
    """A probe that finds at most one build row per stream row (its key
    values ``keys``). Dense mode: one gather in the inverse table. Hash
    mode: K3's probe of the stream hashes, then the exact key check.
    -> (the base columns, the build's appended unless semi or anti; the
    live mask)."""
    u = prep.build
    n = live.shape[0]
    b_rows = u.h_sorted.shape[0]
    if u.table is not None:
        sc = keys[0]
        span = u.table.shape[0]
        pos = sc.data.to(torch.int64) - u.dense_lo
        idx = u.table[pos.clamp(0, span - 1)]
        found = (pos >= 0) & (pos < span) & (idx >= 0)
        if sc.validity is not None:
            found &= sc.validity
        lo_c = idx.clamp(0, b_rows - 1).to(torch.int64)
    elif u.n_valid == 0:  # an empty build, or one of null keys only
        found = torch.zeros(n, dtype=torch.bool, device=live.device)
        lo_c = torch.zeros(n, dtype=torch.int64, device=live.device)
    else:
        h_p = join_ops.hash_keys([(c.data, c.validity) for c in keys],
                                 [c.dtype for c in keys], step.key_common,
                                 _PROBE_NULL)
        lo, _cnt = kjoin.probe(u.ptable, h_p)
        lo_c = lo.clamp(0, b_rows - 1).to(torch.int64)
        found = (u.h_sorted[lo_c] == h_p) & (lo < u.n_valid)
        for sc, bo, ct in zip(keys, step.build_keys, step.key_common):
            sd = sc.data if sc.dtype is ct else sc.data.to(ct.torch_dtype)
            bd = u.datas[bo][lo_c]
            if step.build_types[bo] is not ct:
                bd = bd.to(ct.torch_dtype)
            bv = u.vals[bo]
            s_comps, s_valid = sortkeys.equality_parts(sd, sc.validity, ct)
            b_comps, b_valid = sortkeys.equality_parts(
                bd, None if bv is None else bv[lo_c], ct)
            found &= s_valid & b_valid
            for a, b in zip(s_comps, b_comps):
                found &= a == b
    if step.kind == "left_semi":
        return base, live & found
    if step.kind == "left_anti":
        return base, live & ~found
    out = list(base)
    for bd, bv, bt, g in zip(u.datas, u.vals, step.build_types,
                             prep.ghosts):
        if b_rows == 0:
            gd = torch.zeros(n, dtype=bd.dtype, device=live.device)
            gv = torch.zeros(n, dtype=torch.bool, device=live.device)
        else:
            gd = bd[lo_c]
            gv = None if bv is None else bv[lo_c]
        if step.kind == "left":
            gv = found if gv is None else gv & found
        out.append(ColV(bt, gd, gv, StringColumn(gd, g.dictionary, gv)
                        if bt is dt.STRING else None))
    return out, (live & found) if step.kind == "inner" else live


# ---------------------------------------------------------------------------
# execs
# ---------------------------------------------------------------------------


def _build_key_specs(steps) -> list:
    """(build keys, build types, comparison types) per join step, in
    build-index order."""
    js = sorted((s for s in steps if isinstance(s, JoinStep)),
                key=lambda s: s.build_index)
    return [(tuple(s.build_keys), tuple(s.build_types),
             tuple(s.key_common)) for s in js]


class _FusedMixin:
    """Build preparation and the fallback shared by both fused execs."""

    def _init_fused(self, chain: FusedChain, join_execs: List[TorchExec],
                    fallback: TorchExec, span_max: int, device):
        self.chain = chain
        self.join_execs = join_execs  # their builds, in build-index order
        self.fallback = fallback
        self.span_max = span_max  # the widest build key span probed dense
        self.device = device
        self.build_key_specs = _build_key_specs(chain.steps)
        self._preps: Optional[List[PreparedBuild]] = None
        self._preps_ok: Optional[bool] = None

    def _ensure_preps(self) -> bool:
        """Prepare every build; False (and the unfused subtree runs) when
        one has a repeated key hash."""
        if self._preps_ok is None:
            preps = [prepare_build(j, keys, types, commons, self.span_max)
                     for j, (keys, types, commons) in zip(
                         self.join_execs, self.build_key_specs)]
            ok = all(p.ok for p in preps)
            self._preps = preps if ok else None
            self._preps_ok = ok
        return self._preps_ok

    @property
    def builds(self) -> List[TorchExec]:
        """The build subtrees the chain probes."""
        return [j.children[1] for j in self.join_execs]

    @property
    def join_modes(self) -> List[str]:
        """'dense', 'hash' or 'empty' per build, once prepared."""
        return [p.mode for p in self._preps or ()]

    @property
    def fell_back(self) -> bool:
        return self._preps_ok is False

    def _tree(self, indent: int, note: str) -> str:
        """The unfused subtree is what ran when the fallback did."""
        label = "  " * indent + type(self).__name__ + " " + note
        if self.fell_back:
            label += " [FELL BACK: duplicate build key hashes]"
            return "\n".join([label, tree_string(self.fallback,
                                                 indent + 1)])
        return "\n".join([label] + [tree_string(c, indent + 1)
                                    for c in self.children])


class FusedChainExec(_FusedMixin, TorchExec):
    """A standalone chain: compacted once at its end (K1), or sorted
    when it ends in the ORDER BY of a single-batch aggregate."""

    def __init__(self, source: TorchExec, chain: FusedChain,
                 join_execs: List[TorchExec], schema: Schema,
                 fallback: TorchExec, span_max: int, device):
        TorchExec.__init__(self, [source], schema)
        self._init_fused(chain, join_execs, fallback, span_max, device)

    def execute(self) -> Iterator[ColumnarBatch]:
        if not self._ensure_preps():
            yield from self.fallback.execute()
            return
        saw = False
        has_sort = any(isinstance(s, SortStep) for s in self.chain.steps)
        for b in self.children[0].execute():
            if b.num_rows == 0 and saw:
                continue
            if saw and has_sort:
                raise RuntimeError("a sort tail chain fed more than one "
                                   "batch (its source must be an "
                                   "aggregate)")
            saw = True
            outs, n, ghosts = self.chain.run(b, self._preps, True,
                                             self.device)
            yield self.chain.wrap(outs, ghosts, n)

    def tree_string(self, indent: int = 0) -> str:
        return self._tree(indent, f"[{len(self.chain.steps)} fused steps]")


class FusedAggregateExec(_FusedMixin, agg_exec.HashAggregateExec):
    """A hash aggregate whose update side is a chain: per batch the
    chain gives the projected inputs and a live mask, which the group-by
    takes as it is (no compaction)."""

    def __init__(self, grouping, aggs, schema, source: TorchExec,
                 steps: List, join_execs: List[TorchExec],
                 fallback: agg_exec.HashAggregateExec, span_max: int,
                 device):
        agg_exec.HashAggregateExec.__init__(self, grouping, aggs, source,
                                            schema, device)
        steps = list(steps)
        # the input projection joins the chain when every expression can;
        # otherwise it runs after the chain, row-aligned with the mask
        inputs = _unfolded(fallback, "input_exprs")
        self._proj_in_chain = all(chain_traceable(e) for e in inputs)
        if self._proj_in_chain:
            steps.append(make_project_step(inputs))
        self._init_fused(FusedChain(steps, list(source.schema.types)),
                         join_execs, fallback, span_max, device)

    def _update_inputs(self, b: ColumnarBatch):
        outs, live, ghosts = self.chain.run(b, self._preps, False,
                                            self.device)
        out = self.chain.wrap(outs, ghosts, b.num_rows)
        if not self._proj_in_chain:
            out = basic.project(out, self.input_exprs, self.device)
        return out, live

    def execute(self) -> Iterator[ColumnarBatch]:
        if not self._ensure_preps():
            yield from self.fallback.execute()
            return
        yield from agg_exec.HashAggregateExec.execute(self)

    def tree_string(self, indent: int = 0) -> str:
        return self._tree(indent, f"[{len(self.chain.steps)} fused steps, "
                                  "complete]")


def tree_string(exec_: TorchExec, indent: int = 0) -> str:
    """The exec tree, one exec a line (a fused exec shows its step count
    and, when it fell back, the unfused subtree that ran)."""
    own = getattr(exec_, "tree_string", None)
    if own is not None:
        return own(indent)
    return "\n".join(["  " * indent + type(exec_).__name__] +
                     [tree_string(c, indent + 1) for c in exec_.children])


def fused_nodes(root: TorchExec) -> List[TorchExec]:
    """Every fused exec of the tree, its builds' subtrees included, in
    pre-order (a shared subtree once)."""
    out, seen, stack = [], set(), [root]
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        if isinstance(n, _FusedMixin):
            out.append(n)
        kids = list(n.children)
        if isinstance(n, _FusedMixin):
            kids += list(n.builds)
        stack.extend(reversed(kids))
    return out


def fusion_summary(root: TorchExec) -> dict:
    """Counts of fused execs, fallbacks and chain-join modes, for an exec
    tree that has run."""
    nodes = fused_nodes(root)
    modes = [m for n in nodes for m in n.join_modes]
    return {"chains": sum(isinstance(n, FusedChainExec) for n in nodes),
            "aggregates": sum(isinstance(n, FusedAggregateExec)
                              for n in nodes),
            "fell_back": sum(n.fell_back for n in nodes),
            "dense_joins": modes.count("dense"),
            "hash_joins": modes.count("hash"),
            "empty_joins": modes.count("empty")}


# ---------------------------------------------------------------------------
# planner pass
# ---------------------------------------------------------------------------

_FUSABLE_JOIN_KINDS = ("inner", "left", "left_semi", "left_anti")


def _fusable_join(node: TorchExec) -> bool:
    if type(node) is not joins.BroadcastHashJoinExec:
        return False
    if node.kind not in _FUSABLE_JOIN_KINDS:
        return False
    if node.condition is not None and not (
            node.kind == "inner" and node.condition.device_only and
            node.condition.deterministic):
        return False
    stream_types = node.children[0].schema.types
    build_types = node.children[1].schema.types
    for so, bo in zip(node.left_keys, node.right_keys):
        c = join_ops.common_key_type(stream_types[so], build_types[bo])
        if c is None or c is dt.STRING:
            return False
    return True


def _unfolded(exec_: TorchExec, attr: str):
    """An exec's expressions as planned, before ``fold`` (which the chain
    applies to its compositions): ``plan.overrides`` keeps them as
    ``unfolded``."""
    return getattr(exec_, "unfolded", {}).get(attr, getattr(exec_, attr))


def _extract(node: TorchExec):
    """Walk down a maximal fusable chain: (steps bottom up, source, the
    join execs in build-index order, every exec walked) or None."""
    steps: List = []
    join_execs: List[TorchExec] = []
    walked: List[TorchExec] = []
    cur = node
    while True:
        if type(cur) is basic.FilterExec and \
                chain_traceable(_unfolded(cur, "condition")):
            steps.append(make_filter_step(_unfolded(cur, "condition")))
        elif type(cur) is basic.ProjectExec and \
                all(chain_traceable(e) for e in _unfolded(cur, "exprs")):
            steps.append(make_project_step(_unfolded(cur, "exprs")))
        elif _fusable_join(cur):
            if cur.condition is not None:
                steps.append(make_filter_step(_unfolded(cur, "condition")))
            stream_types = cur.children[0].schema.types
            build_types = list(cur.children[1].schema.types)
            commons = [join_ops.common_key_type(stream_types[so],
                                                build_types[bo])
                       for so, bo in zip(cur.left_keys, cur.right_keys)]
            steps.append(JoinStep(cur.kind, list(cur.left_keys),
                                  list(cur.right_keys), len(join_execs),
                                  build_types, commons))
            join_execs.append(cur)
        else:
            break
        walked.append(cur)
        cur = cur.children[0]
    if not steps:
        return None
    steps.reverse()
    return steps, cur, join_execs, walked


def _counts(steps) -> Tuple[int, int, int]:
    return (sum(isinstance(s, FilterStep) for s in steps),
            sum(isinstance(s, ProjectStep) for s in steps),
            sum(isinstance(s, JoinStep) for s in steps))


@dataclasses.dataclass
class _Pass:
    """One run of the fusion pass: its settings, the execs already
    fused, and the execs with more than one parent."""

    span_max: int
    sort_tail: bool
    memo: dict
    shared: set


def fuse_pipelines(root: TorchExec, span_max: int = 1 << 22,
                   sort_tail: bool = True) -> TorchExec:
    """The fusion pass over a converted tree: chains under aggregates
    become ``FusedAggregateExec``, an ORDER BY over an aggregate joins
    the chain above it (``sort_tail``), other chains become
    ``FusedChainExec``; a chain join probes a dense table when its build
    keys span at most ``span_max`` values. Memoized by exec, so a shared
    subtree stays shared; what changes a source's output
    (``defer_final``) applies only to a source with one parent."""
    return _fuse_node(root, _Pass(span_max, sort_tail, {},
                                  _multi_parent_ids(root)))


def _multi_parent_ids(root: TorchExec) -> set:
    counts: dict = {}
    seen: set = set()
    stack = [root]
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        for c in n.children:
            counts[id(c)] = counts.get(id(c), 0) + 1
            stack.append(c)
    return {i for i, c in counts.items() if c > 1}


def _absorb_final(steps, fused_src):
    """Pull an aggregate source's final projection into the chain above
    it: the aggregate then yields raw (keys..., partials...). Only for a
    chain without joins (a join chain may fall back to its subtree,
    which must see the aggregate's finished output). -> (steps, source
    types or None)."""
    if any(isinstance(s, JoinStep) for s in steps):
        return steps, None
    if not isinstance(fused_src, agg_exec.HashAggregateExec) or \
            fused_src.defer_final:
        return steps, None
    exprs = fused_src.final_exprs
    if not all(chain_traceable(e) for e in exprs):
        return steps, None
    fused_src.defer_final = True
    fb = getattr(fused_src, "fallback", None)
    if isinstance(fb, agg_exec.HashAggregateExec):
        fb.defer_final = True  # it would feed the same chain
    return [make_project_step(exprs)] + list(steps), \
        [e.dtype for e in fused_src.grouping] + fused_src.partial_types


def _fuse_builds(join_execs, p: _Pass) -> None:
    """Each join's build subtree fused in place: the chain probes the
    join's build, and the join is the chain's fallback."""
    for j in join_execs:
        j.children[1] = _fuse_node(j.children[1], p)


def _fuse_sort_tail(node: SortExec, p: _Pass):
    """Sort(Project(Filter(Agg))) as one chain ending in the sort, over
    the aggregate's raw partials."""
    ch = _extract(node.children[0])
    steps, source, join_execs, walked = ch if ch \
        else ([], node.children[0], [], [])
    if id(source) in p.shared:
        return None
    new_source = _fuse_node(source, p)
    if not isinstance(new_source, agg_exec.HashAggregateExec):
        return None
    src_types = None
    if not any(id(w) in p.shared for w in walked):
        steps, src_types = _absorb_final(steps, new_source)
    steps = list(steps) + [SortStep(tuple(node.specs))]
    _fuse_builds(join_execs, p)
    chain = FusedChain(steps, src_types or list(new_source.schema.types))
    return FusedChainExec(new_source, chain, join_execs, node.schema,
                          fallback=node, span_max=p.span_max,
                          device=node.device)


def _fuse_node(node: TorchExec, p: _Pass) -> TorchExec:
    hit = p.memo.get(id(node))
    if hit is not None:
        return hit[1]
    out = None
    if type(node) is agg_exec.HashAggregateExec:
        ch = _extract(node.children[0])
        if ch is not None:
            steps, source, join_execs, _walked = ch
            new_source = _fuse_node(source, p)
            _fuse_builds(join_execs, p)
            out = FusedAggregateExec(node.grouping, node.aggs, node.schema,
                                     new_source, steps, join_execs,
                                     fallback=node, span_max=p.span_max,
                                     device=node.device)
    if out is None and type(node) is SortExec and node.specs and \
            p.sort_tail:
        out = _fuse_sort_tail(node, p)
    if out is None:
        ch = _extract(node)
        if ch is not None:
            steps, source, join_execs, walked = ch
            nf, np_, nj = _counts(steps)
            # the reference's cost rule: a filter saves ~2 dispatches, a
            # projection 1, a join ~6, the chain costs 1; so a lone
            # projection stays as it is
            if 2 * nf + np_ + 6 * nj - 1 >= 1:
                new_source = _fuse_node(source, p)
                src_types = None
                if id(source) not in p.shared and \
                        not any(id(w) in p.shared for w in walked):
                    steps, src_types = _absorb_final(steps, new_source)
                _fuse_builds(join_execs, p)
                chain = FusedChain(
                    steps, src_types or list(new_source.schema.types))
                out = FusedChainExec(new_source, chain, join_execs,
                                     node.schema, fallback=node,
                                     span_max=p.span_max,
                                     device=node.device)
    if out is None:
        node.children = [_fuse_node(c, p) for c in node.children]
        out = node
    p.memo[id(node)] = (node, out)
    return out
