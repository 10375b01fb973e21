"""Optimizing passes over the SSA `FheTrace` IR (paper §IV-F's
"optimized end-to-end processing flow", realized as a compiler).

Classic cleanups (DCE / CSE / plaintext constant folding) plus the
FHE-specific transforms that decide end-to-end cost on a memory-bound
accelerator:

* RotationOpt — rotation reuse: compose nested rotations, drop identity
  rotations, and factor large "sum of pmul(rotate(x, s), diag_s)"
  add-trees baby-step/giant-step so n rotations (each a full ModUp/evk/
  ModDown key switch) become ~2*sqrt(n). The homomorphic identity is the
  same one `core/linalg.matvec_bsgs` uses at the ciphertext layer:
  pmul(rot(x, b+q), c) == rot(pmul(rot(x, b), rot(c, -q)), q), with the
  diagonal pre-rotation folded into a derived const expression.
* LazyRescale — EVA-style waterline: products feeding a sum keep their
  double-width scale (``meta["lazy"]``) and the whole sum is rescaled
  once, replacing n rescales (each 2(l+1) NTT passes) with one.
* BootstrapInsertion — a trace that exhausts its level budget is
  rewritten, not rejected: catch `LevelBudgetExhausted`, place a
  `bootstrap` op on the deepest operand of the failing op, repeat. The
  as-late-as-possible cut point maximizes levels consumed per refresh,
  which minimizes the number of bootstraps for any straight-line chain.

Every pass is functional (fresh trace out) and funnels through
`ir.finish`, so outputs are canonical and never carry dead code. The
manager (repro.compiler.manager) re-costs the trace after each pass and
reverts any non-exempt pass that fails the never-more-expensive check.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Tuple

from repro_torch.core.params import CkksParams
from repro_torch.core.trace import (FheOp, FheTrace, LevelBudgetExhausted,
                              infer_levels)
from repro_torch.compiler.ir import (Emitter, add_tree_roots, cexpr_name,
                               clone_ops, const_expr, finish,
                               flatten_add_tree, use_counts)

_COMMUTATIVE = ("hadd", "hmul")


class Pass:
    name = "?"
    # set on passes allowed to grow OpCost totals (only bootstrap
    # insertion: it buys *feasibility*, not speed)
    may_increase_cost = False

    def run(self, trace: FheTrace, params: CkksParams,
            config) -> FheTrace:
        raise NotImplementedError


class DeadCodeElimination(Pass):
    """Drop ops unreachable from the outputs (inputs always survive)."""
    name = "dce"

    def run(self, trace, params, config):
        return finish(clone_ops(trace), trace.inputs, trace.outputs)


class CommonSubexpr(Pass):
    """Value-number ops on (kind, canonical args, meta); later duplicates
    collapse onto the first occurrence. hadd/hmul are commutative, so
    their args are order-normalized — and because every op here is pure,
    merging is always sound. The headline win is rotation reuse: two
    `rotate(x, k)` of the same source share one key switch."""
    name = "cse"

    def run(self, trace, params, config):
        subst: Dict[int, int] = {}
        table: Dict[Tuple, int] = {}
        for op in trace.ops:
            if op.kind in ("input", "const"):
                continue
            args = tuple(subst.get(a, a) for a in op.args)
            if op.kind in _COMMUTATIVE:
                args = tuple(sorted(args))
            key = (op.kind, args,
                   tuple(sorted((k, repr(v)) for k, v in op.meta.items())))
            if key in table:
                subst[op.idx] = table[key]
            else:
                table[key] = op.idx
        return finish(clone_ops(trace), trace.inputs, trace.outputs, subst)


class ConstantFold(Pass):
    """Fold chained plaintext ops into one derived constant:
    pmul(pmul(x, a), b) -> pmul(x, a*b) and padd(padd(x, a), b) ->
    padd(x, a+b) whenever the inner op has no other consumer. Each fold
    deletes a whole plaintext op (for pmul: including its rescale) and
    returns a level to the budget."""
    name = "fold"

    def run(self, trace, params, config):
        uses = use_counts(trace)
        ops = clone_ops(trace)
        for op in ops:
            if op.kind not in ("pmul", "padd") or op.meta.get("lazy"):
                continue
            inner = ops[op.args[0]]
            if (inner.kind == op.kind and not inner.meta.get("lazy")
                    and uses[inner.idx] == 1):
                tag = "mul" if op.kind == "pmul" else "add"
                ce = (tag, const_expr(inner), const_expr(op))
                op.args = (inner.args[0],)
                op.meta = {"const": cexpr_name(ce), "cexpr": ce}
        return finish(ops, trace.inputs, trace.outputs)


class RotationOpt(Pass):
    """Rotation reuse/hoisting: (1) compose nested rotations and drop
    identities; (2) baby-step/giant-step factor rotation-sum trees."""
    name = "rotation"

    def run(self, trace, params, config):
        t = self._compose(trace, params)
        return self._bsgs(t, params, config)

    # -- (1) composition ----------------------------------------------------

    def _compose(self, trace, params):
        slots = params.slots
        ops = clone_ops(trace)
        subst: Dict[int, int] = {}
        for op in ops:
            if op.kind != "rotate":
                continue
            op.meta["step"] %= slots
            inner = ops[subst.get(op.args[0], op.args[0])]
            if inner.kind == "rotate":
                # rotate(rotate(x, a), b) == rotate(x, a+b): even when the
                # inner stays live for other uses this is never worse, and
                # it unlocks identity elimination + CSE merges
                op.args = (inner.args[0],)
                op.meta["step"] = (op.meta["step"] + inner.meta["step"]) \
                    % slots
            if op.meta["step"] == 0:
                subst[op.idx] = op.args[0]
        return finish(ops, trace.inputs, trace.outputs, subst)

    # -- (2) baby-step / giant-step -----------------------------------------

    def _bsgs(self, trace, params, config):
        slots = params.slots
        uses = use_counts(trace)
        ops = trace.ops
        plans = {}
        for root in add_tree_roots(trace, uses):
            plan = self._plan(trace, uses, root, slots, config)
            if plan is not None:
                plans[root] = plan
        if not plans:
            return trace
        em = Emitter(len(ops))
        out: List[FheOp] = clone_ops(trace)
        new_list: List[FheOp] = []
        subst: Dict[int, int] = {}
        for op in out:
            new_list.append(op)
            if op.idx in plans:
                self._emit(new_list, em, subst, op.idx, plans[op.idx],
                           trace)
        return finish(new_list, trace.inputs, trace.outputs, subst)

    def _plan(self, trace, uses, root, slots, config):
        """A tree qualifies when >= bsgs_min_terms single-use
        pmul(rotate(x, s), const) leaves share one source x with distinct
        steps, and the BSGS factoring strictly reduces rotation count."""
        ops = trace.ops
        terms = flatten_add_tree(trace, uses, root)
        cands, others = [], []
        for t in terms:
            o = ops[t]
            if (o.kind == "pmul" and not o.meta.get("lazy")
                    and uses[t] == 1 and "const" in o.meta):
                a = ops[o.args[0]]
                if a.kind == "rotate" and uses[a.idx] == 1:
                    cands.append((a.meta["step"] % slots, a.args[0], t))
                    continue
                cands.append((0, o.args[0], t))
                continue
            others.append(t)
        if not cands:
            return None
        base, _ = Counter(b for _, b, _ in cands).most_common(1)[0]
        chosen, seen = [], set()
        for s, b, t in cands:
            if b == base and s not in seen:
                seen.add(s)
                chosen.append((s, t))
            else:
                others.append(t)
        if len(chosen) < config.bsgs_min_terms:
            return None
        g = max(1, int(round(math.sqrt(len(chosen)))))
        babies = {s % g for s, _ in chosen}
        giants = {s - s % g for s, _ in chosen}
        n_old = sum(1 for s, _ in chosen if s != 0)
        n_new = len(babies - {0}) + len(giants - {0})
        if n_new >= n_old:
            return None
        return base, g, chosen, others

    def _emit(self, out, em, subst, root, plan, trace):
        base, g, chosen, others = plan

        def push(kind, args, **meta):
            o = em.op(kind, tuple(args), **meta)
            out.append(o)
            return o.idx

        baby = {}
        for b in sorted({s % g for s, _ in chosen}):
            baby[b] = base if b == 0 else push("rotate", (base,), step=b)
        total = None
        for q in sorted({s - s % g for s, _ in chosen}):
            inner = None
            for s, t in sorted(chosen):
                if s - s % g != q:
                    continue
                ce = const_expr(trace.ops[t])
                if q:
                    # pmul(rot(x, b+q), c) == rot(pmul(rot(x, b),
                    # rot(c, -q)), q): pre-rotate the diagonal so the
                    # giant rotation re-aligns it
                    ce = ("rot", ce, -q)
                m = push("pmul", (baby[s % g],), const=cexpr_name(ce),
                         cexpr=ce)
                inner = m if inner is None else push("hadd", (inner, m))
            if q:
                inner = push("rotate", (inner,), step=q)
            total = inner if total is None else push("hadd", (total, inner))
        for t in others:
            total = push("hadd", (total, t))
        subst[root] = total


class LazyRescale(Pass):
    """Defer rescales past adds (EVA-style waterline): when an add-tree
    sums >= 2 single-use eager products at one common level, mark the
    products ``lazy`` (they keep their double-width scale), sum first,
    and rescale the sum once. Non-product leaves are re-added after the
    rescale — they live at single-width scale and must never meet the
    lazy partials. Needs levels, so it runs after bootstrap insertion."""
    name = "lazy_rescale"

    def run(self, trace, params, config):
        try:
            self._ensure_levels(trace, params, config)
        except LevelBudgetExhausted:
            return trace     # infeasible without bootstrap insertion
        uses = use_counts(trace)
        ops = trace.ops
        plans = {}
        for root in add_tree_roots(trace, uses):
            terms = flatten_add_tree(trace, uses, root)
            elig = [t for t in terms
                    if ops[t].kind in ("pmul", "hmul")
                    and not ops[t].meta.get("lazy") and uses[t] == 1]
            others = [t for t in terms if t not in elig]
            if not elig:
                continue
            # one uniform level per lazy group keeps the deferred scales
            # structurally identical (same rescale path)
            lv, n = Counter(ops[t].level for t in elig).most_common(1)[0]
            if n < 2:
                continue
            others += [t for t in elig if ops[t].level != lv]
            plans[root] = ([t for t in elig if ops[t].level == lv], others)
        if not plans:
            return trace
        em = Emitter(len(ops))
        out = clone_ops(trace)
        lazied = {t for group, _ in plans.values() for t in group}
        for t in lazied:
            out[t].meta["lazy"] = True
        new_list: List[FheOp] = []
        subst: Dict[int, int] = {}
        for op in out:
            new_list.append(op)
            if op.idx in plans:
                group, others = plans[op.idx]
                acc = group[0]
                for t in group[1:]:
                    o = em.op("hadd", (acc, t))
                    new_list.append(o)
                    acc = o.idx
                r = em.op("rescale", (acc,))
                new_list.append(r)
                acc = r.idx
                for t in others:
                    o = em.op("hadd", (acc, t))
                    new_list.append(o)
                    acc = o.idx
                subst[op.idx] = acc
        return finish(new_list, trace.inputs, trace.outputs, subst)

    @staticmethod
    def _ensure_levels(trace, params, config):
        start = config.resolve_start_level(trace, params)
        infer_levels(trace, start, config.bootstrap_to)


class BootstrapInsertion(Pass):
    """Turn `LevelBudgetExhausted` into placed `bootstrap` ops. On each
    failure, the deepest (minimum-level) operand of the failing op is
    refreshed immediately before it — the latest legal cut point, which
    consumes the whole remaining budget per refresh and therefore needs
    the fewest refreshes. Uses from *before* the cut keep the original
    value (their levels were already proven feasible); every use at or
    after the cut reads the refreshed one."""
    name = "bootstrap"
    may_increase_cost = True

    def run(self, trace, params, config):
        start = config.resolve_start_level(trace, params)
        boot_to = config.bootstrap_to if config.bootstrap_to is not None \
            else start
        t = trace
        last_fixed = None
        for _ in range(len(trace.ops) + 8):
            try:
                infer_levels(t, start, config.bootstrap_to)
                return t
            except LevelBudgetExhausted as e:
                fail = t.ops[e.op_index]
                args_lv = [(t.ops[a].level, a) for a in fail.args]
                _, arg = min(args_lv)
                if t.ops[arg].kind == "bootstrap" or boot_to < 1:
                    raise LevelBudgetExhausted(e.op_index, e.kind, e.level)
                if (e.op_index, arg) == last_fixed:
                    raise LevelBudgetExhausted(e.op_index, e.kind, e.level)
                last_fixed = (e.op_index, arg)
                t = self._insert(t, fail.idx, arg)
        raise LevelBudgetExhausted(-1, "bootstrap", -1)

    @staticmethod
    def _insert(trace, at, arg):
        em = Emitter(len(trace.ops))
        boot = em.op("bootstrap", (arg,))
        new_list: List[FheOp] = []
        for op in clone_ops(trace):
            if op.idx == at:
                new_list.append(boot)
            if op.idx >= at:
                op.args = tuple(boot.idx if a == arg else a
                                for a in op.args)
            new_list.append(op)
        return finish(new_list, trace.inputs, trace.outputs)


PASS_ORDER: Tuple[Pass, ...] = (
    DeadCodeElimination(), ConstantFold(), RotationOpt(), CommonSubexpr(),
    BootstrapInsertion(), LazyRescale(),
)
