"""Rewrite substrate for `FheTrace` transforms.

Passes (repro.compiler.passes) never mutate a trace in place. They walk
the op list, collect a value substitution (old SSA idx -> replacement
idx) and/or emit new ops, then funnel through `finish()`, which resolves
substitution chains, renumbers densely, and prunes everything not
reachable from the outputs. That single funnel keeps every pass output
canonical: args always precede uses, ids are dense, and dead code never
survives a rewrite (so per-pass cost accounting in the manager compares
like with like).

Derived plaintext constants ("const expressions") are how passes fold or
pre-rotate named constants without access to their values: an op's
``meta["cexpr"]`` is a nested tuple over base names —

    ("ref", name)          the named constant itself
    ("mul", a, b)          elementwise product of two expressions
    ("add", a, b)          elementwise sum
    ("rot", a, step)       slots rotated by `step` (same convention as
                           TraceVar.rotate: out[i] = in[i + step])

The interpreter (repro.compiler.interp) resolves these against the base
const bindings at execution time; the cost model sees them as ordinary
plaintext constants (same footprint as any other diag/mask).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.trace import FheOp, FheTrace

CExpr = Tuple  # ("ref", name) | ("mul", a, b) | ("add", a, b) | ("rot", a, k)


def const_expr(op: FheOp) -> CExpr:
    """The const expression an op multiplies/adds with (pmul/padd only)."""
    return op.meta.get("cexpr", ("ref", op.meta["const"]))


def cexpr_name(e: CExpr) -> str:
    """Compact human/fingerprint-stable name for a const expression."""
    tag = e[0]
    if tag == "ref":
        return e[1]
    if tag == "rot":
        return f"{cexpr_name(e[1])}@r{e[2]}"
    sym = "*" if tag == "mul" else "+"
    return f"({cexpr_name(e[1])}{sym}{cexpr_name(e[2])})"


def clone_ops(trace: FheTrace) -> List[FheOp]:
    return [FheOp(o.idx, o.kind, tuple(o.args), dict(o.meta), o.level)
            for o in trace.ops]


def use_counts(trace: FheTrace) -> Dict[int, int]:
    """References per value: arg uses plus one per appearance in outputs."""
    uses = {o.idx: 0 for o in trace.ops}
    for o in trace.ops:
        for a in o.args:
            uses[a] += 1
    for out in trace.outputs:
        uses[out] += 1
    return uses


def consumers(trace: FheTrace) -> Dict[int, List[int]]:
    cons: Dict[int, List[int]] = {o.idx: [] for o in trace.ops}
    for o in trace.ops:
        for a in o.args:
            cons[a].append(o.idx)
    return cons


def _resolve(subst: Dict[int, int], i: int) -> int:
    """Follow substitution chains (a->b, b->c  =>  a->c)."""
    seen = []
    while i in subst:
        seen.append(i)
        i = subst[i]
    for s in seen:           # path compression
        subst[s] = i
    return i


def finish(ops: Sequence[FheOp], inputs: Iterable[int],
           outputs: Iterable[int],
           subst: Optional[Dict[int, int]] = None) -> FheTrace:
    """Canonicalize a rewritten op list into a fresh FheTrace.

    `ops` is any program-ordered list whose args refer to `idx` values of
    earlier entries (ids need not be dense — rewrites mint fresh ids past
    the old maximum). Applies `subst`, prunes ops unreachable from the
    (substituted) outputs — inputs are always kept, the executor feeds
    them positionally — and renumbers densely.
    """
    subst = dict(subst or {})
    by_id = {o.idx: o for o in ops}
    out_ids = [_resolve(subst, i) for i in outputs]
    in_ids = [_resolve(subst, i) for i in inputs]
    live = set(in_ids)
    stack = list(out_ids)
    while stack:
        i = stack.pop()
        if i in live:
            continue
        live.add(i)
        stack.extend(_resolve(subst, a) for a in by_id[i].args)
    new_ops: List[FheOp] = []
    remap: Dict[int, int] = {}
    for o in ops:
        if o.idx not in live or o.idx in remap:
            continue
        args = tuple(remap[_resolve(subst, a)] for a in o.args)
        remap[o.idx] = len(new_ops)
        new_ops.append(FheOp(len(new_ops), o.kind, args, dict(o.meta),
                             o.level))
    return FheTrace(ops=new_ops,
                    inputs=[remap[i] for i in in_ids],
                    outputs=[remap[i] for i in out_ids],
                    consts=[o.idx for o in new_ops if o.kind == "const"])


class Emitter:
    """Mints fresh ops with ids past a trace's maximum, for passes that
    insert code (BSGS, lazy rescale, bootstrap insertion)."""

    def __init__(self, start_id: int):
        self._next = start_id

    def op(self, kind: str, args: Tuple[int, ...] = (), **meta) -> FheOp:
        o = FheOp(self._next, kind, args, meta)
        self._next += 1
        return o


def flatten_add_tree(trace: FheTrace, uses: Dict[int, int],
                     root: int) -> List[int]:
    """Leaves of the maximal hadd tree rooted at `root`: interior hadd
    nodes are expanded only while they have a single consumer (a shared
    partial sum is an opaque leaf — it must keep existing)."""
    ops = trace.ops
    terms: List[int] = []
    stack = [root]
    while stack:
        i = stack.pop()
        if ops[i].kind == "hadd" and (i == root or uses[i] == 1):
            stack.extend(ops[i].args)
        else:
            terms.append(i)
    return terms


def add_tree_roots(trace: FheTrace, uses: Dict[int, int]) -> List[int]:
    """hadd nodes that head a maximal tree: not themselves absorbed into
    a single-consumer parent hadd."""
    cons = consumers(trace)
    roots = []
    for o in trace.ops:
        if o.kind != "hadd":
            continue
        cs = cons[o.idx]
        absorbed = (uses[o.idx] == 1 and len(cs) == 1
                    and trace.ops[cs[0]].kind == "hadd")
        if not absorbed:
            roots.append(o.idx)
    return roots
