"""Static trace-IR verifier: structural SSA checks plus level/scale
inference, with no ciphertext math.

The structural rules (def-before-use, dense indices, known kinds and
arities, interface lists) make the IR safe for the dict-free
index-walk style every pass and mapper uses. The semantic rules rerun
`core.trace.infer_levels`' level rules *without raising*, so a trace
that would die with `LevelBudgetExhausted` at runtime is reported as
a `T-BUDGET` finding naming the earliest failing op and the
latest-legal bootstrap cut — the same cut `BootstrapInsertion`
(repro_torch.compiler.passes) would pick: the deepest (minimum-level)
operand of the failing op. The scale-width rules enforce the lazy-
rescale discipline DESIGN.md §7 states informally: lazy products
carry double-width scale and must never meet single-width values in
an add, and no chain may exceed double width before a rescale.
"""
from __future__ import annotations

import time
from typing import Optional, Set

from repro_torch.analysis.findings import Report
from repro_torch.core.trace import FheOp, FheTrace

# operand counts per kind (None = structural source, no operands)
ARITY = {
    "input": 0, "const": 0,
    "hmul": 2, "hadd": 2, "hsub": 2,
    "pmul": 1, "padd": 1,
    "rotate": 1, "conjugate": 1, "rescale": 1, "bootstrap": 1,
}

# meta keys a kind cannot function without; pmul/padd accept either a
# plain const binding or a derived constant expression (compiler/ir.py)
_REQUIRED_META = {
    "rotate": (("step",),),
    "pmul": (("const", "cexpr"),),
    "padd": (("const", "cexpr"),),
}


def _op_locus(i: int, op: FheOp) -> str:
    return f"op {i} ({op.kind})"


def _structural(rep: Report, trace: FheTrace) -> bool:
    """Rules T-INDEX/T-KIND/T-ARITY/T-META/T-DEF-USE/T-IFACE. Returns
    True when the trace is sound enough for semantic inference.

    Single pass over the ops (this runs once per applied pass under
    `optimize_trace(verify=True)`, so it is the verifier's hot loop):
    source-op positions are collected inline and reconciled against the
    interface lists afterwards with set algebra instead of a rescan."""
    ok = True
    add = rep.add
    arity = ARITY
    req_meta = _REQUIRED_META
    src_pos = {"input": set(), "const": set()}
    for i, op in enumerate(trace.ops):
        kind = op.kind
        if op.idx != i:
            add("T-INDEX", _op_locus(i, op),
                f"op.idx={op.idx} at position {i}",
                "renumber via repro_torch.compiler.ir.finish", op_idx=i)
            ok = False
        want = arity.get(kind)
        if want is None:
            add("T-KIND", _op_locus(i, op),
                f"unknown kind {kind!r}",
                f"known kinds: {', '.join(sorted(arity))}", op_idx=i)
            ok = False
            continue
        if kind in src_pos:
            src_pos[kind].add(i)
        if len(op.args) != want:
            add("T-ARITY", _op_locus(i, op),
                f"{kind} takes {want} operand(s), "
                f"got {len(op.args)}", op_idx=i)
            ok = False
        if kind in req_meta:
            for keysets in req_meta[kind]:
                if not any(k in op.meta for k in keysets):
                    add("T-META", _op_locus(i, op),
                        f"{kind} missing meta "
                        f"{' or '.join(repr(k) for k in keysets)}",
                        op_idx=i)
                    ok = False
        for a in op.args:
            if not (type(a) is int and 0 <= a < i):
                add("T-DEF-USE", _op_locus(i, op),
                    f"operand {a!r} is not an earlier op "
                    f"(positions 0..{i - 1})",
                    "args must reference already-defined values "
                    "(SSA order)", op_idx=i)
                ok = False
    n = len(trace.ops)
    for name, idxs, kind in (("inputs", trace.inputs, "input"),
                             ("consts", trace.consts, "const")):
        declared = set()
        for x in idxs:
            if not isinstance(x, int) or x < 0 or x >= n:
                rep.add("T-IFACE", f"{name} list",
                        f"entry {x!r} out of range [0, {n})")
                ok = False
                continue
            declared.add(x)
            if trace.ops[x].kind != kind:
                rep.add("T-IFACE", _op_locus(x, trace.ops[x]),
                        f"listed in {name} but kind is "
                        f"{trace.ops[x].kind!r}", op_idx=x)
                ok = False
        for i in sorted(src_pos[kind] - declared):
            rep.add("T-IFACE", _op_locus(i, trace.ops[i]),
                    f"{kind} op missing from the {name} list",
                    op_idx=i)
            ok = False
    if not trace.outputs:
        rep.add("T-IFACE", "outputs list", "trace declares no outputs")
        ok = False
    for x in trace.outputs:
        if not isinstance(x, int) or x < 0 or x >= n:
            rep.add("T-IFACE", "outputs list",
                    f"entry {x!r} out of range [0, {n})")
            ok = False
    return ok


def resolve_start_level(trace: FheTrace,
                        start_level: Optional[int]) -> Optional[int]:
    """Same resolution order as PassConfig.resolve_start_level, minus
    the params fallback: explicit argument, else the first annotated
    input. None = levels unknowable, budget checks are skipped."""
    if start_level is not None:
        return start_level
    for i in trace.inputs:
        if 0 <= i < len(trace.ops) and trace.ops[i].level is not None:
            return trace.ops[i].level
    return None


def _levels(rep: Report, trace: FheTrace, start: int,
            bootstrap_to: Optional[int], check_annotations: bool) -> None:
    """Non-raising mirror of core.trace.infer_levels: T-LEVEL on
    annotation drift, T-BUDGET (earliest failure + latest-legal
    bootstrap cut) on exhaustion."""
    # structural rules passed, so idx == position and args are earlier:
    # a dense list beats a dict in this per-op loop
    lv: list = []
    reported_budget = False
    for op in trace.ops:
        kind = op.kind
        if kind in ("input", "const"):
            exp = start
        elif kind in ("hmul", "pmul"):
            base = min(lv[a] for a in op.args)
            exp = base if op.meta.get("lazy") else base - 1
        elif kind in ("hadd", "hsub", "padd"):
            exp = min(lv[a] for a in op.args)
        elif kind in ("rotate", "conjugate"):
            exp = lv[op.args[0]]
        elif kind == "rescale":
            exp = lv[op.args[0]] - 1
        else:  # bootstrap
            exp = bootstrap_to if bootstrap_to is not None else start
        lv.append(exp)
        if exp < 0 and not reported_budget:
            reported_budget = True
            cut_val, cut_lv = None, None
            if op.args:
                cut_lv, cut_val = min((lv[a], a) for a in op.args)
            hint = ("enable the compiler's bootstrap pass, or insert "
                    ".bootstrap() " +
                    (f"on value {cut_val} (level {cut_lv}) — the "
                     f"latest-legal cut" if cut_val is not None
                     else "upstream"))
            rep.add("T-BUDGET", _op_locus(op.idx, op),
                    f"level {exp} < 0 with start level {start}: the "
                    f"program is deeper than the modulus chain",
                    hint, op_idx=op.idx)
        if check_annotations and op.level is not None and op.level != exp:
            rep.add("T-LEVEL", _op_locus(op.idx, op),
                    f"annotated level {op.level}, static inference "
                    f"gives {exp}",
                    "re-run core.trace.infer_levels after rewriting",
                    op_idx=op.idx)


def _scales(rep: Report, trace: FheTrace) -> None:
    """Scale-width discipline (T-SCALE / T-OVERFLOW). Width counts the
    scale's exponent in units of the working scale Δ: fresh values are
    width 1, a lazy product is width 2, an eager product rescales back
    to its operands' width, rescale subtracts one."""
    # dense list, same justification as _levels
    w: list = []
    for op in trace.ops:
        kind = op.kind
        if kind in ("input", "const", "bootstrap"):
            w.append(1)
            continue
        if kind == "hmul":
            prod = w[op.args[0]] + w[op.args[1]]
        elif kind == "pmul":
            prod = w[op.args[0]] + 1
        elif kind in ("hadd", "hsub"):
            wa, wb = w[op.args[0]], w[op.args[1]]
            if wa != wb:
                rep.add("T-SCALE", _op_locus(op.idx, op),
                        f"operands at scale widths {wa} vs {wb}",
                        "rescale the lazy partial (or mark both "
                        "operands lazy) before adding", op_idx=op.idx)
            w.append(wa if wa >= wb else wb)
            continue
        elif kind in ("padd", "rotate", "conjugate"):
            w.append(w[op.args[0]])
            continue
        elif kind == "rescale":
            nw = w[op.args[0]] - 1
            if nw < 1:
                rep.add("T-OVERFLOW", _op_locus(op.idx, op),
                        f"rescale takes scale width "
                        f"{w[op.args[0]]} below the working scale",
                        "drop the redundant rescale", op_idx=op.idx)
                nw = 1
            w.append(nw)
            continue
        else:
            w.append(1)
            continue
        # product kinds land here with their raw tensored width
        if not op.meta.get("lazy"):
            prod -= 1                       # fused rescale
        if prod > 2:
            rep.add("T-OVERFLOW", _op_locus(op.idx, op),
                    f"scale width {prod} > 2: product chain missed a "
                    f"rescale",
                    "insert a rescale (or let the lazy-rescale pass "
                    "place one) before multiplying again",
                    op_idx=op.idx)
            prod = 2                        # clamp: report once per chain
        w.append(prod)


def _liveness(rep: Report, trace: FheTrace) -> None:
    """T-DEAD / T-UNUSED-IN lints via backward reachability."""
    reach: Set[int] = set()
    stack = [x for x in trace.outputs]
    while stack:
        i = stack.pop()
        if i in reach:
            continue
        reach.add(i)
        stack.extend(trace.ops[i].args)
    for op in trace.ops:
        if op.idx in reach:
            continue
        if op.kind == "input":
            rep.add("T-UNUSED-IN", _op_locus(op.idx, op),
                    f"input (slot {op.meta.get('slot')}) never consumed",
                    "drop the input or use it", op_idx=op.idx)
        elif op.kind != "const":
            rep.add("T-DEAD", _op_locus(op.idx, op),
                    "unreachable from the outputs",
                    "run the DCE pass", op_idx=op.idx)


def verify_trace(trace: FheTrace, *, start_level: Optional[int] = None,
                 bootstrap_to: Optional[int] = None,
                 check_budget: bool = True,
                 structural_only: bool = False,
                 subject: str = "") -> Report:
    """Full static verification of one `FheTrace`.

    ``check_budget=False`` skips the level rules (T-LEVEL/T-BUDGET) —
    the right mode for mid-pipeline traces that a later bootstrap pass
    will legalize and whose annotations are stale. ``structural_only``
    additionally skips the scale and liveness sweeps: the cheap mode
    `verify_pass` uses after every applied pass, where those semantic
    properties are re-established by the final full verification
    anyway (they are whole-pipeline invariants, not per-pass ones).
    """
    rep = Report("trace", subject)
    t0 = time.perf_counter()
    if _structural(rep, trace) and not structural_only:
        start = resolve_start_level(trace, start_level)
        if check_budget and start is not None:
            _levels(rep, trace, start, bootstrap_to,
                    check_annotations=True)
        _scales(rep, trace)
        _liveness(rep, trace)
    rep.wall_s = time.perf_counter() - t0
    return rep


__all__ = ["ARITY", "resolve_start_level", "verify_trace"]
