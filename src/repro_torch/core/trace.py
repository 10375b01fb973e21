"""SSA traces of FHE programs — the input IR of the mapping framework (§IV-F).

The paper extracts an operation trace (HMul/HAdd/HRot...) from a real FHE
program in static single-assignment form with loops unrolled. We do the
same by running the user's program on tracer values.

Also provides the per-op cost/footprint model used by the load-save
pipeline mapper and the analytic benchmarks (Fig. 1/15): for each op at a
given level, the number of (i)NTTs, modular multiplications, bytes of
constants (evk / plaintexts) and bytes of live data, derived from the CKKS
parameter set — the same accounting the paper uses to size pipeline stages.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.params import CkksParams


class LevelBudgetExhausted(Exception):
    """A trace consumed more multiplicative depth than the modulus chain
    provides. Carries the failing op so the compiler's bootstrap-insertion
    pass (repro.compiler.passes.BootstrapInsertion) — or user code — can
    catch it and rewrite instead of dying."""

    def __init__(self, op_index: int, kind: str, level: int):
        self.op_index = op_index
        self.kind = kind
        self.level = level
        super().__init__(
            f"level budget exhausted at op {op_index} ({kind}): "
            f"level {level} < 0")


@dataclasses.dataclass
class FheOp:
    idx: int
    kind: str                     # input|const|hmul|hadd|hsub|pmul|padd|
                                  #   rotate|conjugate|rescale|bootstrap
    args: Tuple[int, ...] = ()
    meta: dict = dataclasses.field(default_factory=dict)
    level: Optional[int] = None   # filled by level inference


@dataclasses.dataclass
class FheTrace:
    ops: List[FheOp]
    inputs: List[int]
    outputs: List[int]
    consts: List[int]

    def __len__(self):
        return len(self.ops)

    def compute_ops(self) -> List[FheOp]:
        return [o for o in self.ops if o.kind not in ("input", "const")]


class _Builder:
    def __init__(self):
        self.ops: List[FheOp] = []

    def add(self, kind: str, args=(), **meta) -> int:
        op = FheOp(len(self.ops), kind, tuple(args), meta)
        self.ops.append(op)
        return op.idx


class TraceVar:
    """Tracer standing in for a ciphertext during program capture."""

    def __init__(self, b: _Builder, idx: int):
        self._b = b
        self.idx = idx

    def _bin(self, kind, other):
        assert isinstance(other, TraceVar)
        return TraceVar(self._b, self._b.add(kind, (self.idx, other.idx)))

    def __add__(self, other):
        if isinstance(other, TraceConst):
            return TraceVar(self._b, self._b.add("padd", (self.idx,),
                                                 const=other.name))
        return self._bin("hadd", other)

    def __sub__(self, other):
        return self._bin("hsub", other)

    def __mul__(self, other):
        if isinstance(other, TraceConst):
            return TraceVar(self._b, self._b.add("pmul", (self.idx,),
                                                 const=other.name))
        return self._bin("hmul", other)

    def rotate(self, step: int):
        return TraceVar(self._b, self._b.add("rotate", (self.idx,), step=step))

    def conjugate(self):
        return TraceVar(self._b, self._b.add("conjugate", (self.idx,)))

    def rescale(self):
        return TraceVar(self._b, self._b.add("rescale", (self.idx,)))

    def bootstrap(self):
        return TraceVar(self._b, self._b.add("bootstrap", (self.idx,)))


@dataclasses.dataclass(frozen=True)
class TraceConst:
    """A named plaintext constant (weight diagonal, mask, twiddle...)."""
    name: str


def trace_program(fn: Callable, n_inputs: int,
                  const_names: Sequence[str] = ()) -> FheTrace:
    b = _Builder()
    inputs = [TraceVar(b, b.add("input", (), slot=i)) for i in range(n_inputs)]
    consts = {nm: TraceConst(nm) for nm in const_names}
    out = fn(*inputs, **({"consts": consts} if const_names else {}))
    outs = out if isinstance(out, (list, tuple)) else [out]
    const_ids = [o.idx for o in b.ops if o.kind == "const"]
    return FheTrace(ops=b.ops,
                    inputs=[v.idx for v in inputs],
                    outputs=[v.idx for v in outs],
                    consts=const_ids)


def infer_levels(trace: FheTrace, start_level: int,
                 bootstrap_to: Optional[int] = None) -> None:
    """Annotate each op with the level of its OUTPUT ciphertext.

    hmul/pmul include their rescale (level-1) unless marked
    ``meta["lazy"]`` (the compiler's lazy-rescale pass defers the divide
    to an explicit ``rescale`` op downstream); hadd aligns to min level.

    Raises LevelBudgetExhausted (not a bare assert) when the program is
    deeper than the chain, so bootstrap insertion can catch and rewrite.
    """
    lv: Dict[int, int] = {}
    for op in trace.ops:
        if op.kind in ("input", "const"):
            lv[op.idx] = start_level
        elif op.kind in ("hmul", "pmul"):
            base = min(lv[a] for a in op.args)
            lv[op.idx] = base if op.meta.get("lazy") else base - 1
        elif op.kind in ("hadd", "hsub", "padd"):
            lv[op.idx] = min(lv[a] for a in op.args)
        elif op.kind in ("rotate", "conjugate"):
            lv[op.idx] = lv[op.args[0]]
        elif op.kind == "rescale":
            lv[op.idx] = lv[op.args[0]] - 1
        elif op.kind == "bootstrap":
            lv[op.idx] = (bootstrap_to if bootstrap_to is not None
                          else start_level)
        else:
            raise ValueError(op.kind)
        op.level = lv[op.idx]
        if op.level < 0:
            raise LevelBudgetExhausted(op.idx, op.kind, op.level)


# ---------------------------------------------------------------------------
# per-op cost / footprint model
# ---------------------------------------------------------------------------

WORD = 8  # bytes per coefficient word (u64 in word32 mode still stores 8B)


@dataclasses.dataclass
class OpCost:
    ntts: int = 0            # number of full N-point (i)NTT passes (per limb summed)
    modmuls: int = 0         # elementwise modular multiplications (N-element rows)
    const_bytes: int = 0     # evk / plaintext bytes this op must have resident
    io_bytes: int = 0        # ciphertext bytes read+written
    out_bytes: int = 0       # output ciphertext size
    ks_modmuls: int = 0      # keyswitch digit-decomposition modmul rows (BConv
    #                          MACs + evk mult-acc): operands are gathered
    #                          across limb partitions, so hardware models may
    #                          bill them heavier than resident-operand modmuls
    move_bytes: int = 0      # ciphertext bytes the op moves between partitions
    #                          (rotation slot permutation, ModUp digit
    #                          distribution) — the PIM lowerer's XFER channel

    def __add__(self, o: "OpCost") -> "OpCost":
        return OpCost(self.ntts + o.ntts, self.modmuls + o.modmuls,
                      self.const_bytes + o.const_bytes,
                      self.io_bytes + o.io_bytes, self.out_bytes,
                      self.ks_modmuls + o.ks_modmuls,
                      self.move_bytes + o.move_bytes)


def ct_bytes(params: CkksParams, level: int) -> int:
    return 2 * (level + 1) * params.n * WORD


def evk_bytes(params: CkksParams) -> int:
    full = params.n_q_moduli + params.n_special
    return params.dnum * 2 * full * params.n * WORD


def keyswitch_cost(params: CkksParams, level: int) -> OpCost:
    """Generalized KS at `level`: per digit iNTT+BConv+NTT (ModUp), evk
    mult-accumulate, then 2x ModDown (iNTT+BConv+NTT+mul).

    Digit-decomposition work (BConv MACs, evk mult-acc) lands in
    ``ks_modmuls``, not ``modmuls``: those rows read operands gathered
    from other limb partitions. The limbs each BConv *creates* in a
    basis it does not own are billed as ``move_bytes`` — the inter-
    partition traffic the paper's permutation network exists for.
    """
    lp = level + 1
    k = params.n_special
    dnum = len([d for d in params.digit_indices(level)])
    alpha = params.alpha
    t = lp + k
    limb_b = params.n * WORD
    ntts = 0
    modmuls = 0
    ks_modmuls = 0
    move_b = 0
    for d in range(dnum):
        dig = min(alpha, lp - d * alpha)
        ntts += dig              # iNTT digit
        ntts += (t - dig)        # NTT of converted limbs
        modmuls += dig                        # qhat_inv mul (resident)
        ks_modmuls += dig * (t - dig)         # bconv MACs
        ks_modmuls += 2 * t                   # evk mult-acc (b and a)
        move_b += (t - dig) * limb_b          # ModUp digit distribution
    # ModDown x2: iNTT P part, BConv P->Q, NTT, final mul
    ntts += 2 * (k + lp)
    modmuls += 2 * (lp + lp)                  # final scalar mul + sub-mul
    ks_modmuls += 2 * (k + k * lp)            # P qhat_inv + bconv MACs
    move_b += 2 * lp * limb_b                 # P->Q converted limbs
    return OpCost(ntts=ntts, modmuls=modmuls, const_bytes=evk_bytes(params),
                  io_bytes=2 * ct_bytes(params, level),
                  out_bytes=ct_bytes(params, level),
                  ks_modmuls=ks_modmuls, move_bytes=move_b)


def rescale_cost(params: CkksParams, level: int) -> OpCost:
    return OpCost(ntts=2 * (1 + level), modmuls=2 * level * 2,
                  io_bytes=2 * ct_bytes(params, level),
                  out_bytes=ct_bytes(params, level - 1))


def op_cost(params: CkksParams, op: FheOp) -> OpCost:
    l = op.level if op.level is not None else params.n_levels
    lp = l + 1
    if op.kind in ("input", "const"):
        return OpCost(out_bytes=ct_bytes(params, l))
    if op.kind in ("hadd", "hsub"):
        return OpCost(modmuls=0, io_bytes=2 * ct_bytes(params, l),
                      out_bytes=ct_bytes(params, l))
    if op.kind == "padd":
        return OpCost(const_bytes=ct_bytes(params, l) // 2,
                      io_bytes=ct_bytes(params, l),
                      out_bytes=ct_bytes(params, l))
    if op.kind == "pmul":
        if op.meta.get("lazy"):          # no rescale: output stays at l
            return OpCost(modmuls=2 * lp,
                          const_bytes=ct_bytes(params, l) // 2,
                          io_bytes=ct_bytes(params, l),
                          out_bytes=ct_bytes(params, l))
        c = OpCost(modmuls=2 * lp, const_bytes=ct_bytes(params, l + 1) // 2,
                   io_bytes=ct_bytes(params, l + 1),
                   out_bytes=ct_bytes(params, l))
        return c + rescale_cost(params, l + 1)
    if op.kind == "hmul":
        if op.meta.get("lazy"):          # tensor+relin only, at level l
            c = OpCost(modmuls=4 * lp,
                       io_bytes=2 * ct_bytes(params, l),
                       out_bytes=ct_bytes(params, l))
            return c + keyswitch_cost(params, l)
        c = OpCost(modmuls=4 * (l + 2),
                   io_bytes=2 * ct_bytes(params, l + 1),
                   out_bytes=ct_bytes(params, l))
        return c + keyswitch_cost(params, l + 1) + rescale_cost(params, l + 1)
    if op.kind in ("rotate", "conjugate"):
        c = keyswitch_cost(params, l)
        # the slot automorphism itself: every coefficient lands in a new
        # position, crossing partitions on a limb-distributed layout
        c.move_bytes += ct_bytes(params, l)
        return c
    if op.kind == "rescale":
        return rescale_cost(params, l + 1)
    if op.kind == "bootstrap":
        # dominated by CtS/EvalMod/StC; approximate with the measured op mix:
        # 2 dense matvecs (~2 sqrt(s) rotations each) + ~2 deg-63 cheb evals
        s_rot = 2 * int(2 * (params.slots ** 0.5))
        cheb_muls = 2 * 70
        c = OpCost()
        for _ in range(s_rot):
            c = c + keyswitch_cost(params, l)
        for _ in range(cheb_muls):
            c = c + keyswitch_cost(params, l) + rescale_cost(params, l)
        return c
    raise ValueError(op.kind)
