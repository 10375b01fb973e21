"""Batched schedule-evaluation engine over the real CKKS stack.

The execution core of the serving runtime's `CiphertextBackend`
(runtime/ciphertext_backend.py) and of the trace interpreter: encode +
encrypt slot batches, evaluate every trace op homomorphically with real
relinearization / Galois keys, decrypt + decode the outputs.

Batching model: a `CtBatch` stacks B same-shaped ciphertexts as one
``(B, 2, L, N)`` int64 tensor on the engine's device, and every
homomorphic op of core/ops.py takes that leading batch dimension as it
is (the reference's ``jax.vmap`` written out), so a batch of 8 costs one
pass of each op, not eight. PyTorch runs eagerly: no per-signature trace
or compile cache is needed.

With ``use_kernels`` every keyswitch runs on the fused CUDA kernels
(kernels/keyswitch.py, 4 launches), every rescale on the same kernels'
ModDown tail (2 launches), the plaintext-multiply data product on the
modmul kernel (kernels/modmul.py) with the batch folded into the
limb-row axis, and the HMul tensor product, the keyswitch combine and
HAdd/HSub on one launch each (kernels/elementwise.py); all are
bit-exact against the library route.

Plaintext constants are encoded once per (const expression, level,
scale) and memoized through a pluggable cache hook (the serving backend
plugs its `KeyCache` in); Galois/relin key generation reports its evk
footprint through ``on_key_load``.

Spans: with an `obs.EngineObs` set on ``obs`` the engine records one
``engine.op`` span an op and, inside it, a span for each step (const,
tensor, keyswitch, perm, combine, rescale, product, align, and keygen
and ksk_mont on first use), on the context's host clock. Without one
(the default) a step costs an attribute read and a None test at its
start and end: no span is made and no clock is read. Spans never wait
on the device.

Scale handling: same-level operands of an add have structurally
identical scales; across a level gap the deeper operand is brought down
exactly with a compensating unit pmul. `bootstrap` ops execute as an
exact refresh (decrypt -> re-encode at the target level -> re-encrypt).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import modarith as ma
from repro_torch.core import ops as hops
from repro_torch.core.ciphertext import Ciphertext, KeySwitchKey, Plaintext
from repro_torch.core.context import CkksContext, DeviceLike
from repro_torch.core.encoder import CkksEncoder
from repro_torch.core.encryptor import CkksEncryptor
from repro_torch.core.params import CkksParams
from repro_torch.core.trace import FheOp, FheTrace, evk_bytes
from repro_torch.kernels import elementwise as kew
from repro_torch.obs.tracer import EngineObs


# ---------------------------------------------------------------------------
# const expressions (derived plaintexts minted by the passes; see ir.py)
# ---------------------------------------------------------------------------

def resolve_cexpr(expr, consts: Dict[str, np.ndarray]) -> np.ndarray:
    """Evaluate a derived-const expression (see ir.py) to a slot vector."""
    tag = expr[0]
    if tag == "ref":
        return np.asarray(consts[expr[1]])
    if tag == "mul":
        return resolve_cexpr(expr[1], consts) * resolve_cexpr(expr[2], consts)
    if tag == "add":
        return resolve_cexpr(expr[1], consts) + resolve_cexpr(expr[2], consts)
    if tag == "rot":
        # rotate(step): out[i] = in[i + step]
        return np.roll(resolve_cexpr(expr[1], consts), -expr[2], axis=-1)
    raise ValueError(f"unknown const expression {expr!r}")


def op_cexpr(op: FheOp):
    """An op's const expression; a bare named const if no cexpr meta."""
    expr = op.meta.get("cexpr")
    return expr if expr is not None else ("ref", op.meta["const"])


def const_vec(op: FheOp, consts: Dict[str, np.ndarray],
              slots: int) -> np.ndarray:
    v = resolve_cexpr(op_cexpr(op), consts)
    assert v.shape[-1] == slots, f"const for op {op.idx} has {v.shape} slots"
    return v


def _const_key(op: FheOp) -> str:
    """Stable human-readable identity of an op's const expression."""
    from repro_torch.compiler.ir import cexpr_name
    return cexpr_name(op_cexpr(op))


# ---------------------------------------------------------------------------
# batched ciphertexts
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CtBatch:
    """B stacked ciphertexts sharing one (level, scale)."""
    data: torch.Tensor           # (B, 2, level+1, N) int64, NTT domain
    level: int
    scale: float

    @property
    def batch(self) -> int:
        return self.data.shape[0]

    @property
    def n_limbs(self) -> int:
        return self.level + 1


@dataclasses.dataclass
class _Const(Plaintext):
    """An encoded constant as the const cache holds it, with K4's
    Montgomery operand (b, q32, -q^-1) on the kernel route, else None."""
    mont: Optional[Tuple[torch.Tensor, ...]] = None


def _default_cache_factory() -> Callable:
    memo: Dict = {}

    def cache(key, nbytes, loader):
        value = memo.get(key)
        if value is None:
            value = memo[key] = loader()
        return value
    return cache


def decrypt_tolerance(params) -> float:
    """Conservative decrypt-error bound for this parameter set."""
    return 512.0 * params.n / 2.0 ** params.log_scale


class CkksEngine:
    """Executes traces/schedules on encrypted slot batches on `device`
    (CUDA unless the caller passes ``device="cpu"``).

    Keys (secret, relin, per-element Galois) are generated once and
    cached across runs.
    """

    def __init__(self, params: CkksParams, seed: int = 7,
                 const_cache: Optional[Callable] = None,
                 on_key_load: Optional[Callable[[Tuple, int], None]] = None,
                 use_kernels: bool = False,
                 device: DeviceLike = None):
        self.params = params
        self.ctx = CkksContext(params, device)
        self.device = self.ctx.device
        self.encoder = CkksEncoder(self.ctx)
        self.encryptor = CkksEncryptor(self.ctx, seed=seed)
        self.sk = self.encryptor.keygen()
        self.rk = self.encryptor.relin_keygen(self.sk)
        self._gks: Dict[int, KeySwitchKey] = {}
        self.const_cache = const_cache or _default_cache_factory()
        self.on_key_load = on_key_load
        # `use_kernels` routes every keyswitch and rescale through the
        # fused kernels (K1-K3) AND the pmul data product through the
        # modmul kernel; all are bit-exact vs the library path
        self.use_kernels = use_kernels
        self._fks = None
        self._obs: Optional[EngineObs] = None
        if on_key_load is not None:
            on_key_load(("relin",), evk_bytes(params))

    # -- tolerance -----------------------------------------------------------

    @property
    def tolerance(self) -> float:
        return decrypt_tolerance(self.params)

    # -- spans ---------------------------------------------------------------

    @property
    def obs(self) -> Optional[EngineObs]:
        """The span context, None (spans off) by default."""
        return self._obs

    @obs.setter
    def obs(self, obs: Optional[EngineObs]) -> None:
        self._obs = obs
        if self._fks is not None:
            self._fks.obs = obs

    # -- keys ----------------------------------------------------------------

    def _gk(self, elt: int) -> KeySwitchKey:
        gk = self._gks.get(elt)
        if gk is None:
            o = self._obs
            if o is not None:
                o.begin("engine.keygen", key=("gk", elt))
            self._gks.update(self.encryptor.galois_keygen(self.sk, [elt]))
            if o is not None:
                o.end()
            if self.on_key_load is not None:
                self.on_key_load(("gk", elt), evk_bytes(self.params))
            gk = self._gks[elt]
        return gk

    def _sync(self) -> None:
        """Wait for the device, so host wall times cover the work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- encrypt / decode ----------------------------------------------------

    def encrypt(self, v: np.ndarray, level: int) -> Ciphertext:
        scale = 2.0 ** self.params.log_scale
        pt = Plaintext(self.encoder.encode(v, scale, level), level, scale)
        return self.encryptor.encrypt_sk(pt, self.sk)

    def encrypt_batch(self, vs: np.ndarray, level: int) -> CtBatch:
        """vs: (B, slots) complex -> one (B, 2, L, N) stack."""
        vs = np.atleast_2d(np.asarray(vs))
        cts = [self.encrypt(vs[i], level) for i in range(vs.shape[0])]
        return CtBatch(torch.stack([c.data for c in cts]), level,
                       cts[0].scale)

    def decode(self, ct: Ciphertext) -> np.ndarray:
        pt = self.encryptor.decrypt(ct, self.sk)
        return self.encoder.decode(pt.data, ct.scale, ct.level)

    def decode_batch(self, cb: CtBatch) -> np.ndarray:
        """One batched decrypt on the device, then per-element decode
        (inverse NTT on the device, CRT lift and FFT on the host)."""
        q = self.ctx.q_all[: cb.n_limbs][:, None]
        s = self.sk.s_ntt[: cb.n_limbs]
        m = ma.addmod(cb.data[:, 0], ma.mulmod(cb.data[:, 1], s, q), q)
        return np.stack([self.encoder.decode(m[i], cb.scale, cb.level)
                         for i in range(m.shape[0])])

    def encode_const(self, vec: np.ndarray, scale: float, level: int,
                     key: Optional[Tuple] = None) -> Tuple[_Const, bool]:
        """Encode (and memoize through the cache hook) one plaintext, and
        say whether the cache held it (its loader did not run). The key
        includes a digest of the VALUE, so a const name rebound to a new
        value is never served stale. On the kernel route the entry also
        holds K4's Montgomery operand, converted once here."""
        # int64 residues, plus the int32 Montgomery operand for K4
        nbytes = (level + 1) * self.params.n * (12 if self.use_kernels
                                                else 8)
        digest = hash(np.ascontiguousarray(vec).tobytes())
        k = ("pt",) + (key or ()) + (digest, level, float(scale))
        loaded = False

        def load() -> _Const:
            nonlocal loaded
            loaded = True
            data = self.encoder.encode(vec, scale, level)
            mont = None
            if self.use_kernels:
                from repro_torch.kernels import ops as kops
                mont = kops.mont_operand(data, self.ctx.primes[:level + 1])
            return _Const(data, level, scale, mont)
        return self.const_cache(k, nbytes, load), not loaded

    def _const(self, scale: float, level: int, op: Optional[FheOp] = None,
               consts: Optional[Dict[str, np.ndarray]] = None,
               scope: Tuple = ()) -> _Const:
        """`op`'s constant, its expression resolved to slots on the host,
        or with no op the all-ones one of `_adjust_to`, encoded at (scale,
        level) through the const cache."""
        o = self._obs
        if o is not None:
            o.begin("engine.const", level=level)
        if op is None:
            vec, key = np.ones(self.params.slots), ("unit",)
        else:
            vec = const_vec(op, consts, self.params.slots)
            key = scope + (_const_key(op),)
        pt, hit = self.encode_const(vec, scale, level, key)
        if o is not None:
            o.end(hit=hit, hashed=vec.nbytes)
        return pt

    # -- batched op appliers -------------------------------------------------

    def _mod_switch(self, cb: CtBatch, level: int) -> CtBatch:
        assert level <= cb.level
        if level == cb.level:
            return cb
        return CtBatch(cb.data[:, :, : level + 1], level, cb.scale)

    def _adjust_to(self, cb: CtBatch, level: int, scale: float) -> CtBatch:
        """Exact (level, scale) landing via a unit pmul at a compensating
        plaintext scale."""
        assert cb.level > level
        o = self._obs
        if o is not None:
            o.begin("engine.align", level=level)
        cb = self._mod_switch(cb, level + 1)
        q_drop = self.ctx.primes[level + 1]
        pt_scale = scale * q_drop / cb.scale
        pt = self._const(pt_scale, level + 1)
        out = self._pmul(cb, pt, lazy=False)      # pt at cb's level
        if o is not None:
            o.end()
        return CtBatch(out.data, level, scale)   # exact by construction

    def _aligned(self, c0: CtBatch, c1: CtBatch) -> Tuple[CtBatch, CtBatch]:
        """Bring an hadd/hsub pair to one (level, scale)."""
        lvl = min(c0.level, c1.level)

        def down(hi: CtBatch, partner_scale: float) -> CtBatch:
            if (hi.level > lvl
                    and abs(hi.scale / partner_scale - 1.0) > 1e-6):
                return self._adjust_to(hi, lvl, partner_scale)
            return self._mod_switch(hi, lvl)

        if c0.level > c1.level:
            c0 = down(c0, c1.scale)
        elif c1.level > c0.level:
            c1 = down(c1, c0.scale)
        rel = abs(c1.scale / c0.scale - 1.0)
        if rel > 1e-6:
            raise ValueError(
                f"scale-incompatible add at level {lvl}: "
                f"{c0.scale:.6e} vs {c1.scale:.6e} — the trace mixes "
                f"rescale disciplines on one add")
        if rel > 0:
            c1 = CtBatch(c1.data, c1.level, c0.scale)
        return c0, c1

    def _addsub(self, kind: str, c0: CtBatch, c1: CtBatch) -> CtBatch:
        c0, c1 = self._aligned(c0, c1)
        if self.use_kernels:
            data = kew.addsub(c0.data, c1.data, self._kbasis(c0.level).q32,
                              sub=kind == "hsub")
            return CtBatch(data, c0.level, c0.scale)
        fn = hops.hadd if kind == "hadd" else hops.hsub
        out = fn(self.ctx, Ciphertext(c0.data, c0.level, c0.scale),
                 Ciphertext(c1.data, c0.level, c0.scale))
        return CtBatch(out.data, c0.level, c0.scale)

    # -- fused CUDA keyswitch route (kernels/keyswitch.py) -------------------

    @property
    def fused_ks(self):
        """Lazily-built FusedKeySwitch shared by every evk."""
        if self._fks is None:
            from repro_torch.kernels.keyswitch import FusedKeySwitch
            self._fks = FusedKeySwitch(self.ctx)
            self._fks.obs = self._obs
        return self._fks

    def _kbasis(self, level: int):
        """The elementwise kernels' constants of the limbs at `level`."""
        return kew.basis(self.ctx.primes[: level + 1], self.device)

    def _keyswitch(self, x: torch.Tensor, level: int, key,
                   ksk_data: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, level+1, N) switched to the evk `key` names ("relin" or
        ("gk", elt)) on the fused kernels: (e0, e1)."""
        o = self._obs
        if o is not None:
            o.begin("engine.keyswitch", key=key, level=level,
                    batch=x.shape[0])
        fks = self.fused_ks
        e = fks.apply(x, level, fks.ksk_mont(key, level, ksk_data))
        if o is not None:
            o.end()
        return e

    def _hmul_fused(self, c0: CtBatch, c1: CtBatch, lazy: bool) -> CtBatch:
        """HMul with the relinearization keyswitch on the fused kernels:
        tensor product (1 launch) -> 4-launch keyswitch of the whole d2
        batch -> combine (1 launch) (+ rescale). Bit-identical to
        `_hmul`."""
        lvl = min(c0.level, c1.level)
        c0 = self._mod_switch(c0, lvl)
        c1 = self._mod_switch(c1, lvl)
        bs = self._kbasis(lvl)
        o = self._obs
        if o is not None:
            o.begin("engine.tensor", level=lvl)
        t0, t1, d2 = kew.tensor(c0.data, c1.data, bs)
        if o is not None:
            o.end()
        e0, e1 = self._keyswitch(d2, lvl, "relin", self.rk.data)
        if o is not None:
            o.begin("engine.combine")
        data = kew.combine(t0, t1, e0, e1, bs.q32)
        if o is not None:
            o.end()
        out = CtBatch(data, lvl, c0.scale * c1.scale)
        return out if lazy else self._rescale(out)

    def _hmul(self, c0: CtBatch, c1: CtBatch, lazy: bool) -> CtBatch:
        if self.use_kernels:
            return self._hmul_fused(c0, c1, lazy)
        out = hops.hmul(self.ctx, Ciphertext(c0.data, c0.level, c0.scale),
                        Ciphertext(c1.data, c1.level, c1.scale), self.rk,
                        do_rescale=not lazy)
        return CtBatch(out.data, out.level, out.scale)

    def _rescale(self, cb: CtBatch) -> CtBatch:
        o = self._obs
        if o is not None:
            o.begin("engine.rescale", level=cb.level, batch=cb.batch)
        if self.use_kernels:
            # K1 + K3 (the keyswitch's ModDown tail by the last prime),
            # bit-identical to core/ops.rescale
            out = CtBatch(self.fused_ks.rescale(cb.data, cb.level),
                          cb.level - 1,
                          cb.scale / self.ctx.q_primes[cb.level])
        else:
            ct = hops.rescale(self.ctx,
                              Ciphertext(cb.data, cb.level, cb.scale))
            out = CtBatch(ct.data, ct.level, ct.scale)
        if o is not None:
            o.end()
        return out

    def _pmul_kernel(self, cb: CtBatch, pt: _Const) -> CtBatch:
        """Plaintext-multiply data product through the modmul kernel: the
        (B, 2, L) rows fold into the kernel's limb-row axis and pair with
        the plaintext row of their limb, so ONE launch covers the batch.
        pt comes from `encode_const`, with its Montgomery operand."""
        from repro_torch.kernels import ops as kops
        o = self._obs
        if o is not None:
            o.begin("engine.product")
        b, _, lp, n = cb.data.shape
        a = cb.data.reshape(2 * b * lp, n)
        data = kops.modmul_mont(a, *(t[:lp] for t in pt.mont))
        if o is not None:
            o.end()
        return CtBatch(data.reshape(b, 2, lp, n), cb.level,
                       cb.scale * pt.scale)

    def _pmul(self, cb: CtBatch, pt: Plaintext, lazy: bool) -> CtBatch:
        if self.use_kernels:
            out = self._pmul_kernel(cb, pt)
            return out if lazy else self._rescale(out)
        out = hops.pmul(self.ctx, Ciphertext(cb.data, cb.level, cb.scale),
                        Plaintext(pt.data, cb.level, pt.scale),
                        do_rescale=not lazy)
        return CtBatch(out.data, out.level, out.scale)

    def _padd(self, cb: CtBatch, pt: Plaintext) -> CtBatch:
        out = hops.padd(self.ctx, Ciphertext(cb.data, cb.level, cb.scale),
                        Plaintext(pt.data, cb.level, cb.scale))
        return CtBatch(out.data, cb.level, cb.scale)

    def _galois_fused(self, cb: CtBatch, elt: int) -> CtBatch:
        """Galois automorphism with the keyswitch on the fused kernels:
        NTT-domain permutation -> 4-launch keyswitch of the rotated `a`
        batch -> combine (1 launch). Bit-identical to `_galois`."""
        gk = self._gk(elt)
        lvl = cb.level
        o = self._obs
        if o is not None:
            o.begin("engine.perm")
        rot = cb.data[..., self.ctx.eval_perm(elt)]       # (B, 2, L, N)
        if o is not None:
            o.end()
        e0, e1 = self._keyswitch(rot[:, 1], lvl, ("gk", elt), gk.data)
        if o is not None:
            o.begin("engine.combine")
        data = kew.combine(rot[:, 0], None, e0, e1, self._kbasis(lvl).q32)
        if o is not None:
            o.end()
        return CtBatch(data, lvl, cb.scale)

    def _galois(self, cb: CtBatch, elt: int) -> CtBatch:
        if self.use_kernels:
            return self._galois_fused(cb, elt)
        out = hops._apply_galois(self.ctx,
                                 Ciphertext(cb.data, cb.level, cb.scale),
                                 elt, self._gk(elt))
        return CtBatch(out.data, cb.level, cb.scale)

    # -- op-by-op evaluation -------------------------------------------------

    def run_ops(self, ops: Sequence[FheOp], env: Dict[int, CtBatch],
                consts: Dict[str, np.ndarray], *, start_level: int,
                const_scope: Tuple = ()) -> List[CtBatch]:
        """Evaluate `ops` (any program-ordered slice of a trace) against
        `env`, mutating it in place. Returns the values produced."""
        slots = self.params.slots
        scale = 2.0 ** self.params.log_scale
        produced: List[CtBatch] = []
        o = self._obs
        for op in ops:
            if op.kind in ("input", "const"):
                continue
            a = [env[x] for x in op.args]
            if o is not None:
                o.begin("engine.op", kind=op.kind, op=op.idx,
                        level_in=min(x.level for x in a), batch=a[0].batch)
            lazy = bool(op.meta.get("lazy"))
            if op.kind in ("hadd", "hsub"):
                out = self._addsub(op.kind, a[0], a[1])
            elif op.kind == "hmul":
                out = self._hmul(a[0], a[1], lazy)
            elif op.kind == "pmul":
                pt = self._const(scale, a[0].level, op, consts, const_scope)
                out = self._pmul(a[0], pt, lazy)
            elif op.kind == "padd":
                pt = self._const(a[0].scale, a[0].level, op, consts,
                                 const_scope)
                out = self._padd(a[0], pt)
            elif op.kind == "rotate":
                step = op.meta["step"] % slots
                if step == 0:
                    out = a[0]
                else:
                    out = self._galois(a[0],
                                       self.ctx.rotation_element(step))
            elif op.kind == "conjugate":
                out = self._galois(a[0], self.ctx.conj_element)
            elif op.kind == "rescale":
                out = self._rescale(a[0])
            elif op.kind == "bootstrap":
                target = op.level if op.level is not None else start_level
                out = self.encrypt_batch(self.decode_batch(a[0]), target)
            else:
                raise ValueError(op.kind)
            if o is not None:
                o.end(level_out=out.level)
            env[op.idx] = out
            produced.append(out)
        return produced

    # -- whole-trace / whole-schedule execution ------------------------------

    @staticmethod
    def _resolve_start(trace: FheTrace, start_level: Optional[int],
                       n_levels: int) -> int:
        if start_level is not None:
            return start_level
        in_op = trace.ops[trace.inputs[0]] if trace.inputs else None
        return (in_op.level if in_op is not None
                and in_op.level is not None else n_levels)

    def encrypt_inputs(self, trace: FheTrace, inputs: Sequence[np.ndarray],
                       start: int) -> Dict[int, CtBatch]:
        return {idx: self.encrypt_batch(np.asarray(inputs[i]), start)
                for i, idx in enumerate(trace.inputs)}

    def run_batch(self, trace: FheTrace, inputs: Sequence[np.ndarray],
                  consts: Optional[Dict[str, np.ndarray]] = None,
                  start_level: Optional[int] = None,
                  const_scope: Tuple = ()) -> List[np.ndarray]:
        """Encrypt (B, slots) inputs, execute, return (B, slots) decodes."""
        consts = consts or {}
        start = self._resolve_start(trace, start_level,
                                    self.params.n_levels)
        env = self.encrypt_inputs(trace, inputs, start)
        self.run_ops(trace.ops, env, consts, start_level=start,
                     const_scope=const_scope)
        return [self.decode_batch(env[o]) for o in trace.outputs]

    def run(self, trace: FheTrace, inputs: Sequence[np.ndarray],
            consts: Optional[Dict[str, np.ndarray]] = None,
            start_level: Optional[int] = None) -> List[np.ndarray]:
        """Single-sample API: 1-D slot vectors in, 1-D decodes out."""
        outs = self.run_batch(trace, [np.asarray(v)[None, :]
                                      for v in inputs],
                              consts, start_level)
        return [o[0] for o in outs]

    def run_schedule(self, schedule, inputs: Sequence[np.ndarray],
                     consts: Optional[Dict[str, np.ndarray]] = None,
                     start_level: Optional[int] = None,
                     const_scope: Tuple = ()
                     ) -> Tuple[List[np.ndarray], List[float]]:
        """Execute a compiled `PipelineSchedule` stage by stage on (B,
        slots) encrypted inputs, timing each stage (a device barrier
        ends every stage). Returns (decoded outputs, per-stage seconds)."""
        trace = schedule.trace
        assert trace is not None, \
            "schedule carries no trace (mapper predates engine support)"
        consts = consts or {}
        start = self._resolve_start(trace, start_level,
                                    self.params.n_levels)
        env = self.encrypt_inputs(trace, inputs, start)
        self._sync()
        stage_seconds: List[float] = []
        for stage in schedule.stages:
            t0 = time.perf_counter()
            self.run_ops(stage.ops, env, consts, start_level=start,
                         const_scope=const_scope)
            self._sync()
            stage_seconds.append(time.perf_counter() - t0)
        return ([self.decode_batch(env[o]) for o in trace.outputs],
                stage_seconds)
