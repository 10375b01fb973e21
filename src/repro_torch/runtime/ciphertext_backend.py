"""CiphertextBackend: the serving backend that actually encrypts.

Behind the executor's ``execute(schedule, batch, ...) -> seconds``
contract (runtime/executor.py), this backend runs the compiled
`PipelineSchedule` on actually encrypted data through the batched CKKS
engine (repro_torch/compiler/engine.py) on its device. Per batch:

* requests' slot groups are packed into (B, slots) value rows and
  encrypted under the engine's secret key;
* every trace op executes as one batched pass over the ciphertext stack
  (on CUDA, keyswitches and plaintext products on the hand-written
  kernels by default);
* stage constants are encoded once and reused across batches through the
  runtime `KeyCache` (evk/Galois-key footprints pinned, plaintext
  constants LRU-evictable);
* outputs are decrypted and compared against the plaintext oracle
  (`reference_eval`); max |error| lands in
  ``MetricsRegistry.decrypt_error``;
* per-stage wall times (a device barrier ends each stage) accumulate in
  ``stage_stats``.

Workload inputs beyond the request payload and the named plaintext
constants are synthesized deterministically per (workload, name).
"""
from __future__ import annotations

import time
import zlib
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.compiler.engine import CkksEngine, op_cexpr
from repro_torch.compiler.interp import reference_eval
from repro_torch.core.context import DeviceLike, resolve_device
from repro_torch.core.params import CkksParams
from repro_torch.core.pipeline import PipelineSchedule
from repro_torch.core.trace import FheTrace, evk_bytes
from repro_torch.runtime.batcher import Batch
from repro_torch.runtime.keycache import KeyCache
from repro_torch.runtime.metrics import MetricsRegistry


def base_const_names(trace: FheTrace) -> List[str]:
    """Named plaintext constants a trace's pmul/padd ops reference,
    including through derived const expressions (ir.py cexprs)."""
    names: Set[str] = set()

    def walk(expr):
        if expr[0] == "ref":
            names.add(expr[1])
        elif expr[0] == "rot":
            walk(expr[1])
        else:
            walk(expr[1])
            walk(expr[2])

    for op in trace.ops:
        if op.kind in ("pmul", "padd"):
            walk(op_cexpr(op))
    return sorted(names)


def _stable_rng(*parts: str) -> np.random.Generator:
    seed = zlib.crc32("/".join(parts).encode()) & 0xFFFFFFFF
    return np.random.default_rng(seed)


class _StageStat:
    """Running mean of one stage's measured wall seconds."""

    __slots__ = ("total_s", "count")

    def __init__(self):
        self.total_s = 0.0
        self.count = 0

    def add(self, seconds: float) -> None:
        self.total_s += seconds
        self.count += 1

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0


class CiphertextBackend:
    """Real encrypted execution of compiled schedules, batched."""

    def __init__(self, params: CkksParams, seed: int = 7,
                 use_kernels: Optional[bool] = None,
                 const_amplitude: float = 0.25,
                 device: DeviceLike = None):
        device = resolve_device(device)
        if use_kernels is None:
            # the hand-written CUDA kernels (fused keyswitch + modmul)
            # are the main path on the card; on the CPU their plain
            # versions are correct but slower than the library path
            use_kernels = device.type == "cuda"
        self.use_kernels = bool(use_kernels)
        self._key_cache: Optional[KeyCache] = None
        self._local_consts: Dict = {}
        self._consts_memo: Dict[Tuple, Dict[str, np.ndarray]] = {}
        self._aux_memo: Dict[Tuple[str, int], np.ndarray] = {}
        self.const_amplitude = const_amplitude
        self.engine = CkksEngine(params, seed=seed,
                                 const_cache=self._cached_const,
                                 on_key_load=self._on_key_load,
                                 use_kernels=self.use_kernels,
                                 device=device)
        # workload -> per-stage running means of measured seconds
        self.stage_stats: Dict[str, List[_StageStat]] = {}
        self.pad_batch_to: Optional[int] = None   # bucketing (executor sets)

    # -- KeyCache integration ------------------------------------------------

    def _cached_const(self, key, nbytes: int, loader):
        """Engine const hook: memoize encoded plaintexts through the
        runtime KeyCache when one is wired, else a local dict."""
        if self._key_cache is None:
            if key not in self._local_consts:
                self._local_consts[key] = loader()
            return self._local_consts[key]
        value, _hit, _load_s = self._key_cache.get_or_load(
            key, nbytes, loader=loader)
        return value

    def _on_key_load(self, key: Tuple, nbytes: int) -> None:
        """Evaluation keys (relin / Galois) are pinned residents."""
        if self._key_cache is not None:
            self._key_cache.get_or_load(("engine",) + key, nbytes, pin=True)

    def _sync_keys(self) -> None:
        """Register evaluation keys the engine already holds into the
        wired KeyCache (pinned); only MISSING keys are loaded, so pinned
        entries are not re-touched every batch."""
        if self._key_cache is None:
            return
        nb = evk_bytes(self.engine.params)
        for key in [("engine", "relin")] + [("engine", "gk", elt)
                                            for elt in self.engine._gks]:
            if key not in self._key_cache:
                self._key_cache.get_or_load(key, nb, pin=True)

    # -- deterministic server-side state -------------------------------------

    def workload_consts(self, workload: str,
                        trace: FheTrace) -> Dict[str, np.ndarray]:
        """Memoized per (workload, const-name set); each value is a pure
        function of (workload, name)."""
        key = (workload, tuple(base_const_names(trace)))
        consts = self._consts_memo.get(key)
        if consts is None:
            slots = self.engine.params.slots
            consts = self._consts_memo[key] = {
                name: self.const_amplitude
                * _stable_rng(workload, "const", name).standard_normal(slots)
                for name in key[1]}
        return consts

    def _aux_input(self, workload: str, input_pos: int,
                   batch_size: int) -> np.ndarray:
        """Inputs past the payload slot (weights etc.): one deterministic
        vector (memoized) broadcast across the batch."""
        v = self._aux_memo.get((workload, input_pos))
        if v is None:
            slots = self.engine.params.slots
            v = self._aux_memo[(workload, input_pos)] = \
                self.const_amplitude * _stable_rng(
                    workload, "input", str(input_pos)).standard_normal(slots)
        return np.broadcast_to(v, (batch_size, len(v)))

    def _pack(self, batch: Batch, n_micro: int) -> np.ndarray:
        """Requests' payload values -> (n_micro, slots) rows (each request
        owns a contiguous slot range)."""
        slots = self.engine.params.slots
        x = np.zeros((n_micro, slots), dtype=np.complex128)
        for ct_i, group in enumerate(batch.slot_groups):
            off = 0
            for r in group:
                n = r.slots_needed
                if r.payload is not None:
                    try:
                        v = np.asarray(r.payload,
                                       dtype=np.complex128).ravel()[:n]
                    except (TypeError, ValueError):
                        v = None   # opaque payload: slots stay zero
                    if v is not None:
                        x[ct_i, off:off + len(v)] = v
                off += n
        return x

    # -- execution -----------------------------------------------------------

    def execute(self, schedule: PipelineSchedule, batch: Batch, *,
                key_cache: Optional[KeyCache],
                metrics: MetricsRegistry, workload: str,
                obs=None) -> float:
        trace = schedule.trace
        assert trace is not None, "mapper did not attach the trace"
        self._key_cache = key_cache
        self._sync_keys()
        n_micro = max(self.pad_batch_to or 0, batch.n_ciphertexts, 1)

        t0 = time.perf_counter()
        values = self._pack(batch, n_micro)
        inputs = [values] + [self._aux_input(workload, i, n_micro)
                             for i in range(1, len(trace.inputs))]
        consts = self.workload_consts(workload, trace)
        t_pack = time.perf_counter() - t0
        outs, stage_s = self.engine.run_schedule(
            schedule, inputs, consts, const_scope=(workload,))
        dt = time.perf_counter() - t0

        # decrypt-side accuracy vs the plaintext oracle on the very same
        # packed values (reference_eval resolves derived cexprs too)
        t_chk = time.perf_counter()
        ref = reference_eval(trace, inputs, consts)
        err = max(float(np.abs(np.asarray(d) - np.asarray(r)).max())
                  for d, r in zip(outs, ref)) if outs else 0.0
        metrics.observe_decrypt_error(workload, err)
        t_chk = time.perf_counter() - t_chk

        stats = self.stage_stats.setdefault(
            workload, [_StageStat() for _ in schedule.stages])
        if len(stats) != len(schedule.stages):   # recompiled differently
            stats = self.stage_stats[workload] = \
                [_StageStat() for _ in schedule.stages]
        for st, sec in zip(schedule.stages, stage_s):
            stats[st.idx].add(sec)
            metrics.occupancy.add(st.partition, sec)

        if obs is not None and obs.tracer is not None:
            # wall-clock decomposition: pack+encrypt, then the measured
            # per-stage execution laid end to end
            tr, t = obs.tracer, obs.t0
            tr.span("encrypt_pack", t, t + t_pack, parent=obs.parent,
                    track=obs.track, n_micro=n_micro)
            at = t + t_pack
            for st, sec in zip(schedule.stages, stage_s):
                tr.span("stage", at, at + sec, parent=obs.parent,
                        track=obs.track, stage=st.idx,
                        partition=st.partition, compute_s=sec)
                at += sec
            tr.instant("decrypt_check", t + dt, parent=obs.parent,
                       track=obs.track, wall_s=t_chk, max_err=err)
        batch.outputs = outs
        return dt

    # -- calibration hooks ---------------------------------------------------

    def measured_stage_seconds(self, workload: str) -> List[float]:
        """Mean measured wall seconds per stage."""
        return [s.mean_s for s in self.stage_stats.get(workload, [])]

    @property
    def tolerance(self) -> float:
        return self.engine.tolerance
