"""Trace → PipelineSchedule memoization.

Mapping a trace (stage splitting + placement, core/pipeline.py) is pure
in (trace structure, CKKS params, memory model, mapper policy), so a
serving runtime should pay it once per distinct workload, not per
batch. Keys are structural fingerprints — two traces of the same
program text captured separately hash identically, so tenants sharing a
model share one compiled schedule.
"""
from __future__ import annotations

import hashlib
import time
from typing import Callable, Dict, Optional, Tuple

from repro_torch.compiler import PassConfig, optimize_trace
from repro_torch.core.params import CkksParams
from repro_torch.core.pipeline import (MemoryModel, PipelineSchedule,
                                 generate_load_save_pipeline)
from repro_torch.core.trace import FheTrace
from repro_torch.runtime.metrics import MetricsRegistry


def trace_fingerprint(trace: FheTrace) -> str:
    """Structural hash: op kinds, dataflow edges, meta, inferred levels.

    Index-based (SSA indices are deterministic given program structure),
    so identical programs traced twice collide — by design.
    """
    h = hashlib.sha256()
    for op in trace.ops:
        meta = tuple(sorted((k, repr(v)) for k, v in op.meta.items()))
        h.update(repr((op.idx, op.kind, op.args, meta, op.level)).encode())
    h.update(repr((tuple(trace.inputs), tuple(trace.outputs),
                   tuple(trace.consts))).encode())
    return h.hexdigest()


def _params_key(params: CkksParams) -> Tuple:
    return (params.log_n, params.log_scale, params.n_levels, params.dnum,
            params.first_mod_bits, params.scale_mod_bits,
            params.special_mod_bits)


def _mem_key(mem: MemoryModel) -> Tuple:
    return (mem.n_partitions, mem.partition_bytes, mem.load_bw,
            mem.modmul_throughput, mem.ntt_row_cost, mem.transfer_bw,
            mem.ks_modmul_weight)


class CompileCache:
    """Unbounded memo of compiled schedules (schedules are small — op
    lists plus floats — and the workload universe is the registry, not
    the request stream, so no eviction policy is needed)."""

    def __init__(self, metrics: Optional[MetricsRegistry] = None,
                 verify: bool = False):
        """``verify=True`` asks for verify-on-miss through the static
        verifier, which this package does not have yet: it raises
        NotImplementedError."""
        if verify:
            raise NotImplementedError(
                "CompileCache(verify=True) needs repro_torch.analysis, "
                "which is not yet ported")
        self.metrics = metrics or MetricsRegistry()
        self._cache: Dict[Tuple, PipelineSchedule] = {}

    def __len__(self) -> int:
        return len(self._cache)

    def get_schedule(self, trace: FheTrace, params: CkksParams,
                     mem: MemoryModel,
                     mapper: Callable[..., PipelineSchedule]
                     = generate_load_save_pipeline,
                     pass_config: Optional[PassConfig] = None,
                     obs=None, **mapper_kwargs) -> PipelineSchedule:
        """Optionally run the optimizing compiler (repro.compiler) on the
        trace before mapping. `pass_config` participates in the cache
        key, so opt and no-opt schedules of one workload — or two
        different pass selections — never collide.

        ``obs`` is an optional `repro.obs.ExecObs` (an explicit kwarg —
        it must never leak into ``mapper_kwargs``, which participate in
        the cache key): with it, a ``compile`` span lands under the
        caller's batch span — zero duration on the serving timeline
        (compilation never advances the virtual clock; service time
        starts at backend.execute) but carrying the measured wall
        seconds, hit/miss, and on a miss one child span per compiler
        pass from the attached PassReport."""
        key = (trace_fingerprint(trace), _params_key(params), _mem_key(mem),
               getattr(mapper, "__name__", repr(mapper)),
               pass_config.key() if pass_config is not None else None,
               tuple(sorted(mapper_kwargs.items())))
        hit = key in self._cache
        if hit:
            self.metrics.incr("compile_hits")
        else:
            self.metrics.incr("compile_misses")
            t0 = time.perf_counter()
            report = None
            if pass_config is not None:
                trace, report = optimize_trace(trace, params, pass_config)
                self.metrics.incr("traces_optimized")
            sched = mapper(trace, params, mem, **mapper_kwargs)
            sched.pass_report = report
            sched._compile_wall_s = time.perf_counter() - t0
            self._cache[key] = sched
        sched = self._cache[key]
        if obs is not None and obs.tracer is not None:
            c = obs.tracer.instant(
                "compile", obs.t0, parent=obs.parent, track=obs.track,
                hit=hit, wall_s=0.0 if hit
                else getattr(sched, "_compile_wall_s", 0.0),
                n_stages=len(sched.stages),
                verify_wall_s=0.0 if hit
                else getattr(sched, "_verify_wall_s", 0.0),
                verify_findings=0 if hit else (
                    len(getattr(sched, "verify_report").findings)
                    if getattr(sched, "verify_report", None) is not None
                    else 0))
            if not hit and sched.pass_report is not None:
                for s in sched.pass_report.passes:
                    obs.tracer.instant(
                        "pass:" + s.name, obs.t0, parent=c,
                        track=obs.track, wall_s=s.wall_s,
                        applied=s.applied, reverted=s.reverted,
                        ops_before=s.n_ops_before, ops_after=s.n_ops_after)
        return sched
