"""Round-based serving engine: drains the slot batcher through a
pipeline backend behind one interface.

Four backends, one contract (``execute(schedule, batch, ...) -> seconds``):

* ``AnalyticBackend`` — the MemoryModel cost model (core/pipeline.py)
  driven as a discrete-event simulation on a virtual clock. Stage
  constant loads consult the KeyCache: a resident stage costs zero load
  time for the next batch. Deterministic; runs anywhere.
* ``MeshBackend`` — the real distributed executor
  (fhe_dist/pipeline_exec.py over torch.distributed): batches become
  microbatch stacks flowing rank to rank through a ring shift, stage
  constants become device-resident tensors cached across batches,
  service time is wall clock.
* ``CiphertextBackend`` (runtime/ciphertext_backend.py) — real encrypted
  execution on a torch device: batches are encrypted under the runtime's
  CKKS keys and every schedule op runs as one batched pass over the
  ciphertext stack, with decrypt-side accuracy recorded per workload.
  Wall clock, per-stage measured times.
* ``PimBackend`` (repro_torch/pim/backend.py) — discrete-event
  simulation of the hierarchical FHEmem hardware model: schedules are
  lowered to a bank-level instruction stream (repro_torch.pim.lower) and
  replayed on a virtual clock; the degenerate flat arch reproduces
  AnalyticBackend stage times exactly.

``PipelinedExecutor`` owns the event loop: admit arrivals → poll the
batcher → compile (memoized) → execute → record completions.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.compiler import PassConfig
from repro_torch.core.params import CkksParams
from repro_torch.core.pipeline import (MemoryModel, PipelineSchedule,
                                 generate_load_save_pipeline)
from repro_torch.core.trace import (FheTrace, LevelBudgetExhausted, infer_levels,
                              trace_program)
from repro_torch.fhe_dist.pipeline_exec import run_load_save_pipeline
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.obs.tracer import ExecObs
from repro_torch.runtime.batcher import Batch, BatchPolicy, SlotBatcher
from repro_torch.runtime.compile_cache import CompileCache
from repro_torch.runtime.keycache import KeyCache
from repro_torch.runtime.metrics import MetricsRegistry
from repro_torch.runtime.queue import AdmissionQueue, Request, RequestStatus


@dataclasses.dataclass
class Workload:
    """A registered FHE program: traced once, compiled per (params, mem)
    via the compile cache, shared by every tenant that names it."""
    name: str
    trace: FheTrace


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------

class AnalyticBackend:
    """Virtual-clock service-time model with cache-aware constant loads.

    ``round_seconds`` is the unit of simulation: one pipeline round at
    a given batch occupancy. ``execute`` sums it over the schedule's
    rounds; the fleet's continuous-batching/preemption path
    (repro.fleet.device) calls it round by round so batch membership
    can change at round boundaries.
    """

    def __init__(self, mem: MemoryModel):
        self.mem = mem

    def round_seconds(self, schedule: PipelineSchedule, rnd, b: int, *,
                      key_cache: Optional[KeyCache],
                      metrics: MetricsRegistry, workload: str,
                      obs: Optional[ExecObs] = None) -> float:
        # the schedule's own cost model is the single source of truth;
        # the key cache only substitutes the load term: a resident
        # stage streams nothing (reload_per_op stages overflow the
        # partition, so residency cannot help them by construction)
        times = schedule.stage_times(b)
        round_times = []
        for st in rnd:
            load, compute, transfer = times[st.idx]
            if key_cache is not None and not schedule.reload_per_op:
                _, _, load = key_cache.get_or_load(
                    (workload, "stage", st.idx), st.const_bytes)
            busy = load + max(compute, transfer)
            round_times.append((busy, compute, transfer))
            metrics.occupancy.add(st.partition, busy)
        # within a round stages overlap (pipelined): worst stage
        # bounds the steady state, plus pipeline fill
        worst = max(t[0] for t in round_times)
        fill = sum(max(c, t) / b for (_, c, t) in round_times)
        tel = metrics.telemetry
        if tel is not None and obs is not None:
            round_s = worst + fill
            t_end = obs.t0 + round_s
            for st, (busy, _, _) in zip(rnd, round_times):
                tel.counter("fhe_partition_busy_seconds",
                            partition=st.partition).inc(t_end, busy)
                tel.gauge("fhe_partition_utilization",
                          partition=st.partition).set(
                              t_end, busy / round_s)
        if obs is not None and obs.tracer is not None:
            # stages of one round run pipelined, so their spans share
            # the round's start and nest by containment in the viewer
            rspan = obs.tracer.begin("round", obs.t0, parent=obs.parent,
                                     track=obs.track, n_stages=len(rnd),
                                     b=b)
            for st, (busy, compute, transfer) in zip(rnd, round_times):
                obs.tracer.span(
                    "stage", obs.t0, obs.t0 + busy, parent=rspan,
                    track=obs.track, stage=st.idx, partition=st.partition,
                    load_s=busy - max(compute, transfer),
                    compute_s=compute, move_s=transfer)
            obs.tracer.end(rspan, obs.t0 + worst + fill)
        return worst + fill

    def execute(self, schedule: PipelineSchedule, batch: Batch, *,
                key_cache: Optional[KeyCache],
                metrics: MetricsRegistry, workload: str,
                obs: Optional[ExecObs] = None) -> float:
        b = max(1, batch.n_ciphertexts)
        total = 0.0
        for rnd in schedule.rounds:
            total += self.round_seconds(
                schedule, rnd, b, key_cache=key_cache, metrics=metrics,
                workload=workload,
                obs=obs.at(obs.t0 + total) if obs is not None else None)
        return total


def _identity_stage(x):
    return x


def default_stage_fn_builder(stage, const):
    """Shape-preserving placeholder stage body: an affine map with the
    stage's (cached, device-resident) constant. Real FHE stage bodies
    plug in here once core ops are wired batch-wise; the pipeline
    structure, residency, and transfer pattern are already the real
    ones."""
    w, bias = const[0], const[1]

    def fn(x):
        return x * w + bias
    return fn


class MeshBackend:
    """Real pipelined execution on a torch.distributed mesh via
    fhe_dist.pipeline_exec.run_load_save_pipeline.

    Batches become (n_ciphertexts, slots_per_ct) float32 stacks (each
    request's payload written into its owned slot range) on the mesh's
    device; schedule rounds are regrouped into chunks of the mesh's
    data-axis size (identity-padded), so the same schedule runs on any
    rank count. Stage constants are materialized host→device through the
    KeyCache: a hit reuses the resident device tensor.
    """

    def __init__(self, mesh=None, axis: str = "data",
                 slots_per_ct: int = 128,
                 stage_fn_builder: Callable = default_stage_fn_builder,
                 pad_batch_to: Optional[int] = None, device=None):
        if mesh is None:
            ranks = dist.get_world_size() if dist.is_initialized() else 1
            mesh = make_host_mesh(data=ranks, model=1, device=device)
        self.mesh = mesh
        self.device = mesh.device
        self.axis = axis
        self.slots_per_ct = slots_per_ct
        self.stage_fn_builder = stage_fn_builder
        # pad every batch to this many microbatches so each workload
        # builds exactly one round list (classic serving bucketing)
        self.pad_batch_to = pad_batch_to
        self._rounds: Dict[Tuple, List[List[Callable]]] = {}

    def _make_const(self, stage_idx: int):
        rng = np.random.default_rng(1000 + stage_idx)
        w = 1.0 - 1e-3 * rng.uniform(size=(self.slots_per_ct,))
        bias = 1e-3 * rng.standard_normal((self.slots_per_ct,))
        return torch.from_numpy(
            np.stack([w, bias]).astype(np.float32)).to(self.device)

    def _pack(self, batch: Batch, n_micro: int):
        x = np.zeros((n_micro, self.slots_per_ct), dtype=np.float32)
        for ct_i, group in enumerate(batch.slot_groups):
            off = 0
            for r in group:
                n = r.slots_needed
                if r.payload is not None:
                    try:
                        v = np.asarray(r.payload,
                                       dtype=np.float32).ravel()[:n]
                    except (TypeError, ValueError):
                        v = None   # opaque payload (e.g. a Ciphertext):
                    if v is not None:  # slots stay zero, request still rides
                        x[ct_i, off:off + len(v)] = v
                off += n
        return torch.from_numpy(x).to(self.device)

    def execute(self, schedule: PipelineSchedule, batch: Batch, *,
                key_cache: Optional[KeyCache],
                metrics: MetricsRegistry, workload: str,
                obs: Optional[ExecObs] = None) -> float:

        # residency accounting + device-resident constants (with no key
        # cache, constants are only materialized when building below)
        consts = None
        if key_cache is not None:
            consts = [key_cache.get_or_load(
                (workload, "stage", st.idx), st.const_bytes,
                loader=lambda i=st.idx: self._make_const(i))[0]
                for st in schedule.stages]

        # pad to the bucket size, but never below the actual batch —
        # a misconfigured pad_batch_to < max_batch must not drop groups
        n_micro = max(self.pad_batch_to or 0, batch.n_ciphertexts, 1)
        # one round list per (workload, stage count, bucket size);
        # _make_const is deterministic per stage idx, so stage bodies
        # built on the first call stay valid across keycache evictions
        key = (workload, len(schedule.stages), n_micro)
        if key not in self._rounds:
            if consts is None:
                consts = [self._make_const(st.idx)
                          for st in schedule.stages]
            fns = [self.stage_fn_builder(st, c)
                   for st, c in zip(schedule.stages, consts)]
            n_dev = self.mesh.shape[self.axis]
            rounds = []
            for i in range(0, len(fns), n_dev):
                chunk = fns[i:i + n_dev]
                chunk += [_identity_stage] * (n_dev - len(chunk))
                rounds.append(chunk)
            self._rounds[key] = rounds

        x = self._pack(batch, n_micro)
        t0 = time.perf_counter()
        out = run_load_save_pipeline(self._rounds[key], x, self.mesh,
                                     self.axis)
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        dt = time.perf_counter() - t0
        n_rounds = max(1, len(schedule.rounds))
        for st in schedule.stages:
            metrics.occupancy.add(st.partition, dt / n_rounds)
        batch.outputs = out
        if obs is not None and obs.tracer is not None:
            # the mesh measures the whole pipeline as one execution — no
            # per-stage decomposition, so a single execute span carries
            # the total (the reference's name, which trace readers key on)
            obs.tracer.span("xla_execute", obs.t0, obs.t0 + dt,
                            parent=obs.parent, track=obs.track,
                            n_rounds=n_rounds, n_micro=n_micro)
        return dt


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------

def record_request_completion(metrics: MetricsRegistry, r: Request,
                              done: float, service_start_s: float,
                              batch_span: Optional[int] = None) -> bool:
    """One request leaves the system: deadline check, latency +
    queue-delay/service-time decomposition, per-tenant attribution.
    Shared by the single executor and every fleet device so their
    accounting can never drift. Returns True iff completed in time.

    With tracing on, this is also the single site that completes a
    request's span tree: queue_wait and service children under the
    root, the service span linking (``batch_span``) to the batch that
    carried it, and the root closed with the terminal status — so the
    root's duration IS the recorded latency, by construction."""
    r.completion_s = done
    r.service_start_s = service_start_s
    metrics.incr("requests_served")
    tr, log = metrics.tracer, metrics.event_log
    tel, slo = metrics.telemetry, metrics.slo
    missed = r.deadline_s is not None and done > r.deadline_s
    if tel is not None:
        tel.counter("fhe_requests_finished",
                    status="deadline_miss" if missed
                    else "completed").inc(done)
        if r.deadline_s is not None and not missed:
            tel.counter("fhe_goodput_requests").inc(done)
    if slo is not None and r.deadline_s is not None:
        # the burn-rate monitor only sees SLO-bearing outcomes:
        # best-effort completions can't miss and must not dilute the
        # miss rate
        slo.record(done, missed, metrics)
    if tr is not None:
        root = tr.ensure_root(r)
        track = f"tenant:{r.tenant}"
        tr.span("queue_wait", r.arrival_s, service_start_s, parent=root,
                track=track, request_id=r.request_id)
        link = {} if batch_span is None else {"batch_span": batch_span}
        tr.span("service", service_start_s, done, parent=root,
                track=track, request_id=r.request_id, **link)
    if r.deadline_s is not None and done > r.deadline_s:
        r.status = RequestStatus.DEADLINE_MISS
        metrics.incr("deadline_misses")
        metrics.incr_tenant("deadline_misses", r.tenant)
        if tr is not None:
            tr.close_root(r, done, "deadline_miss")
        if log is not None:
            log.emit("deadline_miss", done, r)
        return False
    r.status = RequestStatus.COMPLETED
    metrics.request_latency.observe(r.latency())
    metrics.queue_delay.observe(max(0.0, service_start_s - r.arrival_s))
    metrics.service_time.observe(max(0.0, done - service_start_s))
    metrics.incr("requests_completed")
    metrics.incr_tenant("requests_completed", r.tenant)
    if r.deadline_s is not None:
        metrics.incr("requests_goodput")
    if tr is not None:
        tr.close_root(r, done, "completed", latency_s=r.latency())
    if log is not None:
        log.emit("completed", done, r, latency_s=r.latency())
    return True


BACKEND_NAMES = ("analytic", "mesh", "ciphertext", "pim")


def resolve_backend(name: str, params: CkksParams, mem: MemoryModel,
                    use_kernels: Optional[bool] = None,
                    device=None, verify: bool = False):
    """Build a backend from its CLI/ctor name: ``analytic`` (cost model),
    ``mesh`` (distributed placeholder stages over torch.distributed on
    `device`), ``ciphertext`` (real encrypted execution via
    repro_torch.compiler.engine on `device`), ``pim`` (discrete-event
    simulation of the hierarchical FHEmem hardware model, repro_torch.pim
    — the arch is recovered from `mem`: a preset projection maps back to
    its preset, anything else is wrapped in a degenerate arch billing
    exactly like AnalyticBackend). `device` is CUDA unless the caller
    asks for another.

    ``use_kernels`` (ciphertext backend only) routes keyswitch + modmul
    through the hand-written CUDA kernels; None keeps the backend's own
    default (on iff its device is CUDA).

    ``verify`` (pim backend only) arms the static hazard analyzer
    (repro_torch.analysis.pim_hazards) over every freshly lowered
    instruction stream."""
    if name == "analytic":
        return AnalyticBackend(mem)
    if name == "mesh":
        return MeshBackend(slots_per_ct=params.slots, device=device)
    if name == "ciphertext":
        from repro_torch.runtime.ciphertext_backend import CiphertextBackend
        return CiphertextBackend(params, use_kernels=use_kernels,
                                 device=device)
    if name == "pim":
        from repro_torch.pim.backend import resolve_pim_backend
        return resolve_pim_backend(mem, verify=verify)
    from repro_torch.pim.arch import PRESETS
    raise ValueError(
        f"unknown backend {name!r}: valid backends are "
        f"{', '.join(repr(n) for n in BACKEND_NAMES)}; the 'pim' "
        f"backend additionally takes a hardware preset out of "
        f"{', '.join(repr(p) for p in sorted(PRESETS))} "
        f"(serve_fhe --pim-preset / repro_torch.pim.arch.get_arch)")


class PipelinedExecutor:
    """Admission queue → slot batcher → compile cache → backend, driven
    on a virtual clock (event times from the analytic backend) or wall
    clock deltas (mesh/ciphertext backends) — the loop is the same
    either way. `backend` may be an instance or a name ("analytic" |
    "mesh" | "ciphertext" | "pim")."""

    def __init__(self, params: CkksParams, mem: MemoryModel,
                 backend=None, policy: Optional[BatchPolicy] = None,
                 key_cache: Optional[KeyCache] = None,
                 max_depth_per_tenant: int = 256,
                 mapper: Callable[..., PipelineSchedule]
                 = generate_load_save_pipeline,
                 pass_config: Optional[PassConfig] = None,
                 verify: bool = False):
        self.params = params
        self.mem = mem
        self.metrics = MetricsRegistry(n_partitions=mem.n_partitions)
        if isinstance(backend, str):
            backend = resolve_backend(backend, params, mem)
        self.backend = backend or AnalyticBackend(mem)
        self.policy = policy or BatchPolicy(slots_per_ct=params.slots)
        self.queue = AdmissionQueue(max_depth_per_tenant, self.metrics)
        self.batcher = SlotBatcher(self.queue, self.policy, self.metrics)
        # pad every mesh and ciphertext batch to max_batch, so warmup()
        # meets the same shapes (and builds the same round lists and
        # tables) every batch will use
        if getattr(self.backend, "pad_batch_to", 0) is None:
            self.backend.pad_batch_to = self.policy.max_batch
        self.key_cache = key_cache
        if key_cache is not None:
            key_cache.metrics = self.metrics   # one registry for all parts
        # verify=True arms static verify-on-miss (repro_torch.analysis):
        # every freshly compiled schedule is swept before it can serve
        self.compile_cache = CompileCache(self.metrics, verify=verify)
        self.mapper = mapper
        # optimizing compiler (repro.compiler) between capture and the
        # mapper; None serves every trace verbatim
        self.pass_config = pass_config
        self.workloads: Dict[str, Workload] = {}

    # -- workload registry ---------------------------------------------------

    def register(self, name: str, fn: Callable, n_inputs: int,
                 const_names: Sequence[str] = (),
                 start_level: int = 10) -> Workload:
        trace = trace_program(fn, n_inputs, const_names)
        try:
            infer_levels(trace, start_level=start_level)
        except LevelBudgetExhausted:
            # deeper than the chain: admissible only when the compiler's
            # bootstrap-insertion pass will rewrite it at compile time
            # (inputs keep their level so the compiler knows the start)
            if not (self.pass_config and self.pass_config.bootstrap):
                raise
        w = Workload(name, trace)
        self.workloads[name] = w
        return w

    def register_trace(self, name: str, trace: FheTrace) -> Workload:
        w = Workload(name, trace)
        self.workloads[name] = w
        return w

    # -- request path --------------------------------------------------------

    def next_request_id(self) -> int:
        return self.queue.next_request_id()

    def submit(self, tenant: str, workload: str, now: float,
               slots_needed: int = 1, deadline_s: Optional[float] = None,
               payload=None) -> Request:
        assert workload in self.workloads, f"unregistered workload {workload}"
        req = Request(self.queue.next_request_id(), tenant, workload,
                      arrival_s=now, slots_needed=slots_needed,
                      deadline_s=deadline_s, payload=payload)
        self._admit(req)
        return req

    def _admit(self, req: Request) -> None:
        """Admission door: a request that can never fit one ciphertext
        is rejected here, not left to starve in the queue."""
        if req.slots_needed > self.policy.slots_per_ct:
            req.status = RequestStatus.REJECTED
            self.metrics.incr("requests_oversized")
            tr, log = self.metrics.tracer, self.metrics.event_log
            if tr is not None:
                tr.close_root(req, req.arrival_s, "rejected",
                              reason="oversized")
            if log is not None:
                log.emit("rejected", req.arrival_s, req, reason="oversized")
        else:
            self.queue.submit(req)

    def warmup(self) -> float:
        """Pre-compile every registered workload and pre-load its stage
        constants (deploy-time work that must not count against request
        deadlines: on the mesh backend the first execution builds the
        round lists, on the ciphertext backend it pays key generation and
        table construction). Returns wall seconds spent."""
        t0 = time.perf_counter()
        scratch = MetricsRegistry(self.mem.n_partitions)
        # deploy-time misses must not dilute the SERVING hit rates:
        # point every cache at the scratch registry for the duration
        saved_cc, self.compile_cache.metrics = self.compile_cache.metrics, \
            scratch
        saved_kc = None
        if self.key_cache is not None:
            saved_kc, self.key_cache.metrics = self.key_cache.metrics, \
                scratch
        try:
            for name, w in self.workloads.items():
                sched = self.compile_cache.get_schedule(
                    w.trace, self.params, self.mem, self.mapper,
                    pass_config=self.pass_config)
                self.backend.execute(sched, Batch(name, [], [[]], 0.0),
                                     key_cache=self.key_cache,
                                     metrics=scratch, workload=name)
        finally:
            self.compile_cache.metrics = saved_cc
            if saved_kc is not None:
                self.key_cache.metrics = saved_kc
        return time.perf_counter() - t0

    def _execute_batch(self, batch: Batch, now: float) -> float:
        tr, tel = self.metrics.tracer, self.metrics.telemetry
        bspan = obs = None
        if tr is not None:
            bspan = tr.begin(f"batch:{batch.workload}", now,
                             track="device:0", workload=batch.workload,
                             n_requests=len(batch.requests),
                             n_ciphertexts=batch.n_ciphertexts)
        if tr is not None or tel is not None:
            # telemetry alone still needs the timeline origin threaded
            # into the backend (ExecObs.t0); span emission stays off
            obs = ExecObs(tr, bspan, now, "device:0")
        if tel is not None:
            tel.gauge("fhe_device_queue_depth",
                      device=self.queue.owner).set(now, len(self.queue))
        sched = self.compile_cache.get_schedule(
            self.workloads[batch.workload].trace, self.params, self.mem,
            self.mapper, pass_config=self.pass_config, obs=obs)
        service_s = self.backend.execute(
            sched, batch, key_cache=self.key_cache, metrics=self.metrics,
            workload=batch.workload, obs=obs)
        done = now + service_s
        if tr is not None:
            tr.end(bspan, done)
        for r in batch.requests:
            record_request_completion(self.metrics, r, done,
                                      service_start_s=now,
                                      batch_span=bspan)
        self.metrics.batch_service.observe(service_s)
        return service_s

    # -- event loop ----------------------------------------------------------

    def serve(self, arrivals: List[Request],
              start_s: float = 0.0) -> MetricsRegistry:
        """Drain a pre-generated arrival schedule (sorted by arrival_s).

        Single-server semantics: the pipeline serves one batch at a
        time; arrivals landing mid-service are admitted when it ends —
        so saturation shows up as queue growth and latency, exactly
        what the fig16 sweep measures.
        """
        pending = sorted(arrivals, key=lambda r: r.arrival_s)
        i = 0
        now = start_s
        while i < len(pending) or len(self.queue):
            while i < len(pending) and pending[i].arrival_s <= now:
                self._admit(pending[i])
                i += 1
            batch = self.batcher.poll(now)
            if batch is not None:
                now += self._execute_batch(batch, now)
                continue
            # idle: jump to the next event
            events = []
            if i < len(pending):
                events.append(pending[i].arrival_s)
            t_fire = self.batcher.next_fire_time(now)
            if t_fire is not None:
                events.append(t_fire)
            if not events:
                break                  # only expired/unservable work left
            now = max(math.nextafter(now, math.inf), min(events))
        self.metrics.elapsed_s = max(self.metrics.elapsed_s, now - start_s)
        if self.metrics.tracer is not None:
            self.metrics.tracer.close_open(now)
        return self.metrics
