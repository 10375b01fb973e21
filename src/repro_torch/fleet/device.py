"""`Device` — one simulated FHE accelerator inside a fleet.

A device owns the full single-server serving stack the
`PipelinedExecutor` established (admission queue → slot batcher → key
cache → compile cache → backend) plus discrete-event state
(``busy_until``) so a `FleetScheduler` can interleave N of them on one
virtual clock. The backend is any `resolve_backend` name — the
discrete-event `PimBackend` and `AnalyticBackend` make multi-device
simulation cheap; wall-clock backends (mesh/ciphertext) work too but
serve batches atomically.

Two execution paths per batch:

* **atomic** — `backend.execute` end to end, float-identical to
  `PipelinedExecutor._execute_batch` (the fleet(N=1) ≡ single-executor
  regression anchor).
* **stepped** — a `Flight`: the batch streams round by round
  (`backend.round_seconds`), and between rounds the device can
  **refill** free slot rows with newly queued requests of the same
  workload (continuous slot batching) or be **preempted** by a
  deadline-bearing batch (SLO scheduling). A row that joins at a round
  boundary trails the lead wave through the pipeline — the load-save
  pipeline frees a round's partitions once the wave passes — so it
  rides the next `R` round-steps regardless of entry phase; each
  round-step is billed at the batch occupancy current when it issues.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set

from repro_torch.core.params import CkksParams
from repro_torch.core.pipeline import (MemoryModel, PipelineSchedule,
                                       generate_load_save_pipeline)
from repro_torch.obs.tracer import ExecObs
from repro_torch.runtime.batcher import Batch, BatchPolicy, SlotBatcher
from repro_torch.runtime.compile_cache import CompileCache
from repro_torch.runtime.executor import record_request_completion
from repro_torch.runtime.keycache import KeyCache
from repro_torch.runtime.metrics import MetricsRegistry
from repro_torch.runtime.queue import AdmissionQueue, Request, RequestStatus


class Flight:
    """An in-flight batch streamed round by round with mutable
    membership. ``rounds_left[rid]`` counts the round-steps request
    ``rid`` still has to ride; a joiner enters with the full round
    count and wraps behind the lead wave."""

    def __init__(self, batch: Batch, schedule: PipelineSchedule,
                 slots_per_ct: int, now: float):
        self.workload = batch.workload
        self.schedule = schedule
        self.n_rounds = max(1, len(schedule.rounds))
        self.groups: List[List[Request]] = batch.slot_groups
        self.free: List[int] = [
            slots_per_ct - sum(r.slots_needed for r in g)
            for g in self.groups]
        self.members: Dict[int, Request] = {
            r.request_id: r for r in batch.requests}
        self.rounds_left: Dict[int, int] = {
            rid: self.n_rounds for rid in self.members}
        self.service_start: Dict[int, float] = {
            rid: now for rid in self.members}
        self.cursor = 0            # next round index to execute
        self.step_dt = 0.0         # duration of the step in service
        self.total_service = 0.0
        self.span: Optional[int] = None   # open batch span (tracing on)
        self.obs: Optional[ExecObs] = None
        self.n_refills = 0

    @property
    def occupancy(self) -> int:
        return max(1, sum(1 for g in self.groups if g))

    def best_effort(self) -> bool:
        """Preemptable iff no member carries a deadline."""
        return all(r.deadline_s is None for r in self.members.values())

    def min_rounds_left(self) -> int:
        return min(self.rounds_left.values()) if self.rounds_left else 0

    def absorb(self, joined: List[Request], now: float) -> None:
        for r in joined:
            self.members[r.request_id] = r
            self.rounds_left[r.request_id] = self.n_rounds
            self.service_start[r.request_id] = now

    def finish_step(self, now: float,
                    metrics: MetricsRegistry) -> List[Request]:
        """Account the step that just ended: advance the round cursor,
        decrement every rider, complete members that have seen all
        rounds (freeing their slot rows for refill)."""
        self.total_service += self.step_dt
        self.cursor = (self.cursor + 1) % self.n_rounds
        done: List[Request] = []
        for rid in list(self.rounds_left):
            self.rounds_left[rid] -= 1
            if self.rounds_left[rid] == 0:
                done.append(self.members.pop(rid))
                del self.rounds_left[rid]
        for r in done:
            record_request_completion(metrics, r, now,
                                      self.service_start.pop(r.request_id),
                                      batch_span=self.span)
        if done:
            gone = {r.request_id for r in done}
            for i, g in enumerate(self.groups):
                kept = [r for r in g if r.request_id not in gone]
                if len(kept) != len(g):
                    self.free[i] += sum(r.slots_needed for r in g
                                        if r.request_id in gone)
                    self.groups[i] = kept
        return done

    def evacuate(self) -> List[Request]:
        """Preemption: hand back every unfinished member (progress is
        lost — the wasted rounds already hit the occupancy meters)."""
        out = list(self.members.values())
        self.members.clear()
        self.rounds_left.clear()
        self.service_start.clear()
        for g in self.groups:
            g.clear()
        return out


class Device:
    """One fleet device: private queue/batcher/caches/backend plus the
    ``busy_until`` clock the scheduler sequences."""

    def __init__(self, device_id: int, params: CkksParams,
                 mem: MemoryModel, backend, policy: BatchPolicy,
                 metrics: MetricsRegistry,
                 key_cache: Optional[KeyCache] = None,
                 max_depth_per_tenant: int = 256,
                 mapper: Callable[..., PipelineSchedule]
                 = generate_load_save_pipeline,
                 pass_config=None,
                 continuous_batching: bool = False,
                 preempt: bool = False,
                 verify: bool = False):
        self.device_id = device_id
        self.params = params
        self.mem = mem
        self.backend = backend
        self.policy = policy
        self.metrics = metrics
        self.queue = AdmissionQueue(max_depth_per_tenant, metrics)
        self.queue.owner = str(device_id)   # queue-depth series label
        self.batcher = SlotBatcher(self.queue, self.policy, metrics)
        self.key_cache = key_cache
        if key_cache is not None:
            key_cache.metrics = metrics
        self.compile_cache = CompileCache(metrics, verify=verify)
        self.mapper = mapper
        self.pass_config = pass_config
        self.continuous_batching = continuous_batching
        self.preempt = preempt
        if getattr(self.backend, "pad_batch_to", 0) is None:
            self.backend.pad_batch_to = self.policy.max_batch
        self.busy_until = 0.0
        self.flight: Optional[Flight] = None
        self._atomic_in_service = False
        self.compiled: Set[str] = set()

    # -- state queries (router/scheduler) ------------------------------------

    def busy(self) -> bool:
        return self.flight is not None or self._atomic_in_service

    def load_slots(self, now: float) -> int:
        """Backlog in slots: queued demand plus in-flight residency —
        the least-loaded router's comparison key."""
        queued = 0
        for w in self.queue.pending_workloads(now):
            queued += self.queue.pending_demand(now, w)[1]
        inflight = 0
        if self.flight is not None:
            inflight = sum(r.slots_needed
                           for r in self.flight.members.values())
        elif self._atomic_in_service:
            inflight = self.policy.slots_per_ct   # opaque atomic batch
        return queued + inflight

    def is_warm(self, workload: str) -> bool:
        """Cache-affinity signal: stage constants of this workload are
        resident in the device's key cache (admission-time placement
        steers followers here); with no key cache, fall back to the
        compile cache."""
        if self.key_cache is not None:
            return self.key_cache.has_prefix((workload,))
        return workload in self.compiled

    # -- admission -----------------------------------------------------------

    def admit(self, req: Request) -> None:
        """Mirror of PipelinedExecutor._admit: reject what can never
        fit one ciphertext at the door."""
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

    # -- compile -------------------------------------------------------------

    def schedule_for(self, workload: str, trace,
                     obs: Optional[ExecObs] = None) -> PipelineSchedule:
        sched = self.compile_cache.get_schedule(
            trace, self.params, self.mem, self.mapper,
            pass_config=self.pass_config, obs=obs)
        self.compiled.add(workload)
        return sched

    # -- event handling ------------------------------------------------------

    def _poll_order(self, now: float) -> Optional[List[str]]:
        """Earliest-deadline-first workload order when the fleet is
        SLO-aware; None keeps the batcher's first-arrival order."""
        if not self.preempt:
            return None
        ws = self.queue.pending_workloads(now)

        def key(w):
            dl = self.queue.earliest_deadline(now, w)
            return (0, dl) if dl is not None else (1, 0.0)
        return sorted(ws, key=key)

    def on_idle(self, now: float, workloads: Dict[str, object]) -> bool:
        """Called by the scheduler whenever ``busy_until <= now``.
        Returns True iff the device changed state (completed work or
        started new work)."""
        progressed = False
        if self._atomic_in_service:
            # completions were recorded at dispatch; just free the slot
            self._atomic_in_service = False
            tel = self.metrics.telemetry
            if tel is not None:
                tel.gauge("fhe_device_inflight_occupancy",
                          device=self.device_id).set(now, 0.0)
            progressed = True
        if self.flight is not None:
            self._flight_boundary(now)
            progressed = True
        if self.flight is None and not self._atomic_in_service:
            batch = self.batcher.poll(now, order=self._poll_order(now))
            if batch is not None:
                self._start_batch(batch, now, workloads)
                progressed = True
        return progressed

    def _start_batch(self, batch: Batch, now: float,
                     workloads: Dict[str, object]) -> None:
        trace = workloads[batch.workload].trace
        tr = self.metrics.tracer
        tel = self.metrics.telemetry
        track = f"device:{self.device_id}"
        bspan = obs = None
        if tr is not None:
            bspan = tr.begin(f"batch:{batch.workload}", now, track=track,
                             workload=batch.workload,
                             n_requests=len(batch.requests),
                             n_ciphertexts=batch.n_ciphertexts,
                             device=self.device_id)
        if tr is not None or tel is not None:
            # telemetry alone still needs the DES timeline origin
            # threaded into round_seconds; spans stay off
            obs = ExecObs(tr, bspan, now, track)
        if tel is not None:
            tel.gauge("fhe_device_queue_depth",
                      device=self.device_id).set(now, len(self.queue))
            tel.gauge("fhe_device_inflight_occupancy",
                      device=self.device_id).set(
                          now, batch.n_ciphertexts
                          / max(1, self.policy.max_batch))
        sched = self.schedule_for(batch.workload, trace, obs=obs)
        stepped = ((self.continuous_batching or self.preempt)
                   and hasattr(self.backend, "round_seconds")
                   and len(sched.rounds) > 0)
        if not stepped:
            # float-identical to PipelinedExecutor._execute_batch —
            # the fleet(N=1) regression anchor
            service_s = self.backend.execute(
                sched, batch, key_cache=self.key_cache,
                metrics=self.metrics, workload=batch.workload, obs=obs)
            done = now + service_s
            if tr is not None:
                tr.end(bspan, done)
            for r in batch.requests:
                record_request_completion(self.metrics, r, done,
                                          service_start_s=now,
                                          batch_span=bspan)
            self.metrics.batch_service.observe(service_s)
            self.metrics.add_device_busy(self.device_id, service_s)
            self.busy_until = done
            self._atomic_in_service = True
            return
        self.flight = Flight(batch, sched, self.policy.slots_per_ct, now)
        self.flight.span = bspan
        self.flight.obs = obs
        self._begin_step(now)

    def _begin_step(self, now: float) -> None:
        f = self.flight
        tel = self.metrics.telemetry
        if tel is not None:
            # in-flight occupancy at every round boundary: the stepped
            # path's membership changes between rounds (refill /
            # completion), which is exactly what this series shows
            tel.gauge("fhe_device_inflight_occupancy",
                      device=self.device_id).set(
                          now, f.occupancy
                          / max(1, self.policy.max_batch))
        dt = self.backend.round_seconds(
            f.schedule, f.schedule.rounds[f.cursor], f.occupancy,
            key_cache=self.key_cache, metrics=self.metrics,
            workload=f.workload,
            obs=f.obs.at(now) if f.obs is not None else None)
        f.step_dt = dt
        self.metrics.add_device_busy(self.device_id, dt)
        self.busy_until = now + dt

    def _flight_boundary(self, now: float) -> None:
        """A round-step just ended: complete finished riders, then —
        in order — preempt for a firing deadline batch, refill free
        slot rows, or issue the next round-step."""
        f = self.flight
        tr, log = self.metrics.tracer, self.metrics.event_log
        tel = self.metrics.telemetry
        f.finish_step(now, self.metrics)
        if not f.members:
            self.metrics.batch_service.observe(f.total_service)
            if tr is not None and f.span is not None:
                tr.end(f.span, now, n_refills=f.n_refills)
            if tel is not None:
                tel.gauge("fhe_device_inflight_occupancy",
                          device=self.device_id).set(now, 0.0)
            self.flight = None
            return
        if self.preempt and f.best_effort() and f.min_rounds_left() > 1 \
                and self._deadline_batch_ready(now):
            evicted = f.evacuate()
            # front-requeue latest-arrival first so each tenant queue
            # stays in arrival order (same convention as the batcher's
            # overflow path); lost rounds were already billed
            for r in sorted(evicted, key=lambda r: r.arrival_s,
                            reverse=True):
                self.queue.requeue(r)
            self.metrics.incr("preemptions")
            self.metrics.incr("requests_preempted", len(evicted))
            self.metrics.batch_service.observe(f.total_service)
            if tr is not None:
                for r in evicted:
                    tr.instant("preempt", now, parent=tr.ensure_root(r),
                               track=f"tenant:{r.tenant}",
                               request_id=r.request_id,
                               device=self.device_id)
                if f.span is not None:
                    tr.end(f.span, now, preempted=True,
                           n_evicted=len(evicted), n_refills=f.n_refills)
            if log is not None:
                for r in evicted:
                    log.emit("preempted", now, r, device=self.device_id)
            if tel is not None:
                tel.gauge("fhe_device_inflight_occupancy",
                          device=self.device_id).set(now, 0.0)
            self.flight = None
            return
        if self.continuous_batching:
            joined = self.batcher.refill(
                now, f.workload, f.groups, f.free, self.policy.max_batch)
            if joined:
                f.absorb(joined, now)
                f.n_refills += 1
        self._begin_step(now)

    def _deadline_batch_ready(self, now: float) -> bool:
        """Is a deadline-bearing workload's batch ready to fire on this
        device right now? (The preemption trigger.)"""
        for w in self.queue.pending_workloads(now):
            if self.queue.earliest_deadline(now, w) is None:
                continue
            if self.batcher.should_fire(now, w):
                return True
        return False

    # -- warmup --------------------------------------------------------------

    def warmup(self, workloads: Dict[str, object],
               scratch: MetricsRegistry,
               preload_keys: bool = True) -> None:
        """Deploy-time compile (+ optional stage-constant preload)
        against a scratch registry so serving hit rates stay clean —
        the per-device mirror of PipelinedExecutor.warmup."""
        saved_cc, self.compile_cache.metrics = \
            self.compile_cache.metrics, scratch
        saved_kc = None
        if self.key_cache is not None:
            saved_kc, self.key_cache.metrics = \
                self.key_cache.metrics, scratch
        try:
            for name, w in workloads.items():
                sched = self.schedule_for(name, w.trace)
                if preload_keys:
                    self.backend.execute(
                        sched, Batch(name, [], [[]], 0.0),
                        key_cache=self.key_cache, metrics=scratch,
                        workload=name)
        finally:
            self.compile_cache.metrics = saved_cc
            if saved_kc is not None:
                self.key_cache.metrics = saved_kc
