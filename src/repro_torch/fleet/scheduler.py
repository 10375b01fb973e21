"""`FleetScheduler` — the multi-device generalization of
`PipelinedExecutor.serve`: one virtual clock sequencing N `Device`s,
with admission-time routing (repro_torch.fleet.router), SLO-aware
deadline priority with preemption at round boundaries, and continuous
slot batching (repro_torch.fleet.device.Flight).

Invariant the whole layer hangs on: a fleet of ONE device with
``router="round_robin"``, ``continuous_batching=False`` and
``preempt=False`` reproduces the single `PipelinedExecutor` — same
batches at the same virtual times, float-identical latency and
throughput (regression-tested in tests/test_fleet.py). Everything the
fleet adds is opt-in on top of that anchor.

Event loop semantics: requests are routed to a device at admission
(routing is placement, not work stealing — a queued request never
migrates; FHE payloads are encrypted under device-resident keys, so
migration would re-pay the key/constant streaming the router exists
to avoid). Each device serves its own queue one batch at a time;
the scheduler advances the shared clock to the next event (arrival,
device completion/round boundary, or batcher fire time).
"""
from __future__ import annotations

import itertools
import math
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.compiler import PassConfig
from repro_torch.core.params import CkksParams
from repro_torch.core.pipeline import (MemoryModel, PipelineSchedule,
                                       generate_load_save_pipeline)
from repro_torch.core.trace import (FheTrace, LevelBudgetExhausted,
                                    infer_levels, trace_program)
from repro_torch.fleet.device import Device
from repro_torch.fleet.router import POLICIES, Router
from repro_torch.runtime.batcher import BatchPolicy
from repro_torch.runtime.executor import Workload, resolve_backend
from repro_torch.runtime.keycache import KeyCache
from repro_torch.runtime.metrics import MetricsRegistry
from repro_torch.runtime.queue import Request


class FleetScheduler:
    """N devices, one clock, one metrics scoreboard.

    ``backend`` is a `resolve_backend` name (each device gets its OWN
    instance — private lowering memos, kernel tables, serving keys) or a
    zero-arg factory returning a backend instance per device (serve_fhe
    passes one that builds each device's engine on its torch device).
    """

    def __init__(self, params: CkksParams, mem: MemoryModel,
                 n_devices: int = 1, backend="analytic",
                 router: str = "round_robin",
                 policy: Optional[BatchPolicy] = None,
                 cache_bytes: int = 0,
                 max_depth_per_tenant: int = 256,
                 mapper: Callable[..., PipelineSchedule]
                 = generate_load_save_pipeline,
                 pass_config: Optional[PassConfig] = None,
                 continuous_batching: bool = False,
                 preempt: bool = False,
                 latency_reservoir: Optional[int] = None,
                 verify: bool = False):
        assert n_devices >= 1
        self.params = params
        self.mem = mem
        # latency_reservoir bounds the latency accumulators' memory on
        # fig20-scale sweeps (None = exact, unbounded)
        self.metrics = MetricsRegistry(n_partitions=mem.n_partitions,
                                       latency_reservoir=latency_reservoir)
        self.policy = policy or BatchPolicy(slots_per_ct=params.slots)
        self.pass_config = pass_config
        self.continuous_batching = continuous_batching
        self.preempt = preempt

        def make_backend():
            if isinstance(backend, str):
                return resolve_backend(backend, params, mem)
            return backend()

        self.devices: List[Device] = []
        for i in range(n_devices):
            kc = (KeyCache(cache_bytes, load_bw=mem.load_bw)
                  if cache_bytes > 0 else None)
            self.devices.append(Device(
                i, params, mem, make_backend(), self.policy, self.metrics,
                key_cache=kc, max_depth_per_tenant=max_depth_per_tenant,
                mapper=mapper, pass_config=pass_config,
                continuous_batching=continuous_batching, preempt=preempt,
                verify=verify))
            self.metrics.device_busy_s.setdefault(i, 0.0)
        self.router = Router(router, self.devices, self.metrics)
        self.workloads: Dict[str, Workload] = {}
        self._id = itertools.count()

    # -- workload registry (mirrors PipelinedExecutor) -----------------------

    def register(self, name: str, fn: Callable, n_inputs: int,
                 const_names: Sequence[str] = (),
                 start_level: int = 10) -> Workload:
        trace = trace_program(fn, n_inputs, const_names)
        try:
            infer_levels(trace, start_level=start_level)
        except LevelBudgetExhausted:
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
        return next(self._id)

    def submit(self, tenant: str, workload: str, now: float,
               slots_needed: int = 1, deadline_s: Optional[float] = None,
               payload=None) -> Request:
        assert workload in self.workloads, f"unregistered workload {workload}"
        req = Request(self.next_request_id(), tenant, workload,
                      arrival_s=now, slots_needed=slots_needed,
                      deadline_s=deadline_s, payload=payload)
        self._route_and_admit(req, now)
        return req

    def _route_and_admit(self, req: Request, now: float) -> None:
        self.router.route(req, now).admit(req)

    def warmup(self, preload_keys: bool = True) -> None:
        """Deploy-time compile (and optionally key preload) on every
        device, against a scratch registry so serving-time hit rates
        stay clean. ``preload_keys=False`` leaves every key cache cold
        — the regime where cache-affinity routing earns its keep
        (warmth then comes only from serving traffic)."""
        scratch = MetricsRegistry(self.mem.n_partitions)
        for dev in self.devices:
            dev.warmup(self.workloads, scratch, preload_keys=preload_keys)

    # -- event loop ----------------------------------------------------------

    def _work_remains(self, now: float) -> bool:
        if any(d.busy() for d in self.devices):
            return True
        return any(len(d.queue) for d in self.devices)

    def serve(self, arrivals: List[Request],
              start_s: float = 0.0) -> MetricsRegistry:
        """Drain a pre-generated arrival schedule (sorted by
        arrival_s) across the fleet. Multi-server semantics: each
        device serves one batch (or one flight round-step) at a time;
        the clock jumps to the earliest pending event."""
        pending = sorted(arrivals, key=lambda r: r.arrival_s)
        i = 0
        now = start_s
        while True:
            while i < len(pending) and pending[i].arrival_s <= now:
                self._route_and_admit(pending[i], now)
                i += 1
            progressed = False
            for dev in self.devices:
                if dev.busy_until <= now:
                    progressed |= dev.on_idle(now, self.workloads)
            if progressed:
                continue
            # idle: jump to the next event
            events = []
            if i < len(pending):
                events.append(pending[i].arrival_s)
            for dev in self.devices:
                if dev.busy():
                    events.append(dev.busy_until)
                else:
                    t_fire = dev.batcher.next_fire_time(now)
                    if t_fire is not None:
                        events.append(t_fire)
            if not events:
                break              # only expired/unservable work left
            now = max(math.nextafter(now, math.inf), min(events))
        self.metrics.elapsed_s = max(self.metrics.elapsed_s, now - start_s)
        if self.metrics.tracer is not None:
            self.metrics.tracer.close_open(now)
        return self.metrics


def build_fleet(params: CkksParams, mem: MemoryModel, *, n_devices: int,
                backend: str = "analytic", router: str = "round_robin",
                policy: Optional[BatchPolicy] = None, cache_bytes: int = 0,
                pass_config: Optional[PassConfig] = None,
                continuous_batching: bool = False,
                preempt: bool = False,
                latency_reservoir: Optional[int] = None) -> FleetScheduler:
    """Keyword-armored convenience constructor (the serve_fhe/fig20
    entry point)."""
    return FleetScheduler(
        params, mem, n_devices=n_devices, backend=backend, router=router,
        policy=policy, cache_bytes=cache_bytes, pass_config=pass_config,
        continuous_batching=continuous_batching, preempt=preempt,
        latency_reservoir=latency_reservoir)


__all__ = ["FleetScheduler", "build_fleet", "POLICIES"]
