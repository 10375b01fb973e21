"""Admission-time request routing across fleet devices.

Three pluggable policies (``serve_fhe --router ...``):

* ``round_robin``   — cycle devices; the baseline every ablation is
                      measured against.
* ``least_loaded``  — steer to the device with the smallest backlog
                      (queued slots + in-flight residency, tie-broken
                      round-robin so idle fleets still spread).
* ``cache_affinity``— steer a workload to devices whose key/compile
                      caches are already warm (admission-time
                      placement): followers land where the stage
                      constants — evk, rotation keys, plaintext
                      weights — are resident, so the per-round load
                      term stays zero instead of re-streaming on every
                      device the workload touches. Cold workloads get
                      a sticky least-loaded placement; once warm, the
                      residency signal itself governs. Affinity is a
                      preference, not a pin: when the warmest
                      candidate's backlog exceeds the globally
                      least-loaded device by more than one full batch
                      of slots, the request spills there instead —
                      warming a second replica — so a hot workload
                      widens its footprint rather than melting one
                      device (affinity without spillover loses to
                      round_robin the moment load skews).

Every routing decision records whether it landed on a warm device
(``routing_hits``/``routing_misses`` → ``MetricsRegistry.hit_rate
("routing")``), which is the fig20 ablation's routing-hit-rate column.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.fleet.device import Device
from repro_torch.runtime.metrics import MetricsRegistry
from repro_torch.runtime.queue import Request

POLICIES = ("round_robin", "least_loaded", "cache_affinity")


class Router:
    def __init__(self, policy: str, devices: List[Device],
                 metrics: Optional[MetricsRegistry] = None):
        if policy not in POLICIES:
            raise ValueError(f"unknown router policy {policy!r} "
                             f"(expected one of {', '.join(POLICIES)})")
        self.policy = policy
        self.devices = devices
        self.metrics = metrics or MetricsRegistry()
        self._rr = 0
        # cache_affinity: sticky placement for not-yet-warm workloads,
        # so a burst of a cold workload doesn't splatter across devices
        # before the first batch has a chance to warm one cache
        self._placement: Dict[str, Device] = {}

    def route(self, req: Request, now: float) -> Device:
        if self.policy == "round_robin":
            dev = self.devices[self._rr % len(self.devices)]
            self._rr += 1
        elif self.policy == "least_loaded":
            dev = self._least_loaded(self.devices, now)
        else:
            dev = self._affinity(req.workload, now)
        warm = dev.is_warm(req.workload)
        self.metrics.incr("routing_hits" if warm else "routing_misses")
        tr, log = self.metrics.tracer, self.metrics.event_log
        if tr is not None:
            # the router touches a request before any queue: this
            # materializes the root span, with the placement decision
            # as its first child
            tr.instant("route", now, parent=tr.ensure_root(req),
                       track=f"tenant:{req.tenant}",
                       request_id=req.request_id, device=dev.device_id,
                       policy=self.policy, warm=warm)
        if log is not None:
            log.emit("routed", now, req, device=dev.device_id,
                     policy=self.policy, warm=warm)
        return dev

    def _least_loaded(self, candidates: List[Device],
                      now: float) -> Device:
        n = len(self.devices)
        start = self._rr % n
        self._rr += 1
        best, best_key = None, None
        for d in candidates:
            key = (d.load_slots(now),
                   (d.device_id - start) % n)   # rotate tie-breaks
            if best_key is None or key < best_key:
                best, best_key = d, key
        return best

    def _affinity(self, workload: str, now: float) -> Device:
        warm = [d for d in self.devices if d.is_warm(workload)]
        if warm:
            dev = self._least_loaded(warm, now)
            coldest = self._least_loaded(self.devices, now)
            # spillover: re-streaming constants on a fresh device beats
            # queueing a full extra batch behind the warm one
            if dev.load_slots(now) > coldest.load_slots(now) + \
                    dev.policy.capacity_slots:
                dev = coldest
            self._placement[workload] = dev
            return dev
        dev = self._placement.get(workload)
        if dev is None:
            dev = self._least_loaded(self.devices, now)
            self._placement[workload] = dev
        return dev
