"""Admission control + per-tenant request queues with deadlines.

A ``Request`` names a workload (a registered FHE program — its trace is
compiled once and cached) and how many CKKS slots its encrypted payload
occupies. Admission rejects when a tenant's queue is full
(load-shedding at the door beats timing out deep in the pipeline), and
dequeue drops requests whose deadline already passed — the batcher
never wastes pipeline rounds on work nobody is waiting for.

Dequeue order is round-robin across tenants (one request per tenant
per rotation) so one heavy tenant cannot starve the rest — the
multi-tenant analogue of the paper's fair use of pipeline rounds
across the input batch.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.runtime.metrics import MetricsRegistry


class RequestStatus(enum.Enum):
    QUEUED = "queued"
    BATCHED = "batched"
    COMPLETED = "completed"
    REJECTED = "rejected"
    DEADLINE_MISS = "deadline_miss"


@dataclasses.dataclass
class Request:
    request_id: int
    tenant: str
    workload: str                    # key into the executor's workload registry
    arrival_s: float
    slots_needed: int = 1            # CKKS slots the encrypted payload occupies
    deadline_s: Optional[float] = None   # absolute; None = best-effort
    payload: object = None           # opaque ciphertext (mesh backend) or None
    status: RequestStatus = RequestStatus.QUEUED
    completion_s: Optional[float] = None
    service_start_s: Optional[float] = None   # backend execution began
    #                                           (latency = queue delay up
    #                                           to here + service after)

    def latency(self) -> float:
        assert self.completion_s is not None
        return self.completion_s - self.arrival_s

    def expired(self, now: float) -> bool:
        return self.deadline_s is not None and now > self.deadline_s


class AdmissionQueue:
    """Per-tenant FIFO queues behind one admission door."""

    def __init__(self, max_depth_per_tenant: int = 256,
                 metrics: Optional[MetricsRegistry] = None):
        self.max_depth = max_depth_per_tenant
        self.queues: Dict[str, Deque[Request]] = {}
        self.metrics = metrics or MetricsRegistry()
        # telemetry label for the queue-depth series: the fleet sets
        # this to the owning device id (Device ctor); "0" is the
        # single-executor door
        self.owner = "0"
        self._rr = itertools.count()     # tenant rotation cursor
        self._id = itertools.count()

    def next_request_id(self) -> int:
        return next(self._id)

    def __len__(self) -> int:
        return sum(len(q) for q in self.queues.values())

    # -- admission -----------------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Admit or reject (tenant queue full). Returns admitted."""
        tr, log = self.metrics.tracer, self.metrics.event_log
        q = self.queues.setdefault(req.tenant, deque())
        if len(q) >= self.max_depth:
            req.status = RequestStatus.REJECTED
            self.metrics.incr("requests_rejected")
            if tr is not None:
                tr.close_root(req, req.arrival_s, "rejected",
                              reason="tenant_queue_full")
            if log is not None:
                log.emit("rejected", req.arrival_s, req,
                         reason="tenant_queue_full")
            return False
        q.append(req)
        self.metrics.incr("requests_admitted")
        if tr is not None:
            tr.ensure_root(req)
        if log is not None:
            log.emit("accepted", req.arrival_s, req,
                     queue_depth=len(q))
        tel = self.metrics.telemetry
        if tel is not None:
            tel.gauge("fhe_device_queue_depth", device=self.owner).set(
                req.arrival_s, len(self))
        return True

    # -- dequeue -------------------------------------------------------------

    def _drop_expired(self, q: Deque[Request], now: float) -> None:
        """Purge expired requests anywhere in the queue (not just the
        front) so demand accounting and take() never see — let alone
        batch — work nobody is waiting for. Every drop is attributed to
        its tenant (goodput accounting needs the miss charged somewhere,
        not silently discarded)."""
        if not any(r.expired(now) for r in q):
            return
        tr, log = self.metrics.tracer, self.metrics.event_log
        tel, slo = self.metrics.telemetry, self.metrics.slo
        live = []
        for r in q:
            if r.expired(now):
                r.status = RequestStatus.DEADLINE_MISS
                self.metrics.incr("deadline_misses")
                self.metrics.incr("deadline_misses_dequeue")
                self.metrics.incr_tenant("deadline_misses", r.tenant)
                if tr is not None:
                    tr.close_root(r, now, "dropped_expired")
                if log is not None:
                    log.emit("dropped", now, r)
                if tel is not None:
                    tel.counter("fhe_requests_finished",
                                status="dropped_expired").inc(now)
                if slo is not None:
                    # a drop is a miss the service loop never sees —
                    # it must still burn the error budget
                    slo.record(now, True, self.metrics)
            else:
                live.append(r)
        q.clear()
        q.extend(live)
        if tel is not None:
            tel.gauge("fhe_device_queue_depth", device=self.owner).set(
                now, len(self))

    def oldest_arrival(self, now: float,
                       workload: Optional[str] = None) -> Optional[float]:
        """Earliest arrival among live queued requests (batcher's max-wait
        clock), optionally restricted to one workload."""
        best = None
        for q in self.queues.values():
            self._drop_expired(q, now)
            for r in q:
                if workload is not None and r.workload != workload:
                    continue
                if best is None or r.arrival_s < best:
                    best = r.arrival_s
        return best

    def pending_workloads(self, now: float) -> List[str]:
        """Workloads with live queued requests, in first-arrival order."""
        first: Dict[str, float] = {}
        for q in self.queues.values():
            self._drop_expired(q, now)
            for r in q:
                if r.workload not in first or r.arrival_s < first[r.workload]:
                    first[r.workload] = r.arrival_s
        return sorted(first, key=first.get)

    def pending_demand(self, now: float, workload: str) -> Tuple[int, int]:
        """(live request count, total slots) queued for ``workload``."""
        n, slots = 0, 0
        for q in self.queues.values():
            self._drop_expired(q, now)
            for r in q:
                if r.workload == workload:
                    n += 1
                    slots += r.slots_needed
        return n, slots

    def earliest_deadline(self, now: float,
                          workload: str) -> Optional[float]:
        best = None
        for q in self.queues.values():
            self._drop_expired(q, now)
            for r in q:
                if r.workload == workload and r.deadline_s is not None:
                    if best is None or r.deadline_s < best:
                        best = r.deadline_s
        return best

    def requeue(self, req: Request) -> None:
        """Return a dequeued request to the FRONT of its tenant queue
        (batcher overflow — no admission check, no metrics double-count)."""
        req.status = RequestStatus.QUEUED
        self.queues.setdefault(req.tenant, deque()).appendleft(req)

    def take(self, now: float, workload: str, max_requests: int,
             max_slots: Optional[int] = None) -> List[Request]:
        """Dequeue up to ``max_requests`` live requests of ``workload``,
        round-robin across tenants, bounded by total ``max_slots``.

        A request whose ``slots_needed`` would overflow the remaining
        slot budget is left queued (never split across batches).
        """
        tenants = sorted(self.queues)
        if not tenants:
            return []
        start = next(self._rr) % len(tenants)
        order = tenants[start:] + tenants[:start]
        out: List[Request] = []
        slots_left = max_slots if max_slots is not None else float("inf")
        progressed = True
        while progressed and len(out) < max_requests:
            progressed = False
            for t in order:
                if len(out) >= max_requests:
                    break
                q = self.queues[t]
                self._drop_expired(q, now)
                # peek first matching request of this tenant
                for i, r in enumerate(q):
                    if r.workload != workload:
                        continue
                    if r.slots_needed > slots_left:
                        break              # preserve FIFO within tenant
                    del q[i]
                    r.status = RequestStatus.BATCHED
                    out.append(r)
                    slots_left -= r.slots_needed
                    progressed = True
                    break
        return out
