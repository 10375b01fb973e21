"""Slot batcher: packs pending requests into CKKS slot groups and the
load-save pipeline's input-batch dimension.

Two packing axes, mirroring the paper's batch economics (§IV-F):

* **slot axis** — a CKKS ciphertext at ring degree N carries N/2 slots;
  small requests of the same workload share one ciphertext (each request
  owns a contiguous slot range, never split across ciphertexts);
* **batch axis** — packed ciphertexts form the input batch that streams
  through one pipeline round, amortizing each stage's constant load
  across the whole batch.

Dispatch policy is the classic max-batch / max-wait tradeoff: fire when
the batch axis is full, when the oldest request has waited ``max_wait_s``,
or when an admitted deadline is about to become unmeetable.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.runtime.metrics import MetricsRegistry
from repro_torch.runtime.queue import AdmissionQueue, Request, RequestStatus


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    slots_per_ct: int                # CKKS slots per ciphertext (params.slots)
    max_batch: int = 8               # ciphertexts per pipeline batch
    max_wait_s: float = 5e-3         # oldest-request wait before firing
    deadline_slack_s: float = 0.0    # fire early if a deadline is this close

    @property
    def capacity_slots(self) -> int:
        return self.max_batch * self.slots_per_ct


@dataclasses.dataclass
class Batch:
    workload: str
    requests: List[Request]
    slot_groups: List[List[Request]]     # one inner list per ciphertext
    formed_s: float
    outputs: object = None               # filled by the mesh backend

    @property
    def n_ciphertexts(self) -> int:
        return len(self.slot_groups)

    @property
    def n_requests(self) -> int:
        return len(self.requests)

    def slot_utilization(self, slots_per_ct: int) -> float:
        used = sum(r.slots_needed for r in self.requests)
        return used / (self.n_ciphertexts * slots_per_ct) \
            if self.n_ciphertexts else 0.0


def pack_slot_groups(requests: List[Request], slots_per_ct: int,
                     max_groups: int,
                     groups: Optional[List[List[Request]]] = None,
                     free: Optional[List[int]] = None) -> tuple:
    """First-fit-decreasing bin packing of requests into ciphertexts.

    Returns (groups, overflow): requests that would need a group beyond
    ``max_groups`` — or that alone exceed ``slots_per_ct`` — overflow.

    ``groups``/``free`` seed the packer with an in-flight batch's
    existing ciphertext rows and their free slot capacity (continuous
    batching: new requests first-fit into free rows of a batch already
    streaming through the pipeline). Both are mutated in place.
    """
    if groups is None:
        groups = []
    if free is None:
        free = [slots_per_ct - sum(r.slots_needed for r in g)
                for g in groups]
    assert len(free) == len(groups)
    overflow: List[Request] = []
    for r in sorted(requests, key=lambda r: -r.slots_needed):
        if r.slots_needed > slots_per_ct:
            overflow.append(r)
            continue
        for i, f in enumerate(free):
            if r.slots_needed <= f:
                groups[i].append(r)
                free[i] -= r.slots_needed
                break
        else:
            if len(groups) < max_groups:
                groups.append([r])
                free.append(slots_per_ct - r.slots_needed)
            else:
                overflow.append(r)
    return groups, overflow


class SlotBatcher:
    def __init__(self, queue: AdmissionQueue, policy: BatchPolicy,
                 metrics: Optional[MetricsRegistry] = None):
        self.queue = queue
        self.policy = policy
        self.metrics = metrics or queue.metrics

    def _should_fire(self, now: float, workload: str) -> bool:
        p = self.policy
        n, slots = self.queue.pending_demand(now, workload)
        if n == 0:
            return False
        if slots >= p.capacity_slots:
            return True
        oldest = self.queue.oldest_arrival(now, workload)
        if oldest is not None and now - oldest >= p.max_wait_s:
            return True
        dl = self.queue.earliest_deadline(now, workload)
        return dl is not None and dl - now <= p.deadline_slack_s

    def should_fire(self, now: float, workload: str) -> bool:
        """Public fire predicate (the fleet scheduler's preemption
        trigger checks it without forming a batch)."""
        return self._should_fire(now, workload)

    def next_fire_time(self, now: float) -> Optional[float]:
        """Earliest future instant any workload's max-wait clock fires
        (virtual-clock executors advance to this when idle)."""
        best = None
        for w in self.queue.pending_workloads(now):
            oldest = self.queue.oldest_arrival(now, w)
            if oldest is None:
                continue
            t = oldest + self.policy.max_wait_s
            dl = self.queue.earliest_deadline(now, w)
            if dl is not None:
                t = min(t, dl - self.policy.deadline_slack_s)
            if best is None or t < best:
                best = t
        return best

    def poll(self, now: float,
             order: Optional[List[str]] = None) -> Optional[Batch]:
        """Form at most one batch. Requests of different workloads never
        share a batch (they compile to different schedules); workloads
        are served in first-arrival order unless ``order`` overrides it
        (the fleet scheduler passes an earliest-deadline-first order)."""
        if order is None:
            order = self.queue.pending_workloads(now)
        for workload in order:
            batch = self.poll_workload(now, workload)
            if batch is not None:
                return batch
        return None

    def poll_workload(self, now: float, workload: str) -> Optional[Batch]:
        """Form a batch of one workload if its fire condition holds."""
        p = self.policy
        if not self._should_fire(now, workload):
            return None
        taken = self.queue.take(now, workload,
                                max_requests=p.capacity_slots,
                                max_slots=p.capacity_slots)
        groups, overflow = pack_slot_groups(taken, p.slots_per_ct,
                                            p.max_batch)
        self._requeue_overflow(overflow)
        if not groups:
            return None
        batch = Batch(workload, [r for g in groups for r in g],
                      groups, formed_s=now)
        # wait is observed here, not in take(): a requeued overflow
        # request must be sampled once, on the batch it ships in
        for r in batch.requests:
            self.metrics.queue_wait.observe(max(0.0, now - r.arrival_s))
        self.metrics.incr("batches_formed")
        self.metrics.incr("ciphertexts_batched", batch.n_ciphertexts)
        return batch

    def _requeue_overflow(self, overflow: List[Request]) -> None:
        # requeue latest-arrival first so appendleft leaves each
        # tenant's queue in arrival order (overflow comes out of the
        # packer size-sorted, not arrival-sorted)
        p = self.policy
        for r in sorted(overflow, key=lambda r: r.arrival_s,
                        reverse=True):
            if r.slots_needed > p.slots_per_ct:
                # can never fit in one ciphertext — unservable
                r.status = RequestStatus.REJECTED
                self.metrics.incr("requests_oversized")
            else:
                self.queue.requeue(r)
                self.metrics.incr("batcher_overflow_requeued")

    def refill(self, now: float, workload: str,
               groups: List[List[Request]], free: List[int],
               max_groups: int) -> List[Request]:
        """Continuous batching: pull queued requests of ``workload``
        into the free slot rows of an in-flight batch (called between
        pipeline rounds). No fire condition — free capacity in a
        streaming batch is strictly cheaper than waiting for a new
        batch to form. Returns the joined requests; ``groups``/``free``
        are extended in place. Requests of other workloads are never
        pulled (they compile to a different schedule)."""
        budget = sum(free) + \
            max(0, max_groups - len(groups)) * self.policy.slots_per_ct
        if budget <= 0:
            return []
        taken = self.queue.take(now, workload,
                                max_requests=budget, max_slots=budget)
        if not taken:
            return []
        before = {id(r) for g in groups for r in g}
        _, overflow = pack_slot_groups(taken, self.policy.slots_per_ct,
                                       max_groups, groups=groups,
                                       free=free)
        self._requeue_overflow(overflow)
        joined = [r for g in groups for r in g if id(r) not in before]
        for r in joined:
            self.metrics.queue_wait.observe(max(0.0, now - r.arrival_s))
        if joined:
            self.metrics.incr("continuous_refills")
            self.metrics.incr("requests_refilled", len(joined))
            tr = self.metrics.tracer
            if tr is not None:
                # mark mid-flight joins on the request tree: the join
                # instant vs the later service span shows how long the
                # rider trailed the lead wave
                for r in joined:
                    tr.instant("batch_join", now,
                               parent=tr.ensure_root(r),
                               track=f"tenant:{r.tenant}",
                               request_id=r.request_id, workload=workload)
        return joined
