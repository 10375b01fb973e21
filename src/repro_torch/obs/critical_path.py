"""Critical-path analysis over a `SpanStore`.

Answers "where did this request's latency go?" structurally instead of
by post-hoc subtraction of aggregate percentiles:

* `critical_path(store, request_id, k)` — walk the request's span tree
  from the root, at each node descending into the child covering the
  most of the node's window (following the ``service -> batch_span``
  link into the shared batch tree, clipped to the request's service
  window), and report the top-k chain nodes by **exclusive
  contribution** — the part of the node's window its chosen child does
  not explain. Contributions along the chain telescope: they sum to
  the root duration (= the request's recorded latency), so the output
  is a complete attribution, not a sample.

* `workload_breakdown(store)` — fleet-wide aggregation for the fig21
  table: per workload, latency split into queueing (arrival → service
  start) and service, with service further attributed to the
  load / compute / movement buckets the executed stages' spans carry
  (the same OpCost channels the analytic and PIM cost models bill).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.obs.span import Span, SpanStore


@dataclasses.dataclass
class Segment:
    name: str
    contribution_s: float        # window time not explained by the child
    start_s: float
    end_s: float
    track: str
    span_id: int

    def to_jsonable(self) -> dict:
        return dataclasses.asdict(self)


def _overlap(s: Span, lo: float, hi: float) -> float:
    end = s.end_s if s.end_s is not None else s.start_s
    return max(0.0, min(end, hi) - max(s.start_s, lo))


def _candidates(store: SpanStore, node: Span) -> List[Span]:
    """Children of ``node`` plus any batch tree its attrs link to."""
    out = store.children(node.span_id)
    link = node.attrs.get("batch_span")
    if link is not None:
        linked = store.get(link)
        if linked is not None:
            out = out + [linked]
    return out


def request_chain(store: SpanStore, request_id: int) -> List[Span]:
    """Root-to-leaf chain following the dominant child at each level."""
    root = store.request_root(request_id)
    if root is None:
        return []
    chain = [root]
    lo, hi = root.start_s, root.end_s if root.end_s is not None \
        else root.start_s
    node = root
    while True:
        kids = _candidates(store, node)
        if not kids:
            break
        best = max(kids, key=lambda s: _overlap(s, lo, hi))
        if _overlap(best, lo, hi) <= 0.0:
            break
        chain.append(best)
        lo = max(lo, best.start_s)
        hi = min(hi, best.end_s if best.end_s is not None else best.start_s)
        node = best
    return chain


def critical_path(store: SpanStore, request_id: int,
                  k: int = 5) -> List[Segment]:
    root = store.request_root(request_id)
    if root is None or root.end_s is None:
        return []
    chain = request_chain(store, request_id)
    lo, hi = root.start_s, root.end_s
    segs: List[Segment] = []
    for i, node in enumerate(chain):
        lo = max(lo, node.start_s)
        hi = min(hi, node.end_s if node.end_s is not None else node.start_s)
        window = max(0.0, hi - lo)
        child_cover = (_overlap(chain[i + 1], lo, hi)
                       if i + 1 < len(chain) else 0.0)
        segs.append(Segment(node.name, window - child_cover,
                            lo, hi, node.track, node.span_id))
    segs.sort(key=lambda s: -s.contribution_s)
    return segs[:k]


# ---------------------------------------------------------------------------
# fleet-wide attribution (the fig21 table)
# ---------------------------------------------------------------------------

_BUCKETS = ("queue_s", "load_s", "compute_s", "move_s", "other_s")


def _stage_weights(store: SpanStore, batch_id: Optional[int]):
    """(load, compute, move) second-weights summed over the batch
    subtree's stage spans; None when the batch carries no stage data."""
    if batch_id is None:
        return None
    tot = [0.0, 0.0, 0.0]
    found = False
    for s in store.subtree(batch_id):
        if s.name != "stage":
            continue
        found = True
        tot[0] += float(s.attrs.get("load_s", 0.0))
        tot[1] += float(s.attrs.get("compute_s", 0.0))
        tot[2] += float(s.attrs.get("move_s", 0.0))
    return tot if found and sum(tot) > 0 else None


def workload_breakdown(store: SpanStore) -> Dict[str, Dict[str, float]]:
    """Per-workload mean latency attribution over completed requests.

    Returns ``{workload: {n, latency_s, queue_s, load_s, compute_s,
    move_s, other_s}}`` where the last five are mean seconds per
    request and sum to ``latency_s``. Service time is split across
    load/compute/move proportionally to the executed stages' billed
    seconds (exact for the analytic/pim virtual-clock backends, which
    bill from the same buckets); service with no stage data (e.g. mesh
    placeholder stages) lands in ``other_s``.
    """
    acc: Dict[str, Dict[str, float]] = {}
    for root in store.by_name("request"):
        if root.end_s is None or root.attrs.get("status") not in (
                "completed", "deadline_miss"):
            continue
        w = str(root.attrs.get("workload", "?"))
        a = acc.setdefault(w, {"n": 0, "latency_s": 0.0,
                               **{b: 0.0 for b in _BUCKETS}})
        a["n"] += 1
        latency = root.end_s - root.start_s
        a["latency_s"] += latency
        service = None
        for c in store.children(root.span_id):
            if c.name == "service":
                service = c
        if service is None or service.end_s is None:
            a["other_s"] += latency
            continue
        queue = max(0.0, service.start_s - root.start_s)
        svc = max(0.0, service.end_s - service.start_s)
        a["queue_s"] += queue
        a["other_s"] += max(0.0, latency - queue - svc)
        weights = _stage_weights(store, service.attrs.get("batch_span"))
        if weights is None:
            a["other_s"] += svc
            continue
        wsum = sum(weights)
        a["load_s"] += svc * weights[0] / wsum
        a["compute_s"] += svc * weights[1] / wsum
        a["move_s"] += svc * weights[2] / wsum
    for a in acc.values():
        n = max(1, a["n"])
        for k in ("latency_s",) + _BUCKETS:
            a[k] /= n
    return acc
