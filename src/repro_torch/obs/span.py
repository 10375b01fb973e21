"""Span records and the in-process `SpanStore`.

A `Span` is one named interval on the serving timeline — the clock is
whatever the executor that emitted it runs on (virtual DES seconds for
the analytic/pim/fleet paths, wall seconds for mesh/ciphertext), so
spans nest exactly inside the scheduler's own event times rather than
in a second, skewed clock domain.

Spans form two families of trees:

* **request trees** (``request_id`` set, ``track="tenant:<t>"``) — one
  root ``request`` span per request (arrival → completion/drop) with
  ``queue_wait`` / ``route`` / ``service`` children;
* **batch trees** (``track="device:<i>"``) — one root per executed
  batch or flight, with ``compile`` / ``round`` / ``stage`` children.

A request's ``service`` span links to the batch that carried it via
``attrs["batch_span"]`` (many requests ride one batch, so the batch
subtree is shared, not duplicated per request).

The `SpanStore` is the queryable in-process sink: tests and the
critical-path analyzer (repro.obs.critical_path) read it directly; the
Perfetto exporter (repro.obs.perfetto) serializes it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass(slots=True)
class Span:
    span_id: int
    parent_id: Optional[int]
    name: str
    start_s: float
    end_s: Optional[float]        # None while open
    track: str = "runtime"        # "device:<i>" | "tenant:<t>" | "runtime"
    request_id: Optional[int] = None
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return (self.end_s - self.start_s) if self.end_s is not None else 0.0

    def to_jsonable(self) -> dict:
        d = {"span_id": self.span_id, "parent_id": self.parent_id,
             "name": self.name, "start_s": self.start_s,
             "end_s": self.end_s, "track": self.track}
        if self.request_id is not None:
            d["request_id"] = self.request_id
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d


class SpanStore:
    """Append-only span sink with id / parent / request indexes.

    Indexes are rebuilt lazily: emission (the hot path — once per span)
    is a list append plus one dict write; queries (tests, analyzers,
    export) pay the indexing.
    """

    def __init__(self):
        self.spans: List[Span] = []
        self._by_id: Dict[int, Span] = {}
        self._children: Optional[Dict[Optional[int], List[Span]]] = None

    def __len__(self) -> int:
        return len(self.spans)

    def add(self, span: Span) -> None:
        self.spans.append(span)
        self._by_id[span.span_id] = span
        if self._children is not None:
            self._children = None

    def get(self, span_id: int) -> Optional[Span]:
        return self._by_id.get(span_id)

    def _index(self) -> Dict[Optional[int], List[Span]]:
        if self._children is None:
            idx: Dict[Optional[int], List[Span]] = {}
            for s in self.spans:
                idx.setdefault(s.parent_id, []).append(s)
            self._children = idx
        return self._children

    def children(self, span_id: Optional[int]) -> List[Span]:
        return list(self._index().get(span_id, ()))

    def roots(self) -> List[Span]:
        return self.children(None)

    def by_request(self, request_id: int) -> List[Span]:
        return [s for s in self.spans if s.request_id == request_id]

    def request_root(self, request_id: int) -> Optional[Span]:
        for s in self.spans:
            if s.request_id == request_id and s.name == "request":
                return s
        return None

    def by_name(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def subtree(self, span_id: int) -> List[Span]:
        """The span plus all descendants (preorder)."""
        root = self.get(span_id)
        if root is None:
            return []
        out, stack = [], [root]
        while stack:
            s = stack.pop()
            out.append(s)
            stack.extend(reversed(self.children(s.span_id)))
        return out

    def open_spans(self) -> List[Span]:
        return [s for s in self.spans if s.end_s is None]

    def to_jsonable(self) -> List[dict]:
        return [s.to_jsonable() for s in self.spans]
