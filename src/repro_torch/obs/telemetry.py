"""Sampled time-series telemetry for the serving stack.

The tracer (repro_torch.obs.tracer) answers "what happened to THIS request";
this module answers "what was the SYSTEM doing at time t": bank
utilization during the NTT phase, bytes/s on the inter-bank network,
queue depth per device, goodput, SLO burn rate. Counters, gauges and
histograms accumulate ring-buffered ``(t, value)`` points on the
**caller's own clock** — the DES virtual timeline for the analytic /
pim / fleet paths, wall seconds for the ciphertext backend — exactly
the discipline the tracer established: telemetry never reads a clock
of its own.

Wiring follows the tracer's contract verbatim. A `Telemetry` hangs off
the run's shared `MetricsRegistry` (``metrics.telemetry``); absence is
the disabled state, every emission site guards with one attribute read
and a None test, and a run without telemetry is bit-for-bit identical
to a run without this module (pinned by the same metrics golden the
tracer regression uses).

Memory is bounded by construction: each series keeps at most
``max_points`` points (a ring), and points closer together than
``resolution`` seconds coalesce into the newest one, so a million-round
fleet sweep degrades gracefully into a coarser series instead of an
unbounded list.

`SloBurnRate` is the alerting side: a multi-window burn-rate monitor
(SRE-style fast + slow windows over the deadline-miss rate vs an error
budget) fed by the same completion/drop sites that do goodput
accounting. When both windows burn hot it records an alert — an
instant in the span store, an ``slo_alert`` event-log line, and a
telemetry gauge step — with hysteresis so a sustained overload fires
once, not per miss.

Export: OpenMetrics text via repro_torch.obs.openmetrics, Perfetto counter
tracks (``ph:"C"``) merged into the trace JSON via repro_torch.obs.perfetto.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

CLOCKS = ("virtual", "wall")

# default histogram bucket bounds (seconds-flavored, Prometheus-style)
DEFAULT_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 1e-1, 5e-1, 1.0)


def _label_key(labels: Dict[str, object]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Series:
    """One named, labeled time series of ``(t, value)`` points.

    ``kind`` fixes the update verb: a ``counter`` only moves up
    (``inc`` appends the new cumulative total), a ``gauge`` is set to
    the observed level. Points land in a bounded ring; updates within
    ``resolution`` seconds of the newest point coalesce into it."""

    __slots__ = ("name", "labels", "kind", "clock", "points",
                 "resolution", "_total")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 kind: str, clock: str, max_points: int,
                 resolution: float):
        self.name = name
        self.labels = labels
        self.kind = kind
        self.clock = clock
        self.points: Deque[Tuple[float, float]] = deque(maxlen=max_points)
        self.resolution = resolution
        self._total = 0.0

    # -- updates -------------------------------------------------------------

    def _push(self, t: float, v: float) -> None:
        pts = self.points
        if pts and t - pts[-1][0] < self.resolution:
            pts[-1] = (max(t, pts[-1][0]), v)
        else:
            pts.append((t, v))

    def inc(self, t: float, delta: float = 1.0) -> None:
        assert self.kind == "counter", f"{self.name} is a {self.kind}"
        if delta < 0:
            raise ValueError(f"counter {self.name}: negative inc {delta}")
        self._total += delta
        self._push(t, self._total)

    def set(self, t: float, value: float) -> None:
        assert self.kind == "gauge", f"{self.name} is a {self.kind}"
        self._total = float(value)
        self._push(t, self._total)

    # -- queries -------------------------------------------------------------

    @property
    def value(self) -> float:
        """Latest level: cumulative total (counter) / last set (gauge)."""
        return self._total

    def value_at(self, t: float) -> float:
        """Step interpolation: value of the last point at or before
        ``t`` (0.0 before the first retained point)."""
        v = 0.0
        for pt, pv in self.points:
            if pt > t:
                break
            v = pv
        return v

    def rate(self, t0: Optional[float] = None,
             t1: Optional[float] = None) -> float:
        """Counter increase per second over [t0, t1] (defaults to the
        retained window)."""
        assert self.kind == "counter"
        if len(self.points) < 2:
            return 0.0
        lo = self.points[0][0] if t0 is None else t0
        hi = self.points[-1][0] if t1 is None else t1
        if hi <= lo:
            return 0.0
        return (self.value_at(hi) - self.value_at(lo)) / (hi - lo)

    def to_jsonable(self) -> dict:
        return {"name": self.name, "labels": dict(self.labels),
                "kind": self.kind, "clock": self.clock,
                "value": self._total,
                "points": [[t, v] for t, v in self.points]}


class HistogramSeries:
    """Prometheus-shape histogram: cumulative bucket counts + sum +
    count, with a bounded ring of ``(t, count)`` steps so the observe
    cadence survives as a time series too."""

    __slots__ = ("name", "labels", "clock", "buckets", "bucket_counts",
                 "sum", "count", "points", "resolution")
    kind = "histogram"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 clock: str, buckets: Tuple[float, ...], max_points: int,
                 resolution: float):
        if list(buckets) != sorted(buckets) or len(set(buckets)) != \
                len(buckets):
            raise ValueError(f"histogram {name}: buckets must be "
                             f"strictly increasing, got {buckets}")
        self.name = name
        self.labels = labels
        self.clock = clock
        self.buckets = tuple(float(b) for b in buckets)
        self.bucket_counts = [0] * (len(self.buckets) + 1)  # +inf bucket
        self.sum = 0.0
        self.count = 0
        self.points: Deque[Tuple[float, float]] = deque(maxlen=max_points)
        self.resolution = resolution

    def observe(self, t: float, value: float) -> None:
        self.sum += value
        self.count += 1
        for i, le in enumerate(self.buckets):
            if value <= le:
                self.bucket_counts[i] += 1
                break
        else:
            self.bucket_counts[-1] += 1
        pts = self.points
        if pts and t - pts[-1][0] < self.resolution:
            pts[-1] = (max(t, pts[-1][0]), float(self.count))
        else:
            pts.append((t, float(self.count)))

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """[(le, cumulative_count)...] ending with (+inf, count) — the
        OpenMetrics exposition shape."""
        out, acc = [], 0
        for le, c in zip(self.buckets, self.bucket_counts):
            acc += c
            out.append((le, acc))
        out.append((float("inf"), self.count))
        return out

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    @property
    def value(self) -> float:
        """Observation count — the histogram's counter-like face, so
        hub aggregation and counter tracks treat it uniformly."""
        return float(self.count)

    def value_at(self, t: float) -> float:
        v = 0.0
        for pt, pv in self.points:
            if pt > t:
                break
            v = pv
        return v

    def to_jsonable(self) -> dict:
        return {"name": self.name, "labels": dict(self.labels),
                "kind": "histogram", "clock": self.clock,
                "sum": self.sum, "count": self.count,
                "buckets": [[le, c] for le, c in
                            self.cumulative_buckets()]}


class Telemetry:
    """Registry of series for one run, on one clock domain.

    ``counter`` / ``gauge`` / ``histogram`` are memoized by
    ``(name, labels)`` so emission sites can call them in the hot loop:
    after the first call a lookup is one dict probe. Series creation
    order is preserved (export order is deterministic)."""

    def __init__(self, clock: str = "virtual", max_points: int = 4096,
                 resolution: float = 0.0):
        if clock not in CLOCKS:
            raise ValueError(f"clock must be one of {CLOCKS}, "
                             f"got {clock!r}")
        self.clock = clock
        self.max_points = max_points
        self.resolution = resolution
        self._series: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                           object] = {}

    # -- series constructors -------------------------------------------------

    def _get(self, cls, kind: str, name: str, labels: Dict[str, object],
             **kw):
        key = (name, _label_key(labels))
        s = self._series.get(key)
        if s is None:
            if cls is Series:
                s = Series(name, key[1], kind, self.clock,
                           self.max_points, self.resolution)
            else:
                s = HistogramSeries(name, key[1], self.clock,
                                    kw.get("buckets", DEFAULT_BUCKETS),
                                    self.max_points, self.resolution)
            self._series[key] = s
        elif s.kind != kind:
            raise ValueError(f"series {name}{dict(key[1])} already "
                             f"registered as {s.kind}, not {kind}")
        return s

    def counter(self, name: str, **labels) -> Series:
        return self._get(Series, "counter", name, labels)

    def gauge(self, name: str, **labels) -> Series:
        return self._get(Series, "gauge", name, labels)

    def histogram(self, name: str,
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                  **labels) -> HistogramSeries:
        return self._get(HistogramSeries, "histogram", name, labels,
                         buckets=buckets)

    # -- queries -------------------------------------------------------------

    def series(self) -> List[object]:
        return list(self._series.values())

    def find(self, name: str) -> List[object]:
        return [s for (n, _), s in self._series.items() if n == name]

    def get(self, name: str, **labels):
        return self._series.get((name, _label_key(labels)))

    def __len__(self) -> int:
        return len(self._series)

    def n_points(self) -> int:
        return sum(len(s.points) for s in self._series.values())

    def to_jsonable(self) -> dict:
        return {"clock": self.clock,
                "series": [s.to_jsonable() for s in self.series()]}


# ---------------------------------------------------------------------------
# SLO burn-rate monitor
# ---------------------------------------------------------------------------

class SloBurnRate:
    """Multi-window burn-rate alerting over the deadline-miss rate.

    ``budget`` is the tolerated miss fraction (the error budget, e.g.
    0.02 = 2% of requests may miss their deadline). The burn rate of a
    window is ``miss_rate / budget`` — 1.0 means the budget is being
    consumed exactly at its sustainable pace. An alert fires when the
    FAST window (page-quickly signal) and the SLOW window (ignore
    blips) both exceed their thresholds with at least ``min_events``
    outcomes observed in the fast window — the standard two-window
    guard against paging on a single unlucky request.

    Hysteresis: while firing, no further alerts; the monitor re-arms
    only after both windows fall below half their thresholds (an
    ``slo_recovered`` mark is recorded so the alert has an extent).

    ``record`` is called from the two sites that already do goodput
    accounting (request completion and expired-at-dequeue drops), on
    the caller's clock; the optional ``metrics`` registry routes the
    alert into the span store (instant on the ``runtime`` track), the
    JSON event log, and a burn-rate gauge pair in the telemetry."""

    def __init__(self, budget: float = 0.02,
                 fast_window_s: float = 0.005, slow_window_s: float = 0.05,
                 fast_burn: float = 10.0, slow_burn: float = 4.0,
                 min_events: int = 8):
        if budget <= 0:
            raise ValueError("budget must be > 0")
        if fast_window_s >= slow_window_s:
            raise ValueError("fast window must be shorter than slow")
        self.budget = budget
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s
        self.fast_burn = fast_burn
        self.slow_burn = slow_burn
        self.min_events = min_events
        self._events: Deque[Tuple[float, bool]] = deque()
        self.firing = False
        self.alerts: List[dict] = []
        self.recoveries: List[dict] = []

    def _window(self, now: float, w: float) -> Tuple[int, int]:
        lo = now - w
        total = miss = 0
        for t, is_miss in reversed(self._events):
            if t < lo:
                break
            total += 1
            miss += is_miss
        return total, miss

    def burn(self, now: float, window_s: float) -> Tuple[float, int]:
        """(burn rate, events observed) over [now - window_s, now]."""
        total, miss = self._window(now, window_s)
        if total == 0:
            return 0.0, 0
        return (miss / total) / self.budget, total

    def record(self, now: float, miss: bool, metrics=None) -> None:
        ev = self._events
        ev.append((now, bool(miss)))
        lo = now - self.slow_window_s
        while ev and ev[0][0] < lo:
            ev.popleft()
        fast, n_fast = self.burn(now, self.fast_window_s)
        slow, _ = self.burn(now, self.slow_window_s)
        tel = getattr(metrics, "telemetry", None) if metrics is not None \
            else None
        if tel is not None:
            tel.gauge("fhe_slo_burn_rate", window="fast").set(now, fast)
            tel.gauge("fhe_slo_burn_rate", window="slow").set(now, slow)
        if not self.firing:
            if (fast >= self.fast_burn and slow >= self.slow_burn
                    and n_fast >= self.min_events):
                self.firing = True
                alert = {"t": now, "fast_burn": fast, "slow_burn": slow,
                         "budget": self.budget}
                self.alerts.append(alert)
                self._emit(metrics, "slo_alert", now,
                           fast_burn=fast, slow_burn=slow,
                           budget=self.budget)
        elif fast < self.fast_burn / 2 and slow < self.slow_burn / 2:
            self.firing = False
            self.recoveries.append({"t": now, "fast_burn": fast,
                                    "slow_burn": slow})
            self._emit(metrics, "slo_recovered", now,
                       fast_burn=fast, slow_burn=slow)

    @staticmethod
    def _emit(metrics, name: str, now: float, **fields) -> None:
        if metrics is None:
            return
        tr = getattr(metrics, "tracer", None)
        if tr is not None:
            tr.instant(name, now, track="runtime", **fields)
        log = getattr(metrics, "event_log", None)
        if log is not None:
            log.emit(name, now, **fields)
