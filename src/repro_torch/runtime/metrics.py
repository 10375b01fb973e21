"""Serving metrics: latency percentiles, throughput, cache hit rates,
partition occupancy.

Pure-python accumulators (no jax) so they work identically under the
analytic (virtual-clock) and mesh (wall-clock) backends.
"""
from __future__ import annotations

import dataclasses
import random
import zlib
from typing import Dict, List, Optional, Tuple


class LatencyStats:
    """Streaming latency accumulator.

    Default mode keeps every sample and reports **exact** nearest-rank
    percentiles — serving smoke tests and benchmarks see 1e2..1e5
    samples, where that is fine and exactness beats a sketch. Samples
    are appended and sorted lazily on first query (amortized O(n log n)
    total, vs the old per-observe ``bisect.insort`` which was O(n) per
    sample and O(n^2) over a long fleet sweep).

    ``reservoir=R`` bounds memory for million-request sweeps
    (fig20-scale fleets): below R samples everything is kept and
    percentiles stay exact; above, Vitter's Algorithm R keeps a
    uniform R-sample for percentiles while ``count`` / ``mean`` /
    ``max`` remain exact always. The reservoir RNG is seeded from the
    stat's name, so runs are deterministic.
    """

    def __init__(self, name: str = "latency",
                 reservoir: Optional[int] = None):
        if reservoir is not None and reservoir < 1:
            raise ValueError("reservoir size must be >= 1")
        self.name = name
        self.reservoir = reservoir
        self._samples: List[float] = []
        self._dirty = False
        self._sum = 0.0
        self._count = 0
        self._max = 0.0
        self._rng = (random.Random(zlib.crc32(name.encode()) ^ 0x5EED)
                     if reservoir is not None else None)

    def observe(self, seconds: float) -> None:
        self._count += 1
        self._sum += seconds
        if self._count == 1 or seconds > self._max:
            self._max = seconds
        if self.reservoir is None or len(self._samples) < self.reservoir:
            self._samples.append(seconds)
            self._dirty = True
        else:
            # Algorithm R: keep each of the n samples with prob R/n
            j = self._rng.randrange(self._count)
            if j < self.reservoir:
                self._samples[j] = seconds
                self._dirty = True

    def _view(self) -> List[float]:
        if self._dirty:
            self._samples.sort()
            self._dirty = False
        return self._samples

    @property
    def count(self) -> int:
        return self._count

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def percentile(self, p: float) -> float:
        """Nearest-rank p-th percentile (0 <= p <= 100) — exact while
        all samples are retained, reservoir-estimated past the bound."""
        view = self._view()
        if not view:
            return 0.0
        k = min(len(view) - 1,
                max(0, int(round(p / 100.0 * (len(view) - 1)))))
        return view[k]

    @property
    def p50(self) -> float:
        return self.percentile(50)

    @property
    def p95(self) -> float:
        return self.percentile(95)

    @property
    def p99(self) -> float:
        return self.percentile(99)

    @property
    def max(self) -> float:
        return self._max if self._count else 0.0

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "mean_s": self.mean,
                "p50_s": self.p50, "p95_s": self.p95, "p99_s": self.p99,
                "max_s": self.max}


@dataclasses.dataclass
class PartitionOccupancy:
    """Busy-seconds per partition vs elapsed time — how evenly the
    round-robin placement loads the banks/device-groups."""
    n_partitions: int
    busy_s: List[float] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if not self.busy_s:
            self.busy_s = [0.0] * self.n_partitions

    def add(self, partition: int, seconds: float) -> None:
        self.busy_s[partition % self.n_partitions] += seconds

    def occupancy(self, elapsed_s: float) -> List[float]:
        if elapsed_s <= 0:
            return [0.0] * self.n_partitions
        return [min(1.0, b / elapsed_s) for b in self.busy_s]

    def mean_occupancy(self, elapsed_s: float) -> float:
        occ = self.occupancy(elapsed_s)
        return sum(occ) / len(occ) if occ else 0.0

    def utilization(self, elapsed_s: float) -> List[float]:
        """Uncapped busy/wall fraction per partition — unlike
        `occupancy` this keeps values > 1.0 visible (a partition billed
        more busy-seconds than the wall window is oversubscribed, the
        signal the capped column hides)."""
        if elapsed_s <= 0:
            return [0.0] * self.n_partitions
        return [b / elapsed_s for b in self.busy_s]

    def active_utilization(self, elapsed_s: float) -> Tuple[float, float,
                                                            int]:
        """(mean, max, n_active) of busy/wall over partitions that did
        ANY work — the table-facing normalization: averaging the idle
        tail of a 128-bank arch into the mean made the column
        meaningless across backends with different partition counts."""
        util = [u for u in self.utilization(elapsed_s) if u > 0.0]
        if not util:
            return 0.0, 0.0, 0
        return sum(util) / len(util), max(util), len(util)


class MetricsRegistry:
    """One object threaded through queue/batcher/keycache/executor —
    and, under a fleet (repro.fleet), shared by every device so the
    registry is the single fleet-wide scoreboard: per-device busy
    seconds, routing hit rate, preemption counts, and the
    queue-delay vs service-time latency decomposition all land here
    next to the single-executor metrics."""

    def __init__(self, n_partitions: int = 1,
                 latency_reservoir: Optional[int] = None):
        r = latency_reservoir
        self.request_latency = LatencyStats("request_latency", reservoir=r)
        self.queue_wait = LatencyStats("queue_wait", reservoir=r)
        # latency decomposition: request_latency = queue_delay (arrival
        # -> service start, the batcher/scheduler's share) + service
        # time (service start -> completion, the backend's share), so
        # p99 growth under load is attributable to queueing vs compute
        self.queue_delay = LatencyStats("queue_delay", reservoir=r)
        self.service_time = LatencyStats("service_time", reservoir=r)
        self.batch_service = LatencyStats("batch_service", reservoir=r)
        self.occupancy = PartitionOccupancy(n_partitions)
        self.counters: Dict[str, int] = {}
        # per-tenant counters (deadline_misses, requests_completed):
        # goodput accounting needs every miss attributed to a tenant,
        # including drops at dequeue (queue._drop_expired)
        self.tenant_counters: Dict[str, Dict[str, int]] = {}
        # fleet: busy seconds per device id (device-level occupancy,
        # as PartitionOccupancy is bank-level within one device)
        self.device_busy_s: Dict[int, float] = {}
        # decrypt-side accuracy per workload (ciphertext backend):
        # max |decoded - reference| over every slot of every batch served
        self.decrypt_error: Dict[str, float] = {}
        self.elapsed_s = 0.0
        # observability attachment points (repro.obs). None = disabled;
        # every emission site in the stack guards on these being None,
        # so an untraced run does no work beyond the attribute read —
        # the bit-for-bit metrics regression in tests/test_obs.py pins
        # that down. Deliberately NOT part of summary().
        self.tracer = None            # Optional[repro.obs.Tracer]
        self.event_log = None         # Optional[repro.obs.JsonEventLog]
        self.telemetry = None         # Optional[repro.obs.Telemetry]
        self.slo = None               # Optional[repro.obs.SloBurnRate]

    def observe_decrypt_error(self, workload: str, err: float) -> None:
        prev = self.decrypt_error.get(workload, 0.0)
        self.decrypt_error[workload] = max(prev, float(err))
        self.incr("accuracy_batches_checked")

    def incr(self, name: str, by: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + by

    def count(self, name: str) -> int:
        return self.counters.get(name, 0)

    def incr_tenant(self, name: str, tenant: str, by: int = 1) -> None:
        d = self.tenant_counters.setdefault(tenant, {})
        d[name] = d.get(name, 0) + by

    def tenant_count(self, name: str, tenant: str) -> int:
        return self.tenant_counters.get(tenant, {}).get(name, 0)

    def add_device_busy(self, device_id: int, seconds: float) -> None:
        self.device_busy_s[device_id] = \
            self.device_busy_s.get(device_id, 0.0) + seconds

    def device_occupancy(self) -> Dict[int, float]:
        """Busy fraction per fleet device over the serve window."""
        if self.elapsed_s <= 0:
            return {d: 0.0 for d in self.device_busy_s}
        return {d: min(1.0, b / self.elapsed_s)
                for d, b in sorted(self.device_busy_s.items())}

    def hit_rate(self, prefix: str) -> float:
        """hits / (hits + misses) for counters ``{prefix}_hits`` and
        ``{prefix}_misses``."""
        h, m = self.count(f"{prefix}_hits"), self.count(f"{prefix}_misses")
        return h / (h + m) if h + m else 0.0

    def throughput_rps(self) -> float:
        done = self.count("requests_completed")
        return done / self.elapsed_s if self.elapsed_s > 0 else 0.0

    def goodput_rps(self) -> float:
        """Deadline-met throughput: completions of deadline-bearing
        requests per second (a best-effort completion doesn't count —
        goodput measures SLO-attaining work, the fig20 y-axis)."""
        done = self.count("requests_goodput")
        return done / self.elapsed_s if self.elapsed_s > 0 else 0.0

    def summary(self) -> Dict[str, object]:
        return {
            "elapsed_s": self.elapsed_s,
            "throughput_rps": self.throughput_rps(),
            "goodput_rps": self.goodput_rps(),
            "latency": self.request_latency.summary(),
            "queue_wait": self.queue_wait.summary(),
            "queue_delay": self.queue_delay.summary(),
            "service_time": self.service_time.summary(),
            "batch_service": self.batch_service.summary(),
            "keycache_hit_rate": self.hit_rate("keycache"),
            "compile_cache_hit_rate": self.hit_rate("compile"),
            "routing_hit_rate": self.hit_rate("routing"),
            "mean_partition_occupancy":
                self.occupancy.mean_occupancy(self.elapsed_s),
            "device_occupancy": self.device_occupancy(),
            "decrypt_error": dict(sorted(self.decrypt_error.items())),
            "counters": dict(sorted(self.counters.items())),
            "tenants": {t: dict(sorted(c.items())) for t, c in
                        sorted(self.tenant_counters.items())},
        }

    def format_table(self) -> str:
        s = self.summary()
        lat = s["latency"]
        lines = [
            f"elapsed               {s['elapsed_s']:.3f} s",
            f"throughput            {s['throughput_rps']:.1f} req/s",
            f"latency p50/p95/p99   {lat['p50_s']*1e3:.2f} / "
            f"{lat['p95_s']*1e3:.2f} / {lat['p99_s']*1e3:.2f} ms",
            f"queue wait p50        {self.queue_wait.p50*1e3:.2f} ms",
            f"queue delay p99       {self.queue_delay.p99*1e3:.2f} ms",
            f"service time p99      {self.service_time.p99*1e3:.2f} ms",
            f"keycache hit rate     {s['keycache_hit_rate']*100:.1f} %",
            f"compile hit rate      {s['compile_cache_hit_rate']*100:.1f} %",
        ]
        # partition utilization normalized busy/wall over partitions
        # that did work (raw busy-seconds averaged over every partition
        # of the arch — including the idle tail — made the column
        # incomparable between the 4-partition smoke model and a
        # 128-bank pim preset)
        mu, mx, n_act = self.occupancy.active_utilization(s["elapsed_s"])
        lines.append(f"partition util        {mu*100:.1f} % mean / "
                     f"{mx*100:.1f} % max "
                     f"({n_act}/{self.occupancy.n_partitions} active)")
        if self.count("requests_goodput"):
            lines.insert(2, f"goodput               "
                            f"{s['goodput_rps']:.1f} req/s")
        occ = s["device_occupancy"]
        if occ:
            lines.append("device occupancy      " + " ".join(
                f"d{d}={f*100:.0f}%" for d, f in occ.items()))
            lines.append(f"routing hit rate      "
                         f"{s['routing_hit_rate']*100:.1f} %")
        for w, e in s["decrypt_error"].items():
            lines.append(f"max |err| {w:<11} {e:.3e}")
        for k, v in s["counters"].items():
            lines.append(f"{k:<21} {v}")
        for t, c in s["tenants"].items():
            miss = c.get("deadline_misses", 0)
            if miss:
                lines.append(f"deadline misses {t:<6} {miss}")
        return "\n".join(lines)


class TelemetryHub:
    """Fleet-wide view over the run's shared telemetry
    (repro.obs.Telemetry — duck-typed here, as with the tracer, so the
    accumulator module never imports the obs package).

    Devices emit their series into ONE Telemetry with a ``device``
    label (the registry is already the fleet-wide scoreboard), so
    aggregation is a query, not a merge protocol: ``aggregate`` folds
    every series of a name across its label sets into one series
    sampled at the union of their timestamps, step-interpolating each
    input (a counter holds its last cumulative total between points;
    0 before its first) — the "whole-fleet queue depth" / "total
    goodput" view the per-device series can't show individually."""

    AGGS = ("sum", "mean", "max")

    def __init__(self, telemetry):
        self.telemetry = telemetry

    def group(self, name: str, label: str = "device") -> Dict[str, list]:
        """Series of ``name`` bucketed by one label's value (series
        without the label land under "")."""
        out: Dict[str, list] = {}
        for s in self.telemetry.find(name):
            out.setdefault(dict(s.labels).get(label, ""), []).append(s)
        return out

    def aggregate(self, name: str, agg: str = "sum",
                  label: Optional[str] = None,
                  value: Optional[str] = None) -> List[Tuple[float,
                                                             float]]:
        """Fold all series named ``name`` (optionally only those whose
        ``label`` equals ``value``) into [(t, aggregated)] samples."""
        if agg not in self.AGGS:
            raise ValueError(f"agg must be one of {self.AGGS}")
        series = self.telemetry.find(name)
        if label is not None:
            series = [s for s in series
                      if dict(s.labels).get(label) == str(value)]
        series = [s for s in series if s.points]
        if not series:
            return []
        ts = sorted({t for s in series for t, _ in s.points})
        out = []
        for t in ts:
            vals = []
            for s in series:
                if s.points[0][0] > t:
                    # not yet emitting: a counter contributes 0 to a
                    # sum; gauges are excluded (no level exists yet)
                    if s.kind == "counter" and agg == "sum":
                        vals.append(0.0)
                    continue
                vals.append(s.value_at(t))
            if not vals:
                continue
            if agg == "sum":
                out.append((t, sum(vals)))
            elif agg == "max":
                out.append((t, max(vals)))
            else:
                out.append((t, sum(vals) / len(vals)))
        return out

    def totals(self, name: str) -> Dict[str, float]:
        """Final value per label set — {rendered labels: value}."""
        return {",".join(f"{k}={v}" for k, v in s.labels): s.value
                for s in self.telemetry.find(name)}
