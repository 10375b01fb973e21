"""OpenMetrics / Prometheus text exposition of a `Telemetry` snapshot.

``render`` serializes every telemetry series (plus, optionally, the
`MetricsRegistry`'s end-of-run aggregates) in the OpenMetrics text
format: ``# TYPE`` / ``# HELP`` metadata per family, one sample line
per labeled series, counters suffixed ``_total``, histograms exploded
into ``_bucket{le=...}`` / ``_sum`` / ``_count``, terminated by
``# EOF``. The output loads into any Prometheus-compatible scraper —
and into ``parse`` below, the strict self-parser CI runs over every
emitted file (``python -m repro_torch.obs.openmetrics validate FILE``), so a
formatting regression fails the build instead of a dashboard.

Timestamps are deliberately omitted from sample lines: the serving
timeline is virtual for the DES backends and OpenMetrics timestamps
are wall-epoch by convention; the time-resolved view lives in the
Perfetto counter tracks (repro_torch.obs.perfetto), this file is the
"current levels" snapshot.
"""
from __future__ import annotations

import math
import re
import sys
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.telemetry import HistogramSeries, Telemetry

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
# sample line: name{labels} value   (no timestamp — see module doc)
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r" (?P<value>\S+)$")
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

HELP: Dict[str, str] = {
    "fhe_pim_bank_busy_seconds":
        "busy seconds accumulated per PIM bank (load + max(exec, xfer))",
    "fhe_pim_bank_busy_cycles":
        "ISA cycles retired per PIM bank, by dominant stage phase",
    "fhe_pim_bank_utilization":
        "per-bank busy fraction of the pipeline round, by stage phase",
    "fhe_pim_move_bytes":
        "bytes moved per interconnect scope (XFER + STORE traffic)",
    "fhe_pim_move_bw_frac":
        "movement bandwidth as a fraction of the scope's PimArch peak",
    "fhe_partition_busy_seconds":
        "busy seconds accumulated per pipeline partition",
    "fhe_partition_utilization":
        "per-partition busy fraction of the pipeline round",
    "fhe_stage_wall_seconds":
        "measured wall seconds per pipeline stage (ciphertext backend)",
    "fhe_device_queue_depth": "queued requests per fleet device",
    "fhe_device_inflight_occupancy":
        "occupied fraction of a device's in-flight batch slots",
    "fhe_requests_finished": "requests that left the system, by status",
    "fhe_goodput_requests": "deadline-bearing requests completed in time",
    "fhe_slo_burn_rate":
        "deadline-miss rate over the window as a multiple of the budget",
}


def _fmt_value(v: float) -> str:
    if v != v:
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_labels(labels: Tuple[Tuple[str, str], ...],
                extra: Optional[Tuple[str, str]] = None) -> str:
    items = list(labels) + ([extra] if extra is not None else [])
    if not items:
        return ""
    body = ",".join(
        f'{k}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in items)
    return "{" + body + "}"


def registry_families(metrics) -> List[Tuple[str, str, List[Tuple[Tuple, float]]]]:
    """(name, type, [(labels, value)...]) families distilled from a
    `MetricsRegistry` — the end-of-run aggregates exposed next to the
    time-series so one scrape carries both."""
    fams: List[Tuple[str, str, List[Tuple[Tuple, float]]]] = []
    counters = [((("name", k),), float(v))
                for k, v in sorted(metrics.counters.items())]
    if counters:
        fams.append(("fhe_runtime_events", "counter", counters))
    fams.append(("fhe_elapsed_seconds", "gauge",
                 [((), float(metrics.elapsed_s))]))
    lat = metrics.request_latency
    if lat.count:
        fams.append(("fhe_request_latency_seconds", "summary", [
            ((("quantile", "0.5"),), lat.p50),
            ((("quantile", "0.95"),), lat.p95),
            ((("quantile", "0.99"),), lat.p99),
        ]))
    occ = metrics.device_occupancy()
    if occ:
        fams.append(("fhe_device_occupancy", "gauge",
                     [((("device", str(d)),), float(f))
                      for d, f in occ.items()]))
    return fams


def render(telemetry: Optional[Telemetry],
           metrics=None) -> str:
    """OpenMetrics text for a telemetry snapshot (and optionally the
    registry aggregates). Families are grouped (one # TYPE block per
    metric name), label sets keep series-creation order."""
    lines: List[str] = []
    by_name: Dict[str, List] = {}
    if telemetry is not None:
        for s in telemetry.series():
            by_name.setdefault(s.name, []).append(s)
    for name, group in by_name.items():
        kind = group[0].kind
        lines.append(f"# TYPE {name} {kind}")
        help_text = HELP.get(name)
        if help_text:
            lines.append(f"# HELP {name} {help_text}")
        # clock-domain annotation (our extension; parsers skip unknown
        # comment lines) — virtual DES seconds vs wall seconds
        lines.append(f"# CLOCK {name} {group[0].clock}")
        for s in group:
            if isinstance(s, HistogramSeries):
                for le, c in s.cumulative_buckets():
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(s.labels, ('le', _fmt_value(le)))}"
                        f" {_fmt_value(c)}")
                lines.append(f"{name}_sum{_fmt_labels(s.labels)} "
                             f"{_fmt_value(s.sum)}")
                lines.append(f"{name}_count{_fmt_labels(s.labels)} "
                             f"{_fmt_value(s.count)}")
            elif s.kind == "counter":
                lines.append(f"{name}_total{_fmt_labels(s.labels)} "
                             f"{_fmt_value(s.value)}")
            else:
                lines.append(f"{name}{_fmt_labels(s.labels)} "
                             f"{_fmt_value(s.value)}")
    if metrics is not None:
        for name, kind, samples in registry_families(metrics):
            lines.append(f"# TYPE {name} {kind}")
            suffix = "_total" if kind == "counter" else ""
            for labels, value in samples:
                lines.append(f"{name}{suffix}{_fmt_labels(tuple(labels))} "
                             f"{_fmt_value(value)}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# strict self-parser (the CI gate)
# ---------------------------------------------------------------------------

class ParsedMetric:
    __slots__ = ("name", "labels", "value")

    def __init__(self, name, labels, value):
        self.name, self.labels, self.value = name, labels, value


def _parse_value(tok: str) -> float:
    if tok == "+Inf":
        return math.inf
    if tok == "-Inf":
        return -math.inf
    if tok == "NaN":
        return math.nan
    return float(tok)   # raises ValueError on garbage


def parse(text: str) -> Tuple[List[ParsedMetric], List[str]]:
    """Parse OpenMetrics text strictly. Returns (samples, errors);
    an empty error list means the document is valid.

    Enforced: every sample's family has a prior ``# TYPE``; metric and
    label names match the spec charset; counter samples end in
    ``_total``; histogram ``le`` bounds are sorted with a ``+Inf``
    bucket whose count equals ``_count``; values parse as floats; no
    duplicate (name, labels) sample; ``# EOF`` present, last, unique."""
    errs: List[str] = []
    samples: List[ParsedMetric] = []
    types: Dict[str, str] = {}
    seen = set()
    hist: Dict[Tuple[str, Tuple], List[Tuple[float, float]]] = {}
    hist_count: Dict[Tuple[str, Tuple], float] = {}
    eof_at = None
    lines = text.split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    for ln, line in enumerate(lines, 1):
        if eof_at is not None:
            errs.append(f"line {ln}: content after # EOF")
            break
        if line == "# EOF":
            eof_at = ln
            continue
        if line.startswith("#"):
            parts = line.split(" ", 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                name, kind = parts[2], (parts[3] if len(parts) > 3 else "")
                if not _NAME_RE.match(name):
                    errs.append(f"line {ln}: bad metric name {name!r}")
                if kind not in ("counter", "gauge", "histogram",
                                "summary", "untyped", "info"):
                    errs.append(f"line {ln}: bad type {kind!r}")
                if name in types:
                    errs.append(f"line {ln}: duplicate TYPE for {name}")
                types[name] = kind
            continue
        if not line.strip():
            errs.append(f"line {ln}: blank line")
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            errs.append(f"line {ln}: unparseable sample {line!r}")
            continue
        name, raw_labels = m.group("name"), m.group("labels")
        labels: List[Tuple[str, str]] = []
        if raw_labels:
            matched = _LABEL_PAIR_RE.findall(raw_labels)
            rebuilt = ",".join(f'{k}="{v}"' for k, v in matched)
            if rebuilt != raw_labels:
                errs.append(f"line {ln}: malformed labels "
                            f"{{{raw_labels}}}")
                continue
            for k, _v in matched:
                if not _LABEL_RE.match(k):
                    errs.append(f"line {ln}: bad label name {k!r}")
            labels = matched
        try:
            value = _parse_value(m.group("value"))
        except ValueError:
            errs.append(f"line {ln}: bad value {m.group('value')!r}")
            continue
        # resolve the family this sample belongs to
        family = None
        for base, kind in types.items():
            if name == base:
                family = (base, kind, "")
            elif name.startswith(base + "_"):
                suf = name[len(base):]
                if suf in ("_total", "_bucket", "_sum", "_count"):
                    cand = (base, kind, suf)
                    if family is None or len(base) > len(family[0]):
                        family = cand
        if family is None:
            errs.append(f"line {ln}: sample {name!r} has no # TYPE")
            continue
        base, kind, suf = family
        if kind == "counter" and suf != "_total":
            errs.append(f"line {ln}: counter sample {name!r} must "
                        f"end in _total")
        if kind == "gauge" and suf != "":
            errs.append(f"line {ln}: gauge sample {name!r} must not "
                        f"carry a suffix")
        if kind == "histogram" and suf not in ("_bucket", "_sum",
                                               "_count"):
            errs.append(f"line {ln}: histogram sample {name!r} needs "
                        f"a _bucket/_sum/_count suffix")
        key = (name, tuple(sorted(labels)))
        if key in seen:
            errs.append(f"line {ln}: duplicate sample {name}"
                        f"{dict(labels)}")
        seen.add(key)
        if kind == "histogram" and suf == "_bucket":
            le = dict(labels).get("le")
            if le is None:
                errs.append(f"line {ln}: _bucket without le label")
            else:
                hkey = (base, tuple(sorted(
                    (k, v) for k, v in labels if k != "le")))
                hist.setdefault(hkey, []).append(
                    (_parse_value(le), value))
        if kind == "histogram" and suf == "_count":
            hist_count[(base, tuple(sorted(labels)))] = value
        samples.append(ParsedMetric(name, dict(labels), value))
    if eof_at is None:
        errs.append("missing # EOF terminator")
    for (base, labels), buckets in hist.items():
        les = [le for le, _ in buckets]
        if les != sorted(les):
            errs.append(f"{base}{dict(labels)}: le bounds not sorted")
        if not les or les[-1] != math.inf:
            errs.append(f"{base}{dict(labels)}: missing +Inf bucket")
        counts = [c for _, c in buckets]
        if counts != sorted(counts):
            errs.append(f"{base}{dict(labels)}: bucket counts "
                        f"not monotone")
        total = hist_count.get((base, labels))
        if total is not None and counts and counts[-1] != total:
            errs.append(f"{base}{dict(labels)}: +Inf bucket "
                        f"{counts[-1]} != _count {total}")
    return samples, errs


def validate_text(text: str) -> List[str]:
    return parse(text)[1]


def write_metrics(path: str, telemetry: Optional[Telemetry],
                  metrics=None) -> str:
    text = render(telemetry, metrics)
    errs = validate_text(text)
    if errs:   # render/parse must round-trip by construction
        raise AssertionError(f"emitted invalid OpenMetrics: {errs[:3]}")
    with open(path, "w") as f:
        f.write(text)
    return text


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 2 or argv[0] != "validate":
        print("usage: python -m repro_torch.obs.openmetrics validate FILE",
              file=sys.stderr)
        return 2
    try:
        with open(argv[1]) as f:
            text = f.read()
    except OSError as e:
        print(f"INVALID {argv[1]}: {e}", file=sys.stderr)
        return 1
    samples, errs = parse(text)
    if errs:
        for e in errs[:20]:
            print(f"INVALID {e}", file=sys.stderr)
        return 1
    print(f"OK {argv[1]}: {len(samples)} samples")
    return 0


if __name__ == "__main__":
    sys.exit(main())
