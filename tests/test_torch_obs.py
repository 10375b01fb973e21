"""The port's observability exporters (repro_torch.obs) against the JAX
reference's (repro.obs), on the CPU.

tests/_obs_scenario.py's serving scenario runs in each package with a
tracer, telemetry, an SLO burn-rate monitor and a JSON event log
attached; the Perfetto trace JSON, the OpenMetrics text, every event-log
line, each request's critical path and the per-workload latency
breakdown must be equal, character for character and float for float
(the analytic and pim backends run on a virtual clock). Three scenarios:
the analytic backend, the pim backend, and an overload of the analytic
backend that fires the burn-rate alert.
"""
import io
import json

import pytest

pytest.importorskip("torch")

import repro.obs as jobs  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from _obs_scenario import build_executor as j_executor  # noqa: E402
from _obs_scenario import make_arrivals as j_arrivals  # noqa: E402
from _torch_parity import obs_arrivals as t_arrivals  # noqa: E402
from _torch_parity import obs_executor as t_executor  # noqa: E402

SCENARIOS = {
    "analytic": dict(backend="analytic", arrivals={}, slo={}),
    "pim": dict(backend="pim", arrivals={}, slo={}),
    # everything offered at once against deadlines shorter than one batch
    # service: a miss storm the burn-rate monitor pages on
    "overload": dict(backend="analytic",
                     arrivals=dict(rate_rps=1e9, deadline_s=2e-5),
                     slo=dict(min_events=4)),
}


def _run(obs, make_executor, make_arrivals, sc):
    ex = make_executor(sc["backend"])
    ex.metrics.tracer = obs.Tracer()
    ex.metrics.telemetry = obs.Telemetry(clock="virtual")
    ex.metrics.event_log = obs.JsonEventLog(io.StringIO())
    ex.metrics.slo = obs.SloBurnRate(**sc["slo"])
    ex.warmup()
    m = ex.serve(make_arrivals(ex, **sc["arrivals"]))
    return ex, m


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def pair(request):
    sc = SCENARIOS[request.param]
    return (_run(jobs, j_executor, j_arrivals, sc),
            _run(tobs, t_executor, t_arrivals, sc), request.param)


def test_perfetto_trace_equal(pair, tmp_path):
    (jex, _), (tex, _), _name = pair
    paths = []
    for obs, ex in ((jobs, jex), (tobs, tex)):
        p = tmp_path / f"{obs.__name__}.json"
        obs.write_trace(ex.metrics.tracer.store, str(p), clock="virtual",
                        telemetry=ex.metrics.telemetry)
        paths.append(p)
    assert paths[1].read_bytes() == paths[0].read_bytes()
    assert tobs.validate_file(str(paths[1])) == []
    obj = json.loads(paths[1].read_text())
    assert obj["otherData"]["n_spans"] == len(tex.metrics.tracer.store) > 0
    assert obj["otherData"]["n_series"] == len(tex.metrics.telemetry) > 0


def test_openmetrics_equal(pair, tmp_path):
    (jex, _), (tex, _), _name = pair
    texts = [obs.write_metrics(str(tmp_path / f"{obs.__name__}.prom"),
                               ex.metrics.telemetry, ex.metrics)
             for obs, ex in ((jobs, jex), (tobs, tex))]
    assert texts[1] == texts[0]
    assert (tmp_path / "repro_torch.obs.prom").read_text() == texts[1]
    assert tobs.render_openmetrics(tex.metrics.telemetry,
                                   tex.metrics) == texts[1]
    parsed = [obs.parse_openmetrics(text)
              for obs, text in zip((jobs, tobs), texts)]
    # repr: a NaN sample equals its twin
    assert [(p.name, p.labels, repr(p.value)) for p in parsed[1][0]] == [
        (p.name, p.labels, repr(p.value)) for p in parsed[0][0]]
    assert parsed[1][1] == parsed[0][1] == []
    assert len(parsed[1][0]) > 0


def test_event_log_lines_equal(pair):
    (jex, _), (tex, _), name = pair
    jlog, tlog = jex.metrics.event_log, tex.metrics.event_log
    lines = tlog.stream.getvalue().splitlines()
    assert lines == jlog.stream.getvalue().splitlines()
    assert len(lines) == tlog.n_events > 0
    events = {json.loads(ln)["event"] for ln in lines}
    assert events <= set(tobs.EVENTS)
    assert tobs.EVENTS == jobs.EVENTS
    if name == "overload":
        assert "slo_alert" in events
        assert tex.metrics.slo.alerts == jex.metrics.slo.alerts
        assert tex.metrics.slo.alerts


def test_critical_paths_and_breakdown_equal(pair):
    (jex, jm), (tex, tm), _name = pair
    assert tm.summary() == jm.summary()
    js, ts = jex.metrics.tracer.store, tex.metrics.tracer.store
    rids = sorted({s.request_id for s in ts.by_name("request")})
    assert rids == sorted({s.request_id for s in js.by_name("request")})
    assert rids
    for rid in rids:
        tpath = [seg.to_jsonable() for seg in tobs.critical_path(ts, rid)]
        assert tpath == [seg.to_jsonable()
                         for seg in jobs.critical_path(js, rid)], rid
        assert [s.span_id for s in tobs.request_chain(ts, rid)] == [
            s.span_id for s in jobs.request_chain(js, rid)], rid
    assert tobs.workload_breakdown(ts) == jobs.workload_breakdown(js)


def test_telemetry_series_match_reference():
    """Counter, gauge and histogram series fed the same updates give the
    same retained points and exposition in both packages (a ring of 64
    points a series, so eviction runs too)."""
    import numpy as np
    rng = np.random.default_rng(3)
    updates = [(float(t), float(v), int(k)) for t, v, k in zip(
        np.cumsum(rng.exponential(1e-3, size=200)),
        rng.uniform(0, 5, size=200), rng.integers(0, 3, size=200))]
    out = []
    for obs in (jobs, tobs):
        tel = obs.Telemetry(clock="virtual", max_points=64)
        for t, v, k in updates:
            if k == 0:
                tel.counter("c_total", dev=1).inc(t, v)
            elif k == 1:
                tel.gauge("g", dev=2).set(t, v)
            else:
                tel.histogram("h_seconds").observe(t, v * 1e-3)
        out.append((tel.to_jsonable(), tel.n_points(),
                    obs.render_openmetrics(tel)))
    assert out[1] == out[0]
