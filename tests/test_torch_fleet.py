"""The port's fleet (repro_torch.fleet) and its serve_fhe flags against
the JAX reference's, on the CPU.

* For the analytic and pim backends, across the three routers, with and
  without continuous batching and preemption: serve_fhe's fleet serves
  the same arrivals to the same metrics summary, completion times and
  per-device busy seconds, float for float (both run on a virtual clock).
* A fleet of one device equals the port's single executor.
* A ciphertext fleet of two devices at --smoke (log N 8) serves every
  workload within tolerance, both devices serve, each pads its batches to
  --max-batch and holds the same relin key; its trace and metrics files
  validate. (The reference's own ciphertext fleet is too slow for the
  suite on the CPU, so this case is the port's alone.)
* serve_fhe's flags equal the reference's, less --verify, plus --device;
  --backend lacks only mesh.
* At paper parameters, --backend pim --fleet 4 --router least_loaded
  --continuous-batching --preempt --requests 200 writes trace and
  OpenMetrics files byte-equal to the reference's, and the same event-log
  lines.
"""
import argparse
import io
import json
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.core.params import test_params as j_test_params  # noqa: E402
from repro.core.pipeline import MemoryModel as JMem  # noqa: E402
from repro.fleet.router import POLICIES  # noqa: E402
from repro.launch import serve_fhe as jserve  # noqa: E402
from repro.pim.arch import memory_model as j_pim_mem  # noqa: E402
from repro_torch.core.params import (  # noqa: E402
    test_params as t_test_params)
from repro_torch.core.pipeline import MemoryModel as TMem  # noqa: E402
from repro_torch.fleet import FleetScheduler  # noqa: E402
from repro_torch.fleet.router import POLICIES as T_POLICIES  # noqa: E402
from repro_torch.launch import serve_fhe as tserve  # noqa: E402
from repro_torch.obs import parse_openmetrics, validate_file  # noqa: E402
from repro_torch.pim.arch import memory_model as t_pim_mem  # noqa: E402

SMOKE = dict(log_n=10, n_levels=8, dnum=2)
SMOKE_MEM = dict(n_partitions=4, partition_bytes=8 * 2 ** 20)
# the nine flags of the fleet, the PIM model and the exporters
NEW_FLAGS = ("--pim-preset", "--mem-profile", "--fleet", "--router",
             "--continuous-batching", "--preempt", "--trace-out",
             "--metrics-out", "--log-json")


def _side(side, backend):
    """(serve_fhe module, smoke params, memory model) of one package, the
    pim backend priced against the fhemem preset as --pim-preset gives."""
    if side == "j":
        mem = j_pim_mem("fhemem") if backend == "pim" else JMem(**SMOKE_MEM)
        return jserve, j_test_params(**SMOKE), mem, {}
    mem = t_pim_mem("fhemem") if backend == "pim" else TMem(**SMOKE_MEM)
    return tserve, t_test_params(**SMOKE), mem, {"device": "cpu"}


def _arrivals(mod, ex):
    return mod.synth_arrivals(ex, n_tenants=3, n_requests=60,
                              rate_rps=5000.0, seed=0, deadline_s=0.2,
                              encrypt=False, max_slots=128)


def _fleet_serve(side, backend, router, stepped, n_devices=4):
    mod, params, mem, kw = _side(side, backend)
    ex = mod.build_fleet_scheduler(
        params, mem, n_devices=n_devices, backend_name=backend,
        router=router, max_batch=8, max_wait_s=2e-3,
        cache_bytes=256 * 2 ** 20, start_level=7,
        continuous_batching=stepped, preempt=stepped, **kw)
    ex.warmup()
    arrivals = _arrivals(mod, ex)
    return ex, ex.serve(arrivals), arrivals


@pytest.mark.parametrize("stepped", [False, True],
                         ids=["atomic", "continuous_preempt"])
@pytest.mark.parametrize("router", POLICIES)
@pytest.mark.parametrize("backend", ["analytic", "pim"])
def test_fleet_metrics_match_reference(backend, router, stepped):
    assert T_POLICIES == POLICIES
    jex, jm, ja = _fleet_serve("j", backend, router, stepped)
    tex, tm, ta = _fleet_serve("t", backend, router, stepped)
    assert isinstance(tex, FleetScheduler)
    assert tm.summary() == jm.summary()
    assert tm.device_busy_s == jm.device_busy_s
    assert tm.occupancy.busy_s == jm.occupancy.busy_s
    assert [r.completion_s for r in ta] == [r.completion_s for r in ja]
    assert tm.count("requests_completed") > 0
    if stepped and backend == "pim":
        # the pim backend steps round by round: the stepped path ran
        assert tm.count("preemptions") == jm.count("preemptions")


@pytest.mark.parametrize("backend", ["analytic", "pim"])
def test_fleet_of_one_equals_single_executor(backend):
    _, params, mem, kw = _side("t", backend)
    ex = tserve.build_executor(params, mem, backend_name=backend,
                               max_batch=8, max_wait_s=2e-3,
                               cache_bytes=256 * 2 ** 20, start_level=7,
                               **kw)
    ex.warmup()
    sa = _arrivals(tserve, ex)
    sm = ex.serve(sa)
    _, fm, fa = _fleet_serve("t", backend, "round_robin", False,
                             n_devices=1)
    # what only a fleet records: routing and per-device occupancy
    fs = fm.summary()
    for key in ("routing_hit_rate", "device_occupancy"):
        fs[key] = sm.summary()[key]
    routed = sum(fs["counters"].pop(k, 0)
                 for k in ("routing_hits", "routing_misses"))
    assert routed == len(fa)
    assert fs == sm.summary()
    assert [r.completion_s for r in fa] == [r.completion_s for r in sa]
    assert fm.count("requests_completed") > 0


def test_ciphertext_fleet_of_two_serves_on_cpu(tmp_path):
    trace, prom = tmp_path / "fleet.json", tmp_path / "fleet.prom"
    log = io.StringIO()
    args = tserve.parse_args([
        "--smoke", "--backend", "ciphertext", "--use-kernels", "--device",
        "cpu", "--fleet", "2", "--router", "least_loaded", "--requests",
        "8", "--trace-out", str(trace), "--metrics-out", str(prom),
        "--log-json"])
    res = tserve.serve(args, log_stream=log)
    fleet, m = res.executor, res.executor.metrics
    assert isinstance(fleet, FleetScheduler) and len(fleet.devices) == 2
    assert res.accuracy_ok is True
    assert sorted(m.decrypt_error) == sorted(tserve.WORKLOADS)
    assert m.count("requests_completed") == 8
    batches = {d.device_id: 0 for d in fleet.devices}
    for s in m.tracer.store.spans:
        if s.name.startswith("batch:"):
            batches[int(s.track.split(":")[1])] += 1
    for d in fleet.devices:
        assert batches[d.device_id] >= 1, batches
        assert m.device_busy_s[d.device_id] > 0
        # a fleet device pads to --max-batch as the single executor does
        assert d.backend.pad_batch_to == args.max_batch == 8
        assert d.backend.engine.use_kernels
    k0, k1 = (d.backend.engine.rk.data for d in fleet.devices)
    assert torch.equal(k0, k1)
    assert validate_file(str(trace)) == []
    obj = json.loads(trace.read_text())
    assert obj["otherData"]["clock"] == "wall"
    threads = {e["args"]["name"] for e in obj["traceEvents"]
               if e["ph"] == "M" and e["name"] == "thread_name"
               and e["pid"] == 1}
    assert threads == {"0", "1"}
    samples, errors = parse_openmetrics(prom.read_text())
    assert samples and not errors
    events = [json.loads(ln) for ln in log.getvalue().splitlines()]
    assert len(events) == m.event_log.n_events
    assert sum(e["event"] == "routed" for e in events) == 8


class _Parsed(Exception):
    pass


def _parser(monkeypatch, call):
    """The ArgumentParser an entry point builds, caught at parse time."""
    def catch(self, *a, **k):
        raise _Parsed(self)
    with monkeypatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(_Parsed) as ei:
            call()
    return {a.option_strings[0]: a for a in ei.value.args[0]._actions
            if a.option_strings and a.dest != "help"}


def test_serve_flags_match_reference(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve_fhe"])
    ref = _parser(monkeypatch, jserve.main)
    port = _parser(monkeypatch, lambda: tserve.parse_args([]))
    assert set(port) == set(ref) - {"--verify"} | {"--device"}
    for flag in set(port) - {"--device", "--backend", "--use-kernels"}:
        a, b = port[flag], ref[flag]
        assert (type(a), a.dest, a.default, a.choices, a.type, a.metavar,
                a.nargs) == (type(b), b.dest, b.default, b.choices, b.type,
                             b.metavar, b.nargs), flag
    assert set(ref["--backend"].choices) - set(port["--backend"].choices) \
        == {"mesh"}
    assert port["--backend"].default == ref["--backend"].default
    for flag in NEW_FLAGS:
        assert port[flag].help.replace("repro_torch", "repro") \
            == ref[flag].help, flag


PIM_RUN = ["--backend", "pim", "--fleet", "4", "--router", "least_loaded",
           "--continuous-batching", "--preempt", "--requests", "200",
           "--log-json"]


def _out_lines(text):
    """(report lines, event-log lines), the run-specific lines dropped:
    the warmup's wall time and the port's "on <device>"."""
    lines = text.splitlines()
    events = [ln for ln in lines if ln.startswith("{")]
    report = [ln.replace(" backend on cpu,", " backend,")
              for ln in lines if not ln.startswith(("{", "warmup"))]
    return report, events


def test_pim_fleet_trace_and_metrics_byte_equal(tmp_path, monkeypatch,
                                                capsys):
    out = {}
    for side in ("j", "t"):
        trace, prom = tmp_path / f"{side}.json", tmp_path / f"{side}.prom"
        argv = PIM_RUN + ["--trace-out", str(trace), "--metrics-out",
                          str(prom)]
        if side == "j":
            monkeypatch.setattr(sys, "argv", ["serve_fhe"] + argv)
            jserve.main()
        else:
            assert tserve.main(argv + ["--device", "cpu"]) == 0
        text = capsys.readouterr().out
        out[side] = _out_lines(text.replace(str(tmp_path / side), "OUT"))
        out[side] += (trace.read_bytes(), prom.read_bytes())
    assert out["t"][2] == out["j"][2]           # the trace file
    assert out["t"][3] == out["j"][3]           # the OpenMetrics file
    assert out["t"][1] == out["j"][1]           # every event-log line
    assert out["t"][0] == out["j"][0]           # the printed report
    assert validate_file(str(tmp_path / "t.json")) == []
    report = "\n".join(out["t"][0])
    assert "requests_completed    200" in report
    assert "trace: 1285 spans" in report
