"""The port's benchmark drivers that place tensors (repro_torch.benchmarks:
fig18, fig12, fig13, fig21, fig22, and the lm_pretrain example) on the
CPU, against the repository's `benchmarks/` where the numbers are the
reference's.

fig18 runs at --smoke through both routes: the library route on a
backend built with use_kernels=False and the kernel route on the
kernels' plain versions, whose decodes must be bit-equal; the analytic
prediction of every stage equals the reference's `stage_times` on the
reference's own compiled schedule. fig21 and fig22 at --smoke: their
records on the discrete-event clock and their trace and OpenMetrics
files equal the reference's. Their wall-clock gates (encrypted serving
with tracing and telemetry armed against detached) are not run on a
shared CPU: fig21's sections are driven without `_ct_overhead` and
fig22's `_overhead` is replaced in both packages by one that serves
nothing; the gates run on the card (chip_smoke.py's figs phase).
"""
import importlib
import json
import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from repro_torch.benchmarks import common  # noqa: E402

CPU = ["--device", "cpu"]


@pytest.fixture
def results(tmp_path, monkeypatch):
    monkeypatch.setattr(common, "RESULTS", str(tmp_path / "port"))

    def reference(name):
        mod = importlib.import_module(f"benchmarks.{name}")
        monkeypatch.setattr(mod, "RESULTS", str(tmp_path / "ref"))
        monkeypatch.setattr(mod, "row", lambda *a: None)
        return mod
    return reference


def port(name, monkeypatch):
    mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
    monkeypatch.setattr(mod, "row", lambda *a: None, raising=False)
    return mod


def jsonl(path):
    return [json.loads(line) for line in open(path)]


def test_fig18_smoke_kernel_route_bit_equal_and_predictions(results,
                                                           monkeypatch):
    fig18 = port("fig18_calibration", monkeypatch)
    decodes = []
    counted = fig18._counted_runs

    def keep(engine, *args):
        out = counted(engine, *args)
        decodes.append((engine.use_kernels, out[0]))
        return out

    monkeypatch.setattr(fig18, "_counted_runs", keep)
    recs = fig18.main(["--smoke", "--use-kernels"] + CPU)

    # the library route is built with use_kernels=False, the kernel route
    # with True; on the CPU neither launches a kernel
    lib = [r for r in recs if r["stage"] == "total" and "route" not in r]
    ker = [r for r in recs if r.get("route") == "kernels"
           and r["stage"] == "total"]
    assert [r["use_kernels"] for r in lib] == [False] * 4
    assert [r["use_kernels"] for r in ker] == [True] * 4
    assert all(not any(r["launches"].values()) for r in lib + ker)
    assert [u for u, _ in decodes] == [False, True] * 4
    for (_, lib_out), (_, ker_out) in zip(decodes[::2], decodes[1::2]):
        for a, b in zip(lib_out, ker_out):
            np.testing.assert_array_equal(a, b)
    for r in lib:
        assert r["max_decrypt_error"] <= r["tolerance"]
        assert math.isfinite(r["measured_s"]) and r["measured_s"] > 0
    assert all(r["bit_equal"] for r in ker)
    assert {r["device"] for r in jsonl(os.path.join(
        common.RESULTS, "fig18_calibration.jsonl"))} == {"cpu"}

    # predicted_s of every stage is the reference's stage_times on the
    # reference's schedule (its CompileCache; its main is not run)
    ref = results("fig18_calibration")
    from repro.compiler import PassConfig
    from repro.core.trace import trace_program
    from repro.runtime.compile_cache import CompileCache
    params, mem, start, batch = ref._setting(True)
    cc = CompileCache()
    cfg = PassConfig(start_level=start, bsgs_min_terms=4)
    stages = [r for r in recs
              if isinstance(r["stage"], int) and "route" not in r]
    kstages = [r for r in recs
               if isinstance(r["stage"], int) and "route" in r]
    assert [(r["workload"], r["stage"]) for r in kstages] == \
        [(r["workload"], r["stage"]) for r in stages]
    want = []
    for wname, (fn, n_in, consts) in ref._workloads(True).items():
        sched = cc.get_schedule(trace_program(fn, n_in, const_names=consts),
                                params, mem, pass_config=cfg)
        want += [(wname, st.idx, len(st.ops), load + max(comp, xfer))
                 for st, (load, comp, xfer) in zip(
                     sched.stages, sched.stage_times(batch))]
    assert [(r["workload"], r["stage"], r["n_ops"], r["predicted_s"])
            for r in stages] == want


def test_fig18_library_route_is_not_the_kernels(monkeypatch):
    """The port's CiphertextBackend defaults to the kernels on CUDA, so
    fig18 builds its library backend with use_kernels=False explicitly
    (not the default, None), whatever the device."""
    fig18 = port("fig18_calibration", monkeypatch)
    made = []

    class Backend:
        def __init__(self, params, use_kernels=None, device=None):
            made.append(use_kernels)
            raise StopIteration

    monkeypatch.setattr(fig18, "CiphertextBackend", Backend)
    with pytest.raises(StopIteration):
        fig18.main(["--smoke", "--use-kernels"] + CPU)
    assert made == [False]


@pytest.mark.parametrize("name,n_rows", [("fig12_workloads", 9),
                                         ("fig13_breakdown", 6)])
def test_fig12_fig13_rows_named_and_finite(results, monkeypatch, name,
                                           n_rows):
    recs = port(name, monkeypatch).main(CPU)
    tag = name.split("_")[0]
    assert len(recs) == n_rows
    assert all(r["name"].startswith(f"{tag}_") for r in recs)
    assert all(math.isfinite(r["us_per_call"]) and r["us_per_call"] > 0
               for r in recs)
    # library route (torch ops): no row reads as a kernel time
    assert not any(r["name"].endswith(("_cuda", "_plain")) for r in recs)
    on_disk = jsonl(os.path.join(common.RESULTS, f"{name}.jsonl"))
    assert [r["name"] for r in on_disk] == [r["name"] for r in recs]
    assert {r["device"] for r in on_disk} == {"cpu"}


def _fig21_des(mod, trace_path):
    """fig21 --smoke's sections on the discrete-event clock, as its main
    runs them (probe, traced serve, breakdown, PIM rollup, verify spans),
    without the wall-clock overhead gates; the trace file is written as
    main writes it."""
    _, _, _, n_req = mod._setting(True)
    probe = mod._build(True, traced=False)
    pm = probe.serve(mod._arrivals(probe, max(40, n_req // 8), 1e9))
    rate = 0.9 * pm.count("requests_completed") / pm.elapsed_s
    ex_off = mod._build(True, traced=False)
    m_off = ex_off.serve(mod._arrivals(ex_off, n_req, rate))
    ex = mod._build(True, traced=True)
    m_on = ex.serve(mod._arrivals(ex, n_req, rate))
    assert m_on.summary() == m_off.summary()
    store = ex.metrics.tracer.store
    recs = [{"n_spans": len(store), "n_requests": m_on.request_latency.count,
             "summary": m_on.summary()}]
    for wname, bd in sorted(mod.workload_breakdown(store).items()):
        recs.append(dict(bd, figure="breakdown", workload=wname))
    pim_m, isa = mod._pim_isa_rollup(True, n_req, rate)
    recs.append({"figure": "pim_isa", "class_cycles": isa,
                 "n_requests": pim_m.count("requests_completed")})
    ver = mod._verify_compile_spans(True, rate)
    recs.append({k: ver[k] for k in ("n_compiles", "verify_findings")})
    mod.write_trace(store, trace_path, clock="virtual")
    return rate, recs


def test_fig21_smoke_des_records_and_trace_equal_reference(results,
                                                          monkeypatch,
                                                          tmp_path):
    ref = results("fig21_trace")
    fig21 = port("fig21_trace", monkeypatch)
    want = _fig21_des(ref, str(tmp_path / "ref.json"))
    got = _fig21_des(fig21, str(tmp_path / "port.json"))
    assert got == want
    assert len(want[1]) == 7        # totals, 4 workloads, pim_isa, verify
    ref_trace = open(tmp_path / "ref.json", "rb").read()
    assert open(tmp_path / "port.json", "rb").read() == ref_trace
    assert json.loads(ref_trace)["traceEvents"]


def test_fig22_smoke_des_records_and_metrics_equal_reference(results,
                                                            monkeypatch,
                                                            tmp_path):
    ref = results("fig22_utilization")
    fig22 = port("fig22_utilization", monkeypatch)
    monkeypatch.setattr(ref, "_overhead", lambda smoke: (1.0, 1.0))
    monkeypatch.setattr(fig22, "_overhead", lambda smoke, dev: (1.0, 1.0))
    ref.main(["--smoke", "--metrics-out", str(tmp_path / "ref.txt")])
    fig22.main(["--smoke", "--metrics-out", str(tmp_path / "port.txt")]
               + CPU)
    want = jsonl(os.path.join(ref.RESULTS, "fig22_utilization.jsonl"))
    got = jsonl(os.path.join(common.RESULTS, "fig22_utilization.jsonl"))
    assert [r["figure"] for r in want][-5:] == [
        "movement", "gate_fhemem", "gate_flat", "gate_openmetrics",
        "overhead"]
    path = {"path"}            # the artifact's file name differs
    assert [{k: v for k, v in r.items() if k not in path | {"device"}}
            for r in got[:-1]] == \
        [{k: v for k, v in r.items() if k not in path} for r in want[:-1]]
    assert open(tmp_path / "port.txt").read() == \
        open(tmp_path / "ref.txt").read()


def test_lm_pretrain_cpu_loss_decreases(tmp_path):
    from repro_torch.examples import lm_pretrain
    out = lm_pretrain.main(["--device", "cpu", "--steps", "20", "--batch",
                            "2", "--seq", "32", "--ckpt-dir",
                            str(tmp_path)])
    assert len(out["history"]) == 20
    assert out["last10"] < out["first10"]
    assert all(math.isfinite(h["loss"]) for h in out["history"])
    assert not torch.distributed.is_initialized()
