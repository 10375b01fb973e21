"""The port's analytic and discrete-event benchmark drivers
(repro_torch.benchmarks: fig1, fig15's analytic sections, fig16, fig17,
fig19, fig20, run, compare, report) against the repository's
`benchmarks/`, on the CPU.

Both sides run in this process. Each reference module's `row` is
replaced by a recorder (so its raw numbers are compared, not their
printed rounding) and its `RESULTS` pointed at the test's tmp dir; the
port's records go to the tmp dir through `common.RESULTS`. Values from
the analytic models and the discrete-event clock are compared with ==;
wall-clock fields (compile, verify and map wall seconds) are left out.
F8, a fault of the reference that the port copies: fig22's fhemem gate
fails at its default size in both packages.
"""
import importlib
import json
import os
import sys

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from repro_torch.benchmarks import common  # noqa: E402

WALL = {"compile_wall_s", "map_wall_s", "verify_wall_s"}


@pytest.fixture
def results(tmp_path, monkeypatch):
    """Point the port's RESULTS at tmp_path/port; return a function that
    imports a reference module with its RESULTS at tmp_path/ref and its
    rows recorded into a list."""
    monkeypatch.setattr(common, "RESULTS", str(tmp_path / "port"))

    def reference(name):
        mod = importlib.import_module(f"benchmarks.{name}")
        rows = []
        if hasattr(mod, "RESULTS"):
            monkeypatch.setattr(mod, "RESULTS", str(tmp_path / "ref"))
        monkeypatch.setattr(mod, "row", lambda *a: rows.append(a))
        return mod, rows
    return reference


def port(name):
    return importlib.import_module(f"repro_torch.benchmarks.{name}")


def as_rows(records):
    return [(r["name"], r["us_per_call"], r["derived"]) for r in records]


def jsonl(path):
    return [json.loads(line) for line in open(path)]


def without(rec, keys):
    return {k: v for k, v in rec.items() if k not in keys}


def test_fig1_rows_equal_reference(results, capsys):
    ref, rows = results("fig1_bandwidth")
    ref.main()
    recs = port("fig1_bandwidth").main([])
    assert len(rows) == 12
    assert as_rows(recs) == [(n, us, d) for n, us, d in rows]
    assert capsys.readouterr().out.splitlines() == [
        f"{n},{us:.1f},{d}" for n, us, d in rows]
    on_disk = jsonl(os.path.join(common.RESULTS, "fig1_bandwidth.jsonl"))
    assert [r["device"] for r in on_disk] == [common.HOST] * 12
    assert as_rows(on_disk) == as_rows(recs)


def test_fig15_analytic_rows_equal_reference(results):
    ref, rows = results("fig15_ablations")
    ref.ablate_interconnect()
    ref.ablate_pipeline()
    recs = []
    fig15 = port("fig15_ablations")
    fig15.ablate_interconnect(recs)
    fig15.ablate_pipeline(recs)
    assert len(rows) == 5
    assert as_rows(recs) == [(n, us, d) for n, us, d in rows]


def test_fig15_runs_on_cpu_with_moduli_rows(results):
    recs = port("fig15_ablations").main(["--device", "cpu"])
    names = [r["name"] for r in recs]
    assert names[:3] == ["fig15_moduli_solinas",
                         "fig15_moduli_barrett_generic",
                         "fig15_moduli_nmu_add_ratio"]
    assert all(r["us_per_call"] > 0 for r in recs[:2])
    ref, rows = results("fig15_ablations")
    ref.ablate_moduli()
    # the modmul times are this CPU's; the derived notes are analytic
    assert [(r["name"], r["derived"]) for r in recs[:3]] == \
        [(n, d) for n, _, d in rows]


def test_fig16_rows_equal_reference(results):
    ref, rows = results("fig16_serving")
    ref.main()
    recs = port("fig16_serving").main([])
    assert len(rows) == 10
    assert as_rows(recs) == [(n, us, d) for n, us, d in rows]


def test_fig17_records_equal_reference(results):
    """At --smoke: the default size also runs the reference's wall-clock
    verify gate (< 5 % of compile wall), which a shared CPU does not
    hold reliably; its records are the same code at other sizes."""
    ref, _ = results("fig17_compiler")
    ref.main(["--smoke"])
    recs = port("fig17_compiler").main(["--smoke"])
    want = jsonl(os.path.join(ref.RESULTS, "fig17_compiler.jsonl"))
    got = jsonl(os.path.join(common.RESULTS, "fig17_compiler.jsonl"))
    assert len(recs) == len(want) == 24
    assert [without(r, WALL | {"device"}) for r in got] == \
        [without(r, WALL) for r in want]
    assert {r["device"] for r in got} == {common.HOST}


@pytest.mark.parametrize("smoke", [True, False])
def test_fig19_records_equal_reference(results, smoke):
    argv = ["--smoke"] if smoke else []
    ref, rows = results("fig19_pim")
    ref.main(argv)
    port("fig19_pim").main(argv)
    want = jsonl(os.path.join(ref.RESULTS, "fig19_pim.jsonl"))
    got = jsonl(os.path.join(common.RESULTS, "fig19_pim.jsonl"))
    assert len(got) == len(want) > 12
    assert [without(r, {"device"}) for r in got] == want


def _fig20_sections(mod, n_req):
    """fig20's sections at the smoke setting with `n_req` requests a
    point: the capacity probe, the sweep's top load at 1 and 4 devices,
    and the routing ablation's three routers on small caches; the records
    main() would write for those points."""
    params, mem, start, _ = mod._setting(True)
    probe = mod._build_fleet(params, mem, start, n_devices=1,
                             router="round_robin", cache_bytes=1 << 30,
                             smoke=True)
    pm = probe.serve(mod._arrivals(probe, n_req, 1e9, 0.0))
    cap1 = pm.count("requests_completed") / pm.device_busy_s[0]
    deadline_s = 2 * probe.policy.max_wait_s + 4 * pm.batch_service.mean
    recs = []
    for n_dev in (1, 4):
        fleet = mod._build_fleet(params, mem, start, n_devices=n_dev,
                                 router="least_loaded", cache_bytes=1 << 30,
                                 smoke=True)
        recs.append(dict(mod._point(fleet, n_req, 4.0 * cap1, deadline_s),
                         figure="sweep", devices=n_dev))
    small = int(1.5 * mod._working_set_bytes(params, mem, start, True))
    for policy in ("round_robin", "least_loaded", "cache_affinity"):
        fleet = mod._build_fleet(params, mem, start, n_devices=4,
                                 router=policy, cache_bytes=small,
                                 smoke=True, preload_keys=False)
        recs.append(dict(mod._point(fleet, n_req, 3.0 * cap1, deadline_s),
                         figure="ablation", router=policy))
    return cap1, deadline_s, recs


def test_fig20_sections_equal_reference(results):
    ref, _ = results("fig20_fleet")
    want = _fig20_sections(ref, 240)
    got = _fig20_sections(port("fig20_fleet"), 240)
    assert got == want
    assert want[2][0]["throughput_rps"] > 0


def test_fig22_default_fhemem_gate_fails_in_both_f8(results, monkeypatch):
    """F8: at its default size the reference's fig22 fails its own fhemem
    gate (the NTT phase never peaks); the port copies it. Both raise the
    same AssertionError before the wall-overhead gate, with the same
    records up to the gate (read from main's frame)."""
    ref, _ = results("fig22_utilization")
    fig22 = port("fig22_utilization")
    monkeypatch.setattr(fig22, "row", lambda *a: None)

    def run(main, argv):
        with pytest.raises(AssertionError, match="fhemem gate") as exc:
            main(argv)
        frame = next(e for e in exc.traceback if e.name == "main")
        return str(exc.value), frame.locals["records"]

    want_msg, want = run(ref.main, [])
    got_msg, got = run(fig22.main, ["--device", "cpu"])
    assert got_msg == want_msg
    assert "NTT phase peaks at 0.0000 but load peaks at 0.6667" in want_msg
    assert len(want) == 15      # 3 presets x 4 workloads + 3 movement
    assert got == want


def test_run_selects_as_reference():
    ref_run = importlib.import_module("benchmarks.run")
    run = port("run")
    assert run.MODULES == ref_run.MODULES
    for only in (None, "fig1", "fig1_", "fig20", "fig2", "kernels"):
        assert run.selected(only) == [m for m in ref_run.MODULES
                                      if not only or only in m]
    # every module run.py names exists in the port, with a main(argv)
    for m in run.MODULES:
        assert callable(port(m).main)
    assert run.ON_DEVICE < set(run.MODULES)


def test_run_only_passes_device(results, capsys):
    port("run").main(["--only", "fig1_bandwidth", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == ["name,us_per_call,derived",
                       "# --- fig1_bandwidth ---"]
    assert len(out) == 14


def _write_results(dirpath, goodput):
    os.makedirs(dirpath, exist_ok=True)
    recs = [{"figure": "utilization", "workload": "helr",
             "preset": "fhemem", "goodput_rps": goodput,
             "mean_util": 0.6},
            {"figure": "overhead", "overhead_frac": 0.01}]
    with open(os.path.join(dirpath, "fig22_utilization.jsonl"), "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


def test_compare_exit_codes_equal_reference(tmp_path, capsys):
    ref = importlib.import_module("benchmarks.compare")
    compare = port("compare")
    assert compare.SPECS == [tuple(s) for s in ref.SPECS]
    a, b, c = (str(tmp_path / d) for d in "abc")
    _write_results(a, goodput=1000.0)
    _write_results(b, goodput=900.0)       # -10% > 2% budget
    os.makedirs(c)
    with open(os.path.join(c, "fig22_utilization.jsonl"), "w") as f:
        f.write(json.dumps({"figure": "utilization", "workload": "lola",
                            "preset": "flat", "goodput_rps": 5.0,
                            "mean_util": 0.1}) + "\n")
    cases = ([a, b], [a, a], [a, b, "--threshold-scale", "10"],
             [a, str(tmp_path / "missing")], [a, c])
    codes = []
    for argv in cases:
        want = ref.main(argv)
        ref_out = capsys.readouterr()
        got = compare.main(argv)
        out = capsys.readouterr()
        assert (got, out.out, out.err) == (want, ref_out.out, ref_out.err)
        codes.append(got)
    assert codes == [1, 0, 0, 2, 0]


def test_report_renders_null_dryrun_fields_as_dash(results, capsys):
    """A port dry-run record (null compile fields, with reasons) and a
    roofline record with a null collective_s render without raising, as
    the dash and the reason, never as 0."""
    from repro_torch.launch import dryrun, roofline
    rec = dryrun.run_cell("qwen3-8b", "decode_32k", multi_pod=False,
                          count=False)
    assert rec["status"] == "ok" and rec["compile_s"] is None
    os.makedirs(common.RESULTS)
    with open(os.path.join(common.RESULTS, "dryrun.jsonl"), "w") as f:
        f.write(json.dumps(rec) + "\n")
    roof = dict(arch="qwen3-8b", shape="decode_32k", mesh="16x16",
                status="ok", absent={"collective_s": "no collective"},
                **roofline.terms_of(1e15, 2 ** 30, 2 ** 20, 256, 5e14))
    with open(os.path.join(common.RESULTS, "roofline.jsonl"), "w") as f:
        f.write(json.dumps(roof) + "\n")
    port("fig1_bandwidth").main([])
    capsys.readouterr()
    report = port("report")
    assert report.main(["dryrun"]) == 0
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines()
                if ln.startswith("| qwen3-8b | decode_32k"))
    cells = [c.strip() for c in line.split("|")[1:-1]]
    assert cells[4:8] == [report.DASH] * 4     # compile, flops, coll, temp
    assert float(cells[8]) > 0                 # argument GiB
    assert dryrun.ABSENT["compile_s"] in out
    assert "| 0.0 |" not in line and "| 0 |" not in line
    assert report.main(["roofline"]) == 0
    out = capsys.readouterr().out
    assert "one H100's peaks" in out and "v5e" not in out
    assert "no collective" in out and report.DASH in out
    assert report.main([]) == 0     # every table, missing files skipped
