"""The port's static verification layer (repro_torch.analysis) against the
JAX reference's (repro.analysis), on the CPU.

Both packages build the same clean artifacts (`make_clean_artifacts` of
each registered workload: trace, load-save schedule, layout and lowered
PIM program on the smoke point), and every comparison is of
`to_jsonable()` with the wall time dropped:

* every trace, schedule, PIM and pass mutation of every workload gives
  the same findings (or the same refusal, where a workload lacks what a
  mutation needs): the mutation kill table is the reference's;
* `PassManager(verify=True)` names the same corrupting pass with the same
  report; a clean verified compile carries its verify wall time;
* the clean lint sweep at the smoke point gives the same reports, and
  `prove()` the same (empty) list of rules that fail to fire;
* `CompileCache` verify-on-miss and `PimBackend(verify=True)` accept the
  same clean inputs and raise `VerificationError` with the same report on
  the same bad ones;
* `python -m repro_torch.analysis.lint --smoke --prove` prints the
  reference's lines (the ms masked) and writes the same JSON lines;
* serve_fhe --smoke --verify prints the same verify summary on the
  analytic and pim backends (ms masked).
"""
import json
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import repro.analysis as ja  # noqa: E402
import repro.analysis.lint as jlint  # noqa: E402
import repro.analysis.mutate as jmut  # noqa: E402
import repro.pim.backend as jpb  # noqa: E402
import repro_torch.analysis as ta  # noqa: E402
import repro_torch.analysis.lint as tlint  # noqa: E402
import repro_torch.analysis.mutate as tmut  # noqa: E402
import repro_torch.pim.backend as tpb  # noqa: E402
from repro.compiler import PassConfig as JPassConfig  # noqa: E402
from repro.compiler import PassManager as JPassManager  # noqa: E402
from repro.compiler.passes import PASS_ORDER as J_ORDER  # noqa: E402
from repro.core.pipeline import (  # noqa: E402
    generate_load_save_pipeline as j_map)
from repro.launch import serve_fhe as jserve  # noqa: E402
from repro.runtime.compile_cache import CompileCache as JCache  # noqa: E402
from repro_torch.compiler import PassConfig as TPassConfig  # noqa: E402
from repro_torch.compiler import PassManager as TPassManager  # noqa: E402
from repro_torch.compiler.passes import PASS_ORDER as T_ORDER  # noqa: E402
from repro_torch.core.pipeline import (  # noqa: E402
    generate_load_save_pipeline as t_map)
from repro_torch.launch import serve_fhe as tserve  # noqa: E402
from repro_torch.runtime.compile_cache import (  # noqa: E402
    CompileCache as TCache)

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORKLOADS = ("helr", "lola", "matvec", "poly")
SIDES = {"j": (ja, jmut, JPassConfig, JPassManager, JCache, j_map, jpb),
         "t": (ta, tmut, TPassConfig, TPassManager, TCache, t_map, tpb)}
PASS_ORDER = {"j": J_ORDER, "t": T_ORDER}
MS = re.compile(r"[0-9]+\.[0-9] ms")


def mask(text: str) -> str:
    return MS.sub("X ms", text)


def jsonable(rep) -> dict:
    """A report's findings without its wall time; the port's hints name
    its own modules (repro_torch.x for the reference's repro.x)."""
    d = rep.to_jsonable()
    assert d.pop("wall_s") >= 0
    return json.loads(json.dumps(d).replace("repro_torch.", "repro."))


_ARTS = {}


def artifacts(side, workload):
    key = (side, workload)
    if key not in _ARTS:
        _ARTS[key] = SIDES[side][1].make_clean_artifacts(workload, "fhemem")
    return _ARTS[key]


def outcome(fn):
    """What one side's call gives: its value, or the refusal it raised."""
    try:
        return "ok", fn()
    except AssertionError as e:
        return "refused", str(e)


def test_catalogue_equal():
    assert [dataclass_tuple(r) for r in ta.RULES.values()] == \
        [dataclass_tuple(r) for r in ja.RULES.values()]
    assert tmut.ALL_MUTATIONS == jmut.ALL_MUTATIONS
    assert sorted(tmut.ALL_MUTATIONS) == sorted(ta.RULES)


def dataclass_tuple(rule):
    return (rule.id, rule.severity, rule.summary)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_clean_artifacts_equal_and_clean(workload):
    reps = {}
    for side in SIDES:
        an, art = SIDES[side][0], artifacts(side, workload)
        reps[side] = [
            an.verify_trace(art.trace, start_level=art.start_level),
            an.verify_schedule(art.schedule, start_level=art.start_level,
                               include_trace=False),
            an.analyze_program(art.program, art.schedule, art.arch,
                               art.layout)]
        assert art.start_level == 7
    assert [jsonable(r) for r in reps["t"]] == \
        [jsonable(r) for r in reps["j"]]
    assert all(not r.findings for r in reps["t"])
    t, j = artifacts("t", workload), artifacts("j", workload)
    assert [(o.idx, o.kind, o.args, o.level) for o in t.trace.ops] == \
        [(o.idx, o.kind, o.args, o.level) for o in j.trace.ops]
    assert len(t.program.instrs) == len(j.program.instrs)


def _mutated_report(side, workload, kind, rule):
    an, mut = SIDES[side][0], SIDES[side][1]
    art = artifacts(side, workload)
    if kind == "trace":
        return an.verify_trace(mut.TRACE_MUTATIONS[rule](art.trace),
                               start_level=art.start_level)
    if kind == "pass":
        return an.verify_pass(art.trace, mut.PASS_MUTATIONS[rule](art.trace),
                              subject="seeded")
    if kind == "schedule":
        return an.verify_schedule(mut.SCHEDULE_MUTATIONS[rule](art.schedule),
                                  start_level=art.start_level,
                                  include_trace=False)
    prog, layout = mut.PIM_MUTATIONS[rule](art.program, art.schedule,
                                           art.layout, art.arch)
    return an.analyze_program(prog, art.schedule, art.arch, layout)


MUTATIONS = ([("trace", r) for r in jmut.TRACE_MUTATIONS]
             + [("pass", r) for r in jmut.PASS_MUTATIONS]
             + [("schedule", r) for r in jmut.SCHEDULE_MUTATIONS]
             + [("pim", r) for r in jmut.PIM_MUTATIONS])


@pytest.mark.parametrize("kind,rule", MUTATIONS,
                         ids=[r for _, r in MUTATIONS])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_mutation_findings_equal(workload, kind, rule):
    got = {side: outcome(lambda s=side: jsonable(
        _mutated_report(s, workload, kind, rule))) for side in SIDES}
    assert got["t"] == got["j"]
    if workload == "matvec":        # the harness's own workload kills all
        assert got["t"][0] == "ok"
        assert rule in {f["rule"] for f in got["t"][1]["findings"]}


@pytest.mark.parametrize("rule", sorted(jmut.PASS_MUTATIONS))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_pass_manager_names_the_corrupting_pass(workload, rule):
    errs = {}
    for side, (an, mut, PassConfig, PassManager, *_ ) in SIDES.items():
        art = artifacts(side, workload)
        # the corrupting pass hides between two legitimate ones
        legit = [p for p in PASS_ORDER[side] if p.name in ("dce", "cse")]
        pm = PassManager(PassConfig(start_level=art.start_level),
                         verify=True,
                         passes=[legit[0], mut.CorruptingPass(rule, "evil"),
                                 legit[1]])
        with pytest.raises(an.PassVerificationError) as ei:
            pm.run(art.trace, art.params)
        errs[side] = (ei.value.pass_name, str(ei.value).split("; first")[0],
                      jsonable(ei.value.report))
    assert errs["t"] == errs["j"]
    assert errs["t"][0] == "evil"


@pytest.mark.parametrize("workload", WORKLOADS)
def test_verified_compile_reports_overhead(workload):
    stats = {}
    for side, (an, mut, PassConfig, PassManager, *_ ) in SIDES.items():
        art = artifacts(side, workload)
        trace, rep = PassManager(PassConfig(start_level=art.start_level),
                                 verify=True).run(art.trace, art.params)
        applied = [s for s in rep.passes if s.applied]
        assert rep.verify_wall_s > 0
        assert all(s.verify_wall_s > 0 for s in applied)
        stats[side] = ([(s.name, s.applied, s.verify_findings)
                        for s in rep.passes], rep.verify_findings,
                       [(o.kind, o.args) for o in trace.ops])
    assert stats["t"] == stats["j"]


def test_clean_sweep_equal():
    reps = {}
    for side, lint in (("j", jlint), ("t", tlint)):
        params = artifacts(side, "matvec").params    # the smoke point
        reps[side] = [jsonable(r) for r in lint.sweep(
            params, params.n_levels - 1)]
    assert len(reps["t"]) == 104
    assert reps["t"] == reps["j"]
    assert not any(r["findings"] for r in reps["t"])


def test_prove_equal():
    assert tlint.prove() == jlint.prove() == []


def test_compile_cache_verify_on_miss():
    out = {}
    for side, (an, mut, PassConfig, _, Cache, mapper, _pb) in SIDES.items():
        art = artifacts(side, "matvec")
        cfg = PassConfig(start_level=art.start_level)
        cache = Cache(verify=True)
        sched = cache.get_schedule(art.trace, art.params, art.mem,
                                   pass_config=cfg)
        assert sched.verify_report.ok and sched._verify_wall_s > 0

        def broken_mapper(trace, params, mem, _m=mapper, **kw):
            s = _m(trace, params, mem, **kw)
            s.stages[0].ops.pop()            # S-COVER violation
            return s

        bad = Cache(verify=True)
        with pytest.raises(an.VerificationError) as ei:
            bad.get_schedule(art.trace, art.params, art.mem,
                             mapper=broken_mapper, pass_config=cfg)
        out[side] = (jsonable(sched.verify_report),
                     dict(cache.metrics.counters),
                     str(ei.value).split("; first")[0],
                     jsonable(ei.value.report), dict(bad.metrics.counters))
    assert out["t"] == out["j"]
    assert "S-COVER" in {f["rule"] for f in out["t"][3]["findings"]}
    assert out["t"][4]["verify_errors"] > 0


def test_pim_backend_verify_on_lower(monkeypatch):
    out = {}
    for side, (an, mut, *_, pb) in SIDES.items():
        art = artifacts(side, "matvec")
        be = pb.PimBackend(arch=art.arch, verify=True)
        prog = be.program_for(art.schedule)
        assert prog.instrs and be.verify_wall_s > 0
        real = pb.lower_schedule

        def bad_lower(schedule, arch, layout=None, _real=real, _mut=mut):
            p = _mut.clone_program(_real(schedule, arch, layout))
            for k, ins in enumerate(p.instrs):
                if ins.opcode == "STORE" \
                        and schedule.stages[ins.stage].out_bytes:
                    del p.instrs[k]
                    return p
            raise AssertionError("no STORE to drop")

        monkeypatch.setattr(pb, "lower_schedule", bad_lower)
        be2 = pb.PimBackend(arch=art.arch, verify=True)
        with pytest.raises(an.VerificationError) as ei:
            be2.program_for(art.schedule)
        out[side] = (be.verify_findings, jsonable(ei.value.report),
                     be2.verify_findings)
    assert out["t"] == out["j"]
    assert "M-ORPHAN" in {f["rule"] for f in out["t"][1]["findings"]}


def test_lint_cli_equal(tmp_path, capsys):
    """The port's `python -m repro_torch.analysis.lint --smoke --prove`
    against the reference's main with the same flags: same lines (ms
    masked), same JSON lines (wall time dropped), exit code 0."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t_jsonl, j_jsonl = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint",
                        "--smoke", "--prove", "--jsonl", str(t_jsonl)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert jlint.main(["--smoke", "--prove", "--jsonl", str(j_jsonl)]) == 0
    j_out = capsys.readouterr().out
    assert mask(r.stdout) == mask(j_out)
    assert r.stdout.splitlines()[-1] == "prove: 28/28 rules fire on seeded " \
        "mutations"

    def lines(p):
        out = []
        for ln in p.read_text().splitlines():
            d = json.loads(ln)
            del d["wall_s"]
            out.append(d)
        return out
    assert lines(t_jsonl) == lines(j_jsonl) and len(lines(t_jsonl)) == 104


@pytest.mark.parametrize("argv", [
    ["--backend", "analytic"], ["--backend", "pim"],
    ["--backend", "pim", "--fleet", "2", "--router", "least_loaded"]],
    ids=["analytic", "pim", "pim-fleet2"])
def test_serve_fhe_verify_summary_equal(monkeypatch, capsys, argv):
    flags = ["--smoke", "--verify", "--requests", "24"] + argv
    monkeypatch.setattr(sys, "argv", ["serve_fhe"] + flags)
    jserve.main()
    j_out = capsys.readouterr().out
    assert tserve.main(flags + ["--device", "cpu"]) == 0
    t_out = capsys.readouterr().out

    def summary(out):
        (line,) = [ln for ln in out.splitlines() if ln.startswith("verify:")]
        return mask(line)
    assert summary(t_out) == summary(j_out)
    assert summary(t_out).endswith(", 0 finding(s), X ms wall")
    if "--fleet" not in argv:
        n_lowered = 0 if argv[1] == "analytic" else 4
        assert summary(t_out).startswith(
            f"verify: 4 schedule(s) + {n_lowered} lowered program(s)")
