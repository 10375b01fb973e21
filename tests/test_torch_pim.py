"""The port's PIM hardware model (repro_torch.pim) against the JAX
reference's (repro.pim), on the CPU.

* Every preset's `PimArch` (and the memory model projected from it)
  field for field equal to the reference's.
* For every serve_fhe workload at the smoke parameters and at the
  paper's, priced against each preset's memory model: `plan_layout`'s
  placements and `lower_schedule`'s instruction streams equal, cycles
  with ``==``, and ``total_cycles`` (a built-in ``sum``) ``==`` too. The
  comparison is against the live reference under the same interpreter,
  never against a stored golden.
* `PimBackend` on the flat arch within 1 % of `AnalyticBackend` on every
  workload's schedule, and its seconds equal to the reference's.
* `PimBackend(verify=True)` (directly and through resolve_backend)
  hazard-analyzes what it lowers, the mesh backend resolves, and
  serve_fhe refuses a --mem-profile that contradicts --pim-preset.
"""
import dataclasses

import pytest

pytest.importorskip("torch")

import repro.pim as jpim  # noqa: E402
import repro_torch.pim as tpim  # noqa: E402
from repro.core import params as jparams  # noqa: E402
from repro.core.pipeline import MemoryModel as JMem  # noqa: E402
from repro.launch import serve_fhe as jserve  # noqa: E402
from repro.runtime.batcher import Batch as JBatch  # noqa: E402
from repro.runtime.executor import AnalyticBackend as JAnalytic  # noqa: E402
from repro.runtime.metrics import MetricsRegistry as JMetrics  # noqa: E402
from repro_torch.core import params as tparams  # noqa: E402
from repro_torch.core.pipeline import MemoryModel as TMem  # noqa: E402
from repro_torch.launch import serve_fhe as tserve  # noqa: E402
from repro_torch.runtime.batcher import Batch as TBatch  # noqa: E402
from repro_torch.runtime.executor import (  # noqa: E402
    AnalyticBackend as TAnalytic, resolve_backend)
from repro_torch.runtime.metrics import (  # noqa: E402
    MetricsRegistry as TMetrics)

PRESETS = sorted(jpim.PRESETS)
# serve_fhe's two parameter points: --smoke, and the paper's deep set
POINTS = {
    "smoke": (dict(log_n=10, n_levels=8, dnum=2), 7),
    "paper": (None, 20),
}


def _params(pkg, point):
    kw, _ = POINTS[point]
    return (pkg.paper_params_bootstrap() if kw is None
            else pkg.test_params(**kw))


_SCHEDS = {}


def schedules(side, point, preset):
    """serve_fhe's workloads compiled by one package's executor against
    the preset's memory model (what `serve_fhe --backend pim
    --pim-preset <preset>` serves)."""
    key = (side, point, preset)
    if key not in _SCHEDS:
        serve, params_mod, pim = ((jserve, jparams, jpim) if side == "j"
                                  else (tserve, tparams, tpim))
        kw = {} if side == "j" else {"device": "cpu"}
        ex = serve.build_executor(
            _params(params_mod, point), pim.memory_model(preset),
            backend_name="pim", max_batch=8, max_wait_s=2e-3,
            cache_bytes=0, start_level=POINTS[point][1], **kw)
        _SCHEDS[key] = {
            name: ex.compile_cache.get_schedule(
                w.trace, ex.params, ex.mem, ex.mapper,
                pass_config=ex.pass_config)
            for name, w in ex.workloads.items()}
    return _SCHEDS[key]


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_arch_equal(preset):
    assert sorted(tpim.PRESETS) == PRESETS
    ja, ta = jpim.get_arch(preset), tpim.get_arch(preset)
    assert dataclasses.asdict(ta) == dataclasses.asdict(ja)
    assert ta is tpim.PRESETS[preset]
    assert (dataclasses.asdict(tpim.memory_model(preset))
            == dataclasses.asdict(jpim.memory_model(preset)))
    for attr in ("n_banks", "bank_bytes", "total_bytes", "lanes_per_bank"):
        assert getattr(ta, attr) == getattr(ja, attr), attr
    assert ta.elems_per_second() == ja.elems_per_second()
    for n in (1 << 10, 1 << 16):
        assert ta.ntt_pass_seconds(n) == ja.ntt_pass_seconds(n)
        assert ta.modmul_row_seconds(n) == ja.modmul_row_seconds(n)
    assert (tpim.arch_for_memory_model(tpim.memory_model(preset)).name
            == jpim.arch_for_memory_model(jpim.memory_model(preset)).name
            == preset)


def test_custom_memory_model_wraps_to_flat_arch_equal():
    kw = dict(n_partitions=6, partition_bytes=3 * 2 ** 20)
    ja = jpim.arch_for_memory_model(JMem(**kw))
    ta = tpim.arch_for_memory_model(TMem(**kw))
    assert dataclasses.asdict(ta) == dataclasses.asdict(ja)
    assert ta.degenerate
    assert (dataclasses.asdict(tpim.flat_arch_from_memory_model(TMem(**kw)))
            == dataclasses.asdict(jpim.flat_arch_from_memory_model(
                JMem(**kw))))


def _layout_rows(plan):
    return [(s.stage_idx, s.home_channel, s.home_bank, s.spill_bytes_bank,
             s.spill_bytes_channel, s.total_bytes, s.streamed_bytes,
             [dataclasses.astuple(p) for p in s.placements])
            for s in plan.stages]


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("point", sorted(POINTS))
def test_layout_and_instruction_streams_equal(point, preset):
    js, ts = schedules("j", point, preset), schedules("t", point, preset)
    assert sorted(ts) == sorted(js) == sorted(tserve.WORKLOADS)
    for name in js:
        jarch, tarch = jpim.get_arch(preset), tpim.get_arch(preset)
        jplan = jpim.plan_layout(js[name], jarch)
        tplan = tpim.plan_layout(ts[name], tarch)
        assert _layout_rows(tplan) == _layout_rows(jplan), name
        jprog = jpim.lower_schedule(js[name], jarch, jplan)
        tprog = tpim.lower_schedule(ts[name], tarch, tplan)
        assert len(tprog) == len(jprog) > 0, name
        assert [dataclasses.astuple(i) for i in tprog.instrs] == [
            dataclasses.astuple(i) for i in jprog.instrs], name
        assert tprog.total_cycles() == jprog.total_cycles(), name
        assert tprog.summary() == jprog.summary(), name
        assert (tprog.arch_name, tprog.freq_hz, tprog.n_stages) == (
            jprog.arch_name, jprog.freq_hz, jprog.n_stages)
        for st in range(tprog.n_stages):
            assert tprog.stage_seconds(st) == jprog.stage_seconds(st)


@pytest.mark.parametrize("point", sorted(POINTS))
def test_flat_pim_backend_within_one_percent_of_analytic(point):
    """The reference's anchor on the port: the flat preset's PimBackend
    bills every workload's schedule within 1 % of AnalyticBackend, and
    to the same float as the reference's PimBackend."""
    mem_t, mem_j = tpim.memory_model("flat"), jpim.memory_model("flat")
    ts, js = schedules("t", point, "flat"), schedules("j", point, "flat")
    for name in ts:
        for b in (1, 8):
            out = []
            for backend, batch, metrics in (
                    (tpim.PimBackend(preset="flat"), TBatch, TMetrics),
                    (TAnalytic(mem_t), TBatch, TMetrics),
                    (jpim.PimBackend(preset="flat"), JBatch, JMetrics),
                    (JAnalytic(mem_j), JBatch, JMetrics)):
                sched = ts[name] if batch is TBatch else js[name]
                out.append(backend.execute(
                    sched, batch(name, [], [[]] * b, 0.0), key_cache=None,
                    metrics=metrics(mem_t.n_partitions), workload=name))
            t_pim, t_an, j_pim, j_an = out
            assert t_an > 0
            assert abs(t_pim - t_an) / t_an <= 0.01, (name, b, t_pim, t_an)
            assert (t_pim, t_an) == (j_pim, j_an), name


def test_pim_verify_raises_not_ported():
    """Once a stub, now the working path: verify-on-lower through both
    constructors (the hazard analyzer runs on what is lowered and counts
    its findings), and the mesh backend resolves on the CPU."""
    import torch.distributed as dist
    from repro_torch.runtime.executor import MeshBackend
    ts = schedules("t", "smoke", "fhemem")
    for be in (tpim.PimBackend(verify=True),
               resolve_backend("pim", None, tpim.memory_model("fhemem"),
                               verify=True)):
        assert be.verify and be.arch.name == "fhemem"
        for sched in ts.values():
            assert be.program_for(sched).instrs
        assert be.verify_wall_s > 0 and be.verify_findings == 0
    be = resolve_backend("pim", None, tpim.memory_model("hbm2"))
    assert isinstance(be, tpim.PimBackend) and be.arch.name == "hbm2"
    assert not be.verify
    try:
        be = resolve_backend("mesh", tparams.test_params(log_n=6),
                             tpim.memory_model("flat"), device="cpu")
        assert isinstance(be, MeshBackend) and be.slots_per_ct == 32
        assert be.device.type == "cpu" and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="'fhemem', 'flat', 'hbm2'"):
        resolve_backend("bogus", None, tpim.memory_model("flat"))


def test_serve_fhe_rejects_conflicting_presets(capsys):
    with pytest.raises(SystemExit) as ei:
        tserve.parse_args(["--smoke", "--backend", "pim", "--pim-preset",
                           "fhemem", "--mem-profile", "flat"])
    assert ei.value.code == 2
    assert "--pim-preset" in capsys.readouterr().err
    args = tserve.parse_args(["--backend", "pim", "--pim-preset", "hbm2",
                              "--mem-profile", "hbm2"])
    assert (args.pim_preset, args.mem_profile) == ("hbm2", "hbm2")
