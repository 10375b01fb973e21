"""The port's serving driver (repro_torch.launch.serve_fhe) on the CPU.

* ``--smoke --backend ciphertext --device cpu --use-kernels`` serves all
  four workloads through the plain K1-K4 path and exits 0 with every
  workload's decrypt accuracy OK.
* ``--backend analytic --smoke``: on the same arrivals the port's
  executor compiles the same schedules and reports the same stage counts,
  stage seconds and serving metrics as the JAX reference, float for float
  (the analytic backend runs on a virtual clock).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.params import test_params as j_test_params  # noqa: E402
from repro.core.pipeline import MemoryModel as JMem  # noqa: E402
from repro.launch import serve_fhe as jserve  # noqa: E402
from repro_torch.core.params import test_params as t_test_params  # noqa: E402
from repro_torch.core.pipeline import MemoryModel as TMem  # noqa: E402
from repro_torch.launch import serve_fhe as tserve  # noqa: E402


def test_ciphertext_smoke_on_cpu_all_workloads_ok(capsys):
    rc = tserve.main(["--smoke", "--backend", "ciphertext", "--device",
                      "cpu", "--use-kernels"])
    out = capsys.readouterr().out
    assert rc == 0, out
    ok = [ln.split()[1] for ln in out.splitlines()
          if ln.startswith("accuracy ") and ln.endswith(" OK")]
    assert sorted(ok) == sorted(tserve.WORKLOADS), out


def _serve(mod, params, mem, **kw):
    ex = mod.build_executor(params, mem, backend_name="analytic",
                            max_batch=8, max_wait_s=2e-3,
                            cache_bytes=256 * 2 ** 20, start_level=7, **kw)
    arrivals = mod.synth_arrivals(
        ex, n_tenants=3, n_requests=60, rate_rps=5000.0, seed=0,
        deadline_s=0.2, encrypt=False, max_slots=128)
    m = ex.serve(arrivals)
    scheds = {name: ex.compile_cache.get_schedule(
        w.trace, ex.params, ex.mem, ex.mapper, pass_config=ex.pass_config)
        for name, w in ex.workloads.items()}
    return m, scheds, arrivals


def test_analytic_smoke_matches_reference():
    mem = dict(n_partitions=4, partition_bytes=8 * 2 ** 20)
    params = dict(log_n=10, n_levels=8, dnum=2)
    jm, js, ja = _serve(jserve, j_test_params(**params), JMem(**mem))
    tm, ts, ta = _serve(tserve, t_test_params(**params), TMem(**mem),
                        device="cpu")
    assert [(r.arrival_s, r.slots_needed, r.workload, r.tenant)
            for r in ta] == [(r.arrival_s, r.slots_needed, r.workload,
                              r.tenant) for r in ja]
    assert sorted(ts) == sorted(js)
    for name in js:
        assert len(ts[name].stages) == len(js[name].stages), name
        for b in (1, 8):
            assert ts[name].stage_times(b) == js[name].stage_times(b), name
    assert tm.occupancy.busy_s == jm.occupancy.busy_s
    assert tm.summary() == jm.summary()
    assert tm.count("requests_completed") > 0
    np.testing.assert_array_equal(
        [r.completion_s for r in ta], [r.completion_s for r in ja])
