"""The port's distributed layer (repro_torch.launch.mesh, repro_torch.
fhe_dist and the mesh serving backend) against the JAX reference, on the
CPU with gloo.

* Multi-rank cases start one process a rank (tests/_torch_dist_worker.py)
  on a file store, each with a 60 s collective timeout and the whole run
  bounded at 180 s, and read back each rank's arrays:
  - distributed_bconv, ring and all-gather, on 4 and 8 `model` ranks and
    on a 2 x 4 (data, model) mesh: every rank's block and the gathered
    result bit-equal to the reference's rns.bconv at test_params(log_n=8,
    n_levels=7, dnum=2) (at 4 ranks each rank holds 2 source limbs, so
    the ring's per-hop weight rows are exercised); onto destinations
    that include 3221225473 and 4293918721, bit-equal to the port's own
    rns.bconv;
  - run_load_save_pipeline on an 8-rank `data` ring: two rounds equal to
    the sequential composition (rtol 1e-6, as tests/distributed_worker.py)
    and the same on every rank.
* World size 1 in this process (gloo, file store under build/): the
  distributed BConv, the pipeline, the ring shift to itself (a local
  copy), and MeshBackend.execute against the reference's MeshBackend on
  the same batch (rtol 1e-6), and serve_fhe --backend mesh end to end.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

import jax.numpy as jnp  # noqa: E402
from repro.core import rns as j_rns  # noqa: E402
from repro.core.context import CkksContext as JCtx  # noqa: E402
from repro.core.params import test_params as j_test_params  # noqa: E402

import _torch_dist_worker as worker  # noqa: E402
from repro_torch.core import rns as t_rns  # noqa: E402
from repro_torch.fhe_dist import layout  # noqa: E402
from repro_torch.fhe_dist.collective_bconv import (  # noqa: E402
    bconv_tables_device, distributed_bconv)
from repro_torch.fhe_dist.pipeline_exec import (  # noqa: E402
    run_load_save_pipeline)
from repro_torch.launch import mesh as tmesh  # noqa: E402

WORKER = os.path.join(os.path.dirname(__file__), "_torch_dist_worker.py")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RUN_TIMEOUT_S = 180


def run_ranks(tmp_path, scenario, world, *args):
    """Start `world` ranks of `scenario`; return each rank's arrays."""
    store = tmp_path / "store"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, WORKER, scenario, str(world), str(r), str(store),
         str(tmp_path)] + [str(a) for a in args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RUN_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "WORKER_OK" in out, \
            f"rank {r} of {scenario}:\n{out}\n{err}"
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def bconv_want():
    """The reference's rns.bconv of the worker's inputs (8 Q limbs onto
    themselves), and the port's onto the wide destinations."""
    ctx, v, src, dst, wide = worker.bconv_inputs()
    jctx = JCtx(j_test_params(log_n=8, n_levels=7, dnum=2))
    assert jctx.primes == ctx.primes
    want = np.asarray(j_rns.bconv(jnp.asarray(v.astype(np.uint64)),
                                  jctx.bconv_tables(src, dst)))
    t = t_rns.make_bconv_tables([ctx.primes[i] for i in src], wide,
                                torch.device("cpu"))
    want_wide = t_rns.bconv(torch.from_numpy(v), t).numpy()
    assert max(wide) > 2 ** 31 and want_wide.max() > 2 ** 31
    return want.astype(np.int64), want_wide


@pytest.mark.parametrize("data,model", [(1, 4), (1, 8), (2, 4)])
@pytest.mark.parametrize("variant", ["ring", "allgather"])
def test_distributed_bconv_bit_exact(tmp_path, bconv_want, variant, data,
                                     model):
    want, want_wide = bconv_want
    ranks = run_ranks(tmp_path, "bconv", data * model, variant, data, model)
    d_l = want.shape[0] // model
    for r, got in enumerate(ranks):
        d, m = divmod(r, model)
        np.testing.assert_array_equal(got["coords"], [d, m])
        np.testing.assert_array_equal(
            got["peers"], [d * model + (m + 1) % model,
                           d * model + (m - 1) % model,
                           ((d + 1) % data) * model + m])
        np.testing.assert_array_equal(got["full"], want)
        np.testing.assert_array_equal(got["block"],
                                      want[m * d_l:(m + 1) * d_l])
        np.testing.assert_array_equal(got["want_wide"], want_wide)
        np.testing.assert_array_equal(got["full_wide"], want_wide)


def test_pipeline_rounds_8_ranks(tmp_path):
    ranks = run_ranks(tmp_path, "pipeline", 8)
    x, rounds = worker.pipeline_case(8)
    want = x
    for f in rounds[0] + rounds[1]:
        want = f(want)
    for got in ranks:
        np.testing.assert_allclose(got["out"], want, rtol=1e-6)
        np.testing.assert_array_equal(got["out"], ranks[0]["out"])


# ---------------------------------------------------------------------------
# world size 1, in this process
# ---------------------------------------------------------------------------

@pytest.fixture
def mesh1():
    """A (1, 1) CPU mesh over a fresh world-size-1 gloo group, destroyed
    afterwards."""
    assert not dist.is_initialized()
    m = tmesh.make_host_mesh(1, 1, device="cpu")
    try:
        yield m
    finally:
        dist.destroy_process_group()


def test_host_mesh_reuses_group(mesh1):
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    group = dist.group.WORLD
    again = tmesh.make_host_mesh(1, 1, device="cpu")
    assert dist.group.WORLD is group
    assert again.shape == {"data": 1, "model": 1} and again.coords == (0, 0)
    assert again.device.type == "cpu"
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmesh.make_host_mesh(2, 1, device="cpu")
    shape, axes = tmesh.make_production_mesh(multi_pod=True)
    assert (shape, axes) == ((2, 16, 16), ("pod", "data", "model"))
    assert tmesh.make_production_mesh() == ((16, 16), ("data", "model"))


def test_ring_shift_to_self_is_a_copy(mesh1):
    t = torch.arange(6.0)
    out = mesh1.ring_shift(t, "data")
    assert torch.equal(out, t) and out.data_ptr() != t.data_ptr()
    assert torch.equal(mesh1.all_gather(t, "model"), t)


def test_layout_blocks(mesh1):
    specs = layout.limb_specs(mesh1)
    assert specs["ct_batch"] == ("data", None, "model", None)
    x = torch.arange(2 * 4 * 3).reshape(2, 4, 3)
    assert torch.equal(layout.local_block(x, specs["ct"], mesh1), x)
    assert layout.block(8, mesh1, "model") == slice(0, 8)
    assert layout.shardable_limbs(7, mesh1)


def test_distributed_bconv_world1(mesh1, bconv_want):
    ctx, v, src, dst, _ = worker.bconv_inputs()
    want, _ = bconv_want
    tabs = bconv_tables_device(ctx, src, dst)
    for variant in ("ring", "allgather"):
        for gather in (False, True):
            got = distributed_bconv(torch.from_numpy(v), *tabs, mesh1,
                                    variant=variant, gather=gather)
            np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="unknown variant"):
        distributed_bconv(torch.from_numpy(v), *tabs, mesh1, variant="bus")


def test_pipeline_world1(mesh1):
    x, rounds = worker.pipeline_case(1)
    got = run_load_save_pipeline(rounds, torch.from_numpy(x), mesh1)
    np.testing.assert_allclose(got.numpy(), (x * 1) + 0, rtol=1e-6)
    with pytest.raises(ValueError, match="2 stages for the 1 ranks"):
        run_load_save_pipeline([rounds[0] * 2], torch.from_numpy(x), mesh1)


def _mesh_batches(params, mem, jbackend, tbackend):
    """The same schedule and batch (plain payloads in every slot group)
    through the reference's and the port's MeshBackend."""
    from repro.core.trace import trace_program as j_trace
    from repro.runtime.batcher import Batch as JBatch
    from repro.runtime.compile_cache import CompileCache as JCache
    from repro.runtime.metrics import MetricsRegistry as JMetrics
    from repro.runtime.queue import Request as JReq
    from repro.runtime.workloads import (HELR_CONSTS, make_helr_iter)
    from repro_torch.core.trace import trace_program as t_trace
    from repro_torch.runtime.batcher import Batch as TBatch
    from repro_torch.runtime.compile_cache import CompileCache as TCache
    from repro_torch.runtime.metrics import MetricsRegistry as TMetrics
    from repro_torch.runtime.queue import Request as TReq
    rng = np.random.default_rng(3)
    payloads = [[rng.normal(size=n).astype(np.float32) for n in sizes]
                for sizes in ([40, 30], [64], [], [20, 20, 20])]
    outs = []
    for side, backend in (("j", jbackend), ("t", tbackend)):
        trace_program, Cache, Batch, Metrics, Req = (
            (j_trace, JCache, JBatch, JMetrics, JReq) if side == "j"
            else (t_trace, TCache, TBatch, TMetrics, TReq))
        trace = trace_program(make_helr_iter(), 2, HELR_CONSTS)
        sched = Cache().get_schedule(trace, params[side], mem[side])
        groups = [[Req(k * 10 + i, "t0", "helr", 0.0, slots_needed=len(p),
                       payload=p) for i, p in enumerate(g)]
                  for k, g in enumerate(payloads)]
        batch = Batch("helr", [r for g in groups for r in g], groups, 0.0)
        dt = backend.execute(sched, batch, key_cache=None,
                             metrics=Metrics(mem[side].n_partitions),
                             workload="helr")
        assert dt > 0
        outs.append(np.asarray(batch.outputs))
    return outs


def test_mesh_backend_matches_reference(mesh1):
    from repro.core.pipeline import MemoryModel as JMem
    from repro.runtime.executor import MeshBackend as JMesh
    from repro_torch.core.params import test_params as t_test_params
    from repro_torch.core.pipeline import MemoryModel as TMem
    from repro_torch.runtime.executor import MeshBackend as TMesh
    params = {"j": j_test_params(log_n=8, n_levels=8, dnum=2),
              "t": t_test_params(log_n=8, n_levels=8, dnum=2)}
    mem = {"j": JMem(n_partitions=4, partition_bytes=8 * 2 ** 20),
           "t": TMem(n_partitions=4, partition_bytes=8 * 2 ** 20)}
    tb = TMesh(slots_per_ct=params["t"].slots, pad_batch_to=6,
               device="cpu")
    assert tb.mesh.shape == {"data": 1, "model": 1}
    j_out, t_out = _mesh_batches(params, mem, JMesh(
        slots_per_ct=params["j"].slots, pad_batch_to=6), tb)
    assert t_out.shape == (6, params["t"].slots) and t_out.dtype == np.float32
    assert np.abs(t_out[:4]).max() > 0.1
    np.testing.assert_allclose(t_out, j_out, rtol=1e-6, atol=1e-7)


def test_serve_fhe_mesh_cpu(capsys):
    """serve_fhe --smoke --backend mesh --verify --device cpu serves every
    request on a world-size-1 gloo group it starts itself."""
    from repro_torch.launch import serve_fhe as tserve
    from repro_torch.runtime.executor import MeshBackend
    assert not dist.is_initialized()
    try:
        args = tserve.parse_args(["--smoke", "--backend", "mesh", "--verify",
                                  "--device", "cpu", "--no-encrypt"])
        res = tserve.serve(args)
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
    out = capsys.readouterr().out
    ex = res.executor
    assert isinstance(ex.backend, MeshBackend)
    assert ex.metrics.count("requests_completed") == args.requests == 60
    assert ex.backend.pad_batch_to == args.max_batch
    assert "verify: 4 schedule(s) + 0 lowered program(s) swept, " \
        "0 finding(s)" in out
