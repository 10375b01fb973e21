"""Parity of the port's LLM training path (repro_torch.models' forward,
loss_fn and make_train_step, repro_torch.train, .data and .launch.train)
with the JAX package, on the CPU.

* Forward and loss, the ten smoke configs in float32, weights from the
  reference's init_params (cross-attention gates set to 0.5 so that cross
  attention reaches the logits) and the same numpy batch: logits, MTP
  logits, aux and every loss metric within 1e-4 * max |ref| (the PR 20
  limit; what is left is the two libraries' summation order). In bf16:
  finite, the right shapes, and a train step that moves the parameters.
* Gradients, float32: every leaf of loss_fn's gradient within
  1e-4 * max |ref leaf|.
* AdamW alone: both packages' adamw_update on the same parameters, grads
  and state: new parameters, m and v within 1e-6 relative (the port's
  in-place update, sliced into chunks, changes no value).
* The full step: Adam's first step moves an element by about
  lr * sign(g), so a gradient that float noise moves across 0 changes its
  element by up to 2 * lr. The updated parameters are compared within
  1e-4 * max |ref| except where |g_ref| <= 1e-3 * max |g_ref| on that
  leaf; m and v, loss and grad norm within 1e-4 * max |ref| everywhere.
* moe_all_to_all against moe_psum at one rank, with capacity drops:
  equal values and gradients.
* Checkpoints across packages (the reference's save read by the port,
  the port's by the reference; F7: the reference's restore hands back a
  bf16 leaf as `|V2`, which JAX refuses), GC, the async checkpointer,
  Supervisor replay and straggler detection, AdamW on a quadratic, the
  data's determinism and equality with the reference's draws, and
  compressed_pod_mean's error-feedback identity.
* launch/train --smoke --device cpu prints the reference's lines, and
  --resume continues bit for bit where an unbroken run would be.
Every checkpoint goes under the test's tmp_path, and the process group
this module starts is destroyed at its end.
"""
import dataclasses
import re
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.compat import make_mesh as jmake_mesh  # noqa: E402
from repro.compat import set_mesh  # noqa: E402
from repro.data.pipeline import SyntheticLMDataset as JDataset  # noqa: E402
from repro.launch.mesh import make_host_mesh as jhost_mesh  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import compress as jcompress  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMDataset, shard_batch  # noqa: E402
from repro_torch.launch import mesh as tmesh_mod  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import compress as tcompress  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402
from repro_torch.train.fault import (FailureEvent, StragglerEvent,  # noqa: E402
                                     Supervisor)

ARCHS = jconfigs.list_archs()
F32_TOL = 1e-4
ADAM_RTOL = 1e-6
FLAT_GRAD = 1e-3     # |g_ref| <= FLAT_GRAD * max |g_ref|: sign may flip
LR = 3e-4            # make_train_step's default


def as_np(x) -> np.ndarray:
    """Either package's array as float64 (int arrays as they are)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.double() if x.is_floating_point() else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float64) if a.dtype.kind == "f" else a


def close(port, ref, tol, what=""):
    a, b = as_np(port), as_np(ref)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.isfinite(a).all(), what
    err = np.abs(a - b).max() if a.size else 0.0
    assert err <= tol * max(np.abs(b).max(), 1e-30), (what, err,
                                                      np.abs(b).max())


def f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def batch_np(cfg, seed=0, b=2, s=32):
    """tests/test_archs.py's batch, float32."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.xattn_period:
        out["images"] = rng.normal(
            size=(b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        out["frames"] = rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32)
    return out


def paths_of(tree):
    return [p for p, _ in TM.tree_items(tree)]


@pytest.fixture(scope="module")
def jmesh():
    return jhost_mesh(1, 1)


@pytest.fixture(scope="module")
def tmesh():
    """The port's (1, 1) mesh on a gloo group of world size 1, destroyed
    at the end of the module if this fixture started it."""
    started = not dist.is_initialized()
    mesh = tmesh_mod.make_host_mesh(device="cpu")
    yield mesh
    if started:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the reference's results, computed once per arch
# ---------------------------------------------------------------------------

def _ref_weights(arch):
    """The reference's float32 init_params of the smoke config as numpy,
    cross-attention gates set to 0.5."""
    cfg = f32(jconfigs.get_config(arch, smoke=True))
    tree = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))

    def gate(node):
        return {k: (np.full_like(v, 0.5) if k == "gate" else gate(v))
                for k, v in node.items()} if isinstance(node, dict) else node
    return gate(tree)


class RefRuns:
    """The reference's forward, loss, gradients and one train step (its
    make_train_step's composition: value_and_grad of loss_fn, then
    clip_by_global_norm and adamw_update) of each smoke config in float32,
    computed on first use."""

    def __init__(self, mesh):
        self.mesh = mesh
        with ThreadPoolExecutor(4) as pool:
            self.weights = dict(zip(ARCHS, pool.map(_ref_weights, ARCHS)))
        self.runs = {}

    def __call__(self, arch):
        if arch not in self.runs:
            self.runs[arch] = self._run(arch)
        return self.runs[arch]

    def _run(self, arch):
        cfg, mesh = f32(jconfigs.get_config(arch, smoke=True)), self.mesh
        params = self.weights[arch]
        batch = batch_np(cfg)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        def fwd_and_grad(p, b):
            return (JM.forward(p, cfg, b, mesh)[:3],
                    jax.value_and_grad(lambda q: JM.loss_fn(q, cfg, b, mesh),
                                       has_aux=True)(p))

        def update(p, g, s):
            g, gn = joptim.clip_by_global_norm(g, 1.0)
            p, s = joptim.adamw_update(p, g, s, lr=LR, wd=0.1)
            return p, s, gn

        with set_mesh(mesh):
            (logits, mtp, aux), ((loss, metrics), grads) = jax.jit(
                fwd_and_grad)(params, jb)
            new_p, new_s, gnorm = jax.jit(update)(
                params, grads, joptim.adamw_init(params))
        return dict(batch=batch, params=params, logits=logits, mtp=mtp,
                    aux=aux, loss=loss, metrics=metrics,
                    grads=dict(TM.tree_items(grads)),
                    new_params=dict(TM.tree_items(new_p)),
                    m=dict(TM.tree_items(new_s["m"])),
                    v=dict(TM.tree_items(new_s["v"])), gnorm=gnorm)


@pytest.fixture(scope="module")
def ref(jmesh):
    return RefRuns(jmesh)


def port_inputs(r, arch):
    cfg = f32(tconfigs.get_config(arch, smoke=True))
    return (cfg, TM.params_from_jax(r["params"], "cpu"),
            shard_batch(r["batch"], "cpu", torch.float32))


# ---------------------------------------------------------------------------
# forward, loss, gradients and the train step, every smoke config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_f32(arch, ref, tmesh):
    r = ref(arch)
    cfg, params, batch = port_inputs(r, arch)
    logits, mtp, aux, cache = TM.forward(params, cfg, batch, tmesh)
    assert cache is None and logits.shape == (2, 32, cfg.vocab)
    close(logits, r["logits"], F32_TOL, f"{arch} logits")
    assert (mtp is None) == (r["mtp"] is None) == (not cfg.mtp)
    if cfg.mtp:
        close(mtp, r["mtp"], F32_TOL, f"{arch} mtp logits")
    close(aux, r["aux"], F32_TOL, f"{arch} aux")
    loss, metrics = TM.loss_fn(params, cfg, batch, tmesh)
    assert sorted(metrics) == sorted(r["metrics"])
    close(loss, r["loss"], F32_TOL, f"{arch} loss")
    for k, v in metrics.items():
        close(v, r["metrics"][k], F32_TOL, f"{arch} {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_f32(arch, ref, tmesh):
    r = ref(arch)
    cfg, params, batch = port_inputs(r, arch)
    paths = paths_of(params)
    leaves = [t.requires_grad_() for _, t in TM.tree_items(params)]
    loss, _ = TM.loss_fn(TM.tree_unflatten(paths, leaves), cfg, batch, tmesh)
    grads = torch.autograd.grad(loss, leaves)
    assert paths == sorted(r["grads"]) == list(r["grads"])
    for path, g in zip(paths, grads):
        close(g, r["grads"][path], F32_TOL, f"{arch} grad {path}")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_f32(arch, ref, tmesh):
    r = ref(arch)
    cfg, params, batch = port_inputs(r, arch)
    before = TM.tree_map(torch.clone, params)
    opt = toptim.adamw_init(params)
    step = TM.make_train_step(cfg, tmesh)
    new_p, new_opt, metrics = step(params, opt, batch)
    assert new_p is params and int(new_opt["step"]) == 1
    close(metrics["loss"], r["loss"], F32_TOL, f"{arch} loss")
    close(metrics["grad_norm"], r["gnorm"], F32_TOL, f"{arch} grad norm")
    for path, p in TM.tree_items(new_p):
        g = np.abs(np.asarray(r["grads"][path]))
        sure = g > FLAT_GRAD * g.max()
        want = np.asarray(r["new_params"][path])
        err = np.abs(as_np(p) - want)[sure]
        assert not err.size or err.max() <= F32_TOL * np.abs(want).max(), (
            arch, path, err.max())
    for key in ("m", "v"):
        for path, t in TM.tree_items(new_opt[key]):
            close(t, r[key][path], F32_TOL, f"{arch} {key} {path}")
    assert any(not torch.equal(a, b) for (_, a), (_, b) in
               zip(TM.tree_items(before), TM.tree_items(new_p)))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_and_step(arch, tmesh):
    """bf16 (the configs' own dtype): finite logits of the right shapes,
    and a train step with finite loss and grad norm that moves the
    parameters (tests/test_archs.py's checks)."""
    cfg = tconfigs.get_config(arch, smoke=True)
    assert cfg.dtype == "bfloat16"
    params = TM.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    batch = shard_batch(batch_np(cfg, seed=1), "cpu")
    logits, mtp, aux, _ = TM.forward(params, cfg, batch, tmesh)
    assert logits.shape == (2, 32, cfg.vocab)
    assert logits.dtype == torch.bfloat16 and torch.isfinite(logits).all()
    if cfg.mtp:
        assert mtp.shape == (2, 32, cfg.vocab)
    before = TM.tree_map(torch.clone, params)
    _, _, metrics = TM.make_train_step(cfg, tmesh)(
        params, toptim.adamw_init(params), batch)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert any(not torch.equal(a, b) for (_, a), (_, b) in
               zip(TM.tree_items(before), TM.tree_items(params)))


def _shapes(tree):
    """Leaf shapes of a tree of tensors in jax.tree's order (dict keys
    sorted, tuples in order, None dropped)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _shapes(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [s for t in tree for s in _shapes(t)]
    return [tuple(tree.shape)]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches(arch, jmesh, tmesh):
    """make_prefill_step: the last position's logits and the per-layer
    caches stacked as the reference's scan stacks them (the same tree of
    shapes as the reference's prefill step under eval_shape)."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    cfg = tconfigs.get_config(arch, smoke=True)
    params = TM.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    nb = batch_np(cfg, seed=2, s=8)
    logits, caches = TM.make_prefill_step(cfg, tmesh)(
        params, shard_batch(nb, "cpu"))
    with set_mesh(jmesh):
        want = jax.eval_shape(
            JM.make_prefill_step(jcfg, jmesh), JM.abstract_params(jcfg),
            {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in
             nb.items()})
    assert _shapes((logits, caches)) == [tuple(s.shape) for s in
                                         jax.tree.leaves(want)]
    assert logits.shape == (2, cfg.vocab) and torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# AdamW, MoE dispatch
# ---------------------------------------------------------------------------

def test_adamw_update_matches_reference(monkeypatch):
    """The same parameters, grads and state (step 3) through both
    packages' adamw_update; the port's chunks cut to 7 elements."""
    monkeypatch.setattr(toptim, "CHUNK", 7)
    rng = np.random.default_rng(4)
    tree = {"w": rng.normal(size=(5, 6)).astype(np.float32),
            "n": {"b": rng.normal(size=(9,)).astype(np.float32),
                  "k": rng.normal(size=(2, 3, 4)).astype(np.float32)}}
    grads = jax.tree.map(lambda a: (0.1 * rng.normal(size=a.shape)).astype(
        np.float32), tree)
    m = jax.tree.map(lambda a: (0.01 * rng.normal(size=a.shape)).astype(
        np.float32), tree)
    v = jax.tree.map(lambda a: (1e-3 * rng.random(size=a.shape)).astype(
        np.float32), tree)
    jp, js = joptim.adamw_update(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, grads),
        {"m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v),
         "step": jnp.int32(3)}, lr=1e-2, wd=0.1)
    tt = TM.tree_map(torch.tensor, tree)
    ts = {"m": TM.tree_map(torch.tensor, m),
          "v": TM.tree_map(torch.tensor, v),
          "step": torch.tensor(3, dtype=torch.int32)}
    tp, ts2 = toptim.adamw_update(tt, TM.tree_map(torch.tensor, grads),
                                  ts, lr=1e-2, wd=0.1)
    assert int(ts2["step"]) == 4 and ts2["step"].dtype == torch.int32
    for got, want in ((tp, jp), (ts2["m"], js["m"]), (ts2["v"], js["v"])):
        for (path, a), (_, b) in zip(TM.tree_items(got), TM.tree_items(want)):
            np.testing.assert_allclose(as_np(a), np.asarray(b),
                                       rtol=ADAM_RTOL, err_msg=str(path))
    # weight decay only on leaves of more than one axis
    no_decay, _ = toptim.adamw_update(
        TM.tree_map(torch.tensor, tree),
        TM.tree_map(lambda a: torch.zeros(a.shape), tree),
        toptim.adamw_init(TM.tree_map(torch.tensor, tree)), lr=1e-2, wd=0.1)
    assert torch.equal(no_decay["n"]["b"], torch.from_numpy(tree["n"]["b"]))
    assert not torch.equal(no_decay["w"], torch.from_numpy(tree["w"]))


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(6)
    g = {"a": rng.normal(size=(4, 5)).astype(np.float32),
         "b": rng.normal(size=(3,)).astype(np.float32)}
    for max_norm in (0.5, 100.0):
        jg, jn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                            max_norm)
        tg, tn = toptim.clip_by_global_norm(TM.tree_map(torch.from_numpy, g),
                                            max_norm)
        close(tn, jn, 1e-6, "norm")
        for k in g:
            close(tg[k], jg[k], 1e-6, k)


@pytest.mark.parametrize("tokens", [2, 40])
def test_moe_all_to_all_equals_psum_at_one_rank(tokens, tmesh):
    """At one rank the all_to_all schedule computes what moe_psum does:
    2 tokens (capacity 4, nothing dropped) and 40 routed mostly to expert
    3 (capacity 12, slots dropped); values and the gradients of the
    tokens and of every weight torch.equal."""
    cfg = f32(tconfigs.get_config("deepseek-v3-671b", smoke=True))
    rng = np.random.default_rng(tokens)
    d, e, f_ = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    p = {"w_router": rng.normal(size=(d, e)),
         "w_gate": 0.1 * rng.normal(size=(e, d, f_)),
         "w_up": 0.1 * rng.normal(size=(e, d, f_)),
         "w_down": 0.1 * rng.normal(size=(e, f_, d))}
    p["w_router"][:, 3] += 0.5
    x = rng.normal(size=(tokens, d)) + 0.5

    def run(fn):
        xs = torch.tensor(x, dtype=torch.float32, requires_grad=True)
        ps = {k: torch.tensor(v, dtype=torch.float32, requires_grad=True)
              for k, v in p.items()}
        out, aux = fn(xs, ps)
        grads = torch.autograd.grad((out * out).sum() + aux,
                                    [xs] + list(ps.values()))
        return out, aux, grads

    _, ids, _, _ = tmoe.router(torch.tensor(x, dtype=torch.float32),
                               torch.tensor(p["w_router"],
                                            dtype=torch.float32), cfg.top_k)
    _, keep = tmoe._dispatch_indices(ids, e, tmoe.capacity_of(tokens, cfg))
    assert bool((~keep).any()) == (tokens > 2)
    a = run(lambda xs, ps: tmoe.moe_all_to_all(xs, ps, cfg, tmesh))
    b = run(lambda xs, ps: tmoe.moe_psum(xs, ps, cfg))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for ga, gb in zip(a[2], b[2]):
        assert torch.equal(ga, gb)
    with pytest.raises(ValueError, match="local experts"):
        tmoe.moe_all_to_all(torch.tensor(x, dtype=torch.float32),
                            {k: torch.tensor(v[:e - 1] if v.ndim == 3
                                             else v, dtype=torch.float32)
                             for k, v in p.items()}, cfg, tmesh)


@pytest.mark.parametrize("world", [2, 4])
def test_moe_all_to_all_across_ranks(tmp_path, world):
    """moe_all_to_all on WORLD gloo ranks (tests/_torch_dist_worker.py's
    `moe` scenario), each with its block of the tokens and of the experts,
    against moe_psum of the same tokens over every expert in one process:
    each rank's output, aux and the gradients of its tokens and router
    within 1e-5 of the largest value; an expert's gradient is the sum
    over every rank's tokens of what moe_psum gives it."""
    from test_torch_distributed import run_ranks
    import _torch_dist_worker as worker
    ranks = run_ranks(tmp_path, "moe", world)
    cfg, x, p = worker.moe_inputs(world)
    t, e_l = x.shape[0] // world, cfg.n_experts // world
    wants = [worker.moe_run(lambda xs, ps: tmoe.moe_psum(xs, ps, cfg),
                            x[r * t:(r + 1) * t], p) for r in range(world)]
    dropped = 0
    for r, (got, want) in enumerate(zip(ranks, wants)):
        for k in ("out", "aux", "g_x", "g_w_router"):
            close(got[k], want[k], 1e-5, f"rank {r} {k}")
        for k in ("g_w_gate", "g_w_up", "g_w_down"):
            total = sum(w[k] for w in wants)[r * e_l:(r + 1) * e_l]
            close(got[k], total, 1e-5, f"rank {r} {k}")
        ids = tmoe.router(torch.from_numpy(x[r * t:(r + 1) * t]),
                          torch.from_numpy(p["w_router"]), cfg.top_k)[1]
        dropped += int((~tmoe._dispatch_indices(
            ids, cfg.n_experts, tmoe.capacity_of(t, cfg))[1]).sum())
    assert dropped > 0


def test_router_aux_density_carries_no_gradient():
    """Only p_mean carries the aux loss's gradient, as in the reference
    (.at[].add gives none): the gradient of aux with respect to the
    router weights equals that of E * sum(density_const * p_mean)."""
    cfg = f32(tconfigs.get_config("deepseek-v3-671b", smoke=True))
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.normal(size=(12, cfg.d_model)), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(cfg.d_model, cfg.n_experts)),
                     dtype=torch.float32, requires_grad=True)
    _, ids, aux, probs = tmoe.router(x, w, cfg.top_k)
    assert not ids.requires_grad
    (g,) = torch.autograd.grad(aux, w)
    jw = jnp.asarray(w.detach().numpy())
    jg = jax.grad(lambda ww: jmoe.router(jnp.asarray(x.numpy()), ww,
                                         cfg.top_k)[2])(jw)
    close(g, jg, F32_TOL, "aux gradient")


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(8, 16)).astype(np.float32),
            "b": {"c": rng.normal(size=(4,)).astype(np.float32),
                  "d": rng.integers(0, 5, (3, 3)).astype(np.int32)},
            "h": rng.normal(size=(2, 5)).astype(np.float32),
            "step": np.int32(7)}


def _torch_tree(seed=0):
    t = TM.tree_map(lambda a: torch.from_numpy(np.array(a)), _np_tree(seed))
    t["h"] = t["h"].to(torch.bfloat16)
    return t


def _jax_tree(seed=0):
    t = jax.tree.map(jnp.asarray, _np_tree(seed))
    t["h"] = t["h"].astype(jnp.bfloat16)
    return t


def test_reference_checkpoint_read_by_port(tmp_path):
    jt = _jax_tree()
    jckpt.save_checkpoint(str(tmp_path), 5, jt)
    got, step = tckpt.restore_checkpoint(str(tmp_path), _torch_tree())
    assert step == 5
    assert got["h"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["h"].view(torch.int16).numpy(),
        np.asarray(jt["h"]).view(np.int16))
    for path in (("a",), ("b", "c"), ("b", "d"), ("step",)):
        want = np.asarray(jt[path[0]] if len(path) == 1
                          else jt[path[0]][path[1]])
        have = got[path[0]] if len(path) == 1 else got[path[0]][path[1]]
        assert str(have.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_array_equal(have.numpy(), want)


def test_port_checkpoint_read_by_reference(tmp_path):
    """The reference reads the port's file: the same keys, shapes and
    manifest dtypes, every leaf's bytes equal; its restore hands back the
    bf16 leaf as `|V2` (F7), which JAX refuses, while the port's own
    restore gives bfloat16 back."""
    tt = _torch_tree()
    tckpt.save_checkpoint(str(tmp_path / "port"), 3, tt)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 3, _jax_tree())
    got, step = jckpt.restore_checkpoint(str(tmp_path / "port"), _jax_tree())
    assert step == 3
    assert got["h"].dtype.str == "|V2"
    for (path, a), (_, b) in zip(TM.tree_items(got), TM.tree_items(tt)):
        bits = b.view(torch.int16) if b.dtype == torch.bfloat16 else b
        assert np.asarray(a).tobytes() == bits.numpy().tobytes(), path
    import msgpack
    mans = [msgpack.unpackb(open(tmp_path / d / "ckpt_00000003.manifest",
                                 "rb").read()) for d in ("port", "ref")]
    for key in ("step", "keys", "shapes", "dtypes"):
        assert mans[0][key] == mans[1][key], key
    assert mans[0]["dtypes"]["h"] == "bfloat16"
    files = [np.load(tmp_path / d / "ckpt_00000003.npz").files
             for d in ("port", "ref")]
    assert files[0] == files[1]
    back, _ = tckpt.restore_checkpoint(str(tmp_path / "port"), tt)
    assert back["h"].dtype == torch.bfloat16 and torch.equal(back["h"],
                                                             tt["h"])


def test_reference_restore_returns_void_bf16_f7(tmp_path):
    """F7, on the reference alone: a bf16 leaf saved and restored by
    repro.train.checkpoint comes back as `|V2`, and jnp.asarray refuses
    it, so its --resume cannot restore a bf16 model."""
    jt = _jax_tree()
    jckpt.save_checkpoint(str(tmp_path), 1, jt)
    got, _ = jckpt.restore_checkpoint(str(tmp_path), jt)
    assert got["h"].dtype.str == "|V2"
    with pytest.raises(TypeError):
        jnp.asarray(got["h"])


def test_checkpoint_roundtrip_gc_and_device(tmp_path):
    t = _torch_tree()
    tckpt.save_checkpoint(str(tmp_path), 7, t)
    restored, step = tckpt.restore_checkpoint(str(tmp_path), t,
                                              device="cpu")
    assert step == 7
    for (_, a), (_, b) in zip(TM.tree_items(t), TM.tree_items(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for s in (1, 2, 3, 4, 5):
        tckpt.save_checkpoint(str(tmp_path / "gc"), s, t, keep=2)
    assert tckpt.all_steps(str(tmp_path / "gc")) == [4, 5]
    with pytest.raises(ValueError, match="structure mismatch"):
        tckpt.restore_checkpoint(str(tmp_path), {"a": t["a"]})
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "none"), t)


def test_async_checkpointer_snapshots_at_save(tmp_path):
    """The snapshot is taken when save() is called: an in-place change
    made right after it does not reach the file."""
    t = _torch_tree()
    want = t["a"].clone()
    ac = tckpt.AsyncCheckpointer(str(tmp_path))
    ac.save(3, t)
    t["a"].add_(1.0)
    ac.wait()
    restored, step = tckpt.restore_checkpoint(str(tmp_path), t)
    assert step == 3 and torch.equal(restored["a"], want)


# ---------------------------------------------------------------------------
# supervisor, AdamW on a quadratic, data, compression
# ---------------------------------------------------------------------------

def test_supervisor_failure_replay(tmp_path):
    def step_fn(params, opt, batch):
        new_params = TM.tree_map(lambda p: p + batch["x"].mean(), params)
        return new_params, opt, {"loss": batch["x"].mean()}

    def make_batch(step):
        rng = np.random.default_rng(100 + step)
        return {"x": torch.from_numpy(rng.normal(size=(4,)).astype(
            np.float32))}

    params0 = {"w": torch.zeros((2,))}
    sup_ref = Supervisor(step_fn, str(tmp_path / "ref"), ckpt_every=2)
    (ref_params, _), _ = sup_ref.run((params0, {}), make_batch, 10)
    fired = {"done": False}

    def injector(step):
        if step == 7 and not fired["done"]:
            fired["done"] = True
            raise RuntimeError("simulated device failure")

    sup = Supervisor(step_fn, str(tmp_path / "run"), ckpt_every=2,
                     fail_injector=injector, device="cpu")
    (got_params, _), hist = sup.run((params0, {}), make_batch, 10)
    events = [e for e in sup.events if isinstance(e, FailureEvent)]
    assert len(events) == 1 and events[0].step == 7
    # the checkpoint of step 6 may still be in its writer thread
    assert events[0].restored_step in (4, 6)
    assert len(hist) == 10 + 7 - events[0].restored_step
    assert torch.equal(got_params["w"], ref_params["w"])


def test_supervisor_straggler_detection(tmp_path):
    def step_fn(params, opt, batch):
        if batch["i"] == 6:
            time.sleep(0.3)
        return params, opt, {"loss": torch.zeros(())}

    sup = Supervisor(step_fn, str(tmp_path), ckpt_every=100,
                     straggler_k=4.0)
    sup.run(({"w": torch.zeros(1)}, {}), lambda s: {"i": s}, 10)
    assert [e.step for e in sup.events
            if isinstance(e, StragglerEvent)] == [6]


def test_adamw_descends_quadratic():
    params = {"w": torch.tensor([3.0, -2.0])}
    state = toptim.adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}          # d/dw ||w||^2
        grads, _ = toptim.clip_by_global_norm(grads, 10.0)
        params, state = toptim.adamw_update(params, grads, state, lr=5e-2,
                                            wd=0.0)
    assert float(params["w"].abs().max()) < 0.2


@pytest.mark.parametrize("arch", ["qwen3_8b", "seamless_m4t_large_v2",
                                  "llama_3_2_vision_90b"])
def test_synthetic_data_deterministic_and_reference_equal(arch):
    cfg = tconfigs.get_config(arch, smoke=True)
    ds = SyntheticLMDataset(cfg, batch=2, seq=16)
    ref = JDataset(jconfigs.get_config(arch, smoke=True), batch=2, seq=16)
    b1, b2, b3 = ds.batch_at(5), ds.batch_at(5), ds.batch_at(6)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert (b1["tokens"] != b3["tokens"]).any()
    want = ref.batch_at(5)
    assert sorted(b1) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(b1[k], want[k])
    on = shard_batch(b1, "cpu")
    assert on["tokens"].dtype == torch.int32
    for k in set(b1) - {"tokens", "labels"}:
        assert on[k].dtype == torch.bfloat16


def test_compressed_pod_mean_single_pod(tmesh):
    """n_pod = 1: the error-feedback identity (mean + residual = the
    gradient) holds, and the port's mean and residual equal the
    reference's."""
    pod = tmesh_mod.Mesh((1,), ("pod",), torch.device("cpu"))
    g_np = np.linspace(-1, 1, 64, dtype=np.float32)[None]
    g = {"w": torch.from_numpy(g_np)}
    err = tcompress.init_error_feedback(g)
    mean, new_err = tcompress.compressed_pod_mean(g, err, pod)
    recon = as_np(mean["w"]) + as_np(new_err["w"][0])
    np.testing.assert_allclose(recon, g_np[0], atol=1e-6)
    jm = jmake_mesh((1,), ("pod",))
    jg = {"w": jnp.asarray(g_np)}
    jmean, jerr = jcompress.compressed_pod_mean(
        jg, jcompress.init_error_feedback(jg), jm)
    np.testing.assert_array_equal(as_np(mean["w"]), np.asarray(jmean["w"]))
    np.testing.assert_array_equal(as_np(new_err["w"]), np.asarray(jerr["w"]))
    q, s = tcompress.quantize_int8(g["w"])
    jq, js = jcompress.quantize_int8(jg["w"])
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    close(tcompress.dequantize_int8(q, s), jcompress.dequantize_int8(jq, js),
          1e-7, "dequantize")


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

LINE_STEP = re.compile(r"^step +\d+ loss=\d+\.\d{4} ce=\d+\.\d{4} "
                       r"gnorm=\d+\.\d{3}$")


def test_train_cli_prints_reference_lines_and_resumes(tmp_path, capsys):
    """The reference's lines: arch line (the reference's parameter count
    and mesh), a step row a step (--log-every 1), the done line; a run cut
    after 2 steps and resumed to 4 ends with the parameters and optimizer
    state of an unbroken 4-step run, torch.equal."""
    group_before = dist.is_initialized()
    base = ["--arch", "qwen3-8b", "--smoke", "--batch", "2", "--seq", "16",
            "--ckpt-every", "2", "--log-every", "1", "--device", "cpu"]
    whole = ttrain.main(base + ["--steps", "4", "--ckpt-dir",
                                str(tmp_path / "whole")])
    out = capsys.readouterr().out.splitlines()
    jcfg = jconfigs.get_config("qwen3-8b", smoke=True)
    assert out[0] == (f"arch={jcfg.name} params~"
                      f"{jcfg.param_count() / 1e6:.1f}M "
                      f"mesh={{'data': 1, 'model': 1}}")
    assert [int(line.split()[1]) for line in out[1:5]] == [0, 1, 2, 3]
    assert all(LINE_STEP.match(line) for line in out[1:5]), out
    assert re.match(r"^done: 4 steps in \d+\.\ds \(\d+ tok/s\); "
                    r"events=\[\]$", out[5]), out[5]
    assert tckpt.all_steps(str(tmp_path / "whole")) == [2, 4]
    cut = tmp_path / "cut"
    ttrain.main(base + ["--steps", "2", "--ckpt-dir", str(cut)])
    capsys.readouterr()
    resumed = ttrain.main(base + ["--steps", "4", "--ckpt-dir", str(cut),
                                  "--resume"])
    out = capsys.readouterr().out.splitlines()
    assert out[1] == "resumed from step 2"
    assert [int(line.split()[1]) for line in out[2:4]] == [2, 3]
    assert resumed.start == 2 and len(resumed.history) == 2
    assert whole.history[2:] == resumed.history
    for tree in ("params", "opt_state"):
        a, b = getattr(whole, tree), getattr(resumed, tree)
        for (pa, x), (pb, y) in zip(TM.tree_items(a), TM.tree_items(b)):
            assert pa == pb and x.dtype == y.dtype and torch.equal(x, y), pa
    # a group the entry point started is gone; one it found is kept
    assert dist.is_initialized() == group_before
