"""Parity of the port's LLM serve path (repro_torch.models, .configs and
.launch.serve) with the JAX package, on the CPU.

* Configs: ArchConfig, ARCH and SMOKE of all ten architectures equal.
* Shapes only (no allocation): for the ten FULL configs the parameter and
  cache schemas (shapes, logical axes, init scales, cache dtypes) and the
  parameter counts equal the reference's.
* Decode: weights from the reference's init_params -> params_from_jax, the
  same teacher-forced tokens, 4 serve steps of every smoke config; the
  logits and every cache leaf agree after each step.
    - float32: max |port - ref| <= 1e-4 * max |ref| per tensor (what is
      left is the two libraries' summation order, ~1e-6 here), greedy
      tokens equal;
    - bfloat16: <= 5e-2 * max |ref| (bf16 keeps 8 bits, 3.9e-3 relative;
      the two libraries round intermediates differently and the rounding
      compounds over the layers and the 4 steps).
  The cross-attention gates, zero at init, are set to 0.5 on both sides
  so that cross attention reaches the logits. MoE configs decode a batch
  of 8.
* Layers: router and moe_psum with capacity drops and exact ties,
  rwkv_time_mix and rglru_block over state, _ring_local_decode past its
  window (and F5: its empty slots take softmax weight in both packages),
  cross_attention against a 4096-token memory, flash_attention causal and
  windowed, all float32 within 1e-5 * max |ref|.
* The serve entry point on the CPU prints the reference's three lines.
"""
import dataclasses
import functools
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.compat import set_mesh  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import config as jconfig  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import recurrent as trec  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = jconfigs.list_archs()
F32_TOL = 1e-4
BF16_TOL = 5e-2
LAYER_TOL = 1e-5
STEPS = 4


def as_np(x) -> np.ndarray:
    """Either package's array as float64 (int arrays as they are)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.double() if x.is_floating_point() else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float64) if a.dtype.kind in "fV" or \
        a.dtype.name == "bfloat16" else a


def close(port, ref, tol, what=""):
    a, b = as_np(port), as_np(ref)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.isfinite(a).all(), what
    err = np.abs(a - b).max() if a.size else 0.0
    assert err <= tol * max(np.abs(b).max(), 1e-30), (what, err,
                                                      np.abs(b).max())


def t(a, dtype=None):
    """A numpy array as a CPU tensor."""
    return TM.tensor_from_numpy(a).to(dtype=dtype)


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh(1, 1)


# ---------------------------------------------------------------------------
# configs and schemas
# ---------------------------------------------------------------------------

def test_configs_equal():
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.ArchConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.ArchConfig)]
    assert jf == tf
    assert tconfigs.list_archs() == ARCHS
    assert tconfigs.DASHED == jconfigs.DASHED
    for name in list(jconfigs.DASHED) + ARCHS:
        for smoke in (False, True):
            j = jconfigs.get_config(name, smoke=smoke)
            p = tconfigs.get_config(name, smoke=smoke)
            assert isinstance(p, tconfig.ArchConfig)
            assert dataclasses.asdict(p) == dataclasses.asdict(j)
            assert (p.subquadratic, p.resolved_head_dim) == (
                j.subquadratic, j.resolved_head_dim)


def _schema_rows(tree):
    return [(path, tuple(ps.shape), tuple(ps.logical), ps.scale)
            for path, ps in TM.tree_items(tree)]


@pytest.mark.parametrize("arch", ARCHS)
def test_full_schemas_and_counts_equal(arch):
    jc = jconfigs.get_config(arch)
    tc = tconfigs.get_config(arch)
    assert _schema_rows(TM.param_schema(tc)) == _schema_rows(
        JM.param_schema(jc))
    for batch, s_max in ((1, 1), (8, 4096)):
        assert _schema_rows(TM.cache_schema(tc, batch, s_max)) == \
            _schema_rows(JM.cache_schema(jc, batch, s_max))
        j_ab = JM.abstract_cache(jc, batch, s_max)
        t_ab = TM.abstract_cache(tc, batch, s_max)
        rows = list(zip(TM.tree_items(t_ab), TM.tree_items(j_ab)))
        assert len(rows) == len(list(TM.tree_items(j_ab)))
        for (tp, tm), (jp, jm) in rows:
            assert tp == jp and tm.device.type == "meta"
            assert tuple(tm.shape) == jm.shape
            assert str(tm.dtype).split(".")[-1] == str(jm.dtype), tp
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_rule(dtype):
    """The port's init: the reference's shapes and dtype, ones where the
    reference puts ones, scale-0 leaves zero, the rest drawn, the same
    weights from the same seed, and every leaf registered on the model."""
    cfg = dataclasses.replace(tconfigs.get_config("llama-3.2-vision-90b",
                                                  smoke=True), dtype=dtype)
    p1 = TM.init_params(cfg, torch.Generator().manual_seed(3))
    p2 = TM.init_params(cfg, torch.Generator().manual_seed(3))
    ref = dict(TM.tree_items(_ref_weights("llama_3_2_vision_90b")))
    schema = dict(TM.tree_items(TM.param_schema(cfg)))
    for path, leaf in TM.tree_items(p1):
        assert leaf.dtype == getattr(torch, dtype)
        assert tuple(leaf.shape) == ref[path].shape
        ones = bool((ref[path] == 1).all())
        assert bool((leaf == 1).all()) == ones, path
        assert bool((leaf == 0).all()) == (schema[path].scale == 0.0), path
        assert torch.equal(leaf, dict(TM.tree_items(p2))[path])
    model = TM.DecodeModel(cfg, "cpu", params=p1)
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    # a stacked superblock norm has three axes: drawn, as in the reference
    assert not bool((p1["superblocks"]["self"]["attn_norm"] == 1).all())


# ---------------------------------------------------------------------------
# decode parity, every smoke config
# ---------------------------------------------------------------------------

def _draw_ref_weights(arch):
    """The reference's init_params of the smoke config (bfloat16, its own
    dtype) as numpy, cross-attention gates set to 0.5."""
    cfg = jconfigs.get_config(arch, smoke=True)
    tree = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))

    def gate(node):
        return {k: (np.full_like(v, 0.5) if k == "gate" else gate(v))
                for k, v in node.items()} if isinstance(node, dict) else node
    return gate(tree)


@functools.lru_cache(maxsize=None)
def _all_ref_weights():
    """_draw_ref_weights of every architecture, in four threads: the eager
    init_params compiles one small XLA program for each leaf shape, and
    the threads overlap those compiles (~14 s against ~42 s in turn)."""
    with ThreadPoolExecutor(4) as pool:
        return dict(zip(ARCHS, pool.map(_draw_ref_weights, ARCHS)))


def _ref_weights(arch):
    return _all_ref_weights()[arch]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_parity(arch, dtype, mesh):
    jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                               dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_config(arch, smoke=True),
                               dtype=dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jdt = getattr(jnp, dtype)
    # bf16 -> float32 is exact: both dtypes run the reference's weights
    jparams = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jdt)),
                           _ref_weights(arch))
    model = TM.DecodeModel(tcfg, "cpu",
                           params=TM.params_from_jax(jparams, "cpu"))
    b = 8 if jcfg.n_experts else 2
    s_max = 8
    jcache = JM.init_cache(jcfg, b, s_max)
    tcache = model.init_cache(b, s_max)
    rng = np.random.default_rng(1)
    for key, n in (("memory", 4096 if jcfg.enc_dec else 0),
                   ("images", jcfg.n_img_tokens if jcfg.xattn_period else 0)):
        if n:
            jcache[key] = jnp.asarray(rng.normal(size=(b, n, jcfg.d_model)),
                                      jdt)
            tcache[key] = t(np.asarray(jcache[key]))
    tokens = rng.integers(0, jcfg.vocab, (STEPS, b))
    with set_mesh(mesh):
        jstep = jax.jit(lambda p, c, tok, pos: JM.decode_forward(
            p, jcfg, c, tok, pos, mesh))
        for i in range(STEPS):
            jlog, jcache = jstep(jparams, jcache,
                                 jnp.asarray(tokens[i], jnp.int32),
                                 jnp.int32(i))
            tlog, tcache = model.decode(
                tcache, torch.as_tensor(tokens[i], dtype=torch.int32), i)
            close(tlog, jlog, tol, f"{arch} logits step {i}")
            if dtype == "float32":
                np.testing.assert_array_equal(
                    as_np(tlog).argmax(-1), as_np(jlog).argmax(-1))
            jleaves = list(TM.tree_items(jcache))
            tleaves = list(TM.tree_items(tcache))
            assert [p for p, _ in tleaves] == [p for p, _ in jleaves]
            for (path, tl), (_, jl) in zip(tleaves, jleaves):
                assert str(tl.dtype).split(".")[-1] == str(jl.dtype), path
                close(tl, jl, tol, f"{arch} cache {path} step {i}")
    nt, _ = model.serve_step(tcache, torch.as_tensor(tokens[0],
                                                     dtype=torch.int32),
                             STEPS)
    assert nt.dtype == torch.int32 and nt.shape == (b,)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _moe_params(cfg, rng, e=None):
    e = e or cfg.n_experts
    d, f = cfg.d_model, cfg.d_ff_expert
    return {"w_router": rng.normal(size=(d, e)).astype(np.float32),
            "w_gate": (0.1 * rng.normal(size=(e, d, f))).astype(np.float32),
            "w_up": (0.1 * rng.normal(size=(e, d, f))).astype(np.float32),
            "w_down": (0.1 * rng.normal(size=(e, f, d))).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _ref_moe_psum_fn(cfg, mesh):
    """The reference's moe_psum as its decode runs it: a shard_map over
    the (1, 1) host mesh (jitted once per config)."""
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map
    return jax.jit(shard_map(lambda tok, pp: jmoe.moe_psum(tok, pp, cfg),
                             mesh, (P("data", None), P()),
                             (P("data", None), P())))


def _ref_moe_psum(x, p, cfg, mesh):
    with set_mesh(mesh):
        return _ref_moe_psum_fn(cfg, mesh)(jnp.asarray(x),
                                           jax.tree.map(jnp.asarray, p))


@pytest.mark.parametrize("tokens", [2, 16, 40])
def test_moe_psum_capacity_drops(tokens, mesh):
    """Decode batches: 2 tokens (capacity 4, nothing dropped) and 16 and
    40 tokens routed mostly to expert 3 (capacity 5 and 12): some slots
    are dropped, and the port drops the same ones."""
    cfg = dataclasses.replace(jconfigs.get_config("deepseek-v3-671b",
                                                  smoke=True),
                              dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_config("deepseek-v3-671b",
                                                   smoke=True),
                               dtype="float32")
    rng = np.random.default_rng(tokens)
    p = _moe_params(cfg, rng)
    p["w_router"][:, 3] += 0.5          # expert 3 is popular
    x = (rng.normal(size=(tokens, cfg.d_model)) + 0.5).astype(np.float32)
    _, jids, _, _ = jmoe.router(jnp.asarray(x), jnp.asarray(p["w_router"]),
                                cfg.top_k)
    cap = max(int(tokens * cfg.top_k * cfg.capacity_factor /
                  cfg.n_experts), 4)
    assert tmoe.capacity_of(tokens, tcfg) == cap
    jpos, jkeep = jmoe._dispatch_indices(jids, cfg.n_experts, cap)
    tpos, tkeep = tmoe._dispatch_indices(t(np.asarray(jids)),
                                         cfg.n_experts, cap)
    np.testing.assert_array_equal(as_np(tpos), np.asarray(jpos))
    np.testing.assert_array_equal(as_np(tkeep), np.asarray(jkeep))
    dropped = int((~np.asarray(jkeep)).sum())
    assert (dropped > 0) == (tokens > 2), dropped
    jout, jaux = _ref_moe_psum(x, p, cfg, mesh)
    tout, taux = tmoe.moe_psum(t(x), {k: t(v) for k, v in p.items()}, tcfg)
    close(tout, jout, LAYER_TOL, "moe_psum")
    close(taux, jaux, LAYER_TOL, "aux")
    # without drops the dispatch is the dense oracle's combination
    ro, _ = tmoe.moe_reference(t(x), {k: t(v) for k, v in p.items()}, tcfg)
    jro, _ = jmoe.moe_reference(jnp.asarray(x),
                                jax.tree.map(jnp.asarray, p), cfg)
    close(ro, jro, LAYER_TOL, "moe_reference")
    if not dropped:
        close(tout, ro, LAYER_TOL, "no drops: psum == oracle")
    else:
        assert np.abs(as_np(tout) - as_np(ro)).max() > 1e-3


def test_router_ties_break_to_lower_index(mesh):
    """Columns 0-3 of the router equal columns 4-7, and every input and
    weight is a small dyadic number, so each token's logits tie exactly
    in pairs in both packages: lax.top_k's order (lower index first)
    must come out, and the whole-layer outputs agree. All-zero logits
    (every expert tied) give experts 0 and 1."""
    cfg = dataclasses.replace(jconfigs.get_config("deepseek-v3-671b",
                                                  smoke=True),
                              dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_config("deepseek-v3-671b",
                                                   smoke=True),
                               dtype="float32")
    rng = np.random.default_rng(5)
    x = (rng.integers(-4, 5, (24, cfg.d_model)) / 4).astype(np.float32)
    half = (rng.integers(-4, 5, (cfg.d_model, 4)) / 8).astype(np.float32)
    p = _moe_params(cfg, rng)
    p["w_router"] = np.concatenate([half, half], axis=1)
    jw, jids, _, _ = jmoe.router(jnp.asarray(x), jnp.asarray(p["w_router"]),
                                 cfg.top_k)
    tw, tids, _, _ = tmoe.router(t(x), t(p["w_router"]), tcfg.top_k)
    jids = np.asarray(jids)
    assert (jids[:, 1] == jids[:, 0] + 4).all()      # the tied pair
    np.testing.assert_array_equal(as_np(tids), jids)
    close(tw, jw, LAYER_TOL, "weights")
    jout, _ = _ref_moe_psum(x, p, cfg, mesh)
    tout, _ = tmoe.moe_psum(t(x), {k: t(v) for k, v in p.items()}, tcfg)
    close(tout, jout, LAYER_TOL, "moe_psum with ties")
    zeros = np.zeros_like(p["w_router"])
    _, zj, _, _ = jmoe.router(jnp.asarray(x), jnp.asarray(zeros), 2)
    _, zt, _, _ = tmoe.router(t(x), t(zeros), 2)
    np.testing.assert_array_equal(np.asarray(zj), np.tile([0, 1], (24, 1)))
    np.testing.assert_array_equal(as_np(zt), np.asarray(zj))


def _layer_params(schema, rng):
    """Random float32 weights for a schema subtree (norms near one)."""
    return TM.tree_map(
        lambda ps: (rng.normal(size=ps.shape) * (0.1 if ps.scale == 1.0
                                                 else ps.scale)
                    + (1.0 if ps.scale == 1.0 else 0.0)).astype(np.float32),
        schema)


def test_rwkv_time_and_channel_mix_over_state():
    """Three calls in a row (T = 1, 1, 3), each taking the state and last
    token the previous call returned."""
    cfg = dataclasses.replace(jconfigs.get_config("rwkv6-3b", smoke=True),
                              dtype="float32")
    rng = np.random.default_rng(7)
    bp = _layer_params(TM._rwkv_schema(cfg), rng)
    tbp = TM.tree_map(t, bp)
    jbp = jax.tree.map(jnp.asarray, bp)
    b, d = 2, cfg.d_model
    h = d // trec.RWKV_HEAD_DIM
    js = np.zeros((b, h, 64, 64), np.float32)
    ts = t(js)
    jlast = tlast = jcl = tcl = None
    jit_time_mix = jax.jit(jrec.rwkv_time_mix, static_argnums=2)
    jit_channel_mix = jax.jit(jrec.rwkv_channel_mix, static_argnums=2)
    for steps in (1, 1, 3):
        x = rng.normal(size=(b, steps, d)).astype(np.float32)
        jo, (js, jlast) = jit_time_mix(jnp.asarray(x), jbp["time_mix"],
                                       cfg, state=js, x_last=jlast)
        to, (ts, tlast) = trec.rwkv_time_mix(t(x), tbp["time_mix"], cfg,
                                             state=ts, x_last=tlast)
        close(to, jo, LAYER_TOL, "time mix out")
        close(ts, js, LAYER_TOL, "wkv state")
        close(tlast, jlast, 0.0, "x_last")
        jc, jcl = jit_channel_mix(jnp.asarray(x), jbp["channel_mix"], cfg,
                                  x_last=jcl)
        tc, tcl = trec.rwkv_channel_mix(t(x), tbp["channel_mix"], cfg,
                                        x_last=tcl)
        close(tc, jc, LAYER_TOL, "channel mix")


def test_rglru_block_over_state():
    cfg = dataclasses.replace(jconfigs.get_config("recurrentgemma-2b",
                                                  smoke=True),
                              dtype="float32")
    rng = np.random.default_rng(8)
    bp = _layer_params(TM._rglru_schema(cfg), rng)
    tbp, jbp = TM.tree_map(t, bp), jax.tree.map(jnp.asarray, bp)
    jst = tst = None
    jit_block = jax.jit(jrec.rglru_block, static_argnums=2)
    for steps in (1, 1, 4):
        x = rng.normal(size=(2, steps, cfg.d_model)).astype(np.float32)
        jo, jst = jit_block(jnp.asarray(x), jbp, cfg, state=jst)
        to, tst = trec.rglru_block(t(x), tbp, cfg, state=tst)
        close(to, jo, LAYER_TOL, "rglru out")
        close(tst[0], jst[0], LAYER_TOL, "conv state")
        close(tst[1], jst[1], LAYER_TOL, "lru state")


def _ring_run(window, steps, init_pos, seed=9):
    """_ring_local_decode of both packages over `steps` positions of a
    ring of `window` slots whose positions start at `init_pos`."""
    cfg = dataclasses.replace(jconfigs.get_config("recurrentgemma-2b",
                                                  smoke=True),
                              dtype="float32")
    rng = np.random.default_rng(seed)
    bp = _layer_params(TM._block_schema(cfg, "attn"), rng)
    tbp, jbp = TM.tree_map(t, bp), jax.tree.map(jnp.asarray, bp)
    b, hkv, dh = 2, cfg.n_kv_heads, cfg.resolved_head_dim
    jk = jnp.zeros((b, hkv, window, dh), jnp.float32)
    jv, jp = jk, jnp.full((window,), init_pos, jnp.int32)
    tk, tv = torch.zeros(jk.shape), torch.zeros(jk.shape)
    tp = torch.full((window,), init_pos, dtype=torch.int32)
    outs = []
    ring = jax.jit(JM._ring_local_decode, static_argnums=2)
    for pos in range(steps):
        x = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
        jo, jk, jv, jp = ring(jnp.asarray(x), jbp, cfg, jk, jv, jp,
                              jnp.int32(pos))
        to, tk, tv, tp = TM._ring_local_decode(t(x), tbp, cfg, tk, tv, tp,
                                               pos)
        outs.append((to, jo, tk.clone(), jk, tv.clone(), jv, tp.clone(),
                     jp))
    return outs


def test_ring_local_decode_past_window():
    """A ring of 4 slots over 11 positions: every slot is overwritten
    twice, and the outputs and ring state agree at every step."""
    for to, jo, tk, jk, tv, jv, tp, jp in _ring_run(4, 11, 0):
        close(to, jo, LAYER_TOL, "ring out")
        close(tk, jk, LAYER_TOL, "ring k")
        close(tv, jv, LAYER_TOL, "ring v")
        np.testing.assert_array_equal(as_np(tp), np.asarray(jp))
    np.testing.assert_array_equal(as_np(tp), [8, 9, 10, 7])


def test_ring_empty_slots_take_weight_in_both():
    """F5 (ROADMAP §3): init_cache fills the ring positions with 0 and the
    valid mask accepts kv_pos >= 0, so before the ring is full its empty
    slots (k = v = 0) count as position 0 and take softmax weight. A ring
    whose empty slots say -1 gives a different output in the reference;
    the port copies the zero-filled behaviour."""
    zero = _ring_run(4, 2, 0)
    empty = _ring_run(4, 2, -1)
    for (to, jo, *_), (_, jo_masked, *_) in zip(zero, empty):
        close(to, jo, LAYER_TOL, "F5 copied")
        assert np.abs(as_np(jo) - as_np(jo_masked)).max() > 1e-3


def test_cross_attention_4096_memory():
    cfg = dataclasses.replace(jconfigs.get_config("seamless-m4t-large-v2",
                                                  smoke=True),
                              dtype="float32")
    rng = np.random.default_rng(10)
    p = _layer_params(TM._xattn_schema(cfg), rng)
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(2, 4096, cfg.d_model)).astype(np.float32)
    assert tlayers._divisor_chunk(4096) == jlayers._divisor_chunk(4096) \
        == 1024
    assert tlayers._divisor_chunk(1601) == jlayers._divisor_chunk(1601) == 1
    jo = jlayers.cross_attention(jnp.asarray(x), jnp.asarray(mem),
                                 jax.tree.map(jnp.asarray, p), cfg)
    to = tlayers.cross_attention(t(x), t(mem), TM.tree_map(t, p), cfg)
    close(to, jo, LAYER_TOL, "cross attention")


@pytest.mark.parametrize("causal,window,chunk", [(True, 0, 8), (True, 5, 4),
                                                 (False, 0, 16)])
def test_flash_attention(causal, window, chunk):
    rng = np.random.default_rng(11)
    q = rng.normal(size=(2, 4, 16, 8)).astype(np.float32)
    k = rng.normal(size=(2, 2, 16, 8)).astype(np.float32)
    v = rng.normal(size=(2, 2, 16, 8)).astype(np.float32)
    jo = jlayers.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal, chunk=chunk,
                                 window=window)
    to = tlayers.flash_attention(t(q), t(k), t(v), causal=causal,
                                 chunk=chunk, window=window)
    close(to, jo, LAYER_TOL, "flash attention")


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def test_serve_cli_on_cpu_prints_reference_lines():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--arch", "qwen3-8b", "--smoke", "--device", "cpu"],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0] == "arch=qwen3-smoke generated (4, 32) tokens"
    toks = [int(v) for v in re.findall(r"\d+", "\n".join(lines[1:-1]))]
    assert len(toks) == 4 * 16 and all(0 <= v < 512 for v in toks)
    assert re.fullmatch(r"63 serve steps in \d+\.\d\ds -> \d+\.\d tok/s "
                        r"\(batch=4\)", lines[-1]), lines[-1]
