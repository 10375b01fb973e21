"""The port's partitioned step of the cross-attention-period stack,
llama-3.2-vision-90b, against the JAX package's on a (2, 4) mesh, in
float32 on the CPU, and its dry-run count on meta tensors.

The smoke config is one superblock: 4 self-attention layers and a gated
cross-attention layer over the batch's `images` (4 query heads, 2 KV
heads, head_dim 16). Each check runs twice, at the smoke config's 16
image tokens and at 17. At 16 the decode cache's images split over
`model` along their sequence (4 a rank); at 17, which 4 does not divide,
they are replicated, as 1601 are on the production mesh. Either way the
cross attention gathers them inside `attention._attend_island`.
What is compared and how: tests/test_torch_sharded_step.py and
tests/_sharded_parity.py; each token count's reference process and
8-rank port run happen once for the module.

Also the fold of the cross attention's chunk loop on meta tensors
(`layers.cross_attention`): at 1031 image tokens, the smallest prime
above the 1024 target of `_divisor_chunk`, real tensors run F6's
one-token chunks, whose p.v einsum contracts a dim of size 1 and so is
not counted; the meta count equals the loop's plus the p.v product
P = 2 * B * Hq * Sq * Skv * dh for each cross-attention pass (one in
prefill and decode, three in train), exactly, unsharded and on 8 fake
ranks (tests/_torch_fake_counts.py); at 17 tokens (one chunk) the two
are equal. The chunking of real tensors, and so their values, is
unchanged.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _sharded_inputs as si  # noqa: E402
import _sharded_parity as P  # noqa: E402

ARCH = "llama-3.2-vision-90b"
ROOT = os.path.join(os.path.dirname(__file__), "..")
IMG_TOKENS = [16, 17]
PRIME_TOKENS = 1031         # the smallest prime above _divisor_chunk's 1024
_RUNS = {}


@pytest.fixture(scope="module", params=IMG_TOKENS)
def runs(request, tmp_path_factory):
    n = request.param
    if n not in _RUNS:
        _RUNS[n] = P.run_both(ARCH, tmp_path_factory.mktemp(
            f"sharded_vision_{n}"), img_tokens=n)
    return _RUNS[n]


def test_forward_and_loss_match_reference(runs):
    P.check_forward(*runs)


def test_train_step_matches_reference(runs):
    P.check_train(*runs)


def test_prefill_matches_reference(runs):
    P.check_prefill(*runs)


def test_decode_matches_reference(runs):
    P.check_decode(*runs)


@pytest.mark.parametrize("part", ["forward", "train", "prefill", "decode"])
def test_partitioned_equals_unsharded(runs, part):
    """The port's unsharded step against the partitioned one, with the
    same tolerances."""
    _, port = runs
    plain = {k[len("plain/"):]: v for k, v in port.items()
             if k.startswith("plain/")}
    grads = {k: v for k, v in runs[0].items() if k.startswith("grads/")}
    check = {"forward": P.check_forward, "train": P.check_train,
             "prefill": P.check_prefill, "decode": P.check_decode}[part]
    check(dict(plain, **grads), port)


def test_images_reach_the_loss(runs):
    """The gate is 0.5 (tests/_sharded_inputs.py), so the images reach the
    loss: the reference's gradient of the cross attention's key
    projection is not 0 (the train checks hold the port's update to it),
    and both decode caches keep every image token as drawn."""
    ref, port = runs
    assert np.abs(ref["grads/superblocks/cross/attn/wk"]).max() > 0
    for side in (ref, port):
        imgs = side["decode_cache/images"]
        assert imgs.shape[1] in IMG_TOKENS and np.abs(imgs).min() > 0


# ---------------------------------------------------------------------------
# the fold of the chunk loop on meta tensors
# ---------------------------------------------------------------------------

def _pv(cfg, b, sq):
    """The p.v product of one cross-attention layer and pass."""
    return 2 * b * cfg.n_heads * sq * cfg.n_img_tokens * cfg.resolved_head_dim


def _passes(cfg, kind):
    n_cross = cfg.n_layers // (cfg.xattn_period + 1)
    return n_cross * (3 if kind == "train" else 1)


@pytest.fixture(scope="module")
def fake_counts(tmp_path_factory):
    out = tmp_path_factory.mktemp("fake_vision") / "vision.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable,
                        os.path.join(ROOT, "tests", "_torch_fake_counts.py"),
                        "vision", str(out)], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0 and "FAKE_COUNTS_OK" in r.stdout, \
        r.stderr[-3000:]
    return json.loads(out.read_text())


def _cfg(n_img):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(ARCH, smoke=True), dtype="float32",
                               n_img_tokens=n_img)


@pytest.mark.parametrize("n_img", [PRIME_TOKENS, 17])
@pytest.mark.parametrize("step", ["train", "prefill", "decode"])
def test_fold_counts_loop_plus_pv_partitioned(fake_counts, n_img, step):
    """StepCounter's FLOPs a rank of the partitioned step on meta tensors
    (one chunk) against the loop's on real tensors (8 fake ranks): more by
    each rank's share of P a cross-attention pass where the chunks are
    one token (1031), equal where the memory is one chunk (17); the
    collective bytes equal."""
    c = fake_counts[str(n_img)]
    cfg = _cfg(n_img)
    b, sq = (si.B, 1) if step == "decode" else (si.B, si.S)
    # a rank's share: the batch over `data`, the query heads over `model`
    share = _pv(cfg, b, sq) * _passes(cfg, step) // (si.MESH[0] * si.MESH[1])
    extra = share if n_img == PRIME_TOKENS else 0
    fold, loop = c["fold"][step], c["loop"][step]
    assert fold["collective_bytes"] == loop["collective_bytes"]
    assert fold["collective_bytes"]
    assert fold["flops"] == loop["flops"] + extra
    assert loop["flops"] > 0


@pytest.mark.parametrize("n_img", [PRIME_TOKENS, 17])
@pytest.mark.parametrize("step", ["train", "prefill", "decode"])
def test_fold_counts_loop_plus_pv_unsharded(n_img, step):
    """FlopCounterMode over the unsharded step: meta (one chunk) against
    real CPU tensors (F6's chunks), the same weights' shapes and inputs."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models import model as M
    from repro_torch.train import optim
    cfg = _cfg(n_img)
    b, s, slots = si.B, si.S, si.S_MAX
    counts = {}
    for dev in ("meta", "cpu"):
        d = torch.device(dev)
        params = (M.abstract_params(cfg) if dev == "meta" else M.init_params(
            cfg, torch.Generator().manual_seed(0), d))
        tokens = torch.zeros((b, s), dtype=torch.int32, device=d)
        images = torch.zeros((b, n_img, cfg.d_model), device=d)
        with FlopCounterMode(display=False) as fc:
            if step == "train":
                M.make_train_step(cfg, None)(
                    params, optim.adamw_init(params),
                    {"tokens": tokens, "labels": tokens, "images": images})
            elif step == "prefill":
                with torch.no_grad():
                    M.make_prefill_step(cfg, None)(
                        params, {"tokens": tokens, "images": images})
            else:
                with torch.no_grad():
                    M.decode_forward(params, cfg,
                                     M.init_cache(cfg, b, slots, d),
                                     tokens[:, 0], slots - 1)
        counts[dev] = fc.get_total_flops()
    sq = 1 if step == "decode" else s
    extra = _pv(cfg, b, sq) * _passes(cfg, step) \
        if n_img == PRIME_TOKENS else 0
    assert counts["meta"] == counts["cpu"] + extra > 0


def test_fold_leaves_real_values_alone():
    """cross_attention on real tensors: the same output as flash_attention
    with F6's one-token chunks written out here, bit for bit, at 1031
    memory tokens; on meta tensors the same shape."""
    from repro_torch.models import layers as L
    cfg = _cfg(PRIME_TOKENS)
    assert L._divisor_chunk(PRIME_TOKENS) == 1
    gen = torch.Generator().manual_seed(si.SEED)
    dh, h, hkv, d = (cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads,
                     cfg.d_model)
    p = {"wq": torch.randn(d, h, dh, generator=gen) * 0.1,
         "wk": torch.randn(d, hkv, dh, generator=gen) * 0.1,
         "wv": torch.randn(d, hkv, dh, generator=gen) * 0.1,
         "wo": torch.randn(h * dh, d, generator=gen) * 0.1}
    x = torch.randn(2, 8, d, generator=gen)
    mem = torch.randn(2, PRIME_TOKENS, d, generator=gen)
    out = L.cross_attention(x, mem, p, cfg)
    q, k, v = (torch.einsum("bsd,dhk->bshk", t, p[w]).transpose(1, 2)
               for t, w in ((x, "wq"), (mem, "wk"), (mem, "wv")))
    o = L.flash_attention(q, k, v, causal=False, chunk=1)
    want = torch.einsum("bse,ed->bsd",
                        o.transpose(1, 2).reshape(2, 8, h * dh), p["wo"])
    assert torch.equal(out, want)
    assert not torch.equal(out, torch.einsum(
        "bse,ed->bsd", L.flash_attention(q, k, v, causal=False,
                                         chunk=PRIME_TOKENS)
        .transpose(1, 2).reshape(2, 8, h * dh), p["wo"]))
    meta = L.cross_attention(
        x.to("meta"), mem.to("meta"),
        {k_: t.to("meta") for k_, t in p.items()}, cfg)
    assert meta.is_meta and meta.shape == out.shape
