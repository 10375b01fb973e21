"""The inputs of the partitioned-step parity tests, drawn with numpy from a
fixed seed, the same in the JAX package's process
(tests/_jax_sharded_step.py) and in the port's ranks
(tests/_torch_dist_worker.py, scenario ``sharded``).

Each side passes its own parameter and cache schemas (the two packages'
schemas have the same paths, shapes, scales and logical axes, visited in
sorted key order), so nothing here imports either package.
"""
import numpy as np

ARCHS = ("qwen3-8b", "deepseek-v3-671b", "arctic-480b")
MESH = (2, 4)                  # (data, model): 8 ranks or host devices
B, S = 4, 32                   # train and prefill batch
S_MAX, HISTORY, DECODE_STEPS = 16, 6, 4   # decode: cache slots, filled
# slots, steps (positions HISTORY .. HISTORY + DECODE_STEPS - 1: across
# the blocks of two ranks where the cache's sequence splits over model)
# a ring-buffer (local-attention) cache of min(window, S_MAX) = 16 slots is
# filled to RING_HISTORY: positions 14..17 cross the ring's wrap
RING_HISTORY = 14
RING_STEPS = 6                 # the ring-decode test's positions 0..5
LR = 3e-4                      # make_train_step's default
SEED = 26


def history(ring):
    """The decode's filled slots (its first position): RING_HISTORY for a
    stack with a ring-buffer cache (`ring`: the config's rglru)."""
    return RING_HISTORY if ring else HISTORY


def draw_params(leaves):
    """leaves: [(path, shape, scale)] in sorted key order -> {path: array}:
    norm weights (scale 1.0, at most two axes) ones, cross-attention gates
    0.5 (so cross attention reaches the logits), the rest normal x scale,
    float32."""
    rng = np.random.default_rng(SEED)
    out = {}
    for path, shape, scale in leaves:
        if path[-1] == "gate":
            a = np.full(shape, 0.5)
        elif scale == 1.0 and len(shape) <= 2:
            a = np.ones(shape)
        else:
            a = rng.normal(size=shape) * scale
        out[path] = a.astype(np.float32)
    return out


def draw_batch(vocab, d_model, enc_dec, n_img=0):
    """tokens and labels (B, S), then the encoder's `frames` (B, S,
    d_model) for an encoder-decoder, or `images` (B, n_img, d_model) for
    a cross-attention-period stack (n_img > 0)."""
    rng = np.random.default_rng(SEED + 1)
    out = {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}
    if enc_dec:
        out["frames"] = rng.normal(size=(B, S, d_model)).astype(np.float32)
    if n_img:
        out["images"] = rng.normal(size=(B, n_img, d_model)).astype(
            np.float32)
    return out


def draw_cache(leaves, filled):
    """leaves: [(path, shape, logical axes)] of the decode cache at batch
    B and S_MAX slots -> {path: array}: every slot before `filled` of a
    leaf with a "seq" axis drawn (the rest 0); the encoder memory and
    the images whole;
    a ring's slot positions (`pos_*`, `tpos_*`, int32) the slot's index
    before `filled`, 0 after."""
    rng = np.random.default_rng(SEED + 2)
    out = {}
    for path, shape, logical in leaves:
        a = np.zeros(shape, np.float32)
        if path[-1].startswith(("pos", "tpos")):
            a = np.zeros(shape, np.int32)
            a[..., :filled] = np.arange(filled)
        elif path[-1] in ("memory", "images"):
            a[...] = rng.normal(size=shape)
        elif "seq" in logical:
            ax = logical.index("seq")
            idx = [slice(None)] * len(shape)
            idx[ax] = slice(0, filled)
            a[tuple(idx)] = rng.normal(size=a[tuple(idx)].shape)
        out[path] = a
    return out


def first_tokens(vocab):
    return np.random.default_rng(SEED + 3).integers(0, vocab, B).astype(
        np.int32)


def draw_ring(d_model):
    """The ring-decode test's inputs, (RING_STEPS, B, 1, d_model): one
    decode step's activations a position."""
    rng = np.random.default_rng(SEED + 4)
    return rng.normal(size=(RING_STEPS, B, 1, d_model)).astype(np.float32)
