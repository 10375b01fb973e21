"""Recurrent sequence mixers: RWKV6 (Finch) time-mix and RG-LRU
(RecurrentGemma), with state passed in and out.

The PyTorch counterpart of ``repro.models.recurrent``. The reference's
scans over time become loops over T (`_over_time`; decode runs T = 1);
the state is float32 inside a step, as in the reference.

Partitioned step (the inputs are DTensors, `sharding.dtensor`): the
products with a weight go through `sd.mm`; each time loop runs in an
island on each rank's own block, with no collective inside it:
* `_time_mix_island` (RWKV6): heads meet ranks where the head count
  divides over `model` (each rank's column block of r, k, v, w and g is
  then whole heads, and the `wkv` state splits by heads as the cache's
  spec splits it); where it does not (rwkv6-3b's 40 heads on 16 ranks,
  the smoke config's 2 on 4), r, k, v, w and g are gathered over
  `model` and every rank of a `model` group runs every head of its
  batch block, the state whole over `model`, as that cache's spec lays
  it out.
* `_rglru_island` (RG-LRU): the causal conv and the recurrence over each
  rank's block of the width channels, as the column-parallel input
  product splits them (lru_width over `model`); the replicated gate
  vectors are cut to the rank's channels.

On meta tensors (a count of the ops, no values: the dry run) a time loop
runs as one step batched over T (`_over_time`): the same ops on the same
shapes with T folded into each op's batch dim. A matmul's FLOPs are
linear in its batch, and the loop holds no collective, so the count is
T times one step's, exactly what the T steps count, at the cost of one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.sharding import dtensor as sd

F32 = torch.float32
RWKV_HEAD_DIM = 64
_LRU_GATES = ("w_a", "b_a", "w_x", "b_x", "lambda_p")


def _over_time(step, xs, state):
    """state carried through step(x_0[:, i], ..., state) -> (out, state)
    for i < T, xs (B, T, ...) each; -> (outs stacked on dim 1, the last
    state). On meta tensors, one step batched over T (the module's
    docstring): each step's state input is the initial state, and the
    outputs take a zero-weighted sum of the new states, so the gradient
    reaches every input the loop's would (RWKV6's decay reaches the
    loss only through the carried state)."""
    b, t = xs[0].shape[:2]
    if xs[0].is_meta:
        def fold(a):
            return a.reshape((b * t,) + a.shape[2:])
        start = state[:, None].expand((b, t) + state.shape[1:])
        out, last = step(*(fold(x) for x in xs), fold(start))
        out = out + 0 * last.sum()
        return (out.reshape((b, t) + out.shape[1:]),
                last.reshape((b, t) + last.shape[1:])[:, -1])
    outs = []
    for i in range(t):
        out, state = step(*(x[:, i] for x in xs), state)
        outs.append(out)
    return torch.stack(outs, dim=1), state


# ---------------------------------------------------------------------------
# RWKV6 time-mix (data-dependent decay — the Finch headline feature)
# ---------------------------------------------------------------------------

def _token_shift(x, last=None):
    """Shift sequence right by one; `last` supplies x_{-1} for decode."""
    if last is None:
        pad = torch.zeros_like(x[:, :1])
    else:
        pad = last[:, None, :]
    return torch.cat([pad, x[:, :-1]], dim=1)


def rwkv_time_mix(x, p, cfg: ArchConfig, state=None, x_last=None):
    """x: (B, T, D). state: (B, H, dh, dh) float32 or None (zeros).

    Returns (out, (new_state, new_x_last)).
    """
    xs = _token_shift(x, x_last)

    def lerp(mu):
        return x + (xs - x) * mu
    r = sd.mm("btd,de->bte", lerp(p["mu_r"]), p["wr"])
    k = sd.mm("btd,de->bte", lerp(p["mu_k"]), p["wk"])
    v = sd.mm("btd,de->bte", lerp(p["mu_v"]), p["wv"])
    g = sd.mm("btd,de->bte", lerp(p["mu_g"]), p["wg"])
    # data-dependent decay (LoRA): w = exp(-exp(w0 + tanh(xw A) B))
    xw = lerp(p["mu_w"])
    dd = sd.mm("btr,rd->btd", torch.tanh(
        sd.mm("btd,dr->btr", xw, p["w_lora_a"])), p["w_lora_b"])
    w = torch.exp(-torch.exp((p["w0"] + dd).to(F32)))       # (B,T,D) in (0,1)
    mix = _time_mix_island if sd.is_dtensor(r) else _time_mix_heads
    out, s = mix(r, k, v, w, g, p["u_bonus"], p["ln_x_w"], state)
    out = sd.mm("btd,de->bte", out.to(x.dtype), p["wo"])
    return out, (s, x[:, -1])


def _wkv_step(r, k, v, w, u, s):
    """One token of the WKV recurrence: r, k, v, w (B, H, dh), u (H, dh),
    s (B, H, dh, dh) float32 -> (out (B, H, dh), new s)."""
    kv = torch.einsum("bhk,bhv->bhkv", k.to(F32), v.to(F32))
    out = torch.einsum("bhk,bhkv->bhv", r.to(F32),
                       s + u[None, :, :, None] * kv)
    return out, s * w.to(F32)[..., None] + kv


def _time_mix_heads(r, k, v, w, g, u, ln_w, s):
    """The WKV recurrence over the heads of r, k, v, w, g (B, T, H * dh),
    its per-head group norm and the silu(g) gate -> (out (B, T, H * dh)
    float32, state (B, H, dh, dh))."""
    b, t, d = r.shape
    dh = RWKV_HEAD_DIM
    h = d // dh

    def heads(a):
        return a.reshape(b, t, h, dh)
    if s is None:
        s = torch.zeros((b, h, dh, dh), dtype=F32, device=r.device)
    uh = u.reshape(h, dh)
    out, s = _over_time(
        lambda rt, kt, vt, wt, st: _wkv_step(rt, kt, vt, wt, uh, st),
        (heads(r), heads(k), heads(v), heads(w)), s)
    out = _groupnorm(out.reshape(b, t, d), ln_w, h)
    return out * F.silu(g.to(F32)).to(out.dtype), s


def _time_mix_island(r, k, v, w, g, u, ln_w, state):
    """_time_mix_heads on each rank's block: the batch over the data axes,
    the heads over `model` where their count divides, else whole on
    every rank (the module's docstring); u and ln_x_w cut to the rank's
    heads; the state (B, H, dh, dh) laid out as the activations' heads."""
    dm = r.device_mesh
    bs = sd.batch_entry(dm, r.shape[0])
    m = sd.model_size(dm)
    hs = "model" if m > 1 and (r.shape[2] // RWKV_HEAD_DIM) % m == 0 else None
    act = sd.pl(dm, (bs, None, hs))
    vec, vec_grad = sd.pl(dm, (hs,)), sd.pl(dm, (hs,), tuple(bs or ()))
    st = None if state is None else sd.pl(dm, (bs, hs, None, None))
    return sd.island(_time_mix_heads, dm, (r, k, v, w, g, u, ln_w, state),
                     (act,) * 5 + (vec, vec, st),
                     (act, sd.pl(dm, (bs, hs, None, None))),
                     (act,) * 5 + (vec_grad, vec_grad, st))


def _groupnorm(x, w, groups):
    b, t, d = x.shape
    xf = x.to(F32).reshape(b, t, groups, d // groups)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + 64e-5)).reshape(b, t, d)
    return (y * w.to(F32)).to(x.dtype)


def rwkv_channel_mix(x, p, cfg: ArchConfig, x_last=None):
    xs = _token_shift(x, x_last)
    xk = x + (xs - x) * p["mu_ck"]
    xr = x + (xs - x) * p["mu_cr"]
    k = sd.mm("btd,df->btf", xk, p["w_key"])
    k = torch.square(torch.relu(k.to(F32))).to(x.dtype)
    kv = sd.mm("btf,fd->btd", k, p["w_value"])
    r = torch.sigmoid(sd.mm("btd,de->bte", xr, p["w_recept"]).to(F32))
    return (r.to(x.dtype) * kv), x[:, -1]


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma) + temporal conv
# ---------------------------------------------------------------------------

def _causal_conv1d(x, w, state=None):
    """Depthwise causal conv. x (B,T,W), w (K,W). state: (B,K-1,W) history."""
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return out, xp[:, -(k - 1):]


def _lru_step(a, m, gx, h):
    h = a * h + m * gx
    return h, h


def rglru(x, p, state=None):
    """RG-LRU recurrence. x (B,T,W) -> same; state (B,W) diagonal float32."""
    b, _, w_dim = x.shape
    rgate = torch.sigmoid(x.to(F32) * p["w_a"].to(F32) + p["b_a"].to(F32))
    igate = torch.sigmoid(x.to(F32) * p["w_x"].to(F32) + p["b_x"].to(F32))
    log_a = -8.0 * rgate * F.softplus(p["lambda_p"].to(F32))
    a = torch.exp(log_a)                                      # (B,T,W)
    gated_x = x.to(F32) * igate
    multiplier = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12))

    h = (torch.zeros((b, w_dim), dtype=F32, device=x.device)
         if state is None else state)
    hs, h = _over_time(_lru_step, (a, multiplier, gated_x), h)
    return hs.to(x.dtype), h


def _conv_rglru(y, conv_w, conv_state, lru_state, *gates):
    """The causal conv, then the RG-LRU over y (B, T, W) -> (y, conv
    state, lru state); gates are p's _LRU_GATES vectors in that order."""
    y, new_conv = _causal_conv1d(y, conv_w, conv_state)
    y, new_lru = rglru(y, dict(zip(_LRU_GATES, gates)), lru_state)
    return y, new_conv, new_lru


def _rglru_island(y, p, conv_state, lru_state):
    """_conv_rglru on each rank's block: the batch over the data axes and
    the width channels over `model` as y's product split them; conv_w
    (K, W) and the gate vectors cut to the rank's channels."""
    dm = y.device_mesh
    bs = sd.batch_entry(dm, y.shape[0])
    ws = "model" if sd.model_split(y) == 2 else None
    dp = tuple(bs or ())
    act, lru = sd.pl(dm, (bs, None, ws)), sd.pl(dm, (bs, ws))
    conv_pl, conv_grad = sd.pl(dm, (None, ws)), sd.pl(dm, (None, ws), dp)
    vec, vec_grad = sd.pl(dm, (ws,)), sd.pl(dm, (ws,), dp)
    states = (None if conv_state is None else act,
              None if lru_state is None else lru)
    return sd.island(
        _conv_rglru, dm,
        (y, p["conv_w"], conv_state, lru_state)
        + tuple(p[k] for k in _LRU_GATES),
        (act, conv_pl) + states + (vec,) * len(_LRU_GATES),
        (act, act, lru),
        (act, conv_grad) + states + (vec_grad,) * len(_LRU_GATES))


def rglru_block(x, p, cfg: ArchConfig, state=None):
    """RecurrentGemma recurrent block:
    x -> [linear -> conv1d -> RG-LRU] * gelu(linear(x)) -> linear out.
    state = (conv_state, lru_state)."""
    conv_state, lru_state = state if state is not None else (None, None)
    y = sd.mm("btd,dw->btw", x, p["w_in_y"])
    gate = F.gelu(sd.mm("btd,dw->btw", x, p["w_in_g"]).to(F32),
                  approximate="tanh").to(x.dtype)   # jax.nn.gelu's default
    if sd.is_dtensor(y):
        y, new_conv, new_lru = _rglru_island(y, p, conv_state, lru_state)
    else:
        y, new_conv, new_lru = _conv_rglru(
            y, p["conv_w"], conv_state, lru_state,
            *(p[k] for k in _LRU_GATES))
    out = sd.mm("btw,wd->btd", y * gate, p["w_out"])
    return out, (new_conv, new_lru)
