"""Recurrent sequence mixers: RWKV6 (Finch) time-mix and RG-LRU
(RecurrentGemma), with state passed in and out.

The PyTorch counterpart of ``repro.models.recurrent``. The reference's
scans over time become loops over T (decode runs T = 1); the state is
float32 inside a step, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig

F32 = torch.float32
RWKV_HEAD_DIM = 64


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
    b, t, d = x.shape
    dh = RWKV_HEAD_DIM
    h = d // dh
    xs = _token_shift(x, x_last)

    def lerp(mu):
        return x + (xs - x) * mu
    r = torch.einsum("btd,de->bte", lerp(p["mu_r"]), p["wr"])
    k = torch.einsum("btd,de->bte", lerp(p["mu_k"]), p["wk"])
    v = torch.einsum("btd,de->bte", lerp(p["mu_v"]), p["wv"])
    g = torch.einsum("btd,de->bte", lerp(p["mu_g"]), p["wg"])
    # data-dependent decay (LoRA): w = exp(-exp(w0 + tanh(xw A) B))
    xw = lerp(p["mu_w"])
    dd = torch.einsum("btr,rd->btd", torch.tanh(
        torch.einsum("btd,dr->btr", xw, p["w_lora_a"])), p["w_lora_b"])
    w = torch.exp(-torch.exp((p["w0"] + dd).to(F32)))       # (B,T,D) in (0,1)

    rh = r.reshape(b, t, h, dh)
    kh = k.reshape(b, t, h, dh)
    vh = v.reshape(b, t, h, dh)
    wh = w.reshape(b, t, h, dh)
    u = p["u_bonus"].reshape(h, dh)

    s = (torch.zeros((b, h, dh, dh), dtype=F32, device=x.device)
         if state is None else state)
    outs = []
    for i in range(t):
        rt, kt, vt, wt = rh[:, i], kh[:, i], vh[:, i], wh[:, i]  # (B,H,dh)
        kv = torch.einsum("bhk,bhv->bhkv", kt.to(F32), vt.to(F32))
        outs.append(torch.einsum("bhk,bhkv->bhv", rt.to(F32),
                                 s + u[None, :, :, None] * kv))
        s = s * wt.to(F32)[..., None] + kv
    out = torch.stack(outs, dim=1).reshape(b, t, d)
    out = _groupnorm(out, p["ln_x_w"], h)
    out = out * F.silu(g.to(F32)).to(out.dtype)
    out = torch.einsum("btd,de->bte", out.to(x.dtype), p["wo"])
    return out, (s, x[:, -1])


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
    k = torch.einsum("btd,df->btf", xk, p["w_key"])
    k = torch.square(torch.relu(k.to(F32))).to(x.dtype)
    kv = torch.einsum("btf,fd->btd", k, p["w_value"])
    r = torch.sigmoid(
        torch.einsum("btd,de->bte", xr, p["w_recept"]).to(F32))
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


def rglru(x, p, state=None):
    """RG-LRU recurrence. x (B,T,W) -> same; state (B,W) diagonal float32."""
    b, t, w_dim = x.shape
    rgate = torch.sigmoid(x.to(F32) * p["w_a"].to(F32) + p["b_a"].to(F32))
    igate = torch.sigmoid(x.to(F32) * p["w_x"].to(F32) + p["b_x"].to(F32))
    log_a = -8.0 * rgate * F.softplus(p["lambda_p"].to(F32))
    a = torch.exp(log_a)                                      # (B,T,W)
    gated_x = x.to(F32) * igate
    multiplier = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12))

    h = (torch.zeros((b, w_dim), dtype=F32, device=x.device)
         if state is None else state)
    hs = []
    for i in range(t):
        h = a[:, i] * h + multiplier[:, i] * gated_x[:, i]
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype), h


def rglru_block(x, p, cfg: ArchConfig, state=None):
    """RecurrentGemma recurrent block:
    x -> [linear -> conv1d -> RG-LRU] * gelu(linear(x)) -> linear out.
    state = (conv_state, lru_state)."""
    conv_state, lru_state = state if state is not None else (None, None)
    y = torch.einsum("btd,dw->btw", x, p["w_in_y"])
    gate = F.gelu(torch.einsum("btd,dw->btw", x, p["w_in_g"]).to(F32),
                  approximate="tanh").to(x.dtype)   # jax.nn.gelu's default
    y, new_conv = _causal_conv1d(y, p["conv_w"], conv_state)
    y, new_lru = rglru(y, p, lru_state)
    out = torch.einsum("btw,wd->btd", y * gate, p["w_out"])
    return out, (new_conv, new_lru)
