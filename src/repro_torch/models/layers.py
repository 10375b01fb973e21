"""Shared neural layers: norms, RoPE, SwiGLU MLP, flash-style attention
(chunked, causal/local/cross) and single-token decode attention.

The PyTorch counterpart of ``repro.models.layers``. Every cast sits where
the reference has it (the model dtype for matrix products, float32 for
norms, softmax and gates), and the chunked attention keeps the
reference's chunking, so its float order follows the reference's. No
fused attention kernel is called: attention is einsum, softmax and the
online-softmax recurrence, as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.sharding.dtensor import is_dtensor as sd_is_dtensor, mm

F32 = torch.float32


def rmsnorm(x, w, eps=1e-6):
    xf = x.to(F32)
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * w.to(F32)).to(x.dtype)


def rope_angles(positions, dim: int, theta: float):
    """positions: (..., S) int32 -> (cos, sin) of shape (..., S, dim//2)."""
    half = dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=F32,
                                          device=positions.device) / half))
    ang = positions.to(F32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., S, H, d). cos/sin: (..., S, d//2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(F32)
    s = sin[..., None, :].to(F32)
    x1f, x2f = x1.to(F32), x2.to(F32)
    return torch.cat([x1f * c - x2f * s, x2f * c + x1f * s],
                     dim=-1).to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    g = mm("bsd,df->bsf", x, w_gate)
    u = mm("bsd,df->bsf", x, w_up)
    h = F.silu(g.to(F32)).to(x.dtype) * u
    return mm("bsf,fd->bsd", h, w_down)


# ---------------------------------------------------------------------------
# chunked (flash-style) attention
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def _attend_chunk(q, k, v, mask, scale):
    """q (B,G,Hg,Sq,d) k/v (B,G,Skv,d) mask (Sq,Skv) -> partial softmax stats."""
    s = torch.einsum("bghqd,bgkd->bghqk", q, k).to(F32) * scale
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    m = torch.clamp_min(m, -1e29)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bghqk,bgkd->bghqd", p.to(v.dtype), v).to(F32)
    return m, l, o


def flash_attention(q, k, v, *, causal: bool, chunk: int = 1024,
                    window: int = 0):
    """Chunked softmax attention with running max/denominator.

    q: (B, Hq, Sq, d); k, v: (B, Hkv, Skv, d); GQA via head groups.
    window > 0 limits attention to the last `window` positions (exact
    sliding window). Assumes Sq == Skv when causal (training/prefill).
    The chunks are visited in order, as the reference's scan visits them.
    """
    b, hq, sq, d = q.shape
    dv = v.shape[-1]
    g = k.shape[1]
    hg = hq // g
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, g, hg, sq, d)
    skv = k.shape[2]
    chunk = min(chunk, skv)
    n_chunks = skv // chunk
    assert skv % chunk == 0, (skv, chunk)
    q_pos = torch.arange(sq, device=q.device)
    m_run = torch.full((b, g, hg, sq, 1), NEG_INF, dtype=F32,
                       device=q.device)
    l_run = torch.zeros((b, g, hg, sq, 1), dtype=F32, device=q.device)
    o_run = torch.zeros((b, g, hg, sq, dv), dtype=F32, device=q.device)
    for ci in range(n_chunks):
        kb = k[:, :, ci * chunk:(ci + 1) * chunk]
        vb = v[:, :, ci * chunk:(ci + 1) * chunk]
        kv_pos = ci * chunk + torch.arange(chunk, device=q.device)
        mask = torch.ones((sq, chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= kv_pos[None, :]
        if window:
            mask &= q_pos[:, None] - kv_pos[None, :] < window
        m_c, l_c, o_c = _attend_chunk(qg, kb, vb, mask, scale)
        m_new = torch.maximum(m_run, m_c)
        a1 = torch.exp(m_run - m_new)
        a2 = torch.exp(m_c - m_new)
        l_run = l_run * a1 + l_c * a2
        o_run = o_run * a1 + o_c * a2
        m_run = m_new
    out = (o_run / torch.clamp_min(l_run, 1e-30)).to(q.dtype)
    return out.reshape(b, hq, sq, dv)


def decode_attention(q, k_cache, v_cache, cur_pos=None, window: int = 0):
    """Single-token decode: q (B,Hq,1,d) over cache (B,Hkv,S,d).

    `cur_pos` (int) masks cache slots beyond the current position;
    `window` restricts to the trailing sliding window.
    """
    b, hq, _, d = q.shape
    g = k_cache.shape[1]
    hg = hq // g
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, g, hg, 1, d)
    s = torch.einsum("bghqd,bgkd->bghqk", qg, k_cache).to(F32) * scale
    skv = k_cache.shape[2]
    pos = torch.arange(skv, device=q.device)
    if cur_pos is not None:
        s = torch.where(pos <= cur_pos, s, NEG_INF)
        if window:
            s = torch.where(cur_pos - pos < window, s, NEG_INF)
    elif window:
        s = torch.where((skv - 1 - pos) < window, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bghqk,bgkd->bghqd", p.to(v_cache.dtype), v_cache)
    return o.reshape(b, hq, 1, v_cache.shape[-1])


def _divisor_chunk(skv: int, target: int = 1024) -> int:
    """Largest chunk <= target dividing skv. The reference's loop runs
    down to 1, which divides every skv, so a prime skv (1601 image
    tokens) gets chunks of 1, not one chunk of skv as its docstring says;
    the port keeps that chunking (ROADMAP §3, F6)."""
    for c in range(min(target, skv), 0, -1):
        if skv % c == 0:
            return c
    return skv


def cross_attention(x, memory, p, cfg: ArchConfig):
    """Non-causal attention from x to `memory` (vision/audio/encoder).
    On DTensors the attention between the projections runs in
    `attention._attend_island`.

    On meta tensors (a count of the ops, no values: the dry run) the
    memory runs as one chunk, not `_divisor_chunk`'s: llama-3.2-vision's
    1601 image tokens would otherwise be 1601 Python iterations a layer
    and pass. The two counts differ by the p.v product: a one-token
    chunk's `bghqk,bgkd->bghqd` contracts a dim of size 1, which torch
    runs as an elementwise multiply that FlopCounterMode does not count.
    The fold counts it, 2 * B * Hq * Sq * Skv * dh a cross-attention
    layer and pass (three in a train step: the forward and its two
    backward products), so the dry run reports the work the chunks do;
    real tensors keep F6's chunks, and so the reference's values."""
    dh = cfg.resolved_head_dim
    q = mm("bsd,dhk->bshk", x, p["wq"])
    kx = mm("bsd,dhk->bshk", memory, p["wk"])
    vx = mm("bsd,dhk->bshk", memory, p["wv"])

    def attend(q, k, v, norms, lcfg, sl):
        bl, sq = q.shape[:2]
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        skv = k.shape[2]
        o = flash_attention(q, k[:, sl[0]:sl[1]], v[:, sl[0]:sl[1]],
                            causal=False,
                            chunk=skv if q.is_meta else _divisor_chunk(skv))
        return (o.transpose(1, 2).reshape(bl, sq, lcfg.n_heads * dh), k, v)

    if sd_is_dtensor(q):
        from repro_torch.models.attention import _attend_island
        o = _attend_island(q, kx, vx, (), cfg, attend)[0]
    else:
        o = attend(q, kx, vx, (), cfg, (0, kx.shape[2]))[0]
    return mm("bse,ed->bsd", o, p["wo"])
