"""Self-attention blocks: GQA (with qk-norm and sliding window) and MLA
(DeepSeek multi-head latent attention), with train/prefill and decode
paths.

The PyTorch counterpart of ``repro.models.attention``. The sequence
forms run the reference's chunked flash attention (chunks of
min(1024, S)), so their float order follows the reference's.

Decode caches:
* GQA/local: (k, v) each (B, Hkv, S_max, dh) — standard KV cache.
* MLA: the compressed latent (B, S_max, kv_lora + qk_rope) — 576 floats per
  token for deepseek-v3, the arch's signature memory saving.

A cache is written in place at `pos` (inside the cache) and returned.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (apply_rope, decode_attention,
                                       flash_attention, rmsnorm, rope_angles)


def _positions(b: int, pos: int, device):
    return torch.full((b, 1), int(pos), dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def gqa_forward(x, p, cfg: ArchConfig, positions):
    """x (B, S, D), positions (B, S) -> (out (B, S, D), (k, v) each
    (B, Hkv, S, dh))."""
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_angles(positions, dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin).transpose(1, 2)
    k = apply_rope(k, cos, sin).transpose(1, 2)
    v = v.transpose(1, 2)
    window = cfg.local_window if cfg.attention == "local" else 0
    o = flash_attention(q, k, v, causal=True, chunk=min(1024, s),
                        window=window)
    o = o.transpose(1, 2).reshape(b, s, h * dh)
    return torch.einsum("bse,ed->bsd", o, p["wo"]), (k, v)


def gqa_decode(x, p, cfg: ArchConfig, cache: Tuple, pos):
    """x: (B, 1, D); cache (k,v): (B, Hkv, S, dh) with `pos` filled."""
    b = x.shape[0]
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    k_cache, v_cache = cache
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_angles(_positions(b, pos, x.device), dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin).transpose(1, 2)
    k = apply_rope(k, cos, sin).transpose(1, 2)
    v = v.transpose(1, 2)
    k_cache[:, :, pos] = k[:, :, 0]
    v_cache[:, :, pos] = v[:, :, 0]
    window = cfg.local_window if cfg.attention == "local" else 0
    o = decode_attention(q, k_cache, v_cache, cur_pos=pos, window=window)
    o = o.transpose(1, 2).reshape(b, 1, h * dh)
    return torch.einsum("bse,ed->bsd", o, p["wo"]), (k_cache, v_cache)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# ---------------------------------------------------------------------------

def _mla_qkv(x, p, cfg: ArchConfig, positions):
    """Project to per-head q (nope+rope) and latent; returns q, latent."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    # q: low-rank
    q_lat = rmsnorm(torch.einsum("bsd,dr->bsr", x, p["wq_a"]), p["q_norm"],
                    cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", q_lat, p["wq_b"])     # (B,S,H,dn+dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    cos, sin = rope_angles(positions, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    # kv latent + shared k_rope
    kv = torch.einsum("bsd,dr->bsr", x, p["wkv_a"])         # (B,S,kvl+dr)
    kv_lat = rmsnorm(kv[..., :cfg.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = kv[..., cfg.kv_lora_rank:][..., None, :]       # (B,S,1,dr)
    k_rope = apply_rope(k_rope, cos, sin)[..., 0, :]        # (B,S,dr)
    latent = torch.cat([kv_lat, k_rope], dim=-1)
    return torch.cat([q_nope, q_rope], dim=-1), latent


def _mla_attend(q, latent, p, cfg: ArchConfig, cur_pos=None):
    """q (B,Sq,H,dn+dr); latent (B,Skv,kvl+dr) -> (B,Sq,H*dv)."""
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kvl = cfg.kv_lora_rank
    kv_lat, k_rope = latent[..., :kvl], latent[..., kvl:]
    kvb = p["wkv_b"].reshape(kvl, h, dn + dv)
    k_nope = torch.einsum("bsr,rhk->bshk", kv_lat, kvb[..., :dn])
    v = torch.einsum("bsr,rhk->bshk", kv_lat, kvb[..., dn:])
    k_rope_h = k_rope[:, :, None, :].expand(k_rope.shape[:2] + (h, dr))
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2)
    vh = v.transpose(1, 2)
    sq = q.shape[1]
    if sq == 1:
        o = decode_attention(qh, kh, vh, cur_pos=cur_pos)
    else:
        o = flash_attention(qh, kh, vh, causal=True, chunk=min(1024, sq))
    b = q.shape[0]
    return o.transpose(1, 2).reshape(b, sq, h * dv)


def mla_forward(x, p, cfg: ArchConfig, positions):
    """x (B, S, D) -> (out (B, S, D), latent (B, S, kv_lora + qk_rope))."""
    q, latent = _mla_qkv(x, p, cfg, positions)
    o = _mla_attend(q, latent, p, cfg)
    return torch.einsum("bse,ed->bsd", o, p["wo"]), latent


def mla_decode(x, p, cfg: ArchConfig, latent_cache, pos):
    """latent_cache: (B, S_max, kv_lora+qk_rope)."""
    b = x.shape[0]
    q, latent = _mla_qkv(x, p, cfg, _positions(b, pos, x.device))
    latent_cache[:, pos] = latent[:, 0]
    o = _mla_attend(q, latent_cache, p, cfg, cur_pos=pos)
    return torch.einsum("bse,ed->bsd", o, p["wo"]), latent_cache
