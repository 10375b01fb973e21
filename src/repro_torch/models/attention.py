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

Partitioned step (the inputs are DTensors, `sharding.dtensor`): the
projections are DTensor matmuls; what lies between them runs in an
island on each rank's block, because it builds position and mask
tensors, slices heads and writes caches in place:
* `_attend_island` (train/prefill self-attention, and
  `layers.cross_attention`):
  batch over the data axes, heads over `model` where the heads split
  (as the reference's specs shard `wq`); where the KV heads do not split
  over `model` they stay whole on every rank, and each rank attends with
  the KV heads its query heads read.
* `_decode_island` and `_mla_decode_island` (decode): the cache's own
  layout (batch over the data axes; its KV heads, or else its sequence,
  over `model`, as the serving rules lay it out). Where the sequence is
  split, each rank attends over its own slots with every head, and the
  softmax's max, denominator and weighted sum are reduced over `model`
  (context-parallel decode).
* `_mla_island` (MLA train/prefill): the latent's norm and RoPE and the
  per-head expansion through `wkv_b`, heads over `model`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (NEG_INF, apply_rope, decode_attention,
                                       flash_attention, rmsnorm, rope_angles)
from repro_torch.sharding import dtensor as sd

F32 = torch.float32


def _positions(b: int, pos: int, device):
    return torch.full((b, 1), int(pos), dtype=torch.int32, device=device)


def _seq_positions(b: int, s: int, device):
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


# ---------------------------------------------------------------------------
# head layout of the partitioned step
# ---------------------------------------------------------------------------

def _kv_slice(dm, h: int, hkv: int, h_local: int) -> Tuple[int, int]:
    """The KV heads the query heads of this rank read, where the query
    heads split over `model` and the KV heads do not: global query head
    j reads KV head j // (h // hkv)."""
    r = sd.axis_index(dm, "model")
    hg = h // hkv
    if hg % h_local and h_local % hg:
        raise ValueError(f"{h_local} query heads a rank against groups of "
                         f"{hg}: a rank's heads straddle KV groups")
    lo = (r * h_local) // hg
    return lo, ((r + 1) * h_local - 1) // hg + 1


def _attend_island(q, k, v, norms, cfg: ArchConfig, fn):
    """Run fn(q, k, v, norms, local cfg, kv slice) on each rank's block
    of q (B, S, H, dh), k and v (B, Skv, Hkv, dh) and the replicated norm
    weights (None where absent); fn returns (o (B, S, H_l * dh), k, v) and
    the island returns them as DTensors: o with its heads split as q's,
    k and v (B, Hkv, Skv, dh) as they came in."""
    dm = q.device_mesh
    b, h, hkv = q.shape[0], q.shape[2], k.shape[2]
    m = sd.model_size(dm)
    bs = sd.batch_entry(dm, b)
    hs = "model" if m > 1 and h % m == 0 else None
    kvs = "model" if hs and hkv % m == 0 else None
    ws = tuple(bs or ())                 # weights: partial over the data axes
    ms = ("model",) if hs else ()        # ... and over model where heads split
    q_pl = sd.pl(dm, (bs, None, hs, None))
    kv_pl = sd.pl(dm, (bs, None, kvs, None))
    kv_grad = sd.pl(dm, (bs, None, kvs, None), () if kvs else ms)
    w_pl = sd.pl(dm, ())
    w_grad = sd.pl(dm, (), ws + ms)
    n_pl = [None if t is None else w_pl for t in norms]
    n_grad = [None if t is None else w_grad for t in norms]

    def local(ql, kl, vl, *nl):
        lcfg = dataclasses.replace(cfg, n_heads=ql.shape[2],
                                   n_kv_heads=kl.shape[2])
        sl = (0, kl.shape[2]) if kvs or not hs else _kv_slice(
            dm, h, hkv, ql.shape[2])
        return fn(ql, kl, vl, nl, lcfg, sl)

    return sd.island(local, dm, (q, k, v) + tuple(norms),
                     (q_pl, kv_pl, kv_pl) + tuple(n_pl),
                     (sd.pl(dm, (bs, None, hs)),
                      sd.pl(dm, (bs, kvs, None, None)),
                      sd.pl(dm, (bs, kvs, None, None))),
                     (q_pl, kv_grad, kv_grad) + tuple(n_grad))


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def _gqa_rope(q, k, v, q_norm, k_norm, cfg: ArchConfig, positions):
    """qk-norm and RoPE: q (B,S,H,dh), k, v (B,S,Hkv,dh) -> q, k, v with
    heads before the sequence."""
    dh = cfg.resolved_head_dim
    if cfg.qk_norm:
        q = rmsnorm(q, q_norm, cfg.norm_eps)
        k = rmsnorm(k, k_norm, cfg.norm_eps)
    cos, sin = rope_angles(positions, dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin).transpose(1, 2)
    k = apply_rope(k, cos, sin).transpose(1, 2)
    return q, k, v.transpose(1, 2)


def _gqa_norms(p, cfg: ArchConfig):
    return ((p["q_norm"], p["k_norm"]) if cfg.qk_norm else (None, None))


def gqa_forward(x, p, cfg: ArchConfig, positions):
    """x (B, S, D), positions (B, S) -> (out (B, S, D), (k, v) each
    (B, Hkv, S, dh)). On DTensors the positions are each rank's own
    (0..S-1, as the forward's)."""
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    q = sd.mm("bsd,dhk->bshk", x, p["wq"])
    k = sd.mm("bsd,dhk->bshk", x, p["wk"])
    v = sd.mm("bsd,dhk->bshk", x, p["wv"])
    window = cfg.local_window if cfg.attention == "local" else 0

    def attend(q, k, v, norms, lcfg, sl, positions=None):
        bl, sq = q.shape[:2]
        if positions is None:
            positions = _seq_positions(bl, sq, q.device)
        q, k, v = _gqa_rope(q, k, v, *norms, lcfg, positions)
        o = flash_attention(q, k[:, sl[0]:sl[1]], v[:, sl[0]:sl[1]],
                            causal=True, chunk=min(1024, sq), window=window)
        return (o.transpose(1, 2).reshape(bl, sq, lcfg.n_heads * dh), k, v)

    if sd.is_dtensor(q):
        o, k, v = _attend_island(q, k, v, _gqa_norms(p, cfg), cfg, attend)
    else:
        o, k, v = attend(q, k, v, _gqa_norms(p, cfg), cfg,
                         (0, k.shape[2]), positions)
    return sd.mm("bse,ed->bsd", o, p["wo"]), (k, v)


def _seq_owner(dm, split: bool, s_local: int) -> int:
    """The first global slot of this rank's block of a cache's sequence."""
    return sd.axis_index(dm, "model") * s_local if split else 0


def _combine_decode(dm, s, v, split: bool):
    """softmax(s) @ v over the slots of every rank along `model`: s
    (B, G, Hg, 1, S_l) float32 scores, v (B, G, S_l, d). Where the
    sequence is not split it is decode_attention's own formula."""
    if not split:
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bghqk,bgkd->bghqd", p.to(v.dtype), v)
    group = dm.get_group("model")
    m = s.amax(-1, keepdim=True)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    e = torch.exp(s - m)
    den = e.sum(-1, keepdim=True)
    dist.all_reduce(den, group=group)
    num = torch.einsum("bghqk,bgkd->bghqd", e, v.to(F32))
    dist.all_reduce(num, group=group)
    return (num / den).to(v.dtype)


def _decode_scores(q, k_cache, slot_pos, cur_pos: int, window: int):
    """decode_attention's masked scores: q (B,Hq,1,d) over the cache
    slots at global positions slot_pos."""
    b, hq, _, d = q.shape
    g = k_cache.shape[1]
    qg = q.reshape(b, g, hq // g, 1, d)
    s = torch.einsum("bghqd,bgkd->bghqk", qg, k_cache).to(F32) * (
        1.0 / math.sqrt(d))
    s = torch.where(slot_pos <= cur_pos, s, NEG_INF)
    if window:
        s = torch.where(cur_pos - slot_pos < window, s, NEG_INF)
    return s


def _decode_island(q, k, v, norms, k_cache, v_cache, cfg: ArchConfig,
                   pos: int, window: int):
    """GQA decode on each rank's block of the cache (B, Hkv, S, dh), in
    its own layout: the new k, v written in place at `pos` by the rank
    that holds that slot. Returns o (B, 1, H * dh)."""
    dm = q.device_mesh
    spec = sd.spec_of(k_cache)
    bs = spec[0]
    kvs = "model" if sd.splits(spec[1], "model") else None
    seq_split = sd.splits(spec[2], "model")
    dh = cfg.resolved_head_dim

    def local(ql, kl, vl, qn, kn, kc, vc):
        bl = ql.shape[0]
        lcfg = dataclasses.replace(cfg, n_heads=ql.shape[2],
                                   n_kv_heads=kl.shape[2])
        ql, kl, vl = _gqa_rope(ql, kl, vl, qn, kn, lcfg,
                               _positions(bl, pos, ql.device))
        s_l = kc.shape[2]
        off = _seq_owner(dm, seq_split, s_l)
        if off <= pos < off + s_l:
            kc[:, :, pos - off] = kl[:, :, 0]
            vc[:, :, pos - off] = vl[:, :, 0]
        if not seq_split:
            o = decode_attention(ql, kc, vc, cur_pos=pos, window=window)
        else:
            slots = off + torch.arange(s_l, device=ql.device)
            s = _decode_scores(ql, kc, slots, pos, window)
            o = _combine_decode(dm, s, vc, True).reshape(
                bl, ql.shape[1], 1, vc.shape[-1])
        return o.transpose(1, 2).reshape(bl, 1, lcfg.n_heads * dh)

    head_pl = sd.pl(dm, (bs, None, kvs, None))
    w_pl = sd.pl(dm, ())
    return sd.island(
        local, dm, (q, k, v) + tuple(norms) + (k_cache, v_cache),
        (head_pl, head_pl, head_pl)
        + tuple(None if t is None else w_pl for t in norms)
        + (tuple(k_cache.placements), tuple(v_cache.placements)),
        (sd.pl(dm, (bs, None, kvs)),))


def gqa_decode(x, p, cfg: ArchConfig, cache: Tuple, pos):
    """x: (B, 1, D); cache (k,v): (B, Hkv, S, dh) with `pos` filled."""
    b = x.shape[0]
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    k_cache, v_cache = cache
    q = sd.mm("bsd,dhk->bshk", x, p["wq"])
    k = sd.mm("bsd,dhk->bshk", x, p["wk"])
    v = sd.mm("bsd,dhk->bshk", x, p["wv"])
    window = cfg.local_window if cfg.attention == "local" else 0
    if sd.is_dtensor(k_cache):
        o = _decode_island(q, k, v, _gqa_norms(p, cfg), k_cache, v_cache,
                           cfg, pos, window)
        return sd.mm("bse,ed->bsd", o, p["wo"]), (k_cache, v_cache)
    q, k, v = _gqa_rope(q, k, v, *_gqa_norms(p, cfg), cfg,
                        _positions(b, pos, x.device))
    k_cache[:, :, pos] = k[:, :, 0]
    v_cache[:, :, pos] = v[:, :, 0]
    o = decode_attention(q, k_cache, v_cache, cur_pos=pos, window=window)
    o = o.transpose(1, 2).reshape(b, 1, h * dh)
    return sd.mm("bse,ed->bsd", o, p["wo"]), (k_cache, v_cache)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# ---------------------------------------------------------------------------

def _mla_qkv_proj(x, p, cfg: ArchConfig):
    """The projections of x (B,S,D): per-head q (B,S,H,dn+dr) before
    RoPE and the raw latent kv (B,S,kvl+dr)."""
    q_lat = rmsnorm(sd.mm("bsd,dr->bsr", x, p["wq_a"]), p["q_norm"],
                    cfg.norm_eps)
    q = sd.mm("bsr,rhk->bshk", q_lat, p["wq_b"])            # (B,S,H,dn+dr)
    kv = sd.mm("bsd,dr->bsr", x, p["wkv_a"])                # (B,S,kvl+dr)
    return q, kv


def _mla_rope(q, kv, kv_norm, cfg: ArchConfig, positions):
    """RoPE on q's rope part; the latent: kv's normed part and its
    rope'd shared k_rope -> (q, latent (B,S,kvl+dr))."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    cos, sin = rope_angles(positions, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    kv_lat = rmsnorm(kv[..., :cfg.kv_lora_rank], kv_norm, cfg.norm_eps)
    k_rope = kv[..., cfg.kv_lora_rank:][..., None, :]       # (B,S,1,dr)
    k_rope = apply_rope(k_rope, cos, sin)[..., 0, :]        # (B,S,dr)
    latent = torch.cat([kv_lat, k_rope], dim=-1)
    return torch.cat([q_nope, q_rope], dim=-1), latent


def _mla_qkv(x, p, cfg: ArchConfig, positions):
    """Project to per-head q (nope+rope) and latent; returns q, latent."""
    q, kv = _mla_qkv_proj(x, p, cfg)
    return _mla_rope(q, kv, p["kv_norm"], cfg, positions)


def _mla_heads(q, latent, wkv_b, cfg: ArchConfig):
    """(q, k, v) with heads before the sequence: q (B,Sq,H,dn+dr); the
    latent expanded through wkv_b into per-head k (nope + shared rope) and
    v over its Skv slots."""
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kvl = cfg.kv_lora_rank
    kv_lat, k_rope = latent[..., :kvl], latent[..., kvl:]
    kvb = wkv_b.reshape(kvl, h, dn + dv)
    k_nope = torch.einsum("bsr,rhk->bshk", kv_lat, kvb[..., :dn])
    v = torch.einsum("bsr,rhk->bshk", kv_lat, kvb[..., dn:])
    k_rope_h = k_rope[:, :, None, :].expand(k_rope.shape[:2] + (h, dr))
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _mla_attend(q, latent, p, cfg: ArchConfig, cur_pos=None):
    """q (B,Sq,H,dn+dr); latent (B,Skv,kvl+dr) -> (B,Sq,H*dv)."""
    h, dv = cfg.n_heads, cfg.v_head_dim
    qh, kh, vh = _mla_heads(q, latent, p["wkv_b"], cfg)
    sq = q.shape[1]
    if sq == 1:
        o = decode_attention(qh, kh, vh, cur_pos=cur_pos)
    else:
        o = flash_attention(qh, kh, vh, causal=True, chunk=min(1024, sq))
    b = q.shape[0]
    return o.transpose(1, 2).reshape(b, sq, h * dv)


def _mla_island(q, kv, kv_norm, wkv_b, cfg: ArchConfig):
    """MLA train/prefill on each rank's block: q (B,S,H,dn+dr) with heads
    over `model` where they split, kv (B,S,kvl+dr) and kv_norm whole,
    wkv_b's heads as q's. -> (o (B,S,H*dv), latent (B,S,kvl+dr))."""
    dm = q.device_mesh
    b, h = q.shape[0], q.shape[2]
    m = sd.model_size(dm)
    bs = sd.batch_entry(dm, b)
    hs = "model" if m > 1 and h % m == 0 else None
    ws, ms = tuple(bs or ()), (("model",) if hs else ())

    def local(ql, kvl_, kn, wb):
        lcfg = dataclasses.replace(cfg, n_heads=ql.shape[2])
        ql, latent = _mla_rope(ql, kvl_, kn, lcfg,
                               _seq_positions(ql.shape[0], ql.shape[1],
                                              ql.device))
        return _mla_attend(ql, latent, {"wkv_b": wb}, lcfg), latent

    q_pl = sd.pl(dm, (bs, None, hs, None))
    return sd.island(
        local, dm, (q, kv, kv_norm, wkv_b),
        (q_pl, sd.pl(dm, (bs, None, None)), sd.pl(dm, ()),
         sd.pl(dm, (None, hs))),
        (sd.pl(dm, (bs, None, hs)), sd.pl(dm, (bs, None, None))),
        (q_pl, sd.pl(dm, (bs, None, None), ms), sd.pl(dm, (), ws + ms),
         sd.pl(dm, (None, hs), ws)))


def mla_forward(x, p, cfg: ArchConfig, positions):
    """x (B, S, D) -> (out (B, S, D), latent (B, S, kv_lora + qk_rope))."""
    q, kv = _mla_qkv_proj(x, p, cfg)
    if sd.is_dtensor(q):
        o, latent = _mla_island(q, kv, p["kv_norm"], p["wkv_b"], cfg)
    else:
        q, latent = _mla_rope(q, kv, p["kv_norm"], cfg, positions)
        o = _mla_attend(q, latent, p, cfg)
    return sd.mm("bse,ed->bsd", o, p["wo"]), latent


def _mla_decode_island(q, kv, kv_norm, wkv_b, latent_cache,
                       cfg: ArchConfig, pos: int):
    """MLA decode on each rank's block of the latent cache (B, S, lat):
    the new latent written in place at `pos` by the rank holding that
    slot. Where the cache's sequence splits over `model`, every head
    attends over the rank's own slots (q and wkv_b whole); otherwise the
    heads split over `model` as in the forward. -> o (B, 1, H * dv)."""
    dm = q.device_mesh
    spec = sd.spec_of(latent_cache)
    bs = spec[0]
    seq_split = sd.splits(spec[1], "model")
    m, h = sd.model_size(dm), q.shape[2]
    hs = "model" if not seq_split and m > 1 and h % m == 0 else None

    def local(ql, kvl_, kn, wb, lc):
        bl = ql.shape[0]
        lcfg = dataclasses.replace(cfg, n_heads=ql.shape[2])
        ql, latent = _mla_rope(ql, kvl_, kn, lcfg,
                               _positions(bl, pos, ql.device))
        s_l = lc.shape[1]
        off = _seq_owner(dm, seq_split, s_l)
        if off <= pos < off + s_l:
            lc[:, pos - off] = latent[:, 0]
        if not seq_split:
            return _mla_attend(ql, lc, {"wkv_b": wb}, lcfg, cur_pos=pos)
        qh, kh, vh = _mla_heads(ql, lc, wb, lcfg)
        slots = off + torch.arange(s_l, device=ql.device)
        s = _decode_scores(qh, kh, slots, pos, 0)
        o = _combine_decode(dm, s, vh, True)
        return o.reshape(bl, lcfg.n_heads, 1, vh.shape[-1]).transpose(
            1, 2).reshape(bl, 1, lcfg.n_heads * cfg.v_head_dim)

    return sd.island(
        local, dm, (q, kv, kv_norm, wkv_b, latent_cache),
        (sd.pl(dm, (bs, None, hs, None)), sd.pl(dm, (bs, None, None)),
         sd.pl(dm, ()), sd.pl(dm, (None, hs)),
         tuple(latent_cache.placements)),
        (sd.pl(dm, (bs, None, hs)),))


def mla_decode(x, p, cfg: ArchConfig, latent_cache, pos):
    """latent_cache: (B, S_max, kv_lora+qk_rope)."""
    b = x.shape[0]
    if sd.is_dtensor(latent_cache):
        q, kv = _mla_qkv_proj(x, p, cfg)
        o = _mla_decode_island(q, kv, p["kv_norm"], p["wkv_b"],
                               latent_cache, cfg, pos)
        return sd.mm("bse,ed->bsd", o, p["wo"]), latent_cache
    q, latent = _mla_qkv(x, p, cfg, _positions(b, pos, x.device))
    latent_cache[:, pos] = latent[:, 0]
    o = _mla_attend(q, latent_cache, p, cfg, cur_pos=pos)
    return sd.mm("bse,ed->bsd", o, p["wo"]), latent_cache
