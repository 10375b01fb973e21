"""Slot packing of ResNet-20's first stage for `workloads.
make_resnet20_stage`: images into slot vectors and back, and a stage's
weights, folded batch norms, zero-padding masks and activations into the
named plaintext diagonals its program multiplies and adds.

Channel-major (Lee et al., ICML 2022): pixel (i, j) of channel c at slot
c hw^2 + hw i + j; the C hw^2 values are written twice, filling 2 C hw^2
slots, so a rotation by d hw^2 brings channel (c + d) mod C to channel c.
The diagonal of tap (ky, kx) and channel offset d holds, at channel c's
pixel (i, j),

    w[c, (c + d) mod C, ky, kx] * s[c] * [pixel (i + ky - 1, j + kx - 1)
                                          lies inside the map]

with s the folded batch norm's scale; the mask zeroes the taps that a
rotation brings in from a neighbouring row or channel, which is the
convolution's zero padding. The bias diagonal holds the folded batch
norm's bias, each activation coefficient its channel's value.

Blocks are given as `examples/resnet20_plain.random_params` gives them:
a dict a block of `w1`, `w2` (C, C, 3, 3), `bn1`, `bn2` (4, C: gamma,
beta, mean, variance) and `act1`, `act2` (3, C: a, b, e).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.runtime.workloads import conv_weight_name

BN_EPS = 1e-5


def pack(maps: np.ndarray) -> np.ndarray:
    """(N, C, H, W) -> (N, 2 C H W) slot vectors."""
    flat = np.asarray(maps, dtype=np.float64).reshape(len(maps), -1)
    return np.concatenate([flat, flat], axis=1)


def unpack(slots: np.ndarray, channels: int, hw: int) -> np.ndarray:
    """(N, 2 C H W) slot vectors -> (N, C, H, W), from the first copy."""
    n = channels * hw * hw
    return np.real(np.asarray(slots))[:, :n].reshape(-1, channels, hw, hw)


def _twice(per_slot: np.ndarray) -> np.ndarray:
    flat = per_slot.reshape(-1)
    return np.concatenate([flat, flat])


def _broadcast(per_channel: np.ndarray, hw: int) -> np.ndarray:
    v = np.asarray(per_channel, dtype=np.float64)
    return _twice(np.broadcast_to(v[:, None, None], (len(v), hw, hw)))


def fold_bn(bn: np.ndarray):
    """(scale, bias), each (C,), of a batch norm at inference."""
    gamma, beta, mean, var = (np.asarray(r, dtype=np.float64) for r in bn)
    s = gamma / np.sqrt(var + BN_EPS)
    return s, beta - s * mean


def conv_consts(conv: str, weight: np.ndarray, bn: np.ndarray,
                hw: int) -> Dict[str, np.ndarray]:
    """The 9 C tap diagonals and the bias of one convolution with its
    batch norm folded in."""
    w = np.asarray(weight, dtype=np.float64)
    c = w.shape[0]
    scale, bias = fold_bn(bn)
    rows = np.arange(hw)
    out = {}
    for ky in range(3):
        r_in = (rows + ky - 1 >= 0) & (rows + ky - 1 < hw)
        for kx in range(3):
            c_in = (rows + kx - 1 >= 0) & (rows + kx - 1 < hw)
            mask = (r_in[:, None] & c_in[None, :]).astype(np.float64)
            for d in range(c):
                tap = w[np.arange(c), (np.arange(c) + d) % c, ky, kx] * scale
                out[conv_weight_name(conv, d, ky, kx)] = _twice(
                    tap[:, None, None] * mask[None])
    out[f"{conv}.bias"] = _broadcast(bias, hw)
    return out


def act_consts(name: str, coeffs: np.ndarray, hw: int
               ) -> Dict[str, np.ndarray]:
    """a, b and e of h(y) = a y^2 + b y + e, each broadcast over its
    channel's slots."""
    return {f"{name}.{k}": _broadcast(v, hw) for k, v in zip("abe", coeffs)}


def stage_consts(blocks: List[Dict[str, np.ndarray]], hw: int
                 ) -> Dict[str, np.ndarray]:
    """Every constant `workloads.resnet20_consts` names, for `blocks`."""
    out: Dict[str, np.ndarray] = {}
    for k, p in enumerate(blocks):
        for j in (1, 2):
            out.update(conv_consts(f"b{k}.c{j}", p[f"w{j}"], p[f"bn{j}"],
                                   hw))
            out.update(act_consts(f"b{k}.h{j}", p[f"act{j}"], hw))
    return out
