"""Gradient compression for the slow (`pod`) axis: int8 quantization with
error feedback. The port of ``repro.train.compress``.

Only the cross-pod all-reduce is compressed (4x fewer bytes in
bf16 -> int8). Error feedback carries the quantization residual into the
next step. Each rank of the `pod` axis holds its own pod's partial
gradient; the reference's pmax and psum over the axis are all-reduces
(max, then sum) on the port's `launch.mesh.Mesh`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.model import tree_items, tree_map, tree_unflatten

F32 = torch.float32


def quantize_int8(x) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x.to(F32))) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x.to(F32) / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(F32) * scale


def compressed_psum_body(g, err, mesh, axis: str):
    """Int8 all-reduce over `axis` with error feedback, on one rank.

    g, err: (1, ...) — this pod's partial gradient + carried residual.
    Returns (reduced_mean (...), new_err (1, ...)).

    Per-pod scales can't be summed directly; the global max scale is agreed
    with one scalar all-reduce (max), payloads are requantized against it,
    and the int8 payload is summed exactly in int32."""
    n = mesh.axis_size(axis)
    corrected = g[0].to(F32) + err[0]
    _, scale = quantize_int8(corrected)
    gmax = mesh.all_reduce_max(scale.clone(), axis)
    q = torch.clamp(torch.round(corrected / gmax), -127, 127).to(torch.int8)
    new_err = corrected - q.to(F32) * gmax
    summed = mesh.all_reduce_sum(q.to(torch.int32), axis)
    return (summed.to(F32) * gmax / n).to(g.dtype), new_err[None]


def compressed_pod_mean(per_pod_grads, err_tree, mesh, axis: str = "pod"):
    """Compressed all-reduce-mean over `axis`.

    Each leaf of `per_pod_grads` carries a leading pod dimension holding
    this rank's pod (size 1); err leaves match. Returns (mean grads
    without the pod dim, new err tree with it)."""
    errs = dict(tree_items(err_tree))
    paths = [path for path, _ in tree_items(per_pod_grads)]
    outs = [compressed_psum_body(g, errs[path], mesh, axis)
            for path, g in tree_items(per_pod_grads)]
    return (tree_unflatten(paths, [o[0] for o in outs]),
            tree_unflatten(paths, [o[1] for o in outs]))


def init_error_feedback(grads_like):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=F32,
                                          device=g.device), grads_like)
