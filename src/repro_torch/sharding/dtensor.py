"""DTensor plumbing of the partitioned LLM step.

The reference jits its step over a (data, model) or (pod, data, model)
mesh and lets XLA's SPMD partitioner (GSPMD) lay every intermediate out
from the parameters' and the batch's NamedShardings. The port's
counterpart is DTensor: parameters, optimizer state, batch and caches
are DTensors laid out by the specs of `sharding.rules` (`distribute`),
and DTensor's sharding propagation lays out what the step computes from
them.

Where the reference runs a block on each device's own shards (its
shard_map bodies: the MoE layer), or where the block writes a cache in
place or builds index tensors, the port runs an *island* (`island`): the
inputs are redistributed to the placements the island names, the block
runs on their local tensors, and its outputs become DTensors again. An
island names, for each input, the placement its gradient takes: a weight
that every rank of a data axis uses on its own tokens gets a gradient
that is a partial sum over that axis (`Partial`), which DTensor's
autograd reduces into the weight's own layout.

Placements are written as specs (`sharding.rules`' tuples: one entry a
tensor dim, None or a mesh axis or a tuple of them) plus the mesh axes
over which the value is a partial sum (`pl`).

The step's products with a weight (`mm`), its embedding lookup
(`embedding`) and its cross entropy (`cross_entropy`) are islands too,
with the layouts the reference's specs give: the batch over the data
axes; a weight gathered over the data axes (its FSDP split) and split
over `model` as its spec splits it, so a product is column-parallel
(output split over `model`) or row-parallel (a partial sum over `model`,
all-reduced at once). DTensor's own einsum, a mm between views, can
split the flattened (heads x head_dim) or (batch x seq) dim so unevenly
that the view back fails ("Cannot unflatten unevenly sharded tensor"),
and its vocab-split gather (`_MaskPartial`) failed on the MTP head's
shifted logits in torch 2.13: the islands fix both layouts.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.sharding.rules import placements as spec_placements


def is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def axis_names(dm) -> Tuple[str, ...]:
    return tuple(dm.mesh_dim_names)


def dp_axes(dm) -> Tuple[str, ...]:
    """The data-parallel axes of a DeviceMesh (or Mesh), in mesh order."""
    names = getattr(dm, "axis_names", None) or axis_names(dm)
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(dm, axis: str) -> int:
    return dm.size(axis_names(dm).index(axis))


def model_size(dm) -> int:
    """The size of the `model` axis of a DeviceMesh (1 where it has none)."""
    return axis_size(dm, "model") if "model" in axis_names(dm) else 1


def axis_index(dm, axis: str) -> int:
    """This rank's coordinate along `axis`."""
    return dm.get_local_rank(axis)


def pl(dm, spec: Sequence = (), partial: Sequence[str] = ()) -> tuple:
    """Placements on DeviceMesh `dm` of `spec` (missing trailing entries
    replicate), with Partial (sum) on the axes in `partial`, which the
    spec must leave free."""
    out = list(spec_placements(dm, tuple(spec)))
    for a in partial:
        i = axis_names(dm).index(a)
        if not isinstance(out[i], Replicate):
            raise ValueError(f"axis {a!r} both splits and sums {spec}")
        out[i] = Partial()
    return tuple(out)


def distribute(t: torch.Tensor, mesh, spec) -> DTensor:
    """`t`, the whole tensor (the same on every rank), as a DTensor laid
    out by `spec` on `mesh` (a launch.mesh.Mesh): each rank keeps its own
    block, cut locally, so nothing moves between ranks. A meta tensor
    gives a meta DTensor (the dry run's)."""
    dm = mesh.device_mesh
    placements = spec_placements(mesh, spec)
    local = t
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            local = local.chunk(dm.size(i), dim=p.dim)[mesh.coords[i]]
    return DTensor.from_local(local.contiguous(), dm, placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def splits(entry, axis: str) -> bool:
    """Whether a spec entry splits its dim over `axis`."""
    return entry is not None and axis in (
        entry if isinstance(entry, tuple) else (entry,))


def spec_of(t: DTensor) -> tuple:
    """The spec of a DTensor's layout (the inverse of rules.placements)."""
    entries = [()] * t.dim()
    for name, p in zip(axis_names(t.device_mesh), t.placements):
        if isinstance(p, Shard):
            entries[p.dim] = entries[p.dim] + (name,)
        elif not isinstance(p, Replicate):
            raise ValueError(f"{p} has no spec")
    return tuple(None if not e else e[0] if len(e) == 1 else e
                 for e in entries)


def constrain(t: DTensor, placements) -> DTensor:
    """`t` redistributed to `placements` (the reference's
    with_sharding_constraint); no-op where it is laid out so already."""
    if tuple(t.placements) == tuple(placements):
        return t
    return t.redistribute(t.device_mesh, placements)


def island(fn: Callable, dm, args: Sequence, in_pl: Sequence,
           out_pl: Sequence, grad_pl: Optional[Sequence] = None):
    """fn(*local blocks) -> its outputs as DTensors on `dm`.

    in_pl[i] is the placement args[i] is redistributed to before its local
    block is taken (None: the argument passes as it is); grad_pl[i] the
    placement of its gradient (in_pl[i] by default). out_pl gives one
    placement for each output of fn (a tensor or a tuple of tensors;
    None: an output that is not a tensor, returned as it is)."""
    grad_pl = grad_pl or in_pl
    local = []
    for a, p, g in zip(args, in_pl, grad_pl, strict=True):
        if p is None:
            local.append(a)
            continue
        a = constrain(a, p)
        local.append(a.to_local(grad_placements=g))
    outs = fn(*local)
    single = not isinstance(outs, tuple)
    outs = (outs,) if single else outs
    wrapped = tuple(
        o if p is None else DTensor.from_local(o, dm, p, run_check=False)
        for o, p in zip(outs, out_pl, strict=True))
    return wrapped[0] if single else wrapped


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, factor: float):
        ctx.factor = factor
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.factor, None


def scale_grad(t: torch.Tensor, factor: float) -> torch.Tensor:
    """`t` itself, whose gradient is multiplied by `factor`."""
    return _ScaleGrad.apply(t, factor)


class _AllReduce(torch.autograd.Function):
    """Sum over a group, forward; identity backward (the sum is the same
    on every rank of the group, so each summand's gradient is the sum's)."""

    @staticmethod
    def forward(ctx, t, group):
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def psum(t: torch.Tensor, dm, axis: str) -> torch.Tensor:
    """`t` summed over the ranks of `dm` along `axis` (differentiable)."""
    if axis_size(dm, axis) == 1:
        return t
    return _AllReduce.apply(t, dm.get_group(axis))


def all_max(t: torch.Tensor, dm, axis: str) -> torch.Tensor:
    """The elementwise max of `t` over `axis` (no gradient)."""
    t = t.detach().clone()
    if axis_size(dm, axis) > 1:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=dm.get_group(axis))
    return t


def model_split(t: DTensor) -> Optional[int]:
    """The dim of `t` split over `model`, or None."""
    names = axis_names(t.device_mesh)
    if "model" not in names:
        return None
    p = t.placements[names.index("model")]
    return p.dim if isinstance(p, Shard) else None


def batch_entry(dm, b: int):
    """A batch dim's spec entry: the data axes, where they divide it."""
    dp = dp_axes(dm)
    n = math.prod(axis_size(dm, a) for a in dp)
    return dp if dp and b % n == 0 else None


def mm(eq: str, x, w):
    """torch.einsum(eq, x, w) of activations x (batch first) and a weight
    w. On DTensors, an island: x's batch over the data axes, w gathered
    over them and split over `model` as its layout splits it. A split
    output letter makes a column-parallel product (the output split over
    `model`, x's gradient a partial sum over it); a split contracted
    letter a row-parallel one (x split along it, the partial products
    all-reduced over `model`)."""
    if not is_dtensor(x):
        return torch.einsum(eq, x, w)
    dm = x.device_mesh
    ins, out = eq.split("->")
    xl, wl = ins.split(",")
    bs = batch_entry(dm, x.shape[0])
    x_spec, w_spec = [None] * len(xl), [None] * len(wl)
    out_spec = [None] * len(out)
    x_spec[0] = out_spec[out.index(xl[0])] = bs
    x_partial = out_partial = ()
    k = model_split(w)
    if k is not None:
        c = wl[k]
        w_spec[k] = "model"
        if c in out:                                   # column-parallel
            out_spec[out.index(c)] = "model"
            x_partial = ("model",)
        else:                                          # row-parallel
            x_spec[xl.index(c)] = "model"
            out_partial = ("model",)
    y = island(lambda a, b: torch.einsum(eq, a, b), dm, (x, w),
               (pl(dm, x_spec), pl(dm, w_spec)),
               (pl(dm, out_spec, out_partial),),
               (pl(dm, x_spec, x_partial), pl(dm, w_spec, tuple(bs or ()))))
    return constrain(y, pl(dm, out_spec)) if out_partial else y


def embedding(tokens, table):
    """F.embedding(tokens, table). On DTensors, the vocab-split lookup:
    the table gathered over the data axes and split over `model` by rows
    as its layout splits them; each rank looks up the tokens in its rows
    (0 elsewhere) and the rows are summed over `model`."""
    if not is_dtensor(table):
        return F.embedding(tokens, table)
    dm = table.device_mesh
    bs = batch_entry(dm, tokens.shape[0])
    t_spec = (bs,) + (None,) * (tokens.dim() - 1)
    vs = "model" if model_split(table) == 0 else None
    out_spec = t_spec + (None,)

    def local(tok, tab):
        if vs is None:
            return F.embedding(tok, tab)
        lo = axis_index(dm, "model") * tab.shape[0]
        mine = (tok >= lo) & (tok < lo + tab.shape[0])
        rows = F.embedding(torch.where(mine, tok - lo, 0), tab)
        return rows * mine[..., None].to(rows.dtype)

    y = island(local, dm, (tokens, table),
               (pl(dm, t_spec), pl(dm, (vs, None))),
               (pl(dm, out_spec, ("model",) if vs else ()),),
               (pl(dm, t_spec), pl(dm, (vs, None), tuple(bs or ()))))
    return constrain(y, pl(dm, out_spec)) if vs else y


def argmax(logits):
    """torch.argmax(logits, dim=-1). On DTensors whose last dim (the
    vocab) splits over `model`, an island: each rank's best value, its
    max over `model`, and the least global index of a rank whose best is
    that max (torch.argmax's first maximum: the blocks lie in vocab
    order), both reduced over `model`. DTensor's own argmax (torch 2.13)
    fails where a rank's batch block is one row."""
    if not is_dtensor(logits) or model_split(logits) != logits.dim() - 1:
        return torch.argmax(logits, dim=-1)
    dm = logits.device_mesh
    spec = spec_of(logits)

    def local(lg):
        idx = torch.argmax(lg, dim=-1)
        best = torch.gather(lg, -1, idx[..., None])[..., 0]
        top = all_max(best, dm, "model")
        idx = torch.where(best == top,
                          idx + axis_index(dm, "model") * lg.shape[-1],
                          logits.shape[-1])
        if model_size(dm) > 1:
            dist.all_reduce(idx, op=dist.ReduceOp.MIN,
                            group=dm.get_group("model"))
        return idx

    return island(local, dm, (logits,), (pl(dm, spec),),
                  (pl(dm, spec[:-1]),))


def cross_entropy(logits, labels, plain: Callable):
    """The mean over every token of logsumexp(logits) - the label's logit
    (`plain` computes it on plain tensors). On DTensors, an island over
    each rank's tokens and vocab block: the max over the vocab reduced
    over `model` (held constant, as it cancels), the sum of exponentials
    and the label's logit summed over it; each rank's sum over its tokens,
    over the global token count, is a partial sum over the data axes."""
    if not is_dtensor(logits):
        return plain(logits, labels)
    dm = logits.device_mesh
    bs = batch_entry(dm, logits.shape[0])
    vs = "model" if model_split(logits) == logits.dim() - 1 else None
    lg_spec = (bs,) + (None,) * (logits.dim() - 2) + (vs,)
    lab_spec = (bs,) + (None,) * (labels.dim() - 1)
    n_tokens = labels.numel()

    def local(lg, lab):
        lab = lab.long()
        v_l = lg.shape[-1]
        lo = axis_index(dm, "model") * v_l if vs else 0
        mine = (lab >= lo) & (lab < lo + v_l)
        pick = torch.gather(lg, -1, torch.where(mine, lab - lo, 0)[..., None])
        label_logit = torch.where(mine, pick[..., 0].to(torch.float32), 0.0)
        m = lg.amax(-1).to(torch.float32)
        if vs:
            label_logit = psum(label_logit, dm, "model")
            m = all_max(m, dm, "model")
        sumexp = torch.sum(torch.exp(lg.to(torch.float32) - m[..., None]),
                           dim=-1)
        if vs:
            sumexp = psum(sumexp, dm, "model")
        lse = m + torch.log(sumexp)
        return torch.sum(lse - label_logit) / n_tokens

    return island(local, dm, (logits, labels),
                  (pl(dm, lg_spec), pl(dm, lab_spec)),
                  (pl(dm, (), tuple(bs or ())),))


__all__ = ["all_max", "argmax", "axis_index", "axis_size", "batch_entry",
           "constrain", "cross_entropy", "distribute", "dp_axes",
           "embedding", "is_dtensor", "island", "mm", "model_size",
           "model_split", "pl", "psum", "scale_grad", "spec_of", "splits"]
