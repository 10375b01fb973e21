"""Device meshes over `torch.distributed`.

A `Mesh` names the axes of the default process group's ranks, laid out
row-major (the last axis fastest), and holds one process group per axis
for the line of ranks this rank sits on. It is what the distributed
layers (`repro_torch.fhe_dist`, the `mesh` serving backend) address:
`axis_size`, `axis_index`, the ring neighbours along an axis, and the
collectives they need along one axis.

`make_host_mesh` reuses an initialised default group and otherwise
starts one of world size 1 in this process (``nccl`` for CUDA, ``gloo``
for the CPU) through a file store under ``build/``. Several ranks are
started by the caller (one process each) with ``init_process_group``
before the mesh is built; every rank then builds the same mesh, since
``new_group`` is collective.

`make_production_mesh` gives the production layout's shape and axes
only: it builds nothing, so it is safe on a machine of one card.
`fake_production_mesh` builds that layout as a `Mesh` over a fake
process group of 256 or 512 ranks (`compat.fake_process_group`), on meta
tensors: the dry run lays the partitioned step out on it.

Each `Mesh` also carries its `torch.distributed.device_mesh.DeviceMesh`
(`device_mesh`, made on first use: the same ranks, row-major, the same
axis names), on which the partitioned LLM step lays its DTensors out.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import os
import uuid
from datetime import timedelta
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.context import DeviceLike, resolve_device

STORE_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch" / \
    "dist"
# how long a collective of the in-process group waits before it fails
LOCAL_TIMEOUT = timedelta(seconds=60)


class Mesh:
    """Named axes over the ranks of the default process group."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device: torch.device, device_type: Optional[str] = None):
        """`device_type` is the DeviceMesh's ("cuda" or "cpu"): the
        device's own by default; a mesh on meta tensors names the device
        the ranks stand for."""
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} against axes "
                             f"{tuple(axis_names)}")
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"mesh {dict(zip(axis_names, shape))} needs "
                             f"{math.prod(shape)} ranks; the process group "
                             f"has {world}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.device = device
        self.device_type = device_type or device.type
        self._device_mesh = None
        self.rank = dist.get_rank()
        self.coords: Tuple[int, ...] = self.coords_of(self.rank)
        # one group per axis line; new_group is collective, so every rank
        # creates every line's group in the same order and keeps its own
        self._groups: Dict[str, Optional[dist.ProcessGroup]] = {}
        self._lines: Dict[str, List[int]] = {}
        for axis in self.axis_names:
            for line in self._axis_lines(axis):
                # a line of every rank is the default group itself
                group = (None if len(line) == world
                         else dist.new_group(line))
                if self.rank in line:
                    self._groups[axis], self._lines[axis] = group, line

    def coords_of(self, rank: int) -> Tuple[int, ...]:
        out = []
        for axis in reversed(self.axis_names):
            rank, c = divmod(rank, self.shape[axis])
            out.append(c)
        return tuple(reversed(out))

    def rank_of(self, coords: Sequence[int]) -> int:
        r = 0
        for axis, c in zip(self.axis_names, coords):
            r = r * self.shape[axis] + c
        return r

    def _axis_lines(self, axis: str) -> List[List[int]]:
        k = self.axis_names.index(axis)
        others = [range(self.shape[a]) for a in self.axis_names if a != axis]
        lines = []
        for rest in (list(t) for t in itertools.product(*others)):
            lines.append([self.rank_of(rest[:k] + [i] + rest[k:])
                          for i in range(self.shape[axis])])
        return lines

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def device_mesh(self):
        """The DeviceMesh of these ranks and axes (row-major, as `Mesh`).
        Made on first use; making it is collective, as `new_group` is."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh
            ranks = torch.arange(self.size).reshape(
                tuple(self.shape[a] for a in self.axis_names))
            self._device_mesh = DeviceMesh(self.device_type, ranks,
                                           mesh_dim_names=self.axis_names)
        return self._device_mesh

    # -- coordinates ---------------------------------------------------------

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def peer(self, axis: str, offset: int) -> int:
        """Global rank `offset` steps along `axis` (mod its size)."""
        line = self._lines[axis]
        return line[(self.axis_index(axis) + offset) % len(line)]

    # -- collectives along one axis -------------------------------------------

    def ring_shift(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Send `t` to the next rank along `axis` and return what the
        previous one sent (a ring permutation i -> i + 1). A rank alone on
        its axis keeps a copy: no send to itself."""
        if self.shape[axis] == 1:
            return t.clone()
        t = t.contiguous()
        out = torch.empty_like(t)
        group = self._groups[axis]
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, self.peer(axis, 1), group),
            dist.P2POp(dist.irecv, out, self.peer(axis, -1), group)])
        for r in reqs:
            r.wait()
        return out

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The blocks of every rank along `axis`, stacked in rank order
        along dim 0."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.shape[axis])]
        dist.all_gather(parts, t, group=self._groups[axis])
        return torch.cat(parts, 0)

    def broadcast(self, t: torch.Tensor, axis: str, index: int
                  ) -> torch.Tensor:
        """The `t` of the rank at `index` along `axis`, on every rank of
        the line; the others pass a tensor of the same shape and dtype to
        receive into."""
        if self.shape[axis] == 1:
            return t
        t = t.contiguous()
        dist.broadcast(t, src=self._lines[axis][index],
                       group=self._groups[axis])
        return t

    def all_reduce_sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self._groups[axis])
        return t

    def all_reduce_max(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._groups[axis])
        return t

    def all_to_all(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Split dim 0 of `t` into one block a rank along `axis`; send
        block j to rank j and return, in the same shape, the blocks
        received, in rank order. Differentiable: its gradient is the same
        exchange of the output's gradient."""
        if t.shape[0] % self.shape[axis]:
            raise ValueError(f"dim 0 of {tuple(t.shape)} does not split "
                             f"over {self.shape[axis]} ranks")
        return _AllToAll.apply(t, self._groups[axis])


def _exchange(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """all_to_all as a linear map: block (i -> j) of the input becomes
    block (j <- i) of the output, a permutation that is its own
    transpose, so the backward pass is the same exchange."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _exchange(t, group)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group), None


def _init_local_group(device: torch.device) -> None:
    """A process group of world size 1 in this process, through a file
    store under build/ (no TCP port; the store removes its file when the
    group is destroyed); nccl for CUDA, gloo otherwise."""
    STORE_DIR.mkdir(parents=True, exist_ok=True)
    store = STORE_DIR / f"pg-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    dist.init_process_group(
        backend="nccl" if device.type == "cuda" else "gloo",
        init_method=f"file://{store}", world_size=1, rank=0,
        timeout=LOCAL_TIMEOUT)


def make_host_mesh(data: int = 1, model: int = 1,
                   device: DeviceLike = None) -> Mesh:
    """A (data, model) mesh over this host's process group on `device`
    (CUDA unless the caller asks for the CPU). An initialised default
    group is reused, never re-made; without one, a group of world size 1
    is started here."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        _init_local_group(dev)
    return Mesh((data, model), ("data", "model"), dev)


def make_production_mesh(*, multi_pod: bool = False
                         ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The production layout's (shape, axis names): one pod of 16 x 16 =
    256 chips (data, model), or 2 pods x 256 with a leading `pod` axis
    (the slow axis: only gradient compression and pure data parallelism
    cross it). Shapes only; pass them to `Mesh` over a process group of
    that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


@contextlib.contextmanager
def fake_production_mesh(*, multi_pod: bool = False) -> Iterator[Mesh]:
    """The production layout as a `Mesh` of 256 (or 512) ranks over a fake
    process group started here and destroyed on exit: its tensors are
    meta tensors, its DeviceMesh stands for H100s ("cuda"), and its
    collectives move nothing. The counterpart of the reference's
    placeholder host devices; the process must hold no other group."""
    from repro_torch.compat import fake_process_group
    shape, axes = make_production_mesh(multi_pod=multi_pod)
    with fake_process_group(math.prod(shape)):
        yield Mesh(shape, axes, torch.device("meta"), device_type="cuda")


__all__ = ["Mesh", "fake_production_mesh", "make_host_mesh",
           "make_production_mesh"]
