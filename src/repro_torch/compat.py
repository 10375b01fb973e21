"""A device-less mesh for spec resolution and dry runs.

The PyTorch counterpart of ``repro.compat``, whose other four shims wrap
jax APIs that moved between versions and have no meaning without jax.
Their counterparts in the port:

* ``make_mesh`` -> ``launch.mesh.Mesh`` (named axes over the ranks of a
  ``torch.distributed`` group; ``make_host_mesh`` starts one of world
  size 1);
* ``axis_size`` -> ``Mesh.axis_size(axis)``;
* ``shard_map`` and ``set_mesh`` -> none: the port's distributed layers
  take their mesh as an explicit argument and run per rank.

``abstract_mesh`` is the reference's ``jax.sharding.AbstractMesh``: axis
names and sizes with no devices behind them. ``sharding.rules`` resolves
specs on it and ``launch.specs.build_cell`` lays cells out on it, as on a
``launch.mesh.Mesh``: both carry ``axis_names`` and ``shape`` (name ->
size).

``fake_process_group`` is the counterpart of the reference's placeholder
host devices (``--xla_force_host_platform_device_count``): a default
process group of N ranks in this one process, whose collectives move no
data, so a ``launch.mesh.Mesh`` of the production shape can lay a step
out on meta tensors. It wraps a private PyTorch module
(``torch.testing._internal.distributed.fake_pg``), which is why it lives
here and nowhere else.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Sequence, Tuple

import torch


class AbstractMesh:
    """Named axis sizes with no devices or process group behind them."""

    def __init__(self, sizes: Sequence[int], names: Sequence[str]):
        if len(sizes) != len(names):
            raise ValueError(f"mesh sizes {tuple(sizes)} against axes "
                             f"{tuple(names)}")
        self.axis_names: Tuple[str, ...] = tuple(names)
        self.shape: Dict[str, int] = dict(zip(names, (int(s) for s in sizes)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def all_to_all(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """What `launch.mesh.Mesh.all_to_all` returns, where that needs
        no data to move: along an axis of one rank every block stays, so a
        one-rank step (the dry run's count, meta tensors included) runs the
        MoE layers' all_to_all schedule. More ranks raise: nothing moves
        data between the ranks of a device-less mesh."""
        if self.shape[axis] != 1:
            raise ValueError(f"a device-less mesh exchanges no data: axis "
                             f"{axis!r} has {self.shape[axis]} ranks")
        return t


def abstract_mesh(sizes: Sequence[int], names: Sequence[str]) -> AbstractMesh:
    """Device-less mesh for spec resolution (tests, dry runs)."""
    return AbstractMesh(sizes, names)


@contextlib.contextmanager
def fake_process_group(world_size: int) -> Iterator[None]:
    """A default process group of `world_size` ranks, this process rank 0,
    whose collectives return without moving data; destroyed on exit. It
    must be the default group, so no other group may be initialised in
    this process: the dry run starts it in a process of its own."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised in this "
                           "process; the fake group must be the default one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


__all__ = ["AbstractMesh", "abstract_mesh", "fake_process_group"]
