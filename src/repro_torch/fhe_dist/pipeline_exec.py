"""Distributed load-save pipeline executor (paper §IV-F on a mesh).

Maps the PipelineSchedule from core/pipeline.py onto the `data` mesh
axis: each data rank hosts one resident stage per round (its constants
stay on the device for the whole input batch: the "load once per round"
property), and microbatches flow rank to rank through a ring shift,
GPipe-style.

Stage bodies must be shape-preserving (ciphertexts padded to the round's
max limb count: the standard trick for level-heterogeneous pipelines;
the mapper already levels stages within a round). Each rank runs its own
stage, `stage_fns[rank]`, so a round is one program on every rank with a
rotating neighbour send: the paper's Figure 11 timing structure.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from repro_torch.launch.mesh import Mesh


def run_pipeline_round(stage_fns: Sequence[Callable], x_stack: torch.Tensor,
                       mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """Execute one pipeline round of len(stage_fns) stages over the
    microbatch stack x_stack (n_micro, ...), whole on every rank.
    len(stage_fns) must equal the `axis` size. Returns the processed
    stack on every rank.

    Step t: rank r applies its stage to the microbatch that has passed
    ranks 0..r-1; the buffer shifts r -> r+1 each step. After n_micro +
    n_ranks - 1 steps rank n-1 has emitted every microbatch into its
    output stack, which a sum over the axis (zeros elsewhere: exact)
    brings to every rank.
    """
    n_dev = mesh.axis_size(axis)
    if len(stage_fns) != n_dev:
        raise ValueError(f"{len(stage_fns)} stages for the {n_dev} ranks "
                         f"of mesh axis {axis!r}")
    rank = mesh.axis_index(axis)
    stage = stage_fns[rank]
    n_micro = x_stack.shape[0]
    buf = torch.zeros_like(x_stack[0])
    out_stack = torch.zeros_like(x_stack)
    n_steps = n_micro + n_dev - 1
    for t in range(n_steps):
        if rank == 0 and t < n_micro:              # rank 0 injects
            buf = x_stack[t]
        buf = stage(buf)
        done_idx = t - (n_dev - 1)                 # the last rank collects
        if rank == n_dev - 1 and 0 <= done_idx < n_micro:
            out_stack[done_idx] = buf
        if t != n_steps - 1:
            buf = mesh.ring_shift(buf, axis)
    return mesh.all_reduce_sum(out_stack, axis)


def run_load_save_pipeline(rounds: List[Sequence[Callable]],
                           x_stack: torch.Tensor, mesh: Mesh,
                           axis: str = "data") -> torch.Tensor:
    """Full load-save execution: rounds run sequentially; within a round
    the batch streams through the resident stages (constants loaded once:
    the stage functions close over them, on the device)."""
    for fns in rounds:
        x_stack = run_pipeline_round(fns, x_stack, mesh, axis)
    return x_stack


__all__ = ["run_pipeline_round", "run_load_save_pipeline"]
