"""Logical-axis sharding rules (MaxText-style), with divisibility-aware
greedy resolution.

The PyTorch counterpart of ``repro.sharding.rules``. Every parameter and
cache leaf carries a tuple of *logical* axis names; rules map each
logical name to an ordered preference list of mesh axes. Spec resolution
walks dims in a global priority order, assigning the first mesh axis that
(a) is not already used by another dim of the same tensor and (b)
divides the dim size. Non-divisible or exhausted dims replicate.

A spec is a tuple with one entry per dim: None (replicated), a mesh axis
name, or a tuple of axis names used jointly. Entry for entry it is the
reference's ``PartitionSpec``, normalised as that is: a one-axis tuple is
its axis name and an empty one None. The port executes no sharded step:
specs say how a cell would be laid out, and `shard_shape` gives each
device's block of a leaf (`launch.dryrun` sums its bytes).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

Spec = Tuple[object, ...]


@dataclasses.dataclass
class LogicalAxisRules:
    # logical name -> ordered mesh-axis preference (each entry is a mesh axis
    # name or a tuple of axes to use jointly)
    rules: Dict[str, List[object]]
    # resolution priority: earlier names grab mesh axes first
    priority: List[str]

    def axis_prefs(self, name: str) -> List[object]:
        return self.rules.get(name, [])


def default_rules(head_dim_fallback: bool = False) -> LogicalAxisRules:
    """head_dim_fallback: shard head_dim over `model` when head counts
    don't divide it. The reference measured it harmful on its compiler
    (SPMD falls back to rematerialising copies), so it is off by default."""
    return LogicalAxisRules(
        rules={
            "batch": [("pod", "data"), "data"],
            "experts": ["model"],
            "heads": ["model"],
            "kv_heads": ["model"],
            "vocab": ["model"],
            "mlp": ["model"],
            "q_lora": ["model"],
            "kv_lora": ["model"],
            "head_dim": (["model"] if head_dim_fallback else []),
            "embed": ["data"],          # FSDP axis for weights
            "embed_repl": [],
            "seq": [],                  # sequence kept unsharded by default
            "layers": [],
            "conv": [],
            "state": [],
        },
        priority=["experts", "heads", "kv_heads", "vocab", "mlp", "q_lora",
                  "kv_lora", "batch", "head_dim", "embed", "seq"],
    )


def serving_rules(replicate_weights_over_data: bool = False,
                  shard_cache_seq: bool = True) -> LogicalAxisRules:
    """Decode-path rules: the reference found that the decode step's
    traffic is the KV cache's, not the weights' (kv_heads = 8 < model = 16
    leaves the cache replicated over `model`), and shards the cache's
    sequence dim over `model` (context-parallel decode attention).
    Replicating the weights over `data` is an option it measured worse."""
    r = default_rules()
    rules = dict(r.rules)
    if replicate_weights_over_data:
        rules["embed"] = []
    if shard_cache_seq:
        rules["seq"] = ["model"]
    return LogicalAxisRules(rules=rules, priority=r.priority)


def _axes_of(entry) -> Tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


def normalize(entries) -> Spec:
    """A spec's entries as the reference's PartitionSpec keeps them: a
    tuple of one axis is that axis, an empty tuple None."""
    out = []
    for e in entries:
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = None if not e else e[0] if len(e) == 1 else e
        out.append(e)
    return tuple(out)


def spec_for_shape(mesh, logical: Sequence[Optional[str]],
                   shape: Sequence[int],
                   rules: Optional[LogicalAxisRules] = None) -> Spec:
    """Resolve the spec of one tensor on `mesh` (anything with a `shape`
    dict of axis sizes: compat.AbstractMesh or launch.mesh.Mesh)."""
    rules = rules or default_rules()
    mesh_sizes = dict(mesh.shape)
    n = len(shape)
    assert len(logical) == n, (logical, shape)
    assignment: List[Optional[object]] = [None] * n
    used: set = set()
    last = len(rules.priority)
    order = sorted(range(n), key=lambda i: (
        rules.priority.index(logical[i]) if logical[i] in rules.priority
        else last))
    for i in order:
        name = logical[i]
        if name is None:
            continue
        for pref in rules.axis_prefs(name):
            axes = _axes_of(pref)
            if any(a not in mesh_sizes for a in axes):
                continue
            if any(a in used for a in axes):
                continue
            total = math.prod(mesh_sizes[a] for a in axes)
            if shape[i] % total != 0:
                continue
            assignment[i] = pref
            used.update(axes)
            break
    return normalize(assignment)


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_specs(mesh, params_logical, params_shapes,
               rules: Optional[LogicalAxisRules] = None):
    """Matching nested dicts of logical-axis tuples and shapes -> the same
    tree of specs."""
    rules = rules or default_rules()
    if _is_logical(params_logical):
        return spec_for_shape(mesh, params_logical, tuple(params_shapes),
                              rules)
    return {k: tree_specs(mesh, params_logical[k], params_shapes[k], rules)
            for k in sorted(params_logical)}


def shard_shape(mesh, spec: Spec, shape: Sequence[int]) -> Tuple[int, ...]:
    """One device's block of a tensor of `shape` laid out by `spec` on
    `mesh` (NamedSharding.shard_shape): each sharded dim divided by the
    product of its axes' sizes, which must divide it. Missing trailing
    entries replicate."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than {tuple(shape)}")
    sizes = dict(mesh.shape)
    out = []
    for i, d in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        k = 1 if e is None else math.prod(sizes[a] for a in _axes_of(e))
        if d % k:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {e} ({k} devices)")
        out.append(d // k)
    return tuple(out)


__all__ = ["LogicalAxisRules", "Spec", "default_rules", "normalize",
           "serving_rules", "shard_shape", "spec_for_shape", "tree_specs"]
