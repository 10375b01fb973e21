"""Checkpoints with async writes: the port of ``repro.train.checkpoint``.

Format, the reference's: one .npz per checkpoint step (flat key -> array;
a key is the tree path joined by "__", dict keys in sorted order) and a
msgpack manifest (step, keys, shapes, dtypes, time), each written to a
temporary name, fsync'd and renamed, the manifest last; older steps are
removed beyond `keep`. Restore puts each leaf on the `device` asked for,
or lays it out on a `mesh` (the reference's `shardings`: the leaves of a
checkpoint come back laid out on the current mesh, whatever mesh wrote
them). A DTensor leaf is saved whole (`full_tensor`, a collective every
rank of its mesh must join).

bfloat16 leaves are written as the reference writes them: numpy has no
bfloat16, so the .npz holds a 2-byte void array (`|V2`) of the bf16 bits,
and the manifest says "bfloat16". Each package reads the other's files.

Departure from the reference (ROADMAP §3, F7): the reference's restore
returns the `|V2` array as it is and never reads the manifest's dtypes,
so a bf16 leaf cannot become a JAX array again and `--resume` fails for
every bf16 model. This restore casts each leaf to its manifest dtype: a
"bfloat16" leaf's bits are viewed as torch.bfloat16.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

import msgpack
import numpy as np
import torch

from repro_torch.models.model import tree_items

SEP = "__"


def _flatten(tree) -> Dict[str, Any]:
    """Flat key -> leaf in the reference's order (jax.tree's: dict keys
    sorted, depth first)."""
    return {SEP.join(path): leaf for path, leaf in tree_items(tree)}


def _rebuild(tree, flat: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    """`tree`'s structure (empty dicts included) with the leaves of
    `flat`."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], flat, prefix + (k,))
                for k in sorted(tree)}
    return flat[SEP.join(prefix)]


def _host_copy(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A tensor as (a numpy array the .npz can hold, its dtype's name): a
    copy on the host, bf16 as its bits in a 2-byte void array."""
    leaf = leaf.detach()
    if hasattr(leaf, "full_tensor"):     # a DTensor: gathered whole
        leaf = leaf.full_tensor()
    t = leaf.to("cpu", copy=True)
    name = str(t.dtype).split(".")[-1]
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2"), name
    return t.numpy(), name


def _write(ckpt_dir: str, step: int, flat: Dict[str, Tuple[np.ndarray, str]],
           keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}")
    with open(path + ".npz.tmp", "wb") as f:
        np.savez(f, **{k: a for k, (a, _) in flat.items()})
        f.flush()
        os.fsync(f.fileno())
    os.rename(path + ".npz.tmp", path + ".npz")
    manifest = {
        "step": step,
        "keys": sorted(flat),
        "shapes": {k: list(a.shape) for k, (a, _) in flat.items()},
        "dtypes": {k: name for k, (_, name) in flat.items()},
        "time": time.time(),
    }
    with open(path + ".manifest.tmp", "wb") as f:
        f.write(msgpack.packb(manifest))
        f.flush()
        os.fsync(f.fileno())
    os.rename(path + ".manifest.tmp", path + ".manifest")
    _gc_old(ckpt_dir, keep)
    return path


def save_checkpoint(ckpt_dir: str, step: int, tree, *,
                    keep: int = 3) -> str:
    """Blocking save. Returns the checkpoint path."""
    return _write(ckpt_dir, step,
                  {k: _host_copy(v) for k, v in _flatten(tree).items()},
                  keep)


def _gc_old(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep]:
        for ext in (".npz", ".manifest"):
            p = os.path.join(ckpt_dir, f"ckpt_{s:08d}{ext}")
            if os.path.exists(p):
                os.remove(p)


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for f in os.listdir(ckpt_dir):
        if f.endswith(".manifest"):
            out.append(int(f[len("ckpt_"):-len(".manifest")]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _as_tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    """An .npz array as a tensor of the manifest's dtype."""
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, dtype=np.dtype(dtype)))


def restore_checkpoint(ckpt_dir: str, tree_like, *, step: Optional[int] = None,
                       device=None, mesh=None) -> Tuple[Any, int]:
    """Restore into the structure of `tree_like`, every leaf a tensor of
    its manifest dtype on `device` (the CPU by default). With `mesh` (a
    launch.mesh.Mesh), every leaf a DTensor on the mesh's device, laid out
    as tree_like's DTensor leaf is (e.g. models.abstract_params(cfg,
    mesh)): the reference's `shardings=`."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}")
    with open(path + ".manifest", "rb") as f:
        manifest = msgpack.unpackb(f.read())
    flat_keys = sorted(_flatten(tree_like))
    if flat_keys != manifest["keys"]:
        raise ValueError("checkpoint/model structure mismatch: "
                         f"{set(flat_keys) ^ set(manifest['keys'])}")
    if mesh is not None:
        device = mesh.device
    with np.load(path + ".npz") as data:
        out = {k: _as_tensor(data[k], manifest["dtypes"][k]).to(
            device or "cpu") for k in flat_keys}
    if mesh is not None:
        from repro_torch.sharding import dtensor as sd
        like = _flatten(tree_like)
        out = {k: sd.distribute(v, mesh, sd.spec_of(like[k]))
               for k, v in out.items()}
    return _rebuild(tree_like, out), step


class AsyncCheckpointer:
    """Snapshot on the step boundary (the device->host copy is the only
    blocking part); a background thread does the serialization + fsync."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, tree):
        self.wait()
        snapshot = {k: _host_copy(v) for k, v in _flatten(tree).items()}

        def _write_snapshot():
            try:
                _write(self.ckpt_dir, step, snapshot, self.keep)
            except BaseException as e:  # noqa: BLE001 - re-raised by wait()
                self.last_error = e

        self._thread = threading.Thread(target=_write_snapshot, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            raise self.last_error
