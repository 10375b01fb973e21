"""The JAX package's dry-run cells, as JSON, for tests/test_torch_dryrun.py.

    XLA_FLAGS=--xla_force_host_platform_device_count=512 \\
        python tests/_jax_dryrun_cells.py OUT.json

`repro.launch.specs.build_cell` reads `mesh.devices` for a decode cell, so
the cells are built on the production meshes of placeholder host devices
(512 of them, as repro.launch.dryrun forces), in a process of their own.
For every (arch x shape) cell on 16x16 and 2x16x16 it writes the
arguments' paths, shapes and dtypes, the input and output specs by path,
one device's argument bytes (the sum of NamedSharding.shard_shape
bytes) and each argument's NamedSharding.shard_shape.
"""
import json
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402

from repro.configs import list_archs  # noqa: E402
from repro.launch.mesh import make_production_mesh  # noqa: E402
from repro.launch.specs import SHAPES, build_cell  # noqa: E402


def _key(k):
    return str(k.key) if hasattr(k, "key") else str(k.idx)


def flat(tree):
    return [("/".join(_key(k) for k in path), leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def spec_json(ns):
    return [list(e) if isinstance(e, tuple) else e for e in ns.spec]


def main(out):
    assert len(jax.devices()) == 512, jax.devices()
    cells = {}
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        name = "2x16x16" if multi_pod else "16x16"
        for arch in list_archs():
            for shape in SHAPES:
                cell = build_cell(arch, shape, mesh)
                key = f"{arch}|{shape}|{name}"
                if cell["skip"]:
                    cells[key] = {"skip": True, "reason": cell["reason"]}
                    continue
                args = flat(cell["args"])
                ins = flat(cell["in_shardings"])
                arg_bytes = sum(
                    math.prod(ns.shard_shape(a.shape)) * a.dtype.itemsize
                    for (_, a), (_, ns) in zip(args, ins))
                cells[key] = {
                    "skip": False,
                    "args": [[p, list(a.shape), str(a.dtype)]
                             for p, a in args],
                    "in": [[p, spec_json(ns)] for p, ns in ins],
                    "out": (None if cell["out_shardings"] is None else
                            [[p, spec_json(ns)] for p, ns in
                             flat(cell["out_shardings"])]),
                    "arg_bytes": int(arg_bytes),
                    "shard": [[p, list(ns.shard_shape(a.shape))]
                              for (p, a), (_, ns) in zip(args, ins)],
                    "meta": cell["meta"],
                }
    with open(out, "w") as f:
        json.dump(cells, f)
    print("CELLS_OK", len(cells))


if __name__ == "__main__":
    main(sys.argv[1])
