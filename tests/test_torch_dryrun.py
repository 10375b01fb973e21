"""The port's dry-run slice (repro_torch.launch.{specs, dryrun, roofline},
models.model's abstract params and specs, train.optim's abstract AdamW
state) against the JAX package's, on the CPU.

* Specs: for all ten full configs on both production meshes, logical
  axes, parameter and cache specs (default and serving rules), abstract
  params and AdamW state and its specs, leaf for leaf.
* Cells: SHAPES, cell_applicable, and build_cell's argument shapes and
  dtypes, input and output specs and one device's argument bytes for the
  10 x 4 cells on both meshes; the reference's cells come from
  tests/_jax_dryrun_cells.py in a process of 512 placeholder devices.
* Roofline functions equal to the reference's; the meta FLOP count of a
  train step equals FlopCounterMode over the same step on real CPU
  tensors (one dense and one MoE smoke config); the k = 1, 2
  extrapolation equals the full-depth count of a homogeneous stack.
* The partitioned step's layouts: for every argument of every cell
  (parameters, AdamW state, batch, cache) on both meshes, the DTensor's
  local shape on a fake group of 256 or 512 ranks
  (tests/_torch_fake_counts.py, a process of its own) equals
  sharding.rules.shard_shape and the reference's NamedSharding.shard_shape.
* Records: the partitioned step's per-device fields (flops_per_device,
  collective_bytes, collective_total) filled, the compiler's fields null,
  each with its reason; recurrentgemma-2b's roofline adds the RG-LRU
  correction once, to the unsharded FLOPs and over the devices to a
  partitioned count; --measure's one-card collective_s 0.
"""
import dataclasses
import importlib
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.compat import abstract_mesh as jax_abstract_mesh  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sharding import rules as R  # noqa: E402
from repro.train import optim as JO  # noqa: E402
from repro_torch.compat import abstract_mesh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch import specs as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.sharding import rules as T  # noqa: E402
from repro_torch.train import optim as TO  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
RULES = {"default": (None, None),
         "head_dim": (R.default_rules(True), T.default_rules(True)),
         "serving": (R.serving_rules(), T.serving_rules())}
CACHES = ((128, 32768), (1, 524288))    # decode_32k's and long_500k's


def _key(k):
    return str(k.key) if hasattr(k, "key") else str(k.idx)


def jflat(tree, is_leaf=None):
    """(path, leaf) of a JAX tree (NamedShardings and ShapeDtypeStructs are
    leaves)."""
    return [("/".join(_key(k) for k in p), leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]]


def tflat(tree, prefix=""):
    """(path, leaf) of a port tree of nested dicts (a spec is a leaf)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tflat(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def paired(tree, specs, prefix=""):
    """(path, leaf, spec) of a port cell's tree and its mirrored specs."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in paired(tree[k], specs[k], f"{prefix}{k}/")]
    if isinstance(tree, (tuple, list)):
        return [x for i, (t, s) in enumerate(zip(tree, specs, strict=True))
                for x in paired(t, s, f"{prefix}{i}/")]
    return [(prefix[:-1], tree, specs)]


def spec_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def jspecs(tree):
    return [(p, tuple(ns.spec)) for p, ns in jflat(tree)]


def shapes_dtypes(pairs):
    return [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in pairs]


# ---------------------------------------------------------------------------
# specs of the ten full configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_specs_equal_reference(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    assert jflat(JM.logical_axes(jcfg),
                 lambda x: isinstance(x, tuple)) == tflat(TM.logical_axes(cfg))
    jparams, params = JM.abstract_params(jcfg), TM.abstract_params(cfg)
    assert shapes_dtypes(jflat(jparams)) == shapes_dtypes(tflat(params))
    assert all(x.device.type == "meta" for _, x in tflat(params))
    jopt, opt = JO.abstract_adamw_state(jparams), TO.abstract_adamw_state(
        params)
    assert shapes_dtypes(jflat(jopt)) == shapes_dtypes(tflat(opt))
    for sizes, axes in MESHES.values():
        jmesh, mesh = jax_abstract_mesh(sizes, axes), abstract_mesh(sizes,
                                                                    axes)
        for jrules, rules in RULES.values():
            jp = JM.param_specs(jcfg, jmesh, jrules)
            tp = TM.param_specs(cfg, mesh, rules)
            assert jspecs(jp) == tflat(tp)
            assert jspecs(JO.adamw_state_specs(jp, jmesh)) == tflat(
                TO.adamw_state_specs(tp, mesh))
            for b, s in CACHES:
                assert jspecs(JM.cache_specs(jcfg, jmesh, b, s, jrules)) == \
                    tflat(TM.cache_specs(cfg, mesh, b, s, rules))


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("cells") / "cells.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    r = subprocess.run([sys.executable,
                        os.path.join(ROOT, "tests", "_jax_dryrun_cells.py"),
                        str(out)], env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0 and "CELLS_OK 80" in r.stdout, r.stderr[-3000:]
    return json.loads(out.read_text())


def test_shapes_and_applicability_equal_reference():
    assert TS.SHAPES == JS.SHAPES
    for arch in list_archs():
        for shape in JS.SHAPES:
            assert TS.cell_applicable(get_config(arch), shape) == \
                JS.cell_applicable(jax_get_config(arch), shape)


@pytest.mark.parametrize("arch", list_archs())
def test_cells_equal_reference(arch, jax_cells):
    """Argument paths, shapes and dtypes, input and output specs and one
    device's argument bytes of build_cell, for every shape on both
    meshes. The reference's decode position is an int32 scalar; the
    port's a Python int (seq - 1), counted as 4 bytes."""
    for name, (sizes, axes) in MESHES.items():
        mesh = abstract_mesh(sizes, axes)
        for shape in TS.SHAPES:
            ref = jax_cells[f"{arch}|{shape}|{name}"]
            cell = TS.build_cell(arch, shape, mesh)
            assert cell["skip"] == ref["skip"]
            if cell["skip"]:
                assert cell["reason"] == ref["reason"]
                continue
            assert cell["meta"] == ref["meta"]
            rows = paired(cell["args"], cell["in_specs"])
            args = [[p, [], "int32"] if isinstance(x, int) else
                    [p, list(x.shape), str(x.dtype).replace("torch.", "")]
                    for p, x, _ in rows]
            assert args == ref["args"]
            assert [[p, spec_json(s)] for p, _, s in rows] == ref["in"]
            if ref["out"] is None:
                assert cell["out_specs"] is None and cell["outs"] is None
            else:
                assert [[p, spec_json(s)] for p, _, s in
                        paired(cell["outs"], cell["out_specs"])] == ref["out"]
            assert dryrun.sharded_bytes(cell["args"], cell["in_specs"],
                                        mesh) == ref["arg_bytes"]


# ---------------------------------------------------------------------------
# roofline functions and counts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_roofline():
    """repro.launch.roofline sets XLA_FLAGS when imported (for its own
    process); start this process's backend first and put the variable
    back, so nothing started later inherits 512 placeholder devices."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.roofline")
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


def test_roofline_functions_equal_reference(jax_roofline):
    assert roofline.CANONICAL == jax_roofline.CANONICAL
    assert "197e12" not in open(roofline.__file__).read()
    for arch in roofline.CANONICAL:
        assert roofline.full_knobs(arch) == jax_roofline.full_knobs(arch)
        for k in (1, 2):
            assert [(t, dataclasses.asdict(c), u) for t, c, u in
                    roofline.scaled_cfgs(arch, k)] == \
                [(t, dataclasses.asdict(c), u) for t, c, u in
                 jax_roofline.scaled_cfgs(arch, k)]
        for shape in TS.SHAPES:
            assert roofline.recurrence_correction(arch, shape) == \
                jax_roofline.recurrence_correction(arch, shape)
            assert roofline.model_flops(arch, shape) == \
                jax_roofline.model_flops(arch, shape)


@pytest.mark.parametrize("arch", ["qwen3-8b", "arctic-480b"])
def test_meta_count_equals_real_step(arch):
    """FlopCounterMode over one real train step on the CPU counts what it
    counts on meta tensors, and the spec-derived argument bytes (one
    device) are the real tensors' nbytes."""
    r = roofline.measure(arch, "train_4k", "cpu", smoke=True, batch=2,
                         seq=16, steps=1, warmup=0)
    assert r["real_matmul_flops"] == r["meta_matmul_flops"] > 0
    assert r["real_argument_bytes"] == r["argument_bytes"]
    assert r["memory_allocated_delta"] is None
    assert r["ms"] > 0 and r["bound_ms"] > 0 and r["collective_s"] == 0.0


def _train_count(arch, shape="train_4k"):
    mesh = abstract_mesh((16, 16), ("data", "model"))

    def count(cfg):
        return dryrun.count_matmul_flops(TS.build_cell(
            arch, shape, mesh, cfg_override=cfg, batch=2,
            seq=16))["matmul_flops"]
    return count


def test_extrapolation_exact_for_homogeneous_stack():
    cfg = dataclasses.replace(get_config("qwen3-8b", smoke=True), n_layers=5)
    count = _train_count("qwen3-8b")
    assert roofline.extrapolate("qwen3-8b", count, cfg) == count(cfg)


def test_decode_count_does_not_depend_on_pos():
    """The decode attention masks over every cache slot: its matmuls are
    the same at any position (the dry run gives pos = seq - 1)."""
    mesh = abstract_mesh((1, 1), ("data", "model"))
    for arch in list_archs():
        cfg = get_config(arch, smoke=True)
        cell = TS.build_cell(arch, "decode_32k", mesh, cfg_override=cfg,
                             batch=2, seq=64)
        assert cell["args"][3] == 63
        at_end = dryrun.count_matmul_flops(cell)["matmul_flops"]
        args = cell["args"][:3] + (0,)
        assert dryrun.count_matmul_flops(dict(cell, args=args))[
            "matmul_flops"] == at_end > 0


def test_roofline_record_recurrence():
    """The RG-LRU scan's correction, added to the unsharded FLOPs and,
    over the 256 devices, to the partitioned count (here a stub: the
    16x16 count runs in a process of its own; the island's count holds no
    recurrence FLOPs, test_torch_sharded_recurrent.py)."""
    part = {"flops_per_device": 3.0e9, "collective_total": 5.0e8,
            "collective_bytes": {"all-gather": 4.9e8, "all-reduce": 1.0e7}}
    rec = roofline.run_cell("recurrentgemma-2b", "decode_32k",
                            partition=part)
    assert rec["status"] == "ok", rec.get("tb")
    assert rec["recurrence_added_flops"] == \
        roofline.recurrence_correction("recurrentgemma-2b",
                                       "decode_32k") * 256
    assert rec["flops"] == rec["matmul_flops"] + rec["recurrence_added_flops"]
    # partitioned: the collective term and the per-device compute term
    assert rec["collective_s"] is not None
    assert rec["flops_per_device"] is not None and not rec["absent"]
    assert rec["flops_per_device"] == \
        part["flops_per_device"] + rec["recurrence_added_flops"] / 256
    assert rec["collective_s"] == part["collective_total"] / roofline.LINK_BW
    assert rec["compute_s"] == rec["flops_per_device"] / roofline.PEAK_FLOPS
    terms = {k: rec[k] for k in ("compute_s", "memory_s", "collective_s")}
    assert rec["dominant"] == max(terms, key=terms.get)
    assert rec["memory_s"] == (rec["argument_bytes"] + rec["output_bytes"]) \
        / roofline.HBM_BW
    assert rec["k12_gap"] == (rec["matmul_flops_k12"] - rec["matmul_flops"]) \
        / rec["matmul_flops"]


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

def test_dryrun_records(tmp_path):
    out = tmp_path / "d.jsonl"
    assert dryrun.main(["--arch", "qwen3-8b", "--shape", "decode_32k",
                        "--both-meshes", "--out", str(out)]) == 0
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    assert [r["n_devices"] for r in recs] == [256, 512]
    for r in recs:
        assert r["status"] == "ok" and r["fits_device"]
        for k in dryrun.ABSENT:
            assert r[k] is None and r["absent"][k]
        assert r["matmul_flops"] > 0 and r["output_bytes"] > 0
        # the partitioned step's per-device fields, counted on the mesh
        assert r["partitioner"] == "dtensor"
        assert not set(dryrun.PARTITIONED) & set(r["absent"])
        assert r["collective_total"] == sum(r["collective_bytes"].values())
        assert set(r["collective_bytes"]) <= {
            "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "collective-permute"} and r["collective_total"] > 0
        assert r["flops_per_device"] * r["n_devices"] >= r["matmul_flops"]
    # one count, made once for both meshes
    assert recs[0]["matmul_flops"] == recs[1]["matmul_flops"]
    assert recs[0]["count_s"] == recs[1]["count_s"]
    assert recs[1]["argument_bytes"] < recs[0]["argument_bytes"]
    pre = dryrun.run_cell("qwen3-8b", "prefill_32k", False, count=False)
    assert pre["status"] == "ok" and pre["output_bytes"] is None
    assert pre["matmul_flops"] is None
    assert {"output_bytes", "matmul_flops"} <= set(pre["absent"])
    skip = dryrun.run_cell("qwen3-8b", "long_500k", True)
    assert skip["status"] == "skipped" and "sub-quadratic" in skip["reason"]


# ---------------------------------------------------------------------------
# the partitioned step's layouts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fake_shapes(tmp_path_factory):
    out = tmp_path_factory.mktemp("fake") / "shapes.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable,
                        os.path.join(ROOT, "tests", "_torch_fake_counts.py"),
                        "shapes", str(out)], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and "FAKE_COUNTS_OK" in r.stdout, \
        r.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch", list_archs())
def test_partitioned_local_shapes_equal_reference(arch, jax_cells,
                                                  fake_shapes):
    """Every parameter, AdamW, batch and cache leaf of the partitioned
    cells: the DTensor's local block is shard_shape of its spec and the
    reference's NamedSharding.shard_shape, on both meshes."""
    n = 0
    for name in MESHES:
        for shape in TS.SHAPES:
            ref = jax_cells[f"{arch}|{shape}|{name}"]
            if ref["skip"]:
                continue
            want = {p: s for p, s in ref["shard"]}
            for path, local, rule in fake_shapes[f"{arch}|{shape}|{name}"]:
                assert local == rule == want[path], (shape, name, path)
                n += 1
            # every argument but decode's position (an int)
            assert n and len(want) - (shape.startswith(("decode", "long")))\
                == len(fake_shapes[f"{arch}|{shape}|{name}"])
