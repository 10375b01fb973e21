"""The dry run's and roofline's counts of the partitioned step
(launch.dryrun.StepCounter, launch.roofline's collective term), on the
CPU.

* A two-layer dense toy on a (data 2, model 4) mesh of 8 fake ranks
  (tests/_torch_fake_counts.py, in a process of its own): the result
  bytes per device of its prefill step's all-gathers and all-reduces,
  and of its train step's reduce-scatters, equal a count written out
  here from the layouts (TOY: d_model 16, d_ff 32, vocab 32, 4 heads of
  4, batch 4 x seq 8, float32):
  - all-gather: each weight gathered over `data` (its FSDP split) for
    its product: embed and lm_head (32 x 16, 8 x 8 a rank) 512 B each;
    a layer's wq, wk, wv (16 x 4 x 4, 8 x 1 x 4) 256 B each, wo (16 x
    16, 4 x 8) 256 B, w_gate, w_up, w_down (16 x 32, 8 x 8) 512 B each:
    2560 B a layer;
  - all-reduce: the row-parallel products' partial sums over `model`,
    one (2, 8, 16) block of activations (1024 B) each: the embedding
    lookup, and a layer's wo and w_down;
  - reduce-scatter (train): each weight's gradient, a partial sum over
    `data`, into the weight's own block: the local bytes of every
    weight split over `data`.
* Records: qwen3-8b decode_32k's roofline on 16x16 carries the
  collective term (collective_total over one 400 Gb/s port) and the
  per-device compute term; llama-3.2-vision-90b's (the
  cross-attention-period stack) dry-run and roofline records carry the
  partitioned count's per-device fields under both spellings of its
  name.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import dryrun, roofline  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
F32 = 4


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    out = tmp_path_factory.mktemp("toy") / "toy.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable,
                        os.path.join(ROOT, "tests", "_torch_fake_counts.py"),
                        "toy", str(out)], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and "FAKE_COUNTS_OK" in r.stdout, \
        r.stderr[-3000:]
    return json.loads(out.read_text())


def test_toy_prefill_counts_by_hand(toy):
    layers = 2
    gather_layer = 3 * 256 + 256 + 3 * 512
    assert gather_layer == 2560
    all_gather = 512 + layers * gather_layer + 512
    act = 2 * 8 * 16 * F32                      # a rank's (2, 8, 16) block
    all_reduce = act + layers * 2 * act
    assert toy["prefill"] == {"all-gather": all_gather,
                              "all-reduce": all_reduce}
    assert (all_gather, all_reduce) == (6144, 5120)


def test_toy_train_reduce_scatter_by_hand(toy):
    """One reduce-scatter a weight split over `data` (its layers' blocks
    together), of that weight's local bytes."""
    local = {"embed": 8 * 8, "lm_head": 8 * 8,
             "blocks/attn/wq": 2 * 8 * 1 * 4, "blocks/attn/wk": 2 * 8 * 1 * 4,
             "blocks/attn/wv": 2 * 8 * 1 * 4, "blocks/attn/wo": 2 * 4 * 8,
             "blocks/mlp/w_gate": 2 * 8 * 8, "blocks/mlp/w_up": 2 * 8 * 8,
             "blocks/mlp/w_down": 2 * 8 * 8}
    for path, n in local.items():
        assert "data" in toy["specs"][path]
        assert n == eval("*".join(map(str, toy["local_shapes"][path])))
    assert not any("data" in s for p, s in toy["specs"].items()
                   if p not in local)
    assert toy["train"]["reduce-scatter"] == F32 * sum(local.values()) \
        == 3072


def test_roofline_collective_term():
    rec = roofline.run_cell("qwen3-8b", "decode_32k")
    assert rec["status"] == "ok", rec.get("tb")
    assert rec["partitioner"] == "dtensor" and not rec["absent"]
    assert rec["collective_s"] == rec["collective_total"] / roofline.LINK_BW
    assert roofline.LINK_BW == 50e9
    assert rec["collective_total"] == sum(rec["collective_bytes"].values())
    assert rec["compute_s"] == rec["flops_per_device"] / roofline.PEAK_FLOPS
    assert rec["flops_per_device"] * 256 >= rec["matmul_flops"]
    terms = {k: rec[k] for k in ("compute_s", "memory_s", "collective_s")}
    assert rec["dominant"] == max(terms, key=terms.get)
    assert rec["bound_s"] == max(terms.values())


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b",
                                  "llama-3-2-vision-90b"])
def test_vision_record_has_per_device_fields(monkeypatch, arch):
    """The cross-attention-period stack has a partitioned step: under
    either of its two names, the dry run's and the roofline's records
    carry the partitioned count's per-device fields (here a stub: the
    16x16 count runs in a process of its own, and the full-depth
    unsharded count is stubbed too), with nothing absent for them."""
    part = {"flops_per_device": 4.0e14, "collective_total": 3.0e11,
            "collective_bytes": {"all-gather": 1.0e11, "all-reduce": 2.0e11},
            "collective_calls": {"all-gather": 3, "all-reduce": 5},
            "partition_s": 1.0}
    monkeypatch.setattr(roofline, "count_matmul_flops",
                        lambda cell: {"matmul_flops": 1.0e17})
    rec = dryrun.run_cell(arch, "train_4k", False, count=False,
                          partition={(arch, "train_4k"): part})
    assert rec["status"] == "ok", rec.get("tb")
    for k in dryrun.PARTITIONED:
        assert rec[k] == part[k] and k not in rec["absent"]
    rec = roofline.run_cell(arch, "train_4k", partition=part)
    assert rec["status"] == "ok", rec.get("tb")
    assert not rec["absent"] and rec["recurrence_added_flops"] == 0
    assert rec["flops_per_device"] == part["flops_per_device"]
    assert rec["collective_s"] == part["collective_total"] / roofline.LINK_BW
    assert rec["collective_bytes"] == part["collective_bytes"]
    assert rec["dominant"] == "collective_s"
