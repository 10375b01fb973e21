"""The port's partitioned step of the two recurrent stacks against the JAX
package's on a (2, 4) mesh, in float32 on the CPU:

* rwkv6-3b's smoke config (2 layers, d_model 128): the RWKV6 time mix's
  island with 2 heads of 64 on 4 `model` ranks, which the heads do not
  divide, so every rank of a `model` group runs both heads of its batch;
* recurrentgemma-2b's whole smoke config, one (rglru, rglru, attn)
  superblock and a tail RG-LRU layer: the RG-LRU island over each rank's
  16 of 64 channels, local attention with 2 query heads and 1 KV head
  (neither divides over 4), and its ring decode at positions 14..17,
  across the wrap of a 16-slot ring whose slots split over `model`.

What is compared and how: tests/test_torch_sharded_step.py and
tests/_sharded_parity.py; each arch's reference process and 8-rank port
run happen once for the module. Also: F5 (empty ring slots take weight)
on the partitioned ring decode against the reference's
`_ring_local_decode`; the time loops' count on meta tensors (one step
batched over T) equal to the loop's on real tensors, partitioned
(tests/_torch_fake_counts.py, 8 fake ranks) and unsharded; the RG-LRU
scan outside the islands' FLOP count (roofline adds it once); and a
forward on DTensors of every one of the ten archs' smoke configs
(tests/_torch_fake_counts.py ``forward``).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _sharded_inputs as si  # noqa: E402
import _sharded_parity as P  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402

ARCHS = ["rwkv6-3b", "recurrentgemma-2b"]
ROOT = os.path.join(os.path.dirname(__file__), "..")
_RUNS = {}


def _run(arch, tmp_path_factory):
    if arch not in _RUNS:
        _RUNS[arch] = P.run_both(arch, tmp_path_factory.mktemp(
            "sharded_" + arch.split("-")[0]))
    return _RUNS[arch]


@pytest.fixture(scope="module", params=ARCHS)
def runs(request, tmp_path_factory):
    return _run(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def gemma(tmp_path_factory):
    return _run("recurrentgemma-2b", tmp_path_factory)


@pytest.fixture(scope="module")
def fake_counts(tmp_path_factory):
    out = tmp_path_factory.mktemp("fake_recurrent") / "smoke.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable,
                        os.path.join(ROOT, "tests", "_torch_fake_counts.py"),
                        "smoke", str(out)], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and "FAKE_COUNTS_OK" in r.stdout, \
        r.stderr[-3000:]
    return json.loads(out.read_text())


def test_forward_and_loss_match_reference(runs):
    P.check_forward(*runs)


def test_train_step_matches_reference(runs):
    P.check_train(*runs)


def test_prefill_matches_reference(runs):
    P.check_prefill(*runs)


def test_decode_matches_reference(runs):
    P.check_decode(*runs)


@pytest.mark.parametrize("part", ["forward", "train", "prefill", "decode"])
def test_partitioned_equals_unsharded(runs, part):
    """The port's unsharded step (plain tensors, one rank) against the
    partitioned one, with the same tolerances."""
    _, port = runs
    plain = {k[len("plain/"):]: v for k, v in port.items()
             if k.startswith("plain/")}
    grads = {k: v for k, v in runs[0].items() if k.startswith("grads/")}
    check = {"forward": P.check_forward, "train": P.check_train,
             "prefill": P.check_prefill, "decode": P.check_decode}[part]
    check(dict(plain, **grads), port)


def test_ring_decode_crosses_the_wrap(gemma):
    """The decode steps write positions 14..17 into the 16-slot ring: 14
    and 15 at its end, 16 and 17 over slots 0 and 1, in both packages."""
    ref, port = gemma
    window = si.S_MAX
    first = si.history(True)
    assert first < window <= first + si.DECODE_STEPS - 1
    want = np.arange(window)
    for pos in range(first, first + si.DECODE_STEPS):
        want[pos % window] = pos
    for side, k in ((ref, "decode_cache/pos_2"), (port, "decode_cache/pos_2"),
                    (port, "plain/decode_cache/pos_2")):
        np.testing.assert_array_equal(side[k], want[None])


def test_ring_empty_slots_take_weight_partitioned(gemma):
    """F5 (ROADMAP §3) on the DTensor ring decode: a zero ring whose slot
    positions are 0 gives its empty slots softmax weight, as the
    reference's `_ring_local_decode` does, and differs from one whose
    empty slots say -1; both match the reference at every position, the
    ring's slots split over the 4 `model` ranks."""
    ref, port = gemma
    for init in (0, -1):
        for k in [f"ring/{init}/{n}" for n in ("k", "v", "pos")] + [
                f"ring/{init}/out/{i}" for i in range(si.RING_STEPS)]:
            P.close(port[k], ref[k], what=k)
    np.testing.assert_array_equal(
        port["ring/0/pos"], np.r_[np.arange(si.RING_STEPS),
                                  np.zeros(si.S_MAX - si.RING_STEPS)])
    for side in (ref, port):
        gap = max(np.abs(side[f"ring/0/out/{i}"]
                         - side[f"ring/-1/out/{i}"]).max()
                  for i in range(si.RING_STEPS))
        assert gap > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("step", ["train", "prefill", "decode"])
def test_time_loop_count_equals_full_loop(fake_counts, arch, step):
    """StepCounter's collective bytes and FLOPs of the partitioned step on
    meta tensors, where each time loop runs as one step batched over T,
    equal those of the loop over T on real tensors (8 fake ranks)."""
    c = fake_counts["loop_counts"][arch]
    assert c["fold"][step] == c["loop"][step]
    assert c["fold"][step]["flops"] > 0
    assert c["fold"][step]["collective_bytes"]


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_count_equals_real_step(arch):
    """The unsharded train step: FlopCounterMode on meta tensors (the time
    loops batched over T) counts what it counts over one real step on the
    CPU (the loops over T)."""
    from repro_torch.launch import roofline
    r = roofline.measure(arch, "train_4k", "cpu", smoke=True, batch=2,
                         seq=16, steps=1, warmup=0)
    assert r["real_matmul_flops"] == r["meta_matmul_flops"] > 0
    assert r["real_argument_bytes"] == r["argument_bytes"]


def test_rglru_scan_is_not_in_the_island_count():
    """The RG-LRU island's recurrence is elementwise: StepCounter counts
    no FLOPs for it (over T = 8 on real tensors and on meta), so the
    roofline's analytic correction is not counted twice."""
    from repro_torch.launch.dryrun import StepCounter
    from repro_torch.models import recurrent as rec
    for dev in ("cpu", "meta"):
        p = {k: torch.ones(16, device=dev) for k in rec._LRU_GATES}
        x = torch.ones((2, 8, 16), device=dev, requires_grad=True)
        with StepCounter() as c:
            y, h = rec.rglru(x, p)
            y.sum().backward()
        assert c.flops == 0 and y.shape == (2, 8, 16) and h.shape == (2, 16)


@pytest.fixture(scope="module")
def dtensor_forwards(tmp_path_factory):
    out = tmp_path_factory.mktemp("fake_forward") / "forward.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable,
                        os.path.join(ROOT, "tests", "_torch_fake_counts.py"),
                        "forward", str(out)], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and "FAKE_COUNTS_OK" in r.stdout, \
        r.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch", list_archs())
def test_every_stack_has_a_partitioned_forward(dtensor_forwards, arch):
    """Every one of the ten archs' smoke configs runs its forward on
    DTensors ((2, 4) mesh of 8 fake ranks, meta tensors): none raises,
    and the logits come back as a DTensor of (B, S, vocab)."""
    from repro_torch.configs import get_config
    kind, shape = dtensor_forwards[arch]
    assert kind == "DTensor", shape
    assert shape == [si.B, si.S, get_config(arch, smoke=True).vocab]
