"""Shared by tests/test_torch_sharded_*.py: the
reference's partitioned step (tests/_jax_sharded_step.py, 8 host devices)
and the port's (tests/_torch_dist_worker.py scenario ``sharded``, 8 gloo
ranks) of one arch, run side by side in processes of their own, and
their outputs held to each other with the tolerances of
tests/test_torch_llm_train.py and tests/test_torch_llm_serve.py.

Tolerances: every float output within 1e-4 * max |ref| (F32_TOL, the
float32 parity limit of tests/test_torch_llm_train.py; what is left is
the two libraries' summation order); a parameter after the train step is
compared where |g_ref| > 1e-3 * max |g_ref| on its leaf (Adam's first
step moves an element by about lr * sign(g), so a gradient that float
noise moves across 0 changes it by up to 2 * lr); greedy tokens equal.
"""
import os
import subprocess
import sys

import numpy as np

import _sharded_inputs as si

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WORLD = si.MESH[0] * si.MESH[1]
RUN_TIMEOUT_S = 400
F32_TOL = 1e-4
FLAT_GRAD = 1e-3


def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    return env


def _wait(procs, token, what):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RUN_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and token in out, (what, err[-4000:])


def run_both(arch, tmp, img_tokens=None):
    """The reference's and the port's outputs of `arch` (with `img_tokens`
    image tokens where given): (ref, port) as dicts of arrays; port holds
    rank 0's gathered results and, under "plain/", the port's unsharded
    step."""
    jdir, tdir = tmp / "jax", tmp / "torch"
    jdir.mkdir()
    tdir.mkdir()
    env = _env()
    img = [str(img_tokens)] if img_tokens else []
    jax_proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_jax_sharded_step.py"),
         str(jdir), arch] + (["--img-tokens"] + img if img else []),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_dist_worker.py"),
         "sharded", str(WORLD), str(r), str(tdir / "store"), str(tdir),
         arch, str(si.MESH[0]), str(si.MESH[1])] + img, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    _wait(ranks, "WORKER_OK", f"{arch}: the port's ranks")
    _wait([jax_proc], "JAX_SHARDED_OK", f"{arch}: the reference")
    with np.load(jdir / f"{arch}.npz") as j, \
            np.load(tdir / "rank0.npz") as t:
        return dict(j), dict(t)


def close(port, ref, tol=F32_TOL, what=""):
    a = np.asarray(port, np.float64)
    b = np.asarray(ref, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.isfinite(a).all(), what
    err = np.abs(a - b).max() if a.size else 0.0
    assert err <= tol * max(np.abs(b).max(), 1e-30), (
        what, err, np.abs(b).max())


def keys(ref, *prefixes):
    out = sorted(k for k in ref if k.startswith(prefixes))
    assert out, prefixes
    return out


def check_forward(ref, port, pre=""):
    names = ["logits", "loss"] + (["mtp"] if "mtp" in ref else []) + (
        ["aux"] if "metrics/aux" in ref else []) + keys(ref, "metrics/")
    for k in names:
        close(port[pre + k], ref[k], what=pre + k)


def check_train(ref, port, pre=""):
    for k in keys(ref, "train_metrics/", "opt/"):
        close(port[pre + k], ref[k], what=pre + k)
    for k in keys(ref, "new_params/"):
        g = np.abs(ref["grads/" + k[len("new_params/"):]])
        sure = g > FLAT_GRAD * g.max()
        want = ref[k].astype(np.float64)
        err = np.abs(port[pre + k].astype(np.float64) - want)[sure]
        assert not err.size or err.max() <= F32_TOL * np.abs(want).max(), (
            pre + k, err.max())


def check_prefill(ref, port, pre=""):
    for k in ["prefill_logits"] + keys(ref, "prefill_cache/"):
        close(port[pre + k], ref[k], what=pre + k)


def check_decode(ref, port, pre=""):
    for i in range(si.DECODE_STEPS):
        close(port[f"{pre}decode_logits/{i}"], ref[f"decode_logits/{i}"],
              what=f"{pre}decode step {i}")
        np.testing.assert_array_equal(port[f"{pre}decode_tokens/{i}"],
                                      ref[f"decode_tokens/{i}"])
    for k in keys(ref, "decode_cache/"):
        close(port[pre + k], ref[k], what=pre + k)
    np.testing.assert_array_equal(port[pre + "serve_tokens"],
                                  ref["decode_tokens/0"])
