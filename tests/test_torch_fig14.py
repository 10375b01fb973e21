"""The port's fig14 benchmark (`repro_torch.benchmarks.fig14_kernels`) on
the CPU: its ``--smoke`` run with ``--device cpu`` goes through the
kernels' plain versions, holds its >= 4x dispatch assertion and its
oracle checks, names its rows by route, and writes its records where it
is told. Without ``--device cpu`` and without a CUDA device it raises
(tests/test_torch_hygiene.py), and it imports neither jax nor `repro`.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import common, fig14_kernels  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")


def test_fig14_smoke_on_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(common, "RESULTS", str(tmp_path))
    records = fig14_kernels.main(["--smoke", "--device", "cpu"])
    names = [r["name"] for r in records]
    assert not [n for n in names if "pallas" in n or "_cuda" in n]
    for name in ("fig14_ntt_fourstep_plain",
                 "fig14_bconv_kernel_eager_plain",
                 "fig14_bconv_kernel_lazy_plain",
                 "fig14_keyswitch_fused_plain",
                 "fig14_keyswitch_staged_plain"):
        assert name in names
    red = records[names.index("fig14_keyswitch_dispatch_reduction")]
    assert red["fused_dispatches"] == 4
    assert red["staged_dispatches"] == 7 * 2 + 10
    assert red["reduction"] >= 4.0
    with open(tmp_path / "fig14_kernels.jsonl") as f:
        lines = [json.loads(x) for x in f]
    assert [x["name"] for x in lines] == names
    assert all(x["smoke"] and x["device"] == "cpu" for x in lines)
    assert "fig14_keyswitch_dispatch_reduction,0.0,24/4" in \
        capsys.readouterr().out


def test_fig14_imports_no_jax_or_reference():
    code = ("import sys\n"
            "import repro_torch.benchmarks.fig14_kernels\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
