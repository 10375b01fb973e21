"""What the benchmark loads: no module whose top-level name, compared
whole, is `jax`, `jaxlib`, `flax` or the JAX package `repro`; the
reference imports nothing of the program; and the entry refuses to run
without a card or without the program beside it."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

from bench import harness

ROOT = Path(__file__).resolve().parents[2]


def _python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600,
                          env={"PATH": "/usr/bin:/bin",
                               "PYTHONPATH": f"{ROOT}:{ROOT / 'src'}"})


def test_top_level_names_compared_whole():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.core", "jaxtyping", "reprox"]) == []
    assert harness.forbidden_modules(
        ["repro.core", "jax.numpy", "jaxlib", "flax.linen"]) == [
            "flax", "jax", "jaxlib", "repro"]


def test_a_run_loads_no_jax_and_no_jax_package():
    code = (
        "import sys, json\n"
        "sys.path.insert(0, 'bench/tests')\n"
        "from _bench_small import small_cell\n"
        "from bench import harness\n"
        "out = harness.execute(small_cell('helr-paper.b8'), 3, 0.1, True,"
        " 'cpu')\n"
        "print(json.dumps([out['correct'],"
        " harness.forbidden_modules(sys.modules)]))\n")
    r = _python(code)
    assert r.returncode == 0, r.stderr[-2000:]
    ok, found = json.loads(r.stdout.strip().splitlines()[-1])
    assert ok and found == []


def test_reference_imports_nothing_of_the_program():
    r = _python("import sys\nimport bench.reference\n"
                "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert r.returncode == 0, r.stderr
    tops = set(json.loads(r.stdout.strip().replace("'", '"')))
    assert not tops & {"repro_torch", "repro", "jax", "torch"}
    src = (ROOT / "bench" / "reference.py").read_text()
    assert "repro" not in src.replace("reproduce", "")


def test_refuses_without_a_card():
    r = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "helr-paper.b8", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600,
                       env={"PATH": "/usr/bin:/bin",
                            "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_refuses_without_the_program(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    r = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "helr-paper.b8", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=600, env={"PATH": "/usr/bin:/bin"})
    assert r.returncode != 0 and r.stdout.strip() == ""
