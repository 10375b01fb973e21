"""One short run of each cell on the card, through bench/run.py. Skips
without a CUDA device.

    PYTHONPATH=src python -m pytest -q -m cuda bench/tests
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from bench import cells

ROOT = Path(__file__).resolve().parents[2]
pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("w", [w["name"] for w in cells.spec()["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(cuda, w, trace):
    r = subprocess.run([sys.executable, "bench/run.py", "--workload", w,
                        "--seed", str(2 ** 31 + 11), "--seconds", "2",
                        "--trace", str(trace)], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"], out["check"]
    assert out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "check"
    want = cells.cell(w)["per_layer" if trace else "end_to_end"]
    assert {m["name"] for m in want} <= set(out["metrics"]) | {
        "hmul_roofline"}
