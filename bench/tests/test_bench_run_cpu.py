"""The harness path on the CPU at a small ring (log N 8, batches of 2):
compile with the port's compiler, `CkksEngine.run_ops` in the window,
decrypt and compare with the reference. The program as configured passes
the check; the lower precision and each planted fault fail it."""
import json

import numpy as np
import pytest

from _bench_small import small_cell
from bench import cells, faults, harness

CELLS = ("helr-paper.b8", "matvec-paper.b8")


def _run(name, seed, limits=None, trace=False, over=None):
    cell = small_cell(name)
    lim = harness.cell_limits(cell) if limits is None else limits
    return harness.execute(cell, seed, 0.2, trace, "cpu",
                           ckks_override=over, limits=lim)


@pytest.mark.parametrize("name", CELLS)
def test_program_passes_the_check(name, capsys):
    out = _run(name, 2 ** 31 + 17)
    assert out["correct"], out["check"]
    assert out["failed"] == 0
    assert out["attempted"] >= 2
    nums = {k: v["value"] for k, v in out["check"].items()}
    assert nums["bad_coeffs"] == 0
    assert 0 < nums["row_max_err"] <= harness.cell_limits(
        cells.cell(name))["row_max_err"]
    assert set(out["metrics"]) == {"ct_per_s", "batch_ms_p95", "setup_s"}
    harness.report(out)
    cap = capsys.readouterr()
    line = json.loads(cap.out.strip().splitlines()[-1])
    assert list(line)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert cap.err.strip().splitlines()[-1].startswith("check ")


def test_traced_run_reports_host_metrics_only_on_cpu():
    out = _run("helr-paper.b8", 5, trace=True)
    assert out["correct"]
    # no device events on the CPU: no device metric is reported, none 0
    assert set(out["metrics"]) == {"engine_enqueue_ms"}
    assert out["device"]["busy_s"] == 0.0
    rec = out["extra"]["record"]
    assert rec["ops_traced"] == rec["ops_expected"]


@pytest.mark.parametrize("name", CELLS)
def test_lower_precision_fails(name):
    """The control, the program at the configuration's lower precision
    (scale 2^26 in place of 2^28), leaves at least three times the share
    of slots past the tolerance that the program does, and a limit
    between the two passes the program and fails the control. At log N 10
    and batches of 8, with the tolerance at twice the program's 90th
    percentile there, as the configuration's is at its own size (at log N
    9 the few slots that the rescale's rounding biases are too large a
    share of a row: helr read 2.9x on seed 4)."""
    over = cells.config(name.split(".")[0])["control_ckks"]
    for seed in (3, 4):
        cell = small_cell(name, log_n=10, batch=8)
        p90 = harness.execute(cell, seed, 0.1, False, "cpu", limits={})[
            "extra"]["readings"]["row_p90_err"]
        cell["config"]["slot_tol"] = 2 * p90
        a = harness.execute(cell, seed, 0.1, False, "cpu", limits={})[
            "extra"]["readings"]
        b = harness.execute(cell, seed, 0.1, False, "cpu", limits={},
                            ckks_override=over)["extra"]["readings"]
        assert b["row_tail_pct"] >= 3 * max(a["row_tail_pct"], 0.5), (
            seed, a, b)
        limit = {"row_tail_pct": float(np.sqrt(
            max(a["row_tail_pct"], 0.5) * b["row_tail_pct"])),
            "row_max_err": 1e9}
        rows = {"row_tail": [0.0], "row_max": [0.0]}
        assert harness.judge(dict(a, **rows), limit)["correct"]
        assert not harness.judge(dict(b, **rows), limit)["correct"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_planted_fault_fails(name, fault):
    with faults.FAULTS[fault]():
        out = _run(name, 9)
    assert not out["correct"], (fault, out["check"])
    assert out["failed"] > 0


def test_faults_are_removed_afterwards():
    for fault in faults.FAULTS.values():
        with fault():
            pass
    assert _run("matvec-paper.b8", 9)["correct"]


def test_no_input_repeats_within_a_window():
    """Every batch of the window gets inputs no earlier batch had: the
    queue's entries differ from each other, and each request adds its
    own shift to the entry it takes."""
    run = harness.Run(small_cell("helr-paper.b8"), 21, "cpu")
    seen = set()
    for n in range(3 * len(run.queue)):
        env, shift = run.arrive(n)
        for ct in env.values():
            key = ct.data.numpy().tobytes()
            assert key not in seen
            seen.add(key)
    c1 = [e[0][:, 1].numpy().tobytes() for e in run.queue]
    assert len(set(c1)) == len(c1)


def test_few_wrong_slots_fail_the_worst_slot_limit():
    """A few slots off past the configuration's worst-slot error fail the
    check though the share of slots past the tolerance stays within its
    limit."""
    readings = {"bad_coeffs": 0, "row_tail_pct": 1.0, "row_max_err": 0.9,
                "row_tail": [1.0, 0.5], "row_max": [0.1, 0.9]}
    lim = {"row_tail_pct": 8.0, "row_max_err": 0.5}
    chk = harness.judge(readings, lim)
    assert not chk["correct"] and chk["rows_failed"] == 1
    assert harness.judge(dict(readings, row_max_err=0.1,
                              row_max=[0.1, 0.1]), lim)["correct"]
