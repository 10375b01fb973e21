"""BENCHMARK.json against the benchmark's contract, and its parts found
by name: a new configuration, mix or metric is a new file, found without
an edit to any file that is there."""
import json
import re
import shutil

import pytest

from bench import cells, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = cells.spec()


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024
    assert all(not w.startswith("/") and ".." not in w
               for w in SPEC["command"])


def test_names_units_and_entries():
    names = [c["name"] for c in SPEC["configs"]]
    cells_ = [w["name"] for w in SPEC["workloads"]]
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    for group in (names, cells_, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and c["reduced"] == ["ckks"]
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert c["name"] in {w["config"] for w in SPEC["workloads"]}
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert {"ct_per_s", "batch_ms_p95", "setup_s"} == e2e
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m.get("workloads", cells_)) <= set(cells_)
    assert any("mfu" in m["name"] for m in SPEC["per_layer"])


@pytest.mark.parametrize("w", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves(w):
    c = cells.cell(w)
    assert c["config"]["name"] == w.split(".")[0]
    fn, n_inputs, consts = cells.program(c["config"])
    assert callable(fn) and n_inputs >= 1
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(cells.reader(m["name"]))
    assert "row_tail_pct" in cells.limits(w)
    assert 0 < c["config"]["slot_max_tol"] < 1
    assert {m["name"] for m in c["end_to_end"]} == {
        "ct_per_s", "batch_ms_p95", "setup_s"}
    assert c["per_layer"]


def test_configs_are_the_papers_shape_in_the_ports_word32_limbs():
    """log N, L and dnum are the paper's; the limb widths, and so the
    `ckks` group that `reduced` names, are the port's word32 preset."""
    from repro_torch.core.params import CkksParams, paper_params_bootstrap
    for c in SPEC["configs"]:
        cfg = cells.config(c["name"])
        assert c["source"] == cfg["source"]
        assert c["reduced"] == cfg["reduced"] == ["ckks"]
        assert "ckks" in cfg["assumed"]
        for k in ("log_n", "n_levels", "dnum"):
            assert cfg["ckks"][k] == cfg["paper"][k]
        assert CkksParams(**harness.ckks_numbers(cfg)) == \
            paper_params_bootstrap()


def test_new_files_are_found_without_edits(tmp_path, monkeypatch):
    root = tmp_path / "repo"
    shutil.copytree(cells.BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = dict(SPEC)
    (root / "bench" / "traffic" / "b3.json").write_text(json.dumps(
        {"batch": 3, "pool": 1, "queue": 2, "input_low": -0.5,
         "input_high": 0.5, "shift": 0.05, "checked": 1}))
    (root / "bench" / "metrics" / "batches.py").write_text(
        "def read(rec):\n    return rec.get('batches')\n")
    spec["workloads"] = spec["workloads"] + [
        {"name": "matvec-paper.b3", "config": "matvec-paper",
         "traffic": "b3", "chips": 1, "why": "test"}]
    spec["per_layer"] = spec["per_layer"] + [
        {"name": "batches", "unit": "batches", "better": "higher",
         "source": "program_counter", "layer": "engine",
         "moves": "ct_per_s", "workloads": ["matvec-paper.b3"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(cells, "BENCH", root / "bench")
    monkeypatch.setattr(cells, "ROOT", root)
    c = cells.cell("matvec-paper.b3")
    assert c["traffic"]["batch"] == 3
    assert "batches" in [m["name"] for m in c["per_layer"]]
    assert cells.reader("batches")({"batches": 4}) == 4
    other = cells.cell("helr-paper.b8")
    assert "batches" not in [m["name"] for m in other["per_layer"]]
