"""Find a cell's parts by name.

`BENCHMARK.json` at the root names each cell's configuration and
traffic mix and each metric. The parts live in files of their own, found
by those names, so a new cell, mix, configuration or metric is a new
file and a new entry, never an edit:

    bench/configs/<config>.json     sizes, program, compiler settings
    bench/programs/<program>.py     `make(**program_args)` ->
                                    (fn, n_inputs, const names)
    bench/traffic/<traffic>.json    batch, base pool, queue, inputs,
                                    shift, batches checked
    bench/metrics/<metric>.py       `read(records)` -> number or None
    bench/limits/<cell>.json        the limits set from readings (the
                                    worst slot error is the config's)
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def spec() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def _module(path: Path):
    if not path.exists():
        raise FileNotFoundError(path)
    m = importlib.util.spec_from_file_location(
        "bench_part_" + path.stem.replace("-", "_").replace(".", "_"), path)
    mod = importlib.util.module_from_spec(m)
    m.loader.exec_module(mod)
    return mod


def config(name: str) -> Dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> Dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def program(cfg: Dict):
    """(fn, n_inputs, const names) of a configuration's program."""
    mod = _module(BENCH / "programs" / f"{cfg['program']}.py")
    return mod.make(**cfg.get("program_args", {}))


def reader(metric: str) -> Callable[[Dict], Optional[float]]:
    return _module(BENCH / "metrics" / f"{metric}.py").read


def limits(cell: str) -> Dict:
    path = BENCH / "limits" / f"{cell}.json"
    return load_json(path) if path.exists() else {}


def cell(name: str) -> Dict:
    """A cell of BENCHMARK.json with its configuration, mix and the
    metrics it reports."""
    bench = spec()
    for w in bench["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def applies(m: Dict) -> bool:
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    names = [m["name"] for m in e2e]
    layer = [m for m in bench["per_layer"]
             if applies(m) and m["moves"] in names]
    return {"name": name, "chips": w["chips"],
            "config": config(w["config"]), "traffic": traffic(w["traffic"]),
            "end_to_end": e2e, "per_layer": layer}
