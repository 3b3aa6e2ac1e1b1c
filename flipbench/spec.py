"""Find a cell's parts by name: `BENCHMARK.json` names the workload, its
configuration and traffic mix, and the metrics; each is a file of its own.

* configuration: the JSON file the configuration's entry names (its
  `generator` is a module of `flipbench/generators/`);
* traffic mix: `flipbench/traffic/<traffic>.json`;
* metric: `flipbench/metrics/<name>.py`, whose ``read(run)`` returns the
  number, or None when it finds nothing to read.

A new cell is new files and a new entry; no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    metrics: list           # metric entries this run reports


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(bench: dict, workload: str, trace: bool,
              root: Path = ROOT) -> Cell:
    """The cell `workload` of `bench`, with the metrics a run of it
    reports: the end-to-end ones untraced, the per-layer ones traced."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"there are {sorted(entries)}")
    w = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    metrics = bench["per_layer"] if trace else bench["end_to_end"]
    return Cell(name=workload, config=config,
                traffic=load_traffic(w["traffic"], root),
                chips=int(w["chips"]),
                metrics=[m for m in metrics if applies(m, workload)])


def load_traffic(name: str, root: Path = ROOT) -> dict:
    with open(root / "flipbench" / "traffic" / f"{name}.json") as f:
        return json.load(f)


def generator(name: str):
    """The generator module named by a configuration."""
    return importlib.import_module(f"flipbench.generators.{name}")


def metric_reader(name: str, root: Path = ROOT):
    """The `read` function of `flipbench/metrics/<name>.py`."""
    path = root / "flipbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"flipbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
