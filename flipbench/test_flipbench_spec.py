"""BENCHMARK.json and the files it names: each configuration, traffic mix
and metric is found by name, and the entries keep the benchmark's rules."""
import json
import re

import pytest

from flipbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["flipbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all((spec.ROOT / p).is_dir() for p in BENCH["paths"])
    assert (spec.ROOT / BENCH["command"][1]).is_file()


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_are_found_by_name(cell):
    for trace in (False, True):
        c = spec.find_cell(BENCH, cell, trace)
        assert c.config["generator"]
        spec.generator(c.config["generator"])
        assert c.traffic["loop"] in ("closed", "open")
        assert c.chips == 1
        for m in c.metrics:
            assert callable(spec.metric_reader(m["name"]))
    e2e = {m["name"] for m in spec.find_cell(BENCH, cell, False).metrics}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.find_cell(BENCH, cell, True).metrics


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert spec.applies(moved, cell), (m["name"], cell)


def test_configs_name_their_files_and_cuts():
    for c in BENCH["configs"]:
        with open(spec.ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert c["file"].startswith("flipbench/configs/")
