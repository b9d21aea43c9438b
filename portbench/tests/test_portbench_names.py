"""BENCHMARK.json against the benchmark's contract: names and units of
the allowed characters, the keys each entry may have, and every cell,
configuration, traffic mix and per-layer metric found by its name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("group", sorted(KEYS))
def test_entries_have_their_keys_and_names(group):
    seen = set()
    for e in BENCH[group]:
        extra = set(e) - KEYS[group] - {"workloads"}
        assert set(e) >= KEYS[group] and not extra, (e["name"], extra)
        assert NAME.match(e["name"]), e["name"]
        assert e["name"] not in seen
        seen.add(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
                assert "\t" not in e[key]
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])
        for key in e.get("reduced", []):
            assert NAME.match(key)


def test_cells_find_their_files():
    from portbench.harness import spec

    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"], BENCH)
        assert (spec.BENCH_DIR / "drivers"
                / f"{cell.config['driver']}.py").is_file()
        assert (spec.BENCH_DIR / "traffic"
                / f"{cell.traffic['generator']}.py").is_file()
        assert set(cell.workload["limits"]) >= {"voxel_m", "corr_rel",
                                               "icp_m", "gate_miss"}
    for m in BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_configs_are_files_under_paths():
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("portbench/")
        body = json.loads(path.read_text())
        assert set(c["reduced"]) <= set(body)
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
