"""What a cell is made of, found by the names in ``BENCHMARK.json``.

A cell ``<name>`` of ``BENCHMARK.json`` has ``portbench/workloads/<name>.json``
(profiled and checked request counts, the limits of its comparison); its
configuration ``portbench/configs/<config>.json`` names the driver
``portbench/drivers/<driver>.py`` that runs a request; its traffic mix
``portbench/traffic/<traffic>.json`` names the generator
``portbench/traffic/<generator>.py`` that reads it; each per-layer metric
``<metric>`` is read by ``portbench/metrics/<metric>.py``. A later cell,
configuration, mix or metric is a file and an entry, and no edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import a file of the benchmark by its path."""
    if not path.is_file():
        raise FileNotFoundError(f"no {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict  # the cell's entry in BENCHMARK.json
    workload: dict  # workloads/<name>.json
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    end_to_end: list  # BENCHMARK.json metrics this cell reports
    per_layer: list

    def driver(self):
        name = self.config["driver"]
        return load_module(BENCH_DIR / "drivers" / f"{name}.py",
                           f"portbench_driver_{name}")

    def generator(self):
        name = self.traffic["generator"]
        return load_module(BENCH_DIR / "traffic" / f"{name}.py",
                           f"portbench_traffic_{name}")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader(metric: str):
    """The per-layer metric's reader: ``read(trace) -> float | None``."""
    return load_module(BENCH_DIR / "metrics" / f"{metric}.py",
                       "portbench_metric_" + metric.replace(".", "_")).read


def cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    workload = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    config = load_json(BENCH_DIR / "configs" / f"{entry['config']}.json")
    traffic = load_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    return Cell(
        name=name, entry=entry, workload=workload, config=config,
        traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )
