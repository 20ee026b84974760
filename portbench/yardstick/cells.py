"""Everything a cell needs, found by name: its entry in ``BENCHMARK.json``,
its configuration ``configs/<config>.json``, its traffic mix
``traffic/<traffic>.json``, the driver of the mix's ``kind``
``kinds/<kind>.py`` and a reader ``metrics/<metric>.py`` for each
per-layer metric. Adding a configuration, a mix, a kind of traffic or a
metric is adding its file and its manifest entry.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list[dict]   # the manifest entries this cell reports
    per_layer: list[dict]


def reports(metric: dict, cell: str, e2e_of_cell: set | None = None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells it lists, or, for a
    per-layer metric without a list, every cell that reports the
    end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_of_cell is None or metric.get("moves") in e2e_of_cell


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, manifest: dict | None = None) -> Cell:
    """The cell ``name`` of the manifest (``BENCHMARK.json`` at the root of
    the checkout unless given)."""
    if manifest is None:
        manifest = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    e2e = [m for m in manifest["end_to_end"] if reports(m, name)]
    names = {m["name"] for m in e2e}
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config=load_json(os.path.join(ROOT, cfg_entry["file"])),
        mix=load_json(os.path.join(BENCH_DIR, "traffic", entry["traffic"] + ".json")),
        end_to_end=e2e,
        per_layer=[m for m in manifest["per_layer"] if reports(m, name, names)],
    )


def _module(folder: str, name: str):
    path = os.path.join(BENCH_DIR, folder, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"{folder}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    return _module("metrics", name).read


def kind_module(kind: str):
    """``kinds/<kind>.py``: its ``run(cell, seed, seconds, trace, device,
    clock)``, ``breakdown(out)`` and ``control(cell, seed)``."""
    return _module("kinds", kind)
