"""The manifest holds to the benchmark's contract, every name in it is
found as a file, a new mix is a data file and a manifest entry, and nothing
the harness loads is JAX."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT
from yardstick import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def check_contract(m):
    """The contract's checks of a manifest: keys, names, bounds, and the
    cells on four chips, at most a quarter of them (rounded down) and one
    always."""
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert m["paths"] == ["portbench"] and 1 <= m["run_seconds"] <= 51
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
    four = sum(w["chips"] == 4 for w in m["workloads"])
    assert four <= max(1, len(m["workloads"]) // 4), f"{four} cells on 4 chips"
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")
    for x in m["end_to_end"]:
        assert x["source"] in ("host_clock", "device_trace") and 0.01 <= x["bound"] <= 0.25
    names = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names))


def test_manifest_keys_and_names():
    check_contract(manifest())


def _with_cells(n_four: int, n_one: int = 0) -> dict:
    """A copy of the manifest with ``n_four`` more cells on four chips and
    ``n_one`` more on one."""
    m = manifest()
    for i in range(n_four + n_one):
        m["workloads"].append({"name": f"wt10g.extra{i}", "config": "wt10g",
                               "traffic": "build", "chips": 4 if i < n_four else 1,
                               "why": "an added cell"})
    return m


@pytest.mark.parametrize("n_four,n_one", [(1, 0), (2, 5)])
def test_contract_takes_four_chip_cells_within_the_rule(n_four, n_one):
    """One cell on four chips is always allowed; two once there are 8 cells."""
    check_contract(_with_cells(n_four, n_one))


@pytest.mark.parametrize("n_four,n_one", [(2, 0), (3, 5)])
def test_contract_refuses_one_four_chip_cell_more(n_four, n_one):
    with pytest.raises(AssertionError, match="cells on 4 chips"):
        check_contract(_with_cells(n_four, n_one))


def test_contract_refuses_other_chip_counts():
    m = _with_cells(0, 1)
    m["workloads"][-1]["chips"] = 2
    with pytest.raises(AssertionError):
        check_contract(m)


@pytest.mark.parametrize("workload", [w["name"] for w in manifest()["workloads"]])
def test_each_cell_is_found_by_name(workload):
    cell = cells.load_cell(workload)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    kind = cells.kind_module(cell.mix["kind"])
    assert all(callable(getattr(kind, f)) for f in ("run", "breakdown", "control"))
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(cells.metric_reader(m["name"]))


def test_config_files_state_their_cuts():
    m = manifest()
    for c in m["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert all(k in cfg for k in c["reduced"])


def test_a_new_mix_is_a_data_file_and_a_manifest_entry(tmp_path):
    """A copy of the benchmark gains the mix ``build-two`` (two jobs) by one
    new file, its cell's manifest entry and the cell's name in the metrics'
    ``workloads``, and runs it."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    m = manifest()
    m["workloads"].append({"name": "wt10g.build-two", "config": "wt10g",
                           "traffic": "build-two", "chips": 1, "why": "two jobs"})
    for x in m["end_to_end"] + m["per_layer"]:
        if "wt10g.build" in x.get("workloads", ()):
            x["workloads"].append("wt10g.build-two")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    (tmp_path / "portbench" / "traffic" / "build-two.json").write_text(
        json.dumps({"kind": "build", "jobs": 2}))
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "from conftest import tiny_cell\n"
        "import run\n"
        "out = run.run_cell(tiny_cell('wt10g.build-two'), 5, 0.0, False, 'cpu')\n"
        "assert out['correct'] and out['attempted'] == 1, out\n"
        "print('ok', sorted(run.metrics_of(tiny_cell('wt10g.build-two'), out, False)))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(tmp_path / "portbench" / "tests"))
    r = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "portbench"), os.path.join(ROOT, "src")],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ok ['build_docs_per_hour', 'setup_s']" in r.stdout


def test_a_new_kind_of_traffic_is_a_module_a_mix_and_a_manifest_entry(tmp_path):
    """A copy of the benchmark gains the kind ``build-first`` (a module that
    runs only the first job of its mix), a mix of that kind and its cell by
    new files and manifest entries, and runs it."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    m = manifest()
    m["workloads"].append({"name": "wt10g.first", "config": "wt10g",
                           "traffic": "first", "chips": 1, "why": "one job"})
    for x in m["end_to_end"] + m["per_layer"]:
        if "wt10g.build" in x.get("workloads", ()):
            x["workloads"].append("wt10g.first")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    (tmp_path / "portbench" / "traffic" / "first.json").write_text(
        json.dumps({"kind": "build-first", "jobs": 3}))
    (tmp_path / "portbench" / "kinds" / "build-first.py").write_text(
        "import dataclasses\n"
        "from yardstick import cells\n"
        "_build = cells.kind_module('build')\n"
        "breakdown, control = _build.breakdown, _build.control\n"
        "def run(cell, *args):\n"
        "    cell = dataclasses.replace(cell, mix=dict(cell.mix, jobs=1))\n"
        "    return _build.run(cell, *args)\n")
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "from conftest import tiny_cell\n"
        "import run\n"
        "out = run.run_cell(tiny_cell('wt10g.first'), 6, 9.0, True, 'cpu')\n"
        "assert out['correct'] and out['attempted'] == 1, out\n"
        "print('ok', sorted(run.metrics_of(tiny_cell('wt10g.first'), out, True)))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(tmp_path / "portbench" / "tests"))
    r = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "portbench"), os.path.join(ROOT, "src")],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "'segment_write_s'" in r.stdout


def test_nothing_loaded_is_jax():
    """``run.py``, every kind and metric reader and a whole tiny run on the CPU load
    no module whose top-level name is ``jax``, ``jaxlib`` or ``repro``
    (whole names: ``repro_torch`` is the program)."""
    code = (
        "import glob, os, sys; sys.path[:0] = [sys.argv[1], sys.argv[2], sys.argv[3]]\n"
        "import run, control\n"
        "from yardstick import cells\n"
        "for f in glob.glob(os.path.join(sys.argv[1], 'metrics', '*.py')):\n"
        "    cells.metric_reader(os.path.basename(f)[:-3])\n"
        "for f in glob.glob(os.path.join(sys.argv[1], 'kinds', '*.py')):\n"
        "    cells.kind_module(os.path.basename(f)[:-3])\n"
        "from conftest import tiny_cell\n"
        "run.run_cell(tiny_cell('wt10g.build'), 1, 0.0, True, 'cpu')\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'repro'})\n"
        "assert not bad and run.forbidden_modules() == [], bad\n"
        "assert 'repro_torch' in sys.modules\n"
        "print('clean')\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code, BENCH, os.path.join(ROOT, "src"),
         os.path.join(BENCH, "tests")],
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr[-3000:]


def test_forbidden_names_are_whole_names(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "repro_torchlike", sys)
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in run.forbidden_modules()


def test_no_card_exits_non_zero_and_prints_no_result():
    r = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload", "wt10g.build",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
    )
    assert r.returncode != 0
    assert "metrics" not in r.stdout and "correct" not in r.stdout
