"""The port's serving driver against the JAX package's, and the port's
independence from it.

``serve(..., device="cpu")`` at a small size must build the same store and
answer the same Zipf workload as the reference driver. Entry points default
to the card and raise without one. In a clean interpreter, importing every
``repro_torch`` module must load neither JAX nor the reference package.
"""

import filecmp
import json
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import cooc_serve as jax_cooc_serve  # noqa: E402
from repro.store import QueryEngine as JQueryEngine  # noqa: E402
from repro.store import Store as JStore  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.core.cooc import count_to_store  # noqa: E402
from repro_torch.core.list_scan import count_list_scan_segment  # noqa: E402
from repro_torch.core.plan import CountJob, execute_job  # noqa: E402
from repro_torch.core.types import StatsSink  # noqa: E402
from repro_torch.data.corpus import synthetic_zipf_collection  # noqa: E402
from repro_torch.launch import cooc_serve  # noqa: E402
from repro_torch.store import QueryEngine, Store  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.mark.parametrize("score", ["count", "pmi", "dice"])
def test_serve_inprocess_answers_like_jax(score, tmp_path):
    kw = dict(docs=200, vocab=256, method="list-scan", queries=128, batch=32,
              topk=5, score=score)
    got = cooc_serve.serve(store_path=str(tmp_path / "t"), device="cpu", **kw)
    want = jax_cooc_serve.serve(store_path=str(tmp_path / "j"), **kw)
    for key in ("num_docs", "segments", "store_format", "score", "batch"):
        assert got[key] == want[key]
    # the same draws hit the same rows: identical cache traffic
    assert got["row_cache"] == want["row_cache"]
    seg_t = Store.open(got["store"]).segments[0].path
    seg_j = JStore.open(want["store"]).segments[0].path
    for name in ("row_ptr.bin", "cols.bin", "counts.bin", "sym_cols.bin"):
        assert filecmp.cmp(os.path.join(seg_t, name), os.path.join(seg_j, name),
                           shallow=False)
    terms = np.arange(256)
    ti, ts = QueryEngine(Store.open(got["store"]), device="cpu").topk(terms, k=5, score=score)
    ji, js = JQueryEngine(JStore.open(want["store"])).topk(terms, k=5, score=score)
    np.testing.assert_array_equal(ti, ji)
    if score == "pmi":
        np.testing.assert_array_max_ulp(ts, js, maxulp=1)
    else:
        np.testing.assert_array_equal(ts, js)


def test_serve_reopens_a_store(tmp_path, capsys):
    path = str(tmp_path / "s")
    cooc_serve.serve(docs=80, vocab=64, store_path=path, queries=32, batch=16,
                     device="cpu")
    stats = cooc_serve.serve(store_path=path, queries=32, batch=16, device="cpu")
    assert stats["build_s"] == 0.0 and stats["num_docs"] == 80
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == stats


def test_default_device_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = synthetic_zipf_collection(20, vocab=30, mean_len=6, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        count_to_store("list-scan-segment", c, str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        count_list_scan_segment(c, StatsSink())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        execute_job(CountJob(collection=c, output="stats"))  # auto: the card
    store, _ = count_to_store("list-scan", c, str(tmp_path / "b"), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QueryEngine(store)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cooc_serve.serve(store_path=str(tmp_path / "b"), queries=8, batch=8)


@pytest.mark.parametrize(
    "argv,slice_name",
    [
        (["--workers", "2"], "multi-process serving"),
        (["--follow", "feed.txt"], "streaming ingest"),
        (["--compact"], "background compaction"),
    ],
)
def test_cli_rejects_flags_of_later_slices(argv, slice_name, capsys):
    with pytest.raises(SystemExit) as e:
        cooc_serve.main(argv)
    assert e.value.code == 2
    assert slice_name in capsys.readouterr().err


def test_port_imports_neither_jax_nor_the_reference():
    names = sorted(
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
    )
    assert "repro_torch.kernels.ops" in names and len(names) > 20
    code = (
        "import importlib, json, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, timeout=300, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
