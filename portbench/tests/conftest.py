"""Shared helpers of the benchmark's CPU tests. Run them from the root of
the checkout:

    PYTHONPATH=src python -m pytest -q portbench/tests
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# a size a CPU run holds: the cells' shapes at a fraction of their scale,
# counted with the host's methods (the card's plans need the card)
TINY_CONFIG = {"num_docs": 300, "serve_docs": 400, "vocab_size": 4096,
               "mean_len": 230.0, "serve_workers": 2}
TINY_METHOD = {"wt10g": "list-scan", "wt10g-dfdesc": "freq-split"}


def tiny_cell(name: str, manifest=None):
    """The cell ``name`` cut to :data:`TINY_CONFIG`, its method the host's."""
    from yardstick import cells

    cell = cells.load_cell(name, manifest)
    method = TINY_METHOD[cell.config["name"]]
    cell.config.update(TINY_CONFIG, method=method, expect_method=method)
    if cell.mix["kind"] == "serve":
        cell.mix.update(clients=3, sample_rows=400)
    return cell


@pytest.fixture
def tiny():
    return tiny_cell
