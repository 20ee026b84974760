"""Shared setup for spawning repro_torch worker processes.

Both the serving workers (store/serving.py) and the background compaction
worker (store/segments.py) **spawn** (never fork: CUDA contexts do not
survive a fork) and re-import the repro_torch package from scratch in the child.
That re-import has two environmental footguns, fixed here once:

* the parent may have made ``repro_torch`` importable via ``sys.path`` (a
  conftest, an editable checkout) rather than ``PYTHONPATH`` — the child
  would not inherit that, so the package root is pushed into
  ``PYTHONPATH`` for the duration of the spawns;
* spawn re-runs the parent's ``__main__`` in every child when the parent
  is a plain script (no module spec): an unguarded script would re-execute
  top-level code per child, and an interactive/stdin parent has a phantom
  ``"<stdin>"`` path the child cannot open. Workers import everything from
  repro_torch and need nothing from ``__main__``, so its file path is hidden
  while the children launch.
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import os
import sys


@contextlib.contextmanager
def spawn_friendly_env():
    """Yield a spawn multiprocessing context with the environment patched
    so children can re-import repro_torch; restores everything on exit (children
    launched inside the block keep running after it)."""
    ctx = mp.get_context("spawn")
    import repro_torch

    src_root = os.path.dirname(os.path.abspath(list(repro_torch.__path__)[0]))
    old_pp = os.environ.get("PYTHONPATH")
    parts = old_pp.split(os.pathsep) if old_pp else []
    if src_root not in parts:
        os.environ["PYTHONPATH"] = os.pathsep.join([src_root] + parts)
    main_mod = sys.modules.get("__main__")
    hide_main = (
        main_mod is not None
        and getattr(main_mod, "__spec__", None) is None
        and getattr(main_mod, "__file__", None) is not None
    )
    saved_main_file = main_mod.__file__ if hide_main else None
    if hide_main:
        del main_mod.__file__
    try:
        yield ctx
    finally:
        if old_pp is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = old_pp
        if hide_main:
            main_mod.__file__ = saved_main_file
