"""What the harness learns from the processes the program spawns (serving
workers, the ranks of a world): their device traces and each card's memory
peak, written as each process exits by ``workerhook/sitecustomize.py``.

Open :class:`WorkerHook` around the program's call that starts them; read
the traces with ``trace.ops_by_card`` (or ``trace.read_trace_dir`` for one
card) and the peaks with :func:`memory_by_card` once they have exited.
"""

from __future__ import annotations

import glob
import json
import os

HOOK_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "workerhook")
KEYS = ("PYTHONPATH", "PORTBENCH_WORKER_TRACE", "PORTBENCH_WORKER_MEMORY")


class WorkerHook:
    """While open, spawned processes start with ``workerhook`` on their
    path; those that exit normally write their device traces to
    ``trace_dir`` and their memory peaks to ``memory_dir`` (either may be
    ``None``: nothing of that kind, and with both ``None`` no hook)."""

    def __init__(self, trace_dir: str | None = None, memory_dir: str | None = None):
        self.trace_dir, self.memory_dir = trace_dir, memory_dir

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in KEYS}
        if self.trace_dir or self.memory_dir:
            pp = self.saved["PYTHONPATH"]
            os.environ["PYTHONPATH"] = HOOK_DIR + (os.pathsep + pp if pp else "")
        if self.trace_dir:
            os.environ["PORTBENCH_WORKER_TRACE"] = self.trace_dir
        if self.memory_dir:
            os.environ["PORTBENCH_WORKER_MEMORY"] = self.memory_dir
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def memory_by_card(path: str) -> dict[int, int]:
    """``{card: bytes}``: on each card, the sum of the allocator peaks of
    the processes that used it (one rank a card: that rank's peak)."""
    out: dict = {}
    for f in sorted(glob.glob(os.path.join(path, "memory-*.json"))):
        with open(f) as fh:
            for card, peak in json.load(fh).items():
                out[int(card)] = out.get(int(card), 0) + int(peak)
    return out
