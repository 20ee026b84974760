"""Device tracing and memory peaks of spawned processes: serving workers,
the ranks of a world.

The benchmark puts this directory on ``PYTHONPATH`` only while it starts
the program's processes, with ``PORTBENCH_WORKER_TRACE`` or
``PORTBENCH_WORKER_MEMORY`` naming a directory. Python imports this module
as each process starts. In a multiprocessing child (``--multiprocessing-fork``
on its command line: every child of a spawn context, those of
``torch.multiprocessing.spawn`` too):

* with ``PORTBENCH_WORKER_TRACE`` it starts ``torch.profiler`` on the
  card's activity (the host's where the process has no card) and, as the
  process exits, writes the trace to ``worker-<pid>.json`` there;
* with ``PORTBENCH_WORKER_MEMORY`` it writes, as the process exits,
  ``memory-<pid>.json``: ``{card: the caching allocator's peak reserved
  bytes}`` of each card the process used.

Elsewhere it does nothing.
"""

import os
import sys

_DIR = os.environ.get("PORTBENCH_WORKER_TRACE")
_MEM = os.environ.get("PORTBENCH_WORKER_MEMORY")

if (_DIR or _MEM) and "--multiprocessing-fork" in sys.argv:
    import atexit

    if _DIR:
        from torch.profiler import ProfilerActivity, profile

        try:
            _prof = profile(activities=[ProfilerActivity.CUDA])
            _prof.start()
        except AssertionError:  # a build of torch without the card's activity
            _prof = profile(activities=[ProfilerActivity.CPU])
            _prof.start()

    def _write() -> None:
        if _DIR:
            _prof.stop()
            _prof.export_chrome_trace(os.path.join(_DIR, f"worker-{os.getpid()}.json"))
        if _MEM:
            import json

            import torch

            peaks = {}
            if torch.cuda.is_initialized():
                for c in range(torch.cuda.device_count()):
                    if torch.cuda.max_memory_reserved(c):
                        peaks[c] = torch.cuda.max_memory_reserved(c)
            with open(os.path.join(_MEM, f"memory-{os.getpid()}.json"), "w") as f:
                json.dump(peaks, f)

    atexit.register(_write)
