"""Device tracing of spawned worker processes, for traced serving runs.

The benchmark puts this directory on ``PYTHONPATH`` only while it starts a
server in a ``--trace 1`` run, with ``PORTBENCH_WORKER_TRACE`` naming a
directory. Python imports this module as each process starts; in a
multiprocessing child it starts ``torch.profiler`` on the card's activity
and, as the process exits, writes the trace to that directory, where the
benchmark reads the workers' device time. Elsewhere it does nothing.
"""

import os
import sys

_DIR = os.environ.get("PORTBENCH_WORKER_TRACE")

if _DIR and "--multiprocessing-fork" in sys.argv:
    import atexit

    from torch.profiler import ProfilerActivity, profile

    _prof = profile(activities=[ProfilerActivity.CUDA])
    _prof.start()

    def _write() -> None:
        _prof.stop()
        _prof.export_chrome_trace(os.path.join(_DIR, f"worker-{os.getpid()}.json"))

    atexit.register(_write)
