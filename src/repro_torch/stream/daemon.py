"""Micro-segment stream ingestor: bounded visibility lag over an LSM store.

:class:`StreamIngestor` tails a document source (see
:mod:`repro_torch.stream.source`), buffers arriving documents in memory, and
**seals** the buffer into a micro-segment whenever either trigger fires:

* size — ``seal_docs`` documents are buffered, or
* age — the *oldest* buffered document has waited ``seal_age_ms``
  (defaults to half of ``max_visibility_lag_ms``, leaving the other half
  of the budget for the count + write + commit itself).

A seal is the exact batch pipeline in miniature: the buffered documents
become a :class:`~repro_torch.data.corpus.Collection`, co-occurrences are
counted with a registered method into a budgeted
:class:`~repro_torch.store.builder.SpillSink`, and the merged rows commit
through ``Store.add_segment_from_rows(..., single_commit=True)`` with the
stream cursor advanced in the **same** flock'd manifest commit (see
:mod:`repro_torch.stream.cursor`). Counts are additive and exact for every
method, so where the micro-batch boundaries fall never changes the fully
compacted store — byte-for-byte — relative to a one-shot batch build;
streaming only changes *when* documents become queryable, and this daemon
bounds that.

Doc-to-queryable latency (arrival → commit visible) is recorded per
document into a mergeable ``stream/visibility_lag_s`` histogram;
``summary()`` reports its quantiles next to docs/seals throughput.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass

import numpy as np

import repro_torch.obs as obs
from repro_torch.core.cooc import count
from repro_torch.core.specs import get_spec
from repro_torch.device import resolve_device
from repro_torch.store.builder import SpillSink
from repro_torch.stream.cursor import CursorState, StreamCursor

# test hook: after this many seals the daemon parks forever (until killed),
# giving SIGKILL-mid-stream tests a deterministic crash point *between*
# commits — the cursor then proves exactly-once resume.
_STALL_ENV = "REPRO_TEST_STREAM_STALL_AFTER_SEALS"


# each device's own seal method: what ``method="auto"`` ranks there for a
# micro-batch (core/plan.py RANKED_KINDS), and the reference's default on
# the host
DEVICE_METHODS = {"cuda": "list-scan-segment", "cpu": "list-scan"}


@dataclass
class StreamConfig:
    """Tuning for one :class:`StreamIngestor`.

    ``max_visibility_lag_ms`` is the contract the daemon works to: every
    document should be queryable (committed to the manifest) within this
    long of arriving, provided a seal itself fits the budget. ``seal_docs``
    caps micro-segment size so a fast producer doesn't defer visibility
    behind one giant seal.

    ``device`` is where each seal counts: ``method`` defaults to the
    device's own (``DEVICE_METHODS``: ``list-scan-segment`` on the
    ``segment_hist`` kernel for ``"cuda"``, the host ``list-scan`` for
    ``"cpu"``), and a method that takes a device is handed this one.
    """

    method: str | None = None         # default: DEVICE_METHODS[device]
    seal_docs: int = 2048
    max_visibility_lag_ms: float = 2_000.0
    seal_age_ms: float | None = None  # default: max_visibility_lag_ms / 2
    poll_interval_ms: float = 20.0
    memory_budget_pairs: int = 4 << 20
    max_docs: int | None = None       # stop after committing this many docs
    idle_timeout_s: float | None = None  # stop after this long with no input
    device: str = "cuda"

    def __post_init__(self):
        kind = str(self.device).split(":")[0]
        if kind not in DEVICE_METHODS:
            raise ValueError(
                f"unsupported device {self.device!r}; have 'cuda', 'cpu'"
            )
        if self.method is None:
            self.method = DEVICE_METHODS[kind]
        if self.seal_docs < 1:
            raise ValueError("seal_docs must be >= 1")
        if self.max_visibility_lag_ms <= 0:
            raise ValueError("max_visibility_lag_ms must be > 0")
        if self.seal_age_ms is None:
            self.seal_age_ms = self.max_visibility_lag_ms / 2.0
        if self.seal_age_ms <= 0:
            raise ValueError("seal_age_ms must be > 0")


class StreamIngestor:
    """Tail ``source`` into ``store`` as micro-segments, resumably.

    ``run()`` drives the loop inline; ``start()``/``stop()`` wrap it in a
    daemon thread for embedding (e.g. ``cooc_serve --follow``). Restarting
    after any crash is safe: the constructor-loaded cursor says exactly
    which source prefix is already committed, and the fenced cursor
    mutation makes a duplicate commit impossible even with two daemons
    racing on one source.
    """

    def __init__(self, store, source, config: StreamConfig | None = None, *,
                 source_id: str, registry=None):
        self.store = store
        self.source = source
        self.config = config or StreamConfig()
        self.source_id = str(source_id)
        # raises without a card when the seals are to count on one
        resolve_device(self.config.device)
        self._count_kwargs = (
            {"device": self.config.device}
            if "device" in get_spec(self.config.method).defaults() else {}
        )
        self.reg = registry if registry is not None else obs.get_registry()
        self.cursor = StreamCursor(store, self.source_id)
        self.lag_hist = obs.Histogram()     # doc arrival → queryable, seconds
        self.seal_hist = obs.Histogram()    # per-seal commit duration, seconds
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._state = self.cursor.load()
        self._docs_run = 0                  # committed by *this* run
        self._seals_run = 0
        self._last_lags: list[float] = []   # lags of the most recent seal
        self.source.seek(self._state.offset)

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "StreamIngestor":
        if self._thread is not None:
            raise RuntimeError("ingestor already started")
        self._thread = threading.Thread(
            target=self._run_guarded, name=f"stream-{self.source_id}",
            daemon=True,
        )
        self._thread.start()
        return self

    def _run_guarded(self) -> None:
        """Thread target: a failure (e.g. a StreamCursorConflict from a
        second daemon on the same source) must not vanish into a default
        thread traceback while the host keeps serving — it is recorded,
        flips ``healthy``, lands in ``summary()``, and re-raises from the
        next ``stop()``."""
        try:
            self.run()
        except BaseException as e:
            self._error = e
            self.reg.counter("stream/failures").inc(1)

    @property
    def healthy(self) -> bool:
        """False once a ``start()``-ed run has died on an exception."""
        return self._error is None

    @property
    def error(self) -> BaseException | None:
        return self._error

    def stop(self, timeout: float | None = 30.0, *,
             raise_on_error: bool = True) -> None:
        """Ask the loop to finish (it seals whatever is buffered first).
        If the threaded run died on an exception, re-raises it here —
        pass ``raise_on_error=False`` to inspect ``summary()`` /
        ``error`` instead."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        if raise_on_error and self._error is not None:
            raise self._error

    # ------------------------------------------------------------- the loop
    def run(self) -> dict:
        cfg = self.config
        buf_terms: list[np.ndarray] = []
        buf_arrived: list[float] = []
        pending_offset = self._state.offset
        last_input = time.monotonic()
        with self.reg.span("stream/run", source=self.source_id):
            while True:
                # never buffer past one seal's worth: micro-segment size
                # stays deterministic even when the source has a backlog
                budget = cfg.seal_docs - len(buf_terms)
                if cfg.max_docs is not None:
                    budget = min(
                        budget,
                        cfg.max_docs - self._docs_run - len(buf_terms),
                    )
                polled = self.source.poll(budget) if budget > 0 else []
                now = time.monotonic()
                for off, terms in polled:
                    buf_terms.append(self._normalize(terms))
                    buf_arrived.append(now)
                    pending_offset = off
                if polled:
                    last_input = now
                done = (
                    self._stop.is_set()
                    or getattr(self.source, "exhausted", False)
                    or (cfg.max_docs is not None
                        and self._docs_run + len(buf_terms) >= cfg.max_docs)
                    or (cfg.idle_timeout_s is not None and not buf_terms
                        and now - last_input >= cfg.idle_timeout_s)
                )
                oldest_ms = (
                    (now - buf_arrived[0]) * 1e3 if buf_arrived else 0.0
                )
                if buf_terms and (
                    done or len(buf_terms) >= cfg.seal_docs
                    or oldest_ms >= cfg.seal_age_ms
                ):
                    self._seal(buf_terms, buf_arrived, pending_offset)
                    buf_terms, buf_arrived = [], []
                    self._maybe_stall()
                if done and not buf_terms:
                    break
                if not polled:
                    time.sleep(cfg.poll_interval_ms / 1e3)
        return self.summary()

    # ------------------------------------------------------------- internals
    def _normalize(self, terms) -> np.ndarray:
        """Apply the Collection invariant: sorted unique int32 term IDs in
        ``[0, vocab_size)``. Raises on out-of-range terms — a feed with a
        wrong vocabulary must fail loudly, not corrupt counts."""
        t = np.unique(np.asarray(terms, dtype=np.int64))
        if t.size and (t[0] < 0 or t[-1] >= self.store.vocab_size):
            raise ValueError(
                f"stream document has term IDs outside "
                f"[0, {self.store.vocab_size}): "
                f"min={int(t[0])} max={int(t[-1])}"
            )
        return t.astype(np.int32)

    def _seal(self, buf_terms, buf_arrived, new_offset: int) -> None:
        from repro_torch.data.corpus import Collection

        cfg = self.config
        t0 = time.monotonic()
        ptr = np.zeros(len(buf_terms) + 1, dtype=np.int64)
        ptr[1:] = np.cumsum([t.size for t in buf_terms])
        terms = (
            np.concatenate(buf_terms) if buf_terms else
            np.zeros(0, dtype=np.int32)
        )
        c = Collection(ptr, terms, self.store.vocab_size)
        df = np.bincount(terms, minlength=self.store.vocab_size)
        with self.reg.span(
            "stream/seal", docs=c.num_docs, method=cfg.method,
            source=self.source_id,
        ) as sp:
            with SpillSink(
                self.store.vocab_size,
                memory_budget_pairs=cfg.memory_budget_pairs,
            ) as sink:
                count(cfg.method, c, sink, **self._count_kwargs)
                seg = self.store.add_segment_from_rows(
                    sink.merged_rows(),
                    df=df,
                    num_docs=c.num_docs,
                    source=f"stream:{self.source_id}",
                    single_commit=True,
                    extra_mutate=self.cursor.advance_mutation(
                        self._state, new_offset, c.num_docs
                    ),
                )
            sp.set(nnz=int(seg.nnz))
        t1 = time.monotonic()
        self._last_lags = [t1 - a for a in buf_arrived]
        for lag in self._last_lags:
            self.lag_hist.record(lag)
        self.seal_hist.record(t1 - t0)
        self._state = CursorState(
            offset=int(new_offset),
            docs=self._state.docs + c.num_docs,
            seals=self._state.seals + 1,
        )
        self._docs_run += c.num_docs
        self._seals_run += 1
        self.reg.counter("stream/docs").inc(c.num_docs)
        self.reg.counter("stream/seals").inc(1)
        self.reg.gauge("stream/cursor_offset").set(int(new_offset))

    def _maybe_stall(self) -> None:
        stall_after = int(os.environ.get(_STALL_ENV, "0") or "0")
        if stall_after and self._seals_run >= stall_after:
            while True:  # park until SIGKILLed by the test harness
                time.sleep(0.1)

    # ------------------------------------------------------------- reporting
    def summary(self) -> dict:
        """Cursor position plus visibility-lag and seal-cost quantiles (this
        process's seals only; cursor totals span all runs)."""
        out = {
            "source_id": self.source_id,
            "cursor": self._state.as_dict(),
            "docs_this_run": self._docs_run,
            "seals_this_run": self._seals_run,
            "max_visibility_lag_ms": self.config.max_visibility_lag_ms,
            "method": self.config.method,
            "device": str(self.config.device),
            "healthy": self.healthy,
        }
        if self._error is not None:
            out["error"] = f"{type(self._error).__name__}: {self._error}"
        if self.lag_hist.count:
            out["visibility_lag_ms"] = {
                "p50": self.lag_hist.percentile(50) * 1e3,
                "p99": self.lag_hist.percentile(99) * 1e3,
                "max": self.lag_hist.vmax * 1e3,
            }
        if self.seal_hist.count:
            out["seal_s"] = {
                "p50": self.seal_hist.percentile(50),
                "p99": self.seal_hist.percentile(99),
                "max": self.seal_hist.vmax,
            }
        return out
