"""LSM-style co-occurrence store: a manifest of immutable CSR segments.

A store directory holds ``store.json`` plus one subdirectory per segment:

    store.json       {generation, vocab_size, segments: [...],
                      next_seg_id, segment_version}
    seg-00000/       immutable segment (csr_store.py layout, v1 raw or
    seg-00001/        v2 block-compressed — formats coexist freely)
    ...

Counts are additive across document batches (C = Σ_s B_sᵀ B_s), so the
store supports **exact incremental appends**: counting a new document batch
produces a new segment; queries sum counts across segments; ``compact()``
k-way-merges segments back together with no loss of exactness. The same
merge path ingests per-shard outputs of the distributed runner, following
the inverted-index-based real-time construction of Cheng (2023).

Concurrency model: segments are immutable, so the manifest is the only
mutable state. Every commit is a read-modify-write of ``store.json`` under
an advisory ``flock`` (``.store.lock``), which lets a **background
compaction process** merge small segments while the owning process keeps
appending — neither clobbers the other's manifest entry. Within one
process, a single handle may also be shared across threads (a stream
ingestor sealing while a compaction daemon polls ``refresh()``): the
flock cannot serialize those (same file handle, same process), so a
per-handle ``threading.RLock`` additionally guards every reassignment of
``self.manifest`` — ``_commit`` holds it across its read-modify-write so
a concurrent ``refresh()`` can never replace the manifest between the
mutation and the save and silently drop the commit. Readers never take
the cross-process lock: ``refresh()`` detects foreign commits with one
``stat()`` plus a ``generation`` counter cross-check (the counter,
serialized first in store.json, catches the in-place same-size same-mtime
rewrite a bare stat signature can miss), and mmaps opened before a
compaction keep working after it because POSIX unlink only detaches the
name.

Size-tiered compaction: ``plan_compaction()`` picks the smallest run of
similar-sized segments (read-amplification reducers first, never a
rewrite of one big segment to absorb a tiny one), ``compact(names=...)``
merges exactly those, and ``compact_background()`` runs that in a spawned
worker process — the serving workers pick up the swap via their existing
between-batch ``refresh()``.
"""

from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading

import numpy as np

try:
    import fcntl
except ImportError:  # non-POSIX: single-process use keeps working unlocked
    fcntl = None

from repro_torch.store.builder import SpillSink, merge_row_streams, sum_by_key
from repro_torch.store.csr_store import (
    DEFAULT_SEGMENT_VERSION,
    open_segment,
    segment_bytes,
    write_segment,
)
from repro_torch.store.spawn import spawn_friendly_env

STORE_META = "store.json"
LOCK_NAME = ".store.lock"

_GENERATION_RE = re.compile(rb'"generation":\s*(\d+)')
_PENDING_RE = re.compile(r"\.pending-(\d+)-")


def _pid_alive(pid: int) -> bool:
    """Whether ``pid`` is a live process (EPERM counts as alive)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:  # EPERM and friends: someone is there
        return True
    return True


class Store:
    """A directory of CSR segments behind a JSON manifest."""

    def __init__(self, path: str, manifest: dict, *, registry=None):
        self.path = path
        self.manifest = manifest
        self.registry = registry
        self._segments: dict[str, object] = {}
        # serializes manifest reassignment across threads sharing this
        # handle (commit vs. refresh); the flock in _commit only covers
        # other processes / other handles
        self._mutex = threading.RLock()
        # bumped on every manifest mutation; query engines use it to know
        # when their row caches are stale
        self.version = 0
        # (inode, mtime_ns, size) of store.json as last read/written; lets
        # refresh() detect another process's commit with one stat()
        self._meta_sig = self._stat_sig()

    # ------------------------------------------------------- lifecycle
    @classmethod
    def create(
        cls, path: str, vocab_size: int, *, segment_version: int | None = None,
        registry=None,
    ) -> "Store":
        """Create an empty store. ``segment_version`` fixes the on-disk
        format of every segment this store writes (1 = raw arrays,
        2 = block-compressed; default 1) — recorded in the manifest, so
        every later append and compaction agrees."""
        if os.path.exists(os.path.join(path, STORE_META)):
            raise FileExistsError(f"store already exists at {path}")
        os.makedirs(path, exist_ok=True)
        store = cls(
            path,
            {
                "generation": 0,
                "vocab_size": vocab_size,
                "segments": [],
                "next_seg_id": 0,
                "segment_version": int(
                    DEFAULT_SEGMENT_VERSION
                    if segment_version is None else segment_version
                ),
            },
            registry=registry,
        )
        store._save()
        return store

    @classmethod
    def open(cls, path: str, *, registry=None) -> "Store":
        with open(os.path.join(path, STORE_META)) as f:
            store = cls(path, json.load(f), registry=registry)
        store._sweep_pending()
        return store

    @staticmethod
    def exists(path: str) -> bool:
        return os.path.exists(os.path.join(path, STORE_META))

    def _sweep_pending(self) -> None:
        """Remove ``.pending-*`` segment directories abandoned by dead
        writers. Pending dirs are only referenced by the ``single_commit``
        call that created them — never by a manifest — so once the pid
        embedded in the name is gone (SIGKILL mid-seal), the directory is
        unreachable garbage. Live pids are left alone: their commit may
        still be in flight."""
        try:
            entries = os.listdir(self.path)
        except OSError:
            return
        for name in entries:
            m = _PENDING_RE.match(name)
            if m and not _pid_alive(int(m.group(1))):
                shutil.rmtree(
                    os.path.join(self.path, name), ignore_errors=True
                )

    def _stat_sig(self) -> tuple | None:
        try:
            st = os.stat(os.path.join(self.path, STORE_META))
        except OSError:
            return None
        return (st.st_ino, st.st_mtime_ns, st.st_size)

    def _probe_generation(self) -> int | None:
        """The manifest's generation counter with one small read — it is
        serialized as the first key, so the head of the file suffices."""
        try:
            with open(os.path.join(self.path, STORE_META), "rb") as f:
                m = _GENERATION_RE.search(f.read(96))
        except OSError:
            return None
        return int(m.group(1)) if m else None

    def _save(self) -> None:
        with self._mutex:
            # generation first: refresh()'s probe reads only the head
            gen = int(self.manifest.get("generation", 0)) + 1
            m = {"generation": gen}
            m.update(
                (k, v) for k, v in self.manifest.items() if k != "generation"
            )
            self.manifest = m
            tmp = os.path.join(self.path, STORE_META + ".tmp")
            with open(tmp, "w") as f:
                json.dump(self.manifest, f, indent=2)
            os.replace(tmp, os.path.join(self.path, STORE_META))
            self._meta_sig = self._stat_sig()
            self.version += 1

    def _commit(self, mutate) -> None:
        """Read-modify-write the manifest under the store's advisory lock
        (cross-process) *and* the handle mutex (cross-thread): re-read the
        freshest manifest (a background compaction or a sibling appender
        may have committed since we last looked), apply ``mutate`` to it,
        write. The mutex stays held from the re-read through ``_save`` so
        a concurrent ``refresh()`` on this same handle can never reassign
        ``self.manifest`` mid-commit and drop the mutation."""
        with self._mutex:
            lf = open(os.path.join(self.path, LOCK_NAME), "a")
            try:
                if fcntl is not None:
                    fcntl.flock(lf, fcntl.LOCK_EX)
                try:
                    with open(os.path.join(self.path, STORE_META)) as f:
                        on_disk = json.load(f)
                except (OSError, json.JSONDecodeError):
                    on_disk = None
                if on_disk is not None and on_disk.get(
                    "generation", 0
                ) != self.manifest.get("generation", 0):
                    # a foreign commit landed: adopt it (and drop lazily-
                    # opened segments it may have removed) before applying
                    # ours on top
                    self.manifest = on_disk
                    self._segments.clear()
                mutate(self.manifest)
                self._save()
            finally:
                lf.close()  # closing releases the flock

    def refresh(self) -> bool:
        """Pick up another process's manifest commit (append / ingest /
        compact). Cheap when nothing changed — one ``stat()`` of store.json,
        plus a head-of-file generation cross-check that catches the case a
        stat signature cannot: an in-place rewrite that lands on the same
        inode, size, and (coarse-clock) mtime. On change the manifest is
        re-read, lazily-opened segments are dropped, and ``version`` bumps
        so engines invalidate their row caches. Serving workers call this
        between micro-batches, which is how a mutation in the parent
        process becomes visible to queries in flight through the serving
        layer.

        Returns True if the manifest changed.
        """
        # under the handle mutex: a _commit in another thread of this
        # process must never see its manifest swapped out mid-mutation
        with self._mutex:
            sig = self._stat_sig()
            if sig is None:
                return False
            if sig == self._meta_sig:
                gen = self._probe_generation()
                if gen is None or gen == int(
                    self.manifest.get("generation", 0)
                ):
                    return False
            with open(os.path.join(self.path, STORE_META)) as f:
                self.manifest = json.load(f)
            self._meta_sig = sig
            self._segments.clear()
            self.version += 1
            return True

    # ------------------------------------------------------- properties
    @property
    def vocab_size(self) -> int:
        return self.manifest["vocab_size"]

    @property
    def segment_version(self) -> int:
        """On-disk format of segments this store writes (1 raw, 2
        compressed). Manifests from before the field default to 1, so old
        stores keep appending the format they already hold."""
        return int(self.manifest.get("segment_version", DEFAULT_SEGMENT_VERSION))

    @property
    def segment_names(self) -> list[str]:
        return list(self.manifest["segments"])

    @property
    def segments(self) -> list:
        # a compaction in another process can delete a segment directory
        # between our manifest read and the open (segments open eagerly, so
        # once _segment returns, unlink cannot hurt it) — adopt the newer
        # manifest and retry rather than surface the race to the query
        for _ in range(8):
            try:
                return [self._segment(n) for n in self.manifest["segments"]]
            except FileNotFoundError:
                if not self.refresh():
                    raise
        raise RuntimeError(
            f"segment set of {self.path} kept changing underneath the reader"
        )

    def _segment(self, name: str):
        if name not in self._segments:
            self._segments[name] = open_segment(
                os.path.join(self.path, name), registry=self.registry
            )
        return self._segments[name]

    @property
    def num_docs(self) -> int:
        return sum(s.num_docs for s in self.segments)

    @property
    def total_count(self) -> int:
        return sum(s.total_count for s in self.segments)

    def df(self) -> np.ndarray:
        """Document frequencies summed across segments (additive like the
        counts themselves)."""
        out = np.zeros(self.vocab_size, dtype=np.int64)
        for s in self.segments:
            out += s.df
        return out

    def freshness(self) -> dict:
        """How fresh this handle's view of the store is: the manifest
        ``generation``, the segment count split by on-disk format version,
        and the unix time of the newest segment append (``None`` when the
        store is empty or predates the ``created_unix`` meta field).
        Serving workers publish this with their stats snapshots so
        ``CoocServer.stats()["freshness"]`` tracks streamed appends live.

        Reads only the tiny per-segment ``meta.json``s, never the arrays; a
        segment a concurrent compaction unlinked mid-walk triggers a
        refresh-and-retry like the ``segments`` property."""
        for _ in range(8):
            by_version: dict[str, int] = {}
            last: float | None = None
            try:
                for name in self.manifest["segments"]:
                    with open(
                        os.path.join(self.path, name, "meta.json")
                    ) as f:
                        meta = json.load(f)
                    v = f"v{int(meta.get('format_version', 1))}"
                    by_version[v] = by_version.get(v, 0) + 1
                    created = meta.get("created_unix")
                    if created is not None:
                        last = created if last is None else max(last, created)
            except FileNotFoundError:
                if not self.refresh():
                    raise
                continue
            return {
                "generation": int(self.manifest.get("generation", 0)),
                "segments": len(self.manifest["segments"]),
                "segments_by_version": by_version,
                "last_append_unix": last,
            }
        raise RuntimeError(
            f"segment set of {self.path} kept changing underneath freshness()"
        )

    # --------------------------------------------------------- writing
    def _reserve_segment(self) -> tuple[str, str]:
        """Allocate the next segment name with a committed ``next_seg_id``
        bump, so a concurrent writer (background compaction vs. appending
        parent) can never be handed the same directory. A crash after the
        reservation leaves a gap in the id sequence, never a collision."""
        holder: dict = {}

        def mut(m):
            holder["name"] = f"seg-{m['next_seg_id']:05d}"
            m["next_seg_id"] += 1

        self._commit(mut)
        name = holder["name"]
        return name, os.path.join(self.path, name)

    def add_segment_from_sink(
        self,
        sink: SpillSink,
        *,
        df: np.ndarray | None = None,
        num_docs: int = 0,
        source: str = "spill",
    ):
        """Finalize a SpillSink's runs into a new segment of this store."""
        if sink.vocab_size != self.vocab_size:
            raise ValueError(
                f"sink vocab {sink.vocab_size} != store vocab {self.vocab_size}"
            )
        name, seg_dir = self._reserve_segment()
        seg = sink.finalize_segment(
            seg_dir, df=df, num_docs=num_docs, source=source,
            version=self.segment_version,
        )
        self._commit(lambda m: m["segments"].append(name))
        self._segments[name] = seg
        return seg

    def add_segment_from_rows(
        self,
        rows,
        *,
        df: np.ndarray | None = None,
        num_docs: int = 0,
        source: str = "rows",
        single_commit: bool = False,
        extra_mutate=None,
    ):
        """Write a merged (primary, secondaries, counts) row stream — strictly
        ascending primaries, unique pairs — as a new segment. The single
        segment-adding primitive behind counting, ingest, and compaction.

        ``single_commit=True`` writes the segment into a hidden pending
        directory first and then performs **one** flock'd manifest commit
        that allocates the name, renames the directory into place, and
        appends it — instead of the default reserve-then-append pair of
        commits. The parallel-ingest finalizer uses this so a crash leaves
        either no trace (an unreferenced pending dir) or the fully
        committed segment, never a reserved-but-absent name.

        ``extra_mutate`` (optional) runs against the manifest inside the
        same locked commit that appends the segment, *before* the append —
        so an unrelated manifest key (e.g. a stream cursor) advances
        atomically with the segment becoming visible. It may raise to abort
        the commit: with ``single_commit`` the pending directory is then
        removed before the exception propagates, so an abort leaves no
        trace. Only a crash (SIGKILL mid-seal) leaves a pending dir behind,
        and ``Store.open``'s dead-pid sweep collects those.

        The returned segment is opened inside the commit that publishes it:
        once the lock is released a compaction (a daemon thread on this
        handle, or another process) may merge it away and unlink its
        directory, and an open after that would fail."""
        if single_commit:
            tmp_dir = os.path.join(
                self.path, f".pending-{os.getpid()}-{id(rows):x}"
            )
            shutil.rmtree(tmp_dir, ignore_errors=True)
            write_segment(
                tmp_dir, rows, self.vocab_size, df=df, num_docs=num_docs,
                source=source, version=self.segment_version,
            )
            holder: dict = {}

            def mut(m):
                if extra_mutate is not None:
                    extra_mutate(m)
                name = f"seg-{m['next_seg_id']:05d}"
                m["next_seg_id"] += 1
                os.replace(tmp_dir, os.path.join(self.path, name))
                m["segments"].append(name)
                holder["seg"] = self._segment(name)

            try:
                self._commit(mut)
            except BaseException:
                # aborted (e.g. a stream-cursor fence): the segment was
                # never published, so drop the pending dir now instead of
                # leaking it until some future dead-pid sweep
                shutil.rmtree(tmp_dir, ignore_errors=True)
                raise
            return holder["seg"]
        name, seg_dir = self._reserve_segment()
        holder: dict = {}

        def mut_append(m):
            if extra_mutate is not None:
                extra_mutate(m)
            m["segments"].append(name)
            holder["seg"] = self._segment(name)

        write_segment(
            seg_dir, rows, self.vocab_size, df=df, num_docs=num_docs,
            source=source, version=self.segment_version,
        )
        self._commit(mut_append)
        return holder["seg"]

    def append_collection(
        self,
        c,
        *,
        method: str = "list-scan",
        memory_budget_pairs: int = 4 << 20,
        **kwargs,
    ):
        """Count a new document batch and append it as a segment (the exact
        incremental path: no existing segment is touched). ``method`` may be
        ``"auto"`` — the planner's cost models pick it."""
        from repro_torch.core.cooc import count  # lazy: core wires back into us

        if method == "auto":
            if kwargs:
                raise ValueError(
                    "method kwargs require an explicit method (auto-selected "
                    "methods run with planner-resolved params)"
                )
            from repro_torch.core.plan import CountJob, Planner

            plan = Planner().plan(
                CountJob(
                    collection=c,
                    output="stats",
                    memory_budget_pairs=memory_budget_pairs,
                )
            )
            method, kwargs = plan.method, dict(plan.method_kwargs)
        with SpillSink(
            self.vocab_size, memory_budget_pairs=memory_budget_pairs
        ) as sink:
            count(method, c, sink, **kwargs)
            df = np.bincount(c.terms, minlength=self.vocab_size).astype(np.int64)
            return self.add_segment_from_sink(
                sink, df=df, num_docs=c.num_docs, source=f"count:{method}"
            )

    def ingest_store(self, other: "Store"):
        """Merge another store's segments (e.g. a per-shard store from the
        distributed runner) into one new segment here. Exact: counts add."""
        if other.vocab_size != self.vocab_size:
            raise ValueError("vocab mismatch")
        return self.add_segment_from_rows(
            merge_row_streams([s.iter_rows() for s in other.segments]),
            df=other.df(),
            num_docs=other.num_docs,
            source=f"ingest:{os.path.basename(other.path)}",
        )

    # ------------------------------------------------------ compaction
    def compact(self, names: list[str] | None = None):
        """Merge segments into one (LSM compaction). ``names=None`` merges
        everything (major compaction); a list merges exactly those segments
        and leaves the rest in place. Queries before and after return
        identical counts. The manifest commit happens exactly once, *after*
        the merged segment is fully written, and is a locked
        read-modify-write — segments another process appended meanwhile
        survive; a crash mid-way leaves only an orphan directory, never
        double-counted segments."""
        old_names = list(names) if names is not None else self.segment_names
        if not old_names:
            raise ValueError("nothing to compact")
        current = set(self.manifest["segments"])
        missing = [n for n in old_names if n not in current]
        if missing:
            raise ValueError(f"unknown segments {missing}")
        old_segs = [self._segment(n) for n in old_names]
        df = np.zeros(self.vocab_size, dtype=np.int64)
        for s in old_segs:
            df += s.df
        num_docs = sum(s.num_docs for s in old_segs)
        name, seg_dir = self._reserve_segment()
        write_segment(
            seg_dir,
            merge_row_streams([s.iter_rows() for s in old_segs]),
            self.vocab_size,
            df=df,
            num_docs=num_docs,
            source=f"compact:{len(old_names)}",
            version=self.segment_version,
        )
        dropped = set(old_names)
        holder: dict = {}

        def mut(m):
            m["segments"] = [
                n for n in m["segments"] if n not in dropped
            ] + [name]
            holder["seg"] = self._segment(name)

        self._commit(mut)
        for n in old_names:
            self._segments.pop(n, None)
            # unlink only detaches the names: readers that opened the old
            # segments before this commit keep valid mmaps until they close
            shutil.rmtree(os.path.join(self.path, n), ignore_errors=True)
        return holder["seg"]

    def plan_compaction(
        self, *, min_segments: int = 2, tier_ratio: float = 4.0,
        max_segments: int | None = None,
    ) -> list[str]:
        """Size-tiered selection: walk segments smallest-first and return
        the first run of at least ``min_segments`` whose sizes stay within
        ``tier_ratio`` of the run's smallest member — the classic LSM
        policy of merging peers, never rewriting a big segment to absorb a
        tiny one. Returns [] when no tier qualifies."""
        names = self.segment_names
        if len(names) < min_segments:
            return []
        sized = sorted(
            (segment_bytes(os.path.join(self.path, n)), n) for n in names
        )
        i = 0
        while i < len(sized):
            j = i
            while j < len(sized) and sized[j][0] <= sized[i][0] * tier_ratio:
                j += 1
            if j - i >= min_segments:
                tier = [n for _, n in sized[i:j]]
                return tier[:max_segments] if max_segments else tier
            i = j
        return []

    def compact_background(
        self, names: list[str] | None = None, *,
        min_segments: int = 2, tier_ratio: float = 4.0,
    ) -> "CompactionHandle | None":
        """Run a compaction in a spawned worker process and return
        immediately. ``names=None`` compacts the tier ``plan_compaction``
        picks (returns None when nothing qualifies). The worker opens its
        own Store handle, merges, and commits under the manifest lock, so
        this process may keep appending concurrently; call ``refresh()``
        (serving workers already do, between micro-batches) to see the
        swap. ``handle.join()`` waits and returns the result dict."""
        if names is None:
            names = self.plan_compaction(
                min_segments=min_segments, tier_ratio=tier_ratio
            )
        names = list(names)
        if not names:
            return None
        with spawn_friendly_env() as ctx:
            result_q = ctx.Queue()
            proc = ctx.Process(
                target=_compact_worker,
                args=(self.path, names, result_q),
                daemon=True,
            )
            proc.start()
        return CompactionHandle(proc, result_q, names)

    # --------------------------------------------------------- queries
    # (thin exact primitives; the batched/scored engine lives in query.py)
    def pair_count(self, i: int, j: int) -> int:
        return sum(s.pair_count(i, j) for s in self.segments)

    def pair_counts(self, pairs: np.ndarray) -> np.ndarray:
        pairs = np.asarray(pairs, dtype=np.int64)
        out = np.zeros(len(pairs), dtype=np.int64)
        for s in self.segments:
            out += s.pair_counts(pairs)
        return out

    def neighbours(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        """Merged symmetric neighbourhood of ``t`` across segments."""
        segs = self.segments
        if len(segs) == 1:
            ids, cnts = segs[0].neighbours(t)
            return np.asarray(ids, dtype=np.int64), np.asarray(cnts)
        parts = [s.neighbours(t) for s in segs]
        ids = np.concatenate([p[0] for p in parts]).astype(np.int64)
        cnts = np.concatenate([p[1] for p in parts]).astype(np.int64)
        if len(ids) == 0:
            return ids, cnts
        return sum_by_key(ids, cnts)

    def dense(self) -> np.ndarray:
        """Dense strict-upper matrix summed over segments (tests only)."""
        mat = np.zeros((self.vocab_size, self.vocab_size), dtype=np.int64)
        for s in self.segments:
            mat += s.dense()
        return mat


class CompactionHandle:
    """Handle on one background compaction process."""

    def __init__(self, proc, result_q, names: list[str]):
        self.proc = proc
        self.names = names
        self._q = result_q
        self._result: tuple | None = None

    def alive(self) -> bool:
        return self.proc.is_alive()

    def join(self, timeout: float | None = None) -> dict:
        """Wait for the compaction and return its result dict
        (``{"segment", "nnz", "merged"}``). Raises on worker failure."""
        self.proc.join(timeout)
        if self.proc.is_alive():
            raise TimeoutError("background compaction still running")
        if self._result is None:
            try:
                self._result = self._q.get(timeout=5)
            except queue.Empty:
                self._result = (
                    "error", "compaction worker died without a result"
                )
        status, payload = self._result
        if status != "ok":
            raise RuntimeError(f"background compaction failed: {payload}")
        return payload


def _compact_worker(store_path: str, names: list[str], result_q) -> None:
    """Entry point of the spawned compaction process: open an own Store
    handle and run the locked partial compaction."""
    try:
        store = Store.open(store_path)
        seg = store.compact(names=names)
        result_q.put(
            (
                "ok",
                {
                    "segment": os.path.basename(seg.path),
                    "nnz": seg.nnz,
                    "merged": list(names),
                },
            )
        )
    except Exception as e:  # report, don't vanish: join() re-raises
        result_q.put(("error", f"{type(e).__name__}: {e}"))
