"""The port's compaction daemon against the JAX package's.

The ``TestCompactionDaemon`` scenarios of ``tests/test_stream.py`` on
``repro_torch.store.CompactionDaemon`` (inline, in a daemon thread, and
through the spawned background merge), then the two packages side by side:
the same micro-segment store compacted by the port's daemon and by the
reference's is byte-identical, segment names and manifest included, and
each package opens the store the other compacted.
"""

import filecmp
import glob
import json
import os
import shutil
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.store import CompactionDaemon as JCompactionDaemon  # noqa: E402
from repro.store import CompactionPolicy as JCompactionPolicy  # noqa: E402
from repro.store import QueryEngine as JQueryEngine  # noqa: E402
from repro.store import Store as JStore  # noqa: E402
from repro_torch.core.cooc import count_to_store  # noqa: E402
from repro_torch.data.corpus import synthetic_zipf_collection  # noqa: E402
from repro_torch.store import (  # noqa: E402
    CompactionDaemon,
    CompactionPolicy,
    QueryEngine,
    Store,
    merge_row_streams,
)
from repro_torch.stream import QueueSource, StreamConfig, StreamIngestor  # noqa: E402

VOCAB = 160


def corpus(docs=200, seed=0, mean_len=10):
    return synthetic_zipf_collection(docs, vocab=VOCAB, mean_len=mean_len, seed=seed)


def drain(store, c, *, seal_docs):
    src = QueueSource()
    src.push_collection(c)
    src.close()
    StreamIngestor(store, src, StreamConfig(seal_docs=seal_docs, device="cpu"),
                   source_id="q").run()


def micro_store(path, docs=200, seal_docs=2):
    store = Store.create(path, VOCAB)
    drain(store, corpus(docs), seal_docs=seal_docs)
    store.refresh()
    return store


def store_files(path):
    """Every segment file of a store, relative to it, and its manifest's
    segment list, next segment id and stream cursor."""
    files = sorted(os.path.relpath(p, path)
                   for p in glob.glob(os.path.join(path, "seg-*", "*")))
    with open(os.path.join(path, "store.json")) as f:
        m = json.load(f)
    return files, {k: m[k] for k in ("segments", "vocab_size", "next_seg_id", "stream")}


class TestCompactionDaemon:
    def test_policy_validation(self):
        with pytest.raises(ValueError):
            CompactionPolicy(fanout=1)
        with pytest.raises(ValueError):
            CompactionPolicy(tier_ratio=0.5)
        with pytest.raises(ValueError):
            CompactionPolicy(backoff_s=0)
        with pytest.raises(ValueError):
            CompactionPolicy(backoff_s=1.0, max_backoff_s=0.5)

    def test_converges_to_tier_invariant(self, tmp_path):
        store = micro_store(str(tmp_path / "s"))
        assert len(store.segment_names) == 100
        dense_before = store.dense()
        daemon = CompactionDaemon(store, CompactionPolicy(fanout=4), inline=True)
        rounds = daemon.until_converged()
        assert rounds >= 1
        assert daemon.plan() == []
        assert len(store.segment_names) < 100
        np.testing.assert_array_equal(store.dense(), dense_before)
        s = daemon.summary()
        assert s["merges"] == rounds and s["segments_merged"] > rounds
        assert (s["fanout"], s["tier_ratio"]) == (4, 4.0)

    def test_run_once_noop_when_converged(self, tmp_path):
        store, _ = count_to_store("list-scan", corpus(40), str(tmp_path / "s"),
                                  device="cpu")
        daemon = CompactionDaemon(store, inline=True)
        assert daemon.run_once() == 0
        assert daemon.summary()["merges"] == 0

    def test_background_thread_compacts_during_ingest(self, tmp_path):
        """The daemon thread folds the tail down while the ingestor keeps
        sealing; the counts stay those of a batch build."""
        c = corpus(160)
        store = Store.create(str(tmp_path / "s"), VOCAB)
        daemon = CompactionDaemon(store, CompactionPolicy(fanout=4, backoff_s=0.01),
                                  inline=True).start()
        try:
            drain(store, c, seal_docs=4)
        finally:
            daemon.stop()
        store.refresh()
        daemon.until_converged()
        assert len(store.segment_names) < 40
        ref, _ = count_to_store("list-scan", c, str(tmp_path / "batch"), device="cpu")
        np.testing.assert_array_equal(store.dense(), ref.dense())

    def test_spawned_merges_from_the_thread(self, tmp_path):
        """``inline=False``: each merge runs in a spawned process
        (``Store.compact_background``) while the thread waits on it; the
        merged store answers like before."""
        store = micro_store(str(tmp_path / "s"), docs=40, seal_docs=5)
        assert len(store.segment_names) == 8
        before = QueryEngine(store, device="cpu").topk(np.arange(20), k=5)
        daemon = CompactionDaemon(store, CompactionPolicy(fanout=4)).start()
        merged = threading.Event()
        try:
            for _ in range(600):
                if daemon.merges >= 1 and daemon.plan() == []:
                    merged.set()
                    break
                merged.wait(0.1)
        finally:
            daemon.stop(timeout=120)
        assert merged.is_set() and daemon.merges >= 1
        store.refresh()
        assert len(store.segment_names) < 8
        after = QueryEngine(Store.open(store.path), device="cpu").topk(np.arange(20), k=5)
        np.testing.assert_array_equal(before[0], after[0])
        np.testing.assert_array_equal(before[1], after[1])


def compact_after_next_new_segment(store):
    """Wrap ``store._commit``: right after the first commit that publishes a
    new segment, merge every segment away inline, as the daemon thread (or
    another process) may once the commit's lock is released. The merge
    unlinks the new segment's directory before the adding call returns."""
    commit = store._commit
    armed = [True]

    def commit_then_compact(mutate):
        before = set(store.segment_names)
        commit(mutate)
        if armed[0] and set(store.segment_names) - before:
            armed[0] = False
            store.compact()

    store._commit = commit_then_compact
    return armed


@pytest.mark.parametrize("how", ["rows", "rows-single-commit", "compact"])
def test_a_segment_merged_away_after_its_commit_still_opens(tmp_path, how):
    """A segment published by an append (``add_segment_from_rows``, both
    commit styles) or by a merge (``compact``) can be merged away by a
    compaction that runs as soon as the publishing commit releases the
    lock. The call opens its segment inside that commit, so it returns a
    readable segment instead of failing on the unlinked directory, and the
    store keeps every count."""
    a = micro_store(str(tmp_path / "a"), docs=12, seal_docs=6)
    b, _ = count_to_store("list-scan", corpus(30, seed=3), str(tmp_path / "b"),
                          device="cpu")
    want = a.dense() + b.dense()
    armed = compact_after_next_new_segment(a)
    if how == "compact":
        a.add_segment_from_rows(
            merge_row_streams([s.iter_rows() for s in b.segments]),
            df=b.df(), num_docs=b.num_docs,
        )
        armed[0] = True
        seg = a.compact()
        assert seg.nnz == Store.open(a.path).segments[0].nnz
    else:
        seg = a.add_segment_from_rows(
            merge_row_streams([s.iter_rows() for s in b.segments]),
            df=b.df(), num_docs=b.num_docs,
            single_commit=how == "rows-single-commit",
        )
        assert seg.nnz == b.segments[0].nnz
    assert not armed[0]  # the merge ran and unlinked the returned segment
    assert not os.path.exists(seg.path)
    assert len(a.segment_names) == 1
    np.testing.assert_array_equal(a.dense(), want)
    np.testing.assert_array_equal(Store.open(a.path).dense(), want)


@pytest.mark.parametrize("fanout", [2, 4])
def test_port_and_reference_daemons_compact_to_the_same_bytes(tmp_path, fanout):
    """One micro-segment store, copied: the port's daemon converges one
    copy, the reference's the other. The merges, the segment names and
    every segment file are the same, and each package opens the other's
    result with the same answers."""
    a, b = str(tmp_path / "port"), str(tmp_path / "ref")
    micro_store(a, docs=120, seal_docs=3)
    shutil.copytree(a, b)
    mine = CompactionDaemon(Store.open(a), CompactionPolicy(fanout=fanout),
                            inline=True)
    theirs = JCompactionDaemon(JStore.open(b), JCompactionPolicy(fanout=fanout),
                               inline=True)
    assert mine.until_converged() == theirs.until_converged() >= 1
    assert mine.summary() == theirs.summary()
    files_a, man_a = store_files(a)
    files_b, man_b = store_files(b)
    assert files_a == files_b and man_a == man_b
    for rel in files_a:
        if rel.endswith(".bin"):
            assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel),
                               shallow=False), rel
    # each package opens the other's compacted store
    terms = np.arange(0, VOCAB, 7)
    from_port = JQueryEngine(JStore.open(a)).topk(terms, k=6)
    from_ref = QueryEngine(Store.open(b), device="cpu").topk(terms, k=6)
    np.testing.assert_array_equal(from_port[0], from_ref[0])
    np.testing.assert_array_equal(from_port[1], from_ref[1])
    np.testing.assert_array_equal(Store.open(b).dense(), JStore.open(a).dense())
    np.testing.assert_array_equal(Store.open(b).df(), JStore.open(a).df())
