"""The port's streaming ingest against the JAX package.

The scenarios of ``tests/test_stream.py`` on ``repro_torch.stream`` with
``device="cpu"``: sources and the manifest cursor, seals by size and by
age, in-process and SIGKILL resume exactly once, micro-segment stores that
answer like a batch build, a compacted stream byte-identical to a batch
build by the JAX package, and a cursor written by one package that the
other resumes. Each seal counts with the device's own method
(``list-scan-segment`` on the card, ``list-scan`` on the host).
"""

import filecmp
import glob
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.cooc import count_to_store as jax_count_to_store  # noqa: E402
from repro.data.corpus import Collection as JCollection  # noqa: E402
from repro.store import QueryEngine as JQueryEngine  # noqa: E402
from repro.store import Store as JStore  # noqa: E402
from repro.stream import FileTailSource as JFileTailSource  # noqa: E402
from repro.stream import StreamConfig as JStreamConfig  # noqa: E402
from repro.stream import StreamCursor as JStreamCursor  # noqa: E402
from repro.stream import StreamIngestor as JStreamIngestor  # noqa: E402
from repro_torch.data.corpus import synthetic_zipf_collection  # noqa: E402
from repro_torch.device import DeviceError  # noqa: E402
from repro_torch.launch import cooc_stream  # noqa: E402
from repro_torch.store import CoocServer, QueryEngine, Store  # noqa: E402
from repro_torch.stream import (  # noqa: E402
    CursorState,
    FileTailSource,
    QueueSource,
    StreamConfig,
    StreamCursor,
    StreamCursorConflict,
    StreamIngestor,
    collection_to_feed,
    write_feed,
)

VOCAB = 160
SRC_DIR = os.path.join(os.path.dirname(__file__), "..", "src")


def corpus(docs=200, seed=0, mean_len=10):
    return synthetic_zipf_collection(docs, vocab=VOCAB, mean_len=mean_len, seed=seed)


def jax_batch_store(c, path):
    """The one-shot batch build of the JAX package (its list-scan)."""
    jc = JCollection(c.doc_ptr, c.terms, c.vocab_size)
    store, _ = jax_count_to_store("list-scan", jc, path)
    return store


def drain(store, c, *, seal_docs=16, source_id="q", **cfg_kwargs):
    """Stream a whole collection through a QueueSource into ``store`` on
    the host."""
    cfg_kwargs.setdefault("device", "cpu")
    src = QueueSource()
    src.push_collection(c)
    src.close()
    ing = StreamIngestor(store, src, StreamConfig(seal_docs=seal_docs, **cfg_kwargs),
                         source_id=source_id)
    return ing.run()


def segment_bins(store_dir):
    (seg,) = glob.glob(os.path.join(store_dir, "seg-*"))
    return seg, sorted(os.path.basename(p) for p in glob.glob(os.path.join(seg, "*.bin")))


def assert_same_segment_bytes(dir_a, dir_b):
    seg_a, bins_a = segment_bins(dir_a)
    seg_b, bins_b = segment_bins(dir_b)
    assert bins_a == bins_b and bins_a
    for name in bins_a:
        assert filecmp.cmp(os.path.join(seg_a, name), os.path.join(seg_b, name),
                           shallow=False), name


# ---------------------------------------------------------------- sources
class TestSources:
    def test_queue_source_offsets_and_exhaustion(self):
        src = QueueSource()
        src.push([3, 1, 2])
        src.push([])
        assert not src.exhausted
        got = src.poll()
        assert [off for off, _ in got] == [1, 2]
        assert got[1][1].size == 0
        src.close()
        assert src.exhausted
        with pytest.raises(RuntimeError):
            src.push([1])
        src.seek(2)
        with pytest.raises(ValueError):
            src.seek(0)

    def test_queue_source_poll_cap(self):
        src = QueueSource()
        for i in range(5):
            src.push([i])
        assert len(src.poll(2)) == 2
        assert len(src.poll()) == 3

    def test_file_tail_roundtrip_and_blank_lines(self, tmp_path):
        feed = str(tmp_path / "feed.txt")
        write_feed(feed, [[5, 1, 3], [], [7]])
        src = FileTailSource(feed)
        got = src.poll()
        assert len(got) == 3
        np.testing.assert_array_equal(got[0][1], [5, 1, 3])
        assert got[1][1].size == 0
        np.testing.assert_array_equal(got[2][1], [7])
        src2 = FileTailSource(feed, start_offset=got[0][0])
        assert len(src2.poll()) == 2

    def test_file_tail_partial_line_not_consumed(self, tmp_path):
        feed = str(tmp_path / "feed.txt")
        with open(feed, "w") as f:
            f.write("1 2\n3 4")
        src = FileTailSource(feed)
        assert len(src.poll()) == 1
        with open(feed, "a") as f:
            f.write(" 5\n")
        got2 = src.poll()
        assert len(got2) == 1
        np.testing.assert_array_equal(got2[0][1], [3, 4, 5])

    def test_file_tail_missing_file_is_empty(self, tmp_path):
        assert FileTailSource(str(tmp_path / "nope.txt")).poll() == []

    def test_file_tail_line_longer_than_poll_window(self, tmp_path):
        feed = str(tmp_path / "feed.txt")
        big = list(range(100))
        write_feed(feed, [big, [7]])
        src = FileTailSource(feed, max_bytes_per_poll=64)
        got = src.poll()
        assert len(got) == 2
        np.testing.assert_array_equal(got[0][1], big)
        np.testing.assert_array_equal(got[1][1], [7])
        assert src.offset == os.path.getsize(feed)

    def test_file_tail_torn_long_line_waits(self, tmp_path):
        feed = str(tmp_path / "feed.txt")
        with open(feed, "w") as f:
            f.write(" ".join(str(t) for t in range(100)))
        src = FileTailSource(feed, max_bytes_per_poll=64)
        assert src.poll() == []
        assert src.offset == 0
        with open(feed, "a") as f:
            f.write("\n")
        got = src.poll()
        assert len(got) == 1
        np.testing.assert_array_equal(got[0][1], list(range(100)))

    def test_feed_and_offsets_match_the_reference_tailer(self, tmp_path):
        """A feed written by the port tails identically in either package:
        the same documents at the same byte offsets."""
        c = corpus(40)
        feed = str(tmp_path / "feed.txt")
        collection_to_feed(feed, c)
        got = FileTailSource(feed).poll()
        want = JFileTailSource(feed).poll()
        assert len(got) == len(want) == c.num_docs
        for d, ((off, terms), (joff, jterms)) in enumerate(zip(got, want)):
            assert off == joff
            np.testing.assert_array_equal(terms, jterms)
            np.testing.assert_array_equal(terms, c.doc(d))


# ----------------------------------------------------------------- cursor
class TestCursor:
    def test_load_empty_then_roundtrip(self, tmp_path):
        store = Store.create(str(tmp_path / "s"), VOCAB)
        cur = StreamCursor(store, "feed-a")
        assert cur.load() == CursorState()
        drain(store, corpus(30), source_id="feed-a", seal_docs=10)
        assert cur.load() == CursorState(offset=30, docs=30, seals=3)

    def test_fencing_aborts_commit(self, tmp_path):
        store = Store.create(str(tmp_path / "s"), VOCAB)
        drain(store, corpus(20), source_id="x", seal_docs=20)
        cur = StreamCursor(store, "x")
        stale = CursorState(offset=0, docs=0, seals=0)
        segs_before = list(store.segment_names)
        with pytest.raises(StreamCursorConflict):
            store.add_segment_from_rows(
                iter([(0, np.array([1], np.int32), np.array([1], np.int64))]),
                num_docs=1,
                single_commit=True,
                extra_mutate=cur.advance_mutation(stale, 99, 1),
            )
        store.refresh()
        assert store.segment_names == segs_before
        assert cur.load() == CursorState(offset=20, docs=20, seals=1)

    def test_cursor_survives_compaction(self, tmp_path):
        store = Store.create(str(tmp_path / "s"), VOCAB)
        drain(store, corpus(60), source_id="x", seal_docs=10)
        before = StreamCursor(store, "x").load()
        store.compact()
        assert StreamCursor(store, "x").load() == before

    def test_distinct_sources_independent(self, tmp_path):
        store = Store.create(str(tmp_path / "s"), VOCAB)
        drain(store, corpus(20, seed=1), source_id="a", seal_docs=20)
        drain(store, corpus(30, seed=2), source_id="b", seal_docs=30)
        assert StreamCursor(store, "a").load().docs == 20
        assert StreamCursor(store, "b").load().docs == 30


# ------------------------------------------------------- device and method
class TestDevice:
    def test_default_method_is_the_devices_own(self):
        assert StreamConfig().device == "cuda"
        assert StreamConfig().method == "list-scan-segment"
        assert StreamConfig(device="cpu").method == "list-scan"
        assert StreamConfig(device="cuda:0").method == "list-scan-segment"
        assert StreamConfig(method="naive", device="cpu").method == "naive"
        with pytest.raises(ValueError, match="unsupported device"):
            StreamConfig(device="tpu")

    def test_default_device_without_a_card_raises(self, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        store = Store.create(str(tmp_path / "s"), VOCAB)
        with pytest.raises(DeviceError, match="no CUDA device"):
            StreamIngestor(store, QueueSource(), StreamConfig(), source_id="q")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cooc_stream.main(["--feed", str(tmp_path / "f.txt"), "--store",
                              str(tmp_path / "s2"), "--vocab", str(VOCAB)])
        assert not os.path.exists(tmp_path / "s2")  # nothing created first

    def test_segment_method_seals_like_the_reference_stream(self, tmp_path):
        """Seals counted by ``list-scan-segment`` (handed the device: here
        its plain PyTorch version) compact into the bytes of the reference
        package's own stream (``list-scan`` seals) of the same feed."""
        c = corpus(90)
        store = Store.create(str(tmp_path / "s"), VOCAB)
        summary = drain(store, c, seal_docs=16, method="list-scan-segment")
        assert summary["method"] == "list-scan-segment"
        assert summary["device"] == "cpu"
        jstore = JStore.create(str(tmp_path / "j"), VOCAB)
        src = QueueSource()
        src.push_collection(c)
        src.close()
        JStreamIngestor(jstore, src, JStreamConfig(seal_docs=16), source_id="q").run()
        store.refresh()
        store.compact()
        jstore.refresh()
        jstore.compact()
        assert_same_segment_bytes(str(tmp_path / "s"), str(tmp_path / "j"))


# --------------------------------------------------------------- ingestor
class TestIngestor:
    def test_seal_by_size(self, tmp_path):
        store = Store.create(str(tmp_path / "s"), VOCAB)
        summary = drain(store, corpus(100), seal_docs=16)
        assert summary["seals_this_run"] == 7
        store.refresh()
        assert len(store.segment_names) == 7
        assert store.num_docs == 100

    def test_seal_by_age(self, tmp_path):
        store = Store.create(str(tmp_path / "s"), VOCAB)
        src = QueueSource()
        ing = StreamIngestor(
            store, src,
            StreamConfig(seal_docs=1_000, max_visibility_lag_ms=200.0,
                         poll_interval_ms=5.0, device="cpu"),
            source_id="trickle",
        ).start()
        try:
            src.push([1, 2, 3])
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                store.refresh()
                if store.num_docs:
                    break
                time.sleep(0.02)
            assert store.num_docs == 1
        finally:
            src.close()
            ing.stop()

    def test_visibility_lag_recorded(self, tmp_path):
        store = Store.create(str(tmp_path / "s"), VOCAB)
        summary = drain(store, corpus(50), seal_docs=10)
        lag = summary["visibility_lag_ms"]
        assert 0 < lag["p50"] <= lag["max"]
        assert summary["seal_s"]["p50"] > 0

    def test_empty_docs_count(self, tmp_path):
        store = Store.create(str(tmp_path / "s"), VOCAB)
        src = QueueSource()
        src.push([1, 2])
        src.push([])
        src.push([3])
        src.close()
        StreamIngestor(store, src, StreamConfig(seal_docs=2, device="cpu"),
                       source_id="e").run()
        store.refresh()
        assert store.num_docs == 3

    def test_out_of_vocab_raises(self, tmp_path):
        store = Store.create(str(tmp_path / "s"), VOCAB)
        src = QueueSource()
        src.push([VOCAB])
        src.close()
        ing = StreamIngestor(store, src, StreamConfig(seal_docs=1, device="cpu"),
                             source_id="bad")
        with pytest.raises(ValueError, match="term IDs outside"):
            ing.run()

    def test_threaded_failure_is_surfaced_not_silent(self, tmp_path):
        path = str(tmp_path / "s")
        store = Store.create(path, VOCAB)
        src = QueueSource()
        ing = StreamIngestor(
            store, src, StreamConfig(seal_docs=1, poll_interval_ms=5.0, device="cpu"),
            source_id="contested",
        ).start()
        try:
            drain(Store.open(path), corpus(5, seed=3), seal_docs=5,
                  source_id="contested")
            src.push([1, 2, 3])
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and ing.healthy:
                time.sleep(0.02)
            assert not ing.healthy
            assert isinstance(ing.error, StreamCursorConflict)
            summary = ing.summary()
            assert summary["healthy"] is False
            assert "StreamCursorConflict" in summary["error"]
            with pytest.raises(StreamCursorConflict):
                ing.stop()
        finally:
            src.close()
            ing.stop(raise_on_error=False)
        assert not [n for n in os.listdir(path) if n.startswith(".pending-")]

    def test_inprocess_resume_exactly_once(self, tmp_path):
        c = corpus(90)
        feed = str(tmp_path / "feed.txt")
        collection_to_feed(feed, c)
        store = Store.create(str(tmp_path / "s"), VOCAB)
        StreamIngestor(store, FileTailSource(feed),
                       StreamConfig(seal_docs=20, max_docs=40, device="cpu"),
                       source_id="f").run()
        assert StreamCursor(store, "f").load().docs == 40
        StreamIngestor(store, FileTailSource(feed),
                       StreamConfig(seal_docs=20, max_docs=50, device="cpu"),
                       source_id="f").run()
        store.refresh()
        assert store.num_docs == c.num_docs
        ref = jax_batch_store(c, str(tmp_path / "batch"))
        np.testing.assert_array_equal(store.dense(), ref.dense())
        np.testing.assert_array_equal(store.df(), ref.df())


# --------------------------------------------- identity across micro-segments
class TestMicroSegmentIdentity:
    def test_100_microsegments_answer_like_the_reference_batch(self, tmp_path):
        """A store of 110 micro-segments answers every query type like the
        JAX package's engine on its own single-segment batch build."""
        c = corpus(220, mean_len=8)
        store = Store.create(str(tmp_path / "s"), VOCAB)
        summary = drain(store, c, seal_docs=2)
        assert summary["seals_this_run"] == 110
        store.refresh()
        assert len(store.segment_names) == 110
        ref = jax_batch_store(c, str(tmp_path / "batch"))
        e_many = QueryEngine(store, device="cpu")
        e_one = JQueryEngine(ref)
        rng = np.random.default_rng(0)
        terms = rng.integers(0, VOCAB, size=16)
        for score in ("count", "pmi", "dice"):
            ids_a, sc_a = e_many.topk(terms, k=8, score=score)
            ids_b, sc_b = e_one.topk(terms, k=8, score=score)
            np.testing.assert_array_equal(ids_a, ids_b)
            if score == "pmi":
                np.testing.assert_array_max_ulp(sc_a, sc_b, maxulp=1)
            else:
                np.testing.assert_array_equal(sc_a, sc_b)
        pairs = rng.integers(0, VOCAB, size=(64, 2))
        np.testing.assert_array_equal(store.pair_counts(pairs), ref.pair_counts(pairs))
        for t in rng.integers(0, VOCAB, size=8):
            ids_a, cnt_a = store.neighbours(int(t))
            ids_b, cnt_b = ref.neighbours(int(t))
            np.testing.assert_array_equal(ids_a, ids_b)
            np.testing.assert_array_equal(cnt_a, cnt_b)

    @pytest.mark.parametrize("seal_docs", [1, 7, 64])
    def test_compacted_stream_byte_identical_to_jax_batch(self, tmp_path, seal_docs):
        """Where the micro-batch boundaries fall never changes the compacted
        store: it equals, byte for byte, the JAX package's batch build."""
        c = corpus(150)
        store = Store.create(str(tmp_path / "s"), VOCAB)
        drain(store, c, seal_docs=seal_docs)
        store.refresh()
        store.compact()
        jax_batch_store(c, str(tmp_path / "batch"))
        assert_same_segment_bytes(str(tmp_path / "s"), str(tmp_path / "batch"))


# ------------------------------------------------- cursors across packages
class TestCrossPackageResume:
    @pytest.mark.parametrize("first", ["port", "jax"])
    def test_a_cursor_written_by_one_package_resumes_in_the_other(self, tmp_path, first):
        """One package streams the first 40 documents of a feed, the other
        resumes from the manifest cursor: every document exactly once, and
        the compacted store equals the JAX package's batch build."""
        c = corpus(100)
        feed = str(tmp_path / "feed.txt")
        collection_to_feed(feed, c)
        path = str(tmp_path / "s")

        def port_run(max_docs):
            StreamIngestor(Store.open(path), FileTailSource(feed),
                           StreamConfig(seal_docs=16, max_docs=max_docs, device="cpu"),
                           source_id="shared").run()

        def jax_run(max_docs):
            JStreamIngestor(JStore.open(path), JFileTailSource(feed),
                            JStreamConfig(seal_docs=16, max_docs=max_docs),
                            source_id="shared").run()

        (Store if first == "port" else JStore).create(path, VOCAB)
        runs = (port_run, jax_run) if first == "port" else (jax_run, port_run)
        runs[0](40)
        mid = JStreamCursor(JStore.open(path), "shared").load()
        assert StreamCursor(Store.open(path), "shared").load().as_dict() == mid.as_dict()
        assert mid.docs == 40 and mid.seals == 3
        runs[1](60)
        store = Store.open(path)
        cur = StreamCursor(store, "shared").load()
        assert cur.docs == c.num_docs and cur.offset == os.path.getsize(feed)
        assert store.num_docs == c.num_docs
        store.compact()
        jax_batch_store(c, str(tmp_path / "batch"))
        assert_same_segment_bytes(path, str(tmp_path / "batch"))


# -------------------------------------------------------------- freshness
class TestFreshness:
    def test_store_freshness(self, tmp_path):
        store = Store.create(str(tmp_path / "s"), VOCAB)
        drain(store, corpus(50), seal_docs=50)
        f = store.freshness()
        assert f["segments"] == 1
        assert f["segments_by_version"] == {"v1": 1}
        assert f["generation"] >= 1
        assert time.time() - f["last_append_unix"] < 120

    def test_freshness_empty_store(self, tmp_path):
        f = Store.create(str(tmp_path / "s"), VOCAB).freshness()
        assert f["segments"] == 0
        assert f["last_append_unix"] is None

    def test_stats_freshness_block(self, tmp_path):
        path = str(tmp_path / "s")
        drain(Store.create(path, VOCAB), corpus(80), seal_docs=80)
        with CoocServer(path, workers=1, device="cpu") as server:
            server.client().topk([1, 2], k=4)
            stats = server.stop()
        f = stats["freshness"]
        assert f["segments"] == 1
        assert f["segments_by_version"] == {"v1": 1}
        assert f["generation"] >= 1
        assert f["seconds_since_last_append"] >= 0

    def test_idle_refresh_sees_stream_commits(self, tmp_path):
        """With refresh_interval_ms set, a server with no traffic picks up
        segments a stream commits: freshness advances without a query."""
        path = str(tmp_path / "s")
        store = Store.create(path, VOCAB)
        drain(store, corpus(60), seal_docs=60)
        server = CoocServer(path, workers=1, device="cpu", stats_interval_s=0.15,
                            refresh_interval_ms=75).start()
        try:
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                if server.stats().get("freshness", {}).get("segments") == 1:
                    break
                time.sleep(0.1)
            assert server.stats()["freshness"]["segments"] == 1
            drain(store, corpus(30, seed=5), seal_docs=30, source_id="late")
            gen = int(store.manifest["generation"])
            deadline = time.monotonic() + 20
            seen = {}
            while time.monotonic() < deadline:
                time.sleep(0.2)
                seen = server.stats().get("freshness", {})
                if seen.get("generation", 0) >= gen and seen.get("segments") == 2:
                    break
            assert seen.get("segments") == 2, seen
            assert seen.get("generation", 0) >= gen
        finally:
            stats = server.stop(timeout=60)
        assert stats["store_refreshes"] >= 1


# ----------------------------------------------------- the driver, and crashes
class TestDriver:
    def test_cli_streams_and_compacts_like_the_reference(self, tmp_path, capsys):
        """``cooc_stream`` on the host: a paced synthetic producer, seals
        of 64 documents, the compaction daemon alongside; the compacted
        store equals the JAX package's batch build of what it streamed."""
        feed, path = str(tmp_path / "feed.txt"), str(tmp_path / "live")
        cooc_stream.main([
            "--feed", feed, "--store", path, "--vocab", str(VOCAB),
            "--gen-docs", "600", "--gen-mean-len", "10", "--seal-docs", "64",
            "--max-docs", "600", "--compact", "--fanout", "2", "--device", "cpu",
            "--json", str(tmp_path / "s.json"),
        ])
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert summary["docs_this_run"] == 600 and summary["seals_this_run"] >= 10
        assert summary["method"] == "list-scan" and summary["device"] == "cpu"
        assert summary["compaction"]["fanout"] == 2
        assert summary["num_docs"] == 600 and summary["docs_per_hour"] > 0
        assert json.load(open(tmp_path / "s.json")) == summary
        store = Store.open(path)
        store.compact()
        c = synthetic_zipf_collection(600, vocab=VOCAB, mean_len=10.0, seed=0)
        jax_batch_store(c, str(tmp_path / "batch"))
        assert_same_segment_bytes(path, str(tmp_path / "batch"))

    def test_sigkill_mid_stream_resumes_exactly_once(self, tmp_path):
        """Drive the port's cooc_stream in a subprocess with the stall hook,
        SIGKILL it after its 2nd seal, resume in-process: every document
        exactly once and counts equal to the JAX package's batch build."""
        c = corpus(120)
        feed = str(tmp_path / "feed.txt")
        collection_to_feed(feed, c)
        store_path = str(tmp_path / "s")
        env = dict(os.environ)
        env["PYTHONPATH"] = SRC_DIR + os.pathsep + env.get("PYTHONPATH", "")
        env["REPRO_TEST_STREAM_STALL_AFTER_SEALS"] = "2"
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.cooc_stream",
             "--feed", feed, "--store", store_path, "--vocab", str(VOCAB),
             "--seal-docs", "20", "--source-id", "kill-test",
             "--idle-timeout-s", "60", "--device", "cpu"],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        try:
            deadline = time.monotonic() + 90
            seals = 0
            while time.monotonic() < deadline:
                if Store.exists(store_path):
                    seals = StreamCursor(Store.open(store_path), "kill-test").load().seals
                    if seals >= 2:
                        break
                assert proc.poll() is None, "daemon exited before stall"
                time.sleep(0.05)
            assert seals >= 2, "never reached the stall point"
        finally:
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=30)

        store = Store.open(store_path)
        before = StreamCursor(store, "kill-test").load()
        assert 0 < before.docs < c.num_docs
        StreamIngestor(
            store, FileTailSource(feed),
            StreamConfig(seal_docs=20, max_docs=c.num_docs - before.docs, device="cpu"),
            source_id="kill-test",
        ).run()
        store.refresh()
        assert store.num_docs == c.num_docs
        assert StreamCursor(store, "kill-test").load().docs == c.num_docs
        ref = jax_batch_store(c, str(tmp_path / "batch"))
        np.testing.assert_array_equal(store.dense(), ref.dense())
        np.testing.assert_array_equal(store.df(), ref.df())
