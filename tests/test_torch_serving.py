"""The port's multi-process serving layer against the JAX package's engine.

The scenarios of ``tests/test_serving.py`` on ``repro_torch.store.serving``
with ``device="cpu"`` and two spawned workers: coalescing and splitting,
streaming top-k, routed caches, a parent mutation seen by the workers,
serving through a background compaction, bounded client buffers. Answers
are held against the reference package's ``QueryEngine`` on the same store:
ids, counts and count/Dice scores with ``np.array_equal``, PMI scores
within 1 ulp (torch's CPU ``log`` and XLA's round some float32 arguments
differently; the arguments are bit-identical).
"""

import queue
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.store import QueryEngine as JQueryEngine  # noqa: E402
from repro.store import Store as JStore  # noqa: E402
from repro_torch.core.cooc import count_to_store  # noqa: E402
from repro_torch.core.oracle import brute_force_counts  # noqa: E402
from repro_torch.data.corpus import synthetic_zipf_collection  # noqa: E402
from repro_torch.device import DeviceError  # noqa: E402
from repro_torch.store import (  # noqa: E402
    CoocServer,
    NeighboursRequest,
    PairCountsRequest,
    QueryEngine,
    ServingConfig,
    Store,
    TopKRequest,
)
from repro_torch.store.serving import _STAT_KEYS, _serve_batch  # noqa: E402


def serve_cpu(path, **kw):
    """A two-worker server on the host (the tests' device)."""
    kw.setdefault("workers", 2)
    return CoocServer(path, device="cpu", **kw)


def assert_topk_like_reference(got, want, score):
    ids, scores = got
    np.testing.assert_array_equal(ids, want[0])
    if score == "pmi":
        np.testing.assert_array_max_ulp(scores, want[1], maxulp=1)
    else:
        np.testing.assert_array_equal(scores, want[1])


@pytest.fixture(scope="module")
def coll():
    return synthetic_zipf_collection(150, vocab=128, mean_len=12, seed=7)


@pytest.fixture(scope="module")
def store_path(coll, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serving") / "store")
    count_to_store("list-scan", coll, path, device="cpu")
    return path


@pytest.fixture(scope="module")
def jref(store_path):
    """The reference package's engine on the same store."""
    return JQueryEngine(JStore.open(store_path))


# ----------------------------------------------------------- config
def test_serving_config_validation():
    with pytest.raises(ValueError, match="workers"):
        ServingConfig(workers=0)
    with pytest.raises(ValueError, match="max_batch"):
        ServingConfig(max_batch=0)
    with pytest.raises(ValueError, match="batch_window_ms"):
        ServingConfig(batch_window_ms=-1.0)
    with pytest.raises(ValueError, match="stats_interval_s"):
        ServingConfig(stats_interval_s=-0.5)
    with pytest.raises(ValueError, match="refresh_interval_ms"):
        ServingConfig(refresh_interval_ms=-1)
    with pytest.raises(ValueError, match="unsupported device"):
        ServingConfig(device="tpu")
    assert ServingConfig().device == "cuda"  # workers run on the card by default


# ------------------------------------------------- batch coalescing (unit)
def test_serve_batch_coalesces_and_splits(store_path, jref):
    """One micro-batch of typed request envelopes: per-(k, score) top-k
    groups and all pair lookups each become a single launch, and every
    client gets exactly its slice back, equal to the reference engine's."""
    engine = QueryEngine(Store.open(store_path), device="cpu")
    out = queue.Queue()
    stats = {k: 0 for k in _STAT_KEYS}
    batch = [
        (0, 0, 0, 1, TopKRequest(np.array([1, 2]), k=4)),
        (1, 0, 0, 1, TopKRequest(np.array([3]), k=4)),    # coalesces with above
        (0, 1, 0, 1, TopKRequest(np.array([5]), k=2, score="pmi")),
        (1, 1, 0, 1, PairCountsRequest(np.array([[1, 2], [3, 4]]))),
        (0, 2, 0, 1, PairCountsRequest(np.array([[5, 6]]))),
        (1, 2, 0, 1, TopKRequest(np.array([999]), k=4)),  # out-of-vocab -> error
    ]
    _serve_batch(engine, batch, out, worker_id=0, stats=stats)
    assert stats["topk_launches"] == 2          # (4, count) + (2, pmi)
    assert stats["pair_launches"] == 1
    assert stats["topk_queries"] == 4 and stats["pair_queries"] == 3
    assert stats["requests"] == 6 and stats["batches"] == 1

    got = {}
    while not out.empty():
        cid, rid, part, parts, seq, last, ok, payload, meta = out.get()
        assert (part, parts, seq, last) == (0, 1, 0, True)
        got[(cid, rid)] = (ok, payload, meta)
    assert len(got) == 6
    err_kind, err_msg = got[(1, 2)][1]
    assert got[(1, 2)][0] is False and err_kind == "value_error"
    assert "out-of-vocab" in err_msg

    ids, scores = jref.topk(np.array([1, 2, 3]), k=4)
    ok, (ids01, s01), meta = got[(0, 0)]
    assert ok and meta["coalesced_requests"] == 2
    assert_topk_like_reference((ids01, s01), (ids[:2], scores[:2]), "count")
    ok, (ids10, s10), _ = got[(1, 0)]
    assert_topk_like_reference((ids10, s10), (ids[2:], scores[2:]), "count")
    assert_topk_like_reference(got[(0, 1)][1], jref.topk([5], k=2, score="pmi"),
                               "pmi")
    np.testing.assert_array_equal(
        got[(1, 1)][1], jref.pair_counts(np.array([[1, 2], [3, 4]]))
    )
    np.testing.assert_array_equal(
        got[(0, 2)][1], jref.pair_counts(np.array([[5, 6]]))
    )


def test_serve_batch_streams_and_neighbours(store_path, jref):
    engine = QueryEngine(Store.open(store_path), device="cpu")
    out = queue.Queue()
    stats = {k: 0 for k in _STAT_KEYS}
    batch = [
        (0, 0, 0, 1, TopKRequest(np.array([1]), k=10, chunk=4)),
        (0, 1, 0, 1, NeighboursRequest(2)),
    ]
    _serve_batch(engine, batch, out, worker_id=0, stats=stats)
    assert stats["stream_chunks"] == 3 and stats["neighbours_queries"] == 1
    msgs = []
    while not out.empty():
        msgs.append(out.get())
    chunks = sorted([m for m in msgs if m[1] == 0], key=lambda m: m[4])  # by seq
    assert [m[5] for m in chunks] == [False, False, True]  # last flags
    ids = np.concatenate([m[7][0] for m in chunks], axis=1)
    np.testing.assert_array_equal(ids, jref.topk([1], k=10)[0])
    (nmsg,) = [m for m in msgs if m[1] == 1]
    want_ids, want_cnts = jref.neighbours(2)
    np.testing.assert_array_equal(nmsg[7][0], want_ids)
    np.testing.assert_array_equal(nmsg[7][1], want_cnts)


def test_serve_batch_survives_unexpected_error(store_path):
    """A non-ValueError mid-batch (e.g. a segment racing a parent compact)
    must produce error responses for the unanswered requests, not kill the
    worker with clients blocked until timeout."""
    engine = QueryEngine(Store.open(store_path), device="cpu")
    out = queue.Queue()
    stats = {k: 0 for k in _STAT_KEYS}

    def boom(pairs):
        raise OSError("segment vanished")

    engine.store.pair_counts = boom
    batch = [
        (0, 0, 0, 1, TopKRequest(np.array([1]), k=3)),
        (0, 1, 0, 1, PairCountsRequest(np.array([[1, 2]]))),
    ]
    _serve_batch(engine, batch, out, worker_id=0, stats=stats)
    msgs = {}
    while not out.empty():
        cid, rid, part, parts, seq, last, ok, payload, meta = out.get()
        msgs[rid] = (ok, payload)
    assert msgs[0][0] is True                     # the earlier group answered
    ok, (kind, message) = msgs[1]
    assert ok is False and kind == "serving_error"
    assert "segment vanished" in message


def test_serve_batch_reraises_a_device_failure(store_path, monkeypatch):
    """A kernel that fails to build or launch is not a bad request: the
    batch raises (the worker dies, and the supervisor fails it as
    WorkerDied) and nothing is answered, least of all from the host."""
    from repro_torch.kernels import ops

    engine = QueryEngine(Store.open(store_path), device="cpu")

    def broken(*args, **kwargs):
        raise DeviceError("topk_gather launch failed: CUDA error 700")

    monkeypatch.setattr(ops, "topk_gather", broken)
    out = queue.Queue()
    stats = {k: 0 for k in _STAT_KEYS}
    with pytest.raises(DeviceError, match="launch failed"):
        _serve_batch(engine, [(0, 0, 0, 1, TopKRequest(np.array([1]), k=3))],
                     out, worker_id=0, stats=stats)
    assert out.empty()


# --------------------------------------------------- end-to-end (processes)
def test_server_multi_client_matches_reference(store_path, coll, jref):
    """More than one client served by two workers against shared mmap
    segments with batched execution: every answer equals the reference
    engine's and the brute-force oracle."""
    oracle = brute_force_counts(coll)
    sym = oracle + oracle.T
    n_clients, reqs_per_client = 3, 6
    errors, metas, answers = [], [], []

    with serve_cpu(store_path, batch_window_ms=5.0) as server:
        def client_loop(idx):
            try:
                client = server.client()
                rng = np.random.default_rng(100 + idx)
                for r in range(reqs_per_client):
                    terms = rng.integers(0, coll.vocab_size, size=8)
                    score = ("count", "pmi", "dice")[r % 3]
                    pairs = rng.integers(0, coll.vocab_size, size=(6, 2))
                    answers.append((terms, score, client.topk(terms, k=5, score=score),
                                    pairs, client.pair_counts(pairs)))
                    metas.append(client.last_meta)
            except Exception as e:  # pragma: no cover - surfaced below
                errors.append(e)

        threads = [threading.Thread(target=client_loop, args=(i,))
                   for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
    assert not errors, errors
    assert len(answers) == n_clients * reqs_per_client
    for terms, score, got, pairs, counts in answers:
        assert_topk_like_reference(got, jref.topk(terms, k=5, score=score), score)
        np.testing.assert_array_equal(counts, jref.pair_counts(pairs))
        if score == "count":  # and against the oracle
            for b, t in enumerate(terms):
                for i, s in zip(*(a[b] for a in got)):
                    if i >= 0:
                        assert sym[t][i] == s

    stats = server.stats()
    assert stats["workers"] == 2 and stats["routing"] is False
    assert stats["device"] == "cpu"
    assert stats["requests"] == n_clients * reqs_per_client * 2
    assert stats["topk_queries"] == n_clients * reqs_per_client * 8
    assert stats["pair_queries"] == n_clients * reqs_per_client * 6
    assert stats["batches"] >= 1
    assert 0.0 <= stats["cache_hit_rate"] <= 1.0
    assert len(stats["per_worker"]) == 2
    # each worker reports its device and its own launches; the plain
    # version on the host launches no kernel
    for w in stats["per_worker"]:
        assert w["device"] == "cpu"
        assert set(w["kernel_launches"]) == {
            "segment_hist", "topk_gather", "cooc_gram", "bitpair"}
        assert not any(w["kernel_launches"].values())
    assert all(s is not None and s > 0 for s in stats["worker_startup_s"])
    assert metas and all("worker" in m for m in metas)


def test_server_routed_matches_reference_and_partitions_caches(store_path, coll, jref):
    """Hot-term routing: answers stay equal to the reference engine's
    (split requests reassemble exactly), and on a Zipf-skewed workload the
    aggregate hit rate beats the unrouted baseline with the same
    undersized LRU."""
    V = coll.vocab_size
    rng = np.random.default_rng(3)
    probs = (1.0 / np.arange(1, V + 1)) ** 1.0
    probs /= probs.sum()
    workload = [rng.choice(V, size=16, p=probs) for _ in range(60)]
    pair_load = [rng.choice(V, size=(4, 2), p=None) for _ in range(10)]

    hit_rates = {}
    for routing in (False, True):
        with serve_cpu(store_path, batch_window_ms=1.0, cache_rows=8,
                       routing=routing) as server:
            client = server.client()
            for terms in workload:
                assert_topk_like_reference(
                    client.topk(terms, k=5, score="pmi"),
                    jref.topk(terms, k=5, score="pmi"), "pmi")
            for pairs in pair_load:
                np.testing.assert_array_equal(client.pair_counts(pairs),
                                              jref.pair_counts(pairs))
            nids, ncnts = client.neighbours(1)
            np.testing.assert_array_equal(nids, jref.neighbours(1)[0])
            np.testing.assert_array_equal(ncnts, jref.neighbours(1)[1])
        hit_rates[routing] = server.stats()["cache_hit_rate"]
        assert server.stats()["routing"] is routing
    assert hit_rates[True] > hit_rates[False], hit_rates


def test_server_streaming_topk(store_path, jref):
    with serve_cpu(store_path, batch_window_ms=1.0, routing=True) as server:
        client = server.client()
        chunks = list(client.topk_stream([1, 2, 3], k=23, chunk=8, score="dice"))
        mono_ids, mono_scores = jref.topk([1, 2, 3], k=23, score="dice")
        assert [c[0].shape[1] for c in chunks] == [8, 8, 7]
        np.testing.assert_array_equal(
            np.concatenate([c[0] for c in chunks], axis=1), mono_ids)
        np.testing.assert_array_equal(
            np.concatenate([c[1] for c in chunks], axis=1), mono_scores)
        # interleave: a monolithic request while a stream is half-consumed
        stream = client.topk_stream([5], k=9, chunk=3)
        first = next(stream)
        ids, _ = client.topk([7], k=4)
        np.testing.assert_array_equal(ids, jref.topk([7], k=4)[0])
        rest = list(stream)
        sids = np.concatenate([first[0]] + [c[0] for c in rest], axis=1)
        np.testing.assert_array_equal(sids, jref.topk([5], k=9)[0])


def test_server_sees_parent_store_mutation(coll, tmp_path):
    """A parent-process append/compact becomes visible to in-flight serving
    traffic via Store.refresh() between micro-batches."""
    path = str(tmp_path / "mut_store")
    store, _ = count_to_store("list-scan", coll, path, device="cpu")
    with serve_cpu(path, batch_window_ms=1.0) as server:
        client = server.client()
        before = client.pair_counts(np.array([[1, 2]]))[0]
        tids, tscores = client.topk([1], k=4)
        store.append_collection(coll, method="list-scan")  # counts double
        after = client.pair_counts(np.array([[1, 2]]))[0]
        assert after == 2 * before
        store.compact()                                    # counts unchanged
        assert client.pair_counts(np.array([[1, 2]]))[0] == after
        got = client.topk([1], k=4)
        jref = JQueryEngine(JStore.open(path))
        assert_topk_like_reference(got, jref.topk([1], k=4), "count")
        scores = got[1]
        assert np.all(scores[tscores >= 0] >= tscores[tscores >= 0])
    assert sum(w["store_refreshes"] for w in server.stats()["per_worker"]) >= 1


def test_server_error_propagation_and_restart_guard(store_path):
    with serve_cpu(store_path, workers=1, batch_window_ms=0.0) as server:
        client = server.client()
        with pytest.raises(ValueError, match="out-of-vocab"):
            client.topk([10_000], k=3)
        with pytest.raises(ValueError, match="out-of-vocab"):
            client.pair_counts(np.array([[0, -2]]))
        with pytest.raises(ValueError, match="out-of-vocab"):
            client.neighbours(10_000)
        ids, _ = client.topk([1], k=3)  # healthy after an error response
        assert ids.shape == (1, 3)
        with pytest.raises(RuntimeError, match="already started"):
            server.start()


def test_client_rejects_invalid_requests_before_submit(store_path):
    """An unknown score (or bad k/dtype) fails at request construction on
    the client: no envelope ever reaches a worker."""
    with serve_cpu(store_path, workers=1, batch_window_ms=0.0) as server:
        client = server.client()
        with pytest.raises(ValueError, match="unknown score"):
            client.topk([1], k=3, score="bogus")
        with pytest.raises(ValueError, match="k must be"):
            client.topk([1], k=0)
        with pytest.raises(ValueError, match="integer term ids"):
            client.topk(np.array([1.5]), k=3)
        ids, _ = client.topk([1], k=3)  # server healthy, nothing poisoned
        assert ids.shape == (1, 3)
    assert server.stats()["requests"] == 1


def test_client_buffers_bounded_after_errors_and_dropped_streams(store_path):
    """A failed routed request or an abandoned stream must not leave the
    client buffering its late-arriving sibling messages forever."""
    want = Store.open(store_path).pair_counts(np.array([[1, 2]]))
    with serve_cpu(store_path, batch_window_ms=1.0, routing=True) as server:
        client = server.client()
        # split across both workers; the OOV slice fails, the other succeeds
        terms = np.concatenate([np.arange(16), [10_000]])
        with pytest.raises(ValueError, match="out-of-vocab"):
            client.topk(terms, k=3)
        stream = client.topk_stream(np.arange(8), k=30, chunk=4)
        next(stream)
        stream.close()                            # abandoned after one chunk
        never_started = client.topk_stream(np.arange(4), k=20, chunk=4)
        del never_started                         # __del__ must clean up
        with pytest.raises(ValueError, match="out-of-vocab"):
            client.execute([
                TopKRequest([10_000], k=3),
                PairCountsRequest(np.array([[1, 2]])),
            ])
        deadline = time.monotonic() + 30
        while (client._msgs or client._discard) and time.monotonic() < deadline:
            np.testing.assert_array_equal(
                client.pair_counts(np.array([[1, 2]])), want)
            time.sleep(0.02)
        assert not client._msgs and not client._discard
        assert not client._positions
        ids, _ = client.topk(np.arange(8), k=3)
        assert ids.shape == (8, 3)


# --------------------------------------------------- telemetry
def test_server_stats_include_server_side_timing(store_path):
    """Queue-wait, execute and request latency come from worker histograms
    merged across processes, not from client wall clocks."""
    with serve_cpu(store_path, batch_window_ms=1.0) as server:
        client = server.client()
        for _ in range(10):
            client.topk([1, 2, 3], k=5)
    stats = server.stats()
    timing = stats["server_timing"]
    assert set(timing) == {"queue_wait_ms", "execute_ms", "request_latency_ms"}
    assert timing["queue_wait_ms"]["count"] == stats["requests"] == 10
    assert timing["request_latency_ms"]["count"] == 10
    assert timing["execute_ms"]["count"] == stats["batches"]
    for d in timing.values():
        assert d["p50"] <= d["p95"] <= d["p99"]
        assert d["mean"] > 0
    assert timing["request_latency_ms"]["p50"] >= timing["queue_wait_ms"]["p50"]
    hists = stats["metrics"]["histograms"]
    assert "serving/queue_wait_s" in hists and "serving/execute_s" in hists
    assert stats["workers_lost"] == 0


def test_server_live_stats_with_periodic_snapshots(store_path):
    """stats() on a running server merges the freshest periodic snapshot
    from each worker (stats_interval_s), without stopping anything."""
    with serve_cpu(store_path, batch_window_ms=1.0,
                   stats_interval_s=0.05) as server:
        client = server.client()
        for _ in range(8):
            client.topk([1, 2], k=4)
        deadline = time.monotonic() + 30
        live = server.stats()
        while live.get("requests", 0) < 8 and time.monotonic() < deadline:
            time.sleep(0.05)
            live = server.stats()
        assert live["live"] is True
        assert live["requests"] == 8
        assert live["server_timing"]["queue_wait_ms"]["count"] == 8
        ids, _ = client.topk([3], k=4)  # still serving
        assert ids.shape == (1, 4)
    final = server.stats()
    assert final["live"] is False and final["requests"] == 9


def test_server_rejects_bad_args(store_path, tmp_path):
    with pytest.raises(FileNotFoundError):
        CoocServer(str(tmp_path / "nope"), device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        CoocServer(store_path, device="tpu")


# ------------------------------------------- compaction under live serving
def test_server_serves_through_background_compaction(coll, tmp_path):
    """Workers keep answering, byte-identically, while a background process
    compacts the v2 segments out from under their mmaps, and pick the
    merged segment up via their between-batch refresh."""
    from repro_torch.data.preprocess import shard_documents

    path = str(tmp_path / "store")
    store = Store.create(path, coll.vocab_size, segment_version=2)
    for shard in shard_documents(coll, 3):
        store.append_collection(shard, method="list-scan")

    server = serve_cpu(path, batch_window_ms=1.0).start()
    try:
        client = server.client()
        rng = np.random.default_rng(29)
        terms = rng.integers(0, coll.vocab_size, size=24)
        before = client.topk(terms, k=6, score="pmi")
        handle = store.compact_background(names=store.segment_names)
        assert handle is not None
        while handle.alive():                     # serve through the merge
            client.topk(rng.integers(0, coll.vocab_size, size=24), k=6)
        res = handle.join(timeout=120)
        assert len(res["merged"]) == 3
        after = client.topk(terms, k=6, score="pmi")
        assert before[0].tobytes() == after[0].tobytes()
        assert before[1].tobytes() == after[1].tobytes()
        assert_topk_like_reference(
            after, JQueryEngine(JStore.open(path)).topk(terms, k=6, score="pmi"),
            "pmi")
        pairs = rng.integers(0, coll.vocab_size, size=(64, 2))
        np.testing.assert_array_equal(
            client.pair_counts(pairs),
            JQueryEngine(JStore.open(path)).pair_counts(pairs))
    finally:
        stats = server.stop(timeout=60)
    assert stats["workers_lost"] == 0
    assert stats["storage"]["blocks_decoded"] > 0
    assert 0.0 <= stats["storage"]["block_cache_hit_rate"] <= 1.0
    store.refresh()
    assert len(store.segment_names) == 1


def test_workers_report_the_inputs_of_each_top_k_answer(store_path):
    """``report_inputs=True``: each top-k answer carries what its launch
    read — num_docs, the manifest generation, and per row df of the term
    and a digest of the row's (ids, counts, df of the neighbours). A row
    built inside a coalesced batch digests like the same row built alone
    in the in-process engine, so on a mismatch the first input that
    differs is named."""
    engine = QueryEngine(Store.open(store_path), device="cpu", report_inputs=True)
    rng = np.random.default_rng(21)
    reqs = [TopKRequest(rng.integers(0, 128, size=6), k=5, score="pmi")
            for _ in range(12)]
    got, metas = [None] * len(reqs), [None] * len(reqs)
    with serve_cpu(store_path, batch_window_ms=20.0, report_inputs=True) as server:
        def client_loop(idx):
            client = server.client()
            for i in range(idx, len(reqs), 3):
                got[i] = client.execute([reqs[i]], timeout=60.0)[0]
                metas[i] = client.last_meta

        threads = [threading.Thread(target=client_loop, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert max(m["coalesced_requests"] for m in metas) > 1  # rows shared tiles
    for req, (ids, scores), meta in zip(reqs, got, metas):
        want = engine.topk(req.terms, k=5, score="pmi")
        assert np.array_equal(ids, want[0]) and scores.tobytes() == want[1].tobytes()
        assert meta["inputs"] == engine.last_inputs
        assert len(meta["inputs"]["row_crc"]) == len(req.terms)
    # a different count in one row changes that row's digest alone
    tile, num_docs, generation = engine._tile(reqs[0].terms)
    base = engine.inputs(tile, num_docs, generation)["row_crc"]
    tile[1][2, 0] += 1
    changed = engine.inputs(tile, num_docs, generation)["row_crc"]
    assert [a != b for a, b in zip(changed, base)] == [i == 2 for i in range(6)]


def test_a_refresh_after_the_tile_reaches_neither_the_launch_nor_its_report(coll, tmp_path):
    """A refresh that lands between building a top-k tile and its launch
    (another thread of the process following a feed) must not mix
    generations: the launch scores the tile with the ``num_docs`` it was
    built with, and ``report_inputs`` reports those and their generation.
    Appending the collection again doubles every count, df and num_docs,
    which leaves PMI as it was, so only a mixed launch changes the scores."""
    path = str(tmp_path / "race_store")
    store, _ = count_to_store("list-scan", coll, path, device="cpu")
    engine = QueryEngine(Store.open(path), device="cpu", report_inputs=True)
    terms = np.arange(8)
    want = engine.topk(terms, k=5, score="pmi")
    before = dict(engine.last_inputs)
    build = engine._tile

    def tile_then_refresh(t):  # the failpoint: the refresh lands here
        built = build(t)
        store.append_collection(coll, method="list-scan")
        assert engine.store.refresh()
        engine._maybe_invalidate()
        return built

    engine._tile = tile_then_refresh
    ids, scores = engine.topk(terms, k=5, score="pmi")
    assert np.array_equal(ids, want[0]) and scores.tobytes() == want[1].tobytes()
    assert engine.last_inputs == before
    engine._tile = build
    after = engine.topk(terms, k=5, score="pmi")
    assert engine.last_inputs["num_docs"] == 2 * before["num_docs"]
    assert engine.last_inputs["generation"] > before["generation"]
    np.testing.assert_array_max_ulp(after[1], want[1], maxulp=1)
