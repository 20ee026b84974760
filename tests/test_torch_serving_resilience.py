"""The port's fault-tolerant serving, driven through its failpoints.

The scenarios of ``tests/test_serving_resilience.py`` on
``repro_torch.store.serving`` with ``device="cpu"``: fault-spec parsing
(the same ``REPRO_FAULTS`` syntax arms either package's workers), backoff,
the wire envelope, kill and respawn with every answer still returned and
equal to the reference package's engine, a death mid-stream, shedding
under overload, expired deadlines, stop with a backlog. And the port's own
rule: a worker that cannot reach the card dies visibly (``WorkerDied``,
``respawns``, ``workers_lost``) and never answers from the host.
"""

import os
import pickle
import signal
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.runtime import faultinject as jax_faultinject  # noqa: E402
from repro.store import QueryEngine as JQueryEngine  # noqa: E402
from repro.store import Store as JStore  # noqa: E402
from repro_torch.core.cooc import count_to_store  # noqa: E402
from repro_torch.data.corpus import synthetic_zipf_collection  # noqa: E402
from repro_torch.runtime import faultinject  # noqa: E402
from repro_torch.store import (  # noqa: E402
    CoocServer,
    ServerOverloaded,
    TopKRequest,
    WorkerDied,
)
from repro_torch.store.requests import envelope_times, make_envelope  # noqa: E402
from repro_torch.store.serving import _STOP, _is_stop, backoff_delay  # noqa: E402


def serve_cpu(path, **kw):
    return CoocServer(path, device="cpu", **kw)


def wait_until_ready(server, timeout: float = 60.0) -> None:
    """Block until every worker has reported ready (its store open, its
    loop about to start). A scenario timed against a stall must not begin
    while a worker under load is still importing and opening its store."""
    deadline = time.monotonic() + timeout
    while None in server.stats()["worker_startup_s"]:
        assert time.monotonic() < deadline, "the workers never reported ready"
        time.sleep(0.02)


@pytest.fixture(scope="module")
def coll():
    return synthetic_zipf_collection(150, vocab=128, mean_len=12, seed=7)


@pytest.fixture(scope="module")
def store_path(coll, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("resilience") / "store")
    count_to_store("list-scan", coll, path, device="cpu")
    return path


@pytest.fixture
def faults(monkeypatch):
    """Arm a REPRO_FAULTS schedule for the workers this test spawns; the
    monkeypatch teardown disarms it before the next test."""

    def arm(spec: str) -> None:
        monkeypatch.setenv(faultinject.ENV_VAR, spec)

    return arm


# --------------------------------------------------------------- failpoints
SPECS = [
    "kill-worker=1:3; stall-queue=*:0.5:2 ;drop-response=4",
    "drop-response=0:2:1",
    "stall-queue=0.25",
    "",
]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_spec_arms_both_packages_alike(spec):
    """One REPRO_FAULTS spec means the same schedule to either package's
    workers: every failpoint fires at the same hits."""
    assert faultinject.ENV_VAR == jax_faultinject.ENV_VAR == "REPRO_FAULTS"
    mine, theirs = faultinject.FaultRegistry(spec), jax_faultinject.FaultRegistry(spec)
    assert bool(mine) == bool(theirs)
    for name in ("kill-worker", "stall-queue", "drop-response", "nope"):
        assert mine.active(name) == theirs.active(name)
    for w in range(3):
        assert ([mine.kill_worker(worker=w, batches_done=n) for n in range(6)]
                == [theirs.kill_worker(worker=w, batches_done=n) for n in range(6)])
        assert ([mine.stall_queue(worker=w) for _ in range(4)]
                == [theirs.stall_queue(worker=w) for _ in range(4)])
        assert ([mine.drop_response(worker=w) for _ in range(8)]
                == [theirs.drop_response(worker=w) for _ in range(8)])


def test_fault_registry_parsing_and_scoping():
    fr = faultinject.FaultRegistry(
        "kill-worker=1:3; stall-queue=*:0.5:2 ;drop-response=4"
    )
    assert fr and fr.active("kill-worker")
    assert not fr.active("nope")
    assert not fr.kill_worker(worker=0, batches_done=99)
    assert not fr.kill_worker(worker=1, batches_done=2)
    assert fr.kill_worker(worker=1, batches_done=3)
    assert fr.stall_queue(worker=7) == 0.5
    assert fr.stall_queue(worker=7) == 0.5
    assert fr.stall_queue(worker=7) == 0.0
    assert sum(fr.drop_response(worker=0) for _ in range(10)) == 4
    assert sum(fr.drop_response(worker=1) for _ in range(10)) == 4


def test_fault_registry_drop_skip():
    fr = faultinject.FaultRegistry("drop-response=0:2:1")
    assert [fr.drop_response(worker=0) for _ in range(5)] == [
        False, True, True, False, False,
    ]


def test_fault_registry_disarmed(monkeypatch):
    monkeypatch.delenv(faultinject.ENV_VAR, raising=False)
    fr = faultinject.from_env()
    assert not fr
    assert not fr.active("kill-worker")
    assert fr.stall_queue(worker=0) == 0.0


def test_backoff_delay_jitter_bounds():
    for attempt in range(6):
        lo = backoff_delay(attempt, base_ms=40, rng=lambda: 0.0)
        hi = backoff_delay(attempt, base_ms=40, rng=lambda: 1.0)
        assert lo == pytest.approx(0.5 * hi)
        assert hi == pytest.approx(min(40 * 2 ** attempt, 2000) / 1e3)
    assert backoff_delay(30, base_ms=40, rng=lambda: 1.0) == 2.0


# ------------------------------------------------------------ wire envelope
def test_envelope_deadline_roundtrip():
    env = make_envelope(3, 7, 0, 2, TopKRequest([1]), t_submit=5.0, deadline=9.0)
    assert envelope_times(env) == (5.0, 9.0)
    assert envelope_times((3, 7, 0, 2, TopKRequest([1]))) == (None, None)


def test_stop_sentinel_is_not_none_and_survives_pickle():
    assert not _is_stop(None)
    assert _is_stop(_STOP)
    assert _is_stop(pickle.loads(pickle.dumps(_STOP)))


def test_stray_none_on_queue_does_not_stop_worker(store_path):
    with serve_cpu(store_path, workers=1, batch_window_ms=0.5) as server:
        client = server.client()
        ids, _ = client.topk([3], k=4)
        server._request_qs[0].put(None)
        time.sleep(0.2)
        ids2, _ = client.topk([3], k=4, timeout=15.0)  # worker still alive
        np.testing.assert_array_equal(ids, ids2)
    assert server.stats()["workers_lost"] == 0


# ---------------------------------------------------------- worker death
def test_worker_died_mid_execute_is_typed_and_fast(store_path, faults):
    """A SIGKILL'd worker's in-flight request fails back as WorkerDied in
    supervisor time, not at the 60 s client timeout."""
    faults("kill-worker=0")
    with serve_cpu(store_path, workers=1, batch_window_ms=0.5,
                   max_respawns=0) as server:
        client = server.client()
        t0 = time.monotonic()
        with pytest.raises(WorkerDied):
            client.topk([3], k=4)
        elapsed = time.monotonic() - t0
        assert elapsed < 20, f"WorkerDied took {elapsed:.1f}s (hang?)"
        time.sleep(0.2)
        with pytest.raises(WorkerDied):
            client.topk([3], k=4)
    assert server.stats()["resilience"]["worker_died_failures"] >= 1


def test_killed_worker_respawns_and_every_answer_returns(store_path, faults):
    """kill-worker fires on every incarnation of worker 0, so the slot dies
    after every other batch; with a respawn budget and client retries every
    request still completes, equal to the reference engine's answer."""
    faults("kill-worker=0:2")
    jref = JQueryEngine(JStore.open(store_path))
    want = jref.topk(np.arange(16), k=4, score="dice")
    with serve_cpu(store_path, workers=2, routing=True,
                   batch_window_ms=0.5, max_respawns=2) as server:
        client = server.client()
        for _ in range(20):
            ids, scores = client.execute(
                [TopKRequest(np.arange(16), k=4, score="dice")],
                timeout=30.0, retries=4,
            )[0]
            np.testing.assert_array_equal(ids, want[0])
            np.testing.assert_array_equal(scores, want[1])
    stats = server.stats()
    assert stats["resilience"]["respawns"] >= 1
    assert stats["resilience"]["worker_died_failures"] >= 1


def test_one_injected_kill_gives_one_respawn(store_path, monkeypatch):
    """The schedule ``chip_smoke.py`` uses on the card: worker 1 is armed to die
    after a few batches, the failpoint is disarmed once the fleet is up
    (so the replacement lives), every answer comes back after retries, and
    exactly one respawn shows."""
    jref = JQueryEngine(JStore.open(store_path))
    monkeypatch.setenv(faultinject.ENV_VAR, "kill-worker=1:2")
    # routed: every request below splits over both workers, so worker 1
    # takes a batch per request and meets its failpoint
    server = serve_cpu(store_path, workers=2, routing=True,
                       batch_window_ms=0.5).start()
    monkeypatch.delenv(faultinject.ENV_VAR)
    try:
        client = server.client()
        rng = np.random.default_rng(5)
        for r in range(24):
            terms = rng.integers(0, 128, size=8)
            score = ("count", "pmi", "dice")[r % 3]
            got = client.execute([TopKRequest(terms, k=5, score=score)],
                                 timeout=30.0, retries=3)[0]
            want = jref.topk(terms, k=5, score=score)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_max_ulp(got[1], want[1], maxulp=1)
        # the supervisor has caught the death once worker 1 took a batch
        deadline = time.monotonic() + 30
        while (server.stats()["resilience"]["respawns"] < 1
               and time.monotonic() < deadline):
            client.topk(rng.integers(0, 128, size=8), k=5, timeout=30.0)
    finally:
        stats = server.stop(timeout=60)
    assert stats["resilience"]["respawns"] == 1
    assert stats["workers_lost"] == 0


def test_worker_died_mid_stream_iterator_raises_promptly(store_path, faults):
    """A stream whose first chunk arrived and whose tail was lost
    (drop-response), then the worker dies on its next batch: the iterator
    raises WorkerDied on the next ``next()`` and the client's buffers are
    drained."""
    faults("kill-worker=0:1;drop-response=0:2:1")
    with serve_cpu(store_path, workers=1, batch_window_ms=0.5,
                   max_respawns=0) as server:
        client = server.client()
        it = client.topk_stream([3], k=96, chunk=32, timeout=30.0)
        ids0, scores0 = next(it)
        assert ids0.shape == (1, 32)
        t0 = time.monotonic()
        with pytest.raises(WorkerDied):
            client.topk([5], k=4, timeout=60.0)
        with pytest.raises(WorkerDied):
            next(it)
        assert time.monotonic() - t0 < 20
        assert not client._msgs
    assert server.stats()["resilience"]["worker_died_failures"] >= 2


def test_worker_without_a_card_dies_visibly(store_path, monkeypatch):
    """device="cuda" on a host without one: each worker raises resolving
    its device in the child, so the slot dies at start-up, is respawned and
    dies again. The server shows the deaths (respawns, degraded slots,
    workers_lost) and a request fails as WorkerDied: nothing is answered
    from the host."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: workers would reach it")
    server = CoocServer(store_path, workers=2, device="cuda",
                        max_respawns=1).start()
    try:
        deadline = time.monotonic() + 90
        while (len(server.stats()["resilience"]["degraded_workers"]) < 2
               or len(server._dead) < 2) and time.monotonic() < deadline:
            time.sleep(0.1)
        live = server.stats()
        assert live["resilience"]["respawns"] == 2
        assert live["resilience"]["degraded_workers"] == [0, 1]
        assert live["worker_startup_s"] == [None, None]  # never ready
        with pytest.raises(WorkerDied):
            server.client().topk([3], k=4, timeout=10.0)
    finally:
        stats = server.stop(timeout=30)
    assert stats["workers_lost"] == 2
    assert stats["device"] == "cuda"
    assert stats["per_worker"] == []


# ------------------------------------------------------- admission control
def test_overload_sheds_typed_and_counts(store_path, faults):
    """A stalled worker with a bounded queue sheds excess load as
    ServerOverloaded at submit: typed, counted, never a silent drop."""
    faults("stall-queue=1.0:5")
    with serve_cpu(store_path, workers=1, batch_window_ms=0.0,
                   max_inflight=2, max_respawns=0) as server:
        shed, served = [], []

        def hammer():
            c = server.client()
            for _ in range(8):
                try:
                    c.topk([3], k=4, timeout=30.0)
                    served.append(1)
                except ServerOverloaded:
                    shed.append(1)

        threads = [threading.Thread(target=hammer) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        stats = server.stats()
        assert shed, "bounded queue never shed under a 1s stall"
        assert served, "shedding must not starve everything"
        assert stats["resilience"]["shed"] == len(shed)
        assert stats["resilience"]["max_inflight"] == 2


def test_overloaded_retry_then_succeed_under_stall(store_path, faults):
    """A shed request retried with jittered backoff lands once the stalled
    worker drains: the caller sees one successful execute."""
    faults("stall-queue=1.0:1")
    with serve_cpu(store_path, workers=1, batch_window_ms=0.0,
                   max_inflight=2, max_respawns=0) as server:
        wait_until_ready(server)

        def fill(c):
            for _ in range(100):
                try:
                    c.topk([1], k=4, timeout=30.0)
                    return
                except ServerOverloaded:
                    time.sleep(0.05)

        fillers = []
        for _ in range(3):
            th = threading.Thread(target=fill, args=(server.client(),))
            th.start()
            fillers.append(th)
        client = server.client()
        deadline = time.monotonic() + 10
        saw_shed = False
        while time.monotonic() < deadline:
            try:
                client.execute([TopKRequest([2], k=4)], timeout=30.0)
            except ServerOverloaded:
                saw_shed = True
                break
            time.sleep(0.02)
        assert saw_shed, "bounded queue never filled behind the stall"
        (ids, scores), = client.execute(
            [TopKRequest([2], k=4)], timeout=30.0,
            retries=10, retry_backoff_ms=100.0,
        )
        assert ids.shape == (1, 4)
        for th in fillers:
            th.join(timeout=60)
        assert server.stats()["resilience"]["shed"] >= 1


def test_deadline_expired_skip_is_counted(store_path, faults):
    """Requests whose client gave up before a worker dequeued them are
    answered with a typed expiry (client side: TimeoutError), not
    executed, and counted as serving/deadline_expired."""
    faults("stall-queue=0.8:1")
    with serve_cpu(store_path, workers=1, batch_window_ms=0.0,
                   max_respawns=0) as server:
        timeouts = []

        def call():
            c = server.client()
            try:
                c.topk([3], k=4, timeout=0.2)
            except TimeoutError:
                timeouts.append(1)

        threads = [threading.Thread(target=call) for _ in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert timeouts
        time.sleep(1.2)  # let the stalled worker drain the expired backlog
    assert server.stats()["resilience"]["deadline_expired"] >= 1


# ----------------------------------------------------------- stop
def test_stop_returns_fast_when_workers_die_with_backlog(store_path, faults):
    """Workers that die before their final snapshot while their queues hold
    a backlog: stop() returns in supervisor time, and counts the loss."""
    faults("stall-queue=30:1")
    with serve_cpu(store_path, workers=2, routing=True,
                   batch_window_ms=0.5, stats_interval_s=0.05,
                   max_respawns=0) as server:

        def call():
            c = server.client()
            try:
                c.topk(np.arange(8), k=4, timeout=25.0)
            except (WorkerDied, TimeoutError):
                pass

        for _ in range(6):
            th = threading.Thread(target=call)
            th.daemon = True
            th.start()
        time.sleep(1.0)
        for p in server._procs:
            os.kill(p.pid, signal.SIGKILL)
        t0 = time.monotonic()
        stats = server.stop(timeout=120.0)
        elapsed = time.monotonic() - t0
    assert elapsed < 15, f"stop() took {elapsed:.1f}s with dead workers"
    assert stats["workers_lost"] >= 1


def test_server_counts_lost_workers_not_silent(store_path):
    """A worker that dies without a final snapshot is counted, and its last
    periodic snapshot stands in for its traffic (``max_respawns=0``)."""
    with serve_cpu(store_path, workers=2, batch_window_ms=1.0, routing=True,
                   stats_interval_s=0.05, max_respawns=0) as server:
        client = server.client()
        for _ in range(10):
            client.topk(np.arange(16), k=4)  # splits across both workers
        deadline = time.monotonic() + 30
        while server.stats()["requests"] < 20 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert server.stats()["requests"] == 20
        victim = server._procs[0]
        os.kill(victim.pid, signal.SIGKILL)
        victim.join(timeout=30)
    stats = server.stats()
    assert stats["workers_lost"] == 1
    assert stats["requests"] == 20
    assert stats["server_timing"]["queue_wait_ms"]["count"] == 20
    assert len(stats["per_worker"]) == 2


def test_dead_slot_keeps_its_entry_when_the_supervisor_sees_it_first(store_path):
    """The supervisor archives a dead worker's last snapshot as soon as it
    sees the death; a ``stop()`` that comes first finds the corpse itself.
    Both orders give the same final stats. This one waits for the
    supervisor to have handled the death before stopping: the dead slot
    keeps its ``per_worker`` entry and its traffic stays in the sums."""
    server = serve_cpu(store_path, workers=2, batch_window_ms=1.0, routing=True,
                       stats_interval_s=0.05, max_respawns=0)
    handled, covered = threading.Event(), threading.Event()
    on_death, absorb = server._on_worker_death, server._absorb_stats_msg
    reported: dict = {}

    def observed_death(wid, exitcode):
        on_death(wid, exitcode)
        handled.set()

    def observed_snapshot(kind, wid, payload):
        absorb(kind, wid, payload)
        if kind != "ready":
            reported[wid] = payload["stats"]["requests"]
            if sum(reported.values()) == 20:
                covered.set()

    server._on_worker_death = observed_death
    server._absorb_stats_msg = observed_snapshot
    with server:
        client = server.client()
        for _ in range(10):
            client.topk(np.arange(16), k=4)  # splits across both workers
        assert covered.wait(30), f"snapshots cover {reported} requests"
        victim = server._procs[0]
        os.kill(victim.pid, signal.SIGKILL)
        victim.join(timeout=30)
        assert handled.wait(30), "the supervisor never saw the death"
    stats = server.stats()
    assert stats["workers_lost"] == 1
    assert stats["requests"] == 20
    assert stats["server_timing"]["queue_wait_ms"]["count"] == 20
    assert len(stats["per_worker"]) == 2
    assert [w["requests"] for w in stats["per_worker"]] == [
        reported[0], reported[1]
    ]
    assert stats["resilience"]["degraded_workers"] == [0]
