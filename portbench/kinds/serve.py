"""The serving traffic: closed-loop clients of the program's
``CoocServer``, each sending batches of top-k queries and waiting for each
answer before the next.

Set-up builds the configuration's store with the program's
``count_to_store``, starts the server and waits until every worker is
ready, then lets each client send a few warm-up batches. The window runs
until its seconds have passed; a request in flight then finishes and
counts. The client loop is the one of ``_serve_multiprocess`` in
``src/repro_torch/launch/cooc_serve.py``, without its pair-lookup phase.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time

import numpy as np

from yardstick import control as C, gen, judge, reference as R, spawned, trace as T

REQUEST_TIMEOUT_S = 60.0  # a request unanswered this long never answers
POOL_BATCHES = 2048       # batches drawn for each client; it cycles through them

def _memory_sampler(cuda: bool):
    """A thread that keeps the card's highest memory in use by every
    process (``total − free``), sampled every 0.2 s until ``stop``."""
    peak = [0]
    stop = threading.Event()

    def loop():
        import torch

        while not stop.is_set():
            free, total = torch.cuda.mem_get_info()
            peak[0] = max(peak[0], total - free)
            stop.wait(0.2)

    th = threading.Thread(target=loop, daemon=True)
    if cuda:
        th.start()
    return peak, stop, th


def run(cell, seed: int, seconds: float, trace: bool, device: str, clock) -> dict:
    import torch

    from repro_torch.store.serving import CoocServer

    cfg, mix = cell.config, cell.mix
    V, cuda = cfg["vocab_size"], device.startswith("cuda")
    ptr, terms = gen.collection(cfg, cfg["serve_docs"], seed)
    df = np.bincount(terms, minlength=V)
    draw = gen.SAMPLERS[mix["terms"]](df, mix)
    work = tempfile.mkdtemp(prefix="portbench-", dir=tempfile.gettempdir())
    trace_dir = os.path.join(work, "worker-traces") if trace and cuda else None
    memory_dir = os.path.join(work, "worker-memory") if trace and cuda else None
    server = None
    try:
        store_path = os.path.join(work, "store")
        gen.count(cfg, gen.to_program(cfg, ptr, terms), store_path, device)
        if cuda:
            torch.cuda.empty_cache()
        if trace_dir:
            os.makedirs(trace_dir)
            os.makedirs(memory_dir)
        with spawned.WorkerHook(trace_dir, memory_dir):
            server = CoocServer(
                store_path, workers=cfg["serve_workers"],
                batch_window_ms=cfg["batch_window_ms"],
                cache_rows=cfg["cache_rows"], device=device,
                stats_interval_s=cfg["stats_interval_s"],
            ).start()
        deadline = time.monotonic() + 600
        while None in server.stats()["worker_startup_s"]:
            if time.monotonic() > deadline:
                raise RuntimeError("the serving workers did not start")
            time.sleep(0.05)
        startup = server.stats()["worker_startup_s"]
        clients = [server.client() for _ in range(mix["clients"])]
        k, score, batch = mix["k"], mix["score"], mix["batch"]

        def warm(i):
            rng = np.random.default_rng([seed, 0, i])
            for _ in range(mix["warmup_batches"]):
                clients[i].topk(draw(rng, batch), k=k, score=score,
                                timeout=REQUEST_TIMEOUT_S)

        threads = [threading.Thread(target=warm, args=(i,)) for i in range(len(clients))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        # every worker publishes a snapshot while idle: this is the
        # window's baseline
        time.sleep(4 * cfg["stats_interval_s"])
        base = server.stats()

        # every batch a client can send, drawn before the window
        pools = [draw(np.random.default_rng([seed, 1, i]), POOL_BATCHES * batch)
                 .reshape(POOL_BATCHES, batch) for i in range(len(clients))]
        peak, stop_sampler, sampler = _memory_sampler(cuda)
        answers: list[list] = [[] for _ in clients]
        failed = [0] * len(clients)
        go = threading.Barrier(len(clients) + 1)
        t_end = [0.0]

        def client_loop(i):
            go.wait()
            n = 0
            while time.perf_counter() < t_end[0]:
                q = pools[i][n % POOL_BATCHES]
                n += 1
                t_send = time.perf_counter()
                try:
                    ids, sc = clients[i].topk(q, k=k, score=score,
                                              timeout=REQUEST_TIMEOUT_S)
                except Exception:  # a request that never answered
                    failed[i] += 1
                    continue
                answers[i].append((t_send, time.perf_counter(), q, ids, sc))

        threads = [threading.Thread(target=client_loop, args=(i,))
                   for i in range(len(clients))]
        for th in threads:
            th.start()
        setup_s = clock()
        cpu0 = T.process_cpu_s()
        t0, t0_unix = time.perf_counter(), time.time()
        t_end[0] = t0 + seconds
        go.wait()
        for th in threads:
            th.join()
        replies = [a for per in answers for a in per]
        t_last = max((a[1] for a in replies), default=time.perf_counter())
        window_s = t_last - t0
        t1_unix = t0_unix + window_s
        cpu1 = T.process_cpu_s()
        stop_sampler.set()
        if cuda:
            sampler.join()
        final = server.stop()
        server = None
        batches, nfail = len(replies), sum(failed)
        lat = np.array([a[1] - a[0] for a in replies])
        out = {
            "setup_s": setup_s,
            "window_s": window_s,
            "e2e": {"topk_qps": batches * batch / window_s},
            "attempted": batches + nfail,
            "failed": nfail,
            "memory_peak_bytes": int(peak[0]),
            "log": [f"batches answered {batches}, failed {nfail}, in "
                    f"{window_s:.4f} s; worker start-up s {startup}",
                    f"this process used {cpu1 - cpu0:.2f} s of CPU in the window"],
        }
        ops_ = []
        if trace_dir:
            ops_ = T.clip(T.read_trace_dir(trace_dir), t0_unix, t1_unix)
            out["log"].append(
                f"workers' own allocator peaks by card {spawned.memory_by_card(memory_dir)}, "
                f"device operations by card "
                f"{ {c: len(o) for c, o in T.ops_by_card(trace_dir).items()} }")
        out["ctx"] = {
            "base": base, "final": final,
            "latency_s": lat, "ops": ops_, "window": (t0_unix, t1_unix),
        }

        # the comparison: a sample of the answered rows drawn from the seed
        t_cmp = time.perf_counter()
        rows = [(q[j], ids[j], sc[j]) for _, _, q, ids, sc in replies
                for j in range(len(q))]
        pick = np.random.default_rng([seed, 2]).choice(
            len(rows), size=min(mix["sample_rows"], len(rows)), replace=False)
        post = R.Postings(ptr, terms, V)
        numbers = judge.judge_topk(
            post, [rows[i][0] for i in pick], [rows[i][1] for i in pick],
            [rows[i][2] for i in pick], k)
        numbers["unanswered"] = nfail
        out["numbers"] = numbers
        out["compare_s"] = time.perf_counter() - t_cmp
        out["log"].append(f"rows answered {len(rows)}, compared {len(pick)}")
        return out
    finally:
        if server is not None:
            server.stop()
        shutil.rmtree(work, ignore_errors=True)


def breakdown(out: dict) -> dict:
    """The device operations with most time in the workers, and the longest
    stretches in which none ran, each named by the innermost worker span
    open in it: the span events the workers ship with their final
    snapshots."""
    ctx = out["ctx"]
    metrics = ctx["final"].get("metrics", {})
    label = T.innermost_span(metrics.get("events", []), metrics.get("epoch_unix", 0.0))
    return {"device_ops": T.top_ops(ctx["ops"]),
            "idle_gaps": T.idle_gaps(ctx["ops"], *ctx["window"], label)}


def control(cell, seed: int) -> dict:
    """The comparison's numbers when the reference's PMI top-k, scored in
    bfloat16, answers ``sample_rows`` queries of the mix drawn from
    ``seed``."""
    cfg, mix = cell.config, cell.mix
    ptr, terms = gen.collection(cfg, cfg["serve_docs"], seed)
    draw = gen.SAMPLERS[mix["terms"]](np.bincount(terms, minlength=cfg["vocab_size"]), mix)
    q = draw(np.random.default_rng([seed, 1, 0]), mix["sample_rows"])
    post = R.Postings(ptr, terms, cfg["vocab_size"])
    ids, scores = C.topk_answers(post, q, mix["k"])
    return judge.judge_topk(post, q, ids, scores, mix["k"])
