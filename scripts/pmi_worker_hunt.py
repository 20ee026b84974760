"""Hunt a serving worker's PMI scores that differ from the in-process engine's.

Runs on the host (``device="cpu"``) from the repo root::

    PYTHONPATH=src python3 scripts/pmi_worker_hunt.py --requests 50000 \
        --store /tmp/hunt_store --busy 4

Builds a WT10G-shaped store with the host's ``list-scan`` (or reopens
``--store``), starts ``CoocServer(workers=4, report_inputs=True)`` on it and
sends PMI top-k requests of Zipf-drawn terms from four client threads,
one request a call, as ``chip_smoke.py`` 2e-iii does. Each client holds its
own ``QueryEngine`` on the same store and compares every answer with it,
ids and scores bit for bit. ``--busy N`` runs N busy-loop processes beside
the run as CPU load, and stops them at the end.

Prints one JSON line: requests sent, mismatches, and for each mismatch its
report: the worker and how many requests its launch coalesced, the inputs
each side read (``num_docs``, the manifest generation, each row's ``df_t``
and a digest of its ids, counts and neighbour dfs), whether they are equal,
and every score that differs, with both values, their ulp distance and the
float64 value of ``log(c·D / (df_t·df_n))`` from the store's own counts.
``outcome`` is ``no_mismatch``, ``equal_inputs`` (every mismatch read the
same inputs on both sides: the host gave different bits for the same
operation) or ``different_inputs`` (some side read a stale or wrong input).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))

from repro_torch.core.cooc import count_to_store  # noqa: E402
from repro_torch.data.corpus import synthetic_zipf_collection  # noqa: E402
from repro_torch.launch.cooc_serve import _zipf_sampler  # noqa: E402
from repro_torch.store import CoocServer, QueryEngine, Store, TopKRequest  # noqa: E402

# chip_smoke.py 2e-iii's fleet and requests: 4 workers, 4 clients, a 2 ms
# batch window, 16 Zipf-drawn terms a request, k = 10
WORKERS = CLIENTS = 4
BATCH_WINDOW_MS = 2.0
TERMS, K = 16, 10
VOCAB = 65_536
PROGRESS = 5_000


def ulps(a: float, b: float) -> int:
    """Distance of two float32 values in units in the last place."""
    def key(x):
        bits = int(np.float32(x).view(np.int32))
        return bits if bits >= 0 else -(bits & 0x7FFFFFFF)
    return abs(key(a) - key(b))


def mismatch_report(store, i, terms, got, want, meta, mine) -> dict:
    """What differs between a worker's answer and the engine's, and what
    each side read."""
    (ids, scores), (wids, wscores) = got, want
    theirs = meta.get("inputs") or {}
    df = store.df()
    d = store.num_docs
    diffs = []
    for b, c in zip(*np.nonzero(scores.view(np.int32) != wscores.view(np.int32))):
        t, n = int(terms[b]), int(wids[b, c])
        exact = None
        if n >= 0:
            cnt = int(store.pair_count(t, n))
            exact = math.log(cnt * d / (int(df[t]) * int(df[n])))
        diffs.append({
            "row": int(b), "col": int(c), "term": t, "id": n,
            "worker": float(scores[b, c]), "engine": float(wscores[b, c]),
            "ulps": ulps(scores[b, c], wscores[b, c]), "float64": exact,
        })
    return {
        "request": i,
        "terms": [int(t) for t in terms],
        "worker": meta.get("worker"),
        "batch_requests": meta.get("batch_requests"),
        "coalesced_requests": meta.get("coalesced_requests"),
        "ids_equal": bool(np.array_equal(ids, wids)),
        "inputs_equal": theirs == mine,
        "worker_inputs": theirs,
        "engine_inputs": mine,
        "scores": diffs,
    }


def build_store(path: str, docs: int, seed: int) -> Store:
    if Store.exists(path):
        return Store.open(path)
    c = synthetic_zipf_collection(docs, vocab=VOCAB, seed=seed)
    store, _ = count_to_store("list-scan", c, path, device="cpu")
    return store


def hunt(args) -> dict:
    t0 = time.perf_counter()
    store = build_store(args.store, args.docs, args.seed)
    build_s = time.perf_counter() - t0
    draw = _zipf_sampler(store, args.seed)
    rng = np.random.default_rng(args.seed + 7)
    reqs = [draw(rng, TERMS) for _ in range(args.requests)]
    reports: list = []
    sent = [0]
    errors: list = []
    lock = threading.Lock()

    def client(server, idx):
        try:
            cl = server.client()
            engine = QueryEngine(Store.open(args.store), device="cpu",
                                 report_inputs=True)
            for i in range(idx, len(reqs), CLIENTS):
                terms = reqs[i]
                req = TopKRequest(terms, k=K, score="pmi")
                got = cl.execute([req], timeout=600.0)[0]
                meta = cl.last_meta
                want = engine.topk(terms, k=K, score="pmi")
                with lock:
                    sent[0] += 1
                    done = sent[0]
                if not (np.array_equal(got[0], want[0])
                        and got[1].tobytes() == want[1].tobytes()):
                    rep = mismatch_report(engine.store, i, terms, got, want,
                                          meta, engine.last_inputs)
                    # the engine again, alone: are its own bits repeatable?
                    again = engine.topk(terms, k=K, score="pmi")
                    rep["engine_repeatable"] = again[1].tobytes() == want[1].tobytes()
                    with lock:
                        reports.append(rep)
                    print(json.dumps({"mismatch": rep}), file=sys.stderr, flush=True)
                if done % PROGRESS == 0:
                    print(f"{done} requests, {len(reports)} mismatches, "
                          f"{time.perf_counter() - t0:.0f} s", file=sys.stderr,
                          flush=True)
        except Exception as e:  # re-raised below
            errors.append(e)

    busy = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(args.busy)]
    try:
        t1 = time.perf_counter()
        with CoocServer(args.store, workers=WORKERS, device="cpu",
                        batch_window_ms=BATCH_WINDOW_MS,
                        report_inputs=True) as server:
            threads = [threading.Thread(target=client, args=(server, i))
                       for i in range(CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        stats = server.stats()
        serve_s = time.perf_counter() - t1
    finally:
        for p in busy:
            p.kill()
            p.wait()
    if errors:
        raise errors[0]
    if not reports:
        outcome = "no_mismatch"
    elif all(r["inputs_equal"] for r in reports):
        outcome = "equal_inputs"
    else:
        outcome = "different_inputs"
    return {
        "requests": sent[0],
        "score": "pmi",
        "k": K,
        "terms_per_request": TERMS,
        "mismatches": len(reports),
        "outcome": outcome,
        "reports": reports,
        "workers": WORKERS,
        "clients": CLIENTS,
        "busy_processes": args.busy,
        "cpus": os.cpu_count(),
        "store": {"path": args.store, "docs": store.num_docs,
                  "vocab": store.vocab_size, "segments": len(store.segment_names),
                  "seed": args.seed, "build_s": round(build_s, 3)},
        "server": {"requests": stats.get("requests"),
                   "topk_launches": stats.get("topk_launches"),
                   "avg_requests_per_batch": stats.get("avg_requests_per_batch"),
                   "respawns": stats["resilience"]["respawns"],
                   "workers_lost": stats["workers_lost"]},
        "serve_s": round(serve_s, 3),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=50_000)
    ap.add_argument("--store", required=True,
                    help="store directory; built here when absent")
    ap.add_argument("--docs", type=int, default=4_000,
                    help="documents of the store built when --store is absent")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--busy", type=int, default=0,
                    help="busy-loop processes run beside the hunt as CPU load")
    args = ap.parse_args()
    print(json.dumps(hunt(args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
