"""The comparisons that decide ``correct``, and their limits.

Each comparison returns numbers, each held against a limit of its own in
:data:`LIMITS` (``PERF.md`` gives the readings each limit was set from):

* a build job's committed store, read back through ``Store.open``, against
  the reference's exact pair counts: pairs whose key or count differs in
  the upper rows (``pairs_wrong``) and in the symmetric neighbour rows
  (``sym_wrong``), terms whose df differs (``df_wrong``), and a document
  count that differs (``docs_wrong``); a job that committed no store reads
  every pair, row, term and its documents wrong;
* served PMI top-k answers against the reference's: requests that never
  answered (``unanswered``), the widest gap in float32 ulps between a
  served score and the reference's score of the served id
  (``score_ulps``), and the widest rank error (``rank_ulps``): at each
  position, 0 where the served id is the reference's, else the gap in ulps
  by which the reference's score of the served id lies below the
  reference's score at that position; :data:`TIE_BROKEN` where both ids
  have the same float32 argument of the log, a tie ranked against the
  lower-id rule; :data:`NOT_A_NEIGHBOUR` where the served id is none.
"""

from __future__ import annotations

import numpy as np

from yardstick import reference as R

NOT_A_NEIGHBOUR = 2**32
TIE_BROKEN = 2**31

LIMITS = {
    # exact comparisons
    "pairs_wrong": 0,
    "sym_wrong": 0,
    "df_wrong": 0,
    "docs_wrong": 0,
    "unanswered": 0,
    # float32 ulps, set from sound runs and the bfloat16 controls (PERF.md)
    "score_ulps": 16,
    "rank_ulps": 16,
}


def ordered_bits(x: np.ndarray) -> np.ndarray:
    """float32 values mapped to int64 so that adjacent floats differ by 1
    (-0.0 and +0.0 one value)."""
    x = np.where(x == 0, np.float32(0), np.asarray(x, dtype=np.float32))
    b = x.view(np.int32).astype(np.int64)
    return np.where(b < 0, -(b & 0x7FFFFFFF), b)


def ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 ulps; two -inf read 0, -inf against a finite
    value reads :data:`NOT_A_NEIGHBOUR`."""
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    d = np.abs(ordered_bits(a) - ordered_bits(b))
    both_inf = np.isneginf(a) & np.isneginf(b)
    one_inf = np.isneginf(a) ^ np.isneginf(b)
    return np.where(both_inf, 0, np.where(one_inf, NOT_A_NEIGHBOUR, d))


def store_arrays(path: str, df_ref: np.ndarray):
    """``(upper keys, counts, symmetric keys, counts, df, num_docs)`` of a
    committed store, read through the program's ``Store.open``. Neighbour
    rows are read for the terms that occur by the store's df or by the
    reference's ``df_ref``: a term that occurs by neither has no pair, and
    any the store holds for it shows in its upper rows."""
    from repro_torch.store.segments import Store

    store = Store.open(path)
    V = store.vocab_size
    df = np.asarray(store.df(), dtype=np.int64)
    keys, cnts, skeys, scnts = [], [], [], []
    for seg in store.segments:
        for primary, secs, c in seg.iter_rows():
            keys.append(int(primary) * V + np.asarray(secs, dtype=np.int64))
            cnts.append(np.asarray(c, dtype=np.int64))
    live = np.zeros(V, bool)
    live[:len(df)] |= df > 0
    live[:len(df_ref)] |= df_ref[:V] > 0
    for t in np.flatnonzero(live).tolist():
        ids, c = store.neighbours(t)
        if len(ids):
            skeys.append(t * V + np.asarray(ids, dtype=np.int64))
            scnts.append(np.asarray(c, dtype=np.int64))

    def cat(parts):
        return np.concatenate(parts) if parts else np.zeros(0, np.int64)

    k, c = cat(keys), cat(cnts)
    if len(store.segments) > 1:  # several segments: sum by key
        order = np.argsort(k, kind="stable")
        k, c = k[order], c[order]
        starts = np.flatnonzero(np.concatenate([[True], k[1:] != k[:-1]]))
        c = np.add.reduceat(c, starts) if len(k) else c
        k = k[starts]
    return k, c, cat(skeys), cat(scnts), df, int(store.num_docs)


def count_diff(ka, ca, kb, cb) -> int:
    """Keys present on one side only, plus shared keys whose counts
    differ."""
    if len(ka) == len(kb) and np.array_equal(ka, kb):
        return int(np.count_nonzero(ca != cb))
    common, ia, ib = np.intersect1d(ka, kb, assume_unique=True,
                                    return_indices=True)
    return (len(ka) - len(common)) + (len(kb) - len(common)) + int(
        np.count_nonzero(ca[ia] != cb[ib])
    )


def judge_store(got, want) -> dict:
    """Numbers of one job: ``got`` is :func:`store_arrays` of the program's
    store (or ``None`` when the job committed none), ``want`` the
    reference's ``(keys, counts, df, num_docs)``."""
    keys, counts, df, num_docs = want
    V = len(df)
    if got is None:
        return {"pairs_wrong": len(keys), "sym_wrong": 2 * len(keys),
                "df_wrong": V, "docs_wrong": 1}
    gk, gc, gsk, gsc, gdf, gdocs = got
    sk, sc = R.symmetric(keys, counts, V)
    return {
        "pairs_wrong": count_diff(gk, gc, keys, counts),
        "sym_wrong": count_diff(gsk, gsc, sk, sc),
        "df_wrong": int(np.count_nonzero(gdf != df)) if len(gdf) == V else V,
        "docs_wrong": int(gdocs != num_docs),
    }


def judge_topk(post: R.Postings, terms, ids, scores, k: int) -> dict:
    """Numbers of served PMI top-k rows: ``terms (n,)``, ``ids (n, k)``,
    ``scores (n, k)`` as served, against the reference over ``post``."""
    D = len(post.doc_ptr) - 1
    worst_score = worst_rank = 0
    rows: dict = {}
    for t, sid, ssc in zip(terms, ids, scores):
        if int(t) not in rows:
            nid, ncnt = post.row(int(t))
            df_t = max(int(post.df[t]), 1)
            df_n = np.maximum(post.df[nid], 1)
            ref = R.pmi(ncnt, df_t, df_n, D)
            rows[int(t)] = (nid, ref, R.pmi_args(ncnt, df_t, df_n, D),
                            R.topk_order(ref, k))
        nid, ref, args, order = rows[int(t)]
        want_ids = np.full(k, -1, np.int64)
        want_sc = np.full(k, -np.inf, np.float32)
        want_arg = np.full(k, np.nan, np.float32)
        want_ids[:len(order)] = nid[order]
        want_sc[:len(order)] = ref[order]
        want_arg[:len(order)] = args[order]
        # the reference's score and argument of each served id
        sid = np.asarray(sid, dtype=np.int64)
        found = np.zeros(k, bool)
        got_ref = np.full(k, -np.inf, np.float32)
        got_arg = np.full(k, np.nan, np.float32)
        if len(nid):
            pos = np.minimum(np.searchsorted(nid, sid), len(nid) - 1)
            found = (sid >= 0) & (nid[pos] == sid)
            got_ref = np.where(found, ref[pos], -np.inf).astype(np.float32)
            got_arg = np.where(found, args[pos], np.nan).astype(np.float32)
        rank = np.where(got_arg == want_arg, TIE_BROKEN, ulps(want_sc, got_ref))
        rank = np.where((sid >= 0) & ~found, NOT_A_NEIGHBOUR, rank)
        rank = np.where(sid == want_ids, 0, rank)
        score = np.where(found, ulps(np.asarray(ssc, np.float32), got_ref), 0)
        score = np.where(sid < 0, ulps(np.asarray(ssc, np.float32), -np.inf), score)
        worst_rank = max(worst_rank, int(rank.max()))
        worst_score = max(worst_score, int(score.max()))
    return {"score_ulps": worst_score, "rank_ulps": worst_rank}


def verdict(numbers: dict) -> bool:
    return all(v <= LIMITS[k] for k, v in numbers.items())


def report(numbers: dict) -> dict:
    """``{name: {"value": v, "limit": limit}}``, for the result's line."""
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in numbers.items()}
