"""Batched query engine over a co-occurrence store.

Serving-side counterpart of the counting pipeline: pair-count point lookups,
and top-k neighbour queries scored by raw count, PMI, or Dice. Neighbour
rows are gathered from the mmap'd segments through a small LRU cache, padded
into a rectangular batch, and scored/top-k'd in one batched launch.

Queries are typed request objects (store/requests.py): ``execute()`` takes a
batch of ``TopKRequest | PairCountsRequest | NeighboursRequest``, coalesces
compatible requests into single launches, and answers them through the one
``execute_groups`` path. The classic
``topk`` / ``pair_counts`` / ``neighbours`` methods remain as thin
byte-identical shims over that path.

The score-and-select step is ``kernels.ops.topk_gather`` on the engine's
device: the hand-written ``topk_gather`` CUDA kernel on the card (the
default), its plain PyTorch version with ``device="cpu"``. Both rank ties
lowest candidate slot first, like the reference package's ``lax.top_k``.

Scores (df = document frequency, D = total documents):
    count  c(t, n)                        — exact integer top-k
    pmi    log(c · D / (df_t · df_n))    — pointwise mutual information
    dice   2c / (df_t + df_n)            — Dice coefficient
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.store.requests import (
    NeighboursRequest,
    PairCountsRequest,
    TopKRequest,
    check_request_types,
    coalesce,
    default_kernel,
    execute_groups,
)
from repro_torch.store.segments import Store


class QueryEngine:
    """Batched queries against a :class:`~repro_torch.store.segments.Store` with an
    LRU row cache and the score-and-select step on ``device``.

    The cache is the warm path: hot rows (Zipf head terms under real serving
    traffic) are answered from memory; cold rows fall through to the shared
    mmap'd segment files, touching only the pages a row needs. The cache
    auto-invalidates when the store's manifest version changes (append,
    ingest, compact).

    Args:
        store: an open :class:`Store`.
        cache_rows: LRU capacity (merged neighbour rows).
        device: where top-k runs: ``"cuda"`` (the default; raises without a
            card) launches the ``topk_gather`` kernel, ``"cpu"`` runs its
            plain PyTorch version.
        registry: telemetry registry for ``query/execute`` spans and
            cache/kernel-dispatch counters; ``None`` uses the process-global
            one (disabled by default — see repro/obs). Serving workers pass
            their own so metrics can cross the process boundary.

    Example::

        store, _ = count_to_store("auto", collection, "/tmp/store")
        eng = QueryEngine(store)
        ids, scores = eng.topk([3, 17], k=5, score="pmi")
        counts = eng.pair_counts(np.array([[3, 17]]))
    """

    def __init__(
        self,
        store: Store,
        *,
        cache_rows: int = 4096,
        device: str = "cuda",
        registry: "obs.Registry | None" = None,
    ):
        self.store = store
        self.cache_rows = cache_rows
        self.device = resolve_device(device)
        self.kernel = default_kernel(self.device.type)
        self._cache: OrderedDict[int, tuple[np.ndarray, np.ndarray]] = OrderedDict()
        self._df = store.df()
        self._num_docs = max(store.num_docs, 1)
        self._store_version = store.version
        self.stats = {"cache_hits": 0, "cache_misses": 0}
        self._registry = registry

    @property
    def registry(self) -> "obs.Registry":
        """The engine's telemetry registry (a fixed one if passed at
        construction, otherwise whatever is globally installed now)."""
        return self._registry if self._registry is not None else obs.get_registry()

    # ----------------------------------------------------------- cache
    def _maybe_invalidate(self) -> None:
        if self.store.version != self._store_version:
            self._cache.clear()
            self._df = self.store.df()
            self._num_docs = max(self.store.num_docs, 1)
            self._store_version = self.store.version

    def _row(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        """Cached merged row of term ``t`` (no out-of-vocab validation —
        callers go through ``_check_terms`` first)."""
        self._maybe_invalidate()
        hit = self._cache.get(t)
        if hit is not None:
            self._cache.move_to_end(t)
            self.stats["cache_hits"] += 1
            return hit
        self.stats["cache_misses"] += 1
        ids, cnts = self.store.neighbours(t)
        row = (np.asarray(ids, dtype=np.int64), np.asarray(cnts, dtype=np.int64))
        self._cache[t] = row
        if len(self._cache) > self.cache_rows:
            self._cache.popitem(last=False)
        return row

    # --------------------------------------------------------- queries
    def _check_terms(self, terms: np.ndarray) -> None:
        V = self.store.vocab_size
        bad = terms[(terms < 0) | (terms >= V)]
        if bad.size:
            raise ValueError(
                f"out-of-vocab term id(s) {sorted(set(bad.tolist()))[:5]}; "
                f"store vocab_size is {V}"
            )

    def execute(self, requests) -> list:
        """Answer a batch of typed requests (store/requests.py) with as few
        kernel launches as possible — one ``topk`` launch per distinct
        ``(k, score)``, all pair lookups together. Returns one result per
        request, in order: ``(ids, scores)`` for top-k, a count vector for
        pairs, ``(ids, counts)`` for neighbours, and an **iterator of
        score-ordered chunks** for streamed top-k (``chunk=`` set).

        An invalid request (e.g. out-of-vocab term) raises the engine's
        canonical ``ValueError`` for the first offending request.

        Example::

            reqs = [TopKRequest([3, 17], k=5, score="pmi"),
                    PairCountsRequest(np.array([[3, 17]]))]
            (ids, scores), counts = eng.execute(reqs)
        """
        reqs = list(requests)
        check_request_types(reqs)
        results: dict[int, list] = {}
        errors: dict[int, str] = {}

        def emit(tag, ok, payload, *, seq=0, last=True, extra=None):
            if ok:
                results.setdefault(tag, []).append(payload)
            else:
                errors.setdefault(tag, payload[1])

        reg = self.registry
        qstats: dict | None = {} if reg.enabled else None
        hits0, misses0 = self.stats["cache_hits"], self.stats["cache_misses"]
        with reg.span("query/execute", requests=len(reqs), kernel=self.kernel):
            execute_groups(self, coalesce(list(enumerate(reqs))), emit, qstats)
        if qstats is not None:
            reg.counter("query.requests").inc(len(reqs))
            for key, n in qstats.items():
                # topk_launches / pair_launches are the kernel-dispatch
                # counters; the rest are per-query volumes
                reg.counter(f"query.{key}").inc(n)
            reg.counter("query.cache_hits").inc(
                self.stats["cache_hits"] - hits0
            )
            reg.counter("query.cache_misses").inc(
                self.stats["cache_misses"] - misses0
            )
        if errors:
            raise ValueError(errors[min(errors)])
        out = []
        for i, req in enumerate(reqs):
            if isinstance(req, TopKRequest) and req.chunk is not None:
                out.append(iter(results[i]))
            else:
                out.append(results[i][0])
        return out

    def neighbours(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        """Merged ``(neighbour_ids, counts)`` of term ``t``, LRU-cached.
        Shim over :class:`NeighboursRequest` (out-of-vocab ids raise the
        same ``ValueError`` as every other query).

        Example::

            ids, cnts = eng.neighbours(3)   # every co-occurring term of 3
        """
        return self.execute([NeighboursRequest(t)])[0]

    def pair_counts(self, pairs: np.ndarray) -> np.ndarray:
        """Exact counts for a ``(B, 2)`` batch of unordered term pairs.
        Shim over :class:`PairCountsRequest`.

        Example::

            eng.pair_counts(np.array([[3, 17], [5, 5]]))  # diagonal -> 0
        """
        return self.execute([PairCountsRequest(pairs)])[0]

    def topk(
        self, terms, k: int = 10, *, score: str = "count"
    ) -> tuple[np.ndarray, np.ndarray]:
        """Top-k neighbours for a batch of terms. Shim over
        :class:`TopKRequest` — byte-identical to the request path.

        Returns ``(ids (B, k), scores (B, k))``; rows with fewer than k
        neighbours are padded with id -1 (score 0 for count, -inf else).
        Ties rank the lower candidate-slot index first, on either device.

        Example::

            ids, scores = eng.topk([3, 17], k=5, score="count")
        """
        return self.execute([TopKRequest(terms, k=k, score=score)])[0]

    def topk_stream(
        self, terms, k: int, *, score: str = "count", chunk: int = 1024
    ):
        """Streaming top-k: an iterator of score-ordered ``(ids, scores)``
        column blocks of width ≤ ``chunk``. Concatenating the chunks along
        axis 1 equals ``topk(terms, k, score=score)`` exactly — chunking is
        a transport feature (serving moves large-k responses across the
        process boundary block by block), not an approximation.

        Example::

            chunks = list(eng.topk_stream([3], k=5000, chunk=512))
            ids = np.concatenate([c[0] for c in chunks], axis=1)  # (1, 5000)
        """
        return self.execute([TopKRequest(terms, k=k, score=score, chunk=chunk)])[0]

    def tile(
        self, terms: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """The padded int32 ``(ids, cnts, df_t, df_n)`` candidate tile of
        ``terms`` (validated ids): ``(B, L)`` merged rows padded with id -1,
        count 0 and df 1, ``L`` rounded up to a power of two; ``df_t`` is
        ``(B,)``. Both df sides are clamped to >= 1: stores built without
        df metadata would otherwise divide by zero and tie every PMI
        candidate at +inf."""
        rows = [self._row(int(t)) for t in terms]
        L = max((len(r[0]) for r in rows), default=0)
        # round the pad length up to a power of two (few distinct shapes)
        L = max(8, 1 << (L - 1).bit_length()) if L else 8
        B = len(terms)
        ids = np.full((B, L), -1, dtype=np.int64)
        cnts = np.zeros((B, L), dtype=np.int64)
        for b, (rids, rcnts) in enumerate(rows):
            ids[b, : len(rids)] = rids
            cnts[b, : len(rids)] = rcnts
        df_n = np.where(ids >= 0, np.maximum(self._df[np.maximum(ids, 0)], 1), 1)
        df_t = np.maximum(self._df[terms], 1)
        # int32 on the device, as the reference's x64-off conversion did
        return tuple(a.astype(np.int32) for a in (ids, cnts, df_t, df_n))

    def _topk_batch(
        self, terms: np.ndarray, k: int, score: str
    ) -> tuple[np.ndarray, np.ndarray]:
        """The batched gather + score + select launch (validated inputs)."""
        ids, cnts, df_t, df_n = (
            torch.from_numpy(a).to(self.device) for a in self.tile(terms)
        )
        kk = min(k, ids.shape[1])
        top_ids, top_s = ops.topk_gather(
            ids, cnts, df_t, df_n,
            num_docs=self._num_docs, score=score, k=kk,
        )
        top_ids = top_ids.cpu().numpy()
        top_s = top_s.cpu().numpy()
        if k > top_ids.shape[1]:  # fewer candidates than k: pad out
            pad = k - top_ids.shape[1]
            top_ids = np.pad(top_ids, ((0, 0), (0, pad)), constant_values=-1)
            fill = 0 if score == "count" else -np.inf
            top_s = np.pad(top_s, ((0, 0), (0, pad)), constant_values=fill)
        return top_ids, top_s
