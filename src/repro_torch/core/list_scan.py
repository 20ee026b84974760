"""LIST-SCAN (paper §2): term-order traversal over inverted + forward index.

For each term i (the primary key), scan its posting list; for every document
referenced, load the forward document and increment an accumulator for every
secondary key j > i it contains. When the posting list is exhausted the row is
complete and written out. Each document is inspected at most once per
contained term → O(Σ_d len_d²) total, linear in collection size for bounded
document lengths (the paper's best asymptotic method, 1.69M docs in ~20h).

Observation used by the device path: the accumulator row is a *histogram* —
C[i, :] = Σ_{d ∈ postings(i)} B[d, :] — i.e. a bincount over the concatenated
forward documents of postings(i), masked to j > i. That maps directly onto
an integer-atomic scatter (the ``segment_hist`` kernel, kernels/csrc).

The CPU hot path uses the same observation: primaries are processed in
batches, their forward documents gathered into one flat token stream with a
fancy-index (no per-document Python loop), and the whole batch is counted by
a single ``np.bincount`` over packed (slot, token) keys. The pre-vectorization
per-document loop survives as ``count_list_scan_loop`` — the ingest
benchmark's baseline and the byte-identity oracle for the batched path.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import PairSink, emit_dense_rows, group_bounds
from repro_torch.data.corpus import Collection
from repro_torch.data.index import DeviceIndex, InvertedIndex, build_inverted_index
from repro_torch.device import resolve_device


def _batch_tokens(
    c: Collection, inv: InvertedIndex, lo: int, hi: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """Flat strict-upper token stream for primaries [lo, hi).

    Returns ``(tokens, owners, docs_gathered)``: for every posting of every
    primary in the batch, the suffix of the forward document *after* the
    primary itself (per-doc terms are sorted unique, so the suffix is exactly
    the secondaries j > i). ``owners[k]`` is the primary that pulled
    ``tokens[k]`` in. One fancy-index gather — no per-document Python loop,
    no post-hoc masking; memory is O(batch pair occurrences).
    """
    t0, t1 = inv.term_ptr[lo], inv.term_ptr[hi]
    docs = inv.docs[t0:t1].astype(np.int64)
    owners = np.repeat(
        np.arange(lo, hi, dtype=np.int32), np.diff(inv.term_ptr[lo:hi + 1])
    )
    starts = inv.positions[t0:t1] + 1  # one past the primary's own slot
    lens = c.doc_ptr[docs + 1] - starts
    offs = np.zeros(len(docs) + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    # flat[k] walks each doc's suffix slice back-to-back; int32 throughout —
    # the gather feeds ~len² tokens per doc, so halving element width is a
    # straight halving of the hot loop's memory traffic
    # int32 needs every flat index AND the batch token count in range: the
    # arange runs over offs[-1] (gathered tokens this batch), the offsets
    # over c.terms positions — both must fit
    idx_dtype = (
        np.int32
        if int(c.doc_ptr[-1]) < 2**31 and int(offs[-1]) < 2**31
        else np.int64
    )
    flat = np.arange(offs[-1], dtype=idx_dtype) + np.repeat(
        (starts - offs[:-1]).astype(idx_dtype), lens
    )
    tokens = c.terms[flat]  # stays int32
    return tokens, np.repeat(owners, lens), len(docs)


def count_list_scan(
    c: Collection, sink: PairSink, *, rows_per_batch: int = 64
) -> dict:
    """Vectorized LIST-SCAN: one batched histogram per primary batch.

    Each batch's flat (primary, token) stream is aggregated in one shot —
    ``np.bincount`` over packed keys when the batch grid is dense enough to
    pay for an O(rows · V) histogram, otherwise a single sort over the packed
    keys (work proportional to the batch's pair occurrences, not to V — the
    winning regime on the hyper-sparse vocabulary tail).

    Byte-identical to ``count_list_scan_loop`` (asserted in tests and by the
    ingest benchmark); the traversal order and emitted rows are exactly the
    paper's, only the per-document accumulation is batched.
    """
    inv = build_inverted_index(c)
    V = c.vocab_size
    docs_scanned = 0
    # sinks exposing the batch fast path (SpillSink) take each batch's
    # aggregated packed keys whole — no per-row splitting at all
    emit_keys = getattr(sink, "emit_keys", None)
    for lo in range(0, V, rows_per_batch):
        hi = min(lo + rows_per_batch, V)
        tokens, owners, n_docs = _batch_tokens(c, inv, lo, hi)
        docs_scanned += n_docs
        if len(tokens) == 0:
            continue
        if (hi - lo) * V < 2**31:
            # batch-relative keys fit int32: half the sort/bincount traffic
            keys = (owners - np.int32(lo)) * np.int32(V) + tokens
        else:
            keys = (owners.astype(np.int64) - lo) * V + tokens
        if len(keys) * 4 >= (hi - lo) * V:
            # dense batch: one bincount histogram over the (rows, V) grid
            counts = np.bincount(keys, minlength=(hi - lo) * V).astype(
                np.int64, copy=False
            )
            if emit_keys is not None:
                nz = np.nonzero(counts)[0]
                emit_keys(nz + np.int64(lo) * V, counts[nz])
            else:
                emit_dense_rows(counts.reshape(hi - lo, V), sink, row_lo=lo)
        else:
            # sparse batch: sort-aggregate the packed keys, skip the grid
            keys.sort()
            bounds = group_bounds(keys)
            uniq = keys[bounds[:-1]]
            counts = np.diff(bounds)
            if emit_keys is not None:
                emit_keys(uniq.astype(np.int64) + np.int64(lo) * V, counts)
                continue
            rows = uniq // V
            rb = group_bounds(rows)
            for s, e in zip(rb[:-1], rb[1:]):
                sink.emit_row(lo + int(rows[s]), uniq[s:e] % V, counts[s:e])
    return {"docs_scanned": docs_scanned}


def count_list_scan_loop(c: Collection, sink: PairSink) -> dict:
    """Pre-vectorization reference: per-document ``acc[sec] += 1`` loop.

    Kept (unregistered) as the ingest benchmark's docs/hour baseline and as
    the byte-identity oracle for the batched histogram path above.
    """
    inv = build_inverted_index(c)
    V = c.vocab_size
    docs_scanned = 0
    acc = np.zeros(V, dtype=np.int64)  # reused row accumulator
    for i in range(V):
        post = inv.postings(i)
        if len(post) == 0:
            continue
        acc[:] = 0
        for d in post:
            ts = c.doc(int(d))
            # per-doc terms are sorted: secondaries are the suffix after i
            sec = ts[np.searchsorted(ts, i) + 1:]
            acc[sec] += 1
            docs_scanned += 1
        nz = np.nonzero(acc)[0]
        if len(nz):
            sink.emit_row(i, nz, acc[nz])
    return {"docs_scanned": docs_scanned}


def _device_chunks(idx: DeviceIndex, lo: int, hi: int, launch_tokens: int):
    """The strict-upper token stream of primaries [lo, hi) as ``(tokens,
    seg)`` int32 chunks on the index's device, each of at most about
    ``launch_tokens`` tokens; ``seg`` is the primary's row in the batch.

    The same gather as :func:`_batch_tokens`, in torch ops on the device
    (``repeat_interleave``, ``cumsum``, ``arange``, fancy index): the token
    stream never leaves the card. The one host sync per batch reads its
    token count; a batch past ``launch_tokens`` also reads its posting
    offsets to cut the postings into chunks.
    """
    t0, t1 = int(idx.term_ptr_host[lo]), int(idx.term_ptr_host[hi])
    if t1 == t0:
        return
    dev = idx.terms.device
    docs = idx.docs[t0:t1].to(torch.int64)
    starts = idx.positions[t0:t1].to(torch.int64) + 1  # past the primary
    lens = idx.doc_ptr[docs + 1] - starts
    owners = torch.repeat_interleave(
        torch.arange(hi - lo, dtype=torch.int32, device=dev),
        torch.diff(idx.term_ptr[lo:hi + 1]),
        output_size=t1 - t0,
    )
    ends = torch.cumsum(lens, 0)
    total = int(ends[-1])
    if total == 0:
        return
    if total <= launch_tokens:
        cuts = [(0, t1 - t0, 0, total)]
    else:
        # cut the postings so that each chunk holds <= launch_tokens tokens
        # (a single posting longer than that is a chunk of its own)
        ends_h = ends.cpu().numpy()
        cuts, p0, base = [], 0, 0
        while p0 < t1 - t0:
            p1 = int(np.searchsorted(ends_h, base + launch_tokens, side="right"))
            p1 = max(p1, p0 + 1)
            cuts.append((p0, p1, base, int(ends_h[p1 - 1])))
            p0, base = p1, int(ends_h[p1 - 1])
    for p0, p1, base, end in cuts:
        n = end - base
        if n == 0:
            continue
        ln = lens[p0:p1]
        # flat[k] walks each document's suffix slice back to back
        shift = starts[p0:p1] - (ends[p0:p1] - ln - base)
        flat = torch.arange(n, dtype=torch.int64, device=dev)
        flat += torch.repeat_interleave(shift, ln, output_size=n)
        yield (
            idx.terms[flat],
            torch.repeat_interleave(owners[p0:p1], ln, output_size=n),
        )


# tokens one segment_hist launch may see: bounds the device memory of the
# gather (about 24 bytes per token) on the head batches
LAUNCH_TOKENS = 1 << 26


def count_list_scan_segment(
    c: Collection, sink: PairSink, *, rows_per_batch: int = 64, device: str = "cuda"
) -> dict:
    """LIST-SCAN on the device: one batched histogram per primary batch.

    The collection's forward and inverted indexes go to ``device`` once
    (:class:`DeviceIndex`). For each batch of ``rows_per_batch`` primaries
    the strict-upper token stream is gathered on the device and counted by
    ``segment_hist`` into one int32 ``(rows, V)`` grid — the hand-written
    kernel on ``"cuda"`` (the default), its plain PyTorch version on
    ``"cpu"``. A batch of more than ``LAUNCH_TOKENS`` tokens is split across
    several launches into the same grid, which bounds device memory on the
    head batches. Only the grid's nonzeros cross to the host, as ascending
    packed keys ``row * V + col`` with their counts.

    Byte-identical to ``count_list_scan`` in every sink: same rows, same
    counts, same emission order.
    """
    from repro_torch.kernels import ops as kops

    dev = resolve_device(device)
    idx = DeviceIndex.from_collection(c, dev)
    V = c.vocab_size
    emit_keys = getattr(sink, "emit_keys", None)
    batches = 0
    for lo in range(0, V, rows_per_batch):
        hi = min(lo + rows_per_batch, V)
        grid = None
        for tokens, seg in _device_chunks(idx, lo, hi, LAUNCH_TOKENS):
            if grid is None:
                grid = torch.zeros((hi - lo, V), dtype=torch.int32, device=dev)
            kops.segment_hist(tokens, seg, num_rows=hi - lo, vocab=V, out=grid)
        if grid is None:
            continue
        batches += 1
        flat = grid.view(-1)
        nz = torch.nonzero(flat).squeeze(1)
        counts = flat[nz].cpu().numpy().astype(np.int64)
        keys = nz.cpu().numpy() + np.int64(lo) * V
        if emit_keys is not None:
            emit_keys(keys, counts)
            continue
        rows = keys // V
        rb = group_bounds(rows)
        for s, e in zip(rb[:-1], rb[1:]):
            sink.emit_row(int(rows[s]), keys[s:e] - rows[s] * V, counts[s:e])
    return {"row_batches": batches}
