"""LIST-BLOCKS (paper §2): block-pair-order traversal.

The vocabulary's inverted lists are aggregated into b blocks of up to k lists
each (b ≈ k ≈ √V, the paper's recommended choice). Within a block, postings
are re-organised by document — "smaller versions of the original documents"
restricted to that vocabulary slice. Blocks are then paired: the outer block
holds the primary keys, inner blocks the secondary keys; matching documents
generate primary × secondary count increments; finally within-outer pairs are
counted. b(b+1)/2 block pairs total; each outer block's accumulator is
complete (write-once) when its inner sweep finishes — no merge phase.

This is exactly a tiled upper-triangular Gram matmul C[I,J] = B[:,I]ᵀ B[:,J];
``count_list_blocks_gram`` runs the same traversal through the hand-written
``cooc_gram`` kernel (kernels/csrc/cooc_gram.cu) on 0/1 incidence tiles.
"""

from __future__ import annotations

import math

import numpy as np

from repro_torch.core.types import PairSink, emit_dense_rows
from repro_torch.data.corpus import Collection
from repro_torch.data.index import incidence_tile
from repro_torch.device import resolve_device


def _block_mini_docs(c: Collection, lo: int, hi: int):
    """Postings of vocab block [lo, hi) re-organised by document:
    (doc_ids present, list of per-doc term arrays restricted to the block)."""
    doc_ids = []
    mini = []
    for d in range(c.num_docs):
        ts = c.doc(d)
        sel = ts[(ts >= lo) & (ts < hi)]
        if len(sel):
            doc_ids.append(d)
            mini.append(sel)
    return np.asarray(doc_ids, dtype=np.int64), mini


def count_list_blocks(c: Collection, sink: PairSink, *, block_size: int | None = None) -> dict:
    V = c.vocab_size
    k = block_size or max(1, int(math.isqrt(V)))
    nblk = (V + k - 1) // k
    block_pairs = 0

    # Pre-build all blocks' mini documents (the paper holds the collection in
    # memory for this method; blocks are the dominant memory consumer).
    blocks = []
    for b in range(nblk):
        lo, hi = b * k, min((b + 1) * k, V)
        blocks.append((lo, hi, *_block_mini_docs(c, lo, hi)))

    for bo in range(nblk):
        lo, hi, docs_o, mini_o = blocks[bo]
        width = hi - lo
        acc = np.zeros((width, V - lo), dtype=np.int64)  # primary-local × [lo, V)
        # within-outer-block pairs first (the paper's "inner join")
        for ts in mini_o:
            loc = ts - lo
            n = len(loc)
            if n >= 2:
                ii = np.repeat(loc, n)
                jj = np.tile(loc, n)
                m = ii < jj
                np.add.at(acc, (ii[m], jj[m]), 1)
        block_pairs += 1
        # pair with all inner blocks to the right
        for bi in range(bo + 1, nblk):
            ilo, ihi, docs_i, mini_i = blocks[bi]
            block_pairs += 1
            # matching document pairs via sorted merge of doc id lists
            oi = np.searchsorted(docs_o, docs_i)
            oi = np.clip(oi, 0, len(docs_o) - 1) if len(docs_o) else oi
            for pos_i, d in enumerate(docs_i):
                if len(docs_o) == 0:
                    break
                p = oi[pos_i]
                if p < len(docs_o) and docs_o[p] == d:
                    prim = mini_o[p] - lo
                    sec = mini_i[pos_i] - lo
                    np.add.at(acc, (np.repeat(prim, len(sec)), np.tile(sec, len(prim))), 1)
        emit_dense_rows(acc, sink, row_lo=lo, col_lo=lo)
        blocks[bo] = None  # discard outer block (paper: "no longer considered")
    return {"num_blocks": nblk, "block_pairs": block_pairs, "block_size": k}


def count_list_blocks_gram(
    c: Collection,
    sink: PairSink,
    *,
    vocab_tile: int = 512,
    doc_tile: int = 2048,
    device: str = "cuda",
) -> dict:
    """LIST-BLOCKS as a tiled Gram over 0/1 incidence tiles.

    Streams (doc_tile × vocab_tile) uint8 tiles of B to ``device`` and
    through ``cooc_gram`` — the hand-written kernel on ``"cuda"`` (the
    default), its plain PyTorch version on ``"cpu"``. A diagonal block pair
    passes one tile twice. Tiling over documents bounds device memory the
    same way the paper's flushing bounds host memory — but every output tile
    is complete when emitted, so there is no merge. Each tile's int32 Gram
    is exact; the host sums tiles in int64.
    """
    from repro_torch.kernels import ops as kops

    dev = resolve_device(device)
    V, D = c.vocab_size, c.num_docs
    nvb = (V + vocab_tile - 1) // vocab_tile
    matmuls = 0
    for bi in range(nvb):
        ilo, ihi = bi * vocab_tile, min((bi + 1) * vocab_tile, V)
        for bj in range(bi, nvb):
            jlo, jhi = bj * vocab_tile, min((bj + 1) * vocab_tile, V)
            acc = np.zeros((ihi - ilo, jhi - jlo), dtype=np.int64)
            for dlo in range(0, D, doc_tile):
                dhi = min(dlo + doc_tile, D)
                bi_tile = incidence_tile(c, dlo, dhi, ilo, ihi, dev)
                bj_tile = (
                    bi_tile
                    if (jlo, jhi) == (ilo, ihi)
                    else incidence_tile(c, dlo, dhi, jlo, jhi, dev)
                )
                acc += kops.cooc_gram(bi_tile, bj_tile).cpu().numpy()
                matmuls += 1
            emit_dense_rows(acc, sink, row_lo=ilo, col_lo=jlo)
    return {"vocab_tiles": nvb, "matmuls": matmuls}
