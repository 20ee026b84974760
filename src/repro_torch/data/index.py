"""Indexes: the paper's two core structures.

* Forward index — the Collection itself (CSR doc → sorted unique term IDs).
* Inverted index — CSR term → ascending doc IDs (``build_inverted_index``).

Plus the accelerator-side representations:

* ``DeviceIndex`` — both indexes as tensors on one device, so the LIST-SCAN
  token gather runs where the ``segment_hist`` kernel reads its input,
* ``incidence_dense``  — (D, V) 0/1 tile material for a Gram kernel, and
  ``incidence_tile``, the same as a uint8 tensor on the kernel's device,
* ``incidence_bitpacked`` — (V, ceil(D/32)) uint32 bitmap material for a
  popcount intersection kernel (LIST-PAIRS adaptation).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data.corpus import Collection


@dataclasses.dataclass(frozen=True)
class InvertedIndex:
    term_ptr: np.ndarray   # int64[V+1]
    docs: np.ndarray       # int32[nnz] — ascending doc IDs per term
    positions: np.ndarray  # int[nnz] — flat index into c.terms of each
                           # posting's occurrence (positions[k] locates the
                           # term of posting k inside its forward document);
                           # int32 whenever the posting count allows

    @property
    def vocab_size(self) -> int:
        return len(self.term_ptr) - 1

    def postings(self, t: int) -> np.ndarray:
        return self.docs[self.term_ptr[t]:self.term_ptr[t + 1]]

    def df(self) -> np.ndarray:
        return np.diff(self.term_ptr)


def build_inverted_index(c: Collection) -> InvertedIndex:
    """One pass over the forward index (the paper's "first pass").

    Stable counting-sort by term ID keeps doc IDs ascending inside each
    posting list (documents are visited in doc order). The sort permutation
    itself is kept as ``positions``: it maps each posting back to its flat
    offset in ``c.terms``, which is what lets LIST-SCAN gather the
    strict-upper suffix of every forward document without re-searching it.
    """
    df = np.bincount(c.terms, minlength=c.vocab_size).astype(np.int64)
    term_ptr = np.zeros(c.vocab_size + 1, dtype=np.int64)
    np.cumsum(df, out=term_ptr[1:])
    doc_ids = np.repeat(
        np.arange(c.num_docs, dtype=np.int32), np.diff(c.doc_ptr)
    )
    order = np.argsort(c.terms, kind="stable")
    positions = order.astype(np.int32) if len(c.terms) < 2**31 else order
    return InvertedIndex(term_ptr, doc_ids[order].astype(np.int32), positions)


@dataclasses.dataclass(frozen=True)
class DeviceIndex:
    """The forward index (``doc_ptr``, ``terms``) and the inverted index
    (``term_ptr``, ``docs``, ``positions``) as tensors on one device, with
    the same dtypes and meaning as :class:`Collection` and
    :class:`InvertedIndex`. ``term_ptr_host`` is the host copy of
    ``term_ptr``: a batch's posting range is read from it without waiting
    for the device.

    Example::

        idx = DeviceIndex.from_collection(c, "cuda")
        idx.terms.device                 # device(type='cuda', index=0)
    """

    doc_ptr: torch.Tensor    # int64[D+1]
    terms: torch.Tensor      # int32[nnz]
    term_ptr: torch.Tensor   # int64[V+1]
    docs: torch.Tensor       # int32[nnz]
    positions: torch.Tensor  # int32 (int64 past 2^31 postings)[nnz]
    term_ptr_host: np.ndarray
    vocab_size: int

    @classmethod
    def from_collection(
        cls, c: Collection, device, inv: InvertedIndex | None = None
    ) -> "DeviceIndex":
        """Build the inverted index on the host (unless given) and move both
        indexes to ``device``."""
        inv = build_inverted_index(c) if inv is None else inv

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return cls(
            doc_ptr=put(c.doc_ptr.astype(np.int64)),
            terms=put(c.terms.astype(np.int32)),
            term_ptr=put(inv.term_ptr),
            docs=put(inv.docs),
            positions=put(inv.positions),
            term_ptr_host=inv.term_ptr,
            vocab_size=c.vocab_size,
        )


def incidence_dense(
    c: Collection,
    doc_lo: int = 0,
    doc_hi: int | None = None,
    term_lo: int = 0,
    term_hi: int | None = None,
    dtype=np.float32,
) -> np.ndarray:
    """Materialize a (docs, terms) 0/1 tile of B. Host-side tile builder for
    streaming the Gram kernel; never materializes all of B for big corpora."""
    doc_hi = c.num_docs if doc_hi is None else doc_hi
    term_hi = c.vocab_size if term_hi is None else term_hi
    out = np.zeros((doc_hi - doc_lo, term_hi - term_lo), dtype=dtype)
    for i, d in enumerate(range(doc_lo, doc_hi)):
        ts = c.doc(d)
        ts = ts[(ts >= term_lo) & (ts < term_hi)]
        out[i, ts - term_lo] = 1
    return out


def incidence_tile(
    c: Collection, doc_lo: int, doc_hi: int, term_lo: int, term_hi: int, device
) -> torch.Tensor:
    """:func:`incidence_dense` of documents [doc_lo, doc_hi) and terms
    [term_lo, term_hi) as a uint8 tensor on ``device``: the ``cooc_gram``
    kernel's input (a quarter of float32's bytes on the copy to the card).

    Example::

        tile = incidence_tile(c, 0, 2048, 0, 1024, "cuda")   # (2048, 1024) uint8
    """
    tile = incidence_dense(c, doc_lo, doc_hi, term_lo, term_hi, dtype=np.uint8)
    return torch.from_numpy(tile).to(device)


def incidence_bitpacked(
    c: Collection,
    term_lo: int = 0,
    term_hi: int | None = None,
) -> np.ndarray:
    """(terms, ceil(D/32)) uint32 bitmaps: bit d of word w = term appears in
    doc 32*w+d. 32 documents per word → 32× the HBM efficiency of a bf16
    incidence tile for pure intersection counting."""
    term_hi = c.vocab_size if term_hi is None else term_hi
    n_words = (c.num_docs + 31) // 32
    out = np.zeros((term_hi - term_lo, n_words), dtype=np.uint32)
    inv = build_inverted_index(c)
    for t in range(term_lo, term_hi):
        ds = inv.postings(t)
        np.bitwise_or.at(out[t - term_lo], ds // 32, (np.uint32(1) << (ds % 32).astype(np.uint32)))
    return out


def forward_padded(
    c: Collection, max_len: int | None = None, pad_id: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """(D, L) padded forward docs + lengths — device-friendly forward index for
    the LIST-SCAN / MULTI-SCAN paths (pad_id defaults to vocab_size)."""
    lens = c.doc_lengths()
    L = int(lens.max()) if max_len is None else max_len
    pad = c.vocab_size if pad_id is None else pad_id
    out = np.full((c.num_docs, L), pad, dtype=np.int32)
    for d in range(c.num_docs):
        ts = c.doc(d)[:L]
        out[d, : len(ts)] = ts
    return out, lens.astype(np.int32)
