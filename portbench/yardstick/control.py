"""The controls: the reference put in the program's place in the nearest
precision below the one the configuration states, which each cell's
comparison has to find not correct.

* Builds state exact integer counts. The control holds each count in
  bfloat16, the step that would tempt a later change (a 16-bit float
  grid), which rounds every count above 256 that it cannot represent.
* Serving states PMI in float32. The control scores in bfloat16 (the
  argument and the log) and ranks by those scores, ties to the lower id.
"""

from __future__ import annotations

import numpy as np
import torch

from yardstick import judge, reference as R


def bf16(x) -> np.ndarray:
    return torch.as_tensor(np.asarray(x, np.float32)).bfloat16().float().numpy()


def build_numbers(doc_ptr, terms, vocab: int) -> dict:
    """The build comparison's numbers for a store whose counts are the
    reference's held in bfloat16."""
    keys, counts, _ = R.pair_counts(doc_ptr, terms, vocab)
    df = np.bincount(terms, minlength=vocab)
    low = bf16(counts).astype(np.int64)
    sk, sc = R.symmetric(keys, low, vocab)
    got = (keys, low, sk, sc, df.astype(np.int64), len(doc_ptr) - 1)
    return judge.judge_store(got, (keys, counts, df, len(doc_ptr) - 1))


def topk_answers(post: R.Postings, terms, k: int):
    """``(ids, scores)`` of PMI top-k over ``post`` scored in bfloat16."""
    D = len(post.doc_ptr) - 1
    ids = np.full((len(terms), k), -1, np.int64)
    scores = np.full((len(terms), k), -np.inf, np.float32)
    for i, t in enumerate(terms):
        nid, ncnt = post.row(int(t))
        if len(nid) == 0:
            continue
        c = torch.as_tensor(ncnt).bfloat16()
        dft = torch.tensor(max(int(post.df[t]), 1)).bfloat16()
        dfn = torch.as_tensor(np.maximum(post.df[nid], 1)).bfloat16()
        s = torch.log((c * torch.tensor(D).bfloat16()) / (dft * dfn)).float().numpy()
        order = R.topk_order(s, k)
        ids[i, :len(order)] = nid[order]
        scores[i, :len(order)] = s[order]
    return ids, scores
