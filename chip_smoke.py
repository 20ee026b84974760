#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on the card, and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (Hopper:
the kernels build for sm_90a). It fails (exit code != 0, no result line)
without a card, without the repository beside it, or if any phase fails:

1. Device: print the card's name and power limit, build every kernel
   (``segment_hist``, ``topk_gather``, ``cooc_gram``, ``bitpair``) from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` each, all at once) and
   print the build times and the compiler's register report.
2. The paths, each driven with every kernel's launch count set to 0 just
   before and read just after; each kernel a path runs must be > 0.
   a. Path 1 at full width: a WT10G-shaped Zipf collection (20,000
      documents, V = 65,536) is counted into a store with ``count_to_store(
      "list-scan-segment", ...)`` on the card, then served through
      ``launch.cooc_serve.serve`` for count, PMI and Dice (``segment_hist``,
      ``topk_gather``).
   b. Path 2 at full width: the same collection remapped to df-descending
      IDs is counted with ``count_to_store("auto", ..., df_descending=True)``
      on the card; the plan must be ``freq-split`` (``cooc_gram`` head,
      ``segment_hist`` tail).
   Each store's total count must equal sum_d len_d (len_d - 1) / 2, and its
   six CSR arrays must be byte-identical to a build of the same collection
   with the host ``list-scan``.
   c. The batch driver: ``launch.cooc_run.run`` at its own defaults on the
      card must plan ``freq-split`` and write a pairs file byte-identical to
      a host ``list-scan`` job on its collection; resuming the finished run
      must launch no kernel.
   d. The opt-in methods at a reduced size (2,000 documents, V = 4,096):
      ``list-blocks-gram``, ``multi-scan-matmul`` (``cooc_gram``) and
      ``list-pairs-bitpacked`` (``bitpair``) must each equal a host
      ``list-scan`` exactly. At V = 65,536 their quadratic-in-V traversals
      build 8,256, 512 full-width or 32,896 tiles on the host, past the
      run's time limit.
   e. The live store at full width, on path 1's collection:
      i.   documents 0-9,999 are written to a feed and tailed into a fresh
           store by ``launch.cooc_stream.stream`` on the card, sealed every
           2,048 documents (``list-scan-segment``: ``segment_hist`` in this
           process) with the compaction daemon (fanout 4) alongside;
      ii.  ``launch.cooc_serve.serve`` serves that store with 4 worker
           processes and 4 clients (PMI, k = 10, 2,000 Zipf queries) while
           it follows a feed of documents 10,000-19,999 with ``--compact``
           and a 50 ms idle refresh; every worker must have launched
           ``topk_gather`` on the card (its own count, from its stats), the
           manifest generation must advance, no worker may die or shed.
           The rest of the feed is then drained from the manifest cursor and
           the store compacted to one segment, whose CSR arrays must be
           byte-identical to path 1's;
      iii. 4 workers on path 1's store answer 256 fixed count/PMI/Dice top-k
           requests, each equal to the in-process engine's on the card (ids
           and scores bit for bit; on a mismatch, the inputs the worker's
           launch read that differ from the engine's are named); again
           with ``REPRO_FAULTS`` killing
           worker 1 at its fourth batch: every answer still returns, after
           retries, with exactly one respawn.
   f. Parallel path 1: path 1's collection counted with
      ``list-scan-segment`` into a store in 16 shards by
      ``ParallelExecutor(num_workers=4)``: four spawned workers, each in its
      own CUDA context; the segment's files must equal path 1's store byte
      for byte, and every worker that completed a shard must have launched
      ``segment_hist`` on the card (its own count, from its report).
   g. ``launch.cooc_run.run(..., ingest_workers=4)`` at its defaults: its
      pairs file must equal phase 2c's byte for byte; the workers launch
      ``cooc_gram`` and ``segment_hist``.
   h. The distributed Gram: the incidence of path 2's 4,096 highest-df
      terms (uint8 (20,000, 4,096)) on a (2, 2) ("data", "model") gloo
      world of 4 ranks sharing the card, with both schedules
      (``core.distributed.gram_on_world``); each rank's products run
      ``cooc_gram`` on the card, and each C must equal one ``cooc_gram``
      of the whole B on the card and ``gram_reference`` on the host
      (``torch.equal``). The ring must issue point-to-point transfers and
      no ``all_gather``, the all-gather schedule ``all_gather``.
   i. LM serving at full width, for ``minicpm3-4b`` (MLA, dense SwiGLU)
      and ``olmoe-1b-7b`` (GQA, QK-norm, 64 experts top-8), random weights
      drawn on the card from the seed, each model freed before the next:
      i.   card against host: a copy cut to 2 layers, float32 with TF32
           off, the same weights on the card and the CPU, forward logits of
           2 x 64 tokens within max abs 1e-3;
      ii.  decode against forward (the reference's
           ``test_decode_matches_forward``) at half depth (``LM_DEPTH_DIV``;
           31 and 8 layers, full width) in float32: batch
           2, 32 positions decoded one at a time against one forward,
           within max abs 2e-2; OLMoE at capacity_factor = 64 / 8, where
           nothing drops;
      iii. ``launch.serve.serve`` in bf16 at that depth, batch 8, prompt 1,024, 64
           generated tokens, timed after one untimed ``serve()`` of the same
           weights and prompts: every logit finite, (8, 64) tokens out;
           prefill and decode tokens/s, ms a decode step (and each step by
           CUDA events) beside its bound (the bytes it must read over 3.35
           TB/s, counting for OLMoE only the experts that the warm-up's
           step routed to, and beside it the bound with every expert read,
           as ``moe_ffn`` does), peak memory; then 4 decode steps of that shape under the
           profiler: device time and kernels a step, the largest ops.
      Where a token's experts differ between two OLMoE runs, its token,
      layer and router probability gap are printed; the gates may skip
      tokens whose k-th and (k+1)-th router probabilities differ by less
      than 1e-5 (counted and printed), and a flip at any other token fails.
      The LM path runs none of the four kernels (the reference's LM modules
      reach no ``pl.pallas_call``): its launch counts are printed, all 0.
   j. GraphSAGE-Reddit and the four recsys rankers (DIEN, BERT4Rec,
      xDeepFM, BST) at their published widths, float32 with TF32 off,
      random weights drawn on the card from the seed (the rankers' full
      tables: 0.48-1.61 GiB), each model freed before the next:
      i.   card against host (a card copy with N(0, 0.05^2) added to every
           weight, so that the outputs stand at least 100 times above the
           gate, and its host copy from the card's ``state_dict``), max abs
           1e-4 on logits and scores: ``forward_full_graph`` on a
           ``random_graph(2_708, 4)`` at full_graph_sm's widths,
           ``forward_sampled`` on one minibatch_lg batch (1,024 seeds,
           fanout (15, 10)), ``forward_batched_graphs`` on molecule (128
           graphs of 30 nodes and 64 edges); each ranker's forward at batch
           64 (``bert4rec_logits`` for BERT4Rec) and ``retrieval_scores``
           over 4,096 candidates;
      ii.  timed by CUDA events (median of 20 calls after a warm-up), each
           beside its bound (bytes over 3.35 TB/s against matmul FLOPs over
           67 TFLOP/s, float32) and its peak memory: minibatch_lg on a
           ``random_graph(232_965, 492)`` with (232,965, 602) features on
           the card, 20 batches sampled on the host and gathered on the
           card (sampler, gather and forward ms, seeds/s); ogb_products'
           full-graph forward on a ``random_graph(2_449_029, 25)`` (both
           graphs built by ``random_graph_on_device``: the same arrays, the
           search and sort on the card; 1.0%
           fewer edges than the cell, printed as a cut); molecule; each
           ranker's serve_p99 (512), serve_bulk (262,144; BERT4Rec cut to
           4,096, xDeepFM to 65,536) and retrieval_cand (1M candidates;
           xDeepFM cut to 65,536), every cut printed. Outputs must be
           finite and of the reference's shapes. No kernel of the four
           runs (the reference's GNN and recsys modules reach no
           ``pl.pallas_call``): the launch counts print 0.
   l. The sharding slice, after phase 4 and before k:
      i.   the dry run (``python -m repro_torch.launch.dryrun``, the single
           16 x 16 mesh of a fake world, on the host with no card visible)
           of ``cooc-wt10g`` head_gram and tail_hist and ``olmoe-1b-7b``
           train_4k, a process each, beside the card's work: each record
           must be ok; its per-rank compute, fused-memory and collective
           terms, bottleneck and ``fits_80gb`` print on ``[dryrun]`` lines;
      ii.  one rank's share of each co-occurrence cell on the card:
           ``segment_hist`` of 524,288 postings (8,388,608 over 16 data
           ranks) into 256 x 65,536, and the 16 ``cooc_gram`` products of
           the rank's (32,768, 4,096) uint8 block with each column block of
           its ring, held with ``torch.equal`` against the plain versions
           (one product) and timed by CUDA events beside their bounds;
      iii. ``moe_ffn_ep``: OLMoE-1B-7B's MoE layer at full width (d 2,048,
           64 experts of 1,024, top-8), float32, on 8 x 1,024 tokens, on a
           (2, 2) ("data", "model") gloo world of 4 ranks sharing the card,
           against the same world on the host within 1e-4 of the output's
           largest entry, and at capacity factor 64 / 8 (no drops) against
           ``moe_ffn`` on the card.
   k. Training, each model freed before the next; run last, after phase
      4, in the order i, iii, iv, ii (a profiled LM step launches up to
      ~10^5 kernels, after which the profiler drops device events of
      later sessions):
      i.   card against host, float32 with TF32 off, from equal weights:
           one ``make_lm_train_step`` step of MiniCPM3-4B and OLMoE-1B-7B
           cut to 2 layers (2 x 256 tokens, ``pick_optimizer``'s AdamW
           with bf16 moments), loss, metrics and every parameter and
           moment within max abs 1e-3; one SGD step of each GraphSAGE step
           factory and each ranker at 2j-i's widths and weights, batch 64,
           within 1e-4, the host's gradients reaching 100 times the gate;
      ii.  MiniCPM3-4B and OLMoE-1B-7B at full width and depth in bf16
           with remat, sequence 4,096, ``pick_optimizer``'s AdamW: the
           global batch of 256 cut to the largest per-step batch whose
           reckoned peak (``train_bytes``) fits 90% of the card, printed
           before the run; one warm-up step, 4 steps timed by CUDA events
           (median ms, tokens/s, the bound 6 · N_active · tokens at 989
           TFLOP/s and its share), peak memory, one step under the
           profiler (busy share, kernels, largest ops); loss, grad_norm
           and every parameter and moment finite, some parameters changed;
      iii. GraphSAGE's four train cells (full_graph_sm, minibatch_lg at
           1,024 seeds, ogb_products with 2j's 1.0% edge cut, molecule;
           the big graphs built on the card as in 2j) and each ranker's
           ``train_batch`` of 65,536 (BERT4Rec cut to 2,048, xDeepFM to
           16,384), float32, TF32 off: the median of 10 steps beside a
           bound of 3 times the forward's matmul FLOPs at 67 TFLOP/s, peak
           memory, busy share;
      iv.  ``launch.train_lm`` at the example's defaults, 200 steps (the
           loss at step 199 below step 0's), then ``--resume`` to 250, in
           one process under ``torch.use_deterministic_algorithms(True)``:
           the resumed parameters ``torch.equal`` to the first run's
           state continued in memory; a straight 250-step run's difference is
           printed (its cosine spans 250 steps); a bf16-moment state saved
           with ``save_async`` and restored leaf for leaf equal.
      No kernel of the four runs (the reference's ``optim/``,
      ``launch/train.py``, losses and checkpoints reach no
      ``pl.pallas_call``): the launch counts print 0.
3. Kernels against their plain PyTorch versions on the card, with
   ``torch.equal`` (tolerance 0): ``segment_hist`` on path 1's head batch,
   the first tail batches of path 2 and of ``cooc_run``, a stream whose
   row leaves and re-enters the window, misaligned streams, ragged,
   all-padding and V-1 inputs, each also accumulated into a grid that
   holds counts; ``topk_gather`` for
   count, PMI and Dice at k in {1, 10, 1000, L} on a query tile of path 1's
   store, plus all-empty rows, tied rows, k = L, a row of equal scores and
   one whose k-th score ties across the cluster's slice boundaries, rows of
   1,000 slots and PMI scores of +0.0; ``cooc_gram`` on path 2's head tile,
   a ``list-blocks-gram`` tile pair, ``cooc_run``'s head tile, a skinny
   MULTI-SCAN pair, ragged D, M and N, all-ones, all-zero, one-tensor and
   empty tiles; ``bitpair`` on blocks of path 2's full-width bitmaps (W =
   625) and of the opt-in collection's (W = 63), diagonal and not, plus a
   ragged diagonal, W = 1 in one slice, ragged and all-zero words.
   Each kernel is timed two ways, per call by CUDA events around a loop
   of calls (host work per call included where it outlasts the kernel;
   the kernels JSON line's times) and as device time under the profiler,
   beside its plain version, the least time the card could take (the
   larger of bytes over 3.35 TB/s and operations over the card's peak
   rate for them), and one PyTorch library call (``torch.bincount``,
   ``torch.topk`` at k = 10, 1,000 and 4,096, ``torch._int_mm`` at the
   head, ``cooc_run`` and MULTI-SCAN shapes; none for ``bitpair``) as a
   yardstick only. ``segment_hist`` is timed at its three shapes, with
   the share of tokens its window caught (the kernel's own counter);
   ``bitpair`` at blocks 0 x 1 and 0 x 0 of both word widths; for both,
   the wrapper's host time per call on the host clock as well.
4. Summary: build docs/hour of both paths beside the host builds, top-k QPS
   and p50/p99 for each score, the live store's docs/hour, visibility lag,
   seals, merges, multi-worker QPS and worker start-up, the parallel
   builds beside the serial ones (docs/hour, ready wait, counting and
   finalize seconds, each worker's start-up), the distributed Gram's
   seconds split into products, collectives and host copies, the LM lines
   of 2i and their JSON line ``{"lm": [...]}``, the ``[gnn]`` and
   ``[recsys]`` lines of 2j and their JSON line ``{"gnn_recsys": ...}``,
   the ``[train]`` lines of 2k and their JSON line ``{"train": ...}``,
   where the time of
   each build goes (stage
   spans, the device's busy share under the profiler, FREQ-SPLIT's head and
   tail), each kernel's summed device time in path 1's and path 2's
   counting stages, serving, a profiled ``cooc_run`` and LIST-PAIRS on the
   opt-in collection, each kernel's launches and times; then the
   ``nvidia-smi`` line, the kernels' JSON line, and as the last line
   ``{"ok": true, "device": ...}``.

Stores and scratch go to ``.smoke_work/`` in the checkout, removed at exit.
"""

from __future__ import annotations

import filecmp
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")
WORK = os.path.join(HERE, ".smoke_work")

DOCS, VOCAB, SEED = 20_000, 65_536, 0
# the opt-in methods' reduced collection (see phase 2d)
OPT_DOCS, OPT_VOCAB, OPT_MEAN_LEN = 2_000, 4_096, 230
OPT_IN = ("list-blocks-gram", "multi-scan-matmul", "list-pairs-bitpacked")
# the live store (phase 2e): documents 0..LIVE_DOCS-1 streamed into a fresh
# store, the rest followed while LIVE_WORKERS workers serve it
LIVE_DOCS, SEAL_DOCS, FANOUT = 10_000, 2_048, 4
LIVE_WORKERS = LIVE_CLIENTS = 4
LIVE_LAG_MS = 15_000.0  # visibility budget of one 2,048-document seal here
LIVE_REQUESTS = 256     # fixed top-k requests that the workers answer (2e-iii)
KILL_SPEC = "kill-worker=1:3"  # worker 1 dies claiming its fourth batch
SEAL_METHOD = "list-scan-segment"  # what a seal on the card must count with
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
INT8_OPS_PER_S = 1.979e15  # H100 SXM dense int8 tensor-core rate (data sheet)
SMS, POPC_PER_CLOCK_PER_SM = 132, 16  # __popc at a quarter of the int32 rate
SEGMENT_ARRAYS = (
    "row_ptr.bin", "cols.bin", "counts.bin",
    "sym_row_ptr.bin", "sym_cols.bin", "sym_counts.bin",
)
# parallel ingest (2f, 2g): spill workers spawned on the card
INGEST_WORKERS, INGEST_SHARDS = 4, 16
# the distributed Gram (2h): the incidence of the GRAM_TERMS highest-df terms
GRAM_TERMS, GRAM_MESH, GRAM_AXES = 4_096, (2, 2), ("data", "model")
# LM serving at full width (2i): the two LM configs that fit one card whole
LM_ARCHS = ("minicpm3-4b", "olmoe-1b-7b")
LM_HOST_TOKENS, LM_DECODE_TOKENS = (2, 64), (2, 32)  # (batch, positions)
LM_HOST_TOL, LM_DECODE_TOL = 1e-3, 2e-2  # max abs on float32 logits
LM_NEAR_TIE = 1e-5  # router probability gap under which a token may flip
LM_BATCH, LM_PROMPT, LM_GEN = 8, 1_024, 64
# 2i-ii and 2i-iii run at half depth (31 of MiniCPM3-4B's 62 layers, 8 of
# OLMoE-1B-7B's 16), full width: with phase 2k's training at full depth
# the whole script came near its time limit
LM_DEPTH_DIV = 2
# GraphSAGE and the recsys rankers at full width (2j), float32, TF32 off
GNN_ARCH, RANKERS = "graphsage-reddit", ("dien", "bert4rec", "xdeepfm", "bst")
GNN_RECSYS_TOL = 1e-4  # max abs on float32 logits and scores, card vs host
# 2j-i compares at the init weights plus N(0, CHECK_NOISE^2) on every leaf:
# init leaves biases and norms at 0 and 1 and the rankers' outputs at 4e-6
# to 8e-3, where an absolute gate of 1e-4 would pass a wrong answer; the
# host's outputs must reach CHECK_SCALE times the gate
CHECK_NOISE, CHECK_SCALE = 0.05, 100
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)
TIMED_CALLS = 20  # CUDA-event-timed calls after a warm-up; the median is reported
PROFILED_CALLS = 3  # calls of each timed case under the profiler, for its device time
CHECK_BATCH, CHECK_CANDIDATES = 64, 4_096
# random_graph takes an integer mean degree: Reddit's 492 gives 114,618,780
# edges (the cell's 114,615,892); ogbn-products' 25 gives 61,225,725 (61,859,140)
REDDIT_DEGREE, PRODUCTS_DEGREE = 492, 25
MINIBATCHES = 20
# serve_bulk is a batch of 262,144 and retrieval_cand 1,000,000 candidates;
# cut where one call's float32 activations pass the card: BERT4Rec's
# (B, 20, 54,546) logits (1.14 TB at 262,144), xDeepFM's CIN outer product
# (B, 200, 39, 10) (81.8 GB at 262,144; its retrieval is a full forward a
# candidate, 312 GB at 1M)
BULK_BATCH = {"dien": 262_144, "bst": 262_144, "bert4rec": 4_096, "xdeepfm": 65_536}
RETRIEVAL_CANDIDATES = {"dien": 1_000_000, "bert4rec": 1_000_000, "bst": 1_000_000,
                        "xdeepfm": 65_536}
SCORES = ("count", "pmi", "dice")
KERNEL_NAMES = ("segment_hist", "topk_gather", "cooc_gram", "bitpair")
# training (2k)
TRAIN_HOST_TOKENS = (2, 256)  # 2k-i LM batch: (sequences, tokens)
# max abs, card vs host: the LMs (their gradients: of each leaf's largest
# host entry); GNN and rankers
TRAIN_LM_TOL, TRAIN_TOL = 1e-3, 1e-4
TRAIN_SEQ, TRAIN_GLOBAL_BATCH = 4_096, 256  # the reference's train_4k cell
TRAIN_MEM_SHARE = 0.9  # of the card's memory that a reckoned step may take
TRAIN_TIMED, GNN_TRAIN_TIMED = 4, 10  # timed steps after one warm-up
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores (data sheet)
# train_batch is 65,536 for every ranker; cut where a step's float32
# activations pass the card: BERT4Rec's (B, 20, 54,546) logits and their
# softmax and gradients (13 GB at 4,096 each), xDeepFM's CIN outer products
# kept for the backward pass (three of 20 GB at 65,536)
RANKER_TRAIN_BATCH = {"dien": 65_536, "bert4rec": 2_048, "xdeepfm": 16_384, "bst": 65_536}
TRAIN_LM_STEPS, TRAIN_LM_RESUME = 200, 250  # 2k-iv: train_lm --steps, then --resume to
# the sharding slice (2l): dry-run cells, the co-occurrence cells' per-rank
# shares on the 16 x 16 mesh, and the expert-parallel MoE
DRYRUN_CELLS = (("cooc-wt10g", "head_gram"), ("cooc-wt10g", "tail_hist"),
                ("olmoe-1b-7b", "train_4k"))
DRYRUN_TIMEOUT_S = 240
COOC_DP = COOC_MODEL = 16
GRAM_DENSITY = 0.05  # of the head's incidence, for the head_gram share
EP_MESH, EP_TOKENS = (2, 2), (8, 1_024)
EP_TOL = 1e-4  # of the output's largest entry
EP_TIMEOUT_S = 300


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def smi_query(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def smi_line() -> str:
    return smi_query("name,power.limit")


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock, from ``nvidia-smi`` (e.g. "1980 MHz")."""
    return float(smi_query("clocks.max.sm").split()[0]) * 1e6


def reset(kernels) -> None:
    for k in kernels:
        k.launches = 0


def launched(kernels, must: tuple, path: str) -> dict:
    """Every kernel's launch count; each kernel in ``must`` must be > 0."""
    counts = {k.name: k.launches for k in kernels}
    for name in must:
        check(counts[name] > 0, f"{path} launched {name} no time")
    return counts


def same_segments(a: str, b: str, what: str) -> None:
    for name in SEGMENT_ARRAYS:
        check(
            filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False),
            f"{name} differs between {what}",
        )


def check_total(seg, c) -> int:
    """The store's total count must equal sum_d len_d (len_d - 1) / 2;
    returns that sum."""
    import numpy as np

    total = int(np.fromfile(os.path.join(seg.path, "counts.bin"), np.int64).sum())
    lens = np.diff(c.doc_ptr)
    occ = int((lens * (lens - 1) // 2).sum())
    check(total == occ, f"store total count {total} != {occ} pair occurrences")
    return occ


def int_mm_operands(a, *bs):
    """``torch._int_mm``'s operands for the Gram products ``aᵀ b`` of 0/1
    uint8 tiles: viewed as int8, the contraction padded with zero documents
    to a multiple of 8 (its requirement), ``aᵀ`` row-major and each ``b``
    column-major. That is cuBLASLt's TN layout: with ``b`` row-major the 16
    products of 2l's share took 132.8 ms on the H100 instead of 16.7."""
    import torch

    pad = -a.shape[0] % 8
    a8, *b8 = (torch.nn.functional.pad(x, (0, 0, 0, pad)).view(torch.int8)
               for x in (a, *bs))
    return a8.t().contiguous(), [b.t().contiguous().t() for b in b8]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events around a
    loop of ``reps`` calls, after one warm-up call. Where a call's host work
    (argument checks, allocation, the launch) outlasts its kernels, the card
    waits for it, and that wait is counted."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean milliseconds the card spends on ``fn()``: the device time of
    every operation it launches, under the profiler, over ``reps`` calls
    after one warm-up call. The host's work per call is not counted. After
    a large profiled session the profiler may drop a later session's device
    events: a session that records none runs again, twice at most, and
    then the time is NaN (not measured)."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        _, dev_s, _ = device_busy(lambda: [fn() for _ in range(reps)])
        if dev_s > 0:
            return dev_s / reps * 1e3
    return float("nan")


def host_ms(fn, reps: int) -> float:
    """Mean milliseconds of host time per call of ``fn()`` (argument
    checks, allocation, launch), on the host clock over ``reps`` calls that
    do not wait for the card, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    spent = time.perf_counter() - t0
    torch.cuda.synchronize()
    return spent / reps * 1e3


def both_ms(fn, reps: int) -> tuple[float, float]:
    """``(cuda_ms, device_ms)`` of ``fn()``: per call by CUDA events (the
    method of the earlier kernel times, and the one the kernels JSON line
    reports) and the device time alone."""
    return cuda_ms(fn, reps), device_ms(fn, reps)


def show(t: tuple[float, float]) -> str:
    return f"{t[0]:.4f} ms (device {t[1]:.4f})"


def max_abs_err(a, b) -> float:
    """Largest |a - b| over two equal-shaped tensors (equal infinities
    count 0)."""
    import torch

    a, b = a.double(), b.double()
    diff = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


# --------------------------------------------------------------- phase 2
def main_path(c, kernels) -> dict:
    from repro_torch import obs
    from repro_torch.core.cooc import count_to_store
    from repro_torch.launch.cooc_serve import serve

    dev_path = os.path.join(WORK, "store_cuda")
    host_path = os.path.join(WORK, "store_host")
    reset(kernels)
    t0 = time.perf_counter()
    with obs.scoped() as reg:  # ingest stage spans, for the breakdown
        store, seg = count_to_store("list-scan-segment", c, dev_path)
    build_s = time.perf_counter() - t0
    served = {
        score: serve(store_path=dev_path, queries=2000, batch=64, topk=10,
                     score=score)
        for score in SCORES
    }
    launches = launched(kernels, ("segment_hist", "topk_gather"), "path 1")
    pair_occ = check_total(seg, c)

    t0 = time.perf_counter()
    _, host_seg = count_to_store("list-scan", c, host_path, device="cpu")
    host_s = time.perf_counter() - t0
    same_segments(seg.path, host_seg.path, "the cuda and the host list-scan builds")
    return {
        "store": store, "build_s": build_s, "host_build_s": host_s,
        "nnz": int(seg.nnz), "pair_occurrences": pair_occ,
        "served": served, "launches": launches,
        "stages": reg.stage_totals("ingest/"),
    }


def freq_split_path(cd, kernels) -> dict:
    """Path 2: ``auto`` on the df-remapped collection must plan and run
    ``freq-split`` on the card, into the host ``list-scan`` store bytes."""
    from repro_torch import obs
    from repro_torch.core.cooc import count_to_store

    reset(kernels)
    t0 = time.perf_counter()
    with obs.scoped() as reg:
        _, seg = count_to_store(
            "auto", cd, os.path.join(WORK, "fs_cuda"), df_descending=True
        )
    build_s = time.perf_counter() - t0
    launches = launched(kernels, ("cooc_gram", "segment_hist"), "path 2")
    check(seg.meta["source"] == "plan:freq-split",
          f"path 2 planned {seg.meta['source']}, not freq-split")
    check_total(seg, cd)
    t0 = time.perf_counter()
    _, host_seg = count_to_store(
        "list-scan", cd, os.path.join(WORK, "fs_host"), device="cpu"
    )
    host_s = time.perf_counter() - t0
    same_segments(seg.path, host_seg.path,
                  "the cuda freq-split and the host list-scan builds")
    return {"build_s": build_s, "host_build_s": host_s, "nnz": int(seg.nnz),
            "launches": launches, "stages": reg.stage_totals("ingest/")}


def driver_path(kernels) -> dict:
    """Path 2c: ``cooc_run.run`` at its defaults on the card, its pairs file
    against a host list-scan job on the same collection, then a resume of
    the finished run that must count nothing again."""
    import inspect

    from repro_torch.core.plan import CountJob, execute_job
    from repro_torch.data.corpus import synthetic_zipf_collection
    from repro_torch.data.preprocess import remap_df_descending
    from repro_torch.launch import cooc_run

    out = os.path.join(WORK, "cooc_run")
    reset(kernels)
    t0 = time.perf_counter()
    res = cooc_run.run(out_dir=out)
    run_s = time.perf_counter() - t0
    launches = launched(kernels, ("cooc_gram", "segment_hist"), "cooc_run")
    check(res["method"] == "freq-split", f"cooc_run planned {res['method']}")

    defaults = inspect.signature(cooc_run.run).parameters
    c = synthetic_zipf_collection(defaults["num_docs"].default,
                                  vocab=defaults["vocab"].default,
                                  mean_len=60, seed=0)
    cd, _ = remap_df_descending(c)
    host_pairs = os.path.join(WORK, "host_pairs.bin")
    t0 = time.perf_counter()
    execute_job(CountJob(collection=cd, output="pairs-file", out_path=host_pairs,
                         method="list-scan", device="cpu"))
    host_s = time.perf_counter() - t0
    pairs = os.path.join(out, "pairs.bin")
    check(filecmp.cmp(pairs, host_pairs, shallow=False),
          "cooc_run's pairs file differs from the host list-scan job's")

    reset(kernels)
    t0 = time.perf_counter()
    again = cooc_run.run(out_dir=out, resume=True)
    resume_s = time.perf_counter() - t0
    resumed = {k.name: k.launches for k in kernels}
    check(not any(resumed.values()), f"the resumed run launched {resumed}")
    check(again["total_count"] == res["total_count"]
          and filecmp.cmp(pairs, host_pairs, shallow=False),
          "the resumed run's pairs file differs")
    return {"cd": cd, "docs": cd.num_docs, "vocab": cd.vocab_size, "run_s": run_s,
            "pairs": pairs,
            "host_s": host_s, "resume_s": resume_s, "launches": launches,
            "shards": res["num_shards"], "distinct_pairs": res["distinct_pairs"]}


def opt_in_path(kernels) -> dict:
    """Path 2d: the opt-in kernel methods on the card at a reduced size,
    each exactly equal to a host list-scan."""
    import numpy as np

    from repro_torch.core.cooc import dense_counts
    from repro_torch.data.corpus import synthetic_zipf_collection

    c = synthetic_zipf_collection(OPT_DOCS, vocab=OPT_VOCAB,
                                  mean_len=OPT_MEAN_LEN, seed=SEED)
    want = dense_counts("list-scan", c)
    reset(kernels)
    secs = {}
    for method in OPT_IN:
        t0 = time.perf_counter()
        got = dense_counts(method, c)
        secs[method] = time.perf_counter() - t0
        check(np.array_equal(got, want), f"{method} on the card != host list-scan")
    launches = launched(kernels, ("cooc_gram", "bitpair"), "the opt-in methods")
    return {"secs": secs, "launches": launches, "postings": c.num_postings, "c": c}


# --------------------------------------------------------------- phase 2e
def worker_launches(stats: dict, what: str, every: bool = True) -> list[int]:
    """Each worker's ``topk_gather`` launches, from its own stats snapshot
    (launch counters are per process; after a respawn, the replacement's).
    Every worker must be on the card and, with ``every``, have launched
    the kernel."""
    per = stats["per_worker"]
    check(len(per) == LIVE_WORKERS, f"{what}: {len(per)} workers reported")
    for w, st in enumerate(per):
        check(st["device"] == "cuda", f"{what}: worker {w} ran on {st['device']}")
        check(not every or st["kernel_launches"]["topk_gather"] > 0,
              f"{what}: worker {w} launched topk_gather no time")
    return [st["kernel_launches"]["topk_gather"] for st in per]


def live_stream(c, kernels) -> dict:
    """2e-i: documents 0..LIVE_DOCS-1, written to a feed, tailed into a
    fresh store by ``cooc_stream.stream`` on the card (seals of SEAL_DOCS
    counted by ``list-scan-segment``), with the compaction daemon alongside."""
    from repro_torch.launch import cooc_stream
    from repro_torch.stream import write_feed

    feeds = [os.path.join(WORK, f"live_feed{i}.txt") for i in (1, 2)]
    for feed, docs in zip(feeds, (range(LIVE_DOCS), range(LIVE_DOCS, DOCS))):
        write_feed(feed, (c.doc(d) for d in docs), append=False)
    path = os.path.join(WORK, "live")
    reset(kernels)
    summary = cooc_stream.stream(
        feeds[0], path, vocab=VOCAB, seal_docs=SEAL_DOCS, max_lag_ms=LIVE_LAG_MS,
        max_docs=LIVE_DOCS, budget_pairs=4 << 20, compact=True, fanout=FANOUT,
    )
    launches = launched(kernels, ("segment_hist",), "2e-i stream ingest")
    check(summary["healthy"] and summary["docs_this_run"] == LIVE_DOCS
          and summary["method"] == SEAL_METHOD,
          f"2e-i stream ingest: {summary}")
    return {"summary": summary, "launches": launches, "feeds": feeds, "path": path}


def live_serve(st, kernels) -> dict:
    """2e-ii: ``cooc_serve.serve`` on the live store with LIVE_WORKERS
    workers and LIVE_CLIENTS clients (PMI, k = 10, 2,000 Zipf queries) while
    it follows the second feed with ``--compact``; then the rest of the feed
    is drained from the manifest cursor and the store compacted to one
    segment."""
    from repro_torch.launch import cooc_serve, cooc_stream
    from repro_torch.store import Store
    from repro_torch.stream import StreamCursor

    path, feed = st["path"], st["feeds"][1]
    gen0 = int(Store.open(path).manifest["generation"])
    reset(kernels)
    t0 = time.perf_counter()
    served = cooc_serve.serve(
        store_path=path, queries=2000, batch=64, topk=10, score="pmi",
        workers=LIVE_WORKERS, clients=LIVE_CLIENTS, batch_window_ms=2.0,
        follow=feed, compact=True, refresh_interval_ms=50, max_lag_ms=LIVE_LAG_MS,
    )
    serve_s = time.perf_counter() - t0
    launches = launched(kernels, ("segment_hist",), "2e-ii follow")
    sv = served["serving"]
    check(served["workers_lost"] == 0 and sv["resilience"]["respawns"] == 0
          and served["shed"] == 0,
          f"2e-ii: workers_lost {served['workers_lost']}, resilience {sv['resilience']}, "
          f"shed {served['shed']}")
    workers = worker_launches(sv, "2e-ii")
    check(sv["freshness"]["generation"] > gen0,
          f"2e-ii: manifest generation {sv['freshness']['generation']} did not "
          f"advance past {gen0}")
    check(served["stream"]["healthy"], f"2e-ii follow failed: {served['stream']}")

    # the stop sealed what was buffered; the rest resumes from the cursor
    followed = StreamCursor(Store.open(path), os.path.abspath(feed)).load().docs
    reset(kernels)
    t0 = time.perf_counter()
    if followed < DOCS - LIVE_DOCS:
        cooc_stream.stream(
            feed, path, seal_docs=SEAL_DOCS, max_lag_ms=LIVE_LAG_MS,
            max_docs=DOCS - LIVE_DOCS - followed, budget_pairs=4 << 20)
    drain_s = time.perf_counter() - t0
    drain_launches = {k.name: k.launches for k in kernels}
    store = Store.open(path)
    check(StreamCursor(store, os.path.abspath(feed)).load().docs == DOCS - LIVE_DOCS
          and store.num_docs == DOCS, f"the live store holds {store.num_docs} documents")
    t0 = time.perf_counter()
    segments = len(store.segment_names)
    if segments > 1:
        store.compact()
    compact_s = time.perf_counter() - t0
    return {"served": served, "serve_s": serve_s, "launches": launches,
            "workers": workers, "gen0": gen0, "followed": followed,
            "drain_s": drain_s, "drain_launches": drain_launches,
            "segments": segments, "compact_s": compact_s,
            "segment": store.segments[0]}


def live_answers(store, faults: str | None) -> dict:
    """2e-iii: LIVE_WORKERS workers on path 1's store answer LIVE_REQUESTS
    fixed top-k requests (count, PMI, Dice; k = 10) from LIVE_CLIENTS
    clients; every answer must equal the in-process engine's on the card,
    ids and scores bit for bit. With ``faults``, ``REPRO_FAULTS`` arms the
    first incarnation of the fleet only, so the killed worker's replacement
    lives: the run must still return every answer (retries) with exactly
    one respawn."""
    import threading

    import numpy as np

    from repro_torch.launch.cooc_serve import _zipf_sampler
    from repro_torch.runtime import faultinject
    from repro_torch.store import CoocServer, QueryEngine, TopKRequest

    draw = _zipf_sampler(store, SEED)
    rng = np.random.default_rng(SEED + 7)
    reqs = [TopKRequest(draw(rng, 16), k=10, score=SCORES[i % 3])
            for i in range(LIVE_REQUESTS)]
    engine = QueryEngine(store, report_inputs=True)
    want, want_inputs = [], []
    for r in reqs:
        want.append(engine.topk(r.terms, k=10, score=r.score))
        want_inputs.append(engine.last_inputs)
    got: list = [None] * len(reqs)
    metas: list = [None] * len(reqs)
    errors: list = []

    def client(server, idx):
        try:
            cl = server.client()
            for i in range(idx, len(reqs), LIVE_CLIENTS):
                got[i] = cl.execute([reqs[i]], timeout=120.0, retries=3)[0]
                metas[i] = cl.last_meta
        except Exception as e:  # re-raised below
            errors.append(e)

    if faults:
        os.environ[faultinject.ENV_VAR] = faults
    try:
        t0 = time.perf_counter()
        server = CoocServer(store.path, workers=LIVE_WORKERS, batch_window_ms=2.0,
                            report_inputs=True).start()
    finally:
        os.environ.pop(faultinject.ENV_VAR, None)  # respawns spawn clean
    try:
        threads = [threading.Thread(target=client, args=(server, i))
                   for i in range(LIVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    finally:
        stats = server.stop(timeout=120)
    run_s = time.perf_counter() - t0
    if errors:
        raise errors[0]
    for i, ((ids, scores), (wids, wscores)) in enumerate(zip(got, want)):
        check(np.array_equal(ids, wids) and scores.tobytes() == wscores.tobytes(),
              f"2e-iii: worker answer {i} ({reqs[i].score}) != the engine's; "
              + inputs_diff(metas[i], want_inputs[i], reqs[i].terms))
    respawns = stats["resilience"]["respawns"]
    check(respawns == (1 if faults else 0), f"2e-iii: {respawns} respawns")
    check(stats["workers_lost"] == 0, f"2e-iii: {stats['workers_lost']} workers lost")
    return {"stats": stats, "run_s": run_s, "requests": len(reqs),
            # a replacement that came up late may have had nothing left to do
            "workers": worker_launches(stats, "2e-iii", every=not faults),
            "launches": stats["kernel_launches"]["topk_gather"]}


def inputs_diff(meta: dict, mine: dict, terms) -> str:
    """Which inputs of a worker's top-k launch differ from the in-process
    engine's for the same request (``report_inputs``): num_docs, the
    manifest generation, and per row df of the term and the digest of the
    row's ids, counts and neighbour dfs."""
    theirs = meta["inputs"]
    head = (f"worker {meta['worker']}, {meta['coalesced_requests']} requests "
            f"coalesced, ")
    diffs = [f"{k} {theirs[k]} != {mine[k]}" for k in ("num_docs", "generation")
             if theirs[k] != mine[k]]
    for key in ("df_t", "row_crc"):
        rows = [b for b, (a, m) in enumerate(zip(theirs[key], mine[key])) if a != m]
        if rows:
            diffs.append(f"{key} differs in rows {rows} (terms "
                         f"{[int(terms[b]) for b in rows]})")
    if not diffs:
        return head + (f"the same inputs (num_docs {mine['num_docs']}, generation "
                       f"{mine['generation']}, every row's df and digest): only the "
                       "arithmetic differed")
    return head + "; ".join(diffs)


def print_live(st, sv, clean, killed, smi) -> None:
    """The live store's lines: 2e-i, 2e-ii and 2e-iii."""
    s1 = st["summary"]
    lag, seal = s1["visibility_lag_ms"], s1["seal_s"]
    print(f"[live] 2e-i stream ingest: {s1['docs_this_run']} docs in "
          f"{s1['seals_this_run']} seals of {SEAL_DOCS} ({s1['method']} on "
          f"{s1['device']}), {s1['wall_s']:.3f} s, {s1['docs_per_hour']} docs/hour; "
          f"visibility lag p50 {lag['p50']:.1f} / p99 {lag['p99']:.1f} ms against "
          f"a budget of {LIVE_LAG_MS:.0f} ms; seal p50 {seal['p50']:.3f} / p99 "
          f"{seal['p99']:.3f} s; compaction (fanout {FANOUT}): "
          f"{s1['compaction']['merges']} merges of "
          f"{s1['compaction']['segments_merged']} segments, {s1['segments']} "
          f"segments at the end; segment_hist launches "
          f"{st['launches']['segment_hist']} | {smi}")
    sd = sv["served"]
    sv_ = sd["serving"]
    timing = "; ".join(f"{k} p50 {v['p50']} / p99 {v['p99']} ms"
                       for k, v in sd["server_timing"].items())
    fr = sv_["freshness"]
    fl = sd["stream"]
    flag = fl.get("visibility_lag_ms", {})
    print(f"[live] 2e-ii serving while following: {LIVE_WORKERS} workers, "
          f"{LIVE_CLIENTS} clients, pmi k=10: {sd['topk_qps']} top-k QPS, client "
          f"p50 {sd['topk_p50_ms']} / p99 {sd['topk_p99_ms']} ms, {sd['pair_qps']} "
          f"pair QPS; server {timing}; {sv['serve_s']:.2f} s in serve() | {smi}")
    print(f"[live] 2e-ii workers: topk_gather launches {sv['workers']}, devices "
          f"{[w['device'] for w in sv_['per_worker']]}, start-up s "
          f"{[round(x, 3) for x in sv_['worker_startup_s']]}; freshness: "
          f"generation {sv['gen0']} -> {fr['generation']}, {fr['segments']} "
          f"segments, {fr['seconds_since_last_append']} s since the last append; "
          f"respawns {sv_['resilience']['respawns']}, workers lost "
          f"{sd['workers_lost']}, shed {sd['shed']}")
    print(f"[live] 2e-ii follow: {fl['docs_this_run']} docs in "
          f"{fl['seals_this_run']} seals while serving, lag p50 "
          f"{flag.get('p50', 0):.1f} / p99 {flag.get('p99', 0):.1f} ms against "
          f"{LIVE_LAG_MS:.0f}; parent segment_hist launches "
          f"{sv['launches']['segment_hist']}; --compact merged "
          f"{len(sd.get('compaction', {}).get('merged', []))} segments; the rest "
          f"({DOCS - LIVE_DOCS - sv['followed']} docs) drained from the cursor in "
          f"{sv['drain_s']:.2f} s ({sv['drain_launches']['segment_hist']} launches); "
          f"{sv['segments']} segments compacted to one in {sv['compact_s']:.2f} s; "
          f"its CSR arrays identical to path 1's | {smi}")
    for label, r in (("clean", clean), (f"with {KILL_SPEC}", killed)):
        res = r["stats"]["resilience"]
        print(f"[live] 2e-iii {label}: {r['requests']} requests in "
              f"{r['run_s']:.2f} s, every answer equal to the engine's bit for "
              f"bit; topk_gather launches per worker {r['workers']}, start-up s "
              f"{[round(x, 3) for x in r['stats']['worker_startup_s']]}; respawns "
              f"{res['respawns']}, worker_died failures "
              f"{res['worker_died_failures']} | {smi}")


# ------------------------------------------------------------ phase 2f-2h
def ingest_workers(summary: dict, what: str, must: tuple) -> dict:
    """The spill workers' own launch counts, summed. Every worker must exit
    cleanly, the parent must have drained nothing, and each worker that
    completed a shard must have counted on the card and launched every
    kernel in ``must``."""
    per = summary["per_worker"]
    check(len(per) == INGEST_WORKERS, f"{what}: {len(per)} workers reported")
    for w in per:
        check(w["exitcode"] == 0, f"{what}: worker {w['worker']} exited {w['exitcode']}")
        if w["shards"]:
            check(w["device"] == "cuda", f"{what}: worker {w['worker']} ran on {w['device']}")
            for name in must:
                check(w["kernel_launches"][name] > 0,
                      f"{what}: worker {w['worker']} launched {name} no time")
    check(summary["parent_shards"] == 0,
          f"{what}: the parent drained {summary['parent_shards']} shards")
    return {k: sum(w["kernel_launches"][k] for w in per) for k in KERNEL_NAMES}


def parallel_path(c, mp, kernels) -> dict:
    """2f: path 1's build by INGEST_WORKERS spawned workers on the card, into
    path 1's store bytes. Telemetry is on, so the workers' stage spans
    join the parent's."""
    from repro_torch import obs
    from repro_torch.core.plan import CountJob, ParallelExecutor, Planner

    plan = Planner().plan(CountJob(
        collection=c, output="store", out_path=os.path.join(WORK, "par_store"),
        method="list-scan-segment", num_shards=INGEST_SHARDS))
    reset(kernels)
    t0 = time.perf_counter()
    with obs.scoped() as reg:
        res = ParallelExecutor(num_workers=INGEST_WORKERS).execute(plan)
    wall = time.perf_counter() - t0
    parent = {k.name: k.launches for k in kernels}
    check(not any(parent.values()), f"2f: the parent launched {parent}")
    workers = ingest_workers(res.summary, "2f", ("segment_hist",))
    same_segments(res.segment.path, mp["store"].segments[0].path,
                  "the parallel build and path 1's store")
    return {"summary": res.summary, "wall_s": wall, "launches": workers,
            "stages": reg.stage_totals("ingest/")}


def parallel_driver(dr, kernels) -> dict:
    """2g: ``cooc_run`` at its defaults with INGEST_WORKERS workers; its
    pairs file must equal phase 2c's."""
    from repro_torch.launch import cooc_run

    from repro_torch import obs

    out = os.path.join(WORK, "cooc_run_par")
    reset(kernels)
    t0 = time.perf_counter()
    with obs.scoped() as reg:
        res = cooc_run.run(out_dir=out, ingest_workers=INGEST_WORKERS)
    wall = time.perf_counter() - t0
    parent = {k.name: k.launches for k in kernels}
    check(not any(parent.values()), f"2g: the parent launched {parent}")
    check(res["method"] == "freq-split", f"2g: cooc_run planned {res['method']}")
    workers = ingest_workers(res, "2g", ("cooc_gram", "segment_hist"))
    check(filecmp.cmp(os.path.join(out, "pairs.bin"), dr["pairs"], shallow=False),
          "2g: the parallel cooc_run's pairs file differs from phase 2c's")
    return {"summary": res, "wall_s": wall, "launches": workers,
            "stages": reg.stage_totals("ingest/")}


def gram_incidence(cd):
    """uint8 (D, GRAM_TERMS) 0/1 incidence of the df-remapped collection's
    GRAM_TERMS highest-df terms (IDs 0..GRAM_TERMS-1), by one scatter."""
    import numpy as np

    doc = np.repeat(np.arange(cd.num_docs), np.diff(cd.doc_ptr))
    head = cd.terms < GRAM_TERMS
    B = np.zeros((cd.num_docs, GRAM_TERMS), dtype=np.uint8)
    B[doc[head], cd.terms[head]] = 1
    return B


def distributed_gram_path(cd) -> dict:
    """2h: both schedules of the distributed Gram on a GRAM_MESH gloo world
    sharing the card; C against one ``cooc_gram`` of all of B on the card
    and ``gram_reference`` on the host. Launches are the ranks' own."""
    import torch

    from repro_torch.core.distributed import gram_on_world, gram_reference
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    B = gram_incidence(cd)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = gram_on_world(B, GRAM_MESH, GRAM_AXES, device="cuda")
    world_s = time.perf_counter() - t0
    for r in out["ranks"]:
        check(r["device"].startswith("cuda"), f"2h: rank {r['rank']} ran on {r['device']}")
        check(r["kernel_launches"]["cooc_gram"] > 0,
              f"2h: rank {r['rank']} launched cooc_gram no time")
        ring = r["schedules"]["ring"]["counters"]
        ag = r["schedules"]["allgather"]["counters"]
        check(ring.get("dist.p2p", 0) > 0 and "dist.all_gather" not in ring,
              f"2h: the ring issued {ring}")
        check(ag.get("dist.all_gather", 0) > 0, f"2h: the all-gather schedule issued {ag}")
    Bt = torch.from_numpy(B)
    t0 = time.perf_counter()
    host = gram_reference(Bt)
    host_s = time.perf_counter() - t0
    Bd = Bt.cuda()
    card = ops.cooc_gram(Bd, Bd).cpu()
    check(torch.equal(card, host), "2h: cooc_gram of B on the card != gram_reference")
    for sched, C in out["C"].items():
        check(torch.equal(torch.from_numpy(C), host),
              f"2h: the {sched} schedule's C != gram_reference")
    per = {}
    for sched in out["C"]:
        reps = [r["schedules"][sched] for r in out["ranks"]]
        per[sched] = {
            "wall_s": max(x["wall_s"] for x in reps),
            **{k: max(x["seconds"].get(k, 0.0) for x in reps)
               for k in ("product", "collective", "host_copy")},
            "host_copies": sum(x["counters"].get("dist.host_copies", 0) for x in reps),
            "copied_mb": sum(x["counters"].get("dist.d2h_bytes", 0)
                             + x["counters"].get("dist.h2d_bytes", 0) for x in reps) / 2**20,
        }
    return {"shape": B.shape, "nnz": int(B.sum()), "build_s": build_s,
            "backend": out["ranks"][0]["backend"], "cards": torch.cuda.device_count(),
            "world_s": world_s, "host_s": host_s, "schedules": per,
            "launches": {k: sum(r["kernel_launches"][k] for r in out["ranks"])
                         for k in KERNEL_NAMES}}


def print_parallel(pf, pd, gm, mp, dr, smi) -> None:
    """The lines of 2f, 2g and 2h, each beside its serial yardstick."""
    for label, r, serial_s, docs in (
            ("2f parallel path 1", pf, mp["build_s"], DOCS),
            ("2g cooc_run --ingest-workers 4", pd, dr["run_s"], dr["docs"])):
        s = r["summary"]
        print(f"[parallel] {label}: {INGEST_WORKERS} workers, {s['num_shards']} shards "
              f"({s['method']}): {r['wall_s']:.2f} s, {s['docs_per_hour']} docs/hour "
              f"({s['docs_per_hour_work']} after the ready barrier); ready_wait_s "
              f"{s['ready_wait_s']}, count_s {s['count_s']}, finalize_s "
              f"{s['finalize_s']}, reclaims {s['reclaimed_shards']}; worker start-up s "
              f"{[w['startup_s'] for w in s['per_worker']]}, shards "
              f"{[w['shards'] for w in s['per_worker']]}, launches "
              f"{[{k: n for k, n in w['kernel_launches'].items() if n} for w in s['per_worker']]}"
              f"; serial in this run "
              f"{serial_s:.2f} s ({docs / serial_s * 3600:.0f} docs/hour); output "
              f"identical | {smi}")
        stages = ", ".join(f"{n.split('/', 1)[1]} {t:.2f}s"
                           for n, t in sorted(r["stages"].items()))
        print(f"[where] {label} stages (inclusive; count and spill summed over "
              f"the workers' shards): {stages}")
    print(f"[gram] 2h B {gm['shape']} uint8 ({gm['nnz']} ones, built in "
          f"{gm['build_s']:.2f} s), {GRAM_MESH} {GRAM_AXES} {gm['backend']} world of "
          f"{GRAM_MESH[0] * GRAM_MESH[1]} ranks on {gm['cards']} card(s): world {gm['world_s']:.2f} s "
          f"(spawn, both schedules); host gram_reference {gm['host_s']:.2f} s; "
          f"cooc_gram launches in the ranks {gm['launches']['cooc_gram']} | {smi}")
    for sched, t in gm["schedules"].items():
        print(f"[gram] {sched}: {t['wall_s']:.4f} s (slowest rank): products "
              f"{t['product']:.4f} s, collectives {t['collective']:.4f} s, host copies "
              f"{t['host_copy']:.4f} s ({t['host_copies']} copies, "
              f"{t['copied_mb']:.1f} MiB over all ranks); C equal to gram_reference "
              f"and to cooc_gram of B | {smi}")


# --------------------------------------------------------------- phase 2i
class RouterTap:
    """Inside ``with``: records, for every MoE call of the port's
    transformer (one a layer, in layer order), each token's top-k experts
    (as a sorted set) and the gap between its k-th and (k+1)-th router
    probabilities, then runs the call unchanged. A measurement tap: it
    rebinds ``models.transformer.moe_ffn_ep`` for the ``with`` block only."""

    def __init__(self):
        from repro_torch.models import transformer as T

        self.T, self.calls = T, []

    def __enter__(self):
        self.orig = self.T.moe_ffn_ep
        self.T.moe_ffn_ep = self._tap
        return self

    def __exit__(self, *exc):
        self.T.moe_ffn_ep = self.orig

    def _tap(self, params, x, **kw):
        import torch

        k = kw["top_k"]
        probs = torch.softmax((x @ params["router"]).float(), dim=-1)
        top = torch.sort(probs, dim=-1, descending=True, stable=True)
        experts = torch.sort(top.indices[..., :k], dim=-1).values
        gap = top.values[..., k - 1] - top.values[..., k]
        self.calls.append((experts.cpu(), gap.double().cpu()))
        return self.orig(params, x, **kw)

    def routing(self, n_layers: int):
        """(experts (L, B, S, k), gaps (L, B, S)) of a forward (one call a
        layer) or of a run of decode steps (one call a layer a step)."""
        import torch

        steps = len(self.calls) // n_layers
        ex = [torch.cat([self.calls[t * n_layers + l][0] for t in range(steps)], 1)
              for l in range(n_layers)]
        gp = [torch.cat([self.calls[t * n_layers + l][1] for t in range(steps)], 1)
              for l in range(n_layers)]
        return torch.stack(ex), torch.stack(gp)


def near_ties(cfg, tap_a, tap_b, what: str):
    """Where some token's experts differ between runs a and b, each such
    token is printed with its layer and gap, and must be a near-tie: its
    k-th and (k+1)-th router probabilities in some layer of run a differ
    by less than LM_NEAR_TIE. Then the logit gate skips every near-tie
    token: returns a (B, S) bool mask of tokens to keep. With no flip (or
    no MoE) it returns None, and every token is compared."""
    import torch

    if not cfg.moe:
        return None
    ex_a, gap_a = tap_a.routing(cfg.n_layers)
    ex_b, _ = tap_b.routing(cfg.n_layers)
    tie = (gap_a < LM_NEAR_TIE).any(dim=0)
    flips = (ex_a != ex_b).any(dim=-1)  # (L, B, S)
    if not flips.any():
        return None
    for l, b, s in flips.nonzero().tolist():
        print(f"[lm] {cfg.name} {what}: router flip at token ({b}, {s}), layer {l}, "
              f"probability gap {gap_a[l, b, s].item():.3e} (experts "
              f"{ex_a[l, b, s].tolist()} vs {ex_b[l, b, s].tolist()})")
        check(bool(tie[b, s]), f"2i {cfg.name} {what}: a router flip at token "
              f"({b}, {s}), layer {l}, gap {gap_a[l, b, s].item():.3e} >= {LM_NEAR_TIE}")
    return ~tie


def masked_err(a, b, keep) -> float:
    """max |a - b| over the tokens ``keep`` marks (all when None)."""
    if keep is not None:
        a, b = a[keep], b[keep]
    return max_abs_err(a, b)


def lm_card_vs_host(arch: str) -> dict:
    """2i-i: a full-width copy cut to 2 layers, float32, on the card and on
    the host with the same weights; forward logits of 2 x 64 tokens."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_spec
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_spec(arch).model, n_layers=2, dtype="float32")
    card = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    host = T.TransformerLM(cfg, "cpu")
    host.load_state_dict(card.state_dict())
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, LM_HOST_TOKENS).astype(np.int32)
    out = {}
    for name, model, dev in (("card", card, "cuda"), ("host", host, "cpu")):
        with torch.inference_mode(), RouterTap() as tap:
            out[name] = (T.forward(model, torch.from_numpy(tokens).to(dev), cfg)[0].cpu(), tap)
    keep = near_ties(cfg, out["host"][1], out["card"][1], "card vs host")
    err = masked_err(out["card"][0], out["host"][0], keep)
    skipped = 0 if keep is None else int((~keep).sum())
    check(bool(torch.isfinite(out["card"][0]).all()), f"2i {arch}: card logits not finite")
    check(err <= LM_HOST_TOL, f"2i {arch}: card vs host logits differ by {err:.3e} "
          f"> {LM_HOST_TOL}")
    return {"max_abs_err": err, "skipped": skipped}


def serving_cfg(arch: str):
    """The arch's full-width config at 2i's cut depth."""
    import dataclasses

    from repro_torch.configs import get_spec

    cfg = get_spec(arch).model
    return dataclasses.replace(cfg, n_layers=cfg.n_layers // LM_DEPTH_DIV)


def lm_decode_vs_forward(arch: str) -> dict:
    """2i-ii: the reference test ``test_decode_matches_forward`` at full
    width and depth in float32: batch 2, 32 positions decoded one at a
    time against one forward. OLMoE runs at capacity_factor = E / k, as the
    smoke configs do, so that no token drops."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(serving_cfg(arch), dtype="float32")
    if cfg.moe:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    model = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    B, S = LM_DECODE_TOKENS
    tokens = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).cuda()
    with torch.inference_mode():
        with RouterTap() as fwd:
            full, _, _ = T.forward(model, tokens, cfg)
        cache = T.init_cache(cfg, B, S, "cuda")
        steps = []
        with RouterTap() as dec:
            for t in range(S):
                logits, cache = T.decode_step(model, cache, tokens[:, t:t + 1], t, cfg)
                steps.append(logits)
        stepped = torch.stack(steps, dim=1)
    keep = near_ties(cfg, fwd, dec, "decode vs forward")
    err = masked_err(stepped.cpu(), full.cpu(), keep)
    skipped = 0 if keep is None else int((~keep).sum())
    del model, cache
    check(err < LM_DECODE_TOL, f"2i {arch}: decode vs forward differ by {err:.3e} "
          f">= {LM_DECODE_TOL}")
    return {"max_abs_err": err, "skipped": skipped,
            "capacity_factor": cfg.capacity_factor}


def expert_bytes(cfg) -> int:
    """bf16 bytes of one expert's weights in one layer (0 for a dense FFN)."""
    import math

    from repro_torch.models import transformer as T

    if not cfg.moe:
        return 0
    layers = T.param_shapes(cfg)["layers"]
    return sum(math.prod(layers[k][2:]) for k in ("moe_w_in", "moe_w_out", "moe_w_gate")
               if k in layers) * 2


def decode_bounds_ms(cfg, batch: int, prompt_len: int, gen: int,
                     experts_read: list[int] | None = None) -> list[float]:
    """The least time of each decode step: the bytes it must move over
    HBM_BYTES_PER_S. Every weight but the embedding table and the experts
    is read, then the experts: ``experts_read[t]`` (expert, layer) pairs at
    step t, the distinct experts its tokens route to in each layer summed
    over layers. With None every expert of every layer is counted, which is
    what ``moe_ffn`` reads (it runs every expert's matmul). Also the batch's
    embedding rows, the cache up to and including the step's position (the
    new entries written), and the float32 logits written."""
    item = 2  # bf16
    width = (cfg.kv_lora_rank + cfg.qk_rope_dim if cfg.attn == "mla"
             else 2 * cfg.n_kv_heads * cfg.d_head)
    all_experts = cfg.n_layers * cfg.n_experts
    per_expert = expert_bytes(cfg)
    dense = (cfg.num_params() - cfg.vocab_size * cfg.d_model) * item \
        - all_experts * per_expert
    if experts_read is None:
        experts_read = [all_experts] * (gen - 1)
    return [
        (dense + experts_read[t] * per_expert + batch * cfg.d_model * item
         + cfg.n_layers * batch * (prompt_len + t + 1) * width * item
         + batch * cfg.vocab_size * 4) / HBM_BYTES_PER_S * 1e3
        for t in range(gen - 1)
    ]


def routed_experts(cfg, tap) -> list[int] | None:
    """From a RouterTap over one ``serve()`` (a prefill call a layer, then a
    call a layer a decode step): for each decode step, the distinct experts
    its tokens route to in each layer, summed over layers."""
    if not cfg.moe:
        return None
    L = cfg.n_layers
    steps = len(tap.calls) // L - 1
    return [sum(int(tap.calls[L * (t + 1) + l][0].unique().numel()) for l in range(L))
            for t in range(steps)]


def lm_serving(arch: str) -> dict:
    """2i-iii: ``launch.serve.serve`` at full width in the config's own
    dtype (bf16), batch 8, prompt 1,024, 64 generated tokens. One untimed
    ``serve()`` of the same weights and prompts comes first, so that the
    timed run meets no first-use cost (GEMM heuristics, allocator growth);
    a RouterTap over it records the experts each decode step routes to,
    for the bound. Where both runs generate the same tokens (reported as
    ``warm_tokens_equal``), they routed the same way."""
    import torch
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T

    cfg = serving_cfg(arch)
    model = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    kw = dict(batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN, seed=SEED,
              device="cuda", cfg=cfg, params=model)
    with RouterTap() as tap:
        warm, _ = serve(arch, **kw)
    out, st = serve(arch, **kw)
    del model
    check(out.shape == (LM_BATCH, LM_GEN), f"2i {arch}: generated {out.shape}")
    check(st["logits_finite"], f"2i {arch}: a logit of prefill or decode is not finite")
    routed = routed_experts(cfg, tap)
    bounds = decode_bounds_ms(cfg, LM_BATCH, LM_PROMPT, LM_GEN, routed)
    impl = decode_bounds_ms(cfg, LM_BATCH, LM_PROMPT, LM_GEN)
    return {
        "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / st["prefill_s"],
        "decode_tokens_per_s": LM_BATCH * (LM_GEN - 1) / st["decode_s"],
        "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
        "decode_step_ms": st["decode_step_ms"],
        "decode_bound_ms": sum(bounds) / len(bounds),
        "decode_impl_bound_ms": sum(impl) / len(impl),
        "experts_read_per_step": (None if routed is None
                                  else sum(routed) / len(routed)),
        "decode_steps_ms": st["decode_steps_ms"], "decode_bounds_ms": bounds,
        "peak_mem_bytes": st["peak_mem_bytes"],
        "warm_tokens_equal": bool((warm == out).all()),
    }


def lm_decode_device_time(arch: str, steps: int = 4) -> dict:
    """Where a bf16 decode step of 2i-iii's shape goes: ``steps`` steps
    (batch 8, positions from 1,024 of a cache of 1,088) under the profiler,
    after one warm-up step; the device time and the kernels a step, and the
    largest device ops."""
    import torch
    from repro_torch.models import transformer as T
    from torch.profiler import ProfilerActivity, profile

    cfg = serving_cfg(arch)
    model = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    cache = T.init_cache(cfg, LM_BATCH, LM_PROMPT + LM_GEN, "cuda")
    tokens = torch.zeros((LM_BATCH, 1), dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        T.decode_step(model, cache, tokens, LM_PROMPT, cfg)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(steps):
                T.decode_step(model, cache, tokens, LM_PROMPT + i, cfg)
            torch.cuda.synchronize()
    ops, kernels = trace_ops(prof)
    ops = [(name, t / steps * 1e3) for name, t in ops]
    del model, cache
    return {"device_ms": sum(t for _, t in ops), "kernels": kernels / steps,
            "top_ops": ops[:4]}


def lm_path() -> list[dict]:
    """Phase 2i for each model in LM_ARCHS: steps i, ii and iii, in that
    order, each model freed before the next. TF32 is off for i and ii."""
    import gc

    import torch

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    rows = []
    for arch in LM_ARCHS:
        row = {"arch": arch}
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            for step, fn in (("host_check", lm_card_vs_host),
                             ("decode_check", lm_decode_vs_forward)):
                t0 = time.perf_counter()
                row[step] = fn(arch)
                row[step]["s"] = time.perf_counter() - t0
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        row.update(lm_serving(arch))
        gc.collect()
        torch.cuda.empty_cache()
        row["decode_profile"] = lm_decode_device_time(arch)
        gc.collect()
        torch.cuda.empty_cache()
        rows.append(row)
    return rows


def cfg_pairs(arch: str) -> int:
    cfg = serving_cfg(arch)
    return cfg.n_layers * cfg.n_experts


def print_lm(rows, smi) -> None:
    for r in rows:
        hc, dc = r["host_check"], r["decode_check"]
        print(f"[lm] {r['arch']} 2 layers, float32: card vs host forward logits "
              f"max abs {hc['max_abs_err']:.3e} (gate {LM_HOST_TOL}; {hc['skipped']} "
              f"near-tie tokens skipped) in {hc['s']:.1f} s; {serving_cfg(r['arch']).n_layers} "
              f"layers, float32: "
              f"decode vs forward max abs {dc['max_abs_err']:.3e} (gate "
              f"{LM_DECODE_TOL}, capacity_factor {dc['capacity_factor']}; "
              f"{dc['skipped']} skipped) in {dc['s']:.1f} s")
        print(f"[lm] {r['arch']} bf16, {serving_cfg(r['arch']).n_layers} layers (depth cut "
              f"by {LM_DEPTH_DIV}), batch {LM_BATCH}, prompt {LM_PROMPT}, gen "
              f"{LM_GEN}: prefill {r['prefill_s']:.4f} s ({r['prefill_tokens_per_s']:.1f} "
              f"tokens/s), decode {r['decode_tokens_per_s']:.1f} tokens/s, "
              f"{r['decode_step_ms']:.4f} ms a step against a bound of "
              f"{r['decode_bound_ms']:.4f} ms by bytes "
              f"({r['decode_bound_ms'] / r['decode_step_ms']:.1%} of bound"
              + ("" if r["experts_read_per_step"] is None else
                 f"; {r['experts_read_per_step']:.2f} (expert, layer) pairs routed a "
                 f"step of {cfg_pairs(r['arch'])}; {r['decode_impl_bound_ms']:.4f} ms if "
                 "every expert is read, as moe_ffn does")
              + f", after an untimed warm-up serve; warm-up tokens equal: "
              f"{r['warm_tokens_equal']}); peak "
              f"memory {r['peak_mem_bytes'] / 2**30:.2f} GiB | {smi}")
        dp = r["decode_profile"]
        print(f"[where] {r['arch']} decode step under the profiler: device "
              f"{dp['device_ms']:.4f} ms a step, {dp['kernels']:.0f} kernels a step "
              f"({dp['device_ms'] / r['decode_step_ms']:.1%} of the step's "
              f"{r['decode_step_ms']:.4f} ms in 2i-iii); top device ops: "
              + "; ".join(f"{n[:48]} {t:.4f} ms" for n, t in dp["top_ops"]) + f" | {smi}")
        print(f"[lm] {r['arch']} each decode step, ms (CUDA events) / bound ms: "
              + ", ".join(f"{t:.3f}/{b:.4f}" for t, b in
                          zip(r["decode_steps_ms"], r["decode_bounds_ms"])))
    print(json.dumps({"lm": [dict(r, device=smi) for r in rows]}))


# --------------------------------------------------------------- phase 2j
def event_ms(fn, verify) -> dict:
    """``fn()`` timed call by call by CUDA events after one warm-up call:
    the median, least and most ms of TIMED_CALLS calls, and the peak device
    memory of one call. ``verify`` is applied to the warm-up's output,
    which is dropped before the timed calls."""
    import torch

    torch.cuda.synchronize()
    out = fn()
    verify(out)
    del out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = []
    for _ in range(TIMED_CALLS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    ms = sorted(s.elapsed_time(e) for s, e in marks)
    return {"ms": ms[len(ms) // 2], "min_ms": ms[0], "max_ms": ms[-1],
            "peak_bytes": torch.cuda.max_memory_allocated()}


def profiled(t: dict, fn) -> dict:
    """Add to a timed case the device time a call under the profiler
    (PROFILED_CALLS calls) and its three largest device ops, ms a call."""
    def run():
        for _ in range(PROFILED_CALLS):
            fn()  # each output dropped before the next call, as in event_ms

    _, dev_s, ops_ = device_busy(run)
    t["device_ms"] = dev_s / PROFILED_CALLS * 1e3
    t["top_ops"] = [(name[:48], s / PROFILED_CALLS * 1e3) for name, s in ops_[:3]]
    return t


def matmul_flops(fn) -> int:
    """The matrix-product FLOPs of one ``fn()`` call (matmuls, einsums,
    attention products), counted by ``torch.utils.flop_counter`` on this
    call's shapes; elementwise work, gathers and scatters are not counted."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def on_card(a):
    import numpy as np
    import torch

    return torch.from_numpy(np.ascontiguousarray(a)).cuda()


def check_pair(model):
    """A card copy of a GraphSAGE or Ranker with N(0, CHECK_NOISE^2) added
    to every leaf (from a generator seeded with SEED), and its host copy
    from the card's state_dict: the weights the 2j-i checks compare at.
    ``model`` itself is left as it is, for the timed cells."""
    import torch

    card = type(model)(model.cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.no_grad():
        for p, q in zip(card.parameters(), model.parameters()):
            p.copy_(q + CHECK_NOISE * torch.randn(q.shape, generator=gen, device="cuda"))
    host = type(model)(model.cfg, "cpu")
    host.load_state_dict(card.state_dict())
    return card, host


def card_vs_host(what: str, card, host, run, shape: tuple) -> dict:
    """``run(model, device)`` on the card and on the host: the card's
    output must be finite, of ``shape``, and within GNN_RECSYS_TOL of the
    host's (max abs), and the host's must reach CHECK_SCALE times that."""
    import torch

    with torch.inference_mode():
        got = run(card, "cuda").cpu()
        want = run(host, "cpu")
    finite_of_shape(what, shape)(got)
    err, scale = max_abs_err(got, want), float(want.abs().max())
    check(scale >= CHECK_SCALE * GNN_RECSYS_TOL, f"2j {what}: host outputs reach only "
          f"{scale:.3e}, under {CHECK_SCALE} times the gate {GNN_RECSYS_TOL}")
    check(err <= GNN_RECSYS_TOL, f"2j {what}: card vs host max abs {err:.3e} > "
          f"{GNN_RECSYS_TOL}")
    return {"what": what, "max_abs_err": err, "max_abs": scale}


def finite_of_shape(what: str, shape: tuple):
    """A check for event_ms: the output is finite and of ``shape``."""
    import torch

    def _check(out):
        check(tuple(out.shape) == shape, f"2j {what}: shape {tuple(out.shape)} != {shape}")
        check(bool(torch.isfinite(out).all()), f"2j {what}: output not finite")
    return _check


def edge_index_of(g):
    """(2, E) int32 (src, dst) of a CSRGraph, its edges grouped by dst."""
    import numpy as np

    dst = np.repeat(np.arange(g.num_nodes, dtype=np.int32), np.diff(g.indptr))
    return np.stack([g.indices, dst])


def gnn_model(shape: str):
    """GraphSAGE-Reddit's widths at one of its shape cells (d_feat and
    n_classes from the cell), random weights drawn on the card."""
    import dataclasses

    import torch
    from repro_torch.configs import get_spec
    from repro_torch.models import gnn

    spec = get_spec(GNN_ARCH)
    sz = spec.shapes[shape].sizes
    cfg = dataclasses.replace(spec.model, d_in=sz["d_feat"], n_classes=sz["n_classes"])
    model = gnn.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    return cfg, sz, model


def gnn_case(what: str, fn, shape: tuple, input_bytes: int, params) -> dict:
    """Time ``fn`` (a forward) and bound it: bytes are its inputs, the
    parameters and the float32 output; FLOPs its matrix products."""
    import numpy as np

    t = event_ms(fn, finite_of_shape(what, shape))
    moved = input_bytes + nbytes(*params.parameters()) + 4 * int(np.prod(shape))
    t["bound_ms"], t["bound_by"] = bound(moved, matmul_flops(fn), F32_FLOPS_PER_S)
    t["what"] = what
    return profiled(t, fn)


def gnn_path() -> dict:
    """2j for GraphSAGE: i. card against host on full_graph_sm,
    minibatch_lg (one batch) and molecule; ii. the timed cells."""
    import numpy as np
    import torch
    from repro_torch.data.sampler import random_graph, random_graph_on_device, sample_blocks
    from repro_torch.models import gnn

    out = {"checks": [], "cases": []}
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    # full_graph_sm: a Cora-sized graph at its feature width
    cfg, sz, card = gnn_model("full_graph_sm")
    g = random_graph(sz["n_nodes"], 4, seed=SEED)
    ei, feats = edge_index_of(g), rng.standard_normal((g.num_nodes, cfg.d_in), np.float32)
    out["checks"].append(card_vs_host(
        "full_graph_sm forward_full_graph", *check_pair(card),
        lambda m, dev: gnn.forward_full_graph(
            m, torch.from_numpy(feats).to(dev), torch.from_numpy(ei).to(dev), cfg),
        (g.num_nodes, cfg.n_classes)))

    # molecule: 128 graphs of 30 nodes and 64 edges as one disjoint graph
    cfg, sz, card = gnn_model("molecule")
    n_g, nodes, edges = sz["batch"], sz["n_nodes"], sz["n_edges"]
    mol_feats = torch.randn((n_g * nodes, cfg.d_in), generator=gen, device="cuda")
    base = np.repeat(np.arange(n_g) * nodes, edges)
    mol_ei = on_card((rng.integers(0, nodes, (2, n_g * edges)) + base).astype(np.int32))
    gid = on_card(np.repeat(np.arange(n_g), nodes).astype(np.int32))

    def molecule(m, dev):
        return gnn.forward_batched_graphs(m, mol_feats.to(dev), mol_ei.to(dev),
                                          gid.to(dev), cfg, n_g)

    out["checks"].append(card_vs_host("molecule forward_batched_graphs", *check_pair(card),
                                      molecule, (n_g, cfg.n_classes)))
    with torch.inference_mode():
        out["cases"].append(gnn_case(
            "molecule forward_batched_graphs", lambda: molecule(card, "cuda"),
            (n_g, cfg.n_classes), nbytes(mol_feats, mol_ei, gid), card))

    # minibatch_lg: Reddit's node count and mean degree, features on the card
    cfg, sz, card = gnn_model("minibatch_lg")
    t0 = time.perf_counter()
    g = random_graph_on_device(sz["n_nodes"], REDDIT_DEGREE, seed=SEED)
    out["reddit"] = {"nodes": g.num_nodes, "edges": g.num_edges, "shape_edges": sz["n_edges"],
                     "graph_s": time.perf_counter() - t0}
    feats = torch.randn((g.num_nodes, cfg.d_in), generator=gen, device="cuda")
    fanout, B = tuple(sz["fanout"]), sz["batch_nodes"]

    def gather(blocks):
        return [feats[on_card(b).long()] for b in blocks]

    def sampled(m, dev, hops):
        return gnn.forward_sampled(m, *(h.to(dev) for h in hops), cfg)

    hops = gather(sample_blocks(g, rng.choice(g.num_nodes, B, replace=False), fanout, rng))
    out["checks"].append(card_vs_host("minibatch_lg forward_sampled", *check_pair(card),
                                      lambda m, dev: sampled(m, dev, hops), (B, cfg.n_classes)))
    with torch.inference_mode():
        fwd = gnn_case("minibatch_lg forward_sampled (one batch)",
                       lambda: sampled(card, "cuda", hops), (B, cfg.n_classes),
                       nbytes(*hops), card)
        del hops
        sample_ms, gather_ms, forward_ms = [], [], []
        torch.cuda.synchronize()
        t_all = time.perf_counter()
        for _ in range(MINIBATCHES):
            t0 = time.perf_counter()
            blocks = sample_blocks(g, rng.choice(g.num_nodes, B, replace=False), fanout, rng)
            sample_ms.append((time.perf_counter() - t0) * 1e3)
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            marks[0].record()
            hops = gather(blocks)
            marks[1].record()
            logits = sampled(card, "cuda", hops)
            marks[2].record()
            torch.cuda.synchronize()
            gather_ms.append(marks[0].elapsed_time(marks[1]))
            forward_ms.append(marks[1].elapsed_time(marks[2]))
            check(bool(torch.isfinite(logits).all()), "2j minibatch_lg: logits not finite")
        wall = time.perf_counter() - t_all
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    fwd.update(batches=MINIBATCHES, sample_ms=med(sample_ms), gather_ms=med(gather_ms),
               batch_forward_ms=med(forward_ms), seeds_per_s=MINIBATCHES * B / wall,
               seeds=B, fanout=fanout)
    out["cases"].append(fwd)
    del g, feats, hops, logits

    # ogb_products: the full-graph forward at its node count and features
    cfg, sz, card = gnn_model("ogb_products")
    t0 = time.perf_counter()
    g = random_graph_on_device(sz["n_nodes"], PRODUCTS_DEGREE, seed=SEED)
    ei = on_card(edge_index_of(g))
    out["products"] = {"nodes": g.num_nodes, "edges": g.num_edges,
                       "shape_edges": sz["n_edges"], "graph_s": time.perf_counter() - t0}
    del g
    feats = torch.randn((sz["n_nodes"], cfg.d_in), generator=gen, device="cuda")
    with torch.inference_mode():
        out["cases"].append(gnn_case(
            "ogb_products forward_full_graph",
            lambda: gnn.forward_full_graph(card, feats, ei, cfg),
            (sz["n_nodes"], cfg.n_classes), nbytes(feats, ei), card))
    return out


def ranker_batch(kind: str, cfg, B: int, rng) -> dict:
    """A batch of ``kind``'s inputs on the card, ids drawn uniformly over
    each table: DIEN histories right-padded (-1) to a length of at least
    half the sequence, BERT4Rec sequences with their masked positions set
    to [MASK], xDeepFM bags padded from a random length of at least 1."""
    import numpy as np

    i32 = lambda a: on_card(np.asarray(a, np.int32))  # noqa: E731
    if kind in ("dien", "bst"):
        T = cfg.seq_len
        items = rng.integers(0, cfg.n_items, (B, T))
        b = {"target_item": i32(rng.integers(0, cfg.n_items, B))}
        if kind == "dien":
            pad = np.arange(T) >= rng.integers(T // 2, T + 1, B)[:, None]
            cats = rng.integers(0, cfg.n_cats, (B, T))
            items[pad] = cats[pad] = -1
            b.update(hist_cats=i32(cats), target_cat=i32(rng.integers(0, cfg.n_cats, B)))
        return dict(b, hist_items=i32(items))
    if kind == "bert4rec":
        S, M = cfg.seq_len, cfg.n_masked
        items = rng.integers(0, cfg.n_items, (B, S))
        positions = np.argsort(rng.random((B, S)), axis=1)[:, :M]
        items[np.arange(B)[:, None], positions] = cfg.n_items
        return {"items": i32(items), "positions": i32(positions)}
    n_single = cfg.n_fields - cfg.n_multi_hot
    vocabs = np.asarray(cfg.field_vocabs)
    multi = rng.integers(0, vocabs[n_single:, None], (B, cfg.n_multi_hot, cfg.max_bag))
    multi[np.arange(cfg.max_bag) >= rng.integers(1, cfg.max_bag + 1,
                                                 (B, cfg.n_multi_hot))[..., None]] = -1
    return {"single_ids": i32(rng.integers(0, vocabs[:n_single], (B, n_single))),
            "multi_ids": i32(multi)}


def table_bytes(kind: str, cfg, model, batch, cands=None) -> int:
    """The bytes of embedding rows a call must read: each distinct id's
    row once (xDeepFM: its embedding and linear rows at the field
    offsets), or for BERT4Rec's logits the whole table (the output head);
    with ``cands``, the candidates' rows as well."""
    import torch

    def rows(ids, row_bytes):
        ids = torch.cat([i.reshape(-1) for i in ids])
        return int(torch.unique(ids[ids >= 0]).numel()) * row_bytes

    item_row = 4 * cfg.embed_dim
    if kind == "xdeepfm":
        from repro_torch.models.recsys import _xdeepfm_field_offsets

        offs = on_card(_xdeepfm_field_offsets(cfg))
        n_single = cfg.n_fields - cfg.n_multi_hot
        m = batch["multi_ids"]
        ids = [batch["single_ids"] + offs[:n_single],
               torch.where(m >= 0, m + offs[n_single:, None], -1)]
        if cands is not None:
            ids.append(cands)
        return rows(ids, 4 * (cfg.embed_dim + 1))
    if kind == "bert4rec":
        table = nbytes(model["item_embed"])
        return table if cands is None else table + rows([cands], item_row)
    ids = [batch["hist_items"]] + ([batch["target_item"]] if cands is None else [cands])
    out = rows(ids, item_row)
    if kind == "dien":
        cats = [batch["hist_cats"]] + ([batch["target_cat"]] if cands is None else [])
        out += rows(cats, item_row)
    return out


def ranker_forward(kind: str):
    from repro_torch.models import recsys

    if kind == "bert4rec":
        return lambda m, b, cfg: recsys.bert4rec_logits(m, b["items"], b["positions"], cfg)
    return recsys.FORWARD_FNS[kind]


def ranker_case(kind, cfg, model, what: str, fn, shape: tuple, batch, cands=None) -> dict:
    """Time ``fn`` and bound it: bytes are the embedding rows it must read
    (``table_bytes``), its ids and its float32 output (the dense weights,
    under 6 MB a model, are left out); FLOPs its matrix products."""
    import numpy as np

    t = event_ms(fn, finite_of_shape(f"{cfg.name} {what}", shape))
    ids = nbytes(*batch.values()) + (0 if cands is None else nbytes(cands))
    moved = table_bytes(kind, cfg, model, batch, cands) + ids + 4 * int(np.prod(shape))
    t["bound_ms"], t["bound_by"] = bound(moved, matmul_flops(fn), F32_FLOPS_PER_S)
    t["what"], t["batch"] = what, shape[0]
    return profiled(t, fn)


def ranker_path(kind: str) -> dict:
    """2j for one ranker at full width: i. its forward at batch 64 and
    retrieval over 4,096 candidates, card against host; ii. serve_p99,
    serve_bulk (cut where BULK_BATCH says) and retrieval_cand (cut where
    RETRIEVAL_CANDIDATES says), timed."""
    import numpy as np
    import torch
    from repro_torch.configs import get_spec
    from repro_torch.models import recsys

    spec = get_spec(kind)
    cfg = spec.model
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    model = recsys.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    row = {"arch": kind, "params": sum(p.numel() for p in model.parameters()),
           "init_s": time.perf_counter() - t0, "checks": [], "cases": []}
    forward = ranker_forward(kind)
    out_shape = ((lambda B: (B, cfg.n_masked, cfg.n_items)) if kind == "bert4rec"
                 else (lambda B: (B,)))
    rows = cfg.field_vocabs[0] if kind == "xdeepfm" else cfg.n_items

    def to(b, dev):
        return {k: v.to(dev) for k, v in b.items()}

    chk, host = check_pair(model)
    b = ranker_batch(kind, cfg, CHECK_BATCH, rng)
    ctx = {k: v[:1] for k, v in b.items()}
    cands = on_card(rng.integers(0, rows, CHECK_CANDIDATES).astype(np.int32))
    row["checks"].append(card_vs_host(
        f"{kind} forward", chk, host, lambda m, dev: forward(m, to(b, dev), cfg),
        out_shape(CHECK_BATCH)))
    row["checks"].append(card_vs_host(
        f"{kind} retrieval_scores", chk, host,
        lambda m, dev: recsys.retrieval_scores(m, to(ctx, dev), cands.to(dev), cfg),
        (CHECK_CANDIDATES,)))
    del chk, host
    gc_card()

    with torch.inference_mode():
        for cell, B in (("serve_p99", spec.shapes["serve_p99"].sizes["batch"]),
                        ("serve_bulk", BULK_BATCH[kind])):
            b = ranker_batch(kind, cfg, B, rng)
            t = ranker_case(kind, cfg, model, cell, lambda: forward(model, b, cfg),
                            out_shape(B), b)
            t["shape_batch"] = spec.shapes[cell].sizes["batch"]
            row["cases"].append(t)
            del b
            gc_card()
        C = RETRIEVAL_CANDIDATES[kind]
        ctx = ranker_batch(kind, cfg, 1, rng)
        cands = on_card(rng.integers(0, rows, C).astype(np.int32))
        t = ranker_case(kind, cfg, model, "retrieval_cand",
                        lambda: recsys.retrieval_scores(model, ctx, cands, cfg), (C,),
                        ctx, cands)
        t["shape_batch"] = spec.shapes["retrieval_cand"].sizes["n_candidates"]
        row["cases"].append(t)
    del model
    gc_card()
    return row


def gc_card() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def gnn_recsys_path() -> dict:
    """Phase 2j: GraphSAGE, then each ranker (each freed before the next),
    float32 with TF32 off throughout."""
    import torch

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out = {"gnn": gnn_path()}
        gc_card()
        out["recsys"] = [ranker_path(kind) for kind in RANKERS]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return out


def show_case(t: dict) -> str:
    return (f"{t['ms']:.4f} ms (median of {TIMED_CALLS}, {t['min_ms']:.4f}-"
            f"{t['max_ms']:.4f}) against a bound of {t['bound_ms']:.4f} ms by "
            f"{t['bound_by']} ({t['bound_ms'] / t['ms']:.1%} of bound), peak "
            f"{t['peak_bytes'] / 2**30:.2f} GiB; device {t['device_ms']:.4f} ms a "
            f"call under the profiler ({t['device_ms'] / t['ms']:.1%} busy), top: "
            + "; ".join(f"{n} {ms:.4f}" for n, ms in t["top_ops"]))


def print_gnn_recsys(gr: dict, smi: str) -> None:
    gn = gr["gnn"]
    for c in gn["checks"] + [c for r in gr["recsys"] for c in r["checks"]]:
        print(f"[gnn/recsys] 2j-i {c['what']}: card vs host max abs "
              f"{c['max_abs_err']:.3e} (gate {GNN_RECSYS_TOL}; host outputs up to "
              f"{c['max_abs']:.3e})")
    for name, gph in (("minibatch_lg", gn["reddit"]), ("ogb_products", gn["products"])):
        cut = gph["edges"] / gph["shape_edges"] - 1
        print(f"[gnn] {name} graph: random_graph of {gph['nodes']:,} nodes, "
              f"{gph['edges']:,} edges against the cell's {gph['shape_edges']:,} "
              f"({cut:+.2%}{', a cut' if cut < 0 else ''}), built in {gph['graph_s']:.2f} s "
              "(draws on the host, search and sort on the card)")
    for t in gn["cases"]:
        extra = ""
        if "seeds_per_s" in t:
            extra = (f"; {t['batches']} batches of {t['seeds']:,} seeds, fanout {t['fanout']}: "
                     f"sampler {t['sample_ms']:.3f} ms (host), ids to the card and feature gather "
                     f"{t['gather_ms']:.4f} ms, forward {t['batch_forward_ms']:.4f} ms a "
                     f"batch (medians, CUDA events), {t['seeds_per_s']:,.0f} seeds/s")
        print(f"[gnn] {t['what']}: {show_case(t)}{extra} | {smi}")
    for r in gr["recsys"]:
        print(f"[recsys] {r['arch']}: {r['params']:,} parameters "
              f"({r['params'] * 4 / 2**30:.2f} GiB float32) drawn on the card in "
              f"{r['init_s']:.2f} s")
        for t in r["cases"]:
            n = t["batch"]
            cut = "" if n == t["shape_batch"] else f", cut from {t['shape_batch']:,}"
            unit = "candidates" if t["what"] == "retrieval_cand" else "examples"
            print(f"[recsys] {r['arch']} {t['what']} ({n:,} {unit}{cut}): "
                  f"{show_case(t)}; {n / t['ms'] * 1e3:,.0f} {unit}/s | {smi}")
    print(json.dumps({"gnn_recsys": dict(gr, device=smi)}))


# --------------------------------------------------------------- phase 2l
def start_dryrun() -> list:
    """2l-i: ``python -m repro_torch.launch.dryrun`` on the single mesh, a
    process a cell, started on the host (no card visible to them) to run
    beside the card's work."""
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    procs = []
    for arch, shape in DRYRUN_CELLS:
        out = os.path.join(WORK, f"dryrun_{shape}.jsonl")
        procs.append((arch, shape, out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
             "--shape", shape, "--mesh", "single", "--out", out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    return procs


def finish_dryrun(procs) -> list[dict]:
    """Each dry-run process's record; every cell must be ok."""
    recs = []
    for arch, shape, out, p in procs:
        _, err = p.communicate(timeout=DRYRUN_TIMEOUT_S)
        check(p.returncode == 0, f"2l dry run of {arch}/{shape} failed: {err[-1500:]}")
        with open(out) as f:
            rec = json.loads(f.read().splitlines()[-1])
        check(rec.get("ok") is True, f"2l dry run of {arch}/{shape}: {rec.get('error')}")
        recs.append(rec)
    return recs


def cooc_shares(kernels) -> dict:
    """2l-ii: one rank's share of each co-occurrence cell on the card,
    each held with ``torch.equal`` against its plain version and timed by
    CUDA events beside its own bound and one library call of the same
    function (``torch.bincount``, ``torch._int_mm``), whose output must
    equal the kernel's."""
    import torch
    from repro_torch.configs import get_spec
    from repro_torch.kernels import ops, ref

    shapes = get_spec("cooc-wt10g").shapes
    g = torch.Generator(device="cuda").manual_seed(SEED)
    # tail_hist: this rank's postings, rows sorted as LIST-SCAN emits them
    hs = shapes["tail_hist"].sizes
    L, rows, V = hs["postings_chunk"] // COOC_DP, hs["rows"], hs["vocab_tile"]
    seg = torch.sort(torch.randint(0, rows, (L,), generator=g, device="cuda",
                                   dtype=torch.int32)).values
    ids = torch.randint(0, V, (L,), generator=g, device="cuda", dtype=torch.int32)
    # head_gram: this rank's (doc_chunk / dp, head / model) block and the
    # column block of every rank of its ring
    gs = shapes["head_gram"].sizes
    D, M = gs["doc_chunk"] // COOC_DP, gs["head"] // COOC_MODEL
    blocks = [(torch.rand((D, M), generator=g, device="cuda") < GRAM_DENSITY).to(torch.uint8)
              for _ in range(COOC_MODEL)]
    mine = blocks[0]

    def hist():
        return ops.segment_hist(ids, seg, num_rows=rows, vocab=V)

    def gram():
        return [ops.cooc_gram(mine, b) for b in blocks]

    reset(kernels)
    h, products = hist(), gram()
    torch.cuda.synchronize()
    launches = launched(kernels, ("segment_hist", "cooc_gram"), "2l cooc cells")
    check(torch.equal(h, ref.segment_hist_ref(ids, seg, rows, V)),
          "2l: segment_hist differs from its plain version on the tail_hist share")
    check(int(h.sum()) == L, "2l: the tail_hist share lost postings")
    check(torch.equal(products[1], ref.cooc_gram_ref(mine, blocks[1])),
          "2l: cooc_gram differs from its plain version on the head_gram share")
    # the yardsticks' inputs, laid out before the timed calls
    valid = (seg >= 0) & (ids >= 0)
    keys = seg[valid].to(torch.int64) * V + ids[valid].to(torch.int64)
    mine8, blocks8 = int_mm_operands(mine, *blocks)

    def bincount():
        return torch.bincount(keys, minlength=rows * V)

    def int_mm():
        return [torch._int_mm(mine8, b) for b in blocks8]

    check(torch.equal(bincount().view(rows, V), h.to(torch.int64)),
          "2l: torch.bincount differs from segment_hist on the tail_hist share")
    check(all(torch.equal(a, b) for a, b in zip(int_mm(), products)),
          "2l: torch._int_mm differs from cooc_gram on the head_gram share")
    del products
    out = {"launches": launches, "L": L, "grid": (rows, V), "gram": (D, M, M, COOC_MODEL)}
    out["hist_ms"] = cuda_ms(hist, 10)
    out["hist_plain_ms"] = cuda_ms(lambda: ref.segment_hist_ref(ids, seg, rows, V), 3)
    out["hist_library_ms"] = cuda_ms(bincount, 10)
    out["gram_ms"] = cuda_ms(gram, 3)
    out["gram_library_ms"] = cuda_ms(int_mm, 3)
    # bounds: postings read and the grid written; the 16 products' int8
    # operations (the bytes, 16 blocks in and 16 int32 strips out, weigh less)
    out["hist_bound_ms"] = (2 * L * 4 + rows * V * 4) / HBM_BYTES_PER_S * 1e3
    out["gram_bound_ms"] = max(2.0 * D * M * M * COOC_MODEL / INT8_OPS_PER_S,
                               COOC_MODEL * (D * M + M * M * 4) / HBM_BYTES_PER_S) * 1e3
    return out


def moe_layer():
    """OLMoE-1B-7B's MoE layer at full width, float32, random (He) weights
    and tokens drawn on the card from the seed: (params, x) on the card."""
    import torch
    from repro_torch.configs import get_spec

    cfg = get_spec("olmoe-1b-7b").model
    E, d, f = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def normal(shape, fan_in):
        return torch.randn(shape, generator=g, device="cuda") * (2.0 / fan_in) ** 0.5

    p = {"router": normal((d, E), d), "w_in": normal((E, d, f), d),
         "w_gate": normal((E, d, f), d), "w_out": normal((E, f, d), f)}
    return cfg, p, torch.randn(EP_TOKENS + (d,), generator=g, device="cuda")


def start_host_ep(cfg, pn: dict, xn) -> tuple:
    """2l-iii's host world, in a thread: it runs while the card works.
    ``run`` put ``src`` on ``PYTHONPATH`` for good, so this thread's spawns
    and the main thread's do not race on the environment
    ``spawn_friendly_env`` patches."""
    import threading

    from repro_torch.launch.moe_ep import moe_ep_on_world

    host = {}

    def on_host():
        try:
            host.update(moe_ep_on_world(pn, xn, EP_MESH, top_k=cfg.top_k, grads=False,
                                        capacity_factor=cfg.capacity_factor, device="cpu"))
        except Exception as e:  # reported by the check in moe_ep_card_vs_host
            host["error"] = f"{type(e).__name__}: {e}"

    th = threading.Thread(target=on_host)
    th.start()
    return th, host


def moe_ep_card_vs_host(cfg, p, x, pn, xn, th, host) -> dict:
    """2l-iii: the MoE layer expert-parallel on a (2, 2) gloo world whose
    ranks share the card (at the config's capacity factor, then without
    drops), against the same world on the host, and without drops against
    ``moe_ffn`` on the card."""
    import numpy as np
    import torch
    from repro_torch.launch.moe_ep import moe_ep_on_world
    from repro_torch.models.layers import moe_ffn

    E, k = cfg.n_experts, cfg.top_k
    no_drop = E / k  # every token fits even if all choose one expert
    card, card_nd = moe_ep_on_world(pn, xn, EP_MESH, top_k=k, grads=False,
                                    capacity_factor=(cfg.capacity_factor, no_drop))
    with torch.inference_mode():
        want, _ = moe_ffn(p, x, n_experts=E, top_k=k, capacity_factor=no_drop)
    want = want.cpu().numpy()
    th.join(timeout=EP_TIMEOUT_S)
    check(not th.is_alive() and "y" in host,
          f"2l: the host's expert-parallel world failed: {host.get('error', 'timed out')}")
    scale = float(np.abs(host["y"]).max())
    err = float(np.abs(card["y"] - host["y"]).max())
    err_nd = float(np.abs(card_nd["y"] - want).max())
    scale_nd = float(np.abs(want).max())
    check(bool(np.isfinite(card["y"]).all()), "2l: expert-parallel output not finite")
    check(err <= EP_TOL * scale, f"2l: expert-parallel card vs host {err:.3e} > "
          f"{EP_TOL} x {scale:.3e}")
    check(err_nd <= EP_TOL * scale_nd, f"2l: expert-parallel without drops vs moe_ffn "
          f"{err_nd:.3e} > {EP_TOL} x {scale_nd:.3e}")
    return {"err": err, "scale": scale, "err_nd": err_nd, "scale_nd": scale_nd,
            "no_drop_cf": no_drop, "card_rank_s": card["wall_s"],
            "card_nd_rank_s": card_nd["wall_s"], "host_rank_s": host["wall_s"]}


def sharding_path(kernels) -> dict:
    """Phase 2l: the dry run on the card's host (three processes) and the
    expert-parallel host world (a thread) run while the card takes one
    rank's share of each co-occurrence cell and runs its own
    expert-parallel world."""
    procs = start_dryrun()
    try:
        cfg, p, x = moe_layer()
        pn = {n: t.cpu().numpy() for n, t in p.items()}
        xn = x.cpu().numpy()
        th, host = start_host_ep(cfg, pn, xn)
        shares = cooc_shares(kernels)
        ep = moe_ep_card_vs_host(cfg, p, x, pn, xn, th, host)
        recs = finish_dryrun(procs)
        shares["dryrun"] = {r["shape"]: r["roofline"] for r in recs}
        # the dry run's per-rank Gram is the share the card just ran: the
        # same int8 operations at the same peak
        D, M, _, n = shares["gram"]
        want = 2.0 * D * M * M * n / INT8_OPS_PER_S
        got = shares["dryrun"]["head_gram"]["t_compute_s"]
        check(abs(got - want) <= 1e-9 * want,
              f"2l: the dry run's head_gram t_compute {got:.6g} s is not its share's "
              f"{want:.6g} s (int8 operations over {INT8_OPS_PER_S:g}/s)")
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {"dryrun": recs, "shares": shares, "ep": ep}


def print_sharding(sp: dict, smi: str) -> None:
    for r in sp["dryrun"]:
        rl = r["roofline"]
        print(f"[dryrun] {r['arch']}/{r['shape']} mesh={r['mesh']} per rank: t_compute "
              f"{rl['t_compute_s']:.6g} s, t_memory_fused {rl['t_memory_fused_s']:.6g} s, "
              f"t_collective {rl['t_collective_s']:.6g} s, bottleneck {rl['bottleneck']}, "
              f"fits_80gb {r['analytic']['fits_80gb']} (build {r['lower_s']} s, trace "
              f"{r['compile_s']} s on the host)")
    sh = sp["shares"]
    dr = sh["dryrun"]
    print(f"[sharding] tail_hist share: segment_hist of {sh['L']} postings into "
          f"{sh['grid']} {sh['hist_ms']:.4f} ms (plain {sh['hist_plain_ms']:.4f} ms, "
          f"torch.bincount {sh['hist_library_ms']:.4f} ms, equal; bound "
          f"{sh['hist_bound_ms']:.4f} ms by bytes); the dry run's per-rank t_memory "
          f"{dr['tail_hist']['t_memory_s'] * 1e3:.4f} ms, t_collective "
          f"{dr['tail_hist']['t_collective_s'] * 1e3:.4f} ms | {smi}")
    D, M, N, n = sh["gram"]
    print(f"[sharding] head_gram share: {n} cooc_gram products of ({D}, {M}) x ({D}, {N}) "
          f"uint8 {sh['gram_ms']:.4f} ms (torch._int_mm on the blocks as int8, B "
          f"column-major, {sh['gram_library_ms']:.4f} ms, equal; bound "
          f"{sh['gram_bound_ms']:.4f} ms by int8 operations); the dry run's per-rank "
          f"t_compute {dr['head_gram']['t_compute_s'] * 1e3:.4f} ms at the int8 peak, "
          f"t_collective "
          f"{dr['head_gram']['t_collective_s'] * 1e3:.4f} ms | {smi}")
    ep = sp["ep"]
    print(f"[sharding] moe_ffn_ep OLMoE-1B-7B layer on {EP_MESH} ranks sharing the card, "
          f"{EP_TOKENS[0]} x {EP_TOKENS[1]} tokens, float32: card vs host max abs "
          f"{ep['err']:.3e} (output max {ep['scale']:.3e}); capacity factor "
          f"{ep['no_drop_cf']:g} (no drops) vs moe_ffn {ep['err_nd']:.3e}; a card rank's "
          f"call {max(ep['card_rank_s']):.3f} s ({max(ep['card_nd_rank_s']):.3f} s without "
          f"drops), a host rank's {max(ep['host_rank_s']):.3f} s | {smi}")
    print(f"[launches] cooc cells (one rank's share): {json.dumps(sh['launches'])}")


# --------------------------------------------------------------- phase 2k
def tree_leaves(tree) -> list:
    """``(name, tensor)`` of every leaf of a checkpoint tree, in the
    reference's order (a ``Stacked`` leaf's slices one by one)."""
    from repro_torch.checkpoint import flatten

    out = []
    for name, leaf in flatten(tree):
        out += ([(f"{name}[{i}]", t) for i, t in enumerate(leaf)]
                if isinstance(leaf, list) else [(name, leaf)])
    return out


def train_leaves(state) -> list:
    """``tree_leaves`` of a training state ``(model, opt_state)`` in the
    reference's layout."""
    from repro_torch.convert import train_state_tree

    return tree_leaves(train_state_tree(*state))


def compare_states(card, host, what: str, tol: float) -> dict:
    """max |card - host| over every parameter and optimizer-state leaf
    (the step counter must agree exactly), and the host's largest entry of
    a moment (``mu``, ``m``), for the scale of the check."""
    a, b = train_leaves(card), train_leaves(host)
    check([n for n, _ in a] == [n for n, _ in b], f"2k {what}: state trees differ")
    err, worst, scale = 0.0, "", 0.0
    for (name, x), (_, y) in zip(a, b):
        # on the card: a float32 difference is exact enough for these gates
        e = float((x.detach().float() - y.detach().to(x.device).float()).abs().max())
        if e > err:
            err, worst = e, name
        if name.startswith(("1/m/", "1/mu/")):
            scale = max(scale, float(y.detach().abs().max()))
    check(err <= tol, f"2k {what}: card vs host state differs by {err:.3e} at {worst} > {tol}")
    return {"max_abs_err": err, "worst_leaf": worst, "moment_scale": scale}


def grad_tap(opt):
    """``(optimizer, grads)``: ``opt`` with an ``update`` that first keeps
    a copy of the clipped gradients it is given in ``grads`` (a stacked
    leaf as its per-layer slices), then updates as ``opt`` does. A
    measurement tap: the step is unchanged."""
    import dataclasses

    grads = {}

    def update(g, state, params):
        grads.update({k: [t.detach().clone() for t in v] if isinstance(v, list)
                      else v.detach().clone() for k, v in g.items()})
        return opt.update(g, state, params)

    return dataclasses.replace(opt, update=update), grads


def compare_grads(card: dict, host: dict, what: str, tol: float) -> dict:
    """Every gradient leaf (a stacked leaf slice by slice) of the card
    against the host's, relative to that leaf's largest host entry:
    max |card - host| <= tol * max |host|. The gate stands 1/tol below
    each leaf's own scale, so a zero or misdirected card gradient misses it
    by the whole scale; a leaf whose host gradient is all zero must be all
    zero on the card."""
    check(list(card) == list(host), f"2k-i {what}: gradient trees differ")
    worst, worst_leaf, zero, n, least = 0.0, "", 0, 0, float("inf")
    for name, h in host.items():
        c = card[name]
        for i, (x, y) in enumerate(zip(*(v if isinstance(v, list) else [v] for v in (c, h)))):
            leaf = f"{name}[{i}]" if isinstance(h, list) else name
            scale = float(y.abs().max())
            err = float((x.float() - y.to(x.device).float()).abs().max())
            n += 1
            if scale == 0:
                check(err == 0, f"2k-i {what}: {leaf} is zero on the host, not on the card")
                zero += 1
                continue
            least = min(least, scale)
            if err / scale > worst:
                worst, worst_leaf = err / scale, leaf
    check(zero < n, f"2k-i {what}: every host gradient leaf is zero")
    check(worst <= tol, f"2k-i {what}: the card's gradient of {worst_leaf} is off by "
          f"{worst:.3e} of its largest host entry > {tol}")
    return {"grad_rel_err": worst, "grad_worst_leaf": worst_leaf, "grad_leaves": n,
            "zero_grad_leaves": zero, "least_grad_scale": least}


def lm_train_card_vs_host(arch: str) -> dict:
    """2k-i: one ``make_lm_train_step`` step of a full-width copy cut to 2
    layers, float32 (TF32 off), from equal weights on the card and the
    host with ``pick_optimizer``'s AdamW: loss, metrics, grad_norm, and
    every updated leaf and moment within TRAIN_LM_TOL; and every clipped
    gradient leaf within TRAIN_LM_TOL of that leaf's largest host entry
    (``compare_grads``). The first step's learning rate is 1.5e-7 and the
    largest clipped gradient near 1e-2, so the state gate alone holds
    little of the backward pass; the gradient gate holds all of it."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_spec
    from repro_torch.launch.train import make_lm_train_step, pick_optimizer
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_spec(arch).model, n_layers=2, dtype="float32")
    card = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    host = T.TransformerLM(cfg, "cpu")
    host.load_state_dict(card.state_dict())
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, TRAIN_HOST_TOKENS).astype(np.int32)
    out = {}
    for name, model, dev in (("card", card, "cuda"), ("host", host, "cpu")):
        opt, opt_name = pick_optimizer(cfg.num_params())
        opt, grads = grad_tap(opt)
        state = (model, opt.init(model.param_tree()))
        with RouterTap() as tap:
            state, metrics = make_lm_train_step(cfg, opt)(
                state, {"tokens": torch.from_numpy(tokens).to(dev)})
        out[name] = (state, {k: float(v) for k, v in metrics.items()}, tap, grads)
    (cs, cm, ctap, cg), (hs, hm, htap, hg) = out["card"], out["host"]
    flips = 0
    if cfg.moe:
        ex_c, _ = ctap.routing(cfg.n_layers)
        ex_h, _ = htap.routing(cfg.n_layers)
        flips = int((ex_c != ex_h).any(dim=-1).sum())
    metric_err = max(abs(cm[k] - hm[k]) for k in hm)
    check(all(np.isfinite(v) for v in cm.values()), f"2k-i {arch}: a metric is not finite")
    check(metric_err <= TRAIN_LM_TOL, f"2k-i {arch}: metrics differ by {metric_err:.3e}: "
          f"card {cm}, host {hm}")
    row = compare_states(cs, hs, f"2k-i {arch}", TRAIN_LM_TOL)
    row.update(compare_grads(cg, hg, arch, TRAIN_LM_TOL))
    row.update(metrics=hm, metric_err=metric_err, optimizer=opt_name, router_flips=flips)
    return row


def gnn_ranker_train_card_vs_host() -> list[dict]:
    """2k-i for GraphSAGE's three step factories and each ranker's
    ``make_recsys_train_step``: one SGD step (lr 0.1) on the card and on
    the host at 2j-i's widths and batch 64, weights as 2j-i's (init plus
    N(0, 0.05^2) on every leaf). SGD's first momentum is the gradient, so
    the states compare the gradients themselves; the host's must reach
    CHECK_SCALE times the gate."""
    import numpy as np
    import torch
    from repro_torch.configs import get_spec
    from repro_torch.data.sampler import random_graph, sample_blocks
    from repro_torch.launch import train as TR
    from repro_torch.models import recsys
    from repro_torch.optim import sgd

    rows = []
    rng = np.random.default_rng(SEED)

    def both(what, model, make, cfg, inputs):
        card, host = check_pair(model)
        out = {}
        for name, m, dev in (("card", card, "cuda"), ("host", host, "cpu")):
            opt = sgd(0.1)
            ins = [x.to(dev) if torch.is_tensor(x) else
                   ({k: v.to(dev) for k, v in x.items()} if isinstance(x, dict) else x)
                   for x in inputs]
            state, metrics = make(cfg, opt)((m, opt.init(m.param_tree())), *ins)
            out[name] = (state, {k: float(v) for k, v in metrics.items()})
        (cs, cm), (hs, hm) = out["card"], out["host"]
        metric_err = max(abs(cm[k] - hm[k]) for k in hm)
        check(metric_err <= TRAIN_TOL, f"2k-i {what}: metrics differ by {metric_err:.3e}")
        row = compare_states(cs, hs, f"2k-i {what}", TRAIN_TOL)
        check(row["moment_scale"] >= CHECK_SCALE * TRAIN_TOL, f"2k-i {what}: host "
              f"gradients reach only {row['moment_scale']:.3e}")
        row.update(what=what, metrics=hm, metric_err=metric_err)
        rows.append(row)

    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    cfg, sz, model = gnn_model("full_graph_sm")
    g = random_graph(sz["n_nodes"], 4, seed=SEED)
    both("full_graph_sm make_gnn_full_graph_step", model, TR.make_gnn_full_graph_step, cfg,
         [f32(rng.standard_normal((g.num_nodes, cfg.d_in))), i32(edge_index_of(g)),
          i32(rng.integers(0, cfg.n_classes, g.num_nodes)),
          f32(rng.random(g.num_nodes) < 0.5)])
    cfg, sz, model = gnn_model("minibatch_lg")
    g = random_graph(20_000, 30, seed=SEED)
    feats = rng.standard_normal((g.num_nodes, cfg.d_in)).astype(np.float32)
    blocks = sample_blocks(g, rng.choice(g.num_nodes, CHECK_BATCH, replace=False),
                           tuple(sz["fanout"]), rng)
    both("minibatch_lg make_gnn_sampled_step (64 seeds)", model, TR.make_gnn_sampled_step,
         cfg, [f32(feats[b]) for b in blocks] + [i32(rng.integers(0, cfg.n_classes,
                                                                   CHECK_BATCH))])
    cfg, sz, model = gnn_model("molecule")
    n_g, nodes, edges = sz["batch"], sz["n_nodes"], sz["n_edges"]
    base = np.repeat(np.arange(n_g) * nodes, edges)
    both("molecule make_gnn_batched_graphs_step", model, TR.make_gnn_batched_graphs_step, cfg,
         [f32(rng.standard_normal((n_g * nodes, cfg.d_in))),
          i32(rng.integers(0, nodes, (2, n_g * edges)) + base),
          i32(np.repeat(np.arange(n_g), nodes)), i32(rng.integers(0, cfg.n_classes, n_g)),
          n_g])
    del model
    gc_card()
    for kind in RANKERS:
        cfg = get_spec(kind).model
        model = recsys.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
        batch = {k: v.cpu() for k, v in ranker_train_batch(kind, cfg, CHECK_BATCH, rng).items()}
        both(f"{kind} make_recsys_train_step", model, TR.make_recsys_train_step, cfg, [batch])
        del model
        gc_card()
    return rows


def ranker_train_batch(kind: str, cfg, B: int, rng) -> dict:
    """2j's batch of ``kind``'s inputs with the labels its loss reads: a
    click for the pointwise rankers, BERT4Rec's masked items (one position
    in 20 without a label)."""
    import numpy as np

    b = ranker_batch(kind, cfg, B, rng)
    if kind == "bert4rec":
        labels = rng.integers(0, cfg.n_items, (B, cfg.n_masked))
        labels[rng.random((B, cfg.n_masked)) < 0.05] = -1
        b["labels"] = on_card(labels.astype(np.int32))
    else:
        b["label"] = on_card(rng.integers(0, 2, B).astype(np.int32))
    return b


def step_times(step, state, inputs, n: int):
    """Run ``state, metrics = step(state, *inputs)`` ``n`` times, each timed
    by CUDA events; returns ``(state, metrics of the last, [ms...])``."""
    import torch

    ms, metrics = [], None
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, *inputs)
        end.record()
        ms.append((start, end))
    torch.cuda.synchronize()
    return state, metrics, [s.elapsed_time(e) for s, e in ms]


def profiled_step(step, state, inputs) -> dict:
    """One step under the profiler (``trace_ops``): the step's own ms by
    CUDA events, the device ms of its kernels, copies and fills, the kernel
    count and the largest device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        state, metrics = step(state, *inputs)
        end.record()
        torch.cuda.synchronize()
    ops_, kernels = trace_ops(prof)
    return {"state": state, "metrics": metrics, "profiled_ms": start.elapsed_time(end),
            "device_ms": sum(t for _, t in ops_) * 1e3, "kernels": kernels,
            "top_ops": [(n[:48], t * 1e3) for n, t in ops_[:4]]}


def train_bytes(cfg, B: int, S: int) -> int:
    """The reckoned peak device bytes of a bf16 AdamW training step with
    remat at batch B, sequence S: the larger of the backward pass (params,
    gradients and two bf16 moments, 8 bytes a parameter; the blocks'
    bf16 inputs; one block recomputed, its attention one float32 score
    block a causal block pair; the float32 logits and their gradient; the
    float32 copy of the output head and its gradient) and the update
    (the same 8 bytes, 2 more for the updates, and the float32 temporaries
    of the largest leaf). Held to a run on an H100 80GB at batch 2:
    MiniCPM3-4B peaked at 44.73 GiB (backward, reckoned 45.06), OLMoE-1B-7B
    at 67.45 GiB (the update, reckoned 67.44)."""
    import math

    from repro_torch.models import transformer as T
    from repro_torch.models.params import flat_leaves

    N = cfg.num_params()
    shapes = T.param_shapes(cfg)
    largest = max(math.prod(s[1:]) if name.startswith(("layers.", "mtp.block."))
                  else math.prod(s)
                  for name, s in flat_leaves(shapes).items())
    chunk = min(cfg.kv_chunk, S)
    n_chunks = -(-S // chunk)
    blocks = n_chunks * (n_chunks + 1) // 2  # causal blocks that run
    heads = cfg.n_heads
    score = 4 * B * chunk * heads * chunk  # one float32 (B, q, H, kv) block
    carries = cfg.n_layers * B * S * cfg.d_model * 2
    width = max(cfg.d_ff, cfg.expert_d_ff * cfg.top_k * cfg.capacity_factor, 4 * cfg.d_model)
    layer = blocks * score + 12 * B * S * int(width) * 2
    logits = 2 * 4 * B * S * cfg.vocab_size
    head = 2 * 4 * cfg.d_model * cfg.vocab_size
    backward = 8 * N + carries + layer + logits + head
    update = 10 * N + 6 * 4 * largest
    return max(backward, update)


def train_cut(cfg) -> dict:
    """The largest per-step batch (a power of two up to the global batch
    of 256) whose reckoned peak fits TRAIN_MEM_SHARE of the card, at the
    reference's sequence of 4,096; if not even one sequence fits, the
    sequence is halved until it does."""
    import torch

    budget = TRAIN_MEM_SHARE * torch.cuda.get_device_properties(0).total_memory
    S = TRAIN_SEQ
    while train_bytes(cfg, 1, S) > budget:
        S //= 2
    B = 1
    while B * 2 <= TRAIN_GLOBAL_BATCH and train_bytes(cfg, B * 2, S) <= budget:
        B *= 2
    return {"batch": B, "seq": S, "reckoned_bytes": train_bytes(cfg, B, S),
            "budget_bytes": budget}


def lm_train_full(arch: str) -> dict:
    """2k-ii: bf16 AdamW (``pick_optimizer``) training steps of the full
    model with remat at sequence 4,096 and the reckoned batch cut: one
    warm-up step, then TRAIN_TIMED steps timed by CUDA events, the last of
    them under the profiler (the card's activity only; its busy share is
    of its own time). Loss and gradient norm must stay finite, every
    moment leaf finite, and some parameters must have changed."""
    import numpy as np
    import torch
    from repro_torch.configs import get_spec
    from repro_torch.launch.train import make_lm_train_step, pick_optimizer
    from repro_torch.models import transformer as T

    cfg = get_spec(arch).model
    check(cfg.remat and cfg.dtype == "bfloat16", f"2k-ii {arch}: expected bf16 with remat")
    cut = train_cut(cfg)
    B, S = cut["batch"], cut["seq"]
    print(f"[train] {arch}: per-step batch {B} x {S} tokens (global batch "
          f"{TRAIN_GLOBAL_BATCH} x {TRAIN_SEQ} cut; reckoned peak "
          f"{cut['reckoned_bytes'] / 2**30:.2f} GiB of a {cut['budget_bytes'] / 2**30:.2f} "
          "GiB budget)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    opt, opt_name = pick_optimizer(cfg.num_params())
    state = (model, opt.init(model.param_tree()))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if n in ("embed", "layers.0.ln1", f"layers.{cfg.n_layers - 1}.wo")}
    rng = np.random.default_rng(SEED)
    step = make_lm_train_step(cfg, opt)
    batches = [{"tokens": on_card(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))}
               for _ in range(TRAIN_TIMED + 1)]
    losses = []
    t0 = time.perf_counter()
    state, m, _ = step_times(step, state, [batches[0]], 1)
    losses.append(float(m["loss"]))
    warm_s = time.perf_counter() - t0
    ms, prof = [], {}
    for i, b in enumerate(batches[1:], 1):
        if i < TRAIN_TIMED:
            state, m, t = step_times(step, state, [b], 1)
        else:
            prof = profiled_step(step, state, [b])
            state, m, t = prof.pop("state"), prof.pop("metrics"), [prof["profiled_ms"]]
        ms += t
        losses.append(float(m["loss"]))
        check(np.isfinite(losses[-1]) and np.isfinite(float(m["grad_norm"])),
              f"2k-ii {arch}: loss {losses[-1]} or grad_norm {float(m['grad_norm'])} "
              "is not finite")
    peak = torch.cuda.max_memory_allocated()
    step_ms = sorted(ms)[len(ms) // 2]
    prof["busy"] = prof["device_ms"] / prof["profiled_ms"]
    finite = all(bool(torch.isfinite(t).all()) for _, t in train_leaves(state))
    check(finite, f"2k-ii {arch}: a parameter or moment leaf is not finite")
    changed = {n: int((p.detach() != before[n]).sum()) for n, p in model.named_parameters()
               if n in before}
    check(sum(changed.values()) > 0, f"2k-ii {arch}: no parameter changed")
    prof["warm_s"] = warm_s
    del state, model, batches
    gc_card()
    flops = 6 * cfg.num_active_params() * B * S
    bound_ms = flops / BF16_FLOPS_PER_S * 1e3
    return {"arch": arch, "batch": B, "seq": S, "optimizer": opt_name, "init_s": init_s,
            "params": cfg.num_params(), "active_params": cfg.num_active_params(),
            "step_ms": step_ms, "steps_ms": ms, "tokens_per_s": B * S / step_ms * 1e3,
            "bound_ms": bound_ms, "share": bound_ms / step_ms, "peak_bytes": peak,
            "reckoned_bytes": cut["reckoned_bytes"], "losses": losses,
            "changed": changed, **prof}


def gnn_ranker_train_cells() -> list[dict]:
    """2k-iii: GraphSAGE's four train cells and each ranker at its
    train_batch (cut where RANKER_TRAIN_BATCH says), float32 with TF32 off,
    ``pick_optimizer``'s AdamW: the median of GNN_TRAIN_TIMED steps timed
    by CUDA events after a warm-up, beside a bound of 3 times the forward's
    matmul FLOPs at 67 TFLOP/s (the reference's ``model_flops`` is the
    forward's 2·FLOPs; forward and backward are three of them), peak memory
    and one profiled step."""
    import numpy as np
    import torch
    from repro_torch.configs import get_spec
    from repro_torch.data.sampler import random_graph, random_graph_on_device, sample_blocks
    from repro_torch.launch import train as TR
    from repro_torch.models import gnn, recsys

    rows = []
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def cell(what, model, make, cfg, inputs, forward, extra=None):
        opt, opt_name = TR.pick_optimizer(sum(p.numel() for p in model.parameters()))
        state = (model, opt.init(model.param_tree()))
        step = make(cfg, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, m, _ = step_times(step, state, inputs, 1)
        state, m, ms = step_times(step, state, inputs, GNN_TRAIN_TIMED)
        check(np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"])),
              f"2k-iii {what}: loss or grad_norm not finite")
        peak = torch.cuda.max_memory_allocated()
        with torch.inference_mode():
            flops = matmul_flops(forward)
        med = sorted(ms)[len(ms) // 2]
        prof = profiled_step(step, state, inputs)
        del prof["state"], prof["metrics"], state
        prof["busy"] = prof["device_ms"] / med
        bound_ms = 3 * flops / F32_FLOPS_PER_S * 1e3
        row = {"what": what, "optimizer": opt_name, "step_ms": med, "min_ms": min(ms),
               "max_ms": max(ms), "bound_ms": bound_ms, "share": bound_ms / med,
               "peak_bytes": peak, "loss": float(m["loss"]), **prof, **(extra or {})}
        rows.append(row)
        gc_card()

    cfg, sz, model = gnn_model("full_graph_sm")
    g = random_graph(sz["n_nodes"], 4, seed=SEED)
    ei = on_card(edge_index_of(g))
    feats = torch.randn((g.num_nodes, cfg.d_in), generator=gen, device="cuda")
    labels = on_card(rng.integers(0, cfg.n_classes, g.num_nodes).astype(np.int32))
    mask = on_card((rng.random(g.num_nodes) < 0.5).astype(np.float32))
    cell("full_graph_sm", model, TR.make_gnn_full_graph_step, cfg, [feats, ei, labels, mask],
         lambda: gnn.forward_full_graph(model, feats, ei, cfg))

    cfg, sz, model = gnn_model("minibatch_lg")
    g = random_graph_on_device(sz["n_nodes"], REDDIT_DEGREE, seed=SEED)
    feats = torch.randn((g.num_nodes, cfg.d_in), generator=gen, device="cuda")
    B = sz["batch_nodes"]
    hops = [feats[on_card(b).long()] for b in sample_blocks(
        g, rng.choice(g.num_nodes, B, replace=False), tuple(sz["fanout"]), rng)]
    labels = on_card(rng.integers(0, cfg.n_classes, B).astype(np.int32))
    cell("minibatch_lg (1,024 seeds, fanout (15, 10))", model, TR.make_gnn_sampled_step, cfg,
         hops + [labels], lambda: gnn.forward_sampled(model, *hops, cfg))
    del g, feats, hops
    gc_card()

    cfg, sz, model = gnn_model("ogb_products")
    g = random_graph_on_device(sz["n_nodes"], PRODUCTS_DEGREE, seed=SEED)
    ei = on_card(edge_index_of(g))
    edges = g.num_edges
    del g
    feats = torch.randn((sz["n_nodes"], cfg.d_in), generator=gen, device="cuda")
    labels = on_card(rng.integers(0, cfg.n_classes, sz["n_nodes"]).astype(np.int32))
    mask = on_card((rng.random(sz["n_nodes"]) < 0.1).astype(np.float32))
    cell("ogb_products", model, TR.make_gnn_full_graph_step, cfg, [feats, ei, labels, mask],
         lambda: gnn.forward_full_graph(model, feats, ei, cfg),
         {"edges": edges, "shape_edges": sz["n_edges"]})
    del ei, feats, labels, mask
    gc_card()

    cfg, sz, model = gnn_model("molecule")
    n_g, nodes, n_e = sz["batch"], sz["n_nodes"], sz["n_edges"]
    mol = [torch.randn((n_g * nodes, cfg.d_in), generator=gen, device="cuda"),
           on_card((rng.integers(0, nodes, (2, n_g * n_e))
                    + np.repeat(np.arange(n_g) * nodes, n_e)).astype(np.int32)),
           on_card(np.repeat(np.arange(n_g), nodes).astype(np.int32)),
           on_card(rng.integers(0, cfg.n_classes, n_g).astype(np.int32)), n_g]
    cell("molecule (128 graphs)", model, TR.make_gnn_batched_graphs_step, cfg, mol,
         lambda: gnn.forward_batched_graphs(model, *mol[:3], cfg, n_g))
    del model
    gc_card()

    for kind in RANKERS:
        spec = get_spec(kind)
        cfg = spec.model
        model = recsys.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
        B = RANKER_TRAIN_BATCH[kind]
        batch = ranker_train_batch(kind, cfg, B, rng)
        cell(f"{kind} train_batch", model, TR.make_recsys_train_step, cfg, [batch],
             lambda: recsys.loss_fn(model, batch, cfg),
             {"batch": B, "shape_batch": spec.shapes["train_batch"].sizes["batch"]})
        del model, batch
        gc_card()
    return rows


TRAIN_LM_RUNS = r"""
import json, os, sys, time, torch
torch.use_deterministic_algorithms(True)
from repro_torch.launch import train_lm
work, first, resume = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

def args(name, steps, *more):
    return train_lm._parser().parse_args(
        ["--steps", str(steps), "--ckpt-dir", os.path.join(work, name), *more])

def save(name, state, losses, t0):
    torch.save({n: p.detach().cpu() for n, p in state[0].named_parameters()},
               os.path.join(work, name + ".pt"))
    with open(os.path.join(work, name + ".json"), "w") as f:
        json.dump({"losses": losses, "count": int(state[1]["count"]),
                   "s": time.perf_counter() - t0}, f)

t0 = time.perf_counter()
state, losses = train_lm.train(args("ckpt", first))
save("first", state, losses, t0)
t0 = time.perf_counter()
save("resumed", *train_lm.train(args("ckpt", resume, "--resume")), t0)
t0 = time.perf_counter()  # the first run, continued in memory
state, more = train_lm.train(args("straight", resume), state, start=first)
save("straight", state, losses + more, t0)
"""


def start_train_lm():
    """Start 2k-iv's runs of ``launch.train_lm`` at the example's defaults
    on the card, in a process of their own with
    ``torch.use_deterministic_algorithms(True)`` (and cuBLAS's fixed
    workspace, which that needs): 200 steps, then a run with ``--resume``
    to 250 from its checkpoint, and the run that must equal it: the first
    run's own state taken on to 250 in memory, with no checkpoint read (a
    straight ``--steps 250`` run sets its cosine over 250 steps from the
    start, as the reference's does, so its parameters differ). It runs
    beside 2k-i's checks, which leave the card mostly idle; ``train_path``
    waits for it before anything is timed. Returns ``(process, work, t0)``."""
    work = os.path.join(WORK, "train_lm")
    os.makedirs(work, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=SRC, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    with open(os.path.join(work, "stderr.txt"), "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", TRAIN_LM_RUNS, work,
                                 str(TRAIN_LM_STEPS), str(TRAIN_LM_RESUME)], env=env,
                                stdout=subprocess.DEVNULL, stderr=err)
    return proc, work, time.perf_counter()


def train_lm_entry(started) -> dict:
    """2k-iv: wait for ``start_train_lm``'s process and hold its runs: the
    loss falls over the 200 steps, and the resumed run's parameters and
    losses equal the run continued in memory. Then a checkpoint round trip
    of a bf16-moment state on the card."""
    import torch

    proc, work, t0 = started
    rc = proc.wait(timeout=600)  # train_path kills it if this raises
    with open(os.path.join(work, "stderr.txt")) as f:
        check(rc == 0, f"2k-iv train_lm failed:\n{f.read()[-3000:]}")
    runs = {}
    for name in ("first", "resumed", "straight"):
        with open(os.path.join(work, name + ".json")) as f:
            runs[name] = json.load(f)
        runs[name]["params"] = torch.load(os.path.join(work, name + ".pt"))
    first, resumed, straight = (runs[n] for n in ("first", "resumed", "straight"))
    losses = first["losses"]
    check(len(losses) == TRAIN_LM_STEPS and losses[-1] < losses[0],
          f"2k-iv: loss at step {TRAIN_LM_STEPS - 1} {losses[-1]} is not below step 0's "
          f"{losses[0]}")
    check(resumed["count"] == straight["count"] == TRAIN_LM_RESUME, "2k-iv: step counts")
    unequal = [n for n, p in resumed["params"].items()
               if not torch.equal(p, straight["params"][n])]
    check(not unequal, f"2k-iv: resumed parameters differ from the straight run's at {unequal}")
    check(resumed["losses"] == straight["losses"][TRAIN_LM_STEPS:],
          "2k-iv: the resumed run's losses differ from the straight run's")
    return {"losses": [losses[0], losses[-1]], "equal_leaves": len(resumed["params"]),
            "process_s": time.perf_counter() - t0,
            "seconds": {n: r["s"] for n, r in runs.items()},
            "round_trip": checkpoint_round_trip(work)}


def checkpoint_round_trip(work: str) -> dict:
    """A MiniCPM3 smoke model in bf16 on the card, two ``pick_optimizer``
    (bf16-moment AdamW) steps, ``save_async``, then a restore into a fresh
    state: every leaf (parameters, both moments, the counter)
    ``torch.equal`` to the saved one."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.checkpoint import CheckpointManager, restore_checkpoint
    from repro_torch.configs import get_spec
    from repro_torch.convert import train_state_tree
    from repro_torch.launch.train import make_lm_train_step, pick_optimizer
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_spec("minicpm3-4b").smoke(), dtype="bfloat16")
    model = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    opt, _ = pick_optimizer(cfg.num_params())
    state = (model, opt.init(model.param_tree()))
    tokens = on_card(np.random.default_rng(SEED).integers(0, cfg.vocab_size, (2, 32))
                     .astype(np.int32))
    for _ in range(2):
        state, _ = make_lm_train_step(cfg, opt)(state, {"tokens": tokens})
    mgr = CheckpointManager(os.path.join(work, "round_trip"))
    mgr.save_async(2, train_state_tree(*state), extra={"step": 2})
    mgr.wait()
    fresh = T.TransformerLM(cfg, "cuda")
    like = train_state_tree(fresh, opt.init(fresh.param_tree()))
    got, extra = restore_checkpoint(os.path.join(work, "round_trip"), 2, like)
    a, b = train_leaves(state), tree_leaves(got)
    check([n for n, _ in a] == [n for n, _ in b], "2k-iv: the restored tree differs")
    unequal = [n for (n, x), (_, y) in zip(a, b) if not torch.equal(x.detach(), y)]
    check(not unequal, f"2k-iv: restored leaves differ from the saved ones: {unequal}")
    return {"leaves": len(b), "bf16_leaves": sum(t.dtype == torch.bfloat16 for _, t in b),
            "step": extra["step"]}


def train_path() -> dict:
    """Phase 2k: i. card against host (float32, TF32 off), while iv. the
    ``train_lm`` entry point runs in a process of its own; iii. GraphSAGE
    and the rankers at published widths (float32, TF32 off); ii. the two
    LMs at full width in bf16. Each model is freed before the next."""
    import torch
    from repro_torch.configs import get_spec

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    out = {}

    def f32(fn, *args):
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*args)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
            gc_card()

    started = start_train_lm()
    try:
        t0 = time.perf_counter()
        out["lm_checks"] = []
        for arch in LM_ARCHS:
            t1 = time.perf_counter()
            row = f32(lm_train_card_vs_host, arch)
            out["lm_checks"].append(dict(row, arch=arch, s=time.perf_counter() - t1))
        t1 = time.perf_counter()
        out["checks"] = f32(gnn_ranker_train_card_vs_host)
        out["gnn_ranker_check_s"] = time.perf_counter() - t1
        out["check_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["entry"] = train_lm_entry(started)
        out["entry_wait_s"] = time.perf_counter() - t0
    finally:
        if started[0].poll() is None:
            started[0].kill()
            started[0].wait()
    # the profiled steps in order of size, the LMs' (up to ~10^5 kernels)
    # last: the profiler drops device events after a session that large
    t0 = time.perf_counter()
    out["cells"] = f32(gnn_ranker_train_cells)
    out["cells_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["lm"] = []
    for arch in sorted(LM_ARCHS, key=lambda a: get_spec(a).model.n_layers):
        out["lm"].append(lm_train_full(arch))
        gc_card()
    out["lm_s"] = time.perf_counter() - t0
    return out


def print_train(tr: dict, smi: str) -> None:
    for c in tr["lm_checks"]:
        print(f"[train] 2k-i {c['arch']} 2 layers, float32, {TRAIN_HOST_TOKENS[0]} x "
              f"{TRAIN_HOST_TOKENS[1]} tokens, {c['optimizer']}: card vs host metrics max "
              f"abs {c['metric_err']:.3e}, state {c['max_abs_err']:.3e} (at "
              f"{c['worst_leaf']}; gate {TRAIN_LM_TOL}; largest host moment "
              f"{c['moment_scale']:.3e}; {c['router_flips']} router flips); clipped gradients "
              f"off by {c['grad_rel_err']:.3e} of their leaf's largest host entry at most (at "
              f"{c['grad_worst_leaf']}; gate {TRAIN_LM_TOL}; {c['grad_leaves']} leaves, "
              f"{c['zero_grad_leaves']} all zero on both, the least largest entry "
              f"{c['least_grad_scale']:.3e}); host loss {c['metrics']['loss']:.6f}, grad_norm "
              f"{c['metrics']['grad_norm']:.6f}; {c['s']:.1f} s")
    for c in tr["checks"]:
        print(f"[train] 2k-i {c['what']}: card vs host metrics {c['metric_err']:.3e}, "
              f"state {c['max_abs_err']:.3e} (gate {TRAIN_TOL}; host gradients up to "
              f"{c['moment_scale']:.3e})")
    for r in tr["lm"]:
        print(f"[train] 2k-ii {r['arch']} bf16, remat, {r['optimizer']} (bf16 moments): "
              f"batch {r['batch']} x {r['seq']} (cut from {TRAIN_GLOBAL_BATCH} x "
              f"{TRAIN_SEQ}): {r['step_ms']:.1f} ms a step (median of {TRAIN_TIMED}, the last "
              "profiled; "
              + ", ".join(f"{t:.1f}" for t in r["steps_ms"])
              + f"), {r['tokens_per_s']:,.0f} tokens/s; bound 6 x {r['active_params']:,} "
              f"active params x tokens at 989 TFLOP/s = {r['bound_ms']:.1f} ms "
              f"({r['share']:.1%} of bound); peak {r['peak_bytes'] / 2**30:.2f} GiB "
              f"(reckoned {r['reckoned_bytes'] / 2**30:.2f}); init {r['init_s']:.1f} s, "
              f"warm-up step {r['warm_s']:.1f} s; "
              f"busy {r['busy']:.1%} (the profiled step's {r['kernels']:,} kernels: "
              f"{r['device_ms']:.1f} ms of device time); losses "
              f"{', '.join(f'{x:.4f}' for x in r['losses'])}; "
              f"changed elements {r['changed']} | {smi}")
        print(f"[where] 2k-ii {r['arch']} step top device ops: "
              + "; ".join(f"{n} {ms:.1f} ms" for n, ms in r["top_ops"]))
    for c in tr["cells"]:
        cut = ""
        if "shape_batch" in c and c["batch"] != c["shape_batch"]:
            cut = f" (batch {c['batch']:,}, cut from {c['shape_batch']:,})"
        elif "edges" in c:
            cut = f" ({c['edges']:,} edges against the cell's {c['shape_edges']:,})"
        print(f"[train] 2k-iii {c['what']}{cut}, {c['optimizer']}: {c['step_ms']:.3f} ms a "
              f"step (median of {GNN_TRAIN_TIMED}, {c['min_ms']:.3f}-{c['max_ms']:.3f}) "
              f"against a bound of {c['bound_ms']:.3f} ms (3 x forward matmul FLOPs at 67 "
              f"TFLOP/s; {c['share']:.1%}), peak {c['peak_bytes'] / 2**30:.2f} GiB, "
              f"busy {c['busy']:.1%} ({c['kernels']:,} kernels a step); top: "
              + "; ".join(f"{n} {ms:.2f} ms" for n, ms in c["top_ops"][:3]) + f" | {smi}")
    e = tr["entry"]
    print(f"[train] 2k-iv train_lm: loss {e['losses'][0]:.4f} at step 0, {e['losses'][1]:.4f} "
          f"at step {TRAIN_LM_STEPS - 1}; --resume to {TRAIN_LM_RESUME}: all "
          f"{e['equal_leaves']} parameters torch.equal to the same run continued in memory "
          f"(deterministic algorithms); checkpoint round trip: {e['round_trip']['leaves']} "
          f"leaves equal, {e['round_trip']['bf16_leaves']} of them bf16; its process started "
          f"beside 2k-i, {e['process_s']:.1f} s from its start to the round trip's end: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in e["seconds"].items()))
    print(f"[phase] 2k parts: checks {tr['check_s']:.1f} s (GNN and rankers "
          f"{tr['gnn_ranker_check_s']:.1f} s), then train_lm {tr['entry_wait_s']:.1f} s more, "
          f"LM {tr['lm_s']:.1f} s, GNN and rankers {tr['cells_s']:.1f} s")
    print(json.dumps({"train": dict(
        {k: v for k, v in tr.items() if k != "entry"},
        entry={k: v for k, v in e.items()}, device=smi)}, default=str))


# --------------------------------------------------------------- phase 3
def first_tail_batch(col, dev):
    """The first ``segment_hist`` launch of FREQ-SPLIT's tail on ``col`` at
    the default head of 1,024 terms: ``(ids, seg, rows, vocab)``."""
    from repro_torch.core.hybrid import tail_batch_end
    from repro_torch.core.list_scan import LAUNCH_TOKENS, _device_chunks
    from repro_torch.data.index import DeviceIndex

    lo = 1024
    hi = tail_batch_end(lo, col.vocab_size)
    idx = DeviceIndex.from_collection(col, dev)
    ids, seg = next(_device_chunks(idx, lo, hi, LAUNCH_TOKENS, lower=True))
    return ids, seg, hi - lo, hi


def check_segment_hist(c, cd, run_cd) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.list_scan import LAUNCH_TOKENS, _device_chunks
    from repro_torch.data.index import DeviceIndex
    from repro_torch.data.preprocess import shard_documents
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_hist import plan, segment_hist_cuda

    dev = torch.device("cuda")
    idx = DeviceIndex.from_collection(c, dev)
    rows = 64
    ids, seg = next(_device_chunks(idx, 0, rows, LAUNCH_TOKENS))  # head batch
    shapes = {
        "path 1 head batch": (ids, seg, rows, VOCAB),
        "path 2 first tail batch": first_tail_batch(cd, dev),
        # cooc_run counts shard by shard: its first shard's first tail batch
        "cooc_run first tail batch": first_tail_batch(shard_documents(run_cd, 16)[0], dev),
    }
    g = torch.Generator(device=dev).manual_seed(SEED)
    L = 1_000_003
    # rows 0, 1, 5, 0, 2, 63 of 300,000 tokens each: the window moves on,
    # then the stream falls back behind it
    rng = np.random.default_rng(SEED)
    back = torch.from_numpy(np.repeat(np.array([0, 1, 5, 0, 2, 63], np.int32),
                                      300_000)).to(dev)
    back_ids = torch.from_numpy(
        ((rng.zipf(1.1, back.numel()) - 1) % VOCAB).astype(np.int32)).to(dev)
    cases = {name: shape for name, shape in shapes.items()}
    cases.update({
        "ragged L": (
            torch.randint(-1, VOCAB, (L,), device=dev, generator=g, dtype=torch.int32),
            torch.randint(-1, rows, (L,), device=dev, generator=g, dtype=torch.int32),
            rows, VOCAB,
        ),
        "all padding": (
            torch.full((4097,), -1, dtype=torch.int32, device=dev),
            torch.full((4097,), -1, dtype=torch.int32, device=dev), rows, VOCAB,
        ),
        "ids at V-1": (
            torch.full((5000,), VOCAB - 1, dtype=torch.int32, device=dev),
            torch.arange(5000, dtype=torch.int32, device=dev) % rows, rows, VOCAB,
        ),
        "row leaves and re-enters the window": (back_ids, back, rows, VOCAB),
        "misaligned head batch": (ids[1:], seg[1:], rows, VOCAB),
    })
    err = 0.0
    for name, (i, s, r, v) in cases.items():
        got = segment_hist_cuda(i, s, num_rows=r, vocab=v)
        want = ref.segment_hist_ref(i, s, r, v)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"segment_hist != plain version on {name}")
        err = max(err, max_abs_err(got, want))
        # again into the grid that now holds counts: a batch over launches
        segment_hist_cuda(i, s, num_rows=r, vocab=v, out=got)
        ref.segment_hist_ref(i, s, r, v, out=want)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"segment_hist != plain version accumulating on {name}")

    out = {"max_abs_err": err, "shapes": {}}
    for name, (i, s, r, v) in shapes.items():
        n = i.numel()
        grid = torch.zeros((r, v), dtype=torch.int32, device=dev)
        hits = torch.zeros(1, dtype=torch.int64, device=dev)
        segment_hist_cuda(i, s, num_rows=r, vocab=v, out=grid, hits=hits)
        valid = int(((i >= 0) & (s >= 0) & (s < r) & (i < v)).sum())
        # the caller zeroes the grid; the kernel reads and writes only the
        # cells this batch makes nonzero
        nnz = int(torch.count_nonzero(grid))
        keys = s.to(torch.int64) * v + i.to(torch.int64)
        p = plan(r, v, n)
        out["shapes"][name] = {
            "tokens": n, "grid": (r, v), "window": (p.R, p.H),
            "blocks": p.blocks, "span": p.span,
            "hit_share": int(hits) / max(valid, 1),
            "ms": both_ms(lambda: segment_hist_cuda(
                i, s, num_rows=r, vocab=v, out=grid), reps=20),
            "host_ms": host_ms(lambda: segment_hist_cuda(
                i, s, num_rows=r, vocab=v, out=grid), reps=20),
            "library_ms": both_ms(lambda: torch.bincount(
                keys, minlength=r * v), reps=5),
            "nonzero_cells": nnz,
            "bound_ms": (8 * n + 8 * nnz) / HBM_BYTES_PER_S * 1e3,
        }
    grid = torch.zeros((rows, VOCAB), dtype=torch.int32, device=dev)
    out["plain_ms"] = both_ms(lambda: ref.segment_hist_ref(
        ids, seg, rows, VOCAB, out=grid), reps=5)
    out.update(out["shapes"]["path 1 head batch"])
    return out


def check_topk_gather(store) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.topk_gather import topk_gather_cuda
    from repro_torch.store import QueryEngine

    dev = torch.device("cuda")
    eng = QueryEngine(store)
    # a fixed query batch the way serving draws it: the 64 highest-df terms
    # and a sweep down the df order (long and short rows in one tile)
    order = np.argsort(-store.df(), kind="stable")
    terms = np.concatenate([order[:32], order[32::2048][:32]])
    tile = [torch.from_numpy(a).to(dev) for a in eng.tile(terms)]
    B, L = tile[0].shape

    def small(ids, cnts, df_t, df_n):
        return [torch.tensor(np.asarray(a), dtype=torch.int32, device=dev)
                for a in (ids, cnts, df_t, df_n)]

    empty = small(np.full((3, 8), -1), np.zeros((3, 8)), np.ones(3), np.ones((3, 8)))
    tied = small(np.tile(np.arange(10, 26), (2, 1)), np.full((2, 16), 7),
                 np.full(2, 3), np.full((2, 16), 5))
    rng = np.random.default_rng(SEED)
    full_ids = np.sort(rng.choice(4096, size=(4, 128)), axis=1)
    k_eq_l = small(full_ids, rng.integers(1, 4, size=(4, 128)),
                   rng.integers(1, 50, size=4), rng.integers(1, 50, size=(4, 128)))
    # rows the radix select must get right across the cluster's slices:
    # every score equal across a 65,536-slot row; ties of the k-th score
    # on both sides of slice boundaries; all padding; rows of 1,000 slots
    # (one block, not a multiple of a slice); PMI scores of +0.0
    wide = np.tile(np.arange(65_536), (3, 1))
    wide[2] = -1
    wide_c = np.where(wide >= 0, 3, 0)
    wide_c[1, ::97] = 9
    for edge in (8192, 16_384, 57_344):
        wide_c[1, edge - 40:edge + 40] = 5
    straddle = small(wide, wide_c, np.full(3, 7), np.where(wide >= 0, 11, 1))
    above = int((wide_c[1] == 9).sum())
    odd = small(rng.integers(-1, 5000, (8, 1000)), rng.integers(0, 9, (8, 1000)),
                rng.integers(1, 60, 8), rng.integers(1, 60, (8, 1000)))
    pc = rng.integers(1, 8, (2, 20_000))
    pdf = rng.integers(1, 8, (2, 20_000))
    pz = rng.random((2, 20_000)) < 0.3
    num_docs = max(store.num_docs, 1)
    pdf[pz] = pc[pz] * (num_docs // 2)  # c D / (2 df_n) == 1 for even D
    zero = small(np.tile(np.arange(20_000), (2, 1)), pc, [2, 2], pdf)
    check(bool((ref.score_tile(*zero, num_docs=num_docs, score="pmi") == 0)
               .any()), "the PMI case holds no +0.0 score")
    cases = [(f"main tile k={k}", tile, min(k, L)) for k in (1, 10, 1000, L)]
    cases += [("all-empty rows", empty, 4), ("tied rows", tied, 16),
              ("k = L", k_eq_l, 128)]
    cases += [(f"ties across slices k={k}", straddle, k)
              for k in (1, above + 1, above + 60, 65_536)]
    cases += [(f"L = 1000 k={k}", odd, k) for k in (10, 1000)]
    cases += [(f"PMI +0.0 scores k={k}", zero, k) for k in (100, 20_000)]
    err = 0.0
    for score in SCORES:
        for name, args, k in cases:
            gi, gs = topk_gather_cuda(*args, num_docs=num_docs, score=score, k=k)
            wi, ws = ref.topk_gather_ref(*args, num_docs=num_docs, score=score, k=k)
            torch.cuda.synchronize()
            check(torch.equal(gi, wi) and torch.equal(gs, ws),
                  f"topk_gather != plain version ({score}, {name})")
            err = max(err, max_abs_err(gs, ws))
    ti, _ = topk_gather_cuda(*tied, num_docs=num_docs, score="count", k=16)
    check(ti[0].tolist() == list(range(10, 26)), "tied row not in slot order")

    out = {"B": B, "L": L, "k": 10, "max_abs_err": err, "per_score": {}}
    # k = 4,096: topk_stream's k in the thousands
    k_big, k_sort = min(1000, L), min(4096, L)
    for score in SCORES:
        scored = ref.score_tile(*tile, num_docs=num_docs, score=score)
        # torch.topk leaves the order of ties open: its values, not its ids,
        # must equal the kernel's
        _, ks = topk_gather_cuda(*tile, num_docs=num_docs, score=score, k=k_sort)
        check(torch.equal(torch.topk(scored, k_sort, dim=1).values, ks),
              f"torch.topk's values differ from topk_gather's ({score}, k={k_sort})")
        out["per_score"][score] = {
            "ms": both_ms(lambda: topk_gather_cuda(
                *tile, num_docs=num_docs, score=score, k=10), reps=50),
            "ms_k1000": both_ms(lambda: topk_gather_cuda(
                *tile, num_docs=num_docs, score=score, k=k_big), reps=50),
            "plain_ms": both_ms(lambda: ref.topk_gather_ref(
                *tile, num_docs=num_docs, score=score, k=10), reps=5),
            "library_ms": both_ms(lambda: torch.topk(scored, 10, dim=1), reps=50),
            "library_ms_k1000": both_ms(
                lambda: torch.topk(scored, k_big, dim=1), reps=50),
            "ms_k4096": both_ms(lambda: topk_gather_cuda(
                *tile, num_docs=num_docs, score=score, k=k_sort), reps=20),
            "library_ms_k4096": both_ms(
                lambda: torch.topk(scored, k_sort, dim=1), reps=20),
        }
    out["bound_ms"] = (12 * B * L + 4 * B + 8 * B * 10) / HBM_BYTES_PER_S * 1e3
    out["bound_ms_k1000"] = (
        (12 * B * L + 4 * B + 8 * B * k_big) / HBM_BYTES_PER_S * 1e3)
    out["bound_ms_k4096"] = (
        (12 * B * L + 4 * B + 8 * B * k_sort) / HBM_BYTES_PER_S * 1e3)
    return out



def bound(bytes_moved: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """The least time in ms the card could take for the work, and what binds
    it: the larger of bytes over the memory rate and operations over their
    peak rate."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check_cooc_gram(cd, run_cd) -> dict:
    import torch

    from repro_torch.data.index import incidence_tile
    from repro_torch.kernels import ref
    from repro_torch.kernels.cooc_gram import cooc_gram_cuda

    dev = torch.device("cuda")
    head = incidence_tile(cd, 0, 2048, 0, 1024, dev)  # path 2's first head tile
    blk_i = incidence_tile(cd, 0, 2048, 512, 1024, dev)
    blk_j = incidence_tile(cd, 0, 2048, 1024, 1536, dev)
    # cooc_run's first shard (1,250 documents) against its 1,024 head terms
    run_head = incidence_tile(run_cd, 0, 1250, 0, 1024, dev)
    # a MULTI-SCAN pass: 128 primary terms against the full width
    prim = incidence_tile(cd, 0, 2048, 0, 128, dev)
    full = incidence_tile(cd, 0, 2048, 0, cd.vocab_size, dev)
    g = torch.Generator(device=dev).manual_seed(SEED)

    def rand(d, m, p=0.1):
        return (torch.rand((d, m), device=dev, generator=g) < p).to(torch.uint8)

    zeros = torch.zeros((2048, 1024), dtype=torch.uint8, device=dev)
    ones = torch.ones((2048, 256), dtype=torch.uint8, device=dev)
    wide = rand(2048, 2048, 0.2)
    cases = {
        "head tile (2048, 1024) twice": (head, head),
        "list-blocks tile pair (2048, 512)^2": (blk_i, blk_j),
        "list-blocks diagonal tile": (blk_i, blk_i),
        "ragged (1250, 1000) x (1250, 777)": (rand(1250, 1000), rand(1250, 777)),
        "ragged (1001, 1000) x (1001, 777)": (rand(1001, 1000, 0.3), rand(1001, 777, 0.3)),
        "ragged D (2047, 528) x (2047, 272)": (rand(2047, 528, 0.3), rand(2047, 272, 0.3)),
        "cooc_run head tile (1250, 1024) twice": (run_head, run_head),
        "skinny (2048, 128) x (2048, 8192)": (prim, full[:, :8192].contiguous()),
        "all ones (2048, 256) twice": (ones, ones),
        "one tensor (2048, 2048) twice": (wide, wide),
        "all zeros": (zeros, zeros),
        "empty M": (zeros[:, :0].contiguous(), head),
    }
    err = 0.0
    for name, (a, b) in cases.items():
        got = cooc_gram_cuda(a, b)
        want = ref.cooc_gram_ref(a, b)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"cooc_gram != plain version on {name}")
        err = max(err, max_abs_err(got, want))
    check(bool((cooc_gram_cuda(ones, ones) == 2048).all()),
          "cooc_gram on all-ones tiles: a count is not D")

    def int_mm(a, b):
        """``torch._int_mm`` on the same tiles, its operands laid out before
        the timed call; its product must equal the kernel's."""
        at, (bc,) = int_mm_operands(a, b)
        check(torch.equal(torch._int_mm(at, bc), cooc_gram_cuda(a, b)),
              f"torch._int_mm differs from cooc_gram on {tuple(a.shape)} x "
              f"{tuple(b.shape)}")
        return lambda: torch._int_mm(at, bc)

    def timed(a, b, reps=50):
        D, M = a.shape
        N = b.shape[1]
        bound_ms, bound_by = bound(D * M + (0 if a is b else D * N) + 4 * M * N,
                                   2 * M * N * D, INT8_OPS_PER_S)
        return {
            "shape": (D, M, N), "bound_ms": bound_ms, "bound_by": bound_by,
            "ms": both_ms(lambda: cooc_gram_cuda(a, b), reps=reps),
            "library_ms": both_ms(int_mm(a, b), reps=reps),
        }

    out = timed(head, head)
    out.update({
        "max_abs_err": err,
        "ms_blocks": both_ms(lambda: cooc_gram_cuda(blk_i, blk_j), reps=50),
        "plain_ms": both_ms(lambda: ref.cooc_gram_ref(head, head), reps=20),
        "run_head": timed(run_head, run_head),
        "multi_scan": timed(prim, full, reps=20),
    })
    return out


def check_bitpair(cd, opt_c, clock_hz: float) -> dict:
    """``bitpair`` against its plain version, then timed on LIST-PAIRS
    blocks of path 2's bitmaps (W = 625 words, 20,000 documents) and of the
    opt-in collection's (W = 63, 2,000 documents): block 0 x 1, the shape
    of 120 of LIST-PAIRS' 136 calls, and the diagonal block 0 x 0."""
    import numpy as np
    import torch

    from repro_torch.data.index import incidence_bitpacked
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitpair import bitpair_cuda, plan

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    bits = torch.from_numpy(incidence_bitpacked(cd).view(np.int32)).to(dev)
    build_s = time.perf_counter() - t0
    opt_bits = torch.from_numpy(incidence_bitpacked(opt_c).view(np.int32)).to(dev)
    V, W = bits.shape
    b0, b1, tail = bits[:256], bits[256:512], bits[V - 256:]
    o0, o1 = opt_bits[:256], opt_bits[256:512]
    g = torch.Generator(device=dev).manual_seed(SEED)

    def rand(m, w):
        return torch.randint(-2**31, 2**31 - 1, (m, w), device=dev, generator=g,
                             dtype=torch.int32)

    zero_words = rand(64, W)
    zero_words[:, ::2] = 0
    ragged = rand(70, W)
    cases = {
        "block 0 x 0": (b0, b0),
        "block 0 x 1": (b0, b1),
        "tail block x tail block": (tail, tail),
        "block 0 x tail block": (b0, tail),
        "W = 63 block 0 x 0": (o0, o0),
        "W = 63 block 0 x 1": (o0, o1),
        "ragged (70, 33) x (130, 33)": (rand(70, 33), rand(130, 33)),
        "diagonal, ragged M = 70": (ragged, ragged),
        "one slice at W = 1": (rand(256, 1), rand(256, 1)),
        "zero words": (zero_words, b1[:100]),
    }
    err = 0.0
    for name, (a, b) in cases.items():
        got = bitpair_cuda(a, b)
        want = ref.bitpair_popcount_ref(a, b)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"bitpair != plain version on {name}")
        err = max(err, max_abs_err(got, want))

    popc_per_s = SMS * POPC_PER_CLOCK_PER_SM * clock_hz

    def timed(a, b):
        M, w = a.shape
        N = b.shape[0]
        bytes_moved = 4 * (M * w + (0 if a is b else N * w) + M * N)
        # one tensor twice: the pairs n >= m give the whole symmetric output
        pairs = M * (M + 1) // 2 if a is b else M * N
        bound_ms, bound_by = bound(bytes_moved, pairs * w, popc_per_s)
        return {"shape": (M, N, w), "blocks": plan(M, N, w, a is b).blocks,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "ms": both_ms(lambda: bitpair_cuda(a, b), reps=50),
                "host_ms": host_ms(lambda: bitpair_cuda(a, b), reps=50)}

    out = timed(b0, b1)  # the headline: off the diagonal, W = 625
    out.update({
        "max_abs_err": err, "bitmap_build_s": build_s, "clock_mhz": clock_hz / 1e6,
        "diagonal": timed(b0, b0),
        "w63": timed(o0, o1),
        "w63_diagonal": timed(o0, o0),
        "plain_ms": both_ms(lambda: ref.bitpair_popcount_ref(b0, b1), reps=3),
        "library_ms": None,
    })
    return out


# --------------------------------------------------------------- phase 4
def trace_ops(prof) -> tuple[list, int]:
    """``(ops, kernels)`` of a finished profiler session that recorded the
    card's activity: ``(name, seconds)`` of each kernel, copy and fill
    summed by name, largest first, and the number of kernels. Read from its
    trace file: ``key_averages()`` takes longer than the work itself over
    10^4-10^5 events (29.8 s for one MiniCPM3-4B training step's)."""
    path = os.path.join(WORK, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    by_name: dict = {}
    kernels = 0
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e6
            kernels += e["cat"] == "kernel"
    return sorted(by_name.items(), key=lambda kv: -kv[1]), kernels


def device_busy(fn) -> tuple[float, float, list]:
    """``(wall seconds, device seconds, device ops)`` of ``fn()`` under the
    profiler, which records the card's activity only (``trace_ops``);
    device seconds sum the time of every operation on the card, and the ops
    are ``(name, seconds)``, largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ops, _ = trace_ops(prof)
    return wall, sum(t for _, t in ops), ops


def where_time_goes(c, store) -> dict:
    """Device busy share of the counting stage and of serving, and the
    host time of building a serving batch's padded tile beside the time of
    the whole top-k call (which builds it too)."""
    import numpy as np

    from repro_torch.core.list_scan import count_list_scan_segment
    from repro_torch.launch.cooc_serve import _zipf_sampler
    from repro_torch.store import QueryEngine, SpillSink

    def count():
        with SpillSink(VOCAB, spill_dir=os.path.join(WORK, "spill")) as sink:
            count_list_scan_segment(c, sink)

    out = {"count": device_busy(count)}
    eng = QueryEngine(store)
    draw = _zipf_sampler(store, SEED)
    rng = np.random.default_rng(SEED + 1)
    batches = [draw(rng, 64) for _ in range(12)]
    for terms in batches[:2]:
        eng.topk(terms, k=10, score="pmi")  # warm-up
    out["serve"] = device_busy(
        lambda: [eng.topk(t, k=10, score="pmi") for t in batches[2:]]
    )
    tile_s = total_s = 0.0
    for terms in batches[2:]:
        t0 = time.perf_counter()
        eng.tile(terms)
        t1 = time.perf_counter()
        eng.topk(terms, k=10, score="pmi")
        t2 = time.perf_counter()
        tile_s += t1 - t0
        total_s += t2 - t1
    out["tile_ms"] = tile_s / len(batches[2:]) * 1e3
    out["batch_ms"] = total_s / len(batches[2:]) * 1e3
    return out


def freq_split_time(cd) -> dict:
    """Device busy share of path 2's counting stage (``count_freq_split``
    into a SpillSink) with its kernels' device time, and, on the host clock
    in the same run, the stage and the time spent in its head Gram
    (``_head_gram``) and its tail (``_count_tail``), each between two
    synchronisations of the card."""
    import torch

    from repro_torch.core import hybrid
    from repro_torch.store import SpillSink

    def count():
        with SpillSink(VOCAB, spill_dir=os.path.join(WORK, "fs_spill")) as sink:
            hybrid.count_freq_split(cd, sink)

    spent = {"head_s": 0.0, "tail_s": 0.0}

    def timed(name, fn):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return wrapped

    head, tail = hybrid._head_gram, hybrid._count_tail
    hybrid._head_gram = timed("head_s", head)
    hybrid._count_tail = timed("tail_s", tail)
    try:
        wall, busy, ops_ = device_busy(count)
    finally:
        hybrid._head_gram, hybrid._count_tail = head, tail
    return {"count": (wall, busy, ops_), "stage_s": wall, **spent}


def driver_opt_in_time(opt_c) -> dict:
    """Device busy share and device ops of the batch driver (a fresh
    ``cooc_run`` at its defaults) and of ``list-pairs-bitpacked`` on the
    opt-in collection."""
    from repro_torch.core.cooc import dense_counts
    from repro_torch.launch import cooc_run

    return {
        "cooc_run": device_busy(
            lambda: cooc_run.run(out_dir=os.path.join(WORK, "cooc_run_prof"))),
        "list-pairs": device_busy(
            lambda: dense_counts("list-pairs-bitpacked", opt_c)),
    }


def kernel_s(ops_) -> dict:
    """Each kernel's summed device seconds among a profiled window's ops."""
    return {k: sum(t for n, t in ops_ if f"{k}_kernel" in n) for k in KERNEL_NAMES}


# ------------------------------------------------------------------ main
def run() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    # spawned workers import repro_torch from SRC: on PYTHONPATH for the
    # whole run, so that spawns from two threads (2l) find it whatever
    # order their environment patches restore in
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [SRC] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])

    from repro_torch.data.corpus import synthetic_zipf_collection
    from repro_torch.data.preprocess import remap_df_descending
    from repro_torch.kernels import _build, ops

    # phase 1: device and kernel builds
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build_s = _build.build_all(ops.KERNELS)
    print(f"[build] kernels in {time.perf_counter() - t0:.2f}s: "
          + ", ".join(f"{k} {s:.2f}s" for k, s in build_s.items()))
    for k in ops.KERNELS:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {k.name}: {line.strip()}")

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    phase_s = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        print(f"[phase] {name}: {phase_s[name]:.2f}s", flush=True)
        return out

    try:
        # phase 2: the paths
        t0 = time.perf_counter()
        c = synthetic_zipf_collection(DOCS, vocab=VOCAB, seed=SEED)
        cd, _ = remap_df_descending(c)
        print(f"[data] {DOCS} docs, V={VOCAB}, {c.num_postings} postings, "
              f"remapped by df, in {time.perf_counter() - t0:.2f}s")
        mp = phase("2a path 1 (list-scan-segment build + serving)",
                   main_path, c, ops.KERNELS)
        print(f"[main] cuda build {mp['build_s']:.2f}s "
              f"({DOCS / mp['build_s'] * 3600:.0f} docs/hour), "
              f"{mp['nnz']} distinct pairs, total count = "
              f"{mp['pair_occurrences']} pair occurrences; host list-scan "
              f"build {mp['host_build_s']:.2f}s "
              f"({DOCS / mp['host_build_s'] * 3600:.0f} docs/hour); segment "
              f"arrays identical | {smi}")
        for score, st in mp["served"].items():
            print(f"[serve] {score}: {st['topk_qps']} top-k QPS, p50 "
                  f"{st['topk_p50_ms']} ms, p99 {st['topk_p99_ms']} ms | {smi}")
        fs = phase("2b path 2 (auto -> freq-split build)", freq_split_path,
                   cd, ops.KERNELS)
        print(f"[freq-split] auto planned freq-split; cuda build "
              f"{fs['build_s']:.2f}s ({DOCS / fs['build_s'] * 3600:.0f} "
              f"docs/hour), {fs['nnz']} distinct pairs, total count = pair "
              f"occurrences; host list-scan build of the remapped collection "
              f"{fs['host_build_s']:.2f}s "
              f"({DOCS / fs['host_build_s'] * 3600:.0f} docs/hour); segment "
              f"arrays identical | {smi}")
        dr = phase("2c cooc_run driver", driver_path, ops.KERNELS)
        print(f"[cooc_run] {dr['docs']} docs, V={dr['vocab']}, {dr['shards']} "
              f"shards: planned freq-split, {dr['run_s']:.2f}s "
              f"({dr['docs'] / dr['run_s'] * 3600:.0f} docs/hour), "
              f"{dr['distinct_pairs']} distinct pairs; pairs file identical to "
              f"a host list-scan job ({dr['host_s']:.2f}s); resume "
              f"{dr['resume_s']:.2f}s, no kernel launched | {smi}")
        oi = phase("2d opt-in methods (reduced)", opt_in_path, ops.KERNELS)
        print(f"[opt-in] {OPT_DOCS} docs, V={OPT_VOCAB}, mean_len "
              f"{OPT_MEAN_LEN} ({oi['postings']} postings), each equal to host "
              f"list-scan: " + ", ".join(
                  f"{m} {t:.2f}s" for m, t in oi["secs"].items()) + f" | {smi}")
        st = phase("2e-i live store: stream ingest", live_stream, c, ops.KERNELS)
        sv = phase("2e-ii live store: serving while following, drain, compaction",
                   live_serve, st, ops.KERNELS)
        same_segments(sv["segment"].path, mp["store"].segments[0].path,
                      "the compacted live store and path 1's store")
        clean = phase("2e-iii live store: worker answers", live_answers,
                      mp["store"], None)
        killed = phase("2e-iii live store: one injected kill", live_answers,
                       mp["store"], KILL_SPEC)
        print_live(st, sv, clean, killed, smi)
        pf = phase("2f parallel path 1 (4 workers)", parallel_path, c, mp, ops.KERNELS)
        pd = phase("2g cooc_run with 4 ingest workers", parallel_driver, dr, ops.KERNELS)
        gm = phase("2h distributed Gram (2 x 2 gloo ranks)", distributed_gram_path, cd)
        print_parallel(pf, pd, gm, mp, dr, smi)
        reset(ops.KERNELS)
        lm = phase("2i LM serving at full width", lm_path)
        lm_launches = launched(ops.KERNELS, (), "LM serving")
        print_lm(lm, smi)
        reset(ops.KERNELS)
        gr = phase("2j GraphSAGE and the recsys rankers at full width", gnn_recsys_path)
        gr_launches = launched(ops.KERNELS, (), "GNN and recsys")
        print_gnn_recsys(gr, smi)
        live = {
            "segment_hist": sum(x["segment_hist"] for x in (
                st["launches"], sv["launches"], sv["drain_launches"])),
            # the workers' own counts: launches in other processes
            "topk_gather": sum(sv["workers"]) + clean["launches"] + killed["launches"],
            "cooc_gram": 0, "bitpair": 0,
        }
        paths = {"path 1": mp["launches"], "path 2": fs["launches"],
                 "cooc_run": dr["launches"], "opt-in": oi["launches"],
                 "live store": live, "parallel path 1": pf["launches"],
                 "cooc_run, 4 workers": pd["launches"], "distributed Gram": gm["launches"],
                 "LM serving": lm_launches, "GNN and recsys": gr_launches}
        for path, counts in paths.items():
            print(f"[launches] {path}: {json.dumps(counts)}")

        # phase 3: kernels against their plain versions, and their times
        sh = phase("3 segment_hist vs plain", check_segment_hist, c, cd, dr["cd"])
        tk = phase("3 topk_gather vs plain", check_topk_gather, mp["store"])
        cg = phase("3 cooc_gram vs plain", check_cooc_gram, cd, dr["cd"])
        bp = phase("3 bitpair vs plain", check_bitpair, cd, oi["c"],
                   max_sm_clock_hz())
        # phase 4: where the time goes
        wt = phase("4 where path 1's time goes", where_time_goes, c, mp["store"])
        wf = phase("4 where path 2's time goes", freq_split_time, cd)
        wd = phase("4 kernels of cooc_run and list-pairs", driver_opt_in_time,
                   oi["c"])
        # phase 2k runs last: its profiled steps launch up to ~10^5
        # kernels, and after such a session the profiler drops device
        # events of later ones (on the H100, after 150,000 kernels it lost
        # one kernel in ten of the next sessions), which phases 3 and 4
        # read
        sp = phase("2l sharding: dry run, co-occurrence shares, expert-parallel MoE",
                   sharding_path, ops.KERNELS)
        paths["cooc cells"] = sp["shares"]["launches"]
        print_sharding(sp, smi)
        reset(ops.KERNELS)
        tr = phase("2k training at full width", train_path)
        paths["training"] = launched(ops.KERNELS, (), "training")
        print(f"[launches] training: {json.dumps(paths['training'])}")
        print_train(tr, smi)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    for name, t in sh["shapes"].items():
        print(f"[segment_hist] {name}: {t['tokens']} tokens into {t['grid']}, "
              f"window {t['window'][0]} x {t['window'][1]} on {t['blocks']} "
              f"blocks of {t['span']} tokens, hit share {t['hit_share']:.2%}: "
              f"kernel {show(t['ms'])}, host work {t['host_ms']:.4f} ms a call, "
              f"bincount {show(t['library_ms'])}, bound "
              f"{t['bound_ms']:.4f} ms by bytes (tokens and "
              f"{t['nonzero_cells']} nonzero cells; {t['bound_ms'] / t['ms'][0]:.1%} "
              f"of bound, device {t['bound_ms'] / t['ms'][1]:.1%}) | {smi}")
    print(f"[segment_hist] equal to plain on all cases; head batch plain "
          f"(index_put_) {show(sh['plain_ms'])}")
    for score, t in tk["per_score"].items():
        print(f"[topk_gather] {score} B={tk['B']} L={tk['L']} k=10: kernel "
              f"{show(t['ms'])}, plain {show(t['plain_ms'])}, torch.topk "
              f"{show(t['library_ms'])}, bound {tk['bound_ms']:.4f} ms "
              f"({tk['bound_ms'] / t['ms'][0]:.1%} of bound); k=1000: kernel "
              f"{show(t['ms_k1000'])}, torch.topk {show(t['library_ms_k1000'])}, "
              f"bound {tk['bound_ms_k1000']:.4f} ms "
              f"({tk['bound_ms_k1000'] / t['ms_k1000'][0]:.1%} of bound); "
              f"k=4096: kernel {show(t['ms_k4096'])}, torch.topk "
              f"{show(t['library_ms_k4096'])}, bound {tk['bound_ms_k4096']:.4f} ms "
              f"({tk['bound_ms_k4096'] / t['ms_k4096'][0]:.1%} of bound) | {smi}")
    print(f"[cooc_gram] equal to plain on all cases; head tile (D, M, N) = "
          f"{cg['shape']}: kernel {show(cg['ms'])}, plain (float32 matmul) "
          f"{show(cg['plain_ms'])}, torch._int_mm {show(cg['library_ms'])}, "
          f"bound {cg['bound_ms']:.4f} ms by {cg['bound_by']} "
          f"({cg['bound_ms'] / cg['ms'][0]:.1%} of bound); list-blocks tile "
          f"pair (2048, 512)^2 {show(cg['ms_blocks'])} | {smi}")
    for label, t in (("cooc_run head tile", cg["run_head"]),
                     ("multi-scan pass", cg["multi_scan"])):
        print(f"[cooc_gram] {label} (D, M, N) = {t['shape']}: kernel "
              f"{show(t['ms'])}, torch._int_mm {show(t['library_ms'])}, bound "
              f"{t['bound_ms']:.4f} ms by {t['bound_by']} "
              f"({t['bound_ms'] / t['ms'][0]:.1%} of bound) | {smi}")
    print(f"[bitpair] equal to plain on all cases; plain (SWAR) on block 0 x 1 "
          f"{show(bp['plain_ms'])}, no library call; bounds at "
          f"{bp['clock_mhz']:.0f} MHz; bitmaps of the collection built on the "
          f"host in {bp['bitmap_build_s']:.2f}s")
    for label, t in (("W = 625 block 0 x 1", bp), ("W = 625 block 0 x 0", bp["diagonal"]),
                     ("W = 63 block 0 x 1", bp["w63"]),
                     ("W = 63 block 0 x 0", bp["w63_diagonal"])):
        print(f"[bitpair] {label} (M, N, W) = {t['shape']}, {t['blocks']} blocks: "
              f"kernel {show(t['ms'])}, host work {t['host_ms']:.4f} ms a call, "
              f"bound {t['bound_ms']:.4f} ms by "
              f"{t['bound_by']} ({t['bound_ms'] / t['ms'][0]:.1%} of bound, "
              f"device {t['bound_ms'] / t['ms'][1]:.1%}) | {smi}")
    for label, st in (("path 1 cuda build", mp["stages"]),
                      ("path 2 cuda build", fs["stages"])):
        stages = ", ".join(f"{n.split('/', 1)[1]} {s:.2f}s"
                           for n, s in sorted(st.items()))
        print(f"[where] {label} stages (inclusive): {stages}")
    profiled = {"path 1 counting stage": wt["count"],
                "path 2 counting stage": wf["count"],
                "serving 10 pmi batches": wt["serve"],
                "cooc_run at its defaults": wd["cooc_run"],
                "list-pairs-bitpacked (opt-in, reduced)": wd["list-pairs"]}
    path_kernel_s = {what: kernel_s(ops_) for what, (_, _, ops_) in profiled.items()}
    for what, (wall, dev, ops_) in profiled.items():
        tops = "; ".join(f"{n[:48]} {t:.4f} s" for n, t in ops_[:3])
        mine = ", ".join(f"{k} {t:.4f} s" for k, t in path_kernel_s[what].items() if t)
        print(f"[where] {what} under the profiler: wall {wall:.3f} s, device "
              f"busy {dev:.4f} s ({dev / wall:.2%}); kernels: {mine or 'none'}; "
              f"top device ops: {tops} | {smi}")
    print(f"[where] path 2 counting stage on the host clock: "
          f"{wf['stage_s']:.3f} s; head Gram {wf['head_s']:.3f} s "
          f"({wf['head_s'] / wf['stage_s']:.1%}), tail {wf['tail_s']:.3f} s "
          f"({wf['tail_s'] / wf['stage_s']:.1%}), the rest (index build, head "
          f"emission) {wf['stage_s'] - wf['head_s'] - wf['tail_s']:.3f} s, in "
          f"the profiled run | {smi}")
    print(f"[where] serving batch of 64 (pmi, k=10, rows cached): top-k call "
          f"{wt['batch_ms']:.2f} ms; building its padded tile alone on the "
          f"host {wt['tile_ms']:.2f} ms")
    pmi = tk["per_score"]["pmi"]
    shares = sp["shares"]
    total = {k.name: sum(p[k.name] for p in paths.values()) for k in ops.KERNELS}
    device_s = {k: {what: t[k] for what, t in path_kernel_s.items() if t[k]}
                for k in KERNEL_NAMES}
    kernels = [
        {
            "name": "segment_hist", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segment_hist.cu",
            "replaces": "src/repro/kernels/segment_cooc.py:72",
            "launches": total["segment_hist"],
            "max_abs_err": sh["max_abs_err"], "ms": sh["ms"][0],
            "plain_ms": sh["plain_ms"][0], "bound_ms": sh["bound_ms"],
            "bound_by": "bytes", "library_ms": sh["library_ms"][0],
            "device_ms": sh["ms"][1], "hit_share": sh["hit_share"],
            "shapes": {
                name: {"tokens": t["tokens"], "grid": t["grid"],
                       "window": t["window"], "hit_share": t["hit_share"],
                       "ms": t["ms"][0], "device_ms": t["ms"][1],
                       "host_ms": t["host_ms"], "library_ms": t["library_ms"][0],
                       "bound_ms": t["bound_ms"]}
                for name, t in sh["shapes"].items()
            } | {
                "2l tail_hist share": {
                    "tokens": shares["L"], "grid": shares["grid"], "ms": shares["hist_ms"],
                    "plain_ms": shares["hist_plain_ms"],
                    "library_ms": shares["hist_library_ms"],
                    "bound_ms": shares["hist_bound_ms"], "bound_by": "bytes"},
            },
        },
        {
            "name": "topk_gather", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/topk_gather.cu",
            "replaces": "src/repro/kernels/topk_gather.py:132",
            "launches": total["topk_gather"],
            "max_abs_err": tk["max_abs_err"], "ms": pmi["ms"][0],
            "plain_ms": pmi["plain_ms"][0], "bound_ms": tk["bound_ms"],
            "bound_by": "bytes", "library_ms": pmi["library_ms"][0],
            "device_ms": pmi["ms"][1],
            "k4096": {"ms": pmi["ms_k4096"][0], "library_ms": pmi["library_ms_k4096"][0],
                      "bound_ms": tk["bound_ms_k4096"], "bound_by": "bytes"},
        },
        {
            "name": "cooc_gram", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/cooc_gram.cu",
            "replaces": "src/repro/kernels/cooc_gram.py:60",
            "launches": total["cooc_gram"],
            "max_abs_err": cg["max_abs_err"], "ms": cg["ms"][0],
            "plain_ms": cg["plain_ms"][0], "bound_ms": cg["bound_ms"],
            "bound_by": cg["bound_by"], "library_ms": cg["library_ms"][0],
            "device_ms": cg["ms"][1],
            "shapes": {
                "2l head_gram share": {
                    "products": shares["gram"][3], "shape": shares["gram"][:3],
                    "ms": shares["gram_ms"], "library_ms": shares["gram_library_ms"],
                    "bound_ms": shares["gram_bound_ms"], "bound_by": "operations"},
            },
        },
        {
            "name": "bitpair", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bitpair.cu",
            "replaces": "src/repro/kernels/bitpair.py:50",
            "launches": total["bitpair"],
            "max_abs_err": bp["max_abs_err"], "ms": bp["ms"][0],
            "plain_ms": bp["plain_ms"][0], "bound_ms": bp["bound_ms"],
            "bound_by": bp["bound_by"], "library_ms": bp["library_ms"],
            "device_ms": bp["ms"][1], "shape": bp["shape"],
            "shapes": {
                label: {"shape": t["shape"], "blocks": t["blocks"],
                        "ms": t["ms"][0], "device_ms": t["ms"][1],
                        "host_ms": t["host_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"]}
                for label, t in (("W=625 0x1", bp), ("W=625 0x0", bp["diagonal"]),
                                 ("W=63 0x1", bp["w63"]),
                                 ("W=63 0x0", bp["w63_diagonal"]))
            },
        },
    ]
    for k in kernels:
        k["path_device_s"] = device_s[k["name"]]
    print(f"[phases] " + ", ".join(f"{n} {t:.1f}s" for n, t in phase_s.items()))
    print(smi)
    # a device time the profiler lost (NaN) is null in JSON
    print(json.dumps({"kernels": kernels}).replace("NaN", "null"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    try:
        return run()
    except Exception:  # any failed phase: report it and exit non-zero
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
