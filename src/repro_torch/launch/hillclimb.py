"""Hillclimb: re-run a dry-run cell under config variants and record
the roofline deltas (hypothesis → change → before → after).

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell qwen-decode
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --all

The counterpart of the reference's ``launch/hillclimb.py``, with its
experiments (names, cells and overrides); each hypothesis is stated for
the port's layouts on H100s and is tested by the port's own dry run
(``launch/dryrun.py``), whose per-rank terms are the predictions.
"""

from __future__ import annotations

import argparse

from repro_torch.launch.dryrun import run_cell

# Each experiment: (name, arch, shape, multi_pod, cell_kw, hypothesis)
EXPERIMENTS = {
    # ---- dense 110B training ---------------------------------------------
    "qwen-train": [
        (
            "baseline",
            "qwen1.5-110b", "train_4k", False, {},
            "DTensor resolves the FSDP-sharded contraction dimension as it "
            "finds cheapest op by op; where it keeps the weights sharded, "
            "(B, S, ff)-sized partial outputs are all-reduced over data.",
        ),
        (
            "zero3-weight-gather",
            "qwen1.5-110b", "train_4k", False,
            {"overrides": {"zero3_gather_weights": True}},
            "Lay each layer's weights out (replicated, model) at the use "
            "point: one all-gather of the weight shard over data per layer "
            "(ZeRO-3) instead of activation-sized all-reduces; expect the "
            "all-reduce bytes of the baseline to turn into fewer all-gather "
            "bytes.",
        ),
        (
            "zero3 + bf16-attn-scores",
            "qwen1.5-110b", "train_4k", False,
            {"overrides": {"zero3_gather_weights": True, "kv_chunk": 4096}},
            "Larger attention blocks (4096 vs 1024) cut the number of "
            "online-softmax rescale passes (fewer, larger local ops: fewer "
            "bytes per score), at a larger live score block per rank.",
        ),
    ],
    # ---- decode at 500k context -------------------------------------------
    "qwen-decode": [
        (
            "baseline",
            "qwen1.5-110b", "long_500k", False, {},
            "The FSDP layout gathers the d_model-sharded weight shards for "
            "every decoded token (about the layer's parameters over model "
            "parallelism, per step).",
        ),
        (
            "dshard-activations",
            "qwen1.5-110b", "long_500k", False,
            {"overrides": {"shard_decode_dmodel": True}},
            "2D tensor-parallel serving: keep the decode activations "
            "d_model-sharded over the data axes so the contractions run on "
            "the local weight shards and only (B, 1, ·) partials are "
            "all-reduced; expect the all-gather bytes to fall.",
        ),
    ],
    # ---- the paper's own technique: distributed Gram ---------------------
    "cooc-gram": [
        (
            "allgather (paper-faithful LIST-BLOCKS)",
            "cooc-wt10g", "head_gram", False,
            {"overrides": {"schedule": "allgather"}},
            "One all-gather of the full right operand before the local "
            "product: the bytes move in one burst, and a rank holds all V "
            "columns of its doc block.",
        ),
        (
            "ring (beyond-paper)",
            "cooc-wt10g", "head_gram", False,
            {"overrides": {"schedule": "ring"}},
            "Rotate the V/16 column blocks with point-to-point sends: the "
            "same bytes, as collective-permute instead of all-gather, which "
            "can overlap the block products; O(V_loc) columns live instead "
            "of O(V).",
        ),
        (
            "ring + half doc chunk",
            "cooc-wt10g", "head_gram", False,
            {"overrides": {"schedule": "ring", "doc_chunk": 262144}},
            "Halving the doc chunk halves each rank's block and its products; "
            "the bytes moved per processed document stay the same, so expect "
            "half the collective bytes per call.",
        ),
    ],
    # ---- MoE training ----------------------------------------------------
    "deepseek-train": [
        (
            "baseline",
            "deepseek-v3-671b", "train_4k", False, {},
            "The expert-parallel combine all-reduces a float32 (T, d) "
            "output per MoE layer over 'model'.",
        ),
        (
            "bf16-combine",
            "deepseek-v3-671b", "train_4k", False,
            {"overrides": {"moe_combine_dtype": "bfloat16"}},
            "Cast the combined expert output to bf16 before the all-reduce: "
            "half the MoE all-reduce bytes; only the k-way weighted sum "
            "loses its float32 carry.",
        ),
        (
            "capacity-1.0",
            "deepseek-v3-671b", "train_4k", False,
            {"overrides": {"capacity_factor": 1.0}},
            "Capacity factor 1.25 → 1.0 shrinks every expert's slots by a "
            "fifth: expert matmul FLOPs and buffer bytes fall about 20%; the "
            "quality cost of more drops is not visible to a dry run.",
        ),
    ],
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=sorted(EXPERIMENTS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/hillclimb_torch.jsonl")
    args = ap.parse_args(argv)
    names = sorted(EXPERIMENTS) if args.all else [args.cell]
    for name in names:
        for variant, arch, shape, mp, kw, hyp in EXPERIMENTS[name]:
            print(f"\n=== {name} / {variant} ===\nhypothesis: {hyp}")
            run_cell(
                arch, shape, mp, args.out,
                extra={"experiment": name, "variant": variant, "hypothesis": hyp},
                cell_kw=kw,
            )


if __name__ == "__main__":
    main()
