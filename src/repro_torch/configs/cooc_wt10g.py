"""The paper's own workload: WT10G-scale co-occurrence counting
(1.69M docs, 5.75M vocab, 74.1B distinct pairs — Table 1 rightmost column).

The dry-run runs the distributed FREQ-SPLIT steps: the dense-head Gram
accumulation (``cooc_gram``) and the sparse-tail histogram
(``segment_hist``).

One field differs from the reference's config on purpose: ``dtype``. The
port's Gram takes uint8 0/1 incidence and counts in exact int32
(``core/distributed.py``), where the reference multiplies bfloat16
(float32 in the smoke config)."""

import dataclasses

from repro_torch.configs import ArchSpec, ShapeSpec


@dataclasses.dataclass(frozen=True)
class CoocConfig:
    name: str
    num_docs: int
    vocab_size: int
    head: int                 # FREQ-SPLIT head size (df-descending IDs)
    doc_chunk: int            # documents per device-side Gram accumulation
    schedule: str = "ring"    # "ring" | "allgather"
    dtype: str = "uint8"      # the incidence's dtype; the Gram is int32


CONFIG = CoocConfig(
    name="cooc-wt10g",
    num_docs=1_691_666,
    vocab_size=5_750_000,
    head=65_536,
    doc_chunk=524_288,
)

SHAPES = {
    "head_gram": ShapeSpec(
        "head_gram", "cooc_gram", dict(doc_chunk=524_288, head=65_536)
    ),
    "tail_hist": ShapeSpec(
        "tail_hist", "cooc_hist",
        dict(postings_chunk=8_388_608, rows=256, vocab_tile=65_536),
    ),
}


def smoke():
    return dataclasses.replace(
        CONFIG, name="cooc-smoke", num_docs=512, vocab_size=256, head=32,
        doc_chunk=128,
    )


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="cooc-wt10g",
        family="cooc",
        model=CONFIG,
        shapes=SHAPES,
        smoke=smoke,
        notes="C = Σ_s B_sᵀ B_s; docs shard over (pod, data), vocab tiles "
        "over model; ring collective-permute schedule overlaps comm/compute.",
    )
