"""GraphSAGE (Reddit config): 2 layers, d_hidden=128, mean aggregator,
sample sizes 25-10 [arXiv:1706.02216]. Each shape cell carries its own
d_feat / graph size; the dry-run overrides d_in per shape."""

import dataclasses

from repro_torch.configs import ArchSpec, ShapeSpec
from repro_torch.models.gnn import GNNConfig

CONFIG = GNNConfig(
    name="graphsage-reddit",
    n_layers=2,
    d_in=602,          # Reddit features (overridden per shape)
    d_hidden=128,
    n_classes=41,
    aggregator="mean",
    sample_sizes=(25, 10),
)

SHAPES = {
    "full_graph_sm": ShapeSpec(
        "full_graph_sm", "full_graph",
        dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7),
    ),
    "minibatch_lg": ShapeSpec(
        "minibatch_lg", "sampled",
        dict(
            n_nodes=232965, n_edges=114615892, batch_nodes=1024,
            fanout=(15, 10), d_feat=602, n_classes=41,
        ),
    ),
    "ogb_products": ShapeSpec(
        "ogb_products", "full_graph",
        dict(n_nodes=2449029, n_edges=61859140, d_feat=100, n_classes=47),
    ),
    "molecule": ShapeSpec(
        "molecule", "batched_graphs",
        dict(n_nodes=30, n_edges=64, batch=128, d_feat=16, n_classes=2),
    ),
}


def smoke():
    return dataclasses.replace(
        CONFIG, name="graphsage-smoke", d_in=32, d_hidden=16, n_classes=5,
        sample_sizes=(5, 3),
    )


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="graphsage-reddit",
        family="gnn",
        model=CONFIG,
        shapes=SHAPES,
        smoke=smoke,
        notes="Message passing = edge gather + segment_sum (no SpMM in JAX); "
        "minibatch_lg uses the real fixed-fanout sampler in data/sampler.py.",
    )
