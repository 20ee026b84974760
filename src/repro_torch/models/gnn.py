"""GraphSAGE (mean aggregator) — full-graph and sampled-minibatch modes.

The counterpart of the reference package's ``models/gnn.py``. Message
passing is an edge-index gather and a ``segment_sum`` scatter
(``index_add_``, with the reference's rule for segment ids out of range);
the minibatch mode takes the fixed-fanout blocks of
``repro_torch.data.sampler`` with their features gathered.

:class:`GraphSAGE` holds the parameters under the reference's leaf names
(``layer0.w_self``, ``layer0.w_neigh``, ``layer0.b``, …, ``head.w``,
``head.b``); the forward functions and losses take it, as the LM's take a
``TransformerLM``. Gradients come from autograd through these functions
(``launch/train.py``'s step factories); a caller that only serves runs them
under ``torch.inference_mode``, so that no graph is built.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.layers import clip_rows, segment_sum, take_along
from repro_torch.models.params import ParamTree


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int = 2
    d_in: int = 602
    d_hidden: int = 128
    n_classes: int = 41
    aggregator: str = "mean"
    sample_sizes: tuple = (25, 10)
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def param_shapes(cfg: GNNConfig) -> dict:
    shapes = {}
    d_prev = cfg.d_in
    for l in range(cfg.n_layers):
        shapes[f"layer{l}"] = {
            "w_self": (d_prev, cfg.d_hidden),
            "w_neigh": (d_prev, cfg.d_hidden),
            "b": (cfg.d_hidden,),
        }
        d_prev = cfg.d_hidden
    shapes["head"] = {"w": (d_prev, cfg.n_classes), "b": (cfg.n_classes,)}
    return shapes


class GraphSAGE(ParamTree):
    """The parameters of one GraphSAGE model, allocated uninitialised in
    ``cfg``'s dtype on ``device`` (the card unless the caller says so;
    ``repro_torch.device.DeviceError`` without one). :func:`init_params`
    or ``repro_torch.convert.gnn_params_from_numpy`` fills them."""

    def __init__(self, cfg: GNNConfig, device="cuda"):
        super().__init__(param_shapes(cfg), cfg.torch_dtype, resolve_device(device))
        self.cfg = cfg


def init_params(cfg: GNNConfig, generator: torch.Generator, device="cuda") -> GraphSAGE:
    """A :class:`GraphSAGE` by the reference's rule: biases zero, every
    matrix ``normal · shape[0]^-½``, drawn in float32 from ``generator``
    (which must live on ``device``) and cast. The random streams are
    torch's, not JAX's."""
    model = GraphSAGE(cfg, device)
    with torch.no_grad():
        for _, t in model.named_parameters():
            if t.dim() == 1:
                t.zero_()
            else:
                scale = (1.0 / t.shape[0]) ** 0.5
                t.copy_(torch.randn(t.shape, generator=generator, device=t.device) * scale)
    return model


def _sage_layer(p, h: torch.Tensor, h_neigh: torch.Tensor) -> torch.Tensor:
    out = F.relu(h @ p["w_self"] + h_neigh @ p["w_neigh"] + p["b"])
    # GraphSAGE L2 normalization
    norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
    return out / torch.clamp(norm, min=1e-6)


# edges whose messages are gathered at a time: bounds the (chunk, d)
# message buffer (2.1 GB at d = 128) where one (E, d) gather would take
# 31 GB at ogbn-products' 61M edges; the sum is the same
EDGE_CHUNK = 1 << 22


def _mean_layers(params: GraphSAGE, feats, edge_index, cfg: GNNConfig) -> torch.Tensor:
    """The node embeddings after every layer: each layer's neighbour input
    is the mean of its in-neighbours' ``h`` (messages flow src → dst;
    ``h[src]`` clamps, a dst out of range is dropped)."""
    n = feats.shape[0]
    src, dst = edge_index[0], edge_index[1]
    deg = segment_sum(torch.ones_like(dst, dtype=torch.float32), dst, n)
    deg = torch.clamp(deg, min=1.0)[:, None]
    h = feats.to(cfg.torch_dtype)
    for l in range(cfg.n_layers):
        msg = segment_sum(lambda lo, hi: clip_rows(h, src[lo:hi]), dst, n, EDGE_CHUNK)
        h = _sage_layer(params[f"layer{l}"], h, (msg / deg).to(cfg.torch_dtype))
    return h


def forward_full_graph(params: GraphSAGE, feats, edge_index, cfg: GNNConfig) -> torch.Tensor:
    """feats: (N, F); edge_index: (2, E) int rows (src, dst). Messages flow
    src → dst; mean aggregation via two segment sums (sum / degree)."""
    h = _mean_layers(params, feats, edge_index, cfg)
    return h @ params["head"]["w"] + params["head"]["b"]


def forward_sampled(params: GraphSAGE, seed_feats, hop1_feats, hop2_feats,
                    cfg: GNNConfig) -> torch.Tensor:
    """Two-layer fixed-fanout minibatch forward: seed_feats (B, F),
    hop1_feats (B, f1, F), hop2_feats (B, f1, f2, F). Aggregation is the
    mean over the fanout axes (GraphSAGE with sampling, arXiv:1706.02216
    Alg. 2)."""
    if cfg.n_layers != 2:
        raise ValueError(f"forward_sampled is two-layer; cfg has {cfg.n_layers}")
    dt = cfg.torch_dtype
    hop1 = hop1_feats.to(dt)
    # layer 0 applied at hop-1 nodes: aggregate hop-2 neighborhoods
    h1 = _sage_layer(params["layer0"], hop1, hop2_feats.to(dt).mean(dim=2))  # (B, f1, H)
    h0 = _sage_layer(params["layer0"], seed_feats.to(dt), hop1.mean(dim=1))  # (B, H)
    # layer 1 at seeds: aggregate transformed hop-1
    h = _sage_layer(params["layer1"], h0, h1.mean(dim=1))
    return h @ params["head"]["w"] + params["head"]["b"]


def forward_batched_graphs(params: GraphSAGE, feats, edge_index, graph_ids,
                           cfg: GNNConfig, n_graphs: int) -> torch.Tensor:
    """Batched small graphs (molecule shape): one big disjoint graph, then
    the mean of node embeddings per graph → graph logits."""
    n = feats.shape[0]
    h = _mean_layers(params, feats, edge_index, cfg)
    pooled = segment_sum(h, graph_ids, n_graphs)
    sizes = segment_sum(torch.ones_like(graph_ids, dtype=torch.float32), graph_ids, n_graphs)
    pooled = pooled / torch.clamp(sizes, min=1.0)[:, None]
    return pooled @ params["head"]["w"] + params["head"]["b"]


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -take_along(logp, labels[:, None], -1)[:, 0]


def loss_full_graph(params, feats, edge_index, labels, label_mask, cfg: GNNConfig):
    ce = _nll(forward_full_graph(params, feats, edge_index, cfg), labels)
    return (ce * label_mask).sum() / torch.clamp(label_mask.sum(), min=1.0)


def loss_batched_graphs(params, feats, edge_index, graph_ids, labels, cfg: GNNConfig,
                        n_graphs: int):
    logits = forward_batched_graphs(params, feats, edge_index, graph_ids, cfg, n_graphs)
    return _nll(logits, labels).mean()


def loss_sampled(params, seed_feats, hop1_feats, hop2_feats, labels, cfg: GNNConfig):
    return _nll(forward_sampled(params, seed_feats, hop1_feats, hop2_feats, cfg),
                labels).mean()
