"""Real neighbor sampler for GraphSAGE minibatch training.

CSR adjacency + uniform fixed-fanout sampling with replacement (the paper's
setting). Host-side numpy (the sampler is a data-pipeline stage; sampled
blocks are what ship to the device). A copy of the reference package's
``data/sampler.py``: the same ``np.random.Generator`` calls in the same
order, so equal seeds give equal graphs and blocks in both packages.
:func:`random_graph_on_device` draws the same numbers and does the search
and the sort on a device, for graphs of 10^8 edges.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    indptr: np.ndarray   # int64[N+1]
    indices: np.ndarray  # int32[E]

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return int(self.indptr[-1])

    def degree(self) -> np.ndarray:
        return np.diff(self.indptr)


def csr_from_edge_index(edge_index: np.ndarray, num_nodes: int) -> CSRGraph:
    src, dst = edge_index
    order = np.argsort(dst, kind="stable")
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    counts = np.bincount(dst, minlength=num_nodes)
    np.cumsum(counts, out=indptr[1:])
    return CSRGraph(indptr, src[order].astype(np.int32))


def random_graph(num_nodes: int, avg_degree: int, seed: int = 0) -> CSRGraph:
    """Power-law-ish random graph for tests/benchmarks."""
    rng = np.random.default_rng(seed)
    n_edges = num_nodes * avg_degree
    # preferential-attachment-flavoured degree skew
    w = rng.zipf(1.5, size=num_nodes).astype(np.float64)
    w /= w.sum()
    src = rng.choice(num_nodes, size=n_edges, p=w).astype(np.int32)
    dst = rng.integers(0, num_nodes, size=n_edges).astype(np.int32)
    return csr_from_edge_index(np.stack([src, dst]), num_nodes)


def random_graph_on_device(num_nodes: int, avg_degree: int, seed: int = 0,
                           device="cuda") -> CSRGraph:
    """:func:`random_graph`'s arrays, equal for equal seeds. The host draws
    the same numbers from the same generator (``Generator.choice`` with
    ``p`` is a right-side search of ``rng.random`` in the normalised
    cumulative weights); the search, the stable sort by destination and the
    degree count run on ``device`` (the card unless the caller says so)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_edges = num_nodes * avg_degree
    w = rng.zipf(1.5, size=num_nodes).astype(np.float64)
    w /= w.sum()
    cdf = w.cumsum()
    cdf /= cdf[-1]
    u = torch.from_numpy(rng.random(n_edges)).to(dev)
    src = torch.searchsorted(torch.from_numpy(cdf).to(dev), u, right=True).to(torch.int32)
    del u
    dst = torch.from_numpy(rng.integers(0, num_nodes, size=n_edges).astype(np.int32)).to(dev)
    indptr = torch.zeros(num_nodes + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(dst, minlength=num_nodes), 0, out=indptr[1:])
    order = torch.sort(dst, stable=True).indices
    return CSRGraph(indptr.cpu().numpy(), src[order].cpu().numpy())


def sample_neighbors(
    g: CSRGraph, seeds: np.ndarray, fanout: int, rng: np.random.Generator
) -> np.ndarray:
    """(len(seeds), fanout) uniform-with-replacement neighbor sample.
    Isolated nodes self-loop (standard GraphSAGE practice)."""
    lo = g.indptr[seeds]
    deg = g.indptr[seeds + 1] - lo
    r = rng.integers(0, np.maximum(deg, 1)[:, None], size=(len(seeds), fanout))
    idx = lo[:, None] + r
    out = g.indices[np.minimum(idx, len(g.indices) - 1)]
    return np.where(deg[:, None] > 0, out, seeds[:, None].astype(np.int32))


def sample_blocks(
    g: CSRGraph,
    seeds: np.ndarray,
    fanouts: tuple,
    rng: np.random.Generator,
):
    """Multi-hop blocks: returns [seeds (B,), hop1 (B,f1), hop2 (B,f1,f2), ...]."""
    blocks = [seeds.astype(np.int32)]
    frontier = seeds.astype(np.int32)
    shape = (len(seeds),)
    for f in fanouts:
        nbrs = sample_neighbors(g, frontier.reshape(-1), f, rng)
        shape = shape + (f,)
        blocks.append(nbrs.reshape(shape))
        frontier = nbrs.reshape(-1)
    return blocks
