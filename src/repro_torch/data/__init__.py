"""Data substrate: corpora, preprocessing, host and device indexes, samplers."""

from repro_torch.data.corpus import Collection, synthetic_zipf_collection, collection_stats
from repro_torch.data.index import DeviceIndex, InvertedIndex, build_inverted_index, incidence_dense, incidence_bitpacked
from repro_torch.data.preprocess import preprocess_documents, remap_df_descending
from repro_torch.data.sampler import CSRGraph, csr_from_edge_index, random_graph, random_graph_on_device, sample_blocks, sample_neighbors

__all__ = [
    "Collection",
    "synthetic_zipf_collection",
    "collection_stats",
    "DeviceIndex",
    "InvertedIndex",
    "build_inverted_index",
    "incidence_dense",
    "incidence_bitpacked",
    "preprocess_documents",
    "remap_df_descending",
    "CSRGraph",
    "csr_from_edge_index",
    "random_graph",
    "random_graph_on_device",
    "sample_neighbors",
    "sample_blocks",
]
