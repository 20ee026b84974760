"""Data substrate: corpora, preprocessing, host and device indexes."""

from repro_torch.data.corpus import Collection, synthetic_zipf_collection, collection_stats
from repro_torch.data.index import DeviceIndex, InvertedIndex, build_inverted_index, incidence_dense, incidence_bitpacked
from repro_torch.data.preprocess import preprocess_documents, remap_df_descending

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
]
