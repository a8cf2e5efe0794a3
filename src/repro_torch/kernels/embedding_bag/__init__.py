from .kernel import EmbeddingBagOpts, embedding_bag_cuda
from .ops import embedding_bag, embedding_lookup, resolve_backend
from .ref import (embedding_bag_ragged_ref, embedding_bag_ref,
                  embedding_lookup_ref, summation_bound)

__all__ = [
    "EmbeddingBagOpts", "embedding_bag_cuda", "embedding_bag",
    "embedding_lookup", "resolve_backend", "embedding_bag_ref",
    "embedding_bag_ragged_ref", "embedding_lookup_ref", "summation_bound",
]
