from .fused import (MISS, PAD, FusedLookupOpts, FusedLookupResult,
                    complete_miss_bags, fused_warm_lookup,
                    fused_warm_lookup_plain, fused_warm_lookup_tables,
                    mean_epilogue, pool_bag_rows)
from .grad import EmbeddingBagFunction, embedding_bag_backward
from .kernel import (EmbeddingBagOpts, RaggedLayout, embedding_bag_cuda,
                     embedding_bag_ragged_cuda)
from .ops import embedding_bag, embedding_lookup, resolve_backend
from .ref import (embedding_bag_ragged_ref, embedding_bag_ref,
                  embedding_lookup_ref, ragged_tables_bag_ref,
                  summation_bound)

__all__ = [
    "EmbeddingBagOpts", "embedding_bag_cuda", "EmbeddingBagFunction",
    "RaggedLayout", "embedding_bag_ragged_cuda", "ragged_tables_bag_ref",
    "embedding_bag_backward", "embedding_bag",
    "embedding_lookup", "resolve_backend", "embedding_bag_ref",
    "embedding_bag_ragged_ref", "embedding_lookup_ref", "summation_bound",
    "MISS", "PAD", "FusedLookupOpts", "FusedLookupResult",
    "fused_warm_lookup", "fused_warm_lookup_plain",
    "fused_warm_lookup_tables", "complete_miss_bags", "pool_bag_rows",
    "mean_epilogue",
]
