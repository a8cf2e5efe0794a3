from repro_torch.data.pipeline import (HETERO_MIXES, DLRMBatch,
                                       DLRMQueryStream, TokenStream)

__all__ = ["HETERO_MIXES", "DLRMBatch", "DLRMQueryStream", "TokenStream"]
