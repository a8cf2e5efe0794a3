from repro_torch.models.dlrm import DLRM, DLRMConfig

__all__ = ["DLRM", "DLRMConfig"]
