from .kernel import last_launch_info, mips_topk, mips_topk_cuda
from .ref import mips_topk_ref, scores_ref

__all__ = ["last_launch_info", "mips_topk", "mips_topk_cuda",
           "mips_topk_ref", "scores_ref"]
