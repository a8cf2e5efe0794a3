from .kernel import (JaggedLayout, hstu_attention, hstu_attention_cuda,
                     last_launch_info)
from .ref import bucket_thresholds, hstu_attention_ref, time_bucket

__all__ = ["JaggedLayout", "hstu_attention", "hstu_attention_cuda",
           "last_launch_info", "bucket_thresholds", "hstu_attention_ref",
           "time_bucket"]
