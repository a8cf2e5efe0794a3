from .kernel import (JaggedLayout, hstu_attention, hstu_attention_cuda,
                     hstu_time_codes, last_launch_info, time_codes_cuda)
from .ref import (bucket_thresholds, hstu_attention_ref, time_bucket,
                  time_codes_ref)

__all__ = ["JaggedLayout", "hstu_attention", "hstu_attention_cuda",
           "hstu_time_codes", "last_launch_info", "time_codes_cuda",
           "bucket_thresholds", "hstu_attention_ref", "time_bucket",
           "time_codes_ref"]
