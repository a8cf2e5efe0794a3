"""NVIDIA H100 SXM5 80 GB constants for the roofline model.

Source: NVIDIA's H100 Tensor Core GPU data sheet, SXM5 column (dense rates,
without sparsity, at the full 700 W power limit; a card set below it runs
slower under load), and the Hopper architecture whitepaper for the on-chip
sizes.
"""

PEAK_FLOPS_BF16 = 989e12       # FLOP/s, bf16/fp16 tensor cores, dense
PEAK_FLOPS_F32 = 67e12         # FLOP/s, f32 outside the tensor cores
HBM_BW = 3.35e12               # B/s, HBM3
HBM_BYTES = 80 * 10**9         # 80 GB of HBM3
NVLINK_BW = 900e9              # B/s, NVLink 4, both directions together
NVLINK_BW_PER_DIRECTION = 450e9
L2_BYTES = 50 * 2**20          # 50 MB L2
SMEM_BYTES_PER_SM = 228 * 2**10   # shared memory carve-out per SM
NUM_SMS = 132

DTYPE_BYTES = {
    "float64": 8, "float32": 4, "float16": 2, "bfloat16": 2,
    "float8_e4m3fn": 1, "float8_e5m2": 1,
    "int64": 8, "int32": 4, "int16": 2, "int8": 1,
    "uint64": 8, "uint32": 4, "uint16": 2, "uint8": 1,
    "bool": 1, "complex64": 8, "complex128": 16,
}
