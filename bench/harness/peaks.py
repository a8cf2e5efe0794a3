"""Published peaks of one NVIDIA H100 SXM5 80 GB: NVIDIA's data sheet,
dense rates without sparsity, at the full 700 W power limit (a card set
below it runs slower under load; every run records the card's limit).
The values are those of `repro_torch/roofline/hw.py`, copied so that the
yardstick cannot move with the program."""

PEAK_FLOPS_F32 = 67e12      # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12            # B/s, HBM3


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take for work of `flops` float32
    operations that must move `nbytes` through HBM: the larger of the two
    terms."""
    return max(flops / PEAK_FLOPS_F32, nbytes / HBM_BW)
