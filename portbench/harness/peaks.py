"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data
sheet, dense rates, at the full 700 W power limit.  A card set to a
lower limit runs below them; every run prints the card's limit."""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12          # float32 outside the tensor cores
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12


def least_seconds(nbytes: float, ops: float = 0.0,
                  ops_per_s: float = FP32_OPS_PER_S) -> float:
    """The least time the card could take: the larger of the bytes at
    the memory bandwidth and the operations at the compute peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)
