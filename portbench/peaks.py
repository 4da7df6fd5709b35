"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates):
float32 outside the tensor cores and HBM3 bandwidth. They assume the card's
full 700 W; each run prints the card's power limit beside them."""

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def roofline_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)
