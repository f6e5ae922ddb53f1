"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data
sheet, dense rates, at the full 700 W power limit. The run reports the
card's power limit beside every roofline share (``device.power_limit_w``).
"""

HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12


def floor_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over
    the bf16 tensor peak and bytes over the memory bandwidth."""
    return max(flops / BF16_TENSOR_FLOPS, nbytes / HBM_BYTES_PER_S)


def nn_bytes(m: int, n: int, k: int) -> int:
    """The bytes of one exact 1-NN problem, each read or written once:
    float32 refs and queries, and an (index, distance) answer per query."""
    return 4 * n * k + 4 * m * k + 8 * m
