"""The table of peaks the shares are taken against.

One NVIDIA H100 SXM, from NVIDIA's data sheet: dense bf16 products
989 TFLOP/s (no sparsity) and 3.35 TB/s of HBM3, both at the full 700 W
power limit. A card set below it runs slower under load; every result line
carries the card's power limit beside its shares.
"""

H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of operations over
    the peak rate and bytes over the peak bandwidth."""
    return max(flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES_S)
