"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W)."""
BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the chip could take: bytes at the HBM rate or
    operations at the bf16 tensor-core rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S)
