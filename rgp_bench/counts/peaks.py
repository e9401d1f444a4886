"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no
sparsity), at its full power limit of 700 W. A run on a card set below it
records the card's limit beside its numbers."""

# operations per second by the precision a contraction runs in
OPS_PER_S = {"bfloat16": 989e12, "int8": 1979e12}
BYTES_PER_S = 3.35e12
CARD = "NVIDIA H100 80GB HBM3"


def least_seconds(ops: float, nbytes: float, precision: str) -> float:
    """The least time the chip could take: the larger of the operations
    over the precision's peak and the bytes over the memory rate."""
    return max(ops / OPS_PER_S[precision], nbytes / BYTES_PER_S)
