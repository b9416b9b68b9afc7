"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit). A share of a peak is stated against these,
with the card's power limit beside it."""

HBM_BYTES_PER_S = 3.35e12        # HBM3
F32_FLOPS = 67e12                # float32 outside the tensor cores
TF32_FLOPS = 495e12              # TF32 on the tensor cores
FLOPS = {"float32": F32_FLOPS, "tf32": TF32_FLOPS}


def least_seconds(flops: float, nbytes: float, computed_in: str) -> float:
    """The least time the chip could take for work of ``flops`` operations
    computed in ``computed_in`` and ``nbytes`` bytes moved: the larger of
    the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOPS[computed_in])
