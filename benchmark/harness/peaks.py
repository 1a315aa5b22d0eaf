"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W limit): the yardstick of every roofline share."""

HBM_BYTES_S = 3.35e12
TF32_FLOPS = 495e12  # tensor cores: the ceiling a tensor-core redesign could reach
FP32_FLOPS = 67e12  # outside the tensor cores


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time for ``flops`` and ``nbytes``: the larger of the two
    bounds at the peaks above."""
    return max(flops / TF32_FLOPS, nbytes / HBM_BYTES_S)
