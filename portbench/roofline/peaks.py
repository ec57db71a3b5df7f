"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
without sparsity, at the full 700 W power limit). Copied from
``chip_smoke.py`` (``PEAK_F32_FLOPS``, ``PEAK_BF16_FLOPS``,
``PEAK_BYTES``). A card set below 700 W runs slower under load; the
benchmark reports its ``power.limit`` beside the numbers."""

#: float32 outside the tensor cores (the hand kernels' f32 arithmetic)
F32_FLOPS = 67e12
#: bfloat16 on the tensor cores
BF16_FLOPS = 989e12
#: HBM3
BYTES = 3.35e12

_FLOPS = {"float32": F32_FLOPS, "bfloat16": BF16_FLOPS}
_ELEMENT = {"float32": 4, "bfloat16": 2}


def flops_peak(dtype: str) -> float:
    return _FLOPS[dtype]


def element_size(dtype: str) -> int:
    return _ELEMENT[dtype]


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """Least time for the work: the larger of operations over the peak of
    `dtype` and bytes over the memory rate (``chip_smoke.bound_ms``)."""
    return max(flops / flops_peak(dtype), nbytes / BYTES)
