"""Hand-written CUDA kernels (counterpart of ``slate_tpu/ops/``)."""
