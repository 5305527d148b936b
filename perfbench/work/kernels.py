"""The program's own CUDA kernels, by name: every ``__global__`` function
of ``keystone_tpu_torch/csrc/*.cu`` when the benchmark was written.

``library_device_ms`` counts the device time of every kernel that is not
one of these. The list is frozen here, with the counts, so that a kernel
added to or renamed in the program does not change what the metric
measures: a change to it is a change to the benchmark.
"""
from __future__ import annotations

HAND_WRITTEN = (
    "banded2_kernel",
    "banded_matmul_kernel",
    "fused_featurize_kernel",
    "fv_moments_kernel",
    "gram_cross_kernel",
    "quantized_affine_kernel",
    "reduce_uncenter_kernel",
)
