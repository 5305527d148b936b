"""Frozen operation and byte counts, and the card's peaks.

Operations are the algorithm's own, a multiply-add counting two, with no
credit for a split into several lower-precision products; bytes count
each input read once and each output written once. The counts follow
the configuration's algorithm, not an implementation of it, so no later
kernel can push a share of a peak past 100%.

The peaks are the H100 SXM's published dense rates: 495 TFLOP/s of TF32
on the tensor cores, the fastest the card multiplies float32 inputs, and
3.35 TB/s of HBM3.
"""
from __future__ import annotations

PEAK_FLOPS = 495e12
PEAK_BYTES = 3.35e12


def roofline_share(flops: float, nbytes: float, seconds: float) -> float:
    """The least time the card could take for the work, over ``seconds``,
    in percent."""
    return 100.0 * max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) / seconds


def mfu(flops: float, seconds: float) -> float:
    """``flops`` in ``seconds`` as a percentage of the TF32 peak."""
    return 100.0 * flops / (seconds * PEAK_FLOPS)
