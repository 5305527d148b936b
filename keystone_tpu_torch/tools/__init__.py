"""Measurement tools for the port's kernels, run on a CUDA card."""
from __future__ import annotations

import torch


def device_ms(fn, reps=10):
    """Device milliseconds of one ``fn()``: ``reps`` calls captured in a
    CUDA graph and replayed (best of 5 replays, CUDA events), so the
    host's time in the wrappers, which exceeds the device time of small
    launches, is left out. ``fn`` is warmed once before the capture."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    del graph
    return best
