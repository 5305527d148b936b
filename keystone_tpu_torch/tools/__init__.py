"""Measurement helpers for the port's tools.

``device_ms`` times device work alone (a CUDA graph replayed between CUDA
events). ``timeit`` times a call as its caller waits for it: wall
seconds, each timed region closed by ``torch.cuda.synchronize()`` where
the result (or the process) holds CUDA work, so that a launch queued but
not finished is not counted as done. ``device_tensors`` finds the tensors
behind a result, fitted models included (their tensors are attributes,
not containers' items).
"""
from __future__ import annotations

import time

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


def device_name(dev: torch.device) -> str:
    """The card's name, or ``"cpu"``: what a tool's readings were taken
    on."""
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")


def device_tensors(obj, _seen=None):
    """The tensors reachable from ``obj``: ``obj`` itself, the items of
    dicts, lists and tuples, and the attributes of objects (a fitted
    model holds its tensors as attributes), each object visited once."""
    if _seen is None:
        _seen = set()
    if id(obj) in _seen:
        return []
    _seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        vals = obj.values()
    elif isinstance(obj, (list, tuple)):
        vals = obj
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        vals = vars(obj).values()
    else:
        return []
    out = []
    for v in vals:
        out.extend(device_tensors(v, _seen))
    return out


def fence(obj=None) -> None:
    """Wait for the device work behind ``obj``: every CUDA device its
    tensors lie on is synchronized, and the current CUDA device whenever
    the process has started CUDA (a result may hold no tensor while its
    producer's launches are still queued). On the CPU nothing waits."""
    devices = {t.device for t in device_tensors(obj) if t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    if not devices and torch.cuda.is_available() \
            and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(fn, *args, iters=3):
    """Mean wall seconds per call of ``fn(*args)`` over ``iters``
    back-to-back calls, after one warm call; the warm call and the timed
    region each end with :func:`fence`."""
    fence(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args)
    fence(out)
    return (time.perf_counter() - t0) / iters
