"""The traced run: ``torch.profiler`` over the window's first units, and
the reduction of its trace to device intervals, the idle share and the
breakdown that the per-layer readers (``metrics/``) read.

The profiler's trace is written as a Chrome trace under
``perfbench/traces/<cell>.json`` (git ignores the folder; each traced
run of a cell overwrites its file) and read back from there.
"""
from __future__ import annotations

import contextlib
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .core import ROOT
from .work.kernels import HAND_WRITTEN

UNIT_SPAN = "perfbench.unit"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def scan_kernels(csrc: Optional[Path] = None) -> List[str]:
    """Every ``__global__`` function in ``keystone_tpu_torch/csrc/*.cu``
    (what ``work/kernels.py`` froze; its test compares the two)."""
    csrc = ROOT / "keystone_tpu_torch" / "csrc" if csrc is None else csrc
    pat = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*"
                     r"\([^)]*\)\s*)?(?:void\s+)?([A-Za-z_]\w*)\s*\(")
    names = set()
    for path in sorted(csrc.glob("*.cu")):
        names.update(pat.findall(path.read_text()))
    return sorted(names)


def kernel_is(name: str, kernel: str) -> bool:
    """Whether the trace's kernel ``name`` (a demangled signature) is the
    function ``kernel``."""
    return re.search(r"(?<!\w)" + re.escape(kernel) + r"\b", name) is not None


def merge(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def clip(intervals, lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def busy(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` inside [lo, hi]."""
    return sum(b - a for a, b in merge(clip(intervals, lo, hi)))


def gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in merge(clip(intervals, lo, hi)):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


@dataclass
class Summary:
    """A profiled span reduced: device events ``(name, start, end, cat)``
    (kernels, copies and sets) and host events ``(name, start, end)`` in
    seconds, and the window the units spanned."""
    device: List[Tuple[str, float, float, str]]
    host: List[Tuple[str, float, float]]
    window: Tuple[float, float]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return busy([(a, b) for _, a, b, _ in self.device], *self.window)

    def kernel_seconds(self, pick) -> float:
        """Summed time of the kernels whose name ``pick`` accepts."""
        lo, hi = self.window
        return sum(min(b, hi) - max(a, lo) for n, a, b, c in self.device
                   if c == "kernel" and pick(n) and min(b, hi) > max(a, lo))

    def host_at(self, t: float) -> str:
        """The innermost host event running at ``t`` (the last started)."""
        running = [(a, n) for n, a, b in self.host
                   if a <= t <= b and n != UNIT_SPAN]
        return max(running)[1] if running else "(no host event)"

    def breakdown(self, top: int = 10) -> Dict[str, List[List[Any]]]:
        """The device operations that took most time and the longest
        idle gaps, each gap named by what the host was doing in it."""
        by_name: Dict[str, float] = {}
        lo, hi = self.window
        for n, a, b, _ in self.device:
            if min(b, hi) > max(a, lo):
                by_name[n] = by_name.get(n, 0.0) + min(b, hi) - max(a, lo)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(gaps([(a, b) for _, a, b, _ in self.device], lo, hi),
                      key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [["host: " + self.host_at((a + b) / 2)[:110],
                               b - a] for a, b in idle]}


def summarize(events: Sequence[Dict[str, Any]]) -> Summary:
    """A Chrome trace's complete events (``ph`` X, microseconds) reduced
    to a :class:`Summary` over the span of the ``perfbench.unit``
    annotations."""
    device, host, units = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        span = (e["name"], e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6)
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append(span + (cat,))
        elif cat in HOST_CATS:
            (units if e["name"] == UNIT_SPAN else host).append(span)
    if not units:
        raise ValueError("the trace holds no perfbench.unit span")
    window = (min(a for _, a, _ in units), max(b for _, _, b in units))
    return Summary(device, host, window)


class NoTracer:
    """The untraced run's stand-in: units run bare."""

    def start(self):
        pass

    def unit(self, index: int):
        return contextlib.nullcontext()


class Tracer:
    """Profiles units 0 .. ``units`` - 1 of the window, each inside a
    ``perfbench.unit`` annotation, and exports the trace when the last
    of them ends."""

    def __init__(self, units: int, directory: Path, cell: str):
        self.units = units
        self.path = Path(directory) / f"{cell}.json"
        self._prof = None

    def start(self):
        """Start the profiler (its start-up takes seconds, so it is started
        before the window opens; what it records before the first unit
        lies outside the units' span)."""
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()

    @contextlib.contextmanager
    def unit(self, index: int):
        import torch
        from torch.profiler import record_function

        if index >= self.units or self._prof is None:
            yield
            return
        with record_function(UNIT_SPAN):
            yield
            torch.cuda.synchronize()
        if index == self.units - 1:
            self._close()

    def _close(self):
        self._prof.__exit__(None, None, None)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(self.path))
        self._prof = None

    def summary(self) -> Summary:
        if self._prof is not None:      # the window ended first
            self._close()
        with open(self.path) as f:
            return summarize(json.load(f)["traceEvents"])


@dataclass
class Readings:
    """What a per-layer reader reads: the profiled span, the counted work
    of each profiled unit (``adapters/*.py``'s ``unit_work``), and the
    optimizer's host seconds in one unit run under a ``PipelineTrace``."""
    trace: Summary
    work: List[Dict[str, Any]]
    optimizer_s: Optional[float] = None
    hand_written: Sequence[str] = HAND_WRITTEN

    def total(self, key: str) -> Tuple[float, float]:
        """Summed (operations, bytes) of ``key`` over the profiled units."""
        ops = sum(w[key][0] for w in self.work if key in w)
        nbytes = sum(w[key][1] for w in self.work if key in w)
        return ops, nbytes

    def flops(self) -> float:
        return sum(w["flops"] for w in self.work)

    def seconds_of(self, kernel: str) -> float:
        return self.trace.kernel_seconds(lambda n: kernel_is(n, kernel))

    def library_seconds(self) -> float:
        """Device time of kernels that are none of the program's own."""
        return self.trace.kernel_seconds(
            lambda n: not any(kernel_is(n, k) for k in self.hand_written))
