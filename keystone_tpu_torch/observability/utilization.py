"""Device-utilization accounting: MFU and roofline position.

Counterpart of ``keystone_tpu/observability/utilization.py``. Measured
wall time plus counted work becomes:

* **MFU**: achieved FLOP/s over the card's peak (PaLM's accounting: no
  credit for recomputation or for the 3xTF32 split);
* **memory-bandwidth utilization**: achieved bytes/s over the HBM rate;
* a **roofline verdict**: arithmetic intensity (FLOPs a byte) against
  the card's ridge point, compute- or memory-bound.

Peaks come from :data:`DEVICE_PEAKS`, the JAX package's catalogue (its
H100 row, 989e12 FLOP/s dense BF16 and 3350e9 B/s, so both packages'
``mfu`` share a denominator), keyed by substrings of
``torch.cuda.get_device_name``; ``KEYSTONE_TORCH_PEAK_FLOPS`` and
``KEYSTONE_TORCH_PEAK_HBM_BW`` override them. The ``cpu`` row is a
placeholder so the CPU exercises the plumbing: a CPU MFU is no claim.

The JAX package reads FLOPs from each jit site's ``cost_analysis``. The
port has two sources, each counted once:

* the five CUDA kernels, launched through ctypes, are invisible to any
  torch-level counter: each wrapper adds its launch's FLOPs and bytes,
  computed from the shapes (``ops/work.py``), to ``kernels.WORK``;
* every other torch op is counted by ``torch.utils.flop_counter.
  FlopCounterMode``, which sees no bytes.

A :class:`~keystone_tpu_torch.observability.trace.PipelineTrace` made
with ``count_flops=True`` (the command line's ``--trace-out``) runs each
node under a ``FlopCounterMode`` and notes the kernel work of its
launches; :func:`annotate_trace` turns each node's self FLOPs and bytes
(the kernels' bytes plus the node's output bytes, a lower bound: torch
ops' reads are not counted) over its self time into ``flops``, ``mfu``
and ``membw_util``, and lists the nodes with neither source as
``uncovered``. :class:`UtilizationWindow` totals the same two sources
over a region.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

#: (peak dense-matmul FLOP/s, HBM bytes/s) a card, keyed by substrings of
#: the device name: the JAX package's catalogue, vendor spec sheets
DEVICE_PEAKS: Dict[str, Dict[str, float]] = {
    "TPU v2": {"flops_per_s": 45e12, "hbm_bytes_per_s": 700e9},
    "TPU v3": {"flops_per_s": 123e12, "hbm_bytes_per_s": 900e9},
    "TPU v4": {"flops_per_s": 275e12, "hbm_bytes_per_s": 1200e9},
    "TPU v5 lite": {"flops_per_s": 197e12, "hbm_bytes_per_s": 819e9},
    "TPU v5e": {"flops_per_s": 197e12, "hbm_bytes_per_s": 819e9},
    "TPU v5p": {"flops_per_s": 459e12, "hbm_bytes_per_s": 2765e9},
    "TPU v6": {"flops_per_s": 918e12, "hbm_bytes_per_s": 1640e9},
    "H100": {"flops_per_s": 989e12, "hbm_bytes_per_s": 3350e9},
    "A100": {"flops_per_s": 312e12, "hbm_bytes_per_s": 2039e9},
    # placeholder: a CPU host has no single meaningful peak
    "cpu": {"flops_per_s": 100e9, "hbm_bytes_per_s": 50e9},
}

FLOPS_ENV = "KEYSTONE_TORCH_PEAK_FLOPS"
HBM_BW_ENV = "KEYSTONE_TORCH_PEAK_HBM_BW"


@dataclass(frozen=True)
class DevicePeaks:
    """One device kind's roofline parameters; ``source`` says where they
    came from (``catalogue``, ``env`` or ``fallback``)."""

    kind: str
    flops_per_s: float
    hbm_bytes_per_s: float
    source: str

    @property
    def ridge_intensity(self) -> float:
        """FLOPs a byte where the compute and memory ceilings meet."""
        return self.flops_per_s / self.hbm_bytes_per_s


def _current_device_kind() -> str:
    import torch

    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"


def device_peaks(device_kind: Optional[str] = None) -> DevicePeaks:
    """Roofline parameters of ``device_kind`` (default: the first CUDA
    card, else ``cpu``). The environment overrides win; an unknown kind
    falls back to the ``cpu`` placeholder (``source="fallback"``)."""
    if device_kind is None:
        device_kind = _current_device_kind()
    entry = None
    source = "catalogue"
    for key, value in DEVICE_PEAKS.items():
        if key.lower() in device_kind.lower():
            entry = dict(value)
            break
    if entry is None:
        entry = dict(DEVICE_PEAKS["cpu"])
        source = "fallback"
    flops_env = os.environ.get(FLOPS_ENV)
    bw_env = os.environ.get(HBM_BW_ENV)
    if flops_env:
        entry["flops_per_s"] = float(flops_env)
        source = "env"
    if bw_env:
        entry["hbm_bytes_per_s"] = float(bw_env)
        source = "env"
    return DevicePeaks(kind=device_kind, flops_per_s=entry["flops_per_s"],
                       hbm_bytes_per_s=entry["hbm_bytes_per_s"],
                       source=source)


def roofline(flops: float, bytes_accessed: float, elapsed_s: float,
             n_devices: int = 1,
             peaks: Optional[DevicePeaks] = None) -> Dict[str, Any]:
    """MFU, bandwidth utilization and the roofline verdict of a measured
    region: ``flops`` and ``bytes_accessed`` are totals over
    ``elapsed_s`` seconds across ``n_devices`` cards (peaks are a
    card's)."""
    peaks = peaks or device_peaks()
    elapsed_s = max(float(elapsed_s), 1e-12)
    denom_flops = peaks.flops_per_s * max(1, n_devices)
    denom_bw = peaks.hbm_bytes_per_s * max(1, n_devices)
    achieved_flops = float(flops) / elapsed_s
    achieved_bw = float(bytes_accessed) / elapsed_s
    intensity = (float(flops) / float(bytes_accessed)
                 if bytes_accessed else float("inf"))
    return {
        "mfu": achieved_flops / denom_flops,
        "membw_util": achieved_bw / denom_bw,
        "achieved_flops_per_s": achieved_flops,
        "achieved_bytes_per_s": achieved_bw,
        "arithmetic_intensity": intensity,
        "ridge_intensity": peaks.ridge_intensity,
        "bound": ("compute" if intensity >= peaks.ridge_intensity
                  else "memory"),
        "device_kind": peaks.kind,
        "peaks_source": peaks.source,
    }


def kernel_work_snapshot() -> Dict[str, Dict[str, float]]:
    """The kernel wrappers' counted launches and work so far."""
    from ..ops import kernels

    return {name: {"launches": float(kernels.LAUNCHES[name]),
                   "flops": kernels.WORK[name]["flops"],
                   "bytes": kernels.WORK[name]["bytes"]}
            for name in kernels.LAUNCHES}


def kernel_work_delta(before: Dict[str, Dict[str, float]]
                      ) -> Dict[str, Dict[str, float]]:
    """The kernel work counted since ``before``, kernels that launched
    only."""
    now = kernel_work_snapshot()
    out = {}
    for name, cur in now.items():
        prev = before.get(name, {})
        delta = {k: v - prev.get(k, 0.0) for k, v in cur.items()}
        if delta["launches"] > 0:
            out[name] = delta
    return out


class UtilizationWindow:
    """MFU over a region, from the kernels' counted work and a
    ``FlopCounterMode`` over the region's torch ops::

        with UtilizationWindow() as uw:
            run_the_benchmark()
        u = uw.report()
        # u["mfu"], u["membw_util"], u["bound"], u["covered_sites"], ...

    ``covered_sites`` names the kernels that launched (and ``torch``
    when counted torch ops ran FLOPs); a kernel launched only inside a
    CUDA graph capture has no counted work and is listed in
    ``uncovered_sites``. Torch ops add FLOPs and no bytes."""

    def __init__(self) -> None:
        self._work0: Dict[str, Dict[str, float]] = {}
        self._captured0: Dict[str, int] = {}
        self._counter = None
        self._t0 = 0.0
        self.wall_s = 0.0

    def __enter__(self) -> "UtilizationWindow":
        from ..ops import kernels

        self._work0 = kernel_work_snapshot()
        self._captured0 = dict(kernels.CAPTURED)
        from torch.utils.flop_counter import FlopCounterMode

        self._counter = FlopCounterMode(display=False)
        self._counter.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.wall_s = time.perf_counter() - self._t0
        self._counter.__exit__(*exc)

    def report(self, elapsed_s: Optional[float] = None,
               n_devices: Optional[int] = None,
               peaks: Optional[DevicePeaks] = None) -> Dict[str, Any]:
        """The window's roofline. ``n_devices`` None means the devices
        the counted work ran on, as ``jax.devices()`` does in the JAX
        package: here one, the process's own card, since a rank counts
        only the kernels it launched."""
        from ..ops import kernels

        if n_devices is None:
            n_devices = 1
        kernel = kernel_work_delta(self._work0)
        flops = sum(w["flops"] for w in kernel.values())
        nbytes = sum(w["bytes"] for w in kernel.values())
        covered = sorted(kernel)
        torch_flops = float(self._counter.get_total_flops())
        if torch_flops > 0:
            covered.append("torch")
        uncovered = sorted(
            name for name, n in kernels.CAPTURED.items()
            if n > self._captured0.get(name, 0))
        out = roofline(flops + torch_flops, nbytes,
                       elapsed_s if elapsed_s is not None else self.wall_s,
                       n_devices=n_devices, peaks=peaks)
        out["flops_total"] = flops + torch_flops
        out["kernel_flops"] = flops
        out["torch_flops"] = torch_flops
        out["bytes_accessed_total"] = nbytes
        out["covered_sites"] = covered
        out["uncovered_sites"] = uncovered
        return out


def annotate_trace(trace: Any, peaks: Optional[DevicePeaks] = None) -> int:
    """Back-fill per-node ``flops``, ``mfu`` and ``membw_util`` onto a
    finished :class:`~.trace.PipelineTrace` made with
    ``count_flops=True``: each node record's self FLOPs (its kernels'
    counted work plus its counted torch ops) and bytes (its kernels'
    bytes plus its output bytes) over its self time. Nodes that ran with
    neither source are listed in ``trace.uncovered``. Returns how many
    node records were annotated."""
    peaks = peaks or device_peaks()
    annotated = 0
    uncovered: List[str] = []
    for record in getattr(trace, "nodes", []):
        if record.cached or record.total_s <= 0.0:
            continue
        flops = record.kernel_flops + record.torch_flops
        if flops <= 0.0 and record.kernel_bytes <= 0.0:
            uncovered.append(f"{record.operator}#{record.node_id}")
            continue
        r = roofline(flops, record.kernel_bytes + record.output_bytes,
                     max(record.wall_s, 1e-9),
                     n_devices=max(1, record.shards), peaks=peaks)
        record.flops = flops
        record.mfu = r["mfu"]
        record.membw_util = r["membw_util"]
        annotated += 1
    trace.uncovered = uncovered
    trace.peaks = {"kind": peaks.kind, "flops_per_s": peaks.flops_per_s,
                   "hbm_bytes_per_s": peaks.hbm_bytes_per_s,
                   "source": peaks.source}
    return annotated


def utilization_table(trace: Any) -> str:
    """Per-node MFU and bandwidth table of an annotated trace."""
    lines = [f"{'node':<40} {'self ms':>10} {'GFLOP':>10} {'mfu':>9} "
             f"{'membw':>9} kernels"]
    for r in getattr(trace, "nodes", []):
        if not r.flops:
            continue
        kern = ",".join(f"{k}x{int(v)}" for k, v in
                        sorted(r.kernel_launches.items()))
        lines.append(f"{(r.operator + '#' + str(r.node_id))[:40]:<40} "
                     f"{r.wall_s * 1e3:>10.3f} {r.flops / 1e9:>10.3f} "
                     f"{r.mfu:>9.4f} {r.membw_util:>9.4f} {kern}")
    unc = getattr(trace, "uncovered", [])
    if unc:
        lines.append(f"uncovered ({len(unc)}): " + ", ".join(unc[:8])
                     + (" ..." if len(unc) > 8 else ""))
    return "\n".join(lines)
