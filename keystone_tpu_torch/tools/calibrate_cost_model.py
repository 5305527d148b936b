"""Calibrate the solver cost model's weights on this device and write the
artifact ``nodes/learning/least_squares.py::load_calibration`` reads.

    python -m keystone_tpu_torch.tools.calibrate_cost_model \
        [--small] [--out PATH] [--device cuda|cpu]

Counterpart of the repository's ``tools/calibrate_cost_model.py``. The
reference cost form is kept (the solvers' ``cost`` methods implement it):

    cost = iters * (max(cpu_w * flops, mem_w * elements_scanned)
                    + net_w * elements_over_network) + lat_w * rounds

On a GPU the weights mean:

    cpu_w  seconds per float32 flop at the solvers' precision (true
           float32: ``ops/device.py`` keeps TF32 off, and this tool
           refuses to run with it on, since TF32 would read 3-7x fast)
    mem_w  seconds per float32 element read from device memory
    net_w  seconds per float32 element over the interconnect (published
           bandwidth; one device cannot measure it, and on one device
           every log2(machines) term is zero anyway)
    lat_w  seconds per host-synchronizing round (``DISPATCH_ROUNDS`` of
           the solvers, one per L-BFGS iteration)

The first two are floor-cancelled: each is taken from the difference of
two sizes, so a fixed per-call cost cancels. A non-positive difference is
measured again once, then the run stops (``SystemExit``); every rate is
bounds-checked before anything is printed as weights. The tool then times
the three dense candidates (L-BFGS, BCD(1000, 3), the exact solve) at
several shapes and counts the shapes where the model's cheapest candidate
is the measured fastest. The artifact is written (atomically, with
``os.replace``) only when more than half of the shapes agree; otherwise
the shipped weights stay active.

Data is made on the device from seeded ``torch.Generator``s. On a CUDA
device the primitive rates are timed with CUDA events after a warm call
(cuBLAS's handle and workspace are made outside the timed region); the
solvers are timed as their callers wait for them (``tools.timeit``), and
each solver's host synchronizations are counted once with PyTorch's sync
debug mode.

The artifact holds the four weights, the device's name and power limit,
the host name, a timestamp, the agreement and the tool's name. It goes to
``build/keystone_tpu_torch/cost_model_calibration.json`` in the checkout
(``least_squares.DEFAULT_CALIBRATION_PATH``) or to ``--out``;
``KEYSTONE_TORCH_COST_CALIBRATION`` points the loader elsewhere.
"""
from __future__ import annotations

import argparse
import copy
import datetime
import json
import os
import socket
import subprocess
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from . import device_name, fence, timeit

TOOL = "keystone_tpu_torch/tools/calibrate_cost_model.py"

#: the validation shapes (n, d); k = 10 labels
SHAPES = ((65_536, 256), (65_536, 1_024), (32_768, 4_096))
SMALL_SHAPES = ((8_192, 256), (8_192, 1_024))
K = 10
LAM = 0.1


# -- primitive rates -------------------------------------------------------

def _floor_cancelled(label, measure):
    """rate = numer / (dt_large - dt_small), guarded: ``measure()`` returns
    (dt_small, dt_large, numer); a non-positive difference is measured
    once more, then the run stops, so that a negative weight never reaches
    the printout or the artifact."""
    for attempt in (0, 1):
        dt_small, dt_large, numer = measure()
        if dt_large > dt_small:
            return numer / (dt_large - dt_small)
        print(f"WARNING: {label}: dt_large ({dt_large * 1e3:.3f} ms) <= "
              f"dt_small ({dt_small * 1e3:.3f} ms): noise swamped the "
              "floor-cancelled difference; "
              + ("retrying once" if attempt == 0 else "aborting"),
              flush=True)
    raise SystemExit(
        f"calibration aborted: {label} unmeasurable on this host (the "
        "large size is not slower than the small one after a retry). Run "
        "again on a quieter machine; do not take weights from a run that "
        "printed this message.")


def _sanity_bound(name, value, lo, hi, unit):
    """Stop before printing or writing a physically implausible rate."""
    if not np.isfinite(value) or not (lo <= value <= hi):
        raise SystemExit(
            f"calibration aborted: {name} = {value:.3e} {unit} is outside "
            f"the plausible range [{lo:.0e}, {hi:.0e}]: the measurement is "
            "untrustworthy (noise, throttling, or a mis-detected device). "
            "Run again; do not ship these weights.")
    return value


def _call_seconds(fn, dev: torch.device, iters: int) -> float:
    """Seconds per call of ``fn()``: on a CUDA device between CUDA events
    after a warm call, elsewhere :func:`~keystone_tpu_torch.tools.timeit`."""
    if dev.type != "cuda":
        return timeit(fn, iters=iters)
    fn()
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def measure_flop_rate(dev: torch.device, small: bool = False) -> float:
    """Sustained true-float32 flop rate of the solvers' Gram
    (``ops/linalg.py::gram``, ``A.T @ A``) at the solvers' shape class,
    floor-cancelled between two row counts."""
    from ..ops import linalg

    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit(
            "calibration refused: torch.backends.cuda.matmul.allow_tf32 is "
            "on; the solvers run true float32 (ops/device.py), and a TF32 "
            "Gram would price them 3-7x too cheap")
    n_small, n_large, d = ((4_096, 16_384, 1_024) if small
                           else (16_384, 49_152, 4_096))
    gen = torch.Generator(device=dev).manual_seed(0)

    def measure():
        dts = {}
        for n in (n_small, n_large):
            A = torch.randn((n, d), generator=gen, device=dev)
            fence(A)
            dts[n] = _call_seconds(lambda: linalg.gram(A), dev, iters=3)
            del A
        return dts[n_small], dts[n_large], 2.0 * (n_large - n_small) * d * d

    # from a host CPU's GFLOP/s to past any card's float32 peak
    return _sanity_bound("float32 flop rate",
                         _floor_cancelled("float32 flop rate", measure),
                         1e8, 2e15, "FLOP/s")


def measure_stream_rate(dev: torch.device, small: bool = False) -> float:
    """Sustained device-memory read rate (float32 elements/s) of a
    bandwidth-bound ``torch.sum``, floor-cancelled between two sizes."""
    e_small = (8 << 20) if small else (32 << 20)
    e_large = (32 << 20) if small else (160 << 20)
    gen = torch.Generator(device=dev).manual_seed(1)

    def measure():
        dts = {}
        for elems in (e_small, e_large):
            A = torch.randn((elems,), generator=gen, device=dev)
            fence(A)
            dts[elems] = _call_seconds(lambda: torch.sum(A), dev, iters=4)
            del A
        return dts[e_small], dts[e_large], float(e_large - e_small)

    # a broken host's MB/s to past any device memory's rate
    return _sanity_bound("memory stream rate",
                         _floor_cancelled("memory stream rate", measure),
                         1e6, 1e13, "elements/s")


def measure_dispatch_latency(dev: torch.device) -> float:
    """Seconds of one host-synchronizing round: ``v + 1.0`` on 128
    elements followed by a host synchronization (on a CUDA device), the
    round the solvers' ``DISPATCH_ROUNDS`` count."""
    gen = torch.Generator(device=dev).manual_seed(2)
    v = torch.randn((128,), generator=gen, device=dev)
    fence(v)

    def bump():
        out = v + 1.0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    return timeit(bump, iters=8)


#: Published interconnect bandwidth a direction, bytes/s, by device name
#: (all of the name's tags must appear). The H100 SXM5 (its name reads
#: "H100 80GB HBM3", or "H100 SXM") has NVLink 4: 900 GB/s in all, 450
#: GB/s each way (NVIDIA H100 Tensor Core GPU datasheet).
_LINK_BYTES_PER_S = (
    (("h100", "hbm3"), 450e9),
    (("h100", "sxm"), 450e9),
)


def derive_net_weight(dev: torch.device) -> float:
    """Seconds per float32 element over the interconnect, from the
    published table; the reference's 100 GB/s elsewhere."""
    kind = device_name(dev).lower()
    for tags, rate in _LINK_BYTES_PER_S:
        if all(tag in kind for tag in tags):
            return 4.0 / rate
    return 4.0 / 100e9


def power_limit_w(dev: torch.device) -> Optional[float]:
    """The card's power limit in watts as ``nvidia-smi`` reads it (None
    on the CPU or where it cannot be read)."""
    if dev.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i",
             str(dev.index if dev.index is not None
                 else torch.cuda.current_device())],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


# -- the solvers -----------------------------------------------------------

def solver_options(lam: float = LAM):
    """The three dense candidates the validation times and ranks."""
    from ..nodes.learning.lbfgs import DenseLBFGSwithL2
    from ..nodes.learning.linear import (
        BlockLeastSquaresEstimator,
        LinearMapEstimator,
    )

    return [
        ("dense_lbfgs", DenseLBFGSwithL2(lam=lam, num_iterations=20)),
        ("block_ls", BlockLeastSquaresEstimator(1000, 3, lam=lam)),
        ("exact", LinearMapEstimator(lam=lam)),
    ]


def count_host_syncs(fn, dev: torch.device) -> Optional[int]:
    """How many host synchronizations ``fn()`` makes on a CUDA device, as
    PyTorch's sync debug mode reports them (None on the CPU)."""
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fence(fn())
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return sum("synchroniz" in str(w.message) for w in caught)


def time_solvers(n: int, d: int, dev: torch.device, k: int = K):
    """Seconds of each candidate's fit on seeded (n, d) data with k
    labels, and each fit's host synchronizations (a CUDA device only)."""
    from ..parallel.dataset import ArrayDataset

    gen = torch.Generator(device=dev).manual_seed(2)
    X = torch.randn((n, d), generator=gen, device=dev)
    Y = torch.randn((n, k), generator=gen, device=dev)
    fence((X, Y))
    ds, labels = ArrayDataset(X, n), ArrayDataset(Y, n)
    secs, syncs = {}, {}
    for name, solver in solver_options():
        secs[name] = timeit(lambda: solver._fit(ds, labels), iters=2)
        syncs[name] = count_host_syncs(lambda: solver._fit(ds, labels), dev)
        shown = "" if syncs[name] is None else \
            f", {syncs[name]} host syncs a fit"
        print(f"  n={n} d={d} {name:12s} {secs[name] * 1e3:9.2f} ms{shown}",
              flush=True)
    return secs, syncs


def predicted_ranking(n, d, k, cpu_w, mem_w, net_w, lat_w):
    """The candidates ordered by the cost model at (n, d, k), density 1,
    one machine, and their costs."""
    costs = {name: solver.cost(n, d, k, 1.0, 1, cpu_w, mem_w, net_w,
                               lat_w=lat_w)
             for name, solver in solver_options()}
    return sorted(costs, key=costs.get), costs


# -- the choices the weights make -------------------------------------------

def _describe(node) -> str:
    name = type(node).__name__
    if hasattr(node, "block_size") and hasattr(node, "num_iter"):
        return f"{name}({node.block_size}, {node.num_iter})"
    return name


def choice_at(weights: Dict[str, float], n: int, d: int, k: int,
              streaming: bool = False) -> str:
    """The solver a ``LeastSquaresEstimator`` with ``weights`` picks at
    (n, d, k), density 1, one machine; ``streaming`` keeps the one-pass
    candidates, as a streamed fit's choice does. (No cost reads the
    penalty.)"""
    from ..nodes.learning.least_squares import LeastSquaresEstimator

    est = LeastSquaresEstimator(**weights)
    return _describe(est._choose(n, d, k, 1.0, 1, streaming=streaming).node)


def app_choices(weights_by_name: Dict[str, Dict[str, float]]):
    """For every bundled app's check target, each optimizable node whose
    choice reads cost weights, chosen from the static analyzer's shapes
    (as the node rule's default path does) on one machine under each
    named weight set. Returns [(app, node type, (n, item shape), {weight
    set name: choice})], a node the graph holds more than once listed
    once."""
    from ..analysis.interpreter import analyze
    from ..analysis.spec import as_input_spec
    from ..pipelines import CHECK_APPS
    from ..workflow.optimizer.node_rule import NodeOptimizationRule

    out = []
    for app, build in CHECK_APPS.items():
        target = build()
        p = target.pipeline.to_pipeline()
        graph = p._graph
        analysis = analyze(graph, {p._source: as_input_spec(
            target.input_spec)})
        for node in graph.nodes:
            op = graph.get_operator(node)
            if not hasattr(op, "cpu_weight") or \
                    not hasattr(op, "optimize_static"):
                continue
            deps = graph.get_dependencies(node)
            spec = analysis.value(deps[0]) if deps else None
            element = getattr(spec, "element", None)
            shape = (getattr(spec, "n", None),
                     tuple(getattr(element, "shape", ()) or ()))
            picks = {}
            for name, weights in weights_by_name.items():
                op_w = copy.copy(op)
                for key, value in weights.items():
                    setattr(op_w, key, value)
                got = NodeOptimizationRule._static_choice(
                    analysis, graph, node, op_w, 1)
                picks[name] = None if got is None else _describe(
                    got[0].node)
            row = (app, type(op).__name__, shape, picks)
            if row not in out:
                out.append(row)
    return out


# -- the artifact ------------------------------------------------------------

def write_artifact(path, weights, agreement, shapes_checked, dev=None,
                   small=False):
    """Write the calibration as the JSON ``load_calibration`` reads, with
    its provenance, through a temporary file and ``os.replace``."""
    dev = torch.device("cpu") if dev is None else dev
    blob = dict(weights)
    blob.update({
        "device": device_name(dev),
        "power_limit_w": power_limit_w(dev),
        "hostname": socket.gethostname(),
        "timestamp": datetime.datetime.now(
            datetime.timezone.utc).isoformat(),
        "agreement": f"{agreement}/{shapes_checked}",
        "small": bool(small),
        "tool": TOOL,
    })
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(blob, f, indent=2)
    os.replace(tmp, path)
    return path


def calibrate(dev: torch.device, small: bool = False,
              out_path: Optional[str] = None) -> dict:
    """Measure the weights, validate them on the candidates and write the
    artifact when the agreement is above half. Returns the weights, the
    rates, each shape's readings, the agreement and the path written (or
    None)."""
    from ..nodes.learning.least_squares import (
        DEFAULT_CALIBRATION_PATH,
        REFERENCE_EC2_WEIGHTS,
    )

    out_path = out_path or DEFAULT_CALIBRATION_PATH
    print(f"device: {device_name(dev)}, power limit "
          f"{power_limit_w(dev)} W", flush=True)
    flop_rate = measure_flop_rate(dev, small)
    stream_rate = measure_stream_rate(dev, small)
    lat_w = _sanity_bound("dispatch latency", measure_dispatch_latency(dev),
                          1e-7, 1.0, "s/round")
    weights = {"cpu_weight": 1.0 / flop_rate, "mem_weight": 1.0 / stream_rate,
               "network_weight": derive_net_weight(dev), "lat_weight": lat_w}
    print(f"float32 Gram rate (floor-cancelled): {flop_rate / 1e12:.3f} "
          f"TFLOP/s -> cpu_w = {weights['cpu_weight']:.3e} s/flop",
          flush=True)
    print(f"memory stream rate (floor-cancelled): "
          f"{stream_rate * 4 / 1e9:.1f} GB/s -> mem_w = "
          f"{weights['mem_weight']:.3e} s/elem", flush=True)
    print(f"host-synchronizing round: lat_w = {lat_w:.3e} s/round",
          flush=True)
    print(f"interconnect (published): net_w = "
          f"{weights['network_weight']:.3e} s/elem", flush=True)

    shapes = SMALL_SHAPES if small else SHAPES
    agree = 0
    readings = []
    for n, d in shapes:
        measured, syncs = time_solvers(n, d, dev)
        m_rank = sorted(measured, key=measured.get)
        p_rank, p_costs = predicted_ranking(
            n, d, K, weights["cpu_weight"], weights["mem_weight"],
            weights["network_weight"], lat_w)
        ok = m_rank[0] == p_rank[0]
        agree += ok
        readings.append({"n": n, "d": d, "k": K, "seconds": measured,
                         "host_syncs": syncs, "costs": p_costs,
                         "measured_fastest": m_rank[0],
                         "model_pick": p_rank[0], "agree": ok})
        print(f"  -> measured fastest: {m_rank[0]}, model picks: "
              f"{p_rank[0]}  {'OK' if ok else 'MISMATCH'}", flush=True)
        print("     predicted costs: " + ", ".join(
            f"{name}={cost:.4g}s" for name, cost in p_costs.items()),
            flush=True)
    print()
    print(f"the weights measured on {device_name(dev)} (the port ships "
          "REFERENCE_EC2_WEIGHTS in "
          "keystone_tpu_torch/nodes/learning/least_squares.py):",
          flush=True)
    for key, value in weights.items():
        print(f"    {key!r}: {value:.3e},  # EC2 "
              f"{REFERENCE_EC2_WEIGHTS[key]:.3e}", flush=True)
    print(f"model-vs-measurement agreement: {agree}/{len(shapes)} shapes",
          flush=True)
    result = {"weights": weights, "flop_rate": flop_rate,
              "stream_rate": stream_rate, "shapes": readings,
              "agreement": agree, "checked": len(shapes), "path": None}
    if 2 * agree <= len(shapes):
        # weights that mis-rank the measured solvers on most validation
        # shapes would mis-rank every later solve: the artifact is loaded
        # without a human in between
        print(f"NOT writing the calibration artifact: agreement {agree}/"
              f"{len(shapes)} is too low to trust; the shipped weights "
              "stay active", flush=True)
        return result
    result["path"] = write_artifact(out_path, weights, agree, len(shapes),
                                    dev, small)
    print(f"calibration artifact written to {result['path']}; "
          "LeastSquaresEstimator loads it (KEYSTONE_TORCH_COST_CALIBRATION "
          "points elsewhere), and traces report its provenance with every "
          "solver decision", flush=True)
    return result


def main(argv=None) -> int:
    from ..ops.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true",
                    help="smaller primitive sizes and validation shapes")
    ap.add_argument("--out", default=None,
                    help="artifact path (default: the checkout's "
                         "build/keystone_tpu_torch/"
                         "cost_model_calibration.json)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; refused without a card) or cpu")
    args = ap.parse_args(argv)
    calibrate(resolve_device(args.device), args.small, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
