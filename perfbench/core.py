"""The harness: finds a cell's files by name, runs set-up, the window and
the check, and builds the result line.

Nothing in this module knows a configuration, a traffic mix or a
metric: those live in the files ``BENCHMARK.json`` and the cell's
workload file name (see the package docstring).
"""
from __future__ import annotations

import importlib.util
import json
import math
import re
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "keystone_tpu")

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def cache_dirs() -> Dict[str, str]:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own kernel libraries go to ``build/keystone_tpu_torch``,
    which it derives from its package's place)."""
    base = ROOT / "build" / "perfbench"
    return {"TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "TRITON_CACHE_DIR": str(base / "triton"),
            "CUDA_CACHE_PATH": str(base / "nv_compute_cache")}


def forbidden_modules(modules=None) -> List[str]:
    """The top-level names in ``modules`` (default ``sys.modules``) that
    are in :data:`FORBIDDEN`, compared whole: ``keystone_tpu_torch`` is
    not ``keystone_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def note(text: str) -> None:
    """A line for the run's standard error (before the check's lines)."""
    print("perfbench: " + text, file=sys.stderr, flush=True)


# -- finding a cell's parts by name -----------------------------------------

def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def manifest() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


def part(kind: str, name: str) -> Path:
    """``perfbench/<kind>/<name>`` (a JSON file or a Python module)."""
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    return BENCH / kind / name


def load_module(kind: str, name: str):
    """The Python file ``perfbench/<kind>/<name>.py`` as a module."""
    path = part(kind, name + ".py")
    mod_name = f"perfbench_{kind}_" + re.sub(r"\W", "_", name)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The reader of per-layer metric ``metric``: ``metrics/<metric>.py``
    where that file exists, else the reader of its kind,
    ``metrics/<the name before its first dot>.py`` (``idle_share.fit``
    and ``idle_share.apply`` share ``idle_share.py``)."""
    if part("metrics", metric + ".py").is_file():
        return load_module("metrics", metric)
    return load_module("metrics", metric.split(".")[0])


def applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    """One cell: its manifest entry and the files its name leads to."""
    name: str
    entry: Dict[str, Any]
    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def values(self) -> Dict[str, Any]:
        return self.config["values"]

    @property
    def driver(self):
        return load_module("drivers", self.traffic["driver"])

    @property
    def adapter(self):
        return load_module("adapters", self.config["adapter"])


def find_cell(name: str, bench: Optional[Dict[str, Any]] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``), with its
    workload, configuration and traffic files."""
    bench = manifest() if bench is None else bench
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"no single cell named {name!r} in BENCHMARK.json")
    entry = entries[0]
    workload = load_json(part("workloads", name + ".json"))
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[entry["config"]]["file"])
    traffic = load_json(part("traffic", entry["traffic"] + ".json"))
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise ValueError(f"{name}: workload file's {key} "
                             f"{workload[key]!r} is not the manifest's "
                             f"{entry[key]!r}")
    return Cell(name, entry, workload, config, traffic,
                [m for m in bench["end_to_end"] if applies(m, name)],
                [m for m in bench["per_layer"] if applies(m, name)])


# -- window arithmetic ---------------------------------------------------------

def whole_window_rate(rows: List[int], start: float, ends: List[float]) -> float:
    """Rows a second of units run back to back from ``start``: every
    unit's rows over the time to the end of the last one."""
    if not rows:
        raise ValueError("no unit completed in the window")
    return sum(rows) / (max(ends) - start)


def p95(values: List[float]) -> float:
    """The 95th percentile of every value (``statistics.quantiles``,
    inclusive)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[94]


class PeakMemory:
    """The device's allocation peak over a run in which drivers reset
    the peak counter before each unit: ``note`` before every reset."""

    def __init__(self):
        self.value = 0

    def note(self) -> int:
        import torch

        self.value = max(self.value, torch.cuda.max_memory_allocated())
        return self.value


@dataclass
class WindowResult:
    """What a driver's window hands back: its end-to-end metrics, the
    units attempted, the counted work of the profiled units, and what the
    check judges."""
    metrics: Dict[str, float]
    attempted: int
    profiled_work: List[Dict[str, Any]] = field(default_factory=list)
    outputs: Any = None


# -- the check -------------------------------------------------------------------

def widest_gap(ref_scores, predicted, scale: float) -> float:
    """The widest gap by which a predicted class's reference score lies
    below the reference's best score of its row, over ``scale``."""
    import torch

    ref = ref_scores.to(torch.float64)
    pred = predicted.long().to(ref.device)
    if pred.shape[0] != ref.shape[0]:
        return math.inf
    bad = (pred < 0) | (pred >= ref.shape[1])
    if bool(bad.any()):
        return math.inf
    gap = ref.max(dim=1).values - ref.gather(1, pred[:, None])[:, 0]
    return float(gap.max()) / scale if gap.numel() else 0.0


def scale_of(ref_scores) -> float:
    """The scale gaps are measured in: the standard deviation of all the
    reference's scores."""
    return float(ref_scores.double().std())


def verdict(numbers: Dict[str, Dict[str, float]]) -> bool:
    return all(math.isfinite(n["value"]) and n["value"] <= n["limit"]
               for n in numbers.values())


# -- one run ------------------------------------------------------------------

def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: Optional[float] = None):
    """Set-up, window, (trace,) check. Returns ``(result, numbers)``: the
    result line's dict less the device block, and the compared numbers
    (name -> value and limit)."""
    from . import trace as tracing

    t0 = time.perf_counter() if t0 is None else t0
    driver = cell.driver
    peak = PeakMemory()
    state = driver.setup(cell, seed, device)
    setup_s = time.perf_counter() - t0
    tracer = (tracing.Tracer(cell.workload["trace_units"], BENCH / "traces",
                             cell.name)
              if trace else tracing.NoTracer())
    tracer.start()
    result = driver.window(cell, state, seconds, tracer, peak)
    extra = {}
    if trace:
        summary = tracer.summary()
        readings = tracing.Readings(summary, result.profiled_work,
                                    driver.traced_optimizer_s(cell, state))
        layer = {}
        for m in cell.per_layer:
            value = reader(m["name"]).read(readings)
            if value is not None:
                layer[m["name"]] = {"value": float(value), "unit": m["unit"]}
        extra = {"metrics": layer, "busy_s": summary.busy_s,
                 "window_s": summary.window_s,
                 "breakdown": summary.breakdown()}
    memory_peak = peak.note() if device.type == "cuda" else 0
    numbers, failed = driver.check(cell, state, result)
    metrics = {"setup_s": setup_s, **result.metrics}
    e2e = {m["name"]: {"value": float(metrics[m["name"]]), "unit": m["unit"]}
           for m in cell.end_to_end}
    out = {"correct": verdict(numbers) and failed == 0,
           "attempted": result.attempted, "failed": failed,
           "metrics": extra.get("metrics", e2e),
           "memory_peak_bytes": memory_peak}
    for key in ("busy_s", "window_s", "breakdown"):
        if key in extra:
            out[key] = extra[key]
    return out, numbers
