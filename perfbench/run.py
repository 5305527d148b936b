"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout of the repository, on a machine with as many
CUDA devices as the cell asks for. Set-up (imports, inputs from the
seed, a warm unit that builds the program's kernels) is timed as
``setup_s``; then the cell's driver runs its window for ``--seconds``;
with ``--trace 1`` the window's first units run under ``torch.profiler``
and the result carries the per-layer metrics instead of the end-to-end
ones. The check follows the window: each compared number is printed
beside its limit as the last lines of standard error and under
``check``, the last key of the result line, which is the last line of
standard output.

Exits 2 with no result when no CUDA device (or too few) is present, and
1 when a module of ``jax``, ``jaxlib``, ``flax`` or ``keystone_tpu`` is
loaded once the window has closed.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"
    return out[0] if out else "nvidia-smi printed nothing"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    sys.path.insert(0, ROOT)
    from perfbench import core

    for key, path in core.cache_dirs().items():
        os.environ[key] = path
    cell = core.find_cell(a.workload)

    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.entry["chips"]):
        print(f"perfbench: cell {cell.name} needs {cell.entry['chips']} CUDA "
              f"device(s); {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 2
    result, numbers = core.run_cell(cell, a.seed, a.seconds, bool(a.trace),
                                    torch.device("cuda"), t0=T0)
    card = card_line()
    print(f"perfbench: {cell.name} seed {a.seed} on {card}, torch "
          f"{torch.__version__}", file=sys.stderr, flush=True)
    bad = core.forbidden_modules()
    if bad:
        print("perfbench: modules the benchmark may not load are loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 1
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"],
            "device": {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(0),
                       "count": cell.entry["chips"],
                       "memory_peak_bytes": result["memory_peak_bytes"]}}
    if a.trace:
        line["device"]["busy_s"] = result["busy_s"]
        line["device"]["window_s"] = result["window_s"]
        line["breakdown"] = result["breakdown"]
    line["card"] = card
    line["check"] = numbers
    for name, n in numbers.items():
        print(f"check {name} {n['value']!r} limit {n['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
