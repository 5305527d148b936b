"""Readings that a cell's check limit is set from, many seeds in one
process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11 12 13 ... [--out FILE]

For each seed: the cell's inputs, the program's fit on the first
training set (through the cell's own traffic: resident or streamed),
and the number the cell's check compares (``core.widest_gap`` against
the float64 reference) for

- ``program``: the classes the program gives (a fit cell: the held-out
  rows; an apply cell: calls cycling through the traffic's call sizes
  for ``--seconds``, at least one call a size, as the traffic draws them);
- ``tf32``: the control, the reference put in the program's place and
  computed in float32 with TF32 on;
- ``float32``: the reference in true float32 (for comparison);
- ``fault_half``: the program fitted on the first half of the training
  rows only;
- ``fault_unchanged``: a model left at its start, every row given the
  class of the largest label mean;
- ``fault_altered``: the program's classes with one answer changed where
  it is produced (the row's worst class by the reference).

One JSON line a seed goes to standard output (and to ``--out``). The
benchmark's runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seed, device, seconds=0.0):
    import torch

    from perfbench import core, program

    adapter = cell.adapter
    stream = cell.traffic.get("stream")
    state = adapter.prepare(cell, seed, device, 1)
    held_out = adapter.held_out(state)
    t0 = time.perf_counter()
    fitted = adapter.fit(state, 0, stream)
    if cell.traffic["driver"] == "apply":
        apply = core.load_module("drivers", "apply")
        g = torch.Generator(device=device).manual_seed(seed)
        sizes = apply.call_rows(cell.traffic, held_out.shape[0])
        calls = []
        while len(calls) < len(sizes) or time.perf_counter() < t0 + seconds:
            n = sizes[len(calls) % len(sizes)]
            idx = apply.draw(held_out, n, g)
            calls.append((idx, program.apply_classes(fitted, held_out[idx])))
            program.clear_memo()
    else:
        calls = [(torch.arange(held_out.shape[0], device=device),
                  program.apply_classes(fitted, held_out))]
    fit_s = time.perf_counter() - t0
    del fitted
    program.release()
    half = None
    if cell.traffic["driver"] != "apply":
        images, labels = state.train[0]
        m = labels.shape[0] // 2
        state.train.append((images[:m], labels[:m]))
        fitted = adapter.fit(state, 1, stream)
        half = program.apply_classes(fitted, held_out)
        del fitted
        state.train.pop()
        program.release()
    ref = adapter.reference_scores(state, 0, held_out, "float64")
    scale = core.scale_of(ref)

    def gap(pairs):
        return max(core.widest_gap(ref[i], o, scale) for i, o in pairs)

    out = {"seed": seed, "fit_and_apply_s": fit_s, "calls": len(calls),
           "program": gap(calls)}
    idx, first = calls[0]
    worst = ref[idx].argmin(dim=1)
    altered = first.clone()
    altered[0] = worst[0]
    out["fault_altered"] = gap([(idx, altered)] + calls[1:])
    # weights left at zero score every row by the labels' means: the most
    # frequent class
    counts = torch.bincount(state.train[0][1].long().cpu(),
                            minlength=ref.shape[1])
    common = int(counts.argmax())
    out["fault_unchanged"] = gap([(i, torch.full_like(o, common))
                                  for i, o in calls])
    if half is not None:
        out["fault_half"] = core.widest_gap(ref, half, scale)
    for mode in ("tf32", "float32"):
        t0 = time.perf_counter()
        low = adapter.reference_scores(state, 0, held_out, mode)
        classes = low.argmax(dim=1)
        out[mode] = gap([(i, classes[i]) for i, _ in calls])
        out[mode + "_s"] = time.perf_counter() - t0
        del low
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=0.0,
                   help="an apply cell: call for this long (at least one "
                   "call a size), as a run's window does")
    p.add_argument("--out")
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from perfbench import core

    for key, path in core.cache_dirs().items():
        os.environ[key] = path
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = core.find_cell(a.workload)
    for seed in a.seeds:
        line = dict(cell=cell.name, **readings(
            cell, seed, torch.device("cuda"), a.seconds))
        print(json.dumps(line), flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
