"""Back-to-back fits of a pipeline on resident training sets.

Traffic parameters (``traffic/<name>.json``): ``train_sets``, the number
of seeded training sets the fits rotate through. Each fit is a new job:
the pipeline is built again from its inputs and fitted; between fits the
fitted pipeline is dropped (the last one of each training set is kept
for the check) and ``PipelineEnv.reset()`` drops the prefix memo, so no
fit is served from an earlier one. A new
fit starts only while the window is open; each ends in
``torch.cuda.synchronize()``.

End-to-end: ``fit_rows_per_s``, every training row of the fits over the
time from the window's start to the end of the last fit, and
``fit_peak_gib``, the largest ``max_memory_allocated`` less the
allocation at a fit's start, the peak reset before each fit.

The check: each kept pipeline's classes for the held-out rows, against
the reference's float64 fit on the same training set
(``core.widest_gap``).
"""
from __future__ import annotations

import time

from perfbench import core, program

#: the stream a fit reads: none for a resident fit
STREAM = None


def setup(cell, seed, device, stream=STREAM):
    """Inputs from the seed, then one whole fit on the first training set
    (it builds the kernels, warms every shape the fits use and pays the
    process's first analysis)."""
    import torch

    adapter = cell.adapter
    t0 = time.perf_counter()
    state = adapter.prepare(cell, seed, device, cell.traffic["train_sets"])
    t1 = time.perf_counter()
    fitted = adapter.fit(state, 0, stream)
    if device.type == "cuda":
        torch.cuda.synchronize()
    del fitted
    program.reset()
    core.note(f"set-up: inputs {t1 - t0:.2f} s, warm fit "
              f"{time.perf_counter() - t1:.2f} s")
    return state


def window(cell, state, seconds, tracer, peak, stream=STREAM):
    import torch

    adapter = cell.adapter
    cuda = state.device.type == "cuda"
    sets = cell.traffic["train_sets"]
    kept, rows, ends, peaks, work = {}, [], [], [], []
    start = time.perf_counter()
    i = 0
    while time.perf_counter() < start + seconds:
        j = i % sets
        if cuda:
            torch.cuda.synchronize()
            peak.note()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        with tracer.unit(i):
            fitted = adapter.fit(state, j, stream)
            if cuda:
                torch.cuda.synchronize()
        ends.append(time.perf_counter())
        if cuda:
            peaks.append(torch.cuda.max_memory_allocated() - base)
        rows.append(adapter.train_rows(state))
        if i < getattr(tracer, "units", 0):
            work.append(adapter.unit_work(state, "fit", stream))
        kept[j] = fitted
        del fitted
        program.reset()
        i += 1
    metrics = {"fit_rows_per_s": core.whole_window_rate(rows, start, ends),
               "fit_peak_gib": max(peaks, default=0) / 2 ** 30}
    return core.WindowResult(metrics, i, work, kept)


def traced_optimizer_s(cell, state, stream=STREAM):
    """Host seconds of the optimizer's passes in one more fit, run under
    a ``PipelineTrace`` (``meta["optimizer_runs"][*]["wall_s"]``)."""
    return program.optimizer_seconds(
        lambda: cell.adapter.fit(state, 0, stream))


def check(cell, state, result):
    """Each kept pipeline's held-out classes against the reference. The
    classes are read first; then the pipelines and the memo are freed
    and the reference runs."""
    adapter = cell.adapter
    held_out = adapter.held_out(state)
    predicted = {j: program.apply_classes(f, held_out)
                 for j, f in sorted(result.outputs.items())}
    result.outputs = None
    program.release()
    gaps = {}
    for j, pred in predicted.items():
        ref = adapter.reference_scores(state, j, held_out, "float64")
        gaps[j] = core.widest_gap(ref, pred, core.scale_of(ref))
        del ref
    limit = cell.workload["check"]["limit"]
    failed = sum(not g <= limit for g in gaps.values())
    worst = max(gaps.values())
    return {cell.workload["check"]["number"]: {"value": worst,
                                                "limit": limit}}, failed
