"""Batch scoring: one client calls a fitted pipeline's ``apply`` in a
closed loop.

Set-up fits the pipeline once on the first training set, then warms
every call size the traffic uses with one call each. Traffic
parameters: ``call_rows``, the rows of each call, which the window
cycles through in the order the seed shuffles them to once (the same
sizes for every seed). Each call's rows are a fresh seeded draw,
without replacement, from the held-out set: a call of the held-out
set's size scores the whole set, in an order of its own, so no call is
served from an earlier call's memo or its input. The prefix memo is emptied after
each call, outside its timing: the pipeline's ``Cacher`` memoizes every
call's features there, and over a window the memo would outgrow the
card.

End-to-end: ``apply_rows_per_s``, every row the window's calls scored
over the time from the window's start to the end of the last call, and
``apply_p95_ms``, the 95th percentile over every call, each timed from
its call to its synchronised result. A new call starts only while the
window is open.

The check: every call's classes against the reference's float64 fit on
the same training set and its scores for the held-out rows
(``core.widest_gap``, in the scale of all the held-out scores).
"""
from __future__ import annotations

import time

import torch

from perfbench import core, program
from perfbench.data import generator

STREAM_ORDER, STREAM_ROWS, STREAM_WARM = 101, 102, 103


def call_rows(traffic, held_out_rows):
    """The traffic's call sizes, each at most ``held_out_rows``."""
    sizes = [int(n) for n in traffic["call_rows"]]
    if not sizes or min(sizes) < 1 or max(sizes) > held_out_rows:
        raise ValueError(f"call_rows {sizes} are not 1 to {held_out_rows}")
    return sizes


def draw(held_out, n, g):
    """``n`` distinct rows of ``held_out`` in the order ``g`` draws."""
    return torch.randperm(held_out.shape[0], generator=g,
                          device=held_out.device)[:n]


def setup(cell, seed, device):
    adapter = cell.adapter
    t0 = time.perf_counter()
    state = adapter.prepare(cell, seed, device, 1)
    t1 = time.perf_counter()
    state.fitted = adapter.fit(state, 0, None)
    program.reset()
    t2 = time.perf_counter()
    held_out = adapter.held_out(state)
    sizes = call_rows(cell.traffic, held_out.shape[0])
    g = generator(seed, STREAM_WARM, device)
    for n in sorted(set(sizes), reverse=True):
        idx = draw(held_out, n, g)
        program.apply_classes(state.fitted, held_out[idx])
        program.clear_memo()
    order = torch.randperm(len(sizes),
                           generator=generator(seed, STREAM_ORDER, "cpu"))
    state.sizes = [sizes[i] for i in order.tolist()]
    state.rows_gen = generator(seed, STREAM_ROWS, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    core.note(f"set-up: inputs {t1 - t0:.2f} s, fit {t2 - t1:.2f} s, "
              f"{len(sizes)} warm calls {time.perf_counter() - t2:.2f} s")
    return state


def _call(state, held_out, n):
    idx = draw(held_out, n, state.rows_gen)
    t0 = time.perf_counter()
    out = program.apply_classes(state.fitted, held_out[idx])
    if held_out.device.type == "cuda":
        torch.cuda.synchronize()
    return idx, out, t0, time.perf_counter()


def window(cell, state, seconds, tracer, peak):
    adapter = cell.adapter
    held_out = adapter.held_out(state)
    calls, lat, rows, work = [], [], [], []
    start = time.perf_counter()
    end = start
    i = 0
    while time.perf_counter() < start + seconds:
        n = state.sizes[i % len(state.sizes)]
        with tracer.unit(i):
            idx, out, t0, end = _call(state, held_out, n)
        lat.append((end - t0) * 1e3)
        rows.append(n)
        calls.append((idx, out))
        program.clear_memo()
        if i < getattr(tracer, "units", 0):
            work.append(adapter.unit_work(state, "apply", n))
        i += 1
    metrics = {"apply_rows_per_s": core.whole_window_rate(rows, start, [end]),
               "apply_p95_ms": core.p95(lat)}
    return core.WindowResult(metrics, i, work, calls)


def traced_optimizer_s(cell, state):
    held_out = cell.adapter.held_out(state)
    n = state.sizes[0]
    seconds = program.optimizer_seconds(lambda: _call(state, held_out, n))
    program.clear_memo()
    return seconds


def check(cell, state, result):
    """Every call's classes against the reference's scores of the rows it
    drew. The calls' classes are kept; the fitted pipeline and the memo
    are freed before the reference runs."""
    adapter = cell.adapter
    state.fitted = None
    program.release()
    ref = adapter.reference_scores(state, 0, adapter.held_out(state),
                                   "float64")
    scale = core.scale_of(ref)
    limit = cell.workload["check"]["limit"]
    worst, failed = 0.0, 0
    for idx, out in result.outputs:
        gap = core.widest_gap(ref[idx], out, scale)
        worst = max(worst, gap)
        failed += not gap <= limit
    return {cell.workload["check"]["number"]: {"value": worst,
                                                "limit": limit}}, failed
