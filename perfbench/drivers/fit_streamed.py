"""Back-to-back fits of a pipeline that streams its training set from
host memory.

The window, the metrics and the check are ``fit_resident``'s, the rate
named ``streamed_fit_rows_per_s``; each fit reads its training set
through a ``StreamingDataset`` made anew for it.
Traffic parameters: ``train_sets`` and ``stream``, which holds
``chunk_rows``, ``prefetch_depth`` and ``budget_chunks`` (the stream's
``hbm_budget`` is that many chunks plus 1 MiB). The training sets live
in host memory only; the check moves them to the device for the
reference.
"""
from __future__ import annotations

from perfbench import core

_fit = core.load_module("drivers", "fit_resident")


def setup(cell, seed, device):
    return _fit.setup(cell, seed, device, cell.traffic["stream"])


def window(cell, state, seconds, tracer, peak):
    """``fit_resident``'s window; its rate is reported as
    ``streamed_fit_rows_per_s``: a streamed fit is paced by the host's
    staging of each chunk, and its runs spread about ten times as widely
    as a resident fit's, so it has a metric and a bound of its own."""
    result = _fit.window(cell, state, seconds, tracer, peak,
                         cell.traffic["stream"])
    result.metrics["streamed_fit_rows_per_s"] = result.metrics.pop(
        "fit_rows_per_s")
    return result


def traced_optimizer_s(cell, state):
    return _fit.traced_optimizer_s(cell, state, cell.traffic["stream"])


check = _fit.check
