"""The harness's few generic calls into the program (``keystone_tpu_torch``):
datasets, the prefix memo, a pipeline's classes, the optimizer's
record. The program is imported inside each function, so importing the
harness loads nothing of it."""
from __future__ import annotations

import gc


def reset() -> None:
    """Drop the prefix memo (``PipelineEnv.reset()``), so the next fit is
    a new job. (No collection: a fit leaves no cyclic garbage that holds
    device memory, and a full ``gc.collect()`` of the port's heap costs
    about 0.1 s of the host.)"""
    from keystone_tpu_torch.workflow.env import PipelineEnv

    PipelineEnv.reset()


def release() -> None:
    """:func:`reset`, collect, and hand the allocator's cached blocks
    back, before the reference runs."""
    import torch

    reset()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def clear_memo() -> None:
    """Empty the prefix memo (``PipelineEnv``'s ``state``), keeping the
    optimizer: every apply call memoizes its batch's features there, so
    the memo grows by each call's features until it is emptied."""
    from keystone_tpu_torch.workflow.env import PipelineEnv

    PipelineEnv.get_or_create().clear_state()


def apply_classes(fitted, rows):
    """The classes a fitted pipeline gives the (n, ...) tensor ``rows``:
    an (n,) integer tensor where the rows lie."""
    from torch.profiler import record_function

    from keystone_tpu_torch.parallel.dataset import ArrayDataset

    with record_function("pipeline.apply"):
        out = fitted.apply(ArrayDataset(rows, rows.shape[0])).get()
    return out.data[:out.n]


def optimizer_seconds(unit):
    """Host seconds the optimizer's passes took in ``unit()``, run under
    a ``PipelineTrace`` (its ``meta["optimizer_runs"][*]["wall_s"]``);
    None if it recorded none."""
    from keystone_tpu_torch.observability.numerics import numerics_suppressed
    from keystone_tpu_torch.observability.trace import PipelineTrace

    # the numerics plane's health words are not what this reads, and they
    # fail on a node output of 2**31 values or more (TIMIT's features)
    with numerics_suppressed(), PipelineTrace("perfbench") as tr:
        out = unit()
    del out
    reset()
    runs = tr.meta.get("optimizer_runs", [])
    return sum(r["wall_s"] for r in runs) if runs else None
