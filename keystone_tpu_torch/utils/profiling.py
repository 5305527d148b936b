"""A plain profiler capture.

Counterpart of ``keystone_tpu/utils/profiling.py``: :func:`trace`
captures a ``torch.profiler`` trace (CPU and, where present, CUDA
activity) of everything in scope and writes it as a Chrome trace into
``log_dir``. It activates no
:class:`~keystone_tpu_torch.observability.trace.PipelineTrace`, so the
captured timeline is an untraced run's: a pipeline trace synchronises
the device after every node, which changes overlap. The capture still
carries the program's live spans (``observability/timeline.py``): each
node as a ``<label>#<id>`` range, and the entry points', optimizer's,
block solver's and streamed ingest's ranges.
``observability.trace.profiler_trace`` is the capture with pipeline node
names. :class:`StepTimer` is re-exported from ``observability.metrics``
(deprecated there), as the JAX module does.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch

from ..observability.metrics import StepTimer  # noqa: F401 (re-export)


@contextlib.contextmanager
def trace(log_dir: str, name: str = "profile") -> Iterator[None]:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))
