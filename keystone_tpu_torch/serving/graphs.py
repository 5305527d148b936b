"""Captured bucket applies: the serving plane's CUDA graphs.

The JAX plane warms every bucket so that steady-state requests
re-dispatch compiled executables; the port's counterpart is to capture
each bucket's apply as a CUDA graph at admission and replay it per
batch, so a request costs a few copies and one graph launch instead of
the executor's walk and one launch per kernel.

* :func:`capture_apply` captures the apply on the process's capture
  stream (after :func:`warm_apply` did the lazy set-up there) into a
  private memory pool, in ``thread_local`` capture mode (other
  threads go on serving meanwhile), with the numerics gauges suppressed
  (a warmup batch is not traffic). A capture that fails raises
  :class:`CaptureError` naming the operation that broke it (the
  innermost frame outside PyTorch and Python, with its source line): a
  host read (``.item()``,
  ``.cpu()``, ``bool(tensor)``), a pageable copy or a synchronize
  inside the apply cannot be captured. There is no eager fallback.
* :class:`BucketGraph` is one bucket's graph, captured with every row
  real, with its static input buffers and its static outputs.
  :meth:`BucketGraph.replay` copies a batch's ``n`` rows in through
  pinned host memory, zeroes the rows past them, replays, and brings
  the batch's rows of the outputs to the host. A padded bucket's eager
  apply differs only by re-zeroing rows past ``n`` after each stage;
  every served stage is row-wise, so that cannot change rows ``[:n]``,
  and one graph serves every ``n`` up to its bucket with the eager
  apply's bits.
* Each graph owns a private memory pool and a lock: two workers replay
  different graphs at once, never one graph twice at once (its static
  buffers would race).
* Launch counts: a wrapper called during a capture records its launch
  into the graph without running it, and counts it in
  ``kernels.CAPTURED``, not ``kernels.LAUNCHES``; a replay does not pass
  through the wrappers. Each graph keeps the launches its capture
  recorded, and every replay adds them to :data:`REPLAYED_LAUNCHES`
  (:func:`reset_replayed_launches` sets it to zero).

Everything here is CUDA only; a CPU plane runs the eager apply.
"""
from __future__ import annotations

import os
import threading
import traceback
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..observability.compilelog import note_replay

#: kernel name -> launches made by graph replays since the last reset
#: (each replay adds the launches its graph's capture recorded)
REPLAYED_LAUNCHES: Dict[str, int] = {}
_REPLAY_LOCK = threading.Lock()


def reset_replayed_launches() -> None:
    with _REPLAY_LOCK:
        REPLAYED_LAUNCHES.clear()


class CaptureError(RuntimeError):
    """A bucket's apply could not be captured as a CUDA graph. The
    message names the operation that broke the capture; the admission
    that asked for it is refused."""


#: frames under these directories are PyTorch's or Python's own; the
#: operation named is the innermost frame outside them
_LIBRARY_DIRS = (os.path.dirname(torch.__file__),
                 os.path.dirname(os.__file__))


def _failing_operation(exc: BaseException) -> str:
    """``file:line (function: source)`` of the innermost frame of
    ``exc``'s traceback outside PyTorch and the standard library: the
    stage's own call that broke the capture."""
    frames = traceback.extract_tb(exc.__traceback__)
    if not frames:
        return "an unknown operation"
    ours = [f for f in frames
            if not f.filename.startswith(_LIBRARY_DIRS)]
    frame = (ours or frames)[-1]
    path = frame.filename
    cut = path.rfind("keystone_tpu_torch")
    if cut >= 0:
        path = path[cut:]
    return f"{path}:{frame.lineno} ({frame.name}: {frame.line})"


#: the graphs a plane keeps (its memo's bound): an entry dropped for
#: room is captured again on its next request, counted as unexpected, so
#: the bound holds 73 models' 7 graphs at ``max_batch=64``
GRAPHS_KEPT = 512

_STREAMS: Dict[str, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The one side stream the process captures on, per device. cuBLAS
    keeps a workspace per stream; made by an eager apply on this stream
    before any capture (:func:`warm_apply`), it lives outside every
    graph's pool, where a capture on a fresh stream would put one into
    its pool."""
    key = str(device)
    stream = _STREAMS.get(key)
    if stream is None:
        stream = _STREAMS[key] = torch.cuda.Stream(device)
    return stream


def warm_apply(fitted: Any, inputs: Any, n: int,
               device: torch.device) -> None:
    """One eager apply of ``fitted`` to ``inputs`` on the capture stream:
    the lazy set-up (launch plans, quantized weights, the d splits of
    this batch size, cuBLAS's workspace) happens here, outside the
    graph. A fresh dataset object, so nothing is served from a memo of
    it. The caller holds the capture lock."""
    from ..observability.numerics import numerics_suppressed
    from ..parallel.dataset import ArrayDataset

    side = capture_stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with numerics_suppressed(), torch.cuda.stream(side):
        fitted.apply(ArrayDataset(inputs, n)).get()
    torch.cuda.current_stream(device).wait_stream(side)


def capture_apply(fitted: Any, inputs: Any, n: int, device: torch.device,
                  what: str
                  ) -> Tuple[torch.cuda.CUDAGraph, Any, Dict[str, int]]:
    """Capture the apply of ``fitted`` to the static ``inputs`` (a tensor
    tree of the bucket's rows) holding ``n`` real rows, as a CUDA graph;
    returns the graph, the output dataset (its tensors are the graph's
    static outputs) and the kernel launches the capture recorded. The
    dataset is made inside the capture: where ``n`` is below the rows it
    copies the inputs with the rows past ``n`` zeroed, and that copy must
    be part of the graph, or every replay would read the rows of the
    capture. ``what`` names the capture in a :class:`CaptureError`. The
    caller holds the capture lock (``observability/compilelog.py``)."""
    from ..observability.numerics import numerics_suppressed
    from ..ops import kernels
    from ..parallel.dataset import ArrayDataset

    graph = torch.cuda.CUDAGraph()
    side = capture_stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    before = dict(kernels.CAPTURED)
    with numerics_suppressed(), torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            out = fitted.apply(ArrayDataset(inputs, n)).get()
        except BaseException as exc:
            try:  # end the broken capture; its own error adds nothing
                graph.capture_end()
            except Exception:  # noqa: BLE001
                pass
            raise CaptureError(
                f"CUDA graph capture of {what} failed at "
                f"{_failing_operation(exc)}: {type(exc).__name__}: "
                f"{exc}") from exc
        try:
            graph.capture_end()
        except Exception as exc:
            raise CaptureError(
                f"CUDA graph capture of {what} failed when it ended (an "
                f"operation of the apply left the capture invalid): "
                f"{type(exc).__name__}: {exc}") from exc
    torch.cuda.current_stream(device).wait_stream(side)
    launches = {k: v - before.get(k, 0) for k, v in kernels.CAPTURED.items()
                if v != before.get(k, 0)}
    return graph, out, launches


def _leaves(tree: Any) -> List[Any]:
    return pytree.tree_leaves(tree)


class BucketGraph:
    """One captured bucket apply; see the module docstring."""

    def __init__(self, graph: torch.cuda.CUDAGraph, inputs: Any,
                 outputs: Any, bucket: int, launches: Dict[str, int],
                 pool_nbytes: float, site: str = ""):
        self.graph = graph
        #: the capture site, whose replays the observatory counts
        self.site = site
        self.inputs = _leaves(inputs)
        self.outputs = outputs
        self.bucket = int(bucket)
        self.launches = dict(launches)
        self.pool_nbytes = float(pool_nbytes)
        self._staging = [torch.empty(x.shape, dtype=x.dtype,
                                     pin_memory=True) for x in self.inputs]
        self._lock = threading.Lock()

    def replay(self, x_tree: Any, n: int) -> Any:
        """The graph's outputs for the ``n`` rows of the host batch
        ``x_tree``, as host numpy (the eager path's ``.numpy()``)."""
        leaves = _leaves(x_tree)
        with self._lock:
            for dst, host, src in zip(self.inputs, self._staging, leaves):
                host[:n].copy_(torch.from_numpy(np.ascontiguousarray(src)))
                # the pinned staging makes the copy asynchronous; the
                # next write to it follows this replay's read-back
                dst[:n].copy_(host[:n], non_blocking=True)
                if n < self.bucket:
                    dst[n:].zero_()
            self.graph.replay()
            out = pytree.tree_map(lambda t: t[:n].cpu().numpy(),
                                  self.outputs)
        if self.site:
            note_replay(self.site)
        if self.launches:
            with _REPLAY_LOCK:
                for name, count in self.launches.items():
                    REPLAYED_LAUNCHES[name] = (REPLAYED_LAUNCHES.get(name, 0)
                                               + count)
        return out
