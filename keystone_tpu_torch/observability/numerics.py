"""Numerics and data-health: the third observability plane.

Counterpart of ``keystone_tpu/observability/numerics.py``. The first
two planes watch the machine; this one watches the numbers:

* health words: :func:`health_word` reduces each tensor leaf to one row
  ``[finite, nan, inf, min, max, sum, sumsq]`` on its device,
  with a row mask keeping a zero-padded tail out of every statistic.
  ``fit_streaming`` computes one per chunk (:class:`HealthMonitor`) and
  copies it into pinned host memory behind an event; the host reads it
  ``defer`` chunks later (``KEYSTONE_TORCH_NUMERICS_DEFER``, default 8),
  by which time the copy has long finished, so the check adds no host
  synchronisation to the chunk loop. The traced executor checks node
  outputs the same way (:func:`check_node_output`), after the sync the
  trace already makes.
* tripwires: a non-finite word raises :class:`NumericsError` through a
  post-mortem that holds the recent health series, naming the chunk and
  stream, the node, or the fitted model. ``KEYSTONE_TORCH_NUMERICS=0``
  turns the plane off; :func:`numerics_suppressed` suspends it for a
  block (the overhead measurement's off leg).
* the solver ledger: the Cholesky gates of ``ops/linalg.py`` already
  read the factor's status and the scale-free pivot ratio on the host;
  :func:`record_solve_health` / :func:`record_block_health` record
  them (``numerics.pivot_ratio``, one ``numerics.breakdown`` event per
  eigh fallback taken).
* drift: :class:`SketchTracker` keeps fixed-bin histograms of up to 64
  evenly spaced feature columns through a streamed fit; its state rides
  the stream checkpoint, and the frozen :class:`DriftBaseline` rides
  the fitted model (``model.numerics_baseline``), with the PSI of
  another histogram against it. :func:`score_drift` scores apply-time
  inputs against it (the serving plane every ``drift_every`` batches),
  warning past :func:`drift_threshold`. The monitor's CUDA graph capture
  of the health word is recorded by the capture observatory
  (``observability/compilelog.py``), once per geometry.

Events go through :func:`record_numerics_event`: the
``numerics.<event>`` counter, an instant on the flight recorder and the
active trace's numerics stream.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .compilelog import note_replay, observed_capture
from .metrics import MetricsRegistry
from .timeline import record_instant
from .trace import current_trace

#: health-word columns, per leaf
_W_FINITE, _W_NAN, _W_INF, _W_MIN, _W_MAX, _W_SUM, _W_SUMSQ = range(7)
_W_COLS = 7

#: drift-sketch geometry: 16 bins over at most 64 feature columns
SKETCH_BINS = 16
SKETCH_MAX_COLS = 64

#: PSI smoothing pseudo-count per bin
_PSI_ALPHA = 0.5


class NumericsError(RuntimeError):
    """A tripwire fired: non-finite values in a streamed chunk, a traced
    node's output or fitted weights. ``exc.postmortem_path`` names the
    artifact holding the recent health series."""


# -- gating -------------------------------------------------------------------

_SUPPRESS_DEPTH = 0


def numerics_enabled() -> bool:
    """The process switch (``KEYSTONE_TORCH_NUMERICS=0`` turns it off)."""
    return os.environ.get("KEYSTONE_TORCH_NUMERICS", "1") != "0"


def numerics_active() -> bool:
    """Enabled and not inside :func:`numerics_suppressed`."""
    return _SUPPRESS_DEPTH == 0 and numerics_enabled()


@contextlib.contextmanager
def numerics_suppressed() -> Iterator[None]:
    """Suspend the plane's work for the block."""
    global _SUPPRESS_DEPTH
    _SUPPRESS_DEPTH += 1
    try:
        yield
    finally:
        _SUPPRESS_DEPTH -= 1


def _defer_depth() -> int:
    raw = os.environ.get("KEYSTONE_TORCH_NUMERICS_DEFER")
    if not raw:
        return 8
    try:
        depth = int(raw)
    except ValueError:
        raise ValueError(f"KEYSTONE_TORCH_NUMERICS_DEFER must be an "
                         f"integer, got {raw!r}") from None
    if depth < 1:
        raise ValueError("KEYSTONE_TORCH_NUMERICS_DEFER must be >= 1")
    return depth


def record_numerics_event(event: str, **fields: Any) -> None:
    """One numerics event into the counter, the timeline and the trace
    (``nonfinite`` / ``nonfinite_model`` / ``breakdown`` /
    ``drift_score`` / ``drift_warn`` / ``fit_baseline``)."""
    MetricsRegistry.get_or_create().counter(f"numerics.{event}").inc()
    record_instant(event, "numerics", args=fields or None)
    trace = current_trace()
    if trace is not None:
        trace.record_numerics({"event": event, **fields})


# -- health words -------------------------------------------------------------

def _leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _leaf_word(x: torch.Tensor, mask: Optional[torch.Tensor],
               rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """One leaf's ``(7,)`` float64 word on its device. Every operand stays
    there (python scalars, no tensor made from a host value), so nothing
    here waits for the host, and a CUDA graph can hold it. A leaf with no
    finite value gets placeholder bounds, which :func:`word_stats`
    skips."""
    if rows is not None and x.dim() >= 1 and x.shape[0] == rows[1]:
        x, mask = x[:rows[0]], None  # pad rows are the tail: a view
    x32 = x.to(torch.float32)
    # the finite values with the others zeroed, and which ones they are
    # (torch.isfinite would take four passes)
    z = torch.nan_to_num(x32, nan=0.0, posinf=0.0, neginf=0.0)
    finite = z == x32
    nan = x32 != x32
    n_total = x32.numel()
    if mask is not None and x32.dim() >= 1 and x32.shape[0] == mask.shape[0]:
        # pad rows leave every statistic; a leaf whose leading dim is
        # not the row axis keeps the unmasked reduction
        live = mask.to(torch.bool).reshape((-1,) + (1,) * (x32.dim() - 1))
        nan = nan & live
        finite = finite & live
        z = torch.where(live, z, 0.0)
        n_total = (live.view(torch.uint8).sum(dtype=torch.int32)
                   * (n_total // x32.shape[0]))
    # counts in int32 (exact to 2^31 values; a bool tensor summed as
    # bytes takes half the time of a bool sum), carried as float64
    n_fin = finite.view(torch.uint8).sum(dtype=torch.int32)
    n_nan = nan.view(torch.uint8).sum(dtype=torch.int32)
    counts = torch.stack([n_fin, n_nan, n_total - n_fin - n_nan]).to(
        torch.float64)
    if x32.numel():
        # one pass for both bounds: every non-finite (or pad) value is
        # replaced by the first counted finite one, which the bounds of
        # the finite values already cover (index_select: indexing with a
        # 0-dim tensor would read it on the host)
        first = torch.argmax(finite.reshape(-1).view(torch.uint8))
        fill = x32.reshape(-1).index_select(0, first.reshape(1))
        lo, hi = torch.aminmax(torch.where(finite, x32, fill))
    else:
        lo = hi = torch.zeros((), device=x32.device)
    return torch.cat([counts, torch.stack(
        [lo, hi, z.sum(), torch.linalg.vector_norm(z) ** 2])])


def health_word(tree: Any, mask: Optional[torch.Tensor] = None,
                rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``(leaves, 7)`` float64 health word of a tensor or tuple of
    tensors, on their device: ``[finite, nan, inf, min, max, sum,
    sumsq]`` a leaf (:func:`word_stats` reads it). With ``mask`` (a
    chunk's row mask), pad rows are excluded from every statistic of
    each leaf whose leading dimension is the row axis; ``rows = (n,
    padded_n)`` says the same of a chunk whose pad rows are its tail,
    for fewer passes (each such leaf is read as its first n rows).
    Counts are exact; the moments are float32 sums."""
    return torch.stack([_leaf_word(x, mask, rows) for x in _leaves(tree)])


def word_stats(word: Any) -> Dict[str, float]:
    """Host summary of one health word: counts and bounds across leaves
    (those with a finite value), the largest magnitude, mean and
    variance from the raw moments."""
    w = np.asarray(word, dtype=np.float64).reshape(-1, _W_COLS)
    live = w[:, _W_FINITE] > 0
    finite = float(w[:, _W_FINITE].sum())
    mean = float(w[:, _W_SUM].sum() / finite) if finite else 0.0
    var = (max(float(w[:, _W_SUMSQ].sum() / finite) - mean * mean, 0.0)
           if finite else 0.0)
    lo, hi = w[live, _W_MIN], w[live, _W_MAX]
    return {"finite": finite, "nan": float(w[:, _W_NAN].sum()),
            "inf": float(w[:, _W_INF].sum()),
            "min": float(lo.min()) if finite else 0.0,
            "max": float(hi.max()) if finite else 0.0,
            "absmax": float(np.maximum(np.abs(lo), np.abs(hi)).max())
            if finite else 0.0,
            "mean": mean, "var": var}


_SERIES_CAP = 256
_HEALTH_SERIES: deque = deque(maxlen=_SERIES_CAP)
_SERIES_LOCK = threading.Lock()
_LAST_HEALTH_TS: List[float] = [0.0]


def _push_series(entry: Dict[str, Any]) -> None:
    with _SERIES_LOCK:
        _HEALTH_SERIES.append(entry)
        _LAST_HEALTH_TS[0] = time.time()


def recent_health(n: int = 64) -> List[Dict[str, Any]]:
    """The most recent ``n`` health entries, newest last."""
    with _SERIES_LOCK:
        items = list(_HEALTH_SERIES)
    return items[-n:]


def last_health_age_s() -> float:
    """Seconds since the last health word was read, -1.0 before the
    first (the sampler's ``numerics.health_age_s`` probe)."""
    with _SERIES_LOCK:
        ts = _LAST_HEALTH_TS[0]
    return time.time() - ts if ts else -1.0


def reset_health_series() -> None:
    """Drop the health series (tests)."""
    with _SERIES_LOCK:
        _HEALTH_SERIES.clear()
        _LAST_HEALTH_TS[0] = 0.0


def _tripwire(entry: Dict[str, Any], what: str,
              context: Dict[str, Any]) -> NumericsError:
    """The raise-ready tripwire error: counters, the event, and a
    post-mortem holding the recent health series."""
    from .postmortem import attach_postmortem

    reg = MetricsRegistry.get_or_create()
    reg.counter("numerics.nan_total").inc(entry["nan"])
    reg.counter("numerics.inf_total").inc(entry["inf"])
    record_numerics_event("nonfinite", **context, nan=entry["nan"],
                          inf=entry["inf"])
    exc = NumericsError(
        f"non-finite values detected in {what}: nan={int(entry['nan'])} "
        f"inf={int(entry['inf'])} (finite min={entry['min']:.4g} "
        f"max={entry['max']:.4g}); fix the producing stage or the data. "
        "The post-mortem holds the recent health series "
        "(KEYSTONE_TORCH_NUMERICS=0 turns the tripwire off)")
    return attach_postmortem(
        exc, "numerics_tripwire",
        {**context, "nan": entry["nan"], "inf": entry["inf"],
         "recent_health": recent_health()})


#: (flat size, device, thread) -> (graph, flat input, word): the health
#: word of a chunk geometry captured once a process and thread, since a
#: capture costs 5-15 ms of host time, more than a streamed fit's words
#: take to replay; each entry holds its input and its intermediates
#: (about 110 MiB at 1024 x 8192), the least recently used dropped
#: beyond _WORD_GRAPHS_KEPT
_WORD_GRAPHS: "OrderedDict[Tuple[int, str, int], Tuple[Any, ...]]" = \
    OrderedDict()
_WORD_GRAPHS_KEPT = 2


def _word_graph(key: Tuple[int, str, int], device: torch.device):
    """The cached graph of ``key``, captured on first use: the health
    word of a flat float32 input of ``key[0]`` values."""
    hit = _WORD_GRAPHS.get(key)
    if hit is not None:
        _WORD_GRAPHS.move_to_end(key)
        return hit
    flat = torch.empty(key[0], dtype=torch.float32, device=device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        health_word(flat)  # lazy initialisation off the graph
        # recorded by the capture observatory, once per geometry
        with observed_capture("numerics.health_word", "monitor"):
            # thread_local: the stager's thread may copy meanwhile
            graph.capture_begin(capture_error_mode="thread_local")
            word = health_word(flat)
            graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(side)
    _WORD_GRAPHS[key] = hit = (graph, flat, word)
    if len(_WORD_GRAPHS) > _WORD_GRAPHS_KEPT:
        _WORD_GRAPHS.popitem(last=False)
    return hit


class HealthMonitor:
    """Per-fit chunk health for ``fit_streaming``: one health word a
    chunk, read on the host ``defer`` chunks later. On a CUDA chunk the
    word is copied into pinned host memory (a copy into pageable memory
    would be synchronous) behind an event that is waited on only when
    the word is read. A CUDA chunk's word comes from a CUDA graph over
    one flat copy of its leaves (one word for all of them, which
    :func:`word_stats` reads the same), captured at the second chunk of
    a geometry and kept for later fits: one replay a chunk where the
    eager word takes some thirty launches, each tens of microseconds of
    host time. Driver thread only."""

    def __init__(self, source: str, defer: Optional[int] = None):
        self.source = source
        self.defer = _defer_depth() if defer is None else int(defer)
        if self.defer < 1:
            raise ValueError("defer must be >= 1")
        self._pending: deque = deque()  # (chunk idx, host word, event)
        #: pinned host words in rotation: a slot is written again only
        #: after the word it held was read (defer + 1 slots)
        self._ring: List[torch.Tensor] = []
        self._slot = 0
        self.checked = 0
        self._last_n = -1  # the last geometry whose word was eager

    def _replayed_word(self, leaves: List[torch.Tensor]
                       ) -> Optional[torch.Tensor]:
        """The word of a CUDA chunk's leaves from a captured graph (see
        :func:`_word_graph`), captured at the second chunk of a geometry
        the process has not captured yet; None for a geometry seen once
        (a ragged tail), whose word is computed eagerly."""
        n = sum(x.numel() for x in leaves)
        key = (n, str(leaves[0].device), threading.get_ident())
        if key not in _WORD_GRAPHS and n != self._last_n:
            self._last_n = n
            return None
        graph, flat, word = _word_graph(key, leaves[0].device)
        torch.cat([x.reshape(-1) for x in leaves], out=flat)
        graph.replay()
        note_replay("numerics.health_word")
        return word

    def observe(self, chunk_idx: int, *trees: Any,
                mask: Optional[torch.Tensor] = None,
                rows: Optional[Tuple[int, int]] = None) -> None:
        """Queue one chunk's health word (``mask`` or ``rows``: see
        :func:`health_word`) and read the words older than the window."""
        data = tuple(t for t in trees if t is not None)
        if not data:
            return
        word = None
        leaves = _leaves(data)
        if mask is None and all(x.device.type == "cuda" for x in leaves):
            word = self._replayed_word([
                x[:rows[0]] if rows is not None and x.dim() >= 1
                and x.shape[0] == rows[1] else x for x in leaves])
        if word is None:
            word = health_word(data, mask, rows)
        event = None
        if word.device.type == "cuda":
            if len(self._ring) <= self.defer:
                self._ring.append(torch.empty(word.shape, dtype=word.dtype,
                                              pin_memory=True))
            host = self._ring[self._slot % len(self._ring)]
            if host.shape != word.shape:
                host = self._ring[self._slot % len(self._ring)] = \
                    torch.empty(word.shape, dtype=word.dtype,
                                pin_memory=True)
            self._slot += 1
            host.copy_(word, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            word = host
        self._pending.append((chunk_idx, word, event))
        while len(self._pending) > self.defer:
            self._drain_one()

    def _drain_one(self) -> None:
        idx, word, event = self._pending.popleft()
        if event is not None:
            event.synchronize()
        entry = {"source": self.source, "chunk": idx,
                 **word_stats(word.numpy())}
        _push_series(entry)
        self.checked += 1
        MetricsRegistry.get_or_create().counter("numerics.health_words").inc()
        if entry["nan"] or entry["inf"]:
            raise _tripwire(entry, f"chunk {idx} of stream {self.source!r}",
                            {"source": self.source, "chunk": idx})

    def flush(self) -> None:
        """Read and check every pending word (end of the chunk loop, and
        before each checkpoint save: a snapshot must not hold a carry
        that a chunk still unchecked poisoned)."""
        while self._pending:
            self._drain_one()


def _float_leaves(value: Any) -> List[torch.Tensor]:
    """Float tensors worth checking in a value: an ArrayDataset's data,
    a tensor, or the public tensor attributes of a fitted transformer."""
    tree = value
    if hasattr(value, "data") and hasattr(value, "mask") \
            and hasattr(value, "n"):
        tree = value.data
    elif not isinstance(value, torch.Tensor) and hasattr(value, "__dict__"):
        tree = [v for k, v in vars(value).items() if not k.startswith("_")]
    out = []

    def walk(v):
        if isinstance(v, (tuple, list)):
            for x in v:
                walk(x)
        elif isinstance(v, torch.Tensor) and torch.is_floating_point(v):
            out.append(v)
        elif isinstance(v, np.ndarray) and np.issubdtype(v.dtype,
                                                         np.floating):
            out.append(torch.from_numpy(v))

    walk(tree)
    return out


def check_node_output(value: Any, node: str) -> Optional[Dict[str, Any]]:
    """Traced-executor hook: check one node's output (the executor has
    synchronised already). Raises :class:`NumericsError` with a
    post-mortem on non-finite values; returns the health entry, or None
    when the plane is off or the value holds no float tensors."""
    if not numerics_active():
        return None
    try:
        mask = (value.mask if hasattr(value, "data")
                and hasattr(value, "mask") and hasattr(value, "n") else None)
        leaves = _float_leaves(value)
        if not leaves:
            return None
        word = torch.cat([health_word(x, mask).cpu()
                          for x in leaves]).numpy()
    except Exception:
        return None  # an exotic value must never break execution
    entry = {"source": f"node:{node}", **word_stats(word)}
    _push_series(entry)
    MetricsRegistry.get_or_create().counter("numerics.health_words").inc()
    if entry["nan"] or entry["inf"]:
        raise _tripwire(entry, f"the output of pipeline node {node}",
                        {"node": node})
    return entry


def check_fitted(model: Any, source: str) -> None:
    """Tripwire over a fitted model's float arrays at finalize: the
    solvers' recovery paths guarantee finite weights, so a non-finite
    one means a recovery was bypassed."""
    if not numerics_active():
        return
    try:
        leaves = _float_leaves(model)
        if not leaves:
            return
        # one word a device over all the leaves, one host read each
        flat: Dict[torch.device, List[torch.Tensor]] = {}
        for x in leaves:
            flat.setdefault(x.device, []).append(
                x.reshape(-1).to(torch.float32))
        word = torch.cat([health_word(torch.cat(xs)).cpu()
                          for xs in flat.values()]).numpy()
    except Exception:
        return
    entry = {"source": f"fitted:{source}", **word_stats(word)}
    _push_series(entry)
    if entry["nan"] or entry["inf"]:
        record_numerics_event("nonfinite_model", source=source,
                              nan=entry["nan"], inf=entry["inf"])
        raise _tripwire(entry, f"the fitted model from {source!r}",
                        {"source": source, "phase": "finalize"})


# -- solver conditioning ledger ----------------------------------------------

def record_solve_health(site: str, ok: bool, pivot_ratio: float) -> None:
    """One Cholesky solve's gate, from values the solver already read on
    the host: ``ok`` False is exactly the eigh fallback taken."""
    if not numerics_active():
        return
    reg = MetricsRegistry.get_or_create()
    reg.counter("numerics.solves_total").inc()
    ratio = float(pivot_ratio)
    if np.isfinite(ratio):
        reg.histogram("numerics.pivot_ratio").observe(ratio)
    if not ok:
        reg.counter("numerics.breakdown_total").inc()
        record_numerics_event("breakdown", site=site,
                              pivot_ratio=ratio if np.isfinite(ratio)
                              else None)


def record_block_health(site: str, oks: Sequence[bool],
                        ratios: Sequence[float]) -> None:
    """A blocked solver's gates (one entry per block)."""
    if not numerics_active():
        return
    reg = MetricsRegistry.get_or_create()
    reg.counter("numerics.solves_total").inc(len(oks))
    hist = reg.histogram("numerics.pivot_ratio")
    for r in ratios:
        if np.isfinite(r):
            hist.observe(float(r))
    for i, ok in enumerate(oks):
        if not ok:
            reg.counter("numerics.breakdown_total").inc()
            r = float(ratios[i])
            record_numerics_event("breakdown", site=site, block=i,
                                  pivot_ratio=r if np.isfinite(r) else None)


# -- distribution-drift sketch -----------------------------------------------

def _select_cols(d: int, max_cols: int) -> np.ndarray:
    f = min(d, max_cols)
    return (np.arange(f, dtype=np.int64) * d // f).astype(np.int32)


def _bin_geometry(interior: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(start, step)`` of the uniform bin grid behind the stored
    interior edges, derived the same way at fit and at apply time."""
    interior = np.asarray(interior, np.float32)
    if interior.shape[1] < 2:
        raise ValueError("sketch needs >= 3 bins (>= 2 interior edges)")
    step = interior[:, 1] - interior[:, 0]
    start = interior[:, 0] - step
    return start.astype(np.float32), step.astype(np.float32)


def _sketch_update(counts: torch.Tensor, start: torch.Tensor,
                   step: torch.Tensor, cols: torch.Tensor,
                   X: torch.Tensor) -> None:
    """Fold the rows of X (a chunk's live rows) into the ``(F, B)``
    counts in place: the bin index is arithmetic on the uniform grid,
    out-of-range values clamp into the end bins, NaNs land in bin 0 (the
    tripwire owns them). The counts are whole numbers in float32, so
    adding them in any order gives the same bits; ``index_add_`` needs
    no host read (``one_hot`` checks its indices on the host)."""
    F, B = counts.shape
    Xs = X.index_select(1, cols).to(torch.float32)
    idx = torch.floor((Xs - start[None, :]) / step[None, :])
    idx = torch.where(torch.isnan(idx), torch.zeros_like(idx), idx)
    idx = idx.clamp(0, B - 1).to(torch.int64)
    flat = idx + torch.arange(F, device=idx.device)[None, :] * B
    counts.view(-1).index_add_(
        0, flat.reshape(-1), torch.ones(flat.numel(), dtype=counts.dtype,
                                        device=counts.device))


@dataclass
class DriftBaseline:
    """The frozen fit-time sketch: per-column fixed-bin counts over
    ``cols`` with shared ``interior`` boundaries, plain numpy (it
    pickles with checkpoints and saved pipelines)."""

    cols: np.ndarray       # (F,) int32 feature indices
    interior: np.ndarray   # (F, B-1) float32 interior bin boundaries
    counts: np.ndarray     # (F, B) float32 per-bin row counts
    rows: float            # true row count
    source: str = "fit"

    def state(self) -> Dict[str, Any]:
        return {"cols": self.cols, "interior": self.interior,
                "counts": self.counts, "rows": self.rows,
                "source": self.source}

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "DriftBaseline":
        return cls(cols=np.asarray(state["cols"], np.int32),
                   interior=np.asarray(state["interior"], np.float32),
                   counts=np.asarray(state["counts"], np.float32),
                   rows=float(state["rows"]),
                   source=str(state.get("source", "fit")))

    def merge(self, other: "DriftBaseline") -> "DriftBaseline":
        """The sum of two sketches of one geometry: fixed bins make
        per-rank sketches mergeable (the world's ``merge_baselines``)."""
        if (not np.array_equal(self.cols, other.cols)
                or not np.array_equal(self.interior, other.interior)):
            raise ValueError(
                "cannot merge drift sketches with different geometry "
                "(columns/bin edges must match — build both from one "
                "baseline's edges)")
        return DriftBaseline(
            cols=self.cols, interior=self.interior,
            counts=self.counts + other.counts,
            rows=self.rows + other.rows, source=self.source)

    def psi(self, counts: np.ndarray) -> np.ndarray:
        """Per-column Population Stability Index of ``counts`` (same
        geometry) against this baseline, each histogram normalized to
        its own mass."""
        b = self.counts.astype(np.float64) + _PSI_ALPHA
        q = np.asarray(counts, np.float64) + _PSI_ALPHA
        b /= b.sum(axis=1, keepdims=True)
        q /= q.sum(axis=1, keepdims=True)
        return np.sum((q - b) * np.log(q / b), axis=1)


def _eligible_leaf(chunk) -> Optional[torch.Tensor]:
    """A chunk's one 2-D float tensor, cut to its live rows (the pad
    rows are the tail), or None."""
    x = chunk.data
    if not isinstance(x, torch.Tensor) or x.dim() != 2 \
            or not torch.is_floating_point(x):
        return None
    return x[:chunk.n]


class SketchTracker:
    """The fit-time feature sketch, chunk by chunk. Chunk 1 pins the bin
    edges from its per-column ranges over live rows, padded 5% each side,
    computed on the chunk's device in float64 as the JAX package does on
    the host (the same IEEE operations, so the same edges), with no host
    read; later chunks are one fixed-shape update each. The edges and
    counts come to the host for a snapshot and the baseline. Data other
    than one 2-D float tensor disables the tracker for the fit (baseline
    None, never an error)."""

    def __init__(self, bins: int = SKETCH_BINS,
                 max_cols: int = SKETCH_MAX_COLS, source: str = "fit"):
        if bins < 3:
            raise ValueError("bins must be >= 3")
        self.bins = int(bins)
        self.max_cols = int(max_cols)
        self.source = source
        self.cols: Optional[np.ndarray] = None
        self._interior: Optional[torch.Tensor] = None  # on the device
        self._dev = None  # (cols, start, step) on the chunks' device
        self._counts: Optional[torch.Tensor] = None
        self.rows = 0.0
        self.disabled = False

    @property
    def interior(self) -> Optional[np.ndarray]:
        """The interior bin edges, (columns, bins - 1) float32, on the
        host."""
        return None if self._interior is None else \
            self._interior.cpu().numpy()

    def _put_geometry(self, interior: torch.Tensor,
                      cols: torch.Tensor) -> None:
        """Pin the edges, the columns and the uniform grid behind the
        edges (as :func:`_bin_geometry`), all on the edges' device."""
        self._interior = interior
        step = interior[:, 1] - interior[:, 0]
        self._dev = (cols, interior[:, 0] - step, step)

    def _init_edges(self, X: torch.Tensor) -> None:
        d = int(X.shape[1])
        self.cols = _select_cols(d, self.max_cols)
        f = len(self.cols)
        cols = torch.arange(f, device=X.device) * d // f
        Xs = X.index_select(1, cols).to(torch.float32)
        if Xs.shape[0]:
            lo, hi = (t.to(torch.float64) for t in torch.aminmax(Xs, dim=0))
        else:
            lo = torch.full((f,), float("inf"), dtype=torch.float64,
                            device=X.device)
            hi = -lo
        span = torch.where(torch.isfinite(hi - lo), hi - lo, 1.0)
        lo = torch.where(torch.isfinite(lo), lo, 0.0)
        pad = 0.05 * span + 1e-6
        start, width = lo - pad, span + 2 * pad
        steps = torch.arange(1, self.bins, dtype=torch.float32,
                             device=X.device) / self.bins
        self._put_geometry((start[:, None] + width[:, None] * steps[None, :]
                            ).to(torch.float32), cols)
        self._counts = torch.zeros((f, self.bins), dtype=torch.float32,
                                   device=X.device)

    def update(self, chunk) -> None:
        """Fold one chunk's live rows into the sketch."""
        if self.disabled:
            return
        X = _eligible_leaf(chunk)
        if X is None:
            self.disabled = True
            return
        if self.cols is None:
            self._init_edges(X)
        _sketch_update(self._counts, *self._dev[1:], self._dev[0], X)
        self.rows += float(chunk.n)

    def state(self) -> Optional[Dict[str, Any]]:
        """Host snapshot for the stream checkpoint; None when the tracker
        never saw an eligible chunk."""
        if self.disabled or self.cols is None:
            return None
        return {"cols": self.cols, "interior": self.interior,
                "counts": self._counts.cpu().numpy(), "rows": self.rows,
                "bins": self.bins, "source": self.source}

    def restore(self, state: Optional[Dict[str, Any]],
                device: torch.device) -> None:
        """Resume from a checkpointed snapshot."""
        if not state:
            return
        self.bins = int(state["bins"])
        self.cols = np.asarray(state["cols"], np.int32)
        self._put_geometry(
            torch.as_tensor(np.asarray(state["interior"], np.float32),
                            device=device),
            torch.as_tensor(self.cols.astype(np.int64), device=device))
        self._counts = torch.as_tensor(
            np.asarray(state["counts"], np.float32), device=device).clone()
        self.rows = float(state["rows"])
        self.source = str(state.get("source", self.source))

    def baseline(self) -> Optional[DriftBaseline]:
        if self.disabled or self.cols is None:
            return None
        return DriftBaseline(self.cols, self.interior,
                             self._counts.cpu().numpy().astype(np.float32),
                             self.rows, self.source)


def drift_threshold() -> float:
    """PSI warn threshold (``KEYSTONE_TORCH_DRIFT_THRESHOLD``, default
    0.2, the classical boundary of a significant population shift)."""
    raw = os.environ.get("KEYSTONE_TORCH_DRIFT_THRESHOLD")
    if not raw:
        return 0.2
    try:
        value = float(raw)
    except ValueError:
        raise ValueError(f"KEYSTONE_TORCH_DRIFT_THRESHOLD must be a float, "
                         f"got {raw!r}") from None
    if value <= 0:
        raise ValueError("KEYSTONE_TORCH_DRIFT_THRESHOLD must be > 0")
    return value


def _sketch_counts(baseline: DriftBaseline, data) -> Tuple[np.ndarray,
                                                           float]:
    """Histogram ``data``'s live rows with the baseline's geometry (the
    comparable half of a PSI pair). ``data``: an ArrayDataset, a
    StreamingDataset (chunk by chunk) or a host array."""
    from ..parallel.dataset import ArrayDataset

    if isinstance(data, np.ndarray):
        data = ArrayDataset.from_numpy(np.asarray(data, np.float32), "cpu")
    chunks = data.chunks() if hasattr(data, "chunks") else [data]
    counts = None
    rows = 0.0
    geometry = None
    for chunk in chunks:
        X = chunk.data
        if not isinstance(X, torch.Tensor) or X.dim() != 2:
            raise ValueError(
                "drift scoring needs a single 2-D feature leaf (the shape "
                "the baseline was built from)")
        if int(X.shape[1]) <= int(baseline.cols.max()):
            raise ValueError(
                f"drift scoring: data has {int(X.shape[1])} feature "
                f"column(s) but the baseline sketches column "
                f"{int(baseline.cols.max())}: the apply-time input is not "
                "the feature space this baseline was built from")
        if counts is None:
            dev = X.device
            counts = torch.zeros(baseline.counts.shape, dtype=torch.float32,
                                 device=dev)
            # the fit-time derivation: the bins are the same bits on
            # both sides of the PSI pair
            start, step = _bin_geometry(baseline.interior)
            geometry = (torch.as_tensor(start, device=dev),
                        torch.as_tensor(step, device=dev),
                        torch.as_tensor(baseline.cols.astype(np.int64),
                                        device=dev))
        _sketch_update(counts, *geometry, X[:chunk.n])
        rows += float(chunk.n)
    if counts is None:
        raise ValueError("empty dataset: nothing to score")
    return counts.cpu().numpy().astype(np.float32), rows


def score_drift(baseline: DriftBaseline, data,
                threshold: Optional[float] = None) -> Dict[str, Any]:
    """Score apply-time ``data`` against a fit-time baseline: PSI per
    sketched column, the largest published as the
    ``numerics.drift_score`` gauge, and a ``drift_warn`` event past the
    threshold (:func:`drift_threshold`). Returns ``{psi_max, psi_mean,
    warned, threshold, rows, per_col}``."""
    if baseline is None:
        raise ValueError(
            "no drift baseline: the fit did not build a feature sketch "
            "(non-2-D data, or numerics disabled during the fit)")
    threshold = drift_threshold() if threshold is None else float(threshold)
    counts, rows = _sketch_counts(baseline, data)
    per_col = baseline.psi(counts)
    psi_max = float(per_col.max())
    psi_mean = float(per_col.mean())
    warned = psi_max > threshold
    if numerics_active():
        MetricsRegistry.get_or_create().gauge(
            "numerics.drift_score").set(psi_max)
        record_numerics_event("drift_score", score=psi_max, mean=psi_mean,
                              rows=rows, source=baseline.source)
        if warned:
            record_numerics_event(
                "drift_warn", score=psi_max, threshold=threshold,
                worst_col=int(baseline.cols[int(per_col.argmax())]),
                source=baseline.source)
    return {"psi_max": psi_max, "psi_mean": psi_mean, "warned": warned,
            "threshold": threshold, "rows": rows,
            "per_col": per_col.tolist()}


def health_snapshot() -> Dict[str, Any]:
    """What a post-mortem embeds: the recent series and the plane's
    state."""
    return {"enabled": numerics_enabled(), "recent_health": recent_health(),
            "last_health_age_s": last_health_age_s()}


def postmortem_report(argv: Sequence[str]) -> int:
    """``python -m keystone_tpu_torch numerics <postmortem.json>``: render
    a health post-mortem (the JAX package's ``numerics`` command over the
    port's artifacts, ``observability/postmortem.py``): the reason and
    context, the numerics counters of the metrics snapshot, and the
    embedded health series as a table. Exit 0 rendered, 1 unreadable."""
    argv = [a for a in argv if not a.startswith("-")]
    if len(argv) != 1:
        print("usage: python -m keystone_tpu_torch numerics POSTMORTEM.json")
        return 1
    try:
        with open(argv[0]) as f:
            blob = json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        print(f"numerics: cannot load {argv[0]!r}: {exc}")
        return 1
    print(f"post-mortem: {blob.get('reason')} (pid {blob.get('pid')})")
    ctx = dict(blob.get("context") or {})
    series = ctx.pop("recent_health", None) or (
        blob.get("numerics") or {}).get("recent_health") or []
    for k, v in sorted(ctx.items()):
        print(f"  {k}: {v}")
    counters = (blob.get("metrics") or {}).get("counters") or {}
    numeric = {k: v for k, v in counters.items()
               if k.startswith("numerics.")}
    if numeric:
        print("numerics counters: " + " ".join(
            f"{k.split('.', 1)[1]}={v:g}" for k, v in sorted(
                numeric.items())))
    if series:
        print(f"health series (last {len(series)}):")
        print(f"{'source':<28} {'chunk':>6} {'nan':>8} {'inf':>8} "
              f"{'min':>11} {'max':>11} {'mean':>11}")
        for e in series:
            print(f"{str(e.get('source', '?'))[:28]:<28} "
                  f"{str(e.get('chunk', '-')):>6} "
                  f"{e.get('nan', 0):>8.0f} {e.get('inf', 0):>8.0f} "
                  f"{e.get('min', 0):>11.4g} {e.get('max', 0):>11.4g} "
                  f"{e.get('mean', 0):>11.4g}")
    else:
        print("no health series in this artifact")
    return 0
