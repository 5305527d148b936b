"""Checkpoint and resume of a streamed fit.

Counterpart of ``keystone_tpu/resilience/stream_checkpoint.py``. A
streamed fit has one piece of evolving state, the
estimator's carry (Gram, cross products, moments) and the chunk cursor,
so a snapshot costs O(d (d + k)), not O(n), and a resume is exact:

* :class:`StreamCheckpoint` writes ``(magic, version, fingerprint,
  cursor, carry, quarantine state, numerics state)`` atomically (a
  temporary file, then ``os.replace``) every N chunks;
* a resumed ``fit_streaming`` replays the source, skips the accumulate
  of the first ``cursor`` chunks (they are in the restored carry) and
  goes on. The remaining accumulates see the same inputs in the same
  order, so the resumed weights have the same bits as an uninterrupted
  fit's (the carry's round trip through the host is exact);
* the fingerprint binds a snapshot to the estimator's configuration,
  the stream's chunk geometry, tag and dtypes, and the labels: any
  change raises :class:`CheckpointMismatchError` instead of folding new
  chunks into a stale carry.

The carry is updated in place on the device (``gram_cross`` adds into G
and C, the scalers' sums use ``+=``), so :func:`snapshot_carry` clones
each tensor on the current stream before the next accumulate is
enqueued, and copies the clone into pinned host memory behind an event.

A world of N ranks checkpoints as one WORLD snapshot in a shared
directory: each rank writes its sidecar (``save_host``) and rank 0 folds
them into the world snapshot (``merge_hosts``), which ``load_world``
reads back slice by slice. The snapshot records the world size and the
fingerprint folds it too, so a world resumes only at the size that wrote
it: a snapshot of 2 ranks loaded by 4 ranks or by one process, or one
process's snapshot loaded by a world, raises
:class:`CheckpointMismatchError`. Truncated or foreign files raise
:class:`CheckpointCorruptError` (shared with ``utils/checkpoint.py``)
naming the path.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import re
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..observability.metrics import MetricsRegistry
from .events import record_event


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file exists but cannot be read back (truncated
    write, bad bytes, wrong format, kind or version). The message names
    the path; deleting the file starts clean."""


class CheckpointMismatchError(RuntimeError):
    """A snapshot's fingerprint does not match the current fit."""


def atomic_pickle_dump(payload: Any, path: str) -> None:
    """Pickle to a pid-suffixed temporary file, then ``os.replace``: a
    crash mid-write leaves the previous file whole."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


# -- config fingerprint ------------------------------------------------------

def _stable(obj: Any) -> Any:
    """JSON-able, address-free view of a configuration value."""
    if isinstance(obj, (str, int, float, bool, type(None))):
        return obj
    if isinstance(obj, type):
        return f"type:{obj.__module__}.{obj.__qualname__}"
    if callable(obj) and hasattr(obj, "__qualname__"):
        return f"fn:{getattr(obj, '__module__', '?')}.{obj.__qualname__}"
    if isinstance(obj, (list, tuple)):
        return [_stable(x) for x in obj]
    if isinstance(obj, dict):
        return {str(k): _stable(v)
                for k, v in sorted(obj.items(), key=lambda kv: str(kv[0]))}
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return f"array{tuple(obj.shape)}:{obj.dtype}"
    return re.sub(r"0x[0-9a-fA-F]+", "0x", repr(obj))


def _estimator_key(estimator: Any) -> Any:
    eq = getattr(estimator, "eq_key", None)
    if callable(eq):
        try:
            return _stable(eq())
        except TypeError:
            pass
    cfg = {k: v for k, v in vars(estimator).items() if not k.startswith("_")}
    return [f"{type(estimator).__module__}.{type(estimator).__qualname__}",
            _stable(cfg)]


def fit_fingerprint(estimator: Any, data: Any, labels: Any = None) -> str:
    """Stable id of one streamed-fit configuration: the estimator's
    configuration, the stream's chunk size, tag, element and dtype
    policy, and the labels (resident labels by a digest of their
    content, streamed labels by their geometry). ``prefetch_depth`` and
    the retry and watchdog settings change scheduling, not results, and
    are left out, so a resume may tune them. Under a world the world
    size folds in (each rank's stream is its shard, so a resume at
    another size would replay other rows under the old cursors). The
    fingerprint cannot see a stream's content without consuming it: keep
    the source the same across a resume."""
    if labels is None:
        labels_key: Any = None
    elif hasattr(labels, "chunk_size") and hasattr(labels, "chunks"):
        labels_key = (f"stream:chunk_size={labels.chunk_size}:"
                      f"wire={labels.wire_dtype_name()}:"
                      f"compute={labels.compute_dtype_name()}")
    else:
        from ..parallel.dataset import to_numpy

        arr = np.ascontiguousarray(to_numpy(labels))
        labels_key = (f"resident:{tuple(arr.shape)}:{arr.dtype}:"
                      f"{hashlib.sha256(arr.tobytes()).hexdigest()[:16]}")
    element = getattr(data, "element", None)
    parts = {
        "estimator": _estimator_key(estimator),
        "chunk_size": int(getattr(data, "chunk_size", 0)),
        "data_tag": getattr(data, "tag", None),
        "data_element": _stable(element() if callable(element) else None),
        "wire_dtype": data.wire_dtype_name(),
        "compute_dtype": data.compute_dtype_name(),
        "labels": labels_key,
    }
    from ..parallel.mesh import process_count

    if process_count() > 1:
        parts["topology"] = {"processes": process_count()}
    blob = json.dumps(parts, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


# -- the carry's host copy ---------------------------------------------------

class CarrySnapshot:
    """A carry's copy on its way to the host: tensor leaves cloned on
    the current stream and copied into pinned host buffers behind one
    event. :meth:`host` waits for the event and returns the carry with
    numpy leaves."""

    def __init__(self, carry: Any, pinned: Optional[List[torch.Tensor]]
                 = None):
        self._pinned = [] if pinned is None else pinned
        self._event = None
        self._tree = self._walk(carry, iter(range(1 << 30)))

    def _walk(self, leaf, counter):
        if isinstance(leaf, (tuple, list)):
            return type(leaf)(self._walk(x, counter) for x in leaf)
        if not isinstance(leaf, torch.Tensor):
            return leaf
        i = next(counter)
        if leaf.device.type != "cuda":
            return leaf.detach().clone().numpy()
        # clone on the compute stream: the next accumulate updates the
        # carry in place, and this copy is ordered before it
        copy = leaf.detach().clone()
        while len(self._pinned) <= i:
            self._pinned.append(None)
        buf = self._pinned[i]
        if buf is None or buf.shape != copy.shape or buf.dtype != copy.dtype:
            buf = self._pinned[i] = torch.empty(
                copy.shape, dtype=copy.dtype, pin_memory=True)
        buf.copy_(copy, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record()
        return buf

    def host(self) -> Any:
        if self._event is not None:
            self._event.synchronize()

        def land(leaf):
            if isinstance(leaf, (tuple, list)):
                return type(leaf)(land(x) for x in leaf)
            return leaf.numpy() if isinstance(leaf, torch.Tensor) else leaf

        return land(self._tree)


def restore_carry(host_carry: Any, device: torch.device) -> Any:
    """A snapshot's host carry back on ``device``: array leaves become
    contiguous tensors there, host ints stay ints."""
    if isinstance(host_carry, (tuple, list)):
        return type(host_carry)(restore_carry(x, device) for x in host_carry)
    if isinstance(host_carry, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(host_carry)).to(device)
    return host_carry


# -- the snapshot file -------------------------------------------------------

class StreamCheckpoint:
    """Atomic snapshot and restore of one streamed fit's progress. Each
    save observes ``checkpoint.d2h_s`` (the carry's copy to the host)
    and ``checkpoint.write_s`` (pickle and write)."""

    MAGIC = "keystone-torch-stream-fit"
    VERSION = 1

    def __init__(self, directory: str, name: str = "stream_fit"):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"{name}.ckpt")
        self._pinned: List[torch.Tensor] = []

    def save(self, fingerprint: str, cursor: int, carry: Any,
             quarantine_state: Optional[Dict[str, Any]] = None,
             numerics: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot after chunk ``cursor - 1``. Must be called before the
        next accumulate is enqueued."""
        reg = MetricsRegistry.get_or_create()
        t0 = time.perf_counter()
        host_carry = CarrySnapshot(carry, self._pinned).host()
        t1 = time.perf_counter()
        atomic_pickle_dump({
            "magic": self.MAGIC, "version": self.VERSION,
            "fingerprint": fingerprint, "cursor": int(cursor),
            "carry": host_carry, "quarantine": quarantine_state,
            "numerics": numerics}, self.path)
        t2 = time.perf_counter()
        reg.histogram("checkpoint.d2h_s").observe(t1 - t0)
        reg.histogram("checkpoint.write_s").observe(t2 - t1)
        record_event("checkpoint_save", path=self.path, cursor=int(cursor),
                     d2h_s=t1 - t0, write_s=t2 - t1)

    def _read_blob(self, path: str) -> Dict[str, Any]:
        try:
            with open(path, "rb") as f:
                blob = pickle.load(f)
        except Exception as exc:
            raise CheckpointCorruptError(
                f"stream checkpoint {path!r} is truncated or corrupt "
                f"({type(exc).__name__}: {exc}); delete it to start the fit "
                "from scratch") from exc
        if not (isinstance(blob, dict) and blob.get("magic") == self.MAGIC):
            raise CheckpointCorruptError(
                f"{path!r} is not a keystone_tpu_torch stream checkpoint "
                "(missing format header); delete it to start over")
        if blob.get("version") != self.VERSION:
            raise CheckpointCorruptError(
                f"stream checkpoint {path!r} has format version "
                f"{blob.get('version')!r}, this build reads {self.VERSION}; "
                "delete it to start over")
        return blob

    def load(self, fingerprint: str) -> Optional[Dict[str, Any]]:
        """The last snapshot, or None. A corrupt file raises
        :class:`CheckpointCorruptError`, another fit's snapshot
        :class:`CheckpointMismatchError`."""
        if not os.path.exists(self.path):
            return None
        blob = self._read_blob(self.path)
        topo = blob.get("topology")
        if topo is not None:
            raise CheckpointMismatchError(
                f"stream checkpoint {self.path!r} was written by a "
                f"{topo.get('processes')}-process world; a single-process "
                "fit cannot resume it (the per-rank cursors hold only under "
                "the original shard partition). Relaunch at world size "
                f"{topo.get('processes')}, or delete the checkpoint "
                "directory to start over")
        if blob.get("fingerprint") != fingerprint:
            raise CheckpointMismatchError(
                f"stream checkpoint {self.path!r} was written by a different "
                f"fit configuration (fingerprint {blob.get('fingerprint')!r} "
                f"!= {fingerprint!r}); refusing to resume. Delete the "
                "checkpoint directory to start over, or restore the original "
                "estimator, chunk size and labels")
        record_event("checkpoint_restore", path=self.path,
                     cursor=int(blob["cursor"]))
        return blob

    # -- world snapshots ------------------------------------------------------
    def host_path(self, process_id: int) -> str:
        """A rank's sidecar, beside the world snapshot (the directory is
        shared storage, as the resume needs anyway)."""
        base, ext = os.path.splitext(self.path)
        return f"{base}.host{int(process_id)}{ext}"

    def save_host(self, fingerprint: str, process_id: int, cursor: int,
                  carry: Any,
                  quarantine_state: Optional[Dict[str, Any]] = None,
                  numerics: Optional[Dict[str, Any]] = None) -> None:
        """One rank's part of a coordinated snapshot, written atomically
        to its sidecar. ``carry`` is already on the host (the world loop
        lands a :class:`CarrySnapshot` one round after cutting it)."""
        t0 = time.perf_counter()
        atomic_pickle_dump({
            "magic": self.MAGIC, "version": self.VERSION,
            "fingerprint": fingerprint, "process_id": int(process_id),
            "cursor": int(cursor), "carry": carry,
            "quarantine": quarantine_state, "numerics": numerics},
            self.host_path(process_id))
        MetricsRegistry.get_or_create().histogram(
            "checkpoint.write_s").observe(time.perf_counter() - t0)
        record_event("checkpoint_save", path=self.host_path(process_id),
                     cursor=int(cursor))

    def merge_hosts(self, processes: int) -> None:
        """Fold every rank's sidecar into the world snapshot (rank 0,
        after a round in which every rank reported a durable sidecar).
        The snapshot holds each rank's cursor, carry and states plus the
        world size, so a relaunched world restores each rank's place and
        a world of another size is refused before anything is touched."""
        hosts = []
        for p in range(int(processes)):
            blob = self._read_blob(self.host_path(p))
            hosts.append({k: blob.get(k) for k in
                          ("fingerprint", "cursor", "carry", "quarantine",
                           "numerics")})
        atomic_pickle_dump({
            "magic": self.MAGIC, "version": self.VERSION,
            "topology": {"processes": int(processes)}, "hosts": hosts},
            self.path)
        record_event("checkpoint_save", path=self.path,
                     cursor=min(int(h["cursor"]) for h in hosts),
                     world=int(processes))

    def load_world(self, fingerprint: str, process_id: int,
                   processes: int) -> Optional[Dict[str, Any]]:
        """This rank's slice of the last world snapshot, or None. The
        world size is checked first: a snapshot of another size, or of
        one process, raises :class:`CheckpointMismatchError` naming
        both."""
        if not os.path.exists(self.path):
            return None
        blob = self._read_blob(self.path)
        topo = blob.get("topology")
        if topo is None:
            raise CheckpointMismatchError(
                f"stream checkpoint {self.path!r} was written by a "
                f"single-process fit; a {int(processes)}-process world "
                "cannot resume it (the shard partition differs). Relaunch "
                "single-process, or delete the checkpoint directory to "
                "start over")
        if int(topo.get("processes", -1)) != int(processes):
            raise CheckpointMismatchError(
                f"stream checkpoint {self.path!r} was written by a "
                f"{topo.get('processes')}-process world but this world has "
                f"{int(processes)} processes; refusing to resume (the "
                "per-rank cursors hold only under the original shard "
                f"partition). Relaunch at world size "
                f"{topo.get('processes')}, or delete the checkpoint "
                "directory to start over")
        host = blob["hosts"][int(process_id)]
        if host.get("fingerprint") != fingerprint:
            raise CheckpointMismatchError(
                f"stream checkpoint {self.path!r} (rank {process_id} slice) "
                f"was written by a different fit configuration (fingerprint "
                f"{host.get('fingerprint')!r} != {fingerprint!r}); refusing "
                "to resume. Delete the checkpoint directory to start over, "
                "or restore the original estimator, chunk size and labels")
        record_event("checkpoint_restore", path=self.path,
                     cursor=int(host["cursor"]))
        return dict(host)

    def clear(self) -> None:
        """Remove the snapshot and any rank sidecars after a finished fit
        (a stale snapshot must never seed a later, unrelated fit)."""
        import glob

        base, ext = os.path.splitext(self.path)
        for path in [self.path] + glob.glob(f"{base}.host*{ext}"):
            try:
                os.remove(path)
            except FileNotFoundError:
                pass
