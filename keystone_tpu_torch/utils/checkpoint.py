"""Save and load fitted pipelines.

Counterpart of ``save_pipeline`` / ``load_pipeline`` in
``keystone_tpu/utils/checkpoint.py`` (reference
``graph/FittedPipeline.scala``): the fitted pipeline is pickled inside a
format header, ``{"format": "keystone-checkpoint", "version": 1,
"kind": "pipeline", "payload": ...}``, written to a temporary file and
moved into place, so a crash mid-write leaves the previous file whole.
Fitted tensors pickle as host copies. A file that is truncated,
corrupt, of another kind or another version raises
:class:`CheckpointCorruptError` naming the path. Unpickling runs code:
load only files this program wrote.

``save_pca_csv`` writes a fitted PCA projection as the CSV artifact the
ImageNet and VOC apps' ``pca_file`` options read; ``SolverCheckpoint``
is the per-pass checkpoint of the weighted block solver.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..ops.device import DEFAULT_DEVICE, resolve_device
from ..workflow.pipeline import FittedPipeline

_FORMAT = "keystone-checkpoint"
_VERSION = 1


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file exists but cannot be read back (truncated
    write, bad bytes, wrong format, kind or version)."""


def _atomic_pickle_dump(payload: Any, path: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)


def save_pipeline(pipeline: FittedPipeline, path: str) -> None:
    """Write ``pipeline`` to ``path`` atomically, under the header."""
    _atomic_pickle_dump({"format": _FORMAT, "version": _VERSION,
                         "kind": "pipeline", "payload": pipeline}, path)


def load_pipeline(path: str, device=DEFAULT_DEVICE) -> FittedPipeline:
    """Read a pipeline written by :func:`save_pipeline` and stage its
    fitted tensors on ``device`` (default ``"cuda"``; raises when CUDA
    is asked for and absent)."""
    dev = resolve_device(device)
    try:
        with open(path, "rb") as f:
            blob = pickle.load(f)
    except FileNotFoundError:
        raise
    except Exception as exc:  # noqa: BLE001 - any unpickling failure
        raise CheckpointCorruptError(
            f"checkpoint {path!r} is truncated or corrupt "
            f"({type(exc).__name__}: {exc}); re-save it or delete the "
            "file") from exc
    if not (isinstance(blob, dict) and blob.get("format") == _FORMAT):
        raise CheckpointCorruptError(
            f"checkpoint {path!r} carries no {_FORMAT!r} header")
    if blob.get("version") != _VERSION:
        raise CheckpointCorruptError(
            f"checkpoint {path!r} has format version "
            f"{blob.get('version')!r}; this build reads version {_VERSION}")
    if blob.get("kind") != "pipeline":
        raise CheckpointCorruptError(
            f"checkpoint {path!r} holds a {blob.get('kind')!r} artifact, "
            "not a 'pipeline'")
    out = blob.get("payload")
    if not isinstance(out, FittedPipeline):
        raise CheckpointCorruptError(
            f"checkpoint {path!r} does not hold a FittedPipeline (got "
            f"{type(out).__name__})")
    graph = out.to_pipeline().graph
    for node in graph.nodes:
        stage = getattr(graph.get_operator(node), "apply_params", None)
        if stage is not None:
            stage(dev)
    return out


def save_pca_csv(pca_mat, path: str) -> None:
    """Write a (d, k) PCA projection as the CSV artifact the apps'
    ``pca_file`` options read (reference ImageNetSiftLcsFV.scala:46-48
    loads it with ``csvread(file).t``): the file holds the transposed
    (k, d) matrix, and loading transposes it back to the ``pca_mat`` a
    ``BatchPCATransformer`` applies."""
    mat = pca_mat.cpu().numpy() if isinstance(pca_mat, torch.Tensor) \
        else np.asarray(pca_mat)
    np.savetxt(path, mat.T, delimiter=",")


class SolverCheckpoint:
    """Per-pass checkpoint of a block solver (the counterpart of the JAX
    package's ``SolverCheckpoint``; reference CLUSTER.md's failure
    recovery, where Spark task retry and lineage restarted the work).

    A file holds the problem's ``key``, the index of the last completed
    pass, the model blocks and, where given, the solver's residual, as
    host arrays; writes are atomic (a temporary file moved into place).
    ``load`` ignores a file of another key or one it cannot read, so a
    stale file never warm-starts a different solve."""

    def __init__(self, path: str):
        self.path = path

    def load(self, key) -> Optional[dict]:
        """``{"pass": int, "models": [...], "residual": array or None}``
        for a file of this ``key``, else None."""
        if not os.path.exists(self.path):
            return None
        try:
            with open(self.path, "rb") as f:
                blob = pickle.load(f)
        except Exception:  # noqa: BLE001 - an unreadable file is no resume
            return None
        if not isinstance(blob, dict) or blob.get("key") != key:
            return None
        return blob

    def save(self, key, pass_idx: int, models: Sequence,
             residual=None) -> None:
        def host(t):
            return t.detach().cpu().numpy() if isinstance(
                t, torch.Tensor) else np.asarray(t)

        _atomic_pickle_dump(
            {"key": key, "pass": int(pass_idx),
             "models": [host(m) for m in models],
             "residual": None if residual is None else host(residual)},
            self.path)

    def clear(self) -> None:
        """Remove the file after a completed solve."""
        try:
            os.remove(self.path)
        except OSError:
            pass
