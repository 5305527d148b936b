"""Data-parallel sharded apply over the world's ranks.

Counterpart of ``keystone_tpu/parallel/spmd_apply.py``. The JAX package
runs a ``shard_map`` over the ``data`` axis of its world mesh; the port
has one rank per GPU, so each rank applies its own rows and the
collectives are written out:

* **batch rows** split over the mesh's ``data`` axis
  (:func:`shard_batch`): each rank passes the SAME global batch and
  applies only its contiguous row block;
* **weight rows** of ``LinearMapper`` / ``BlockLinearMapper`` shard over
  the data axis AT REST (:func:`shard_rows`): each rank keeps
  ``ceil(d / shards)`` rows of W, and the apply gathers the whole matrix
  only while its GEMM runs: the whole matrix for ``LinearMapper``, one
  feature block at a time for ``BlockLinearMapper``, whose transient
  peak is one block (``serving/residency.py`` charges exactly this:
  resident shard + gather transient + activation shard);
* **quantized mappers** keep their one fused kernel
  (``ops.kernels.quantized_affine``) with only the batch sharded, as in
  the JAX package: per-column scales make a row-shard gather another
  program;
* **fused featurize chains** ride the batch sharding
  (:func:`sharded_chain_apply`): their parameters are small and every
  rank holds them, so each rank runs the chain, the featurize kernel
  included, on its rows.

The gathered weights are the stored weights bit for bit (a gather moves
bytes), so a rank's rows come out as the unsharded model's apply of the
same rows would. Outputs come back to every rank whole
(:func:`unshard_batch`), in data order. Without a world each function is
the plain apply of the whole batch.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from .distributed import world_gather
from .mesh import DATA_AXIS, Mesh, batch_rows, get_mesh, num_data_shards, \
    world

__all__ = [
    "shard_rows",
    "shard_batch",
    "unshard_batch",
    "sharded_apply",
    "sharded_chain_apply",
]


def _round_up(n: int, m: int) -> int:
    return -(-int(n) // int(m)) * int(m)


def shard_rows(arr: Any, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """This rank's block of a ``(d, ...)`` parameter's rows under the
    mesh's data axis, ``d`` zero-padded to a multiple of the shard count
    (the gather slices the pad off): the AT-REST placement,
    ``ceil(d / shards)`` rows a rank."""
    mesh = mesh or get_mesh()
    shards = num_data_shards(mesh)
    t = torch.as_tensor(arr)
    pad = _round_up(t.shape[0], shards) - t.shape[0]
    if pad:
        t = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
    per = t.shape[0] // shards
    i, _ = mesh.coords()
    return t[i * per:(i + 1) * per].contiguous()


def _gather_rows(shard: torch.Tensor, rows: int, mesh: Mesh
                 ) -> torch.Tensor:
    """The whole parameter from every rank's :func:`shard_rows` block
    (pad rows sliced off): the transient of the apply's GEMM."""
    if world() is None:
        return shard[:rows]
    parts = world_gather(shard)
    return torch.cat([parts[r] for r in mesh.group(DATA_AXIS)])[:rows]


def shard_batch(x: Any, mesh: Optional[Mesh] = None
                ) -> Tuple[torch.Tensor, int]:
    """This rank's contiguous block of a global batch (the same on every
    rank) and its row count. Undo with :func:`unshard_batch`."""
    mesh = mesh or get_mesh()
    t = torch.as_tensor(x)
    if num_data_shards(mesh) == 1:
        return t, int(t.shape[0])
    lo, hi = batch_rows(int(t.shape[0]), mesh)
    return t[lo:hi], hi - lo


def unshard_batch(out: torch.Tensor, n: int,
                  mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Every rank's output rows, whole and in data order, on every rank
    (the counterpart of slicing a global output back to the caller's
    rows). Blocks of unequal size pad to the largest for the gather."""
    mesh = mesh or get_mesh()
    out = out[:n]
    if world() is None or num_data_shards(mesh) == 1:
        return out
    counts = [int(c[0]) for c in world_gather(
        torch.tensor([n], dtype=torch.int64, device=out.device))]
    width = max(counts)
    padded = out.new_zeros((width,) + tuple(out.shape[1:]))
    padded[:n] = out
    parts = world_gather(padded)
    return torch.cat([parts[r][:counts[r]]
                      for r in mesh.group(DATA_AXIS)])


# -- resident sharded params --------------------------------------------------

def _placed(model, mesh: Mesh, device, build):
    """The model's sharded params for (mesh, device), cached on the
    instance under ``_params_cache`` (dropped by pickling). The whole
    params ``build`` reads through ``apply_params`` are not kept: at rest
    a rank holds its shard alone."""
    cache = model.__dict__.setdefault("_params_cache", {})
    key = ("sharded", mesh, str(device))
    if key not in cache:
        had = str(device) in cache
        cache[key] = build()
        if not had:
            cache.pop(str(device), None)
    return cache[key]


def _sharded_affine_params(model, mesh: Mesh, device):
    """W row-sharded at rest, the small vectors whole."""
    def build():
        W, mean, inv_std, b = model.apply_params(device)
        return (shard_rows(W, mesh), int(W.shape[0]), mean, inv_std, b)

    return _placed(model, mesh, device, build)


def _sharded_block_params(model, mesh: Mesh, device):
    """Each block row-sharded at rest, with its bounds; mean and
    intercept whole."""
    def build():
        _, mean, _, b = model.apply_params(device)
        bounds, lo, shards = [], 0, []
        for w in model.block_weights:
            rows = int(w.shape[0])
            bounds.append((lo, lo + rows))
            lo += rows
            shards.append(shard_rows(torch.as_tensor(
                w, dtype=torch.float32).to(device), mesh))
        return tuple(bounds), tuple(shards), mean, b

    return _placed(model, mesh, device, build)


# -- entry points --------------------------------------------------------------

def sharded_apply(model, x: Any, mesh: Optional[Mesh] = None
                  ) -> torch.Tensor:
    """Apply a fitted linear model data-parallel over ``mesh`` (default
    the global mesh): every rank applies its rows, with the weights
    gathered from their at-rest shards for the GEMM (the whole matrix for
    ``LinearMapper``, a block at a time for ``BlockLinearMapper``), and
    the output comes back whole to every rank. A quantized mapper
    (``weight_dtype``) runs its fused kernel on the rank's rows with the
    batch alone sharded. Every rank of the world must call it."""
    from ..nodes.learning.linear import BlockLinearMapper

    mesh = mesh or get_mesh()
    xs, n = shard_batch(x, mesh)
    dev = xs.device
    X = xs.to(torch.float32)
    if getattr(model, "weight_dtype", None) is not None:
        out = model.apply_batch(X)
    elif isinstance(model, BlockLinearMapper):
        bounds, shards, mean, b = _sharded_block_params(model, mesh, dev)
        out = None
        for (lo, hi), w_shard in zip(bounds, shards):
            # transient: ONE block, the peak that lets a model larger
            # than one rank's budget serve
            w = _gather_rows(w_shard, hi - lo, mesh)
            part = (X[:, lo:hi] - mean[lo:hi]) @ w
            out = part if out is None else out + part
        out = out + b
    else:
        w_shard, rows, mean, inv_std, b = _sharded_affine_params(
            model, mesh, dev)
        W = _gather_rows(w_shard, rows, mesh)
        out = ((X - mean) * inv_std) @ W + b
    return unshard_batch(out, n, mesh)


def sharded_chain_apply(fused, x: Any, mesh: Optional[Mesh] = None
                        ) -> torch.Tensor:
    """Data-parallel apply of a fused featurize chain (or any transformer
    with ``apply_batch``): every rank runs the chain on its rows (its
    parameters are small and every rank holds them) and the outputs come
    back whole. A terminal linear stage that wants its weights sharded
    goes through :func:`sharded_apply`."""
    mesh = mesh or get_mesh()
    xs, n = shard_batch(x, mesh)
    out = fused.apply_batch(xs)
    return unshard_batch(out, n, mesh)

