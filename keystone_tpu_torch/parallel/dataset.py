"""Dataset: the collection type that flows through pipelines.

Counterpart of ``keystone_tpu/parallel/dataset.py``:

* `ArrayDataset` — a batch-major tensor, or a tuple of them, on one
  device. ``n`` is the true item count. Rows are zero-padded up to a
  multiple of ``shards`` (1 by default, so no padding), keeping the
  padding and mask semantics of the JAX package's sharded batches:
  padded rows are re-zeroed after every batch map, so sums and Grams
  stay exact and means divide by the true ``n``.
* `HostDataset` — a plain Python list of items for host-side stages.

Rank-sharded rows. In a world (``parallel/mesh.py``) a dataset whose
``mesh`` is set holds this rank's block of a larger whole, the block
:func:`shard_dataset` cuts for the rank's data index; its ``n`` is the
block's true row count. The resident solvers read ``mesh`` and sum their
row reductions over the ranks of the data group (``ops/linalg.py``).
Every batch map keeps the mark; a dataset without it (``mesh`` None) is
this rank's own, the single-process case.

Datasets are eager; laziness lives in ``workflow.expression``. The
chunked, prefetched ``StreamingDataset`` lives in ``parallel.streaming``
and is recognised here by ``is_streaming``.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..ops.device import DEFAULT_DEVICE, resolve_device


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Map over the tensors of a tensor-or-nested-tuple value."""
    if isinstance(tree, (tuple, list)):
        return tuple(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def map_rows(fn: Callable[[Any], Any], data: Any) -> Any:
    """Apply a per-item function to every row of a batch and stack the
    results: the batch form of a node that writes none of its own."""
    rows = tree_leaves(data)[0].shape[0]
    outs = [fn(tree_map(lambda x: x[i], data)) for i in range(rows)]
    return tree_map(lambda *xs: torch.stack(xs), *outs)


def padded_rows(n: int, shards: int) -> int:
    """Rows a batch of ``n`` items occupies after padding to a multiple
    of ``shards`` (at least one row per shard)."""
    shards = max(int(shards), 1)
    return max(((int(n) + shards - 1) // shards) * shards, shards)


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    if x.shape[0] == rows:
        return x
    pad = torch.zeros((rows - x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=0)


def _zero_rows_from(x: torch.Tensor, n: int) -> torch.Tensor:
    if n >= x.shape[0]:
        return x
    out = x.clone()
    out[n:] = 0
    return out


def _host(x: Any) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _to_tensor(x: Any, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def is_streaming(ds: Any) -> bool:
    """True for chunked streaming datasets (``parallel.streaming``).
    Duck-typed on the chunk API so the modules below the streaming module
    (this one, ``workflow.transformer``) share one predicate without an
    import cycle."""
    return isinstance(ds, Dataset) and hasattr(ds, "map_chunks")


class Dataset:
    """Abstract collection of items."""

    def map(self, fn: Callable[[Any], Any]) -> "Dataset":
        raise NotImplementedError

    def collect(self) -> List[Any]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def cache(self) -> "Dataset":
        return self


class ArrayDataset(Dataset):
    """Batch-major, zero-padded dataset of fixed-shape items on one
    device. ``data`` is a tensor or tuple of tensors sharing leading dim
    ``padded_n`` (``padded_rows(n, shards)`` for data staged here); rows
    at index >= n are zero. ``data, n, mesh`` take the JAX package's
    places (its ``_already_sharded`` has no counterpart, so ``tag`` is
    keyword-only); ``shards``, the padding multiple, is the port's own."""

    def __init__(self, data: Any, n: int, mesh: Any = None, *,
                 tag: Optional[str] = None, shards: int = 1):
        self.n = int(n)
        self.shards = int(shards)
        self.tag = tag  # stable identity for prefix reuse across pipelines
        #: the mesh whose data shard these rows are (None: not sharded
        #: over ranks)
        self.mesh = mesh
        rows = padded_rows(self.n, self.shards)

        def fit(x):
            # n rows are padded; longer batches (a 1->many node's output
            # over padded input) keep their trailing zero rows
            if x.shape[0] < self.n:
                raise ValueError(
                    f"leading dim {x.shape[0]} is below n={self.n}")
            if x.shape[0] == self.n:
                x = _pad_rows(x, rows)
            return _zero_rows_from(x, self.n)

        self.data = tree_map(fit, data)

    # -- construction -----------------------------------------------------
    @staticmethod
    def from_numpy(array: Any, device=DEFAULT_DEVICE,
                   tag: Optional[str] = None, *,
                   shards: int = 1) -> "ArrayDataset":
        """Stage host arrays (or tensors) on ``device``."""
        dev = resolve_device(device)
        data = tree_map(lambda x: _to_tensor(x, dev), array)
        n = tree_leaves(data)[0].shape[0]
        return ArrayDataset(data, n, shards=shards, tag=tag)

    @staticmethod
    def from_items(items: Sequence[Any], device=DEFAULT_DEVICE,
                   shards: int = 1) -> "ArrayDataset":
        """Stack fixed-shape items; tensor items are stacked where they
        lie and then moved, host arrays are stacked on the host."""
        def stack(*xs):
            if all(isinstance(x, torch.Tensor) for x in xs):
                return torch.stack(xs)
            return np.stack([_host(x) for x in xs])

        return ArrayDataset.from_numpy(tree_map(stack, *items), device,
                                       shards=shards)

    # -- properties -------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return tree_leaves(self.data)[0].device

    @property
    def padded_n(self) -> int:
        return tree_leaves(self.data)[0].shape[0]

    @property
    def mask(self) -> torch.Tensor:
        """bool[padded_n], True for real rows."""
        m = torch.zeros(self.padded_n, dtype=torch.bool, device=self.device)
        m[: self.n] = True
        return m

    def __len__(self) -> int:
        return self.n

    def to(self, device) -> "ArrayDataset":
        """This dataset on ``device`` (itself when already there)."""
        dev = resolve_device(device)
        if self.device == dev or (dev.type == "cuda" and dev.index is None
                                  and self.device.type == "cuda"):
            return self
        return ArrayDataset(tree_map(lambda x: x.to(dev), self.data), self.n,
                            self.mesh, tag=self.tag, shards=self.shards)

    # -- transforms -------------------------------------------------------
    def map_batch(self, fn: Callable[[Any], Any]) -> "ArrayDataset":
        """Apply a whole-batch function (padded rows included; the rows
        past ``n`` are re-zeroed afterwards)."""
        return ArrayDataset(fn(self.data), self.n, self.mesh,
                            shards=self.shards)

    def map(self, fn: Callable[[Any], Any]) -> "ArrayDataset":
        """Apply a per-item function row by row (the generic batch path
        for nodes that write no batched form)."""
        return self.map_batch(lambda data: map_rows(fn, data))

    def zip(self, *others: "ArrayDataset") -> "ArrayDataset":
        """Zip datasets of equal length into a dataset of tuples."""
        for o in others:
            if o.n != self.n:
                raise ValueError("zip requires equal lengths")
        data = (self.data,) + tuple(o.data for o in others)
        return ArrayDataset(
            tree_map(lambda x: x[: self.n], data), self.n, self.mesh,
            shards=self.shards)

    # -- materialization --------------------------------------------------
    def numpy(self) -> Any:
        """Copy to host as numpy, padding stripped."""
        return tree_map(lambda x: x[: self.n].cpu().numpy(), self.data)

    def collect(self) -> List[Any]:
        return [tree_map(lambda x: x[i], self.data) for i in range(self.n)]


def bucketed_dataset(data: Any, n: int, bucket_rows: int,
                     device=DEFAULT_DEVICE) -> ArrayDataset:
    """Stage a host batch of ``n`` items on ``device``, padded with zero
    rows to exactly ``bucket_rows`` (not merely to the shard multiple):
    the serving micro-batcher's pad-to-bucket step. The result is an
    ArrayDataset with ``padded_n == bucket_rows`` and the true ``n``, so
    the mask machinery treats the pad rows like any padding: they are
    re-zeroed after every batch map, and ``numpy()`` / ``collect()``
    strip them. One device, so the shard count is 1."""
    if n > bucket_rows:
        raise ValueError(f"n={n} items do not fit bucket_rows={bucket_rows}")
    dev = resolve_device(device)

    def put(x):
        x = _host(x)
        if x.shape[0] != n:
            raise ValueError(f"leading dim {x.shape[0]} != n={n}")
        padded = np.zeros((bucket_rows,) + x.shape[1:], x.dtype)
        padded[:n] = x
        return torch.as_tensor(padded, device=dev)

    return ArrayDataset(tree_map(put, data), n)


def shard_dataset(ds: "ArrayDataset", mesh: Any = None) -> "ArrayDataset":
    """This rank's block of ``ds``'s true rows under ``mesh``'s data axis
    (default the global mesh), marked with the mesh: the rows a resident
    fit in a world holds (the port's counterpart of a batch placed with
    the JAX ``batch_sharding``). ``ds`` itself on a one-shard mesh."""
    from .mesh import batch_rows, get_mesh, num_data_shards

    mesh = mesh or get_mesh()
    shards = num_data_shards(mesh)
    if shards == 1:
        return ds
    lo, hi = batch_rows(ds.n, mesh)
    # a tag of its own: the block must never be served the whole's
    # prefix-memo entries
    tag = None if ds.tag is None else \
        f"{ds.tag}:shard{mesh.coords()[0]}/{shards}"
    return ArrayDataset(tree_map(lambda x: x[lo:hi].contiguous(), ds.data),
                        hi - lo, tag=tag, mesh=mesh)


def argmax_labels(L: torch.Tensor) -> torch.Tensor:
    """Class ids from a one-hot or indicator label matrix, on its
    device."""
    return torch.argmax(L, dim=1).to(torch.int32)


def fetch_to_host(arr: Any, mesh: Any = None) -> np.ndarray:
    """A small (metadata-sized) tensor on the host. With a rank-sharded
    ``mesh`` the ranks' parts are gathered and concatenated in data
    order, so every rank gets the whole."""
    from .distributed import world_gather
    from .mesh import DATA_AXIS, num_data_shards, process_count

    t = torch.as_tensor(arr)
    if mesh is None or process_count() == 1 or num_data_shards(mesh) == 1:
        return t.detach().cpu().numpy()
    # the parts may differ in rows: gather the counts, then padded rows
    rows = [int(p[0]) for p in world_gather(
        torch.tensor([t.shape[0]], dtype=torch.int64))]
    width = max(rows)
    padded = torch.zeros((width,) + tuple(t.shape[1:]), dtype=t.dtype)
    padded[:t.shape[0]] = t.detach().cpu()
    parts = world_gather(padded)
    return torch.cat([parts[r][:rows[r]] for r in mesh.group(DATA_AXIS)]
                     ).numpy()


class HostDataset(Dataset):
    """Host-resident list-backed dataset for ragged / non-numeric stages."""

    def __init__(self, items: Iterable[Any], tag: Optional[str] = None):
        self.items = list(items)
        self.tag = tag

    def map(self, fn: Callable[[Any], Any]) -> "HostDataset":
        return HostDataset([fn(x) for x in self.items])

    def collect(self) -> List[Any]:
        return list(self.items)

    def __len__(self) -> int:
        return len(self.items)

    def to_device(self, device=DEFAULT_DEVICE, shards: int = 1
                  ) -> ArrayDataset:
        return ArrayDataset.from_items(self.items, device, shards)


def as_dataset(data: Any, device=DEFAULT_DEVICE) -> Dataset:
    """A Dataset as it is, a list of non-array items as a HostDataset,
    anything array-like staged on ``device``."""
    if isinstance(data, Dataset):
        return data
    if isinstance(data, (list, tuple)) and data and not hasattr(
            data[0], "shape"):
        return HostDataset(data)
    if isinstance(data, (list, tuple)):
        return ArrayDataset.from_items(list(data), device)
    return ArrayDataset.from_numpy(data, device)


def ensure_array(ds: Any, device=None) -> ArrayDataset:
    """Promote a host dataset of fixed-shape items (or a raw array) to an
    ArrayDataset; no-op for one already. With no ``device``, tensors
    stay where they lie (a raw tensor, or a host dataset's tensor items);
    host arrays, which lie on no device, go to the default device."""
    if isinstance(ds, ArrayDataset):
        return ds
    if device is None:
        first = ds
        if isinstance(ds, HostDataset):
            first = tree_leaves(ds.items[0])[0] if ds.items else None
        device = (first.device if isinstance(first, torch.Tensor)
                  else DEFAULT_DEVICE)
    if isinstance(ds, (np.ndarray, torch.Tensor)):
        return ArrayDataset.from_numpy(ds, device)
    if is_streaming(ds):
        raise TypeError(
            "a StreamingDataset cannot be implicitly promoted to a "
            "device-resident ArrayDataset (that would materialize the "
            "whole stream on the device, the thing streaming exists to "
            "avoid). Fit with a streamable estimator "
            "(parallel.streaming.fit_streaming), or call .materialize() "
            "explicitly if the stream is known to fit.")
    if not isinstance(ds, HostDataset):
        raise TypeError(f"cannot promote {type(ds).__name__} to an "
                        "ArrayDataset")
    return ds.to_device(device)


def device_nbytes(value: Any) -> float:
    """Memory footprint in bytes of a pipeline value, from tensor
    metadata alone. A stream reports its device residency: the bounded
    prefetch buffer plus the working chunk at its post-cast width, not
    the logical dataset size; this is the number the streamed fit's
    ``hbm_budget`` check reads."""
    if isinstance(value, ArrayDataset):
        return float(sum(leaf.element_size() * leaf.numel()
                         for leaf in tree_leaves(value.data)))
    if is_streaming(value):
        return float(value.buffered_nbytes())
    if isinstance(value, HostDataset):
        return float(sum(getattr(it, "nbytes", 64) for it in value.items))
    if isinstance(value, Dataset):
        return 64.0 * len(value)
    return float(sum(
        leaf.element_size() * leaf.numel() if isinstance(leaf, torch.Tensor)
        else getattr(leaf, "nbytes", 64) for leaf in tree_leaves(value)))


def to_numpy(x: Any, dtype=None) -> np.ndarray:
    """Materialize datasets / lazy pipeline results / tensors as one
    numpy array (the shared coercion for evaluators and host-side fits)."""
    if hasattr(x, "get") and not isinstance(x, Dataset):  # PipelineResult
        x = x.get()
    if isinstance(x, ArrayDataset):
        out = np.asarray(x.numpy())
    elif isinstance(x, Dataset):
        out = np.asarray([_host(v) for v in x.collect()])
    elif isinstance(x, torch.Tensor):
        out = x.cpu().numpy()
    else:
        out = np.asarray(x)
    return out.astype(dtype) if dtype is not None else out
