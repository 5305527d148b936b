"""The mesh of ranks and the world's start-up.

Counterpart of ``keystone_tpu/parallel/mesh.py``. The JAX package runs
GSPMD: one program over a mesh of devices, several devices in a
process, and collectives the compiler inserts. The port runs one
process per GPU on ``torch.distributed`` and writes each collective out
itself, so its mesh is a mesh of RANKS: a :class:`Mesh` arranges global
rank ids on the ``data`` and ``model`` axes. A JAX world of P processes
x D devices corresponds to a port world of P x D ranks.

* Without a world (one process) every mesh is the one-rank mesh and
  every collective helper is the identity, so single-process code runs
  exactly as before.
* Under a world, :func:`get_mesh` defaults to :func:`world_data_mesh`
  (every rank), as the JAX package's default mesh spans every process's
  devices. A RESIDENT dataset under a world mesh holds this rank's share
  of the rows: rank r at mesh coordinates (i, j) holds data shard i
  (:func:`shard_bounds`), replicated over the ``model`` axis, and the
  resident solvers sum their row reductions over the ranks of its
  ``data`` group (``ops/linalg.py``). A streamed fit is shard-local
  instead (:func:`local_mesh`): each rank accumulates its own chunks and
  the carries merge once at finalize (``parallel/distributed.py``).

:func:`initialize_distributed` starts the world: one rank per GPU
(``torch.cuda.set_device(local_rank)``), the backend picked by a rule
(:func:`pick_backend`), a timeout on every collective, and a gloo group
of CPU tensors for the coordination rounds.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import sys
import threading
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

#: seconds a collective may wait for its peers before it raises
#: (``KEYSTONE_TORCH_COORD_TIMEOUT_S``); a dead or divergent peer ends
#: in an error the launcher reaps, never a hang
DEFAULT_TIMEOUT_S = 120.0


class Mesh:
    """Global rank ids on a (``data``, ``model``) grid. Hashable by its
    layout; ``ranks[i, j]`` is the rank at data index i, model index j."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, ranks: Sequence[Sequence[int]]):
        arr = np.asarray(ranks, dtype=np.int64)
        if arr.ndim != 2 or arr.size == 0:
            raise ValueError(f"a mesh is a non-empty (data, model) grid of "
                             f"ranks, got shape {arr.shape}")
        if len(set(arr.flat)) != arr.size:
            raise ValueError(f"a rank appears twice in the mesh {arr.tolist()}")
        self.ranks = arr
        self._key = tuple(map(tuple, arr.tolist()))

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: int(self.ranks.shape[0]),
                MODEL_AXIS: int(self.ranks.shape[1])}

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def flat_ranks(self) -> Tuple[int, ...]:
        return tuple(int(r) for r in self.ranks.flat)

    def coords(self, rank: Optional[int] = None) -> Tuple[int, int]:
        """(data index, model index) of ``rank`` (default this one)."""
        rank = process_index() if rank is None else int(rank)
        hit = np.argwhere(self.ranks == rank)
        if not len(hit):
            raise ValueError(f"rank {rank} is not in the mesh "
                             f"{self.ranks.tolist()}")
        return int(hit[0][0]), int(hit[0][1])

    def group(self, axis: str, rank: Optional[int] = None
              ) -> Tuple[int, ...]:
        """The ranks along ``axis`` through ``rank``, in axis order: the
        ``data`` group sums a rank's row reductions, the ``model`` group
        holds its class slices."""
        i, j = self.coords(rank)
        if axis == DATA_AXIS:
            return tuple(int(r) for r in self.ranks[:, j])
        if axis == MODEL_AXIS:
            return tuple(int(r) for r in self.ranks[i, :])
        raise ValueError(f"unknown mesh axis {axis!r}")

    def is_local(self) -> bool:
        """True when the mesh holds this rank alone."""
        return self.flat_ranks() == (process_index(),)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.ranks.tolist()})"


_lock = threading.Lock()
_global_mesh: Optional[Mesh] = None


def make_mesh(ranks: Optional[Sequence[int]] = None,
              data: Optional[int] = None, model: int = 1) -> Mesh:
    """A (data, model) mesh over ``ranks`` (default: every rank of the
    world, in rank order)."""
    if ranks is None:
        ranks = range(process_count())
    ranks = [int(r) for r in ranks]
    n = len(ranks)
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh shape {data}x{model} != {n} ranks")
    return Mesh(np.asarray(ranks).reshape(data, model))


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _global_mesh
    with _lock:
        _global_mesh = mesh


def get_mesh() -> Mesh:
    """The process-global mesh: the one set by :func:`set_mesh` or
    :func:`mesh_scope`, else the mesh over every rank of the live world,
    built anew each call so that it follows the world; the one-rank mesh
    without a world. ``KEYSTONE_TORCH_MESH_MODEL=k`` sizes that default
    mesh's ``model`` axis (1 when unset)."""
    with _lock:
        if _global_mesh is not None:
            return _global_mesh
    raw = os.environ.get("KEYSTONE_TORCH_MESH_MODEL") or "1"
    try:
        model = int(raw)
    except ValueError:
        raise ValueError(
            f"KEYSTONE_TORCH_MESH_MODEL must be an integer, got {raw!r}"
        ) from None
    return make_mesh(model=model)


@contextlib.contextmanager
def mesh_scope(mesh: Mesh) -> Iterator[Mesh]:
    """Temporarily replace the global mesh."""
    global _global_mesh
    with _lock:
        prev = _global_mesh
        _global_mesh = mesh
    try:
        yield mesh
    finally:
        with _lock:
            _global_mesh = prev


def num_data_shards(mesh: Optional[Mesh] = None) -> int:
    return (mesh or get_mesh()).shape[DATA_AXIS]


def replication_factor(mesh: Optional[Mesh] = None) -> int:
    """Replicas of a data-sharded batch the mesh holds: the ``model``
    axis size (each replica is staged by its own rank)."""
    return (mesh or get_mesh()).shape[MODEL_AXIS]


def local_mesh(model: int = 1) -> Mesh:
    """The mesh of this rank alone: what a shard-local streamed fit
    stages onto (each rank stages only its own chunks, and the carries
    merge at finalize). ``model`` must be 1: one rank has one device."""
    if model != 1:
        raise ValueError("a rank's local mesh has one device: model=1")
    return Mesh([[process_index()]])


def world_data_mesh(model: int = 1) -> Mesh:
    """The mesh over every rank of the world, rank-major on ``data``:
    what the sharded apply and the rank-sharded solves run on."""
    return make_mesh(model=model)


# -- row shards ---------------------------------------------------------------

def shard_bounds(n: int, shards: int) -> np.ndarray:
    """Row bounds of ``shards`` contiguous blocks of ``n`` rows (the same
    partition on every launch, which keeps a resumed world's shards)."""
    return np.linspace(0, int(n), int(shards) + 1).astype(np.int64)


def batch_rows(n: int, mesh: Optional[Mesh] = None,
               rank: Optional[int] = None) -> Tuple[int, int]:
    """The row range [lo, hi) of ``n`` rows that ``rank`` (default this
    one) holds under ``mesh``'s data axis: the port's counterpart of a
    ``batch_sharding`` shard."""
    mesh = mesh or get_mesh()
    i, _ = mesh.coords(rank)
    b = shard_bounds(n, mesh.shape[DATA_AXIS])
    return int(b[i]), int(b[i + 1])


def batch_sharding(mesh: Optional[Mesh] = None):
    """The row-range function of a batch sharded over ``mesh``'s data
    axis: ``n -> (lo, hi)`` of this rank."""
    mesh = mesh or get_mesh()
    return lambda n: batch_rows(n, mesh)


def replicated_sharding(mesh: Optional[Mesh] = None):
    """The row-range function of a replicated batch: every row."""
    return lambda n: (0, int(n))


def shard_put(arr, sharding, *, device=None) -> torch.Tensor:
    """This rank's rows of a host array (every rank passes the same
    global array) on ``device``: the counterpart of the JAX
    ``shard_put``, whose processes each put their own shards. The rows
    cross through the stream stager's path (``torch.as_tensor`` of a
    numpy view, one copy)."""
    from ..ops.device import DEFAULT_DEVICE, resolve_device

    lo, hi = sharding(int(arr.shape[0]))
    dev = resolve_device(DEFAULT_DEVICE if device is None else device)
    if isinstance(arr, torch.Tensor):
        return arr[lo:hi].to(dev)
    return torch.as_tensor(np.ascontiguousarray(np.asarray(arr)[lo:hi]),
                           device=dev)


# -- the world ----------------------------------------------------------------

class _World:
    """What :func:`initialize_distributed` set up."""

    __slots__ = ("rank", "size", "local_rank", "local_size", "device",
                 "backend", "cpu_group", "rule")

    def __init__(self, rank, size, local_rank, local_size, device, backend,
                 cpu_group, rule):
        self.rank, self.size = rank, size
        self.local_rank, self.local_size = local_rank, local_size
        self.device, self.backend = device, backend
        self.cpu_group, self.rule = cpu_group, rule


_WORLD: Optional[_World] = None


def world() -> Optional[_World]:
    """The live world, or None."""
    return _WORLD


def process_index() -> int:
    """This process's rank (0 without a world)."""
    w = _WORLD
    return 0 if w is None else w.rank


def process_count() -> int:
    """The world size (1 without a world)."""
    w = _WORLD
    return 1 if w is None else w.size


def pick_backend(device: torch.device, local_size: int,
                 gpus: int) -> Tuple[str, str]:
    """The backend rule, never a ``try``: NCCL when every rank of the
    node has a GPU of its own; gloo on the CPU and when ranks share a
    card (NCCL refuses two ranks on one device). Returns the backend and
    the rule's reason."""
    if device.type != "cuda":
        return "gloo", "gloo: ranks on the CPU"
    if local_size <= gpus:
        return "nccl", (f"nccl: {local_size} rank(s) on this node, each "
                        f"with its own of {gpus} GPU(s)")
    return "gloo", (f"gloo: {local_size} ranks share {gpus} GPU(s) on this "
                    "node (NCCL refuses two ranks on one device)")


def coord_timeout_s() -> float:
    raw = os.environ.get("KEYSTONE_TORCH_COORD_TIMEOUT_S")
    if not raw:
        return DEFAULT_TIMEOUT_S
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"KEYSTONE_TORCH_COORD_TIMEOUT_S must be a "
                         f"number, got {raw!r}") from None


def _init_method(coordinator_address: Optional[str]) -> str:
    if coordinator_address is None:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                               "WORLD_SIZE") if not os.environ.get(k)]
        if missing:
            raise ValueError(
                "a world without --coordinator reads torchrun's "
                f"environment; {', '.join(missing)} is not set")
        return "env://"
    if "://" in coordinator_address:
        return coordinator_address          # file:///path, tcp://h:p
    host, _, port = coordinator_address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"--coordinator expects HOST:PORT or file://PATH, "
                         f"got {coordinator_address!r}")
    return f"tcp://{host}:{port}"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda", quiet: bool = False) -> _World:
    """Start this rank's world (a no-op when one is live): one rank per
    GPU, ``torch.cuda.set_device(local_rank)`` when ``device`` is CUDA
    (without a card that raises, as every entry point does), the backend
    by :func:`pick_backend` (printed with its rule), every collective
    under ``KEYSTONE_TORCH_COORD_TIMEOUT_S``, and a gloo group of CPU
    tensors for the coordination rounds (the default group when the
    backend is gloo). ``coordinator_address`` is ``HOST:PORT`` (TCP),
    ``file://PATH`` (a store file every rank can see) or None
    (torchrun's ``env://``). The local rank is ``LOCAL_RANK`` or the
    process id, the node's rank count ``LOCAL_WORLD_SIZE`` or the world
    size: the launchers here run one node."""
    global _WORLD
    from ..ops.device import resolve_device

    if _WORLD is not None:
        return _WORLD
    init = _init_method(coordinator_address)
    if init == "env://":
        rank = int(os.environ["RANK"])
        size = int(os.environ["WORLD_SIZE"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and "
                             "process_id")
        rank, size = int(process_id), int(num_processes)
    if not 0 <= rank < size:
        raise ValueError(f"process id {rank} outside a world of {size}")
    dev = resolve_device(device)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    gpus = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend, rule = pick_backend(dev, local_size, gpus)
    if dev.type == "cuda":
        # two ranks on one card share it (gloo); each its own otherwise
        dev = torch.device("cuda", local_rank % gpus)
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=coord_timeout_s())
    kw = {} if init == "env://" else {"rank": rank, "world_size": size}
    dist.init_process_group(backend, init_method=init, timeout=timeout, **kw)
    cpu_group = (dist.new_group(backend="gloo", timeout=timeout)
                 if backend != "gloo" else dist.group.WORLD)
    _WORLD = _World(rank, size, local_rank, local_size, dev, backend,
                    cpu_group, rule)
    if size > 1:
        from ..resilience.events import set_process_dimension

        set_process_dimension(rank)
    if not quiet:
        print(f"world: rank {rank} of {size} on {dev}, backend {rule}",
              file=sys.stderr, flush=True)
    return _WORLD


def shutdown_distributed() -> None:
    """Leave the world (idempotent): the process group goes, and the
    events' process dimension with it."""
    global _WORLD
    if _WORLD is None:
        return
    _WORLD = None
    if dist.is_initialized():
        dist.destroy_process_group()
    from ..resilience.events import set_process_dimension

    set_process_dimension(None)
