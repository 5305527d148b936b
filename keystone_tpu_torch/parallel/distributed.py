"""The multi-process world: coordination of a streamed fit, the
deterministic collectives the solvers use, and the dryrun launcher.

Counterpart of ``keystone_tpu/parallel/distributed.py`` on
``torch.distributed``, one process (rank) per GPU:

* **world introspection**: :func:`process_index` / :func:`process_count`
  / :func:`is_distributed` (0 / 1 / False without a world);

* **deterministic collectives**: :func:`world_gather` gathers a tensor
  from every rank of the world (the JAX ``process_allgather``), and
  :func:`world_sum` sums the gathered parts of the ranks along one mesh
  axis in rank order, on every rank alike. No reduction here uses an
  all-reduce, whose summation order is the library's: the same inputs
  give the same bits on every rank and on every relaunch, which is what
  makes a killed and resumed world ``torch.equal`` to an uninterrupted
  one. Under NCCL a CUDA tensor gathers in place; under gloo it is
  copied to a pinned host buffer, gathered there and copied back, the
  staging written out here rather than left to the backend;

* :class:`WorldCoordinator`: the rounds of the world loop of
  ``fit_streaming`` (``parallel/streaming.py``). Each rank folds its
  shard-local chunks and the ranks meet every ``checkpoint_every``
  chunks: one fixed-shape all-gather of ``(cursor, done, has_carry,
  saved_cursor)`` int64 rows, always on the gloo group of CPU tensors.
  :meth:`~WorldCoordinator.step_begin` dispatches it with
  ``async_op=True`` and :meth:`~WorldCoordinator.step_await` waits on its
  work, so round k's exchange hides behind round k+1's chunks. At
  finalize the carries merge once (:meth:`~WorldCoordinator.merge_carries`:
  gather, then sum in rank order), as do the drift sketches;

* :class:`DryrunWorld`: spawns N processes on this machine wired as one
  world, watches for a dead member, applies gang semantics (survivors
  are killed ``grace_s`` after the first exit), and relaunches: the
  kill-one-rank-and-resume tests and ``tools/elastic_gate.py`` drive it.
  Members meet on a ``file://`` store in the world's work directory, so
  concurrent worlds never race for a port.

Telemetry: the ``coord.world_size`` gauge, ``coord.rounds_total``
counter, ``coord.barrier_wait_s`` histogram, ``coord.overlap_occupancy``
gauge (1 - blocked await over round wall), and the ``coord:<tag>`` /
``coord:<tag>:dispatch`` / ``barrier:<name>`` spans. ``coord.step`` (at
dispatch) and ``coord.await`` (at the await point) are fault sites, so
the host-level fault kinds run the real coordination path.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..observability.metrics import MetricsRegistry
from ..observability.reqtrace import mint_flow_id, mint_trace_id
from ..observability.timeline import record_span
from ..resilience.faults import HOST_DEATH_EXIT_CODE, inject
from .mesh import (
    DATA_AXIS,
    Mesh,
    get_mesh,
    process_count,
    process_index,
    world,
)


def is_distributed() -> bool:
    return process_count() > 1


# -- deterministic collectives ----------------------------------------------

def _cpu_group():
    return world().cpu_group


def world_gather(t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape and dtype on every rank), in rank
    order, on ``t``'s device; ``[t]`` without a world. NCCL gathers CUDA
    tensors in place; gloo gathers host tensors, so a CUDA tensor is
    staged through a pinned host buffer and the parts copied back."""
    w = world()
    if w is None:
        return [t]
    t = t.contiguous()
    if t.device.type == "cuda" and w.backend == "nccl":
        parts = [torch.empty_like(t) for _ in range(w.size)]
        dist.all_gather(parts, t)
        return parts
    if t.device.type == "cuda":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)     # synchronous: the gather reads it next
        parts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 for _ in range(w.size)]
        dist.all_gather(parts, host, group=w.cpu_group)
        return [p.to(t.device, non_blocking=True) for p in parts]
    parts = [torch.empty_like(t) for _ in range(w.size)]
    dist.all_gather(parts, t, group=w.cpu_group)
    return parts


def world_sum(t: torch.Tensor, mesh: Optional[Mesh] = None,
              axis: str = DATA_AXIS) -> torch.Tensor:
    """The sum of ``t`` over the ranks along ``axis`` of ``mesh`` (default
    the global mesh) through this rank, added in rank order after one
    gather from every rank: deterministic, and the same bits on every
    rank of the group. ``t`` itself without a world (a world of one
    still gathers, through its backend). Every rank of the world must
    call it (the SPMD contract)."""
    mesh = mesh or get_mesh()
    if world() is None:
        return t
    parts = world_gather(t)
    members = mesh.group(axis)
    out = parts[members[0]].clone()
    for r in members[1:]:
        out += parts[r]
    return out


def world_scalar_sum(value: float, mesh: Optional[Mesh] = None,
                     axis: str = DATA_AXIS) -> float:
    """:func:`world_sum` of a host number (a row count), in float64."""
    t = torch.tensor([float(value)], dtype=torch.float64)
    return float(world_sum(t, mesh, axis)[0])


def world_concat(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The parts of the ranks along ``axis`` through this rank,
    concatenated on their last dimension in axis order (a class-split
    result made whole on every rank)."""
    if world() is None:
        return t
    parts = world_gather(t)
    return torch.cat([parts[r] for r in mesh.group(axis)], dim=-1)


# -- the coordination rounds -------------------------------------------------

@dataclass(frozen=True)
class WorldState:
    """What one coordination round learned about the world."""

    round: int
    cursors: Tuple[int, ...]    # per-rank local chunk cursor
    dones: Tuple[bool, ...]     # per-rank "my shard is exhausted"
    carries: Tuple[bool, ...]   # per-rank "I hold a carry": every rank
                                # sees an empty peer shard together
    all_done: bool
    #: per-rank cursor of the last sidecar it wrote durably (-1: none);
    #: it rides the same payload, so a rank renames its sidecar before
    #: dispatching the round that reports it, and rank 0 merges the
    #: world snapshot only after awaiting such a round
    saved_cursors: Tuple[int, ...] = ()


@dataclass
class PendingStep:
    """One dispatched, unawaited round: ``work`` is the async gather's
    handle and ``parts`` its output buffers (None on the synchronous
    path, where ``result`` is already filled). The handle must reach
    :meth:`WorldCoordinator.step_await` exactly once (the
    ``unawaited-collective`` pass, ``analysis/spmd.py``)."""

    round: int
    cursor: int
    dispatched_at: float
    flow: int
    work: Any = None
    result: Optional[np.ndarray] = None
    parts: Optional[List[torch.Tensor]] = None


class WorldCoordinator:
    """Round-based coordination of one distributed streamed fit. One
    instance per fit; every method is a COLLECTIVE: all ranks call it
    the same number of times in the same order, which the
    ``fit_streaming`` round loop guarantees by construction."""

    def __init__(self, tag: str = "stream"):
        self.pid = process_index()
        self.nproc = process_count()
        self.tag = tag
        self.rounds = 0
        self.trace_id = mint_trace_id("coord")
        self._round_flow: Optional[int] = None
        self._await_wall = 0.0
        self._round_wall = 0.0
        self._last_boundary: Optional[float] = None
        # KEYSTONE_TORCH_COORD_OVERLAP=0: each round is awaited as it is
        # dispatched, the same gathers in the same order
        self._overlap = os.environ.get(
            "KEYSTONE_TORCH_COORD_OVERLAP", "1") not in ("0", "false", "off")
        MetricsRegistry.get_or_create().gauge(
            "coord.world_size").set(self.nproc)

    def step_begin(self, cursor: int, done: bool, has_carry: bool = True,
                   saved_cursor: int = -1) -> PendingStep:
        """Dispatch one round's ``(cursor, done, has_carry,
        saved_cursor)`` exchange on the gloo group and return the
        in-flight handle; every handle must reach :meth:`step_await`
        exactly once, in dispatch order. With overlap off the gather is
        waited for here, and the handle comes back with its result."""
        inject("coord.step", context=f"{self.tag}:round{self.rounds}")
        t0 = time.perf_counter()
        row = torch.tensor([int(cursor), 1 if done else 0,
                            1 if has_carry else 0, int(saved_cursor)],
                           dtype=torch.int64)
        flow = mint_flow_id()
        pend = PendingStep(round=self.rounds, cursor=int(cursor),
                           dispatched_at=t0, flow=flow)
        if self.nproc == 1:
            pend.result = row.numpy()[None, :]
        else:
            pend.parts = [torch.empty_like(row) for _ in range(self.nproc)]
            pend.work = dist.all_gather(pend.parts, row, group=_cpu_group(),
                                        async_op=True)
            if not self._overlap:
                # the blocked wait moves here from the await: the same
                # coordination overhead, hidden behind nothing
                t_wait = time.perf_counter()
                pend.work.wait()
                self._await_wall += time.perf_counter() - t_wait
                pend.result = torch.stack(pend.parts).numpy()
                pend.work = pend.parts = None
        self.rounds += 1
        record_span(f"coord:{self.tag}:dispatch", "coord", t0,
                    time.perf_counter() - t0,
                    args={"round": pend.round, "cursor": pend.cursor,
                          "trace_id": self.trace_id, "flow_out": flow})
        return pend

    def step_await(self, pending: PendingStep) -> WorldState:
        """The await point of a dispatched round (``coord.await`` is the
        fault site between dispatch and await): wait on the gather and
        fold the world's view. Only time blocked on a gather, here or,
        with overlap off, at the dispatch, is coordination overhead
        (:meth:`overhead_share`)."""
        inject("coord.await", context=f"{self.tag}:round{pending.round}")
        t0 = time.perf_counter()
        if pending.result is None:
            pending.work.wait()
            pending.result = torch.stack(pending.parts).numpy()
            pending.work = pending.parts = None
        gathered = pending.result
        end = time.perf_counter()
        wait_s = end - t0
        anchor = (self._last_boundary if self._last_boundary is not None
                  else pending.dispatched_at)
        self._await_wall += wait_s
        self._round_wall += max(end - anchor, 1e-9)
        self._last_boundary = end
        reg = MetricsRegistry.get_or_create()
        reg.histogram("coord.barrier_wait_s").observe(wait_s)
        reg.counter("coord.rounds_total").inc()
        reg.gauge("coord.overlap_occupancy").set(
            max(0.0, 1.0 - self.overhead_share()))
        args: dict = {"round": pending.round, "cursor": pending.cursor,
                      "trace_id": self.trace_id, "flow_out": pending.flow}
        if self._round_flow is not None:
            args["flow_in"] = [self._round_flow]
        self._round_flow = pending.flow
        record_span(f"coord:{self.tag}", "coord", t0, wait_s, args=args)
        return WorldState(
            round=pending.round,
            cursors=tuple(int(c) for c in gathered[:, 0]),
            dones=tuple(bool(d) for d in gathered[:, 1]),
            carries=tuple(bool(c) for c in gathered[:, 2]),
            all_done=bool(gathered[:, 1].all()),
            saved_cursors=tuple(int(s) for s in gathered[:, 3]))

    def step(self, cursor: int, done: bool,
             has_carry: bool = True) -> WorldState:
        """A synchronous round: dispatch and await at once."""
        pending = self.step_begin(cursor, done, has_carry=has_carry)
        return self.step_await(pending)

    def overhead_share(self) -> float:
        """Blocked wall over round wall, over the fit so far: the share
        of coordination the overlap did not hide (0 until the first
        await). The blocked wall is every wait on a round's gather: at
        the await, or at the dispatch with overlap off."""
        if self._round_wall <= 0.0:
            return 0.0
        return min(1.0, self._await_wall / self._round_wall)

    def barrier(self, name: str) -> None:
        """A named world barrier on the gloo group (the name labels the
        span; call sites pass literals, ``analysis/spmd.py`` checks)."""
        t0 = time.perf_counter()
        if self.nproc > 1:
            dist.barrier(group=_cpu_group())
        wait_s = time.perf_counter() - t0
        MetricsRegistry.get_or_create().histogram(
            "coord.barrier_wait_s").observe(wait_s)
        record_span(f"barrier:{name}", "coord", t0, wait_s,
                    args={"trace_id": self.trace_id})

    # -- finalize-time reductions ------------------------------------------
    def merge_carries(self, carry: Any,
                      reducer: Optional[Callable[[List[Any]], Any]] = None
                      ) -> Any:
        """Merge the ranks' carries: gather every leaf once, then fold in
        RANK ORDER (deterministic, so a resumed world merges to the same
        bits). The default fold sums each leaf, right for every additive
        carry (Gram, cross products, sums, moments, row counts); an
        estimator with another carry supplies ``reducer(per_rank)``.
        Host numbers gather as float64 (ints stay ints)."""
        leaves: List[Any] = []

        def flatten(c):
            if isinstance(c, (tuple, list)):
                return type(c)(flatten(x) for x in c)
            leaves.append(c)
            return len(leaves) - 1

        shape = flatten(carry)
        if world() is None:
            return carry
        gathered: List[List[Any]] = []
        for leaf in leaves:
            if isinstance(leaf, torch.Tensor):
                gathered.append(world_gather(leaf))
            else:
                host = torch.tensor([float(leaf)], dtype=torch.float64)
                parts = world_gather(host)
                cast = int if isinstance(leaf, (int, np.integer)) else float
                gathered.append([cast(p[0].item()) for p in parts])

        def build(s, pick):
            if isinstance(s, (tuple, list)):
                return type(s)(build(x, pick) for x in s)
            return pick(gathered[s])

        if reducer is not None:
            return reducer([build(shape, lambda g, p=p: g[p])
                            for p in range(self.nproc)])

        def total(parts):
            if isinstance(parts[0], torch.Tensor):
                out = parts[0].clone()
                for p in parts[1:]:
                    out += p
                return out
            return sum(parts[1:], parts[0])

        return build(shape, total)

    def merge_baselines(self, baseline: Any) -> Any:
        """Merge the ranks' drift sketches into one world baseline. Bin
        edges are pinned per rank from its first chunk, so a rank whose
        edges differ from rank 0's is skipped, and the shortfall is
        recorded as a ``numerics.drift_merge`` event (merged / hosts);
        every rank computes the same merge from the same gathered
        states."""
        from ..observability.numerics import (
            DriftBaseline,
            record_numerics_event,
        )

        st = baseline.state()
        leaf = {k: torch.as_tensor(np.asarray(st[k]))
                for k in ("cols", "interior", "counts")}
        # shapes agree (the tracker's fixed geometry): gather each leaf
        got = {k: [p.numpy() for p in world_gather(v)]
               for k, v in leaf.items()}
        rows = [float(p[0]) for p in world_gather(
            torch.tensor([float(st["rows"])], dtype=torch.float64))]
        ranks = [DriftBaseline.from_state(
            {"cols": got["cols"][p], "interior": got["interior"][p],
             "counts": got["counts"][p], "rows": rows[p],
             "source": baseline.source}) for p in range(self.nproc)]
        world, merged = ranks[0], 1
        for other in ranks[1:]:
            try:
                world = world.merge(other)
            except ValueError:
                continue  # edges differ from rank 0's: skipped, recorded
            merged += 1
        record_numerics_event("drift_merge", source=self.tag,
                              merged=merged, hosts=self.nproc)
        return world


# -- the dryrun launcher -----------------------------------------------------

def free_coordinator_port() -> int:
    """An OS-assigned free localhost port for a ``HOST:PORT``
    coordinator (the launcher itself meets on a store file)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


class DryrunWorld:
    """Spawn, watch, kill and relaunch an N-rank world on this machine:
    the test and CI stand-in for a cluster.

    Every member runs the same command with ``<process_id>
    <num_processes> <store>`` appended by :meth:`launch` (``store`` is a
    ``file://`` path in ``workdir``, fresh for each launch), or, for the
    apps, the ``--coordinator/--num-processes/--process-id`` flags of
    ``python -m keystone_tpu_torch`` (:meth:`launch_app`). Members get
    ``OMP_NUM_THREADS=1`` (the tests run several worlds side by side;
    the worker sets torch's threads from it), ``LOCAL_WORLD_SIZE`` (one
    node), and
    log to their own files (no pipe to fill).

    Gang semantics: once any member exits, the others get ``grace_s``
    to finish and are then killed, as a lost rank wedges its peers in a
    collective; recovery is relaunch and resume."""

    def __init__(self, num_processes: int = 2, *,
                 workdir: Optional[str] = None,
                 grace_s: float = 20.0, env: Optional[dict] = None):
        self.num_processes = int(num_processes)
        self.grace_s = float(grace_s)
        self.workdir = workdir or tempfile.mkdtemp(prefix="keystone-dryrun-")
        os.makedirs(self.workdir, exist_ok=True)
        self.extra_env = dict(env or {})
        self.store: Optional[str] = None
        self.procs: List[subprocess.Popen] = []
        self._log_paths: List[str] = []
        self._launches = 0

    def _member_env(self) -> dict:
        env = dict(os.environ)
        env["OMP_NUM_THREADS"] = "1"
        env["LOCAL_WORLD_SIZE"] = str(self.num_processes)
        root = _repo_root()
        env["PYTHONPATH"] = root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        env.update(self.extra_env)
        return env

    def launch(self, argv: Sequence[str],
               per_process_argv: Optional[Callable[[int, int, str],
                                                   List[str]]] = None
               ) -> "DryrunWorld":
        """Start all members. ``argv`` is the common command prefix; each
        member appends ``<process_id> <num_processes> <store>``, or
        ``per_process_argv(pid, nproc, store)`` builds each command."""
        if self.procs and any(p.poll() is None for p in self.procs):
            raise RuntimeError("world is already running; wait() or "
                               "kill() it before relaunching")
        self._launches += 1
        path = os.path.join(self.workdir, f"store{self._launches}")
        if os.path.exists(path):
            os.remove(path)
        self.store = "file://" + path
        env = self._member_env()
        self.procs = []
        self._log_paths = []
        for pid in range(self.num_processes):
            if per_process_argv is not None:
                cmd = per_process_argv(pid, self.num_processes, self.store)
            else:
                cmd = list(argv) + [str(pid), str(self.num_processes),
                                    self.store]
            log_path = os.path.join(
                self.workdir, f"launch{self._launches}.p{pid}.log")
            self._log_paths.append(log_path)
            member_env = dict(env, LOCAL_RANK=str(pid))
            with open(log_path, "wb") as log:
                self.procs.append(subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT,
                    env=member_env))
        return self

    def launch_app(self, app: str, args: Sequence[str] = ()
                   ) -> "DryrunWorld":
        """Launch a ``python -m keystone_tpu_torch`` app over the world
        through the command line's own multi-process flags."""
        def per_process(pid: int, nproc: int, store: str) -> List[str]:
            return [sys.executable, "-m", "keystone_tpu_torch", app,
                    "--coordinator", store, "--num-processes", str(nproc),
                    "--process-id", str(pid), *args]

        return self.launch([], per_process_argv=per_process)

    def wait(self, timeout_s: float = 300.0) -> List[int]:
        """Block until the world drains, with gang semantics; returns the
        members' exit codes. Past ``timeout_s`` every member is killed
        and ``TimeoutError`` raised."""
        deadline = time.monotonic() + timeout_s
        first_exit: Optional[float] = None
        while True:
            codes = [p.poll() for p in self.procs]
            if all(c is not None for c in codes):
                return [int(c) for c in codes]
            now = time.monotonic()
            if first_exit is None and any(c is not None for c in codes):
                first_exit = now
            if first_exit is not None and now - first_exit > self.grace_s:
                self.kill()
            if now > deadline:
                self.kill()
                raise TimeoutError(
                    f"dryrun world did not drain in {timeout_s:g}s "
                    f"(exit codes so far: {codes}; logs under "
                    f"{self.workdir})")
            time.sleep(0.05)

    def kill(self) -> None:
        """SIGKILL every member still running (machine loss, not a
        graceful stop) and reap it."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except (subprocess.TimeoutExpired, OSError):
                pass  # reaped best-effort; poll() callers see the truth

    def output(self, pid: int) -> str:
        if not self._log_paths:
            return ""
        with open(self._log_paths[pid], "rb") as f:
            return f.read().decode(errors="replace")

    def host_death_exits(self, codes: Sequence[int]) -> List[int]:
        """The members that died of an injected ``host_death``."""
        return [i for i, c in enumerate(codes)
                if c == HOST_DEATH_EXIT_CODE]

    def __enter__(self) -> "DryrunWorld":
        return self

    def __exit__(self, *exc) -> None:
        self.kill()

