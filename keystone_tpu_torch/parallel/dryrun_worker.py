"""One rank of a :class:`~keystone_tpu_torch.parallel.distributed.DryrunWorld`.

Counterpart of ``keystone_tpu/parallel/dryrun_worker.py``: starts the
world on the launcher's store, runs a shard-local streamed fit through
the real world loop of ``fit_streaming`` (coordination rounds,
coordinated checkpoints, the carries merged at finalize) under this
rank's local mesh, and prints a line the launcher checks::

    ELASTIC_OK pid=0 world=2 rows=192 resumed=0 unexpected_compiles=0 \
solves=1 digest=91f2a4...

Faults are injected with the host-level :class:`~keystone_tpu_torch.
resilience.faults.FaultPlan` kinds (``--die-process`` a ``host_death``,
``--straggle-process`` a ``straggler`` at the coordination site,
``--partition-process`` a ``partition``): every rank installs the same
plan and the ``process_id`` gate picks the victim.

Checked in the worker, so that exit 0 means more than "did not crash":
the weights' digest is gathered and must be the same on every rank
(the finalize merge replicates), and ``unexpected_compiles`` reports the
capture fence's verdict on the world path.

Usage (the launcher appends the positionals; ``store`` is a
``file://`` path or a TCP port on this machine)::

    python -m keystone_tpu_torch.parallel.dryrun_worker [flags] \
        <process_id> <num_processes> <store>
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import sys
import time


def _parse(argv):
    p = argparse.ArgumentParser(prog="dryrun_worker")
    p.add_argument("--data", default=None,
                   help=".npz with arrays X (n, d) and Y (n, k); each "
                        "rank takes its contiguous 1/world block")
    p.add_argument("--tar-dir", default=None,
                   help="shard-local tar ingest: each rank decodes only "
                        "its rank-strided archives (stream_tar_shards) "
                        "and fits a StandardScaler")
    p.add_argument("--chunk-size", type=int, default=32)
    p.add_argument("--estimator", default="linear",
                   choices=("linear", "auto", "scaler"))
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=2)
    p.add_argument("--out", default=None,
                   help="rank 0 writes the fitted weights here (.npz)")
    p.add_argument("--die-process", type=int, default=None)
    p.add_argument("--die-at-chunk", type=int, default=None,
                   help="host_death fires after this many produced chunks "
                        "on --die-process")
    p.add_argument("--die-at-round", type=int, default=None,
                   help="host_death fires entering this coordination "
                        "round on --die-process")
    p.add_argument("--die-at-await-round", type=int, default=None,
                   help="host_death fires at this round's await point on "
                        "--die-process (between a round's dispatch and "
                        "its await, with a carry copy in flight)")
    p.add_argument("--straggle-process", type=int, default=None)
    p.add_argument("--partition-process", type=int, default=None)
    p.add_argument("--partition-at-round", type=int, default=1)
    p.add_argument("--bench", action="store_true",
                   help="rank 0 prints an images/sec metric line (and the "
                        "coordination overhead pair)")
    p.add_argument("--warmup", action="store_true",
                   help="fit once untimed first")
    p.add_argument("--device", default="cuda",
                   help="each rank's device: cuda (the default; refused "
                        "without a card) or cpu")
    p.add_argument("process_id", type=int)
    p.add_argument("num_processes", type=int)
    p.add_argument("store")
    return p.parse_args(argv)


def _build_plan(args):
    from keystone_tpu_torch.resilience.faults import FaultPlan

    plan = FaultPlan(seed=0)
    used = False
    if args.die_process is not None:
        if args.die_at_await_round is not None:
            plan.add("coord.await", kind="host_death",
                     after=args.die_at_await_round, count=1,
                     process_id=args.die_process)
        elif args.die_at_round is not None:
            plan.add("coord.step", kind="host_death",
                     after=args.die_at_round, count=1,
                     process_id=args.die_process)
        else:
            plan.add("ingest.produce", kind="host_death",
                     after=(3 if args.die_at_chunk is None
                            else args.die_at_chunk), count=1,
                     process_id=args.die_process)
        used = True
    if args.straggle_process is not None:
        plan.add("coord.step", kind="straggler",
                 process_id=args.straggle_process)
        used = True
    if args.partition_process is not None:
        plan.add("coord.step", kind="partition",
                 after=args.partition_at_round, count=1,
                 process_id=args.partition_process)
        used = True
    return plan if used else None


def coordinator_of(store: str) -> str:
    """A launcher positional as a coordinator address: a bare port is a
    TCP coordinator on this machine, anything else a store URL."""
    return f"127.0.0.1:{store}" if store.isdigit() else store


def limit_threads() -> None:
    """torch's intra-op threads as ``OMP_NUM_THREADS`` says, where the
    launcher set it (one: several worlds share the machine)."""
    import torch

    raw = os.environ.get("OMP_NUM_THREADS")
    if raw:
        torch.set_num_threads(int(raw))


def main(argv=None) -> int:
    args = _parse(sys.argv[1:] if argv is None else list(argv))
    limit_threads()
    import numpy as np
    import torch

    from keystone_tpu_torch.parallel.mesh import (
        initialize_distributed,
        local_mesh,
        mesh_scope,
        process_count,
        process_index,
        shard_bounds,
    )

    w = initialize_distributed(coordinator_of(args.store),
                               args.num_processes, args.process_id,
                               device=args.device)
    pid, nproc = process_index(), process_count()

    from keystone_tpu_torch.observability.compilelog import (
        compile_observatory,
    )
    from keystone_tpu_torch.observability.metrics import MetricsRegistry
    from keystone_tpu_torch.parallel.distributed import world_gather
    from keystone_tpu_torch.parallel.streaming import (
        StreamingDataset,
        fit_streaming,
    )

    plan = _build_plan(args)
    obs = compile_observatory()
    with mesh_scope(local_mesh()):
        labels = None
        archives = None
        if args.tar_dir is not None:
            from keystone_tpu_torch.loaders.image_loader_utils import (
                stream_tar_shards,
            )
            from keystone_tpu_torch.nodes.stats import StandardScaler

            def prepare(batch):
                return np.stack([img for _, img in batch]).reshape(
                    len(batch), -1).astype(np.float32)

            stream = stream_tar_shards(args.tar_dir, args.chunk_size,
                                       prepare=prepare, device=w.device)
            archives = [os.path.basename(a) for a in stream.shard_archives]
            rows_total = None
            est = StandardScaler()
        else:
            blob = np.load(args.data)
            X, Y = blob["X"], blob["Y"]
            # the contiguous block of this rank: the same partition on
            # every relaunch, which keeps a resume bit-identical
            bounds = shard_bounds(X.shape[0], nproc)
            lo, hi = int(bounds[pid]), int(bounds[pid + 1])
            Xl = np.ascontiguousarray(X[lo:hi])
            rows_total = int(X.shape[0])
            stream = StreamingDataset.from_numpy(
                Xl, chunk_size=args.chunk_size, tag="elastic",
                device=w.device)
            if args.estimator == "scaler":
                from keystone_tpu_torch.nodes.stats import StandardScaler

                est = StandardScaler()
            else:
                labels = np.ascontiguousarray(Y[lo:hi])
                if args.estimator == "linear":
                    from keystone_tpu_torch.nodes.learning.linear import (
                        LinearMapEstimator,
                    )

                    est = LinearMapEstimator(lam=0.1)
                else:
                    from keystone_tpu_torch.nodes.learning.least_squares \
                        import LeastSquaresEstimator

                    est = LeastSquaresEstimator(lam=0.1)

        if args.warmup and args.data is not None:
            fit_streaming(est, StreamingDataset.from_numpy(
                Xl, chunk_size=args.chunk_size, tag="elastic-warmup",
                device=w.device), labels)
        t0 = time.perf_counter()
        ctx = plan if plan is not None else contextlib.nullcontext()
        try:
            with ctx:
                model = fit_streaming(
                    est, stream, labels,
                    checkpoint_dir=args.checkpoint_dir,
                    checkpoint_every=(args.checkpoint_every
                                      if args.checkpoint_dir else None))
        except BaseException:
            # gang semantics: a failed step ends the rank at once; an
            # orderly exit could wait in the process group's teardown on
            # peers stuck in a collective this rank left
            import traceback

            traceback.print_exc()
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(1)
        wall = time.perf_counter() - t0

        if hasattr(model, "weights"):
            wts = np.asarray(model.weights.cpu() if isinstance(
                model.weights, torch.Tensor) else model.weights, np.float32)
        else:  # StandardScalerModel: mean (+ std)
            wts = np.asarray(model.mean, np.float32)
            std = getattr(model, "std", None)
            if std is not None:
                wts = np.concatenate([wts, np.asarray(std, np.float32)])
        digest = hashlib.sha256(np.ascontiguousarray(wts).tobytes()
                                ).hexdigest()[:16]
        if nproc > 1:
            token = torch.from_numpy(np.frombuffer(
                bytes.fromhex(digest), dtype=np.int64).copy())
            tokens = [int(t[0]) for t in world_gather(token)]
            if len(set(tokens)) != 1:
                raise SystemExit(f"cross-rank weight divergence: digests "
                                 f"{tokens}")

        snap = MetricsRegistry.get_or_create().snapshot()
        counters = snap.get("counters", {})
        resumed = int(counters.get("resilience.checkpoint_restore", 0))
        solves = int(counters.get("numerics.solves_total", 0))
        unexpected = obs.unexpected_total()
        if pid == 0 and args.out:
            np.savez(args.out, weights=wts)
        line = (f"ELASTIC_OK pid={pid} world={nproc} "
                f"rows={rows_total if rows_total is not None else '?'} "
                f"resumed={resumed} unexpected_compiles={unexpected} "
                f"solves={solves} digest={digest}")
        if archives is not None:
            line += f" archives={','.join(archives)}"
        print(line, flush=True)
        if args.bench and pid == 0 and rows_total:
            print(json.dumps({
                "metric": "elastic_streamed_images_per_sec",
                "value": rows_total / wall, "processes": nproc,
                "chunk_size": args.chunk_size, "warm": bool(args.warmup),
                "device": str(w.device)}), flush=True)
            occ = snap.get("gauges", {}).get("coord.overlap_occupancy")
            if nproc > 1 and occ is not None:
                print(json.dumps({"metric": "coord_overhead_share",
                                  "value": 1.0 - float(occ),
                                  "processes": nproc}), flush=True)
                print(json.dumps({"metric": "coord_overlap_occupancy",
                                  "value": float(occ),
                                  "processes": nproc}), flush=True)
    from keystone_tpu_torch.parallel.mesh import shutdown_distributed

    shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
