"""One rank of the port's CPU worlds in tests/test_torch_world.py.

    python tests/torch_world_worker.py <mode> <in.npz> <out.npz> \
        <process_id> <num_processes> <store>

Modes (every rank runs the same one; rank 0 writes ``out.npz``):

* ``linalg``: the rank-sharded solves over this rank's contiguous block
  of X (n, d) / Y (n, k): ``gram``, ``cross``, ``distributed_mean``,
  ``normal_equations``, ``block_coordinate_descent`` (2 blocks, 3
  passes), ``solve_one_pass_l2`` and ``tsqr_r``, and
  ``WorldCoordinator.merge_carries`` of a (tensor, int) carry;
* ``classes``: the same BCD on a (data 2, model 2) mesh of 4 ranks, the
  label columns split over ``model``;
* ``apply``: ``sharded_apply`` of a LinearMapper, a BlockLinearMapper and
  an int8 LinearMapper, and ``sharded_chain_apply`` of a scaler, at the
  batch sizes in ``sizes``;
* ``weighted``: the block-weighted solver (direct and low-rank paths)
  and the per-class weighted solver over this rank's block of a
  ``shard_dataset``-marked dataset;
* ``app``: ``cifar.random_patch``'s ``main`` with the arguments in
  ``argv`` (a JSON list in the npz), its weights and test predictions;
* ``streamed``: ``fit_streaming`` of a ``LinearMapEstimator`` over this
  rank's block of X / Y in chunks of ``chunk``, once under each
  coordination setting of ``switches`` (a JSON list of environment
  dicts, read when a fit starts): each fit's weights, rounds,
  ``coord.overlap_occupancy`` and the rounds whose gather was still in
  flight when ``WorldCoordinator.step_begin`` returned.
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def _linalg(blob, mesh):
    from keystone_tpu_torch.ops import linalg
    from keystone_tpu_torch.parallel.distributed import WorldCoordinator
    from keystone_tpu_torch.parallel.mesh import batch_rows

    X, Y = blob["X"], blob["Y"]
    lo, hi = batch_rows(X.shape[0], mesh)
    Xl = torch.from_numpy(np.ascontiguousarray(X[lo:hi]))
    Yl = torch.from_numpy(np.ascontiguousarray(Y[lo:hi]))
    mean = linalg.distributed_mean(Xl, hi - lo, mesh)
    Xc = Xl - mean
    blocks = [Xc[:, :X.shape[1] // 2].contiguous(),
              Xc[:, X.shape[1] // 2:].contiguous()]
    Ws = linalg.block_coordinate_descent(blocks, Yl, 0.5, 3, mesh=mesh)
    W1 = linalg.solve_one_pass_l2(blocks, Yl, 0.5, mesh=mesh)
    carry = (Xl.T @ Xl, hi - lo)
    merged = WorldCoordinator("t").merge_carries(carry)
    return {"gram": linalg.gram(Xl, mesh).numpy(),
            "cross": linalg.cross(Xl, Yl, mesh).numpy(),
            "mean": mean.numpy(),
            "ne": linalg.normal_equations(Xl, Yl, 0.5, mesh).numpy(),
            "bcd": torch.cat(Ws).numpy(), "one": torch.cat(W1).numpy(),
            "tsqr": linalg.tsqr_r(Xl, mesh).numpy(),
            "merged_g": merged[0].numpy(), "merged_n": np.array(merged[1])}


def _classes(blob, mesh):
    from keystone_tpu_torch.ops import linalg
    from keystone_tpu_torch.parallel.mesh import batch_rows

    X, Y = blob["X"], blob["Y"]
    lo, hi = batch_rows(X.shape[0], mesh)
    Xl = torch.from_numpy(np.ascontiguousarray(X[lo:hi]))
    Yl = torch.from_numpy(np.ascontiguousarray(Y[lo:hi]))
    blocks = [Xl[:, :X.shape[1] // 2].contiguous(),
              Xl[:, X.shape[1] // 2:].contiguous()]
    Ws = linalg.block_coordinate_descent(blocks, Yl, 0.5, 3, mesh=mesh)
    return {"bcd": torch.cat(Ws).numpy()}


def _apply(blob, mesh):
    from keystone_tpu_torch.nodes.learning.linear import (
        BlockLinearMapper,
        LinearMapper,
    )
    from keystone_tpu_torch.nodes.stats import StandardScalerModel
    from keystone_tpu_torch.parallel.spmd_apply import (
        sharded_apply,
        sharded_chain_apply,
    )

    W, b, mean = blob["W"], blob["b"], blob["mean"]
    models = {
        "lin": LinearMapper(W, intercept=b,
                            feature_scaler=StandardScalerModel(mean)),
        "block": BlockLinearMapper([W[:5], W[5:9], W[9:]], 5, intercept=b,
                                   feature_means=mean),
        "int8": LinearMapper(W, intercept=b, weight_dtype="int8"),
    }
    scaler = StandardScalerModel(mean, blob["std"])
    out = {}
    for size in blob["sizes"]:
        x = blob["X"][:int(size)]
        for name, model in models.items():
            out[f"{name}_{size}"] = sharded_apply(model, x, mesh).numpy()
        out[f"chain_{size}"] = sharded_chain_apply(
            scaler, torch.from_numpy(x), mesh).numpy()
    return out


def _weighted(blob, mesh):
    from keystone_tpu_torch.nodes.learning.block_weighted import (
        BlockWeightedLeastSquaresEstimator,
    )
    from keystone_tpu_torch.nodes.learning.per_class_weighted import (
        PerClassWeightedLeastSquaresEstimator,
    )
    from keystone_tpu_torch.parallel.dataset import ArrayDataset, \
        shard_dataset

    X = shard_dataset(ArrayDataset.from_numpy(blob["X"], "cpu"), mesh)
    L = shard_dataset(ArrayDataset.from_numpy(blob["L"], "cpu"), mesh)
    out = {}
    for solver in ("cholesky", "woodbury"):
        est = BlockWeightedLeastSquaresEstimator(4, 2, 0.5, 0.3,
                                                 solver=solver)
        out[solver] = est._fit(X, L).weights.numpy()
    est = PerClassWeightedLeastSquaresEstimator(4, 2, 0.5, 0.3)
    out["per_class"] = est._fit(X, L).weights.numpy()
    return out


def _app(blob):
    from keystone_tpu_torch.nodes.learning.linear import BlockLinearMapper
    from keystone_tpu_torch.pipelines.images.cifar import (
        random_patch_cifar as rpc,
    )

    pipeline, _, test_eval = rpc.main(json.loads(str(blob["argv"])))
    graph = pipeline.to_pipeline().graph
    mapper = next(graph.get_operator(n) for n in graph.nodes
                  if isinstance(graph.get_operator(n), BlockLinearMapper))
    return {"weights": np.asarray(mapper.weights),
            "test_error": np.array(test_eval.total_error)}


def _streamed(blob):
    from keystone_tpu_torch.nodes.learning.linear import LinearMapEstimator
    from keystone_tpu_torch.observability.metrics import MetricsRegistry
    from keystone_tpu_torch.parallel.distributed import WorldCoordinator
    from keystone_tpu_torch.parallel.mesh import (local_mesh, mesh_scope,
                                                  process_count,
                                                  process_index, shard_bounds)
    from keystone_tpu_torch.parallel.streaming import (StreamingDataset,
                                                       fit_streaming)

    X, Y = blob["X"], blob["Y"]
    bounds = shard_bounds(X.shape[0], process_count())
    lo, hi = int(bounds[process_index()]), int(bounds[process_index() + 1])
    reg = MetricsRegistry.get_or_create()
    in_flight = [0]
    real = WorldCoordinator.step_begin

    def step_begin(self, *args, **kwargs):
        pend = real(self, *args, **kwargs)
        in_flight[0] += pend.result is None
        return pend

    WorldCoordinator.step_begin = step_begin
    out = {}
    for i, env in enumerate(json.loads(str(blob["switches"]))):
        os.environ.update(env)
        in_flight[0] = 0
        try:
            rounds = reg.snapshot()["counters"].get("coord.rounds_total", 0)
            with mesh_scope(local_mesh()):
                stream = StreamingDataset.from_numpy(
                    np.ascontiguousarray(X[lo:hi]),
                    chunk_size=int(blob["chunk"]), tag=f"switch{i}",
                    device="cpu")
                model = fit_streaming(LinearMapEstimator(lam=0.1), stream,
                                      np.ascontiguousarray(Y[lo:hi]))
        finally:
            for key in env:
                del os.environ[key]
        snap = reg.snapshot()
        out[f"weights{i}"] = np.asarray(model.weights, np.float32)
        out[f"rounds{i}"] = np.array(
            snap["counters"]["coord.rounds_total"] - rounds)
        out[f"occupancy{i}"] = np.array(
            snap["gauges"]["coord.overlap_occupancy"])
        out[f"in_flight{i}"] = np.array(in_flight[0])
    return out


def main(argv):
    mode, src, dst, pid, nproc, store = argv
    from keystone_tpu_torch.parallel.dryrun_worker import (
        coordinator_of,
        limit_threads,
    )
    from keystone_tpu_torch.parallel.mesh import (
        initialize_distributed,
        make_mesh,
        process_index,
        shutdown_distributed,
        world_data_mesh,
    )

    limit_threads()
    initialize_distributed(coordinator_of(store), int(nproc), int(pid),
                           device="cpu", quiet=True)
    blob = np.load(src)
    if mode == "linalg":
        out = _linalg(blob, world_data_mesh())
    elif mode == "classes":
        out = _classes(blob, make_mesh(model=2))
    elif mode == "apply":
        out = _apply(blob, world_data_mesh())
    elif mode == "weighted":
        out = _weighted(blob, world_data_mesh())
    elif mode == "streamed":
        out = _streamed(blob)
    else:
        out = _app(blob)
    if process_index() == 0:
        np.savez(dst, **out)
    print(f"WORLD_OK pid={process_index()} mode={mode}", flush=True)
    shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
