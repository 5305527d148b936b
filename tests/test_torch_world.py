"""The port's multi-process world on the CPU: the mesh of ranks, the
coordinator, the host-level fault kinds, the world checkpoint format,
``save_state`` / ``load_state``, and the rank-sharded solves and sharded
apply held against the JAX package.

The worlds are real: gloo worlds of 2 ranks (4 for the ``model`` axis)
launched through the port's ``DryrunWorld`` and
``tests/torch_world_worker.py``, each launched once per module
(``worlds`` fixture), every member reaped under a timeout.
"""
import os
import sys

import numpy as np
import pytest
import torch

from keystone_tpu_torch.parallel import mesh as tmesh
from keystone_tpu_torch.parallel.distributed import (
    DryrunWorld,
    WorldCoordinator,
    is_distributed,
    process_count,
    process_index,
)
from keystone_tpu_torch.resilience import (
    HOST_DEATH_EXIT_CODE,
    CheckpointMismatchError,
    FaultPlan,
    PartitionError,
    StreamCheckpoint,
    inject,
    set_process_dimension,
)

WORKER = os.path.join(os.path.dirname(__file__), "torch_world_worker.py")
N, D, K = 96, 12, 4
SIZES = (1, 5, 13, 16)
TIMEOUT_S = 240


def _xy(n=N, d=D, k=K, seed=0):
    rng = np.random.RandomState(seed)
    X = (rng.randn(n, d) * (1.0 + rng.rand(d))).astype(np.float32)
    Y = (X @ rng.randn(d, k) + 0.1 * rng.randn(n, k)).astype(np.float32)
    return X, Y


def _launch(base, mode, nproc, blob, tag):
    src = os.path.join(base, f"{tag}.in.npz")
    dst = os.path.join(base, f"{tag}.out.npz")
    np.savez(src, **blob)
    world = DryrunWorld(num_processes=nproc,
                        workdir=os.path.join(base, tag), grace_s=20)
    world.launch([sys.executable, WORKER, mode, src, dst])
    return world, dst


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world of this file, launched together and drained once."""
    base = str(tmp_path_factory.mktemp("worlds"))
    X, Y = _xy()
    rng = np.random.RandomState(3)
    apply_blob = {"X": rng.randn(16, D).astype(np.float32),
                  "W": rng.randn(D, K).astype(np.float32),
                  "b": rng.randn(K).astype(np.float32),
                  "mean": rng.randn(D).astype(np.float32),
                  "std": (1 + rng.rand(D)).astype(np.float32),
                  "sizes": np.array(SIZES)}
    wrng = np.random.RandomState(5)
    cls = wrng.randint(0, 3, size=60)
    weighted_blob = {"X": wrng.randn(60, 10).astype(np.float32),
                     "L": np.where(np.arange(3) == cls[:, None], 1.0,
                                   -1.0).astype(np.float32)}
    launched = {
        "weighted": _launch(base, "weighted", 2, weighted_blob, "weighted"),
        "linalg": _launch(base, "linalg", 2, {"X": X, "Y": Y}, "linalg"),
        "classes": _launch(base, "classes", 4, {"X": X, "Y": Y}, "classes"),
        "apply": _launch(base, "apply", 2, apply_blob, "apply"),
    }
    out = {"X": X, "Y": Y, "apply_in": apply_blob,
           "weighted_in": weighted_blob}
    for name, (world, dst) in launched.items():
        codes = world.wait(timeout_s=TIMEOUT_S)
        assert codes == [0] * world.num_processes, (
            name, codes, [world.output(p)[-2000:]
                          for p in range(world.num_processes)])
        out[name] = dict(np.load(dst))
    return out


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(float(np.abs(np.asarray(b)).max()), 1.0))


# -- the rank-sharded solves against the JAX functions -----------------------

def test_sharded_gram_cross_and_mean_match_the_whole(worlds):
    X, Y = worlds["X"], worlds["Y"]
    got = worlds["linalg"]
    assert _rel(got["gram"], X.T.astype(np.float64) @ X) <= 1e-6
    assert _rel(got["cross"], X.T.astype(np.float64) @ Y) <= 1e-6
    np.testing.assert_allclose(got["mean"], X.mean(0), rtol=1e-5, atol=1e-6)
    # merge_carries: the tensor leaves sum in rank order, the ints add
    assert _rel(got["merged_g"], X.T.astype(np.float64) @ X) <= 1e-6
    assert int(got["merged_n"]) == N


def test_sharded_bcd_and_tsqr_match_the_jax_functions(worlds):
    """The rank-sharded BCD, one-pass solve, normal equations and TSQR of
    2 ranks against the JAX functions on one process, <= 1e-5."""
    import jax.numpy as jnp

    from keystone_tpu.ops import linalg as jl

    X, Y = worlds["X"], worlds["Y"]
    got = worlds["linalg"]
    Xc = X - X.mean(0)
    blocks = [jnp.asarray(Xc[:, :D // 2]), jnp.asarray(Xc[:, D // 2:])]
    want = np.concatenate([np.asarray(w) for w in jl.block_coordinate_descent(
        blocks, jnp.asarray(Y), 0.5, num_passes=3)])
    assert _rel(got["bcd"], want) <= 1e-5
    want1 = np.concatenate([np.asarray(w) for w in jl.solve_one_pass_l2(
        blocks, jnp.asarray(Y), 0.5)])
    assert _rel(got["one"], want1) <= 1e-5
    assert _rel(got["ne"], np.asarray(jl.normal_equations(
        jnp.asarray(X), jnp.asarray(Y), 0.5))) <= 1e-5
    assert _rel(got["tsqr"], np.asarray(jl.tsqr_r(jnp.asarray(X)))) <= 1e-5


def test_class_split_bcd_on_a_2x2_mesh_matches_the_whole(worlds):
    """Labels split over the ``model`` axis of a (2, 2) mesh of 4 ranks:
    each model group solves its classes, and the gathered weights match
    the JAX BCD of the whole problem."""
    import jax.numpy as jnp

    from keystone_tpu.ops import linalg as jl

    X, Y = worlds["X"], worlds["Y"]
    blocks = [jnp.asarray(X[:, :D // 2]), jnp.asarray(X[:, D // 2:])]
    want = np.concatenate([np.asarray(w) for w in jl.block_coordinate_descent(
        blocks, jnp.asarray(Y), 0.5, num_passes=3)])
    assert worlds["classes"]["bcd"].shape == (D, K)
    assert _rel(worlds["classes"]["bcd"], want) <= 1e-5


@pytest.mark.parametrize("solver", ["cholesky", "woodbury", "per_class"])
def test_weighted_solvers_over_rank_sharded_rows(worlds, solver):
    """The weighted solvers over 2 ranks' blocks of the rows (classes
    spread unevenly over the ranks) against the same solver on the whole
    in one process, <= 1e-5 of the largest weight."""
    from keystone_tpu_torch.nodes.learning.block_weighted import (
        BlockWeightedLeastSquaresEstimator,
    )
    from keystone_tpu_torch.nodes.learning.per_class_weighted import (
        PerClassWeightedLeastSquaresEstimator,
    )

    blob = worlds["weighted_in"]
    if solver == "per_class":
        est = PerClassWeightedLeastSquaresEstimator(4, 2, 0.5, 0.3)
    else:
        est = BlockWeightedLeastSquaresEstimator(4, 2, 0.5, 0.3,
                                                 solver=solver)
    want = est.fit_arrays(blob["X"], blob["L"], device="cpu").weights
    assert _rel(worlds["weighted"][solver], want.numpy()) <= 1e-5


@pytest.mark.parametrize("size", SIZES)
def test_sharded_apply_at_ragged_sizes_matches_the_jax_one(worlds, size):
    """``sharded_apply`` over 2 ranks (weights row-sharded at rest,
    gathered for the GEMM) against the JAX ``sharded_apply`` on its CPU
    mesh, at batch sizes that do not divide the ranks."""
    from keystone_tpu.nodes.learning.linear import (
        BlockLinearMapper as JBlock,
        LinearMapper as JLin,
    )
    from keystone_tpu.nodes.stats import StandardScalerModel as JScaler
    from keystone_tpu.parallel.spmd_apply import sharded_apply as jsa

    blob = worlds["apply_in"]
    W, b, mean = blob["W"], blob["b"], blob["mean"]
    x = blob["X"][:size]
    got = worlds["apply"]
    want_lin = np.asarray(jsa(JLin(W, intercept=b,
                                   feature_scaler=JScaler(mean)), x))
    want_block = np.asarray(jsa(JBlock([W[:5], W[5:9], W[9:]], 5,
                                       intercept=b, feature_means=mean), x))
    assert got[f"lin_{size}"].shape == (size, K)
    assert _rel(got[f"lin_{size}"], want_lin) <= 1e-5
    assert _rel(got[f"block_{size}"], want_block) <= 1e-5
    np.testing.assert_array_equal(got[f"lin_{size}"].argmax(1),
                                  want_lin.argmax(1))
    # the quantized mapper shards the batch only: its fused apply on each
    # rank's rows, against the JAX quantized apply
    want_q = np.asarray(jsa(JLin(W, intercept=b, weight_dtype="int8"), x))
    assert _rel(got[f"int8_{size}"], want_q) <= 1e-5
    scaled = (x - mean) / blob["std"]
    np.testing.assert_allclose(got[f"chain_{size}"], scaled, rtol=1e-6,
                               atol=1e-6)


# -- the mesh and the world, in process ---------------------------------------

def test_without_a_world_everything_is_one_rank():
    assert (process_index(), process_count(), is_distributed()) == (0, 1,
                                                                   False)
    m = tmesh.get_mesh()
    assert m.shape == {"data": 1, "model": 1} and m.is_local()
    assert tmesh.num_data_shards() == 1 and tmesh.replication_factor() == 1
    t = torch.arange(6.0)
    from keystone_tpu_torch.parallel.distributed import world_gather, \
        world_sum

    assert world_gather(t)[0] is t and world_sum(t) is t
    coord = WorldCoordinator("solo")
    state = coord.step(3, True)
    assert state.cursors == (3,) and state.all_done
    assert coord.merge_carries((t, 4))[1] == 4


def test_mesh_layout_groups_and_row_bounds():
    m = tmesh.Mesh([[0, 1], [2, 3]])
    assert m.shape == {"data": 2, "model": 2} and m.size == 4
    assert m.coords(3) == (1, 1) and m.group("data", 1) == (1, 3)
    assert m.group("model", 2) == (2, 3)
    assert m == tmesh.make_mesh(range(4), model=2) and hash(m) == hash(
        tmesh.make_mesh(range(4), model=2))
    with pytest.raises(ValueError, match="twice"):
        tmesh.Mesh([[0, 0]])
    with pytest.raises(ValueError, match="2x2 != 3"):
        tmesh.make_mesh(range(3), data=2, model=2)
    assert list(tmesh.shard_bounds(10, 3)) == [0, 3, 6, 10]
    assert tmesh.batch_rows(10, m, rank=2) == (5, 10)
    with tmesh.mesh_scope(m):
        assert tmesh.get_mesh() is m and tmesh.num_data_shards() == 2
    assert tmesh.get_mesh().size == 1


def test_row_placements_and_host_fetch_without_a_world():
    from keystone_tpu_torch.parallel.dataset import argmax_labels, \
        fetch_to_host

    m = tmesh.Mesh([[0], [1]])
    X = np.arange(10, dtype=np.float32).reshape(5, 2)
    assert tmesh.batch_sharding(m)(5) == (0, 2)    # rank 0's block
    assert tmesh.replicated_sharding(m)(5) == (0, 5)
    np.testing.assert_array_equal(
        tmesh.shard_put(X, tmesh.batch_sharding(m), device="cpu").numpy(),
        X[:2])
    np.testing.assert_array_equal(
        fetch_to_host(torch.from_numpy(X), m), X)  # one process: as is
    L = torch.tensor([[-1.0, 1.0], [1.0, -1.0]])
    assert argmax_labels(L).tolist() == [1, 0]


def test_a_tcp_coordinator_world(tmp_path):
    """The command line's ``HOST:PORT`` coordinator: a 2-rank world over
    TCP on this machine."""
    from keystone_tpu_torch.parallel.distributed import (
        free_coordinator_port,
    )

    X, Y = _xy()
    npz = str(tmp_path / "d.npz")
    np.savez(npz, X=X, Y=Y[:, :3])
    port = free_coordinator_port()
    world = DryrunWorld(2, workdir=str(tmp_path), grace_s=20)
    argv = [sys.executable, "-m", "keystone_tpu_torch.parallel.dryrun_worker",
            "--data", npz, "--chunk-size", "16", "--device", "cpu"]
    world.launch([], per_process_argv=lambda pid, n, _store: argv + [
        str(pid), str(n), str(port)])
    codes = world.wait(timeout_s=TIMEOUT_S)
    assert codes == [0, 0], [world.output(p)[-1500:] for p in range(2)]
    assert all("ELASTIC_OK" in world.output(p) for p in range(2))


def test_the_backend_rule():
    cpu, gpu = torch.device("cpu"), torch.device("cuda", 0)
    assert tmesh.pick_backend(cpu, 2, 0)[0] == "gloo"
    assert tmesh.pick_backend(gpu, 1, 1)[0] == "nccl"
    assert tmesh.pick_backend(gpu, 4, 4)[0] == "nccl"
    backend, rule = tmesh.pick_backend(gpu, 2, 1)
    assert backend == "gloo" and "share" in rule


def test_a_coordinator_address_needs_ids_and_a_shape(monkeypatch):
    with pytest.raises(ValueError, match="num_processes and process_id"):
        tmesh.initialize_distributed("localhost:1", device="cpu")
    with pytest.raises(ValueError, match="HOST:PORT"):
        tmesh.initialize_distributed("nohost", 2, 0, device="cpu")
    for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        tmesh.initialize_distributed(device="cpu")
    assert tmesh.world() is None


def test_a_stream_refuses_a_mesh_of_other_ranks():
    from keystone_tpu_torch.parallel.streaming import StreamingDataset

    X, _ = _xy()
    with pytest.raises(ValueError, match="local_mesh"):
        StreamingDataset.from_numpy(X, 16, device="cpu",
                                    mesh=tmesh.Mesh([[0], [1]]))
    s = StreamingDataset.from_numpy(X, 16, device="cpu")
    assert s.mesh.is_local() and s.map(lambda r: r).mesh == s.mesh


def test_shard_dataset_marks_the_block_and_batch_maps_keep_it(monkeypatch):
    from keystone_tpu_torch.parallel.dataset import ArrayDataset, \
        shard_dataset

    X, _ = _xy(n=10)
    ds = ArrayDataset.from_numpy(X, "cpu")
    assert shard_dataset(ds) is ds          # one rank: itself
    m = tmesh.Mesh([[0], [1], [2]])
    monkeypatch.setattr(tmesh, "process_index", lambda: 1)
    part = shard_dataset(ds, m)
    assert part.n == 3 and part.mesh is m
    np.testing.assert_array_equal(part.numpy(), X[3:6])
    assert part.map_batch(lambda x: x * 2).mesh is m
    assert part.to("cpu").mesh is m


# -- fault kinds ---------------------------------------------------------------

def test_host_death_aimed_at_another_rank_is_dormant():
    from keystone_tpu_torch.nodes.learning.linear import LinearMapEstimator
    from keystone_tpu_torch.parallel.streaming import (
        StreamingDataset,
        fit_streaming,
    )

    X, Y = _xy()
    plan = FaultPlan().add("ingest.produce", kind="host_death", count=1,
                           process_id=1)
    with plan:
        model = fit_streaming(LinearMapEstimator(lam=0.1),
                              StreamingDataset.from_numpy(X, 16,
                                                          device="cpu"), Y)
    assert plan.injections() == 0
    assert torch.isfinite(torch.as_tensor(model.weights)).all()


def test_partition_raises_a_connection_error_and_is_rank_gated():
    plan = FaultPlan().add("ingest.stage", kind="partition", count=1,
                           process_id=0)
    with plan:
        with pytest.raises(PartitionError):
            inject("ingest.stage", context="t")
    assert isinstance(PartitionError("x"), ConnectionError)
    assert HOST_DEATH_EXIT_CODE == 117
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan().add("x", kind="meteor")


def test_the_process_dimension_rides_every_event():
    from keystone_tpu_torch.observability.trace import PipelineTrace
    from keystone_tpu_torch.resilience.events import record_event

    set_process_dimension(3)
    try:
        with PipelineTrace("dim") as tr:
            record_event("retry", site="x")
        assert tr.resilience[-1]["process_id"] == 3
    finally:
        set_process_dimension(None)


# -- the world checkpoint format -----------------------------------------------

def _world_snapshot(ckdir, fps, cursors, carries):
    ckpt = StreamCheckpoint(str(ckdir))
    for pid, (fp, cur, carry) in enumerate(zip(fps, cursors, carries)):
        ckpt.save_host(fp, pid, cur, carry)
    ckpt.merge_hosts(len(fps))
    return ckpt


def test_world_snapshot_roundtrip_and_clear(tmp_path):
    carries = [(np.arange(4, dtype=np.float32), 2),
               (np.arange(4, 8, dtype=np.float32), 3)]
    ckpt = _world_snapshot(tmp_path, ["fpA", "fpB"], [3, 5], carries)
    h0 = ckpt.load_world("fpA", 0, 2)
    h1 = ckpt.load_world("fpB", 1, 2)
    assert (h0["cursor"], h1["cursor"]) == (3, 5)
    np.testing.assert_array_equal(h1["carry"][0], carries[1][0])
    with pytest.raises(CheckpointMismatchError, match="fingerprint"):
        ckpt.load_world("fpA", 1, 2)
    ckpt.clear()
    assert os.listdir(str(tmp_path)) == []


def test_a_resume_at_another_world_size_refuses_both_ways(tmp_path):
    carry = (np.ones(4, np.float32),)
    ckpt = _world_snapshot(tmp_path / "w", ["fp", "fp"], [1, 1],
                           [carry, carry])
    with pytest.raises(CheckpointMismatchError, match="2-process world"):
        ckpt.load_world("fp", 0, 4)
    with pytest.raises(CheckpointMismatchError, match="2-process world"):
        ckpt.load("fp")
    solo = StreamCheckpoint(str(tmp_path / "s"))
    solo.save("fp", 3, carry)
    with pytest.raises(CheckpointMismatchError, match="single-process"):
        solo.load_world("fp", 0, 2)


def test_the_fingerprint_folds_the_world_size(monkeypatch):
    from keystone_tpu_torch.nodes.learning.linear import LinearMapEstimator
    from keystone_tpu_torch.parallel.streaming import StreamingDataset
    from keystone_tpu_torch.resilience import fit_fingerprint

    X, Y = _xy()
    stream = StreamingDataset.from_numpy(X, 16, device="cpu", tag="fp")
    est = LinearMapEstimator(lam=0.1)
    one = fit_fingerprint(est, stream, Y)
    monkeypatch.setattr(tmesh, "process_count", lambda: 2)
    assert fit_fingerprint(est, stream, Y) != one


def test_the_world_snapshot_format_matches_the_jax_one(tmp_path):
    """The same keys, world topology and per-host slices as the JAX
    package's world snapshot."""
    from keystone_tpu.resilience import StreamCheckpoint as J

    carry = (np.ones(3, np.float32),)
    port = _world_snapshot(tmp_path / "p", ["a", "b"], [1, 2],
                           [carry, carry])
    jax_ck = J(str(tmp_path / "j"))
    for pid, cur in enumerate((1, 2)):
        jax_ck.save_host("ab"[pid], pid, cur, carry)
    jax_ck.merge_hosts(2)
    import pickle

    with open(port.path, "rb") as f:
        pb = pickle.load(f)
    with open(jax_ck.path, "rb") as f:
        jb = pickle.load(f)
    assert set(pb) == set(jb) and pb["topology"] == jb["topology"]
    assert [set(h) for h in pb["hosts"]] == [set(h) for h in jb["hosts"]]
    assert [h["cursor"] for h in pb["hosts"]] == [1, 2]


# -- save_state / load_state ---------------------------------------------------

def test_save_state_and_load_state_skip_the_refit(tmp_path):
    """The prefix table's fitted transformers round-trip, and a pipeline
    of the same prefixes is served from them (the JAX package's
    save_state / load_state)."""
    from keystone_tpu_torch.nodes.stats import StandardScaler
    from keystone_tpu_torch.parallel.dataset import ArrayDataset
    from keystone_tpu_torch.utils import load_state, save_state
    from keystone_tpu_torch.utils.checkpoint import (
        CheckpointCorruptError,
        save_pipeline,
    )
    from keystone_tpu_torch.workflow.env import PipelineEnv

    X, _ = _xy()
    ds = ArrayDataset.from_numpy(X, "cpu", tag="state-ds")
    PipelineEnv.reset()
    first = StandardScaler().with_data(ds).fit()
    path = str(tmp_path / "state.ckpt")
    saved = save_state(path)
    assert saved >= 1
    PipelineEnv.reset()
    assert load_state(path) == saved
    calls = []
    orig = StandardScaler._fit

    def spy(self, d):
        calls.append(1)
        return orig(self, d)

    StandardScaler._fit = spy
    try:
        again = StandardScaler().with_data(ds).fit()
    finally:
        StandardScaler._fit = orig
    assert calls == []
    np.testing.assert_array_equal(again.apply(ds).get().numpy(),
                                  first.apply(ds).get().numpy())
    save_pipeline(first, str(tmp_path / "p.ckpt"))
    with pytest.raises(CheckpointCorruptError, match="not a 'state'"):
        load_state(str(tmp_path / "p.ckpt"))
    PipelineEnv.reset()


def test_sharded_residency_charges_one_ranks_share():
    from keystone_tpu_torch.serving.residency import ModelCharge

    whole = ModelCharge(model_nbytes=800.0, item_nbytes=10.0,
                        bucket_rows=16)
    share = ModelCharge(model_nbytes=800.0, item_nbytes=10.0,
                        bucket_rows=16, data_shards=4,
                        shardable_nbytes=600.0, gather_nbytes=300.0)
    assert whole.total_nbytes() == 800.0 + 160.0
    assert share.total_nbytes() == 200.0 + 150.0 + 300.0 + 40.0





def test_a_sharded_plane_admits_what_a_replicated_one_refuses():
    """``ServingPlane(data_shards=N)`` charges one rank's share under the
    sharded apply (a block mapper's weights divided at rest, one block's
    gather transient): a model whose replicated charge passes the budget
    is admitted by a plane of 4 shards and refused by a plane of 1."""
    from keystone_tpu_torch.nodes.learning.linear import (
        BlockLeastSquaresEstimator,
    )
    from keystone_tpu_torch.parallel.dataset import ArrayDataset
    from keystone_tpu_torch.serving import ItemSpec, ServingPlane
    from keystone_tpu_torch.serving.residency import AdmissionError

    r = np.random.RandomState(0)
    d, k = 512, 64
    fitted = BlockLeastSquaresEstimator(64, 1, 1e-3).with_data(
        ArrayDataset.from_numpy(r.rand(96, d).astype(np.float32), "cpu"),
        ArrayDataset.from_numpy(r.rand(96, k).astype(np.float32),
                                "cpu")).fit()
    sample = ItemSpec((d,), np.float32)
    with ServingPlane(max_batch=8, device="cpu") as probe:
        whole = probe.admit("m", fitted, sample).charge
    with ServingPlane(max_batch=8, device="cpu", data_shards=4) as probe:
        share = probe.admit("m", fitted, sample).charge
    assert share.data_shards == 4 and share.shardable_nbytes > 0
    assert share.total_nbytes() < whole.total_nbytes()
    budget = (share.total_nbytes() + whole.total_nbytes()) / 2
    with ServingPlane(hbm_budget=budget, max_batch=8, device="cpu") as p1:
        with pytest.raises(AdmissionError):
            p1.admit("m", fitted, sample)
    with ServingPlane(hbm_budget=budget, max_batch=8, device="cpu",
                      data_shards=4) as p4:
        p4.admit("m", fitted, sample)
        out = p4.predict("m", r.rand(3, d).astype(np.float32))
    assert np.asarray(out).shape == (3, k)
