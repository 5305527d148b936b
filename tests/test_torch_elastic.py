"""The port's elastic world on the CPU: gloo worlds of 2 ranks launched
through the port's ``DryrunWorld`` run the shard-local streamed fit
through the world loop of ``fit_streaming``, are killed mid-fit, and
resume from the shared ``StreamCheckpoint``.

Held against the JAX package, at ``tests/test_elastic.py``'s shapes
(N=192, D=12, K=3, chunk 16): the port's 2-rank streamed ``LinearMap``
fit lies within 1e-5 of the largest weight of the JAX package's
single-process fit of the same seeded data, with identical argmax, and
likewise of one JAX ``DryrunWorld`` of 2 processes. A killed and resumed
port world is ``torch.equal`` to the uninterrupted one. The worlds are
launched once per module (``elastic_runs``); every member is reaped
under a timeout. The straggler, partition-relaunch and divergent-
collective worlds are marked slow, as their JAX counterparts are.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from keystone_tpu_torch.parallel.distributed import DryrunWorld
from keystone_tpu_torch.resilience import HOST_DEATH_EXIT_CODE

N, D, K, CHUNK = 192, 12, 3, 16
TIMEOUT_S = 300
WORKER = os.path.join(os.path.dirname(__file__), "torch_world_worker.py")


def _xy(n=N, d=D, k=K, seed=0):
    rng = np.random.RandomState(seed)
    X = (rng.randn(n, d) * (1.0 + rng.rand(d))).astype(np.float32)
    Y = (X @ rng.randn(d, k) + 0.1 * rng.randn(n, k)).astype(np.float32)
    return X, Y


def _worker_argv(npz, extra=()):
    return [sys.executable, "-m", "keystone_tpu_torch.parallel.dryrun_worker",
            "--data", npz, "--chunk-size", str(CHUNK), "--device", "cpu",
            *extra]


def _ok_fields(world, pid):
    lines = [line for line in world.output(pid).splitlines()
             if line.startswith("ELASTIC_OK")]
    assert lines, (f"rank {pid} printed no ELASTIC_OK line:\n"
                   f"{world.output(pid)[-2000:]}")
    return dict(kv.split("=", 1) for kv in lines[0].split()[1:])


def _write_cifar(path, n, seed):
    """``n`` seeded images in the CIFAR binary layout the loader reads."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.uint8)
    pix = rng.randint(0, 256, size=(n, 3 * 32 * 32)).astype(np.uint8)
    # a class-dependent brightness, so the fit has something to learn
    pix = np.clip(pix.astype(np.int32) // 2 + 12 * labels[:, None], 0,
                  255).astype(np.uint8)
    np.concatenate([labels[:, None], pix], axis=1).tofile(path)


APP_ARGS = ["--numFilters", "8", "--lambda", "10", "--device", "cpu"]


@pytest.fixture(scope="module")
def elastic_runs(tmp_path_factory):
    """The port's worlds: uninterrupted, killed at round 2, resumed, and
    the CIFAR app of 2 ranks; beside them one JAX world of 2 processes
    over the same data, all launched together."""
    from keystone_tpu.parallel.distributed import DryrunWorld as JaxWorld

    base = str(tmp_path_factory.mktemp("elastic"))
    X, Y = _xy()
    npz = os.path.join(base, "data.npz")
    np.savez(npz, X=X, Y=Y)
    out_a = os.path.join(base, "uninterrupted.npz")
    out_c = os.path.join(base, "resumed.npz")
    out_j = os.path.join(base, "jax.npz")
    ckdir = os.path.join(base, "ck")
    runs = {"X": X, "Y": Y, "ckdir": ckdir, "base": base}

    os.makedirs(os.path.join(base, "jax"))
    jax_world = JaxWorld(num_processes=2, devices_per_process=2,
                         workdir=os.path.join(base, "jax"), grace_s=20)
    jax_world.launch([sys.executable, "-m",
                      "keystone_tpu.parallel.dryrun_worker", "--data", npz,
                      "--chunk-size", str(CHUNK), "--out", out_j])
    train, test = (os.path.join(base, f"cifar_{s}.bin")
                   for s in ("train", "test"))
    _write_cifar(train, 96, 1)
    _write_cifar(test, 32, 2)
    runs["cifar"] = (train, test)
    app_in = os.path.join(base, "app.in.npz")
    np.savez(app_in, argv=json.dumps(["--trainLocation", train,
                                      "--testLocation", test, *APP_ARGS]))
    app_world = DryrunWorld(2, workdir=os.path.join(base, "app"),
                            grace_s=20)
    app_world.launch([sys.executable, WORKER, "app", app_in,
                      os.path.join(base, "app.out.npz")])

    world = DryrunWorld(2, workdir=os.path.join(base, "port"), grace_s=20)
    world.launch(_worker_argv(npz, ["--out", out_a, "--bench"]))
    runs["codes_a"] = world.wait(timeout_s=TIMEOUT_S)
    runs["fields_a"] = [_ok_fields(world, p) for p in range(2)]
    runs["bench_a"] = [line for line in world.output(0).splitlines()
                       if line.startswith("{")]
    world.launch(_worker_argv(npz, [
        "--checkpoint-dir", ckdir, "--checkpoint-every", "1",
        "--die-process", "1", "--die-at-round", "3"]))
    runs["codes_b"] = world.wait(timeout_s=TIMEOUT_S)
    runs["log_b"] = world.output(0)
    runs["snapshot_after_kill"] = sorted(os.listdir(ckdir))
    world.launch(_worker_argv(npz, [
        "--checkpoint-dir", ckdir, "--checkpoint-every", "1",
        "--out", out_c]))
    runs["codes_c"] = world.wait(timeout_s=TIMEOUT_S)
    runs["fields_c"] = [_ok_fields(world, p) for p in range(2)]
    runs["w_a"] = np.load(out_a)["weights"]
    runs["w_c"] = np.load(out_c)["weights"]

    codes = app_world.wait(timeout_s=TIMEOUT_S)
    assert codes == [0, 0], [app_world.output(p)[-2000:] for p in range(2)]
    runs["app"] = dict(np.load(os.path.join(base, "app.out.npz")))
    codes = jax_world.wait(timeout_s=TIMEOUT_S)
    assert codes == [0, 0], [jax_world.output(p)[-2000:] for p in range(2)]
    runs["w_jax_world"] = np.load(out_j)["weights"]
    return runs


def test_kill_one_rank_resume_is_torch_equal(elastic_runs):
    """Rank 1 dies entering round 3, when it has awaited round 1: rank
    0's await of round 1 (both sidecars reported) then completes and the
    world snapshot exists whatever the scheduling."""
    r = elastic_runs
    assert r["codes_a"] == [0, 0], r["codes_a"]
    # rank 1 died of the injected host_death; rank 0 failed in its
    # gather (an error, not a hang) or was reaped by the launcher
    assert r["codes_b"][1] == HOST_DEATH_EXIT_CODE, r["codes_b"]
    assert r["codes_b"][0] != 0
    assert "stream_fit.ckpt" in r["snapshot_after_kill"]
    assert {"stream_fit.host0.ckpt", "stream_fit.host1.ckpt"} <= set(
        r["snapshot_after_kill"])
    assert r["codes_c"] == [0, 0], r["codes_c"]
    for f in r["fields_c"]:
        assert f["resumed"] == "1", f
    assert torch.equal(torch.from_numpy(r["w_a"]), torch.from_numpy(r["w_c"]))
    assert not os.path.exists(os.path.join(r["ckdir"], "stream_fit.ckpt"))


def test_the_world_path_fence_is_clean_and_weights_replicate(elastic_runs):
    for fields in (elastic_runs["fields_a"], elastic_runs["fields_c"]):
        assert fields[0]["digest"] == fields[1]["digest"]
        for f in fields:
            assert f["unexpected_compiles"] == "0", f
            assert int(f["solves"]) >= 1


def test_two_rank_fit_matches_the_jax_single_process_fit(elastic_runs):
    from keystone_tpu.nodes.learning.linear import LinearMapEstimator
    from keystone_tpu.parallel.streaming import (
        StreamingDataset,
        fit_streaming,
    )

    X, Y = elastic_runs["X"], elastic_runs["Y"]
    m1 = fit_streaming(LinearMapEstimator(lam=0.1),
                       StreamingDataset.from_numpy(X, chunk_size=CHUNK,
                                                   tag="p1"), Y)
    w1 = np.asarray(m1.weights)
    w2 = elastic_runs["w_a"]
    rel = np.abs(w1 - w2).max() / max(np.abs(w1).max(), 1.0)
    assert rel <= 1e-5, rel
    np.testing.assert_array_equal(np.argmax(X @ w1, axis=1),
                                  np.argmax(X @ w2, axis=1))


def test_two_rank_fit_matches_a_jax_world_of_two(elastic_runs):
    X = elastic_runs["X"]
    wj, w2 = elastic_runs["w_jax_world"], elastic_runs["w_a"]
    rel = np.abs(wj - w2).max() / max(np.abs(wj).max(), 1.0)
    assert rel <= 1e-5, rel
    np.testing.assert_array_equal(np.argmax(X @ wj, axis=1),
                                  np.argmax(X @ w2, axis=1))


def test_the_bench_lines_report_rate_and_overlap(elastic_runs):
    lines = [json.loads(line) for line in elastic_runs["bench_a"]]
    rate = [x for x in lines
            if x["metric"] == "elastic_streamed_images_per_sec"]
    assert rate and rate[0]["value"] > 0 and rate[0]["processes"] == 2
    occ = [x for x in lines if x["metric"] == "coord_overlap_occupancy"]
    share = [x for x in lines if x["metric"] == "coord_overhead_share"]
    assert occ and share
    assert abs(occ[0]["value"] + share[0]["value"] - 1.0) < 1e-9


def test_the_cifar_app_in_a_world_matches_one_process(elastic_runs):
    """``cifar.random_patch``'s ``main`` in a 2-rank world (each rank
    fits its block of the rows; the scaler and the block solve sum over
    the ranks) against the same ``main`` in one process."""
    from keystone_tpu_torch.nodes.learning.linear import BlockLinearMapper
    from keystone_tpu_torch.pipelines.images.cifar import (
        random_patch_cifar as rpc,
    )
    from keystone_tpu_torch.workflow.env import PipelineEnv

    train, test = elastic_runs["cifar"]
    PipelineEnv.reset()
    pipeline, _, test_eval = rpc.main(["--trainLocation", train,
                                       "--testLocation", test, *APP_ARGS])
    PipelineEnv.reset()
    graph = pipeline.to_pipeline().graph
    w1 = np.asarray(next(
        graph.get_operator(n).weights for n in graph.nodes
        if isinstance(graph.get_operator(n), BlockLinearMapper)))
    got = elastic_runs["app"]
    assert got["weights"].shape == w1.shape
    rel = np.abs(got["weights"] - w1).max() / np.abs(w1).max()
    assert rel <= 1e-4, rel
    assert abs(float(got["test_error"]) - test_eval.total_error) <= 1.0 / 32


def test_the_app_command_line_starts_a_world(elastic_runs):
    """``python -m keystone_tpu_torch cifar.random_patch --coordinator
    ... --num-processes 2 --process-id i`` runs the app in a world (the
    launcher passes a store file; TCP ``HOST:PORT`` works the same)."""
    train, test = elastic_runs["cifar"]
    world = DryrunWorld(2, workdir=os.path.join(elastic_runs["base"], "cli"),
                        grace_s=20)
    world.launch_app("cifar.random_patch", ["--trainLocation", train,
                                            "--testLocation", test,
                                            *APP_ARGS])
    codes = world.wait(timeout_s=TIMEOUT_S)
    assert codes == [0, 0], [world.output(p)[-2000:] for p in range(2)]
    for p in range(2):
        out = world.output(p)
        assert f"rank {p} of 2" in out and "backend gloo" in out
        assert "Test error is:" in out


def test_shard_local_tar_ingest_two_ranks(tmp_path):
    """Each rank decodes only its rank-strided tar archive, the moment
    carries merge at finalize, and the scaler equals the resident
    computation over all images (the JAX package's shard-local test)."""
    import io
    import tarfile

    from PIL import Image

    tar_dir = str(tmp_path / "tars")
    os.makedirs(tar_dir)
    rng = np.random.RandomState(0)
    imgs = []
    for t in range(2):
        with tarfile.open(os.path.join(tar_dir, f"shard{t}.tar"), "w") as tf:
            for i in range(12):
                arr = (rng.rand(8, 8, 3) * 255).astype(np.uint8)
                imgs.append(arr)
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, format="PNG")
                info = tarfile.TarInfo(f"img{t}_{i:02d}.png")
                info.size = buf.getbuffer().nbytes
                buf.seek(0)
                tf.addfile(info, buf)
    out = str(tmp_path / "scaler.npz")
    world = DryrunWorld(2, workdir=str(tmp_path / "w"), grace_s=20)
    world.launch([sys.executable, "-m",
                  "keystone_tpu_torch.parallel.dryrun_worker",
                  "--tar-dir", tar_dir, "--chunk-size", "8", "--out", out,
                  "--device", "cpu"])
    codes = world.wait(timeout_s=TIMEOUT_S)
    assert codes == [0, 0], [world.output(p)[-1500:] for p in range(2)]
    fields = [_ok_fields(world, p) for p in range(2)]
    assert fields[0]["archives"] == "shard0.tar"
    assert fields[1]["archives"] == "shard1.tar"
    assert fields[0]["digest"] == fields[1]["digest"]
    flat = np.stack(imgs).reshape(len(imgs), -1).astype(np.float32)
    got = np.load(out)["weights"]
    mean, std = got[:flat.shape[1]], got[flat.shape[1]:]
    assert np.abs(mean - flat.mean(0)).max() <= 1e-4
    assert np.abs(std - flat.std(0, ddof=1)).max() <= 1e-3


def test_a_dead_peer_ends_the_survivor_in_an_error(elastic_runs):
    """The survivor of the killed world left its round with an error
    from the backend (the peer's connection closed), not a hang."""
    log = elastic_runs["log_b"]
    assert "Traceback" in log and ("Connection" in log or "timed out"
                                   in log.lower() or "closed" in log), \
        log[-2000:]


@pytest.mark.slow
def test_straggler_world_completes_with_parity(tmp_path):
    X, Y = _xy()
    npz = str(tmp_path / "data.npz")
    np.savez(npz, X=X, Y=Y)
    world = DryrunWorld(2, workdir=str(tmp_path), grace_s=25)
    world.launch(_worker_argv(npz, ["--straggle-process", "0"]))
    codes = world.wait(timeout_s=TIMEOUT_S)
    assert codes == [0, 0], [world.output(p)[-1500:] for p in range(2)]
    fields = [_ok_fields(world, p) for p in range(2)]
    assert fields[0]["digest"] == fields[1]["digest"]


@pytest.mark.slow
def test_partitioned_world_relaunches_and_resumes(tmp_path):
    X, Y = _xy()
    npz = str(tmp_path / "data.npz")
    np.savez(npz, X=X, Y=Y)
    ckdir = str(tmp_path / "ck")
    out_a, out_c = str(tmp_path / "a.npz"), str(tmp_path / "c.npz")
    world = DryrunWorld(2, workdir=str(tmp_path), grace_s=20)
    world.launch(_worker_argv(npz, ["--out", out_a]))
    assert world.wait(TIMEOUT_S) == [0, 0]
    world.launch(_worker_argv(npz, [
        "--checkpoint-dir", ckdir, "--checkpoint-every", "1",
        "--partition-process", "1", "--partition-at-round", "3"]))
    codes = world.wait(TIMEOUT_S)
    assert codes[1] not in (0, HOST_DEATH_EXIT_CODE), codes
    assert os.path.exists(os.path.join(ckdir, "stream_fit.ckpt"))
    world.launch(_worker_argv(npz, [
        "--checkpoint-dir", ckdir, "--checkpoint-every", "1",
        "--out", out_c]))
    assert world.wait(TIMEOUT_S) == [0, 0]
    assert all(_ok_fields(world, p)["resumed"] == "1" for p in range(2))
    assert torch.equal(torch.from_numpy(np.load(out_a)["weights"]),
                       torch.from_numpy(np.load(out_c)["weights"]))


@pytest.mark.slow
def test_divergent_collective_ends_in_an_error_and_is_reaped(tmp_path):
    """The hazard the ``collective-divergence`` pass flags statically
    (``tests/test_torch_spmd.py``), reproduced: rank 0 enters a barrier
    rank 1 never matches. Rank 1 finishes and exits 0; rank 0 makes no
    progress and ends in the collective's timeout error (the port's
    collectives never wait without limit), or the launcher reaps it."""
    worker = os.path.join(os.path.dirname(__file__),
                          "torch_spmd_divergent_worker.py")
    world = DryrunWorld(2, workdir=str(tmp_path), grace_s=30,
                        env={"KEYSTONE_TORCH_COORD_TIMEOUT_S": "5"})
    world.launch([sys.executable, worker])
    codes = world.wait(timeout_s=120)
    assert codes[1] == 0, world.output(1)[-1500:]
    assert "DIVERGE_DONE pid=1" in world.output(1)
    out0 = world.output(0)
    assert "DIVERGE_ENTER pid=0" in out0, out0[-1500:]
    assert "DIVERGE_DONE pid=0" not in out0
    assert codes[0] != 0, codes
