"""The port's profilers, scaling bench, NLP trainers and bench gate against
the repository's tools, on the CPU at small sizes.

- ``profile_imagenet``: prefix 4 (the descriptors) against the JAX tool's
  ``prefix_fn(4)`` on the same seeded 160 x 160 images (both tools'
  ``H``, ``W`` set by monkeypatch), within the golden envelope of
  quantized descriptors (max <= 2.0 levels, mean <= 0.15: the band
  products of two packages sum in other orders); prefix 6 against the
  port's production ``SIFTExtractor`` -> PCA -> FV chain (<= 1e-4); the
  tool end to end at ``--small``.
- ``profile_solver``: its assembled SYRK tilings, Cholesky factor,
  ``cholesky_solve`` and cross product with the residual against float64
  NumPy at (512, 128, 10), <= 1e-4 of the largest entry (the JAX tool runs
  at import, so NumPy is the reference).
- ``elastic_bench`` at 512 x 16, chunks of 64, on the CPU: the five metric
  lines, finite.
- ``train_pos`` / ``train_ner`` with ``--no-save``: held-out accuracy and
  F1 equal to the JAX trainers' on the same corpora (exact: the same
  integer counts), the same tags on the held-out sentences, no file
  written.
- ``bench_compare``: the JAX command's exit codes.
- ``tools.timeit`` / ``device_tensors``.
"""
import hashlib
import importlib
import json
import math
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu_torch.tools import (
    device_tensors,
    elastic_bench,
    profile_imagenet,
    profile_solver,
    timeit,
    train_ner,
    train_pos,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENVELOPE_MAX, ENVELOPE_MEAN = 2.0, 0.15
PREFIX6_TOL = 1e-4
SOLVER_RTOL = 1e-4
METRICS = ("elastic_streamed_images_per_sec_1p",
           "elastic_streamed_images_per_sec_2p",
           "elastic_scaling_efficiency", "coord_overhead_share",
           "coord_overlap_occupancy")


def _jax_tool(name):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    return importlib.import_module(f"tools.{name}")


def _images(n=2, h=160, w=160, seed=0):
    return np.random.RandomState(seed).rand(n, h, w).astype(np.float32)


# -- profile_imagenet ---------------------------------------------------------

def test_prefix4_matches_the_jax_tool(monkeypatch):
    jt = _jax_tool("profile_imagenet")
    monkeypatch.setattr(jt, "H", 160)
    monkeypatch.setattr(jt, "W", 160)
    monkeypatch.setattr(profile_imagenet, "H", 160)
    monkeypatch.setattr(profile_imagenet, "W", 160)
    jone = jt.prefix_fn(4)
    tone = profile_imagenet.prefix_fn(4)
    for img in _images():
        want = np.asarray(jone(jnp.asarray(img)))
        got = tone(torch.as_tensor(img)).numpy()
        assert got.shape == want.shape and want.shape[0] == 128
        diff = np.abs(got - want)
        assert diff.max() <= ENVELOPE_MAX, diff.max()
        assert diff.mean() <= ENVELOPE_MEAN, diff.mean()


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_short_prefixes_match_the_jax_tool(monkeypatch, depth):
    """The scalar prefixes (sums of the smoothed image, the orientation
    maps, the bins) within 1e-4 relative of the JAX tool's."""
    jt = _jax_tool("profile_imagenet")
    for mod in (jt, profile_imagenet):
        monkeypatch.setattr(mod, "H", 96)
        monkeypatch.setattr(mod, "W", 128)
    img = _images(1, 96, 128)[0]
    want = float(jt.prefix_fn(depth)(jnp.asarray(img)))
    got = float(profile_imagenet.prefix_fn(depth)(torch.as_tensor(img)))
    assert got == pytest.approx(want, rel=1e-4)


def test_prefix6_matches_the_production_chain():
    _, imgs, pca, gmm = profile_imagenet._inputs(2, (160, 160),
                                                 torch.device("cpu"))
    one = profile_imagenet.prefix_fn(6, pca, gmm, (160, 160))
    for img in imgs:
        a = one(img)
        b = profile_imagenet._production(img, pca, gmm)
        assert a.shape == b.shape == (2 * profile_imagenet.DESC_DIM
                                      * profile_imagenet.VOCAB,)
        assert float((a - b).abs().max()) <= PREFIX6_TOL


def test_profile_imagenet_runs_on_the_cpu():
    out = profile_imagenet.run(2, (96, 128), torch.device("cpu"),
                               batch64=False)
    assert [s["stage"] for s in out["stages"]] == list(
        profile_imagenet.STAGES)
    assert all(s["wall_ms"] > 0 and s["device_ms"] is None
               for s in out["stages"])
    assert out["launches"] == {}          # the plain versions on the CPU
    gates = out["gates"]
    assert gates["prefix6"] <= PREFIX6_TOL and gates["fv_max"] <= 1e-3
    assert gates["quant_bf16"]["agree"] >= 0.999
    assert gates["quant_int8"]["agree"] >= 0.98


# -- profile_solver -----------------------------------------------------------

@pytest.fixture(scope="module")
def solver_inputs():
    rng = np.random.RandomState(0)
    A = rng.randn(512, 128).astype(np.float32)
    Y = rng.randn(512, 10).astype(np.float32)
    W = rng.randn(128, 10).astype(np.float32) * 0.1
    R = rng.randn(128, 10).astype(np.float32)
    return A, Y, W, R


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got.astype(np.float64) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("tile", [32, 48, 64, 128, 512])
def test_syrk_tilings_match_float64(solver_inputs, tile):
    A, _, _, _ = solver_inputs
    want = A.astype(np.float64).T @ A.astype(np.float64)
    got = profile_solver.syrk(torch.as_tensor(A), tile)
    assert got.shape == want.shape
    assert _rel(got, want) <= SOLVER_RTOL
    assert profile_solver.syrk_fraction(128, tile) == pytest.approx(
        (lambda T: T * (T + 1) / 2 / T ** 2)(math.ceil(128 / tile)))


def test_cholesky_and_solve_match_float64(solver_inputs):
    A, Y, W, R = solver_inputs
    A64 = A.astype(np.float64)
    G64 = A64.T @ A64 + profile_solver.RIDGE * np.eye(128)
    G = profile_solver.gram_full(torch.as_tensor(A))
    L = profile_solver.chol(G)
    assert _rel(L, np.linalg.cholesky(G64)) <= SOLVER_RTOL
    X = profile_solver.cho_solve(L, torch.as_tensor(R))
    assert _rel(X, np.linalg.solve(G64, R.astype(np.float64))) \
        <= SOLVER_RTOL
    got = profile_solver.cross_resid(torch.as_tensor(A), torch.as_tensor(W),
                                     torch.as_tensor(Y))
    want = A64.T @ (Y.astype(np.float64) - A64 @ W.astype(np.float64))
    assert _rel(got, want) <= SOLVER_RTOL


def test_profile_solver_runs_on_the_cpu(capsys):
    out = profile_solver.profile(512, 128, 10, "cpu")
    assert set(out) == {"gram full", "gram syrk tile=512",
                        "gram syrk tile=1024", "cholesky factor",
                        "cholesky_solve k=10", "cross+residual"}
    assert out["gram syrk tile=512"]["fraction"] == 1.0   # one tile
    assert all(v["ms"] > 0 for v in out.values())
    assert "TFLOP/s" in capsys.readouterr().out


@pytest.mark.parametrize("tool", [profile_solver, profile_imagenet,
                                  elastic_bench])
def test_the_tools_refuse_cuda_without_a_card(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])


# -- elastic_bench ------------------------------------------------------------

def test_elastic_bench_prints_the_five_metrics(capsys):
    assert elastic_bench.main(["--rows", "512", "--dim", "16",
                               "--chunk-size", "64", "--device", "cpu"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    values = {line["metric"]: line["value"] for line in lines}
    assert set(values) == set(METRICS)
    assert all(math.isfinite(v) for v in values.values())
    assert values["elastic_streamed_images_per_sec_1p"] > 0
    assert values["coord_overhead_share"] == pytest.approx(
        1.0 - values["coord_overlap_occupancy"])


# -- the NLP trainers ---------------------------------------------------------

def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_train_pos_matches_the_jax_trainer(capsys):
    from keystone_tpu_torch.nodes.nlp.perceptron_pos import _DATA_PATH

    jt = _jax_tool("train_pos")
    before = _digest(_DATA_PATH)
    assert train_pos.main(["--no-save"]) == 0
    text = capsys.readouterr().out
    held = float(re.search(r"held-out accuracy: ([0-9.]+)", text).group(1))
    train = jt.read_tagged_file(os.path.join(REPO, jt.TRAIN))
    heldout = jt.read_tagged_file(os.path.join(REPO, jt.EVAL))
    jmodel = jt.AveragedPerceptronPosModel.train(train, epochs=8)
    want = jt.accuracy(jmodel, heldout)
    assert held == pytest.approx(want, abs=5e-5)   # printed to 4 places
    model = train_pos.train(train)
    assert train_pos.accuracy(model, heldout) == want
    for sent in heldout:
        words = [w for w, _ in sent]
        assert model.best_sequence(words).tags == \
            jmodel.best_sequence(words).tags
    assert _digest(_DATA_PATH) == before


def test_train_ner_matches_the_jax_trainer(capsys):
    from keystone_tpu_torch.nodes.nlp.corenlp import RuleBasedNerModel
    from keystone_tpu_torch.nodes.nlp.perceptron_ner import (
        _DATA_PATH,
        read_labeled_file,
    )

    jt = _jax_tool("train_ner")
    before = _digest(_DATA_PATH)
    assert train_ner.main(["--no-save"]) == 0
    capsys.readouterr()
    train = read_labeled_file(str(train_ner.TRAIN))
    heldout = read_labeled_file(str(train_ner.EVAL))
    jbest = None
    for epochs in train_ner.EPOCH_CHOICES:
        jmodel = jt.AveragedPerceptronNerModel.train(train, epochs=epochs)
        f1 = jt.token_f1(jmodel, heldout)
        if jbest is None or f1[0] > jbest[0][0]:
            jbest = (f1, epochs, jmodel)
    hf1, epochs, model = train_ner.train_best(train, heldout)
    assert (hf1, epochs) == (jbest[0][0], jbest[1])
    assert train_ner.token_f1(model, heldout) == jbest[0]
    assert train_ner.token_f1(RuleBasedNerModel(), heldout) == \
        jt.token_f1(jt.RuleBasedNerModel(), heldout)
    for sent in heldout:
        words = [w for w, _ in sent]
        assert model.best_sequence(words).labels == \
            jbest[2].best_sequence(words).labels
    assert _digest(_DATA_PATH) == before


# -- bench_compare ------------------------------------------------------------

@pytest.mark.parametrize("pair,code", [
    (("BENCH_r01.json", "BENCH_r02.json"), 0),
    (("BENCH_r02.json", "BENCH_r01.json"), 2),
    (("BENCH_r06.json", "BENCH_r09.json"), 1)])
def test_bench_compare_exit_codes_match_the_jax_command(pair, code):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    port = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch.tools.bench_compare",
         *pair], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    ref = subprocess.run(
        [sys.executable, os.path.join("tools", "bench_compare.py"), *pair],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert port.returncode == ref.returncode == code, (port.stderr,
                                                       ref.stderr)
    assert port.stdout == ref.stdout


# -- timeit / device_tensors --------------------------------------------------

def test_device_tensors_walks_a_fitted_model():
    from keystone_tpu_torch.nodes.learning.linear import LinearMapEstimator
    from keystone_tpu_torch.parallel.dataset import ArrayDataset

    rng = np.random.RandomState(0)
    X = ArrayDataset.from_numpy(rng.randn(64, 8).astype(np.float32), "cpu")
    Y = ArrayDataset.from_numpy(rng.randn(64, 3).astype(np.float32), "cpu")
    model = LinearMapEstimator(lam=0.1).fit(X, Y)
    found = device_tensors({"m": [model, (model,)]})
    assert any(t is model.weights for t in found)
    assert len({id(t) for t in found}) == len(found)
    assert device_tensors(7) == [] and device_tensors(X.data) == [X.data]


def test_timeit_is_seconds_per_call():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    dt = timeit(fn, torch.ones(4), iters=3)
    assert dt > 0 and len(calls) == 4      # one warm call, three timed
