"""TIMIT: the port against ``keystone_tpu``.

``CosineRandomFeatures.create`` draws the JAX package's W and b bit for
bit; its outputs agree within 1e-5 times the largest cosine argument
|x W^T + b| (at least 1): the cosine is 1-Lipschitz, and the float32
argument of two libraries' products differs in proportion to its size,
which Cauchy weights make large. The loader reads the same CSV and label
files as the JAX loader, and ``make_surrogate_timit`` is
``bench.py::timit_bench``'s generator bit for bit. ``run`` at 3
branches of 64 features on 512 / 128 surrogate frames: predictions agree
on at least 0.99 of test frames, test errors within 0.01 and below
0.95 (chance is 146/147 over 147 classes, with 3.5 training frames a
class here), and the block weights within 1e-5 of the largest weight
(two float32 BCDs of five passes; 2.5e-6 read on the CPU).
"""
import numpy as np
import pytest
import torch

import bench
from keystone_tpu.loaders import timit as jloader
from keystone_tpu.loaders.csv_loader import LabeledData as JLabeledData
from keystone_tpu.nodes import stats as jstats
from keystone_tpu.parallel.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.pipelines.speech import timit as jtimit
from keystone_tpu.workflow.env import PipelineEnv as JEnv
from keystone_tpu_torch import convert
from keystone_tpu_torch.loaders import timit as tloader
from keystone_tpu_torch.loaders.csv_loader import LabeledData
from keystone_tpu_torch.loaders.surrogate import make_surrogate_timit
from keystone_tpu_torch.nodes import stats as tstats
from keystone_tpu_torch.parallel.dataset import ArrayDataset
from keystone_tpu_torch.pipelines.speech import timit as ttimit
from keystone_tpu_torch.workflow.env import PipelineEnv

COSINE_TOL = 1e-5
W_TOL = 1e-5


@pytest.mark.parametrize("w_dist,b_dist", [
    ("gaussian", "uniform"), ("cauchy", "uniform"), ("uniform", "gaussian")])
def test_cosine_random_features_match_jax(w_dist, b_dist):
    port = tstats.CosineRandomFeatures.create(440, 96, 0.05, w_dist, b_dist,
                                              seed=7)
    ref = jstats.CosineRandomFeatures.create(440, 96, 0.05, w_dist, b_dist,
                                             seed=7)
    np.testing.assert_array_equal(port.W, ref.W)
    np.testing.assert_array_equal(port.b, ref.b)
    x = np.random.RandomState(0).randn(9, 440).astype(np.float32)
    want = np.stack([np.asarray(ref.apply(r)) for r in x])
    got = port.apply_batch(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (9, 96)
    arg = np.abs(x.astype(np.float64) @ ref.W.T.astype(np.float64)
                 + ref.b).max()
    bar = COSINE_TOL * max(1.0, arg)
    assert np.abs(got - want).max() <= bar
    one = port.apply(torch.as_tensor(x[3])).numpy()
    assert np.abs(one - want[3]).max() <= bar


def test_cosine_random_features_refuse_an_unknown_distribution():
    with pytest.raises(ValueError):
        tstats.CosineRandomFeatures.create(4, 4, 1.0, w_dist="laplace")
    with pytest.raises(ValueError):
        tstats.CosineRandomFeatures.create(4, 4, 1.0, b_dist="laplace")


def _write_split(tmp_path, name, X, y, shuffle_seed):
    feats = tmp_path / f"{name}.csv"
    np.savetxt(feats, X, delimiter=",", fmt="%.6f")
    order = np.random.RandomState(shuffle_seed).permutation(len(y))
    labels = tmp_path / f"{name}.labels"
    # 1-based rows and labels, in any row order, blank lines ignored
    labels.write_text("".join(f"{i + 1} {y[i] + 1}\n\n" for i in order))
    return str(feats), str(labels)


def test_loader_reads_what_the_jax_loader_reads(tmp_path):
    (X, y), (vx, vy) = make_surrogate_timit(12, 5)
    paths = (_write_split(tmp_path, "train", X, y, 0)
             + _write_split(tmp_path, "test", vx, vy, 1))
    port = tloader.timit_features_loader(*paths, device="cpu")
    ref = jloader.timit_features_loader(*paths)
    for p, r in ((port.train, ref.train), (port.test, ref.test)):
        np.testing.assert_array_equal(p.data.numpy(),
                                      np.asarray(r.data.numpy()))
        np.testing.assert_array_equal(p.labels.numpy(),
                                      np.asarray(r.labels.numpy()))
    np.testing.assert_array_equal(port.train.labels.numpy(), y)
    assert port.train.data.numpy().shape == (12, tloader.TIMIT_DIMENSION)
    assert (tloader.TIMIT_DIMENSION, tloader.NUM_CLASSES) == (
        jloader.TIMIT_DIMENSION, jloader.NUM_CLASSES)


def test_loader_refuses_a_missing_label(tmp_path):
    (X, y), _ = make_surrogate_timit(4, 1)
    feats, labels = _write_split(tmp_path, "train", X, y, 0)
    with open(labels, "w") as f:
        f.write("1 3\n2 4\n")
    with pytest.raises(ValueError, match="missing rows"):
        tloader._parse_sparse_labels(labels, 4)


def test_surrogate_timit_is_bench_generator(monkeypatch):
    """``make_surrogate_timit`` against the data ``bench.py::timit_bench``
    hands to the app (captured at the bench's small size)."""
    seen = {}

    class Captured(Exception):
        pass

    def capture(config, data):
        seen["data"] = data
        raise Captured

    monkeypatch.setattr(bench, "SMALL", True)
    monkeypatch.setattr(jtimit, "run", capture)
    with pytest.raises(Captured):
        bench.timit_bench()
    data = seen["data"]
    (tx, ty), (vx, vy) = make_surrogate_timit(data.train.data.n,
                                              data.test.data.n)
    np.testing.assert_array_equal(tx, data.train.data.numpy())
    np.testing.assert_array_equal(ty, data.train.labels.numpy())
    np.testing.assert_array_equal(vx, data.test.data.numpy())
    np.testing.assert_array_equal(vy, data.test.labels.numpy())


def _mapper(graph):
    return next(graph.get_operator(n) for n in graph.nodes
                if type(graph.get_operator(n)).__name__
                == "BlockLinearMapper")


@pytest.fixture(scope="module")
def runs():
    (tx, ty), (vx, vy) = make_surrogate_timit(512, 128)
    kw = dict(num_cosines=3, num_cosine_features=64, gamma=1.0 / 880,
              lam=1e-2, num_epochs=5, seed=123)
    JEnv.get_or_create().clear_state()
    jdata = jloader.TimitFeaturesData(
        JLabeledData(JArrayDataset.from_numpy(tx), JArrayDataset.from_numpy(ty)),
        JLabeledData(JArrayDataset.from_numpy(vx), JArrayDataset.from_numpy(vy)))
    jpred, jeval = jtimit.run(jtimit.TimitConfig(**kw), data=jdata)
    jfit = jpred.fit()
    jout = np.asarray(jfit.apply(JArrayDataset.from_numpy(vx)).get().numpy())
    PipelineEnv.reset()
    tdata = tloader.TimitFeaturesData(
        LabeledData(ArrayDataset.from_numpy(tx, "cpu"),
                    ArrayDataset.from_numpy(ty, "cpu")),
        LabeledData(ArrayDataset.from_numpy(vx, "cpu"),
                    ArrayDataset.from_numpy(vy, "cpu")))
    tfit, teval = ttimit.run(ttimit.TimitConfig(**kw), data=tdata,
                             device="cpu")
    tout = tfit.apply(ArrayDataset.from_numpy(vx, "cpu")).get().numpy()
    return dict(kw=kw, vx=vx, jfit=jfit, jeval=jeval, jout=jout, tfit=tfit,
                teval=teval, tout=tout)


def test_timit_run_matches_jax(runs):
    assert np.mean(runs["tout"] == runs["jout"]) >= 0.99
    assert abs(runs["teval"].total_error - runs["jeval"].total_error) <= 0.01
    assert runs["teval"].total_error < 0.95
    jW = np.asarray(_mapper(runs["jfit"]._graph).weights)
    tW = np.asarray(_mapper(runs["tfit"]._graph).weights)
    assert tW.shape == jW.shape == (192, tloader.NUM_CLASSES)
    assert np.abs(tW - jW).max() <= W_TOL * np.abs(jW).max()
    # the datum path through the fitted pipeline
    one = runs["tfit"].apply_datum(torch.as_tensor(runs["vx"][0])).get()
    assert int(one) == runs["tout"][0]


def test_fitted_timit_carried_across_predicts_as_jax(runs):
    """The JAX fit's branches and model, carried across: the same
    predictions as the JAX package's on every test frame."""
    jgraph = runs["jfit"]._graph
    fused = next(jgraph.get_operator(n) for n in jgraph.nodes
                 if type(jgraph.get_operator(n)).__name__
                 == "FusedTransformer")
    branches = fused.stages[0].branches
    assert len(branches) == 3
    fitted = convert.timit_pipeline(
        [(np.asarray(b.W), np.asarray(b.b)) for b in branches],
        _mapper(jgraph), device="cpu")
    out = fitted.apply(ArrayDataset.from_numpy(runs["vx"], "cpu")).get()
    np.testing.assert_array_equal(out.numpy(), runs["jout"])


def test_run_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tx, ty), _ = make_surrogate_timit(8, 2)
    split = LabeledData(ArrayDataset.from_numpy(tx, "cpu"),
                        ArrayDataset.from_numpy(ty, "cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttimit.run(ttimit.TimitConfig(num_cosines=1),
                   data=tloader.TimitFeaturesData(split, split))
