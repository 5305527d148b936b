"""RandomPatchCifar end to end: the port against ``keystone_tpu``.

Both packages fit the north-star pipeline on the same surrogate CIFAR
data (``make_surrogate_cifar(128, 32)``, 8 filters, lam = 10). Learned
filters must match to float32 rounding amplified by the ZCA solve
(rtol 1e-3 of the largest entry); class scores within 1e-3 of the
largest score; predictions agree on at least 98% of test images. The
JAX-fitted model, carried into the port with
``convert.from_reference_arrays``, must give identical predictions.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
from keystone_tpu.loaders.csv_loader import LabeledData as JLabeledData
from keystone_tpu.parallel.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.pipelines.images.cifar import linear_pixels as jlp
from keystone_tpu.pipelines.images.cifar import random_patch_cifar as jrpc
from keystone_tpu_torch import convert
from keystone_tpu_torch.loaders.csv_loader import LabeledData
from keystone_tpu_torch.loaders.surrogate import make_surrogate_cifar
from keystone_tpu_torch.parallel.dataset import ArrayDataset
from keystone_tpu_torch.pipelines.images.cifar import linear_pixels as tlp
from keystone_tpu_torch.pipelines.images.cifar import random_patch_cifar as trpc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def surrogate():
    return make_surrogate_cifar(128, 32)


def _jax_data(split):
    x, y = split
    return JLabeledData(JArrayDataset.from_numpy(x),
                        JArrayDataset.from_numpy(y.astype(np.int32)))


def _port_data(split):
    x, y = split
    return LabeledData(ArrayDataset.from_numpy(x, "cpu"),
                       ArrayDataset.from_numpy(y.astype(np.int32), "cpu"))


def _ops(fitted):
    g = fitted._graph
    return {type(g.get_operator(n)).__name__: g.get_operator(n)
            for n in g.nodes}


def _scores(ops, data):
    """Class scores: the fitted chain minus its MaxClassifier."""
    chain = (ops["FusedConvRectifyPool"] >> ops["StandardScalerModel"]
             >> ops["BlockLinearMapper"])
    return chain.apply(data).numpy()


@pytest.fixture(scope="module")
def fitted_pair(surrogate):
    """(JAX fitted pipeline, port fitted pipeline, JAX filters, port
    filters), both fitted on the same data with the same config."""
    (tr, te) = surrogate
    config = dict(num_filters=8, lam=10.0, seed=0)
    jtrain, ttrain = _jax_data(tr), _port_data(tr)
    jconf, tconf = jrpc.RandomCifarConfig(**config), trpc.RandomCifarConfig(
        **config)
    jfilters, jwhite = jrpc.learn_filters(jtrain.data, jconf)
    tfilters, twhite = trpc.learn_filters(ttrain.data, tconf)

    from keystone_tpu.nodes.util import (
        ClassLabelIndicatorsFromIntLabels as JLabels,
    )
    from keystone_tpu.workflow.common import Cacher as JCacher
    from keystone_tpu_torch.nodes.util import ClassLabelIndicatorsFromIntLabels
    from keystone_tpu_torch.workflow.common import Cacher

    jlabels = (JLabels(10) >> JCacher("labels"))(jtrain.labels)
    tlabels = (ClassLabelIndicatorsFromIntLabels(10) >> Cacher("labels"))(
        ttrain.labels)
    jfit = jrpc.build_pipeline(jfilters, jwhite, jconf, jtrain.data,
                               jlabels).fit()
    tfit = trpc.build_pipeline(tfilters, twhite, tconf, ttrain.data,
                               tlabels).fit()
    return jfit, tfit, (jfilters, jwhite), (tfilters, twhite)


def test_sample_windows_equals_composed_nodes(surrogate):
    """The gathered filter-learning sample is the composed
    Windower >> ImageVectorizer >> Sampler output, row for row."""
    from keystone_tpu_torch.nodes.images.core import (
        ImageVectorizer,
        Windower,
    )
    from keystone_tpu_torch.nodes.stats.sampling import Sampler

    imgs = ArrayDataset.from_numpy(surrogate[0][0][:6], "cpu")
    composed = (Windower(1, 6) >> ImageVectorizer() >> Sampler(500, seed=0)
                ).apply(imgs).numpy()
    gathered = trpc.sample_windows(imgs, 6, 1, 500, seed=0).numpy()
    np.testing.assert_array_equal(gathered, composed)


def test_learned_filters_match_reference(fitted_pair):
    _, _, (jf, jw), (tf, tw) = fitted_pair
    assert tf.shape == jf.shape == (8, 108)
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-3 * np.abs(jf).max())
    np.testing.assert_allclose(tw.means, jw.means, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tw.whitener, jw.whitener, rtol=0,
                               atol=1e-3 * np.abs(jw.whitener).max())


def test_scores_and_predictions_match_reference(surrogate, fitted_pair):
    jfit, tfit, _, _ = fitted_pair
    te = surrogate[1]
    jscores = _scores(_ops(jfit), JArrayDataset.from_numpy(te[0]))
    tscores = _scores(_ops(tfit), ArrayDataset.from_numpy(te[0], "cpu"))
    assert tscores.shape == jscores.shape == (32, 10)
    np.testing.assert_allclose(tscores, jscores, rtol=0,
                               atol=1e-3 * np.abs(jscores).max())
    jpred = jfit.apply(JArrayDataset.from_numpy(te[0])).numpy()
    tpred = tfit.apply(ArrayDataset.from_numpy(te[0], "cpu")).numpy()
    assert np.mean(jpred == tpred) >= 0.98
    # the datum path agrees with the batch path
    for i in (0, 5, 31):
        assert int(tfit.apply_datum(torch.as_tensor(te[0][i])).get()) \
            == tpred[i]


def test_reference_model_carried_across_predicts_identically(surrogate,
                                                             fitted_pair):
    jfit, _, _, _ = fitted_pair
    ops = _ops(jfit)
    fused, scaler, mapper = (ops["FusedConvRectifyPool"],
                             ops["StandardScalerModel"],
                             ops["BlockLinearMapper"])
    arrays = {
        "filters": fused.filters,
        "whitener_means": fused.whitener_means,
        "scaler_mean": np.asarray(scaler.mean),
        "scaler_std": np.asarray(scaler.std),
        "weights": np.asarray(mapper.weights),
        "feature_means": np.asarray(mapper.feature_means),
        "intercept": np.asarray(mapper.intercept),
    }
    ported = convert.from_reference_arrays(
        arrays, device="cpu", config=trpc.RandomCifarConfig(num_filters=8))
    te = surrogate[1][0]
    want = jfit.apply(JArrayDataset.from_numpy(te)).numpy()
    got = ported.apply(ArrayDataset.from_numpy(te, "cpu")).numpy()
    np.testing.assert_array_equal(got, want)


def test_run_entry_points_match_reference_errors(surrogate):
    """``run`` of both pipelines through the user entry points: the
    port's train/test errors land within one test image of the
    reference's. LinearPixels is compared at lam = 1e5: at lam = 10 its
    1024-wide Gram over 128 images has kappa ~ 1e8, where any two float32
    solves (HIGHEST-precision XLA, LAPACK) part ways — the f32 parity
    boundary PARITY.md documents."""
    tr, te = surrogate
    config = dict(num_filters=8, lam=10.0, seed=0)
    _, jtr, jte = jrpc.run(jrpc.RandomCifarConfig(**config),
                           _jax_data(tr), _jax_data(te))
    fitted, ttr, tte = trpc.run(trpc.RandomCifarConfig(**config),
                                _port_data(tr), _port_data(te), device="cpu")
    assert abs(ttr.total_error - jtr.total_error) <= 1 / 128
    assert abs(tte.total_error - jte.total_error) <= 1 / 32
    _, jlin_tr, jlin = jlp.run(jlp.LinearPixelsConfig(lam=1e5),
                               _jax_data(tr), _jax_data(te))
    _, tlin_tr, tlin = tlp.run(tlp.LinearPixelsConfig(lam=1e5),
                               _port_data(tr), _port_data(te), device="cpu")
    assert abs(tlin_tr.total_error - jlin_tr.total_error) <= 1 / 128
    assert abs(tlin.total_error - jlin.total_error) <= 1 / 32


def test_surrogate_copy_is_bit_identical_to_bench():
    for args in ((64, 16), (10, 3, 5)):
        a, b = make_surrogate_cifar(*args), bench.make_surrogate_cifar(*args)
        for (xa, ya), (xb, yb) in zip(a, b):
            assert xa.dtype == xb.dtype and ya.dtype == yb.dtype
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)


def test_entry_points_refuse_to_fall_back_to_the_cpu(surrogate):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule under test is what "
                    "happens without one")
    x = surrogate[1][0][:2]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ArrayDataset.from_numpy(x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trpc.run(trpc.RandomCifarConfig(num_filters=8),
                 _port_data(surrogate[0]), _port_data(surrogate[1]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlp.run(tlp.LinearPixelsConfig(), _port_data(surrogate[0]),
                _port_data(surrogate[1]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.from_reference_arrays({"filters": np.zeros((1, 108))})
    from keystone_tpu_torch.nodes.images.core import ImageVectorizer

    pipe = ImageVectorizer().to_pipeline()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipe.apply(x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipe.apply_datum(x[0])


def _run_chip_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_a_card():
    out = _run_chip_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_chip_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
