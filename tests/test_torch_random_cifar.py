"""RandomCifar: the port against ``keystone_tpu``.

Both packages run the app (``run``, as ``tests/test_app_pipelines.py``
drives the JAX one) with 8 Gaussian filters and lam = 0.01 on 256 / 64
surrogate CIFAR images. The filters are the same bits; class
predictions agree on at least 0.98 of test images and the test errors
within 0.02 (two float32 exact solves on 800 features). The JAX fit,
carried across with ``convert.random_cifar_pipeline``, scores within
1e-4 of the largest score of the JAX package's and predicts the same
classes. The featurizer is one fused node, and the DefaultOptimizer and
the NoOpOptimizer give the same predictions bit for bit.
"""
import numpy as np
import pytest
import torch

from keystone_tpu.loaders.csv_loader import LabeledData as JLabeledData
from keystone_tpu.parallel.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.pipelines.images.cifar import random_cifar as jrc
from keystone_tpu.workflow.env import PipelineEnv as JEnv
from keystone_tpu_torch import convert
from keystone_tpu_torch.loaders.csv_loader import LabeledData
from keystone_tpu_torch.loaders.surrogate import make_surrogate_cifar
from keystone_tpu_torch.nodes.util import ClassLabelIndicatorsFromIntLabels
from keystone_tpu_torch.parallel.dataset import ArrayDataset
from keystone_tpu_torch.pipelines.images.cifar import random_cifar as trc
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.optimizer.default import NoOpOptimizer
from keystone_tpu_torch.workflow.optimizer.fusion import FusedTransformer

CONFIG = dict(num_filters=8, lam=0.01, seed=0)


def _ops(graph):
    return {type(graph.get_operator(n)).__name__: graph.get_operator(n)
            for n in graph.nodes}


@pytest.fixture(scope="module")
def runs():
    (x, y), (vx, vy) = make_surrogate_cifar(256, 64)
    y, vy = y.astype(np.int32), vy.astype(np.int32)
    JEnv.get_or_create().clear_state()
    jpipe, _, jtest = jrc.run(
        jrc.RandomCifarConfig(**CONFIG),
        train=JLabeledData(JArrayDataset.from_numpy(x),
                           JArrayDataset.from_numpy(y)),
        test=JLabeledData(JArrayDataset.from_numpy(vx),
                          JArrayDataset.from_numpy(vy)))
    jfit = jpipe.fit()
    jout = np.asarray(jfit.apply(JArrayDataset.from_numpy(vx)).get().numpy())
    PipelineEnv.reset()
    tfit, _, ttest = trc.run(
        trc.RandomCifarConfig(**CONFIG),
        train=LabeledData(ArrayDataset.from_numpy(x, "cpu"),
                          ArrayDataset.from_numpy(y, "cpu")),
        test=LabeledData(ArrayDataset.from_numpy(vx, "cpu"),
                         ArrayDataset.from_numpy(vy, "cpu")),
        device="cpu")
    tout = tfit.apply(ArrayDataset.from_numpy(vx, "cpu")).get().numpy()
    return dict(x=x, y=y, vx=vx, jfit=jfit, jtest=jtest, jout=jout,
                tfit=tfit, ttest=ttest, tout=tout)


def test_random_cifar_run_matches_jax(runs):
    jops, tops = _ops(runs["jfit"]._graph), _ops(runs["tfit"]._graph)
    np.testing.assert_array_equal(
        tops["FusedTransformer"].stages[0].filters,
        np.asarray(jops["FusedTransformer"].stages[0].filters))
    assert np.mean(runs["tout"] == runs["jout"]) >= 0.98
    assert abs(runs["ttest"].total_error - runs["jtest"].total_error) <= 0.02
    one = runs["tfit"].apply_datum(torch.as_tensor(runs["vx"][0])).get()
    assert int(one) == runs["tout"][0]


def test_fitted_random_cifar_carried_across_scores_as_jax(runs):
    jops = _ops(runs["jfit"]._graph)
    conv = jops["FusedTransformer"].stages[0]
    scaler, model = jops["StandardScalerModel"], jops["LinearMapper"]
    fitted = convert.random_cifar_pipeline(
        np.asarray(conv.filters), np.asarray(scaler.mean),
        np.asarray(scaler.std), model,
        trc.RandomCifarConfig(**CONFIG), device="cpu")
    out = fitted.apply(ArrayDataset.from_numpy(runs["vx"], "cpu")).get()
    np.testing.assert_array_equal(out.numpy(), runs["jout"])
    # the scores, the chain less its argmax, against the JAX package's
    tops = _ops(fitted._graph)
    chain = tops["Convolver"]
    for name in ("SymmetricRectifier", "Pooler", "ImageVectorizer",
                 "StandardScalerModel", "LinearMapper"):
        chain = chain >> tops[name]
    got = chain.apply(ArrayDataset.from_numpy(runs["vx"], "cpu")).get().numpy()
    jchain = jops["FusedTransformer"] >> scaler >> model
    want = np.asarray(jchain.apply(JArrayDataset.from_numpy(
        runs["vx"])).get().numpy())
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_featurizer_is_one_fused_node(runs):
    g = runs["tfit"].apply(ArrayDataset.from_numpy(runs["vx"][:4], "cpu"))
    g.get()
    labels = [g._executor.graph.get_operator(n).label()
              for n in g._executor.graph.nodes]
    assert ("Fused[Convolver >> SymmetricRectifier >> Pooler >> "
            "ImageVectorizer]") in labels
    fused = [op for op in _ops(runs["tfit"]._graph).values()
             if isinstance(op, FusedTransformer)]
    assert len(fused) == 1 and len(fused[0].stages) == 4


def test_default_and_noop_optimizers_predict_the_same_bits(runs):
    x, y, vx = runs["x"][:96], runs["y"][:96], runs["vx"]
    preds = []
    for opt in (None, NoOpOptimizer()):
        PipelineEnv.reset()
        if opt is not None:
            PipelineEnv.get_or_create().set_optimizer(opt)
        train = ArrayDataset.from_numpy(x, "cpu")
        labels = ClassLabelIndicatorsFromIntLabels(10)(
            ArrayDataset.from_numpy(y, "cpu"))
        fitted = trc.build_pipeline(trc.RandomCifarConfig(**CONFIG), train,
                                    labels).fit()
        preds.append(fitted.apply(ArrayDataset.from_numpy(
            vx, "cpu")).get().numpy())
    PipelineEnv.reset()
    np.testing.assert_array_equal(preds[0], preds[1])
