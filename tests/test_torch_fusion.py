"""Map and gather fusion: the port against ``keystone_tpu``.

* Fusability: each Transformer class of the port that has a JAX
  counterpart of the same module and name answers ``fusable`` as the
  JAX predicate (``keystone_tpu/workflow/optimizer/fusion.py::_fusable``,
  read on the class) answers.
* The optimized graphs: JAX's ``DefaultOptimizer`` and the port's give
  the same node labels in linearize order on the apps' graphs.
* The cases of ``tests/test_map_fusion.py`` that have a meaning in eager
  PyTorch (those about compiled-program caches do not), run on the
  port; results of fused and unfused paths are compared bit for bit on
  the CPU, as the fused node runs each stage's own batch path.
* Streams, the datum path, the gathered features written in place, and
  no process-wide memo pinning fitted stages.
"""
import gc
import importlib
import inspect
import pkgutil
import weakref

import numpy as np
import pytest
import torch

import keystone_tpu_torch
from keystone_tpu.loaders.csv_loader import LabeledData as JLabeledData
from keystone_tpu.nodes.learning import (
    BlockLeastSquaresEstimator as JBLS,
)
from keystone_tpu.nodes.learning import LinearMapEstimator as JLinearMap
from keystone_tpu.nodes.images import core as jcore
from keystone_tpu.nodes.util import (
    ClassLabelIndicatorsFromIntLabels as JLabels,
)
from keystone_tpu.nodes.util import MaxClassifier as JMax
from keystone_tpu.parallel.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.pipelines.images.cifar import random_patch_cifar as jrpc
from keystone_tpu.pipelines.images.mnist import random_fft as jfft
from keystone_tpu.pipelines.speech import timit as jtimit
from keystone_tpu.workflow import graph_ids as jids
from keystone_tpu.workflow.common import Cacher as JCacher
from keystone_tpu.workflow.env import PipelineEnv as JEnv
from keystone_tpu.workflow.optimizer.default import (
    DefaultOptimizer as JDefault,
)
from keystone_tpu_torch.loaders.csv_loader import LabeledData
from keystone_tpu_torch.loaders.surrogate import make_surrogate_cifar
from keystone_tpu_torch.nodes.images import core as tcore
from keystone_tpu_torch.nodes.learning import (
    BlockLeastSquaresEstimator,
    LinearMapEstimator,
)
from keystone_tpu_torch.nodes.learning.linear import LinearMapper
from keystone_tpu_torch.nodes.stats import (
    CosineRandomFeatures,
    StandardScaler,
    StandardScalerModel,
)
from keystone_tpu_torch.nodes.util import (
    ClassLabelIndicatorsFromIntLabels,
    MaxClassifier,
    VectorCombiner,
)
from keystone_tpu_torch.parallel.dataset import ArrayDataset
from keystone_tpu_torch.parallel.streaming import StreamingDataset
from keystone_tpu_torch.pipelines.images.cifar import random_cifar as trc
from keystone_tpu_torch.pipelines.images.cifar import (
    random_patch_cifar as trpc,
)
from keystone_tpu_torch.pipelines.images.mnist import random_fft as tfft
from keystone_tpu_torch.pipelines.speech import timit as ttimit
from keystone_tpu_torch.workflow.common import Cacher
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.estimator import LambdaEstimator
from keystone_tpu_torch.workflow.graph_ids import NodeId
from keystone_tpu_torch.workflow.optimizer.default import (
    DefaultOptimizer,
    NoOpOptimizer,
)
from keystone_tpu_torch.workflow.optimizer.fusion import (
    FusedGatherTransformer,
    FusedTransformer,
    GatherFusionRule,
    MapFusionRule,
)
from keystone_tpu_torch.workflow.optimizer.rule import (
    Batch,
    FixedPoint,
    Optimizer,
)
from keystone_tpu_torch.workflow.optimizer.rules import (
    EquivalentNodeMergeRule,
)
from keystone_tpu_torch.workflow.pipeline import Pipeline
from keystone_tpu_torch.nodes.util.sparse import Sparsify
from keystone_tpu_torch.workflow.transformer import (
    LambdaTransformer,
    Transformer,
)


@pytest.fixture(autouse=True)
def fresh_envs():
    PipelineEnv.reset()
    JEnv.get_or_create().clear_state()
    yield
    PipelineEnv.reset()


# -- fusability, class by class -------------------------------------------

def _port_transformer_classes():
    """(qualified name, port class, JAX class) for every Transformer class
    the port defines that the JAX package defines in the module of the
    same path under the same name."""
    out = []
    for info in pkgutil.walk_packages(keystone_tpu_torch.__path__,
                                      "keystone_tpu_torch."):
        if info.name.endswith("__main__") or ".tools" in info.name:
            continue
        mod = importlib.import_module(info.name)
        for name, cls in inspect.getmembers(mod, inspect.isclass):
            if cls.__module__ != info.name or not issubclass(
                    cls, Transformer):
                continue
            jname = info.name.replace("keystone_tpu_torch", "keystone_tpu", 1)
            try:
                jcls = getattr(importlib.import_module(jname), name)
            except (ImportError, AttributeError):
                continue
            out.append((f"{info.name[len('keystone_tpu_torch.'):]}.{name}",
                        cls, jcls))
    return sorted(out, key=lambda t: t[0])


SHARED = _port_transformer_classes()

#: the classes the JAX predicate refuses (and so the port's ``fusable``)
NOT_FUSABLE = {
    "nodes.images.core.CenterCornerPatcher",
    "nodes.images.core.FusedConvRectifyPool",
    "nodes.images.core.RandomFlipper",
    "nodes.images.core.RandomImageTransformer",
    "nodes.images.core.RandomPatcher",
    "nodes.images.core.Windower",
    "nodes.images.extractors.BatchSIFTExtractor",
    "nodes.images.multilabel.MultiLabelExtractor",
    "nodes.images.multilabel.MultiLabeledImageExtractor",
    "nodes.learning.classifiers.LogisticRegressionModel",
    "nodes.learning.classifiers.NaiveBayesModel",
    "nodes.learning.classifiers.SparseLinearMapper",
    "nodes.nlp.corenlp.CoreNLPFeatureExtractor",
    "nodes.nlp.corenlp.NER",
    "nodes.nlp.corenlp.POSTagger",
    "nodes.nlp.hashing.HashingTF",
    "nodes.nlp.hashing.NGramsHashingTF",
    "nodes.nlp.ngrams.NGramsCounts",
    "nodes.nlp.ngrams.NGramsFeaturizer",
    "nodes.nlp.stupid_backoff.StupidBackoffModel",
    "nodes.nlp.text.LowerCase",
    "nodes.nlp.text.Tokenizer",
    "nodes.nlp.text.Trim",
    "nodes.nlp.word_freq.WordFrequencyTransformer",
    "nodes.stats.TermFrequency",
    "nodes.stats.sampling.Sampler",
    "nodes.util.Densify",
    "nodes.util.LabelAugmenter",
    "nodes.util.sparse.SparseFeatureVectorizer",
    "nodes.util.sparse.Sparsify",
    "workflow.common.Cacher",
    "workflow.common.Identity",
    "workflow.optimizable.OptimizableTransformer",
    "workflow.transformer.HostTransformer",
}


def _jax_fusable(jcls) -> bool:
    """``keystone_tpu``'s ``_fusable`` read on the class."""
    from keystone_tpu.workflow.transformer import (
        HostTransformer as JHost,
        Transformer as JTransformer,
    )

    return (issubclass(jcls, JTransformer)
            and not issubclass(jcls, JHost)
            and (jcls.apply_dataset is JTransformer.apply_dataset
                 or jcls.fusion_safe)
            and not getattr(jcls, "saveable", False))


@pytest.mark.parametrize("name,cls,jcls", SHARED,
                         ids=[name for name, _, _ in SHARED])
def test_fusable_matches_the_jax_predicate(name, cls, jcls):
    assert cls.fusable == _jax_fusable(jcls), name
    assert cls.fusable == (name not in NOT_FUSABLE), name


def test_every_refused_class_is_shared():
    names = {name for name, _, _ in SHARED}
    assert NOT_FUSABLE <= names
    assert len(names) >= 43


# -- optimized graphs against the JAX package ------------------------------

def _labels(graph, node_cls):
    return [graph.get_operator(n).label() for n in graph.linearize()
            if isinstance(n, node_cls)]


def _same_labels(jgraph, tgraph, expect_fused=None):
    jl = _labels(JDefault().execute(jgraph), jids.NodeId)
    tl = _labels(DefaultOptimizer().execute(tgraph), NodeId)
    assert tl == jl
    if expect_fused is not None:
        assert sum(lbl.startswith("Fused") for lbl in tl) == expect_fused
    return tl


def _digits(n, d, k, seed):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, k, n).astype(np.int32)
    X = (rng.randn(n, d) + 2.0 * y[:, None]).astype(np.float32)
    return X, y


def test_mnist_random_fft_graph_matches_jax():
    X, y = _digits(32, 784, 10, 0)
    jtrain = JLabeledData(JArrayDataset.from_numpy(X),
                          JArrayDataset.from_numpy(y))
    jlabels = JLabels(10)(jtrain.labels)
    jpipe = jfft.build_featurizer(jfft.MnistRandomFFTConfig(
        num_ffts=3)).and_then(JBLS(2048, 1, 0.1), jtrain.data,
                              jlabels) >> JMax()
    train = LabeledData(ArrayDataset.from_numpy(X, "cpu"),
                        ArrayDataset.from_numpy(y, "cpu"))
    tpipe = tfft.build_pipeline(tfft.MnistRandomFFTConfig(
        num_ffts=3, block_size=2048, lam=0.1), train)
    # the featurizer on the training data and on the runtime input
    labels = _same_labels(jpipe.graph, tpipe.graph, expect_fused=2)
    assert ("Fused[FusedGather[" + ", ".join(
        ["Fused[RandomSignNode >> PaddedFFT >> LinearRectifier]"] * 3)
        + "] >> VectorCombiner]") in labels


def test_timit_graph_matches_jax():
    X, y = _digits(32, 20, 4, 1)
    cfg = dict(num_cosines=3, num_cosine_features=64, lam=0.01, gamma=0.1)
    jtrain = JLabeledData(JArrayDataset.from_numpy(X),
                          JArrayDataset.from_numpy(y))
    jpipe = jtimit.build_featurizer(jtimit.TimitConfig(**cfg), 20).and_then(
        JBLS(64, 5, 0.01), jtrain.data, JLabels(4)(jtrain.labels)) >> JMax()
    train = LabeledData(ArrayDataset.from_numpy(X, "cpu"),
                        ArrayDataset.from_numpy(y, "cpu"))
    tpipe = ttimit.build_pipeline(ttimit.TimitConfig(**cfg), train, 4)
    labels = _same_labels(jpipe.graph, tpipe.graph, expect_fused=2)
    assert ("Fused[FusedGather[" + ", ".join(["CosineRandomFeatures"] * 3)
            + "] >> VectorCombiner]") in labels


def test_random_cifar_featurizer_graph_matches_jax():
    cfg = trc.RandomCifarConfig(num_filters=4)
    filters = trc.random_filters(cfg)
    jfeat = (jcore.Convolver(filters, 32, 32, 3, whitener=None,
                             normalize_patches=True)
             >> jcore.SymmetricRectifier(alpha=cfg.alpha)
             >> jcore.Pooler(cfg.pool_stride, cfg.pool_size, "identity",
                             "sum")
             >> jcore.ImageVectorizer() >> JCacher())
    labels = _same_labels(jfeat.to_pipeline().graph,
                          trc.build_featurizer(cfg, filters).graph,
                          expect_fused=1)
    assert labels == ["Fused[Convolver >> SymmetricRectifier >> Pooler >> "
                      "ImageVectorizer]", "Cache"]


@pytest.fixture(scope="module")
def cifar():
    return make_surrogate_cifar(64, 16)


def test_random_patch_cifar_graphs_match_jax(cifar):
    (x, y), (vx, _) = cifar
    config = trpc.RandomCifarConfig(num_filters=8, lam=10.0)
    jtrain = JLabeledData(JArrayDataset.from_numpy(x),
                          JArrayDataset.from_numpy(y.astype(np.int32)))
    filters, jwhitener = jrpc.learn_filters(jtrain.data, jrpc.RandomCifarConfig(
        num_filters=8, lam=10.0))
    jlabels = (JLabels(10) >> JCacher("labels"))(jtrain.labels)
    jpipe = jrpc.build_pipeline(filters, jwhitener, jrpc.RandomCifarConfig(
        num_filters=8, lam=10.0), jtrain.data, jlabels)
    train = ArrayDataset.from_numpy(x, "cpu")
    labels = (ClassLabelIndicatorsFromIntLabels(10) >> Cacher("labels"))(
        ArrayDataset.from_numpy(y.astype(np.int32), "cpu"))
    from keystone_tpu_torch.convert import whitener_from_arrays

    whitener = whitener_from_arrays(jwhitener.means, jwhitener.whitener)
    tpipe = trpc.build_pipeline(filters, whitener, config, train, labels)
    _same_labels(jpipe.graph, tpipe.graph)
    # the fitted apply graph: the fitted chain after the featurizer fuses
    japply = jpipe.fit().apply(JArrayDataset.from_numpy(vx))
    tapply = tpipe.fit().apply(ArrayDataset.from_numpy(vx, "cpu"))
    jl = _labels(japply._executor.graph, jids.NodeId)
    tl = _labels(tapply._executor.graph, NodeId)
    assert tl == jl
    assert ("Fused[StandardScalerModel >> BlockLinearMapper >> "
            "MaxClassifier]") in tl


def test_linear_pixels_graph_matches_jax(cifar):
    (x, y), _ = cifar
    jtrain = JArrayDataset.from_numpy(x)
    jpipe = (jcore.GrayScaler() >> jcore.ImageVectorizer()).and_then(
        JLinearMap(1.0), jtrain, JLabels(10)(JArrayDataset.from_numpy(
            y.astype(np.int32)))) >> JMax()
    train = ArrayDataset.from_numpy(x, "cpu")
    tpipe = (tcore.GrayScaler() >> tcore.ImageVectorizer()).and_then(
        LinearMapEstimator(1.0), train, ClassLabelIndicatorsFromIntLabels(
            10)(ArrayDataset.from_numpy(y.astype(np.int32), "cpu"))) \
        >> MaxClassifier()
    labels = _same_labels(jpipe.graph, tpipe.graph)
    assert "Fused[GrayScaler >> ImageVectorizer]" in labels


def test_voc_fitted_apply_graph_matches_jax():
    from keystone_tpu.loaders.image_loader_utils import (
        MultiLabeledImage as JMLI,
    )
    from keystone_tpu.nodes.images.multilabel import (
        MultiLabeledImageExtractor as JImages,
    )
    from keystone_tpu.parallel.dataset import HostDataset as JHost
    from keystone_tpu.pipelines.images.voc import voc_sift_fisher as jvoc
    from keystone_tpu_torch.loaders.surrogate import make_surrogate_voc
    from keystone_tpu_torch.nodes.images.multilabel import (
        MultiLabeledImageExtractor,
    )
    from keystone_tpu_torch.pipelines.images.voc import (
        voc_sift_fisher as tvoc,
    )

    # the size of tests/test_torch_voc.py
    config = dict(lam=0.5, desc_dim=8, vocab_size=2, num_pca_samples=400,
                  num_gmm_samples=400, block_size=256)
    sift = dict(step=12, num_scales=2)
    train, test = make_surrogate_voc(8, 8, seed=0,
                                     sizes=((56, 56), (48, 64)))

    def jax(ds):
        return JHost([JMLI(it.image, list(it.labels), it.filename)
                      for it in ds.collect()])

    jpred, _ = jvoc.run(jvoc.SIFTFisherConfig(**config), train=jax(train),
                        test=jax(test), sift_kwargs=sift)
    japply = jpred.fit().apply(JImages().apply_dataset(jax(test)))
    tfit, _ = tvoc.run(tvoc.SIFTFisherConfig(**config), train=train,
                       test=test, sift_kwargs=sift, device="cpu")
    tapply = tfit.apply(MultiLabeledImageExtractor("cpu").apply_dataset(test))
    japply.get()
    tapply.get()
    jl = _labels(japply._executor.graph, jids.NodeId)
    tl = _labels(tapply._executor.graph, NodeId)
    assert tl == jl
    assert "Fused[PixelScaler >> GrayScaler]" in tl
    assert "Fused[SIFTExtractor >> BatchPCATransformer]" in tl
    assert any(lbl.startswith("Fused[FisherVector >> ") for lbl in tl)


# -- the cases of tests/test_map_fusion.py ---------------------------------

def t(fn, name):
    return LambdaTransformer(fn, name)


class FusionOnly(Optimizer):
    @property
    def batches(self):
        return [Batch("fuse", FixedPoint(100), [MapFusionRule()])]


def _fused_ops_of_bound(pipe, ds):
    bound = pipe.apply(ds)
    bound.get()
    g = bound._executor.graph
    return [g.get_operator(n) for n in sorted(g.nodes, key=lambda n: n.id)
            if isinstance(g.get_operator(n), FusedTransformer)]


def test_chain_fuses_to_one_node():
    pipe = (t(lambda x: x + 1, "a") >> t(lambda x: x * 2, "b")
            >> t(lambda x: x - 3, "c"))
    g = FusionOnly().execute(pipe.graph)
    assert len(g.nodes) == 1
    (op,) = [g.get_operator(n) for n in g.nodes]
    assert isinstance(op, FusedTransformer)
    assert [s.label() for s in op.stages] == ["a", "b", "c"]
    x = np.arange(8.0, dtype=np.float32).reshape(8, 1)
    fitted = pipe.fit()
    out = fitted.apply(ArrayDataset.from_numpy(x, "cpu")).get().numpy()
    np.testing.assert_array_equal(out, (x + 1) * 2 - 3)
    assert float(fitted.apply_datum(torch.tensor([5.0])).get()) == 9.0


def test_multi_consumer_not_fused():
    class CseThenFuse(Optimizer):
        @property
        def batches(self):
            return [Batch("cse", FixedPoint(100), [EquivalentNodeMergeRule()]),
                    Batch("fuse", FixedPoint(100), [MapFusionRule()])]

    a = t(lambda x: x + 1, "a").to_pipeline()
    both = Pipeline.gather([a >> t(lambda x: x * 2, "b"),
                            a >> t(lambda x: x * 3, "c")])
    g = CseThenFuse().execute(both.graph)
    labels = sorted(g.get_operator(n).label() for n in g.nodes)
    assert "a" in labels and "b" in labels and "c" in labels


def test_cacher_breaks_chain():
    pipe = t(lambda x: x + 1, "a") >> Cacher("mid") >> t(lambda x: x * 2, "b")
    g = FusionOnly().execute(pipe.graph)
    assert "Cacher" in [type(g.get_operator(n)).__name__ for n in g.nodes]
    assert len(g.nodes) == 3


def test_host_stage_not_fused():
    """Sparsify is the port's host stage (a HostTransformer in the JAX
    package)."""
    pipe = t(lambda x: x * 2, "a") >> Sparsify()
    assert len(FusionOnly().execute(pipe.graph).nodes) == 2


def test_fused_eq_key_enables_cse():
    a, b, c = t(lambda x: x, "a"), t(lambda x: x, "b"), t(lambda x: x, "c")
    assert (FusedTransformer([a, b]).eq_key()
            == FusedTransformer([a, b]).eq_key())
    assert (FusedTransformer([a, b]).eq_key()
            != FusedTransformer([a, c]).eq_key())
    # two equal fused nodes on one input merge under CSE
    g = Pipeline.gather([a >> b, a >> b]).graph
    g = FusionOnly().execute(g)
    g = EquivalentNodeMergeRule().apply(g)
    fused = [n for n in g.nodes
             if isinstance(g.get_operator(n), FusedTransformer)]
    assert len(fused) == 1


def test_fused_eq_key_is_the_jax_key_shape():
    """The fused key is the tuple of the stages' own keys, as in the JAX
    package, so prefixes and CSE see through fusion the same way."""
    a, b = t(lambda x: x, "a"), t(lambda x: x, "b")
    key = FusedTransformer([a, b]).eq_key()
    assert key == (FusedTransformer, (a._cached_eq_key(), b._cached_eq_key()))
    gkey = FusedGatherTransformer([a, b]).eq_key()
    assert gkey[1] == (a._cached_eq_key(), b._cached_eq_key())


def _bls_app(optimizer):
    rng = np.random.RandomState(0)
    X = rng.randn(64, 12).astype(np.float32)
    y = rng.randint(0, 4, 64).astype(np.int32)
    ds = ArrayDataset.from_numpy(X, "cpu")
    labels = ClassLabelIndicatorsFromIntLabels(4).apply_dataset(
        ArrayDataset.from_numpy(y, "cpu"))
    env = PipelineEnv.get_or_create()
    env.clear_state()
    env.set_optimizer(optimizer)
    feat = (t(lambda x: x * 2.0, "scale") >> t(lambda x: x + 1.0, "shift")
            >> t(lambda x: np.tanh(1) * x, "gain"))
    fitted = (feat.and_then(StandardScaler(), ds)
              .and_then(BlockLeastSquaresEstimator(8, 1, 0.1), ds, labels)
              >> MaxClassifier()).fit()
    return fitted, ds


def test_default_optimizer_matches_noop_end_to_end():
    preds, scores = {}, {}
    for name, opt in (("noop", NoOpOptimizer()),
                      ("default", DefaultOptimizer())):
        fitted, ds = _bls_app(opt)
        preds[name] = fitted.apply(ds).get().numpy()
        scores[name] = [fitted.apply_datum(ds.data[i]).get()
                        for i in range(4)]
    np.testing.assert_array_equal(preds["noop"], preds["default"])
    assert [int(s) for s in scores["noop"]] == [
        int(s) for s in scores["default"]]


def test_fitted_pipeline_fuses_model_chain():
    pipe = (t(lambda x: x + 1, "a") >> t(lambda x: x * 2, "b")
            >> t(lambda x: x - 1, "c") >> t(lambda x: x / 2, "d"))
    fitted = pipe.fit()
    x = np.ones((4, 2), np.float32)
    out = fitted.apply(ArrayDataset.from_numpy(x, "cpu")).get().numpy()
    np.testing.assert_array_equal(out, ((x + 1) * 2 - 1) / 2)
    fused = _fused_ops_of_bound(fitted.to_pipeline(),
                                ArrayDataset.from_numpy(x, "cpu"))
    assert len(fused) == 1 and len(fused[0].stages) == 4


def test_fitted_scaler_mapper_chain_fuses_and_threads_params():
    rng = np.random.RandomState(3)
    X = rng.randn(16, 6).astype(np.float32)
    scaler = StandardScalerModel(rng.randn(6).astype(np.float32),
                                 (0.5 + rng.rand(6)).astype(np.float32))
    mapper = LinearMapper(rng.randn(6, 3).astype(np.float32),
                          intercept=rng.randn(3).astype(np.float32))
    fused = FusedTransformer([scaler, mapper])
    dev = torch.device("cpu")
    params = fused.apply_params(dev)
    # the stages' own cached params, not copies
    assert params[0] is scaler.apply_params(dev)
    assert params[1] is mapper.apply_params(dev)
    Xt = torch.as_tensor(X)
    want = mapper.apply_batch(scaler.apply_batch(Xt))
    assert torch.equal(fused.apply_batch(Xt), want)
    for i in range(4):
        assert torch.equal(fused.apply_with_params(params, Xt[i]),
                           mapper.apply(scaler.apply(Xt[i])))


def test_gather_branches_fuse_to_one_node():
    branches = [t(lambda x, s=s: x * s, f"scale{s}") >> t(torch.sin, f"sin{s}")
                for s in (1.0, 2.0, 3.0)]
    pipe = Pipeline.gather(branches) >> VectorCombiner()
    g = DefaultOptimizer().execute(pipe.graph)
    assert len(g.nodes) == 1
    (op,) = [g.get_operator(n) for n in g.nodes]
    assert isinstance(op, FusedTransformer)
    assert any(isinstance(s, FusedGatherTransformer) for s in op.stages)
    X = np.linspace(0.0, 1.0, 12).reshape(6, 2).astype(np.float32)
    Xt = torch.as_tensor(X)
    expect = torch.cat([torch.sin(Xt * s) for s in (1.0, 2.0, 3.0)], dim=-1)
    fitted = pipe.fit()
    out = fitted.apply(ArrayDataset.from_numpy(X, "cpu")).get().numpy()
    np.testing.assert_array_equal(out, expect.numpy())
    one = fitted.apply_datum(Xt[2]).get()
    np.testing.assert_array_equal(one.numpy(), expect[2].numpy())


def test_gather_host_branch_not_fused():
    dev = t(lambda x: x * 2.0, "dev")
    g = (Pipeline.gather([Sparsify(), dev]) >> VectorCombiner()).graph
    assert len(GatherFusionRule().apply(g).nodes) == len(g.nodes)
    g2 = (Pipeline.gather([t(lambda x: x + 1.0, "a"), dev])
          >> VectorCombiner()).graph
    assert len(GatherFusionRule().apply(g2).nodes) < len(g2.nodes)


def test_fused_prefix_chain_hits_saved_state():
    fits = []

    def fit_fn(ds):
        fits.append(1)
        m = float(ds.numpy().mean())
        return t(lambda x, m=m: x - m, "center")

    est = LambdaEstimator(fit_fn, "E")
    a, b = t(lambda x: x + 1.0, "a"), t(lambda x: x * 2.0, "b")
    train = ArrayDataset.from_numpy(
        np.arange(8.0, dtype=np.float32).reshape(8, 1), "cpu",
        tag="fused-prefix")
    out1 = (a >> b).and_then(est, train)(train).get().numpy()
    assert len(fits) == 1
    out2 = (a >> b).and_then(est, train)(train).get().numpy()
    assert len(fits) == 1, "fused pre-estimator chain missed saved state"
    np.testing.assert_array_equal(out1, out2)


def test_fused_gather_prefix_hits_saved_state():
    fits = []

    def fit_fn(ds):
        fits.append(1)
        return t(lambda x: x, "id")

    g1, g2 = t(lambda x: x + 1.0, "g1"), t(lambda x: x * 2.0, "g2")
    combiner, est = VectorCombiner(), LambdaEstimator(fit_fn, "E")
    train = ArrayDataset.from_numpy(
        np.arange(8.0, dtype=np.float32).reshape(8, 1), "cpu",
        tag="fused-gather-prefix")

    def build():
        return (Pipeline.gather([g1, g2]) >> combiner).and_then(est, train)

    out1 = build()(train).get().numpy()
    out2 = build()(train).get().numpy()
    assert len(fits) == 1, "fused gather chain missed saved state"
    np.testing.assert_array_equal(out1, out2)


# -- streams, single items, the gathered features, pinning -----------------

def _scaler_mapper(seed=0, d=16, k=4):
    r = np.random.RandomState(seed)
    return (StandardScalerModel(r.randn(d).astype(np.float32),
                                (0.5 + r.rand(d)).astype(np.float32)),
            LinearMapper(r.randn(d, k).astype(np.float32),
                         intercept=r.randn(k).astype(np.float32)))


def test_fused_chain_streams_per_chunk():
    X = np.random.RandomState(1).randn(70, 16).astype(np.float32)
    fused = FusedTransformer(list(_scaler_mapper()))
    resident = fused.apply_dataset(ArrayDataset.from_numpy(X, "cpu")).numpy()
    out = fused.apply_dataset(StreamingDataset.from_numpy(
        X, 16, device="cpu"))
    chunks = [c.data[:c.n].numpy() for c in out.chunks()]
    assert len(chunks) == 5
    np.testing.assert_array_equal(np.concatenate(chunks), resident)


def test_datum_path_equals_batch_path_row_for_row():
    rng = np.random.RandomState(2)
    X = torch.as_tensor(rng.randn(5, 20).astype(np.float32))
    scaler, mapper = _scaler_mapper(3, d=8 * 3, k=3)
    branches = [CosineRandomFeatures.create(20, 8, 0.3, seed=i)
                for i in range(3)]
    stages = [FusedGatherTransformer(branches), VectorCombiner(), scaler,
              mapper]
    fused = FusedTransformer(stages)
    gather = stages[0]
    batch = fused.apply_batch(X)
    gathered = gather.apply_batch(X)
    scale = float(batch.abs().max())
    for i in range(X.shape[0]):
        one = fused.apply(X[i])
        # the datum path is each stage's own datum path, bit for bit ...
        want = X[i]
        for s in stages:
            want = s.apply(want)
        assert torch.equal(one, want)
        # ... and the batch path's row within 1e-6 of the largest score
        # (a matrix-vector product against a matrix product)
        assert float((one - batch[i]).abs().max()) <= 1e-6 * scale
        for got, rows in zip(gather.apply(X[i]), gathered):
            assert float((got - rows[i]).abs().max()) <= 1e-6


@pytest.mark.parametrize("widths", [(8, 8, 8), (8, 5, 8), (4,)])
def test_gathered_features_written_in_place_equal_the_concatenation(widths):
    """The fused gather feeding VectorCombiner writes each branch's batch
    into its column block; the result equals the unfused path's
    concatenation bit for bit, also where the widths differ."""
    X = torch.as_tensor(np.random.RandomState(4).randn(9, 6).astype(
        np.float32))
    branches = [CosineRandomFeatures.create(6, w, 0.5, seed=i)
                for i, w in enumerate(widths)]
    fused = FusedTransformer([FusedGatherTransformer(branches),
                              VectorCombiner()])
    want = VectorCombiner().apply_batch(
        tuple(b.apply_batch(X) for b in branches))
    got = fused.apply_batch(X)
    assert got.shape == (9, sum(widths))
    assert torch.equal(got, want)
    # and through the pipeline API, fused against unfused
    pipe = Pipeline.gather(branches) >> VectorCombiner()
    ds = ArrayDataset.from_numpy(X.numpy(), "cpu")
    fused_out = pipe.apply(ds).get().numpy()
    PipelineEnv.get_or_create().set_optimizer(NoOpOptimizer())
    plain_out = pipe.apply(ds).get().numpy()
    np.testing.assert_array_equal(fused_out, plain_out)


def test_a_dropped_fitted_pipeline_is_not_pinned():
    scaler, mapper = _scaler_mapper(5)
    fitted = (scaler >> mapper >> MaxClassifier()).fit()
    X = np.random.RandomState(6).randn(8, 16).astype(np.float32)
    out = fitted.apply(ArrayDataset.from_numpy(X, "cpu"))
    assert _fused_ops_of_bound(fitted.to_pipeline(),
                               ArrayDataset.from_numpy(X, "cpu"))
    out.get()
    ref = weakref.ref(mapper)
    del fitted, out, scaler, mapper
    gc.collect()
    assert ref() is None, "a fused-node memo pins the fitted stage"
