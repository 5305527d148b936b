"""VOCSIFTFisher end to end: the port against ``keystone_tpu``.

Both packages run the whole pipeline (SIFT -> column PCA -> GMM Fisher
vector -> normalizations -> block least squares -> mean average
precision) on the same seeded surrogate images at the size of the JAX
package's pipeline test (8 training images, desc_dim 8, vocab 2, step
12, 2 scales, block 256), ragged (56 x 56 and 48 x 64). Test scores must
agree within 1e-3 of the largest score and the APs within 1e-3: the two
fits differ only by float32 rounding (the port's PCA is the TSQR form,
the JAX package's node-level rule may pick the local SVD; both are exact
PCAs of the same sample). With the JAX package's fitted PCA and GMM
carried across (``convert``), the Fisher-vector features agree within
1e-4 of the largest.
"""
import numpy as np
import pytest
import torch

from keystone_tpu.evaluation import mean_average_precision as jmap
from keystone_tpu.loaders.image_loader_utils import MultiLabeledImage as JMLI
from keystone_tpu.nodes.images import core as jcore
from keystone_tpu.nodes.images import extractors as jext
from keystone_tpu.nodes.images import fisher_vector as jfv
from keystone_tpu.nodes.images.multilabel import (
    MultiLabeledImageExtractor as JImages,
)
from keystone_tpu.nodes.learning.pca import BatchPCATransformer as JPCA
from keystone_tpu.nodes.stats import NormalizeRows as JNorm
from keystone_tpu.nodes.stats import SignedHellingerMapper as JHell
from keystone_tpu.nodes.util import FloatToDouble as JF2D
from keystone_tpu.nodes.util import MatrixVectorizer as JVec
from keystone_tpu.parallel.dataset import HostDataset as JHost
from keystone_tpu.pipelines.images.voc import voc_sift_fisher as jvoc
from keystone_tpu.workflow.env import PipelineEnv as JEnv
from keystone_tpu.workflow.expression import TransformerExpression
from keystone_tpu_torch import convert
from keystone_tpu_torch.evaluation import mean_average_precision as tmap
from keystone_tpu_torch.loaders.surrogate import make_surrogate_voc
from keystone_tpu_torch.nodes.images.core import GrayScaler, PixelScaler
from keystone_tpu_torch.nodes.images.extractors import SIFTExtractor
from keystone_tpu_torch.nodes.images.multilabel import (
    MultiLabeledImageExtractor,
    MultiLabelExtractor,
)
from keystone_tpu_torch.nodes.stats import NormalizeRows, SignedHellingerMapper
from keystone_tpu_torch.nodes.util import (
    ClassLabelIndicatorsFromIntArrayLabels,
    FloatToDouble,
    MatrixVectorizer,
)
from keystone_tpu_torch.pipelines.images.voc import voc_sift_fisher as tvoc
from keystone_tpu_torch.workflow.env import PipelineEnv

CONFIG = dict(lam=0.5, desc_dim=8, vocab_size=2, num_pca_samples=400,
              num_gmm_samples=400, block_size=256)
SIFT = dict(step=12, num_scales=2)
SIZES = ((56, 56), (48, 64))


@pytest.fixture(scope="module")
def data():
    return make_surrogate_voc(8, 8, seed=0, sizes=SIZES)


def _jax(ds):
    return JHost([JMLI(it.image, list(it.labels), it.filename)
                  for it in ds.collect()])


def _ops(fitted):
    g = fitted._graph
    return {type(g.get_operator(n)).__name__: g.get_operator(n)
            for n in g.nodes}


@pytest.fixture(scope="module")
def runs(data):
    """Both pipelines fitted on the same data: (JAX predictor, JAX APs,
    JAX test scores, JAX fitted PCA matrix, JAX GMM, port fitted
    pipeline, port APs, port test scores)."""
    train, test = data
    JEnv.get_or_create().clear_state()
    jpred, jap = jvoc.run(jvoc.SIFTFisherConfig(**CONFIG), train=_jax(train),
                          test=_jax(test), sift_kwargs=SIFT)
    jscores = np.stack([np.asarray(s) for s in jpred(
        JImages().apply_dataset(_jax(test))).get().collect()])
    pca_mat = gmm = None
    for expr in JEnv.get_or_create().state.values():
        if isinstance(expr, TransformerExpression) and expr.computed:
            node = expr.get()
            if isinstance(node, JPCA):
                pca_mat = np.asarray(node.pca_mat)
            if isinstance(node, jfv.FisherVector):
                gmm = node.gmm
    assert pca_mat is not None and gmm is not None
    PipelineEnv.reset()
    tfit, tap = tvoc.run(tvoc.SIFTFisherConfig(**CONFIG), train=train,
                         test=test, sift_kwargs=SIFT, device="cpu")
    tscores = tfit(MultiLabeledImageExtractor("cpu").apply_dataset(
        test)).get()
    tscores = np.stack([s.numpy() for s in tscores.collect()])
    return jpred, jap, jscores, pca_mat, gmm, tfit, tap, tscores


def test_voc_pipeline_matches_jax(runs):
    _, jap, jscores, _, _, _, tap, tscores = runs
    assert tap.shape == jap.shape == (20,)
    assert np.all(np.isfinite(tap))
    assert tscores.shape == jscores.shape == (8, 20)
    assert np.abs(tscores - jscores).max() <= 1e-3 * np.abs(jscores).max()
    np.testing.assert_allclose(tap, jap, rtol=0, atol=1e-3)


def test_voc_fitted_path_has_the_kernel_nodes(runs):
    ops = _ops(runs[5])
    for name in ("SIFTExtractor", "BatchPCATransformer", "FisherVector",
                 "BlockLinearMapper"):
        assert name in ops, sorted(ops)
    assert ops["BatchPCATransformer"].pca_mat.shape == (128, 8)
    assert ops["FisherVector"].gmm.k == 2


def _featurizer_jax(pca_mat, gmm):
    return (jcore.PixelScaler() >> jcore.GrayScaler()
            >> jext.SIFTExtractor(**SIFT) >> JPCA(pca_mat)
            >> jfv.FisherVector(gmm) >> JF2D() >> JVec() >> JNorm()
            >> JHell() >> JNorm())


def _featurizer_port(pca_mat, gmm):
    return (PixelScaler() >> GrayScaler() >> SIFTExtractor(**SIFT)
            >> convert.pca_transformer(pca_mat)
            >> convert.fisher_vector(gmm.means, gmm.variances, gmm.weights,
                                     gmm.weight_threshold)
            >> FloatToDouble() >> MatrixVectorizer() >> NormalizeRows()
            >> SignedHellingerMapper() >> NormalizeRows())


def test_carried_pca_and_gmm_give_the_same_features(runs, data):
    _, _, _, pca_mat, gmm, _, _, _ = runs
    _, test = data
    jfeat = _featurizer_jax(pca_mat, gmm)
    tfeat = _featurizer_port(pca_mat, gmm)
    for it in test.collect():
        want = np.asarray(jfeat.apply_datum(it.image).get())
        got = tfeat.apply_datum(torch.as_tensor(it.image),
                                device="cpu").get().numpy()
        assert got.shape == want.shape == (8 * 2 * 2,)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_csv_preload_skips_both_fits(runs, data, tmp_path, monkeypatch):
    """The reference's pcaFile / gmm*File branch: the port's own fitted
    PCA and GMM saved as CSV, then a run with the files wired must fit
    neither estimator and give the same APs."""
    _, _, _, _, _, tfit, tap, _ = runs
    train, test = data
    ops = _ops(tfit)
    paths = {k: str(tmp_path / f"{k}.csv")
             for k in ("pca", "mean", "var", "wts")}
    np.savetxt(paths["pca"], ops["BatchPCATransformer"].pca_mat.T,
               delimiter=",")
    ops["FisherVector"].gmm.save(paths["mean"], paths["var"], paths["wts"])

    def no_fit(self, *a, **k):
        raise AssertionError("estimator fit despite preloaded artifacts")

    monkeypatch.setattr(tvoc.ColumnPCAEstimator, "fit_datasets", no_fit)
    monkeypatch.setattr(tvoc.GMMFisherVectorEstimator, "fit_datasets",
                        no_fit)
    PipelineEnv.reset()
    cfg = tvoc.SIFTFisherConfig(
        **CONFIG, pca_file=paths["pca"], gmm_mean_file=paths["mean"],
        gmm_var_file=paths["var"], gmm_wts_file=paths["wts"])
    _, ap = tvoc.run(cfg, train=train, test=test, sift_kwargs=SIFT,
                     device="cpu")
    np.testing.assert_allclose(ap, tap, atol=1e-4)


def test_run_needs_the_datasets(tmp_path):
    """Without datasets, ``run`` reads the config's tar archives: a
    location that does not exist raises."""
    missing = str(tmp_path / "missing")
    labels = tmp_path / "labels.csv"
    labels.write_text('header\nx,1,a,b,"im0.jpg"\n')
    with pytest.raises(FileNotFoundError, match="missing"):
        tvoc.run(tvoc.SIFTFisherConfig(missing, missing, str(labels)),
                 device="cpu")


def test_label_nodes():
    from keystone_tpu_torch.loaders.image_loader_utils import (
        MultiLabeledImage,
    )
    from keystone_tpu_torch.parallel.dataset import HostDataset

    items = HostDataset([MultiLabeledImage(np.zeros((2, 2, 3)), [3, 0]),
                         MultiLabeledImage(np.zeros((2, 2, 3)), [19])])
    padded = MultiLabelExtractor("cpu").apply_dataset(items)
    assert padded.numpy().tolist() == [[3, 0], [19, -1]]
    ind = ClassLabelIndicatorsFromIntArrayLabels(20).apply_batch(padded.data)
    want = -np.ones((2, 20), np.float32)
    want[0, [0, 3]] = 1.0
    want[1, 19] = 1.0
    np.testing.assert_array_equal(ind.numpy(), want)


def test_parse_voc_labels_matches_jax(tmp_path):
    from keystone_tpu.loaders.voc import parse_voc_labels as jparse
    from keystone_tpu_torch.loaders.voc import NUM_CLASSES, parse_voc_labels

    path = tmp_path / "labels.csv"
    path.write_text('id,class,x,y,file\n'
                    '0,15,a,b,"000005.jpg"\n'
                    '1,9,a,b,"000005.jpg"\n'
                    '\n'
                    '2,20,a,b,"000007.jpg"\n')
    got = parse_voc_labels(str(path))
    assert got == jparse(str(path)) == {"000005.jpg": [14, 8],
                                        "000007.jpg": [19]}
    assert NUM_CLASSES == 20


@pytest.mark.parametrize("seed", [0, 1])
def test_mean_average_precision_matches_jax(seed):
    rng = np.random.RandomState(seed)
    scores = rng.randn(40, 20)
    labels = [sorted(set(rng.randint(0, 20, rng.randint(1, 4))))
              for _ in range(40)]
    want = jmap.evaluate_mean_average_precision(labels, scores, 20)
    got = tmap.evaluate_mean_average_precision(labels, torch.as_tensor(
        scores), 20)
    np.testing.assert_array_equal(got, want)
