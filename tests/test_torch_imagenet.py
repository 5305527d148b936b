"""ImageNetSiftLcsFV and its nodes: the port against ``keystone_tpu``.

* ``LCSExtractor`` against the JAX ``_lcs`` on seeded RGB images at two
  sizes, one with a ragged keypoint grid (the grid does not divide the
  image), each with a flat square where the variance cancels, in [0, 1]
  and in [0, 255]. Means within 1e-5 of the pixel range (1e-5 absolute
  on [0, 1] images): both sum the same six values twice in float32 in
  another order. Standard deviations are ``sqrt(max(box(x^2) -
  box(x)^2, 0))``: where the variance is near zero the difference
  cancels to float32 rounding of the second moment, up to 16 roundings
  of (range)^2, and the square root makes that range x 2^-10 (0.249 on
  [0, 255]); that is the bar.
* ``TopKClassifier`` against ``jax.lax.top_k`` on rows with ties: the
  same indices in the same order (ties to the lower index).
* The pipeline at the size of the JAX package's app test (``desc_dim =
  8``, ``vocab_size = 2``, SIFT step 12 over 2 scales, LCS stride 12 and
  border 20, block 128), on ``make_surrogate_imagenet``'s images at 64 x
  80 (4 classes, 16 train, 8 test, top 2): both packages' own fits give
  the same top-2 set on every test image and the same error; the JAX
  package's fitted PCAs, GMMs and weighted model carried across
  (``convert.imagenet_pipeline``) give exactly the JAX top-2 lists, and
  each branch's Fisher-vector features within 2e-3 of its largest: the
  moment form of the FV cancels on uncentered PCA'd descriptors, so two
  float32 summation orders give FVs about 2e-3 of the largest apart
  (ROADMAP C6; read here up to 1.0e-4 on SIFT and 1.2e-3 on LCS, whose
  descriptors are local means in [0, 255]).
* The CSV preload path: the port's fitted PCAs (``save_pca_csv``) and
  GMMs (``GaussianMixtureModel.save``) for both branches wired into the
  config: no estimator fits, and the same predictions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.loaders.image_loader_utils import LabeledImage as JLI
from keystone_tpu.nodes.images import core as jcore
from keystone_tpu.nodes.images import extractors as jext
from keystone_tpu.nodes.images import fisher_vector as jfv
from keystone_tpu.nodes.learning.linear import BlockLinearMapper as JBLM
from keystone_tpu.nodes.learning.pca import BatchPCATransformer as JPCA
from keystone_tpu.nodes.stats import BatchSignedHellingerMapper as JBHell
from keystone_tpu.nodes.stats import NormalizeRows as JNorm
from keystone_tpu.nodes.stats import SignedHellingerMapper as JHell
from keystone_tpu.nodes.util import FloatToDouble as JF2D
from keystone_tpu.nodes.util import MatrixVectorizer as JVec
from keystone_tpu.nodes.util import TopKClassifier as JTopK
from keystone_tpu.parallel.dataset import HostDataset as JHost
from keystone_tpu.parallel.dataset import to_numpy as jto_numpy
from keystone_tpu.pipelines.images.imagenet import sift_lcs_fv as jin
from keystone_tpu.workflow.env import PipelineEnv as JEnv
from keystone_tpu.workflow.expression import TransformerExpression
from keystone_tpu_torch import convert
from keystone_tpu_torch.loaders.imagenet import (
    NUM_CLASSES,
    parse_imagenet_labels,
)
from keystone_tpu_torch.loaders.surrogate import make_surrogate_imagenet
from keystone_tpu_torch.nodes.images.extractors import LCSExtractor, _lcs
from keystone_tpu_torch.nodes.images.fisher_vector import FisherVector
from keystone_tpu_torch.nodes.learning.pca import BatchPCATransformer
from keystone_tpu_torch.nodes.util import TopKClassifier
from keystone_tpu_torch.parallel.dataset import HostDataset
from keystone_tpu_torch.pipelines.images.imagenet import sift_lcs_fv as tin
from keystone_tpu_torch.utils.checkpoint import save_pca_csv
from keystone_tpu_torch.workflow.env import PipelineEnv

CONFIG = dict(lam=1e-3, mixture_weight=0.25, desc_dim=8, vocab_size=2,
              lcs_stride=12, lcs_border=20, num_pca_samples=400,
              num_gmm_samples=400, block_size=128)
SIFT = dict(step=12, num_scales=2)
CLASSES, TOP_K = 4, 2
FV_TOL = 2e-3


# -- LCS ------------------------------------------------------------------

def _lcs_image(H, W, scale, seed):
    img = np.random.RandomState(seed).rand(H, W, 3).astype(np.float32)
    img[5:25, 8:40] = 0.5                  # flat: the variance cancels
    return img * scale


@pytest.mark.parametrize("scale", [1.0, 255.0])
@pytest.mark.parametrize("H,W,args", [
    (64, 80, (4, 16, 6)),       # the app's stride, border and sub-patch
    (57, 71, (5, 12, 4)),       # a ragged grid: neither side divides
])
def test_lcs_matches_jax(H, W, args, scale):
    img = _lcs_image(H, W, scale, seed=H + W)
    want = np.asarray(jext._lcs(jnp.asarray(img), *args))
    got = LCSExtractor(*args).apply(torch.as_tensor(img)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    n_x = len(range(args[1], H - args[1], args[0]))
    n_y = len(range(args[1], W - args[1], args[0]))
    assert got.shape == (3 * 16 * 2, n_x * n_y)
    means, stds = (got[0::2], want[0::2]), (got[1::2], want[1::2])
    assert np.abs(means[0] - means[1]).max() <= 1e-5 * scale
    assert np.abs(stds[0] - stds[1]).max() <= scale * 2.0 ** -10
    assert (stds[0] >= 0).all()
    # the flat square gives zero standard deviations in both
    assert (stds[1] == 0).any()


def test_lcs_takes_integer_images():
    img = (np.random.RandomState(1).rand(48, 56, 3) * 255).astype(np.uint8)
    got = _lcs(torch.as_tensor(img), 4, 16, 6)
    want = _lcs(torch.as_tensor(img.astype(np.float32)), 4, 16, 6)
    assert torch.equal(got, want)


# -- TopKClassifier ---------------------------------------------------------

def test_top_k_matches_jax_with_ties():
    rng = np.random.RandomState(0)
    X = np.round(rng.rand(64, 12) * 4).astype(np.float32)   # many ties
    X[3] = 1.0                                               # all tied
    X[5, [2, 7, 9]] = 9.0
    for k in (1, 3, 5, 12):
        _, want = jax.lax.top_k(jnp.asarray(X), k)
        got = TopKClassifier(k).apply_batch(torch.as_tensor(X))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        one = TopKClassifier(k).apply(torch.as_tensor(X[5]))
        np.testing.assert_array_equal(one.numpy(), np.asarray(want)[5])
        jone = JTopK(k).apply(jnp.asarray(X[5]))
        np.testing.assert_array_equal(one.numpy(), np.asarray(jone))


# -- the pipeline -----------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    return make_surrogate_imagenet(16, 8, seed=0, num_classes=CLASSES, h=64,
                                   w=80)


def _jax(ds):
    return JHost([JLI(np.asarray(it.image, np.float32), it.label,
                      it.filename) for it in ds.collect()])


def _mentions(prefix, cls):
    if prefix is cls:
        return True
    return isinstance(prefix, tuple) and any(_mentions(p, cls)
                                             for p in prefix)


def _jax_fitted():
    """(sift (pca_mat, gmm), lcs (pca_mat, gmm), weighted model) from the
    JAX package's prefix memo after its fit: each PCA's branch told by
    its input width (128 SIFT, 96 LCS), each GMM's by the extractor
    class in its prefix."""
    found = {}
    for prefix, expr in JEnv.get_or_create().state.items():
        if not (isinstance(expr, TransformerExpression) and expr.computed):
            continue
        node = expr.get()
        branch = ("lcs" if _mentions(prefix, jext.LCSExtractor) else "sift")
        if isinstance(node, JPCA):
            pca_mat = np.asarray(node.pca_mat)
            found[("sift" if pca_mat.shape[0] == 128 else "lcs", "pca")] = \
                pca_mat
        elif isinstance(node, jfv.FisherVector):
            found[(branch, "gmm")] = node.gmm
        elif isinstance(node, JBLM):
            found["model"] = node
    return ((found[("sift", "pca")], found[("sift", "gmm")]),
            (found[("lcs", "pca")], found[("lcs", "gmm")]), found["model"])


def _port_fitted(fitted):
    """{"sift": (pca, fv), "lcs": (pca, fv)} of the port's fitted
    pipeline: each FisherVector node with the PCA node it reads."""
    g = fitted._graph
    out = {}
    for n in g.operators:
        op = g.get_operator(n)
        if isinstance(op, FisherVector):
            (dep,) = g.get_dependencies(n)
            pca = g.get_operator(dep)
            assert isinstance(pca, BatchPCATransformer)
            out["sift" if pca.pca_mat.shape[0] == 128 else "lcs"] = (pca, op)
    return out


@pytest.fixture(scope="module")
def runs(data):
    train, test = data
    JEnv.get_or_create().clear_state()
    jpred, jerr = jin.run(jin.ImageNetSiftLcsFVConfig(**CONFIG),
                          train=_jax(train), test=_jax(test),
                          num_classes=CLASSES, top_k=TOP_K, sift_kwargs=SIFT)
    jfit = _jax_fitted()     # before any other apply adds memo entries
    jtop = jto_numpy(jpred(JHost([it.image for it in _jax(test).collect()])))
    PipelineEnv.reset()
    tpred, terr = tin.run(tin.ImageNetSiftLcsFVConfig(**CONFIG), train=train,
                          test=test, num_classes=CLASSES, top_k=TOP_K,
                          sift_kwargs=SIFT, device="cpu")
    ttop = tpred(tin.images_on(test, "cpu")).get()
    ttop = np.stack([t.numpy() for t in ttop.collect()])
    return jerr, jtop, jfit, tpred, terr, ttop


def test_pipeline_matches_jax(runs, data):
    jerr, jtop, _, _, terr, ttop = runs
    _, test = data
    assert ttop.shape == jtop.shape == (8, TOP_K)
    assert ttop.dtype == np.int32
    for a, b in zip(ttop, jtop):
        assert set(a.tolist()) == set(b.tolist()), (ttop, jtop)
    assert terr == pytest.approx(jerr)
    labels = np.array([it.label for it in test.collect()])
    # the surrogate's class signal: every test image's class in the top 2
    assert terr == 0.0 and np.all((ttop == labels[:, None]).any(axis=1))


def _featurizers(sift, lcs):
    """(JAX, port) gathered and combined featurizers with the given
    branch params."""
    from keystone_tpu.nodes.util import VectorCombiner as JCombiner
    from keystone_tpu.workflow.pipeline import Pipeline as JPipeline
    from keystone_tpu_torch.nodes.images.core import GrayScaler, PixelScaler
    from keystone_tpu_torch.nodes.images.extractors import SIFTExtractor
    from keystone_tpu_torch.nodes.stats import (
        BatchSignedHellingerMapper,
        NormalizeRows,
        SignedHellingerMapper,
    )
    from keystone_tpu_torch.nodes.util import (
        FloatToDouble,
        MatrixVectorizer,
        VectorCombiner,
    )
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    def jbranch(prefix, pca_mat, gmm):
        return (prefix >> JPCA(pca_mat) >> jfv.FisherVector(gmm) >> JF2D()
                >> JVec() >> JNorm() >> JHell() >> JNorm())

    def tbranch(prefix, pca_mat, gmm):
        return (prefix >> convert.pca_transformer(pca_mat)
                >> convert.fisher_vector(gmm.means, gmm.variances,
                                         gmm.weights, gmm.weight_threshold)
                >> FloatToDouble() >> MatrixVectorizer() >> NormalizeRows()
                >> SignedHellingerMapper() >> NormalizeRows())

    jfeat = JPipeline.gather([
        jbranch(jcore.PixelScaler() >> jcore.GrayScaler()
                >> jext.SIFTExtractor(scale_step=1, **SIFT) >> JBHell(),
                *sift),
        jbranch(jext.LCSExtractor(12, 20, 6).to_pipeline(), *lcs),
    ]) >> JCombiner()
    tfeat = Pipeline.gather([
        tbranch(PixelScaler() >> GrayScaler()
                >> SIFTExtractor(scale_step=1, **SIFT)
                >> BatchSignedHellingerMapper(), *sift),
        tbranch(LCSExtractor(12, 20, 6).to_pipeline(), *lcs),
    ]) >> VectorCombiner()
    return jfeat, tfeat


def test_carried_jax_model_gives_the_jax_top_k(runs, data):
    _, jtop, (sift, lcs, model), _, _, _ = runs
    _, test = data
    fitted = convert.imagenet_pipeline(
        sift, lcs, model, tin.ImageNetSiftLcsFVConfig(**CONFIG),
        top_k=TOP_K, sift_kwargs=SIFT, device="cpu")
    got = np.stack([t.numpy() for t in fitted(
        tin.images_on(test, "cpu")).get().collect()])
    np.testing.assert_array_equal(got, jtop)
    one = fitted.apply_datum(torch.as_tensor(test.collect()[0].image),
                             device="cpu").get().numpy()
    np.testing.assert_array_equal(one, jtop[0])


def test_carried_branches_give_the_same_fisher_vectors(runs, data):
    _, _, (sift, lcs, _), _, _, _ = runs
    _, test = data
    jfeat, tfeat = _featurizers(sift, lcs)
    for it in test.collect()[:4]:
        want = np.asarray(jfeat.apply_datum(
            np.asarray(it.image, np.float32)).get())
        got = tfeat.apply_datum(torch.as_tensor(it.image),
                                device="cpu").get().numpy()
        assert got.shape == want.shape == (2 * 2 * 8 * 2,)
        w = 2 * 8 * 2                     # each branch's 2 D K features
        for lo in (0, w):
            g, j = got[lo:lo + w], want[lo:lo + w]
            assert np.abs(g - j).max() <= FV_TOL * np.abs(j).max(), lo


def test_csv_preload_skips_every_fit(runs, data, tmp_path, monkeypatch):
    _, _, _, tpred, _, ttop = runs
    train, test = data
    fitted = _port_fitted(tpred)
    files = {}
    for branch, (pca, fv) in fitted.items():
        files[f"{branch}_pca_file"] = str(tmp_path / f"{branch}_pca.csv")
        save_pca_csv(pca.pca_mat, files[f"{branch}_pca_file"])
        names = [str(tmp_path / f"{branch}_{p}.csv")
                 for p in ("mean", "var", "wts")]
        fv.gmm.save(*names)
        for key, name in zip(("mean", "var", "wts"), names):
            files[f"{branch}_gmm_{key}_file"] = name

    def no_fit(self, *a, **k):
        raise AssertionError("estimator fit despite preloaded artifacts")

    monkeypatch.setattr(tin.ColumnPCAEstimator, "fit_datasets", no_fit)
    monkeypatch.setattr(tin.GMMFisherVectorEstimator, "fit_datasets", no_fit)
    PipelineEnv.reset()
    pred, err = tin.run(tin.ImageNetSiftLcsFVConfig(**CONFIG, **files),
                        train=train, test=test, num_classes=CLASSES,
                        top_k=TOP_K, sift_kwargs=SIFT, device="cpu")
    top = np.stack([t.numpy() for t in pred(
        tin.images_on(test, "cpu")).get().collect()])
    np.testing.assert_array_equal(top, ttop)


def test_gmm_preload_needs_all_three_files(data):
    train, _ = data
    with pytest.raises(ValueError, match="all three files"):
        tin.compute_pca_fisher_branch(
            LCSExtractor().to_pipeline(), HostDataset([]),
            tin.ImageNetSiftLcsFVConfig(), 1, 1, gmm_mean_file="m.csv")


def test_run_needs_the_datasets(tmp_path):
    """Without datasets, ``run`` reads the config's tar archives: a
    location that does not exist raises."""
    missing = str(tmp_path / "missing")
    labels = tmp_path / "labels.txt"
    labels.write_text("n00000 0\n")
    with pytest.raises(FileNotFoundError, match="missing"):
        tin.run(tin.ImageNetSiftLcsFVConfig(missing, missing, str(labels)),
                device="cpu")


def test_config_defaults_are_the_reference_ones():
    want = jin.ImageNetSiftLcsFVConfig()
    got = tin.ImageNetSiftLcsFVConfig()
    assert got.__dict__ == want.__dict__


def test_surrogate_imagenet_is_balanced_seeded_uint8():
    tr, te = make_surrogate_imagenet(30, 10, seed=3, num_classes=7, h=32,
                                     w=40)
    tr2, _ = make_surrogate_imagenet(30, 10, seed=3, num_classes=7, h=32,
                                     w=40)
    items = tr.collect()
    assert len(items) == 30 and len(te) == 10
    assert all(it.image.dtype == np.uint8 and it.image.shape == (32, 40, 3)
               for it in items)
    counts = np.bincount([it.label for it in items], minlength=7)
    assert counts.min() == 4 and counts.max() == 5
    for a, b in zip(items, tr2.collect()):
        assert a.label == b.label and np.array_equal(a.image, b.image)
    # the class color shows in the image means
    mean = {}
    for it in items:
        mean.setdefault(it.label, []).append(it.image.mean((0, 1)))
    spread = max(np.ptp(np.stack(v), axis=0).max() for v in mean.values())
    assert spread < 40


def test_imagenet_labels(tmp_path):
    path = tmp_path / "labels.txt"
    path.write_text("n01440764 0\nn01443537 1\n\nbad\n")
    assert parse_imagenet_labels(str(path)) == {"n01440764": 0,
                                                "n01443537": 1}
    assert NUM_CLASSES == 1000
