"""ImageNetSiftLcsFV.

Counterpart of ``keystone_tpu/pipelines/images/imagenet/sift_lcs_fv.py``
(reference ``pipelines/images/imagenet/ImageNetSiftLcsFV.scala:29-228``):
two feature branches, SIFT (PixelScaler -> GrayScaler -> SIFT ->
BatchSignedHellinger) and LCS, each followed by ColumnSampler ->
ColumnPCA -> GMM Fisher vector -> FloatToDouble -> MatrixVectorizer ->
NormalizeRows -> SignedHellinger -> NormalizeRows; gathered, combined,
solved with BlockWeightedLeastSquares(4096, 1, lambda = 6e-5,
mixtureWeight = 0.25) and evaluated by top-5 error over 1000 classes.

On the card every SIFT band contraction runs in ``banded_matmul`` (10
launches an image at 5 scales) and every Fisher vector, of either
branch, in ``fv_moments``. ``run`` reads the train and test images
from the ImageNet tar archives and the labels file its config names
(``loaders.imagenet``) unless the caller passes HostDatasets of
``LabeledImage``; ``main`` is ``python -m keystone_tpu_torch
imagenet.sift_lcs_fv``.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ....loaders.imagenet import NUM_CLASSES, imagenet_loader
from ....nodes.images.core import GrayScaler, PixelScaler
from ....nodes.images.extractors import LCSExtractor, SIFTExtractor
from ....nodes.images.fisher_vector import (
    FisherVector,
    GMMFisherVectorEstimator,
)
from ....nodes.learning.block_weighted import (
    BlockWeightedLeastSquaresEstimator,
)
from ....nodes.learning.gmm import GaussianMixtureModel
from ....nodes.learning.pca import BatchPCATransformer, ColumnPCAEstimator
from ....nodes.stats import (
    BatchSignedHellingerMapper,
    NormalizeRows,
    SignedHellingerMapper,
)
from ....nodes.stats.sampling import ColumnSampler
from ....nodes.util import (
    ClassLabelIndicatorsFromIntLabels,
    FloatToDouble,
    MatrixVectorizer,
    TopKClassifier,
    VectorCombiner,
)
from ....ops.device import DEFAULT_DEVICE, resolve_device
from ....parallel.dataset import ArrayDataset, Dataset, HostDataset, to_numpy
from ....workflow.common import Cacher
from ....workflow.pipeline import Pipeline


@dataclass
class ImageNetSiftLcsFVConfig:
    train_location: str = ""
    test_location: str = ""
    label_path: str = ""
    lam: float = 6e-5
    mixture_weight: float = 0.25
    desc_dim: int = 64
    vocab_size: int = 16
    sift_scale_step: int = 1
    lcs_stride: int = 4
    lcs_border: int = 16
    lcs_patch: int = 6
    num_pca_samples: int = 10_000_000
    num_gmm_samples: int = 10_000_000
    block_size: int = 4096
    # Precomputed-artifact loading (reference ImageNetSiftLcsFV.scala:
    # 46-70): when set, the branch takes the loaded projection / GMM in
    # place of its estimator and does not refit it.
    sift_pca_file: Optional[str] = None
    sift_gmm_mean_file: Optional[str] = None
    sift_gmm_var_file: Optional[str] = None
    sift_gmm_wts_file: Optional[str] = None
    lcs_pca_file: Optional[str] = None
    lcs_gmm_mean_file: Optional[str] = None
    lcs_gmm_var_file: Optional[str] = None
    lcs_gmm_wts_file: Optional[str] = None


def compute_pca_fisher_branch(prefix: Pipeline, training_data: Dataset,
                              config: ImageNetSiftLcsFVConfig,
                              pca_samples: int, gmm_samples: int,
                              pca_file: Optional[str] = None,
                              gmm_mean_file: Optional[str] = None,
                              gmm_var_file: Optional[str] = None,
                              gmm_wts_file: Optional[str] = None) -> Pipeline:
    """The per-branch suffix (reference ``ImageNetSiftLcsFV.scala:29-80``):
    PCA then GMM Fisher vector, each fitted on sampled columns or loaded
    from CSV files (``utils.checkpoint.save_pca_csv`` writes the PCA
    file, the (k, d) projection transposed on load;
    ``GaussianMixtureModel.save`` the GMM's (d, k) means and variances
    and k weights), then the normalizations."""
    gmm_files = (gmm_mean_file, gmm_var_file, gmm_wts_file)
    if any(f is not None for f in gmm_files) and None in gmm_files:
        raise ValueError(
            "GMM preload needs all three files (mean, var, wts); got "
            f"mean={gmm_mean_file!r} var={gmm_var_file!r} wts={gmm_wts_file!r}")
    if pca_file is not None:
        pca_branch = prefix >> BatchPCATransformer(
            np.loadtxt(pca_file, delimiter=",", ndmin=2).T)
    else:
        pca_sample = (prefix >> ColumnSampler(pca_samples) >> Cacher())(
            training_data)
        pca_branch = prefix.and_then(
            ColumnPCAEstimator(config.desc_dim).with_data(pca_sample))

    if gmm_mean_file is not None:
        fisher = pca_branch >> FisherVector(GaussianMixtureModel.load(
            gmm_mean_file, gmm_var_file, gmm_wts_file))
    else:
        gmm_sample = (pca_branch >> ColumnSampler(gmm_samples))(training_data)
        fisher = pca_branch.and_then(
            GMMFisherVectorEstimator(config.vocab_size).with_data(gmm_sample))
    return fisher >> FloatToDouble() >> MatrixVectorizer() >> NormalizeRows() \
        >> SignedHellingerMapper() >> NormalizeRows()


def build_pipeline(config: ImageNetSiftLcsFVConfig, training_data: Dataset,
                   training_labels, top_k: int = 5,
                   sift_kwargs: Optional[dict] = None) -> Pipeline:
    """The unfitted predictor: images (a HostDataset of (H, W, 3) tensors
    in [0, 255], any real or integer type) -> the indices of the
    ``top_k`` highest class scores; its PCAs and GMMs fitted on column
    samples of ``training_data`` (or loaded from the config's files), its
    solver on ``training_data`` and ``training_labels`` (+-1
    indicators)."""
    n_train = max(len(training_data), 1)
    pca_per_img = max(config.num_pca_samples // n_train, 1)
    gmm_per_img = max(config.num_gmm_samples // n_train, 1)

    sift_prefix = (
        PixelScaler() >> GrayScaler()
        >> SIFTExtractor(scale_step=config.sift_scale_step,
                         **(sift_kwargs or {}))
        >> BatchSignedHellingerMapper()
    )
    lcs_prefix = Pipeline.identity() >> LCSExtractor(
        config.lcs_stride, config.lcs_border, config.lcs_patch)

    sift_branch = compute_pca_fisher_branch(
        sift_prefix, training_data, config, pca_per_img, gmm_per_img,
        config.sift_pca_file, config.sift_gmm_mean_file,
        config.sift_gmm_var_file, config.sift_gmm_wts_file)
    lcs_branch = compute_pca_fisher_branch(
        lcs_prefix, training_data, config, pca_per_img, gmm_per_img,
        config.lcs_pca_file, config.lcs_gmm_mean_file,
        config.lcs_gmm_var_file, config.lcs_gmm_wts_file)

    featurizer = Pipeline.gather([sift_branch, lcs_branch]) \
        >> VectorCombiner() >> Cacher()
    return featurizer.and_then(
        BlockWeightedLeastSquaresEstimator(
            config.block_size, 1, config.lam, config.mixture_weight),
        training_data, training_labels,
    ) >> TopKClassifier(top_k)


def images_on(ds: Dataset, device) -> HostDataset:
    """The images of a dataset of LabeledImage as tensors on ``device``,
    in their own type (uint8 images stay uint8: a quarter of the
    memory; the branches' first nodes widen them)."""
    return HostDataset([torch.as_tensor(np.asarray(it.image), device=device)
                        for it in ds.collect()])


def run(config: ImageNetSiftLcsFVConfig, train: Optional[Dataset] = None,
        test: Optional[Dataset] = None, num_classes: int = NUM_CLASSES,
        top_k: int = 5, sift_kwargs: Optional[dict] = None,
        device=DEFAULT_DEVICE):
    """Fit on ``train`` and evaluate on ``test`` (HostDatasets of
    LabeledImage, read from the config's tar archives and labels file
    when not given), the images staged on ``device``. Returns the fitted
    predictor and the test top-k error in percent."""
    dev = resolve_device(device)
    start = time.time()
    if train is None:
        train = imagenet_loader(config.train_location, config.label_path)
    if test is None:
        test = imagenet_loader(config.test_location, config.label_path)
    train_labels = np.asarray([it.label for it in train.collect()], np.int64)
    labels = ClassLabelIndicatorsFromIntLabels(num_classes).apply_dataset(
        ArrayDataset.from_numpy(train_labels, dev))
    predictor = build_pipeline(config, images_on(train, dev), labels, top_k,
                               sift_kwargs).fit()

    test_labels = np.asarray([it.label for it in test.collect()], np.int64)
    topk = to_numpy(predictor(images_on(test, dev)))
    hits = np.any(topk == test_labels[:, None], axis=1)
    err = 100.0 * (1.0 - hits.mean())
    print(f"TEST top-{top_k} error is {err:.2f}%")
    print(f"Pipeline took {time.time() - start:.1f} s")
    return predictor, err


def main(argv=None):
    p = argparse.ArgumentParser("ImageNetSiftLcsFV")
    p.add_argument("--trainLocation", required=True)
    p.add_argument("--testLocation", required=True)
    p.add_argument("--labelPath", required=True)
    p.add_argument("--lambda", dest="lam", type=float, default=6e-5)
    p.add_argument("--mixtureWeight", type=float, default=0.25)
    p.add_argument("--descDim", type=int, default=64)
    p.add_argument("--vocabSize", type=int, default=16)
    for flag in ("siftPcaFile", "siftGmmMeanFile", "siftGmmVarFile",
                 "siftGmmWtsFile", "lcsPcaFile", "lcsGmmMeanFile",
                 "lcsGmmVarFile", "lcsGmmWtsFile"):
        p.add_argument("--" + flag, default=None)
    p.add_argument("--device", default=DEFAULT_DEVICE)
    a = p.parse_args(argv)
    run(ImageNetSiftLcsFVConfig(
        a.trainLocation, a.testLocation, a.labelPath, a.lam,
        a.mixtureWeight, a.descDim, a.vocabSize,
        sift_pca_file=a.siftPcaFile, sift_gmm_mean_file=a.siftGmmMeanFile,
        sift_gmm_var_file=a.siftGmmVarFile, sift_gmm_wts_file=a.siftGmmWtsFile,
        lcs_pca_file=a.lcsPcaFile, lcs_gmm_mean_file=a.lcsGmmMeanFile,
        lcs_gmm_var_file=a.lcsGmmVarFile, lcs_gmm_wts_file=a.lcsGmmWtsFile),
        device=a.device)


if __name__ == "__main__":
    main()
