"""VOCSIFTFisher.

Counterpart of ``keystone_tpu/pipelines/images/voc/voc_sift_fisher.py``
(reference ``pipelines/images/voc/VOCSIFTFisher.scala:29-159``):
PixelScaler -> GrayScaler -> SIFT -> [sampled ColumnPCA] -> [sampled GMM
Fisher vector] -> FloatToDouble -> MatrixVectorizer -> NormalizeRows ->
SignedHellinger -> NormalizeRows -> BlockLeastSquares(4096, 1, lambda) ->
mean average precision over the 20 VOC classes.

On the card every SIFT band contraction runs in ``banded_matmul`` (10
launches an image at 5 scales) and every Fisher vector in
``fv_moments`` (one launch an image, with the GMM's kernel terms cached
per device). ``run`` reads the train and test images from the VOC tar
archives and the labels CSV its config names (``loaders.voc``) unless
the caller passes HostDatasets of ``MultiLabeledImage``; ``main`` is
``python -m keystone_tpu_torch voc.sift_fisher``.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ....evaluation.mean_average_precision import (
    evaluate_mean_average_precision,
)
from ....loaders.voc import (
    NUM_CLASSES,
    VOCDataPath,
    VOCLabelPath,
    voc_loader,
)
from ....nodes.images.core import GrayScaler, PixelScaler
from ....nodes.images.extractors import SIFTExtractor
from ....nodes.images.fisher_vector import (
    FisherVector,
    GMMFisherVectorEstimator,
)
from ....nodes.images.multilabel import (
    MultiLabeledImageExtractor,
    MultiLabelExtractor,
)
from ....nodes.learning import BlockLeastSquaresEstimator
from ....nodes.learning.gmm import GaussianMixtureModel
from ....nodes.learning.pca import BatchPCATransformer, ColumnPCAEstimator
from ....nodes.stats import NormalizeRows, SignedHellingerMapper
from ....nodes.stats.sampling import ColumnSampler
from ....nodes.util import (
    ClassLabelIndicatorsFromIntArrayLabels,
    FloatToDouble,
    MatrixVectorizer,
)
from ....ops.device import DEFAULT_DEVICE, resolve_device
from ....parallel.dataset import Dataset
from ....workflow.common import Cacher


#: where the VOC 2007 tars keep their images
IMAGES_PREFIX = "VOCdevkit/VOC2007/JPEGImages/"


@dataclass
class SIFTFisherConfig:
    train_location: str = ""
    test_location: str = ""
    label_path: str = ""
    lam: float = 0.5
    desc_dim: int = 80
    vocab_size: int = 256
    scale_step: int = 0
    num_pca_samples: int = 1_000_000
    num_gmm_samples: int = 1_000_000
    block_size: int = 4096
    # Precomputed-artifact loading (reference VOCSIFTFisher.scala:50-76):
    # when set, the loaded projection / GMM replace their estimators and
    # the fit is skipped.
    pca_file: Optional[str] = None
    gmm_mean_file: Optional[str] = None
    gmm_var_file: Optional[str] = None
    gmm_wts_file: Optional[str] = None


def build_pipeline(config: SIFTFisherConfig, training_data: Dataset,
                   training_labels, sift_kwargs: Optional[dict] = None):
    """The unfitted predictor: images (a HostDataset of (H, W, 3) tensors
    in [0, 255]) -> (20,) class scores, its PCA and GMM fitted on column
    samples of ``training_data`` (or loaded from the config's CSV files)
    and its solver on ``training_data`` and ``training_labels``."""
    n_train = len(training_data)
    pca_samples_per_image = max(config.num_pca_samples // max(n_train, 1), 1)
    gmm_samples_per_image = max(config.num_gmm_samples // max(n_train, 1), 1)

    sift = SIFTExtractor(scale_step=config.scale_step,
                         **(sift_kwargs or {}))
    sift_extractor = PixelScaler() >> GrayScaler() >> Cacher() >> sift

    if config.pca_file is not None:
        pca_featurizer = sift_extractor >> BatchPCATransformer(
            np.loadtxt(config.pca_file, delimiter=",", ndmin=2).T) >> Cacher()
    else:
        pca_sample = (sift_extractor >> ColumnSampler(pca_samples_per_image))(
            training_data)
        pca_featurizer = sift_extractor.and_then(
            ColumnPCAEstimator(config.desc_dim).with_data(pca_sample)
        ) >> Cacher()

    if config.gmm_mean_file is not None:
        fisher = pca_featurizer >> FisherVector(GaussianMixtureModel.load(
            config.gmm_mean_file, config.gmm_var_file, config.gmm_wts_file))
    else:
        gmm_sample = (pca_featurizer >> ColumnSampler(
            gmm_samples_per_image))(training_data)
        fisher = pca_featurizer.and_then(
            GMMFisherVectorEstimator(config.vocab_size).with_data(gmm_sample))
    fisher_featurizer = fisher >> FloatToDouble() >> MatrixVectorizer() \
        >> NormalizeRows() >> SignedHellingerMapper() >> NormalizeRows() \
        >> Cacher()

    return fisher_featurizer.and_then(
        BlockLeastSquaresEstimator(config.block_size, 1, config.lam),
        training_data, training_labels)


def run(config: SIFTFisherConfig, train: Optional[Dataset] = None,
        test: Optional[Dataset] = None, sift_kwargs: Optional[dict] = None,
        device=DEFAULT_DEVICE):
    """Fit on ``train`` and evaluate on ``test`` (HostDatasets of
    MultiLabeledImage, read from the config's tar archives and labels CSV
    when not given), the images staged on ``device``. Returns the fitted
    pipeline and the per-class AP array."""
    dev = resolve_device(device)
    start = time.time()
    if train is None:
        train = voc_loader(VOCDataPath(config.train_location, IMAGES_PREFIX),
                           VOCLabelPath(config.label_path))
    if test is None:
        test = voc_loader(VOCDataPath(config.test_location, IMAGES_PREFIX),
                          VOCLabelPath(config.label_path))
    label_grabber = (
        MultiLabelExtractor(dev)
        >> ClassLabelIndicatorsFromIntArrayLabels(NUM_CLASSES)
        >> Cacher()
    )
    training_labels = label_grabber(train).get()
    training_data = MultiLabeledImageExtractor(dev).apply_dataset(train)
    fitted = build_pipeline(config, training_data, training_labels,
                            sift_kwargs).fit()

    test_data = MultiLabeledImageExtractor(dev).apply_dataset(test)
    test_actuals = [it.labels for it in test.collect()]
    predictions = fitted(test_data).get()
    ap = evaluate_mean_average_precision(test_actuals, predictions,
                                         NUM_CLASSES)
    print(f"TEST APs are: {','.join(str(a) for a in ap)}")
    print(f"TEST MAP is: {float(np.mean(ap))}")
    print(f"Pipeline took {time.time() - start:.1f} s")
    return fitted, ap


def main(argv=None):
    p = argparse.ArgumentParser("VOCSIFTFisher")
    p.add_argument("--trainLocation", required=True)
    p.add_argument("--testLocation", required=True)
    p.add_argument("--labelPath", required=True)
    p.add_argument("--lambda", dest="lam", type=float, default=0.5)
    p.add_argument("--descDim", type=int, default=80)
    p.add_argument("--vocabSize", type=int, default=256)
    p.add_argument("--scaleStep", type=int, default=0)
    p.add_argument("--numPcaSamples", type=int, default=1_000_000)
    p.add_argument("--numGmmSamples", type=int, default=1_000_000)
    for flag in ("pcaFile", "gmmMeanFile", "gmmVarFile", "gmmWtsFile"):
        p.add_argument("--" + flag, default=None)
    p.add_argument("--device", default=DEFAULT_DEVICE)
    a = p.parse_args(argv)
    run(SIFTFisherConfig(
        a.trainLocation, a.testLocation, a.labelPath, a.lam, a.descDim,
        a.vocabSize, a.scaleStep, a.numPcaSamples, a.numGmmSamples,
        pca_file=a.pcaFile, gmm_mean_file=a.gmmMeanFile,
        gmm_var_file=a.gmmVarFile, gmm_wts_file=a.gmmWtsFile),
        device=a.device)


if __name__ == "__main__":
    main()
