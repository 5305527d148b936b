"""The TIMIT pipeline (``keystone_tpu_torch/pipelines/speech/timit.py``)
driven from the benchmark's inputs.

The benchmark makes the frames and labels from the seed
(``data/timit.py``). The featurizer, ``timit.build_featurizer(config)``
(the 50 random cosine branches and their concatenation, their weights
drawn on the host from ``TimitConfig.seed``, which the benchmark derives
from its seed), is built once in set-up, as the RandomPatchCifar cells'
filters are made once: its weights are the featurizer's parameters, not
the fit's work. The reference draws the same weights again from the
same recipe. A fit is what ``timit.build_pipeline`` composes on that
featurizer, fitted: ``featurizer.and_then(BlockLeastSquaresEstimator(
4096, 5, lam), frames, labels) >> MaxClassifier()``.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch
from torch.profiler import record_function

from perfbench.data import timit as data
from perfbench.reference import MODES, precision
from perfbench.reference import timit as ref
from perfbench.work.cosine import cosine_flops
from perfbench.work.solve import block_solve_flops, linear_apply_flops


#: the branches draw from RandomState(cosine_seed + i), which takes seeds
#: below 2**32
COSINE_SEEDS = 2 ** 32 - 1024


def prepare(cell, seed, device, train_sets):
    from keystone_tpu_torch.pipelines.speech import timit

    v = cell.values
    train, test = data.frames(seed, v["n_train"], v["n_test"], train_sets,
                              v["num_classes"], v["input_dim"], device)
    config = timit.TimitConfig(
        num_cosines=v["num_cosines"], gamma=v["gamma"], rf_type="gaussian",
        lam=v["lam"], num_epochs=v["num_epochs"],
        seed=int(seed) % COSINE_SEEDS,
        num_cosine_features=v["num_cosine_features"])
    return SimpleNamespace(v=v, device=device, train=train, test=test,
                           config=config, params=None, references={},
                           featurizer=timit.build_featurizer(
                               config, v["input_dim"]))


def train_rows(state):
    return state.v["n_train"]


def held_out(state):
    return state.test[0]


def fit(state, j, stream):
    from keystone_tpu_torch.nodes.learning import BlockLeastSquaresEstimator
    from keystone_tpu_torch.nodes.util import (
        ClassLabelIndicatorsFromIntLabels, MaxClassifier)
    from keystone_tpu_torch.parallel.dataset import ArrayDataset

    frames, labels = state.train[j]
    n = labels.shape[0]
    c = state.config
    with record_function("pipeline.build"):
        indicators = ClassLabelIndicatorsFromIntLabels(
            state.v["num_classes"])(ArrayDataset(labels, n))
        pipeline = state.featurizer.and_then(
            BlockLeastSquaresEstimator(c.num_cosine_features, c.num_epochs,
                                       c.lam),
            ArrayDataset(frames, n), indicators) >> MaxClassifier()
    with record_function("pipeline.fit"):
        return pipeline.fit()


def unit_work(state, kind, arg):
    v = state.v
    d = v["num_cosines"] * v["num_cosine_features"]
    k = v["num_classes"]
    n = arg if kind == "apply" else v["n_train"]
    flops = cosine_flops(n, v["input_dim"], d)
    if kind == "apply":
        return {"flops": flops + linear_apply_flops(n, d, k)}
    return {"flops": flops + block_solve_flops(
        n, d, v["num_cosine_features"], k, v["num_epochs"])}


def reference_scores(state, j, rows, mode):
    dtype, tf32 = MODES[mode]
    v = state.v
    if state.params is None:
        state.params = ref.cosine_params(
            state.config.seed, v["num_cosines"], v["num_cosine_features"],
            v["input_dim"], v["gamma"])
    key = (j, mode)
    with precision(tf32):
        if key not in state.references:
            frames, labels = state.train[j]
            state.references = {key: ref.fit(v, frames, labels,
                                             state.params, dtype)}
        return ref.scores(state.references[key], rows, state.params, dtype)
