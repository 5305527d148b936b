"""RandomPatchCifar (``keystone_tpu_torch/pipelines/images/cifar/
random_patch_cifar.py``) driven from the benchmark's inputs.

The configuration's ``values`` give the sizes. The benchmark makes the
images, the labels, the filter bank and the whitener from the seed
(``data/cifar.py``) and hands them to ``random_patch_cifar.build_pipeline``
through the port's public ``ZCAWhitener``, so filter learning is not in
the window. A fit is ``build_pipeline(...).fit()`` on a resident
``ArrayDataset`` or a ``StreamingDataset`` over host memory; an apply is
``fitted.apply`` on a batch of held-out images.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch
from torch.profiler import record_function

from perfbench.data import cifar as data
from perfbench.reference import MODES, precision
from perfbench.reference import rpc_cifar as ref
from perfbench.work.featurize import featurize_work
from perfbench.work.solve import (block_solve_flops, gram_work,
                                  linear_apply_flops, scaler_flops)



def prepare(cell, seed, device, train_sets):
    from keystone_tpu_torch.nodes.learning.zca import ZCAWhitener
    from keystone_tpu_torch.pipelines.images.cifar import (
        random_patch_cifar as rpc)

    v = cell.values
    train, test = data.images(seed, v["n_train"], v["n_test"], train_sets,
                              device)
    bank, whitener, means = data.filters(
        seed, train[0][0], v["num_filters"], v["patch_size"],
        v["whitening_epsilon"], v["whitener_samples"])
    config = rpc.RandomCifarConfig(
        num_filters=v["num_filters"], whitening_epsilon=v["whitening_epsilon"],
        patch_size=v["patch_size"], patch_steps=v["patch_steps"],
        pool_size=v["pool_size"], pool_stride=v["pool_stride"],
        alpha=v["alpha"], lam=v["lam"])
    if "stream" in cell.traffic:
        train = [(x.cpu().numpy(), y) for x, y in train]
    return SimpleNamespace(v=v, device=device, train=train, test=test,
                           filters=bank, means=means, config=config,
                           whitener=ZCAWhitener(whitener, means),
                           references={})


def train_rows(state):
    return state.v["n_train"]


def held_out(state):
    return state.test[0]


def fit(state, j, stream):
    from keystone_tpu_torch.nodes.util import ClassLabelIndicatorsFromIntLabels
    from keystone_tpu_torch.parallel.dataset import ArrayDataset
    from keystone_tpu_torch.parallel.streaming import StreamingDataset
    from keystone_tpu_torch.pipelines.images.cifar import (
        random_patch_cifar as rpc)
    from keystone_tpu_torch.workflow.common import Cacher

    images, labels = state.train[j]
    n = labels.shape[0]
    label_ds = (ClassLabelIndicatorsFromIntLabels(state.v["num_classes"])
                >> Cacher("labels"))(ArrayDataset(labels, n))
    if stream is None:
        train = ArrayDataset(images, n)
    else:
        chunk = stream["chunk_rows"]
        budget = (stream["budget_chunks"] * chunk * images[0].size * 4
                  + (1 << 20))
        train = StreamingDataset.from_numpy(
            images, chunk, device=state.device,
            prefetch_depth=stream["prefetch_depth"], hbm_budget=budget)
    with record_function("pipeline.build"):
        pipeline = rpc.build_pipeline(state.filters, state.whitener,
                                      state.config, train, label_ds)
    with record_function("pipeline.fit"):
        return pipeline.fit()


def features(v):
    side = (v["image_size"] - v["patch_size"]) // v["patch_steps"] + 1
    regions = len(range(v["pool_size"] // 2, side, v["pool_stride"])) ** 2
    return regions * 2 * v["num_filters"]


def _featurize(v, B):
    return featurize_work(B, v["num_filters"], v["image_size"], v["channels"],
                          v["patch_size"], v["pool_stride"], v["pool_size"])


def unit_work(state, kind, arg):
    """Counted work of one fit (``arg`` its stream or None) or one apply
    call (``arg`` its rows): ``flops`` of the whole unit, and the
    operations and bytes of what its kernels' rooflines count."""
    v = state.v
    d, k = features(v), v["num_classes"]
    if kind == "apply":
        feat = _featurize(v, arg)
        return {"flops": feat[0] + linear_apply_flops(arg, d, k),
                "featurize": feat}
    n = v["n_train"]
    feat = _featurize(v, n)
    out = {"flops": feat[0] + scaler_flops(n, d)
           + block_solve_flops(n, d, v["block_size"], k, v["num_iter"]),
           "featurize": feat}
    if arg is not None:
        chunk = arg["chunk_rows"]
        launches = [gram_work(min(chunk, n - lo), d, k)
                    for lo in range(0, n, chunk)]
        out["gram"] = (sum(o for o, _ in launches),
                       sum(b for _, b in launches))
    return out


def reference_scores(state, j, rows, mode):
    """The plain reference's scores of ``rows`` after its fit on
    training set ``j``, in ``mode`` (``float64``; ``float32``; ``tf32``,
    float32 with TF32 on, the control)."""
    dtype, tf32 = MODES[mode]
    dev = rows.device
    filters = torch.as_tensor(state.filters, device=dev)
    means = torch.as_tensor(state.means, device=dev)
    key = (j, mode)
    with precision(tf32):
        if key not in state.references:
            images, labels = state.train[j]
            images = torch.as_tensor(images, device=dev)
            state.references = {key: ref.fit(state.v, images, labels.to(dev),
                                             filters, means, dtype)}
            del images
        return ref.scores(state.v, state.references[key], rows, filters,
                          means, dtype)
