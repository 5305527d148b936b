"""Surrogate TIMIT frames.

A frozen, vectorised copy of
``keystone_tpu_torch/loaders/surrogate.py::make_surrogate_timit`` (itself
``bench.py::timit_bench``'s): 147 class prototypes of 440 standard
normal values, each frame its class's prototype plus 4.0 N(0, 1) noise,
so the classes overlap and the test error cannot reach 0. Drawn in
torch on the device from the run's seed.
"""
from __future__ import annotations

import torch

from . import generator

STREAM_PROTOS, STREAM_TEST, STREAM_TRAIN0 = 0, 1, 16


def frames(seed: int, n_train: int, n_test: int, train_sets: int,
           num_classes: int, dim: int, device):
    """``train_sets`` training sets of ``n_train`` frames and a test set
    of ``n_test``: a list of ``(frames, labels)`` and one pair, float32
    (n, dim) and int32 (n,) on ``device``."""
    protos = torch.randn((num_classes, dim),
                         generator=generator(seed, STREAM_PROTOS, device),
                         device=device)

    def split(n, stream):
        g = generator(seed, stream, device)
        y = torch.randint(0, num_classes, (n,), generator=g, device=device)
        noise = torch.randn((n, dim), generator=g, device=device)
        return (protos[y] + 4.0 * noise).contiguous(), y.to(torch.int32)

    train = [split(n_train, STREAM_TRAIN0 + j) for j in range(train_sets)]
    return train, split(n_test, STREAM_TEST)
