"""Linear model over sparse inputs.

Counterpart of ``SparseLinearMapper`` in
``keystone_tpu/nodes/learning/classifiers.py`` (reference
``SparseLinearMapper.scala:22-48``), the model the sparse L-BFGS solver
fits. The rest of that module (naive Bayes, logistic regression, SVMs)
comes with the text pipelines.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...ops.device import resolve_device
from ...parallel.dataset import ArrayDataset, Dataset
from ...workflow.operators import tensor_token
from ...workflow.transformer import Transformer
from ..util.sparse import SparseVector, is_sparse_host, sparse_batch


def _host(v):
    return v.cpu() if isinstance(v, torch.Tensor) else v


class SparseLinearMapper(Transformer):
    """out = x W (+ b) for a SparseVector or a dense x. A SparseVector
    gathers its active weight rows; a batch of SparseVectors packs to
    padded COO (``sparse_batch``) and is one gather and one contraction
    on the weights' device; a dense batch is one GEMM on its own."""

    fusable = False

    def __init__(self, weights, intercept: Optional[np.ndarray] = None):
        self.weights = weights
        self.intercept = intercept

    def eq_key(self):
        return (SparseLinearMapper, tensor_token(self.weights),
                tensor_token(self.intercept))

    def _device(self) -> torch.device:
        if isinstance(self.weights, torch.Tensor):
            return self.weights.device
        return resolve_device()

    def apply_params(self, device):
        def build(d):
            W = torch.as_tensor(self.weights, dtype=torch.float32, device=d)
            b = (torch.zeros(W.shape[1], device=d) if self.intercept is None
                 else torch.as_tensor(self.intercept, dtype=torch.float32,
                                      device=d))
            return W, b
        return self._params_on(device, build)

    def _check_size(self, size: int) -> None:
        d = self.weights.shape[0]
        if size != d:
            raise ValueError(f"sparse input size {size} != model dim {d}")

    def apply(self, x):
        if isinstance(x, SparseVector):
            self._check_size(x.size)
            W, b = self.apply_params(self._device())
            idx = torch.as_tensor(x.indices.astype(np.int64), device=W.device)
            vals = torch.as_tensor(x.values, device=W.device)
            return vals @ W[idx] + b
        W, b = self.apply_params(x.device)
        return x @ W + b

    def apply_batch(self, X):
        W, b = self.apply_params(X.device)
        return X @ W + b

    def apply_dataset(self, ds: Dataset) -> Dataset:
        if is_sparse_host(ds):
            indices, values, size = sparse_batch(ds.items)
            self._check_size(size)
            W, b = self.apply_params(self._device())
            idx = torch.as_tensor(indices.astype(np.int64), device=W.device)
            vals = torch.as_tensor(values, device=W.device)
            out = torch.einsum("rs,rsk->rk", vals, W[idx]) + b
            return ArrayDataset(out, len(ds.items))
        return super().apply_dataset(ds)

    def __getstate__(self):
        # device tensors pickle as host copies
        d = super().__getstate__()
        d["weights"] = _host(d["weights"])
        d["intercept"] = _host(d["intercept"])
        return d
