"""Utility nodes (reference ``nodes/util``).

Counterpart of ``keystone_tpu/nodes/util/__init__.py``: the label,
classifier, combiner, splitting, casting and densifying nodes, the
label augmenter of the augmented CIFAR app, and (from ``sparse.py``)
the sparse vectors and text vectorizers.
"""
from __future__ import annotations

import numpy as np
import torch

from ...ops.device import resolve_device
from ...parallel.dataset import (
    ArrayDataset,
    Dataset,
    HostDataset,
    is_streaming,
    tree_map,
)
from ...workflow.transformer import Transformer


class ClassLabelIndicatorsFromIntLabels(Transformer):
    """int label -> +-1 one-hot vector
    (reference ``util/ClassLabelIndicators.scala:15-34``)."""

    def __init__(self, num_classes: int):
        assert num_classes > 1, "numClasses must be > 1"
        self.num_classes = num_classes

    def apply_batch(self, labels):
        idx = torch.arange(self.num_classes, device=labels.device)
        hit = idx == labels.reshape(labels.shape + (1,))
        return torch.where(hit, 1.0, -1.0).to(torch.float32)

    def apply(self, label):
        return self.apply_batch(label)


class ClassLabelIndicatorsFromIntArrayLabels(Transformer):
    """multi-label int array -> +-1 multi-hot vector
    (reference ``util/ClassLabelIndicators.scala:41-55``). Inputs are
    fixed-width label arrays padded with -1 for missing entries."""

    def __init__(self, num_classes: int):
        assert num_classes > 1, "numClasses must be > 1"
        self.num_classes = num_classes

    def apply_batch(self, labels):
        idx = torch.arange(self.num_classes, device=labels.device)
        hits = (labels[..., :, None] == idx).any(dim=-2)
        return torch.where(hits, 1.0, -1.0).to(torch.float32)

    def apply(self, labels):
        return self.apply_batch(labels)


class VectorCombiner(Transformer):
    """Concatenate a gathered tuple of vectors into one vector
    (reference ``util/VectorCombiner.scala:12-14``)."""

    def apply(self, xs):
        return torch.cat(list(xs), dim=-1)

    def apply_batch(self, Xs):
        return self.apply(Xs)


class MaxClassifier(Transformer):
    """argmax (reference ``util/MaxClassifier.scala:9-11``)."""

    def apply(self, x):
        return torch.argmax(x, dim=-1).to(torch.int32)

    def apply_batch(self, X):
        return self.apply(X)


class TopKClassifier(Transformer):
    """Indices of the k largest values, descending (reference
    ``util/TopKClassifier.scala:9-11``). Equal values come lower index
    first, as ``jax.lax.top_k`` orders them: a stable descending sort
    keeps the input order among ties on every device (``torch.topk``
    promises no order there), so classes that got identical scores (no
    training rows) are ranked the same way in both packages."""

    def __init__(self, k: int):
        self.k = k

    def apply_batch(self, X):
        idx = torch.sort(X, dim=-1, descending=True, stable=True).indices
        return idx[..., : self.k].to(torch.int32)

    def apply(self, x):
        return self.apply_batch(x)


class VectorSplitter(Transformer):
    """Split the feature dimension into blocks of ``block_size``
    (reference ``util/VectorSplitter.scala:11-36``): a tuple of views,
    the last block ragged."""

    def __init__(self, block_size: int, num_features: int = None):
        self.block_size = block_size
        self.num_features = num_features

    def _bounds(self, d: int):
        bs = self.block_size
        return [(lo, min(d, lo + bs)) for lo in range(0, d, bs)]

    def apply(self, x):
        d = self.num_features or x.shape[-1]
        return tuple(x[..., lo:hi] for lo, hi in self._bounds(d))

    def apply_batch(self, X):
        return self.apply(X)


class FloatToDouble(Transformer):
    """Precision promotion (reference ``util/FloatToDouble.scala``). Like
    the JAX package without x64, it yields float32: the solvers downstream
    run in true float32."""

    def apply(self, x):
        return x.to(torch.float32)

    def apply_batch(self, X):
        return X.to(torch.float32)


class DoubleToFloat(Transformer):
    """Precision narrowing to float32 (reference
    ``util/DoubleToFloat.scala``)."""

    def apply(self, x):
        return x.to(torch.float32)

    def apply_batch(self, X):
        return X.to(torch.float32)


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or a numpy-style name
    (``"float32"``, ``np.int32``, ``"bfloat16"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"no torch dtype for {dtype!r}")
    return out


class Cast(Transformer):
    """Elementwise cast to ``dtype`` (a numpy-style name, as the JAX
    node takes)."""

    def __init__(self, dtype: str):
        self.dtype = dtype

    def apply(self, x):
        return x.to(_torch_dtype(self.dtype))

    def apply_batch(self, X):
        return self.apply(X)


class MatrixVectorizer(Transformer):
    """Flatten a matrix into a vector, column-major to match Breeze's
    ``toDenseVector`` (reference ``util/MatrixVectorizer.scala``)."""

    def apply(self, x):
        return x.T.reshape(-1)

    def apply_batch(self, X):
        return X.transpose(1, 2).reshape(X.shape[0], -1)


class Densify(Transformer):
    """Sparse -> dense (reference ``util/Densify.scala:10-21``). Array
    datasets and streams are already dense and pass through; a host
    dataset is stacked into an ArrayDataset. Tensors stay on their
    device; host items (SparseVectors, numpy arrays) go to ``device``,
    the default device (``"cuda"``) when it is None."""

    fusable = False

    def __init__(self, device=None):
        self.device = device

    def _host_device(self):
        return resolve_device() if self.device is None else resolve_device(
            self.device)

    def apply(self, x):
        if hasattr(x, "todense"):
            return torch.as_tensor(x.todense(), device=self._host_device())
        return x

    def apply_dataset(self, ds: Dataset) -> Dataset:
        if isinstance(ds, ArrayDataset) or is_streaming(ds):
            return ds
        items = ds.collect()
        if items and all(isinstance(it, torch.Tensor) for it in items):
            return ArrayDataset.from_items([it.reshape(-1) for it in items],
                                           items[0].device)
        dense = [np.asarray(it.todense() if hasattr(it, "todense") else it,
                            dtype=np.float32).ravel() for it in items]
        return ArrayDataset.from_numpy(np.stack(dense), self._host_device())

    def abstract_single(self, elements):
        from ...analysis.spec import ShapeDtype, SparseSpec, Unknown

        (e,) = elements
        if isinstance(e, SparseSpec):
            if e.size is None:
                return Unknown("sparse element of unknown size")
            return ShapeDtype((e.size,), torch.float32)
        return super().abstract_single(elements)


from .sparse import (  # noqa: E402
    AllSparseFeatures,
    CommonSparseFeatures,
    SparseFeatureVectorizer,
    SparseVector,
    Sparsify,
    sparse_batch,
)


class LabelAugmenter(Transformer):
    """Repeat each item ``mult`` times, item-major, so labels (or ids)
    line up with a patch-augmented dataset (reference
    ``RandomPatchCifarAugmented.LabelAugmenter``). A 1->many node, never
    fused: an array dataset is repeated on its device, a host dataset
    item by item."""

    fusable = False

    def __init__(self, mult: int):
        self.mult = mult

    def apply(self, x):
        return x

    def abstract_eval(self, dep_specs):
        from ...analysis.spec import DatasetSpec

        out = super().abstract_eval(dep_specs)
        if isinstance(out, DatasetSpec) and out.n is not None:
            return DatasetSpec(out.element, n=out.n * self.mult,
                               host=out.host, sparsity=out.sparsity)
        return out

    def apply_dataset(self, ds: Dataset) -> Dataset:
        if isinstance(ds, ArrayDataset):
            data = tree_map(lambda x: torch.repeat_interleave(
                x[: ds.n], self.mult, dim=0), ds.data)
            return ArrayDataset(data, ds.n * self.mult, mesh=ds.mesh)
        return HostDataset(
            [it for it in ds.collect() for _ in range(self.mult)])
