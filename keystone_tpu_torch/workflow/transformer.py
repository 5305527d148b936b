"""Transformer: the per-item pipeline stage.

Counterpart of ``keystone_tpu/workflow/transformer.py`` (reference
``workflow/Transformer.scala``): a Transformer is simultaneously an
operator (executable node) and a one-node Pipeline. A node implements
per-item ``apply`` on tensors; its batch form is ``apply_batch`` over a
written-out leading batch dimension. Nodes that write no ``apply_batch``
get a row-by-row map of ``apply``.

Fitted-param protocol: a node holding fitted arrays returns them, staged
on a device, from ``apply_params(device)`` and computes from them in
``apply_with_params(params, x)``, so the datum path and the batch path
read the same device copies. The copies are cached per device on the
node and dropped when it is pickled.

Fusability: map and gather fusion (``optimizer/fusion.py``) may fold a
node into one fused node with its neighbours only when its class says
``fusable``. A fused node runs each stage's own ``apply_batch`` in turn,
so a class whose ``apply_dataset`` is not that per-batch map (a 1->many
reshape, a host stage, a sampler, a cache point) sets it False. The
classes that set it False are exactly those for which the JAX package's
predicate is False (``tests/test_torch_fusion.py`` holds the two apart
class by class).
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from ..parallel.dataset import (
    ArrayDataset,
    Dataset,
    HostDataset,
    is_streaming,
    map_rows,
)
from .graph import Graph
from .operators import TransformerOperator
from .pipeline import Chainable, Pipeline


class Transformer(TransformerOperator, Chainable):
    #: May map and gather fusion fold this node into a fused node? False
    #: where ``apply_dataset`` is not the per-batch map of ``apply_batch``.
    fusable = True

    def apply(self, x: Any) -> Any:
        """Per-item transform on tensors."""
        raise NotImplementedError

    def apply_batch(self, X: Any) -> Any:
        """Whole-batch transform over the leading dimension (padded rows
        included). Default: ``apply`` row by row."""
        return map_rows(self.apply, X)

    # -- fitted-param protocol ---------------------------------------------
    def apply_params(self, device: torch.device) -> Any:
        """Fitted tensors consumed by ``apply_with_params``, staged on
        ``device``, or None for stateless/config-only nodes."""
        return None

    def apply_with_params(self, params: Any, x: Any) -> Any:
        """``apply(x)`` reading fitted tensors from ``params``."""
        return self.apply(x)

    def _params_on(self, device: torch.device,
                   build: Callable[[torch.device], Any]) -> Any:
        """Per-device cache behind ``apply_params``."""
        cache = self.__dict__.setdefault("_params_cache", {})
        key = str(device)
        if key not in cache:
            cache[key] = build(device)
        return cache[key]

    def apply_dataset(self, ds: Dataset) -> Dataset:
        if isinstance(ds, ArrayDataset):
            return ds.map_batch(self.apply_batch)
        if is_streaming(ds):
            # lazy per-chunk apply: each chunk is an ArrayDataset, so the
            # batch path above runs on it when the stream is consumed
            return ds.map_chunks(self.apply_dataset)
        return ds.map(self.apply)

    # -- operator plumbing -------------------------------------------------
    def single_transform(self, inputs: Sequence[Any]) -> Any:
        return self.apply(inputs[0])

    def batch_transform(self, inputs: Sequence[Dataset]) -> Dataset:
        return self.apply_dataset(inputs[0])

    def to_pipeline(self) -> Pipeline:
        g = Graph()
        g, src = g.add_source()
        g, nid = g.add_node(self, (src,))
        g, sink = g.add_sink(nid)
        return Pipeline(g, src, sink)

    # device copies of fitted params must not leak into pickles
    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_params_cache", None)
        state.pop("_eq_key_val", None)
        return state


class HostTransformer(Transformer):
    """A transformer whose ``apply`` runs host-side Python on host items
    (tokenizers, string and n-gram work). Its batch path maps ``apply``
    over the items of a host dataset; an array dataset is collected to
    host items first, and a stream is refused (its chunks lie on the
    device). Never fused: a fused node runs ``apply_batch`` on tensors."""

    fusable = False

    def apply_dataset(self, ds: Dataset) -> Dataset:
        if is_streaming(ds):
            raise TypeError(
                f"host stage {self.label()!r} cannot consume a "
                "StreamingDataset: its chunks are device-resident and a host "
                "stage would copy every chunk back. Run host stages before "
                "building the stream, or materialize() it.")
        if isinstance(ds, ArrayDataset):
            ds = HostDataset(ds.collect())
        return ds.map(self.apply)


class LambdaTransformer(Transformer):
    """Function lift (reference ``Transformer.apply(f)``)."""

    def __init__(self, fn: Callable[[Any], Any], name: str = "Lambda"):
        self.fn = fn
        self.name = name

    def eq_key(self):
        return (LambdaTransformer, self.fn, self.name)

    def apply(self, x: Any) -> Any:
        return self.fn(x)

    def label(self) -> str:
        return self.name


def transformer(fn: Callable[[Any], Any]) -> LambdaTransformer:
    """Decorator/lift: ``transformer(lambda x: x * 2)``."""
    return LambdaTransformer(fn, getattr(fn, "__name__", "Lambda"))
