"""Identity and Cacher stages.

Counterpart of ``keystone_tpu/workflow/common.py`` (reference
``workflow/graph/Identity.scala`` and ``Cacher.scala``). Datasets are
already materialized on the device, so Cacher's job is to mark its node
saveable for the cross-pipeline prefix memo. On a stream it returns the
stream itself: caching never materializes a stream, and the memo then
holds the lazy stream, never its device chunks.
"""
from __future__ import annotations

from typing import Any

from ..parallel.dataset import Dataset
from .transformer import Transformer


class Identity(Transformer):
    fusable = False

    def apply(self, x: Any) -> Any:
        return x

    def apply_dataset(self, ds: Dataset) -> Dataset:
        return ds


class Cacher(Transformer):
    """Marks its output for materialization + cross-pipeline reuse
    (reference ``nodes/util/Cacher.scala:15-25``)."""

    saveable = True
    fusable = False

    def __init__(self, name: str = ""):
        self.name = name

    def apply(self, x: Any) -> Any:
        return x

    def apply_dataset(self, ds: Dataset) -> Dataset:
        return ds.cache()

    def label(self) -> str:
        return f"Cache({self.name})" if self.name else "Cache"
