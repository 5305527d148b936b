"""String preprocessing nodes (reference ``nodes/nlp/StringUtils.scala``).

Counterpart of ``keystone_tpu/nodes/nlp/text.py``. Host stages:
tokenizing is ragged, non-numeric work that stays on the host; the
vectorizers downstream turn its output into sparse vectors that the
solvers and models stage on the device.
"""
from __future__ import annotations

import re

from ...workflow.transformer import HostTransformer


class Tokenizer(HostTransformer):
    """Split a string into tokens on a delimiter regex (reference
    ``StringUtils.scala:13-15``; the default splits on punctuation and
    whitespace). JVM ``String.split`` semantics: trailing empty fields
    are removed, leading and interior ones kept."""

    def __init__(self, sep: str = r"[\W_\s]+"):
        self.sep = sep
        self._re = re.compile(sep)

    def eq_key(self):
        return (Tokenizer, self.sep)

    def apply(self, s: str):
        parts = self._re.split(s)
        while parts and parts[-1] == "":
            parts.pop()
        return parts

    def __getstate__(self):
        state = super().__getstate__()
        state.pop("_re", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._re = re.compile(self.sep)


class Trim(HostTransformer):
    """Strip leading and trailing whitespace (``StringUtils.scala:20-22``)."""

    def apply(self, s: str) -> str:
        return s.strip()


class LowerCase(HostTransformer):
    """Lower-case a string (``StringUtils.scala:28-30``)."""

    def apply(self, s: str) -> str:
        return s.lower()
