"""Identifiers for graph elements.

Mirrors the reference's ``workflow/graph/GraphId.scala:1-31`` (SourceId /
NodeId / SinkId as distinct id spaces sharing an integer namespace).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True, order=True)
class GraphId:
    """Base class for all graph identifiers."""

    id: int


@dataclass(frozen=True, order=True)
class NodeId(GraphId):
    """Identifies an operator node in a Graph."""

    def __repr__(self) -> str:
        return f"node{self.id}"


@dataclass(frozen=True, order=True)
class SourceId(GraphId):
    """Identifies a dangling input of a Graph."""

    def __repr__(self) -> str:
        return f"source{self.id}"


@dataclass(frozen=True, order=True)
class SinkId(GraphId):
    """Identifies an output endpoint of a Graph."""

    def __repr__(self) -> str:
        return f"sink{self.id}"
