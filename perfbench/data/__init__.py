"""Seeded generators of the benchmark's inputs, in torch on the device.

Each stream of random numbers has a generator of its own, seeded from
the run's ``--seed`` and the stream's number, so one seed gives the same
inputs on every run and the streams do not overlap.
"""
from __future__ import annotations

import torch

_MASK = (1 << 63) - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for ``stream`` of run ``seed`` (any whole
    number; the two are mixed into one 63-bit seed)."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + int(stream) * 0xBF58476D1CE4E5B9
             + 0x94D049BB133111EB) & _MASK
    return torch.Generator(device=device).manual_seed(mixed)
