"""Shared fixtures of the benchmark's tests.

Run from the repository's root: ``python -m pytest perfbench/tests -q``.
Tests marked ``card`` need a CUDA device and skip without one (the
``card`` fixture decides, when the test runs); on the card:
``python3 -m pytest perfbench/tests -q -m card``.
"""
from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


#: sizes at which a cell runs on the CPU in seconds: the same code paths,
#: far smaller than the cells' own
TINY = {"rpc_cifar": dict(num_filters=16, n_train=300, n_test=120,
                          whitener_samples=2000),
        "timit": dict(num_cosines=2, num_cosine_features=32, n_train=256,
                      n_test=64)}


def tiny(cell):
    """``cell`` cut to :data:`TINY`'s sizes, its stream chunks to 64 rows
    and its apply calls to the
    whole tiny held-out set and 50 of its rows."""
    cell.config = dict(cell.config, values=dict(
        cell.config["values"], **TINY[cell.config["adapter"]]))
    if "stream" in cell.traffic:
        cell.traffic = dict(cell.traffic,
                            stream=dict(cell.traffic["stream"], chunk_rows=64))
    if cell.traffic["driver"] == "apply":
        cell.traffic = dict(cell.traffic, call_rows=[120, 50])
    return cell


@pytest.fixture
def tiny_cell():
    from perfbench import core

    return lambda name: tiny(core.find_cell(name))
