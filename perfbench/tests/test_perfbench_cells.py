"""Whole runs on the CPU at tiny sizes: each cell comes out correct, a new
cell needs new files only, and a run with its timed path broken comes
out not correct, once for each fault the cell can have."""
from __future__ import annotations

import json
import shutil

import pytest
import torch

from perfbench import core
from perfbench.tests.conftest import tiny

CELLS = [w["name"] for w in core.manifest()["workloads"]]
SEED = 2 ** 31 + 4242
CPU = torch.device("cpu")


def _run(cell, seconds=0.3):
    result, numbers = core.run_cell(cell, SEED, seconds, False, CPU)
    return result, numbers


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_is_correct_on_the_cpu(tiny_cell, name):
    result, numbers = _run(tiny_cell(name))
    assert result["correct"] and result["failed"] == 0, numbers
    assert result["attempted"] >= 1
    cell = core.find_cell(name)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in result["metrics"].values():
        assert m["value"] >= 0


def _zero_weights(monkeypatch):
    """The solve returns the weights it started from (zeros)."""
    from keystone_tpu_torch.nodes.learning import linear

    def resident(X, Y, n, lam, bounds, num_iter, mask=None, mesh=None):
        Ws, x_mean, y_mean = solve(X, Y, n, lam, bounds, num_iter, mask, mesh)
        return [torch.zeros_like(W) for W in Ws], x_mean, y_mean

    def streamed(carry, lam, bounds, num_iter):
        Ws, x_mean, y_mean = gram(carry, lam, bounds, num_iter)
        return [torch.zeros_like(W) for W in Ws], x_mean, y_mean

    solve, gram = linear.block_least_squares, linear.gram_bcd
    monkeypatch.setattr(linear, "block_least_squares", resident)
    monkeypatch.setattr(linear, "gram_bcd", streamed)


def _half_the_rows(monkeypatch):
    """The solve sees the first half of the rows, its means taken over
    them; a stream folds every other chunk."""
    from keystone_tpu_torch.nodes.learning import linear

    def resident(X, Y, n, lam, bounds, num_iter, mask=None, mesh=None):
        h = n // 2
        return solve(X[:h], Y[:h], h, lam, bounds, num_iter, None, mesh)

    seen = []

    def fold(carry, chunk, labels):
        seen.append(1)
        return carry if len(seen) % 2 == 0 and carry is not None else \
            accumulate(carry, chunk, labels)

    solve, accumulate = linear.block_least_squares, linear.accumulate_gram_carry
    monkeypatch.setattr(linear, "block_least_squares", resident)
    monkeypatch.setattr(linear, "accumulate_gram_carry", fold)


def _altered_answer(monkeypatch):
    """The classifier changes its first row's answer."""
    from keystone_tpu_torch.nodes.util import MaxClassifier

    def apply(self, x):
        out = torch.argmax(x, dim=-1).to(torch.int32)
        if out.dim() == 1 and out.shape[0] > 0:
            out[0] = torch.argmin(x[0]).to(torch.int32)
        return out

    monkeypatch.setattr(MaxClassifier, "apply", apply)


def _half_the_batch(monkeypatch):
    """The featurizer computes the first half of a batch and repeats it
    for the rest."""
    from keystone_tpu_torch.nodes.images.core import FusedConvRectifyPool

    featurize = FusedConvRectifyPool.apply_batch

    def apply_batch(self, imgs):
        h = (imgs.shape[0] + 1) // 2
        out = featurize(self, imgs[:h].contiguous())
        return torch.cat([out, out])[:imgs.shape[0]]

    monkeypatch.setattr(FusedConvRectifyPool, "apply_batch", apply_batch)


FAULTS = {"fit": [_zero_weights, _half_the_rows, _altered_answer],
          "apply": [_zero_weights, _half_the_batch, _altered_answer]}


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in CELLS
    for fault in FAULTS["apply" if name.endswith(".apply") else "fit"]],
    ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_a_broken_timed_path_is_not_correct(tiny_cell, monkeypatch, name, fault):
    cell = tiny_cell(name)
    fault(monkeypatch)
    result, numbers = _run(cell)
    assert not result["correct"], numbers


def test_a_cell_that_exists_only_as_files_runs(tmp_path, monkeypatch):
    """A new cell is a workload file, a traffic file and a manifest entry:
    the harness finds it by name with no code changed."""
    bench = tmp_path / "perfbench"
    shutil.copytree(core.BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "traces", "tests"))
    (bench / "traffic" / "fit_three_sets.json").write_text(
        json.dumps({"driver": "fit_resident", "train_sets": 3}))
    wl = json.loads((bench / "workloads" / "timit.fit.json").read_text())
    wl.update(name="timit.fit_three", traffic="fit_three_sets")
    (bench / "workloads" / "timit.fit_three.json").write_text(json.dumps(wl))
    manifest = core.manifest()
    entry = dict(next(w for w in manifest["workloads"]
                      if w["name"] == "timit.fit"),
                 name="timit.fit_three", traffic="fit_three_sets")
    manifest["workloads"].append(entry)
    monkeypatch.setattr(core, "BENCH", bench)
    cell = tiny(core.find_cell("timit.fit_three", manifest))
    assert cell.traffic["train_sets"] == 3
    result, numbers = _run(cell, seconds=0.5)
    assert result["correct"] and result["attempted"] >= 3, numbers
