"""The port's gate scripts (``keystone_tpu_torch/tools/*_gate.py``), each
run as a subprocess on the CPU under its own time limit: the recompile
gate (a second epoch and a second traffic pass capture nothing), the
numerics gate (an injected NaN trips, a clean fit does not) and the
chaos gate at one seed over two scenarios; and each gate's refusal of
the default device where there is no card.
"""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def _gate(module, *args, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", f"keystone_tpu_torch.tools.{module}", *args],
        cwd=REPO, capture_output=True, text=True, timeout=timeout)


def test_recompile_gate_passes_on_the_cpu():
    proc = _gate("recompile_gate", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "epoch 2 captured 0 (0 unexpected)" in proc.stdout
    assert "the second pass captured 0 (0 unexpected)" in proc.stdout
    assert "recompile gate: PASS" in proc.stdout


def test_numerics_gate_passes_on_the_cpu():
    proc = _gate("numerics_gate", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 post-mortem(s)" in proc.stdout
    assert "injected NaN in chunk 2 tripped NumericsError" in proc.stdout


def test_chaos_gate_passes_on_the_cpu_at_one_seed():
    proc = _gate("chaos_gate", "--device", "cpu", "--seeds", "1",
                 "--scenario", "burst", "--scenario", "poisoned_batch")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("-> CLEAN") == 2
    assert "chaos gate: PASS (2 runs clean" in proc.stdout


def test_chaos_gate_names_an_unknown_scenario():
    proc = _gate("chaos_gate", "--device", "cpu", "--scenario", "nope")
    assert proc.returncode == 1
    assert "unknown scenario(s) ['nope']" in proc.stderr


@pytest.mark.parametrize("module", ["recompile_gate", "numerics_gate",
                                    "serving_gate", "chaos_gate",
                                    "fleet_gate"])
def test_each_gate_refuses_the_default_device_without_a_card(module):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    proc = _gate(module, timeout=120)
    assert proc.returncode == 2
    assert "FAIL: no CUDA device is available" in proc.stderr
