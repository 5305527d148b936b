"""The port's serving gates and CI chain as subprocesses on the CPU,
each under its own time limit: the serving gate (``serve`` in a
subprocess, readiness, requests over three buckets, no unexpected
capture, the SLO tripped by a straggler), the fleet gate (three replica
subprocesses, one killed mid-replay and its models re-placed
sha-verified) and ``tools/ci.py --no-tests`` (lint, ``check --all`` and
the advisory benchdiff).
"""
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _run(module, *args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", f"keystone_tpu_torch.tools.{module}", *args],
        cwd=REPO, capture_output=True, text=True, timeout=timeout)


def test_serving_gate_passes_on_the_cpu():
    proc = _run("serving_gate", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "hot-path scan clean" in proc.stdout
    assert "24 requests over 2 models" in proc.stdout
    assert "the straggler tripped the SLO" in proc.stdout


def test_fleet_gate_passes_on_the_cpu():
    proc = _run("fleet_gate", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "3 replicas up on cpu" in proc.stdout
    assert "re-placement sha-verified" in proc.stdout


def test_ci_chain_runs_the_static_stages_in_order():
    proc = _run("ci", "--device", "cpu", "--no-tests", timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    stages = [line for line in proc.stdout.splitlines()
              if line.startswith("== ci: ")]
    assert [s.split("== ci: ")[1].split(" ")[0] for s in stages] == [
        "lint", "check", "benchdiff", "benchdiff"]
    assert "lint: clean" in proc.stdout
    assert "hotpath: clean" in proc.stdout
    assert "ci: clean in" in proc.stdout
