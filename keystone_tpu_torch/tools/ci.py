"""The port's CI chain: the counterpart of the repository's
``bin/ci.sh``, stage by stage in its order.

    python -m keystone_tpu_torch.tools.ci [--device cuda|cpu]
        [--no-tests] [--chaos-seeds N]

1. ``tools.lint --skip-apps``: the AST rules, the concurrency, hot-path
   and publication passes, the donation shape gate;
2. ``check --all --budget B``: the analyzer over every app, with the
   concurrency and hot-path scans (``B`` is
   ``KEYSTONE_TORCH_CI_HBM_BUDGET``, default 80GiB: one H100's memory);
3. ``benchdiff`` over the two newest ``BENCH_r*.json`` and the two newest
   ``MULTICHIP_r*.json``: advisory, it prints and never fails;

and, unless ``--no-tests``, the dynamic gates on ``--device`` (default
``cuda``):

4. ``recompile_gate``, 5. ``numerics_gate``, 6. ``elastic_gate`` (a
   2-rank world killed and resumed, bit-identical weights),
7. ``serving_gate``, 8. ``chaos_gate --seeds N`` (default 2),
9. ``fleet_gate``, 10. the bounded-seed schedule suite
   (``tests/test_torch_concurrency_sched.py``, which imports nothing of
   the JAX package, so it runs where JAX is absent).

The tier-1 tests are the repository's own pytest command (ROADMAP.md):
their parity tests import the JAX package. Each stage runs as a
subprocess under its own time limit and prints its seconds; stages 1-3
touch no device and run at the same time (their output printed in
order), the gates one after another. The first failing stage, in that
order, ends the chain with its name. Exit 0 clean, 1 otherwise.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from . import gates

NAME = "ci"
STAGE_TIMEOUT_S = 900.0


def _run(label: str, args: Sequence[str], timeout_s: float = STAGE_TIMEOUT_S
         ) -> Tuple[int, float]:
    print(f"== {NAME}: {label} ==", flush=True)
    t0 = time.perf_counter()
    try:
        rc = subprocess.run([sys.executable, *args], cwd=str(gates.REPO),
                            env=gates.child_env(), timeout=timeout_s).returncode
    except subprocess.TimeoutExpired:
        print(f"{NAME}: {label} passed its {timeout_s:.0f} s limit",
              file=sys.stderr)
        rc = 124
    seconds = time.perf_counter() - t0
    print(f"{NAME}: {label}: exit {rc} in {seconds:.1f}s", flush=True)
    return rc, seconds


def _run_together(stages: Sequence[Tuple[str, Sequence[str]]],
                  timeout_s: float = STAGE_TIMEOUT_S
                  ) -> List[Tuple[str, int, float]]:
    """Start every stage at once, wait for each under the limit, and
    print each one's output, exit and seconds in the given order."""
    t0 = time.perf_counter()
    procs = [(label, subprocess.Popen(
        [sys.executable, *args], cwd=str(gates.REPO), env=gates.child_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for label, args in stages]
    out = []
    for label, proc in procs:
        try:
            text, _ = proc.communicate(
                timeout=max(timeout_s - (time.perf_counter() - t0), 1.0))
            rc = proc.returncode
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate(timeout=30)
            text += f"\n{NAME}: {label} passed its {timeout_s:.0f} s limit\n"
            rc = 124
        seconds = time.perf_counter() - t0
        print(f"== {NAME}: {label} ==\n{text.rstrip()}\n{NAME}: {label}: "
              f"exit {rc}, done within {seconds:.1f}s of the static "
              "stages' start", flush=True)
        out.append((label, rc, seconds))
    return out


def _newest_pair(prefix: str) -> Optional[List[str]]:
    found = sorted(Path(gates.REPO).glob(f"{prefix}_r*.json"))
    return [str(p) for p in found[-2:]] if len(found) >= 2 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the gates' device: cuda (default) or cpu")
    ap.add_argument("--no-tests", action="store_true",
                    help="the static stages only")
    ap.add_argument("--chaos-seeds", type=int, default=2)
    args = ap.parse_args(argv)
    budget = os.environ.get("KEYSTONE_TORCH_CI_HBM_BUDGET", "80GiB")
    t_chain = time.perf_counter()
    stages = [
        ("lint", ["-m", "keystone_tpu_torch.tools.lint", "--skip-apps"]),
        (f"check --all --budget {budget}",
         ["-m", "keystone_tpu_torch", "check", "--all", "--budget",
          budget]),
    ]
    advisory = set()
    for prefix in ("BENCH", "MULTICHIP"):
        pair = _newest_pair(prefix)
        if pair is None:
            print(f"{NAME}: benchdiff {prefix} skipped (fewer than two "
                  "artifacts)")
            continue
        label = f"benchdiff {prefix} (advisory)"
        advisory.add(label)
        stages.append((label, ["-m", "keystone_tpu_torch", "benchdiff",
                               *pair]))
    times = []
    for label, rc, seconds in _run_together(stages):
        times.append((label, seconds))
        if rc and label in advisory:
            print(f"{NAME}: {label}: advisory verdict exit {rc} (not "
                  "failing the chain)")
        elif rc:
            return gates.fail(NAME, f"stage '{label}' exited {rc}")
    if not args.no_tests:
        dev = ["--device", args.device]
        gates_ = [
            ("recompile gate", ["-m", "keystone_tpu_torch.tools."
                                "recompile_gate", *dev]),
            ("numerics gate", ["-m", "keystone_tpu_torch.tools."
                               "numerics_gate", *dev]),
            ("elastic gate", ["-m", "keystone_tpu_torch.tools."
                              "elastic_gate", *dev]),
            ("serving gate", ["-m", "keystone_tpu_torch.tools."
                              "serving_gate", *dev]),
            (f"chaos gate (--seeds {args.chaos_seeds})",
             ["-m", "keystone_tpu_torch.tools.chaos_gate", *dev,
              "--seeds", str(args.chaos_seeds)]),
            ("fleet gate", ["-m", "keystone_tpu_torch.tools.fleet_gate",
                            *dev]),
            ("bounded-seed schedule suite",
             ["-m", "pytest", "tests/test_torch_concurrency_sched.py", "-q",
              "-p", "no:cacheprovider", "--noconftest"]),
        ]
        for label, cmd in gates_:
            rc, seconds = _run(label, cmd)
            times.append((label, seconds))
            if rc:
                return gates.fail(NAME, f"stage '{label}' exited {rc}")
    total = time.perf_counter() - t_chain
    print(f"{NAME}: clean in {total:.1f}s ("
          + ", ".join(f"{label} {s:.1f}s" for label, s in times) + ")",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
