"""The chaos gate: the serving scenario catalogue at bounded seeds.

    python -m keystone_tpu_torch.tools.chaos_gate [--device cuda|cpu]
        [--seeds N] [--scenario NAME ...]

Counterpart of the repository's ``tools/chaos_gate.py``. Each
``serving/scenarios`` scenario replays its deterministic load trace
against a fresh plane (or, for the fleet scenarios, a fleet of planes
behind real HTTP) under its seeded fault plan, in this process (a
``FaultPlan`` is process-wide), and is judged on its p99 and
availability floors and its own checks. Every run must end CLEAN; a
run that does not writes a post-mortem naming the scenario and the seed,
and the gate exits 1 naming the violated floor. An unclassified outcome
is a violation.

Post-mortems go to a temporary directory, kept when a run fails (its
path is printed) and removed otherwise.
"""
from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

from . import gates

NAME = "chaos gate"


def main(argv=None) -> int:
    ap = gates.parser(__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=2,
                    help="seeds per scenario (0..N-1, default 2)")
    ap.add_argument("--scenario", action="append", default=None,
                    help="run only this scenario (repeatable)")
    args = ap.parse_args(argv)
    device = gates.resolve(NAME, args.device)
    if device is None:
        return 2
    from ..serving.scenarios import SCENARIOS, load_catalogue, run_scenario

    load_catalogue()
    names = sorted(SCENARIOS)
    if args.scenario:
        missing = [n for n in args.scenario if n not in SCENARIOS]
        if missing:
            return gates.fail(NAME, f"unknown scenario(s) {missing}; the "
                                    f"catalogue: {names}")
        names = sorted(set(args.scenario))
    pm_dir = tempfile.mkdtemp(prefix="keystone-chaos-gate-")
    os.environ["KEYSTONE_TORCH_POSTMORTEM_DIR"] = pm_dir
    print(f"{NAME}: {len(names)} scenario(s) x {args.seeds} seed(s) on "
          f"{device}", flush=True)
    failures = []
    t_gate = time.perf_counter()
    for name in names:
        for seed in range(args.seeds):
            t0 = time.perf_counter()
            res = run_scenario(name, seed, device=device)
            verdict = ("CLEAN" if res.clean else
                       f"CLASSIFIED (post-mortem "
                       f"{res.postmortem_path or 'MISSING'})")
            print(f"{NAME}: {name} seed={seed} p99={res.p99_ms:.1f}ms "
                  f"floor<={res.floors.p99_ms:.0f} "
                  f"avail={res.availability:.3f} "
                  f"floor>={res.floors.availability:.2f} "
                  f"inj={res.injections} {time.perf_counter() - t0:.1f}s "
                  f"-> {verdict}", flush=True)
            if res.clean:
                continue
            for v in res.violations:
                print(f"{NAME}:   violated: {v}", file=sys.stderr)
            if not res.postmortem_path:
                print(f"{NAME}:   and the violation wrote no post-mortem",
                      file=sys.stderr)
            failures.append((name, seed, res.violations))
    if failures:
        floors = "; ".join(f"{n}/seed{s}: {', '.join(v)}"
                           for n, s, v in failures)
        return gates.fail(NAME, f"{len(failures)} run(s) violated their "
                                f"floors ({floors}); post-mortems in "
                                f"{pm_dir}")
    shutil.rmtree(pm_dir, ignore_errors=True)
    print(f"{NAME}: PASS ({len(names) * args.seeds} runs clean in "
          f"{time.perf_counter() - t_gate:.1f}s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
