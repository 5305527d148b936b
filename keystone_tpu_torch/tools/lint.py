"""The port's static gate: the counterpart of the repository's
``tools/lint.py``, over ``keystone_tpu_torch/``.

    python -m keystone_tpu_torch.tools.lint [--skip-apps]

No data is read and no device is touched. Layers, each printing its
failures as ``file:line: code: message``:

1. **AST rules** over the source tree (``analysis/diagnostics.py``):
   ``host-coercion-in-apply`` (a device transformer's ``apply`` reads
   its item on the host), the capture hazards ``per-instance-capture-memo``
   / ``unstable-capture-key`` and the in-place carry hazards
   ``use-after-donate`` / ``checkpoint-after-donate`` (tree-wide, the
   carries' donors gathered from the whole package), ``metric-name-drift``
   (tree-wide), ``swallow-all-handler`` (``SWALLOW_ALL_SCOPES``),
   ``silent-nan-silencer`` (``NAN_SILENCER_SCOPES``) and
   ``cast-before-transfer`` (``CAST_BEFORE_TRANSFER_SCOPES``).
2. **The concurrency passes** (``analysis/concurrency.py``).
3. **The hot-path and publication passes** (``analysis/hotpath.py``),
   whose full-tree scan must also finish under
   ``HOTPATH_SCAN_BUDGET_S``, and **the SPMD passes**
   (``analysis/spmd.py``): collective divergence, barrier and payload
   stability, collective axes, world checkpoints, unawaited rounds.
4. **The donation shape gate** (``utils/donation.py``): every
   registered in-place update runs on its probe's meta tensors and must
   write each carry tensor in place; a site without a probe fails.
5. **The pipeline checks** of every app of ``CHECK_APPS`` (skipped with
   ``--skip-apps``).
6. ``ruff`` over the package, only where one is found on the path.

Each layer prints its wall seconds. Exit 0 clean, 1 on any failure.
"""
from __future__ import annotations

import ast
import importlib
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Tuple

PKG = Path(__file__).resolve().parent.parent
REPO = PKG.parent


def _trees() -> List[Tuple[Path, ast.Module]]:
    out = []
    for path in sorted(PKG.rglob("*.py")):
        try:
            out.append((path, ast.parse(path.read_text())))
        except SyntaxError as exc:
            print(f"{path.relative_to(REPO)}:{exc.lineno}: syntax-error: "
                  f"{exc}")
    return out


def _scope(path: Path) -> str:
    parts = path.relative_to(PKG).parts
    return parts[0] if len(parts) > 1 else ""


def _transformer_applies(tree: ast.Module):
    """(class, apply def) for transformer-looking classes: a base name
    holding ``Transformer`` and none holding ``Host``."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        bases = " ".join(str(b.attr if isinstance(b, ast.Attribute)
                             else getattr(b, "id", ""))
                         for b in node.bases)
        if "Transformer" not in bases or "Host" in bases:
            continue
        for item in node.body:
            if isinstance(item, ast.FunctionDef) and item.name == "apply":
                yield node, item


def run_ast_rules() -> int:
    from keystone_tpu_torch.analysis.diagnostics import (
        CAST_BEFORE_TRANSFER_SCOPES,
        NAN_SILENCER_SCOPES,
        SWALLOW_ALL_SCOPES,
        donating_names,
        donation_hazards,
        float_casts_before_transfer,
        host_coercions_in_funcdef,
        metric_name_drift,
        recompile_hazards,
        silent_nan_silencers,
        swallow_all_handlers,
    )

    trees = _trees()
    donors: Dict[str, frozenset] = {}
    for _, tree in trees:
        donors.update(donating_names(tree))
    failures = 0

    def report(rel, lineno, code, msg):
        nonlocal failures
        print(f"{rel}:{lineno}: {code}: {msg}")
        failures += 1

    for path, tree in trees:
        rel = path.relative_to(REPO)
        scope = _scope(path)
        for cls, fdef in _transformer_applies(tree):
            for lineno, what in host_coercions_in_funcdef(fdef):
                report(rel, lineno, "host-coercion-in-apply",
                       f"{cls.name}.apply reads {what} of its item on the "
                       "host (a sync per item; keep it in torch on the "
                       "device or make the node a HostTransformer)")
        for lineno, code, msg in recompile_hazards(tree):
            report(rel, lineno, code, msg)
        for lineno, code, msg in donation_hazards(tree, donors):
            report(rel, lineno, code, msg)
        for lineno, code, msg in metric_name_drift(tree):
            report(rel, lineno, code, msg)
        if scope in SWALLOW_ALL_SCOPES:
            for lineno, what in swallow_all_handlers(tree):
                report(rel, lineno, "swallow-all-handler",
                       f"{what} in ingest/serving/workflow code silently "
                       "loses failures; narrow the exception type, or "
                       "route it through the resilience layer")
        if scope in NAN_SILENCER_SCOPES:
            for lineno, what in silent_nan_silencers(tree):
                report(rel, lineno, "silent-nan-silencer",
                       f"{what} with no recorded numerics event in scope; "
                       "pair it with record_numerics_event(...) "
                       "(observability/numerics.py)")
        if scope in CAST_BEFORE_TRANSFER_SCOPES:
            for lineno, what in float_casts_before_transfer(tree):
                report(rel, lineno, "cast-before-transfer",
                       f"{what} in a function that moves data to the "
                       "device: widening on the host ships 4x the bytes; "
                       "ship the source dtype and cast on the device")
    return failures


def _scan(scan) -> Tuple[int, float]:
    t0 = time.perf_counter()
    hits = scan(PKG)
    elapsed = time.perf_counter() - t0
    for hit in hits:
        print(f"{hit['file']}:{hit['lineno']}: {hit['code']}: "
              f"{hit['message']}")
    return len(hits), elapsed


def run_concurrency_rules() -> int:
    from keystone_tpu_torch.analysis.concurrency import scan_package

    failures, elapsed = _scan(scan_package)
    print(f"concurrency passes: {failures} failure(s) in {elapsed:.2f}s")
    return failures


def run_hotpath_rules() -> int:
    from keystone_tpu_torch.analysis.hotpath import (
        HOTPATH_SCAN_BUDGET_S,
        scan_package,
    )

    failures, elapsed = _scan(scan_package)
    if elapsed > HOTPATH_SCAN_BUDGET_S:
        print(f"hotpath-scan-over-budget: full-tree scan took "
              f"{elapsed:.2f}s > {HOTPATH_SCAN_BUDGET_S:.0f}s budget")
        failures += 1
    print(f"hotpath passes: {failures} failure(s) in {elapsed:.2f}s "
          f"(budget {HOTPATH_SCAN_BUDGET_S:.0f}s)")
    return failures


def run_spmd_rules() -> int:
    from keystone_tpu_torch.analysis.spmd import scan_package

    failures, elapsed = _scan(scan_package)
    print(f"spmd passes: {failures} failure(s) in {elapsed:.2f}s")
    return failures


def _donating_modules() -> List[str]:
    """Every package module declaring an in-place update, found by the
    same AST pass the hazard rule uses: a new site is probed without a
    list to keep."""
    from keystone_tpu_torch.analysis.diagnostics import donating_names

    mods = []
    for path, tree in _trees():
        if not donating_names(tree):
            continue
        parts = list(path.relative_to(REPO).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def run_donation_shape_gate() -> int:
    t0 = time.perf_counter()
    for mod in _donating_modules():
        importlib.import_module(mod)
    from keystone_tpu_torch.utils.donation import (
        donation_shape_mismatches,
        registered_donations,
    )

    failures = probed = 0
    for site in registered_donations():
        if site.probe is None:
            print(f"{site.module}: donation-without-probe: {site.name} "
                  f"updates argument {site.carry_arg} in place but "
                  "registers no probe; pass probe= so the gate can check "
                  "it")
            failures += 1
            continue
        probed += 1
        for what in donation_shape_mismatches(site):
            print(f"{site.module}: donation-shape-mismatch: {what}")
            failures += 1
    print(f"donation shape gate: {probed} probed site(s), {failures} "
          f"failure(s) in {time.perf_counter() - t0:.2f}s")
    return failures


def run_pipeline_checks() -> int:
    from keystone_tpu_torch.pipelines import CHECK_APPS

    t0 = time.perf_counter()
    failures = 0
    for name in sorted(CHECK_APPS):
        target = CHECK_APPS[name]()
        report = target.pipeline.check(target.input_spec, name=name)
        print(f"check {name}: {'ok' if report.ok else 'FAIL'} "
              f"({report.resolved_nodes()}/"
              f"{len(report.analysis.graph.nodes)} specs resolved)")
        if not report.ok:
            for d in report.diagnostics:
                print(f"  {d}")
            failures += 1
    print(f"pipeline checks: {failures} failure(s) in "
          f"{time.perf_counter() - t0:.2f}s")
    return failures


def run_ruff() -> int:
    ruff = shutil.which("ruff")
    if ruff is None:
        print("ruff: not on the path; style pass skipped")
        return 0
    proc = subprocess.run([ruff, "check", "--select", "E9,F63,F7,F82",
                           str(PKG)], capture_output=True, text=True,
                          timeout=300)
    if proc.stdout.strip():
        print(proc.stdout)
    return 0 if proc.returncode == 0 else 1


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    t0 = time.perf_counter()
    failures = run_ast_rules()
    print(f"AST rules: {failures} failure(s) in "
          f"{time.perf_counter() - t0:.2f}s")
    failures += run_concurrency_rules()
    failures += run_hotpath_rules()
    failures += run_spmd_rules()
    failures += run_donation_shape_gate()
    failures += run_ruff()
    if "--skip-apps" not in argv:
        failures += run_pipeline_checks()
    if failures:
        print(f"\nlint: {failures} failure(s)")
        return 1
    print("\nlint: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
