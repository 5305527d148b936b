"""The port's command line (the analogue of the reference's
``bin/run-pipeline.sh <class> --flags``):

    python -m keystone_tpu_torch <app> [--flags] [--device cuda|cpu]
                                       [--trace-out PATH]
    python -m keystone_tpu_torch check <app>|--all [--json PATH]
                                       [--budget BYTES] [--replicas N]
    python -m keystone_tpu_torch benchdiff BASE.json CURRENT.json [--force]
    python -m keystone_tpu_torch numerics POSTMORTEM.json
    python -m keystone_tpu_torch serve NAME=PATH@SHAPE[:DTYPE] ... [--port P]

Counterpart of ``keystone_tpu/__main__.py``. Run with no arguments to
list the apps. Each app's ``main`` takes the JAX package's flags and
defaults, plus ``--device`` (default ``cuda``: without a card the app
raises). ``--trace-out PATH`` runs the app under a
:class:`~keystone_tpu_torch.observability.trace.PipelineTrace` that
counts each node's work, annotates every node with its FLOPs, ``mfu``
and ``membw_util`` (``observability/utilization.py::annotate_trace``)
and writes the trace's JSON to PATH (a PATH ending ``.perfetto.json``
gets the flight recorder's Chrome trace instead), with a per-node
summary and MFU table on stderr.

``check`` analyzes an app's pipeline DAG without loading data or
touching a device (``keystone_tpu_torch/analysis``): shape and dtype
propagation on meta tensors, the graph lints, the static device-memory
plan and the metric-name catalogue. Exit 0 clean, 1 diagnostics, 2 a
predicted budget violation or a usage error. ``--budget BYTES``
(``MiB``/``GiB`` suffixes) gates each app's fit-path peak; ``--replicas
N`` (with ``--budget`` as each replica's budget) solves the apps' static
serving charges into an N-replica placement (``serving/placement.py``).
``--json PATH`` writes the full report. ``benchdiff`` is the
bench-regression gate over ``BENCH_r*.json`` artifacts
(``observability/benchdiff.py``), ``numerics`` renders a numerics
post-mortem (``observability/numerics.py``), ``serve`` is the serving
plane's command (``serving/http.py``).

What the port does not have yet exits 2 naming its ROADMAP item:
``check --shards`` and the multi-process launch (``--coordinator``,
``--num-processes``, ``--process-id``, ``KEYSTONE_DISTRIBUTED``; A11),
``check --xla`` (A12b).
"""
from __future__ import annotations

import importlib
import json
import os
import sys

APPS = {
    "mnist.random_fft": "keystone_tpu_torch.pipelines.images.mnist.random_fft",
    "cifar.linear_pixels":
        "keystone_tpu_torch.pipelines.images.cifar.linear_pixels",
    "cifar.random_cifar":
        "keystone_tpu_torch.pipelines.images.cifar.random_cifar",
    "cifar.random_patch":
        "keystone_tpu_torch.pipelines.images.cifar.random_patch_cifar",
    "cifar.random_patch_augmented":
        "keystone_tpu_torch.pipelines.images.cifar."
        "random_patch_cifar_augmented",
    "imagenet.sift_lcs_fv":
        "keystone_tpu_torch.pipelines.images.imagenet.sift_lcs_fv",
    "voc.sift_fisher":
        "keystone_tpu_torch.pipelines.images.voc.voc_sift_fisher",
    "speech.timit": "keystone_tpu_torch.pipelines.speech.timit",
    "text.newsgroups": "keystone_tpu_torch.pipelines.text.newsgroups",
    "text.amazon_reviews": "keystone_tpu_torch.pipelines.text.amazon_reviews",
    "nlp.stupid_backoff":
        "keystone_tpu_torch.pipelines.nlp.stupid_backoff_pipeline",
}

#: the check command's switches the port has not yet, with the ROADMAP
#: item that brings each
CHECK_NOT_PORTED = {"--shards": "A11", "--xla": "A12b"}
DISTRIBUTED_FLAGS = ("--coordinator", "--num-processes", "--process-id")

#: the tree-wide scans of the JAX ``check`` the port has not yet: their
#: summary lines say so, and ``--json`` leaves their keys out
SCANS_NOT_PORTED = (("concurrency", "A12b"), ("spmd", "A11"),
                    ("hotpath", "A12b"))


def _usage() -> None:
    print("usage: python -m keystone_tpu_torch <app> [--flags] "
          "[--device cuda|cpu] [--trace-out PATH]\n"
          "       python -m keystone_tpu_torch check <app>|--all\n"
          "       python -m keystone_tpu_torch benchdiff BASE.json "
          "CURRENT.json\n"
          "       python -m keystone_tpu_torch numerics POSTMORTEM.json\n"
          "       python -m keystone_tpu_torch serve "
          "NAME=PATH@SHAPE[:DTYPE] ...\n\napps:")
    for name in sorted(APPS):
        print(f"  {name}")


def _refuse(what: str, item: str) -> int:
    print(f"{what} is not ported to keystone_tpu_torch yet (ROADMAP {item})",
          file=sys.stderr)
    return 2


def _parse_bytes(text: str) -> float:
    """Byte counts with optional binary suffixes: ``1073741824``,
    ``512MiB``, ``16GiB``, ``4g``."""
    units = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}
    s = text.strip().lower()
    for suffix in ("ib", "b"):
        if s.endswith(suffix) and len(s) > len(suffix) \
                and s[-len(suffix) - 1] in units:
            s = s[: -len(suffix)]
            break
    mult = 1
    if s and s[-1] in units:
        mult = units[s[-1]]
        s = s[:-1]
    return float(s) * mult


def _take_value(rest, flag: str, what: str):
    """Remove ``flag VALUE`` from ``rest``; (found, value), value None
    when the flag ends the line."""
    if flag not in rest:
        return False, None
    i = rest.index(flag)
    if i + 1 >= len(rest):
        print(f"{flag} requires {what}", file=sys.stderr)
        del rest[i:]
        return True, None
    value = rest[i + 1]
    del rest[i:i + 2]
    return True, value


def check_main(rest) -> int:
    """``python -m keystone_tpu_torch check <app>|--all [--json PATH]
    [--budget BYTES] [--replicas N]``: the JAX package's ``check``
    (``keystone_tpu/__main__.py::check_main``) over the port's apps, with
    its exit codes: 0 clean, 1 diagnostics, 2 a predicted budget
    violation or a usage error. ``--budget`` gates each app's static
    fit-path peak; ``--replicas N`` with ``--budget`` as each replica's
    budget solves the apps' static serving charges into an N-replica
    placement (``serving/placement.py``), exit 2 naming the first app no
    replica can host. ``--shards`` (A11) and ``--xla`` (A12b) exit 2."""
    rest = list(rest)
    for flag, item in CHECK_NOT_PORTED.items():
        if flag in rest:
            return _refuse(f"check {flag}", item)
    found, json_out = _take_value(rest, "--json", "a path")
    if found and json_out is None:
        return 2
    found, text = _take_value(rest, "--budget", "a byte count (e.g. 16GiB)")
    budget = None
    if found:
        try:
            budget = _parse_bytes(text) if text is not None else None
        except ValueError:
            print(f"--budget expects bytes (e.g. 1073741824, 512MiB, "
                  f"16GiB), got {text!r}", file=sys.stderr)
            return 2
        if budget is None:
            return 2
    found, text = _take_value(rest, "--replicas", "a replica count (e.g. 3)")
    replicas = None
    if found:
        try:
            replicas = int(text) if text is not None else None
            if replicas is not None and replicas < 1:
                raise ValueError(replicas)
        except ValueError:
            print(f"--replicas expects a positive integer, got {text!r}",
                  file=sys.stderr)
            return 2
        if replicas is None:
            return 2
    if replicas is not None and budget is None:
        print("--replicas needs --budget BYTES (the per-replica device "
              "budget the fleet placement is solved against)",
              file=sys.stderr)
        return 2

    from .analysis.diagnostics import scan_metric_names
    from .pipelines import CHECK_APPS, resolve_check_app

    if not rest or rest[0] in ("-h", "--help"):
        print("usage: python -m keystone_tpu_torch check <app>|--all "
              "[--json PATH] [--budget BYTES] [--replicas N]\n\napps:")
        for name in sorted(CHECK_APPS):
            print(f"  {name}")
        return 0
    if rest[0] == "--all":
        builders = [CHECK_APPS[k] for k in sorted(CHECK_APPS)]
    else:
        try:
            builders = [resolve_check_app(rest[0])]
        except KeyError:
            print(f"unknown app '{rest[0]}'; run `check` with no "
                  "arguments to list apps", file=sys.stderr)
            return 2

    # metric-name drift: every counter/gauge/histogram call site must use
    # a catalogued name (observability/names.py)
    pkg_root = os.path.dirname(os.path.abspath(__file__))
    metrics_names = scan_metric_names(pkg_root)
    for hit in metrics_names:
        print(f"{hit['file']}:{hit['lineno']}: {hit['code']}: "
              f"{hit['message']}", file=sys.stderr)
    failed = 1 if metrics_names else 0
    over_budget = 0
    reports = []
    for build in builders:
        target = build()
        report = target.pipeline.check(target.input_spec, name=target.name,
                                       hbm_budget=budget)
        reports.append(report)
        print(report.summary(), file=sys.stderr)
        violated = any(d.code == "hbm-budget" for d in report.diagnostics)
        over_budget += violated
        if not report.ok:
            failed += 1
        if report.ok:
            status = "OK"
        elif violated:
            status = (f"OVER BUDGET (plan "
                      f"{report.plan.fit_peak_nbytes / (1 << 20):.2f} MiB "
                      f"> {budget / (1 << 20):.2f} MiB)")
        else:
            status = f"FAIL ({len(report.diagnostics)} diagnostic(s))"
        print(f"{target.name}: {status}")
    fleet_placement = None
    if replicas is not None:
        fleet_placement = _fleet_placement(reports, replicas, budget)
        over_budget += "infeasible" in fleet_placement
    print(f"metrics names: {'clean' if not metrics_names else f'{len(metrics_names)} diagnostic(s)'}")
    for scan, item in SCANS_NOT_PORTED:
        print(f"{scan}: not ported (ROADMAP {item})")
    if json_out is not None:
        if len(reports) == 1:
            blob = reports[0].to_dict()
            blob["metrics_names"] = metrics_names
        else:
            blob = {"apps": [r.to_dict() for r in reports],
                    "metrics_names": metrics_names}
        if fleet_placement is not None:
            blob["fleet_placement"] = fleet_placement
        with open(json_out, "w") as f:
            f.write(json.dumps(blob, indent=2))
        print(f"report written to {json_out}", file=sys.stderr)
    if over_budget:
        return 2  # a predicted device-memory violation, before any work
    return 1 if failed else 0


def _fleet_placement(reports, replicas: int, budget: float) -> dict:
    """The checked apps' static serving charges at a 64-row bucket,
    solved into ``replicas`` replicas of ``budget`` bytes. The CUDA
    graphs' pools a CUDA plane charges at admission are measured only by
    a probe capture on the card (``serving/residency.py``), so the static
    charge leaves them out."""
    from .analysis.resources import serving_residency_nbytes
    from .serving.placement import ModelDemand, PlacementError, \
        plan_placement

    bucket_rows = 64
    demands, unsized = [], []
    for report in reports:
        charge = serving_residency_nbytes(
            report.plan.model_nbytes, report.plan, bucket_rows)
        if charge is None:
            unsized.append(report.name)
            continue
        demands.append(ModelDemand(name=report.name,
                                   charge_nbytes=float(charge)))
    if unsized:
        print(f"fleet: skipping {', '.join(unsized)}: no static serving "
              "charge (unresolved plan)", file=sys.stderr)
    try:
        placed = plan_placement(
            demands, {f"r{i}": float(budget) for i in range(replicas)})
    except PlacementError as exc:
        print(f"fleet: INFEASIBLE at {replicas} replica(s) x "
              f"{budget / (1 << 20):.2f} MiB: {exc}")
        return {"replicas": replicas, "budget_nbytes": float(budget),
                "infeasible": str(exc), "model": exc.model}
    max_load = max(placed.loads.values()) if placed.loads else 0.0
    print(f"fleet: {len(demands)} app(s) place on {replicas} replica(s) x "
          f"{budget / (1 << 20):.2f} MiB (max replica load "
          f"{max_load / (1 << 20):.2f} MiB)")
    return {"replicas": replicas, "budget_nbytes": float(budget),
            "bucket_rows": bucket_rows,
            "assignments": {m: list(r) for m, r
                            in sorted(placed.assignments.items())},
            "loads": dict(sorted(placed.loads.items()))}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        _usage()
        return 0
    app, rest = argv[0], argv[1:]
    if app == "serve":
        from .serving.http import main as serve_main

        return serve_main(rest)
    if app == "check":
        return check_main(rest)
    if app == "benchdiff":
        from .observability.benchdiff import main as bd_main

        return bd_main(rest)
    if app == "numerics":
        from .observability.numerics import postmortem_report

        return postmortem_report(rest)
    for flag in DISTRIBUTED_FLAGS:
        if any(a == flag or a.startswith(flag + "=") for a in rest):
            return _refuse(f"the multi-process launch ({flag})", "A11")
    if os.environ.get("KEYSTONE_DISTRIBUTED"):
        return _refuse("the multi-process launch (KEYSTONE_DISTRIBUTED)",
                       "A11")
    trace_out = None
    if "--trace-out" in rest:
        i = rest.index("--trace-out")
        if i + 1 >= len(rest):
            print("--trace-out requires a path", file=sys.stderr)
            return 2
        trace_out = rest[i + 1]
        del rest[i:i + 2]
    module = APPS.get(app)
    if module is None:
        print(f"unknown app '{app}'; run with no arguments to list apps",
              file=sys.stderr)
        return 2
    mod = importlib.import_module(module)
    if trace_out is None:
        mod.main(rest)
        return 0
    from .observability.timeline import write_trace_artifact
    from .observability.trace import PipelineTrace

    from .observability.utilization import annotate_trace, utilization_table

    with PipelineTrace(app, count_flops=True) as tr:
        mod.main(rest)
    # per-node FLOPs, MFU and bandwidth from the kernels' counted work and
    # the torch ops' FlopCounterMode counts, before export
    annotate_trace(tr)
    kind = write_trace_artifact(trace_out, tr)
    print(tr.summary(), file=sys.stderr)
    print(utilization_table(tr), file=sys.stderr)
    print(f"{kind} written to {trace_out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
