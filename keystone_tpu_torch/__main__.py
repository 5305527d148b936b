"""The port's command line (the analogue of the reference's
``bin/run-pipeline.sh <class> --flags``):

    python -m keystone_tpu_torch <app> [--flags] [--device cuda|cpu]
                                       [--trace-out PATH]
    python -m keystone_tpu_torch check <app>|--all [--json PATH]
                                       [--budget BYTES] [--shards N]
                                       [--replicas N]
                                       [--xla [--device cuda|cpu]]
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
plan and the metric-name catalogue, plus the tree-wide concurrency scan
(``analysis/concurrency.py``, the ``concurrency`` key in ``--json``),
SPMD scan (``analysis/spmd.py``, the ``spmd`` key) and hot-path scan
(``analysis/hotpath.py``, the ``hotpath`` key). Exit 0 clean, 1
diagnostics (a scan finding included), 2 a predicted budget violation or
a usage error. ``--budget BYTES`` (``MiB``/``GiB`` suffixes) gates each
app's fit-path peak; ``--shards N`` plans one rank's share of an
N-shard world (resident batches padded to N, serving charges under the
sharded apply); ``--replicas
N`` (with ``--budget`` as each replica's budget) solves the apps' static
serving charges into an N-replica placement (``serving/placement.py``).
``--json PATH`` writes the full report. ``--xla`` is the counterpart
of the JAX ``check --xla``: each planner-resolved per-item node runs
once on one zero item on ``--device`` (default ``cuda``), and its plan
charge is set against the bytes it outputs (``plan_vs_device``, the
``xla_verify`` rows of ``--json``; advisory). ``benchdiff`` is the
bench-regression gate over ``BENCH_r*.json`` artifacts
(``observability/benchdiff.py``), ``numerics`` renders a numerics
post-mortem (``observability/numerics.py``), ``serve`` is the serving
plane's command (``serving/http.py``).

A world of several processes (``parallel/mesh.py``): every rank runs
the same command with ``--coordinator HOST:PORT`` (or ``file://PATH``),
``--num-processes N`` and its own ``--process-id``, or with
``KEYSTONE_TORCH_DISTRIBUTED=1`` and torchrun's environment (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``). The world starts before the
app on the app's ``--device`` and ends after it.
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

#: the multi-process flags: flag -> (initialize_distributed keyword, type)
DISTRIBUTED_FLAGS = {"--coordinator": ("coordinator_address", str),
                     "--num-processes": ("num_processes", int),
                     "--process-id": ("process_id", int)}


def _usage() -> None:
    print("usage: python -m keystone_tpu_torch <app> [--flags] "
          "[--device cuda|cpu] [--trace-out PATH]\n"
          "       python -m keystone_tpu_torch check <app>|--all "
          "[--shards N] [--xla [--device cuda|cpu]]\n"
          "       python -m keystone_tpu_torch benchdiff BASE.json "
          "CURRENT.json\n"
          "       python -m keystone_tpu_torch numerics POSTMORTEM.json\n"
          "       python -m keystone_tpu_torch serve "
          "NAME=PATH@SHAPE[:DTYPE] ...\n\napps:")
    for name in sorted(APPS):
        print(f"  {name}")


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
    [--budget BYTES] [--replicas N] [--xla [--device cuda|cpu]]``: the
    JAX package's ``check`` (``keystone_tpu/__main__.py::check_main``)
    over the port's apps and tree, with its exit codes: 0 clean, 1
    diagnostics (a concurrency or hot-path finding included), 2 a
    predicted budget violation or a usage error. ``--budget`` gates each
    app's static fit-path peak; ``--replicas N`` with ``--budget`` as
    each replica's budget solves the apps' static serving charges into
    an N-replica placement (``serving/placement.py``), exit 2 naming the
    first app no replica can host. ``--xla`` runs each per-item node once
    on ``--device`` against its plan charge
    (``analysis/resources.py::device_verify_plan``). ``--shards N`` plans
    one rank's share of an N-shard world."""
    rest = list(rest)
    found, json_out = _take_value(rest, "--json", "a path")
    if found and json_out is None:
        return 2
    verify = "--xla" in rest
    if verify:
        rest.remove("--xla")
    found, device = _take_value(rest, "--device", "cuda or cpu")
    if found and device is None:
        return 2
    if device is not None and not verify:
        print("--device applies to check --xla (the node runs); the rest "
              "of check touches no device", file=sys.stderr)
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
    found, text = _take_value(rest, "--shards", "a data-shard count (e.g. 8)")
    shards = None
    if found:
        try:
            shards = int(text) if text is not None else None
            if shards is not None and shards < 1:
                raise ValueError(shards)
        except ValueError:
            print(f"--shards expects a positive integer, got {text!r}",
                  file=sys.stderr)
            return 2
        if shards is None:
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

    from .analysis.concurrency import scan_package as scan_concurrency
    from .analysis.diagnostics import scan_metric_names
    from .analysis.hotpath import scan_package as scan_hotpath
    from .analysis.spmd import scan_package as scan_spmd
    from .pipelines import CHECK_APPS, resolve_check_app

    if not rest or rest[0] in ("-h", "--help"):
        print("usage: python -m keystone_tpu_torch check <app>|--all "
              "[--json PATH] [--budget BYTES] [--shards N] [--replicas N] "
              "[--xla [--device cuda|cpu]]\n\napps:")
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

    if verify:
        from .ops.device import resolve_device

        try:
            device = resolve_device("cuda" if device is None else device)
        except (RuntimeError, ValueError) as exc:
            print(f"check --xla: {exc}", file=sys.stderr)
            return 2
    pkg_root = os.path.dirname(os.path.abspath(__file__))
    # the tree-wide scans: guarded-by races, lock order, blocking under a
    # lock and split guarded sequences; metric-name drift against the
    # catalogue (observability/names.py); the SPMD contract of the
    # collective sites (analysis/spmd.py); the hot path's hazards from
    # every @hotpath entry point and the @published_by discipline
    scans = {}
    for key, scan in (("concurrency", scan_concurrency),
                      ("metrics_names", scan_metric_names),
                      ("spmd", scan_spmd),
                      ("hotpath", scan_hotpath)):
        scans[key] = scan(pkg_root)
        for hit in scans[key]:
            print(f"{hit['file']}:{hit['lineno']}: {hit['code']}: "
                  f"{hit['message']}", file=sys.stderr)
    failed = sum(1 for hits in scans.values() if hits)
    over_budget = 0
    reports = []
    for build in builders:
        target = build()
        report = target.pipeline.check(target.input_spec, name=target.name,
                                       hbm_budget=budget, data_shards=shards)
        reports.append(report)
        print(report.summary(), file=sys.stderr)
        if verify:
            from .analysis.resources import (device_verify_plan,
                                             format_device_verify)

            report.xla_verify = device_verify_plan(report.analysis,
                                                   report.plan, device)
            print(format_device_verify(report.xla_verify, target.name,
                                       device), file=sys.stderr)
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
        fleet_placement = _fleet_placement(reports, replicas, budget,
                                           shards or 1)
        over_budget += "infeasible" in fleet_placement
    for key, label in (("concurrency", "concurrency"),
                       ("metrics_names", "metrics names"),
                       ("spmd", "spmd"), ("hotpath", "hotpath")):
        print(f"{label}: {_verdict(scans[key])}")
    if json_out is not None:
        def dump(report):
            d = report.to_dict()
            if getattr(report, "xla_verify", None) is not None:
                d["xla_verify"] = report.xla_verify
            return d

        if len(reports) == 1:
            blob = dump(reports[0])
            blob.update(scans)
        else:
            blob = {"apps": [dump(r) for r in reports], **scans}
        if fleet_placement is not None:
            blob["fleet_placement"] = fleet_placement
        with open(json_out, "w") as f:
            f.write(json.dumps(blob, indent=2))
        print(f"report written to {json_out}", file=sys.stderr)
    if over_budget:
        return 2  # a predicted device-memory violation, before any work
    return 1 if failed else 0


def _verdict(hits) -> str:
    return "clean" if not hits else f"{len(hits)} diagnostic(s)"


def _fleet_placement(reports, replicas: int, budget: float,
                     shards: int = 1) -> dict:
    """The checked apps' static serving charges at a 64-row bucket (one
    rank's share under the sharded apply when ``shards > 1``), solved
    into ``replicas`` replicas of ``budget`` bytes. The CUDA graphs'
    pools a CUDA plane charges at admission are measured only by a probe
    capture on the card (``serving/residency.py``), so the static charge
    leaves them out."""
    from .analysis.resources import (serving_residency_nbytes,
                                     sharded_apply_nbytes)
    from .serving.placement import ModelDemand, PlacementError, \
        plan_placement

    bucket_rows = 64
    demands, unsized = [], []
    for report in reports:
        shardable, gather = (sharded_apply_nbytes(report.analysis.graph)
                             if shards > 1 else (0.0, 0.0))
        charge = serving_residency_nbytes(
            report.plan.model_nbytes, report.plan, bucket_rows,
            data_shards=shards, shardable_nbytes=shardable,
            gather_nbytes=gather)
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
    dist_args = {}
    for flag, (key, cast) in DISTRIBUTED_FLAGS.items():
        found = [i for i, a in enumerate(rest)
                 if a == flag or a.startswith(flag + "=")]
        if not found:
            continue
        i = found[0]
        if rest[i] == flag:
            if i + 1 >= len(rest):
                print(f"{flag} requires a value", file=sys.stderr)
                return 2
            text = rest[i + 1]
            del rest[i:i + 2]
        else:
            text = rest[i].split("=", 1)[1]
            del rest[i]
        try:
            dist_args[key] = cast(text)
        except ValueError:
            print(f"{flag} expects {cast.__name__}, got {text!r}",
                  file=sys.stderr)
            return 2
    if dist_args and "coordinator_address" not in dist_args:
        print("--num-processes/--process-id require --coordinator "
              "(without it the world comes from torchrun's environment: "
              "set KEYSTONE_TORCH_DISTRIBUTED=1 instead)", file=sys.stderr)
        return 2
    world_started = False
    if os.environ.get("KEYSTONE_TORCH_DISTRIBUTED") or dist_args:
        # every rank runs the same command; the world starts before the
        # app touches a device, on the app's own --device
        from .parallel.mesh import initialize_distributed

        device = "cuda"
        if "--device" in rest and rest.index("--device") + 1 < len(rest):
            device = rest[rest.index("--device") + 1]
        try:
            initialize_distributed(device=device, **dist_args)
        except ValueError as exc:
            print(f"multi-process launch: {exc}", file=sys.stderr)
            return 2
        world_started = True
    try:
        return _run_app(app, rest)
    finally:
        if world_started:
            from .parallel.mesh import shutdown_distributed

            shutdown_distributed()


def _run_app(app: str, rest) -> int:
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
