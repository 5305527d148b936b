"""The port's command line (the analogue of the reference's
``bin/run-pipeline.sh <class> --flags``):

    python -m keystone_tpu_torch <app> [--flags] [--device cuda|cpu]
                                       [--trace-out PATH]
    python -m keystone_tpu_torch serve NAME=PATH@SHAPE[:DTYPE] ... [--port P]

Counterpart of ``keystone_tpu/__main__.py``. Run with no arguments to
list the apps. Each app's ``main`` takes the JAX package's flags and
defaults, plus ``--device`` (default ``cuda``: without a card the app
raises). ``--trace-out PATH`` runs the app under a
:class:`~keystone_tpu_torch.observability.trace.PipelineTrace` and writes
its JSON to PATH (a PATH ending ``.perfetto.json`` gets the flight
recorder's Chrome trace instead), with a per-node summary on stderr.
``serve`` is the serving plane's command (``serving/http.py``).

What the port does not have yet exits 2 naming its ROADMAP item: the
text and NLP apps (A8), the ``check`` and ``numerics`` subcommands
(A12), ``benchdiff`` (A9b) and the multi-process launch
(``--coordinator``, ``--num-processes``, ``--process-id``,
``KEYSTONE_DISTRIBUTED``; A11).
"""
from __future__ import annotations

import importlib
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
}

#: the JAX package's commands and launch switches the port has not yet,
#: with the ROADMAP item that brings each
NOT_PORTED = {
    "text.newsgroups": "A8",
    "text.amazon_reviews": "A8",
    "nlp.stupid_backoff": "A8",
    "check": "A12",
    "numerics": "A12",
    "benchdiff": "A9b",
}
DISTRIBUTED_FLAGS = ("--coordinator", "--num-processes", "--process-id")


def _usage() -> None:
    print("usage: python -m keystone_tpu_torch <app> [--flags] "
          "[--device cuda|cpu] [--trace-out PATH]\n"
          "       python -m keystone_tpu_torch serve "
          "NAME=PATH@SHAPE[:DTYPE] ...\n\napps:")
    for name in sorted(APPS):
        print(f"  {name}")


def _refuse(what: str, item: str) -> int:
    print(f"{what} is not ported to keystone_tpu_torch yet (ROADMAP {item})",
          file=sys.stderr)
    return 2


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        _usage()
        return 0
    app, rest = argv[0], argv[1:]
    if app == "serve":
        from .serving.http import main as serve_main

        return serve_main(rest)
    if app in NOT_PORTED:
        return _refuse(repr(app), NOT_PORTED[app])
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

    with PipelineTrace(app) as tr:
        mod.main(rest)
    kind = write_trace_artifact(trace_out, tr)
    print(tr.summary(), file=sys.stderr)
    print(f"{kind} written to {trace_out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
