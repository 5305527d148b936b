"""The serving gate: ``serve`` in a subprocess, readiness, requests, and
no unexpected capture.

    python -m keystone_tpu_torch.tools.serving_gate [--device cuda|cpu]

Counterpart of the repository's ``tools/serving_gate.py``, the
deployment shape end to end:

1. the hot-path scan (``analysis/hotpath.py``) is clean and within
   ``HOTPATH_SCAN_BUDGET_S``;
2. two small models are fitted on the device and saved with
   ``save_pipeline``, and ``python -m keystone_tpu_torch serve`` starts
   as a SUBPROCESS on an ephemeral port with both, as bf16 (the
   ``quantized_affine`` kernel on a card), binding before it admits;
3. ``/healthz`` turns 200 within ``READY_TIMEOUT_S``;
4. requests of 1, 3, 7 and 11 rows (three buckets) go to both models,
   three times each: every reply has the rows and width asked for and a
   distinct ``X-Keystone-Trace`` header;
5. ``/metrics``: ``compile.unexpected_total`` is 0 (the plane's
   steady-state fence counts any capture after admission) and
   ``serving.requests_total`` saw every request; ``/slo`` reports
   availability 1.0 and no violation;
6. in process (a ``FaultPlan`` is process-wide): a plane under a tight
   SLO policy and a ``serve.dispatch`` straggler must trip the SLO,
   recording a violation named for the model with its post-mortem on
   disk.

Exit 0 clean, 1 with a named reason. The server is stopped (SIGTERM,
then a kill after 10 s) on every path.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from . import gates

NAME = "serving gate"
READY_TIMEOUT_S = 240.0
DIMS = {"alpha": (24, 3), "beta": (32, 4)}


def _hotpath_scan() -> int:
    from ..analysis.hotpath import HOTPATH_SCAN_BUDGET_S, scan_package

    t0 = time.perf_counter()
    hits = scan_package(gates.REPO / "keystone_tpu_torch")
    scan_s = time.perf_counter() - t0
    for hit in hits:
        print(f"  {hit['file']}:{hit['lineno']}: {hit['code']}: "
              f"{hit['message']}", file=sys.stderr)
    if hits:
        return gates.fail(NAME, f"{len(hits)} hot-path/publication "
                                "diagnostic(s) before any load")
    if scan_s > HOTPATH_SCAN_BUDGET_S:
        return gates.fail(NAME, f"the hot-path scan took {scan_s:.2f}s > "
                                f"{HOTPATH_SCAN_BUDGET_S:.0f}s")
    print(f"{NAME}: hot-path scan clean in {scan_s:.2f}s (budget "
          f"{HOTPATH_SCAN_BUDGET_S:.0f}s)", flush=True)
    return 0


def main(argv=None) -> int:
    args = gates.parser(__doc__.splitlines()[0]).parse_args(argv)
    device = gates.resolve(NAME, args.device)
    if device is None:
        return 2
    if _hotpath_scan():
        return 1
    tmp = tempfile.mkdtemp(prefix="keystone-serving-gate-")
    try:
        rc = _subprocess_phase(device, tmp)
        return rc if rc else _straggler_phase(device, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _subprocess_phase(device, tmp) -> int:
    from ..utils.checkpoint import save_pipeline

    specs = []
    for name, (d, k) in DIMS.items():
        fitted, _ = gates.fit_linear(d, k, d, device)
        path = os.path.join(tmp, f"{name}.pkl")
        save_pipeline(fitted, path)
        specs.append(f"{name}={path}@{d}:float32")
    proc = gates.spawn(["keystone_tpu_torch", "serve", *specs, "--port",
                        "0", "--hbm-budget", "256MiB", "--max-batch", "16",
                        "--weight-dtype", "bf16", "--device", str(device)])
    try:
        deadline = time.monotonic() + READY_TIMEOUT_S
        bound = gates.read_until(proc, r"serving on ([\d.]+):(\d+)",
                                 deadline, "server")
        if bound is None:
            return gates.fail(NAME, "the server printed no 'serving on' "
                                    "line (it exited or wedged)")
        host, port = bound.group(1), int(bound.group(2))
        saw_warming = False
        while True:
            if time.monotonic() > deadline:
                return gates.fail(NAME, f"/healthz not ready in "
                                        f"{READY_TIMEOUT_S:.0f}s")
            try:
                status, _ = gates.get(host, port, "/healthz", 2.0)
            except OSError:
                time.sleep(0.2)
                continue
            if status == 503:
                saw_warming = True
                time.sleep(0.2)
                continue
            if status == 200:
                break
            return gates.fail(NAME, f"/healthz answered {status}")
        print(f"{NAME}: ready on port {port} (warming seen: "
              f"{saw_warming})", flush=True)
        sent, traces = 0, set()
        for name, (d, k) in DIMS.items():
            for rows in (1, 3, 7, 11):
                body = json.dumps({"instances": [[0.5] * d] * rows}).encode()
                for _ in range(3):
                    status, raw, headers = gates.post_json(
                        host, port, f"/predict/{name}", body)
                    if status != 200:
                        return gates.fail(NAME, f"predict {name} rows={rows} "
                                                f"answered {status}: "
                                                f"{raw[:160]!r}")
                    out = json.loads(raw)
                    preds = out.get("predictions") or []
                    if out.get("rows") != rows or len(preds) != rows \
                            or len(preds[0]) != k:
                        return gates.fail(NAME, f"bad reply for {name} "
                                                f"rows={rows}: "
                                                f"{out.get('rows')} rows")
                    trace = headers.get("X-Keystone-Trace")
                    if not trace:
                        return gates.fail(NAME, f"the reply for {name} "
                                                f"rows={rows} carried no "
                                                "X-Keystone-Trace")
                    traces.add(trace)
                    sent += 1
        if len(traces) != sent:
            return gates.fail(NAME, f"{len(traces)} distinct trace ids for "
                                    f"{sent} requests")
        status, raw = gates.get(host, port, "/metrics")
        if status != 200:
            return gates.fail(NAME, f"/metrics answered {status}")
        metrics = gates.prometheus(raw.decode())
        unexpected = metrics.get("keystone_compile_unexpected_total_total",
                                 0.0)
        if unexpected:
            return gates.fail(NAME, f"{unexpected:g} capture(s) after "
                                    "admission: a bucket was not captured "
                                    "at warmup")
        served = metrics.get("keystone_serving_requests_total_total", 0.0)
        if served < sent:
            return gates.fail(NAME, f"serving.requests_total={served:g} < "
                                    f"the {sent} requests sent")
        status, raw = gates.get(host, port, "/slo")
        slo = json.loads(raw) if status == 200 else {}
        if status != 200 or slo.get("availability") != 1.0 \
                or slo.get("violations"):
            return gates.fail(NAME, f"/slo of a clean run: status {status}, "
                                    f"availability "
                                    f"{slo.get('availability')}, "
                                    f"{len(slo.get('violations') or [])} "
                                    "violation(s)")
        print(f"{NAME}: {sent} requests over {len(DIMS)} models and three "
              f"buckets on {device}, {len(traces)} trace ids, 0 unexpected "
              "captures, /slo clean", flush=True)
        return 0
    finally:
        gates.stop([proc])


def _straggler_phase(device, tmp) -> int:
    from ..observability.slo import SloPolicy
    from ..resilience.faults import FaultPlan
    from ..serving import ServingPlane
    from ..serving.models import ItemSpec

    os.environ["KEYSTONE_TORCH_POSTMORTEM_DIR"] = tmp
    fitted, X = gates.fit_linear(16, 3, 7, device)
    policy = SloPolicy(latency_threshold_ms=50.0, availability_target=0.95,
                       window=8, min_count=8)
    with ServingPlane(max_batch=16, slo_policy=policy,
                      device=device) as plane:
        plane.admit("straggle", fitted, ItemSpec((16,), np.float32))
        plane.predict("straggle", X[:4], timeout_s=60.0)
        with FaultPlan(0).add("serve.dispatch", kind="straggler",
                              delay_s=0.2):
            for _ in range(10):
                plane.predict("straggle", X[:2], timeout_s=60.0)
        state = plane.slo.state()
    violations = state.get("violations") or []
    hit = [v for v in violations if v.get("model") == "straggle"]
    if not hit:
        return gates.fail(NAME, "a 200 ms straggler under a 50 ms SLO did "
                                "not trip the SLO")
    path = hit[0].get("postmortem")
    if not path or not os.path.exists(path):
        return gates.fail(NAME, "the SLO violation wrote no post-mortem")
    print(f"{NAME}: the straggler tripped the SLO "
          f"(window {hit[0].get('window')}), post-mortem written",
          flush=True)
    print(f"{NAME}: PASS", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
