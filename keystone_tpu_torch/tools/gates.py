"""What the port's gate scripts share: the ``--device`` argument, a
named failure, subprocesses read and stopped under deadlines, and the
small fitted model the serving gates admit.

The gates (each ``python -m keystone_tpu_torch.tools.<gate> [--device
cuda|cpu]``, default ``cuda``, exit 0 clean and non-zero with a named
reason): ``recompile_gate``, ``numerics_gate``, ``elastic_gate``,
``serving_gate``, ``chaos_gate`` and ``fleet_gate``; ``ci`` chains them.
"""
from __future__ import annotations

import argparse
import os
import re
import select
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Optional, Sequence, Tuple

import numpy as np

REPO = Path(__file__).resolve().parent.parent.parent


def parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; refused without a card) or "
                         "cpu")
    return ap


def resolve(name: str, device: str):
    """The ``torch.device`` of ``--device``; None after printing the
    named reason when it cannot be had."""
    from ..ops.device import resolve_device

    try:
        return resolve_device(device)
    except (RuntimeError, ValueError) as exc:
        fail(name, str(exc))
        return None


def fail(name: str, reason: str) -> int:
    print(f"{name}: FAIL: {reason}", file=sys.stderr, flush=True)
    return 1


def child_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def spawn(args: Sequence[str]) -> subprocess.Popen:
    """``python -m <args>`` from the repository root, its stdout and
    stderr merged into one text pipe."""
    return subprocess.Popen([sys.executable, "-m", *args],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            cwd=str(REPO), env=child_env())


def read_until(proc: subprocess.Popen, pattern: str, deadline: float,
               tag: str) -> Optional[re.Match]:
    """Echo ``proc``'s lines until one matches ``pattern``; None when the
    process ends or the deadline passes first (a wedged start fails the
    gate, not the wall clock)."""
    regex = re.compile(pattern)
    while time.monotonic() < deadline:
        readable, _, _ = select.select(
            [proc.stdout], [], [],
            max(0.0, min(1.0, deadline - time.monotonic())))
        if not readable:
            if proc.poll() is not None:
                return None
            continue
        line = proc.stdout.readline()
        if not line:
            return None
        print(f"  {tag}: {line.rstrip()}", flush=True)
        match = regex.search(line)
        if match:
            return match
    return None


def stop(procs: Sequence[subprocess.Popen], timeout_s: float = 10.0
         ) -> None:
    """Terminate, wait up to ``timeout_s`` each, then kill."""
    for proc in procs:
        if proc.poll() is None:
            proc.terminate()
    for proc in procs:
        try:
            proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=timeout_s)
        if proc.stdout is not None:
            proc.stdout.close()


def fit_linear(d: int, k: int, seed: int, device: Any) -> Tuple[Any, Any]:
    """A small fitted ``LinearMapEstimator`` pipeline on ``device`` and
    its training rows (host float32)."""
    from ..nodes.learning.linear import LinearMapEstimator
    from ..parallel.dataset import ArrayDataset

    r = np.random.RandomState(seed)
    X = r.rand(96, d).astype(np.float32)
    Y = r.rand(96, k).astype(np.float32)
    fitted = LinearMapEstimator(lam=1e-3).with_data(
        ArrayDataset.from_numpy(X, device),
        ArrayDataset.from_numpy(Y, device)).fit()
    return fitted, X


def post_json(host: str, port: int, path: str, body: bytes,
              timeout_s: float = 30.0) -> Tuple[int, bytes, dict]:
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/json"})
        rsp = conn.getresponse()
        return rsp.status, rsp.read(), dict(rsp.getheaders())
    finally:
        conn.close()


def get(host: str, port: int, path: str,
        timeout_s: float = 5.0) -> Tuple[int, bytes]:
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
    try:
        conn.request("GET", path)
        rsp = conn.getresponse()
        return rsp.status, rsp.read()
    finally:
        conn.close()


def prometheus(text: str) -> dict:
    """``{sample name: value}`` of a Prometheus text exposition."""
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or " " not in line:
            continue
        key, value = line.rsplit(" ", 1)
        try:
            out[key] = float(value)
        except ValueError:
            continue
    return out

