"""The numerics gate: an injected NaN trips the tripwire; a clean fit
does not.

    python -m keystone_tpu_torch.tools.numerics_gate [--device cuda|cpu]

Counterpart of the repository's ``tools/numerics_gate.py``, on the
port's data-health plane (``observability/numerics.py``):

1. a clean streamed least-squares fit (16 chunks of 64 rows, the Gram
   carry through ``gram_cross`` on a card) must pull health words and
   write NO post-mortem;
2. the same fit with one chunk corrupted by a seeded ``corrupt`` fault
   at ``ingest.stage`` must raise ``NumericsError`` naming the chunk and
   the stream, with a post-mortem whose health series shows that chunk
   non-finite.

Post-mortems go to a temporary directory, removed at the end. Exit 0
clean, 1 naming the direction of the contract that broke.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile

import numpy as np

from . import gates

NAME = "numerics gate"
POISON_CHUNK = 2


def _fit(tag, device):
    import torch

    from ..nodes.learning.linear import LinearMapEstimator
    from ..parallel.streaming import StreamingDataset, fit_streaming

    rng = np.random.RandomState(0)
    n, d = 1024, 64
    X = rng.rand(n, d).astype(np.float32)
    y = rng.randint(0, 10, n)
    labels = (-np.ones((n, 10)) + 2.0 * np.eye(10)[y]).astype(np.float32)
    stream = StreamingDataset.from_numpy(X, 64, device=device, tag=tag)
    stream = stream.map_chunks(lambda ad: ad.map_batch(torch.tanh))
    return fit_streaming(LinearMapEstimator(lam=0.1), stream, labels)


def main(argv=None) -> int:
    args = gates.parser(__doc__.splitlines()[0]).parse_args(argv)
    device = gates.resolve(NAME, args.device)
    if device is None:
        return 2
    os.environ.pop("KEYSTONE_TORCH_NUMERICS", None)  # the plane is on
    pm_dir = tempfile.mkdtemp(prefix="keystone-numerics-gate-")
    os.environ["KEYSTONE_TORCH_POSTMORTEM_DIR"] = pm_dir
    try:
        return _run(device, pm_dir)
    finally:
        shutil.rmtree(pm_dir, ignore_errors=True)


def _run(device, pm_dir) -> int:
    from ..observability.metrics import MetricsRegistry
    from ..observability.numerics import NumericsError
    from ..resilience.faults import FaultPlan

    reg = MetricsRegistry.get_or_create()
    words0 = reg.counter("numerics.health_words").value
    _fit("numerics-gate-clean", device)
    words = reg.counter("numerics.health_words").value - words0
    dumped = os.listdir(pm_dir)
    print(f"{NAME}: clean fit on {device}: {words:g} health word(s) "
          f"pulled, {len(dumped)} post-mortem(s)", flush=True)
    if not words:
        return gates.fail(NAME, "the clean fit pulled no health word: the "
                                "numerics plane did not run")
    if dumped:
        return gates.fail(NAME, f"a CLEAN fit wrote post-mortem(s) "
                                f"{dumped}: the tripwire fired on healthy "
                                "data")
    tag = "numerics-gate-poisoned"
    try:
        with FaultPlan(seed=7).add("ingest.stage", kind="corrupt",
                                   after=POISON_CHUNK, count=1):
            _fit(tag, device)
    except NumericsError as exc:
        msg = str(exc)
        if f"chunk {POISON_CHUNK}" not in msg or tag not in msg:
            return gates.fail(NAME, f"the tripwire fired but named neither "
                                    f"chunk {POISON_CHUNK} nor stream "
                                    f"{tag!r}: {msg}")
        path = getattr(exc, "postmortem_path", None)
        if path is None or not os.path.exists(path):
            return gates.fail(NAME, "the tripwire fired without a "
                                    "post-mortem")
        with open(path) as f:
            series = (json.load(f).get("context") or {}).get(
                "recent_health") or []
        if not [e for e in series if e.get("chunk") == POISON_CHUNK
                and (e.get("nan") or e.get("inf"))]:
            return gates.fail(NAME, f"the post-mortem's health series does "
                                    f"not show chunk {POISON_CHUNK} "
                                    f"non-finite ({len(series)} entries)")
        print(f"{NAME}: injected NaN in chunk {POISON_CHUNK} tripped "
              "NumericsError naming chunk and stream, with the health "
              "series in its post-mortem", flush=True)
        from ..ops import kernels

        print(f"{NAME}: kernel launches in this process "
              f"{dict(kernels.LAUNCHES)}", flush=True)
        print(f"{NAME}: PASS", flush=True)
        return 0
    return gates.fail(NAME, "the poisoned fit finished without raising "
                            "NumericsError: the tripwire is dead")


if __name__ == "__main__":
    sys.exit(main())
