"""The recompile gate: a second epoch captures nothing new.

    python -m keystone_tpu_torch.tools.recompile_gate [--device cuda|cpu]

Counterpart of the repository's ``tools/recompile_gate.py``. The port's
compile is a CUDA-graph capture, counted by the capture observatory
(``observability/compilelog.py``). Two steady states are checked:

1. **A streamed fit.** The same streamed least-squares fit (a fresh
   ``StreamingDataset`` each epoch, uint8 on the wire, a tanh featurize
   per chunk, the Gram carry through ``gram_cross`` on a card) runs
   twice; the second runs under ``expect_no_compiles``, and any capture
   in it fails the gate, named with its site and trigger.
2. **Served traffic.** A bf16 model is admitted to a ``ServingPlane``
   (every bucket captured at admission on a card) and the same requests
   across four buckets are sent twice; any capture during the second
   pass, or any capture the plane's steady-state fence counts as
   unexpected, fails the gate.

On the CPU nothing is captured, so the gate checks that the observatory
stays at zero. Exit 0 clean, 1 with the offending captures named.
"""
from __future__ import annotations

import sys

import numpy as np

from . import gates

NAME = "recompile gate"


def _streamed_epoch(imgs, labels, device):
    import torch

    from ..nodes.learning.linear import LinearMapEstimator
    from ..parallel.streaming import StreamingDataset, fit_streaming

    def featurize(ad):
        return ad.map_batch(lambda x: torch.tanh(x.float() / 255.0))

    stream = StreamingDataset.from_numpy(
        imgs, 64, device=device, tag="recompile-gate").map_chunks(featurize)
    return fit_streaming(LinearMapEstimator(lam=0.1), stream, labels)


def _named(records) -> str:
    return "; ".join(f"{r.get('name')} ({r.get('trigger')})"
                     for r in records) or "none recorded"


def main(argv=None) -> int:
    args = gates.parser(__doc__.splitlines()[0]).parse_args(argv)
    device = gates.resolve(NAME, args.device)
    if device is None:
        return 2
    from ..observability.compilelog import (compile_observatory,
                                            expect_no_compiles)
    from ..serving import ServingPlane
    from ..serving.models import ItemSpec

    obs = compile_observatory()
    rng = np.random.RandomState(0)
    n = 256
    imgs = (rng.rand(n, 8 * 8 * 3) * 255).astype(np.uint8)
    y = rng.randint(0, 10, n)
    labels = (-np.ones((n, 10)) + 2.0 * np.eye(10)[y]).astype(np.float32)

    c0 = obs.count_total()
    _streamed_epoch(imgs, labels, device)
    first = obs.count_total() - c0
    c1, u1 = obs.count_total(), obs.unexpected_total()
    with expect_no_compiles("recompile-gate:second-epoch"):
        _streamed_epoch(imgs, labels, device)
    new, unexpected = obs.count_total() - c1, obs.unexpected_total() - u1
    print(f"{NAME}: streamed fit on {device}: epoch 1 captured {first}, "
          f"epoch 2 captured {new} ({unexpected} unexpected)", flush=True)
    if new or unexpected:
        return gates.fail(NAME, f"the second epoch of a fixed-shape "
                                f"streamed fit captured {new} graph(s): "
                                f"{_named(obs.tail()[-max(new, 1):])}")

    fitted, X = gates.fit_linear(32, 4, 3, device)
    with ServingPlane(max_batch=16, default_weight_dtype="bf16",
                      device=device) as plane:
        plane.admit("gate", fitted, ItemSpec((32,), np.float32))
        sizes = (1, 3, 7, 11)

        def traffic():
            for rows in sizes:
                out = plane.predict("gate", X[:rows], timeout_s=60.0)
                if out.shape != (rows, 4):
                    raise AssertionError(f"served {out.shape} for "
                                         f"{rows} rows")

        try:
            traffic()
            c2, u2 = obs.count_total(), plane.unexpected_recompiles()
            traffic()
        except (AssertionError, RuntimeError) as exc:
            return gates.fail(NAME, f"serving failed: {exc}")
        new = obs.count_total() - c2
        unexpected = plane.unexpected_recompiles() - u2
        print(f"{NAME}: served traffic on {device}: "
              f"{plane.state()['graphs']} graph(s) held from admission; "
              f"the second pass captured {new} ({unexpected:g} "
              "unexpected)", flush=True)
        if new or unexpected:
            return gates.fail(NAME, f"the second pass of served traffic "
                                    f"captured {new} graph(s): "
                                    f"{_named(obs.tail()[-max(new, 1):])}")
    from ..ops import kernels

    print(f"{NAME}: kernel launches in this process "
          f"{dict(kernels.LAUNCHES)}", flush=True)
    print(f"{NAME}: PASS", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
