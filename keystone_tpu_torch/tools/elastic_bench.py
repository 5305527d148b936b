"""The 1-against-N-rank scaling bench of the streamed fit.

    python -m keystone_tpu_torch.tools.elastic_bench [--processes N] \
        [--rows R] [--dim D] [--chunk-size C] [--cold] [--device cuda|cpu]

Counterpart of the repository's ``tools/elastic_bench.py``. The same
shard-local streamed ``LinearMapEstimator`` fit runs in a world of 1 rank
and in a world of N (default 2) through
``parallel.distributed.DryrunWorld`` and ``python -m
keystone_tpu_torch.parallel.dryrun_worker --bench``: real
``torch.distributed`` worlds, real coordination rounds, the carries
merged at finalize. Rank 0 of each world prints its rows a second; this
tool prints the reference's five metric lines::

    {"metric": "elastic_streamed_images_per_sec_1p", "value": ...}
    {"metric": "elastic_streamed_images_per_sec_2p", "value": ...}
    {"metric": "elastic_scaling_efficiency", "value": ...}
    {"metric": "coord_overhead_share", "value": ...}
    {"metric": "coord_overlap_occupancy", "value": ...}

``elastic_scaling_efficiency`` is (N-rank rows/s) / (N x 1-rank rows/s).
Ranks on one machine share it (on one card they share the card and meet
over gloo, ``parallel/mesh.py``'s backend rule), so the number bounds what
the rounds and the merge cost when the work itself cannot spread; across
cards the same harness measures scaling. The coordination pair (blocked
await wall over round wall, and its complement) comes from the N-rank
world.

Both worlds fit warm by default (``--cold`` turns it off): each rank fits
once untimed first, so a process's start and first launches are not
spread over the rows. The numerics plane is off in both worlds
(``KEYSTONE_TORCH_NUMERICS=0``), as in the reference: its per-chunk
health word would be timed in both, and the ratio is to measure the
coordination. Defaults: 32768 rows of 64 float32 features, 8 labels,
chunks of 256, on ``cuda``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys
import tempfile
from typing import List

import numpy as np

WORLD_TIMEOUT_S = 900.0


def _run_world(nproc, npz, chunk, workdir, device, warmup=True):
    """Rank 0's rows a second, its ``ELASTIC_OK`` lines and its
    coordination metric lines, from a world of ``nproc`` ranks."""
    from ..parallel.distributed import DryrunWorld

    world = DryrunWorld(num_processes=nproc,
                        workdir=os.path.join(workdir, f"w{nproc}"),
                        grace_s=30, env={"KEYSTONE_TORCH_NUMERICS": "0"})
    cmd = [sys.executable, "-m", "keystone_tpu_torch.parallel.dryrun_worker",
           "--data", npz, "--chunk-size", str(chunk), "--bench",
           "--device", device]
    if warmup:
        cmd.append("--warmup")
    codes = world.launch(cmd).wait(timeout_s=WORLD_TIMEOUT_S)
    if any(codes):
        for p in range(nproc):
            print(world.output(p)[-1500:], file=sys.stderr)
        raise SystemExit(f"elastic bench: world size {nproc} failed (exit "
                         f"codes {codes})")
    out = world.output(0)
    m = re.search(r'^\{.*"elastic_streamed_images_per_sec".*\}$', out,
                  re.MULTILINE)
    if not m:
        raise SystemExit(f"elastic bench: world size {nproc} printed no "
                         "metric line")
    fence = [line for p in range(nproc)
             for line in world.output(p).splitlines()
             if line.startswith("ELASTIC_OK")]
    coord = [json.loads(line) for line in out.splitlines()
             if line.startswith("{") and '"coord_' in line]
    return float(json.loads(m.group(0))["value"]), fence, coord


def bench(nproc: int = 2, rows: int = 32768, dim: int = 64,
          chunk: int = 256, warmup: bool = True,
          device: str = "cuda") -> List[dict]:
    """Run both worlds on seeded data; returns the metric lines (dicts)
    in the order the tool prints them."""
    from ..ops.device import resolve_device

    resolve_device(device)
    workdir = tempfile.mkdtemp(prefix="keystone-elastic-bench-")
    try:
        rng = np.random.RandomState(0)
        npz = os.path.join(workdir, "data.npz")
        np.savez(npz, X=rng.randn(rows, dim).astype(np.float32),
                 Y=rng.randn(rows, 8).astype(np.float32))
        print(f"elastic bench: {rows}x{dim} f32, chunk {chunk}, world sizes "
              f"1 and {nproc} on {device} "
              f"({'warm steady state' if warmup else 'cold'})", flush=True)
        ips_1, _, _ = _run_world(1, npz, chunk, workdir, device, warmup)
        ips_n, fence, coord = _run_world(nproc, npz, chunk, workdir,
                                         device, warmup)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for line in fence:
        print(line, flush=True)
    efficiency = ips_n / (nproc * ips_1) if ips_1 else 0.0
    return [
        {"metric": "elastic_streamed_images_per_sec_1p", "value": ips_1,
         "rows": rows, "dim": dim, "warm": warmup, "device": device},
        {"metric": f"elastic_streamed_images_per_sec_{nproc}p",
         "value": ips_n, "rows": rows, "dim": dim, "warm": warmup,
         "device": device},
        {"metric": "elastic_scaling_efficiency", "value": efficiency,
         "processes": nproc,
         "note": "ranks share one machine (and one card where there is "
                 "one): what the rounds and the merge cost when the work "
                 "cannot spread, not a scaling claim"},
        *coord,
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--rows", type=int, default=32768)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--chunk-size", type=int, default=256)
    ap.add_argument("--cold", action="store_true",
                    help="no untimed fit before the timed one")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; refused without a card) or cpu")
    args = ap.parse_args(argv)
    for line in bench(args.processes, args.rows, args.dim, args.chunk_size,
                      not args.cold, args.device):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
