"""The elastic gate: kill one rank mid-fit, relaunch, resume; the resumed
weights must be bit-identical to the uninterrupted run's.

    python -m keystone_tpu_torch.tools.elastic_gate [--device cuda|cpu]

Counterpart of the repository's ``tools/elastic_gate.py``, on the port's
world (``parallel/distributed.py``). Five worlds of 2 ranks run the same
shard-local streamed LinearMap fit through the world loop of
``fit_streaming`` (``parallel/dryrun_worker.py``), on ``--device``: on a
machine with one card both ranks share it over gloo.

1. **uninterrupted**: the reference weights;
2. **killed**: a ``host_death`` fault ends rank 1 entering round 3 (exit
   117); rank 0 fails in its gather when the peer is gone (or the
   launcher reaps it). Entering round 3 rank 1 has awaited round 1, so
   rank 0's await of round 1, in which both ranks reported a sidecar,
   completes, and the world snapshot exists whatever the scheduling (a
   kill entering round 2 can land before rank 0 dispatched round 1, and
   then no round with both sidecars completes). A resume of that
   snapshot at world size 1 must refuse (``CheckpointMismatchError``)
   and leave it as it was;
3. **relaunched**: the world resumes from the snapshot: every rank
   reports ``resumed=1`` and ``unexpected_compiles=0``, and rank 0's
   weights equal run 1's bit for bit; the snapshot is cleared;
4. **killed mid-overlap**: the kill lands at the await of round 2,
   between a round's dispatch and its await, with the round's gather and
   a carry copy in flight (the ranks' sidecars may trail their cursors
   by one round);
5. **relaunched again**: the resume replays the round the sidecars
   missed and must still give bit-identical weights.

Exit 1 names the run and the artifact that diverged.
"""
from __future__ import annotations

import os
import shutil
import sys
import tempfile

import numpy as np

from . import gates

NAME = "elastic gate"
N, D, K, CHUNK = 192, 12, 3, 16
KILL_ROUND = 3
AWAIT_KILL_ROUND = 2
WORLD_TIMEOUT_S = 300.0


def _fields(world, pid):
    lines = [line for line in world.output(pid).splitlines()
             if line.startswith("ELASTIC_OK")]
    if not lines:
        return None
    return dict(kv.split("=", 1) for kv in lines[0].split()[1:])


def _check_world(world, codes, name, expect_resumed) -> bool:
    for pid, code in enumerate(codes):
        if code != 0:
            print(world.output(pid)[-2000:], file=sys.stderr)
            gates.fail(NAME, f"{name} run: rank {pid} exited {code} (log "
                             "above)")
            return False
        fields = _fields(world, pid)
        if fields is None:
            gates.fail(NAME, f"{name} run: rank {pid} printed no "
                             "ELASTIC_OK line")
            return False
        if int(fields["unexpected_compiles"]) != 0:
            gates.fail(NAME, f"{name} run: rank {pid} saw "
                             f"{fields['unexpected_compiles']} capture(s) "
                             "under the fit fence")
            return False
        if int(fields["resumed"]) != expect_resumed:
            gates.fail(NAME, f"{name} run: rank {pid} reported resumed="
                             f"{fields['resumed']}, expected "
                             f"{expect_resumed}")
            return False
    return True


def _kill_run(world, base, ckdir, flag, at, label) -> bool:
    from ..resilience.faults import HOST_DEATH_EXIT_CODE

    codes = world.launch(base + [
        "--checkpoint-dir", ckdir, "--checkpoint-every", "1",
        "--die-process", "1", flag, str(at)]).wait(WORLD_TIMEOUT_S)
    if world.host_death_exits(codes) != [1]:
        gates.fail(NAME, f"{label}: expected rank 1 to die of host_death "
                         f"(exit {HOST_DEATH_EXIT_CODE}), got exit codes "
                         f"{codes}")
        return False
    if not os.path.exists(os.path.join(ckdir, "stream_fit.ckpt")):
        gates.fail(NAME, f"{label}: the killed world left no world "
                         f"snapshot under {ckdir}: nothing to resume")
        return False
    return True


def _resume_and_compare(world, base, ckdir, out, ref, label) -> bool:
    codes = world.launch(base + [
        "--checkpoint-dir", ckdir, "--checkpoint-every", "1",
        "--out", out]).wait(WORLD_TIMEOUT_S)
    if not _check_world(world, codes, label, expect_resumed=1):
        return False
    got = np.load(out)["weights"]
    if not np.array_equal(got, ref):
        delta = float(np.abs(got - ref).max())
        gates.fail(NAME, f"{label}: resumed weights diverge from the "
                         f"uninterrupted run (max |delta| {delta:.3e}; "
                         f"{out})")
        return False
    if os.path.exists(os.path.join(ckdir, "stream_fit.ckpt")):
        gates.fail(NAME, f"{label}: the world snapshot survived a "
                         "finished fit")
        return False
    return True


def _resize_refuses(base, ckdir, workdir) -> bool:
    """A world of 1 resuming the 2-rank snapshot must refuse."""
    from ..parallel.distributed import DryrunWorld

    before = sorted(os.listdir(ckdir))
    solo = DryrunWorld(num_processes=1, workdir=os.path.join(workdir, "w1"),
                       grace_s=5)
    codes = solo.launch(base + ["--checkpoint-dir", ckdir,
                                "--checkpoint-every", "1"]
                        ).wait(WORLD_TIMEOUT_S)
    out = solo.output(0)
    if codes == [0] or "CheckpointMismatchError" not in out:
        print(out[-2000:], file=sys.stderr)
        gates.fail(NAME, f"a world of 1 resumed a 2-rank snapshot "
                         f"(exit {codes}): it must refuse")
        return False
    if sorted(os.listdir(ckdir)) != before:
        gates.fail(NAME, "the refused resume changed the snapshot files")
        return False
    return True


def main(argv=None) -> int:
    args = gates.parser(__doc__.splitlines()[0]).parse_args(argv)
    device = gates.resolve(NAME, args.device)
    if device is None:
        return 1
    workdir = tempfile.mkdtemp(prefix="keystone-elastic-gate-")
    try:
        return _run(args.device, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(device: str, workdir: str) -> int:
    from ..parallel.distributed import DryrunWorld

    rng = np.random.RandomState(0)
    npz = os.path.join(workdir, "data.npz")
    np.savez(npz, X=rng.randn(N, D).astype(np.float32),
             Y=rng.randn(N, K).astype(np.float32))
    out_a = os.path.join(workdir, "uninterrupted.npz")
    base = [sys.executable, "-m", "keystone_tpu_torch.parallel.dryrun_worker",
            "--data", npz, "--chunk-size", str(CHUNK), "--device", device]
    world = DryrunWorld(num_processes=2, workdir=workdir, grace_s=20)

    print(f"{NAME}: run 1/5: uninterrupted 2-rank streamed fit on {device}",
          flush=True)
    codes = world.launch(base + ["--out", out_a]).wait(WORLD_TIMEOUT_S)
    if not _check_world(world, codes, "uninterrupted", expect_resumed=0):
        return 1
    ref = np.load(out_a)["weights"]

    ckdir = os.path.join(workdir, "ck")
    print(f"{NAME}: run 2/5: kill rank 1 at round {KILL_ROUND}; a world of "
          "1 must refuse the snapshot", flush=True)
    if not _kill_run(world, base, ckdir, "--die-at-round", KILL_ROUND,
                     "killed"):
        return 1
    if not _resize_refuses(base, ckdir, workdir):
        return 1
    print(f"{NAME}: run 3/5: relaunch, resume, compare", flush=True)
    if not _resume_and_compare(world, base, ckdir,
                               os.path.join(workdir, "resumed.npz"), ref,
                               "resumed"):
        return 1

    ckdir2 = os.path.join(workdir, "ck-overlap")
    print(f"{NAME}: run 4/5: kill rank 1 at round {AWAIT_KILL_ROUND}'s "
          "await (gather and carry copy in flight)", flush=True)
    if not _kill_run(world, base, ckdir2, "--die-at-await-round",
                     AWAIT_KILL_ROUND, "killed mid-overlap"):
        return 1
    print(f"{NAME}: run 5/5: relaunch after the mid-overlap kill, resume, "
          "compare", flush=True)
    if not _resume_and_compare(world, base, ckdir2,
                               os.path.join(workdir, "resumed2.npz"), ref,
                               "overlap-resumed"):
        return 1
    print(f"{NAME}: killed worlds (round entry and mid-overlap await) "
          "resumed to bit-identical weights, fence clean, snapshots "
          "cleared, resize refused", flush=True)
    print(f"{NAME}: PASS", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
