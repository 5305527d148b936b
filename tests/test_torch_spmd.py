"""The port's SPMD scan (``keystone_tpu_torch/analysis/spmd.py``): each
pass fires on a seeded offender written against the port's own
collective sites (``torch.distributed`` calls, the deterministic
``world_*`` helpers, the ``WorldCoordinator`` methods), stays quiet on
the safe shapes, and finds nothing on the port's tree; the graph lint
over rank-local streams; the divergent worker flagged statically.
"""
import ast
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

from keystone_tpu_torch.analysis import spmd

REPO = Path(__file__).resolve().parent.parent


def _tree(src):
    return ast.parse(textwrap.dedent(src))


def _codes(hits):
    return sorted({h[1] for h in hits})


DIVERGENT = """
import torch.distributed as dist
from keystone_tpu_torch.parallel.mesh import process_index

def rank_zero_barrier():
    if process_index() == 0:
        dist.barrier()

def tainted_loop(world):
    rank = process_index()
    for _ in range(rank):
        world.step(0, True)

def helper(t):
    return world_sum(t)

def one_hop(t, pid):
    if pid == 1:
        helper(t)
"""


def test_collective_divergence_fires_on_each_seeded_shape():
    hits = spmd.collective_divergence(_tree(DIVERGENT))
    where = sorted((h[2].split()[0], h[1]) for h in hits)
    assert ("rank_zero_barrier", "collective-divergence") in where
    assert ("tainted_loop", "collective-divergence") in where
    assert ("one_hop", "collective-divergence") in where
    msg = next(h[2] for h in hits if h[2].startswith("rank_zero_barrier"))
    assert "`barrier`" in msg and "process_index() == 0" in msg


def test_uniform_conditions_and_laundered_results_are_clean():
    src = """
    import torch.distributed as dist

    def uniform(world, t):
        if process_count() > 1:
            dist.barrier()
        state = world.step(pid, True)
        if state.all_done:
            world.barrier("done")
        rank, nproc = process_index(), process_count()
        if nproc > 1:
            world_gather(t)

    def tensor_gather(x, idx, pid):
        if pid == 0:
            x.gather(0, idx)   # a tensor op, not a collective
    """
    assert spmd.collective_divergence(_tree(src)) == []


def test_the_allowlist_suppresses_by_scope():
    src = "def f():\n    if process_index() == 0:\n        world_sum(t)\n"
    assert spmd.collective_divergence(_tree(src))
    assert spmd.collective_divergence(_tree(src),
                                      allowlist={"f:world_sum"}) == []


def test_barrier_names_and_gather_shapes_must_be_fixed():
    src = """
    import torch.distributed as dist

    def names(world, r):
        world.barrier(f"round-{r}")
        world.barrier(name=str(r))
        world.barrier("fixed")

    def shapes(t, items):
        rows = [x for x in items]
        world_gather(torch.tensor(rows))
        parts = [None, None]
        dist.all_gather(parts, torch.tensor([1, 2]))
    """
    hits = spmd.barrier_stability(_tree(src))
    assert [h[1] for h in hits].count("unstable-barrier-name") == 2
    assert "non-fixed-coordination-shape" in _codes(hits)
    assert len([h for h in hits
                if h[1] == "non-fixed-coordination-shape"]) == 1


def test_an_axis_no_mesh_binds_is_flagged():
    src = """
    def f(t, mesh):
        world_sum(t, mesh, "data")
        world_concat(t, mesh, "classes")
        mesh.group("model")
        mesh.group("rows")
        m = re.match("x", "y"); m.group("prefix")
    """
    hits = spmd.collective_axis_bindings(_tree(src))
    bad = sorted(h[2].split("'")[1] for h in hits)
    assert bad == ["classes", "rows"]


def test_rank_zero_snapshot_effects_need_barriers():
    src = """
    def unbarriered(world, ckpt):
        ckpt.save_host(fp, world.pid, 1, carry)
        if world.pid == 0:
            ckpt.merge_hosts(2)
            ckpt.clear()

    def paired(world, ckpt):
        ckpt.save_host(fp, world.pid, 1, carry)
        world.barrier("sidecars")
        if world.pid == 0:
            ckpt.merge_hosts(2)
        world.barrier("merged")
        if world.pid == 0:
            ckpt.clear()

    def raw_carry(ckpt, fp):
        snap = ckpt.load(fp)
        carry = snap["carry"]
        ok = restore_carry(snap["carry"], "cpu")
        empty = snap["carry"] is None
    """
    hits = spmd.world_checkpoint_consistency(_tree(src))
    effects = sorted(h[2].split()[0] for h in hits
                     if h[1] == "unbarriered-host0-effect")
    assert effects == ["unbarriered", "unbarriered"]
    restores = [h for h in hits if h[1] == "carry-restore-discipline"]
    assert len(restores) == 1 and restores[0][2].startswith("raw_carry")


def test_every_dispatched_round_is_awaited():
    src = """
    def dropped(world):
        world.step_begin(1, False)

    def rebound(world):
        p = world.step_begin(1, False)
        p = world.step_begin(2, False)
        world.step_await(p)

    def stale(world):
        p = world.step_begin(1, False)
        x = p.result
        world.step_await(p)

    def pipelined(world):
        pending = None
        while True:
            new = world.step_begin(1, False)
            if pending is not None:
                state = world.step_await(pending)
                if state.all_done:
                    world.step_await(new)
                    break
            pending = new
    """
    hits = spmd.unawaited_collective(_tree(src))
    scopes = sorted((h[2].split()[0], h[1]) for h in hits)
    assert ("dropped", "unawaited-collective") in scopes
    assert ("rebound", "unawaited-collective") in scopes
    assert ("stale", "stale-coordination-read") in scopes
    assert not any(s == "pipelined" for s, _ in scopes)


def test_the_port_tree_scans_clean():
    assert spmd.scan_package(REPO / "keystone_tpu_torch") == []


def test_every_allowlist_entry_is_live_and_commented():
    src = (REPO / "keystone_tpu_torch/analysis/spmd.py").read_text()
    block = src[src.index("SPMD_ALLOWLIST"):src.index("})")]
    for key in spmd.SPMD_ALLOWLIST:
        line = next(line for line in block.splitlines() if key in line)
        before = block[:block.index(line)].rstrip().splitlines()[-1]
        assert before.strip().startswith("#"), key
    # dropping the entry makes the shipped streaming loop fire
    tree = ast.parse((REPO / "keystone_tpu_torch/parallel/streaming.py"
                      ).read_text())
    assert spmd.world_checkpoint_consistency(tree, allowlist=()) != []


def test_the_divergent_worker_is_flagged(tmp_path):
    hits = spmd.scan_file(REPO / "tests/torch_spmd_divergent_worker.py",
                          "tests/torch_spmd_divergent_worker.py")
    assert [h["code"] for h in hits] == ["collective-divergence"]
    assert "barrier" in hits[0]["message"]


def test_the_passes_and_codes_are_the_jax_ones():
    from keystone_tpu.analysis import spmd as jspmd

    for name in ("collective_divergence", "barrier_stability",
                 "collective_axis_bindings", "world_checkpoint_consistency",
                 "unawaited_collective", "sharding_flow_lint", "scan_file",
                 "scan_package"):
        assert callable(getattr(jspmd, name)) and callable(
            getattr(spmd, name)), name
    assert {k.split(":")[0] for k in spmd.SPMD_ALLOWLIST} <= {
        k.split(":")[0] for k in jspmd.SPMD_ALLOWLIST}


def test_sharding_flow_lint_on_a_rank_local_stream():
    """A rank-local stream collapsed into a resident dataset, or zipped
    with a non-sharded input, is reported; a streamable fit on it is
    not (the world loop merges its carries)."""
    from keystone_tpu_torch.analysis.diagnostics import check_graph
    from keystone_tpu_torch.analysis.spec import ShapeDtype, dataset_spec
    from keystone_tpu_torch.nodes.learning.pca import ColumnPCAEstimator
    from keystone_tpu_torch.nodes.stats import StandardScaler
    from keystone_tpu_torch.parallel.streaming import StreamingDataset

    import torch

    X = np.random.RandomState(0).randn(40, 6).astype(np.float32)
    stream = StreamingDataset.from_numpy(X, 8, device="cpu")
    stream.process_sharded = True
    spec = dataset_spec(stream)
    assert spec.sharded and "sharded" in repr(spec)
    assert dataset_spec(stream.map_chunks(lambda ad: ad)).sharded
    item = ShapeDtype((6,), torch.float32)
    pca = ColumnPCAEstimator(3).with_data(stream)
    rep = check_graph(pca._graph, {pca._source: item}, name="pca")
    hit = [d for d in rep.diagnostics if d.code == "non-streamable-fit"]
    assert len(hit) == 1 and "shard-local" in hit[0].message
    fit = StandardScaler().with_data(stream)
    rep = check_graph(fit._graph, {fit._source: item}, name="scaler")
    assert not [d for d in rep.diagnostics
                if d.code in ("cross-host-materialization",
                              "implicit-replication")]


def test_check_reports_the_spmd_key(tmp_path):
    out = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", "check",
         "cifar.linear_pixels", "--json", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "spmd: clean" in proc.stdout
    assert json.loads(out.read_text())["spmd"] == []


def test_the_lint_tool_runs_the_spmd_passes(tmp_path, monkeypatch, capsys):
    from keystone_tpu_torch.tools import lint

    pkg = tmp_path / "keystone_tpu_torch"
    pkg.mkdir()
    (pkg / "bad.py").write_text(textwrap.dedent(DIVERGENT))
    monkeypatch.setattr(lint, "PKG", pkg)
    assert lint.run_spmd_rules() == 3
    assert "collective-divergence" in capsys.readouterr().out



