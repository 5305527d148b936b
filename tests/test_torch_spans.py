"""The port's live spans on the profiler's clock: under a bare
``torch.profiler`` capture (no ``PipelineTrace``) a fit and an apply
export the pipeline API's, the optimizer's, the nodes' and the block
solver's ranges, nested as the code nests; a streamed fit exports its
ingest stalls on the main thread; ``profiler_trace`` shows each node
once. (That a run with neither enters no range is
``test_torch_telemetry.py::test_untraced_runs_wrap_nothing``.)

Bars: the ranges' counts are the solver's (one ``factor:`` a block, one
``block:`` a block and pass) and every child lies inside its parent.
Port data live on the CPU, at small shapes.
"""
import collections
import json

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from keystone_tpu_torch.nodes.learning import BlockLeastSquaresEstimator
from keystone_tpu_torch.nodes.stats import StandardScaler
from keystone_tpu_torch.observability.metrics import MetricsRegistry
from keystone_tpu_torch.observability.timeline import reset_flight_recorder
from keystone_tpu_torch.observability.trace import current_trace, \
    profiler_trace
from keystone_tpu_torch.parallel.dataset import ArrayDataset
from keystone_tpu_torch.parallel.streaming import StreamingDataset
from keystone_tpu_torch.workflow.env import PipelineEnv

D, BLOCK, PASSES = 12, 4, 2


@pytest.fixture(autouse=True)
def fresh_planes():
    MetricsRegistry.reset()
    reset_flight_recorder()
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()
    reset_flight_recorder()


def _xy(n=96):
    rng = np.random.RandomState(0)
    X = (rng.randn(n, D) * 2 + 1).astype(np.float32)
    return X, (X @ rng.randn(D, 3)).astype(np.float32)


def _ranges(prof, tmp_path):
    """The capture's ``record_function`` ranges: (name, start, end, tid)."""
    path = tmp_path / "capture.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"], e["tid"])
            for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]


def _inside(child, parents):
    return any(p[1] <= child[1] and child[2] <= p[2] for p in parents)


def _heads(ranges, head):
    return [r for r in ranges if r[0].split(":")[0] == head]


def test_a_bare_profiler_exports_the_layers_nested(tmp_path):
    X, Y = _xy()
    train = ArrayDataset.from_numpy(X, "cpu")
    pipe = StandardScaler().with_data(train).and_then(
        BlockLeastSquaresEstimator(BLOCK, PASSES, 0.1), train,
        ArrayDataset.from_numpy(Y, "cpu"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert current_trace() is None
        fitted = pipe.fit()
        fitted.apply(ArrayDataset.from_numpy(X, "cpu")).get()
    ranges = _ranges(prof, tmp_path)
    fits = [r for r in ranges if r[0] == "execute:fit"]
    gets = [r for r in ranges if r[0] == "execute:get"]
    assert len(fits) == 1 and len(gets) == 1
    optimize = _heads(ranges, "optimize")
    nodes = [r for r in ranges if "#" in r[0]]
    factors = _heads(ranges, "factor")
    blocks = _heads(ranges, "block")
    assert {r[0] for r in optimize} == {"optimize:DefaultOptimizer"}
    assert {r[0] for r in factors} == {"factor:bcd_core"}
    assert {r[0] for r in blocks} == {"block:bcd_core"}
    # one factor a block, one update a block and pass, none of them in
    # the optimizer's own runs
    outside = [r for r in factors + blocks if not _inside(r, optimize)]
    n_blocks = D // BLOCK
    assert collections.Counter(r[0] for r in outside) == {
        "factor:bcd_core": n_blocks, "block:bcd_core": n_blocks * PASSES}
    # nested as the code nests: solver spans in the estimator's node,
    # nodes and optimizer passes in an entry point
    solver_nodes = [r for r in nodes
                    if r[0].startswith("BlockLeastSquaresEstimator#")]
    assert solver_nodes
    assert all(_inside(r, solver_nodes) for r in factors + blocks)
    assert all(_inside(r, fits + gets) for r in nodes + optimize)
    assert any(_inside(r, gets) for r in nodes)
    assert any(_inside(r, gets) for r in optimize)


def test_a_streamed_fit_exports_its_stalls_on_the_main_thread(tmp_path):
    X, Y = _xy(n=200)
    train = StreamingDataset.from_numpy(X, 48, device="cpu", tag="sp")
    est = BlockLeastSquaresEstimator(BLOCK, PASSES, 0.1).with_data(
        train, ArrayDataset.from_numpy(Y, "cpu"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        est.fit()
    ranges = _ranges(prof, tmp_path)
    stalls = [r for r in ranges if r[0] == "stall:sp"]
    main = {r[3] for r in _heads(ranges, "execute")}
    # a wait for each of the 5 chunks and one for the stream's end
    assert len(stalls) == 6 and {r[3] for r in stalls} == main
    assert len([r for r in ranges if r[0] == "accumulate:sp"]) == 5
    counts = collections.Counter(r[0] for r in ranges
                                 if r[0].split(":")[0] in ("factor",
                                                           "block"))
    assert counts == {"factor:gram_bcd": D // BLOCK,
                      "block:gram_bcd": D // BLOCK * PASSES}
    # the producer thread's stage spans stay in the flight recorder
    assert not _heads(ranges, "stage")


def test_profiler_trace_shows_each_node_once(tmp_path):
    X, Y = _xy()
    train = ArrayDataset.from_numpy(X, "cpu")
    pipe = StandardScaler().with_data(train).and_then(
        BlockLeastSquaresEstimator(BLOCK, PASSES, 0.1), train,
        ArrayDataset.from_numpy(Y, "cpu"))
    with profiler_trace(str(tmp_path), name="once") as tr:
        pipe.fit()
    events = json.loads((tmp_path / "once.json").read_text())["traceEvents"]
    nodes = collections.Counter(
        e["name"] for e in events if e.get("ph") == "X"
        and e.get("cat") == "user_annotation" and "#" in e["name"])
    # every thunk the trace timed is one range (constants, recorded at
    # once, run none)
    recorded = {f"{r.operator}#{r.node_id}" for r in tr.nodes}
    assert len(nodes) >= 3 and set(nodes) <= recorded
    assert set(nodes.values()) == {1}

