"""The port's telemetry plane: the flight recorder and its Chrome trace,
the pipeline trace and its JSON round trip (held against the JAX trace
of the same pipeline), the executor's node instrumentation and its
tripwire, the optimizers' trace records, post-mortems, the sampler, the
metric-name catalogue and the port's import boundary.

Bars, as stated per test: exported lanes hold no two overlapping spans;
a round-tripped trace has the same node records, and the same operator
set as the JAX package's trace of the same pipeline; every literal
metric name in the port is catalogued; no port module imports JAX or
the JAX package. Port data live on the CPU, at small shapes.
"""
import ast
import json
import os
import threading
import time

import numpy as np
import pytest

from keystone_tpu.nodes.learning.linear import (
    LinearMapEstimator as JLinearMap,
)
from keystone_tpu.nodes.stats import StandardScaler as JScaler
from keystone_tpu.observability.trace import PipelineTrace as JTrace
from keystone_tpu.parallel.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.workflow.env import PipelineEnv as JEnv
from keystone_tpu_torch.nodes.learning.least_squares import (
    LeastSquaresEstimator,
)
from keystone_tpu_torch.nodes.learning.linear import LinearMapEstimator
from keystone_tpu_torch.nodes.stats import StandardScaler
from keystone_tpu_torch.observability import names, postmortem
from keystone_tpu_torch.observability.metrics import MetricsRegistry
from keystone_tpu_torch.observability.numerics import (
    NumericsError,
    reset_health_series,
)
from keystone_tpu_torch.observability.sampler import TelemetrySampler
from keystone_tpu_torch.observability.timeline import (
    FlightRecorder,
    flight_recorder,
    flight_span,
    record_span,
    reset_flight_recorder,
    write_trace_artifact,
)
from keystone_tpu_torch.observability.trace import (
    PipelineTrace,
    current_trace,
    metrics_suppressed,
    profiler_trace,
    tracing_disabled,
)
from keystone_tpu_torch.parallel.dataset import ArrayDataset
from keystone_tpu_torch.parallel.streaming import StreamingDataset
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.optimizer.auto_cache import AutoCacheRule
from keystone_tpu_torch.workflow.transformer import transformer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "keystone_tpu_torch")


@pytest.fixture(autouse=True)
def fresh_planes(tmp_path, monkeypatch):
    monkeypatch.setenv("KEYSTONE_TORCH_POSTMORTEM_DIR",
                       str(tmp_path / "postmortems"))
    # the shipped cost weights: a calibration artifact the tool left in
    # the checkout's build/ must not move a solver decision here
    monkeypatch.setenv("KEYSTONE_TORCH_COST_CALIBRATION",
                       str(tmp_path / "no-calibration.json"))
    MetricsRegistry.reset()
    reset_flight_recorder()
    reset_health_series()
    PipelineEnv.reset()
    yield
    MetricsRegistry.reset()
    reset_flight_recorder()
    reset_health_series()
    PipelineEnv.reset()


def _xy(n=192, d=8, k=2, seed=0):
    rng = np.random.RandomState(seed)
    X = (rng.randn(n, d) * 2 + 1).astype(np.float32)
    return X, (X @ rng.randn(d, k)).astype(np.float32)


def _lanes_ok(trace):
    by_lane = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X":
            by_lane.setdefault(e["tid"], []).append((e["ts"], e["dur"]))
    for spans in by_lane.values():
        spans.sort()
        for (t0, d0), (t1, _) in zip(spans, spans[1:]):
            if t1 < t0 + d0 - 1e-3:
                return False
    return True


# -- the flight recorder -----------------------------------------------------

def test_ring_keeps_the_newest_spans(monkeypatch):
    monkeypatch.setenv("KEYSTONE_TORCH_FLIGHT_SPANS", "16")
    rec = FlightRecorder()
    for i in range(40):
        rec.record(f"s{i}", "test", float(i), 0.5)
    spans = rec.spans()
    assert [s.name for s in spans] == [f"s{i}" for i in range(24, 40)]
    assert rec.dropped() == 24 and rec.total_recorded == 40
    monkeypatch.setenv("KEYSTONE_TORCH_FLIGHT_RECORDER", "0")
    off = FlightRecorder()
    off.record("x", "test", 0.0, 1.0)
    assert off.spans() == []
    monkeypatch.setenv("KEYSTONE_TORCH_FLIGHT_SPANS", "zero")
    with pytest.raises(ValueError):
        FlightRecorder()


def test_chrome_trace_lanes_do_not_overlap(tmp_path):
    """Nested spans of one thread overflow to a nested lane; other
    threads get their own lanes; instants ride lane 0."""
    rec = flight_recorder()
    with flight_span("outer", "node"):
        with flight_span("inner", "node"):
            time.sleep(0.002)
        rec.record_instant("mark", "resilience", {"k": 1})

    def worker():
        record_span("stage:w", "ingest", time.perf_counter(), 0.001)

    t = threading.Thread(target=worker, name="worker-lane")
    t.start()
    t.join(timeout=5.0)
    trace = rec.to_chrome_trace()
    assert _lanes_ok(trace)
    names_by_lane = {e["args"]["name"] for e in trace["traceEvents"]
                     if e.get("name") == "thread_name"}
    assert "worker-lane" in names_by_lane
    assert any(n.endswith("(nested 1)") for n in names_by_lane)
    assert any(e.get("ph") == "i" for e in trace["traceEvents"])
    path = str(tmp_path / "t.perfetto.json")
    assert write_trace_artifact(path) == "perfetto"
    assert json.loads(open(path).read())["otherData"]["recorded_spans"] == 4
    with pytest.raises(ValueError):
        write_trace_artifact(str(tmp_path / "t.json"))


# -- the pipeline trace ----------------------------------------------------------

def _port_pipeline(X, Y):
    train = ArrayDataset.from_numpy(X, "cpu")
    labels = ArrayDataset.from_numpy(Y, "cpu")
    return StandardScaler().with_data(train).and_then(
        LinearMapEstimator(lam=0.1), train, labels)


def _jax_pipeline(X, Y):
    train = JArrayDataset.from_numpy(X)
    labels = JArrayDataset.from_numpy(Y)
    return JScaler().with_data(train).and_then(
        JLinearMap(lam=0.1), train, labels)


def test_trace_round_trip_matches_the_jax_node_set():
    X, Y = _xy()
    with PipelineTrace("port") as tr:
        fitted = _port_pipeline(X, Y).fit()
        out = fitted.apply(ArrayDataset.from_numpy(X, "cpu")).get()
    JEnv.reset()
    with JTrace("jax") as jtr:
        jfitted = _jax_pipeline(X, Y).fit()
        jout = jfitted.apply(JArrayDataset.from_numpy(X)).get()
    np.testing.assert_allclose(np.asarray(out.numpy()),
                               np.asarray(jout.numpy()), rtol=1e-4,
                               atol=1e-4)
    assert sorted({r.operator for r in tr.nodes}) == sorted(
        {r.operator for r in jtr.nodes})
    back = PipelineTrace.from_json(tr.to_json())
    assert [(r.node_id, r.operator, r.cached) for r in back.nodes] == [
        (r.node_id, r.operator, r.cached) for r in tr.nodes]
    assert back.node_ids() == tr.node_ids()
    assert tr.wall_s > 0 and tr.total_node_wall_s() > 0
    assert "PipelineTrace 'port'" in tr.summary()
    counters = MetricsRegistry.get_or_create().snapshot()["counters"]
    assert counters["executor.nodes_executed"] > 0
    node_spans = [s for s in flight_recorder().spans() if s.cat == "node"]
    assert {s.name.split("#")[0] for s in node_spans} <= {
        r.operator for r in tr.nodes}


def test_untraced_runs_wrap_nothing():
    X, Y = _xy()
    _port_pipeline(X, Y).fit()
    assert current_trace() is None
    assert not [s for s in flight_recorder().spans() if s.cat == "node"]
    with tracing_disabled():
        assert metrics_suppressed()
    assert not metrics_suppressed()


def test_streamed_pipeline_fit_feeds_trace_and_timeline():
    X, Y = _xy(n=200)
    train = StreamingDataset.from_numpy(X, 48, device="cpu", tag="tl")
    labels = ArrayDataset.from_numpy(Y, "cpu")
    with PipelineTrace("stream") as tr:
        StandardScaler().with_data(train).and_then(
            LeastSquaresEstimator(lam=0.1), train, labels).fit()
    assert tr.chunk_stats["count"] == 10  # two fits of 5 chunks
    assert [f["source"] for f in tr.streamed_fits] == ["tl", "tl"]
    # the stream's n is known: the node rule's static path chooses among
    # the one-pass solvers before the fit, as the JAX default does
    assert tr.solver_decisions[-1]["shape_source"] == "static"
    assert tr.solver_decisions[-1]["streaming_restricted"]
    spans = flight_recorder().spans()
    kinds = {s.name.split(":")[0] for s in spans if ":" in s.name}
    assert {"stage", "stall", "accumulate"} <= kinds
    stage_tids = {s.tid for s in spans if s.name == "stage:tl"}
    assert threading.get_ident() not in stage_tids
    assert _lanes_ok(flight_recorder().to_chrome_trace())
    gauges = MetricsRegistry.get_or_create().snapshot()["gauges"]
    assert gauges["streaming.carry_bytes"] == 4 * (8 * 8 + 8 * 2 + 8 + 2)


def test_optimizer_records_go_to_the_trace():
    X, Y = _xy(n=300)
    train = ArrayDataset.from_numpy(X, "cpu")
    labels = ArrayDataset.from_numpy(Y, "cpu")
    with PipelineTrace("choice") as tr:
        LeastSquaresEstimator(lam=0.1).with_data(train, labels).fit()
    assert tr.node_choices and tr.node_choices[0]["optimizable"] == \
        "LeastSquaresEstimator"
    # the rule's default, as the JAX package's: shapes from the analyzer
    assert tr.node_choices[0]["provenance"] == "static"
    assert tr.solver_decisions[0]["shape_source"] == "static"
    assert set(tr.solver_decisions[0]["costs"]) >= {"LinearMapEstimator"}
    PipelineEnv.reset()
    rule = AutoCacheRule(AutoCacheRule.GREEDY, max_mem=1e9)
    scaler = StandardScaler().with_data(train)
    with PipelineTrace("cache") as tr:
        graph = rule.apply(scaler._graph)
    assert graph is not None
    assert tr.auto_cache and tr.auto_cache[0]["strategy"] == "greedy"
    assert not tr.nodes  # the profiling runs were not traced


@transformer
def _poison(x):
    return x * float("nan")


def test_traced_node_tripwire_names_the_node():
    X, _ = _xy(n=32)
    pipe = StandardScaler().with_data(ArrayDataset.from_numpy(X, "cpu")) \
        >> _poison
    fitted = pipe.fit()
    fitted.apply(ArrayDataset.from_numpy(X, "cpu")).get()  # untraced: quiet
    with PipelineTrace("nan"), pytest.raises(NumericsError,
                                             match="pipeline node") as info:
        fitted.apply(ArrayDataset.from_numpy(X, "cpu")).get()
    assert "#" in str(info.value)
    blob = json.loads(open(info.value.postmortem_path).read())
    assert blob["context"]["node"] in str(info.value)


def test_profiler_trace_names_the_nodes(tmp_path):
    X, Y = _xy(n=64)
    with profiler_trace(str(tmp_path), name="prof") as tr:
        _port_pipeline(X, Y).fit()
    events = json.loads(open(tmp_path / "prof.json").read())["traceEvents"]
    labels = {r.operator for r in tr.nodes}
    assert any(e.get("name", "").split("#")[0] in labels for e in events)


# -- post-mortems and the sampler ------------------------------------------------

def test_postmortem_dump_attach_and_switches(tmp_path, monkeypatch):
    record_span("stage:x", "ingest", time.perf_counter(), 0.001)
    exc = postmortem.attach_postmortem(RuntimeError("boom"), "unit",
                                       {"k": 1})
    path = exc.postmortem_path
    assert path in str(exc) and os.path.basename(path).startswith(
        "postmortem-unit-")
    blob = json.loads(open(path).read())
    assert blob["context"] == {"k": 1}
    assert blob["numerics"]["enabled"]
    assert any(e.get("name") == "stage:x"
               for e in blob["flight_recorder"]["traceEvents"])
    monkeypatch.setenv("KEYSTONE_TORCH_POSTMORTEM", "0")
    assert postmortem.dump_postmortem("off") is None
    monkeypatch.delenv("KEYSTONE_TORCH_POSTMORTEM")
    blocker = tmp_path / "file"
    blocker.write_text("x")
    monkeypatch.setenv("KEYSTONE_TORCH_POSTMORTEM_DIR", str(blocker))
    exc = postmortem.attach_postmortem(ValueError("kept"), "unwritable")
    assert exc.postmortem_path is None and str(exc) == "kept"


def test_sampler_is_idempotent_and_skips_a_broken_probe():
    reg = MetricsRegistry.get_or_create()
    reg.counter("streaming.chunks_total").inc(3)
    sampler = TelemetrySampler(interval_s=0.01, capacity=4)
    sampler.add_probe("broken", lambda: 1 / 0)
    sampler.start()
    sampler.start()
    deadline = time.time() + 5.0
    while len(sampler.series("process.rss_bytes")) < 2 and \
            time.time() < deadline:
        time.sleep(0.01)
    sampler.stop()
    sampler.stop()
    assert not sampler.running
    assert len(sampler.series("process.rss_bytes")) >= 2
    assert len(sampler.series("process.rss_bytes")) <= 4
    assert "broken" not in sampler.series_names()
    assert sampler.series("streaming.chunks_total")[-1][1] == 3.0
    values = sampler.sample_once()
    assert values["streaming.stage_queue_depth"] == 0.0
    assert values["numerics.health_age_s"] == -1.0
    sampler.start()
    assert sampler.running
    sampler.stop()
    with pytest.raises(ValueError):
        TelemetrySampler(interval_s=0)


# -- the catalogue and the import boundary ---------------------------------------

def _port_files():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _metric_literals(tree):
    """(name or f-string head, is_fstring) of every counter / gauge /
    histogram / timer call with a literal first argument."""
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("counter", "gauge", "histogram",
                                       "timer") and node.args):
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            yield arg.value, False
        elif isinstance(arg, ast.JoinedStr):
            head = "".join(v.value for v in arg.values[:1]
                           if isinstance(v, ast.Constant))
            yield head, True


def test_every_literal_metric_name_is_catalogued():
    seen, missing = 0, []
    for path in _port_files():
        tree = ast.parse(open(path).read(), path)
        for name, fstring in _metric_literals(tree):
            seen += 1
            ok = (names.is_catalogued_prefix(name) if fstring
                  else names.is_catalogued(name))
            if not ok:
                missing.append((os.path.relpath(path, REPO), name))
    assert seen > 30
    assert not missing, missing
    assert names.is_catalogued("resilience.retry")
    assert not names.is_catalogued("streaming.chunks")


def test_the_port_imports_no_jax():
    bad = []
    for path in list(_port_files()) + [os.path.join(REPO, "chip_smoke.py")]:
        for node in ast.walk(ast.parse(open(path).read(), path)):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            for m in mods:
                top = m.split(".")[0]
                if top in ("jax", "jaxlib", "keystone_tpu", "bench"):
                    bad.append((os.path.relpath(path, REPO), m))
    assert not bad, bad
