"""The parts of the JAX package's contract the signature audit
(``tests/test_torch_signatures.py``) found missing from the port, each
held against the JAX package where it has a counterpart.

* ``executor.prefix_hits`` counts a node served from saved state,
  traced or not (``tests/test_observability.py``'s prefix-hit test);
* ``numerics.residual_rel``: a healthy 8 x 8 ridge solve's relative
  residual below 1e-3 in both packages (``tests/test_numerics.py``'s
  bar), and on a breakdown event;
* ``KEYSTONE_TORCH_MESH_MODEL`` sizes the default mesh's model axis
  (``tests/test_launch.py``), ``KEYSTONE_TORCH_COORD_ROUND_LEN`` and
  ``KEYSTONE_TORCH_COORD_OVERLAP`` parse and fail as the JAX switches
  do, and a 2-rank gloo world at ``tests/test_torch_elastic.py``'s
  shapes gives the same weights (``np.array_equal``) under each, with
  the rounds each switch says, and with overlap off no gather still in
  flight when its dispatch returns;
* ``BlockLinearMapper(weights=)`` against the JAX mapper (rtol 1e-5),
  ``profile_graph(num_trials=3)``, ``serve(registry=)``,
  ``record_instant(ts_s=)``, ``dense_sift(kernel_mode=)`` and ``UtilizationWindow.report()``;
* JAX-style positional calls of ``StreamingDataset``, ``ArrayDataset``
  and ``model_charge`` bind each value to the parameter of the same
  name in both packages.
"""
import inspect
import json
import os
import sys
import urllib.request

import numpy as np
import pytest
import torch

from keystone_tpu_torch.observability.metrics import MetricsRegistry
from keystone_tpu_torch.observability.timeline import reset_flight_recorder
from keystone_tpu_torch.parallel.dataset import ArrayDataset
from keystone_tpu_torch.workflow import Estimator, Transformer
from keystone_tpu_torch.workflow.env import PipelineEnv


@pytest.fixture(autouse=True)
def fresh_planes(tmp_path, monkeypatch):
    monkeypatch.setenv("KEYSTONE_TORCH_POSTMORTEM_DIR", str(tmp_path))
    MetricsRegistry.reset()
    reset_flight_recorder()
    PipelineEnv.reset()
    yield
    MetricsRegistry.reset()
    reset_flight_recorder()
    PipelineEnv.reset()


def _data(n=16, d=4, seed=0):
    return np.random.RandomState(seed).rand(n, d).astype(np.float32)


# -- executor.prefix_hits -----------------------------------------------------

class _AddOne(Transformer):
    def apply(self, x):
        return x + 1


class _Shift(Transformer):
    def __init__(self, b):
        self.b = np.asarray(b, np.float32)

    def apply(self, x):
        return x + torch.as_tensor(self.b)


class _MeanCenter(Estimator):
    num_fits = 0

    def _fit(self, ds):
        _MeanCenter.num_fits += 1
        return _Shift(-ds.numpy().mean(axis=0))


def _jax_prefix_hits(x):
    """The JAX test's drive: (hits after one apply, hits after two, fits)."""
    from keystone_tpu import Estimator as JEstimator
    from keystone_tpu import Transformer as JTransformer
    from keystone_tpu.observability import MetricsRegistry as JRegistry
    from keystone_tpu.parallel.dataset import ArrayDataset as JArrayDataset

    fits = []

    class AddOne(JTransformer):
        def apply(self, v):
            return v + 1

    class Shift(JTransformer):
        def __init__(self, b):
            self.b = np.asarray(b)

        def apply(self, v):
            return v + self.b

    class MeanCenter(JEstimator):
        def _fit(self, ds):
            fits.append(1)
            return Shift(-ds.numpy().mean(axis=0))

    reg = JRegistry.get_or_create()
    ds = JArrayDataset.from_numpy(x)
    pipe = AddOne().and_then(MeanCenter(), ds)
    pipe.apply(ds).numpy()
    first = reg.snapshot()["counters"].get("executor.prefix_hits", 0)
    pipe.apply(ds).numpy()
    return first, reg.snapshot()["counters"]["executor.prefix_hits"], \
        len(fits)


def test_prefix_hits_counted_without_trace_as_the_jax_package():
    x = _data()
    _MeanCenter.num_fits = 0
    reg = MetricsRegistry.get_or_create()
    ds = ArrayDataset.from_numpy(x, "cpu")
    pipe = _AddOne().and_then(_MeanCenter(), ds)
    pipe.apply(ds).numpy()
    first = reg.snapshot()["counters"].get("executor.prefix_hits", 0)
    pipe.apply(ds).numpy()  # the fitted state comes from the prefix memo
    second = reg.snapshot()["counters"]["executor.prefix_hits"]
    assert first == 0 and second >= 1 and _MeanCenter.num_fits == 1
    j_first, j_second, j_fits = _jax_prefix_hits(x)
    assert (j_first, j_fits) == (first, _MeanCenter.num_fits)
    assert j_second >= 1


def test_prefix_hits_are_not_counted_inside_sampled_executions():
    from keystone_tpu_torch.observability.trace import tracing_disabled

    x = _data()
    ds = ArrayDataset.from_numpy(x, "cpu")
    pipe = _AddOne().and_then(_MeanCenter(), ds)
    pipe.apply(ds).numpy()
    with tracing_disabled():
        pipe.apply(ds).numpy()
    snap = MetricsRegistry.get_or_create().snapshot()["counters"]
    assert snap.get("executor.prefix_hits", 0) == 0


# -- numerics.residual_rel ----------------------------------------------------

def test_healthy_solve_records_its_residual_as_the_jax_package():
    import jax.numpy as jnp

    from keystone_tpu.observability import MetricsRegistry as JRegistry
    from keystone_tpu.ops.linalg import ridge_cho_solve as jsolve
    from keystone_tpu_torch.ops.linalg import ridge_cho_solve

    G = np.eye(8, dtype=np.float32) * 4.0
    C = np.ones((8, 2), np.float32)
    W = ridge_cho_solve(torch.from_numpy(G), torch.from_numpy(C), 0.1)
    snap = MetricsRegistry.get_or_create().snapshot()
    assert snap["counters"]["numerics.solves_total"] >= 1
    assert "numerics.breakdown_total" not in snap["counters"]
    assert snap["histograms"]["numerics.pivot_ratio"]["min"] > 1e-3
    assert snap["histograms"]["numerics.residual_rel"]["count"] == 1
    assert snap["histograms"]["numerics.residual_rel"]["max"] < 1e-3
    want = np.asarray(jsolve(jnp.asarray(G), jnp.asarray(C), 0.1))
    np.testing.assert_allclose(W.numpy(), want, rtol=1e-6)
    jsnap = JRegistry.get_or_create().snapshot()
    assert jsnap["histograms"]["numerics.residual_rel"]["max"] < 1e-3


def test_the_residual_is_computed_only_while_the_plane_is_on(monkeypatch):
    from keystone_tpu_torch.ops.linalg import ridge_cho_solve

    monkeypatch.setenv("KEYSTONE_TORCH_NUMERICS", "0")
    ridge_cho_solve(torch.eye(4) * 2.0, torch.ones(4, 1), 0.1)
    assert "numerics.residual_rel" not in \
        MetricsRegistry.get_or_create().snapshot()["histograms"]


def test_record_solve_health_keeps_only_a_finite_residual():
    from keystone_tpu_torch.observability import numerics as tnum
    from keystone_tpu_torch.observability.trace import PipelineTrace

    with PipelineTrace() as tr:
        tnum.record_solve_health("s", True, 0.5, -1.0)
        tnum.record_solve_health("s", True, 0.5, float("nan"))
        tnum.record_solve_health("s", True, 0.5, None)
        tnum.record_solve_health("s", False, 1e-9, 0.25)
        tnum.record_solve_health("s", False, 1e-9, float("inf"))
    hist = MetricsRegistry.get_or_create().snapshot()["histograms"]
    assert hist["numerics.residual_rel"]["count"] == 1
    assert hist["numerics.residual_rel"]["max"] == 0.25
    events = [e for e in tr.numerics if e["event"] == "breakdown"]
    assert [e.get("residual_rel") for e in events] == [0.25, None]
    assert "residual_rel" not in events[1]


# -- the environment contract -------------------------------------------------

def test_mesh_model_env_sizes_the_model_axis_as_the_jax_one(monkeypatch):
    import jax

    from keystone_tpu.parallel import mesh as jmesh
    from keystone_tpu_torch.parallel import mesh as tmesh

    monkeypatch.setenv("KEYSTONE_MESH_MODEL", "2")
    monkeypatch.setenv("KEYSTONE_TORCH_MESH_MODEL", "2")
    # a world of 8 ranks, as the JAX test has 8 devices
    monkeypatch.setattr(tmesh, "process_count", lambda: 8)
    jmesh.set_mesh(None)
    tmesh.set_mesh(None)
    try:
        m = tmesh.get_mesh()
        assert m.shape["model"] == 2 and m.shape["data"] * 2 == 8
        jm = jmesh.get_mesh()
        assert dict(jm.shape) == m.shape
        assert jm.shape["data"] * 2 == len(jax.devices())
    finally:
        jmesh.set_mesh(None)
        tmesh.set_mesh(None)
    monkeypatch.delenv("KEYSTONE_TORCH_MESH_MODEL")
    assert tmesh.get_mesh().shape == {"data": 8, "model": 1}


def test_mesh_model_env_refuses_what_the_jax_one_refuses(monkeypatch):
    from keystone_tpu.parallel import mesh as jmesh
    from keystone_tpu_torch.parallel import mesh as tmesh

    monkeypatch.setenv("KEYSTONE_MESH_MODEL", "two")
    monkeypatch.setenv("KEYSTONE_TORCH_MESH_MODEL", "two")
    jmesh.set_mesh(None)
    tmesh.set_mesh(None)
    try:
        with pytest.raises(ValueError) as jerr:
            jmesh.get_mesh()
        with pytest.raises(ValueError) as terr:
            tmesh.get_mesh()
    finally:
        jmesh.set_mesh(None)
    assert str(terr.value) == str(jerr.value).replace(
        "KEYSTONE_", "KEYSTONE_TORCH_")


def test_round_length_env_parses_and_fails_as_the_jax_one(monkeypatch):
    from keystone_tpu_torch.parallel.streaming import _coord_round_len

    monkeypatch.delenv("KEYSTONE_TORCH_COORD_ROUND_LEN", raising=False)
    assert _coord_round_len() == 16
    monkeypatch.setenv("KEYSTONE_TORCH_COORD_ROUND_LEN", "4")
    assert _coord_round_len() == 4
    assert _coord_round_len(checkpoint_every=3) == 3  # checkpoints pin it
    monkeypatch.setenv("KEYSTONE_TORCH_COORD_ROUND_LEN", "four")
    with pytest.raises(ValueError, match=r"KEYSTONE_TORCH_COORD_ROUND_LEN "
                       r"must be an integer \(chunks folded per "
                       r"coordination round\), got 'four'"):
        _coord_round_len()
    monkeypatch.setenv("KEYSTONE_TORCH_COORD_ROUND_LEN", "0")
    with pytest.raises(ValueError, match="must be >= 1, got 0"):
        _coord_round_len()


@pytest.mark.parametrize("value,overlap", [
    (None, True), ("1", True), ("0", False), ("false", False),
    ("off", False)])
def test_overlap_env_parses_as_the_jax_one(monkeypatch, value, overlap):
    from keystone_tpu_torch.parallel.distributed import WorldCoordinator

    if value is None:
        monkeypatch.delenv("KEYSTONE_TORCH_COORD_OVERLAP", raising=False)
    else:
        monkeypatch.setenv("KEYSTONE_TORCH_COORD_OVERLAP", value)
    world = WorldCoordinator("t")
    assert world._overlap is overlap
    state = world.step(cursor=3, done=True)
    assert state.all_done and state.cursors == (3,)


# a 2-rank world at tests/test_torch_elastic.py's shapes
N, D, K, CHUNK = 192, 12, 3, 16
TIMEOUT_S = 300
SWITCHES = ({}, {"KEYSTONE_TORCH_COORD_ROUND_LEN": "2"},
            {"KEYSTONE_TORCH_COORD_OVERLAP": "0"})
WORKER = os.path.join(os.path.dirname(__file__), "torch_world_worker.py")


@pytest.fixture(scope="module")
def switched_fits(tmp_path_factory):
    """One world of 2 gloo ranks fitting the same seeded stream three
    times: the defaults, round length 2 and overlap off."""
    from keystone_tpu_torch.parallel.distributed import DryrunWorld

    base = str(tmp_path_factory.mktemp("switches"))
    rng = np.random.RandomState(0)
    X = (rng.randn(N, D) * (1.0 + rng.rand(D))).astype(np.float32)
    Y = (X @ rng.randn(D, K) + 0.1 * rng.randn(N, K)).astype(np.float32)
    src, dst = os.path.join(base, "in.npz"), os.path.join(base, "out.npz")
    np.savez(src, X=X, Y=Y, chunk=np.array(CHUNK),
             switches=json.dumps(list(SWITCHES)))
    world = DryrunWorld(2, workdir=os.path.join(base, "w"), grace_s=20)
    world.launch([sys.executable, WORKER, "streamed", src, dst])
    codes = world.wait(timeout_s=TIMEOUT_S)
    assert codes == [0, 0], [world.output(p)[-2000:] for p in range(2)]
    return dict(np.load(dst))


def test_the_switched_fits_give_the_default_weights(switched_fits):
    for i in (1, 2):
        assert np.array_equal(switched_fits[f"weights{i}"],
                              switched_fits["weights0"]), SWITCHES[i]


def test_the_switched_fits_round_as_the_switches_say(switched_fits):
    # 6 chunks a rank: at the default length one round of the six and the
    # done round; at length 2 three full rounds, the done one and the
    # drain
    rounds = [int(switched_fits[f"rounds{i}"]) for i in range(3)]
    assert rounds == [2, 5, 2]
    # with overlap every round's gather is still in flight when its
    # dispatch returns; with it off none is, and the waits the dispatch
    # blocked on are the measured overhead
    in_flight = [int(switched_fits[f"in_flight{i}"]) for i in range(3)]
    assert in_flight == [rounds[0], rounds[1], 0]
    for i in range(3):
        assert 0.0 <= float(switched_fits[f"occupancy{i}"]) <= 1.0
    assert float(switched_fits["occupancy2"]) < 1.0


# -- the parameters the audit found -------------------------------------------

def test_block_linear_mapper_keeps_the_given_weights_as_the_jax_one():
    from keystone_tpu.nodes.learning.linear import (
        BlockLinearMapper as JMapper,
    )
    from keystone_tpu_torch.nodes.learning.linear import BlockLinearMapper

    rng = np.random.RandomState(3)
    blocks = [rng.randn(4, 3).astype(np.float32),
              rng.randn(2, 3).astype(np.float32)]
    b = rng.randn(3).astype(np.float32)
    x = rng.randn(5, 6).astype(np.float32)
    for weights in (np.concatenate(blocks), 2.0 * np.concatenate(blocks)):
        port = BlockLinearMapper(blocks, 4, intercept=b, weights=weights)
        assert port.weights is weights
        ref = JMapper(blocks, 4, intercept=b, weights=weights)
        got = port.apply_batch(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(ref.apply(x)), rtol=1e-5)
    # and positionally, at the JAX place
    port = BlockLinearMapper(blocks, 4, b, None, 3.0 * np.concatenate(blocks))
    np.testing.assert_array_equal(port.weights, 3.0 * np.concatenate(blocks))


def _count_graph():
    """data -> count -> add-one, both sinks: a Graph the profiler runs
    without a runtime source."""
    from keystone_tpu_torch.workflow.graph import Graph
    from keystone_tpu_torch.workflow.operators import DatasetOperator
    from keystone_tpu_torch.workflow.transformer import transformer

    calls = []

    def count(v):
        calls.append(1)
        return v * 2.0

    g = Graph()
    g, src = g.add_node(DatasetOperator(
        ArrayDataset.from_numpy(_data(32), "cpu")), ())
    g, a = g.add_node(transformer(count), (src,))
    g, b = g.add_node(transformer(lambda v: v + 1.0), (a,))
    g, _ = g.add_sink(a)
    g, _ = g.add_sink(b)
    return g, calls


def test_profile_graph_runs_each_trial():
    from keystone_tpu_torch.workflow.optimizer import auto_cache

    graph, calls = _count_graph()
    runs = {}
    for trials in (1, 3):
        before = len(calls)
        profiles = auto_cache.profile_graph(graph, (2, 4), num_trials=trials)
        runs[trials] = len(calls) - before
        assert profiles
    # one run a scale and trial (a per-item function runs once an item)
    assert runs[3] == 3 * runs[1] and runs[1] > 0
    rule = auto_cache.AutoCacheRule(num_trials=3)
    assert rule.num_trials == 3 and auto_cache.AutoCacheRule().num_trials == 1


def test_auto_cache_rule_passes_its_trials_to_the_profiler(monkeypatch):
    from keystone_tpu_torch.workflow.optimizer import auto_cache

    seen = []
    real = auto_cache.profile_graph

    def spy(graph, scales, num_trials=1):
        seen.append(num_trials)
        return real(graph, scales, num_trials)

    monkeypatch.setattr(auto_cache, "profile_graph", spy)
    graph, _ = _count_graph()
    auto_cache.AutoCacheRule(num_trials=3, max_mem=1e9).apply(graph)
    assert seen == [3]


def test_serve_scrapes_the_given_registry():
    from keystone_tpu_torch.serving import ServingPlane, serve

    reg = MetricsRegistry()
    reg.counter("contract.only_here").inc(7)
    with ServingPlane(max_batch=4, device="cpu") as plane:
        server = serve(plane, port=0, registry=reg)
        try:
            url = f"http://127.0.0.1:{server.server_port}/metrics"
            with urllib.request.urlopen(url, timeout=30) as resp:
                text = resp.read().decode()
        finally:
            server.shutdown()
    assert "contract_only_here" in text
    assert "serving_requests_total" not in text


def test_record_instant_takes_its_time_as_the_jax_one():
    from keystone_tpu.observability.timeline import FlightRecorder as JRec
    from keystone_tpu_torch.observability.timeline import FlightRecorder

    rec, jrec = FlightRecorder(), JRec()
    for r in (rec, jrec):
        r.record_instant("mark", "resilience", ts_s=12.5, args={"k": 1})
        r.record_instant("now", "resilience")
    spans, jspans = rec.spans(), jrec.spans()
    assert [(s.name, s.ph, s.args) for s in spans] == [
        (s.name, s.ph, s.args) for s in jspans]
    assert spans[0].start_s == 12.5 and spans[1].start_s > 12.5


def test_utilization_report_counts_the_process_card_by_default():
    from keystone_tpu_torch.observability.utilization import (
        DevicePeaks, UtilizationWindow)

    peaks = DevicePeaks(kind="t", flops_per_s=1e9, hbm_bytes_per_s=1e9,
                        source="test")
    with UtilizationWindow() as w:
        torch.ones(64, 64) @ torch.ones(64, 64)
    got = w.report(elapsed_s=1.0, peaks=peaks)
    assert got == w.report(elapsed_s=1.0, n_devices=1, peaks=peaks)
    assert got["mfu"] == pytest.approx(
        2 * w.report(elapsed_s=1.0, n_devices=2, peaks=peaks)["mfu"])


def test_dense_sift_kernel_modes_on_the_cpu():
    from keystone_tpu_torch.ops.sift import dense_sift, dense_sift_plain

    img = torch.from_numpy(np.random.RandomState(5).rand(40, 48).astype(
        np.float32))
    want = dense_sift_plain(img, 4, 6, 2, 0)
    assert torch.equal(dense_sift(img, 4, 6, 2, 0), want)
    assert torch.equal(dense_sift(img, 4, 6, 2, 0, kernel_mode="einsum"),
                       want)
    with pytest.raises(ValueError, match="needs a CUDA image"):
        dense_sift(img, 4, 6, 2, 0, kernel_mode="banded")
    with pytest.raises(ValueError, match="needs a CUDA image"):
        dense_sift(img.to("meta"), kernel_mode="banded")
    with pytest.raises(ValueError, match="kernel_mode must be"):
        dense_sift(img, kernel_mode="banded_interpret")
    meta = dense_sift(img.to("meta"), 4, 6, 2, 0, kernel_mode="einsum")
    assert meta.shape == want.shape
    with pytest.raises(TypeError):
        dense_sift(img, 4, 6, 2, 0, None, "einsum")  # precision is JAX's


# -- JAX-style positional calls -----------------------------------------------

def _bound(fn, *args):
    return dict(inspect.signature(fn).bind(*args).arguments)


def test_jax_style_positional_calls_bind_as_in_the_jax_package():
    from keystone_tpu.parallel.dataset import ArrayDataset as JArrayDataset
    from keystone_tpu.parallel.streaming import (
        StreamingDataset as JStreamingDataset,
    )
    from keystone_tpu.serving.residency import model_charge as jcharge
    from keystone_tpu_torch.parallel.mesh import local_mesh
    from keystone_tpu_torch.parallel.streaming import StreamingDataset
    from keystone_tpu_torch.serving.residency import model_charge

    mesh = local_mesh()
    src = lambda: iter([_data(8)])  # noqa: E731
    stream_args = (src, 8, 8, mesh, 3, "t")
    assert _bound(StreamingDataset, *stream_args) == _bound(
        JStreamingDataset, *stream_args)
    stream = StreamingDataset(*stream_args, device="cpu")
    assert (stream.mesh, stream.prefetch_depth, stream.tag) == (mesh, 3, "t")
    assert str(stream.device) == "cpu"

    data = torch.zeros(4, 2)
    assert _bound(ArrayDataset, data, 4, mesh) == _bound(
        JArrayDataset, data, 4, mesh)
    assert ArrayDataset(data, 4, mesh).mesh is mesh
    with pytest.raises(TypeError):
        ArrayDataset(data, 4, mesh, False, "tag")  # _already_sharded is JAX's

    charge_args = (object(), np.zeros((1, 3), np.float32), 8, "m", 2)
    assert _bound(model_charge, *charge_args) == _bound(jcharge,
                                                        *charge_args)
    from keystone_tpu_torch.nodes.learning.linear import LinearMapper

    fitted = LinearMapper(torch.ones(3, 2)).to_pipeline()
    charge = model_charge(fitted, np.zeros((1, 3), np.float32), 8, "m", 2,
                          device="cpu")
    assert charge.data_shards == 2 and charge.bucket_rows == 8
