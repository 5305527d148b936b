"""Auto-caching: the port against ``keystone_tpu``.

The planning functions of ``workflow/optimizer/auto_cache.py`` give the
JAX package's answers on the same graphs, built in both packages: run
counts, the initial cache set, the linear generalization (to 1e-9
relative), the run-time estimate, the Cacher insertion, the aggressive
selection, and the greedy selection with the same injected profiles at
budgets 0, 1e12 and one between (the cases of
``tests/test_auto_cache.py``). Then the port's own profiling on the CPU
and ``AutoCachingOptimizer`` end to end.
"""
import numpy as np
import pytest
import torch

from keystone_tpu.nodes.learning import (
    BlockLeastSquaresEstimator as JBLS,
)
from keystone_tpu.nodes.stats import StandardScaler as JScaler
from keystone_tpu.nodes.util import MaxClassifier as JMax
from keystone_tpu.parallel.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.workflow import graph as jgraph_mod
from keystone_tpu.workflow.operators import DatasetOperator as JDatasetOp
from keystone_tpu.workflow.optimizer import auto_cache as jac
from keystone_tpu.workflow.optimizer.default import (
    AutoCachingOptimizer as JAutoCaching,
)
from keystone_tpu.workflow.transformer import transformer as jtransformer
from keystone_tpu_torch.nodes.learning import BlockLeastSquaresEstimator
from keystone_tpu_torch.nodes.stats import StandardScaler
from keystone_tpu_torch.nodes.util import MaxClassifier
from keystone_tpu_torch.parallel.dataset import ArrayDataset
from keystone_tpu_torch.workflow.common import Cacher
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.graph import Graph
from keystone_tpu_torch.workflow.operators import DatasetOperator
from keystone_tpu_torch.workflow.optimizer import auto_cache as tac
from keystone_tpu_torch.workflow.optimizer.default import (
    AutoCachingOptimizer,
    DefaultOptimizer,
)
from keystone_tpu_torch.workflow.transformer import transformer


@pytest.fixture(autouse=True)
def fresh_env():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


def _diamond(port: bool):
    """data -> a -> (b, c) -> d; a is consumed twice, c and d are sinks."""
    x = np.arange(32, dtype=np.float32).reshape(32, 1)
    if port:
        G, t, data = Graph, transformer, DatasetOperator(
            ArrayDataset.from_numpy(x, "cpu"))
    else:
        G, t, data = jgraph_mod.Graph, jtransformer, JDatasetOp(
            JArrayDataset.from_numpy(x))
    g = G()
    g, src = g.add_node(data, ())
    g, a = g.add_node(t(lambda v: v + 1.0), (src,))
    g, b = g.add_node(t(lambda v: v * 2.0), (a,))
    g, c = g.add_node(t(lambda v: v * 3.0), (a,))
    g, d = g.add_node(t(lambda v: v[0:1] * 1.0), (b,))
    g, _ = g.add_sink(d)
    g, _ = g.add_sink(c)
    return g


def _fit_graph(port: bool):
    """featurize -> StandardScaler -> BCD(8, 2) -> argmax, as an app
    composes it without Cachers: the featurized training set feeds the
    scaler's fit, the scaler's apply and the solver's fit."""
    rng = np.random.RandomState(0)
    X = rng.randn(24, 6).astype(np.float32)
    Y = np.where(rng.rand(24, 3) > 0.5, 1.0, -1.0).astype(np.float32)
    if port:
        ds, ys = (ArrayDataset.from_numpy(X, "cpu"),
                  ArrayDataset.from_numpy(Y, "cpu"))
        feat = transformer(lambda v: v * 2.0)
        pipe = feat.and_then(StandardScaler(), ds).and_then(
            BlockLeastSquaresEstimator(4, 2, 0.5), ds, ys) >> MaxClassifier()
    else:
        ds, ys = JArrayDataset.from_numpy(X), JArrayDataset.from_numpy(Y)
        feat = jtransformer(lambda v: v * 2.0)
        pipe = feat.and_then(JScaler(), ds).and_then(
            JBLS(4, 2, 0.5), ds, ys) >> JMax()
    return pipe.graph


GRAPHS = {"diamond": _diamond, "fit": _fit_graph}


def _ids(nodes):
    return sorted(n.id for n in nodes)


def _structure(graph):
    nodes = sorted((n.id, graph.get_operator(n).label(),
                    tuple((type(d).__name__, d.id)
                          for d in graph.get_dependencies(n)))
                   for n in graph.nodes)
    sinks = sorted((k.id, graph.get_sink_dependency(k).id)
                   for k in graph.sinks)
    return nodes, sinks


def _both(name):
    return GRAPHS[name](False), GRAPHS[name](True)


def _by_id(d):
    return {n.id: v for n, v in d.items()}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_get_runs_and_weights_match_jax(name):
    jg, tg = _both(name)
    jkids = jac._children_with_multiplicity(jg)
    tkids = tac._children_with_multiplicity(tg)
    assert ({n.id: sorted(c.id for c in v) for n, v in jkids.items()}
            == {n.id: sorted(c.id for c in v) for n, v in tkids.items()})
    jw = {n: jac.node_weight(jg.get_operator(n)) for n in jg.nodes}
    tw = {n: tac.node_weight(tg.get_operator(n)) for n in tg.nodes}
    assert _by_id(jw) == _by_id(tw)
    for pick in ([], [0], [0, -1]):
        jn = sorted(jg.nodes, key=lambda n: n.id)
        tn = sorted(tg.nodes, key=lambda n: n.id)
        jc = frozenset(jn[i] for i in pick)
        tc = frozenset(tn[i] for i in pick)
        assert (_by_id(jac.get_runs(jg, jkids, jc, jw))
                == _by_id(tac.get_runs(tg, tkids, tc, tw)))


def test_get_runs_counts_reuse_and_weights():
    g = _diamond(True)
    a, b, c, d = sorted(g.nodes, key=lambda n: n.id)[1:]
    kids = tac._children_with_multiplicity(g)
    weights = {n: 1 for n in g.nodes}
    runs = tac.get_runs(g, kids, frozenset(), weights)
    assert runs[a] == 2 and runs[b] == runs[c] == runs[d] == 1
    weights[b] = 5
    assert tac.get_runs(g, kids, frozenset(), weights)[a] == 6


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_init_cache_set_and_data_outputting_match_jax(name):
    jg, tg = _both(name)
    assert _ids(jac.init_cache_set(jg)) == _ids(tac.init_cache_set(tg))
    assert ({n.id: jac._data_outputting(jg, n) for n in jg.nodes}
            == {n.id: tac._data_outputting(tg, n) for n in tg.nodes})


@pytest.mark.parametrize("scales,values,at", [
    ((2, 4), (20.0, 40.0), 100),
    ((2, 4, 8), (5.0, 7.0, 8.0), 1000),
    ((2, 4), (40.0, 20.0), 64),       # a falling slope clamps at 0
])
def test_generalize_profiles_matches_jax(scales, values, at):
    js = [jac.SampleProfile(s, jac.Profile(v, 10 * v))
          for s, v in zip(scales, values)]
    ts = [tac.SampleProfile(s, tac.Profile(v, 10 * v))
          for s, v in zip(scales, values)]
    jp, tp = jac.generalize_profiles(at, js), tac.generalize_profiles(at, ts)
    assert tp.ns == pytest.approx(jp.ns, rel=1e-9)
    assert tp.mem == pytest.approx(jp.mem, rel=1e-9)


def _profiles(graph, profile_cls):
    """Seeded profiles keyed by node id: ns and bytes of each node."""
    rng = np.random.RandomState(7)
    out = {}
    for n in sorted(graph.nodes, key=lambda g: g.id):
        out[n] = profile_cls(ns=float(rng.randint(1, 100)) * 1e6,
                             mem=float(rng.randint(1, 100)) * 1e3)
    return out


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_estimate_cached_run_time_matches_jax(name):
    jg, tg = _both(name)
    jp, tp = _profiles(jg, jac.Profile), _profiles(tg, tac.Profile)
    jkids = jac._children_with_multiplicity(jg)
    tkids = tac._children_with_multiplicity(tg)
    jn = sorted(jg.nodes, key=lambda n: n.id)
    tn = sorted(tg.nodes, key=lambda n: n.id)
    for pick in ([], [1], [1, 2]):
        jt = jac.estimate_cached_run_time(
            jg, jkids, frozenset(jn[i] for i in pick), jp)
        tt = tac.estimate_cached_run_time(
            tg, tkids, frozenset(tn[i] for i in pick), tp)
        assert tt == jt


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_make_cached_graph_matches_jax(name):
    jg, tg = _both(name)
    jn = sorted(jg.nodes, key=lambda n: n.id)
    tn = sorted(tg.nodes, key=lambda n: n.id)
    for pick in ([1], [1, 2], list(range(len(jn)))):
        jout = jac.make_cached_graph(jg, frozenset(jn[i] for i in pick))
        tout = tac.make_cached_graph(tg, frozenset(tn[i] for i in pick))
        assert _structure(tout) == _structure(jout)


def test_make_cached_graph_points_consumers_at_the_cacher():
    g = _diamond(True)
    a, b, c = sorted(g.nodes, key=lambda n: n.id)[1:4]
    out = tac.make_cached_graph(g, frozenset({a}))
    cachers = [n for n in out.nodes
               if isinstance(out.get_operator(n), Cacher)]
    assert len(cachers) == 1
    assert out.get_dependencies(cachers[0]) == (a,)
    for n in (b, c):
        assert out.get_dependencies(n) == (cachers[0],)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_aggressive_selection_matches_jax(name):
    jg, tg = _both(name)
    jout = jac.AutoCacheRule(jac.AutoCacheRule.AGGRESSIVE).apply(jg)
    tout = tac.AutoCacheRule(tac.AutoCacheRule.AGGRESSIVE).apply(tg)
    assert _structure(tout) == _structure(jout)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("budget", [0.0, 1e12, "between"])
def test_greedy_selection_matches_jax(name, budget, monkeypatch):
    jg, tg = _both(name)
    jp, tp = _profiles(jg, jac.Profile), _profiles(tg, tac.Profile)
    monkeypatch.setattr(jac, "profile_graph", lambda g, s, t=1: jp)
    monkeypatch.setattr(tac, "profile_graph", lambda g, s, t=1: tp)
    if budget == "between":
        # room for some of the candidates and not for all of them
        budget = 0.5 * sum(p.mem for p in tp.values())
    jout = jac.AutoCacheRule(jac.AutoCacheRule.GREEDY, budget).apply(jg)
    tout = tac.AutoCacheRule(tac.AutoCacheRule.GREEDY, budget).apply(tg)
    assert _structure(tout) == _structure(jout)
    added = len(tout.nodes) - len(tg.nodes)
    if budget == 0.0:
        assert added == 0
    if budget == 1e12:
        assert added > 0


def test_auto_caching_optimizer_runs_the_jax_batches():
    assert ([b.name for b in AutoCachingOptimizer().batches]
            == [b.name for b in JAutoCaching().batches])
    assert ([b.name for b in AutoCachingOptimizer().batches]
            == [b.name for b in DefaultOptimizer().batches] + ["auto-cache"])


def test_profile_graph_measures_every_executable_node():
    g = _fit_graph(True)
    profiles = tac.profile_graph(g, scales=(2, 4))
    unexec = g.source_descendants()
    assert set(profiles) == {n for n in g.nodes if n not in unexec}
    assert all(p.ns >= 0 and p.mem >= 0 for p in profiles.values())
    # the sampled fits stay out of the global prefix memo
    assert not PipelineEnv.get_or_create().state


def test_budget_on_the_cpu_is_the_jax_fallback():
    g = _fit_graph(True)
    assert tac._graph_device(g) == torch.device("cpu")
    assert tac._device_mem_budget(tac._graph_device(g)) == 0.75 * 8 * 2**30


def test_auto_caching_fit_predicts_as_the_default_fit():
    rng = np.random.RandomState(1)
    Xt = rng.randn(10, 6).astype(np.float32)
    preds = {}
    for name, opt in (("default", DefaultOptimizer()),
                      ("auto", AutoCachingOptimizer())):
        PipelineEnv.reset()
        PipelineEnv.get_or_create().set_optimizer(opt)
        pipe = _fit_graph_pipeline()
        if name == "auto":
            # the reused featurized training set gets a Cacher
            g = opt.execute(pipe.graph)
            assert "Cacher" in [type(g.get_operator(n)).__name__
                                for n in g.nodes]
        fitted = pipe.fit()
        preds[name] = fitted.apply(ArrayDataset.from_numpy(
            Xt, "cpu")).get().numpy()
    np.testing.assert_array_equal(preds["default"], preds["auto"])


def _fit_graph_pipeline():
    rng = np.random.RandomState(0)
    X = rng.randn(24, 6).astype(np.float32)
    Y = np.where(rng.rand(24, 3) > 0.5, 1.0, -1.0).astype(np.float32)
    ds, ys = (ArrayDataset.from_numpy(X, "cpu"),
              ArrayDataset.from_numpy(Y, "cpu"))
    return transformer(lambda v: v * 2.0).and_then(StandardScaler(), ds) \
        .and_then(BlockLeastSquaresEstimator(4, 2, 0.5), ds, ys) \
        >> MaxClassifier()
