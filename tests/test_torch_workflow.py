"""The port's workflow layer: graph surgery, composition, the optimizer
rules, fit/apply/apply_datum and Cacher.

A representative subset of ``tests/test_graph.py`` and
``tests/test_pipeline.py`` run on the port, plus parity checks that the
same graph construction yields the same structure in both packages. All
comparisons are exact (graph structure) or at float32 rounding
(rtol 1e-6 / 1e-5 for the small arithmetic the toy nodes do).
"""
import pickle

import numpy as np
import pytest
import torch

from keystone_tpu.workflow.graph import Graph as JGraph
from keystone_tpu.workflow.operators import Operator as JOperator
from keystone_tpu_torch.parallel.dataset import ArrayDataset
from keystone_tpu_torch.workflow import (
    Cacher,
    Estimator,
    Identity,
    LabelEstimator,
    Pipeline,
    PipelineEnv,
    Transformer,
    transformer,
)
from keystone_tpu_torch.workflow.graph import Graph
from keystone_tpu_torch.workflow.graph_ids import NodeId
from keystone_tpu_torch.workflow.operators import Operator
from keystone_tpu_torch.workflow.optimizer.rules import (
    EquivalentNodeMergeRule,
    SavedStateLoadRule,
    UnusedBranchRemovalRule,
)


@pytest.fixture(autouse=True)
def fresh_port_env():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


# -- graph surgery (tests/test_graph.py) --------------------------------------

class Op(Operator):
    def __init__(self, tag):
        self.tag = tag


class JOp(JOperator):
    def __init__(self, tag):
        self.tag = tag


def build_chain(graph_cls=Graph, op_cls=Op):
    g = graph_cls()
    g, src = g.add_source()
    g, a = g.add_node(op_cls("a"), (src,))
    g, b = g.add_node(op_cls("b"), (a,))
    g, sink = g.add_sink(b)
    return g, src, a, b, sink


def test_add_node_and_sink():
    g, src, a, b, sink = build_chain()
    assert g.sources == {src}
    assert set(g.nodes) == {a, b}
    assert g.get_sink_dependency(sink) == b
    assert g.get_dependencies(b) == (a,)
    assert len({src.id, a.id, b.id, sink.id}) == 4


def test_set_operator_is_by_copy():
    g, src, a, b, sink = build_chain()
    g2 = g.set_operator(a, Op("c"))
    assert g2.get_operator(a).tag == "c"
    assert g.get_operator(a).tag == "a"
    assert g.set_dependencies(b, (src,)).get_dependencies(b) == (src,)


def test_remove_node_after_rerouting():
    g, src, a, b, sink = build_chain()
    g2 = g.replace_dependency(b, a).remove_sink(sink)
    g2, k2 = g2.add_sink(a)
    g2 = g2.remove_node(b)
    assert set(g2.nodes) == {a}
    assert g2.get_sink_dependency(k2) == a


def test_connect_graph_splices_source_to_sink():
    g1, src1, a1, b1, sink1 = build_chain()
    g2, src2, a2, b2, sink2 = build_chain()
    merged, smap, kmap = g1.connect_graph(g2, {src2: sink1})
    assert merged.sources == {src1}
    assert sink1 not in merged.sinks and len(merged.sinks) == 1
    nb2 = merged.get_sink_dependency(kmap[sink2])
    (na2,) = merged.get_dependencies(nb2)
    assert merged.get_dependencies(na2) == (b1,)


def test_ancestors_descendants_linearize_induce():
    g, src, a, b, sink = build_chain()
    assert g.get_ancestors(sink) == {b, a, src}
    assert g.get_descendants(src) == {a, b, sink}
    order = g.linearize()
    assert order.index(src) < order.index(a) < order.index(b)
    sub = g.induce(frozenset({a, src}))
    assert set(sub.nodes) == {a} and sub.sources == {src} and not sub.sinks


def test_graph_structure_matches_reference():
    """The same surgery on both packages yields the same ids, order and
    DOT text (the graph layer is a copy)."""
    def surgery(graph_cls, op_cls):
        g1, *_ , sink1 = build_chain(graph_cls, op_cls)
        g2, src2, *_ , sink2 = build_chain(graph_cls, op_cls)
        merged, _, kmap = g1.connect_graph(g2, {src2: sink1})
        return merged

    port, ref = surgery(Graph, Op), surgery(JGraph, JOp)
    assert [repr(x) for x in port.linearize()] == \
        [repr(x) for x in ref.linearize()]
    assert port.to_dot().replace("Op", "") == ref.to_dot().replace("JOp", "")


# -- composition and execution (tests/test_pipeline.py) -----------------------

class Scale(Transformer):
    def __init__(self, k):
        self.k = k

    def apply(self, x):
        return x * self.k


class AddOne(Transformer):
    def apply(self, x):
        return x + 1


class Shift(Transformer):
    def __init__(self, b):
        self.b = np.asarray(b, np.float32)

    def apply(self, x):
        return x + torch.as_tensor(self.b)


class MeanCenterEstimator(Estimator):
    num_fits = 0

    def _fit(self, ds):
        MeanCenterEstimator.num_fits += 1
        return Shift(-ds.numpy().mean(axis=0))


class OffsetByLabelMean(LabelEstimator):
    num_fits = 0

    def _fit(self, ds, labels):
        OffsetByLabelMean.num_fits += 1
        return Shift(labels.numpy().mean(axis=0))


def data(n=16, d=4, seed=0):
    return np.random.RandomState(seed).rand(n, d).astype(np.float32)


def ds(x):
    return ArrayDataset.from_numpy(x, "cpu")


def test_transformer_apply_datum_and_dataset():
    x = data()
    assert float(Scale(3.0).bind_datum(torch.tensor(2.0)).get()) == 6.0
    np.testing.assert_allclose(Scale(2.0)(ds(x)).numpy(), x * 2, rtol=1e-6)


@pytest.mark.parametrize("compose", ["rshift", "and_then"])
def test_chaining(compose):
    x = data()
    if compose == "rshift":
        pipe = Scale(2.0) >> AddOne() >> Scale(0.5)
    else:
        pipe = Scale(2.0).and_then(AddOne()).and_then(Scale(0.5))
    np.testing.assert_allclose(pipe.apply(ds(x)).numpy(), (x * 2 + 1) * 0.5,
                               rtol=1e-6)


def test_estimator_chain_fits_once():
    MeanCenterEstimator.num_fits = 0
    x = data()
    pipe = AddOne().and_then(MeanCenterEstimator(), ds(x))
    out = pipe.apply(ds(x)).numpy()
    np.testing.assert_allclose(out, (x + 1) - (x + 1).mean(axis=0),
                               rtol=1e-5, atol=1e-5)
    pipe.apply(ds(data(seed=1))).numpy()
    pipe.apply_datum(torch.as_tensor(x[0])).get()
    assert MeanCenterEstimator.num_fits == 1


def test_label_estimator_chain():
    OffsetByLabelMean.num_fits = 0
    x, y = data(), data(seed=2)
    pipe = Scale(1.0).and_then(OffsetByLabelMean(), ds(x), ds(y))
    np.testing.assert_allclose(pipe.apply(ds(x)).numpy(), x + y.mean(axis=0),
                               rtol=1e-5, atol=1e-5)
    assert OffsetByLabelMean.num_fits == 1


def test_gather_then_combine():
    x = data()
    branches = Pipeline.gather([Scale(1.0), Scale(2.0)])

    class Sum(Transformer):
        def apply(self, xs):
            return xs[0] + xs[1]

    out = (branches >> Sum()).apply(ds(x)).numpy()
    np.testing.assert_allclose(out, x * 3, rtol=1e-6)
    got = branches.apply(ds(x)).numpy()
    assert isinstance(got, tuple) and len(got) == 2


def test_fit_returns_picklable_pipeline_that_never_refits():
    MeanCenterEstimator.num_fits = 0
    x = data()
    fitted = (AddOne().and_then(MeanCenterEstimator(), ds(x))
              >> Scale(2.0)).fit()
    assert MeanCenterEstimator.num_fits == 1
    out1 = fitted.apply(ds(x)).numpy()
    restored = pickle.loads(pickle.dumps(fitted))
    np.testing.assert_allclose(restored.apply(ds(x)).numpy(), out1, rtol=1e-6)
    np.testing.assert_allclose(out1, ((x + 1) - (x + 1).mean(axis=0)) * 2,
                               rtol=1e-5, atol=1e-5)
    fitted.apply(ds(data(seed=3))).numpy()
    assert MeanCenterEstimator.num_fits == 1


def test_incremental_state_reuse_across_pipelines():
    MeanCenterEstimator.num_fits = 0
    d = ds(data())
    AddOne().and_then(MeanCenterEstimator(), d).apply(d).numpy()
    (AddOne().and_then(MeanCenterEstimator(), d) >> Scale(5.0)).apply(d).numpy()
    assert MeanCenterEstimator.num_fits == 1


def test_fresh_data_never_hits_a_freed_objects_memo_entry():
    """Constant data is keyed by a per-object token, not ``id()``: a new
    object that reuses a freed object's id must not be served the freed
    object's cached results."""
    x = data()
    pipe = (AddOne().and_then(MeanCenterEstimator(), ds(x))
            >> Cacher("c")).fit()
    xt = torch.as_tensor(x)
    for i in range(6):
        # a fresh view per call, freed as soon as the call returns
        got = pipe.apply_datum(xt[i]).get()
        want = (x[i] + 1) - (x + 1).mean(axis=0)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    for seed in range(3):
        fresh = data(seed=10 + seed)
        np.testing.assert_allclose(
            pipe.apply(ds(fresh)).numpy(),
            (fresh + 1) - (x + 1).mean(axis=0), rtol=1e-5, atol=1e-5)


def test_lambda_transformer_identity_and_cacher():
    x = data()
    np.testing.assert_allclose(transformer(lambda v: v * 4.0)(ds(x)).numpy(),
                               x * 4, rtol=1e-6)
    pipe = Identity() >> Cacher("t") >> Scale(2.0)
    np.testing.assert_allclose(pipe.apply(ds(x)).numpy(), x * 2, rtol=1e-6)
    assert Cacher("t").label() == "Cache(t)"


def test_datum_and_batch_paths_agree_through_estimator_pipeline():
    x = data()
    pipe = AddOne().and_then(MeanCenterEstimator(), ds(x))
    batch = pipe.apply(ds(x)).numpy()
    for i in (0, 7):
        one = pipe.apply_datum(torch.as_tensor(x[i])).get().numpy()
        np.testing.assert_allclose(one, batch[i], rtol=1e-6)


def test_cacher_output_is_saved_and_reused():
    calls = []

    class Count(Transformer):
        def apply_batch(self, X):
            calls.append(1)
            return X * 3

    d = ds(data())
    featurize = Count() >> Cacher("f")
    a = featurize.apply(d).numpy()
    b = (featurize >> Identity()).apply(d).numpy()
    np.testing.assert_array_equal(a, b)
    assert len(calls) == 1


# -- optimizer rules ----------------------------------------------------------

def test_cse_merges_equal_nodes():
    g = Graph()
    g, src = g.add_source()
    g, a1 = g.add_node(Scale(2.0), (src,))
    g, a2 = g.add_node(Scale(2.0), (src,))
    g, b = g.add_node(Scale(3.0), (src,))
    g, k1 = g.add_sink(a1)
    g, k2 = g.add_sink(a2)
    g, k3 = g.add_sink(b)
    out = EquivalentNodeMergeRule().apply(g)
    assert len(out.nodes) == 2
    assert out.get_sink_dependency(k1) == out.get_sink_dependency(k2)
    assert out.get_sink_dependency(k3) == b
    assert EquivalentNodeMergeRule().apply(out) is out


def test_unused_branch_removal():
    g = Graph()
    g, src = g.add_source()
    g, a = g.add_node(Scale(2.0), (src,))
    g, dead = g.add_node(Scale(9.0), (a,))
    g, k = g.add_sink(a)
    out = UnusedBranchRemovalRule().apply(g)
    assert set(out.nodes) == {a} and out.sources == {src}
    assert UnusedBranchRemovalRule().apply(out) is out


def test_saved_state_load_substitutes_computed_prefix():
    MeanCenterEstimator.num_fits = 0
    d = ds(data())
    pipe = AddOne().and_then(MeanCenterEstimator(), d)
    pipe.apply(d).numpy()
    assert PipelineEnv.get_or_create().state
    rewritten = SavedStateLoadRule().apply(pipe.graph)
    labels = {rewritten.get_operator(n).label() for n in rewritten.nodes}
    assert "Saved" in labels
    assert isinstance(next(iter(rewritten.nodes)), NodeId)


def test_lambda_estimators_fit_through_the_graph():
    from keystone_tpu_torch.workflow.estimator import estimator
    from keystone_tpu_torch.workflow.label_estimator import (
        LambdaLabelEstimator,
    )

    x, y = data(), data(seed=5)

    @estimator
    def center(d):
        return Shift(-d.numpy().mean(axis=0))

    out = AddOne().and_then(center, ds(x)).apply(ds(x)).numpy()
    np.testing.assert_allclose(out, (x + 1) - (x + 1).mean(axis=0),
                               rtol=1e-5, atol=1e-5)
    assert center.label() == "center"
    offset = LambdaLabelEstimator(
        lambda d, labels: Shift(labels.numpy().mean(axis=0)), "offset")
    fitted = offset.fit(ds(x), ds(y))
    np.testing.assert_allclose(fitted.apply(torch.as_tensor(x[0])).numpy(),
                               x[0] + y.mean(axis=0), rtol=1e-5)
