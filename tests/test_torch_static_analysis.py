"""The static analyzer and the node rule's static path: the port against
``keystone_tpu``.

For each app of ``CHECK_APPS``: every node's resolved spec (shape and
dtype name) and the set of diagnostic codes equal the JAX package's, and
the static plan equals the JAX plan node by node under the JAX liveness
(``plan_graph(memo_held=False)``) except where the port holds other
tensors (the Fisher-vector kernel's workspace, ROADMAP Queue C). Each
lint fires on a synthetic broken graph, as the JAX package's does. The
node rule's defaults make the JAX default's choices with the same
provenance on the CIFAR solver pipeline, a seeded sparse set, VOC's PCA
and GMM at small widths and a streamed input; with both packages'
switches off, the sampled paths agree. JAX's checks run with one data
shard (the port's one GPU). Every comparison is exact: specs and codes
are strings, plans are byte counts from the same integer geometry.
"""
import json

import jax
import numpy as np
import pytest
import torch

from keystone_tpu import pipelines as jpipelines
from keystone_tpu.nodes.learning import least_squares as jls
from keystone_tpu.observability.trace import PipelineTrace as JTrace
from keystone_tpu.workflow.optimizer.node_rule import (
    NodeOptimizationRule as JRule,
)
from keystone_tpu_torch import pipelines as tpipelines
from keystone_tpu_torch.analysis import (
    DatasetSpec,
    ShapeDtype,
    SparseSpec,
    Unknown,
    analyze,
    as_input_spec,
    check_graph,
    plan_graph,
    spec_dataset,
)
from keystone_tpu_torch.analysis.diagnostics import (
    apply_body_host_coercions,
    fusion_prefix_lint,
)
from keystone_tpu_torch.analysis.interpreter import classify_failure
from keystone_tpu_torch.analysis.resources import fv_apply_transient_nbytes
from keystone_tpu_torch.nodes.learning import least_squares as tls
from keystone_tpu_torch.observability.trace import PipelineTrace
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.optimizer.node_rule import (
    NodeOptimizationRule,
)
from keystone_tpu_torch.workflow.transformer import (
    HostTransformer,
    LambdaTransformer,
    Transformer,
)

EC2 = jls.REFERENCE_EC2_WEIGHTS
APPS = sorted(tpipelines.CHECK_APPS)


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    # both rules on their defaults: the static path
    monkeypatch.delenv("KEYSTONE_STATIC_NODE_OPT", raising=False)
    monkeypatch.delenv("KEYSTONE_TORCH_STATIC_NODE_OPT", raising=False)
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


def _reports(app):
    port = tpipelines.CHECK_APPS[app]()
    ref = jpipelines.CHECK_APPS[app]()
    return (port.pipeline.check(port.input_spec, name=port.name),
            ref.pipeline.check(ref.input_spec, name=ref.name,
                               data_shards=1))


def _nodes(report):
    return [(n["node_id"], n["operator"], n["spec"])
            for n in report.to_dict()["nodes"]]


# -- the apps ----------------------------------------------------------------

def test_the_registry_is_the_jax_packages():
    assert APPS == sorted(jpipelines.CHECK_APPS)
    for name in APPS:
        assert tpipelines.resolve_check_app(name.replace(".", "_")) is \
            tpipelines.CHECK_APPS[name]
    with pytest.raises(KeyError):
        tpipelines.resolve_check_app("no.such_app")


@pytest.mark.parametrize("app", APPS)
def test_app_specs_and_codes_match_jax(app):
    port, ref = _reports(app)
    assert _nodes(port) == _nodes(ref)
    assert {d.code for d in port.diagnostics} == \
        {d.code for d in ref.diagnostics}
    assert port.ok and port.resolved_nodes() == ref.resolved_nodes()


@pytest.mark.parametrize("app", APPS)
def test_app_plan_matches_jax_where_the_port_holds_the_same(app):
    port, ref = _reports(app)
    p = port.analysis
    jax_liveness = plan_graph(p, app, memo_held=False)
    ref_entries = {e["node_id"]: e for e in ref.plan.entries}
    keys = ("out_nbytes", "transient_nbytes", "carry_nbytes", "item_nbytes")
    for e in jax_liveness.entries:
        r = ref_entries[e["node_id"]]
        assert e["operator"] == r["operator"]
        for key in keys:
            if e[key] == r[key]:
                continue
            # the one place the port holds other tensors: the fv_moments
            # kernel's moment sums, not the (nDesc, K) posteriors
            assert (e["operator"], key) == ("Delegate", "transient_nbytes")
            t = p.value(p.graph.get_dependencies(
                next(n for n in p.graph.nodes if n.id == e["node_id"]))[0])
            assert t.label == "GMMFisherVectorEstimator"
            assert e[key] < r[key]
    diverges = jax_liveness.fit_peak_nbytes != ref.plan.fit_peak_nbytes
    assert diverges == (app == "voc.sift_fisher")
    assert (jax_liveness.model_nbytes, jax_liveness.apply_item_nbytes) == \
        (ref.plan.model_nbytes, ref.plan.apply_item_nbytes)
    # the executor memo holds every value to the end
    assert port.plan.fit_peak_nbytes >= jax_liveness.fit_peak_nbytes


def test_fv_workspace_is_the_kernels_moment_sums():
    # VOC's check target: D = 8 descriptors, K = 4 components
    assert fv_apply_transient_nbytes(8, 4, 145) == 4.0 * (4 + 2 * 8 * 4)


def test_check_allocates_nothing_and_launches_nothing():
    from keystone_tpu_torch.ops import kernels

    launches = dict(kernels.LAUNCHES)
    target = tpipelines.resolve_check_app("voc.sift_fisher")()
    assert target.pipeline.check(target.input_spec).ok
    assert kernels.LAUNCHES == launches


def test_report_summary_and_json():
    target = tpipelines.resolve_check_app("speech.timit")()
    report = target.pipeline.check(target.input_spec, name="timit")
    text = report.summary()
    assert "statically clean" in text and "CosineRandomFeatures" in text
    blob = json.loads(report.to_json())
    assert blob["name"] == "timit" and blob["diagnostics"] == []
    assert blob["plan"]["fit_peak_nbytes"] == report.plan.fit_peak_nbytes


# -- the lints ---------------------------------------------------------------

def _t(fn, name):
    return LambdaTransformer(fn, name)


def _codes(report, code):
    return [d for d in report.diagnostics if d.code == code]


def test_shape_mismatch_fires_once_like_jax():
    from keystone_tpu.nodes.stats import RandomSignNode as JSign
    from keystone_tpu.workflow.transformer import LambdaTransformer as JLam
    from keystone_tpu_torch.nodes.stats import RandomSignNode

    port = (RandomSignNode(np.ones(784)) >> _t(lambda x: x + 1, "a")
            >> _t(lambda x: x * 2, "b")).check(
        ShapeDtype((32,), torch.float32))
    ref = (JSign(np.ones(784)) >> JLam(lambda x: x + 1, "a")
           >> JLam(lambda x: x * 2, "b")).check(
        jax.ShapeDtypeStruct((32,), np.float32), data_shards=1)
    bad = _codes(port, "shape-mismatch")
    assert len(bad) == 1 == len(_codes(ref, "shape-mismatch"))
    assert bad[0].operator == "RandomSignNode"


def test_dtype_narrowing_fires_and_respects_narrowing_ok():
    pipe = (_t(lambda x: x + 1.0, "f32")
            >> _t(lambda x: x.to(torch.bfloat16), "narrow")
            >> _t(lambda x: x * 2, "after"))
    narrow = _codes(pipe.check(ShapeDtype((8,), torch.float32)),
                    "dtype-narrowing")
    assert len(narrow) == 1 and narrow[0].operator == "narrow"

    class DeliberateCast(Transformer):
        narrowing_ok = True

        def apply(self, x):
            return x.to(torch.bfloat16)

    ok = (_t(lambda x: x + 1.0, "f32") >> DeliberateCast()).check(
        ShapeDtype((8,), torch.float32))
    assert not _codes(ok, "dtype-narrowing")


def test_unbound_source_and_dead_branch_fire():
    from keystone_tpu_torch.workflow.graph import Graph
    from keystone_tpu_torch.workflow.operators import DatasetOperator

    pipe = _t(lambda x: x + 1.0, "a") >> _t(lambda x: x * 2.0, "b")
    assert _codes(pipe.check(), "unbound-source")
    g = Graph()
    g, live = g.add_node(DatasetOperator(spec_dataset((4,), n=8)), ())
    g, _ = g.add_sink(live)
    g, dead = g.add_node(_t(lambda x: x + 1, "dead"), (live,))
    dead_diags = _codes(check_graph(g), "dead-branch")
    assert len(dead_diags) == 1 and dead_diags[0].node_id == dead.id


@pytest.mark.parametrize("read", ["item", "tolist", "cpu", "numpy", "bool",
                                  "float", "np.asarray", "mask", "nonzero"])
def test_host_reads_on_meta_are_host_sync(read):
    fns = {
        "item": lambda x: x * x.sum().item(),
        "tolist": lambda x: torch.tensor(x.tolist()),
        "cpu": lambda x: x.cpu() + 1.0,
        "numpy": lambda x: torch.as_tensor(x.numpy()),
        "bool": lambda x: x if bool(x.sum() > 0) else -x,
        "float": lambda x: x * float(x.max()),
        "np.asarray": lambda x: torch.as_tensor(np.asarray(x) + 1.0),
        "mask": lambda x: x[x > 0],
        "nonzero": lambda x: x.nonzero(),
    }
    report = _t(fns[read], "hostish").check(ShapeDtype((8,), torch.float32))
    assert [d.code for d in report.diagnostics] == ["host-sync"]


def test_a_shape_error_is_not_host_sync():
    assert classify_failure(RuntimeError(
        "a and b must have same reduction dim")) == "shape-mismatch"
    assert classify_failure(ValueError("bad")) == "shape-mismatch"


def test_host_sync_ast_lint():
    class BadNode(Transformer):
        def apply(self, x):
            return x * (x * 2).sum().item()

    class Coerce(Transformer):
        def apply(self, x):
            return torch.as_tensor(np.asarray(x) * 2.0)

    class Casts(Transformer):
        def apply(self, x):
            return x * int(x[0]) * float(x.mean()) if bool(x.any()) else x

    class GoodNode(Transformer):
        def apply(self, x):
            idx = np.arange(int(x.shape[-1]))  # metadata and config
            return x[torch.as_tensor(idx)] * len(x)

    class HostNode(HostTransformer):
        def apply(self, x):
            return x.cpu().numpy().tolist()

    assert apply_body_host_coercions(BadNode) == ["x...item()"]
    assert apply_body_host_coercions(Coerce) == ["np.asarray(x)"]
    assert sorted(apply_body_host_coercions(Casts)) == [
        "bool(x)", "float(x)", "int(x)"]
    assert apply_body_host_coercions(GoodNode) == []
    assert apply_body_host_coercions(HostNode) == []
    report = BadNode().check(ShapeDtype((4,), torch.float32))
    # the static form and the meta run both name it
    assert [d.code for d in report.diagnostics] == ["host-sync",
                                                    "host-sync"]


def test_fusion_prefix_lint_fires_on_a_noncanonical_fusion():
    from keystone_tpu_torch.workflow.estimator import LambdaEstimator
    from keystone_tpu_torch.workflow.graph_ids import NodeId

    class OpaqueComposite(Transformer):
        def __init__(self, stages):
            self.composite_stages = list(stages)

        def eq_key(self):
            return (OpaqueComposite,
                    tuple(s._cached_eq_key() for s in self.composite_stages))

        def apply(self, x):
            for s in self.composite_stages:
                x = s.apply(x)
            return x

    def bad_fuse(graph):
        for b in sorted(graph.nodes, key=lambda n: n.id):
            deps = graph.get_dependencies(b)
            if len(deps) == 1 and isinstance(deps[0], NodeId):
                a = deps[0]
                op_a, op_b = graph.get_operator(a), graph.get_operator(b)
                if not (isinstance(op_a, LambdaTransformer)
                        and isinstance(op_b, LambdaTransformer)):
                    continue
                g = graph.set_operator(b, OpaqueComposite([op_a, op_b]))
                g = g.set_dependencies(b, graph.get_dependencies(a))
                return g.remove_node(a)
        return graph

    def fixpoint(graph):
        while True:
            nxt = bad_fuse(graph)
            if nxt is graph:
                return graph
            graph = nxt

    est = LambdaEstimator(lambda ds: _t(lambda x: x, "id"), "E")
    pipe = (_t(lambda x: x + 1, "a") >> _t(lambda x: x * 2, "b")).and_then(
        est, spec_dataset((4,), n=8))
    diags = fusion_prefix_lint(pipe.graph, fuse=fixpoint)
    assert [d.code for d in diags] == ["fusion-prefix-hazard"]
    assert fusion_prefix_lint(pipe.graph) == []


def _stream(n=96, d=6, chunk=32):
    from keystone_tpu_torch.parallel.streaming import StreamingDataset

    X = np.random.RandomState(0).randn(n, d).astype(np.float32)
    return StreamingDataset.from_numpy(X, chunk, device="cpu")


def test_streaming_lints_fire():
    from keystone_tpu_torch.nodes.learning.zca import ZCAWhitenerEstimator
    from keystone_tpu_torch.nodes.util.sparse import Sparsify
    from keystone_tpu_torch.parallel.dataset import ArrayDataset

    est = ZCAWhitenerEstimator().with_data(_stream())
    report = est.check(ShapeDtype((6,), torch.float32))
    assert [d.operator for d in _codes(report, "non-streamable-fit")] == [
        "ZCAWhitenerEstimator"]
    labels_only = tls.LeastSquaresEstimator(**EC2).with_data(
        ArrayDataset.from_numpy(np.zeros((96, 6), np.float32), "cpu"),
        _stream(d=2))
    assert _codes(labels_only.check(ShapeDtype((6,), torch.float32)),
                  "non-streamable-fit")
    host = Sparsify().to_pipeline()
    report = host.check(DatasetSpec(ShapeDtype((6,), torch.float32),
                                    n=96, streaming=True))
    assert [d.operator for d in _codes(report, "host-stage-on-stream")] == [
        "Sparsify"]


def test_hbm_budget_fires_below_the_plan():
    target = tpipelines.resolve_check_app("cifar.linear_pixels")()
    report = target.pipeline.check(target.input_spec)
    tight = target.pipeline.check(
        target.input_spec, hbm_budget=report.plan.fit_peak_nbytes - 1)
    assert [d.code for d in tight.diagnostics] == ["hbm-budget"]
    assert target.pipeline.check(
        target.input_spec, hbm_budget=report.plan.fit_peak_nbytes).ok


def test_spec_dataset_refuses_execution():
    ds = spec_dataset((8,), torch.float32, n=16)
    assert len(ds) == 16
    with pytest.raises(RuntimeError, match="static-analysis placeholder"):
        ds.collect()
    with pytest.raises(RuntimeError):
        ds.map(lambda x: x)


def test_input_specs():
    spec = as_input_spec(((3, 4), np.float32))
    assert spec.element == ShapeDtype((3, 4), torch.float32)
    assert as_input_spec(torch.zeros(5, dtype=torch.int32)).element == \
        ShapeDtype((5,), torch.int32)
    assert as_input_spec(spec) is spec
    with pytest.raises(TypeError):
        as_input_spec(object())


def test_stream_plan_is_the_streams_own_sizer():
    from keystone_tpu_torch.parallel.streaming import StreamingDataset
    from keystone_tpu_torch.workflow.operators import DatasetOperator
    from keystone_tpu_torch.workflow.graph import Graph

    X = np.zeros((100, 8), np.uint8)
    stream = StreamingDataset.from_numpy(X, 32, device="cpu",
                                         compute_dtype=np.float32)
    g = Graph()
    g, node = g.add_node(DatasetOperator(stream), ())
    g, _ = g.add_sink(node)
    plan = plan_graph(analyze(g))
    # two staged uint8 chunks, one float32 working chunk, one cast chunk
    assert plan.fit_peak_nbytes == stream.static_plan_nbytes() == \
        2 * 32 * 8 + 32 * 8 * 4 + 32 * 8


# -- the node rule's static path -----------------------------------------------

def _choices(trace):
    return [(c["optimizable"], c["chosen"], c["prefix"], c["full_n"],
             c["provenance"]) for c in trace.node_choices]


def _decisions(trace):
    return [(d["n"], d["d"], d["k"], d["sparsity"], d["chosen"],
             d["shape_source"], bool(d.get("streaming_restricted")))
            for d in trace.solver_decisions]


def _run_rules(port_graph, jax_graph, **kw):
    with PipelineTrace("port") as tr:
        NodeOptimizationRule(num_machines=1, **kw).apply(port_graph)
    with JTrace("jax") as jtr:
        JRule(num_machines=1, **kw).apply(jax_graph)
    return tr, jtr


def _cifar_solver_pipes(n=60, lam=10.0):
    from keystone_tpu.nodes.images.core import FusedConvRectifyPool as JFused
    from keystone_tpu.nodes.stats import StandardScaler as JScaler
    from keystone_tpu.parallel.dataset import ArrayDataset as JArray
    from keystone_tpu_torch.nodes.images.core import FusedConvRectifyPool
    from keystone_tpu_torch.nodes.stats import StandardScaler
    from keystone_tpu_torch.parallel.dataset import ArrayDataset

    rng = np.random.RandomState(3)
    imgs = (rng.rand(n, 32, 32, 3) * 255).astype(np.float32)
    labels = np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)]
    filters = rng.randn(8, 108).astype(np.float32)
    port = (FusedConvRectifyPool(filters, 32, 6, 3, 13, 14, 0.25)
            .and_then(StandardScaler(), ArrayDataset.from_numpy(imgs, "cpu"))
            .and_then(tls.LeastSquaresEstimator(lam=lam, **EC2),
                      ArrayDataset.from_numpy(imgs, "cpu"),
                      ArrayDataset.from_numpy(labels, "cpu")))
    ref = (JFused(filters, 32, 6, 3, 13, 14, 0.25)
           .and_then(JScaler(), JArray.from_numpy(imgs))
           .and_then(jls.LeastSquaresEstimator(lam=lam, **EC2),
                     JArray.from_numpy(imgs), JArray.from_numpy(labels)))
    return port, ref


def test_cifar_solver_choice_is_static_like_jax(mesh8):
    port, ref = _cifar_solver_pipes()
    tr, jtr = _run_rules(port.graph, ref.graph)
    assert _choices(tr) == _choices(jtr)
    assert _decisions(tr) == _decisions(jtr)
    assert [c[-1] for c in _choices(tr)] == ["static"]
    # structural density: the rectified features rank as dense
    assert _decisions(tr)[0][3] == 1.0


def test_static_path_opt_out_is_jax_sampled_path(mesh8, monkeypatch):
    monkeypatch.setenv("KEYSTONE_STATIC_NODE_OPT", "0")
    monkeypatch.setenv("KEYSTONE_TORCH_STATIC_NODE_OPT", "0")
    assert NodeOptimizationRule().static_shapes is False
    port, ref = _cifar_solver_pipes()
    tr, jtr = _run_rules(port.graph, ref.graph)
    assert [c[-1] for c in _choices(tr)] == ["sampled"]
    assert _choices(tr) == _choices(jtr)
    # the sampled density is measured on the sample's values
    (n, d, k, sparsity, chosen, source, _), = _decisions(tr)
    (jn, jd, jk, jsparsity, jchosen, jsource, _), = _decisions(jtr)
    assert (n, d, k, chosen, source) == (jn, jd, jk, jchosen, jsource)
    assert source == "sampled"
    assert sparsity == pytest.approx(jsparsity, abs=1e-6)


@pytest.mark.parametrize("value,static", [("0", False), ("false", False),
                                          ("no", False), ("1", True),
                                          (None, True)])
def test_the_switch(monkeypatch, value, static):
    if value is None:
        monkeypatch.delenv("KEYSTONE_TORCH_STATIC_NODE_OPT", raising=False)
    else:
        monkeypatch.setenv("KEYSTONE_TORCH_STATIC_NODE_OPT", value)
    assert NodeOptimizationRule().static_shapes is static
    assert NodeOptimizationRule(static_shapes=not static).static_shapes \
        is (not static)


def test_sparse_set_falls_back_to_sampling_like_jax(mesh8):
    from keystone_tpu.nodes.util.sparse import SparseVector as JSparse
    from keystone_tpu.parallel.dataset import ArrayDataset as JArray
    from keystone_tpu.parallel.dataset import HostDataset as JHost
    from keystone_tpu_torch.nodes.util.sparse import SparseVector
    from keystone_tpu_torch.parallel.dataset import ArrayDataset, HostDataset

    rng = np.random.RandomState(0)
    n, d = 200, 2000
    rows = [np.sort(rng.choice(d, 20, replace=False)) for _ in range(n)]
    vals = [rng.randn(20).astype(np.float32) for _ in range(n)]
    Y = rng.randn(n, 3).astype(np.float32)
    port = tls.LeastSquaresEstimator(lam=0.5, **EC2).with_data(
        HostDataset([SparseVector(i, v, d) for i, v in zip(rows, vals)]),
        ArrayDataset.from_numpy(Y, "cpu"))
    ref = jls.LeastSquaresEstimator(lam=0.5, **EC2).with_data(
        JHost([JSparse(i, v, d) for i, v in zip(rows, vals)]),
        JArray.from_numpy(Y))
    tr, jtr = _run_rules(port.graph, ref.graph)
    assert _choices(tr) == _choices(jtr)
    assert _choices(tr)[0][1:3] == ("SparseLBFGSwithL2", ["Sparsify"])
    assert _choices(tr)[0][-1] == "sampled"
    data = DatasetSpec(SparseSpec(d), n=n, host=True, sparsity=None)
    labels = DatasetSpec(ShapeDtype((3,), torch.float32), n=n)
    assert tls.LeastSquaresEstimator().optimize_static(
        data, n, 1, labels_spec=labels) is None


def _voc_pipes(n=6, size=(40, 48)):
    """VOC's featurization at small widths in both packages: SIFT, a
    column sample, the column PCA; a column sample, the GMM Fisher
    vector."""
    from keystone_tpu.nodes.images.core import GrayScaler as JGray
    from keystone_tpu.nodes.images.core import PixelScaler as JPixel
    from keystone_tpu.nodes.images.extractors import SIFTExtractor as JSift
    from keystone_tpu.nodes.images.fisher_vector import (
        GMMFisherVectorEstimator as JGmm,
    )
    from keystone_tpu.nodes.learning.pca import ColumnPCAEstimator as JPca
    from keystone_tpu.nodes.stats.sampling import ColumnSampler as JCols
    from keystone_tpu.parallel.dataset import HostDataset as JHost
    from keystone_tpu.workflow.common import Cacher as JCacher
    from keystone_tpu_torch.nodes.images.core import GrayScaler, PixelScaler
    from keystone_tpu_torch.nodes.images.extractors import SIFTExtractor
    from keystone_tpu_torch.nodes.images.fisher_vector import (
        GMMFisherVectorEstimator,
    )
    from keystone_tpu_torch.nodes.learning.pca import ColumnPCAEstimator
    from keystone_tpu_torch.nodes.stats.sampling import ColumnSampler
    from keystone_tpu_torch.parallel.dataset import HostDataset
    from keystone_tpu_torch.workflow.common import Cacher

    rng = np.random.RandomState(7)
    imgs = [(rng.rand(*size, 3) * 255).astype(np.float32) for _ in range(n)]

    def build(Pixel, Gray, C, Sift, Cols, Pca, Gmm, data):
        sift = Pixel() >> Gray() >> C() >> Sift(scale_step=1)
        pca_sample = (sift >> Cols(16))(data)
        pca = sift.and_then(Pca(8, **EC2).with_data(pca_sample)) >> C()
        gmm_sample = (pca >> Cols(16))(data)
        return pca.and_then(Gmm(4).with_data(gmm_sample))

    port = build(PixelScaler, GrayScaler, Cacher, SIFTExtractor,
                 ColumnSampler, ColumnPCAEstimator, GMMFisherVectorEstimator,
                 HostDataset([torch.as_tensor(i) for i in imgs]))
    ref = build(JPixel, JGray, JCacher, JSift, JCols, JPca, JGmm,
                JHost(imgs))
    return port, ref


def test_voc_pca_and_gmm_choices_are_static_like_jax(mesh8):
    port, ref = _voc_pipes()
    tr, jtr = _run_rules(port.graph, ref.graph)
    assert _choices(tr) == _choices(jtr)
    # the PCA node twice (the GMM's sample graph holds its own copy until
    # CSE merges them), then the GMM
    assert [(c[0], c[-1]) for c in _choices(tr)] == [
        ("ColumnPCAEstimator", "static"), ("ColumnPCAEstimator", "static"),
        ("GMMFisherVectorEstimator", "static")]


def test_voc_sampled_paths_agree_with_both_switches_off(mesh8):
    port, ref = _voc_pipes()
    tr, jtr = _run_rules(port.graph, ref.graph, static_shapes=False)
    assert _choices(tr) == _choices(jtr)
    assert [c[-1] for c in _choices(tr)] == ["sampled"] * 3


def test_streamed_input_like_jax(mesh8):
    from keystone_tpu.parallel import streaming as jstreaming
    from keystone_tpu.parallel.dataset import ArrayDataset as JArray
    from keystone_tpu_torch.parallel.dataset import ArrayDataset
    from keystone_tpu_torch.parallel.streaming import StreamingDataset

    rng = np.random.RandomState(0)
    X = rng.randn(96, 6).astype(np.float32)
    Y = rng.randn(96, 2).astype(np.float32)
    # n known: the static choice, restricted to the one-pass solvers
    port = tls.LeastSquaresEstimator(lam=0.1, **EC2).with_data(
        StreamingDataset.from_numpy(X, 32, device="cpu"),
        ArrayDataset.from_numpy(Y, "cpu"))
    ref = jls.LeastSquaresEstimator(lam=0.1, **EC2).with_data(
        jstreaming.StreamingDataset.from_numpy(X, 32), JArray.from_numpy(Y))
    tr, jtr = _run_rules(port.graph, ref.graph)
    assert _choices(tr) == _choices(jtr)
    assert _decisions(tr) == _decisions(jtr)
    assert _choices(tr)[0][-1] == "static" and _decisions(tr)[0][-1]

    # n unknown: left in place for finalize, as the JAX rule leaves it
    def chunks():
        for i in range(0, 96, 32):
            yield X[i:i + 32]

    def jchunks():
        for i in range(0, 96, 32):
            yield X[i:i + 32]

    port = tls.LeastSquaresEstimator(lam=0.1, **EC2).with_data(
        StreamingDataset.from_chunks(chunks, 32, device="cpu"),
        ArrayDataset.from_numpy(Y, "cpu"))
    ref = jls.LeastSquaresEstimator(lam=0.1, **EC2).with_data(
        jstreaming.StreamingDataset.from_chunks(jchunks, 32),
        JArray.from_numpy(Y))
    tr, jtr = _run_rules(port.graph, ref.graph)
    assert _choices(tr) == _choices(jtr) == []


def test_static_fit_predicts_like_the_sampled_one():
    from keystone_tpu_torch.parallel.dataset import ArrayDataset
    from keystone_tpu_torch.workflow.transformer import transformer

    rng = np.random.RandomState(0)
    X = rng.randn(64, 6).astype(np.float32)
    Y = (X @ rng.randn(6, 3)).astype(np.float32)
    pipe = transformer(lambda x: x * 1.0).and_then(
        tls.LeastSquaresEstimator(lam=1e-3, **EC2),
        ArrayDataset.from_numpy(X, "cpu"), ArrayDataset.from_numpy(Y, "cpu"))
    with PipelineTrace("static") as tr:
        preds = pipe(ArrayDataset.from_numpy(X, "cpu")).get().numpy()
    assert tr.node_choices[0]["provenance"] == "static"
    assert tr.solver_decisions[0]["shape_source"] == "static"
    np.testing.assert_allclose(preds, Y, atol=2e-2)


def test_unknown_propagates_silently():
    report = _t(lambda x: x + 1, "a").check(
        DatasetSpec(Unknown("raw text"), n=None, host=True))
    assert report.ok
    (node,) = report.analysis.graph.nodes
    assert isinstance(report.analysis.value(node).element, Unknown)


def test_the_cifar_bench_shape_chooses_as_jax_does():
    # phase 4e's resident fit on the card: (20480, 8192, 10), dense
    # storage, one machine, the EC2 weights
    from keystone_tpu.analysis.spec import DatasetSpec as JSpec

    port = tls.LeastSquaresEstimator(lam=10.0, **EC2).optimize_static(
        DatasetSpec(ShapeDtype((8192,), torch.float32), n=20480,
                    sparsity=1.0), 20480, 1,
        labels_spec=DatasetSpec(ShapeDtype((10,), torch.float32), n=20480))
    ref = jls.LeastSquaresEstimator(lam=10.0, **EC2).optimize_static(
        JSpec(jax.ShapeDtypeStruct((8192,), np.float32), n=20480,
              sparsity=1.0), 20480, 1,
        labels_spec=JSpec(jax.ShapeDtypeStruct((10,), np.float32),
                          n=20480))
    assert type(port.node).__name__ == type(ref.node).__name__ == \
        "BlockLeastSquaresEstimator"
    assert (port.node.block_size, port.node.num_iter) == \
        (ref.node.block_size, ref.node.num_iter) == (1000, 3)
    assert [type(t).__name__ for t in port.prefix] == \
        [type(t).__name__ for t in ref.prefix] == ["Densify"]


def _imagenet_pipes(n=3, size=(64, 80)):
    """ImageNet's two PCA / GMM branches at small widths in both
    packages, through each package's ``compute_pca_fisher_branch``."""
    from keystone_tpu.nodes.images.core import GrayScaler as JGray
    from keystone_tpu.nodes.images.core import PixelScaler as JPixel
    from keystone_tpu.nodes.images.extractors import LCSExtractor as JLcs
    from keystone_tpu.nodes.images.extractors import SIFTExtractor as JSift
    from keystone_tpu.nodes.stats import BatchSignedHellingerMapper as JHell
    from keystone_tpu.parallel.dataset import HostDataset as JHost
    from keystone_tpu.pipelines.images.imagenet import sift_lcs_fv as jinet
    from keystone_tpu.workflow.pipeline import Pipeline as JPipeline
    from keystone_tpu_torch.nodes.images.core import GrayScaler, PixelScaler
    from keystone_tpu_torch.nodes.images.extractors import (
        LCSExtractor,
        SIFTExtractor,
    )
    from keystone_tpu_torch.nodes.stats import BatchSignedHellingerMapper
    from keystone_tpu_torch.parallel.dataset import HostDataset
    from keystone_tpu_torch.pipelines.images.imagenet import (
        sift_lcs_fv as tinet,
    )
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    rng = np.random.RandomState(11)
    imgs = [(rng.rand(*size, 3) * 255).astype(np.float32) for _ in range(n)]

    def build(mod, Pl, Pixel, Gray, Sift, Hell, Lcs, data):
        cfg = mod.ImageNetSiftLcsFVConfig(desc_dim=8, vocab_size=4)
        sift = Pixel() >> Gray() >> Sift(scale_step=1) >> Hell()
        lcs = Pl.identity() >> Lcs(cfg.lcs_stride, cfg.lcs_border,
                                   cfg.lcs_patch)
        return Pl.gather([mod.compute_pca_fisher_branch(p, data, cfg, 16, 16)
                          for p in (sift, lcs)])

    port = build(tinet, Pipeline, PixelScaler, GrayScaler, SIFTExtractor,
                 BatchSignedHellingerMapper, LCSExtractor,
                 HostDataset([torch.as_tensor(i) for i in imgs]))
    ref = build(jinet, JPipeline, JPixel, JGray, JSift, JHell, JLcs,
                JHost(imgs))
    return port, ref


def test_imagenet_pca_and_gmm_choices_are_static_like_jax(mesh8):
    port, ref = _imagenet_pipes()
    tr, jtr = _run_rules(port.graph, ref.graph)
    # the branch builder gives each package's ColumnPCAEstimator its own
    # default weights (the port's the reference's EC2 ones, the JAX
    # package's its calibration), so the PCA picks may differ; what the
    # rule resolved, from which shapes, must not
    assert [(c[0], c[2], c[3], c[4]) for c in _choices(tr)] == \
        [(c[0], c[2], c[3], c[4]) for c in _choices(jtr)]
    assert [c[1] for c in _choices(tr) if c[0] != "ColumnPCAEstimator"] == \
        [c[1] for c in _choices(jtr) if c[0] != "ColumnPCAEstimator"]
    assert {c[-1] for c in _choices(tr)} == {"static"}
    assert {c[0] for c in _choices(tr)} == {"ColumnPCAEstimator",
                                            "GMMFisherVectorEstimator"}


def test_check_replicas_places_the_apps_as_jax_does(tmp_path, capsys):
    from keystone_tpu import __main__ as jmain
    from keystone_tpu_torch import __main__ as tmain

    # 20 GiB: every app's fit peak fits under both packages' plans (the
    # port's holds the executor memo, C19), so the exit code is the
    # placement's
    argv = ["check", "--all", "--budget", "20GiB", "--replicas", "2",
            "--json"]
    assert tmain.main(argv + [str(tmp_path / "t.json")]) == 0
    assert jmain.main(argv + [str(tmp_path / "j.json")]) == 0
    port = json.loads((tmp_path / "t.json").read_text())["fleet_placement"]
    ref = json.loads((tmp_path / "j.json").read_text())["fleet_placement"]
    assert port == ref and len(port["assignments"]) == 9
    assert tmain.main(["check", "--all", "--replicas", "2"]) == \
        jmain.main(["check", "--all", "--replicas", "2"]) == 2
