"""The cost-model solver choice: the port against ``keystone_tpu``.

Cost models, the least-squares and column-PCA choices, the calibration
loader, the node-level rule's splices, L-BFGS (dense and sparse) and the
streamed least-squares fit, on the same seeded numpy inputs in both
packages. Both rules run their sampled paths here
(``static_shapes=False`` and both packages' switches set to 0; the
static defaults are held in ``test_torch_static_analysis.py``); both
sides get the reference's EC2 weights and one machine explicitly (the
JAX package's defaults are its own calibration and its test mesh has
eight devices).

Tolerances: cost values 1e-12 relative (the same float64 formulas);
L-BFGS weights and objectives 1e-4 relative and iteration counts within
one (two float32 summation orders can move the relative-improvement stop
by one iteration); the streamed fit's weights 1e-5 of the largest;
predictions through a splice agree on >= 0.99 of items and scores
within 1e-4 of the largest.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.nodes.learning import lbfgs as jlbfgs
from keystone_tpu.nodes.learning import least_squares as jls
from keystone_tpu.nodes.learning import linear as jlinear
from keystone_tpu.nodes.learning import pca as jpca
from keystone_tpu.nodes.util.sparse import SparseVector as JSparseVector
from keystone_tpu.ops.lbfgs import lbfgs as jax_lbfgs
from keystone_tpu.parallel import streaming as jstreaming
from keystone_tpu.parallel.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.parallel.dataset import HostDataset as JHostDataset
from keystone_tpu.workflow.optimizer.node_rule import (
    NodeOptimizationRule as JRule,
)
from keystone_tpu.workflow.transformer import transformer as jtransformer
from keystone_tpu_torch import convert
from keystone_tpu_torch.nodes.learning import lbfgs as tlbfgs
from keystone_tpu_torch.nodes.learning import least_squares as tls
from keystone_tpu_torch.nodes.learning import linear as tlinear
from keystone_tpu_torch.nodes.learning import pca as tpca
from keystone_tpu_torch.nodes.util import Densify
from keystone_tpu_torch.nodes.util import sparse as tsparse
from keystone_tpu_torch.nodes.util.sparse import (
    CSRMatrix,
    Sparsify,
    sparse_batch,
)
from keystone_tpu_torch.ops.lbfgs import lbfgs as port_lbfgs
from keystone_tpu_torch.parallel.dataset import ArrayDataset, HostDataset
from keystone_tpu_torch.parallel.streaming import StreamingDataset
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.optimizer.default import DefaultOptimizer
from keystone_tpu_torch.workflow.optimizer.rules import (
    EquivalentNodeMergeRule,
)
from keystone_tpu_torch.workflow.optimizer.node_rule import (
    NodeOptimizationRule,
    _sample_dataset,
    _SampledValues,
)
from keystone_tpu_torch.workflow.transformer import Transformer, transformer

EC2 = jls.REFERENCE_EC2_WEIGHTS
#: the JAX package's shipped (device-calibrated) weights, with a latency
#: term: a second weight surface for the cost grid
JAX_SHIPPED = {"cpu_weight": jls.DEFAULT_CPU_WEIGHT,
               "mem_weight": jls.DEFAULT_MEM_WEIGHT,
               "network_weight": jls.DEFAULT_NETWORK_WEIGHT,
               "lat_weight": jls.DEFAULT_LAT_WEIGHT}

#: (n, d, k, density) -> the solver the EC2 surface picks on one machine
CHOICE_TABLE = [
    ((20480, 8192, 10, 1.0), "BlockLeastSquaresEstimator"),
    ((20480, 8192, 10, 0.01), "SparseLBFGSwithL2"),
    ((20480, 1024, 10, 1.0), "LinearMapEstimator"),
    ((50000, 1024, 10, 1.0), "LinearMapEstimator"),
    ((65536, 256, 10, 1.0), "LinearMapEstimator"),
    ((16384, 102400, 10, 1.0), "BlockLeastSquaresEstimator"),
]
COST_SHAPES = [shape for shape, _ in CHOICE_TABLE] + [
    (1_000_000, 1000, 1000, 1.0), (1_000_000, 10_000, 2, 0.01),
    (100, 4, 2, 0.5), (512, 1953, 80, 1.0)]


@pytest.fixture(autouse=True)
def _port_env(monkeypatch):
    # both rules' static paths off: this file holds the sampled paths
    # against each other (tests/test_torch_static_analysis.py holds the
    # static defaults)
    monkeypatch.setenv("KEYSTONE_STATIC_NODE_OPT", "0")
    monkeypatch.setenv("KEYSTONE_TORCH_STATIC_NODE_OPT", "0")
    PipelineEnv.reset()
    tls.clear_calibration_cache()
    yield
    PipelineEnv.reset()
    tls.clear_calibration_cache()


def _solvers(pkg_lbfgs, pkg_linear, pkg_pca):
    return {
        "DenseLBFGS": pkg_lbfgs.DenseLBFGSwithL2(num_iterations=20),
        "SparseLBFGS": pkg_lbfgs.SparseLBFGSwithL2(num_iterations=20),
        "BlockLS": pkg_linear.BlockLeastSquaresEstimator(1000, 3),
        "Exact": pkg_linear.LinearMapEstimator(),
        "PCA": pkg_pca.PCAEstimator(80),
        "DistributedPCA": pkg_pca.DistributedPCAEstimator(80),
    }


@pytest.mark.parametrize("machines", [1, 16])
@pytest.mark.parametrize("weights", ["ec2", "jax_shipped"])
@pytest.mark.parametrize("solver", ["DenseLBFGS", "SparseLBFGS", "BlockLS",
                                    "Exact", "PCA", "DistributedPCA"])
def test_cost_models_match_jax(solver, weights, machines):
    w = EC2 if weights == "ec2" else JAX_SHIPPED
    args = (w["cpu_weight"], w["mem_weight"], w["network_weight"])
    port = _solvers(tlbfgs, tlinear, tpca)[solver]
    ref = _solvers(jlbfgs, jlinear, jpca)[solver]
    for n, d, k, density in COST_SHAPES:
        got = port.cost(n, d, k, density, machines, *args,
                        lat_w=w["lat_weight"])
        want = ref.cost(n, d, k, density, machines, *args,
                        lat_w=w["lat_weight"])
        assert got == pytest.approx(want, rel=1e-12, abs=0), (n, d, k)


@pytest.mark.parametrize("shape,chosen", CHOICE_TABLE)
def test_least_squares_choice_matches_jax(shape, chosen):
    n, d, k, density = shape
    port = tls.LeastSquaresEstimator(lam=1.0, **EC2)._choose(
        n, d, k, density, 1)
    ref = jls.LeastSquaresEstimator(lam=1.0, **EC2)._choose(
        n, d, k, density, 1, "sampled")
    assert type(port.node).__name__ == type(ref.node).__name__ == chosen
    assert [type(t).__name__ for t in port.prefix] == \
        [type(t).__name__ for t in ref.prefix]
    # the streamed surface keeps the Gram-capable solvers only
    port_s = tls.LeastSquaresEstimator(lam=1.0, **EC2)._choose(
        n, d, k, 1.0, 1, streaming=True)
    ref_s = jls.LeastSquaresEstimator(lam=1.0, **EC2)._choose(
        n, d, k, 1.0, 1, "streamed", streaming=True)
    assert type(port_s.node).__name__ == type(ref_s.node).__name__


def test_port_default_weights_are_the_reference_ec2_ones():
    est = tls.LeastSquaresEstimator()
    assert {k: getattr(est, k) for k in EC2} == EC2
    pca = tpca.ColumnPCAEstimator(80)
    assert {k: getattr(pca, k) for k in EC2} == EC2


@pytest.mark.parametrize("d,cols,n,machines", [
    (128, 1953, 512, 1),      # VOCSIFTFisher's PCA sample
    (8, 50, 12, 1), (16, 4, 3, 8), (64, 10, 1000, 16), (1000, 2, 5, 1)])
def test_column_pca_choice_matches_jax(d, cols, n, machines):
    port = tpca.ColumnPCAEstimator(8)._choose(d, cols, n, machines)
    ref = jpca.ColumnPCAEstimator(8, **EC2)._choose(d, cols, n, machines)
    assert type(port.node).__name__ == type(ref.node).__name__
    if (d, cols, n) == (128, 1953, 512):
        assert isinstance(port.node, tpca.DistributedColumnPCAEstimator)


def test_column_pca_optimize_reads_the_sample_geometry():
    rng = np.random.RandomState(0)
    items = [rng.rand(16, 40).astype(np.float32) for _ in range(3)]
    port = tpca.ColumnPCAEstimator(4).optimize(
        HostDataset([torch.as_tensor(m) for m in items]), n=3,
        num_machines=1)
    ref = jpca.ColumnPCAEstimator(4, **EC2).optimize(
        JHostDataset(items), n=3, num_machines=1)
    assert type(port.node).__name__ == type(ref.node).__name__


@pytest.mark.parametrize("case", ["valid", "out_of_range", "low_agreement",
                                  "missing"])
def test_load_calibration_matches_jax(tmp_path, case):
    blob = {"cpu_weight": 1e-14, "mem_weight": 2e-11,
            "network_weight": 3e-11, "lat_weight": 1e-4,
            "timestamp": "2026-10-17T00:00:00", "hostname": "h",
            "device": "d"}
    if case == "out_of_range":
        blob["cpu_weight"] = -1.0
    if case == "low_agreement":
        blob["agreement"] = "1/3"
    path = tmp_path / "calibration.json"
    if case != "missing":
        path.write_text(json.dumps(blob))
    jls.clear_calibration_cache()
    tw, tp = tls.load_calibration(str(path))
    jw, jp = jls.load_calibration(str(path))
    assert tp["source"] == jp["source"]
    if case == "valid":
        assert tp["source"] == "artifact"
        assert tw == jw == {k: blob[k] for k in EC2}
        assert {k: tp[k] for k in ("timestamp", "hostname", "device")} == \
            {k: jp[k] for k in ("timestamp", "hostname", "device")}
    else:
        # each package falls back to its own shipped weights: the port's
        # are the reference's EC2 ones
        assert tp["source"] == "shipped_defaults"
        assert tw == EC2
        assert ("note" in tp) == ("note" in jp)


def test_calibration_path_is_the_ports_own(monkeypatch):
    monkeypatch.delenv(tls.CALIBRATION_ENV, raising=False)
    assert tls.CALIBRATION_ENV != jls.CALIBRATION_ENV
    assert tls.DEFAULT_CALIBRATION_PATH != jls.DEFAULT_CALIBRATION_PATH
    assert "keystone_tpu_torch" in tls.DEFAULT_CALIBRATION_PATH


# -- the node-level rule ------------------------------------------------------

def _sparse_rows(n, d, nnz, seed):
    rng = np.random.RandomState(seed)
    X = np.zeros((n, d), np.float32)
    for i in range(n):
        X[i, rng.choice(d, nnz, replace=False)] = rng.randn(nnz)
    return X


def _problem(kind, seed=0):
    """(train X, train Y, test X, lam, chosen solver) for the three
    splices."""
    rng = np.random.RandomState(seed)
    if kind == "sparse":
        n, d = 240, 2000
        X, Xt = _sparse_rows(n, d, 20, seed), _sparse_rows(12, d, 20, seed + 1)
        chosen = "SparseLBFGSwithL2"
        lam = 0.5
    else:
        # n = d for the block solver: lam = 50 keeps its f32 solve
        # well conditioned
        n, d, lam = (400, 8, 0.5) if kind == "exact" else (1000, 1000, 50.0)
        X = rng.randn(n, d).astype(np.float32)
        Xt = rng.randn(12, d).astype(np.float32)
        chosen = ("LinearMapEstimator" if kind == "exact"
                  else "BlockLeastSquaresEstimator")
    W = rng.randn(d, 3).astype(np.float32)
    Y = (X @ W + 0.1 * rng.randn(n, 3)).astype(np.float32)
    return X, Y, Xt, lam, chosen


def _spliced(graph):
    return sorted(type(graph.get_operator(n)).__name__ for n in graph.nodes
                  if type(graph.get_operator(n)).__name__ not in (
                      "DatasetOperator", "LambdaTransformer"))


def _scale(x):
    return x * 1.0


@pytest.mark.parametrize("kind", ["exact", "block", "sparse"])
def test_node_rule_splices_like_jax(mesh8, kind):
    X, Y, Xt, lam, chosen = _problem(kind)
    if kind == "sparse":
        sp = Sparsify()
        port_train = HostDataset([sp.apply(x) for x in X])
        jax_train = JHostDataset([JSparseVector(np.nonzero(x)[0],
                                                x[np.nonzero(x)[0]], x.size)
                                  for x in X])
        port_head = jax_head = None
    else:
        port_train = ArrayDataset.from_numpy(X, "cpu")
        jax_train = JArrayDataset.from_numpy(X)
        port_head, jax_head = transformer(_scale), jtransformer(_scale)
    port_est = tls.LeastSquaresEstimator(lam=lam, num_machines=1, **EC2)
    jax_est = jls.LeastSquaresEstimator(lam=lam, num_machines=1, **EC2)
    port_y = ArrayDataset.from_numpy(Y, "cpu")
    jax_y = JArrayDataset.from_numpy(Y)
    if port_head is None:
        port_pipe = port_est.with_data(port_train, port_y)
        jax_pipe = jax_est.with_data(jax_train, jax_y)
    else:
        port_pipe = port_head.and_then(port_est, port_train, port_y)
        jax_pipe = jax_head.and_then(jax_est, jax_train, jax_y)

    port_graph = NodeOptimizationRule().apply(port_pipe.graph)
    jax_graph = JRule(static_shapes=False).apply(jax_pipe.graph)
    assert _spliced(port_graph) == _spliced(jax_graph)
    assert chosen in _spliced(port_graph)
    prefix = "Sparsify" if kind == "sparse" else "Densify"
    # the prefix on the fit path and on the runtime path
    assert _spliced(port_graph).count(prefix) == 2

    # the DefaultOptimizer runs the rule, then CSE, inside fit()
    port_fit = port_pipe.fit()
    jax_fit = jax_pipe.fit()
    names = _spliced(port_fit._graph)
    assert names == _spliced(jax_fit._graph)
    if kind == "sparse":
        port_test = HostDataset([Sparsify().apply(x) for x in Xt])
        jax_test = JHostDataset([JSparseVector(np.nonzero(x)[0],
                                               x[np.nonzero(x)[0]], x.size)
                                 for x in Xt])
        datum, jdatum = port_test.items[0], jax_test.items[0]
    else:
        port_test = ArrayDataset.from_numpy(Xt, "cpu")
        jax_test = JArrayDataset.from_numpy(Xt)
        datum, jdatum = torch.as_tensor(Xt[0]), jnp.asarray(Xt[0])
    got = port_fit.apply(port_test).get().numpy()
    want = np.asarray(jax_fit.apply(jax_test).get().numpy())
    assert got.shape == want.shape == (12, 3)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    one = port_fit.apply_datum(datum).get()
    np.testing.assert_allclose(np.asarray(one), got[0], rtol=1e-5,
                               atol=1e-5 * np.abs(got).max())
    jone = np.asarray(jax_fit.apply_datum(jdatum).get())
    assert np.abs(np.asarray(one) - jone).max() <= 1e-4 * np.abs(jone).max()


def test_node_rule_leaves_a_streamed_node_in_place(mesh8):
    rng = np.random.RandomState(0)
    X = rng.randn(96, 6).astype(np.float32)
    Y = rng.randn(96, 2).astype(np.float32)
    port_pipe = tls.LeastSquaresEstimator(lam=0.1, **EC2).with_data(
        StreamingDataset.from_numpy(X, 32, device="cpu"),
        ArrayDataset.from_numpy(Y, "cpu"))
    jax_pipe = jls.LeastSquaresEstimator(lam=0.1, **EC2).with_data(
        jstreaming.StreamingDataset.from_numpy(X, 32),
        JArrayDataset.from_numpy(Y))
    port_graph = NodeOptimizationRule().apply(port_pipe.graph)
    jax_graph = JRule(static_shapes=False).apply(jax_pipe.graph)
    assert port_graph is port_pipe.graph
    assert _spliced(port_graph) == _spliced(jax_graph) == [
        "DelegatingOperator", "LeastSquaresEstimator"]


def test_sample_dataset_is_evenly_spread_and_bounded():
    X = np.arange(300, dtype=np.float32).reshape(100, 3)
    got = _sample_dataset(ArrayDataset.from_numpy(X, "cpu"), 10)
    idx = np.unique(np.linspace(0, 99, 10).astype(np.int64))
    np.testing.assert_array_equal(got.numpy(), X[idx])
    host = _sample_dataset(HostDataset(list(range(100))), 10)
    assert host.collect() == list(idx)
    # a stream is sampled from its first chunk only
    stream = StreamingDataset.from_numpy(X, 40, device="cpu")
    first = _sample_dataset(stream, 10)
    np.testing.assert_array_equal(
        first.numpy(), X[np.unique(np.linspace(0, 39, 10).astype(np.int64))])


def test_sampled_execution_runs_the_prefix_on_the_sample():
    X = np.random.RandomState(0).randn(500, 4).astype(np.float32)
    pipe = transformer(_scale).and_then(
        tls.LeastSquaresEstimator(**EC2), ArrayDataset.from_numpy(X, "cpu"),
        ArrayDataset.from_numpy(X[:, :2], "cpu"))
    graph = pipe.graph
    est = next(n for n in graph.nodes if isinstance(
        graph.get_operator(n), tls.LeastSquaresEstimator))
    (sample, labels), n = NodeOptimizationRule._execute_sampled(
        graph, graph.get_dependencies(est)[:2], _SampledValues(50))
    assert n == 500 and sample.n == labels.n == 50


class _RowCounter(Transformer):
    """x * 1.0, recording the row count of every batch it transforms."""

    batches: list = []

    def apply(self, x):
        return x * 1.0

    def apply_batch(self, X):
        _RowCounter.batches.append(X.shape[0])
        return X * 1.0


def test_one_rule_application_samples_a_shared_prefix_once():
    rng = np.random.RandomState(0)
    X = ArrayDataset.from_numpy(rng.randn(500, 4).astype(np.float32), "cpu")
    Y = ArrayDataset.from_numpy(rng.randn(500, 2).astype(np.float32), "cpu")
    # two optimizable nodes downstream of one prefix on the same data
    pipe = _RowCounter().and_then(
        tls.LeastSquaresEstimator(lam=0.1, **EC2), X, Y).and_then(
        tls.LeastSquaresEstimator(lam=0.2, **EC2), X, Y)
    PipelineEnv.reset()
    _RowCounter.batches.clear()
    graph = DefaultOptimizer().execute(pipe.graph)
    assert _spliced(graph).count("LinearMapEstimator") == 2
    # the prefix ran once, on the sample; the second node reused it
    assert _RowCounter.batches == [96]
    # values keyed by a sampled dataset never enter the prefix memo
    assert PipelineEnv.get_or_create().state == {}


@pytest.mark.parametrize("optimizable", [False, True])
def test_post_splice_cse_runs_only_after_a_splice(monkeypatch, optimizable):
    rng = np.random.RandomState(1)
    X = ArrayDataset.from_numpy(rng.randn(200, 4).astype(np.float32), "cpu")
    Y = ArrayDataset.from_numpy(rng.randn(200, 2).astype(np.float32), "cpu")
    est = (tls.LeastSquaresEstimator(lam=0.1, **EC2) if optimizable
           else tlinear.LinearMapEstimator(lam=0.1))
    pipe = transformer(_scale).and_then(est, X, Y)
    passes = []

    def counted(cls):
        real = cls.apply

        def run(rule, graph):
            passes.append(cls.__name__)
            return real(rule, graph)
        monkeypatch.setattr(cls, "apply", run)

    counted(EquivalentNodeMergeRule)
    counted(NodeOptimizationRule)
    DefaultOptimizer().execute(pipe.graph)
    rule_at = passes.index("NodeOptimizationRule")
    assert rule_at >= 1 and set(passes[:rule_at]) == {
        "EquivalentNodeMergeRule"}
    # the second CSE batch merges the splice's prefixes, and runs no pass
    # over a graph the node rule left as it was
    assert (len(passes) > rule_at + 1) is optimizable


def test_default_optimizer_order_matches_jax():
    from keystone_tpu.workflow.optimizer.default import (
        DefaultOptimizer as JDefault,
    )
    from keystone_tpu_torch.workflow.optimizer.default import (
        DefaultOptimizer,
    )

    port = [b.name for b in DefaultOptimizer().batches]
    ref = [b.name for b in JDefault().batches]
    # the JAX package's batches, in its order
    assert port == ref


# -- L-BFGS ----------------------------------------------------------------

def _quadratic(n=200, d=30, k=3, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    Y = (X @ rng.randn(d, k) + 0.1 * rng.randn(n, k)).astype(np.float32)
    return X, Y


@pytest.mark.parametrize("lam", [0.0, 0.1])
def test_lbfgs_minimizer_matches_jax(lam):
    X, Y = _quadratic()
    n = X.shape[0]

    def vg_port(W):
        R = torch.as_tensor(X) @ W - torch.as_tensor(Y)
        return (0.5 * torch.sum(R * R) / n + 0.5 * lam * torch.sum(W * W),
                torch.as_tensor(X).T @ R / n + lam * W)

    def vg_jax(W):
        R = jnp.asarray(X) @ W - jnp.asarray(Y)
        return (0.5 * jnp.sum(R * R) / n + 0.5 * lam * jnp.sum(W * W),
                jnp.asarray(X).T @ R / n + lam * W)

    got = port_lbfgs(vg_port, torch.zeros((30, 3)), max_iters=50)
    want = jax_lbfgs(vg_jax, jnp.zeros((30, 3), jnp.float32), max_iters=50)
    assert abs(got.num_iters - int(want.num_iters)) <= 1
    assert got.f == pytest.approx(float(want.f), rel=1e-4)
    W = np.asarray(want.x)
    assert np.abs(got.x.numpy() - W).max() <= 1e-4 * np.abs(W).max()
    assert got.evaluations >= got.num_iters + 1


def _objective(X, Y, W, b, lam):
    """The least-squares objective in float64, b unpenalized."""
    X, Y, W = (np.asarray(a, np.float64) for a in (X, Y, W))
    R = X @ W + (0.0 if b is None else np.asarray(b, np.float64)) - Y
    return 0.5 * (R * R).sum() / len(X) + 0.5 * lam * (W * W).sum()


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("lam", [0.0, 0.1])
def test_dense_lbfgs_matches_jax(mesh8, lam, fit_intercept):
    X, Y = _quadratic(seed=1)
    kw = dict(lam=lam, num_iterations=20, fit_intercept=fit_intercept)
    port = tlbfgs.DenseLBFGSwithL2(**kw).fit(
        ArrayDataset.from_numpy(X, "cpu"), ArrayDataset.from_numpy(Y, "cpu"))
    ref = jlbfgs.DenseLBFGSwithL2(**kw).fit(
        JArrayDataset.from_numpy(X), JArrayDataset.from_numpy(Y))
    W = np.asarray(ref.weights)
    assert np.abs(port.weights.numpy() - W).max() <= 1e-4 * np.abs(W).max()
    if fit_intercept:
        np.testing.assert_allclose(port.intercept.numpy(),
                                   np.asarray(ref.intercept), rtol=1e-5)
    Xc = X - X.mean(0) if fit_intercept else X
    Yc = Y - Y.mean(0) if fit_intercept else Y
    floor = 1e-7 * _objective(Xc, Yc, np.zeros_like(W), None, lam)
    assert _objective(Xc, Yc, port.weights, None, lam) == \
        pytest.approx(_objective(Xc, Yc, W, None, lam), rel=1e-4,
                      abs=floor)
    assert 1 <= port._solve_stats["iterations"] <= 20
    got = port.apply_batch(torch.as_tensor(X[:5])).numpy()
    want = np.asarray(ref.apply_dataset(JArrayDataset.from_numpy(
        X[:5])).numpy())
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def _sparse_items(X):
    port = [Sparsify().apply(x) for x in X]
    ref = [JSparseVector(v.indices, v.values, v.size) for v in port]
    return HostDataset(port), JHostDataset(ref)


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("lam", [0.0, 0.1])
def test_sparse_lbfgs_matches_jax(mesh8, lam, fit_intercept):
    X = _sparse_rows(150, 40, 6, seed=2)
    Y = (X @ np.random.RandomState(3).randn(40, 3) + 0.5).astype(np.float32)
    port_ds, jax_ds = _sparse_items(X)
    kw = dict(lam=lam, num_iterations=30, fit_intercept=fit_intercept)
    port = tlbfgs.SparseLBFGSwithL2(**kw).fit(
        port_ds, ArrayDataset.from_numpy(Y, "cpu"))
    ref = jlbfgs.SparseLBFGSwithL2(**kw).fit(jax_ds,
                                             JArrayDataset.from_numpy(Y))
    W = np.asarray(ref.weights)
    assert np.abs(port.weights.numpy() - W).max() <= 1e-4 * np.abs(W).max()
    b_port = None if port.intercept is None else port.intercept.numpy()
    if fit_intercept:
        np.testing.assert_allclose(b_port, ref.intercept, rtol=1e-4,
                                   atol=1e-4 * np.abs(W).max())
    else:
        assert b_port is None and ref.intercept is None
    # a fit at lam = 0 reaches float32 noise: absolutely, 1e-7 of the
    # objective at W = 0
    floor = 1e-7 * _objective(X, Y, np.zeros_like(W), None, lam)
    assert _objective(X, Y, port.weights, b_port, lam) == \
        pytest.approx(_objective(X, Y, W, ref.intercept, lam),
                      rel=1e-4, abs=floor)
    got = port.apply_dataset(port_ds).numpy()
    want = np.asarray(ref.apply_dataset(jax_ds).numpy())
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(port.apply(port_ds.items[0]).numpy(), got[0],
                               rtol=1e-5, atol=1e-6)


def test_sparse_fit_matches_the_dense_fit_on_the_densified_copy():
    X = _sparse_rows(64, 20, 6, seed=3)
    Y = (X @ np.random.RandomState(4).randn(20, 3)).astype(np.float32)
    port_ds, _ = _sparse_items(X)
    kw = dict(lam=0.1, num_iterations=300, fit_intercept=False)
    sparse = tlbfgs.SparseLBFGSwithL2(**kw).fit(
        port_ds, ArrayDataset.from_numpy(Y, "cpu"))
    dense_ds = Densify("cpu").apply_dataset(port_ds)
    np.testing.assert_array_equal(dense_ds.numpy(), X)
    dense = tlbfgs.DenseLBFGSwithL2(**kw).fit(
        dense_ds, ArrayDataset.from_numpy(Y, "cpu"))
    W = dense.weights.numpy()
    assert np.abs(sparse.weights.numpy() - W).max() <= 2e-3 * np.abs(W).max()


def _ridge_cg_float64(indices, values, Y, d, lam):
    """The exact minimizer, in float64, of the sparse solver's objective
    with its unpenalized intercept, 0.5 |X W + b - Y|^2 / n + 0.5 lam
    |W|^2: (Xc^T Xc / n + lam I) W = Xc^T Yc / n by conjugate gradients,
    Xc = X less its column means applied implicitly to a sparse X."""
    import scipy.sparse as sps
    from scipy.sparse.linalg import LinearOperator, cg

    n = len(Y)
    X = sps.csr_matrix((values.ravel().astype(np.float64),
                        (np.repeat(np.arange(n), indices.shape[1]),
                         indices.ravel())), shape=(n, d))
    mu = np.asarray(X.mean(axis=0)).ravel()
    Yc = Y - Y.mean(axis=0)

    def normal(v):
        Xv = X @ v - mu @ v
        return (X.T @ Xv - mu * Xv.sum()) / n + lam * v

    op = LinearOperator((d, d), matvec=normal, dtype=np.float64)
    rhs = (X.T @ Yc - np.outer(mu, Yc.sum(axis=0))) / n
    cols = []
    for j in range(Y.shape[1]):
        w, info = cg(op, rhs[:, j], rtol=1e-13, maxiter=1000)
        assert info == 0
        cols.append(w)
    return np.stack(cols, axis=1)


def test_sparse_lbfgs_stops_where_jax_does_at_heavy_l2(mesh8):
    """The sparse solver at the CIFAR path's L2 weight (lam = 10), on the
    data of chip_smoke.py's sparse phase (20480 x 8192, 82 draws a row,
    +-1 labels of 10 classes, seed 0). The relative-improvement stop ends
    the fit 1.41e-3 of the largest weight from the exact ridge solve in
    the JAX package as in the port: the distance is the algorithm's, and
    the port's fit ends no further away (5% margin)."""
    n, d, nnz, lam = 20480, 8192, 82, 10.0
    rng = np.random.RandomState(0)
    idx = rng.randint(0, d, (n, nnz))
    vals = rng.randn(n, nnz).astype(np.float32)
    W0 = rng.randn(d, 10).astype(np.float32)
    y = np.einsum("rs,rsk->rk", vals, W0[idx]).argmax(axis=1)
    Y = np.where(np.arange(10) == y[:, None], 1.0, -1.0).astype(np.float32)
    port_items = [tsparse.SparseVector(idx[i], vals[i], d) for i in range(n)]
    jax_items = [JSparseVector(v.indices, v.values, d) for v in port_items]
    exact = _ridge_cg_float64(idx, vals, Y.astype(np.float64), d, lam)
    kw = dict(lam=lam, num_iterations=20)
    port = tlbfgs.SparseLBFGSwithL2(**kw).fit(
        HostDataset(port_items), ArrayDataset.from_numpy(Y, "cpu"))
    ref = jlbfgs.SparseLBFGSwithL2(**kw).fit(
        JHostDataset(jax_items), JArrayDataset.from_numpy(Y))

    def dist(W):
        return float(np.abs(np.asarray(W, np.float64) - exact).max()
                     / np.abs(exact).max())

    got, want = dist(port.weights.numpy()), dist(ref.weights)
    print(f"max |W - W_exact| / max |W_exact| at lam = {lam}: port "
          f"{got:.4e} (L-BFGS {port._solve_stats}), JAX package {want:.4e}")
    assert got <= 1.05 * want, (got, want)


def test_csr_products_match_dense_and_repeat_bit_for_bit():
    rng = np.random.RandomState(5)
    X = _sparse_rows(70, 300, 9, seed=5)
    X[:, 7] = rng.randn(70)        # one dense column: a long row of X^T
    X[3] = 0.0                      # an empty row
    indices, values, size = sparse_batch([Sparsify().apply(x) for x in X])
    A = CSRMatrix.from_padded(indices, values, size, "cpu")
    At = A.transpose()
    M = torch.as_tensor(rng.randn(300, 4).astype(np.float32))
    R = torch.as_tensor(rng.randn(70, 4).astype(np.float32))
    np.testing.assert_allclose(A.matmul(M).numpy(), X @ M.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(At.matmul(R).numpy(), X.T @ R.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(At.matmul(R), At.matmul(R))
    assert len(At._levels) >= 2     # the dense column needs a second level


# -- the streamed fit ----------------------------------------------------------

@pytest.mark.parametrize("n,d,lam,chosen", [
    (1024, 24, 0.1, "LinearMapper"),
    (1024, 1500, 100.0, "BlockLinearMapper")])
def test_streamed_least_squares_matches_jax_fit_streaming(mesh8, n, d, lam,
                                                          chosen):
    rng = np.random.RandomState(6)
    X = rng.randn(n, d).astype(np.float32)
    Y = (X @ rng.randn(d, 3) + rng.randn(n, 3)).astype(np.float32)
    port = tls.LeastSquaresEstimator(lam=lam, num_machines=1, **EC2).fit(
        StreamingDataset.from_numpy(X, 256, device="cpu"),
        ArrayDataset.from_numpy(Y, "cpu"))
    ref = jstreaming.fit_streaming(
        jls.LeastSquaresEstimator(lam=lam, num_machines=1, **EC2),
        jstreaming.StreamingDataset.from_numpy(X, 256),
        JArrayDataset.from_numpy(Y))
    assert type(port).__name__ == type(ref).__name__ == chosen
    if chosen == "LinearMapper":
        got, want = port.weights.numpy(), np.asarray(ref.weights)
    else:
        got = port.weights.numpy()
        want = np.concatenate([np.asarray(w) for w in ref.block_weights])
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # the JAX-fitted model carried into the port predicts the same
    carried = convert.solver_model(ref, "cpu")
    out = carried.apply_batch(torch.as_tensor(X[:7])).numpy()
    ours = port.apply_batch(torch.as_tensor(X[:7])).numpy()
    assert np.abs(out - ours).max() <= 1e-4 * np.abs(ours).max()


def test_least_squares_default_fit_is_dense_lbfgs():
    X, Y = _quadratic(seed=7)
    model = tls.LeastSquaresEstimator(lam=0.0, num_iterations=100).fit(
        ArrayDataset.from_numpy(X, "cpu"), ArrayDataset.from_numpy(Y, "cpu"))
    pred = model.apply_batch(torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(pred, Y, atol=0.5)
    assert "iterations" in model._solve_stats


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = _sparse_rows(8, 10, 3, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Densify().apply_dataset(HostDataset([Sparsify().apply(x)
                                             for x in X]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlbfgs.SparseLBFGSwithL2().fit(
            HostDataset([Sparsify().apply(x) for x in X]),
            HostDataset([np.zeros(2, np.float32)] * 8))
