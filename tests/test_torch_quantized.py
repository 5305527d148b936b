"""The quantized predict: the port against ``keystone_tpu``.

Same seeded numpy inputs through both packages:

* ``quantized_affine_plain`` against ``quantized_affine_pallas`` run in
  interpret mode, bf16 and int8, at rtol = atol = 1e-5 (the bar the JAX
  package holds its kernel to against its einsum);
* ``_quantize_weights`` against the JAX one: bit-identical ``Wq`` and
  ``scale``, an all-zero column included;
* the parity gate of ``tests/test_pallas_kernels.py`` on the port (bf16:
  argmax agreement 1.0 and max error <= 2% of the largest score; int8:
  >= 0.98 and <= 3%);
* the ``weight_dtype`` contract, the cached-params invalidation, the
  kernel's split arithmetic, ``bucketed_dataset``, the carry-across of a
  quantized mapper, and that no port module imports JAX.
"""
import os
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.nodes.learning import linear as jlinear
from keystone_tpu.ops.pallas_kernels import quantized_affine_pallas
from keystone_tpu.parallel.dataset import ArrayDataset as JArrayDataset
from keystone_tpu_torch import convert
from keystone_tpu_torch.nodes.learning import linear as tlinear
from keystone_tpu_torch.observability.metrics import MetricsRegistry
from keystone_tpu_torch.ops import kernels
from keystone_tpu_torch.parallel.dataset import ArrayDataset, bucketed_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _affine_inputs(n, d, k, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    W = rng.randn(d, k).astype(np.float32)
    mean = rng.randn(d).astype(np.float32)
    inv = (1.0 + rng.rand(d)).astype(np.float32)
    b = rng.randn(k).astype(np.float32)
    return X, W, mean, inv, b


def _bits(t: torch.Tensor) -> np.ndarray:
    """The raw bits of a bf16 / int8 tensor, comparable with numpy."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jax_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("weight_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("n,d,k", [(77, 50, 11), (5, 300, 10)])
def test_plain_version_matches_the_interpreted_pallas_kernel(
        weight_dtype, n, d, k):
    X, W, mean, inv, b = _affine_inputs(n, d, k, seed=n + d + k)
    Wq, scale = jlinear._quantize_weights(jnp.asarray(W), weight_dtype)
    want = np.asarray(quantized_affine_pallas(
        jnp.asarray(X), Wq, scale, jnp.asarray(mean), jnp.asarray(inv),
        jnp.asarray(b), interpret=True))
    tWq = convert._weight_bits(Wq)
    got = kernels.quantized_affine(
        torch.as_tensor(X), tWq, torch.as_tensor(np.array(scale)),
        torch.as_tensor(mean), torch.as_tensor(inv), torch.as_tensor(b))
    assert got.shape == (n, k) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert kernels.LAUNCHES["quantized_affine"] == 0  # CPU: plain version


@pytest.mark.parametrize("weight_dtype", ["bf16", "int8"])
def test_quantize_weights_is_bit_identical_to_the_reference(weight_dtype):
    rng = np.random.RandomState(3)
    W = (rng.randn(300, 12) * rng.rand(12) * 5).astype(np.float32)
    W[:, 4] = 0.0                     # all-zero column: scale 1
    # a column with amax 127 (scale 1) and exact halves: round half to
    # even (2.5 -> 2, 3.5 -> 4, -4.5 -> -4)
    W[:, 2] = np.round(rng.uniform(-126, 126, 300) * 2) / 2
    W[:3, 2] = [127.0, 2.5, 3.5]
    W[3, 2] = -4.5
    W[:, 9] *= 1e-30                  # tiny column
    jWq, jscale = jlinear._quantize_weights(jnp.asarray(W), weight_dtype)
    tWq, tscale = tlinear._quantize_weights(torch.as_tensor(W), weight_dtype)
    np.testing.assert_array_equal(_bits(tWq), _jax_bits(jWq))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    if weight_dtype == "int8":
        assert tscale[4] == 1.0 and int(tWq[:, 4].abs().max()) == 0
        assert int(tWq.abs().max()) == 127
        assert tWq[1:4, 2].tolist() == [2, 4, -4]


@pytest.mark.parametrize("weight_dtype,min_agree,max_rel", [
    ("bf16", 1.0, 0.02), ("int8", 0.98, 0.03)])
def test_quantized_predict_parity_gate(weight_dtype, min_agree, max_rel):
    """The serving parity bar on the port: quantized apply against the
    float32 apply, batch and per item, the error recorded."""
    rng = np.random.RandomState(0)
    n, d, k = 256, 64, 10
    X = rng.randn(n, d).astype(np.float32)
    teacher = rng.randn(d, k).astype(np.float32)
    Y = -np.ones((n, k), np.float32)
    Y[np.arange(n), (X @ teacher).argmax(1)] = 1.0
    data = ArrayDataset.from_numpy(X, "cpu")
    ys = ArrayDataset.from_numpy(Y, "cpu")
    model = tlinear.LinearMapEstimator(1e-3).fit(data, ys, device="cpu")
    quant = tlinear.LinearMapEstimator(
        1e-3, weight_dtype=weight_dtype).fit(data, ys, device="cpu")
    assert quant.weight_dtype == weight_dtype
    reg = MetricsRegistry.get_or_create()
    count0 = reg.counter("numerics.quant_error").value
    a = model.apply_dataset(data).numpy()
    b = quant.apply_dataset(data).numpy()
    assert (a.argmax(1) == b.argmax(1)).mean() >= min_agree
    assert np.abs(a - b).max() / np.abs(a).max() <= max_rel
    assert reg.counter("numerics.quant_error").value == count0 + 1
    assert reg.gauge("numerics.quant_rel_error").value > 0.0
    # whatever layout the solve left W in, the kernel's operands are
    # contiguous
    assert all(t.is_contiguous()
               for t in quant.apply_params(torch.device("cpu")))
    one = quant.apply(torch.as_tensor(X[0]))
    np.testing.assert_allclose(one.numpy(), b[0], rtol=1e-5, atol=1e-5)
    # the same bar against the JAX package's quantized model
    jq = jlinear.LinearMapEstimator(1e-3, weight_dtype=weight_dtype).fit(
        JArrayDataset.from_numpy(X), JArrayDataset.from_numpy(Y))
    jb = jq.apply_dataset(JArrayDataset.from_numpy(X)).numpy()
    assert (jb.argmax(1) == b.argmax(1)).mean() >= min_agree
    assert np.abs(jb - b).max() / np.abs(jb).max() <= max_rel


def test_weight_dtype_contract():
    with pytest.raises(ValueError, match="weight_dtype"):
        tlinear.LinearMapEstimator(1.0, weight_dtype="fp8")
    with pytest.raises(ValueError, match="weight_dtype"):
        tlinear.BlockLeastSquaresEstimator(4, 1, weight_dtype="int4")
    assert tlinear._canon_weight_dtype("bfloat16") == "bf16"
    assert tlinear._canon_weight_dtype(torch.int8) == "int8"
    W = np.random.RandomState(1).randn(6, 3).astype(np.float32)
    keys = {wd: tlinear.BlockLinearMapper([W], 6, weight_dtype=wd)
            for wd in (None, "bf16", "int8")}
    assert len({m.struct_key() for m in keys.values()}) == 3
    assert len({m.eq_key() for m in keys.values()}) == 3
    lm = {wd: tlinear.LinearMapper(W, weight_dtype=wd)
          for wd in (None, "bf16")}
    assert lm[None].struct_key() != lm["bf16"].struct_key()
    # pickling drops the cached (quantized) device params
    m = keys["int8"]
    m.apply_batch(torch.ones((2, 6)))
    assert "cpu" in m.__dict__["_params_cache"]
    again = pickle.loads(pickle.dumps(m))
    assert "_params_cache" not in again.__dict__
    assert again.weight_dtype == "int8"
    np.testing.assert_array_equal(again.apply_batch(torch.ones((2, 6))),
                                  m.apply_batch(torch.ones((2, 6))))


def test_narrowing_after_an_apply_drops_the_cached_float32_params():
    """A mapper applied at float32 caches float32 params; narrowing it
    afterwards (as admission does) must serve the quantized answer, not
    the cached float32 one."""
    from keystone_tpu_torch.serving.models import _apply_weight_dtype

    rng = np.random.RandomState(5)
    W = rng.randn(40, 4).astype(np.float32)
    X = torch.as_tensor(rng.randn(7, 40).astype(np.float32))
    pipe = tlinear.BlockLinearMapper([W], 40).to_pipeline()
    mapper = next(iter(pipe.graph.operators.values()))
    f32 = mapper.apply_batch(X)
    assert _apply_weight_dtype(pipe.graph, "bf16") == 1
    got = mapper.apply_batch(X)
    want = tlinear.BlockLinearMapper([W], 40, weight_dtype="bf16"
                                     ).apply_batch(X)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert not torch.equal(got, f32)


@pytest.mark.parametrize("n,d,k", [(1, 8192, 10), (64, 8192, 10),
                                   (4096, 8192, 10), (77, 50, 11),
                                   (33, 1000, 1000), (3, 64, 1)])
def test_kernel_split_covers_d_in_nonempty_slab_multiples(n, d, k):
    splits, dsplit = kernels.quant_split(n, d, k, sms=132)
    slab = kernels.QUANT_SLAB
    assert dsplit % slab == 0
    assert (splits - 1) * dsplit < d <= splits * dsplit
    assert 1 <= splits <= kernels.QUANT_MAX_SPLITS
    # no other split count would take fewer waves x slabs a block
    tiles = -(-n // kernels.QUANT_ROWS) * kernels.quant_columns(k)[1]
    slabs = -(-d // slab)
    res = kernels.QUANT_BLOCKS_PER_SM * 132

    def cost(s):
        return -(-tiles * s // res) * -(-slabs // s)

    assert cost(splits) == min(cost(s) for s in range(
        1, min(kernels.QUANT_MAX_SPLITS, slabs) + 1))


@pytest.mark.parametrize("k", [1, 2, 9, 10, 15, 16, 17, 31, 33, 1000])
@pytest.mark.parametrize("n,d", [(1, 8192), (64, 8192), (4096, 8192),
                                 (77, 50), (5, 3), (300, 1000)])
def test_launch_plan_covers_every_depth_once_and_every_column(n, d, k):
    """The kernel's launch plan: the d splits, each a run of whole slabs,
    cover every depth exactly once; the column variant is even, at most
    16, and its tiles cover k (k <= 16: one tile of at least k)."""
    kc, ctiles = kernels.quant_columns(k)
    assert kc % 2 == 0 and kc <= kernels.QUANT_KMAX
    assert kc * ctiles >= k > kc * (ctiles - 1)
    if k <= kernels.QUANT_KMAX:
        assert ctiles == 1 and kc >= k
    splits, dsplit = kernels.quant_split(n, d, k, sms=132)
    seen = np.zeros(d, np.int64)
    for s in range(splits):
        lo = s * dsplit
        assert lo < d                       # every split holds depths
        seen[lo:min(d, lo + dsplit)] += 1
    assert (seen == 1).all()


def test_bucketed_dataset_pads_to_the_bucket_with_the_true_n():
    X = np.arange(5 * 3, dtype=np.float32).reshape(5, 3)
    ds = bucketed_dataset(X, 5, 16, "cpu")
    assert ds.padded_n == 16 and ds.n == 5
    np.testing.assert_array_equal(ds.numpy(), X)
    assert int(ds.mask.sum()) == 5
    assert float(ds.data[5:].abs().sum()) == 0.0
    pair = bucketed_dataset((X, X[:, 0]), 5, 8, "cpu")
    assert [t.shape[0] for t in pair.data] == [8, 8]
    with pytest.raises(ValueError, match="do not fit"):
        bucketed_dataset(X, 5, 4, "cpu")
    with pytest.raises(ValueError, match="leading dim"):
        bucketed_dataset(X, 4, 8, "cpu")


@pytest.mark.parametrize("weight_dtype", ["bf16", "int8"])
def test_quantized_mapper_carried_across_bit_identically(weight_dtype):
    rng = np.random.RandomState(2)
    X = rng.randn(64, 24).astype(np.float32)
    Y = rng.randn(64, 3).astype(np.float32)
    jdata, jys = JArrayDataset.from_numpy(X), JArrayDataset.from_numpy(Y)
    for est in (jlinear.LinearMapEstimator(1e-2, weight_dtype=weight_dtype),
                jlinear.BlockLeastSquaresEstimator(
                    8, 2, 1e-2, weight_dtype=weight_dtype)):
        jmodel = est.fit(jdata, jys)
        jWq, jscale = jmodel.apply_params()[:2]
        want = jmodel.apply_dataset(JArrayDataset.from_numpy(X)).numpy()
        for source in (jmodel, tuple(np.asarray(p)
                                     for p in jmodel.apply_params())):
            mapper = convert.quantized_mapper(source, device="cpu")
            assert mapper.weight_dtype == weight_dtype
            Wq, scale = mapper.apply_params(torch.device("cpu"))[:2]
            np.testing.assert_array_equal(_bits(Wq), _jax_bits(jWq))
            np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
            got = mapper.apply_batch(torch.as_tensor(X)).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="no weight_dtype"):
        convert.quantized_mapper(jlinear.LinearMapEstimator(1e-2).fit(
            jdata, jys), device="cpu")


def test_wrapper_checks_its_operands_on_every_device():
    X, W, mean, inv, b = _affine_inputs(4, 6, 3, seed=1)
    t = {k: torch.as_tensor(v) for k, v in
         dict(X=X, mean=mean, inv=inv, b=b).items()}
    Wq = torch.as_tensor(W).to(torch.bfloat16)
    ones = torch.ones(3)
    with pytest.raises(ValueError, match="bfloat16 or int8"):
        kernels.quantized_affine(t["X"], torch.as_tensor(W), ones,
                                 t["mean"], t["inv"], t["b"])
    with pytest.raises(ValueError, match=r"\(n, d\) and \(d, k\)"):
        kernels.quantized_affine(t["X"][:, :5], Wq, ones, t["mean"],
                                 t["inv"], t["b"])
    with pytest.raises(ValueError, match="scale"):
        kernels.quantized_affine(t["X"], Wq, torch.ones(4), t["mean"],
                                 t["inv"], t["b"])
    # params are the five operands or a launch plan alone
    with pytest.raises(TypeError, match="QuantPlan"):
        kernels.quantized_affine(t["X"], Wq, ones, t["mean"], t["inv"])
    with pytest.raises(TypeError, match="QuantPlan"):
        kernels.quantized_affine(t["X"], (Wq, ones, t["mean"], t["inv"],
                                          t["b"]))


def test_mapper_params_on_the_cpu_are_the_operands_and_no_plan():
    """On the CPU a quantized mapper's params are the five operands (no
    launch plan is made off the card), and its batch and item applies
    pass them to the wrapper, which takes the plain version."""
    X, W, mean, inv, b = _affine_inputs(9, 6, 3, seed=2)
    mapper = tlinear.LinearMapper(
        torch.as_tensor(W), intercept=torch.as_tensor(b),
        feature_scaler=tlinear.StandardScalerModel(mean, 1.0 / inv),
        weight_dtype="int8")
    params = mapper.apply_params(torch.device("cpu"))
    assert len(params) == 5
    assert kernels.quant_plan(*params) is None
    before = dict(kernels.LAUNCHES)
    x = torch.as_tensor(X)
    want = kernels.quantized_affine_plain(x, *params)
    assert torch.equal(mapper.apply_batch(x), want)
    torch.testing.assert_close(mapper.apply(x[4]), want[4])
    assert kernels.LAUNCHES == before


def test_no_port_module_imports_jax_or_the_jax_package():
    """Every module of keystone_tpu_torch, imported in a fresh
    interpreter, pulls in neither jax nor keystone_tpu (this test
    process has both loaded already, through tests/conftest.py)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import keystone_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'keystone_tpu_torch.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'keystone_tpu' or "
        "m.startswith('keystone_tpu.'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 40 else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
