"""Device-utilization accounting: the port against ``keystone_tpu``.

``roofline`` and the peak catalogue give the JAX package's numbers on
the same counts (exact: the same float64 arithmetic); a
``UtilizationWindow`` totals the kernels' counted work and a
``FlopCounterMode`` count of torch ops; a ``count_flops`` trace charges
each node its own work, a parent's nested children to them, and
``annotate_trace`` turns it into ``flops``, ``mfu`` and ``membw_util``
with the nodes that ran no counted work listed as uncovered; the
``--trace-out`` command writes the annotations. The kernel work counts
(``ops/work.py``) give the bounds recorded for the kernels on an H100.
"""
import json

import numpy as np
import pytest
import torch

from keystone_tpu.observability import utilization as jutil
from keystone_tpu_torch.observability import utilization as tutil
from keystone_tpu_torch.observability.trace import PipelineTrace
from keystone_tpu_torch.ops import kernels, work
from keystone_tpu_torch.parallel.dataset import ArrayDataset
from keystone_tpu_torch.workflow.env import PipelineEnv
from keystone_tpu_torch.workflow.transformer import Transformer

COUNTS = [(1e12, 4e9, 0.5), (3.3e9, 1e10, 2e-3), (0.0, 1e6, 1e-4),
          (5e14, 0.0, 1.0)]
KINDS = ["NVIDIA H100 80GB HBM3", "NVIDIA A100-SXM4-80GB", "TPU v4",
         "cpu", "Some Future Card"]


def _peaks_pair(kind):
    return tutil.device_peaks(kind), jutil.device_peaks(kind)


def test_the_catalogue_is_the_jax_packages():
    assert tutil.DEVICE_PEAKS == jutil.DEVICE_PEAKS
    assert tutil.DEVICE_PEAKS["H100"] == {"flops_per_s": 989e12,
                                          "hbm_bytes_per_s": 3350e9}


@pytest.mark.parametrize("kind", KINDS)
def test_device_peaks_match_jax(kind, monkeypatch):
    for env in (tutil.FLOPS_ENV, tutil.HBM_BW_ENV, "KEYSTONE_PEAK_FLOPS",
                "KEYSTONE_PEAK_HBM_BW"):
        monkeypatch.delenv(env, raising=False)
    port, ref = _peaks_pair(kind)
    assert (port.kind, port.flops_per_s, port.hbm_bytes_per_s,
            port.source, port.ridge_intensity) == (
        ref.kind, ref.flops_per_s, ref.hbm_bytes_per_s, ref.source,
        ref.ridge_intensity)


def test_the_overrides_are_the_ports_own(monkeypatch):
    monkeypatch.setenv("KEYSTONE_TORCH_PEAK_FLOPS", "1e15")
    monkeypatch.setenv("KEYSTONE_TORCH_PEAK_HBM_BW", "2e12")
    monkeypatch.delenv("KEYSTONE_PEAK_FLOPS", raising=False)
    peaks = tutil.device_peaks("NVIDIA H100 80GB HBM3")
    assert (peaks.flops_per_s, peaks.hbm_bytes_per_s, peaks.source) == (
        1e15, 2e12, "env")
    assert jutil.device_peaks("NVIDIA H100 80GB HBM3").source == "catalogue"
    # without a card the default kind is the CPU placeholder
    monkeypatch.delenv("KEYSTONE_TORCH_PEAK_FLOPS")
    monkeypatch.delenv("KEYSTONE_TORCH_PEAK_HBM_BW")
    assert tutil.device_peaks().kind == "cpu"


@pytest.mark.parametrize("kind", KINDS[:3])
@pytest.mark.parametrize("flops,nbytes,elapsed", COUNTS)
def test_roofline_matches_jax(kind, flops, nbytes, elapsed):
    port, ref = _peaks_pair(kind)
    for n_devices in (1, 4):
        assert tutil.roofline(flops, nbytes, elapsed, n_devices, port) == \
            jutil.roofline(flops, nbytes, elapsed, n_devices, ref)


def _launch(monkeypatch, name, flops, nbytes, capturing=False):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    kernels._count_launch(name, flops, nbytes)


def test_window_totals_kernel_work_and_torch_flops(monkeypatch):
    peaks = tutil.device_peaks("NVIDIA H100 80GB HBM3")
    a = torch.randn(32, 48)
    b = torch.randn(48, 16)
    with tutil.UtilizationWindow() as uw:
        _launch(monkeypatch, "gram_cross", *work.gram_work(1024, 8192, 10))
        _launch(monkeypatch, "fv_moments", *work.fv_work(64, 16, 4096))
        _launch(monkeypatch, "fv_moments", *work.fv_work(64, 16, 4096))
        _launch(monkeypatch, "banded_matmul", 1e6, 2e6, capturing=True)
        a @ b
    u = uw.report(elapsed_s=2e-3, peaks=peaks)
    g_ops, g_bytes = work.gram_work(1024, 8192, 10)
    f_ops, f_bytes = work.fv_work(64, 16, 4096)
    kernel_flops = g_ops + 2 * f_ops
    torch_flops = 2 * 32 * 48 * 16
    assert (u["kernel_flops"], u["torch_flops"]) == (kernel_flops,
                                                     torch_flops)
    assert u["bytes_accessed_total"] == g_bytes + 2 * f_bytes
    assert u["covered_sites"] == ["fv_moments", "gram_cross", "torch"]
    # a launch recorded into a CUDA graph has no counted work here
    assert u["uncovered_sites"] == ["banded_matmul"]
    want = jutil.roofline(kernel_flops + torch_flops,
                          g_bytes + 2 * f_bytes, 2e-3, 1,
                          jutil.device_peaks("NVIDIA H100 80GB HBM3"))
    assert {k: u[k] for k in want} == want


def test_bounds_are_the_recorded_ones():
    # PERF.md's kernel table (H100 SXM peaks): featurize at B = K = 1024,
    # Gram at (1024, 8192, 10), FV at (80, 256, 47213), quantized bf16 at
    # (64, 8192, 10)
    assert work.featurize_bound(1024, 1024)[1] == pytest.approx(1.132,
                                                                abs=5e-4)
    assert work.gram_bound(1024, 8192, 10)[1] == pytest.approx(0.4175,
                                                               abs=5e-5)
    assert work.fv_bound(80, 256, 47213)[1] == pytest.approx(0.0469,
                                                             abs=5e-5)
    q_ops, q_bytes = work.quant_work(64, 8192, 10, 2)
    assert work.bound(q_ops, q_bytes)[0] == pytest.approx(0.0007, abs=5e-5)
    band = np.eye(6, 5, dtype=np.float32)
    right = np.eye(4, 3, dtype=np.float32)
    X = torch.zeros(2, 5, 3)
    ops, nbytes = work.banded_work([(band, X, right)])
    assert (ops, nbytes) == work.banded_call_work(5, 6, 3, 4, 2, 5, 3)
    assert ops == 2 * 2 * (5 * 3 + 6 * 3)


class _MatMul(Transformer):
    """x @ W: a torch op the FlopCounterMode counts."""

    def __init__(self, W):
        self.W = W

    def apply(self, x):
        return x @ self.W

    def apply_batch(self, X):
        return X @ self.W


class _Copy(Transformer):
    """A copy, kept apart from its neighbours (map fusion would fold the
    chain into one node)."""

    fusable = False

    def apply(self, x):
        return x.clone()

    def apply_batch(self, X):
        return X.clone()


def test_traced_nodes_carry_their_own_work():
    PipelineEnv.reset()
    rng = np.random.RandomState(0)
    X = ArrayDataset.from_numpy(rng.randn(64, 16).astype(np.float32), "cpu")
    W1 = torch.as_tensor(rng.randn(16, 8).astype(np.float32))
    W2 = torch.as_tensor(rng.randn(8, 4).astype(np.float32))
    pipe = _MatMul(W1) >> _Copy() >> _MatMul(W2)
    with PipelineTrace("flops", count_flops=True) as tr:
        pipe(X).get()
    peaks = tutil.device_peaks("cpu")
    assert tutil.annotate_trace(tr, peaks) == 2
    by_op = {}
    for r in tr.nodes:
        by_op.setdefault(r.operator, []).append(r)
    # the second product's record holds its own FLOPs, not the first's
    # (its thunk computes its ancestors inside it)
    assert sorted(r.torch_flops for r in by_op["_MatMul"]) == [
        2.0 * 64 * 8 * 4, 2.0 * 64 * 16 * 8]
    for r in by_op["_MatMul"]:
        assert r.flops == r.torch_flops and r.kernel_flops == 0
        assert r.mfu == pytest.approx(
            r.flops / max(r.wall_s, 1e-9) / peaks.flops_per_s)
        assert 0 < r.mfu and 0 < r.membw_util
    assert [u.split("#")[0] for u in tr.uncovered] == ["_Copy"]
    blob = json.loads(tr.to_json())
    assert blob["uncovered"] == tr.uncovered
    assert any(n["mfu"] > 0 for n in blob["nodes"])
    assert "_MatMul" in tutil.utilization_table(tr)


def test_a_plain_trace_counts_nothing():
    PipelineEnv.reset()
    X = ArrayDataset.from_numpy(np.ones((8, 4), np.float32), "cpu")
    with PipelineTrace("plain") as tr:
        (_MatMul(torch.ones(4, 2)) >> _Copy())(X).get()
    assert tr.nodes and all(r.torch_flops == 0 for r in tr.nodes)
    assert tutil.annotate_trace(tr) == 0


def test_trace_out_annotates_the_nodes(tmp_path, capsys):
    from keystone_tpu_torch import __main__ as tmain
    from keystone_tpu_torch.loaders.surrogate import make_surrogate_mnist

    PipelineEnv.reset()
    (tx, ty), (vx, vy) = make_surrogate_mnist(48, 16)
    paths = []
    for name, X, y in (("train", tx, ty), ("test", vx, vy)):
        rows = np.concatenate([(y + 1)[:, None], np.rint(X * 255)], axis=1)
        np.savetxt(tmp_path / f"{name}.csv", rows, delimiter=",", fmt="%d")
        paths.append(str(tmp_path / f"{name}.csv"))
    out = tmp_path / "trace.json"
    assert tmain.main(["mnist.random_fft", "--trainLocation", paths[0],
                       "--testLocation", paths[1], "--numFFTs", "2",
                       "--blockSize", "256", "--lambda", "10",
                       "--device", "cpu", "--trace-out", str(out)]) == 0
    blob = json.loads(out.read_text())
    annotated = [n for n in blob["nodes"] if n["flops"] > 0]
    assert annotated and all(n["mfu"] > 0 for n in annotated)
    assert "uncovered" in blob
    assert "mfu" in capsys.readouterr().err
