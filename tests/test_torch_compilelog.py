"""The port's capture observatory (``keystone_tpu_torch/observability/
compilelog.py``) and its bounded memo (``utils/lru.py``), on the CPU:

* the observatory counts, times and fences records as the JAX package's
  ``CompileObservatory`` does: the same records under the same fences
  give the same counts, names and unexpected flags;
* a record inside an armed fence is unexpected and names the fence,
  fences nest, ``expect_no_compiles`` disarms even when its block
  raises, and ``is_device_oom`` recognizes ``torch.cuda.
  OutOfMemoryError``;
* ``fit_streaming`` arms ``fit_streaming:<tag>`` after its warm chunks
  and disarms it at the end: a capture recorded in the steady chunk
  loop is unexpected, one in the warm chunks is not;
* the executor attributes a capture inside a traced node to that node,
  and the trace keeps the capture in its round-tripping ``compiles``;
* ``LruMemo`` keeps and drops the same keys as the JAX package's, and
  returns what it drops;
* a kernel wrapper called while its stream captures a graph counts the
  launch as captured, not as run.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from keystone_tpu.observability.compilelog import \
    CompileObservatory as JObservatory
from keystone_tpu.utils.lru import LruMemo as JLruMemo
from keystone_tpu_torch.nodes.learning.linear import LinearMapEstimator
from keystone_tpu_torch.observability.compilelog import (
    CompileObservatory,
    compile_observatory,
    expect_no_compiles,
    is_device_oom,
    observed_capture,
    reset_compile_observatory,
)
from keystone_tpu_torch.observability.metrics import MetricsRegistry
from keystone_tpu_torch.observability.trace import PipelineTrace
from keystone_tpu_torch.parallel.dataset import ArrayDataset
from keystone_tpu_torch.parallel.streaming import StreamingDataset
from keystone_tpu_torch.utils.lru import LruMemo
from keystone_tpu_torch.workflow.transformer import Transformer


@pytest.fixture(autouse=True)
def _fresh():
    reset_compile_observatory()
    MetricsRegistry.reset()
    yield
    reset_compile_observatory()


_SCRIPT = [("arm", "warmup"), ("rec", "a"), ("rec", "b"), ("disarm", None),
           ("rec", "a"), ("arm", "outer"), ("arm", "inner"), ("rec", "c"),
           ("disarm", None), ("rec", "d"), ("disarm", None), ("rec", "e")]


def _drive(obs):
    for op, arg in _SCRIPT:
        if op == "arm":
            obs.arm_fence(arg)
        elif op == "disarm":
            obs.disarm_fence()
        else:
            obs.record(name=arg, wall_s=0.25, trigger="admission")


def test_records_and_fences_match_the_jax_observatory():
    ours, theirs = CompileObservatory(), JObservatory()
    _drive(ours)
    _drive(theirs)
    assert ours.count_total() == theirs.count_total() == 6
    assert ours.unexpected_total() == theirs.unexpected_total() == 4
    assert ours.by_name() == theirs.by_name()
    assert ours.wall_s_total() == theirs.wall_s_total()
    assert [(r["name"], r.get("fence")) for r in ours.tail()] == \
        [(r["name"], r.get("fence")) for r in theirs.tail()]
    assert [r["fence"] for r in ours.unexpected_records()] == \
        ["warmup", "warmup", "inner", "outer"]
    assert not ours.fenced


def test_observed_capture_records_with_metrics_and_span():
    obs = compile_observatory()
    reg = MetricsRegistry.get_or_create()
    with observed_capture("serve:m:8:full", "admission") as stats:
        stats["pool_nbytes"] = 4096.0
    assert stats["wall_s"] >= 0.0
    with expect_no_compiles("steady"):
        with observed_capture("serve:m:8", "bucket_miss"):
            pass
    assert obs.count_total() == 2 and obs.unexpected_total() == 1
    assert reg.counter("compile.count").value == 2
    assert reg.counter("compile.unexpected_total").value == 1
    assert reg.histogram("compile.wall_s").count == 2
    rec = obs.unexpected_records()[0]
    assert rec["name"] == "serve:m:8" and rec["fence"] == "steady"
    assert obs.tail()[0]["stats"]["pool_nbytes"] == 4096.0
    with pytest.raises(ValueError):
        with observed_capture("x", "recompile"):
            pass
    # a capture that raises built nothing and is not recorded
    with pytest.raises(RuntimeError):
        with observed_capture("y", "admission"):
            raise RuntimeError("capture broke")
    assert obs.count_total() == 2


def test_expect_no_compiles_disarms_when_its_block_raises():
    obs = compile_observatory()
    with pytest.raises(KeyError):
        with expect_no_compiles("block"):
            assert obs.fenced
            raise KeyError("boom")
    assert not obs.fenced
    assert obs.snapshot()["unexpected"] == 0


def test_is_device_oom():
    assert is_device_oom(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert is_device_oom(MemoryError())
    assert is_device_oom(RuntimeError("CUDA error: out of memory"))
    assert not is_device_oom(ValueError("shape mismatch"))


def _stream(n=160, d=8, chunk=20):
    r = np.random.RandomState(0)
    X = r.randn(n, d).astype(np.float32)
    Y = r.randn(n, 2).astype(np.float32)
    return (StreamingDataset.from_numpy(X, chunk, device="cpu", tag="cl"),
            ArrayDataset.from_numpy(Y, "cpu"))


@pytest.mark.parametrize("at_chunk,unexpected", [(0, 0), (1, 0), (2, 1),
                                                 (6, 1)])
def test_streamed_fit_fence_catches_a_steady_capture(monkeypatch, at_chunk,
                                                     unexpected):
    """A capture recorded while the fit accumulates chunk ``at_chunk``:
    the first two chunks are warm, every later one is steady state."""
    from keystone_tpu_torch.nodes.learning import linear

    seen = [0]
    orig = linear.LinearMapEstimator.accumulate

    def accumulate(self, carry, chunk, *rest):
        if seen[0] == at_chunk:
            with observed_capture("induced", "monitor"):
                pass
        seen[0] += 1
        return orig(self, carry, chunk, *rest)

    monkeypatch.setattr(linear.LinearMapEstimator, "accumulate", accumulate)
    X, Y = _stream()
    LinearMapEstimator(lam=0.1).fit(X, Y)
    obs = compile_observatory()
    assert obs.count_total() == 1
    assert obs.unexpected_total() == unexpected
    if unexpected:
        assert obs.unexpected_records()[0]["fence"] == "fit_streaming:cl"
    assert not obs.fenced


class _CapturingNode(Transformer):
    """Records one capture while it applies (the executor attributes
    it to the node)."""

    def apply(self, x):
        return x

    def apply_batch(self, X):
        with observed_capture("inside-node", "admission"):
            pass
        return X * 2.0


def test_executor_attributes_a_capture_to_its_node():
    ds = ArrayDataset.from_numpy(np.ones((4, 3), np.float32), "cpu")
    with PipelineTrace("attr") as tr:
        _CapturingNode().to_pipeline().apply(ds).get()
    rec = compile_observatory().tail()[0]
    assert rec["context"].startswith("node:")
    assert tr.compiles and tr.compiles[0]["name"] == "inside-node"
    again = PipelineTrace.from_json(tr.to_json())
    assert again.compiles == tr.compiles


def test_lru_memo_matches_the_jax_memo():
    ours, theirs = LruMemo(max_entries=3), JLruMemo(max_entries=3)
    ops = [("put", "a"), ("put", "b"), ("get", "a"), ("put", "c"),
           ("put", "d"), ("get", "b"), ("get", "a"), ("put", "e"),
           ("get", "c"), ("get", "d")]
    dropped = []
    for op, key in ops:
        if op == "put":
            dropped += [k for k, _ in ours.put(key, key.upper())]
            theirs.put(key, key.upper())
        else:
            assert ours.get(key) == theirs.get(key)
        assert len(ours) == len(theirs)
    assert dropped == ["b", "c"]
    assert ours.put("a", "A2") == [("a", "A")]
    assert [k for k, _ in ours.pop_where(lambda k: k in ("a", "e"))] == \
        ["e", "a"]
    assert ours.keys() == ["d"]
    assert ours.clear() == [("d", "D")] and len(ours) == 0
    with pytest.raises(ValueError):
        ours.put("x", None)


@pytest.mark.parametrize("capturing", [False, True])
def test_a_launch_under_capture_counts_as_captured(monkeypatch, capturing):
    """A capture records a launch into its graph, where each replay runs
    it; the wrapper's own count takes only the launches that run."""
    from keystone_tpu_torch.ops import kernels

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    launched = dict(kernels.LAUNCHES)
    captured = dict(kernels.CAPTURED)
    try:
        kernels._count_launch("quantized_affine")
        assert (kernels.CAPTURED["quantized_affine"]
                - captured["quantized_affine"]) == int(capturing)
        assert (kernels.LAUNCHES["quantized_affine"]
                - launched["quantized_affine"]) == int(not capturing)
    finally:
        kernels.LAUNCHES.update(launched)
        kernels.CAPTURED.update(captured)
