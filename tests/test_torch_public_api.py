"""The port's import surface against the JAX package's.

Every module of ``keystone_tpu`` that declares ``__all__`` has a
counterpart in ``keystone_tpu_torch`` whose ``__all__`` is the same list,
in the same order, less the names of :data:`JAX_ONLY`; every name of the
port's ``__all__`` imports. :data:`JAX_ONLY` is the one difference
allowed, each entry with its reason.
"""
import ast
import importlib
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent

_JIT = "a jit helper: the port compiles no programs (its compile is a " \
       "CUDA-graph capture, observability.compilelog.observed_capture)"

#: module (relative to the package) -> {JAX-only name: reason}
JAX_ONLY = {
    "observability": {"observed_jit": _JIT, "watch_jit": _JIT},
    "utils": {"donating_jit": _JIT},
}

#: JAX modules the port has no counterpart of yet, with the reason
JAX_ONLY_MODULES = {}


def _modules_with_all():
    out = []
    root = REPO / "keystone_tpu"
    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text())
        if any(isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in n.targets) for n in tree.body):
            rel = path.relative_to(root).with_suffix("")
            parts = [p for p in rel.parts if p != "__init__"]
            out.append(".".join(parts))
    return out


MODULES = _modules_with_all()


def test_the_jax_only_lists_name_real_jax_names():
    for mod, names in JAX_ONLY.items():
        ref = importlib.import_module(
            "keystone_tpu" + (f".{mod}" if mod else ""))
        assert set(names) <= set(ref.__all__), mod
    assert set(JAX_ONLY_MODULES) <= set(MODULES)


@pytest.mark.parametrize("mod", [m for m in MODULES
                                 if m not in JAX_ONLY_MODULES])
def test_all_is_the_jax_packages_less_the_named_list(mod):
    suffix = f".{mod}" if mod else ""
    ref = importlib.import_module("keystone_tpu" + suffix)
    port = importlib.import_module("keystone_tpu_torch" + suffix)
    skip = JAX_ONLY.get(mod, {})
    assert list(port.__all__) == [n for n in ref.__all__ if n not in skip]
    for name in port.__all__:
        assert getattr(port, name) is not None, name


def test_the_readme_imports_work():
    """The names the JAX README imports from the package and its
    observability layer import from the port too."""
    from keystone_tpu_torch import PipelineTrace, is_streamable  # noqa: F401
    from keystone_tpu_torch.observability import (  # noqa: F401
        TelemetrySampler, compile_observatory, expect_no_compiles,
        score_drift, serve_metrics, xprof_trace)


def test_mean_average_precision_evaluator_wraps_the_function():
    from keystone_tpu.evaluation import MeanAveragePrecisionEvaluator as J
    from keystone_tpu_torch.evaluation import (
        MeanAveragePrecisionEvaluator, evaluate_mean_average_precision)

    rng = np.random.RandomState(0)
    scores = rng.rand(20, 4).astype(np.float32)
    labels = [list(rng.choice(4, size=1 + i % 2, replace=False))
              for i in range(20)]
    got = MeanAveragePrecisionEvaluator().evaluate(labels, scores, 4)
    np.testing.assert_array_equal(
        got, evaluate_mean_average_precision(labels, scores, 4))
    np.testing.assert_allclose(got, J().evaluate(labels, scores, 4),
                               rtol=1e-12)


def test_cifar_decode_u8_matches_the_jax_one_and_stays_bytes():
    from keystone_tpu import native as jnative
    from keystone_tpu_torch import native
    from keystone_tpu_torch.loaders.cifar_loader import cifar_decode

    rng = np.random.RandomState(1)
    raw = rng.randint(0, 256, size=5 * 3073, dtype=np.uint8).tobytes()
    imgs, labels = native.cifar_decode_u8(raw)
    want_imgs, want_labels = jnative.cifar_decode_u8(raw)
    assert imgs.dtype == np.uint8 and imgs.shape == (5, 32, 32, 3)
    assert imgs.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(imgs, want_imgs)
    np.testing.assert_array_equal(labels, want_labels)
    wide, _ = cifar_decode(raw)
    assert wide.dtype == np.float32 and wide.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(wide, imgs.astype(np.float32))
    packed, _ = cifar_decode(raw, packed=True)
    np.testing.assert_array_equal(packed, imgs)
    with pytest.raises(ValueError, match="corrupt"):
        native.cifar_decode_u8(raw[:-1])
