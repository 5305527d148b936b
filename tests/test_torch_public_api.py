"""The port's import surface against the JAX package's.

Every module of ``keystone_tpu`` that declares ``__all__`` has a
counterpart in ``keystone_tpu_torch`` whose ``__all__`` is the same list,
in the same order, less the names of :data:`JAX_ONLY`; every name of the
port's ``__all__`` imports. :data:`JAX_ONLY` is the one difference
allowed, each entry with its reason.

Below ``__all__``, the members: every public function and class that a
JAX module defines has a counterpart of the same name in the port's
module of the same path, and every public method, classmethod,
staticmethod and property in such a class's body is an attribute of the
port's class (inherited ones count). :data:`JAX_ONLY_MEMBERS` and
:data:`MOVED` are the exceptions, each with its reason.
"""
import ast
import functools
import importlib
import inspect
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

_STRUCT_KEY = ("a jit program-sharing key: fitted nodes of one structure "
               "share an XLA program; the port compiles none")
_COMPILELOG = ("XLA compile observation; the port's compiles are CUDA-graph "
               "captures, observed by compilelog.observed_capture")
_JIT_MEMO = "a jit program cache or its key; the port compiles no programs"
_H2D = "per-chip staging on a JAX mesh; a port rank stages to its one card"
_INTERN = ("interning for jit reuse; the port builds FusedTransformer / "
           "FusedGatherTransformer directly")

#: JAX member (module path relative to the package, then the name, then
#: a method's name) -> why the port has no counterpart
JAX_ONLY_MEMBERS = {
    **{f"{cls}.struct_key": _STRUCT_KEY for cls in (
        "nodes.images.core.Convolver",
        "nodes.images.core.FusedConvRectifyPool",
        "nodes.images.fisher_vector.FisherVector",
        "nodes.learning.classifiers.NaiveBayesModel",
        "nodes.learning.classifiers.LogisticRegressionModel",
        "nodes.learning.gmm.GaussianMixtureModel",
        "nodes.learning.kmeans.KMeansModel",
        "nodes.learning.zca.ZCAWhitener",
        "nodes.stats.StandardScalerModel",
        "workflow.transformer.Transformer")},
    **{f"observability.compilelog.{name}": _COMPILELOG for name in (
        "observation_enabled", "registered_sites", "executable_stats",
        "eager_capture", "watch_jit", "observed_jit")},
    "utils.donation.donating_jit": _JIT,
    **{f"workflow.transformer.{name}": _JIT_MEMO for name in (
        "clear_jit_cache", "config_shim", "struct_cached_jit")},
    "parallel.dataset.clear_vmap_cache": _JIT_MEMO,
    "ops.linalg.solver_precision": (
        "the port's TF32 policy is fixed in ops/device.py (both switches "
        "off at import)"),
    **{f"parallel.mesh.{name}": _H2D for name in (
        "replicated_zeros", "h2d_workers", "h2d_pool", "shutdown_h2d_pool")},
    **{f"workflow.optimizer.fusion.{name}": _INTERN for name in (
        "fused_transformer", "fused_gather_transformer")},
}

#: JAX member -> (the port's member that does its work, why it moved)
MOVED = {
    "analysis.resources.xla_verify_plan": (
        "analysis.resources.device_verify_plan",
        "the plan is verified by one run a node on the card, not by XLA"),
    "analysis.resources.format_xla_verify": (
        "analysis.resources.format_device_verify",
        "the report of device_verify_plan"),
    "analysis.resources.fitted_model_nbytes": (
        "serving.residency.fitted_model_nbytes",
        "the serving plane's admission charge is its one caller"),
}

#: the JAX module holding the five Pallas kernels, ported into csrc/
_KERNEL_MODULE = "ops.pallas_kernels"

_METHOD_KINDS = (staticmethod, classmethod, property,
                 functools.cached_property)


def _module_paths():
    """(module path relative to the package, file) of every JAX module."""
    root = REPO / "keystone_tpu"
    for path in sorted(root.rglob("*.py")):
        parts = [p for p in path.relative_to(root).with_suffix("").parts
                 if p != "__init__"]
        yield ".".join(parts), path


def _modules_with_all():
    out = []
    for mod, path in _module_paths():
        tree = ast.parse(path.read_text())
        if any(isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in n.targets) for n in tree.body):
            out.append(mod)
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


ALL_MODULES = [m for m, _ in _module_paths() if m != _KERNEL_MODULE]


def _module(pkg, mod):
    return importlib.import_module(pkg + (f".{mod}" if mod else ""))


def _public_members(ref):
    """``(path, kind)`` of the public functions and classes the JAX
    module defines, and of the public methods and properties in each
    class's body."""
    for name, obj in vars(ref).items():
        if name.startswith("_") or getattr(obj, "__module__", None) != \
                ref.__name__:
            continue
        if not (inspect.isfunction(obj) or inspect.isclass(obj)):
            continue
        yield (name,)
        if inspect.isclass(obj):
            for attr, val in vars(obj).items():
                if not attr.startswith("_") and (
                        inspect.isfunction(val)
                        or isinstance(val, _METHOD_KINDS)):
                    yield (name, attr)


def _resolve(port, path):
    obj = port
    for part in path:
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


@pytest.mark.parametrize("mod", ALL_MODULES)
def test_every_public_member_has_a_counterpart(mod):
    """Each public function, class and class member of the JAX module
    exists in the port's module of the same path, or is named in
    JAX_ONLY_MEMBERS or MOVED."""
    ref, port = _module("keystone_tpu", mod), _module("keystone_tpu_torch", mod)
    missing = []
    for path in _public_members(ref):
        key = ".".join(((mod,) if mod else ()) + path)
        if key in JAX_ONLY_MEMBERS or key in MOVED:
            continue
        if not _resolve(port, path):
            missing.append(key)
    assert not missing, missing


def test_the_member_exceptions_name_real_jax_members():
    """Every key of JAX_ONLY_MEMBERS and MOVED is a public member of the
    JAX package that the port's module lacks; each moved member's new
    home exists; every entry has its reason."""
    members = {}
    for mod in ALL_MODULES:
        ref = _module("keystone_tpu", mod)
        members[mod] = set(_public_members(ref))
    for key in list(JAX_ONLY_MEMBERS) + list(MOVED):
        mod = next(m for m in sorted(members, key=len, reverse=True)
                   if key.startswith(m + "."))
        path = tuple(key[len(mod) + 1:].split("."))
        assert path in members[mod], key
        assert not _resolve(_module("keystone_tpu_torch", mod), path), key
    for target, reason in MOVED.values():
        mod, name = target.rsplit(".", 1)
        assert hasattr(_module("keystone_tpu_torch", mod), name), target
        assert reason
    assert all(JAX_ONLY_MEMBERS.values())
    assert not set(JAX_ONLY_MEMBERS) & set(MOVED)


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
