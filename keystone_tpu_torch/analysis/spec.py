"""Abstract values for static pipeline analysis.

Counterpart of ``keystone_tpu/analysis/spec.py``. Where the executor
flows lazy Dataset/Datum/Transformer expressions through the DAG, the
abstract interpreter (``analysis.interpreter``) flows *specs*: shape and
dtype descriptions plus the dataset metadata the cost model needs (item
count, storage density, streaming), without touching a device.

An element leaf is a :class:`ShapeDtype`, a frozen ``(shape, dtype)``
pair with a torch dtype: the port's ``jax.ShapeDtypeStruct``. Per-item
functions are shape-propagated by running them on tensors on
``torch.device("meta")`` (:func:`abstract_apply_element`), which carry a
shape and a dtype and no data.

The lattice is shallow:

* :class:`DatumSpec`: one item, a tuple tree of :class:`ShapeDtype`
  leaves (or :class:`SparseSpec` / :class:`Unknown` markers).
* :class:`DatasetSpec`: a collection of ``n`` such items.
* :class:`TransformerSpec`: an abstract fitted transformer, what an
  estimator node produces and a ``DelegatingOperator`` applies.
* :class:`Unknown`: "cannot say"; it propagates silently, so host
  stages and estimators that describe no output never produce false
  diagnostics.

``SpecDataset`` is the check command's placeholder ``Dataset``: it
carries only a spec, can be spliced wherever an app's builder expects
training data, and raises if anything tries to execute it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..parallel.dataset import ArrayDataset, Dataset, HostDataset


def torch_dtype(dtype: Any) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def dtype_name(dtype: Any) -> str:
    """``float32``, ``int32``, ``bfloat16``: numpy's names for a dtype."""
    return str(torch_dtype(dtype)).replace("torch.", "")


@dataclass(frozen=True)
class ShapeDtype:
    """One array leaf of an element: its shape and torch dtype."""

    shape: Tuple[int, ...]
    dtype: torch.dtype

    def __init__(self, shape, dtype):
        object.__setattr__(self, "shape", tuple(int(d) for d in shape))
        object.__setattr__(self, "dtype", torch_dtype(dtype))

    @property
    def nbytes(self) -> float:
        return float(np.prod(self.shape, dtype=np.float64)) * \
            torch.empty((), dtype=self.dtype).element_size()

    def __repr__(self) -> str:
        return f"ShapeDtype({list(self.shape)}, {dtype_name(self.dtype)})"


class AbstractValue:
    """Base of the analysis lattice."""


@dataclass(frozen=True)
class Unknown(AbstractValue):
    """Value the analyzer cannot describe (host objects, estimators that
    describe no output). Consuming an Unknown yields Unknown, never a
    diagnostic."""

    reason: str = ""

    def __repr__(self) -> str:
        return f"Unknown({self.reason!r})" if self.reason else "Unknown"


@dataclass(frozen=True)
class SparseSpec(AbstractValue):
    """Per-item :class:`~keystone_tpu_torch.nodes.util.sparse.SparseVector`
    element: logical size known, density not."""

    size: Optional[int] = None

    def __repr__(self) -> str:
        return f"SparseSpec(size={self.size})"


@dataclass(frozen=True)
class DatumSpec(AbstractValue):
    """One item: a tuple tree of :class:`ShapeDtype`, :class:`SparseSpec`
    or :class:`Unknown` leaves."""

    element: Any

    def __repr__(self) -> str:
        return f"DatumSpec({format_element(self.element)})"


@dataclass(frozen=True)
class DatasetSpec(AbstractValue):
    """A dataset of ``n`` items shaped like ``element``.

    ``sparsity`` is the *storage* density the cost model reads: 1.0 for
    dense array elements, None when unknown (sparse host items, host
    objects). ``streaming`` marks a chunked collection
    (``parallel.streaming``): ``n`` may be None and only estimators with
    the accumulate/finalize protocol fit on it. ``wire_dtype`` (streams)
    names a dtype shipped host to device narrower than the compute dtype
    ``element`` reports. ``geometry`` (streams) is the static chunk
    geometry (:class:`~keystone_tpu_torch.analysis.resources.StreamGeometry`)
    the HBM planner charges, None for an opaque source. ``sharded``
    marks a rank-local share of a stream (``stream_tar_shards``): its
    ``n`` is one rank's rows, and only the world loop of
    ``fit_streaming`` understands it."""

    element: Any
    n: Optional[int] = None
    host: bool = False
    sparsity: Optional[float] = None
    streaming: bool = False
    wire_dtype: Optional[str] = None
    geometry: Optional[Any] = None
    sharded: bool = False

    def __repr__(self) -> str:
        flag = ", streaming" if self.streaming else ""
        if self.sharded:
            flag += ", sharded"
        if self.wire_dtype is not None:
            flag += f", wire={self.wire_dtype}"
        return (f"DatasetSpec(n={self.n}, "
                f"element={format_element(self.element)}{flag})")


@dataclass(frozen=True)
class TransformerSpec(AbstractValue):
    """Abstract fitted transformer. ``apply_element`` maps an input
    element spec to the fitted transformer's output element (what the
    estimator's ``abstract_fit`` promised), None when the estimator does
    not describe it. ``apply_transient_nbytes`` maps the same input
    element to the fitted apply's per-item device workspace, which the
    HBM planner charges at the Delegate node; None when none is
    declared."""

    apply_element: Optional[Callable[[Any], Any]] = field(
        default=None, compare=False)
    label: str = "Transformer"
    apply_transient_nbytes: Optional[Callable[[Any], Any]] = field(
        default=None, compare=False)

    def __repr__(self) -> str:
        known = "known" if self.apply_element is not None else "opaque"
        return f"TransformerSpec({self.label}, {known})"


# -- element trees ------------------------------------------------------------

def element_map(fn: Callable[[Any], Any], element: Any) -> Any:
    """Map ``fn`` over the leaves of a tuple tree (lists become tuples,
    as in the port's data trees)."""
    if isinstance(element, (tuple, list)):
        return tuple(element_map(fn, e) for e in element)
    return fn(element)


def element_leaves(element: Any) -> list:
    if isinstance(element, (tuple, list)):
        return [leaf for e in element for leaf in element_leaves(e)]
    return [element]


def is_unknown(spec: Any) -> bool:
    return isinstance(spec, Unknown)


def element_has_unknown(element: Any) -> bool:
    """True when a leaf is not a dense array (sparse, opaque, Unknown)."""
    return any(not isinstance(leaf, ShapeDtype)
               for leaf in element_leaves(element))


def dense_sparsity(element: Any) -> Optional[float]:
    """Structural storage density of an element: 1.0 when every leaf is
    a dense array, None when any leaf is sparse or opaque."""
    return None if element_has_unknown(element) else 1.0


def format_element(element: Any) -> str:
    """The JAX package's rendering: ``'float32[64, 64, 3]'``, tuples of
    those for gathered items."""
    def fmt(leaf):
        if isinstance(leaf, ShapeDtype):
            return f"{dtype_name(leaf.dtype)}{list(leaf.shape)}"
        return repr(leaf)

    return repr(element_map(fmt, element))


def struct_of(value: Any) -> Any:
    """Element spec of a concrete per-item value (host or device; a meta
    tensor too)."""
    from ..nodes.util.sparse import SparseVector

    if isinstance(value, (tuple, list)):
        return tuple(struct_of(v) for v in value)
    if isinstance(value, SparseVector):
        return SparseSpec(value.size)
    if isinstance(value, (torch.Tensor, np.ndarray, np.generic)):
        return ShapeDtype(tuple(value.shape), value.dtype)
    if isinstance(value, (bool, int)):
        return ShapeDtype((), torch.int32)
    if isinstance(value, float):
        return ShapeDtype((), torch.float32)
    return Unknown(f"host object {type(value).__name__}")


def _stream_element(ds) -> Any:
    leaves = ds.element()
    if leaves is None:
        return Unknown("opaque stream source")
    specs = tuple(ShapeDtype(shape, name) for shape, name in leaves)
    return specs[0] if len(specs) == 1 else specs


def dataset_spec(ds: Dataset) -> AbstractValue:
    """DatasetSpec of a concrete Dataset, reading only metadata (tensor
    shapes and dtypes, the first host item), never device data."""
    spec = getattr(ds, "_keystone_spec", None)
    if spec is not None:
        return spec
    if isinstance(ds, ArrayDataset):
        element = element_map(
            lambda a: ShapeDtype(tuple(a.shape[1:]), a.dtype), ds.data)
        return DatasetSpec(element, n=ds.n, host=False, sparsity=1.0)
    from ..parallel.streaming import StreamingDataset

    if isinstance(ds, StreamingDataset):
        # the element as consumers see it (post-cast); a narrow wire is
        # reported apart so it never reads as dtype narrowing
        element = _stream_element(ds)
        return DatasetSpec(
            element, n=ds.n, host=False,
            sparsity=dense_sparsity(element),
            streaming=True, wire_dtype=ds.wire_dtype_name(),
            geometry=ds.plan_geometry(),
            sharded=bool(getattr(ds, "process_sharded", False)))
    if isinstance(ds, HostDataset):
        items = ds.items
        if not items:
            return DatasetSpec(Unknown("empty host dataset"), n=0, host=True)
        element = struct_of(items[0])
        return DatasetSpec(element, n=len(items), host=True,
                           sparsity=dense_sparsity(element))
    return Unknown(f"dataset type {type(ds).__name__}")


def datum_spec(value: Any) -> AbstractValue:
    return DatumSpec(struct_of(value))


def value_spec(value: Any) -> AbstractValue:
    """Spec of an already computed expression value (saved state)."""
    from ..workflow.operators import TransformerOperator

    if isinstance(value, Dataset):
        return dataset_spec(value)
    if isinstance(value, TransformerOperator):
        def apply_element(elem, _t=value):
            return abstract_apply_element(_t, elem)

        return TransformerSpec(apply_element, label=value.label())
    return datum_spec(value)


# -- meta execution -----------------------------------------------------------

META = torch.device("meta")


def to_meta(element: Any) -> Any:
    """Tensors on the meta device shaped like ``element``'s leaves: they
    carry a shape and a dtype and no data, so running a node's ``apply``
    on them allocates nothing and launches nothing."""
    return element_map(
        lambda leaf: torch.empty(leaf.shape, dtype=leaf.dtype, device=META),
        element)


def run_on_meta(fn: Callable[..., Any], *elements: Any) -> Any:
    """Element spec of ``fn(*meta tensors)``. Raises whatever the call
    raises: a shape error, or the meta device's refusal of a host read
    (``.item()``, ``.cpu()``, ``.numpy()``, a data-dependent shape), which
    the interpreter classifies as ``host-sync``."""
    with torch.no_grad():
        out = fn(*[to_meta(e) for e in elements])
    return struct_of(out)


def abstract_apply_element(op, element: Any) -> Any:
    """Shape-propagate one per-item application of a transformer-like
    operator on meta tensors."""
    if element_has_unknown(element):
        return Unknown("input element not fully specified")
    return run_on_meta(lambda x: op.single_transform([x]), element)


# -- estimator abstract_fit helpers -------------------------------------------

def element_feature_dim(spec: Any) -> Optional[int]:
    """Per-item feature dimension of a Dataset/Datum spec: the last axis
    of a dense element, the logical size of a sparse one."""
    element = getattr(spec, "element", spec)
    if isinstance(element, SparseSpec):
        return element.size
    if isinstance(element, ShapeDtype) and element.shape:
        return int(element.shape[-1])
    return None


def map_last_dim(k: int, dtype: Any = torch.float32) -> Callable[[Any], Any]:
    """``abstract_fit`` body of models that replace the feature axis with
    a ``k``-wide output: dense ``(..., d) -> (..., k)``, sparse ``-> (k,)``
    (the solvers densify their outputs)."""

    def apply_element(element: Any) -> Any:
        if isinstance(element, SparseSpec):
            return ShapeDtype((k,), dtype)
        if isinstance(element, ShapeDtype):
            return ShapeDtype(tuple(element.shape[:-1]) + (k,), dtype)
        return Unknown("input element not a vector/matrix")

    return apply_element


def labels_width_fit(dep_specs, dtype: Any = torch.float32
                     ) -> Optional[Callable[[Any], Any]]:
    """``abstract_fit`` of (data, labels) estimators fitting a linear
    model: the output width is the labels' feature dimension."""
    if len(dep_specs) < 2:
        return None
    k = element_feature_dim(dep_specs[1])
    return None if k is None else map_last_dim(k, dtype)


def identity_fit(dep_specs) -> Callable[[Any], Any]:
    """``abstract_fit`` of shape-preserving fitted transformers (scalers,
    whiteners)."""
    return lambda element: element


# -- input specs --------------------------------------------------------------

def as_input_spec(sample: Any, n: Optional[int] = None) -> AbstractValue:
    """Coerce a sample description into an AbstractValue: an
    AbstractValue as is; a :class:`ShapeDtype` (or tuple of them) as the
    element of a dataset; a concrete Dataset; a tensor or numpy array as
    ONE item; or a ``(shape, dtype)`` pair."""
    if isinstance(sample, AbstractValue):
        return sample
    if isinstance(sample, Dataset):
        return dataset_spec(sample)
    if isinstance(sample, ShapeDtype):
        return DatasetSpec(sample, n=n, sparsity=1.0)
    if isinstance(sample, tuple) and len(sample) == 2 and isinstance(
            sample[0], (tuple, list)) and not isinstance(
            sample[1], (tuple, list, ShapeDtype)):
        return DatasetSpec(ShapeDtype(sample[0], sample[1]), n=n,
                           sparsity=1.0)
    if isinstance(sample, (torch.Tensor, np.ndarray)):
        return DatasetSpec(ShapeDtype(tuple(sample.shape), sample.dtype),
                           n=n, sparsity=1.0)
    leaves = element_leaves(sample)
    if leaves and all(isinstance(leaf, ShapeDtype) for leaf in leaves):
        return DatasetSpec(element_map(lambda x: x, sample), n=n,
                           sparsity=1.0)
    raise TypeError(
        f"cannot build an input spec from {type(sample).__name__}; pass a "
        "ShapeDtype, (shape, dtype), tensor, Dataset, or spec")


class SpecDataset(Dataset):
    """A Dataset that exists only as a spec: it can stand in for training
    data in an app's builder for static checking, and it raises if it is
    ever executed."""

    def __init__(self, element: Any, n: Optional[int] = None,
                 host: bool = False, sparsity: Optional[float] = None,
                 tag: Optional[str] = None):
        if sparsity is None and not element_has_unknown(element):
            sparsity = 1.0
        self._keystone_spec = DatasetSpec(
            element, n=n, host=host, sparsity=sparsity)
        # a stable tag keeps DatasetOperator.eq_key deterministic for
        # spec-only graphs
        self.tag = tag or f"spec:{format_element(element)}:{n}"

    @property
    def spec(self) -> DatasetSpec:
        return self._keystone_spec

    def __len__(self) -> int:
        return self._keystone_spec.n or 0

    def _refuse(self, what: str):
        raise RuntimeError(
            f"SpecDataset cannot be {what}: it is a static-analysis "
            "placeholder (did a check-only pipeline get executed?)")

    def map(self, fn):
        self._refuse("mapped")

    def collect(self):
        self._refuse("collected")


def spec_dataset(shape, dtype: Any = torch.float32, n: Optional[int] = None,
                 **kw) -> SpecDataset:
    """Shorthand: ``spec_dataset((784,), torch.float32, n=60000)``."""
    return SpecDataset(ShapeDtype(shape, dtype), n=n, **kw)
