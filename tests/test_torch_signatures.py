"""The port's call signatures, switches and metric names against the JAX
package's.

Parameters. For every public function, class (its ``__init__``) and
method that ``tests/test_torch_public_api.py`` pairs across the
packages:

* every JAX parameter exists in the port under the same name, or is
  named in :data:`JAX_ONLY_PARAMS` (no meaning in the port) or in
  :data:`MOVED_PARAMS` (another port parameter does its work, at its
  place);
* the JAX parameters keep the JAX positional order. Where a JAX
  positional parameter has no port counterpart, the port's later JAX
  parameters are keyword-only, so a JAX-style positional call raises
  rather than binding a value to the next parameter;
* a default is the JAX default, after mapping numpy dtypes to torch
  dtypes, the JAX package's classes and functions to the port's of the
  same qualified name, and the JAX package's data paths to the port's;
* the port's own parameters come after all the JAX ones, and are
  keyword-only where the JAX signature has no parameter at that place:
  after a JAX parameter the port lacks, or after JAX keyword-only ones.

Switches. Every ``KEYSTONE_X`` the JAX package reads has a
``KEYSTONE_TORCH_X`` that the port reads, less :data:`JAX_ONLY_SWITCHES`;
the port reads no ``KEYSTONE_`` name without the ``TORCH_`` prefix.

Metrics. Every metric name the JAX package passes to ``counter``,
``gauge``, ``histogram`` or ``timer`` as a literal, or as an f-string's
literal head, is emitted by the port the same way and catalogued in its
``observability/names.py``, less :data:`JAX_ONLY_METRICS`.

The switches and metrics come from the two packages' syntax trees; the
signatures from ``inspect`` on the members the public-API audit pairs.
"""
import ast
import functools
import inspect
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_public_api import (ALL_MODULES, JAX_ONLY_MEMBERS, MOVED,
                                   _module, _public_members)

REPO = Path(__file__).resolve().parent.parent
P = inspect.Parameter
_POSITIONAL = (P.POSITIONAL_ONLY, P.POSITIONAL_OR_KEYWORD)

_RANKS = ("a port mesh holds ranks, one card each; JAX meshes hold the "
          "devices of a host")
_ONE_CARD_DATA = ("the port places a dataset on ``device``, its rank's one "
                  "card, where a JAX mesh spreads it over a host's chips")
_XLA_EXEC = ("the compiled XLA executables of the JAX package; the port "
             "compiles none (its captures are CUDA graphs)")
_SHARD_BUCKETS = (
    "a JAX plane splits each batch over its mesh's devices, so its buckets "
    "are shard multiples; a port plane serves from its rank's one card, "
    "whole batches (its ``data_shards`` sizes admission alone, "
    "serving/plane.py, and the apply over ranks is parallel/spmd_apply.py), "
    "so its buckets are those of a one-device JAX mesh")

_PLAN_VS_XLA = (
    "the JAX ratio divides a node's static plan by XLA's memory analysis "
    "(output + temp bytes) of the program the node compiled; a port node "
    "compiles no program and a trace records no per-node allocation, so "
    "the plan is held against the device by ``check --xla`` "
    "(analysis/resources.py ``device_verify_plan``: ``plan_vs_device`` "
    "and the node's allocation peak, each node run once)")

#: JAX parameter (member key, then ``.param``) -> why the port has none
JAX_ONLY_PARAMS = {
    "parallel.dataset.ArrayDataset._already_sharded": (
        "a JAX batch placed on the mesh already; a port dataset lies on "
        "one device and is never re-placed"),
    "parallel.distributed.DryrunWorld.devices_per_process": (
        "virtual XLA CPU devices a JAX process fakes; a port rank drives "
        "one device"),
    "parallel.mesh.shard_put.pool": (
        "the JAX per-chip staging thread pool; a port rank stages to its "
        "one card in one copy"),
    "ops.sift.dense_sift.precision": (
        "the XLA matmul precision of the band products; the port's run in "
        "float32 (TF32 off, ops/device.py), the banded kernel included"),
    "observability.postmortem.dump_postmortem.capture_executables":
        _XLA_EXEC,
    "observability.postmortem.attach_postmortem.capture_executables":
        _XLA_EXEC,
    "observability.compilelog.executable_table.capture": _XLA_EXEC,
    "observability.compilelog.executable_table.max_capture": _XLA_EXEC,
    "observability.compilelog.CompileObservatory.record.delta": (
        "the change of an XLA program's argument signature; a CUDA-graph "
        "capture has none"),
    "observability.compilelog.CompileObservatory.record.signature": (
        "an XLA program's argument signature; a CUDA-graph capture has "
        "none"),
    "utils.donation.DonationSite.static_argnames": (
        "jit static arguments; the port's in-place updates are plain "
        "functions"),
    "utils.checkpoint.SolverCheckpoint.load.model_shapes": (
        "JAX ranks restore one shared file into these shapes; the port "
        "keeps one file a rank and agrees on the pass by a gather "
        "(nodes/learning/block_weighted.py)"),
    "serving.plane.ServingPlane.mesh": (
        "the device mesh a JAX plane splits its batches over; a port plane "
        "serves from its rank's one card (``device``)"),
    "serving.batcher.BucketPolicy.rows.shards": _SHARD_BUCKETS,
    "serving.batcher.BucketPolicy.bucket_for.shards": _SHARD_BUCKETS,
    "serving.batcher.BucketPolicy.max_rows.shards": _SHARD_BUCKETS,
    "observability.utilization.annotate_trace.plan": _PLAN_VS_XLA,
    "observability.trace.NodeRecord.plan_vs_xla": _PLAN_VS_XLA,
}

#: JAX parameter -> (the port's parameter that does its work, at its
#: place, and why)
MOVED_PARAMS = {
    "parallel.mesh.make_mesh.devices": ("ranks", _RANKS),
    **{f"parallel.dataset.{m}.mesh": ("device", _ONE_CARD_DATA) for m in (
        "ArrayDataset.from_numpy", "ArrayDataset.from_items",
        "HostDataset.to_device", "as_dataset", "bucketed_dataset",
        "ensure_array")},
    "observability.numerics.SketchTracker.restore.mesh": (
        "device", "a restored sketch lies on the rank's one card"),
    "parallel.distributed.PendingStep.payload": (
        "work", "the in-flight gather: a torch.distributed work handle "
                "where JAX holds a replicated device array"),
    "utils.donation.DonationSite.donate_argnums": (
        "carry_arg", "the port's update donates one carry, written in "
                     "place, by its positional index"),
}

#: JAX switch (less ``KEYSTONE_``) -> why the port has no counterpart
JAX_ONLY_SWITCHES = {
    "COMPILE_LOG": (
        "turns off the jit wrappers' compile observation; the port "
        "compiles no programs, and its capture records run only at a "
        "CUDA-graph capture"),
    "GRAM_VMEM_SLOTS": (
        "the Pallas Gram kernel's VMEM slot budget on a TPU core; the CUDA "
        "kernel's shared-memory plan is fixed at build"),
    "H2D_THREADS": (
        "lanes of the JAX per-chip staging pool; a port rank stages to "
        "one card from the stream's own producer"),
    "SOLVER_PRECISION": (
        "the XLA matmul precision of the solvers; the port's TF32 policy "
        "is fixed in ops/device.py (both switches off at import)"),
    "XLA_COST": (
        "eager XLA cost analysis at every compile; the port's counted work "
        "comes from its kernels' launch counters"),
}

#: JAX metric name (or f-string head + ``*``) -> why the port emits none
JAX_ONLY_METRICS = {}


# -- parameters ---------------------------------------------------------------

def _members():
    """``(key, jax member, port member)`` of every paired function, class
    and method (properties have no parameters)."""
    out = []
    for mod in ALL_MODULES:
        ref, port = _module("keystone_tpu", mod), _module(
            "keystone_tpu_torch", mod)
        for path in _public_members(ref):
            key = ".".join(((mod,) if mod else ()) + path)
            if key in JAX_ONLY_MEMBERS or key in MOVED:
                continue
            if len(path) == 2:
                raw = inspect.getattr_static(getattr(ref, path[0]), path[1])
                if isinstance(raw, (property, functools.cached_property)):
                    continue
            j, t = ref, port
            for part in path:
                j, t = getattr(j, part), getattr(t, part)
            out.append((key, j, t))
    return out


MEMBERS = _members()
BY_MODULE = {}
for _key, _j, _t in MEMBERS:
    _mod = next(m for m in sorted(ALL_MODULES, key=len, reverse=True)
                if _key.startswith(m + "."))
    BY_MODULE.setdefault(_mod, []).append((_key, _j, _t))


def _signature(obj):
    """The parameters of ``obj`` less a method's ``self`` / ``cls``;
    None for a member with no signature (an exception class taking
    ``*args``, on both sides)."""
    try:
        params = list(inspect.signature(obj).parameters.values())
    except (TypeError, ValueError):
        return None
    if params and params[0].name in ("self", "cls"):
        params = params[1:]
    return params


def _pkg_path(module):
    for pkg in ("keystone_tpu_torch", "keystone_tpu"):
        if module == pkg or module.startswith(pkg + "."):
            return "pkg" + module[len(pkg):]
    return None


_DATA_DIRS = (str(REPO / "keystone_tpu_torch"), str(REPO / "keystone_tpu"))


def _canon(value):
    """A default as both packages can be compared on it."""
    if isinstance(value, (tuple, list)):
        return type(value).__name__, tuple(_canon(v) for v in value)
    if isinstance(value, torch.dtype):
        return "dtype", str(value).replace("torch.", "")
    if isinstance(value, np.dtype) or (
            isinstance(value, type) and issubclass(value, np.generic)):
        return "dtype", np.dtype(value).name
    if isinstance(value, str):
        for d in _DATA_DIRS:
            value = value.replace(d, "<package>")
        return value
    if isinstance(value, type) or callable(value):
        module = getattr(value, "__module__", None) or ""
        name = getattr(value, "__qualname__", None) or getattr(
            value, "__name__", repr(value))
        pkg = _pkg_path(module)
        if pkg is not None:
            return "object", pkg, name
        if module.startswith(("jax", "numpy", "torch")) or isinstance(
                value, types.BuiltinFunctionType):
            # an array library's function: jnp.add and torch.add alike
            return "library", getattr(value, "__name__", name)
        return "object", module, name
    return value


def _moved(key, name):
    return MOVED_PARAMS.get(f"{key}.{name}", (name,))[0]


def _signature_faults(key, jax_obj, port_obj):
    """Every way the port's signature of ``key`` departs from the JAX
    one, outside the two tables."""
    jp, tp = _signature(jax_obj), _signature(port_obj)
    if jp is None or tp is None:
        return [] if jp is None and tp is None else [f"{key}: signature"]
    port = {p.name: p for p in tp}
    faults = []
    jax_names = set()
    shifted = False   # a JAX positional place the port does not hold
    pos = 0
    port_pos = [p.name for p in tp if p.kind in _POSITIONAL]
    for p in jp:
        where = f"{key}.{p.name}"
        if where in JAX_ONLY_PARAMS:
            shifted = shifted or p.kind in _POSITIONAL
            continue
        name = _moved(key, p.name)
        jax_names.add(name)
        q = port.get(name)
        if q is None:
            faults.append(f"{where}: missing")
            continue
        if p.kind in (P.VAR_POSITIONAL, P.VAR_KEYWORD):
            if q.kind != p.kind:
                faults.append(f"{where}: {q.kind} where JAX has {p.kind}")
            if p.kind == P.VAR_POSITIONAL:
                shifted = True
            continue
        if p.kind in _POSITIONAL and not shifted and q.kind in _POSITIONAL:
            if pos >= len(port_pos) or port_pos[pos] != name:
                faults.append(f"{where}: positional place {pos} holds "
                              f"{port_pos[pos:pos + 1]}")
            pos += 1
        elif p.kind in _POSITIONAL and q.kind != P.KEYWORD_ONLY:
            faults.append(f"{where}: positional after a JAX place the port "
                          "lacks; must be keyword-only")
        elif p.kind in _POSITIONAL:
            shifted = True
        elif q.kind not in (P.KEYWORD_ONLY, P.POSITIONAL_OR_KEYWORD):
            faults.append(f"{where}: {q.kind} where JAX is keyword-only")
        if p.default is not P.empty and name == p.name:
            # a moved parameter has the default of what it moved to
            if q.default is P.empty:
                faults.append(f"{where}: no default where JAX has "
                              f"{p.default!r}")
            elif _canon(p.default) != _canon(q.default):
                faults.append(f"{where}: default {q.default!r} where JAX "
                              f"has {p.default!r}")
    jax_kw_only = any(p.kind in (P.KEYWORD_ONLY, P.VAR_POSITIONAL)
                      for p in jp)
    for i, q in enumerate(tp):
        if q.name in jax_names or q.kind == P.VAR_KEYWORD:
            continue
        if q.kind in _POSITIONAL and (shifted or jax_kw_only):
            faults.append(f"{key}.{q.name}: the port's own parameter is "
                          "positional where the JAX signature has no place "
                          "for it; must be keyword-only")
        later = [r.name for r in tp[i + 1:]
                 if r.name in jax_names and r.kind in _POSITIONAL]
        if later:
            faults.append(f"{key}.{q.name}: the port's own parameter comes "
                          f"before the JAX ones {later}")
    return faults


@pytest.mark.parametrize("mod", sorted(BY_MODULE))
def test_every_jax_parameter_keeps_its_name_place_and_default(mod):
    faults = [f for key, j, t in BY_MODULE[mod]
              for f in _signature_faults(key, j, t)]
    assert not faults, faults


def test_the_parameter_tables_name_real_parameters():
    """Every entry of JAX_ONLY_PARAMS and MOVED_PARAMS is a parameter of a
    paired JAX member that the port's member lacks under that name, each
    moved one's new name is a parameter of the port's member, and every
    entry has its reason."""
    members = {key: (j, t) for key, j, t in MEMBERS}
    for entry in list(JAX_ONLY_PARAMS) + list(MOVED_PARAMS):
        key, name = entry.rsplit(".", 1)
        assert key in members, entry
        j, t = members[key]
        assert name in [p.name for p in _signature(j)], entry
        assert name not in [p.name for p in _signature(t)], entry
    for entry, (target, reason) in MOVED_PARAMS.items():
        key = entry.rsplit(".", 1)[0]
        assert target in [p.name for p in _signature(members[key][1])], entry
        assert reason
    assert all(JAX_ONLY_PARAMS.values())
    assert not set(JAX_ONLY_PARAMS) & set(MOVED_PARAMS)


def test_the_audit_sees_a_wrong_binding():
    """The rule itself: a renamed, a reordered, a dropped and a
    re-defaulted parameter, and a port parameter put before the JAX
    ones, are each a fault; the same signature is none."""
    def ref(data, n, mesh=None, tag=None):
        pass

    def same(data, n, mesh=None, tag=None, *, device="cuda"):
        pass

    def renamed(data, count, mesh=None, tag=None):
        pass

    def reordered(data, n, tag=None, mesh=None):
        pass

    def dropped(data, n, tag=None):
        pass

    def defaulted(data, n, mesh=None, tag="t"):
        pass

    def wedged(data, n, device="cuda", mesh=None, tag=None):
        pass

    assert _signature_faults("k", ref, same) == []
    for bad in (renamed, reordered, dropped, defaulted, wedged):
        assert _signature_faults("k", ref, bad), bad.__name__


def test_defaults_map_across_the_packages():
    from keystone_tpu.resilience import retry as jretry
    from keystone_tpu_torch.resilience import retry as tretry

    assert _canon(np.float32) == _canon(torch.float32)
    assert _canon(jretry.TransientError) == _canon(tretry.TransientError)
    assert _canon(jretry.TransientError) != _canon(tretry.RetryPolicy)
    assert _canon(str(REPO / "keystone_tpu" / "a.json")) == _canon(
        str(REPO / "keystone_tpu_torch" / "a.json"))


# -- switches -----------------------------------------------------------------

_SWITCH = re.compile(r"KEYSTONE_[A-Z0-9_]+")


def _py_files(pkg):
    return sorted((REPO / pkg).rglob("*.py"))


def _switches(pkg):
    """Every string constant of the package that is a whole
    ``KEYSTONE_*`` name (docstrings and messages are longer)."""
    found = {}
    for path in _py_files(pkg):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and _SWITCH.fullmatch(node.value)):
                found.setdefault(node.value, f"{path.name}:{node.lineno}")
    return found


def test_every_jax_switch_has_a_torch_switch():
    jax_names = {n[len("KEYSTONE_"):] for n in _switches("keystone_tpu")}
    port = set(_switches("keystone_tpu_torch"))
    missing = sorted(n for n in jax_names - set(JAX_ONLY_SWITCHES)
                     if f"KEYSTONE_TORCH_{n}" not in port)
    assert not missing, missing
    assert set(JAX_ONLY_SWITCHES) <= jax_names
    assert all(JAX_ONLY_SWITCHES.values())
    for name in JAX_ONLY_SWITCHES:
        assert f"KEYSTONE_TORCH_{name}" not in port, name


def test_the_port_reads_no_unprefixed_switch():
    unprefixed = {n: at for n, at in _switches("keystone_tpu_torch").items()
                  if not n.startswith("KEYSTONE_TORCH_")}
    assert not unprefixed, unprefixed
    heads = []
    for path in _py_files("keystone_tpu_torch"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.JoinedStr) and node.values and \
                    isinstance(node.values[0], ast.Constant):
                head = str(node.values[0].value)
                if _SWITCH.match(head) and not head.startswith(
                        "KEYSTONE_TORCH_"):
                    heads.append(f"{path.name}:{node.lineno}")
    assert not heads, heads


# -- metrics ------------------------------------------------------------------

_METRIC_CALLS = ("counter", "histogram", "gauge", "timer")


def _metric_names(pkg):
    """Literal metric names, and f-string heads as ``head*``."""
    found = {}
    for path in _py_files(pkg):
        for node in ast.walk(ast.parse(path.read_text())):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            fn = node.func
            fname = (fn.attr if isinstance(fn, ast.Attribute)
                     else getattr(fn, "id", None))
            if fname not in _METRIC_CALLS:
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                name = arg.value
            elif isinstance(arg, ast.JoinedStr) and arg.values and \
                    isinstance(arg.values[0], ast.Constant):
                name = str(arg.values[0].value) + "*"
            else:
                continue
            found.setdefault(name, f"{path.name}:{node.lineno}")
    return found


def test_every_jax_metric_is_emitted_and_catalogued_by_the_port():
    from keystone_tpu_torch.observability.names import (
        is_catalogued, is_catalogued_prefix)

    jax_names = _metric_names("keystone_tpu")
    port = _metric_names("keystone_tpu_torch")
    faults = []
    for name, at in sorted(jax_names.items()):
        if name in JAX_ONLY_METRICS:
            continue
        if name not in port:
            faults.append(f"{name} ({at}): not emitted by the port")
        elif name.endswith("*"):
            if not is_catalogued_prefix(name[:-1]):
                faults.append(f"{name}: prefix not catalogued")
        elif not is_catalogued(name):
            faults.append(f"{name}: not catalogued")
    assert not faults, faults
    assert set(JAX_ONLY_METRICS) <= set(jax_names)
    assert all(JAX_ONLY_METRICS.values())


def test_the_two_metrics_this_audit_found_are_named_in_the_catalogue():
    from keystone_tpu_torch.observability.names import METRIC_NAMES

    assert {"executor.prefix_hits", "numerics.residual_rel"} <= METRIC_NAMES
