"""Request-path static analysis: interprocedural hot-path hazards and
atomic-publication safety for the serving plane.

Counterpart of ``keystone_tpu/analysis/hotpath.py``, over the port's
tree. Two pass families, wired into
``python -m keystone_tpu_torch.tools.lint``, ``python -m
keystone_tpu_torch check`` (the ``hotpath`` JSON key) and the gates:

**1. Hot-path reachability + hazard classification.** A package-wide
static call graph (AST only: imports resolved across modules,
``self.<attr>`` receivers typed through their constructor assignments
and class-level annotations), walked breadth first to
:data:`MAX_CHAIN_DEPTH` from the entry points declared with the
zero-cost :func:`~keystone_tpu_torch.utils.guarded.hotpath` marker.
Every reachable call is
classified; each diagnostic names the call chain from its entry point:

* ``hotpath-blocking``: ``Event.wait``, ``join``, ``sleep``,
  ``Future.result``, ``queue.get/put`` and a semaphore ``acquire``
  (receivers typed as semaphores by their constructor). Lock acquires
  are not flagged: blocking UNDER a lock is the concurrency pass's job.
* ``hotpath-host-sync``: a host-device synchronization. In torch terms
  ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``.to("cpu")``, ``torch.cuda.synchronize()`` and
  ``Stream``/``Event.synchronize()``, plus the numpy coercions
  (``np.asarray``/``array``/``concatenate``/``stack``/``copy`` through
  a numpy alias) that drag a device value to the host. A CUDA graph's
  ``replay()`` is asynchronous and is not a sync.
* ``hotpath-io``: ``open``/``print``, ``.read``/``.write``/
  ``.readline``/socket sends, ``urllib``/``subprocess``/``pickle``/
  ``shutil`` calls.
* ``hotpath-lazy-import``: an ``import`` executed inside a reachable
  function body (the import machinery takes a process-wide lock).
* ``hotpath-unbounded-growth``: a reachable method grows a ``self``
  container of a class that never shrinks that field anywhere and
  declares no bound (``deque(maxlen=...)``).
* ``hotpath-lock-held-dispatch``: a call made while holding an
  analyzer-known lock whose callee TRANSITIVELY blocks or syncs: every
  thread contending that lock stalls for the full round trip.

Deliberate exceptions live in :data:`HOTPATH_ALLOWLIST` (keyed
``"Func:offender"``, each entry with its comment); functions in
:data:`HOTPATH_COLD` are rare-by-design paths the walk does not enter
(at most once per failure or violation, never per request).

**2. Atomic-publication safety.** Fields read LOCK-FREE on the request
path are declared with
:func:`~keystone_tpu_torch.utils.guarded.published_by`:
``unpublished-write`` is a mutation outside the declared lock;
``non-atomic-publication`` a mutation under it that readers can observe
piecewise (augmented assignment, ``.append``/``.update``/``.clear``...:
only a whole rebind, one subscript store or one single-key pop or del is
a reference-atomic flip); ``torn-publication`` one method writing two
published fields in separate statements. Methods named ``*_locked``
count as holding the declared lock.

:func:`scan_source` runs both families over one inline module (the
tests' offender strings). The full-tree scan must finish under
:data:`HOTPATH_SCAN_BUDGET_S`.
"""
from __future__ import annotations

import ast
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from .concurrency import _self_attr, _with_lock_attrs

# -- budgets & declarations --------------------------------------------------

#: wall budget for the full package scan (index + BFS + report);
#: asserted by tests and surfaced by tools/lint.py so static-layer
#: creep shows up in CI output instead of accreting silently
HOTPATH_SCAN_BUDGET_S = 20.0

#: call-graph traversal depth cap from any entry point — deep enough
#: for every real serving chain (the longest today is 6 hops), shallow
#: enough that a resolution bug cannot walk the whole package
MAX_CHAIN_DEPTH = 12

#: deliberate exceptions, keyed ``"Func:offender"`` where ``Func`` is
#: ``Class.method`` or a bare function name and ``offender`` the flagged
#: attribute, name or field. EVERY entry carries a comment saying why
#: the flagged shape is the design.
HOTPATH_ALLOWLIST: FrozenSet[str] = frozenset({
    # the slot gate: backpressure is a counted semaphore by design (a
    # 429 after a bounded, caller-set wait beats an unbounded queue)
    "MicroBatcher.submit_request:acquire",
    # the worker's idle poll: a bounded (50 ms) event wait that runs only
    # when there is nothing to serve; it is how the worker sleeps
    "MicroBatcher.take:wait",
    # the synchronous wrappers ARE a wait by contract: callers that
    # cannot block use submit()/submit_request() and hold the future
    "ServingPlane.predict:result",
    "ServingPlane.predict_traced:result",
    # request rows arrive as host JSON lists or arrays: this coercion is
    # the input copy (the admitted dtype's cast, once per request); a
    # caller that hands in a device tensor is copied once, here
    "_as_host:asarray",
    "_as_host:cpu",
    "_as_host:numpy",
    # the coalesce merge: the members' rows are host numpy until
    # staging, and one concatenate per BATCH is what batching buys its
    # throughput with
    "ServingPlane._serve_batch:concatenate",
    # the pad-to-bucket staging of the CPU plane and of the drift score:
    # the batch is host numpy from the batcher; the tensor branch serves
    # the fit-side callers of bucketed_dataset, never a request
    "_host:asarray",
    "_host:cpu",
    "_host:numpy",
    # the CPU plane's apply (a CUDA plane replays graphs and reaches
    # _eager only at admission): its outputs are CPU tensors, and
    # .numpy() on them is a view
    "ServingPlane._eager:numpy",
    # the poisoned-batch guard runs on the host outputs the replay (or
    # the CPU apply) already returned: a view of host numpy, one
    # vectorized isfinite pass per leaf
    "_count_nonfinite:asarray",
    # reading the POST body is the request (bounded by Content-Length);
    # writing the reply is the respond phase. The router's surface and
    # the HTTP replica transport repeat the pair: reading the replica's
    # reply IS the forwarded request completing
    "ServingHandler.do_POST:read",
    "_JsonReplyHandler._reply:write",
    "RouterHandler.do_POST:read",
    "HttpReplicaClient._request:read",
    # the shared predict path's input coercion: host JSON rows, no
    # device value possible
    "predict_response:asarray",
    # the JSON encoding of the plane's outputs, which are host numpy by
    # contract (BucketGraph.replay and _eager return numpy)
    "_jsonable:tolist",
    # bounded per model by construction (the slowest `cap` traces, the
    # fastest dropped on overflow); one entry per model name, the
    # cardinality the per-model metric families already admit
    "ExemplarReservoir.offer:_by_model",
    "ExemplarReservoir.offer:_floor",
    # one rolling window per model name, each a deque(maxlen=window)
    "SloTracker.record:_windows",
})

#: rare-by-design functions the walk does NOT enter: each entry claims
#: the code runs at most once per violation or failure, never per
#: request. Keys match the allowlist's ``Func`` half.
HOTPATH_COLD: FrozenSet[str] = frozenset({
    # SLO escalation: once per violated window (the window then resets
    # and must re-fill to min_count); writes the post-mortem
    "SloTracker._escalate",
    # drift scoring is a BATCH-level phase run after the batch's futures
    # resolved (every drift_every batches): it adds no request latency
    "ServingPlane._score_drift",
    # the drift-unscorable epilogue: once per model lifetime
    "ServingPlane._disable_drift",
    # a bucket's capture: once per (admission, bucket), at admission or
    # on a steady-state miss the observatory counts as unexpected; a
    # captured bucket is replayed, never captured again
    "ServingPlane._capture",
})

#: publication-pass exceptions, keyed ``"Class.method:field"``; same
#: comment discipline as the hot-path allowlist. Empty: every declared
#: published field currently obeys the flip discipline.
PUBLICATION_ALLOWLIST: FrozenSet[str] = frozenset()


def _allowed(key: str, allowlist: Optional[Iterable[str]]) -> bool:
    return key in (HOTPATH_ALLOWLIST if allowlist is None
                   else frozenset(allowlist))


# -- hazard tables -----------------------------------------------------------

#: attribute calls that block the calling thread, any receiver
_BLOCKING_ATTRS = {"wait", "join", "sleep", "result"}

#: semaphore constructors: ``self.<attr>.acquire`` blocks as
#: backpressure when <attr> was assigned one of these
_SEM_CTORS = {"Semaphore", "BoundedSemaphore", "TracedSemaphore"}

#: lock constructors whose ``with self.<attr>`` holds count as critical
#: sections for the lock-held-dispatch pass (semaphores excluded:
#: holding a slot is not a critical section)
_HELD_CTORS = {"Lock", "RLock", "TracedLock", "Condition"}

#: attribute calls that synchronize host and device: the tensor host
#: reads, and ``synchronize`` on ``torch.cuda``, a stream or an event
_HOST_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize"}

#: numpy-module functions that coerce (possibly device) values to host
_NP_SYNC_FUNCS = {"asarray", "array", "concatenate", "stack", "copy"}

#: attribute calls that perform I/O, any receiver
_IO_ATTRS = {"read", "write", "readline", "readinto", "recv", "send",
             "sendall", "urlopen"}

#: module-receiver I/O: ``<alias>.<attr>`` where the alias imports one
#: of these modules
_IO_MODULES = {
    "pickle": {"load", "loads", "dump", "dumps"},
    "subprocess": {"run", "Popen", "call", "check_call", "check_output"},
    "urllib.request": {"urlopen", "urlretrieve"},
    "socket": {"create_connection"},
    "shutil": {"copy", "copyfile", "copytree", "move", "rmtree"},
}

#: container-growth calls (superset of the concurrency pass's mutators,
#: minus the RNG draws — drawing a sample allocates nothing lasting)
_GROW_METHODS = {"append", "appendleft", "add", "insert", "extend",
                 "update", "setdefault"}

#: shrink operations that bound a field (a class that pops/clears a
#: container somewhere has a drain path; one that never does, grows
#: forever)
_SHRINK_METHODS = {"pop", "popleft", "popitem", "clear", "remove",
                   "discard"}

#: arguments to these attribute calls are DEFERRED thunks, not hot-path
#: code: ``FlightRecorder.defer`` materializes them at flush points
#: (idle worker, scrape surface) — the serving plane's documented
#: off-the-hot-path channel
_DEFER_SINKS = {"defer"}

_EXEMPT_METHODS = {"__init__", "__new__", "__del__", "__init_subclass__"}


# -- package index -----------------------------------------------------------

@dataclass
class _Class:
    name: str
    module: str
    node: ast.ClassDef
    bases: List[str] = field(default_factory=list)
    methods: Dict[str, ast.FunctionDef] = field(default_factory=dict)
    #: self attr -> constructor simple name (TracedSemaphore, Event, ...)
    attr_ctor: Dict[str, str] = field(default_factory=dict)
    #: self attr -> (module, class) for package-resolved receivers
    attr_class: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    #: fields with a shrink op anywhere in the class
    shrunk: Set[str] = field(default_factory=set)
    #: fields constructed with an explicit bound (deque(maxlen=...))
    bounded: Set[str] = field(default_factory=set)


@dataclass
class _Module:
    name: str
    path: Optional[Path]
    tree: ast.Module
    is_pkg: bool = False
    imports: Dict[str, str] = field(default_factory=dict)
    functions: Dict[str, ast.FunctionDef] = field(default_factory=dict)
    classes: Dict[str, _Class] = field(default_factory=dict)


FuncId = Tuple[str, str]  # (module dotted name, "Class.method" | "func")


def _to_host(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` (a literal host
    device)."""
    args = list(call.args[:1]) + [kw.value for kw in call.keywords
                                  if kw.arg == "device"]
    return any(isinstance(a, ast.Constant) and a.value == "cpu"
               for a in args)


def _ctor_simple_name(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    return getattr(f, "id", None)


def _ann_class_name(ann) -> Optional[str]:
    """Class simple name out of an annotation: ``X``, ``Optional[X]``,
    or ``"X"`` (string literal). Multi-parameter generics resolve to
    None — ``Dict[str, X]`` types the mapping, not the attribute."""
    if isinstance(ann, ast.Name):
        return ann.id
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value
    if isinstance(ann, ast.Subscript) and isinstance(ann.value, ast.Name) \
            and ann.value.id == "Optional":
        return _ann_class_name(ann.slice)
    return None


class _Package:
    """The cross-module index the reachability pass resolves against."""

    def __init__(self):
        self.modules: Dict[str, _Module] = {}
        #: class simple name -> (module, name); names are unique in
        #: this tree — a collision keeps the first and the resolver
        #: simply fails closed for the shadowed one
        self.class_names: Dict[str, Tuple[str, str]] = {}
        self.funcs: Dict[FuncId, ast.FunctionDef] = {}
        self.func_cls: Dict[FuncId, Optional[_Class]] = {}
        self.entries: List[FuncId] = []

    # -- construction -------------------------------------------------------
    def add_module(self, name: str, tree: ast.Module,
                   path: Optional[Path] = None,
                   is_pkg: bool = False) -> None:
        mod = _Module(name=name, path=path, tree=tree, is_pkg=is_pkg)
        self._collect_imports(mod)
        for node in tree.body:
            if isinstance(node, ast.FunctionDef):
                mod.functions[node.name] = node
            elif isinstance(node, ast.ClassDef):
                mod.classes[node.name] = self._index_class(mod, node)
        self.modules[name] = mod

    def _collect_imports(self, mod: _Module) -> None:
        pkg_parts = mod.name.split(".")
        if not mod.is_pkg:
            pkg_parts = pkg_parts[:-1]
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    mod.imports[local] = alias.name
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    strip = node.level - 1
                    base_parts = pkg_parts[:len(pkg_parts) - strip] \
                        if strip else list(pkg_parts)
                    base = ".".join(base_parts + (
                        node.module.split(".") if node.module else []))
                else:
                    base = node.module or ""
                for alias in node.names:
                    local = alias.asname or alias.name
                    mod.imports[local] = (f"{base}.{alias.name}"
                                          if base else alias.name)

    def _index_class(self, mod: _Module, node: ast.ClassDef) -> _Class:
        cls = _Class(name=node.name, module=mod.name, node=node)
        for base in node.bases:
            bname = base.attr if isinstance(base, ast.Attribute) \
                else getattr(base, "id", None)
            if bname:
                cls.bases.append(bname)
        for item in node.body:
            if isinstance(item, ast.FunctionDef):
                cls.methods[item.name] = item
            elif isinstance(item, ast.AnnAssign) and \
                    isinstance(item.target, ast.Name):
                cname = _ann_class_name(item.annotation)
                if cname:
                    cls.attr_class[item.target.id] = ("?", cname)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and \
                    isinstance(sub.value, ast.Call):
                ctor = _ctor_simple_name(sub.value)
                for t in sub.targets:
                    attr = _self_attr(t)
                    if attr is None or ctor is None:
                        continue
                    cls.attr_ctor.setdefault(attr, ctor)
                    if ctor == "deque" and any(
                            kw.arg == "maxlen" for kw in sub.value.keywords):
                        cls.bounded.add(attr)
            elif isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr in _SHRINK_METHODS:
                attr = _self_attr(sub.func.value)
                if attr is not None:
                    cls.shrunk.add(attr)
            elif isinstance(sub, ast.Delete):
                for t in sub.targets:
                    if isinstance(t, ast.Subscript):
                        attr = _self_attr(t.value)
                        if attr is not None:
                            cls.shrunk.add(attr)
        return cls

    def finish(self) -> None:
        """Resolve cross-module references once every module is in."""
        for mod in self.modules.values():
            for cname in mod.classes:
                self.class_names.setdefault(cname, (mod.name, cname))
        for mod in self.modules.values():
            for fname, fdef in mod.functions.items():
                fid = (mod.name, fname)
                self.funcs[fid] = fdef
                self.func_cls[fid] = None
                if self._is_entry(fdef):
                    self.entries.append(fid)
            for cls in mod.classes.values():
                for attr, (m, cname) in list(cls.attr_class.items()):
                    if m == "?":
                        hit = self._resolve_class(mod, cname)
                        if hit is None:
                            del cls.attr_class[attr]
                        else:
                            cls.attr_class[attr] = hit
                for attr, ctor in cls.attr_ctor.items():
                    hit = self._resolve_class(mod, ctor)
                    if hit is not None:
                        cls.attr_class.setdefault(attr, hit)
                for mname, meth in cls.methods.items():
                    fid = (mod.name, f"{cls.name}.{mname}")
                    self.funcs[fid] = meth
                    self.func_cls[fid] = cls
                    if self._is_entry(meth):
                        self.entries.append(fid)

    @staticmethod
    def _is_entry(fdef: ast.FunctionDef) -> bool:
        for dec in fdef.decorator_list:
            name = dec.attr if isinstance(dec, ast.Attribute) \
                else getattr(dec, "id", None)
            if name == "hotpath":
                return True
        return False

    # -- resolution ---------------------------------------------------------
    def _resolve_class(self, mod: _Module,
                       name: str) -> Optional[Tuple[str, str]]:
        if name in mod.classes:
            return (mod.name, name)
        dotted = mod.imports.get(name)
        if dotted is not None:
            head, _, tail = dotted.rpartition(".")
            target = self.modules.get(head)
            for _ in range(4):  # follow package __init__ re-exports
                if target is None:
                    break
                if tail in target.classes:
                    return (target.name, tail)
                nxt = target.imports.get(tail)
                if nxt is None:
                    break
                head, _, tail = nxt.rpartition(".")
                target = self.modules.get(head)
        return self.class_names.get(name) if name in self.class_names \
            else None

    def _resolve_func_name(self, mod: _Module,
                           name: str) -> Optional[FuncId]:
        """A bare ``name(...)`` call: same-module function, imported
        function, or imported class constructor (-> its __init__)."""
        if name in mod.functions:
            return (mod.name, name)
        if name in mod.classes:
            return self._class_init((mod.name, name))
        dotted = mod.imports.get(name)
        if dotted is None:
            return None
        head, _, tail = dotted.rpartition(".")
        target = self.modules.get(head)
        for _ in range(4):  # follow package __init__ re-exports
            if target is None:
                return None
            if tail in target.functions:
                return (target.name, tail)
            if tail in target.classes:
                return self._class_init((target.name, tail))
            nxt = target.imports.get(tail)
            if nxt is None:
                return None
            head, _, tail = nxt.rpartition(".")
            target = self.modules.get(head)
        return None

    def _class_init(self, cls_id: Tuple[str, str]) -> Optional[FuncId]:
        return self.find_method(cls_id, "__init__")

    def find_method(self, cls_id: Tuple[str, str],
                    mname: str) -> Optional[FuncId]:
        """Method lookup through the static MRO (bounded)."""
        seen = 0
        queue = [cls_id]
        while queue and seen < 8:
            seen += 1
            module, cname = queue.pop(0)
            mod = self.modules.get(module)
            cls = mod.classes.get(cname) if mod else None
            if cls is None:
                continue
            if mname in cls.methods:
                return (module, f"{cname}.{mname}")
            for bname in cls.bases:
                hit = self._resolve_class(mod, bname)
                if hit is not None:
                    queue.append(hit)
        return None


# -- per-function analysis ---------------------------------------------------

@dataclass
class _FuncReport:
    """One reachable function's raw findings (allowlist applied at
    report time so fixtures and the tree share one engine)."""

    fid: FuncId
    edges: List[FuncId] = field(default_factory=list)
    #: (lineno, code, offender, description)
    hazards: List[Tuple[int, str, str, str]] = field(default_factory=list)
    #: (lineno, callee fid, callee display, lock attr) — resolved calls
    #: made while holding a known lock
    locked_calls: List[Tuple[int, FuncId, str, str]] = \
        field(default_factory=list)
    #: this function directly blocks or syncs (pre-allowlist) — the
    #: seed for the transitive lock-held-dispatch summary
    syncs: bool = False


def _display(fid: FuncId) -> str:
    return fid[1]


def _analyze_function(pkg: _Package, mod: _Module, cls: Optional[_Class],
                      fid: FuncId, fdef: ast.FunctionDef) -> _FuncReport:
    rep = _FuncReport(fid=fid)
    held_attrs = set()
    if cls is not None:
        held_attrs = {a for a, c in cls.attr_ctor.items()
                      if c in _HELD_CTORS}

    def hazard(lineno: int, code: str, offender: str, desc: str) -> None:
        rep.hazards.append((lineno, code, offender, desc))
        if code in ("hotpath-blocking", "hotpath-host-sync"):
            rep.syncs = True

    def imports_numpy(rid: str) -> bool:
        return rid in ("np", "numpy") or mod.imports.get(rid) == "numpy"

    def handle_call(call: ast.Call, held: FrozenSet[str]) -> None:
        f = call.func
        callee: Optional[FuncId] = None
        label = ""
        if isinstance(f, ast.Name):
            label = f.id
            if f.id == "open":
                hazard(call.lineno, "hotpath-io", "open",
                       "opens a file")
            elif f.id == "print":
                hazard(call.lineno, "hotpath-io", "print",
                       "writes to stdout (line-buffered console I/O)")
            else:
                callee = pkg._resolve_func_name(mod, f.id)
        elif isinstance(f, ast.Attribute):
            attr = f.attr
            base = f.value
            label = attr
            recv_attr = _self_attr(base)
            if isinstance(base, ast.Name) and base.id == "self":
                # self.m(...): a method of this class (or a base)
                if cls is not None:
                    callee = pkg.find_method((cls.module, cls.name), attr)
                label = f"{cls.name}.{attr}" if cls else attr
            elif recv_attr is not None and cls is not None:
                # self.x.m(...): typed through the ctor assignment
                ctor = cls.attr_ctor.get(recv_attr)
                if attr == "acquire" and ctor in _SEM_CTORS:
                    hazard(call.lineno, "hotpath-blocking", "acquire",
                           f"blocks on semaphore `self.{recv_attr}`")
                target_cls = cls.attr_class.get(recv_attr)
                if target_cls is not None:
                    callee = pkg.find_method(target_cls, attr)
                    label = f"{target_cls[1]}.{attr}"
            elif isinstance(base, ast.Name):
                rid = base.id
                dotted = mod.imports.get(rid)
                if imports_numpy(rid) and attr in _NP_SYNC_FUNCS:
                    hazard(call.lineno, "hotpath-host-sync", attr,
                           f"coerces through `{rid}.{attr}` — a device "
                           "value here silently syncs and copies "
                           "across the host link")
                mod_io = _IO_MODULES.get(dotted or rid)
                if mod_io and attr in mod_io:
                    hazard(call.lineno, "hotpath-io", attr,
                           f"calls `{rid}.{attr}`")
                if dotted in pkg.modules:
                    target = pkg.modules[dotted]
                    if attr in target.functions:
                        callee = (dotted, attr)
                    elif attr in target.classes:
                        callee = pkg._class_init((dotted, attr))
                if callee is None:
                    cls_hit = pkg._resolve_class(mod, rid)
                    if cls_hit is not None:
                        callee = pkg.find_method(cls_hit, attr)
                        label = f"{cls_hit[1]}.{attr}"
            if attr in _BLOCKING_ATTRS:
                hazard(call.lineno, "hotpath-blocking", attr,
                       f"calls blocking `{attr}()`")
            if attr in _HOST_SYNC_ATTRS:
                hazard(call.lineno, "hotpath-host-sync", attr,
                       f"calls `{attr}()` — a host-device round trip")
            if attr == "to" and _to_host(call):
                hazard(call.lineno, "hotpath-host-sync", "to",
                       "calls `.to(\"cpu\")` — a device-to-host copy")
            if attr in _IO_ATTRS:
                hazard(call.lineno, "hotpath-io", attr,
                       f"calls `.{attr}()`")
            if attr in ("get", "put") and isinstance(base, ast.Name) \
                    and (base.id == "q" or "queue" in base.id.lower()):
                hazard(call.lineno, "hotpath-blocking", attr,
                       f"blocks on `{base.id}.{attr}()`")
        if callee is not None:
            rep.edges.append(callee)
            if held:
                lock = sorted(held)[0]
                rep.locked_calls.append(
                    (call.lineno, callee, label, lock))

    def handle_growth(node, held: FrozenSet[str]) -> None:
        if cls is None:
            return
        growths: List[Tuple[int, str]] = []
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    a = _self_attr(t.value)
                    if a is not None:
                        growths.append((node.lineno, a))
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _GROW_METHODS:
            a = _self_attr(node.func.value)
            if a is not None:
                growths.append((node.lineno, a))
        for lineno, a in growths:
            if a in cls.shrunk or a in cls.bounded:
                continue
            hazard(lineno, "hotpath-unbounded-growth", a,
                   f"grows `self.{a}` — and {cls.name} never shrinks "
                   "it anywhere (no pop/del/clear) nor declares a "
                   "bound (deque(maxlen=...)): admit/evict or "
                   "per-model churn turns this into a leak")

    def visit(node, held: FrozenSet[str]) -> None:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            hazard(node.lineno, "hotpath-lazy-import", "import",
                   "executes an import in the function body — the "
                   "import machinery takes a process-wide lock and "
                   "does dict/filesystem work per execution; hoist it "
                   "to module level")
            return
        if isinstance(node, ast.With):
            acquired = frozenset(a for a in _with_lock_attrs(node)
                                 if a in held_attrs)
            for item in node.items:
                visit(item.context_expr, held)
            for stmt in node.body:
                visit(stmt, held | acquired)
            return
        if isinstance(node, ast.Call):
            handle_call(node, held)
            handle_growth(node, held)
            f = node.func
            visit(f, held)
            deferred = isinstance(f, ast.Attribute) \
                and f.attr in _DEFER_SINKS
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if deferred and isinstance(arg, (ast.Lambda,
                                                 ast.FunctionDef)):
                    continue  # deferred thunk: off the hot path
                visit(arg, held)
            return
        if isinstance(node, ast.Assign):
            handle_growth(node, held)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: runs inline on this path (tree_map leaves,
            # staging closures) — scanned in the same hot context
            for stmt in node.body:
                visit(stmt, held)
            return
        elif isinstance(node, ast.Lambda):
            visit(node.body, held)
            return
        elif isinstance(node, ast.ClassDef):
            return
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for stmt in fdef.body:
        visit(stmt, frozenset())
    return rep


# -- reachability + reporting ------------------------------------------------

_HAZARD_VERB = {
    "hotpath-blocking": "a blocking primitive",
    "hotpath-host-sync": "a host-device sync",
    "hotpath-io": "I/O",
    "hotpath-lazy-import": "an import",
    "hotpath-unbounded-growth": "unbounded growth",
}


def _chain(parents: Dict[FuncId, Optional[FuncId]], fid: FuncId) -> str:
    path = [fid]
    seen = {fid}
    while parents.get(path[-1]) is not None:
        nxt = parents[path[-1]]
        if nxt in seen:
            break
        path.append(nxt)
        seen.add(nxt)
    return " -> ".join(_display(p) for p in reversed(path))


def hotpath_hazards(
    pkg: _Package,
    allowlist: Optional[Iterable[str]] = None,
    cold: Optional[Iterable[str]] = None,
) -> List[Tuple[str, int, str, str]]:
    """BFS the call graph from the declared entry points and classify
    every reachable call; returns ``(module, lineno, code, message)``
    tuples. ``allowlist``/``cold`` default to the module-level tables
    (tests override both)."""
    cold_set = HOTPATH_COLD if cold is None else frozenset(cold)
    reports: Dict[FuncId, _FuncReport] = {}
    parents: Dict[FuncId, Optional[FuncId]] = {}
    depth: Dict[FuncId, int] = {}
    queue = deque()
    for fid in pkg.entries:
        if fid not in parents:
            parents[fid] = None
            depth[fid] = 0
            queue.append(fid)
    while queue:
        fid = queue.popleft()
        fdef = pkg.funcs.get(fid)
        mod = pkg.modules.get(fid[0])
        if fdef is None or mod is None:
            continue
        rep = _analyze_function(pkg, mod, pkg.func_cls.get(fid),
                                fid, fdef)
        reports[fid] = rep
        if depth[fid] >= MAX_CHAIN_DEPTH:
            continue
        for callee in rep.edges:
            if callee in parents or _display(callee) in cold_set:
                continue
            if callee not in pkg.funcs:
                continue
            parents[callee] = fid
            depth[callee] = depth[fid] + 1
            queue.append(callee)

    # transitive blocks/syncs summary for the lock-held-dispatch pass
    sync_memo: Dict[FuncId, bool] = {}

    def transitively_syncs(fid: FuncId, stack: Set[FuncId]) -> bool:
        if fid in sync_memo:
            return sync_memo[fid]
        if fid in stack:
            return False
        rep = reports.get(fid)
        if rep is None:
            return False
        if rep.syncs:
            sync_memo[fid] = True
            return True
        stack.add(fid)
        out = any(transitively_syncs(c, stack) for c in rep.edges
                  if _display(c) not in cold_set)
        stack.discard(fid)
        sync_memo[fid] = out
        return out

    hits: List[Tuple[str, int, str, str]] = []
    seen: Set[Tuple[str, int, str, str]] = set()
    for fid, rep in sorted(reports.items()):
        where = _display(fid)
        chain = _chain(parents, fid)
        for lineno, code, offender, desc in rep.hazards:
            if _allowed(f"{where}:{offender}", allowlist):
                continue
            key = (fid[0], lineno, code, offender)
            if key in seen:
                continue
            seen.add(key)
            verb = _HAZARD_VERB.get(code, "a hazard")
            hits.append((
                fid[0], lineno, code,
                f"{where} is on the serving hot path ({chain}) and "
                f"{desc} — {verb} costs every request that takes this "
                "chain its p99; move it off the request path or "
                "allowlist with a comment (analysis/hotpath.py)"))
        for lineno, callee, label, lock in rep.locked_calls:
            if not transitively_syncs(callee, set()):
                continue
            if _allowed(f"{where}:{label}", allowlist):
                continue
            key = (fid[0], lineno, "hotpath-lock-held-dispatch", label)
            if key in seen:
                continue
            seen.add(key)
            hits.append((
                fid[0], lineno, "hotpath-lock-held-dispatch",
                f"{where} ({chain}) calls `{label}` — which "
                "transitively blocks or syncs with the device — while "
                f"holding `self.{lock}`: every thread contending that "
                "lock stalls for the full device round trip. Release "
                "the lock before dispatching, or allowlist with a "
                "comment (analysis/hotpath.py)"))
    return sorted(hits)


# -- pass 2: atomic publication ----------------------------------------------

def published_classes(tree: ast.Module) -> Dict[str, Dict[str, str]]:
    """``{class name: {field: lock_attr}}`` for every class declaring a
    ``@published_by("lock", "field", ...)`` publication discipline."""
    out: Dict[str, Dict[str, str]] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        pmap: Dict[str, str] = {}
        for dec in node.decorator_list:
            if not isinstance(dec, ast.Call):
                continue
            fname = (dec.func.attr if isinstance(dec.func, ast.Attribute)
                     else getattr(dec.func, "id", ""))
            if fname != "published_by" or not dec.args:
                continue
            vals = [a.value for a in dec.args
                    if isinstance(a, ast.Constant)
                    and isinstance(a.value, str)]
            if len(vals) >= 2:
                pmap.update({f: vals[0] for f in vals[1:]})
        if pmap:
            out[node.name] = pmap
    return out


#: in-place mutators lock-free readers can observe piecewise — never a
#: reference-atomic flip (``pop`` is exempt: a single-key removal is
#: one dict-slot write, same atomicity as ``del d[k]``)
_NON_ATOMIC_METHODS = (_GROW_METHODS | {"clear", "remove", "discard",
                                        "popitem", "extend", "insert",
                                        "sort", "reverse"}) - {"pop"}


def published_field_hazards(
    tree: ast.Module,
    allowlist: Optional[Iterable[str]] = None,
) -> List[Tuple[int, str, str]]:
    """``(lineno, code, description)`` for publication-discipline
    violations on ``@published_by`` classes: ``unpublished-write``
    (mutation outside the declared lock), ``non-atomic-publication``
    (an in-place mutation readers observe piecewise), and
    ``torn-publication`` (one method flips two or more published fields
    in separate statements — lock-free readers can see version skew).
    Methods named ``*_locked`` are treated as holding the declared
    lock; ``__init__``/``__new__`` are exempt (the object is not
    shared yet)."""
    allow = (PUBLICATION_ALLOWLIST if allowlist is None
             else frozenset(allowlist))
    hits: List[Tuple[int, str, str]] = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        pmap = published_classes(tree).get(cls.name)
        if not pmap:
            continue
        locks = set(pmap.values())
        for meth in cls.body:
            if not isinstance(meth, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                    or meth.name in _EXEMPT_METHODS:
                continue
            base_held = frozenset(locks) if meth.name.endswith("_locked") \
                else frozenset()
            written: Dict[str, int] = {}

            def note_write(field: str, lineno: int) -> None:
                written.setdefault(field, lineno)

            def flag(lineno: int, code: str, field: str,
                     desc: str) -> None:
                if f"{cls.name}.{meth.name}:{field}" in allow:
                    return
                hits.append((lineno, code, desc))

            def scan(stmts, held: FrozenSet[str]) -> None:
                for stmt in stmts:
                    if isinstance(stmt, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        continue
                    if isinstance(stmt, ast.With):
                        scan(stmt.body,
                             held | frozenset(_with_lock_attrs(stmt)))
                        continue
                    check(stmt, held)
                    for name in ("body", "orelse", "finalbody"):
                        block = getattr(stmt, name, None)
                        if block:
                            scan(block, held)
                    for h in getattr(stmt, "handlers", ()):
                        scan(h.body, held)

            def check(stmt, held: FrozenSet[str]) -> None:
                for sub in ast.walk(stmt):
                    f = None
                    lineno = getattr(sub, "lineno", stmt.lineno)
                    atomic = True
                    kind = ""
                    if isinstance(sub, ast.Assign):
                        for t in sub.targets:
                            if isinstance(t, ast.Subscript):
                                f = _self_attr(t.value)
                                kind = "item store"
                            else:
                                f = _self_attr(t)
                                kind = "rebind"
                            if f in pmap:
                                self_check(f, lineno, held, True, kind)
                        continue
                    if isinstance(sub, ast.AugAssign):
                        t = sub.target
                        f = _self_attr(t) or (
                            _self_attr(t.value)
                            if isinstance(t, ast.Subscript) else None)
                        atomic, kind = False, "augmented assignment"
                    elif isinstance(sub, ast.Call) and isinstance(
                            sub.func, ast.Attribute) and \
                            sub.func.attr in _NON_ATOMIC_METHODS:
                        f = _self_attr(sub.func.value)
                        atomic = False
                        kind = f".{sub.func.attr}()"
                    elif isinstance(sub, ast.Call) and isinstance(
                            sub.func, ast.Attribute) and \
                            sub.func.attr == "pop":
                        f = _self_attr(sub.func.value)
                        kind = ".pop()"
                    elif isinstance(sub, ast.Delete):
                        for t in sub.targets:
                            if isinstance(t, ast.Subscript):
                                f = _self_attr(t.value)
                                if f in pmap:
                                    self_check(f, lineno, held, True,
                                               "del item")
                        continue
                    if f in pmap:
                        self_check(f, lineno, held, atomic, kind)

            def self_check(f: str, lineno: int, held: FrozenSet[str],
                           atomic: bool, kind: str) -> None:
                note_write(f, lineno)
                lock = pmap[f]
                if lock not in held:
                    flag(lineno, "unpublished-write", f,
                         f"{cls.name}.{meth.name} mutates published "
                         f"field '{f}' ({kind}) outside `with "
                         f"self.{lock}`: the field is read LOCK-FREE "
                         "on the hot path, so every write must be an "
                         "atomic flip under the declared lock "
                         "(@published_by, utils/guarded.py)")
                elif not atomic:
                    flag(lineno, "non-atomic-publication", f,
                         f"{cls.name}.{meth.name} mutates published "
                         f"field '{f}' in place ({kind}): lock-free "
                         "readers observe the mutation piecewise. "
                         "Build the new value fresh and publish it "
                         "with ONE rebind (`self.{0} = new`)".format(f))

            scan(meth.body, base_held)
            if len(written) >= 2:
                fields = sorted(written)
                if not any(f"{cls.name}.{meth.name}:{f}" in allow
                           for f in fields):
                    hits.append((
                        min(written.values()), "torn-publication",
                        f"{cls.name}.{meth.name} writes published "
                        f"fields {fields} in separate statements: a "
                        "lock-free reader between the writes observes "
                        "version skew (field one new, field two "
                        "stale). Fold the state into one object and "
                        "flip a single reference, or allowlist with a "
                        "comment (analysis/hotpath.py)"))
    return sorted(set(hits))


# -- package scan (tools/lint.py + `check` + the gates) ----------------------

def build_package(pkg_root) -> _Package:
    """Index every module under ``pkg_root`` (syntax errors are
    skipped here — the concurrency scan reports them)."""
    pkg_root = Path(pkg_root)
    pkg = _Package()
    for path in sorted(pkg_root.rglob("*.py")):
        rel = path.relative_to(pkg_root.parent).with_suffix("")
        parts = list(rel.parts)
        is_pkg = parts[-1] == "__init__"
        if is_pkg:
            parts = parts[:-1]
        try:
            tree = ast.parse(path.read_text())
        except SyntaxError:
            continue
        pkg.add_module(".".join(parts), tree, path=path, is_pkg=is_pkg)
    pkg.finish()
    return pkg


def scan_package(pkg_root) -> List[Dict[str, object]]:
    """Both pass families over a package tree; returns
    ``[{file, lineno, code, message}]`` (the ``tools/lint.py`` /
    ``check --json`` shape). Hot-path hazards run over the
    interprocedural graph; the publication pass runs per module (it
    fires only on ``@published_by`` classes)."""
    pkg_root = Path(pkg_root)
    pkg = build_package(pkg_root)
    mod_file = {m.name: str(m.path.relative_to(pkg_root.parent))
                for m in pkg.modules.values() if m.path is not None}
    out: List[Dict[str, object]] = []
    for module, lineno, code, msg in hotpath_hazards(pkg):
        out.append({"file": mod_file.get(module, module),
                    "lineno": lineno, "code": code, "message": msg})
    for mod in sorted(pkg.modules.values(), key=lambda m: m.name):
        for lineno, code, msg in published_field_hazards(mod.tree):
            out.append({"file": mod_file.get(mod.name, mod.name),
                        "lineno": lineno, "code": code, "message": msg})
    return out


def scan_source(source: str, modname: str = "fixture",
                allowlist: Optional[Iterable[str]] = None,
                cold: Optional[Iterable[str]] = None,
                ) -> List[Tuple[int, str, str]]:
    """One self-contained module (fixtures, tests): entry points come
    from its own ``@hotpath`` decorations; returns
    ``(lineno, code, message)`` tuples from BOTH pass families."""
    tree = ast.parse(source)
    pkg = _Package()
    pkg.add_module(modname, tree)
    pkg.finish()
    hits = [(lineno, code, msg) for _, lineno, code, msg
            in hotpath_hazards(pkg, allowlist=allowlist, cold=cold)]
    hits.extend(published_field_hazards(tree, allowlist=allowlist))
    return sorted(hits)
