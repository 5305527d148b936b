"""Concurrency-safety static passes: guarded-by races, lock order,
blocking-under-lock, and non-atomic guarded sequences.

Counterpart of ``keystone_tpu/analysis/concurrency.py``, over the port's
tree. The lock discipline is *declared* (``utils/guarded.py``: the
``@guarded_by`` class decorator plus the ``GUARDED_FIELDS`` table) and
three pass families check the declaration against the source, in
textual order per function scope. False positives break a gate on
legitimate code, so the rules are conservative and every deliberate
exception lives in the commented :data:`CONCURRENCY_ALLOWLIST`.

* **guarded-by race** (``guarded-field-race``): a read-modify-write
  (``self.count += 1``, ``self.stats[k] = self.stats.get(k) + 1``) or a
  compound mutation (``self._tail.append``, ``del self._tail[:n]``, an
  RNG draw) of a declared-guarded field outside a ``with self.<lock>``
  scope, in any method of the owning class (``__init__``/``__new__``
  are exempt: the object is not shared yet). Plain rebinds are not
  flagged.
* **lock order + blocking-under-lock**: a static lock-acquisition graph
  from ``with``-nesting (plus one call hop into same-module functions
  and methods: ``f()``, ``self.m()`` of the same class, ``obj.m()`` of
  another class of the module). A cycle is a deadlock waiting for its schedule
  (``lock-order-cycle``); a blocking call made while holding an
  analyzer-known lock stalls every sibling of that lock for the
  duration (``blocking-under-lock``). Blocking means a thread wait
  (``queue.get``, ``Event.wait``, ``join``, ``future.result``,
  ``sleep``) or a device wait: ``synchronize`` on a stream, an event or
  ``torch.cuda``, and the host reads ``.item()``, ``.cpu()``,
  ``.tolist()`` and ``.numpy()`` (the table ``analysis/diagnostics.py``
  uses for the host-sync lint).
* **non-atomic guarded sequence** (``non-atomic-guarded-sequence``): a
  check-then-act on a guarded field split across two ``with <same
  lock>`` blocks in one function: the read in block one is stale by the
  time block two writes.

``python -m keystone_tpu_torch.tools.lint`` enforces all three
tree-wide (blocking and order scoped by :data:`CONCURRENCY_SCOPES`);
``python -m keystone_tpu_torch check`` folds :func:`scan_package` into
its report.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from ..utils.guarded import GUARDED_FIELDS
from .diagnostics import _HOST_READ_METHODS

# -- scopes & allowlist ------------------------------------------------------

#: directories (under ``keystone_tpu_torch/``) where the lock-order and
#: blocking-under-lock passes apply: the subsystems that own threads
#: and locks. The guarded-by and sequence passes run tree-wide — they
#: only fire on classes that *declared* a discipline.
CONCURRENCY_SCOPES = (
    "loaders", "observability", "parallel", "resilience", "serving",
    "utils", "workflow",
)

#: deliberate exceptions; every entry needs a comment saying WHY the
#: flagged shape is safe (an entry is a debt, not a convention). Keys:
#:   guarded-field-race / non-atomic-guarded-sequence:
#:       "Class.method:field"
#:   blocking-under-lock: "function_or_Class.method:callee_attr"
#: Empty: every finding on the port's tree was fixed.
CONCURRENCY_ALLOWLIST: FrozenSet[str] = frozenset()


def _allowed(key: str, allowlist: Optional[Iterable[str]] = None) -> bool:
    return key in (CONCURRENCY_ALLOWLIST if allowlist is None
                   else frozenset(allowlist))


# -- declarations off the AST ------------------------------------------------

def guarded_classes(
    tree: ast.Module, extra: Optional[Dict[str, Dict[str, str]]] = None
) -> Dict[str, Dict[str, str]]:
    """``{class name: {field: lock_attr}}`` for every class in ``tree``
    that declares a lock discipline — via a ``@guarded_by("lock",
    "field", ...)`` decorator or an entry in ``extra`` (defaults to
    :data:`~keystone_tpu_torch.utils.guarded.GUARDED_FIELDS`)."""
    extra = GUARDED_FIELDS if extra is None else extra
    out: Dict[str, Dict[str, str]] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        gmap: Dict[str, str] = dict(extra.get(node.name, {}))
        for dec in node.decorator_list:
            if not isinstance(dec, ast.Call):
                continue
            fname = (dec.func.attr if isinstance(dec.func, ast.Attribute)
                     else getattr(dec.func, "id", ""))
            if fname != "guarded_by" or not dec.args:
                continue
            vals = []
            for a in dec.args:
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    vals.append(a.value)
            if len(vals) >= 2:
                gmap.update({f: vals[0] for f in vals[1:]})
        if gmap:
            out[node.name] = gmap
    return out


# -- shared walk helpers -----------------------------------------------------

#: method names whose call on a guarded field is a compound mutation
#: (containers + the numpy RandomState draws the retry/fault layers
#: share across threads)
_MUTATING_METHODS = {
    "append", "extend", "insert", "add", "update", "remove", "discard",
    "pop", "popitem", "clear", "setdefault",
    "rand", "randn", "randint", "choice", "shuffle", "permutation",
}

_EXEMPT_METHODS = {"__init__", "__new__", "__del__", "__init_subclass__"}


def _self_attr(node) -> Optional[str]:
    """``attr`` when ``node`` is ``self.<attr>``, else None."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _with_lock_attrs(stmt: ast.With) -> Set[str]:
    """Lock ATTR names (``self.<attr>``) acquired by one with statement."""
    out = set()
    for item in stmt.items:
        attr = _self_attr(item.context_expr)
        if attr is not None:
            out.add(attr)
    return out


def _field_mutations(node, fields: Iterable[str]):
    """Yield ``(lineno, field, kind)`` for every read-modify-write or
    compound mutation of ``self.<field>`` inside ``node`` (one leaf
    statement or header expression — callers handle statement
    structure)."""
    fields = set(fields)
    for sub in ast.walk(node):
        if isinstance(sub, ast.AugAssign):
            t = sub.target
            f = _self_attr(t) or (
                _self_attr(t.value) if isinstance(t, ast.Subscript)
                else None)
            if f in fields:
                yield sub.lineno, f, "read-modify-write"
        elif isinstance(sub, ast.Assign):
            targets = []
            for t in sub.targets:
                targets.extend(t.elts if isinstance(t, ast.Tuple) else [t])
            for t in targets:
                if isinstance(t, ast.Subscript):
                    f = _self_attr(t.value)
                    if f in fields:
                        yield sub.lineno, f, "item assignment"
                else:
                    f = _self_attr(t)
                    if f in fields and any(
                            _self_attr(r) == f
                            for r in ast.walk(sub.value)):
                        yield sub.lineno, f, "read-modify-write"
        elif isinstance(sub, ast.Call) and isinstance(
                sub.func, ast.Attribute):
            if sub.func.attr in _MUTATING_METHODS:
                f = _self_attr(sub.func.value)
                if f in fields:
                    yield sub.lineno, f, f".{sub.func.attr}()"
        elif isinstance(sub, ast.Delete):
            for t in sub.targets:
                if isinstance(t, ast.Subscript):
                    f = _self_attr(t.value)
                    if f in fields:
                        yield sub.lineno, f, "del item"


def _field_reads(node, fields: Iterable[str]) -> Set[str]:
    fields = set(fields)
    out = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and isinstance(
                sub.ctx, ast.Load):
            f = _self_attr(sub)
            if f in fields:
                out.add(f)
    return out


_HEADER_FIELDS = {
    ast.If: ("test",), ast.While: ("test",), ast.For: ("target", "iter"),
    ast.AsyncFor: ("target", "iter"), ast.Return: ("value",),
    ast.Raise: ("exc", "cause"), ast.Assert: ("test", "msg"),
}


def _iter_bodies(stmt):
    """Child statement lists of a compound statement."""
    for name in ("body", "orelse", "finalbody"):
        block = getattr(stmt, name, None)
        if block:
            yield block
    for h in getattr(stmt, "handlers", ()):
        yield h.body


# -- pass 1: guarded-by race -------------------------------------------------

def guarded_field_races(
    tree: ast.Module,
    extra: Optional[Dict[str, Dict[str, str]]] = None,
    allowlist: Optional[Iterable[str]] = None,
) -> List[tuple]:
    """``(lineno, code, description)`` for every RMW/compound mutation
    of a declared-guarded field outside its lock (see module
    docstring)."""
    hits: List[tuple] = []
    classes = guarded_classes(tree, extra)
    if not classes:
        return hits
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef) or cls.name not in classes:
            continue
        gmap = classes[cls.name]

        def scan(stmts, held: FrozenSet[str], mname: str):
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    continue  # nested def: runs later, its own scope
                if isinstance(stmt, ast.With):
                    for item in stmt.items:
                        check(item.context_expr, held, mname)
                    scan(stmt.body,
                         held | frozenset(_with_lock_attrs(stmt)), mname)
                    continue
                for fname in _HEADER_FIELDS.get(type(stmt), ()):
                    sub = getattr(stmt, fname, None)
                    if sub is not None:
                        check(sub, held, mname)
                if isinstance(stmt, (ast.Assign, ast.AugAssign,
                                     ast.AnnAssign, ast.Expr,
                                     ast.Delete)):
                    check(stmt, held, mname)
                for block in _iter_bodies(stmt):
                    scan(block, held, mname)

        def check(node, held: FrozenSet[str], mname: str):
            for lineno, field, kind in _field_mutations(node, gmap):
                lock = gmap[field]
                if lock in held:
                    continue
                if _allowed(f"{cls.name}.{mname}:{field}", allowlist):
                    continue
                hits.append((
                    lineno, "guarded-field-race",
                    f"{cls.name}.{mname} mutates guarded field "
                    f"'{field}' ({kind}) outside `with self.{lock}` — "
                    "the declared lock discipline says worker threads "
                    "share this field; take the lock or allowlist with "
                    "a comment (analysis/concurrency.py)"))

        for meth in cls.body:
            if not isinstance(meth, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if meth.name in _EXEMPT_METHODS:
                continue
            scan(meth.body, frozenset(), meth.name)
    return sorted(set(hits))


# -- pass 2: lock order + blocking-under-lock --------------------------------

_LOCK_CTORS = {"Lock", "RLock", "TracedLock", "Semaphore",
               "BoundedSemaphore", "TracedSemaphore", "Condition"}

#: attribute calls that block the calling thread: thread waits, and the
#: device waits (``synchronize`` on a stream, an event or ``torch.cuda``,
#: and the host reads of a tensor)
_BLOCKING_ATTRS = ({"wait", "join", "result", "sleep", "synchronize"}
                   | _HOST_READ_METHODS)


def _lock_ctor_name(call) -> bool:
    if not isinstance(call, ast.Call):
        return False
    f = call.func
    name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
    return name in _LOCK_CTORS


def known_locks(
    tree: ast.Module, extra: Optional[Dict[str, Dict[str, str]]] = None
) -> Tuple[Set[str], Dict[str, Set[str]]]:
    """Analyzer-known lock identities in one module: module-level
    ``NAME = threading.Lock()``-style globals, plus per-class ``self.X =
    Lock()`` attributes and every guard attr a class declared."""
    mod_locks: Set[str] = set()
    cls_locks: Dict[str, Set[str]] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and _lock_ctor_name(node.value):
            mod_locks.add(node.targets[0].id)
    declared = guarded_classes(tree, extra)
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        attrs: Set[str] = set(declared.get(cls.name, {}).values())
        for sub in ast.walk(cls):
            if isinstance(sub, ast.Assign) and _lock_ctor_name(sub.value):
                for t in sub.targets:
                    a = _self_attr(t)
                    if a is not None:
                        attrs.add(a)
        if attrs:
            cls_locks[cls.name] = attrs
    return mod_locks, cls_locks


class _LockWalk:
    """Shared held-lock walker for the order and blocking passes."""

    def __init__(self, tree: ast.Module, module: str,
                 extra: Optional[Dict[str, Dict[str, str]]] = None):
        self.module = module
        self.mod_locks, self.cls_locks = known_locks(tree, extra)
        self.edges: List[tuple] = []   # (holder, acquired, lineno, where)
        self.blocking: List[tuple] = []
        # (class or None, function name) -> lock ids acquired directly in
        # its body (the one-hop budget for cross-function acquisition)
        self.direct: Dict[Tuple[Optional[str], str], Set[str]] = {}
        self._collect_direct(tree)
        self._walk_tree(tree)

    # lock identity: "module.NAME" for globals, "Class.attr" for attrs
    def _lock_ids(self, stmt: ast.With, clsname: Optional[str]
                  ) -> List[str]:
        ids = []
        for item in stmt.items:
            e = item.context_expr
            attr = _self_attr(e)
            if attr is not None and clsname is not None \
                    and attr in self.cls_locks.get(clsname, ()):
                ids.append(f"{clsname}.{attr}")
            elif isinstance(e, ast.Name) and e.id in self.mod_locks:
                ids.append(f"{self.module}.{e.id}")
        return ids

    def _collect_direct(self, tree):
        # keyed (class or None, name): a method's locks are reached only
        # through a call that can be that method (see _one_call)
        def record(fdef, clsname):
            acquired: Set[str] = set()
            for sub in ast.walk(fdef):
                if isinstance(sub, ast.With):
                    acquired.update(self._lock_ids(sub, clsname))
            if acquired:
                key = (clsname, fdef.name)
                self.direct[key] = self.direct.get(key, set()) | acquired

        for node in tree.body:
            if isinstance(node, ast.FunctionDef):
                record(node, None)
            elif isinstance(node, ast.ClassDef):
                for meth in node.body:
                    if isinstance(meth, ast.FunctionDef):
                        record(meth, node.name)

    def _walk_tree(self, tree):
        for node in tree.body:
            if isinstance(node, ast.FunctionDef):
                self._walk(node.body, frozenset(), None, node.name)
            elif isinstance(node, ast.ClassDef):
                for meth in node.body:
                    if isinstance(meth, ast.FunctionDef):
                        self._walk(meth.body, frozenset(), node.name,
                                   f"{node.name}.{meth.name}")

    def _walk(self, stmts, held: FrozenSet[str],
              clsname: Optional[str], where: str):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested def: separate scope, runs later
            if isinstance(stmt, ast.With):
                ids = self._lock_ids(stmt, clsname)
                for h in held:
                    for i in ids:
                        self.edges.append((h, i, stmt.lineno, where))
                if held:
                    for item in stmt.items:
                        for call in ast.walk(item.context_expr):
                            if isinstance(call, ast.Call):
                                self._one_call(call, held, clsname, where)
                self._walk(stmt.body, held | frozenset(ids), clsname,
                           where)
                continue
            if held:
                self._check_calls(stmt, held, clsname, where)
            for block in _iter_bodies(stmt):
                self._walk(block, held, clsname, where)

    def _check_calls(self, stmt, held: FrozenSet[str],
                     clsname: Optional[str], where: str):
        # only this statement's own expressions (headers for compound
        # statements, everything for leaves) — child statement LISTS
        # are walked separately with the same held set, so each call is
        # seen exactly once
        for sub in ast.iter_child_nodes(stmt):
            if isinstance(sub, (ast.stmt, ast.excepthandler)):
                continue
            for call in ast.walk(sub):
                if isinstance(call, ast.Call):
                    self._one_call(call, held, clsname, where)

    def _callee_locks(self, f, clsname: Optional[str]) -> Set[str]:
        """Locks a same-module callee acquires directly: ``f()`` is the
        module function ``f``, ``self.m()`` this class's method ``m``,
        and ``obj.m()`` a method ``m`` of ANOTHER class of the module (a
        method of this class is reached through ``self``; an attribute
        object such as ``self.ledger`` is not this class)."""
        if isinstance(f, ast.Name):
            return self.direct.get((None, f.id), set())
        if not isinstance(f, ast.Attribute):
            return set()
        if isinstance(f.value, ast.Name) and f.value.id == "self":
            return self.direct.get((clsname, f.attr), set())
        out: Set[str] = set()
        for (owner, fname), locks in self.direct.items():
            if owner is not None and owner != clsname and fname == f.attr:
                out |= locks
        return out

    def _one_call(self, call: ast.Call, held: FrozenSet[str],
                  clsname: Optional[str], where: str):
        f = call.func
        attr = f.attr if isinstance(f, ast.Attribute) else None
        # one call hop: a same-module function/method that acquires
        # locks directly, called while holding one
        for lock in self._callee_locks(f, clsname):
            for h in held:
                if h != lock:
                    self.edges.append((h, lock, call.lineno, where))
        if attr is None:
            return
        blocking = attr in _BLOCKING_ATTRS or (
            attr in ("get", "put")
            and isinstance(f.value, ast.Name)
            and (f.value.id == "q" or "queue" in f.value.id.lower()))
        if blocking:
            self.blocking.append((call.lineno, attr, where, held))


def lock_order_edges(
    tree: ast.Module, module: str = "<module>",
    extra: Optional[Dict[str, Dict[str, str]]] = None,
) -> List[tuple]:
    """``(held, acquired, lineno, where)`` acquisition-order edges from
    ``with``-nesting (plus one same-module call hop)."""
    return _LockWalk(tree, module, extra).edges


def blocking_under_lock(
    tree: ast.Module, module: str = "<module>",
    extra: Optional[Dict[str, Dict[str, str]]] = None,
    allowlist: Optional[Iterable[str]] = None,
) -> List[tuple]:
    """``(lineno, code, description)`` for blocking calls made while an
    analyzer-known lock is held."""
    walk = _LockWalk(tree, module, extra)
    hits = []
    for lineno, attr, where, held in walk.blocking:
        if _allowed(f"{where}:{attr}", allowlist):
            continue
        locks = ", ".join(sorted(held))
        hits.append((
            lineno, "blocking-under-lock",
            f"{where} calls blocking `{attr}()` while holding "
            f"{locks}: every thread contending that lock stalls for "
            "the full wait (and a cross-thread dependency deadlocks). "
            "Move the blocking call outside the critical section, or "
            "allowlist with a comment (analysis/concurrency.py)"))
    return sorted(set(hits))


def find_lock_cycles(edges: Iterable[tuple]) -> List[tuple]:
    """Cycles in the acquisition graph: each is ``(path, description)``
    where path is the lock-id cycle (first == last). Two threads taking
    the same locks in cycle order deadlock."""
    adj: Dict[str, Dict[str, tuple]] = {}
    for a, b, lineno, where in edges:
        if a != b:
            adj.setdefault(a, {}).setdefault(b, (lineno, where))
    cycles: List[tuple] = []
    seen_sets: Set[FrozenSet[str]] = set()

    def dfs(start, node, path):
        for nxt in sorted(adj.get(node, ())):
            if nxt == start:
                key = frozenset(path)
                if key not in seen_sets:
                    seen_sets.add(key)
                    cyc = path + [start]
                    sites = " ; ".join(
                        f"{p}->{q} at {adj[p][q][1]}:{adj[p][q][0]}"
                        for p, q in zip(cyc, cyc[1:]))
                    cycles.append((tuple(cyc), sites))
            elif nxt not in path and nxt > start:
                # canonical start = smallest id: each cycle found once
                dfs(start, nxt, path + [nxt])

    for n in sorted(adj):
        dfs(n, n, [n])
    return cycles


# -- pass 3: non-atomic guarded sequence -------------------------------------

def guarded_sequence_hazards(
    tree: ast.Module,
    extra: Optional[Dict[str, Dict[str, str]]] = None,
    allowlist: Optional[Iterable[str]] = None,
) -> List[tuple]:
    """``(lineno, code, description)`` for check-then-act sequences on a
    guarded field split across two ``with <same lock>`` blocks in one
    method: block one reads the field, the lock is released, block two
    mutates it — the read is stale by the write (see module
    docstring)."""
    hits: List[tuple] = []
    classes = guarded_classes(tree, extra)
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef) or cls.name not in classes:
            continue
        gmap = classes[cls.name]
        for meth in cls.body:
            if not isinstance(meth, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                    or meth.name in _EXEMPT_METHODS:
                continue
            withs = []
            for sub in ast.walk(meth):
                if isinstance(sub, ast.With):
                    locks = _with_lock_attrs(sub) & set(gmap.values())
                    if locks:
                        withs.append((sub, locks))
            for i, (w1, locks1) in enumerate(withs):
                for w2, locks2 in withs[i + 1:]:
                    shared = locks1 & locks2
                    if not shared:
                        continue
                    end1 = getattr(w1, "end_lineno", w1.lineno)
                    if w2.lineno <= end1:
                        continue  # nested/overlapping: not a sequence
                    fields = {f for f, lk in gmap.items() if lk in shared}
                    read1 = _field_reads(w1, fields)
                    wrote2 = {f for _, f, _ in
                              _field_mutations(w2, fields)}
                    for f in sorted(read1 & wrote2):
                        if _allowed(f"{cls.name}.{meth.name}:{f}",
                                    allowlist):
                            continue
                        hits.append((
                            w2.lineno, "non-atomic-guarded-sequence",
                            f"{cls.name}.{meth.name} reads guarded "
                            f"field '{f}' in one `with "
                            f"self.{gmap[f]}` block (line {w1.lineno}) "
                            f"and mutates it in a second (line "
                            f"{w2.lineno}): the lock is released in "
                            "between, so the check is stale by the "
                            "act. Merge the blocks so the lock spans "
                            "the decision, or allowlist with a comment"))
    return sorted(set(hits))


# -- package scan (tools/lint.py + `check`) ----------------------------------

def scan_package(pkg_root) -> List[Dict[str, object]]:
    """Run all three pass families over a package tree; returns
    ``[{file, lineno, code, message}]``. Guarded-by and sequence passes
    run tree-wide (they fire only on declared classes); lock-order and
    blocking-under-lock are scoped by :data:`CONCURRENCY_SCOPES`, and
    the acquisition graph is cycle-checked ACROSS modules (a deadlock
    needs two sites, usually in two files)."""
    pkg_root = Path(pkg_root)
    out: List[Dict[str, object]] = []
    all_edges: List[tuple] = []
    edge_files: Dict[str, str] = {}
    for path in sorted(pkg_root.rglob("*.py")):
        rel = path.relative_to(pkg_root.parent)
        try:
            tree = ast.parse(path.read_text())
        except SyntaxError as exc:
            out.append({"file": str(rel), "lineno": exc.lineno or 0,
                        "code": "syntax-error", "message": str(exc)})
            continue
        for lineno, code, msg in guarded_field_races(tree):
            out.append({"file": str(rel), "lineno": lineno,
                        "code": code, "message": msg})
        for lineno, code, msg in guarded_sequence_hazards(tree):
            out.append({"file": str(rel), "lineno": lineno,
                        "code": code, "message": msg})
        parts = rel.parts
        scoped = len(parts) >= 2 and parts[1] in CONCURRENCY_SCOPES
        if scoped:
            module = ".".join(rel.with_suffix("").parts)
            for lineno, code, msg in blocking_under_lock(tree, module):
                out.append({"file": str(rel), "lineno": lineno,
                            "code": code, "message": msg})
            edges = lock_order_edges(tree, module)
            all_edges.extend(edges)
            for a, b, lineno, where in edges:
                edge_files.setdefault(f"{a}->{b}", str(rel))
    for path_cycle, sites in find_lock_cycles(all_edges):
        first = edge_files.get(f"{path_cycle[0]}->{path_cycle[1]}", "?")
        out.append({
            "file": first, "lineno": 0, "code": "lock-order-cycle",
            "message": ("lock acquisition cycle "
                        + " -> ".join(path_cycle)
                        + f" ({sites}): two threads taking these locks "
                        "in cycle order deadlock; pick one global "
                        "order and stick to it")})
    return out
