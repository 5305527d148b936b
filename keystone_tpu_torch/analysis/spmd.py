"""SPMD-safety static passes over the port's own collective sites.

Counterpart of ``keystone_tpu/analysis/spmd.py``. The port writes its
collectives out on ``torch.distributed`` (``parallel/distributed.py``),
one process per GPU, so a single rank-divergent branch around a
collective is a distributed hang: every other rank waits in an
unmatched gather until its timeout. These passes make the SPMD contract
a statically checked property, in the textual-order-per-scope style of
the concurrency passes (one call hop, conservative rules, every
deliberate exception in the commented :data:`SPMD_ALLOWLIST`).

What counts as a collective: the ``torch.distributed`` calls
(``all_gather``, ``all_reduce``, ``all_gather_object``, ``barrier``,
``broadcast`` and the rest, the generic names only on a ``dist`` /
``torch.distributed`` receiver), the port's deterministic helpers
(``world_gather``, ``world_sum``, ``world_scalar_sum``,
``world_concat``), and the ``WorldCoordinator`` methods on a
``world`` / ``coord`` receiver.

Five pass families:

* **collective-divergence**: a collective reachable under rank-divergent
  control flow, a branch or loop bound whose condition derives from the
  divergence seeds (``process_index()``, the ``process_id`` / ``pid``
  spellings) or a local they flow into. World-uniform conditions
  (``process_count() > 1``, a round's gathered result) never taint.
  Per-rank state not derived from the rank id (a shard's chunk count) is
  beyond the seeds: the fixed-round ``WorldCoordinator`` covers it.
* **unstable-barrier-name / non-fixed-coordination-shape**: a
  ``world.barrier(...)`` name that is not a string literal (two ranks
  computing different names meet in different barriers), and a gather
  payload whose shape derives from shard-local data (ranks whose shapes
  differ fail or wedge inside the gather).
* **sharding-flow**: the spec-level lattice seeded from
  ``DatasetSpec.sharded`` (:func:`sharding_flow_lint`: a rank-local
  stream collapsed into a resident dataset or datum, or zipped with a
  non-sharded input), and the AST half, ``unbound-collective-axis``: an
  axis name passed to ``world_sum`` / ``world_concat`` that no mesh in
  the module binds.
* **world-checkpoint consistency**: rank-0-only effects on the shared
  snapshot (``merge_hosts``, ``clear``) must be barrier-paired, and a
  restored checkpoint carry must re-enter the device through
  ``restore_carry``.
* **unawaited-collective**: every ``world.step_begin`` handle reaches
  exactly one ``world.step_await``; a pending handle's ``result`` is not
  read before it.

``python -m keystone_tpu_torch check`` folds :func:`scan_package` into
its report (the ``spmd`` key) and ``tools/lint.py`` runs it tree-wide;
the fixtures in ``tests/test_torch_spmd.py`` pin each rule's firing
shape.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

# -- allowlist ---------------------------------------------------------------

#: deliberate exceptions — every entry needs a comment saying WHY the
#: flagged shape is safe (a bare entry in a review is a finding, not a
#: suppression). Format: "function_or_Class.method:offender", where
#: offender is the collective/barrier/effect name the rule reports.
SPMD_ALLOWLIST: FrozenSet[str] = frozenset({
    # The overlapped round loop merges WITHOUT barriers on purpose:
    # ordering comes from the round gather itself. A rank renames its
    # sidecar (atomic os.replace) BEFORE dispatching the round that
    # reports its cursor in the (1, 4) payload, and rank 0 calls
    # merge_hosts only after AWAITING a round in which every rank
    # reported a durable sidecar: the collective is the happens-before
    # a barrier pair would provide, at no extra collective. The 'after'
    # side is unnecessary because peers never READ the world snapshot
    # during a fit (only a relaunched world does, and the atomic rename
    # means it sees the old or the new complete snapshot, never torn).
    "fit_streaming:merge_hosts",
})


def _allowed(key: str, allowlist: Optional[Iterable[str]] = None) -> bool:
    return key in (SPMD_ALLOWLIST if allowlist is None
                   else frozenset(allowlist))


# -- what counts as a collective ---------------------------------------------

#: collective call names specific enough to count on any receiver: the
#: torch.distributed collectives with distinctive names and the port's
#: deterministic helpers (parallel/distributed.py)
_COLLECTIVE_CALLS = frozenset({
    "all_gather", "all_reduce", "all_gather_into_tensor",
    "all_gather_object", "all_to_all", "all_to_all_single",
    "reduce_scatter", "reduce_scatter_tensor", "monitored_barrier",
    "broadcast_object_list", "gather_object", "scatter_object_list",
    "world_gather", "world_sum", "world_scalar_sum", "world_concat",
})

#: generic names that are collectives only on a ``dist`` /
#: ``torch.distributed`` receiver (``x.gather(...)`` is a tensor op)
_QUALIFIED_COLLECTIVES = frozenset({
    "barrier", "broadcast", "gather", "scatter", "reduce", "send", "recv",
})

_DIST_RECEIVERS = frozenset({"dist", "distributed"})

#: WorldCoordinator methods that are collectives, recognized at call
#: sites by the receiver-name convention (the round loop binds its
#: coordinator as `world`/`coord`)
_COLLECTIVE_METHODS = frozenset({
    "step", "step_begin", "step_await", "barrier", "merge_carries",
    "merge_baselines",
})

_COORDINATOR_RECEIVERS = ("world", "coord")


def _call_name(call: ast.Call) -> str:
    f = call.func
    return f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")


def _direct_collective(call: ast.Call) -> bool:
    """A direct collective call: a distinctive name, or a generic one on
    a ``dist`` / ``torch.distributed`` receiver."""
    name = _call_name(call)
    if name in _COLLECTIVE_CALLS:
        return True
    if name in _QUALIFIED_COLLECTIVES and isinstance(call.func,
                                                      ast.Attribute):
        recv = call.func.value
        rname = recv.id if isinstance(recv, ast.Name) else (
            recv.attr if isinstance(recv, ast.Attribute) else "")
        return rname in _DIST_RECEIVERS
    return False


def _is_coordinator_receiver(call: ast.Call) -> bool:
    f = call.func
    if not isinstance(f, ast.Attribute):
        return False
    recv = f.value
    name = recv.id if isinstance(recv, ast.Name) else (
        recv.attr if isinstance(recv, ast.Attribute) else "")
    return any(name.startswith(p) for p in _COORDINATOR_RECEIVERS)


def collective_call_name(call: ast.Call,
                         one_hop: FrozenSet[str] = frozenset()
                         ) -> Optional[str]:
    """The collective this call performs, or None: a direct collective,
    a ``world.<coordination method>`` call, or (one call hop) a
    same-module function whose body performs one directly."""
    name = _call_name(call)
    if _direct_collective(call):
        return name
    if name in _COLLECTIVE_METHODS and _is_coordinator_receiver(call):
        return name
    if name in one_hop:
        return name
    return None


def collective_carriers(tree: ast.Module) -> FrozenSet[str]:
    """Names of module-level functions (and methods) whose body makes a
    DIRECT collective call — the one-call-hop budget: calling one of
    these under a divergent branch diverges the collective exactly as
    if it were inlined (the same transitive budget the concurrency
    passes use)."""
    out: Set[str] = set()

    def record(fdef):
        for sub in ast.walk(fdef):
            if isinstance(sub, ast.Call) and _direct_collective(sub):
                out.add(fdef.name)
                return

    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            record(node)
        elif isinstance(node, ast.ClassDef):
            for meth in node.body:
                if isinstance(meth, ast.FunctionDef):
                    record(meth)
    return frozenset(out)


# -- host-divergence taint ---------------------------------------------------

#: calls whose RESULT differs per host (the taint seeds). process_count
#: / is_distributed are deliberately absent: world size is UNIFORM —
#: `if nproc > 1:` gates collectives on every host together, which is
#: the safe idiom, not a hazard.
_DIVERGENT_CALLS = frozenset({"process_index"})

#: name/attribute spellings that carry a per-host value by convention
#: (WorldCoordinator.pid, the worker argv process_id)
_DIVERGENT_NAMES = frozenset({"process_id", "pid"})


def _expr_divergent(node, tainted: Set[str]) -> bool:
    """True when an expression's value can differ across hosts: it
    reads a divergence seed or a tainted local."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            if _call_name(sub) in _DIVERGENT_CALLS:
                return True
        elif isinstance(sub, ast.Name):
            if sub.id in tainted or sub.id in _DIVERGENT_NAMES:
                return True
        elif isinstance(sub, ast.Attribute):
            if sub.attr in _DIVERGENT_NAMES:
                return True
    return False


def _launders_divergence(node) -> bool:
    """True when an expression routes through a collective: the RESULT
    of ``world.step`` / ``world_gather`` / ``merge_carries`` is
    REPLICATED across hosts by construction — exchanging per-host
    values for the world view is what those calls are for — so an
    assignment from one is world-uniform even when its arguments were
    per-host. (Re-indexing a gathered array with a per-host index
    re-diverges, and the seed scan catches that read directly.)"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and (
                _direct_collective(sub)
                or (_call_name(sub) in _COLLECTIVE_METHODS
                    and _is_coordinator_receiver(sub))):
            return True
    return False


def _store_names(target) -> List[str]:
    return [n.id for n in ast.walk(target)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)]


def _assign_taint(stmt: ast.Assign, tainted: Set[str]) -> None:
    """Propagate per-host taint through one assignment, element-wise
    for matching tuple-to-tuple binds (``pid, nproc = process_index(),
    process_count()`` must taint only ``pid``). A rebind from a
    uniform expression — including a collective's replicated result
    (:func:`_launders_divergence`) — KILLS the taint (the
    textual-order discipline all the passes here share; conditional
    kills are re-joined across branches by the scanner)."""
    if len(stmt.targets) == 1 and isinstance(stmt.targets[0], ast.Tuple) \
            and isinstance(stmt.value, ast.Tuple) \
            and len(stmt.targets[0].elts) == len(stmt.value.elts):
        for t, v in zip(stmt.targets[0].elts, stmt.value.elts):
            div = _expr_divergent(v, tainted) and not \
                _launders_divergence(v)
            for name in _store_names(t):
                (tainted.add if div else tainted.discard)(name)
        return
    div = _expr_divergent(stmt.value, tainted) and not \
        _launders_divergence(stmt.value)
    for t in stmt.targets:
        for name in _store_names(t):
            (tainted.add if div else tainted.discard)(name)


def _walrus_taint(node, tainted: Set[str]) -> None:
    """``(rank := process_index())`` binds inside an expression: taint
    the walrus target like any other assignment."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.NamedExpr) and isinstance(
                sub.target, ast.Name):
            div = _expr_divergent(sub.value, tainted) and not \
                _launders_divergence(sub.value)
            (tainted.add if div else tainted.discard)(sub.target.id)


def _stmt_taint(stmt, tainted: Set[str]) -> None:
    """Taint fold for one binding statement: plain assigns (with the
    element-wise tuple rule), annotated assigns, and augmented assigns
    (``x += seed`` taints; an AugAssign never kills — the old value
    survives in the new one). Walrus binds anywhere in the statement
    fold too."""
    if isinstance(stmt, ast.Assign):
        _assign_taint(stmt, tainted)
    elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
        div = _expr_divergent(stmt.value, tainted) and not \
            _launders_divergence(stmt.value)
        for name in _store_names(stmt.target):
            (tainted.add if div else tainted.discard)(name)
    elif isinstance(stmt, ast.AugAssign):
        if _expr_divergent(stmt.value, tainted) and not \
                _launders_divergence(stmt.value):
            for name in _store_names(stmt.target):
                tainted.add(name)
    _walrus_taint(stmt, tainted)


def _condition_src(node) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - very old AST shapes
        return "<condition>"


def _own_walk(root):
    """Walk ``root`` WITHOUT descending into nested function defs: each
    nested def is its own scope, enumerated (and scanned) separately by
    :func:`_scopes` — the same boundary rule the donation and
    cast-before-transfer passes use."""
    stack = [root]
    while stack:
        node = stack.pop()
        if node is not root and isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _scopes(tree: ast.Module):
    """The scopes of :func:`_walk_scopes`, listed once per module node
    (every pass walks them)."""
    cached = getattr(tree, "_spmd_scopes", None)
    if cached is None:
        cached = list(_walk_scopes(tree))
        tree._spmd_scopes = cached
    return cached


def _walk_scopes(tree: ast.Module):
    """``(qualname, scope node)`` for EVERY scope in the module: the
    module top level itself (``<module>`` — script-style worker bodies
    execute collectives at import time), module-level functions,
    methods, and nested defs at any depth (the streaming hot path is
    closure-heavy: ``produce``, ``put``, ``accumulate_one`` must not
    escape the scan). Qualnames join with dots, so allowlist keys
    address nested scopes as ``outer.inner``."""
    yield "<module>", tree
    def recurse(fdef, prefix):
        name = f"{prefix}{fdef.name}"
        yield name, fdef
        # nested defs: _own_walk stops at them, so each is discovered
        # exactly once, from its direct parent node
        for sub in _own_walk(fdef):
            for child in ast.iter_child_nodes(sub):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    yield from recurse(child, f"{name}.")

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield from recurse(node, "")
        elif isinstance(node, ast.ClassDef):
            for meth in node.body:
                if isinstance(meth, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    yield from recurse(meth, f"{node.name}.")


# -- pass 1: collective divergence -------------------------------------------

def collective_divergence(
    tree: ast.Module, allowlist: Optional[Iterable[str]] = None,
) -> List[tuple]:
    """``(lineno, code, description)`` for every collective/barrier
    site reachable under host-divergent control flow (see module
    docstring). Scoped per function, textual order; nested defs are
    separate scopes enumerated by :func:`_scopes` (they run later,
    under their caller's control flow, which this engine cannot see —
    each closure is scanned with its own fresh taint)."""
    hits: List[tuple] = []
    one_hop = collective_carriers(tree)

    def check_stmt(stmt, tainted: Set[str], where: str,
                   condition: Optional[str]):
        if condition is None:
            return
        for sub in ast.walk(stmt):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return  # nested scope boundary inside this statement
            if not isinstance(sub, ast.Call):
                continue
            coll = collective_call_name(sub, one_hop)
            if coll is None:
                continue
            if _allowed(f"{where}:{coll}", allowlist):
                continue
            hits.append((
                sub.lineno, "collective-divergence",
                f"{where} reaches collective `{coll}` under the "
                f"rank-divergent condition `{condition}`: ranks where "
                "the branch goes the other way never match this "
                "collective, and the rest of the world waits in it "
                "until the collective timeout. Hoist the collective "
                "out of the "
                "branch, gate on a world-uniform value, or allowlist "
                "with a comment (analysis/spmd.py)"))

    def scan(stmts, tainted: Set[str], where: str,
             condition: Optional[str]):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested def: its own scope, scanned separately
            if isinstance(stmt, (ast.Assign, ast.AnnAssign,
                                 ast.AugAssign)):
                check_stmt(stmt, tainted, where, condition)
                _stmt_taint(stmt, tainted)
                continue
            if isinstance(stmt, ast.If):
                check_stmt(stmt.test, tainted, where, condition)
                _walrus_taint(stmt.test, tainted)
                cond = condition
                if _expr_divergent(stmt.test, tainted):
                    cond = _condition_src(stmt.test)
                # path-sensitive join: a kill inside one branch must not launder the fall-through path —
                # each branch folds a copy, and a name stays tainted
                # after the If when ANY path leaves it tainted
                t_body, t_else = set(tainted), set(tainted)
                scan(stmt.body, t_body, where, cond)
                scan(stmt.orelse, t_else, where, cond)
                tainted.clear()
                tainted.update(t_body | t_else)
                continue
            if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
                header = stmt.test if isinstance(stmt, ast.While) \
                    else stmt.iter
                check_stmt(header, tainted, where, condition)
                _walrus_taint(header, tainted)
                cond = condition
                if _expr_divergent(header, tainted):
                    # a seed-derived iteration count (range(pid), a
                    # local the process index flowed into) diverges
                    # collectives inside the loop exactly like a branch
                    cond = _condition_src(header)
                # the body may run zero times: join body-out with the
                # in-state instead of folding in place
                t_body = set(tainted)
                scan(stmt.body, t_body, where, cond)
                tainted.update(t_body)
                scan(stmt.orelse, tainted, where, cond)
                continue
            check_stmt(stmt, tainted, where, condition)
            _walrus_taint(stmt, tainted)
            # try/with blocks may be entered partially: join each
            # block's out-state with the in-state (kills stay local)
            outs = []
            for name in ("body", "orelse", "finalbody"):
                block = getattr(stmt, name, None)
                if block:
                    t = set(tainted)
                    scan(block, t, where, condition)
                    outs.append(t)
            for h in getattr(stmt, "handlers", ()):
                t = set(tainted)
                scan(h.body, t, where, condition)
                outs.append(t)
            for t in outs:
                tainted.update(t)

    for where, fdef in _scopes(tree):
        scan(fdef.body, set(), where, None)
    return sorted(set(hits))


# -- pass 2: barrier-name / coordination-shape stability ---------------------

#: constructors whose result length is data-dependent: a payload built
#: from one of these has a per-host shape
_DYNAMIC_BUILDERS = frozenset({"list", "sorted", "set", "tuple"})

#: numpy-ish array constructors a dynamic container flows through on
#: its way to the wire
_ARRAY_CTORS = frozenset({"array", "asarray", "stack", "concatenate",
                          "frombuffer", "zeros", "ones", "empty", "full",
                          "tensor", "as_tensor", "cat"})

#: gather collectives and the position of their payload argument
_GATHER_PAYLOAD = {"all_gather": 1, "all_gather_object": 1,
                   "all_gather_into_tensor": 1, "world_gather": 0,
                   "world_sum": 0, "world_scalar_sum": 0,
                   "world_concat": 0}


def _is_dynamic_expr(v, dynamic: Set[str], tainted: Set[str]) -> bool:
    if isinstance(v, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
        return True
    if isinstance(v, ast.Call):
        name = _call_name(v)
        if name in _DYNAMIC_BUILDERS:
            return True
        if name in _ARRAY_CTORS and v.args:
            first = v.args[0]
            if isinstance(first, (ast.ListComp, ast.SetComp,
                                  ast.GeneratorExp)):
                return True
            if isinstance(first, ast.Name) and first.id in dynamic:
                return True
            if _expr_divergent(first, tainted) and name in (
                    "zeros", "ones", "empty", "full"):
                return True  # per-host SIZE -> per-host shape
    if isinstance(v, ast.Name) and v.id in dynamic:
        return True
    return False


def _fold_scope(fdef, upto: Optional[int] = None
                ) -> Tuple[Set[str], Set[str]]:
    """``(dynamic, tainted)`` name sets for one function scope, folded
    in TEXTUAL (line) order up to line ``upto`` (exclusive; None =
    whole scope) — so a rebind from a fixed-shape/uniform expression
    kills an earlier dynamic/tainted mark before a later use, the same
    discipline :func:`_assign_taint` documents. ``dynamic`` holds
    locals bound to a dynamically-sized container (list comp,
    ``list(...)``, an appended-to accumulator, an array built over
    one); ``tainted`` the per-host divergence taint. Nested defs are
    separate scopes (:func:`_own_walk`)."""
    events = []
    for sub in _own_walk(fdef):
        if isinstance(sub, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            events.append((sub.lineno, "bind", sub))
        elif isinstance(sub, ast.NamedExpr):
            events.append((sub.lineno, "walrus", sub))
        elif isinstance(sub, ast.Call) and isinstance(
                sub.func, ast.Attribute) and sub.func.attr in (
                    "append", "extend", "insert") and isinstance(
                    sub.func.value, ast.Name):
            events.append((sub.lineno, "append", sub.func.value.id))
    dynamic: Set[str] = set()
    tainted: Set[str] = set()
    for lineno, kind, payload in sorted(events, key=lambda e: e[0]):
        if upto is not None and lineno >= upto:
            break
        if kind == "append":
            dynamic.add(payload)
            continue
        if kind == "walrus":
            _walrus_taint(payload, tainted)
            if isinstance(payload.target, ast.Name):
                (dynamic.add if _is_dynamic_expr(
                    payload.value, dynamic, tainted)
                 else dynamic.discard)(payload.target.id)
            continue
        _stmt_taint(payload, tainted)
        value = payload.value
        if value is None:  # bare annotation: no bind
            continue
        dyn = _is_dynamic_expr(value, dynamic, tainted)
        targets = (payload.targets if isinstance(payload, ast.Assign)
                   else [payload.target])
        for t in targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name) and isinstance(
                        n.ctx, ast.Store):
                    if isinstance(payload, ast.AugAssign):
                        if dyn:
                            dynamic.add(n.id)  # += never un-marks
                    else:
                        (dynamic.add if dyn else dynamic.discard)(n.id)
    return dynamic, tainted


def barrier_stability(
    tree: ast.Module, allowlist: Optional[Iterable[str]] = None,
) -> List[tuple]:
    """``(lineno, code, description)`` for non-literal barrier tags and
    shard-local-shaped coordination payloads (see module docstring)."""
    hits: List[tuple] = []
    for where, fdef in _scopes(tree):
        for sub in _own_walk(fdef):
            if not isinstance(sub, ast.Call):
                continue
            name = _call_name(sub)
            is_barrier = name == "barrier" and _is_coordinator_receiver(sub)
            # the name may ride positionally or as a keyword
            tags = list(sub.args[:1]) + [
                kw.value for kw in sub.keywords
                if kw.arg in ("name", "tag")]
            for tag in tags if is_barrier else ():
                if not (isinstance(tag, ast.Constant)
                        and isinstance(tag.value, str)):
                    if _allowed(f"{where}:{name}", allowlist):
                        continue
                    hits.append((
                        sub.lineno, "unstable-barrier-name",
                        f"{where} passes a non-literal name to "
                        f"`{name}(...)`: barrier names must be FIXED "
                        "per call site (two ranks computing different "
                        "names meet in different barriers, and the "
                        "span names stop lining up). Use a string "
                        "literal, or allowlist with a comment "
                        "(analysis/spmd.py)"))
            slot = _GATHER_PAYLOAD.get(name)
            if slot is None or not _direct_collective(sub):
                continue
            payloads = list(sub.args[slot:slot + 1]) + [
                kw.value for kw in sub.keywords
                if kw.arg in ("tensor", "obj", "t")]
            if payloads:
                # fold the scope's binds in textual order up to THIS
                # call: a rebind from a fixed-shape expression between
                # a conditional dynamic bind and the gather kills the
                # mark
                dynamic, tainted = _fold_scope(fdef, upto=sub.lineno + 1)
                bad = False
                for arg in payloads:
                    if _is_dynamic_expr(arg, dynamic, tainted):
                        bad = True
                    if isinstance(arg, ast.Call):
                        cname = _call_name(arg)
                        if cname in _ARRAY_CTORS and arg.args and (
                                isinstance(arg.args[0], (
                                    ast.ListComp, ast.SetComp,
                                    ast.GeneratorExp))
                                or (isinstance(arg.args[0], ast.Name)
                                    and arg.args[0].id in dynamic)):
                            bad = True
                if bad and not _allowed(f"{where}:{name}", allowlist):
                    hits.append((
                        sub.lineno, "non-fixed-coordination-shape",
                        f"{where} gathers a payload whose shape "
                        "derives from shard-local data (a dynamically "
                        "sized container): ranks whose shapes differ "
                        "fail or wedge inside the gather. Exchange a "
                        "FIXED-shape summary instead (the "
                        "WorldCoordinator.step `(cursor, done, "
                        "has_carry)` discipline), or allowlist with a "
                        "comment (analysis/spmd.py)"))
    return sorted(set(hits))


# -- pass 3 (AST half): collective axis names vs the mesh in scope -----------

#: axis names the port's meshes bind (parallel/mesh.py DATA_AXIS /
#: MODEL_AXIS)
_CANONICAL_AXES = frozenset({"data", "model"})

#: the port's axis-taking collectives and the position of the axis
_AXIS_COLLECTIVES = {"world_sum": 2, "world_scalar_sum": 2,
                     "world_concat": 2, "group": 0}


def _module_axis_names(tree: ast.Module) -> FrozenSet[str]:
    """Mesh axis names bound in this module: string literals assigned to
    an ``*_AXIS`` name or inside a ``Mesh(...)`` / ``make_mesh(...)``
    call, plus the canonical ('data', 'model') pair."""
    axes: Set[str] = set(_CANONICAL_AXES)
    for sub in ast.walk(tree):
        if isinstance(sub, ast.Assign) and isinstance(
                sub.value, ast.Constant) and isinstance(
                    sub.value.value, str) and any(
                isinstance(t, ast.Name) and t.id.endswith("_AXIS")
                for t in sub.targets):
            axes.add(sub.value.value)
        if isinstance(sub, ast.Call) and _call_name(sub) in (
                "Mesh", "make_mesh"):
            for a in ast.walk(sub):
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    axes.add(a.value)
    return frozenset(axes)


def collective_axis_bindings(tree: ast.Module) -> List[tuple]:
    """``(lineno, code, description)`` for ``world_sum`` /
    ``world_concat`` / ``mesh.group`` calls whose literal axis name no
    mesh of this module binds: the call raises only on the first world
    that runs it, which a one-process test never is."""
    hits: List[tuple] = []
    axes = _module_axis_names(tree)
    for sub in ast.walk(tree):
        if not isinstance(sub, ast.Call):
            continue
        name = _call_name(sub)
        slot = _AXIS_COLLECTIVES.get(name)
        if slot is None:
            continue
        if name == "group" and not (
                isinstance(sub.func, ast.Attribute)
                and "mesh" in ast.unparse(sub.func.value).lower()):
            continue  # only a mesh's group(axis), not re.Match.group
        cands = list(sub.args[slot:slot + 1]) + [
            kw.value for kw in sub.keywords if kw.arg == "axis"]
        for cand in cands:
            if isinstance(cand, ast.Constant) and isinstance(
                    cand.value, str) and cand.value not in axes:
                hits.append((
                    sub.lineno, "unbound-collective-axis",
                    f"`{name}(..., {cand.value!r})` names a mesh axis "
                    "this module never binds (known axes: "
                    f"{', '.join(sorted(axes))}): the call raises on the "
                    "first world that runs it. Use an axis the mesh "
                    "defines (parallel/mesh.py DATA_AXIS/MODEL_AXIS)"))
    return sorted(set(hits))


# -- pass 3 (spec half): sharding-flow graph lint ----------------------------

def sharding_flow_lint(analysis) -> List:
    """Graph diagnostics over the ``DatasetSpec.sharded`` provenance
    lattice (the abstract interpreter propagates ``sharded`` through
    transformer and delegate nodes):

    * ``cross-host-materialization`` (ERROR): a consumer collapses a
      rank-local stream into a resident dataset or a single datum: in a
      world the result holds ONE rank's share of the records, presented
      as the whole. Estimator fits are exempt: the world loop of
      ``fit_streaming`` merges their carries, and a non-streamable
      estimator is already ``non-streamable-fit``.
    * ``implicit-replication`` (WARNING): a consumer zips a sharded
      stream with a non-sharded dataset input: each rank pairs its rows
      against the same rows of the other input. The other input must be
      this rank's matching slice.
    """
    from .interpreter import Diagnostic, SEVERITY_ERROR, SEVERITY_WARNING
    from .spec import DatasetSpec, DatumSpec, TransformerSpec

    graph = analysis.graph
    out: List = []
    for n in sorted(graph.nodes, key=lambda g: g.id):
        deps = graph.get_dependencies(n)
        dep_specs = [analysis.value(d) for d in deps]
        sharded = [d for d in dep_specs
                   if isinstance(d, DatasetSpec) and d.sharded]
        if not sharded:
            continue
        op = graph.get_operator(n)
        spec = analysis.value(n)
        if isinstance(spec, TransformerSpec):
            # estimator fit: the world loop merges the carries, and its
            # labels input follows the shard-local convention the
            # runtime guards (the misaligned-labels raise)
            continue
        if isinstance(spec, DatumSpec) or (
                isinstance(spec, DatasetSpec) and not spec.streaming):
            what = ("a single datum" if isinstance(spec, DatumSpec)
                    else "a resident dataset")
            out.append(Diagnostic(
                code="cross-host-materialization",
                severity=SEVERITY_ERROR, node_id=n.id,
                operator=op.label(),
                message=(
                    f"consumer collapses a rank-local stream into {what}:"
                    " in a world this holds ONE rank's share of the "
                    "records, presented as the whole dataset. Keep the "
                    "computation streaming (the world loop merges the "
                    "carries across ranks)")))
        unsharded = [d for d in dep_specs
                     if isinstance(d, DatasetSpec) and not d.sharded]
        if unsharded:
            out.append(Diagnostic(
                code="implicit-replication",
                severity=SEVERITY_WARNING, node_id=n.id,
                operator=op.label(),
                message=(
                    "consumer zips a rank-local stream with a "
                    "non-sharded input: each rank pairs its shard's "
                    "rows against the SAME rows of the other input, so "
                    "every rank but one computes a misaligned pairing. "
                    "Slice the other input to this rank's shard (the "
                    "dryrun worker's contiguous-block labels)")))
    return out


# -- pass 4: world-checkpoint consistency ------------------------------------

#: world-snapshot filesystem effects that only host 0 performs; the
#: value says which sides need a barrier. merge_hosts READS every
#: peer's sidecar and WRITES the world snapshot peers may resume from:
#: both sides. clear destroys state nobody may still need: the
#: preceding barrier (everyone past finalize) suffices.
_HOST0_EFFECTS = {"merge_hosts": ("before", "after"),
                  "clear": ("before",)}

#: receivers that look like a stream checkpoint (the `clear` effect is
#: only checked on these — `.clear()` on dicts/lists is ubiquitous)
_CKPT_RECEIVERS = ("ckpt", "checkpoint", "snapshot")


def _is_ckpt_receiver(call: ast.Call) -> bool:
    f = call.func
    if not isinstance(f, ast.Attribute):
        return False
    recv = f.value
    name = recv.id if isinstance(recv, ast.Name) else (
        recv.attr if isinstance(recv, ast.Attribute) else "")
    return any(p in name for p in _CKPT_RECEIVERS)


def _barrier_lines(fdef) -> List[int]:
    """Lines of true world BARRIERS in one scope: named barriers only.
    ``WorldCoordinator.step`` is deliberately NOT one here — it is a
    rendezvous, but the sidecar writes happen AFTER it in the round
    loop, so it cannot order snapshot durability."""
    lines = []
    for sub in _own_walk(fdef):
        if isinstance(sub, ast.Call):
            name = _call_name(sub)
            if (name == "barrier" and (_is_coordinator_receiver(sub)
                                       or _direct_collective(sub))) \
                    or name == "monitored_barrier":
                lines.append(sub.lineno)
    return sorted(lines)


def _snapshot_write_lines(fdef) -> List[int]:
    """Lines where this scope writes snapshot state peers must see as
    durable before a fold (``save_host``/``save`` on a checkpoint-ish
    receiver): the 'before' barrier must land BETWEEN the last such
    write and the host-0 effect, or it orders nothing."""
    lines = []
    for sub in _own_walk(fdef):
        if isinstance(sub, ast.Call) and isinstance(
                sub.func, ast.Attribute) and sub.func.attr in (
                    "save_host", "save") and _is_ckpt_receiver(sub):
            lines.append(sub.lineno)
    return sorted(lines)


def world_checkpoint_consistency(
    tree: ast.Module, allowlist: Optional[Iterable[str]] = None,
) -> List[tuple]:
    """``(lineno, code, description)`` for unbarriered host-0 snapshot
    effects and raw (non-``_restore_carry``) checkpoint-carry reads
    (see module docstring)."""
    hits: List[tuple] = []
    for where, fdef in _scopes(tree):
        barriers = _barrier_lines(fdef)
        writes = _snapshot_write_lines(fdef)

        # -- host-0 effects must be barrier-paired -------------------------
        for sub in _own_walk(fdef):
            if not isinstance(sub, ast.If):
                continue
            if not any(isinstance(c, ast.Call)
                       and _call_name(c) in _HOST0_EFFECTS
                       for c in ast.walk(sub)):
                continue  # no rank-0 effect under this gate
            # taint AS OF the gate: a LATER uniform rebind of the gating
            # name must not mask an earlier rank-0 gate
            _, tainted = _fold_scope(fdef, upto=sub.lineno)
            if not _expr_divergent(sub.test, tainted):
                continue
            end = getattr(sub, "end_lineno", sub.lineno)
            # the 'before' barrier must order the LAST preceding
            # snapshot write: a barrier (or any line) before the write
            # proves nothing about its durability
            last_write = max((w for w in writes if w < sub.lineno),
                             default=None)
            floor = last_write if last_write is not None else 0
            for call in ast.walk(sub):
                if not isinstance(call, ast.Call):
                    continue
                name = _call_name(call)
                sides = _HOST0_EFFECTS.get(name)
                if sides is None:
                    continue
                if name == "clear" and not _is_ckpt_receiver(call):
                    continue
                if _allowed(f"{where}:{name}", allowlist):
                    continue
                missing = []
                if "before" in sides and not any(
                        floor < b < sub.lineno for b in barriers):
                    missing.append("before")
                if "after" in sides and not any(
                        b > end for b in barriers):
                    missing.append("after")
                if missing:
                    hits.append((
                        call.lineno, "unbarriered-host0-effect",
                        f"{where} runs host-0-only `{name}(...)` with "
                        f"no world barrier {' or '.join(missing)} the "
                        "gating branch: peers race the shared "
                        "snapshot files (a sidecar still in flight "
                        "folds torn; a peer resumes a half-merged "
                        "world). Bracket the effect with "
                        "WorldCoordinator.barrier calls (the "
                        "sidecars/world discipline in fit_streaming), "
                        "or allowlist with a comment "
                        "(analysis/spmd.py)"))

        # -- restored carries re-enter through _restore_carry --------------
        snap_names: Set[str] = set()
        for sub in _own_walk(fdef):
            if not isinstance(sub, ast.Assign):
                continue
            loads = any(
                isinstance(c, ast.Call) and isinstance(
                    c.func, ast.Attribute)
                and c.func.attr in ("load", "load_world")
                for c in ast.walk(sub.value))
            if loads:
                for t in sub.targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name) and isinstance(
                                n.ctx, ast.Store):
                            snap_names.add(n.id)
        if not snap_names:
            continue
        exempt: Set[int] = set()
        for sub in _own_walk(fdef):
            if isinstance(sub, ast.Call) and _call_name(sub) in (
                    "restore_carry", "_restore_carry", "restore"):
                for a in sub.args:
                    for n in ast.walk(a):
                        exempt.add(id(n))
            elif isinstance(sub, ast.Compare) and any(
                    isinstance(c, ast.Constant) and c.value is None
                    for c in sub.comparators):
                for n in ast.walk(sub):
                    exempt.add(id(n))
        for sub in _own_walk(fdef):
            if not (isinstance(sub, ast.Subscript)
                    and isinstance(sub.value, ast.Name)
                    and sub.value.id in snap_names):
                continue
            sl = sub.slice
            if not (isinstance(sl, ast.Constant) and sl.value == "carry"):
                continue
            if id(sub) in exempt:
                continue
            if _allowed(f"{where}:carry", allowlist):
                continue
            hits.append((
                sub.lineno, "carry-restore-discipline",
                f"{where} feeds a restored checkpoint carry "
                "(`...['carry']`) onward without `restore_carry`: the "
                "raw host arrays would reach accumulate on the host, not "
                "on the stream's device as contiguous tensors. Route the "
                "restore through resilience.stream_checkpoint."
                "restore_carry (host ints preserved), or allowlist with "
                "a comment (analysis/spmd.py)"))
    return sorted(set(hits))


# -- pass 5: unawaited coordination handles ----------------------------------

#: WorldCoordinator methods that DISPATCH an asynchronous coordination
#: round (returning a ``PendingStep`` handle) and the method that AWAITS
#: one. The overlapped round loop (``parallel/streaming.py``) is the
#: shape this pass protects: every dispatched handle must reach exactly
#: one ``step_await`` before it is discarded, rebound, or read.
_DISPATCH_METHODS = frozenset({"step_begin"})
_AWAIT_METHODS = frozenset({"step_await"})

#: ``PendingStep`` fields only meaningful AFTER the await: reading one
#: on a still-pending handle races the in-flight allgather (the payload
#: is a device future; ``result`` is None until ``step_await`` fills it)
_PENDING_RESULT_FIELDS = frozenset({"result"})


def _dispatch_call(node) -> Optional[ast.Call]:
    """The ``world.step_begin(...)`` call inside ``node``, unless the
    same expression also awaits it inline (``step_await(step_begin())``
    is a complete round, not a leak)."""
    found = None
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        name = _call_name(sub)
        if name in _AWAIT_METHODS and _is_coordinator_receiver(sub):
            return None
        if name in _DISPATCH_METHODS and _is_coordinator_receiver(sub):
            found = sub
    return found


def unawaited_collective(
    tree: ast.Module, allowlist: Optional[Iterable[str]] = None,
) -> List[tuple]:
    """``(lineno, code, description)`` for async-coordination hazards:
    a dispatched round handle (``world.step_begin`` → ``PendingStep``)
    that is discarded, rebound, or still pending at scope exit without
    ever reaching ``world.step_await`` — the collective the rest of the
    world is blocked in never completes here, or its result is silently
    dropped and the next boundary folds a stale world view — and a
    pending handle's ``result`` read before its await point (a
    stale-buffer read racing the in-flight allgather).

    Same textual-order discipline as the taint passes: handles are
    tracked per scope in statement order, an await KILLS the pending
    bit through any alias (``pending = new_pending`` transfers the
    handle), so the shipped pipelined loop — dispatch round k+1, await
    round k, drain at the break — scans clean."""
    hits: List[tuple] = []

    def flag(lineno: int, where: str, what: str):
        hits.append((
            lineno, "unawaited-collective",
            f"{where} {what}: every `step_begin` handle must reach "
            "exactly one `step_await` (the overlap contract — peers "
            "are already blocked in this round's allgather, and the "
            "awaited result is the only world view safe to act on). "
            "Await the handle at the next round boundary (the "
            "fit_streaming pipeline shape), or allowlist with a "
            "comment (analysis/spmd.py)"))

    for where, fdef in _scopes(tree):
        if _allowed(f"{where}:step_begin", allowlist):
            continue
        # pending handle name -> dispatch lineno, folded in textual
        # order over this scope's own statements
        pending: Dict[str, int] = {}
        events: List[tuple] = []
        for sub in _own_walk(fdef):
            if isinstance(sub, (ast.Assign, ast.AnnAssign)):
                events.append((sub.lineno, 1, "bind", sub))
            elif isinstance(sub, ast.Expr):
                events.append((sub.lineno, 1, "expr", sub))
            elif isinstance(sub, ast.Call) and _call_name(
                    sub) in _AWAIT_METHODS and _is_coordinator_receiver(sub):
                events.append((sub.lineno, 2, "await", sub))
            elif isinstance(sub, ast.Attribute) and isinstance(
                    sub.ctx, ast.Load) and sub.attr in \
                    _PENDING_RESULT_FIELDS and isinstance(
                        sub.value, ast.Name):
                events.append((sub.lineno, 0, "read", sub))
        for lineno, _, kind, node in sorted(events, key=lambda e: e[:2]):
            if kind == "read":
                if node.value.id in pending:
                    hits.append((
                        lineno, "stale-coordination-read",
                        f"{where} reads `{node.value.id}."
                        f"{node.attr}` before its `step_await`: the "
                        "round dispatched at line "
                        f"{pending[node.value.id]} is still in "
                        "flight, so the read races the gather (None, "
                        "never the world view). Await the handle first, "
                        "or allowlist with a comment (analysis/spmd.py)"))
            elif kind == "await":
                for arg in list(node.args) + [kw.value
                                              for kw in node.keywords]:
                    for n in ast.walk(arg):
                        if isinstance(n, ast.Name):
                            pending.pop(n.id, None)
            elif kind == "expr":
                disp = _dispatch_call(node.value)
                if disp is not None:
                    flag(disp.lineno, where,
                         "discards a `step_begin` handle (dispatched "
                         "round never awaited)")
            else:  # bind
                targets = node.targets if isinstance(
                    node, ast.Assign) else [node.target]
                names = [n for t in targets for n in _store_names(t)]
                value = node.value
                disp = None if value is None else _dispatch_call(value)
                # alias transfer: `pending = new_pending` moves the
                # handle — awaiting through EITHER name satisfies it
                alias = value.id if isinstance(value, ast.Name) and \
                    value.id in pending else None
                for name in names:
                    if name in pending and alias != name:
                        flag(pending.pop(name), where,
                             f"rebinds `{name}` over a still-pending "
                             "handle (the earlier round's result is "
                             "dropped unawaited)")
                if disp is not None:
                    for name in names:
                        pending[name] = disp.lineno
                elif alias is not None:
                    lno = pending.pop(alias)
                    for name in names:
                        pending[name] = lno
        for name, lineno in pending.items():
            flag(lineno, where,
                 f"lets pending handle `{name}` escape the scope "
                 "unawaited")
    return sorted(set(hits))


# -- package scan (tools/lint.py + `check` CLI) ------------------------------

def scan_file(path, rel: str) -> List[Dict[str, object]]:
    """All five AST families over one file; ``[{file, lineno, code,
    message}]`` (the shape tools/lint.py and ``check --json``
    consume)."""
    out: List[Dict[str, object]] = []
    try:
        tree = ast.parse(Path(path).read_text())
    except SyntaxError as exc:
        return [{"file": rel, "lineno": exc.lineno or 0,
                 "code": "syntax-error", "message": str(exc)}]
    for pass_fn in (collective_divergence, barrier_stability,
                    collective_axis_bindings,
                    world_checkpoint_consistency,
                    unawaited_collective):
        for lineno, code, msg in pass_fn(tree):
            out.append({"file": rel, "lineno": lineno,
                        "code": code, "message": msg})
    return out


def scan_package(pkg_root) -> List[Dict[str, object]]:
    """Run every AST pass family over a package tree, tree-wide: the
    rules key on collective call names specific enough that scoping
    would only hide new call sites."""
    pkg_root = Path(pkg_root)
    out: List[Dict[str, object]] = []
    for path in sorted(pkg_root.rglob("*.py")):
        rel = str(path.relative_to(pkg_root.parent))
        out.extend(scan_file(path, rel))
    return out
