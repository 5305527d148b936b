"""The port's concurrency passes (``keystone_tpu_torch/analysis/
concurrency.py``): each of the three families fires on an inline
offender, the port's tree scans clean, the torch device waits count as
blocking, and the declarations are the JAX package's, class for class.

The offenders are source strings parsed here (the JAX package's
``tests/lint_fixtures/`` stay its own); where a shape is the JAX
fixture's, the same source goes through both packages' passes and the
findings are compared.
"""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from keystone_tpu.analysis import concurrency as jconc
from keystone_tpu_torch.analysis.concurrency import (
    CONCURRENCY_ALLOWLIST,
    CONCURRENCY_SCOPES,
    blocking_under_lock,
    find_lock_cycles,
    guarded_classes,
    guarded_field_races,
    guarded_sequence_hazards,
    known_locks,
    lock_order_edges,
    scan_package,
)
from keystone_tpu_torch.utils.guarded import (GUARDED_FIELDS, guarded_by,
                                              guarded_fields)

REPO = Path(__file__).resolve().parent.parent

GUARDED = '''
import threading
from keystone_tpu_torch.utils.guarded import guarded_by

@guarded_by("_lock", "count", "tail", "stats")
class RacyLedger:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self.tail = []
        self.stats = {}

    def bump(self):
        self.count += 1

    def push(self, x):
        self.tail.append(x)

    def merge(self, key):
        self.stats[key] = self.stats.get(key, 0) + 1

    def locked_bump(self):
        with self._lock:
            self.count += 1

    def rebind(self, fresh):
        self.tail = list(fresh)
'''

LOCK_ORDER = '''
import threading
import torch

_MODULE_LOCK = threading.Lock()


class DeadlockPair:
    def __init__(self):
        self._ingest = threading.Lock()
        self._ledger = threading.Lock()

    def producer_side(self):
        with self._ingest:
            with self._ledger:
                pass

    def consumer_side(self):
        with self._ledger:
            with self._ingest:
                pass

    def stalls_everyone(self, q, ev, t, stream):
        with self._ingest:
            item = q.get(timeout=1.0)
            ev.wait()
            host = t.cpu()
            value = t.sum().item()
            stream.synchronize()
            torch.cuda.synchronize()
            return item, host, value

    def module_nesting(self):
        with _MODULE_LOCK:
            with self._ingest:
                pass
'''

ATOMICITY = '''
import threading
from keystone_tpu_torch.utils.guarded import guarded_by


@guarded_by("_lock", "items")
class SplitCheckThenAct:
    def __init__(self):
        self._lock = threading.Lock()
        self.items = []

    def drain_one(self):
        with self._lock:
            pending = len(self.items)
        if pending:
            with self._lock:
                return self.items.pop()
        return None

    def drain_one_atomic(self):
        with self._lock:
            if self.items:
                return self.items.pop()
        return None
'''


def _tree(src):
    return ast.parse(src)


def _jax_src(src):
    return src.replace("keystone_tpu_torch.", "keystone_tpu.")


# -- declarations -----------------------------------------------------------------

def test_guarded_by_decorator_lands_on_class_and_ast():
    @guarded_by("_lock", "count", "tail", "stats")
    class RacyLedger:
        pass

    want = {"count": "_lock", "tail": "_lock", "stats": "_lock"}
    assert guarded_fields(RacyLedger) == want
    assert guarded_classes(_tree(GUARDED))["RacyLedger"] == want


def test_guarded_fields_table_merges_for_undecorated_classes():
    from keystone_tpu_torch.utils.lru import LruMemo

    assert guarded_fields(LruMemo) == {"_entries": "_lock"}
    src = "class LruMemo:\n    def f(self):\n        self._entries.clear()\n"
    assert [c for _, c, _ in guarded_field_races(ast.parse(src))] == \
        ["guarded-field-race"]
    assert set(GUARDED_FIELDS) == {"LruMemo"}


def _declared(pkg_root, decorator):
    """``{class: {field: lock}}`` of every ``@<decorator>`` in a tree."""
    out = {}
    for path in sorted(Path(pkg_root).rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.ClassDef):
                continue
            for dec in node.decorator_list:
                if isinstance(dec, ast.Call) and getattr(
                        dec.func, "id", "") == decorator:
                    args = [a.value for a in dec.args]
                    out.setdefault(node.name, {}).update(
                        {f: args[0] for f in args[1:]})
    return out


#: JAX-declared classes or fields the port has no counterpart of, each
#: with its reason
JAX_ONLY_GUARDS = {
    # the per-program jit site: the port compiles no programs; its
    # capture sites' tallies live in CompileObservatory._sites
    "_JitSite": None,
    # the JAX trace's per-compile stats table; the port's trace keeps
    # the capture tail only
    ("PipelineTrace", "compile_stats"): None,
}

#: the port's own guarded state, each with its reason
PORT_ONLY_GUARDS = {
    # the per-site capture tallies (the JAX _JitSite's counterpart)
    ("CompileObservatory", "_sites"): None,
    # a captured bucket's static buffers: one replay of a graph at a time
    "BucketGraph": None,
}


def _strip(decl, skip):
    out = {}
    for cls, fields in decl.items():
        if cls in skip:
            continue
        kept = {f: lk for f, lk in fields.items() if (cls, f) not in skip}
        if kept:
            out[cls] = kept
    return out


def test_guarded_declarations_match_the_jax_ones_class_for_class():
    port = _declared(REPO / "keystone_tpu_torch", "guarded_by")
    ref = _declared(REPO / "keystone_tpu", "guarded_by")
    # the JAX table's FaultPlan / RetryPolicy are decorators in the port
    from keystone_tpu.utils.guarded import GUARDED_FIELDS as JTABLE

    for cls, fields in JTABLE.items():
        ref.setdefault(cls, {}).update(fields)
    for cls, fields in GUARDED_FIELDS.items():
        port.setdefault(cls, {}).update(fields)
    assert _strip(port, PORT_ONLY_GUARDS) == _strip(ref, JAX_ONLY_GUARDS)


# -- pass 1: guarded-by race ------------------------------------------------------

def test_guarded_race_fires_on_offender_like_jax():
    hits = guarded_field_races(_tree(GUARDED))
    assert {c for _, c, _ in hits} == {"guarded-field-race"}
    assert len(hits) == 3
    by_msg = " ".join(m for _, _, m in hits)
    assert "read-modify-write" in by_msg and ".append()" in by_msg
    assert "item assignment" in by_msg
    assert "locked_bump" not in by_msg and "rebind" not in by_msg
    ref = jconc.guarded_field_races(_tree(_jax_src(GUARDED)))
    assert [(ln, c) for ln, c, _ in hits] == [(ln, c) for ln, c, _ in ref]


def test_guarded_race_allowlist_suppresses_with_entry():
    hits = guarded_field_races(
        _tree(GUARDED),
        allowlist={"RacyLedger.bump:count", "RacyLedger.push:tail"})
    assert len(hits) == 1 and "merge" in hits[0][2]


def test_guarded_race_catches_the_unlocked_resilience_stats_shape():
    src = ("class PipelineTrace:\n"
           "    def record_resilience(self, entry):\n"
           "        ev = str(entry.get('event', 'other'))\n"
           "        self.resilience_stats[ev] = "
           "self.resilience_stats.get(ev, 0) + 1\n"
           "        self.resilience.append(entry)\n")
    extra = {"PipelineTrace": {"resilience": "_resilience_lock",
                               "resilience_stats": "_resilience_lock"}}
    hits = guarded_field_races(ast.parse(src), extra=extra)
    assert len(hits) == 2


def test_guarded_race_catches_the_unlocked_histogram_shape():
    src = ("@guarded_by('_lock', 'count', '_tail')\n"
           "class Histogram:\n"
           "    def observe(self, value):\n"
           "        self.count += 1\n"
           "        self._tail.append(value)\n"
           "        if len(self._tail) > 256:\n"
           "            del self._tail[:1]\n")
    assert len(guarded_field_races(ast.parse(src))) == 3


# -- pass 2: lock order + blocking-under-lock -------------------------------------

def test_lock_order_cycle_fires_on_offender():
    edges = lock_order_edges(_tree(LOCK_ORDER), "m")
    cycles = find_lock_cycles(edges)
    assert len(cycles) == 1
    path, sites = cycles[0]
    assert set(path) == {"DeadlockPair._ingest", "DeadlockPair._ledger"}
    assert "producer_side" in sites and "consumer_side" in sites


def test_module_level_lock_edges_are_tracked():
    tree = _tree(LOCK_ORDER)
    mod_locks, cls_locks = known_locks(tree)
    assert mod_locks == {"_MODULE_LOCK"}
    assert cls_locks["DeadlockPair"] == {"_ingest", "_ledger"}
    assert ("m._MODULE_LOCK", "DeadlockPair._ingest") in {
        (a, b) for a, b, _, _ in lock_order_edges(tree, "m")}


def test_blocking_under_lock_counts_the_torch_device_waits():
    hits = blocking_under_lock(_tree(LOCK_ORDER), "m")
    attrs = sorted(m.split("`")[1] for _, _, m in hits)
    assert attrs == ["cpu()", "get()", "item()", "synchronize()",
                     "synchronize()", "wait()"]
    assert all(c == "blocking-under-lock" for _, c, _ in hits)


@pytest.mark.parametrize("read", ["t.tolist()", "t.numpy()",
                                  "ev.synchronize()", "fut.result()",
                                  "worker.join()", "time.sleep(0.1)"])
def test_each_blocking_read_fires_under_a_lock(read):
    src = ("import threading, time\n"
           "class C:\n"
           "    def __init__(self):\n"
           "        self._lock = threading.Lock()\n"
           "    def f(self, t, ev, fut, worker):\n"
           "        with self._lock:\n"
           f"            return {read}\n")
    assert len(blocking_under_lock(ast.parse(src), "m")) == 1
    outside = src.replace("        with self._lock:\n            return",
                          "        return")
    assert blocking_under_lock(ast.parse(outside), "m") == []


def test_blocking_under_lock_ignores_dict_get():
    src = ("import threading\n"
           "class Reg:\n"
           "    def __init__(self):\n"
           "        self._lock = threading.Lock()\n"
           "    def lookup(self, table, name):\n"
           "        with self._lock:\n"
           "            return table.get(name)\n")
    assert blocking_under_lock(ast.parse(src), "m") == []


def test_one_hop_follows_self_methods_not_a_collaborators_namesake():
    """``self.ledger.admit`` under the plane lock is not the plane's own
    ``admit`` (which takes the plane lock): the one-hop edge follows
    ``self.m()`` into this class and ``obj.m()`` only into OTHER classes
    of the module."""
    src = ("import threading\n"
           "class Plane:\n"
           "    def __init__(self):\n"
           "        self._lock = threading.Lock()\n"
           "        self._admit_lock = threading.Lock()\n"
           "    def admit(self):\n"
           "        with self._admit_lock:\n"
           "            with self._lock:\n"
           "                self.ledger.admit(1)\n"
           "    def capture(self):\n"
           "        with self._lock:\n"
           "            self.warm()\n"
           "    def warm(self):\n"
           "        with self._admit_lock:\n"
           "            pass\n")
    edges = {(a, b) for a, b, _, _ in lock_order_edges(ast.parse(src), "m")}
    assert ("Plane._lock", "Plane._admit_lock") in edges  # self.warm()
    assert len(find_lock_cycles(lock_order_edges(ast.parse(src), "m"))) == 1
    no_self = src.replace("            self.warm()\n", "            pass\n")
    assert find_lock_cycles(lock_order_edges(ast.parse(no_self), "m")) == []


# -- pass 3: non-atomic guarded sequence ------------------------------------------

def test_sequence_hazard_fires_on_offender():
    hits = guarded_sequence_hazards(_tree(ATOMICITY))
    assert len(hits) == 1
    _, code, msg = hits[0]
    assert code == "non-atomic-guarded-sequence"
    assert "drain_one" in msg and "items" in msg
    assert "drain_one_atomic" not in msg
    assert guarded_sequence_hazards(
        _tree(ATOMICITY),
        allowlist={"SplitCheckThenAct.drain_one:items"}) == []


# -- the tree ---------------------------------------------------------------------

def test_package_tree_is_concurrency_clean():
    assert scan_package(REPO / "keystone_tpu_torch") == []
    assert CONCURRENCY_ALLOWLIST == frozenset()


def test_scan_package_reports_offenders_when_present(tmp_path):
    pkg = tmp_path / "pkg"
    (pkg / "parallel").mkdir(parents=True)
    (pkg / "parallel" / "racy.py").write_text(GUARDED)
    (pkg / "serving").mkdir()
    (pkg / "serving" / "order.py").write_text(LOCK_ORDER)
    hits = scan_package(pkg)
    assert {h["code"] for h in hits} == {
        "guarded-field-race", "blocking-under-lock", "lock-order-cycle"}
    assert {Path(h["file"]).name for h in hits} == {"racy.py", "order.py"}


def test_scopes_cover_the_threaded_subsystems():
    assert set(CONCURRENCY_SCOPES) == set(jconc.CONCURRENCY_SCOPES)


def test_lint_tool_runs_the_concurrency_passes(tmp_path, monkeypatch):
    from keystone_tpu_torch.tools import lint

    pkg = tmp_path / "keystone_tpu_torch"
    (pkg / "parallel").mkdir(parents=True)
    (pkg / "parallel" / "bad.py").write_text(LOCK_ORDER)
    monkeypatch.setattr(lint, "PKG", pkg)
    monkeypatch.setattr(lint, "REPO", tmp_path)
    assert lint.run_concurrency_rules() > 0


def test_check_json_carries_the_concurrency_scan(tmp_path):
    out = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", "check",
         "nlp.stupid_backoff", "--json", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "concurrency: clean" in proc.stdout
    blob = json.loads(out.read_text())
    assert blob["concurrency"] == [] and blob["metrics_names"] == []
