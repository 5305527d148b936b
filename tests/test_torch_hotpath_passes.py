"""The port's hot-path and publication passes (``keystone_tpu_torch/
analysis/hotpath.py``): each rule fires on an inline offender through
``scan_source`` with the call chain named, the torch host reads count as
syncs and a CUDA graph's replay does not, the port's tree scans clean
within ``HOTPATH_SCAN_BUDGET_S``, every allowlist and cold entry is
load-bearing, and the ``@hotpath`` / ``@published_by`` declarations are
the JAX package's, site for site.
"""
import ast
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from keystone_tpu.analysis import hotpath as jhot
from keystone_tpu_torch.analysis.hotpath import (
    HOTPATH_ALLOWLIST,
    HOTPATH_COLD,
    HOTPATH_SCAN_BUDGET_S,
    MAX_CHAIN_DEPTH,
    build_package,
    hotpath_hazards,
    published_classes,
    published_field_hazards,
    scan_package,
    scan_source,
)
from keystone_tpu_torch.utils.guarded import (hotpath, published_by,
                                              published_fields)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "keystone_tpu_torch"

BLOCKING = '''
import threading
import time
from keystone_tpu_torch.utils.guarded import hotpath


class SlowGate:
    def __init__(self):
        self._slots = threading.Semaphore(4)
        self._done = threading.Event()

    @hotpath
    def handle(self, fut):
        self._slots.acquire()
        self._done.wait(1.0)
        return fut.result()

    @hotpath
    def drain(self, q):
        return q.get()

    @hotpath
    def submit(self, item):
        return self._stall(item)

    def _stall(self, item):
        time.sleep(0.01)
        return item
'''

HOSTSYNC = '''
import numpy as np
import torch
from keystone_tpu_torch.utils.guarded import hotpath


class SyncyPlane:
    @hotpath
    def respond(self, out, graph, stream, event):
        host = np.asarray(out)
        value = out.sum().item()
        rows = out.tolist()
        back = out.cpu()
        arr = out.detach().numpy()
        moved = out.to("cpu")
        torch.cuda.synchronize()
        stream.synchronize()
        event.synchronize()
        graph.replay()
        kept = out.to(torch.float16)
        return host, value, rows, back, arr, moved, kept
'''

IO = '''
import pickle
from keystone_tpu_torch.utils.guarded import hotpath


class ChattyHandler:
    @hotpath
    def handle(self, path):
        print("request", path)
        with open(path, "rb") as f:
            raw = f.read()
        return pickle.loads(raw)
'''

LAZY = '''
from keystone_tpu_torch.utils.guarded import hotpath


class LazyLoader:
    @hotpath
    def predict(self, x):
        import json
        return json.dumps(x)
'''

GROWTH = '''
from collections import deque
from keystone_tpu_torch.utils.guarded import hotpath


class LeakyLedger:
    def __init__(self):
        self._seen = []
        self._seen_index = {}
        self._retired = []
        self._recent = deque(maxlen=64)

    @hotpath
    def record(self, rid):
        self._seen.append(rid)
        self._retired.append(rid)
        self._recent.append(rid)
        self._seen_index[rid] = True

    def retire(self):
        return self._retired.pop()
'''

LOCK_DISPATCH = '''
import threading
from keystone_tpu_torch.utils.guarded import hotpath


class DispatchUnderLock:
    def __init__(self):
        self._lock = threading.Lock()

    @hotpath
    def flush(self, batch):
        with self._lock:
            self._dispatch(batch)

    @hotpath
    def flush_unlocked(self, batch):
        return self._dispatch(batch)

    def _dispatch(self, batch):
        return self._gather(batch)

    def _gather(self, batch):
        return batch.cpu()
'''

PUBLICATION = '''
import threading
from keystone_tpu_torch.utils.guarded import published_by


@published_by("_lock", "_live", "_epoch")
class TornPlane:
    def __init__(self):
        self._lock = threading.Lock()
        self._live = {}
        self._epoch = 0

    def unlocked_flip(self, snap):
        self._live = snap

    def piecewise(self, name, entry):
        with self._lock:
            self._live.update({name: entry})

    def torn_swap(self, snap, epoch):
        with self._lock:
            self._live = snap
            self._epoch = epoch

    def clean_flip(self, snap):
        with self._lock:
            self._live = dict(snap)

    def clean_drop_locked(self, name):
        self._live.pop(name, None)
'''


def _scan(src, **kw):
    kw.setdefault("allowlist", ())
    kw.setdefault("cold", ())
    return scan_source(src, **kw)


def _jax(src):
    return src.replace("keystone_tpu_torch.", "keystone_tpu.")


# -- declarations -----------------------------------------------------------------

def test_hotpath_marker_is_zero_cost_and_introspectable():
    def f():
        return 1

    assert hotpath(f) is f and f.__hotpath_entry__ is True

    @published_by("_lock", "_live")
    class Plane:
        pass

    assert published_fields(Plane) == {"_live": "_lock"}
    with pytest.raises(ValueError):
        published_by("_lock")


def _entries(pkg_root):
    return {f"{fid[0].split('.', 1)[1]}::{fid[1]}"
            for fid in build_package(pkg_root).entries}


def _publications(pkg_root):
    out = {}
    for path in sorted(Path(pkg_root).rglob("*.py")):
        out.update(published_classes(ast.parse(path.read_text())))
    return out


def test_entry_points_are_the_jax_ones_site_for_site():
    port = _entries(PKG)
    ref = {e for e in _entries(REPO / "keystone_tpu")}
    assert port == ref
    assert len(port) == 20


def test_published_fields_are_the_jax_ones():
    assert _publications(PKG) == _publications(REPO / "keystone_tpu")
    from keystone_tpu_torch.observability.reqtrace import ExemplarReservoir
    from keystone_tpu_torch.serving.batcher import MicroBatcher
    from keystone_tpu_torch.serving.plane import ServingPlane
    from keystone_tpu_torch.serving.router import FleetRouter

    assert published_fields(MicroBatcher) == {"_closed": "_lock"}
    assert published_fields(ServingPlane) == {"_live": "_lock"}
    assert published_fields(ExemplarReservoir) == {"_floor": "_lock"}
    assert published_fields(FleetRouter) == {"_table": "_lock"}


def test_serving_entry_points_carry_the_marker_at_runtime():
    from keystone_tpu_torch.observability.reqtrace import (
        ExemplarReservoir, ReqTrace)
    from keystone_tpu_torch.serving.batcher import MicroBatcher
    from keystone_tpu_torch.serving.http import ServingHandler
    from keystone_tpu_torch.serving.plane import ServingPlane
    from keystone_tpu_torch.serving.router import (
        FleetRouter, HttpReplicaClient, LocalReplicaClient, RouterHandler)

    for fn in (MicroBatcher.submit, MicroBatcher.submit_request,
               MicroBatcher.take, MicroBatcher.done, ServingPlane.submit,
               ServingPlane.submit_request, ServingPlane.predict,
               ServingPlane.predict_traced, ServingPlane._execute,
               ServingPlane._serve_batch, ReqTrace.new,
               ExemplarReservoir.offer, ServingHandler.do_POST,
               LocalReplicaClient.submit_request,
               LocalReplicaClient.predict_raw,
               HttpReplicaClient.predict_raw, FleetRouter._route,
               FleetRouter.submit_request, FleetRouter.predict_raw,
               RouterHandler.do_POST):
        assert getattr(fn, "__hotpath_entry__", False), fn


# -- each rule --------------------------------------------------------------------

@pytest.mark.parametrize("src, code, count", [
    (BLOCKING, "hotpath-blocking", 5),
    (IO, "hotpath-io", 4),
    (LAZY, "hotpath-lazy-import", 1),
    (GROWTH, "hotpath-unbounded-growth", 2),
], ids=["blocking", "io", "lazy-import", "growth"])
def test_rule_fires_on_its_offender_as_the_jax_one(src, code, count):
    hits = _scan(src)
    assert {c for _, c, _ in hits} == {code}
    assert len(hits) == count
    assert all(ln > 0 and "hot path" in msg for ln, _, msg in hits)
    ref = jhot.scan_source(_jax(src), allowlist=(), cold=())
    assert [(ln, c) for ln, c, _ in hits] == [(ln, c) for ln, c, _ in ref]


def test_host_sync_is_the_torch_host_reads_and_not_a_replay():
    hits = _scan(HOSTSYNC)
    assert {c for _, c, _ in hits} == {"hotpath-host-sync"}
    lines = HOSTSYNC.splitlines()
    flagged = sorted({lines[ln - 1].strip().split(" = ")[-1].split("(")[0]
                      for ln, _, _ in hits})
    assert len(hits) == 9
    assert not any("replay" in lines[ln - 1] or "float16" in lines[ln - 1]
                   for ln, _, _ in hits)
    assert "np.asarray" in flagged


def test_diagnostics_name_the_full_call_chain():
    sleep_hits = [m for _, _, m in _scan(BLOCKING) if "sleep" in m]
    assert len(sleep_hits) == 1
    assert "SlowGate.submit -> SlowGate._stall" in sleep_hits[0]


def test_growth_rule_spares_drained_and_bounded_fields():
    hits = _scan(GROWTH)
    assert all("_seen" in m for _, _, m in hits)
    assert not any("_retired" in m or "_recent" in m for _, _, m in hits)


def test_lock_held_dispatch_fires_transitively_and_only_under_lock():
    hits = _scan(LOCK_DISPATCH)
    dispatch = [h for h in hits if h[1] == "hotpath-lock-held-dispatch"]
    assert len(dispatch) == 1
    assert "holding `self._lock`" in dispatch[0][2]
    assert "DispatchUnderLock._dispatch" in dispatch[0][2]
    syncs = [h for h in hits if h[1] == "hotpath-host-sync"]
    assert len(syncs) == 1 and "DispatchUnderLock.flush -> " in syncs[0][2]


def test_publication_pass_fires_each_clause_once():
    hits = published_field_hazards(ast.parse(PUBLICATION), allowlist=())
    assert {c for _, c, _ in hits} == {
        "unpublished-write", "non-atomic-publication", "torn-publication"}
    assert len(hits) == 3
    allow = {"TornPlane.unlocked_flip:_live", "TornPlane.piecewise:_live",
             "TornPlane.torn_swap:_live"}
    assert published_field_hazards(ast.parse(PUBLICATION),
                                   allowlist=allow) == []


def test_allowlist_and_cold_set_prune_by_func_and_offender():
    allow = {"SlowGate.handle:acquire", "SlowGate.handle:wait",
             "SlowGate.handle:result", "SlowGate.drain:get",
             "SlowGate._stall:sleep"}
    assert _scan(BLOCKING, allowlist=allow) == []
    partial = _scan(BLOCKING, allowlist={"SlowGate.drain:get"})
    assert len(partial) == 4
    cold = _scan(BLOCKING, cold={"SlowGate._stall"})
    assert len(cold) == 4 and not any("sleep" in m for _, _, m in cold)


def test_the_walk_is_bounded():
    chain = "\n".join(
        f"    def f{i}(self):\n        return self.f{i + 1}()"
        for i in range(MAX_CHAIN_DEPTH + 3))
    src = ("import time\nfrom keystone_tpu_torch.utils.guarded import "
           "hotpath\nclass Deep:\n    @hotpath\n    def entry(self):\n"
           "        return self.f0()\n" + chain +
           f"\n    def f{MAX_CHAIN_DEPTH + 3}(self):\n"
           "        time.sleep(1)\n")
    assert _scan(src) == []  # past the depth cap: not walked


# -- the tree ---------------------------------------------------------------------

def test_tree_scan_is_clean_and_under_budget():
    t0 = time.perf_counter()
    hits = scan_package(PKG)
    elapsed = time.perf_counter() - t0
    assert hits == [], hits
    assert elapsed < HOTPATH_SCAN_BUDGET_S


def test_every_allowlist_and_cold_entry_is_live():
    pkg = build_package(PKG)
    assert hotpath_hazards(pkg) == []
    for entry in sorted(HOTPATH_ALLOWLIST):
        assert hotpath_hazards(pkg, allowlist=HOTPATH_ALLOWLIST - {entry}), \
            f"allowlist entry {entry!r} is dead"
    for entry in sorted(HOTPATH_COLD):
        assert hotpath_hazards(pkg, cold=HOTPATH_COLD - {entry}), \
            f"cold entry {entry!r} is dead"


def test_every_allowlist_and_cold_entry_carries_a_comment():
    src = (PKG / "analysis" / "hotpath.py").read_text().splitlines()
    for table in ("HOTPATH_ALLOWLIST", "HOTPATH_COLD"):
        start = next(i for i, ln in enumerate(src)
                     if ln.startswith(f"{table}: "))
        end = next(i for i in range(start, len(src)) if src[i] == "})")
        prev_comment = False
        for line in src[start + 1:end]:
            s = line.strip()
            if s.startswith("#"):
                prev_comment = True
            elif s.startswith('"'):
                assert prev_comment, f"{table}: {s} has no comment"


def test_the_batch_failure_post_mortem_is_off_the_worker(tmp_path,
                                                         monkeypatch):
    """The serving worker hands the post-mortem to the writer thread: the
    path is on the exception at once, the file follows."""
    from keystone_tpu_torch.observability import postmortem

    monkeypatch.setenv("KEYSTONE_TORCH_POSTMORTEM_DIR", str(tmp_path))
    exc = postmortem.attach_postmortem_async(RuntimeError("boom"), "unit",
                                             {"k": 1})
    assert exc.postmortem_path and "[post-mortem: " in str(exc)
    assert postmortem.wait_postmortems(10.0)
    blob = json.loads(Path(exc.postmortem_path).read_text())
    assert blob["reason"] == "unit" and blob["context"] == {"k": 1}
    assert "ServingPlane._fail_batch" not in HOTPATH_COLD


def test_scan_package_reports_the_lint_shape(tmp_path):
    pkg = tmp_path / "pkg"
    (pkg / "serving").mkdir(parents=True)
    (pkg / "serving" / "bad.py").write_text(LAZY)
    hits = scan_package(pkg)
    assert {h["code"] for h in hits} == {"hotpath-lazy-import"}
    for h in hits:
        assert set(h) == {"file", "lineno", "code", "message"}
        assert h["file"].endswith("bad.py") and h["lineno"] > 0


def test_lint_tool_runs_the_hotpath_passes(tmp_path, monkeypatch, capsys):
    from keystone_tpu_torch.tools import lint

    pkg = tmp_path / "keystone_tpu_torch"
    (pkg / "serving").mkdir(parents=True)
    (pkg / "serving" / "bad.py").write_text(BLOCKING)
    monkeypatch.setattr(lint, "PKG", pkg)
    monkeypatch.setattr(lint, "REPO", tmp_path)
    assert lint.run_hotpath_rules() > 0
    assert "budget" in capsys.readouterr().out


def test_check_prints_and_carries_the_hotpath_scan(tmp_path):
    out = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", "check",
         "mnist.random_fft", "--json", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "hotpath: clean" in proc.stdout
    assert "spmd: clean" in proc.stdout
    blob = json.loads(out.read_text())
    assert blob["hotpath"] == [] and blob["spmd"] == []
