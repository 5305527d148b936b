"""The port's AST-only lints (``analysis/diagnostics.py``) and the
donation shape gate (``utils/donation.py``): each rule fires on an
inline offender and stays silent on its clean twin, the shapes the JAX
package's rules share give the same findings there, and the port's tree
is clean through ``python -m keystone_tpu_torch.tools.lint``.
"""
import ast

import pytest
import torch

from keystone_tpu.analysis import diagnostics as jdiag
from keystone_tpu_torch.analysis.diagnostics import (
    CAST_BEFORE_TRANSFER_SCOPES,
    NAN_SILENCER_SCOPES,
    SWALLOW_ALL_SCOPES,
    donating_names,
    donation_hazards,
    float_casts_before_transfer,
    recompile_hazards,
    silent_nan_silencers,
    swallow_all_handlers,
)
from keystone_tpu_torch.utils import donation


def _lines(hits):
    return [h[0] for h in hits]


# -- cast before transfer -----------------------------------------------------------

CAST = '''
import numpy as np
import torch


def widen_then_ship(records, device):
    wide = records.astype(np.float32)
    return torch.from_numpy(wide).to(device)


def as_tensor_widens_on_the_host(records, dev):
    return torch.as_tensor(records, dtype=torch.float32, device=dev)


def stack_widens(rows):
    x = np.stack(rows, dtype=np.float64)
    return torch.from_numpy(x).cuda()


def ship_then_cast(records, device):
    return torch.from_numpy(records).to(device).to(torch.float32)


def cast_only(records):
    return records.astype(np.float32)


def outer(records, device):
    wide = records.astype("float32")

    def ship(x):
        return x.to(device)

    return ship(torch.from_numpy(wide))
'''


def test_cast_before_transfer_fires_on_host_widening_before_a_copy():
    hits = float_casts_before_transfer(ast.parse(CAST))
    assert [what for _, what in hits] == [
        "astype(float)", "as_tensor(dtype=float, device=...)",
        "stack(dtype=float)"]
    # a device-side cast, a cast with no transfer, and a transfer in a
    # nested scope are not flagged
    assert max(_lines(hits)) < CAST.splitlines().index(
        "def ship_then_cast(records, device):") + 1


def test_a_dtype_cast_is_not_a_transfer():
    src = ("import numpy as np\nimport torch\n"
           "def f(records):\n"
           "    x = records.astype(np.float32)\n"
           "    return torch.from_numpy(x).to(torch.float16)\n")
    assert float_casts_before_transfer(ast.parse(src)) == []


# -- swallow-all handlers -----------------------------------------------------------

SWALLOW = '''
def bare(f):
    try:
        f()
    except:
        pass


def silent(f):
    try:
        f()
    except Exception:
        pass


def silent_base(f):
    try:
        f()
    except (ValueError, BaseException):
        ...


def narrowed(f):
    try:
        f()
    except OSError:
        pass


def recorded(f):
    try:
        f()
    except Exception as exc:
        return str(exc)
'''


def test_swallow_all_fires_as_the_jax_rule():
    tree = ast.parse(SWALLOW)
    hits = swallow_all_handlers(tree)
    assert len(hits) == 3
    assert hits == jdiag.swallow_all_handlers(tree)


# -- NaN silencers --------------------------------------------------------------------

NAN = '''
import numpy as np
import torch
from keystone_tpu_torch.observability.numerics import record_numerics_event


def silent(x):
    return torch.nan_to_num(x, nan=0.0)


def silent_method(x):
    return x.nan_to_num_()


def silent_errstate(a):
    with np.errstate(divide="ignore"):
        return 1.0 / a


def accounted(x):
    bad = int((~torch.isfinite(x)).sum())
    record_numerics_event("clamped", count=bad)
    return torch.nan_to_num(x)


def raising(a):
    with np.errstate(all="raise"):
        return 1.0 / a


def counted(x, reg):
    reg.counter("numerics.clamped_total").inc()
    return np.nan_to_num(x)
'''


def test_nan_silencers_fire_only_without_an_event():
    hits = silent_nan_silencers(ast.parse(NAN))
    assert [what for _, what in hits] == [
        "nan_to_num(...)", "nan_to_num_(...)", "errstate(...='ignore')"]


# -- donation hazards (in-place carry updates) ----------------------------------------

DONATION = '''
from keystone_tpu_torch.utils.donation import donates_carry


@donates_carry(0)
def update(carry, chunk):
    return carry


class Est:
    @donates_carry(1)
    def accumulate(self, carry, chunk):
        return carry


def reads_after(carry, chunks, ckpt):
    new = update(carry, chunks[0])
    stale = carry[0]
    return new, stale


def snapshots_after(est, carry, chunk, ckpt):
    out = est.accumulate(carry, chunk)
    ckpt.save(carry)
    return out


def rebinds(carry, chunks):
    for chunk in chunks:
        carry = update(carry, chunk)
    return carry


def copies_first(carry, chunk, ckpt):
    ckpt.save(carry)
    carry = update(carry, chunk)
    return carry
'''


def test_donating_names_count_self_out_of_a_methods_position():
    assert donating_names(ast.parse(DONATION)) == {
        "update": frozenset({0}), "accumulate": frozenset({0})}


def test_use_and_checkpoint_after_donate_fire():
    hits = donation_hazards(ast.parse(DONATION))
    assert [c for _, c, _ in hits] == ["use-after-donate",
                                       "checkpoint-after-donate"]
    assert "update()" in hits[0][2] and "accumulate()" in hits[1][2]


def test_donors_from_another_module_count():
    caller = ("def f(carry, x):\n"
              "    out = accumulate_gram_carry(carry, x, x)\n"
              "    return out, carry\n")
    assert donation_hazards(ast.parse(caller)) == []
    hits = donation_hazards(ast.parse(caller),
                            {"accumulate_gram_carry": frozenset({0})})
    assert [c for _, c, _ in hits] == ["use-after-donate"]


def test_the_ports_donation_sites_declare_probes_and_update_in_place():
    import keystone_tpu_torch.nodes.learning.linear  # noqa: F401
    import keystone_tpu_torch.nodes.stats  # noqa: F401

    sites = {s.name: s for s in donation.registered_donations()}
    assert {"accumulate_gram_carry", "StandardScaler.accumulate"} <= \
        set(sites)
    for site in sites.values():
        assert site.probe is not None and site.fn is not None
        assert donation.donation_shape_mismatches(site) == []


def _site(fn, probe):
    return donation.DonationSite(fn, 0, probe=probe, name=fn.__name__,
                                 module=__name__)


def test_the_shape_gate_fires_on_a_new_carry_and_a_reshaped_one():
    def meta(*shape):
        return torch.empty(shape, device="meta")

    def probe():
        return ((meta(4, 4), meta(4)), meta(8, 4)), {}

    def copies(carry, x):
        G, s = carry
        return (G + x.T @ x, s)

    def reshapes(carry, x):
        G, s = carry
        return (G.reshape(16), s)

    def in_place(carry, x):
        G, s = carry
        G += x.T @ x
        s += x.sum(0)
        return (G, s)

    assert donation.donation_shape_mismatches(
        _site(in_place, probe)) == []
    assert [m.split(" is ")[-1] for m in donation.donation_shape_mismatches(
        _site(copies, probe))] == [
        "not updated in place (the update returns a new tensor)"]
    assert ["no shape-compatible output" in m
            for m in donation.donation_shape_mismatches(
                _site(reshapes, probe))] == [True]
    assert donation.donation_shape_mismatches(_site(copies, None)) == []


# -- recompile (capture) hazards -----------------------------------------------------

RECOMPILE = '''
import time
import torch
from keystone_tpu_torch.serving.graphs import capture_apply

_MEMO = {}


class Plane:
    def per_instance(self, fitted, inputs, n, dev):
        graph, out, launches = capture_apply(fitted, inputs, n, dev, "b")
        self._graph = graph

    def fresh_graph_on_self(self):
        self._graphs = {}
        self._graphs["k"] = torch.cuda.CUDAGraph()

    def fast_path(self, fitted, inputs, n, dev, memo, key):
        graph, out, _ = capture_apply(fitted, inputs, n, dev, "b")
        memo.put(key, graph)
        self._last = graph

    def volatile_key(self, fitted, inputs, n, dev, memo):
        graph, out, _ = capture_apply(fitted, inputs, n, dev, "b")
        memo.put((id(inputs), n), graph)

    def clock_key(self, fitted, inputs, n, dev):
        _MEMO[time.perf_counter()] = capture_apply(fitted, inputs, n, dev,
                                                  "b")

    def stable(self, fitted, inputs, n, dev, memo, model):
        graph, out, _ = capture_apply(fitted, inputs, n, dev, "b")
        memo.put((model, n), graph)
        _MEMO[(model, n)] = graph
'''


def test_capture_hazards_fire_per_instance_and_on_volatile_keys():
    hits = recompile_hazards(ast.parse(RECOMPILE))
    lines = RECOMPILE.splitlines()
    got = [(c, lines[ln - 1].strip()) for ln, c, _ in hits]
    assert got == [
        ("per-instance-capture-memo", "self._graph = graph"),
        ("per-instance-capture-memo",
         'self._graphs["k"] = torch.cuda.CUDAGraph()'),
        ("unstable-capture-key", "memo.put((id(inputs), n), graph)"),
        ("unstable-capture-key",
         "_MEMO[time.perf_counter()] = capture_apply(fitted, inputs, n, "
         "dev,"),
    ]


# -- the port's tree ------------------------------------------------------------------

def test_scopes_are_the_jax_rules_scopes():
    assert SWALLOW_ALL_SCOPES == jdiag.SWALLOW_ALL_SCOPES
    assert CAST_BEFORE_TRANSFER_SCOPES == jdiag.CAST_BEFORE_TRANSFER_SCOPES
    assert NAN_SILENCER_SCOPES == jdiag.NAN_SILENCER_SCOPES


def test_the_ports_tree_passes_the_ast_rules_and_the_shape_gate(capsys):
    from keystone_tpu_torch.tools import lint

    assert lint.run_ast_rules() == 0
    assert lint.run_donation_shape_gate() == 0
    out = capsys.readouterr().out
    assert "donation shape gate: 2 probed site(s), 0 failure(s)" in out


def test_the_lint_tool_fails_on_an_offender(tmp_path, monkeypatch, capsys):
    from keystone_tpu_torch.tools import lint

    pkg = tmp_path / "keystone_tpu_torch"
    (pkg / "loaders").mkdir(parents=True)
    (pkg / "loaders" / "bad.py").write_text(CAST + SWALLOW)
    (pkg / "nodes").mkdir()
    (pkg / "nodes" / "nan.py").write_text(NAN)
    monkeypatch.setattr(lint, "PKG", pkg)
    monkeypatch.setattr(lint, "REPO", tmp_path)
    assert lint.run_ast_rules() == 3 + 3 + 3
    out = capsys.readouterr().out
    for code in ("cast-before-transfer", "swallow-all-handler",
                 "silent-nan-silencer"):
        assert f": {code}: " in out


@pytest.mark.parametrize("argv", [["--skip-apps"], []])
def test_the_lint_tool_exits_clean(argv, capsys):
    from keystone_tpu_torch.tools import lint

    assert lint.main(argv) == 0
    out = capsys.readouterr().out
    assert "lint: clean" in out and "hotpath passes: 0 failure(s)" in out
    assert ("pipeline checks: 0 failure(s)" in out) == (argv == [])
