"""The readers of the program's spans (``spans.py``, ``metrics/*_idle_ms``)
on synthetic traces, and the frozen span table against the program's
catalogue."""
from __future__ import annotations

import pytest

from keystone_tpu_torch.observability import names
from perfbench import core, spans, trace


def _summary(host, device, window=(0.0, 1.0)):
    return trace.Summary([(n, a, b, "kernel") for n, a, b in device],
                         list(host), window)


def _readings(summary, units=1):
    return trace.Readings(summary, [{"flops": 1.0}] * units)


def _read(kind, r):
    return core.load_module("metrics", kind).read(r)


def test_the_frozen_table_is_the_programs_catalogue():
    assert spans.LAYERS == names.SPAN_LAYERS
    assert spans.NODE_LAYER == names.NODE_SPAN_LAYER
    for name in ("stall:stream", "factor:bcd_core", "Scaler#3",
                 "pipeline.fit", "aten::mm", "perfbench.unit"):
        assert spans.layer_of(name) == names.span_layer(name), name
    layers = {m["layer"] for m in core.manifest()["per_layer"]}
    assert set(spans.LAYERS.values()) <= layers


def test_idle_is_split_by_the_innermost_program_span():
    # device busy 0-0.1 and 0.9-1.0; idle 0.1-0.9 under:
    # execute:fit 0.05-0.95 > Node#1 0.1-0.8 > factor:bcd_core 0.2-0.4,
    # and optimize: 0.85-0.9 inside execute:fit alone
    host = [("execute:fit", 0.05, 0.95), ("Node#1", 0.1, 0.8),
            ("factor:bcd_core", 0.2, 0.4), ("optimize:DefaultOptimizer",
                                            0.85, 0.9),
            ("aten::mm", 0.25, 0.3)]
    s = _summary(host, [("k", 0.0, 0.1), ("k", 0.9, 1.0)])
    by = spans.idle_by_layer(s)
    assert by[spans.SOLVER] == pytest.approx(0.2)
    assert by[spans.OPTIMIZER] == pytest.approx(0.05)
    # the node 0.1-0.2 and 0.4-0.8, execute:fit 0.8-0.85
    assert by[spans.EXECUTOR] == pytest.approx(0.55)
    assert None not in by
    assert sum(by.values()) == pytest.approx(
        s.window_s - s.busy_s)


def test_harness_annotations_are_ignored_and_the_rest_is_unattributed():
    host = [("pipeline.fit", 0.0, 1.0), ("pipeline.build", 0.0, 0.3),
            ("perfbench.unit", 0.0, 1.0), ("stall:stream", 0.5, 0.7)]
    s = _summary(host, [("k", 0.3, 0.5)])
    by = spans.idle_by_layer(s)
    assert by[spans.INGEST] == pytest.approx(0.2)
    assert by[None] == pytest.approx(0.6)
    assert spans.EXECUTOR not in by


def test_spans_of_two_threads_take_the_latest_started():
    # a stall opened at 0.2 inside a node opened at 0.1; the node closes
    # first (another thread's span): the stall alone covers 0.6-0.8
    host = [("Node#2", 0.1, 0.6), ("stall:s", 0.2, 0.8)]
    by = spans.idle_by_layer(_summary(host, [], window=(0.0, 1.0)))
    assert by[spans.EXECUTOR] == pytest.approx(0.1)
    assert by[spans.INGEST] == pytest.approx(0.6)
    assert by[None] == pytest.approx(0.3)


def test_readers_divide_by_units_and_stay_silent_without_spans():
    host = [("execute:get", 0.0, 0.5), ("optimize:DefaultOptimizer", 0.0,
                                        0.1),
            ("execute:get", 0.5, 1.0), ("optimize:DefaultOptimizer", 0.5,
                                        0.6)]
    device = [("k", 0.1, 0.45), ("k", 0.6, 0.95)]
    r = _readings(_summary(host, device), units=2)
    assert _read("optimizer_idle_ms", r) == pytest.approx(1e3 * 0.2 / 2)
    assert _read("executor_idle_ms", r) == pytest.approx(1e3 * 0.1 / 2)
    # no solver or ingest span in the units' span: a program without
    # them, as the parent of these spans is, reads nothing
    assert _read("solver_idle_ms", r) is None
    assert _read("ingest_idle_ms", r) is None
    bare = _readings(_summary([("pipeline.apply", 0.0, 1.0)], device))
    assert all(_read(k, bare) is None for k in (
        "optimizer_idle_ms", "executor_idle_ms", "solver_idle_ms",
        "ingest_idle_ms"))
    assert _read("optimizer_idle_ms", trace.Readings(
        _summary(host, device), [])) is None


def test_a_span_with_no_idle_reads_zero():
    host = [("block:gram_bcd", 0.2, 0.4)]
    r = _readings(_summary(host, [("k", 0.0, 1.0)]))
    assert _read("solver_idle_ms", r) == 0.0


def test_every_new_metric_is_read_by_its_kind():
    kinds = {"ingest_idle_ms", "solver_idle_ms", "optimizer_idle_ms",
             "executor_idle_ms"}
    entries = [m for m in core.manifest()["per_layer"]
               if m["name"].split(".")[0] in kinds]
    assert len(entries) == 9
    for m in entries:
        assert m["source"] == "program_span" and m["unit"] == "ms"
        assert core.reader(m["name"]).__name__.endswith(
            m["name"].split(".")[0])
