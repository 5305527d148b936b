"""The whole-window arithmetic and the reduction of a trace, on synthetic
numbers."""
from __future__ import annotations

import statistics

import pytest

from perfbench import core, trace


def test_rate_runs_to_the_end_of_the_last_whole_unit():
    # three fits of 100 rows ending at 1, 2 and 4 s after a start at 0:
    # the window closed at 3 s but the last fit counts whole
    assert core.whole_window_rate([100, 100, 100], 0.0, [1.0, 2.0, 4.0]) == 75.0
    with pytest.raises(ValueError):
        core.whole_window_rate([], 0.0, [])


def test_p95_is_the_tail_of_every_call():
    calls = [10.0] * 95 + [100.0] * 5
    assert core.p95(calls) == pytest.approx(
        statistics.quantiles(calls, n=100, method="inclusive")[94])
    assert core.p95([1.0, 2.0, 3.0, 40.0] * 25) > 3.0
    assert core.p95([7.0]) == 7.0


def test_busy_and_gaps_of_overlapping_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (9.0, 12.0)]
    assert trace.busy(iv, 0.0, 10.0) == pytest.approx(4.0)
    assert trace.gaps(iv, 0.0, 10.0) == [(2.0, 3.0), (4.0, 9.0)]
    assert trace.gaps([], 1.0, 2.0) == [(1.0, 2.0)]


def _event(name, cat, ts_us, dur_us):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts_us, "dur": dur_us}


def test_summarize_idle_share_breakdown_and_kernel_seconds():
    events = [
        _event(trace.UNIT_SPAN, "user_annotation", 0, 1_000_000),
        _event("void fused_featurize_kernel(float const*)", "kernel",
               100_000, 400_000),
        _event("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy",
               500_000, 100_000),
        _event("void gemm_kernel<float>()", "kernel", 700_000, 100_000),
        _event("aten::linalg_cholesky", "cpu_op", 600_000, 200_000),
        _event("aten::mm", "cpu_op", 610_000, 50_000),
        _event("outside", "kernel", 2_000_000, 5_000),
    ]
    s = trace.summarize(events)
    assert s.window_s == pytest.approx(1.0)
    assert s.busy_s == pytest.approx(0.6)
    idle = 100 * (1 - s.busy_s / s.window_s)
    assert idle == pytest.approx(40.0)
    assert s.kernel_seconds(
        lambda n: trace.kernel_is(n, "fused_featurize_kernel")) == \
        pytest.approx(0.4)
    b = s.breakdown()
    assert b["device_ops"][0][0].startswith("void fused_featurize_kernel")
    # the gaps 800-1000, 0-100 and 600-700 ms; in the last the host runs
    # aten::mm inside aten::linalg_cholesky
    assert [round(g, 6) for _, g in b["idle_gaps"]] == [0.2, 0.1, 0.1]
    assert sorted(n for n, _ in b["idle_gaps"]) == [
        "host: (no host event)", "host: (no host event)", "host: aten::mm"]


def test_summarize_needs_the_unit_spans():
    with pytest.raises(ValueError):
        trace.summarize([_event("k", "kernel", 0, 1)])


def test_kernel_names_are_matched_whole():
    assert trace.kernel_is("void gram_cross_kernel<true>(float const*, int)",
                           "gram_cross_kernel")
    assert not trace.kernel_is("void my_gram_cross_kernel2()",
                               "gram_cross_kernel")
    assert trace.kernel_is("void (anonymous namespace)::gram_cross_kernel()",
                           "gram_cross_kernel")


def test_the_programs_kernels_are_found_in_its_sources():
    # the frozen list is today's scan: a kernel added to or renamed in the
    # program has to be named in work/kernels.py before this passes
    from perfbench.work.kernels import HAND_WRITTEN

    names = trace.scan_kernels()
    for k in ("fused_featurize_kernel", "gram_cross_kernel",
              "quantized_affine_kernel", "banded_matmul_kernel",
              "fv_moments_kernel"):
        assert k in names
    assert list(HAND_WRITTEN) == names


def test_readers_return_nothing_without_their_work():
    s = trace.summarize([_event(trace.UNIT_SPAN, "user_annotation", 0, 10),
                         _event("void gemm()", "kernel", 0, 5)])
    r = trace.Readings(s, [{"flops": 1e9}], None)
    feat = core.reader("featurize_roofline.fit")
    gram = core.reader("gram_roofline.streamed_fit")
    opt = core.reader("optimizer_ms.fit")
    lib = core.reader("library_device_ms.fit")
    assert feat.read(r) is None and gram.read(r) is None and opt.read(r) is None
    assert lib.read(r) == pytest.approx(5e-3)
    assert core.reader("idle_share.fit").read(r) == \
        pytest.approx(50.0)


def test_widest_gap_reads_the_reference_at_the_predicted_class():
    import torch

    ref = torch.tensor([[1.0, 3.0, 2.0], [0.0, -1.0, 5.0]], dtype=torch.float64)
    assert core.widest_gap(ref, torch.tensor([1, 2]), 2.0) == 0.0
    assert core.widest_gap(ref, torch.tensor([2, 2]), 2.0) == pytest.approx(0.5)
    assert core.widest_gap(ref, torch.tensor([1, 7]), 2.0) == float("inf")
    assert core.widest_gap(ref, torch.tensor([1]), 2.0) == float("inf")


@pytest.mark.parametrize("kind,names", [
    ("mfu", ["mfu.fit", "mfu.streamed_fit", "mfu.apply"]),
    ("idle_share", ["idle_share.fit", "idle_share.streamed_fit",
                    "idle_share.apply"]),
])
def test_metrics_of_one_kind_share_its_reader(kind, names):
    # a new metric of a kind the benchmark reads needs no new reader
    for name in names + [kind + ".a_cell_added_later"]:
        assert core.reader(name) is core.load_module("metrics", kind)
