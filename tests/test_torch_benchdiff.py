"""The bench-regression gate and the numerics report: the port against
``keystone_tpu``.

``benchdiff`` runs over the repo's own ``BENCH_r*.json`` and
``MULTICHIP_r*.json`` artifacts in both packages: the same artifact
parse, noise bands, per-metric verdicts, table and exit code (0 nothing
regressed, 1 usage or cross-host refusal, 2 a regression). ``numerics``
renders a post-mortem the port wrote, line for line as the JAX command
renders the same file. Every comparison is exact (the same float64
arithmetic on the same numbers, the same strings).
"""
import json
import os
from pathlib import Path

import pytest

from keystone_tpu.observability import benchdiff as jbd
from keystone_tpu.observability.numerics import (
    postmortem_report as jpostmortem_report,
)
from keystone_tpu_torch import __main__ as tmain
from keystone_tpu_torch.observability import benchdiff as tbd

REPO = Path(__file__).resolve().parent.parent

#: (base, current) -> the exit code both packages give: in-band pairs,
#: a regression (r02 -> r01) and a cross-host refusal (r06 -> r09)
PAIRS = [
    (("BENCH_r01.json", "BENCH_r02.json"), 0),
    (("BENCH_r09.json", "BENCH_r10.json"), 0),
    (("BENCH_r02.json", "BENCH_r01.json"), 2),
    (("BENCH_r04.json", "BENCH_r01.json"), 2),
    (("BENCH_r06.json", "BENCH_r09.json"), 1),
    (("MULTICHIP_r01.json", "MULTICHIP_r02.json"), None),
]


def _paths(pair):
    return [str(REPO / name) for name in pair]


@pytest.mark.parametrize("pair,code", PAIRS)
def test_exit_code_and_output_match_jax(pair, code, capsys):
    argv = _paths(pair)
    got = tbd.main(list(argv))
    port_out = capsys.readouterr()
    want = jbd.main(list(argv))
    jax_out = capsys.readouterr()
    assert got == want
    if code is not None:
        assert got == code
    assert port_out.out == jax_out.out
    assert port_out.err == jax_out.err


@pytest.mark.parametrize("pair,code", PAIRS)
def test_verdicts_match_jax(pair, code):
    base, cur = _paths(pair)
    port = tbd.compare(tbd.load_artifact(base), tbd.load_artifact(cur),
                       tbd.discover_history(cur))
    ref = jbd.compare(jbd.load_artifact(base), jbd.load_artifact(cur),
                      jbd.discover_history(cur))
    assert port == ref


def test_artifacts_parse_like_jax():
    names = sorted(p.name for p in REPO.glob("*_r*.json")
                   if p.name.startswith(("BENCH", "MULTICHIP")))
    assert names
    for name in names:
        port = tbd.load_artifact(str(REPO / name))
        ref = jbd.load_artifact(str(REPO / name))
        assert (port.round_n, port.metrics, port.meta) == \
            (ref.round_n, ref.metrics, ref.meta)
        assert tbd.artifact_prefix(name) == jbd.artifact_prefix(name)


@pytest.mark.parametrize("metric", [
    "serve_qps_per_chip", "serve_p99_ms", "h2d_bytes_per_image",
    "numerics_overhead_share", "cifar_e2e_images_per_sec_per_chip",
    "voc_map", "fleet_availability", "queue_wait_share", "x_error"])
def test_directions_and_bands_match_jax(metric):
    assert tbd.lower_is_better(metric) == jbd.lower_is_better(metric)
    assert tbd.absolute_band(metric) == jbd.absolute_band(metric)
    for base, cur in [(100.0, 91.0), (100.0, 120.0), (0.0, 0.01),
                      (-0.04, 0.01)]:
        assert tbd.classify(metric, base, cur, 0.08) == \
            jbd.classify(metric, base, cur, 0.08)


def test_usage_errors_exit_1(tmp_path, capsys):
    assert tbd.main([]) == jbd.main([]) == 1
    bad = tmp_path / "BENCH_r01.json"
    bad.write_text("[1, 2]")
    args = [str(bad), str(REPO / "BENCH_r01.json")]
    assert tbd.main(list(args)) == jbd.main(list(args)) == 1
    assert tbd.main(["--band"]) == jbd.main(["--band"]) == 1


def test_the_command_runs_benchdiff(capsys):
    assert tmain.main(["benchdiff"] + _paths(
        ("BENCH_r02.json", "BENCH_r01.json"))) == 2
    assert "regressed" in capsys.readouterr().out


# -- numerics ------------------------------------------------------------------

def _port_postmortem(tmp_path, monkeypatch):
    """A post-mortem the port writes when its tripwire names chunk 3."""
    from keystone_tpu_torch.observability import numerics
    from keystone_tpu_torch.observability.metrics import MetricsRegistry
    from keystone_tpu_torch.observability.postmortem import attach_postmortem

    monkeypatch.setenv("KEYSTONE_TORCH_POSTMORTEM_DIR", str(tmp_path))
    MetricsRegistry.get_or_create().counter("numerics.nan_total").inc(4)
    series = [{"source": "fit_streaming:cifar", "chunk": i,
               "nan": 4.0 if i == 3 else 0.0, "inf": 0.0, "min": -1.5,
               "max": 2.25, "mean": 0.125} for i in range(4)]
    exc = attach_postmortem(
        numerics.NumericsError("non-finite chunk 3"), "numerics_nan",
        {"source": "fit_streaming:cifar", "chunk": 3,
         "recent_health": series})
    return exc.postmortem_path


def test_numerics_renders_a_port_postmortem_like_jax(tmp_path, monkeypatch,
                                                     capsys):
    path = _port_postmortem(tmp_path, monkeypatch)
    assert path and os.path.exists(path)
    blob = json.loads(Path(path).read_text())
    assert "executables" in blob and "compiles" in blob
    assert tmain.main(["numerics", path]) == 0
    port_out = capsys.readouterr().out
    assert jpostmortem_report([path]) == 0
    assert port_out == capsys.readouterr().out
    assert "chunk: 3" in port_out and "nan_total=4" in port_out
    assert "fit_streaming:cifar" in port_out


def test_numerics_usage_and_unreadable_exit_1(tmp_path, capsys):
    from keystone_tpu_torch.observability.numerics import postmortem_report

    assert postmortem_report([]) == jpostmortem_report([]) == 1
    missing = str(tmp_path / "none.json")
    assert postmortem_report([missing]) == jpostmortem_report([missing]) == 1
