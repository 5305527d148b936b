"""``check --xla`` in the port: each planner-resolved per-item node runs
once on a zero item (``analysis/resources.py::device_verify_plan``), and
its plan charge is set against the bytes it outputs (``plan_vs_device``),
against the JAX package's ``xla_verify_plan`` rows on the same apps. On
the CPU it runs the plain paths; with no card, ``--xla`` on the default
device refuses with exit 2.
"""
import pytest

from keystone_tpu import pipelines as jpipelines
from keystone_tpu.analysis.resources import xla_verify_plan
from keystone_tpu_torch import __main__ as tmain
from keystone_tpu_torch import pipelines as tpipelines
from keystone_tpu_torch.analysis.resources import (device_verify_plan,
                                                   format_device_verify)
from keystone_tpu_torch.workflow.env import PipelineEnv


@pytest.fixture(autouse=True)
def _reset():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


@pytest.mark.parametrize("app", ["cifar.random_patch", "mnist.random_fft",
                                 "speech.timit"])
def test_plan_vs_device_against_the_jax_rows(app):
    port = tpipelines.CHECK_APPS[app]()
    ref = jpipelines.CHECK_APPS[app]()
    report = port.pipeline.check(port.input_spec, name=app)
    jreport = ref.pipeline.check(ref.input_spec, name=app, data_shards=1)
    rows = device_verify_plan(report.analysis, report.plan, "cpu")
    jrows = xla_verify_plan(jreport.analysis, jreport.plan)
    assert [(r["node_id"], r["operator"]) for r in rows] == \
        [(r["node_id"], r["operator"]) for r in jrows]
    ok = [r for r in rows if r["status"] == "ok"]
    assert ok
    for r in ok:
        # the plan charges exactly what the node outputs
        assert r["plan_vs_device"] == 1.0
        assert r["device_output_bytes"] == r["plan_item_nbytes"]
        assert r["device_peak_bytes"] is None  # measured on a card only
    jok = {r["node_id"]: r for r in jrows if r["status"] == "ok"}
    for r in ok:
        if r["node_id"] in jok:
            assert r["plan_item_nbytes"] == jok[r["node_id"]][
                "plan_item_nbytes"]
    text = format_device_verify(rows, app, "cpu")
    assert f"{len(ok)}/{len(rows)} nodes run once" in text


def test_a_node_that_cannot_take_a_zero_item_is_a_named_skip():
    import torch

    from keystone_tpu_torch.analysis import as_input_spec
    from keystone_tpu_torch.workflow.transformer import Transformer

    class Factor(Transformer):
        """Shapes propagate on meta tensors; a zero item is not positive
        definite."""

        def apply(self, x):
            return torch.linalg.cholesky(x.T @ x)

    report = Factor().to_pipeline().check(as_input_spec(torch.zeros(4, 3)),
                                          name="factor")
    assert report.ok
    rows = device_verify_plan(report.analysis, report.plan, "cpu")
    assert [r["status"] for r in rows] == [
        "skip:source", "skip:unrunnable (_LinAlgError)"]


def test_check_xla_needs_a_card_unless_told_cpu(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    assert tmain.main(["check", "speech.timit", "--xla"]) == 2
    assert "--xla" in capsys.readouterr().err
    assert tmain.main(["check", "speech.timit", "--device", "cpu"]) == 2
    assert tmain.main(["check", "speech.timit", "--xla", "--device",
                       "cpu"]) == 0
    assert "plan_vs_device 1.0" in capsys.readouterr().err
