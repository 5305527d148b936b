"""The port's cost-model calibration tool against the repository's.

``keystone_tpu_torch/tools/calibrate_cost_model.py`` is held against
``tools/calibrate_cost_model.py`` (imported as ``tools.calibrate_cost_model``
on the CPU; its module level only reads ``sys.argv``): the predicted
ranking over a grid of shapes and weight sets (the same order, costs
equal to 1e-12 relative: the same float64 formulas), the guards on the
floor-cancelled rates and the plausibility bounds, the artifact's round
trip through ``load_calibration``, and the tool run end to end on the
CPU at its small size (an artifact if and only if its printed agreement
is above half).
"""
import importlib
import json
import os
import re
import sys

import pytest

from keystone_tpu.nodes.learning import least_squares as jls
from keystone_tpu_torch.nodes.learning import least_squares as tls
from keystone_tpu_torch.tools import calibrate_cost_model as cal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the three weight surfaces of the grid: the JAX package's shipped
#: (device-calibrated) weights, the reference's EC2 ones, and a set like
#: an H100's (float32 Gram ~53 TFLOP/s, ~3.6 TB/s, 42 us a synchronizing
#: round, NVLink 4)
WEIGHT_SETS = {
    "jax_shipped": {"cpu_weight": jls.DEFAULT_CPU_WEIGHT,
                    "mem_weight": jls.DEFAULT_MEM_WEIGHT,
                    "network_weight": jls.DEFAULT_NETWORK_WEIGHT,
                    "lat_weight": jls.DEFAULT_LAT_WEIGHT},
    "ec2": dict(jls.REFERENCE_EC2_WEIGHTS),
    "h100_like": {"cpu_weight": 1.876e-14, "mem_weight": 1.106e-12,
                  "network_weight": 8.889e-12, "lat_weight": 4.231e-05},
}
SHAPES = [(65536, 256), (65536, 1024), (32768, 4096), (20480, 8192)]
COST_RTOL = 1e-12


@pytest.fixture(scope="module")
def jtool():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    return importlib.import_module("tools.calibrate_cost_model")


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch, tmp_path):
    # the shipped weights: an artifact in the checkout's build/ must not
    # be read by the loader checks here
    monkeypatch.setenv(tls.CALIBRATION_ENV,
                       str(tmp_path / "no-calibration.json"))
    tls.clear_calibration_cache()
    yield
    tls.clear_calibration_cache()


@pytest.mark.parametrize("weights", sorted(WEIGHT_SETS))
@pytest.mark.parametrize("n,d", SHAPES)
def test_predicted_ranking_matches_jax(jtool, n, d, weights):
    w = WEIGHT_SETS[weights]
    args = (n, d, 10, w["cpu_weight"], w["mem_weight"],
            w["network_weight"], w["lat_weight"])
    rank, costs = cal.predicted_ranking(*args)
    jrank, jcosts = jtool.predicted_ranking(*args)
    assert rank == jrank
    assert set(costs) == set(jcosts)
    for name in costs:
        assert costs[name] == pytest.approx(jcosts[name], rel=COST_RTOL)


def test_floor_cancelled_retries_once_then_refuses():
    calls = []

    def jittery():
        calls.append(1)
        return 2.0, 1.0, 10.0          # the large size not slower

    with pytest.raises(SystemExit, match="unmeasurable"):
        cal._floor_cancelled("fake rate", jittery)
    assert len(calls) == 2

    readings = iter([(2.0, 2.0, 10.0), (1.0, 3.0, 10.0)])
    assert cal._floor_cancelled("fake rate",
                                lambda: next(readings)) == 5.0


@pytest.mark.parametrize("value", [1e-3, 1e20, float("nan"), float("inf")])
def test_sanity_bound_refuses_an_implausible_rate(value):
    with pytest.raises(SystemExit, match="plausible range"):
        cal._sanity_bound("rate", value, 1e6, 1e13, "elements/s")


def test_sanity_bound_passes_a_plausible_rate():
    assert cal._sanity_bound("rate", 5e11, 1e6, 1e13, "elements/s") == 5e11


def test_write_artifact_round_trips_through_load_calibration(tmp_path,
                                                             monkeypatch):
    weights = WEIGHT_SETS["h100_like"]
    path = str(tmp_path / "sub" / "cal.json")
    assert cal.write_artifact(path, weights, 2, 3) == path
    assert not os.path.exists(path + ".tmp")
    blob = json.load(open(path))
    assert blob["agreement"] == "2/3" and blob["device"] == "cpu"
    assert blob["power_limit_w"] is None and blob["tool"] == cal.TOOL
    assert {"hostname", "timestamp", "small"} <= set(blob)
    loaded, provenance = tls.load_calibration(path)
    assert loaded == weights
    assert provenance["source"] == "artifact"
    assert provenance["device"] == "cpu" and provenance["path"] == path
    # an estimator built with the artifact's path in the environment
    # takes its weights
    monkeypatch.setenv(tls.CALIBRATION_ENV, path)
    est = tls.LeastSquaresEstimator()
    assert {k: getattr(est, k) for k in weights} == weights
    assert est._weight_provenance["source"] == "artifact"


def test_main_writes_an_artifact_iff_agreement_above_half(tmp_path, capsys):
    out = str(tmp_path / "cal.json")
    assert cal.main(["--small", "--device", "cpu", "--out", out]) == 0
    text = capsys.readouterr().out
    hits, total = map(int, re.search(
        r"agreement: (\d+)/(\d+) shapes", text).groups())
    assert total == len(cal.SMALL_SHAPES)
    assert os.path.exists(out) == (2 * hits > total), text
    if os.path.exists(out):
        weights, provenance = tls.load_calibration(out)
        assert provenance["source"] == "artifact"
        blob = json.load(open(out))
        assert weights == {k: blob[k] for k in weights}
        assert blob["agreement"] == f"{hits}/{total}" and blob["small"]


def test_the_tool_refuses_cuda_without_a_card():
    if cal.torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cal.main(["--small"])


def test_host_syncs_are_not_counted_on_the_cpu():
    assert cal.count_host_syncs(lambda: None,
                                cal.torch.device("cpu")) is None


def test_net_weight_comes_from_the_published_table(monkeypatch):
    monkeypatch.setattr(cal, "device_name",
                        lambda dev: "NVIDIA H100 80GB HBM3")
    assert cal.derive_net_weight(None) == pytest.approx(4.0 / 450e9)
    monkeypatch.setattr(cal, "device_name", lambda dev: "cpu")
    assert cal.derive_net_weight(None) == pytest.approx(4.0 / 100e9)


def test_choice_at_is_the_estimators_choice():
    """Under the EC2 weights the tool's choice at phase 4e's shape is the
    reference surface's, resident and streamed; under the H100-like set
    the resident choice moves to L-BFGS and the streamed one stays."""
    ec2 = WEIGHT_SETS["ec2"]
    assert cal.choice_at(ec2, 20480, 8192, 10) == \
        "BlockLeastSquaresEstimator(1000, 3)"
    assert cal.choice_at(ec2, 20480, 8192, 10, streaming=True) == \
        "BlockLeastSquaresEstimator(1000, 3)"
    h100 = WEIGHT_SETS["h100_like"]
    assert cal.choice_at(h100, 20480, 8192, 10) == "DenseLBFGSwithL2"
    assert cal.choice_at(h100, 20480, 8192, 10, streaming=True) == \
        "BlockLeastSquaresEstimator(1000, 3)"


def test_app_choices_match_jax():
    """Each app's optimizable node with cost weights, chosen from the
    analyzer's shapes under each weight set: the JAX package's column PCA
    choice at the same geometry and weights."""
    from keystone_tpu.nodes.learning import pca as jpca

    rows = cal.app_choices(WEIGHT_SETS)
    assert {app for app, *_ in rows} == {"imagenet.sift_lcs_fv",
                                         "voc.sift_fisher"}
    for app, node, (n, item), picks in rows:
        assert node == "ColumnPCAEstimator"
        d, cols = item
        for name, weights in WEIGHT_SETS.items():
            want = jpca.ColumnPCAEstimator(8, **weights)._choose(
                d, cols, n, 1)
            assert picks[name] == type(want.node).__name__, (app, name)
