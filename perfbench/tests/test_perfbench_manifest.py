"""BENCHMARK.json against the rules it is held to: names, units, keys,
and that every name leads to its file."""
from __future__ import annotations

import json
import re

import pytest

from perfbench import core

BENCH = core.manifest()
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|experts_per|num_filters|"
                   r"features|patch|pool|input_dim|num_classes")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((core.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    cells = 24
    seconds = ((2 + 14 * cells) * (BENCH["run_seconds"] + 60)
               + cells * 2 * 90 + 1200)
    assert seconds <= 43200


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries_have_only_their_keys_and_good_names(section):
    entries = BENCH[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert set(e) <= ENTRY_KEYS[section], e
        assert core.NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert core.UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]


def test_metric_names_are_unique_across_sections():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)


def test_end_to_end_bounds_and_sources():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        if m["name"] == "setup_s":
            assert "workloads" not in m


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"] if core.applies(m, w["name"])]
        layers = [m for m in BENCH["per_layer"] if core.applies(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2 and layers, w["name"]
        for m in layers:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_metric_cells_configs_drivers_and_readers_exist():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", [])) <= cells, m["name"]
    for m in BENCH["per_layer"]:
        assert core.reader(m["name"]).read, m["name"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for w in BENCH["workloads"]:
        cell = core.find_cell(w["name"])
        assert cell.entry["chips"] in (1, 4)
        assert core.part("drivers", cell.traffic["driver"] + ".py").is_file()
        assert core.part("adapters", cell.config["adapter"] + ".py").is_file()
        assert cell.workload["trace_units"] >= 1
        assert cell.workload["check"]["limit"] > 0


def test_pairs_of_config_and_traffic_are_unique_and_at_most_a_quarter_on_four():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(pairs) // 4)


def test_configs_files_lie_under_paths_and_list_every_change():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("perfbench/")
        cfg = json.loads((core.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert core.NAME.match(key) and key in cfg["values"]
            assert not WIDTH.search(key), f"{key} names a width"
