"""The manifest against the benchmark's contract: names, units, files."""

import json
import re

import pytest

from perfbench.common import HERE, MANIFEST, load_json

#: a name: a letter, digit or _ first, then at most 63 letters, digits, _, . and -
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
#: a unit: 1 to 16 of letters, digits, _, /, %, . and -
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")

M = load_json(MANIFEST)
E2E = {m["name"]: m for m in M["end_to_end"]}
CELLS = {w["name"]: w for w in M["workloads"]}


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "perfbench/run.py"]
    assert M["paths"] == ["perfbench"]
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert len(json.dumps(M)) < 64 * 1024


def all_names():
    yield from (c["name"] for c in M["configs"])
    for w in M["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    yield from (m["name"] for m in M["end_to_end"] + M["per_layer"])
    for c in M["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(all_names())))
def test_names_hold_only_allowed_characters(name):
    assert NAME.fullmatch(name), name


@pytest.mark.parametrize("metric", M["end_to_end"] + M["per_layer"], ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.fullmatch(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert (HERE / "metrics" / f"{metric['name']}.py").is_file()
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if metric in M["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert metric["moves"] in E2E
        # every listed cell reports the end-to-end metric the metric moves
        for cell in metric["workloads"]:
            assert cell in E2E[metric["moves"]].get("workloads", [cell])
        assert set(metric) == {"name", "unit", "better", "source", "layer", "moves",
                               "workloads"}


def test_names_are_distinct():
    for group in (M["configs"], M["workloads"], M["end_to_end"] + M["per_layer"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("workload", M["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files(workload):
    assert workload["chips"] in (1, 4) and len(workload["why"]) <= 200
    assert (HERE / "traffic" / f"{workload['traffic']}.json").is_file()
    spec = load_json(HERE / "cells" / f"{workload['name']}.json")
    assert spec["check"]["limits"] and spec["check"]["calls"] >= 1
    reported = [m for m in M["end_to_end"] if workload["name"] in m.get("workloads",
                                                                       [workload["name"]])]
    assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
    assert any(workload["name"] in m["workloads"] for m in M["per_layer"])


@pytest.mark.parametrize("config", M["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    assert config["file"].startswith("perfbench/configs/")
    body = load_json(MANIFEST.parent / config["file"])
    assert body["name"] == config["name"] and body["source"] == config["source"]
    assert body["reduced"] == config["reduced"] == []
    assert (HERE / "families" / f"{body['family']}.py").is_file()
    assert len(config["source"]) <= 200 and len(config["why"]) <= 200


def test_setup_bound_and_four_chip_cells():
    assert E2E["setup_s"]["bound"] <= 0.25
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(M["workloads"]) // 4)
