"""The benchmark's files: every configuration, cell, traffic mix, limit and
metric reader parses and is found by name, and BENCHMARK.json keeps the
contract's shape."""

from __future__ import annotations

import json
import os
import re

import pytest

from port_bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + METRICS + \
        [m["name"] for m in BENCH["end_to_end"]]
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    assert len(set(CELLS)) == len(CELLS) and len(set(METRICS)) == len(METRICS)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for text in [c["why"] for c in BENCH["configs"]] + [w["why"] for w in BENCH["workloads"]] + \
            [m["layer"] for m in BENCH["per_layer"]] + [c["source"] for c in BENCH["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text


def test_bounds():
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = spec.cell(name)
    assert cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "step_p95_ms"}
    assert cell.per_layer, "every cell reports a per-layer metric"
    e2e = {m["name"] for m in cell.end_to_end}
    for m in cell.per_layer:
        assert m["moves"] in e2e
    assert cell.traffic["kind"] in ("train", "test")
    assert cell.limits
    m = cell.m
    assert m["num_frames"] == 400 and m["n_mels"] == 128 and m["width"] == 64


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    doc = json.load(open(os.path.join(spec.ROOT, config["file"])))
    assert config["file"].startswith("port_bench/")
    assert sorted(doc["reduced"]) == sorted(config["reduced"]) == sorted(doc["departures"])
    assert len(config["reduced"]) <= 16
    for key in config["reduced"]:
        assert NAME.match(key) and not key.endswith(("_dim", "_rank")), key
    cfg = spec.config_as_run(doc)
    for key, dep in doc["departures"].items():
        node = cfg
        for part in key.split("."):
            node = node[part]
        assert node == dep["value"] and dep["why"]
    for group in ("RESNET", "AUDIO_DATA"):  # no width is cut
        for k, v in doc["published"][group].items():
            assert cfg[group][k] == v or f"{group}.{k}" in doc["departures"]


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_found(metric):
    read = spec.reader(metric)
    assert callable(read)


def test_every_config_and_metric_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for m in BENCH["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
