"""BENCHMARK.json against the benchmark's contract: keys, names, units,
lengths, and every file it names under the benchmark's own folder."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert not p.startswith("/") and not p.endswith("_torch")
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _line(entry["source"]) and _line(entry["why"])
    assert entry["file"].split("/")[0] in BENCH["paths"]
    assert (ROOT / entry["file"]).exists()
    assert len(entry["reduced"]) <= 16 and all(NAME.match(k) for k in entry["reduced"])
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    for k in ("name", "config", "traffic"):
        assert NAME.match(cell[k])
    assert cell["chips"] in (1, 4) and _line(cell["why"])
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (ROOT / "benchmark" / "drivers" / f"{traffic['driver']}.py").exists()
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = [m for m in BENCH["per_layer"] if cell["name"] in m["workloads"]]
    assert per and all(m["moves"] in e2e for m in per)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(metric):
    keys = {"name", "unit", "better", "source"}
    if metric in BENCH["end_to_end"]:
        keys |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0 < metric["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        assert _line(metric["layer"]) and metric["workloads"]
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher") and metric["source"] in SOURCES
    for w in metric.get("workloads", []):
        assert w in {c["name"] for c in BENCH["workloads"]}
    assert (ROOT / "benchmark" / "metrics" / f"{metric['name']}.py").exists()


def test_unique_names():
    for group in (BENCH["configs"], BENCH["workloads"],
                  BENCH["end_to_end"] + BENCH["per_layer"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
