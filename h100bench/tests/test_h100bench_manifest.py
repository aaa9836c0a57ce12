"""BENCHMARK.json and every file it names, held to the benchmark's
contract: names, units, sources, metrics that each cell reports, the files
found by name; and a run without a card exits non-zero."""

import json
import os
import re
import subprocess
import sys

import pytest

from h100bench import harness
from h100bench.tests import tiny

ROOT = harness.ROOT
M = harness.load_manifest()
ALL = tiny.manifest()  # with the held cells
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj|"
                   r"head|expansion|dims|width|experts_per")


def test_h100bench_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"][:2] == ["python3", "h100bench/run.py"]
    assert M["paths"] == ["h100bench"]
    assert 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) < 64 * 1024


@pytest.mark.parametrize("man", [M, ALL], ids=["listed", "with_held"])
def test_h100bench_names_and_units(man):
    metrics = man["end_to_end"] + man["per_layer"]
    for group in (man["configs"], man["workloads"], metrics):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_h100bench_configs_and_cells():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("h100bench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg and not WIDTH.search(key)
            assert key in cfg["source_values"]
        assert any(w["config"] == c["name"] for w in M["workloads"])
    pairs = set()
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert NAME.match(w["traffic"])
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (harness.HERE / "limits" / f"{w['name']}.json").exists()


def reports(cell, metric):
    return cell in metric.get("workloads", [cell])


@pytest.mark.parametrize("man", [M, ALL], ids=["listed", "with_held"])
def test_h100bench_every_cell_reports_what_it_must(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for w in man["workloads"]:
        cell = w["name"]
        mine = [m["name"] for m in man["end_to_end"] if reports(cell, m)]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(reports(cell, m) for m in man["per_layer"])
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert reports(cell, e2e[m["moves"]]), (m["name"], cell)
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()


def test_h100bench_run_without_a_card_fails():
    if os.environ.get("CUDA_VISIBLE_DEVICES") is None:
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    else:
        env = dict(os.environ)
    res = subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload",
         M["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert res.stdout.strip() == ""


@pytest.mark.parametrize("cell", [w["name"] for w in ALL["workloads"]])
def test_h100bench_cell_files_load(cell):
    entries = harness.cell_entries(ALL, cell)
    for m in entries["per_layer"]:
        assert callable(harness.load_metric_reader(m["name"]))
    limits = json.loads((harness.HERE / "limits" / f"{cell}.json")
                        .read_text())["limits"]
    assert limits and all(v >= 0 for v in limits.values())


