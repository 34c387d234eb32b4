"""The loader and ``BENCHMARK.json``: every part is found by name, the
spec keeps the benchmark's contract, and bad names and units are refused."""

from __future__ import annotations

import json

import pytest

from portbench import loader
from portbench.loader import Bench

from .conftest import BASE, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", ["corpus512.encode", "a", "_x-1.b",
                                  "9" * 64])
def test_good_names_pass(name):
    assert loader.check_name(name) == name


@pytest.mark.parametrize("name", ["", "a b", "a,b", "a/b", ".a", "-a",
                                  "µs", "a" * 65, "a\tb", None])
def test_bad_names_are_refused(name):
    with pytest.raises(ValueError):
        loader.check_name(name)


@pytest.mark.parametrize("unit", ["MP/s", "%", "ms", "s", "tokens/s",
                                  "a" * 16])
def test_good_units_pass(unit):
    assert loader.check_unit(unit) == unit


@pytest.mark.parametrize("unit", ["", "MP per s", "µs", "a" * 17, "ms,"])
def test_bad_units_are_refused(unit):
    with pytest.raises(ValueError):
        loader.check_unit(unit)


def test_a_name_with_a_slash_finds_no_file():
    with pytest.raises(ValueError):
        Bench().config("../BENCHMARK")


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_parts_by_name(cell):
    b = Bench()
    c = b.cell(cell)
    cfg = b.config(c["config"])
    b.mix(c["traffic"])
    entry = b.entry(c["entry"])
    assert entry.KIND in ("encode", "decode")
    assert callable(entry.setup) and callable(entry.call)
    b.work(f"{entry.KIND}_pass")
    assert cfg["cards"] == c["chips"]
    spec_cell = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert {k: spec_cell[k] for k in ("config", "traffic", "chips", "why")} \
        == {k: c[k] for k in ("config", "traffic", "chips", "why")}
    names = {m["name"] for m in b.metrics_of(cell, False)}
    assert "setup_s" in names and len(names) >= 2
    assert b.metrics_of(cell, True)


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_each_metric_has_its_reader(metric):
    b = Bench()
    reader = (b.e2e_metric if metric in SPEC["end_to_end"]
              else b.layer_metric)(metric["name"])
    assert callable(reader.read)


def test_the_spec_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        loader.check_name(c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = Bench().config(c["name"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
        names.add(c["name"])
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(SPEC["workloads"]) == len(set(CELLS))
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(
        1, len(CELLS) // 4)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    metric_names = list(e2e) + [m["name"] for m in SPEC["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        loader.check_name(m["name"])
        loader.check_unit(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]]["workloads"]
    for cell in CELLS:
        reported = [m for m in SPEC["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in SPEC["per_layer"])
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert layers == {"kernels", "device", "transfers", "local mesh"}


def test_the_benchmark_holds_only_its_own_files():
    for p in BASE.rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            rel = p.relative_to(BASE).as_posix()
            assert all(ch.isalnum() or ch in "_.-/" for ch in rel), rel
