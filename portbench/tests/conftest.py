"""Shared by the benchmark's CPU tests: a copy of the benchmark's folder
with small cells added as files, run on the CPU through the kernels' plain
versions (``device="cpu"``)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

BASE = Path(__file__).resolve().parents[1]
ROOT = BASE.parent

# small stand-ins of the real configurations: (real config, changes)
SMALL_CONFIGS = {
    "small-q50-exact": ("corpus512-q50-exact",
                        {"height": 64, "width": 64, "images_per_call": 3}),
    "small256-q50-exact": ("corpus512-q50-exact",
                           {"height": 256, "width": 256,
                            "images_per_call": 4}),
    "smallframe-q50-exact": ("uhd8k-q50-exact",
                             {"height": 43, "width": 61}),
    "smallx4-q50-exact": ("corpus512x4-q50-exact",
                          {"height": 32, "width": 32, "images_per_call": 8}),
}
# small cells: (config, the cell whose files give their mix and entry, the
# cell whose metrics they report)
SMALL_CELLS = {
    "small.encode": ("small-q50-exact", "corpus512.encode",
                     "corpus512.encode"),
    "small.decode": ("small-q50-exact", "corpus512.decode",
                     "corpus512.decode"),
    "small256.encode": ("small256-q50-exact", "corpus512.encode",
                        "corpus512.encode"),
    "small256.decode": ("small256-q50-exact", "corpus512.decode",
                        "corpus512.decode"),
    "smallframe.encode": ("smallframe-q50-exact", "uhd8k.encode",
                          "corpus512.encode"),
    "smallx4.encode": ("smallx4-q50-exact", "corpus512x4.encode",
                       "corpus512x4.encode"),
}


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=2) + "\n")


def small_copy(dest: Path) -> Path:
    """A copy of the benchmark (its folder and ``BENCHMARK.json``) under
    ``dest`` with the small configurations and cells added as files and
    entries; returns the copy's folder."""
    base = dest / "portbench"
    shutil.copytree(BASE, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, (real, changes) in SMALL_CONFIGS.items():
        cfg = json.loads((base / "configs" / f"{real}.json").read_text())
        cfg.update(changes)
        _write(base / "configs" / f"{name}.json", cfg)
    for mix in (base / "mixes").glob("*.json"):
        # the small cells compare every call's answer
        every = json.loads(mix.read_text())
        every["check_every"] = 1
        _write(mix.with_name(mix.stem + ".all.json"), every)
    for name, (config, files, metrics) in SMALL_CELLS.items():
        cell = json.loads((base / "workloads" / f"{files}.json").read_text())
        cell["config"] = config
        cell["traffic"] += ".all"
        _write(base / "workloads" / f"{name}.json", cell)
        for m in spec["end_to_end"] + spec["per_layer"]:
            if metrics in m.get("workloads", []):
                m["workloads"].append(name)
    _write(dest / "BENCHMARK.json", spec)
    return base


@pytest.fixture(scope="session")
def small_bench(tmp_path_factory):
    from portbench.loader import Bench

    return Bench(small_copy(tmp_path_factory.mktemp("bench")))
