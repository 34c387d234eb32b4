"""Finds the benchmark's parts by name, each in a file of its own.

Under the benchmark's folder (``base``, this file's folder by default):

- ``configs/<config>.json``: one configuration (a deployment of the codec);
- ``workloads/<cell>.json``: one cell: its configuration, mix, entry, chips
  and why;
- ``mixes/<mix>.json``: one traffic mix, read by ``traffic.py``: it names
  what a call sends (``sends/<kind>.py``) and how calls arrive
  (``loops/<kind>.py``);
- ``generators/<name>.py``: the images of a configuration's ``generator``;
- ``entries/<entry>.py``: the caller of one public entry point;
- ``e2e_metrics/<metric>.py`` and ``layer_metrics/<metric>.py``: the reader
  of one end-to-end or per-layer metric;
- ``work/<pass>.py``: the operations and bytes of one pass;
- ``peaks.json``: the datasheet peaks of each card, by its name.

``BENCHMARK.json`` beside the folder says which metrics each cell reports.
A name is a letter, digit or ``_`` followed by at most 63 letters, digits,
``_``, ``.`` or ``-``; a unit is 1 to 16 of those, ``/`` and ``%``.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")

CONFIG_KEYS = {"source", "height", "width", "images_per_call", "quality",
               "precision", "block_index", "index_stride", "cards",
               "generator", "assumed", "reduced"}
CELL_KEYS = {"config", "traffic", "entry", "chips", "why"}


def check_name(name: str, what: str = "name") -> str:
    if not isinstance(name, str) or not NAME_RE.fullmatch(name):
        raise ValueError(f"bad {what} {name!r}: a letter, digit or _ then "
                         "at most 63 of letters, digits, _ . -")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT_RE.fullmatch(unit):
        raise ValueError(f"bad unit {unit!r}: 1 to 16 of letters, digits, "
                         "_ / % . -")
    return unit


def _keys(d: dict, want: set, what: str) -> dict:
    if set(d) != want:
        raise ValueError(f"{what}: keys {sorted(d)}, expected "
                         f"{sorted(want)}")
    return d


class Bench:
    """The benchmark's parts under ``base``."""

    def __init__(self, base: Path | str | None = None):
        self.base = Path(base or Path(__file__).resolve().parent)
        self.spec_path = self.base.parent / "BENCHMARK.json"
        self._modules: dict[tuple[str, str], ModuleType] = {}

    def _file(self, folder: str, name: str, suffix: str) -> Path:
        path = self.base / folder / f"{check_name(name)}{suffix}"
        if not path.is_file():
            raise FileNotFoundError(f"no {folder[:-1]} {name!r} ({path})")
        return path

    def _json(self, folder: str, name: str) -> dict:
        return json.loads(self._file(folder, name, ".json").read_text())

    def _module(self, folder: str, name: str) -> ModuleType:
        key = (folder, name)
        if key not in self._modules:
            path = self._file(folder, name, ".py")
            spec = importlib.util.spec_from_file_location(
                f"portbench_{folder}_{name.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def config(self, name: str) -> dict:
        cfg = _keys(self._json("configs", name), CONFIG_KEYS,
                    f"config {name}")
        for key in cfg["reduced"]:
            check_name(key, "reduced key")
        return cfg

    def cell(self, name: str) -> dict:
        cell = _keys(self._json("workloads", name), CELL_KEYS, f"cell {name}")
        for key in ("config", "traffic", "entry"):
            check_name(cell[key], key)
        if cell["chips"] not in (1, 4):
            raise ValueError(f"cell {name}: chips must be 1 or 4")
        return cell

    def mix(self, name: str) -> dict:
        from .traffic import check_mix

        mix = self._json("mixes", name)
        own = set()
        for folder, key in (("sends", "sends"), ("loops", "loop")):
            if key not in mix:
                raise ValueError(f"mix {name}: no {key!r}")
            own |= set(self._module(folder, mix[key]).KEYS)
        return check_mix(mix, name, own)

    def sends(self, name: str) -> ModuleType:
        return self._module("sends", name)

    def loop(self, name: str) -> ModuleType:
        return self._module("loops", name)

    def generator(self, name: str) -> ModuleType:
        return self._module("generators", name)

    def entry(self, name: str) -> ModuleType:
        return self._module("entries", name)

    def e2e_metric(self, name: str) -> ModuleType:
        return self._module("e2e_metrics", name)

    def layer_metric(self, name: str) -> ModuleType:
        return self._module("layer_metrics", name)

    def work(self, name: str) -> ModuleType:
        return self._module("work", name)

    def peaks(self, card: str) -> dict:
        table = json.loads((self.base / "peaks.json").read_text())
        if card not in table:
            raise KeyError(f"no datasheet peaks for {card!r} in peaks.json")
        return table[card]

    def spec(self) -> dict:
        return json.loads(self.spec_path.read_text())

    def metrics_of(self, cell: str, traced: bool) -> list[dict]:
        """The metrics ``cell`` reports: the end-to-end ones untraced, the
        per-layer ones traced.  A metric with a ``workloads`` list is the
        listed cells'; one without it is every cell's that reports the
        end-to-end metric it ``moves`` (or every cell's, end to end)."""
        spec = self.spec()
        e2e = [m for m in spec["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not traced:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]
