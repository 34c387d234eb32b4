"""On the card (marker ``gpu``; skipped without one): the control at each
cell's own size.  The program's float32 path in place of the exact one the
configuration states has to come out not correct on three seeds, where
the program as configured comes out correct.  Run on the card:

    python -m pytest portbench/tests/test_portbench_card.py -m gpu -q -s
"""

from __future__ import annotations

import json

import pytest

from portbench import control
from portbench.loader import Bench

from .conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
SEEDS = [2**31 + 101, 2**31 + 202, 2**31 + 303]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_the_control_is_refused_at_the_cells_own_size(cell):
    import torch

    chips = Bench().cell(cell)["chips"]
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} cards")
    for seed, correct, numbers in control.readings(
            Bench(), cell, SEEDS, 2.0, precision="fast"):
        print(json.dumps({"cell": cell, "seed": seed, "control": True,
                          "numbers": numbers}))
        assert not correct, (seed, numbers)
    for seed, correct, numbers in control.readings(Bench(), cell, SEEDS[:1],
                                                   2.0):
        print(json.dumps({"cell": cell, "seed": seed, "control": False,
                          "numbers": numbers}))
        assert correct, (seed, numbers)
