"""The fast-precision cell (``corpus512.encode-fast``) and its parts: the
float32 reference loads nothing of the program, a small cell of the same
files runs correct on the CPU and its control (the program in exact mode)
is refused, the entropy stage says when it transformed pixels, and the
kernel's roofline share reads the pixel-input kernel alone."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import control, harness
from portbench.loader import Bench
from tinyimgcodec_tpu_torch import api, profiling

from .conftest import ROOT, small_copy

MS = 1_000_000  # ns
PIXEL_KERNEL = ("void (anonymous namespace)::encode2_kernel<false>(void "
                "const*, float const*, float, unsigned int const*)")
COEFF_KERNEL = PIXEL_KERNEL.replace("<false>", "<true>")


@pytest.fixture(scope="module")
def fast_bench(tmp_path_factory):
    """The small copy with ``small-q50-fast`` (the fast configuration at
    3 images of 64x64) and ``small.encode-fast`` (the fast cell's files,
    every answer judged) added, reporting what the real cell reports."""
    dest = tmp_path_factory.mktemp("fast")
    base = small_copy(dest)
    cfg = json.loads((base / "configs" / "corpus512-q50-fast.json")
                     .read_text())
    cfg.update(height=64, width=64, images_per_call=3)
    (base / "configs" / "small-q50-fast.json").write_text(json.dumps(cfg))
    cell = json.loads((base / "workloads" / "corpus512.encode-fast.json")
                      .read_text())
    cell.update(config="small-q50-fast", traffic=cell["traffic"] + ".all")
    (base / "workloads" / "small.encode-fast.json").write_text(
        json.dumps(cell))
    spec = json.loads((dest / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "corpus512.encode-fast" in m.get("workloads", []):
            m["workloads"].append("small.encode-fast")
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return Bench(base)


def _run(bench, traced=False, **kw):
    return harness.run(bench, "small.encode-fast", 2**31 + 23, 0.3, traced,
                       time.perf_counter(), device="cpu",
                       log=lambda *a, **k: None, **kw)


def test_the_torch_reference_loads_nothing_of_the_program():
    code = (f"import sys, json; sys.path.insert(0, {str(ROOT)!r}); "
            "import portbench.reference_torch.fast; "
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in list(sys.modules)})))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert {"portbench", "torch"} <= tops
    assert not tops & {"tinyimgcodec_tpu_torch", "tinyimgcodec_tpu", "jax",
                       "jaxlib", "flax"}


@pytest.mark.parametrize("traced", [False, True])
def test_a_small_fast_cell_runs_correct(fast_bench, traced):
    r = _run(fast_bench, traced)
    assert r["correct"] is True and r["failed"] == 0
    assert r["checks"]["streams_wrong"]["value"] == 0
    want = {m["name"] for m in fast_bench.metrics_of("small.encode-fast",
                                                     traced)}
    if traced:
        # the roofline shares read nothing without a card's timeline
        want = {n for n in want if "roofline" not in n}
        assert "idle_in_entropy.encode" in want
    assert set(r["metrics"]) == want


def test_the_control_in_exact_mode_is_refused(fast_bench):
    (seed, correct, numbers), = control.readings(
        fast_bench, "small.encode-fast", [5], 0.3, precision="exact",
        device="cpu")
    assert correct is False and numbers["streams_wrong"] > 0


def test_the_fast_answers_refuse_an_exact_configuration(fast_bench):
    cfg = fast_bench.config("small-q50-exact")
    with pytest.raises(ValueError, match="fast precision only"):
        fast_bench.sends("images_fast").make([], cfg, {})


@pytest.mark.parametrize("precision, version, want", [
    ("fast", "v2", 3 * 64), ("fast", "v1", 3 * 64), ("exact", "v2", None)])
def test_the_entropy_stage_counts_the_blocks_it_transformed(precision,
                                                            version, want):
    from tinyimgcodec_tpu_torch.pipeline import compress_batch_device

    images = np.random.default_rng(1).integers(0, 256, (3, 64, 64),
                                               dtype=np.uint8)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        t0 = time.time_ns()
        if version == "v2":
            api.compress_batch(images, 50, precision=precision, device="cpu")
        else:
            compress_batch_device(images, 50, precision=precision,
                                  version="v1", device="cpu")
    recs = [r for r in profiling.spans()[0] if r.start_ns >= t0
            and r.name == "codec.encode.entropy"]
    assert len(recs) == 1
    assert recs[0].counts.get("from_pixels") == want


def _record(ops, precision="fast"):
    cfg = {"height": 512, "width": 512, "images_per_call": 49,
           "precision": precision}
    return {"kind": "encode", "calls": [(0.0, 0.01, 0, True),
                                        (0.01, 0.02, 1, True)],
            "window_s": 0.02, "config": cfg, "card": "NVIDIA H100 80GB HBM3",
            "stream_bytes": [904_045] * 2, "bench": Bench(),
            "timeline": {"window": (0, 20 * MS), "device_ops": ops,
                         "spans": [], "host_ops": [], "cards": [0]}}


def test_the_pixel_kernels_roofline_reads_that_kernel_alone():
    read = Bench().layer_metric("encode2_pixels_roofline").read
    ops = [(0, 1 * MS, 1 * MS + 120_000, PIXEL_KERNEL, "kernel"),
           (0, 11 * MS, 11 * MS + 80_000, PIXEL_KERNEL, "kernel"),
           (0, 2 * MS, 3 * MS, "place_kernel", "kernel"),
           (0, 3 * MS, 4 * MS, "Memset (Device)", "memset"),
           (0, 5 * MS, 6 * MS, "Memcpy HtoD (Pageable -> Device)",
            "host_copy")]
    got = read(_record(ops))
    # two calls of 200 704 blocks, 2048 float32 operations each, at
    # 67 TFLOP/s, against the two pixel-input launches' 200 us
    least = 2 * 200_704 * 2048 / 6.7e13
    assert got["bound"] == "operations"
    assert got["value"] == pytest.approx(100 * least / 200e-6)
    # no pixel-input launch: exact mode, or a window without one
    coeff = [(0, 1 * MS, 2 * MS, COEFF_KERNEL, "kernel")] + ops[2:]
    assert read(_record(coeff, "exact")) is None
    assert read(dict(_record(ops), timeline=None)) is None


@pytest.mark.gpu
def test_the_fast_cells_control_is_refused_on_the_card():
    """The control at the cell's own size: the program in exact mode, which
    the fast reference has to refuse, where the program as configured
    comes out correct.  Run on the card:

        python -m pytest portbench/tests/test_portbench_fast.py -m gpu -q -s
    """
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = "corpus512.encode-fast"
    seeds = [2**31 + 401, 2**31 + 502, 2**31 + 603]
    for seed, correct, numbers in control.readings(Bench(), cell, seeds, 2.0,
                                                   precision="exact"):
        print(json.dumps({"cell": cell, "seed": seed, "control": True,
                          "numbers": numbers}))
        assert not correct, (seed, numbers)
    for seed, correct, numbers in control.readings(Bench(), cell, seeds[:1],
                                                   2.0):
        print(json.dumps({"cell": cell, "seed": seed, "control": False,
                          "numbers": numbers}))
        assert correct, (seed, numbers)
