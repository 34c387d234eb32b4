"""The cell of streams without an index (``corpus512.decode-noindex``) and
its parts: the streams are the upstream layout, byte for byte the port's
``container.compress(..., block_index=False)``; what cannot be cut is
refused; a small cell of the same files runs correct on the CPU through
the host-entropy leg, its traced run splits the card's idle time into that
leg's stages; a wrong answer and the control are refused."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest

from portbench import control, harness
from portbench.loader import Bench
from tinyimgcodec_tpu_torch import container, profiling

from .conftest import small_copy

CELL = "corpus512.decode-noindex"
# small twins of the cell: (name, its configuration's changes)
TWINS = {"small.decode-noindex": {"height": 64, "width": 64,
                                  "images_per_call": 3},
         "small256.decode-noindex": {"height": 256, "width": 256,
                                     "images_per_call": 4}}
STAGES = ["prepare", "host_entropy", "compact", "upload", "transform",
          "pull"]


@pytest.fixture(scope="module")
def noindex_bench(tmp_path_factory):
    """The small copy with the twins of the cell added (its files, every
    answer judged), reporting what the real cell reports."""
    dest = tmp_path_factory.mktemp("noindex")
    base = small_copy(dest)
    real = json.loads((base / "configs" / "corpus512-q50-noindex.json")
                      .read_text())
    cell = json.loads((base / "workloads" / f"{CELL}.json").read_text())
    spec = json.loads((dest / "BENCHMARK.json").read_text())
    for name, changes in TWINS.items():
        config = name.replace(".decode", "-q50")
        (base / "configs" / f"{config}.json").write_text(
            json.dumps(dict(real, **changes)))
        (base / "workloads" / f"{name}.json").write_text(json.dumps(
            dict(cell, config=config, traffic=cell["traffic"] + ".all")))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if CELL in m.get("workloads", []):
                m["workloads"].append(name)
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return Bench(base)


def _config(h, w, quality, block_index=False):
    return {"height": h, "width": w, "quality": quality,
            "block_index": block_index, "index_stride": 64}


def _sends():
    return Bench().sends("reference_streams_noindex")


def _run(bench, name="small.decode-noindex", traced=False, seconds=0.3):
    return harness.run(bench, name, 2**31 + 41, seconds, traced,
                       time.perf_counter(), device="cpu",
                       log=lambda *a, **k: None)


@pytest.mark.parametrize("n, h, w, quality", [
    (2, 24, 40, 10), (2, 37, 61, 50), (2, 83, 29, 90), (1, 512, 512, 50)],
    ids=["24x40-q10", "37x61-q50", "83x29-q90", "512x512-q50"])
def test_the_streams_are_the_ports_streams_without_an_index(n, h, w,
                                                            quality):
    images = np.random.default_rng(h * w + quality).integers(
        0, 256, (n, h, w), dtype=np.uint8)
    images[:, : h // 2] //= 4  # smooth rows beside the noise
    items, _, expected = _sends().make([images], _config(h, w, quality),
                                       {})
    want = [container.compress(im, quality, block_index=False)
            for im in images]
    assert items[0] == want
    assert all(not s.endswith(b"TICX") for s in items[0])
    pixels, stream_bytes = expected()
    assert stream_bytes == [sum(map(len, want))]
    assert np.array_equal(pixels[0], np.stack([container.decompress(s)
                                               for s in want]))


def test_a_stream_without_the_magic_or_an_indexed_config_is_refused():
    sends = _sends()
    stream = container.compress(np.full((16, 16), 9, np.uint8), 50,
                                block_index=True)
    assert sends.cut_trailer(stream) == container.compress(
        np.full((16, 16), 9, np.uint8), 50, block_index=False)
    with pytest.raises(ValueError, match="TICX trailer"):
        sends.cut_trailer(stream[:-4])
    with pytest.raises(ValueError, match="TICX trailer"):
        sends.cut_trailer(stream[:16] + b"\xff\xff\x00\x00TICX")
    with pytest.raises(ValueError, match="block_index false only"):
        sends.make([], _config(16, 16, 50, block_index=True), {})


@pytest.mark.parametrize("traced", [False, True])
def test_a_small_noindex_cell_runs_correct_on_the_host_entropy_leg(
        noindex_bench, traced):
    t0 = time.time_ns()
    r = _run(noindex_bench, traced=traced)
    assert r["correct"] is True and r["failed"] == 0
    assert r["checks"]["pixels_wrong"]["value"] == 0
    want = {m["name"] for m in noindex_bench.metrics_of(
        "small.decode-noindex", traced)}
    if not traced:
        assert set(r["metrics"]) == want == {"decode_mp_s", "setup_s"}
        return
    # the roofline share reads nothing without a card's timeline
    assert set(r["metrics"]) == {n for n in want if "roofline" not in n}
    assert {f"idle_in_{s}.decode" for s in STAGES} <= set(r["metrics"])
    assert "kernel_leg_share.decode" not in r["metrics"]
    parts = sum(v["value"] for k, v in r["metrics"].items()
                if k.startswith(("idle_in_", "idle_unstaged")))
    assert parts == pytest.approx(r["metrics"]["device_idle.decode"]["value"],
                                  abs=0.01)
    # every call of the window took the host-entropy leg, whole
    calls = [s for s in profiling.spans()[0] if s.start_ns >= t0
             and s.name == "codec.decompress_batch"]
    assert calls and all(s.counts == {"kernel": 0, "host_entropy": 3,
                                      "host_decoder": 0} for s in calls)


def test_an_altered_answer_is_not_correct(noindex_bench, monkeypatch):
    from tinyimgcodec_tpu_torch.engine import Engine

    orig = Engine._arrays_pixels

    def altered(self, *a, **k):
        out = np.array(orig(self, *a, **k))
        out[0, 3, 5] ^= 1
        return out

    monkeypatch.setattr(Engine, "_arrays_pixels", altered)
    r = _run(noindex_bench)
    assert r["correct"] is False
    assert r["checks"]["pixels_wrong"]["value"] > 0


def test_the_control_is_not_correct(noindex_bench):
    """The program's float32 path in place of the exact one the
    configuration states, at a size a test holds."""
    cell = "small256.decode-noindex"
    for seed, correct, numbers in control.readings(
            noindex_bench, cell, [1, 2], 0.2, precision="fast",
            device="cpu"):
        assert not correct and numbers["pixels_wrong"] > 0, (seed, numbers)
    (seed, correct, numbers), = control.readings(noindex_bench, cell, [3],
                                                 0.2, device="cpu")
    assert correct, (seed, numbers)
