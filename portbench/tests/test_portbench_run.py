"""Whole runs on the CPU (the kernels' plain versions): the result line,
a cell added as files, a run without a card, and the program at fault."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from portbench import harness
from portbench.loader import Bench

from .conftest import ROOT, small_copy

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(bench, cell, traced=False, seconds=0.3, **kw):
    return harness.run(bench, cell, 2**31 + 17, seconds, traced,
                       time.perf_counter(), device="cpu",
                       log=lambda *a, **k: None, **kw)


@pytest.mark.parametrize("cell", ["small.encode", "small.decode",
                                  "smallframe.encode", "smallx4.encode"])
@pytest.mark.parametrize("traced", [False, True])
def test_the_result_line(small_bench, cell, traced):
    r = _run(small_bench, cell, traced)
    assert list(r) == KEYS + (["breakdown"] if traced else []) + ["checks"]
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 1
    json.dumps(r)
    want = {m["name"] for m in small_bench.metrics_of(cell, traced)}
    got = set(r["metrics"])
    if traced:
        # the roofline shares read nothing without a card's timeline
        assert got == {n for n in want if "roofline" not in n}
        assert set(r["device"]) >= {"busy_s", "window_s"}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert got == want
    for m in r["metrics"].values():
        assert isinstance(m["value"], float) and m["unit"]
    assert all(set(v) == {"value", "limit"} for v in r["checks"].values())
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}


def test_a_cell_config_mix_and_metric_added_as_files_run(tmp_path):
    base = small_copy(tmp_path)
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    cfg = json.loads((base / "configs" / "small-q50-exact.json").read_text())
    cfg.update(height=24, width=40, images_per_call=2, quality=75,
               generator="seeded_image")
    (base / "configs" / "new-q75.json").write_text(json.dumps(cfg))
    mix = {"sends": "images", "loop": "closed", "pool": 3, "check_every": 1}
    (base / "mixes" / "images.closed1.pool3.json").write_text(
        json.dumps(mix))
    (base / "workloads" / "new.encode.json").write_text(json.dumps(
        {"config": "new-q75", "traffic": "images.closed1.pool3",
         "entry": "api.compress_batch", "chips": 1, "why": "a new cell"}))
    (base / "layer_metrics" / "calls_per_s.encode.py").write_text(
        "def read(record):\n"
        "    return len(record['calls']) / record['window_s']\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["end_to_end"][0]["workloads"].append("new.encode")
    spec["per_layer"].append({
        "name": "calls_per_s.encode", "unit": "1/s", "better": "higher",
        "source": "host_clock", "layer": "api", "moves": "encode_mp_s",
        "workloads": ["new.encode"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    b = Bench(base)
    r = _run(b, "new.encode", traced=True)
    assert r["correct"] and r["metrics"]["calls_per_s.encode"]["value"] > 0
    assert set(_run(b, "new.encode")["metrics"]) == {"encode_mp_s",
                                                    "setup_s"}
    assert all(p.read_bytes() == data for p, data in before.items())


def test_a_generator_what_is_sent_and_a_loop_added_as_files_run(tmp_path):
    """A new image generator, a new kind of input (here the pool's images
    in reverse order, with the reference's answers to them) and a new
    arrival loop (here calls spaced by a pause) are files too."""
    base = small_copy(tmp_path)
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    (base / "generators" / "ramp.py").write_text(
        "import numpy as np\n\n"
        "def image(h, w, seq):\n"
        "    rng = np.random.default_rng(seq)\n"
        "    ramp = np.add.outer(np.arange(h), np.arange(w)) * 3\n"
        "    return ((ramp + rng.integers(0, 9, (h, w))) % 256)"
        ".astype(np.uint8)\n")
    (base / "sends" / "images_reversed.py").write_text(
        "from portbench import compare\n"
        "from portbench.reference import codec\n\n"
        "KEYS = set()\n"
        "check = compare.streams\n"
        "same = compare.same_streams\n\n"
        "def make(pool, config, mix):\n"
        "    items = [x[::-1].copy() for x in pool]\n\n"
        "    def expected():\n"
        "        ref = codec.encode_pool(items, config['quality'],\n"
        "                                config['index_stride'])\n"
        "        return ([s for s, _ in ref],\n"
        "                [sum(map(len, s)) for s, _ in ref])\n\n"
        "    return items, 0.0, expected\n")
    (base / "loops" / "paced.py").write_text(
        "import time\n\n"
        "KEYS = {'pause_ms'}\n\n"
        "def run(call, n_items, seconds, mix):\n"
        "    end = time.perf_counter() + seconds\n"
        "    n = 0\n"
        "    while n == 0 or time.perf_counter() < end:\n"
        "        t = time.perf_counter()\n"
        "        call(n % n_items, t)\n"
        "        n += 1\n"
        "        time.sleep(mix['pause_ms'] / 1e3)\n")
    cfg = json.loads((base / "configs" / "small-q50-exact.json").read_text())
    cfg.update(height=16, width=24, generator="ramp")
    (base / "configs" / "ramp-q50.json").write_text(json.dumps(cfg))
    (base / "mixes" / "reversed.paced.json").write_text(json.dumps(
        {"sends": "images_reversed", "loop": "paced", "pool": 2,
         "check_every": 1, "pause_ms": 20}))
    (base / "workloads" / "ramp.encode.json").write_text(json.dumps(
        {"config": "ramp-q50", "traffic": "reversed.paced",
         "entry": "api.compress_batch", "chips": 1, "why": "a new mix"}))
    b = Bench(base)
    with pytest.raises(ValueError, match="unknown keys"):
        (base / "mixes" / "bad.json").write_text(json.dumps(
            {"sends": "images", "loop": "closed", "pool": 2,
             "check_every": 1, "pause_ms": 20}))
        b.mix("bad")
    r = _run(b, "ramp.encode", seconds=0.3)
    assert r["correct"] and r["attempted"] >= 2
    # the pauses fall between calls, outside each call's time
    assert r["attempted"] <= 0.3 / 0.02 + 1
    assert all(p.read_bytes() == data for p, data in before.items())


def test_every_answer_is_judged_and_equal_ones_are_counted():
    answers = harness.Answers(lambda a, b: a == b, 1, None)
    for k, out in [(0, "a"), (1, "b"), (0, "a"), (1, "c"), (0, "a")]:
        answers.add(k, out)
    assert answers.kept == [[0, "a", 3], [1, "b", 1], [1, "c", 1]]
    drawn = harness.Answers(lambda a, b: a == b, 4,
                            np.random.default_rng(5))
    for i in range(400):
        drawn.add(i % 2, "x")
    assert [k for k, *_ in drawn.kept] == [0, 1]
    assert 60 < sum(n for *_, n in drawn.kept) < 140


def test_the_reference_streams_are_left_out_of_setup_s(small_bench,
                                                      monkeypatch):
    from portbench.reference import codec

    orig = codec.encode_pool

    def slow(*a, **k):
        time.sleep(1.5)
        return orig(*a, **k)

    monkeypatch.setattr(codec, "encode_pool", slow)
    t = time.perf_counter()
    r = _run(small_bench, "small.decode")
    wall = time.perf_counter() - t
    assert r["correct"]
    assert r["metrics"]["setup_s"]["value"] <= wall - 1.5


def test_without_a_card_it_exits_and_prints_no_result():
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "corpus512.encode", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert p.returncode != 0
    assert p.stdout == ""
    assert "card" in p.stderr


def test_without_the_program_it_exits_and_prints_no_result(tmp_path):
    """A directory that holds only ``BENCHMARK.json`` and the benchmark's
    folder has no program to run: the run fails before any result (on the
    CPU here, since this machine has no card)."""
    small_copy(tmp_path)
    code = ("import sys, time; sys.path[:] = [p for p in sys.path if "
            "'repo' not in p]; sys.path.insert(0, '.'); "
            "from portbench import harness; from portbench.loader import "
            "Bench; print(harness.run(Bench(), 'small.encode', 1, 0.2, "
            "False, time.perf_counter(), device='cpu'))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120, env=env)
    assert p.returncode != 0
    assert "tinyimgcodec_tpu_torch" in p.stderr
    assert "correct" not in p.stdout


# -- the timed path broken underneath: correct has to come out false ------

def _patch_result(monkeypatch, module, name, fault):
    orig = getattr(module, name)

    def broken(*a, **k):
        return fault(orig(*a, **k))

    monkeypatch.setattr(module, name, broken)


def _alter_stream(streams):
    s = bytearray(streams[0])
    s[len(s) // 2] ^= 0x10
    return [bytes(s)] + list(streams[1:])


def _alter_pixel(pixels):
    out = np.array(pixels)
    out[0, 3, 5] ^= 1
    return out


def _half(out):
    return out[: max(1, len(out) // 2)]


class _Stale:
    """A step that hands back its state unchanged: the answer of the
    call before, whatever this call asked."""

    def __init__(self):
        self.last = None

    def __call__(self, out):
        prev, self.last = self.last, out
        return out if prev is None else prev


def _encode_targets():
    from tinyimgcodec_tpu_torch import api, engine
    from tinyimgcodec_tpu_torch.parallel import batch

    return {"small.encode": (api, "compress_batch_device"),
            "smallframe.encode": (engine, "compress_batch_device"),
            "smallx4.encode": (batch, "compress_batch_device")}


@pytest.mark.parametrize("cell", ["small.encode", "smallframe.encode",
                                  "smallx4.encode"])
@pytest.mark.parametrize("fault", ["alter", "half", "stale"])
def test_an_encode_fault_is_not_correct(small_bench, monkeypatch, cell,
                                        fault):
    module, name = _encode_targets()[cell]
    if fault == "half" and cell == "smallframe.encode":
        pytest.skip("one image a call: no half of the batch to leave out")
    faults = {"alter": _alter_stream, "half": _half, "stale": _Stale()}
    _patch_result(monkeypatch, module, name, faults[fault])
    r = _run(small_bench, cell, seconds=0.2)
    assert r["correct"] is False
    assert r["checks"]["streams_wrong"]["value"] > 0


@pytest.mark.parametrize("fault", ["alter", "half", "stale"])
def test_a_decode_fault_is_not_correct(small_bench, monkeypatch, fault):
    from tinyimgcodec_tpu_torch.engine import Engine

    faults = {"alter": _alter_pixel, "half": _half, "stale": _Stale()}
    _patch_result(monkeypatch, Engine, "decompress_batch", faults[fault])
    r = _run(small_bench, "small.decode", seconds=0.5)
    assert r["correct"] is False
    assert r["checks"]["pixels_wrong"]["value"] > 0


def test_the_exchange_between_chips_left_out_is_not_correct(
        small_bench, monkeypatch):
    from tinyimgcodec_tpu_torch.parallel import mesh

    def own_only(self, parts):
        return list(parts)

    monkeypatch.setattr(mesh.Mesh, "all_gather_bytes", own_only)
    r = _run(small_bench, "smallx4.encode", seconds=0.2)
    assert r["correct"] is False
    assert r["checks"]["streams_wrong"]["value"] > 0


def test_a_call_that_raises_is_not_correct(small_bench, monkeypatch):
    from tinyimgcodec_tpu_torch import api

    orig, calls = api.compress_batch_device, []

    def sometimes(*a, **k):
        calls.append(1)
        if len(calls) > 4 and len(calls) % 3 == 0:  # in the window
            raise RuntimeError("a fault")
        return orig(*a, **k)

    monkeypatch.setattr(api, "compress_batch_device", sometimes)
    r = _run(small_bench, "small.encode", seconds=0.3)
    assert r["correct"] is False
    assert 1 <= r["checks"]["calls_raised"]["value"] <= r["failed"]
    assert r["checks"]["streams_wrong"]["value"] == 0


def test_a_fault_in_set_up_ends_the_run(small_bench, monkeypatch):
    from tinyimgcodec_tpu_torch import api

    def boom(*a, **k):
        raise RuntimeError("a fault")

    monkeypatch.setattr(api, "compress_batch_device", boom)
    with pytest.raises(RuntimeError):
        _run(small_bench, "small.encode")


@pytest.mark.parametrize("cell", ["small256.encode", "small256.decode"])
def test_the_control_is_not_correct(small_bench, cell):
    """The control at a size a test holds: the program's float32 path in
    place of the exact one the configuration states."""
    from portbench import control

    for seed, correct, numbers in control.readings(
            small_bench, cell, [1, 2, 3], 0.2, precision="fast",
            device="cpu"):
        assert not correct, (seed, numbers)
    for seed, correct, numbers in control.readings(
            small_bench, cell, [1, 2], 0.2, device="cpu"):
        assert correct, (seed, numbers)
