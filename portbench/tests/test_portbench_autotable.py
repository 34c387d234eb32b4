"""The cell of per-image Huffman tables (``corpus512.encode-autotable``)
and its parts: the plain reference of dynamic tables equals the program's
oracle byte for byte and loads nothing of the program; a small cell of the
same files runs correct on the CPU, and its traced run reads the table
stage and the kernel route's share; a path broken underneath (a stream
byte, the standard tables in place of the image's, a frequency tie broken
the other way) and the control are refused."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import control, harness, traffic
from portbench.loader import Bench
from portbench.reference_torch import autotable
from tinyimgcodec_tpu_torch import api, constants, container, engine, huffman

from .conftest import ROOT, small_copy

CELL = "corpus512.encode-autotable"
CONFIG = "corpus512-q50-autotable"
# small twins of the cell: (name, its configuration's changes)
TWINS = {"small.encode-autotable": {"height": 64, "width": 64},
         "small512.encode-autotable": {}}
STAGES = ["upload", "transform", "pull", "table", "entropy", "place",
          "assemble"]
SEED = 2**31 + 67


@pytest.fixture(scope="module")
def auto_bench(tmp_path_factory):
    """The small copy with the twins of the cell added (its files, every
    answer judged), reporting what the real cell reports."""
    dest = tmp_path_factory.mktemp("autotable")
    base = small_copy(dest)
    real = json.loads((base / "configs" / f"{CONFIG}.json").read_text())
    cell = json.loads((base / "workloads" / f"{CELL}.json").read_text())
    spec = json.loads((dest / "BENCHMARK.json").read_text())
    for name, changes in TWINS.items():
        config = name.replace(".encode", "-q50")
        (base / "configs" / f"{config}.json").write_text(
            json.dumps(dict(real, **changes)))
        (base / "workloads" / f"{name}.json").write_text(json.dumps(
            dict(cell, config=config, traffic=cell["traffic"] + ".all")))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if CELL in m.get("workloads", []):
                m["workloads"].append(name)
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return Bench(base)


def _run(bench, name="small.encode-autotable", traced=False, seconds=0.3):
    return harness.run(bench, name, SEED, seconds, traced,
                       time.perf_counter(), device="cpu",
                       log=lambda *a, **k: None)


def _image(h, w, seed):
    img = np.random.default_rng(seed).integers(0, 256, (h, w),
                                               dtype=np.uint8)
    img[: h // 2] //= 4  # smooth rows beside the noise
    return img


@pytest.mark.parametrize("stride", [16, 64])
@pytest.mark.parametrize("quality", [10, 50, 90])
@pytest.mark.parametrize("h, w", [(24, 40), (37, 61), (83, 29)])
def test_the_reference_is_the_oracle_byte_for_byte(h, w, quality, stride):
    img = _image(h, w, h * w + quality)
    want = container.compress(img, quality, True, block_index=True,
                              index_stride=stride)
    assert autotable.encode_one(img, quality, stride) == want


def test_the_reference_is_the_oracle_on_a_512x512_image():
    from tinyimgcodec_tpu_torch.corpus import synthetic_corpus

    img = synthetic_corpus(1)[0]
    assert autotable.encode_one(img, 50) == container.compress(
        img, 50, True, block_index=True)


def test_the_reference_is_the_program_on_the_cells_pool():
    bench = Bench()
    cfg = bench.config(CONFIG)
    pool = traffic.pool_inputs(cfg, SEED, 2,
                               bench.generator(cfg["generator"]).image)
    ref = autotable.encode_pool(pool, cfg["quality"], cfg["index_stride"])
    for images, streams in zip(pool, ref):
        assert streams == [api.compress(
            images[0], cfg["quality"], auto_generate_huffman_table=True,
            block_index=True, index_stride=cfg["index_stride"],
            device="cpu")]


def test_a_symbol_past_the_segment_raises_and_a_lone_symbol_has_one_bit():
    with pytest.raises(ValueError, match="16 or more"):
        autotable.symbols(torch.tensor([[1 << 16] + [0] * 63]))
    with pytest.raises(ValueError, match="16 or more"):
        autotable.symbols(torch.tensor([[0, 5] + [1 << 15] + [0] * 61]))
    assert autotable.code_lengths([(0, 7)]) == {0: 1}
    # DC texts in ASCII order: category 10 before category 2 at one length
    codes = autotable.canonical_codes({2: 2, 10: 2, 0: 2, 1: 2})
    assert [s for s, _ in sorted(codes.items(), key=lambda kv: kv[1])] == [
        0, 1, 10, 2]


def test_lengths_past_16_bits_are_limited():
    # counts of a Fibonacci run: an unlimited code would be 24 bits deep
    fib = [1, 1]
    while len(fib) < 26:
        fib.append(fib[-1] + fib[-2])
    counts = [((r, s), c) for (r, s), c in zip(
        [(r, s) for r in range(16) for s in range(1, 11)], fib)]
    lengths = autotable.code_lengths(counts)
    assert max(lengths.values()) == 16
    assert sum(2.0 ** -ln for ln in lengths.values()) <= 1.0
    want = huffman._huffman_code_lengths(dict(counts))
    assert lengths == want


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import sys, json; sys.path.insert(0, {str(ROOT)!r}); "
            "import portbench.reference_torch.autotable; "
            "import portbench.sends.images_autotable; "
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in list(sys.modules)})))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert {"portbench", "torch"} <= tops
    assert not tops & {"tinyimgcodec_tpu_torch", "tinyimgcodec_tpu", "jax",
                       "jaxlib", "flax"}


def test_the_answers_refuse_a_fast_or_unindexed_configuration():
    sends = Bench().sends("images_autotable")
    cfg = Bench().config(CONFIG)
    for changes in ({"precision": "fast"}, {"block_index": False}):
        with pytest.raises(ValueError, match="exact precision with"):
            sends.make([], dict(cfg, **changes), {})


@pytest.mark.parametrize("traced", [False, True])
def test_a_small_autotable_cell_runs_correct(auto_bench, traced):
    r = _run(auto_bench, traced=traced)
    assert r["correct"] is True and r["failed"] == 0
    assert r["checks"]["streams_wrong"]["value"] == 0
    want = {m["name"] for m in auto_bench.metrics_of(
        "small.encode-autotable", traced)}
    if not traced:
        assert set(r["metrics"]) == want == {"encode_mp_s", "setup_s"}
        return
    # the roofline share reads nothing without a card's timeline
    assert set(r["metrics"]) == {n for n in want if "roofline" not in n}
    assert {f"idle_in_{s}.encode" for s in STAGES} <= set(r["metrics"])
    assert r["metrics"]["autotable_kernel_share.encode"]["value"] == 100.0
    parts = sum(v["value"] for k, v in r["metrics"].items()
                if k.startswith(("idle_in_", "idle_unstaged")))
    assert parts == pytest.approx(r["metrics"]["device_idle.encode"]["value"],
                                  abs=0.01)


def test_the_kernel_share_counts_the_host_route(auto_bench, monkeypatch):
    """Every image sent to the host container: the share reads 0 and the
    bytes are still the reference's."""
    monkeypatch.setattr(engine, "KERNEL_BLOCK_BITS", 0)
    r = _run(auto_bench, traced=True)
    assert r["correct"] is True
    assert r["metrics"]["autotable_kernel_share.encode"]["value"] == 0.0


def _alter_a_byte(monkeypatch):
    orig = engine.concat_bit_payload

    def altered(*a, **k):
        out = bytearray(orig(*a, **k))
        out[len(out) // 2] ^= 0x10
        return bytes(out)

    monkeypatch.setattr(engine, "concat_bit_payload", altered)


def _standard_tables(monkeypatch):
    def standard(*counts):
        dc_code = np.zeros(huffman.DC_CATS, np.uint32)
        dc_len = np.zeros(huffman.DC_CATS, np.int32)
        ac_code = np.zeros((16, huffman.AC_SIZES), np.uint32)
        ac_len = np.zeros((16, huffman.AC_SIZES), np.int32)
        dc_code[:12], dc_len[:12] = constants.DC_CODE, constants.DC_CODELEN
        ac_code[:, :11] = constants.AC_CODE
        ac_len[:, :11] = constants.AC_CODELEN
        return huffman.HuffmanSpec(dc_code, dc_len, ac_code, ac_len)

    monkeypatch.setattr(engine, "build_huffman_spec_from_counts", standard)


def _ties_the_other_way(monkeypatch):
    orig = huffman._huffman_code_lengths

    def reversed_ties(freqs, max_len=huffman.MAX_CODE_LENGTH):
        return orig(dict(reversed(list(freqs.items()))), max_len)

    monkeypatch.setattr(huffman, "_huffman_code_lengths", reversed_ties)


@pytest.mark.parametrize("fault", [_alter_a_byte, _standard_tables,
                                   _ties_the_other_way],
                         ids=["a_stream_byte", "standard_tables",
                              "ties_the_other_way"])
def test_a_broken_path_is_not_correct(auto_bench, monkeypatch, fault):
    fault(monkeypatch)
    r = _run(auto_bench)
    assert r["correct"] is False
    assert r["checks"]["streams_wrong"]["value"] > 0


def test_the_control_is_not_correct(auto_bench):
    """The program's float32 coefficients in place of the exact ones the
    configuration states: other tables and other bytes (at the cell's own
    size, where every image has coefficients that move)."""
    cell = "small512.encode-autotable"
    for seed, correct, numbers in control.readings(
            auto_bench, cell, [SEED, SEED + 1], 0.3, precision="fast",
            device="cpu"):
        assert not correct and numbers["streams_wrong"] > 0, (seed, numbers)
    (seed, correct, numbers), = control.readings(auto_bench, cell, [SEED + 2],
                                                 0.3, device="cpu")
    assert correct, (seed, numbers)
