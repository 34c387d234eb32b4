"""The port's conformance batteries, corpus loaders and scaling harness on
the CPU, held against the JAX package on the same inputs.

``conformance.adversarial`` and ``quality_sweep`` run the kernels' plain
versions here (``device="cpu"``); on the card the same functions drive
the CUDA kernels (``chip_smoke.py`` phase ``conformance``,
``scripts/torch_hw_adversarial.py``).  Every comparison is an equality:
bytes, sha256 of streams, pixels, and CR / PSNR computed by the JAX
package's formulas on the JAX oracle's streams.
"""

import hashlib
import importlib.util
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import tinyimgcodec_tpu.corpus as jcorpus
from tinyimgcodec_tpu import container as jcontainer
from tinyimgcodec_tpu import metrics as jmetrics
from tinyimgcodec_tpu_torch import api, conformance
from tinyimgcodec_tpu_torch import corpus as tcorpus

SCRIPTS = pathlib.Path(__file__).resolve().parent.parent / "scripts"


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sha(streams) -> str:
    return hashlib.sha256(b"".join(streams)).hexdigest()


@pytest.fixture(scope="module")
def battery():
    return conformance.adversarial("cpu", 64)


def _check(record, name):
    (c,) = [c for c in record["checks"] if c["name"] == name]
    return c


@pytest.mark.parametrize("shape", [(64, 64), (40, 56)])
def test_contents_equal_the_jax_scripts(shape):
    # the JAX script's imports of its package sit inside main()
    want = _script("hw_adversarial").contents(*shape)
    got = conformance.contents(*shape)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                 want[k])


def test_the_cpu_battery_passes_every_check(battery):
    assert conformance.failed_names(battery) == []
    assert battery["all_passed"] is True


def test_check_names_cover_every_part_of_the_battery(battery):
    names = [c["name"] for c in battery["checks"]]
    for q in conformance.QUALITIES:  # a
        for kind in ("exact-byte-identity", "exact-device-noindex",
                     "fast-decodable", "fast-v1-equals-v2"):
            assert f"{kind}-q{q}" in names
    for label in ("compress_batch", "compress", "fast-v1"):  # b
        assert f"q99-{label}-raises-like-oracle" in names
    assert "q99-auto-table-equals-oracle" in names
    caps = battery["caps"]  # c
    need, turn = battery["need"], battery["stitch_turn_words"]
    assert {need - 64, need - 1, need, need + 1, 64 * 52, turn - 1, turn,
            turn + 4096} == set(caps)
    assert turn % 4096 == 0 and turn - 4096 < need <= turn
    assert [f"capacity-edge-{c}" for c in caps] == [
        n for n in names if n.startswith("capacity-edge-")]
    for c in caps:
        assert _check(battery, f"capacity-edge-{c}")["cap_words"] == c
    assert "small-batch-byte-identity" in names  # d
    assert "single-small-image-byte-identity" in names
    for q in (50, 90):  # e, f
        assert f"device-entropy-decode-parity-q{q}" in names
        assert f"device-entropy-decode-parity-custom-table-q{q}" in names
    assert battery["ctas_past_window_q90"] == 0  # one CTA at 64x64


@pytest.mark.parametrize("q", conformance.QUALITIES)
def test_exact_streams_equal_the_jax_oracle(battery, q):
    images = conformance.contents(64, 64).values()
    want = [jcontainer.compress(im, q, block_index=True) for im in images]
    assert _check(battery, f"exact-byte-identity-q{q}")["sha256"] == _sha(
        want)


def test_the_need_is_the_jax_oracles_payload_words(battery):
    noise = conformance.contents(64, 64)["noise"]
    ref = jcontainer.compress(noise, 50)
    assert battery["need"] == -(-(len(ref) - 16) * 8 // 32)


def test_q99_refusals_match_the_jax_oracle(battery):
    refused = []
    for name, im in conformance.contents(64, 64).items():
        try:
            jcontainer.compress(im, 99)
        except ValueError as e:
            assert "Huffman table range" in str(e)
            refused.append(name)
    assert refused
    for label in ("compress_batch", "compress", "fast-v1"):
        c = _check(battery, f"q99-{label}-raises-like-oracle")
        assert c["refused"] == refused and c["instead"] is None


def test_a_flipped_byte_fails_its_check_and_the_script(monkeypatch,
                                                       tmp_path):
    real = api.compress_batch

    def flipped(images, quality=50, **kw):
        out = real(images, quality, **kw)
        if quality == 1 and kw.get("precision") == "exact":
            out[0] = out[0][:20] + bytes([out[0][20] ^ 1]) + out[0][21:]
        return out

    monkeypatch.setattr(api, "compress_batch", flipped)
    path = tmp_path / "adv.json"
    rc = _script("torch_hw_adversarial").main(
        ["--device", "cpu", "--sizes", "64", "--out", str(path)])
    assert rc == 1
    rec = json.loads(path.read_text())
    assert rec["all_passed"] is False
    (bat,) = rec["batteries"]
    assert bat["all_passed"] is False
    assert conformance.failed_names(bat) == ["exact-byte-identity-q1"]
    assert _check(bat, "exact-byte-identity-q1")["mismatches"] == ["noise"]


@pytest.mark.parametrize("q", [10, 50, 90])
def test_quality_sweep_equals_the_jax_formulas(q):
    img = jcorpus.synthetic_corpus(1, 64)[0]
    rows = conformance.quality_sweep([img], (q,), "cpu",
                                     precisions=("exact", "fast"))
    exact, fast = rows
    ref = jcontainer.compress(img, q, block_index=True)
    dec = jcontainer.decompress(ref)
    want = {"bytes": len(ref), "cr": jmetrics.compression_ratio(img, ref),
            "psnr": jmetrics.psnr(dec, img),
            "psnr_ref_formula": jmetrics.psnr_reference(dec, img)}
    assert exact["precision"] == "exact" and exact["q"] == q
    assert exact["byte_identical_to_host_oracle"] and exact["passed"]
    for k, v in want.items():
        assert exact[k] == v, k
    assert exact["oracle_bytes"] == want["bytes"]
    assert exact["oracle_cr"] == want["cr"]
    assert exact["oracle_psnr"] == want["psnr"]
    nb = (64 // 8) ** 2
    payload = ref[:jcontainer.parse_block_index(ref, nb)[2]]
    assert exact["cr_no_index"] == jmetrics.compression_ratio(img, payload)
    assert fast["precision"] == "fast" and fast["passed"]
    assert fast["psnr_gap_to_oracle_db"] <= conformance.FAST_PSNR_DB


def test_quality_sweep_script_on_the_cpu(monkeypatch, tmp_path):
    sweep = _script("torch_hw_quality_sweep")
    monkeypatch.setattr(tcorpus, "REFERENCE_DATA", str(tmp_path / "absent"))
    # the corpus part on two small images instead of 49 of 512x512
    monkeypatch.setattr(tcorpus, "load_corpus",
                        lambda: tcorpus.synthetic_corpus(2, 64))
    path = tmp_path / "sweep.json"
    assert sweep.main(["--device", "cpu", "--out", str(path)]) == 0
    rep = json.loads(path.read_text())
    assert [(r["image"], r["q"]) for r in rep["rows"]] == [
        ("synthetic_corpus[0]", q) for q in conformance.SWEEP_QUALITIES]
    assert all(r["byte_identical_to_host_oracle"] for r in rep["rows"])
    c = rep["corpus"]
    assert c["images"] == 2 and c["byte_identical"] == 2
    assert c["source"] == "synthetic_corpus(2)"
    assert "baseline_mean_cr" not in c
    assert c["corpus_q50_mean_cr"] == c["oracle_q50_mean_cr"]


@pytest.mark.parametrize("name", ["torch_hw_adversarial",
                                  "torch_hw_quality_sweep",
                                  "torch_scaling_bench"])
def test_the_scripts_need_the_card_unless_told_cpu(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _script(name).main(["--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


def test_loaders_fall_back_like_the_jax_package(monkeypatch, tmp_path):
    for mod in (jcorpus, tcorpus):
        monkeypatch.setattr(mod, "REFERENCE_DATA", str(tmp_path / "absent"))
    assert tcorpus.corpus_available() is jcorpus.corpus_available() is False
    assert np.array_equal(tcorpus.load_corpus(3), jcorpus.load_corpus(3))
    assert np.array_equal(tcorpus.load_named("Lenna"),
                          jcorpus.load_named("Lenna"))


def test_loaders_read_gifs_like_the_jax_package(monkeypatch, tmp_path):
    image = pytest.importorskip("PIL.Image")
    rng = np.random.RandomState(3)
    for name in ["1.gif", "2.gif", "3.gif", "lenna.gif"]:
        px = rng.randint(0, 256, (48, 40)).astype(np.uint8)
        image.fromarray(px, "L").save(tmp_path / name)
    for mod in (jcorpus, tcorpus):
        monkeypatch.setattr(mod, "REFERENCE_DATA", str(tmp_path))
    assert tcorpus.corpus_available() and jcorpus.corpus_available()
    got = tcorpus.load_corpus(3)
    assert got.shape == (3, 48, 40) and got.dtype == np.uint8
    assert np.array_equal(got, jcorpus.load_corpus(3))
    assert np.array_equal(tcorpus.load_named("Lenna"),
                          jcorpus.load_named("Lenna"))


def test_a_corpus_that_cannot_be_read_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(tcorpus, "REFERENCE_DATA", str(tmp_path))
    monkeypatch.setitem(sys.modules, "PIL", None)  # Pillow missing
    with pytest.raises(ImportError):
        tcorpus.load_corpus(1)
    with pytest.raises(ImportError):
        tcorpus.load_named("Lenna")


def test_scaling_bench_over_one_and_two_gloo_ranks(tmp_path):
    path = tmp_path / "scaling.json"
    res = subprocess.run(
        [sys.executable, str(SCRIPTS / "torch_scaling_bench.py"),
         "--procs", "1,2", "--per-proc", "1", "--size", "64", "--reps", "2",
         "--backend", "gloo", "--device", "cpu", "--out", str(path)],
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    rec = json.loads(path.read_text())
    rows = rec["backends"]["gloo"]
    assert [r["procs"] for r in rows] == [1, 2]
    assert rows[0]["efficiency"] == 1.0
    for r in rows:
        n = r["procs"]
        want = api.compress_batch(tcorpus.synthetic_corpus(n, 64), 50,
                                  precision="fast", block_index=False,
                                  device="cpu")
        assert r["sha256_streams"] == _sha(want)
        assert r["streams_equal_one_process"] is True
        assert len(r["step_s"]) == 2 and r["mps"] > 0
    assert rec["card"] is None and rec["cores"] >= 1 and rec["note"]
