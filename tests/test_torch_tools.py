"""The port's tools on the CPU: ``jobs``, ``profiling`` and the CLI, the
counterparts of ``tests/test_aux.py``'s, with ``device="cpu"`` (or
``--device cpu``) where the codec runs."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tinyimgcodec_tpu import api as japi
from tinyimgcodec_tpu import container as jcontainer
from tinyimgcodec_tpu_torch import container
from tinyimgcodec_tpu_torch.jobs import CorpusEncodeJob
from tinyimgcodec_tpu_torch.profiling import (
    device_sync_cost, run_record, trace,
)

from conftest import synthetic_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(tool: str, *args: str):
    return subprocess.run(
        [sys.executable, "-m", f"tinyimgcodec_tpu_torch.cli.{tool}", *args],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, MPLBACKEND="Agg"),
    )


def test_run_record_names_the_device():
    r = run_record("test", 1.0, 0.5, {"x": 1}, device="cpu")
    assert r["mp_per_s"] == 2.0 and r["x"] == 1
    assert (r["device"], r["n_devices"]) == ("cpu", 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run_record("test", 1.0, 0.5)


def test_trace_and_sync_cost_on_the_cpu(tmp_path):
    from tinyimgcodec_tpu_torch import api

    img = synthetic_image(32, 32, seed=6)
    with trace(str(tmp_path / "trace"), device="cpu") as prof:
        api.compress(img, 50, device="cpu")
    assert prof.key_averages()
    with open(tmp_path / "trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert 0 <= device_sync_cost(3, device="cpu") < 1.0


def test_corpus_job_resume(tmp_path):
    imgs = {"a": synthetic_image(16, 16, seed=1),
            "b": synthetic_image(16, 16, seed=2)}
    out = str(tmp_path / "job")
    paths = CorpusEncodeJob(out, quality=50, backend="host").run(imgs)
    assert sorted(paths) == ["a", "b"]
    for p in paths.values():
        with open(p, "rb") as f:
            assert jcontainer.decompress(f.read()).shape == (16, 16)
    job2 = CorpusEncodeJob(out, quality=50, backend="host")
    assert job2.pending(["a", "b"]) == []
    imgs["c"] = synthetic_image(16, 16, seed=3)
    assert job2.pending(["a", "b", "c"]) == ["c"]


def test_corpus_job_batched_matches_the_jax_job(tmp_path):
    """Batches of 3 with a shape change in the middle: every file holds
    the JAX package's exact stream (the oracle's, with the trailer), one
    progress call an image, and a second run has nothing to do."""
    imgs = {f"im{i}": synthetic_image(24, 24, seed=i) for i in range(5)}
    imgs["odd"] = synthetic_image(16, 40, seed=9)
    out = str(tmp_path / "job")
    seen = []
    job = CorpusEncodeJob(out, quality=50, batch_size=3, device="cpu")
    paths = job.run(imgs, progress=lambda i, n, name: seen.append(name))
    assert len(seen) == 6
    for name, img in imgs.items():
        with open(paths[name], "rb") as f:
            assert f.read() == japi.compress(img, quality=50)
    job2 = CorpusEncodeJob(out, quality=50, batch_size=3, device="cpu")
    assert job2.pending(sorted(imgs)) == []


def test_encode_cli_roundtrip(tmp_path):
    from PIL import Image

    img = synthetic_image(32, 32, seed=4)
    src, dst = str(tmp_path / "in.png"), str(tmp_path / "out.img")
    Image.fromarray(img).save(src)
    r = _cli("encode", src, dst, "-q", "50", "--device", "cpu",
             "--block-index")
    assert r.returncode == 0, r.stderr
    assert "compression" in r.stdout
    with open(dst, "rb") as f:
        assert f.read() == jcontainer.compress(img, 50, block_index=True)


def test_cli_without_a_card_refuses(tmp_path):
    """The tools run on the card by default and do not fall back to the
    CPU when there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    from PIL import Image

    src = str(tmp_path / "in.png")
    Image.fromarray(synthetic_image(16, 16, seed=4)).save(src)
    r = _cli("encode", src, str(tmp_path / "out.img"))
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr


def test_view_cli_save(tmp_path):
    img = synthetic_image(24, 24, seed=5)
    src = str(tmp_path / "x.img")
    with open(src, "wb") as f:
        f.write(container.compress(img, 50, block_index=True))
    r = _cli("view", src, "--save", str(tmp_path / "png"), "--device", "cpu")
    assert r.returncode == 0, r.stderr
    from PIL import Image

    back = np.asarray(Image.open(tmp_path / "png" / "x.png"))
    assert np.array_equal(back, jcontainer.decompress(
        container.compress(img, 50)))


def test_convert_cli(tmp_path):
    from PIL import Image

    img = synthetic_image(20, 28, seed=8)
    src, dst = str(tmp_path / "in.png"), str(tmp_path / "out.raw")
    Image.fromarray(img).save(src)
    r = _cli("convert", src, dst)
    assert r.returncode == 0, r.stderr
    assert "28x20" in r.stdout
    with open(dst, "rb") as f:
        assert f.read() == img.tobytes()


def test_benchmark_harness_small(tmp_path):
    from tinyimgcodec_tpu_torch.cli import benchmark as bm

    csv_path = str(tmp_path / "r.csv")
    rows = bm.run_corpus("auto", csv_path, limit=1, device="cpu")
    assert os.path.exists(csv_path)
    assert len(rows) == len(bm.QUALITIES)
    assert all(r["ratio"] > 1 for r in rows)
    host = bm.run_corpus("host", str(tmp_path / "h.csv"), limit=1)
    assert [r["ratio"] for r in rows] == [r["ratio"] for r in host]


def test_prepare_time_script_small():
    """``scripts/torch_prepare_time.py`` at a tiny size: one JSON line with
    the streams, their chunks and the call times."""
    r = subprocess.run(
        [sys.executable, "scripts/torch_prepare_time.py", "--calls", "5",
         "--images", "3", "--size", "64"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert (out["streams"], out["chunks"], out["calls"]) == (3, 3, 5)
    assert 0 < out["min_ms"] <= out["median_ms"]
