"""``torch_bench.py``, the port's counterpart of ``bench.py``: its device
passes on the CPU (the kernels' plain versions) against the JAX package,
its mode names against ``bench.py``'s, and its rehearsal.

The passes are what the benchmark captures in CUDA graphs on the card;
here they run eagerly.  Fast-mode encode has the bar of
``tests/test_torch_pipeline.py`` (streams decode through the JAX
package's decoder, PSNR within 0.01 dB of the JAX package's fast
streams); decode has the bar of ``tests/test_torch_decode.py`` for
fast-precision pixels (within one level of the oracle on at most 0.1 % of
the pixels).
"""

import ast
import json
import pathlib

import numpy as np
import torch

import torch_bench
from tinyimgcodec_tpu import container as jcontainer
from tinyimgcodec_tpu.metrics import psnr
from tinyimgcodec_tpu.pallas_pipeline import compress_batch_pallas
from tinyimgcodec_tpu_torch.pipeline import compress_batch_device
from tinyimgcodec_tpu_torch.tables import CodecTables

from conftest import synthetic_image

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def test_device_encode_pass_cross_decodes_and_matches_jax_psnr():
    imgs = np.stack([synthetic_image(64, 64, seed=s) for s in range(71, 75)])
    cap = -(-imgs.size * 4 // 32)
    out = torch_bench.encode_pass(torch.from_numpy(imgs),
                                  CodecTables.build(50, CPU), "fast", cap)
    assert not bool(out[3])
    mine = torch_bench.pass_streams(out, (64, 64), 50)
    # the pass is the pipeline's fast encode, cut as the pipeline cuts it
    assert mine == compress_batch_device(imgs, 50, precision="fast",
                                         device="cpu")
    theirs = compress_batch_pallas(imgs, 50, bt=64, interpret=True,
                                   precision="fast")
    for i in range(4):
        dec_mine = jcontainer.decompress(mine[i])
        dec_theirs = jcontainer.decompress(theirs[i])
        assert dec_mine.shape == (64, 64)
        gap = psnr(imgs[i], dec_mine) - psnr(imgs[i], dec_theirs)
        assert abs(gap) <= 0.01


def test_device_decode_pass_gives_the_oracle_pixels():
    """Row 4 on indexed exact streams of the JAX package's oracle, an odd
    shape so that the crop shows."""
    imgs = [synthetic_image(61, 83, seed=s) for s in (75, 76, 77)]
    streams = [jcontainer.compress(im, 50, block_index=True) for im in imgs]
    pixels, ok = torch_bench.decode_pass(
        *torch_bench.decode_inputs(streams, CPU))
    assert bool(ok.all()) and pixels.shape == (3, 64, 88)
    got = pixels[:, :61, :83].numpy()
    want = np.stack([jcontainer.decompress(s) for s in streams])
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3


def _jax_mode_names() -> set[str]:
    """Every key ``bench.py`` stores into ``results``: literal keys, the
    first element of the tuples a ``for name, ...`` loop walks, and an
    f-string key with its field kept as ``{nt}``."""
    tree = ast.parse((REPO / "bench.py").read_text())
    loops: dict[str, list[str]] = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.For) and isinstance(node.target, ast.Tuple)
                and isinstance(node.iter, ast.List)):
            loops.setdefault(node.target.elts[0].id, []).extend(
                e.elts[0].value for e in node.iter.elts)
    names = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Subscript)
                and isinstance(node.ctx, ast.Store)
                and isinstance(node.value, ast.Name)
                and node.value.id == "results"):
            continue
        key = node.slice
        if isinstance(key, ast.Constant):
            names.add(key.value)
        elif isinstance(key, ast.Name):
            names.update(loops[key.id])
        else:
            names.add("".join(
                v.value if isinstance(v, ast.Constant)
                else "{" + v.value.id + "}" for v in key.values))
    return names


def test_mode_names_follow_bench_py():
    jax = _jax_mode_names()
    assert "pallas-fast/device" in jax and len(jax) == 19

    def rename(name):
        for old, new in (("pallas-", "cuda-"), ("xla-", "batch-")):
            if name.startswith(old):
                return new + name[len(old):]
        return name

    want = {rename(n) for n in jax} - {"decode/device-fastpath"}
    assert set(torch_bench.MODES) == want
    assert len(torch_bench.MODES) == len(want)


def _rehearse(capsys):
    rc = torch_bench.main(["--rehearse"])
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_rehearsal_runs_every_mode_with_null_values(capsys):
    rc, record = _rehearse(capsys)
    assert rc == 0 and record["failed"] == []
    assert record["metric"] == "corpus_encode_throughput_per_chip"
    assert record["value"] is None and record["unit"] == "MP/s"
    assert list(record["modes"]) == torch_bench.mode_names()
    for stats in record["modes"].values():
        assert stats == {"median": None, "p10": None, "p90": None,
                         "samples": 0}
    assert record["notes"]["sha256"]["pinned"] is False
    assert record["notes"]["conformance"]["byte_identical"] == 4


def test_rehearsal_names_a_failed_mode_and_exits_non_zero(capsys,
                                                          monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(torch_bench, "bench_decode_device", broken)
    rc, record = _rehearse(capsys)
    assert rc != 0
    assert record["failed"] == ["decode/device"]
    assert "decode/device" not in record["modes"]
    assert "decode/device-full" in record["modes"]


def test_without_a_card_the_benchmark_refuses(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert torch_bench.main([]) == 2
    assert capsys.readouterr().out == ""
