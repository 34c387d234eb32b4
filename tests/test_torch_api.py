"""Public API of the port: routing, validation, the device rule, and its
independence from JAX and from the JAX package."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import tinyimgcodec_tpu as jtic
import tinyimgcodec_tpu_torch as ttic
from tinyimgcodec_tpu_torch.device import resolve_device

from conftest import synthetic_image

IMG = synthetic_image(48, 40, seed=71)


def _no_card() -> bool:
    return not torch.cuda.is_available()


def test_compress_cpu_equals_host_backend_and_jax_package():
    a = ttic.compress(IMG, 50, device="cpu")
    b = ttic.compress(IMG, 50, backend="host")
    c = jtic.compress(IMG, 50, backend="host")
    assert a == b == c
    assert np.array_equal(ttic.decompress(a, backend="host"),
                          jtic.decompress(a, backend="host"))


def test_compress_batch_cpu_equals_host_backend():
    imgs = np.stack([IMG, IMG[::-1]])
    a = ttic.compress_batch(imgs, 60, device="cpu")
    b = ttic.compress_batch(imgs, 60, backend="host")
    c = jtic.compress_batch(imgs, 60, backend="host")
    assert a == b == c
    t = ttic.compress_batch(torch.from_numpy(imgs.copy()), 60, device="cpu")
    assert t == a
    out = ttic.decompress_batch(a, backend="host")
    assert out.shape == imgs.shape


@pytest.mark.parametrize("block_index", [None, True, False])
def test_block_index_default_is_on(block_index):
    got = ttic.compress(IMG, 50, device="cpu", block_index=block_index)
    want = jtic.compress(IMG, 50, backend="host", block_index=block_index)
    assert got == want
    assert got.endswith(b"TICX") == (block_index is not False)


def test_fast_precision_routes_to_the_fast_transform():
    a = ttic.compress(IMG, 50, device="cpu", precision="fast")
    assert ttic.decompress(a, backend="host").shape == IMG.shape
    cfg = ttic.CodecConfig(quality=50, precision="fast")
    assert ttic.compress(IMG, config=cfg, device="cpu") == a


@pytest.mark.parametrize(
    "kwargs, exc",
    [(dict(quality=100), ValueError), (dict(quality=0), ValueError),
     (dict(precision="double"), ValueError),
     (dict(backend="jax"), ValueError),
     (dict(index_stride=48), ValueError)],
)
def test_validation(kwargs, exc):
    with pytest.raises(exc):
        ttic.compress(IMG, device="cpu", **kwargs)
    with pytest.raises(exc):
        ttic.compress_batch(IMG[None], device="cpu", **kwargs)


def test_wrong_rank_is_refused():
    with pytest.raises(ValueError):
        ttic.compress(IMG[None], device="cpu")
    with pytest.raises(ValueError):
        ttic.compress_batch(IMG, device="cpu")


def test_unported_parts_say_so():
    """Nothing of the public API raises for want of a port any more:
    auto-table encode runs on the device (here its plain versions) and
    writes the host oracle's bytes, and such streams decode through every
    backend."""
    data = ttic.compress(IMG, 50, backend="host",
                         auto_generate_huffman_table=True)
    assert data == jtic.compress(IMG, 50, backend="host",
                                 auto_generate_huffman_table=True,
                                 block_index=True)
    for backend in ("auto", "torch"):
        assert ttic.compress(IMG, 50, auto_generate_huffman_table=True,
                             backend=backend, device="cpu") == data
    cfg = ttic.CodecConfig(quality=50, auto_huffman_table=True)
    assert ttic.compress(IMG, config=cfg, device="cpu") == data
    want = jtic.decompress(data, backend="host")
    assert np.array_equal(ttic.decompress(data, backend="host"), want)
    for backend in ("auto", "torch"):
        assert np.array_equal(
            ttic.decompress(data, backend=backend, device="cpu"), want)
        out = ttic.decompress_batch([data], backend=backend, device="cpu")
        assert out.shape == (1,) + IMG.shape and np.array_equal(out[0], want)


@pytest.mark.parametrize("backend", ["auto", "torch", "host"])
@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_decompress_backends_and_precisions(backend, precision):
    data = ttic.compress(IMG, 50, device="cpu")
    got = ttic.decompress(data, backend=backend, precision=precision,
                          device="cpu")
    want = jtic.decompress(data, backend="host")
    if precision == "exact" or backend == "host":
        assert np.array_equal(got, want)
    else:
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3


def test_default_device_raises_without_a_card():
    """No quiet fall-back to the CPU: with no card and no device="cpu"
    the entry points raise."""
    if not _no_card():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttic.compress(IMG, 50)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttic.compress_batch(IMG[None], 50)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttic.compress(IMG, 50, backend="torch")
    data = ttic.compress(IMG, 50, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttic.decompress(data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttic.decompress_batch([data])
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_kernel_wrappers_do_not_fall_back_without_nvcc(monkeypatch):
    """The build step raises when the compiler is missing; nothing catches
    that and carries on with the plain version."""
    from tinyimgcodec_tpu_torch.ops import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("place")
    assert set(_build.KERNELS) == {
        "exact_transform", "encode2", "place", "encode1", "stitch",
        "entropy_decode", "exact_inverse", "symbol_stats"}


def test_build_key_follows_the_sources_and_the_headers(tmp_path, monkeypatch):
    """A library's file name carries a hash of its source and of every
    header under csrc/: editing a shared header rebuilds the kernels."""
    from tinyimgcodec_tpu_torch.ops import _build

    for name in ("a.cu", "b.cu"):
        (tmp_path / name).write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    a1, b1 = _build._target("a")[1], _build._target("b")[1]
    assert a1 != b1 and a1 == _build._target("a")[1]
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert _build._target("a")[1] != a1 and _build._target("b")[1] != b1
    a2 = _build._target("a")[1]
    (tmp_path / "a.cu").write_text('#include "common.cuh"\n// edit\n')
    assert _build._target("a")[1] != a2


def test_the_one_card_codec_imports_nothing_of_parallel():
    """The layering rule: ``api`` -> ``engine`` -> ``pipeline`` -> ``ops``
    is drawn without an arrow up into ``parallel/``."""
    code = (
        "import sys\n"
        "import tinyimgcodec_tpu_torch, tinyimgcodec_tpu_torch.engine, "
        "tinyimgcodec_tpu_torch.pipeline\n"
        "bad = [m for m in sys.modules "
        "if m.startswith('tinyimgcodec_tpu_torch.parallel')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("clean")


def test_port_imports_neither_jax_nor_the_jax_package():
    # the port's scripts too (their entry points run under __main__)
    repo = pathlib.Path(__file__).resolve().parent.parent
    scripts = [str(repo / "scripts" / f"{name}.py")
               for name in ("torch_hw_adversarial", "torch_hw_quality_sweep",
                            "torch_scaling_bench", "torch_multicard",
                            "torch_host_entropy_split", "torch_prepare_time")]
    scripts.append(str(repo / "torch_bench.py"))
    code = (
        "import sys, numpy as np\n"
        "import tinyimgcodec_tpu_torch as t\n"
        "import tinyimgcodec_tpu_torch.ops.encode2, "
        "tinyimgcodec_tpu_torch.ops.place, "
        "tinyimgcodec_tpu_torch.ops.exact_transform, "
        "tinyimgcodec_tpu_torch.ops.encode1, "
        "tinyimgcodec_tpu_torch.ops.stitch, "
        "tinyimgcodec_tpu_torch.ops.entropy_decode, "
        "tinyimgcodec_tpu_torch.ops.transform, "
        "tinyimgcodec_tpu_torch.engine, "
        "tinyimgcodec_tpu_torch.native, "
        "tinyimgcodec_tpu_torch.ops._build, "
        "tinyimgcodec_tpu_torch.parallel, "
        "tinyimgcodec_tpu_torch.parallel.mesh, "
        "tinyimgcodec_tpu_torch.parallel.tiled, "
        "tinyimgcodec_tpu_torch.parallel.batch, "
        "tinyimgcodec_tpu_torch.parallel.stream, "
        "tinyimgcodec_tpu_torch.jobs, "
        "tinyimgcodec_tpu_torch.profiling, "
        "tinyimgcodec_tpu_torch.cli, "
        "tinyimgcodec_tpu_torch.cli.encode, "
        "tinyimgcodec_tpu_torch.cli.convert, "
        "tinyimgcodec_tpu_torch.cli.view, "
        "tinyimgcodec_tpu_torch.cli.benchmark, "
        "tinyimgcodec_tpu_torch.conformance\n"
        "import importlib.util\n"
        f"for name in {scripts!r}:\n"
        "    spec = importlib.util.spec_from_file_location(name, name)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "img = (np.arange(64 * 64).reshape(64, 64) % 251).astype(np.uint8)\n"
        "from tinyimgcodec_tpu_torch.parallel import make_mesh, tiled\n"
        "assert tiled.encode_tiled(img, 50, mesh=make_mesh(device='cpu')) "
        "== t.compress(img, 50, block_index=False, device='cpu')\n"
        "local = make_mesh(devices=['cpu'] * 3)\n"
        "assert tiled.encode_tiled(img, 50, mesh=local) == "
        "t.compress(img, 50, block_index=False, device='cpu')\n"
        "from tinyimgcodec_tpu_torch.parallel import batch\n"
        "assert batch.compress_batch(np.stack([img] * 4), 50, mesh=local, "
        "block_index=True) == [t.compress(img, 50, device='cpu')] * 4\n"
        "d = t.compress(img, 50, device='cpu')\n"
        "assert t.decompress(d, backend='host').shape == img.shape\n"
        "out = t.decompress_batch([d, d], device='cpu')\n"
        "assert (out[0] == t.decompress(d, backend='host')).all()\n"
        "from tinyimgcodec_tpu_torch.engine import Engine\n"
        "nt = t.compress(img, 50, block_index=False, device='cpu')\n"
        "assert (Engine('exact', 'cpu').decompress_batch([nt, nt])[1] == "
        "t.decompress(nt, backend='host')).all()\n"
        "words, bits = Engine('exact', 'cpu').encode_to_words(img, 50)\n"
        "assert words.shape == (64, 52) and bits.shape == (64,)\n"
        "from tinyimgcodec_tpu_torch.pipeline import compress_batch_device\n"
        "v1 = compress_batch_device(img[None], 50, device='cpu', "
        "version='v1')\n"
        "assert t.decompress(v1[0], device='cpu').shape == img.shape\n"
        "auto = t.compress(img, 50, auto_generate_huffman_table=True, "
        "device='cpu')\n"
        "assert (t.decompress(auto, device='cpu') == "
        "t.decompress(auto, backend='host')).all()\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or "
        "m == 'tinyimgcodec_tpu' or m.startswith('tinyimgcodec_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean', len(d))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("clean")
