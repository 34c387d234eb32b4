"""The port's C host runtime (``tinyimgcodec_tpu_torch.native``): every case
of the JAX package's ``tests/test_native.py`` run against the port's copy,
the C decoder held against the pure-Python cursor (``use_native=False``)
on every stream kind, and the port's embedded encoder against the JAX
package's, byte for byte.  A build that fails raises: nothing here skips
for want of a compiler."""

import os
import struct
import subprocess

import numpy as np
import pytest

from tinyimgcodec_tpu import container as jcontainer
from tinyimgcodec_tpu import native as jnative
from tinyimgcodec_tpu_torch import container, golden, native
from tinyimgcodec_tpu_torch.bitstream import BitReader, pack_ragged_words
from tinyimgcodec_tpu_torch.constants import (
    AC_CODE, AC_CODELEN, DC_CODE, DC_CODELEN, HEADER_BYTES,
)

from conftest import synthetic_image


def _same_arrays(a, b):
    assert (a.height, a.width, a.quality, a.scaled_dct) == (
        b.height, b.width, b.quality, b.scaled_dct)
    assert np.array_equal(a.dc, b.dc) and np.array_equal(a.ac, b.ac)


# ------------------------------------------- tests/test_native.py, ported


def test_stitch_matches_numpy():
    rng = np.random.RandomState(0)
    n, stride = 64, 8
    words = rng.randint(0, 1 << 32, size=(n, stride), dtype=np.uint64).astype(
        np.uint32
    )
    bits = rng.randint(0, stride * 32 + 1, size=n).astype(np.int32)
    # zero invalid tail bits so both paths see identical data
    lane = np.arange(stride * 32)
    bitmask = lane[None, :] < bits[:, None]
    b = np.unpackbits(words.astype(">u4").view(np.uint8), axis=1) * bitmask
    words = np.packbits(b, axis=1).view(">u4").astype(np.uint32)
    assert native.stitch(words, bits) == pack_ragged_words(words, bits)


def test_entropy_decode_roundtrip(small_image):
    data = container.compress(small_image, 50)
    arrays = container.decompress_to_arrays(data, use_native=False)
    dc, ac = native.entropy_decode(data[HEADER_BYTES:], arrays.nblocks)
    assert np.array_equal(dc, arrays.dc)
    assert np.array_equal(ac, arrays.ac)


@pytest.mark.parametrize("quality", [10, 50, 90])
def test_entropy_encode_matches_host(quality):
    img = synthetic_image(64, 80, seed=31)
    arrays = golden.encode_arrays(img, quality)
    payload, nbits = native.entropy_encode(arrays.dc, arrays.ac)
    assert payload == container.compress(img, quality)[HEADER_BYTES:]
    assert (nbits + 7) // 8 == len(payload)
    assert (payload, nbits) == jnative.entropy_encode(arrays.dc, arrays.ac)


def test_entropy_decode_truncated():
    img = synthetic_image(64, 64, seed=32)
    data = container.compress(img, 50)
    payload = data[HEADER_BYTES:]
    half = payload[: len(payload) // 2]
    dc, ac = native.entropy_decode(half, 64)
    # early fully-decoded blocks must match; tail is zero-filled
    full = container.decompress_to_arrays(data, use_native=False)
    n_ok = next(
        (i for i in range(64) if not np.array_equal(ac[i], full.ac[i])), 64
    )
    assert n_ok > 10  # got a meaningful prefix
    assert np.all(dc[n_ok + 1:] == 0)
    cut = container.decompress_to_arrays(data[: HEADER_BYTES + len(half)],
                                         use_native=False)
    assert np.array_equal(dc, cut.dc) and np.array_equal(ac, cut.ac)


def test_entropy_decode_garbage_no_crash():
    rng = np.random.RandomState(4)
    junk = rng.bytes(512)
    dc, ac = native.entropy_decode(junk, 100)
    assert dc.shape == (100,) and ac.shape == (100, 63)
    jdc, jac = jnative.entropy_decode(junk, 100)
    assert np.array_equal(dc, jdc) and np.array_equal(ac, jac)


def test_native_sanitizer_selftest(tmp_path):
    """Build the port's ``native/selftest.c`` with ASan + UBSan and run it:
    it round-trips the entropy coder, checks the stitcher against a naive
    bit appender, feeds corrupt and truncated payloads, and probes
    capacity edges; any out-of-bounds access or undefined behaviour aborts
    the subprocess through the sanitizer runtime."""
    src_dir = native._DIR
    exe = tmp_path / "selftest"
    cc = os.environ.get("CC", "cc")
    build = subprocess.run(
        [cc, "-O1", "-g", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=all",
         os.path.join(src_dir, "selftest.c"),
         os.path.join(src_dir, "codec_native.c"),
         os.path.join(src_dir, "embedded.c"),
         "-o", str(exe)],
        capture_output=True, text=True,
    )
    assert build.returncode == 0, build.stderr

    dc_lut, ac_lut = native._default_luts()
    blob = b"".join([
        np.ascontiguousarray(DC_CODE, np.uint32).tobytes(),
        np.ascontiguousarray(DC_CODELEN, np.uint8).tobytes(),
        np.ascontiguousarray(AC_CODE.reshape(-1), np.uint32).tobytes(),
        np.ascontiguousarray(AC_CODELEN.reshape(-1), np.uint8).tobytes(),
        dc_lut[0].tobytes(), dc_lut[1].tobytes(),
        ac_lut[0].tobytes(), ac_lut[1].tobytes(),
    ])
    tables = tmp_path / "tables.bin"
    tables.write_bytes(blob)
    run = subprocess.run([str(exe), str(tables)], capture_output=True,
                         timeout=120)
    assert run.returncode == 0, (
        run.stdout.decode(errors="replace")
        + run.stderr.decode(errors="replace")
    )
    assert b"selftest OK" in run.stdout


# ------------------------------------ C decoder == the pure-Python cursor


def _lying_trailer(data: bytes, nb: int, custom: bool) -> bytes:
    """``data`` with its last TICX offset moved past the true payload end
    (for a custom-table stream: inside the window by which the structural
    check over-counts, so only the payload-length check can refuse it)."""
    data = bytearray(data)
    body_len = struct.unpack_from("<I", data, len(data) - 8)[0]
    start = len(data) - 8 - body_len
    n_off = (body_len - 8) // 4
    if custom:
        reader = BitReader(bytes(data))
        reader.seek(HEADER_BYTES * 8)
        container.read_huffman_table(reader)
        bogus = (start - HEADER_BYTES) * 8 - 1
        assert bogus >= start * 8 - reader.tell()
    else:
        bogus = 0xFFFFFFFF
    struct.pack_into("<I", data, start + 8 + 4 * (n_off - 1), bogus)
    return bytes(data)


def _streams():
    img = synthetic_image(96, 80, seed=33)  # 120 blocks
    odd = synthetic_image(61, 83, seed=34)
    std = container.compress(img, 50)
    ticx = container.compress(img, 75, block_index=True, index_stride=16)
    auto = container.compress(img, 50, True)
    auto_ticx = container.compress(img, 90, True, block_index=True,
                                   index_stride=8)
    rng = np.random.RandomState(35)
    contrast = (rng.randint(0, 2, (64, 64)) * 255).astype(np.uint8)
    return {
        "standard": std,
        "standard, odd shape": container.compress(odd, 30),
        "standard, TICX stride 16": ticx,
        "custom table": auto,
        "custom table, TICX stride 8": auto_ticx,
        "extended custom table, q99": container.compress(contrast, 99, True,
                                                         block_index=True),
        "scaled DCT (embedded encoder)": native.embedded_encode(img, 1),
        "standard, TICX trailer that lies": _lying_trailer(ticx, 120, False),
        "custom table, TICX trailer that lies": _lying_trailer(
            auto_ticx, 120, True),
        "standard, truncated": std[: len(std) // 2],
        "custom table, truncated": auto[: len(auto) * 2 // 3],
    }


STREAMS = _streams()


@pytest.mark.parametrize("kind", sorted(STREAMS))
def test_c_decoder_equals_the_python_cursor(kind):
    data = STREAMS[kind]
    c = container.decompress_to_arrays(data)
    py = container.decompress_to_arrays(data, use_native=False)
    _same_arrays(c, py)
    _same_arrays(container.decompress_to_arrays(data, index_workers=1), py)
    # and the JAX package's C decoder reads the stream alike
    _same_arrays(jcontainer.decompress_to_arrays(data), py)
    assert np.array_equal(container.decompress(data),
                          golden.decode_arrays(py))


def test_lying_trailers_are_refused_before_the_index_is_used():
    assert container.parse_block_index(
        STREAMS["standard, TICX trailer that lies"], 120) is None
    # the structural check lets the custom-table one through; the native
    # branch's payload-length check refuses it
    assert container.parse_block_index(
        STREAMS["custom table, TICX trailer that lies"], 120) is not None


@pytest.mark.parametrize("trial", range(4))
def test_c_decoder_equals_the_python_cursor_on_garbage(trial):
    rng = np.random.RandomState(40 + trial)
    base = bytearray(STREAMS["custom table" if trial % 2 else "standard"])
    for _ in range(3):
        i = rng.randint(16 + 40 * (trial % 2), len(base))
        base[i] ^= 1 << rng.randint(0, 8)
    data = bytes(base)
    _same_arrays(container.decompress_to_arrays(data),
                 container.decompress_to_arrays(data, use_native=False))


# ------------------------------------------------------ embedded encoder


@pytest.mark.parametrize("qfactor", [0, 3])
def test_embedded_encode_equals_the_jax_packages(qfactor):
    img = synthetic_image(64, 96, seed=36)
    data = native.embedded_encode(img, qfactor)
    assert data == jnative.embedded_encode(img, qfactor)
    assert np.array_equal(container.decompress(data),
                          jcontainer.decompress(data))
    with pytest.raises(ValueError):
        native.embedded_encode(np.zeros((60, 64), np.uint8), 2)


def test_embedded_cli_equals_the_library():
    img = synthetic_image(64, 64, seed=37)
    proc = subprocess.run([native.embedded_cli_path(), "64", "64", "2"],
                          input=img.tobytes(), capture_output=True,
                          timeout=60)
    assert proc.returncode == 0
    assert proc.stdout == native.embedded_encode(img, 2)


# ------------------------------------------------------------ the build


def test_a_failed_build_raises_with_the_compilers_output(tmp_path,
                                                         monkeypatch):
    """No fallback: a compiler that fails or is missing raises."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CC", "false")
    with pytest.raises(RuntimeError, match="false failed"):
        native.library_path()
    monkeypatch.setenv("CC", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="not found"):
        native.library_path()
    assert not list(tmp_path.iterdir())


def test_the_build_lands_in_the_checkout_under_a_hashed_name():
    from tinyimgcodec_tpu_torch.ops import _build

    path = native.library_path()
    assert os.path.dirname(path) == str(_build.BUILD_DIR)
    name = os.path.basename(path)
    assert name.startswith("libcodec_native_") and name.endswith(".so")
    assert native.available()
