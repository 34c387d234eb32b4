"""The host runtime in C: builds ``codec_native.c`` + ``embedded.c`` with
the system C compiler and loads them through ctypes.

The port's copy of the JAX package's ``native`` module: the LUT entropy
decoder behind ``container.decompress_to_arrays`` (serial, and
chunk-parallel on TICX streams), the ragged-row stitcher, the
standard-table entropy encoder and the fixed-point embedded encoder.  The
port's decoder adds one entry point, ``tic_entropy_decode_batch``
(:func:`entropy_decode_batch`): a batch's streams decoded by the same
cursor, on several threads at once, straight into the narrow rows the
host-entropy decode leg uploads.

The library is compiled on first use into ``build/`` at the root of the
checkout (``ops/_build.BUILD_DIR``, shared with the CUDA kernels), into a
file whose name carries a hash of the sources and of the flags.  ``CC``
names the compiler (default ``cc``).  There is no fallback: a build or a
load that fails raises, with the compiler's output in the message, so
``available()`` means "built" and is never a quiet "no".
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from typing import NamedTuple

import numpy as np

from ..ops._build import BUILD_DIR

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "codec_native.c")
_EMBEDDED_SRC = os.path.join(_DIR, "embedded.c")

# No -march=native: the library lands in the checkout, which may be copied
# to a machine with another CPU.
CFLAGS = ("-O3",)

_LOCK = threading.Lock()


def _compile(out: str, args: list[str]) -> str:
    """Compile unless ``out`` exists; raise with the compiler's output."""
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    cc = os.environ.get("CC", "cc")
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [cc, *CFLAGS, *args, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(
            f"C compiler {cc!r} not found: the native host runtime cannot "
            "be built (set CC)") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(
            f"{cc} failed (exit {proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent compiles agree on the file
    return out


def _build(name: str, flags: tuple, sources: tuple, suffix: str = "") -> str:
    """Build ``sources`` with ``flags`` into ``BUILD_DIR``, under a name
    that carries a hash of the sources and of every flag."""
    h = hashlib.sha256()
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(CFLAGS + flags).encode())
    out = os.path.join(str(BUILD_DIR), f"{name}_{h.hexdigest()[:16]}{suffix}")
    with _LOCK:
        return _compile(out, [*flags, *sources])


def library_path() -> str:
    """The shared library, built if need be."""
    return _build("libcodec_native", ("-shared", "-fPIC"),
                  (_SRC, _EMBEDDED_SRC), ".so")


def embedded_cli_path() -> str:
    """Build (once) and return the streaming embedded-encoder CLI binary."""
    return _build("tic_embedded_encode", ("-DTIC_EMBEDDED_MAIN",),
                  (_EMBEDDED_SRC,))


@functools.cache
def lib() -> ctypes.CDLL:
    path = library_path()
    try:
        l = ctypes.CDLL(path)
    except OSError as e:
        raise RuntimeError(f"cannot load {path}: {e}") from e
    u8 = ctypes.POINTER(ctypes.c_uint8)
    u32 = ctypes.POINTER(ctypes.c_uint32)
    i32 = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.POINTER(ctypes.c_int64)
    l.tic_stitch.restype = ctypes.c_long
    l.tic_stitch.argtypes = [u32, i32, ctypes.c_long, ctypes.c_long, u8,
                             ctypes.c_long]
    l.tic_entropy_decode.restype = ctypes.c_long
    l.tic_entropy_decode.argtypes = [u8, ctypes.c_long, ctypes.c_long,
                                     u8, u8, u8, u8, i32, i32]
    l.tic_entropy_decode_at.restype = ctypes.c_long
    l.tic_entropy_decode_at.argtypes = [u8, ctypes.c_long, ctypes.c_long,
                                        ctypes.c_long, u8, u8, u8, u8,
                                        i32, i32]
    l.tic_entropy_decode_chunks.restype = ctypes.c_long
    l.tic_entropy_decode_chunks.argtypes = [
        u8, ctypes.c_long, i64, ctypes.c_long, ctypes.c_long,
        ctypes.c_long, u8, u8, u8, u8, i32, i32,
    ]
    l.tic_entropy_decode_batch.restype = ctypes.c_long
    l.tic_entropy_decode_batch.argtypes = [
        i64, i64, ctypes.c_long, ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int16), ctypes.c_void_p, ctypes.c_long, i64,
        ctypes.POINTER(ctypes.c_int16), i64,
    ]
    l.tic_entropy_encode.restype = ctypes.c_long
    l.tic_entropy_encode.argtypes = [i32, i32, ctypes.c_long, u32, u8,
                                     u32, u8, u8, ctypes.c_long]
    l.tic_embedded_encode.restype = ctypes.c_long
    l.tic_embedded_encode.argtypes = [u8, ctypes.c_uint32, ctypes.c_uint32,
                                      ctypes.c_uint8, u8, ctypes.c_long]
    return l


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def available() -> bool:
    """True once the library is built and loaded; a failed build raises."""
    return lib() is not None


def stitch(words: np.ndarray, bits: np.ndarray) -> bytes:
    """(n, stride) uint32 ragged bit buffers + per-row bit counts -> bytes."""
    l = lib()
    words = np.ascontiguousarray(words, dtype=np.uint32)
    bits = np.ascontiguousarray(bits, dtype=np.int32)
    n, stride = words.shape
    cap = int(bits.sum()) // 8 + 8
    out = np.zeros(cap, dtype=np.uint8)
    written = l.tic_stitch(
        _ptr(words, ctypes.c_uint32), _ptr(bits, ctypes.c_int32),
        n, stride, _ptr(out, ctypes.c_uint8), cap,
    )
    if written < 0:
        raise RuntimeError("tic_stitch: capacity exceeded")
    return out[:written].tobytes()


@functools.cache
def _default_luts():
    from ..constants import AC_CODE, AC_CODELEN, DC_CODE, DC_CODELEN

    return (
        build_decode_lut(
            {c: (int(DC_CODE[c]), int(DC_CODELEN[c])) for c in range(12)}
        ),
        build_decode_lut(
            {
                (r << 4) | s: (int(AC_CODE[r, s]), int(AC_CODELEN[r, s]))
                for r in range(16)
                for s in range(11)
                if AC_CODELEN[r, s]
            }
        ),
    )


def build_decode_lut(codes: dict[int, tuple[int, int]]):
    """symbol -> (code, len) map to a 16-bit peek LUT (len, sym) arrays."""
    lut_len = np.zeros(1 << 16, dtype=np.uint8)
    lut_sym = np.zeros(1 << 16, dtype=np.uint8)
    for sym, (code, length) in codes.items():
        base = code << (16 - length)
        span = 1 << (16 - length)
        lut_len[base : base + span] = length
        lut_sym[base : base + span] = sym
    return lut_len, lut_sym


def entropy_decode(
    payload: bytes,
    nblocks: int,
    dc_lut=None,
    ac_lut=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Payload bytes -> (dc diffs (nb,), ac (nb, 63)) int32 arrays."""
    l = lib()
    if dc_lut is None or ac_lut is None:
        dc_lut, ac_lut = _default_luts()
    data = np.frombuffer(payload, dtype=np.uint8)
    dc = np.zeros(nblocks, dtype=np.int32)
    ac = np.zeros((nblocks, 63), dtype=np.int32)
    l.tic_entropy_decode(
        _ptr(data, ctypes.c_uint8), len(payload) * 8, nblocks,
        _ptr(dc_lut[0], ctypes.c_uint8), _ptr(dc_lut[1], ctypes.c_uint8),
        _ptr(ac_lut[0], ctypes.c_uint8), _ptr(ac_lut[1], ctypes.c_uint8),
        _ptr(dc, ctypes.c_int32), _ptr(ac, ctypes.c_int32),
    )
    return dc, ac


def entropy_decode_indexed(
    payload: bytes,
    nblocks: int,
    chunk_offsets: np.ndarray,
    stride: int,
    dc_lut=None,
    ac_lut=None,
    max_workers: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Index-parallel entropy decode (the TICX trailer of ``container``).

    chunk_offsets[i] is the payload bit offset of block i*stride; chunks
    are disjoint, each thread decodes its own block range into disjoint
    slices of the shared output (the ctypes call releases the GIL, so
    this scales with cores).
    """
    l = lib()
    if dc_lut is None or ac_lut is None:
        dc_lut, ac_lut = _default_luts()
    data = np.frombuffer(payload, dtype=np.uint8)
    nbits = len(payload) * 8
    dc = np.zeros(nblocks, dtype=np.int32)
    ac = np.zeros((nblocks, 63), dtype=np.int32)
    offs = np.ascontiguousarray(chunk_offsets, dtype=np.int64)
    nchunks = len(offs)

    def run_span(c0: int, nch: int) -> None:
        b0 = c0 * stride
        l.tic_entropy_decode_chunks(
            _ptr(data, ctypes.c_uint8), nbits,
            _ptr(offs[c0:], ctypes.c_int64), nch, stride, nblocks - b0,
            _ptr(dc_lut[0], ctypes.c_uint8), _ptr(dc_lut[1], ctypes.c_uint8),
            _ptr(ac_lut[0], ctypes.c_uint8), _ptr(ac_lut[1], ctypes.c_uint8),
            _ptr(dc[b0:], ctypes.c_int32), _ptr(ac[b0:], ctypes.c_int32),
        )

    workers = min(nchunks, max_workers or os.cpu_count() or 1)
    if workers > 1:
        # one C call per thread, each covering a contiguous chunk span
        # (per-chunk dispatch overhead would dwarf the decode work)
        per = -(-nchunks // workers)
        spans = [(c0, min(per, nchunks - c0))
                 for c0 in range(0, nchunks, per)]
        list(_decode_pool().map(lambda s: run_span(*s), spans))
    else:
        run_span(0, nchunks)
    return dc, ac


class BatchRows(NamedTuple):
    """A batch's coefficients as :func:`entropy_decode_batch` writes them:
    ``dc`` (B, nb) int16 DC differences, ``ac`` (B, nb, 63) zig-zag AC,
    int8 (wrapped) or int16; for int8, ``counts`` (B,) the AC values
    outside int8 a stream (-1 where the stream cannot go narrow: its list
    overflowed, or a delta lies beyond int16), and the lists, row s of
    ``idx`` (B, cap) int64 (flat indices into ``ac``) and ``val`` (B, cap)
    int16 (the value less its int8 wrap), valid to ``counts[s]``; for
    int16, ``counts`` all zero and no lists."""

    dc: np.ndarray
    ac: np.ndarray
    counts: np.ndarray
    idx: np.ndarray
    val: np.ndarray


def entropy_decode_batch(plans, width: int = 1,
                         workers: int = 1) -> BatchRows:
    """Streams of equal block counts -> their coefficients in the batch's
    upload form: one C call (``tic_entropy_decode_batch``) a worker, the
    calling thread and ``workers - 1`` of the decode pool, each taking the
    next stream from a shared cursor until none is left.

    ``plans``: one a stream, each with ``payload`` (uint8 array: the bytes
    the cursor reads), ``nblocks``, ``starts`` (int64 TICX chunk bit
    offsets, or None for the serial cursor), ``stride`` and ``luts``
    (``(dc_lut, ac_lut)``, None for the standard tables): what
    ``container.payload_plan`` gives.  Each stream is decoded as
    :func:`entropy_decode` / :func:`entropy_decode_indexed` decode it.
    ``width`` 1 writes int8 AC and lists the values outside int8, at most
    ``nb * 63 // 8`` a stream; 2 writes int16 AC and no lists."""
    if width not in (1, 2):
        raise ValueError(f"width {width}: 1 (int8 AC) or 2 (int16 AC)")
    l = lib()
    n = len(plans)
    nb = plans[0].nblocks if n else 0
    if any(p.nblocks != nb for p in plans):
        raise ValueError("streams of different block counts")
    table = np.zeros((n, 9), np.int64)
    for s, p in enumerate(plans):
        dc_lut, ac_lut = p.luts or _default_luts()
        table[s] = (p.payload.ctypes.data, p.payload.size * 8,
                    0 if p.starts is None else p.starts.ctypes.data,
                    0 if p.starts is None else p.starts.size, p.stride,
                    dc_lut[0].ctypes.data, dc_lut[1].ctypes.data,
                    ac_lut[0].ctypes.data, ac_lut[1].ctypes.data)
    cap = nb * 63 // 8 if width == 1 else 0
    rows = BatchRows(np.empty((n, nb), np.int16),
                     np.empty((n, nb, 63), np.int8 if width == 1 else
                              np.int16),
                     np.zeros(n, np.int64), np.empty((n, cap), np.int64),
                     np.empty((n, cap), np.int16))

    cursor = np.zeros(1, np.int64)

    def run() -> None:
        l.tic_entropy_decode_batch(
            _ptr(table, ctypes.c_int64), _ptr(cursor, ctypes.c_int64), n,
            nb, width, _ptr(rows.dc, ctypes.c_int16), rows.ac.ctypes.data,
            cap, _ptr(rows.idx, ctypes.c_int64),
            _ptr(rows.val, ctypes.c_int16), _ptr(rows.counts, ctypes.c_int64))

    helpers = [_decode_pool().submit(run) for _ in range(min(workers, n) - 1)]
    run()
    # the cursor is spent: a helper not started yet has nothing to do
    for f in helpers:
        if not f.cancel():
            f.result()
    return rows


@functools.cache
def _decode_pool():
    from concurrent.futures import ThreadPoolExecutor

    return ThreadPoolExecutor(os.cpu_count() or 1)


def entropy_encode(dc: np.ndarray, ac: np.ndarray) -> tuple[bytes, int]:
    """(nb,) DC diffs + (nb, 63) zig-zag AC -> (payload bytes, bit length)."""
    from ..constants import AC_CODE, AC_CODELEN, DC_CODE, DC_CODELEN

    l = lib()
    dc = np.ascontiguousarray(dc, dtype=np.int32)
    ac = np.ascontiguousarray(ac, dtype=np.int32)
    nb = dc.shape[0]
    cap = nb * 212 + 16  # worst legal block is 1662 bits = 208 bytes
    out = np.zeros(cap, dtype=np.uint8)
    dcc = np.ascontiguousarray(DC_CODE, dtype=np.uint32)
    dcl = np.ascontiguousarray(DC_CODELEN, dtype=np.uint8)
    acc = np.ascontiguousarray(AC_CODE.reshape(-1), dtype=np.uint32)
    acl = np.ascontiguousarray(AC_CODELEN.reshape(-1), dtype=np.uint8)
    nbits = l.tic_entropy_encode(
        _ptr(dc, ctypes.c_int32), _ptr(ac, ctypes.c_int32), nb,
        _ptr(dcc, ctypes.c_uint32), _ptr(dcl, ctypes.c_uint8),
        _ptr(acc, ctypes.c_uint32), _ptr(acl, ctypes.c_uint8),
        _ptr(out, ctypes.c_uint8), cap,
    )
    if nbits < 0:
        raise ValueError("entropy encode failed (magnitude out of range)")
    return out[: (nbits + 7) // 8].tobytes(), int(nbits)


def embedded_encode(pixels: np.ndarray, qfactor: int = 2) -> bytes:
    """Fixed-point embedded-profile encoder -> scaled_dct stream.

    pixels: (H, W) uint8, dims multiples of 8; qfactor 0 (best) .. 3 (low).
    """
    l = lib()
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    h, w = pixels.shape
    cap = 16 + h * w  # ~8 bpp worst case
    out = np.zeros(cap, dtype=np.uint8)
    n = l.tic_embedded_encode(
        _ptr(pixels, ctypes.c_uint8), w, h, qfactor,
        _ptr(out, ctypes.c_uint8), cap,
    )
    if n < 0:
        raise ValueError(f"embedded encode failed ({n})")
    return out[:n].tobytes()
