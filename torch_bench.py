#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port: corpus encode throughput on
one NVIDIA card, and the modes around it.

The counterpart of the JAX package's ``bench.py``.  Workload: the 49-image
512x512 corpus (``corpus.load_corpus()``: the reference images where
``data/`` holds them, else ``synthetic_corpus``; the record says which),
quality 50.  Run from the root of a checkout:

    python3 torch_bench.py                  # the current card
    python3 torch_bench.py --device cuda:1  # another card
    python3 torch_bench.py --rehearse       # every mode at a tiny size on
                                            # the CPU (plain versions);
                                            # every value null

Modes (``MODES``; ``bench.py``'s names with ``pallas-`` -> ``cuda-`` and
``xla-`` -> ``batch-``):

- ``*/device``, ``decode/device-*``: one pass of kernels on tensors that
  stay on the card, captured once in a ``torch.cuda.CUDAGraph`` and
  replayed k times between two CUDA events (no host in the loop; the
  input is read warm from the 50 MB L2 when it fits there, as the 12.8 MB
  corpus and the 16.8 MB 4096x4096 mosaic do).  Each compares the graph's
  output once with an eager call of the same pass.
- ``*e2e``, ``decode/entropy-host``, ``decode/1stream-*``: host clock
  around a whole call of a public entry point, one warm call first.

Every mode gives ``REPS`` samples (a sample of a graph mode is the mean of
its k replays) and the record keeps their median, p10 and p90 in MP/s.
The checks: the corpus streams made as ``chip_smoke.py`` makes them keep
their pinned sha256; the modes' bytes equal the oracle's (exact) or the v2
fast bytes; decoded pixels are within one level of the oracle's on at
most 0.1 % of the pixels, the bar of fast-precision decode; and the
conformance check of ``bench.py``.  A failed mode or check is named in
``failed`` and the run exits 1; there is no fallback and no stale number.

Not carried over from ``bench.py``: its supervisor process and partial
results (a stale number in place of a failed run hides the device), the
retry without the word-packed input, the XLA compile cache, the
always-zero perturbation that kept XLA from hoisting the pass out of its
loop (a graph replay hoists nothing), and ``decode/device-fastpath``,
which times a slot budget of the TPU decoder that the port does not have.

The last line of standard output is one JSON object: ``metric``,
``value`` (the median of ``cuda-fast/device``), ``unit``, ``device`` (the
card's name and power limit as ``nvidia-smi`` prints them, and the count
of cards), ``torch``, ``cuda``, ``modes``, ``failed``, and notes.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import signal
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tinyimgcodec_tpu_torch import api, container, corpus, native
from tinyimgcodec_tpu_torch.constants import HEADER_BYTES
from tinyimgcodec_tpu_torch.device import card_lines, resolve_device
from tinyimgcodec_tpu_torch.engine import (
    Engine, compact_coefficients, widen_coefficients,
)
from tinyimgcodec_tpu_torch.metrics import psnr
from tinyimgcodec_tpu_torch.ops import (
    _build, encode2, entropy_decode, exact_transform, place, transform,
)
from tinyimgcodec_tpu_torch.parallel import batch as pbatch
from tinyimgcodec_tpu_torch.parallel import make_mesh
from tinyimgcodec_tpu_torch.pipeline import (
    compress_batch_device, split_streams, stream_bytes,
)
from tinyimgcodec_tpu_torch.tables import CodecTables, DecodeTables

QUALITY = 50
REPS = 5  # samples of every mode
K_ENCODE = 100  # graph replays a sample: encode of the corpus
K_4K = 50  # the 4096x4096 mosaic
K_DECODE = 50  # entropy decode + transform
K_TRANSFORM = 100  # decode transform alone
PHASE_SECONDS = 600  # each mode's and check's own time limit

# The corpus streams of ``chip_smoke.py`` (``synthetic_corpus(49, 512)``,
# q=50, block index on), unchanged since the port's second slice.
SHA256_FAST = (
    "dcc29e818283cd09647bd85773969c24cd479dc0d5dba79b43b2469d78a47549")
SHA256_EXACT = (
    "bc527ae862612df9f10296110178e615b0e1d32cabeafbca22922d17581d6133")

MODES = (
    "cuda-fast/device", "cuda-exact/device",
    "cuda-fast/staged-e2e", "cuda-fast/host-e2e",
    "api/staged-e2e", "api/1image-e2e",
    "cuda-fast/4k-device",
    "batch-fast/device/staged", "exact/host/e2e",
    "decode/e2e", "decode/e2e-indexed",
    "decode/device-full", "decode/device-dense-q90",
    "decode/device-custom-table",
    "decode/entropy-host", "decode/device",
    "decode/1stream-serial", "decode/1stream-indexed-{nt}t",
)

# thread counts of ``decode/1stream-indexed-{nt}t``, as in bench.py
THREADS = sorted({2, os.cpu_count() or 2})

CHUNK_KEYS = ("chunk_start", "chunk_blocks", "chunk_block_base",
              "chunk_end_lo", "chunk_end_hi")


def mode_names() -> list[str]:
    """``MODES`` with ``{nt}`` spelled out for each of ``THREADS``."""
    return [m.replace("{nt}", str(nt)) for m in MODES
            for nt in (THREADS if "{nt}" in m else [0])]


class BenchError(RuntimeError):
    """A mode's check failed: its number does not stand."""


def log(*a):
    print(*a, file=sys.stderr, flush=True)


@contextlib.contextmanager
def _alarm(seconds: int):
    """Hard time limit of one mode or check."""

    def _raise(*_):
        raise TimeoutError(f"phase exceeded {seconds}s")

    old = signal.signal(signal.SIGALRM, _raise)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def mosaic(images: np.ndarray) -> np.ndarray:
    """The first 16 images as one 4x4 mosaic (image 4c + r at row r,
    column c): ``bench.py``'s 2048x2048 image of the corpus."""
    t4 = np.concatenate(np.split(images[:16], 4), axis=2)
    return np.ascontiguousarray(
        np.concatenate([t[0] for t in np.split(t4, 4)], axis=0))


def rates(pixels: int, ms: list[float]) -> list[float]:
    """MP/s of each sample of ``ms`` milliseconds for ``pixels`` pixels."""
    return [pixels / 1e3 / m for m in ms]


def summary(samples: list[float]) -> dict:
    if not samples:
        return {"median": None, "p10": None, "p90": None, "samples": 0}
    a = np.asarray(samples, np.float64)
    return {"median": float(np.median(a)),
            "p10": float(np.percentile(a, 10)),
            "p90": float(np.percentile(a, 90)), "samples": len(samples)}


def host_samples(fn, reps: int, dev: torch.device):
    """One warm call of ``fn``, then ``reps`` calls on the host clock, each
    ended by a synchronise: (the last call's result, ms of each)."""
    fn()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, ms


def replay(step, k: int, reps: int, dev: torch.device):
    """``step()``: one pass on tensors that stay on ``dev``, with no host
    sync, returning a tuple of tensors.  It is called eagerly, captured
    once in a CUDA graph (after a warm-up call on a side stream) and the
    graph replayed ``k`` times between two CUDA events, ``reps`` times.
    Returns (the eager outputs, copies of the graph's outputs after its
    first replay, ms a pass of each sample).  On the CPU (a rehearsal)
    the graph's place is taken by a second eager call and there are no
    samples.  A capture that fails raises; nothing falls back to eager
    timing."""
    eager = step()
    if dev.type != "cuda":
        return eager, step(), []
    with torch.cuda.device(dev):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = step()
        graph.replay()
        first = tuple(t.clone() for t in out)
        ms = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(k):
                graph.replay()
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b) / k)
    return eager, first, ms


# ------------------------------------------------- row 3: encode on the card


def encode_pass(pixels: torch.Tensor, tables: CodecTables, precision: str,
                cap: int):
    """One encode pass on (B, H, W) block-aligned uint8 pixels on the
    device, with no host sync: ``blockify``, ``exact_transform`` (exact
    only), ``encode2`` (from the pixels, or from the exact coefficients),
    ``place`` at ``cap`` words.  Returns (stream words (cap,) int32, image
    start bits (B,), total bits, capacity or table overflow, the
    ``exact_transform`` tie flags (N,), empty in fast mode).  The exact
    pass settles its flagged blocks inside ``exact_transform``, so its
    bytes are the float64 oracle's (``bench.py``'s pass left them out)."""
    b, h, w = pixels.shape
    nb = (h // 8) * (w // 8)
    blocks = transform.blockify(pixels).reshape(b * nb, 64)
    if precision == transform.EXACT:
        zz, flags, _ = exact_transform.exact_transform(blocks, tables)
        packed, meta, table_over = encode2.encode2(zz, tables, nb,
                                                   from_zz=True)
    else:
        packed, meta, table_over = encode2.encode2(blocks, tables, nb)
        flags = meta[1, :0]
    stream, starts, total, cap_over = place.place(packed, meta, nb, cap)
    return stream, starts, total, table_over | cap_over, flags


def same_encode(a, b) -> bool:
    """Two passes' stream words up to the total, image starts, total,
    overflow and flags are equal."""
    total = int(a[2])
    words = -(-total // 32)
    return (total == int(b[2]) and torch.equal(a[0][:words], b[0][:words])
            and torch.equal(a[1], b[1]) and bool(a[3]) == bool(b[3])
            and torch.equal(a[4], b[4]))


def pass_streams(out, true_shape: tuple[int, int],
                 quality: int) -> list[bytes]:
    """An encode pass's words -> one stream an image, without index, cut
    as ``pipeline.compress_batch_device`` cuts them."""
    total = int(out[2])
    raw = stream_bytes(out[0][: -(-total // 32)], total)
    return split_streams(raw, out[1].cpu().numpy().astype(np.int64),
                         true_shape, quality)


def bench_device(images: np.ndarray, quality: int, precision: str,
                 k: int = K_ENCODE, dev: torch.device | None = None,
                 reps: int = REPS):
    """Row 3: the encode pass on the card with the pixels resident there,
    replayed from a CUDA graph.  Returns (MP/s samples, the graph's
    outputs); raises ``BenchError`` if the graph's stream differs from an
    eager pass's or overflowed."""
    dev = resolve_device(dev)
    pixels = torch.from_numpy(
        np.ascontiguousarray(images, dtype=np.uint8)).to(dev)
    tables = CodecTables.build(quality, dev)
    cap = -(-images.size * 4 // 32)  # words, bench.py:83
    eager, out, ms = replay(
        lambda: encode_pass(pixels, tables, precision, cap), k, reps, dev)
    if not same_encode(eager, out):
        raise BenchError(f"{precision} encode: the graph's stream differs "
                         "from the eager pass's")
    if bool(out[3]):
        raise BenchError(f"{precision} encode: the stream passed {cap} words "
                         "or a table's range")
    return rates(images.size, ms), out


# ------------------------------------------- row 4: full decode on the card


def decode_inputs(streams: list[bytes], dev: torch.device):
    """Row 4's set-up, outside its timing, as the engine's kernel leg does
    it: ``prepare_batch`` and ``DecodeTables`` (a stream's own table:
    canonical form and first-level lookup, in numpy) on the host, then the
    uploads.  Returns (prep, [words, chunk arrays...], tables), or
    ``None`` when the streams cannot take the kernel leg."""
    prep = entropy_decode.prepare_batch(streams)
    if prep is None:
        return None
    tables = DecodeTables.build(prep["shape"][2], prep["scaled_dct"], dev,
                                huffman=prep["tables"])
    args = [torch.from_numpy(prep["words"].view(np.int32)).to(dev)] + [
        torch.from_numpy(prep[key]).to(dev) for key in CHUNK_KEYS]
    return prep, args, tables


def decode_pass(prep: dict, args: list, tables: DecodeTables):
    """One full decode pass on the card, no host sync: ``entropy_decode``,
    ``undo_dpcm``, ``decode_blocks`` (fast), ``unblockify``.  Returns
    ((B, H8, W8) uint8 pixels, (C,) chunk ok flags)."""
    h, w, quality = prep["shape"]
    nb = prep["nb_per_image"]
    zz, ok = entropy_decode.entropy_decode_chunks(
        *args, prep["nb_total"], tables)
    zz_abs = transform.undo_dpcm(zz.reshape(-1, nb, 64))
    blocks = transform.decode_blocks(
        zz_abs, quality, scaled_dct=prep["scaled_dct"], tables=tables)
    return transform.unblockify(blocks, -(-h // 8) * 8, -(-w // 8) * 8), ok


def bench_decode_entropy_device(streams: list[bytes], k: int = K_DECODE,
                                dev: torch.device | None = None,
                                reps: int = REPS):
    """Row 4: the full decode of TICX-indexed streams with the words
    resident on the card, replayed from a CUDA graph.  Returns (MP/s
    samples, the graph's (B, H8, W8) pixels); raises ``BenchError`` if
    they differ from an eager pass's or a chunk failed validation."""
    dev = resolve_device(dev)
    got = decode_inputs(streams, dev)
    if got is None:
        raise BenchError("the streams cannot take the kernel leg")
    eager, out, ms = replay(lambda: decode_pass(*got), k, reps, dev)
    if not torch.equal(eager[0], out[0]):
        raise BenchError("decode: the graph's pixels differ from the eager "
                         "pass's")
    failed = int((~out[1]).sum())
    if failed:
        raise BenchError(f"decode: {failed} chunks failed validation")
    h, w, _ = got[0]["shape"]
    return rates(len(streams) * h * w, ms), out[0]


# ---------------------------------------- row 5: decode transform on the card


def bench_decode_device(arrays: list, k: int = K_TRANSFORM,
                        dev: torch.device | None = None, reps: int = REPS):
    """Row 5: the transform half of decode alone from the compact form
    the engine's host-entropy leg uploads (int16 DC, int8 or int16 AC and
    the outliers, ``engine.compact_coefficients``), resident on the card:
    ``widen_coefficients``, ``undo_dpcm``, ``decode_blocks`` fast,
    ``unblockify``, replayed from a CUDA graph, as ``bench.py``'s
    ``bench_decode_device``.  Returns (MP/s samples, the graph's (B, H8,
    W8) pixels)."""
    dev = resolve_device(dev)
    a0 = arrays[0]
    h8, w8 = -(-a0.height // 8) * 8, -(-a0.width // 8) * 8
    tables = DecodeTables.build(int(a0.quality), bool(a0.scaled_dct), dev)
    narrow = [torch.from_numpy(x).to(dev) for x in compact_coefficients(
        np.stack([a.dc for a in arrays]), np.stack([a.ac for a in arrays]))]

    def step():
        zz = widen_coefficients(*narrow, dev)
        blocks = transform.decode_blocks(
            transform.undo_dpcm(zz), int(a0.quality), tables=tables)
        return (transform.unblockify(blocks, h8, w8),)

    eager, out, ms = replay(step, k, reps, dev)
    if not torch.equal(eager[0], out[0]):
        raise BenchError("decode transform: the graph's pixels differ from "
                         "the eager pass's")
    return rates(len(arrays) * a0.height * a0.width, ms), out[0]


# ------------------------------------------- row 2: the batch entry point


def bench_mode(images, quality: int, precision: str, assemble: str, mesh,
               reps: int, staged=None):
    """Row 2: ``parallel.batch.compress_batch`` at a world of one, host
    clock.  Returns (MP/s samples, the last call's streams)."""
    out, ms = host_samples(lambda: pbatch.compress_batch(
        images, quality=quality, mesh=mesh, precision=precision,
        assemble=assemble, staged=staged), reps, mesh.device)
    return rates(images.size, ms), out


# ------------------------------------------------------------------ the run


def within_one_level(got: np.ndarray, want: np.ndarray, what: str) -> None:
    """The bar of fast-precision decode against the float64 oracle: no
    pixel more than one level away, at most 0.1 % of them one away."""
    if got.shape != want.shape:
        raise BenchError(f"{what}: shape {got.shape}, oracle {want.shape}")
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    if diff.max() > 1 or (diff != 0).mean() > 1e-3:
        raise BenchError(f"{what}: {int((diff != 0).sum())} pixels differ "
                         f"from the oracle's, at most by {int(diff.max())}")


class Bench:
    """One run: the corpus, the device, what the modes share (made once,
    on first use), and what they recorded."""

    def __init__(self, dev: torch.device, rehearse: bool):
        self.dev = dev
        self.rehearse = rehearse
        self.reps = 1 if rehearse else REPS
        # 16 images: the mosaics need as many
        self.images = (corpus.synthetic_corpus(16, 32) if rehearse
                       else corpus.load_corpus())
        self.modes: dict[str, dict] = {}
        self.notes: dict[str, dict] = {}
        self.failed: list[str] = []
        self._made: dict = {}

    def once(self, key, make):
        if key not in self._made:
            self._made[key] = make()
        return self._made[key]

    # -- shared inputs ---------------------------------------------------
    def pixels(self) -> torch.Tensor:
        return self.once("pixels", lambda: torch.from_numpy(
            self.images).to(self.dev))

    def streams(self, precision: str = transform.FAST,
                quality: int = QUALITY, index: bool = False) -> list[bytes]:
        return self.once(("streams", precision, quality, index),
                         lambda: compress_batch_device(
                             self.images, quality, precision=precision,
                             block_index=index, device=self.dev))

    def oracle_pixels(self, streams: list[bytes], key) -> np.ndarray:
        return self.once(("oracle", key), lambda: np.stack(
            [container.decompress(s) for s in streams]))

    def hold_fast(self, streams: list[bytes], what: str) -> None:
        """Fast streams without index == the v2 fast bytes: the payload of
        the fast indexed streams, whose sha256 the run checks."""
        ixd = self.streams(index=True)
        if len(streams) != len(ixd) or any(
                len(i) <= len(s) or i[: len(s)] != s
                for s, i in zip(streams, ixd)):
            raise BenchError(f"{what}: bytes differ from the v2 fast bytes")

    def hold_indexed(self, streams: list[bytes], what: str) -> None:
        if streams != self.streams(index=True)[: len(streams)]:
            raise BenchError(f"{what}: bytes differ from the v2 fast bytes")

    # -- row 3 -----------------------------------------------------------
    def cuda_device(self, precision: str) -> list[float]:
        samples, out = bench_device(self.images, QUALITY, precision,
                                    K_ENCODE, self.dev, self.reps)
        if precision == transform.FAST:
            self.hold_fast(pass_streams(out, self.images.shape[1:], QUALITY),
                           "the graph's streams")
            self.notes["cuda-fast/device"] = {"k": K_ENCODE}
        else:
            if pass_streams(out, self.images.shape[1:], QUALITY) != (
                    self.streams(transform.EXACT)):
                raise BenchError("the exact graph's streams differ from "
                                 "the oracle's bytes")
            self.notes["cuda-exact/device"] = {
                "k": K_ENCODE,
                "flagged_blocks": int((out[4] != 0).sum())}
        return samples

    def cuda_4k_device(self) -> list[float]:
        big = np.tile(mosaic(self.images), (2, 2))[None]
        samples, out = bench_device(big, QUALITY, transform.FAST, K_4K,
                                    self.dev, self.reps)
        if pass_streams(out, big.shape[1:], QUALITY) != compress_batch_device(
                big, QUALITY, precision=transform.FAST, device=self.dev):
            raise BenchError("4k: the graph's stream differs from "
                             "compress_batch_device's")
        self.notes["cuda-fast/4k-device"] = {"k": K_4K,
                                             "shape": list(big.shape)}
        return samples

    # -- e2e encode ------------------------------------------------------
    def pipeline_e2e(self, staged: bool) -> list[float]:
        src = self.pixels() if staged else self.images
        out, ms = host_samples(lambda: compress_batch_device(
            src, QUALITY, precision=transform.FAST, device=self.dev),
            self.reps, self.dev)
        self.hold_fast(out, "compress_batch_device")
        return rates(self.images.size, ms)

    def api_staged_e2e(self) -> list[float]:
        out, ms = host_samples(lambda: api.compress_batch(
            self.pixels(), QUALITY, precision=transform.FAST,
            device=self.dev), self.reps, self.dev)
        self.hold_indexed(out, "api.compress_batch")
        return rates(self.images.size, ms)

    def api_1image_e2e(self) -> list[float]:
        eng = Engine(transform.FAST, self.dev)
        out, ms = host_samples(lambda: eng.compress(self.images[0], QUALITY),
                               self.reps, self.dev)
        self.hold_indexed([out], "Engine.compress")
        return rates(self.images[0].size, ms)

    def batch_fast_staged(self) -> list[float]:
        mesh = make_mesh(device=self.dev)
        staged = pbatch.stage_images(self.images, mesh)
        samples, out = bench_mode(self.images, QUALITY, transform.FAST,
                                  "device", mesh, self.reps, staged)
        self.hold_fast(out, "parallel.batch.compress_batch fast")
        return samples

    def exact_host_e2e(self) -> list[float]:
        samples, out = bench_mode(self.images, QUALITY, transform.EXACT,
                                  "host", make_mesh(device=self.dev),
                                  self.reps)
        mism = [i for i, (s, im) in enumerate(zip(out, self.images))
                if s != container.compress(im, QUALITY)]
        if mism:
            raise BenchError(f"exact bytes differ from the oracle for "
                             f"images {mism}")
        return samples

    # -- decode ----------------------------------------------------------
    def decode_e2e(self, index: bool) -> list[float]:
        streams = self.streams(index=index)
        eng = Engine(transform.FAST, self.dev)
        out, ms = host_samples(lambda: eng.decompress_batch(streams),
                               self.reps, self.dev)
        leg = "kernel" if index else "host_entropy"
        want = {"kernel": 0, "host_entropy": 0, "host_decoder": 0}
        want[leg] = len(streams)
        if eng.decode_stats != want:
            raise BenchError(f"decode legs {eng.decode_stats}, expected "
                             f"{want}")
        within_one_level(out, self.oracle_pixels(streams, "q50"),
                         "decompress_batch")
        name = "decode/e2e-indexed" if index else "decode/e2e"
        self.notes[name] = {"decode_stats": dict(eng.decode_stats)}
        return rates(self.images.size, ms)

    def decode_device(self, name: str, streams: list[bytes], k: int,
                      oracle_key: str) -> list[float]:
        samples, pixels = bench_decode_entropy_device(streams, k, self.dev,
                                                      self.reps)
        h, w = container.parse_header(streams[0])[:2]
        within_one_level(pixels[:, :h, :w].cpu().numpy(),
                         self.oracle_pixels(streams, oracle_key), name)
        self.notes[name] = {
            "k": k, "images": len(streams), "shape": [h, w],
            "outside_the_timing": "prepare_batch and DecodeTables on the "
            "host (for a stream's own table: canonical form and first-level "
            "lookup in numpy), the upload of words, chunk arrays and tables"}
        return samples

    def auto_table_stream(self) -> list[bytes]:
        """The 2048x2048 mosaic with a Huffman table of its own."""
        def make():
            stream = Engine(transform.FAST, self.dev).compress(
                mosaic(self.images), QUALITY, auto_table=True)
            prep = entropy_decode.prepare_batch([stream])
            if prep is None or prep["tables"] is None:
                raise BenchError("the auto-table stream does not take the "
                                 "kernel leg with a table of its own")
            return [stream]
        return self.once("auto", make)

    def entropy_host(self) -> list[float]:
        streams = self.streams()

        def run():
            with ThreadPoolExecutor(2) as pool:
                return list(pool.map(container.decompress_to_arrays,
                                     streams))

        arrays, ms = host_samples(run, self.reps, self.dev)
        self._made["arrays"] = arrays
        return rates(self.images.size, ms)

    def transform_device(self) -> list[float]:
        arrays = self.once("arrays", lambda: [
            container.decompress_to_arrays(s) for s in self.streams()])
        samples, pixels = bench_decode_device(arrays, K_TRANSFORM, self.dev,
                                              self.reps)
        within_one_level(pixels.cpu().numpy(),
                         self.oracle_pixels(self.streams(), "q50"),
                         "decode transform")
        self.notes["decode/device"] = {
            "k": K_TRANSFORM,
            "starts_from": "the compact form the host-entropy leg uploads "
            "(int16 DC, int8 AC + outliers), widened inside the pass"}
        return samples

    def one_stream(self):
        """One 2048x2048 mosaic stream with index: (payload, blocks, chunk
        offsets, stride, pixels)."""
        def make():
            big = mosaic(self.images)
            nb = big.size // 64
            stream = compress_batch_device(big[None], QUALITY,
                                           block_index=True,
                                           device=self.dev)[0]
            chunk_off, stride, pay_end = container.parse_block_index(
                stream, nb)
            return stream[HEADER_BYTES:pay_end], nb, chunk_off, stride, \
                big.size
        return self.once("one_stream", make)

    def one_stream_serial(self) -> list[float]:
        payload, nb, _, _, pixels = self.one_stream()
        out, ms = host_samples(lambda: native.entropy_decode(payload, nb),
                               self.reps, self.dev)
        self._made["one_stream_arrays"] = out
        return rates(pixels, ms)

    def one_stream_indexed(self, nt: int) -> list[float]:
        payload, nb, chunk_off, stride, pixels = self.one_stream()
        out, ms = host_samples(lambda: native.entropy_decode_indexed(
            payload, nb, chunk_off, stride, max_workers=nt),
            self.reps, self.dev)
        serial = self.once("one_stream_arrays",
                           lambda: native.entropy_decode(payload, nb))
        if not all(np.array_equal(a, b) for a, b in zip(out, serial)):
            raise BenchError(f"indexed decode on {nt} threads differs from "
                             "the serial cursor")
        return rates(pixels, ms)

    # -- checks ----------------------------------------------------------
    def check_sha256(self) -> None:
        """The corpus streams as ``chip_smoke.py`` makes them (q=50, index
        on), held to their pinned sha256; a rehearsal has another corpus
        and only reports them."""
        imgs = (self.images if self.rehearse
                else corpus.synthetic_corpus(49, 512))
        got = {}
        for precision, want in ((transform.EXACT, SHA256_EXACT),
                                (transform.FAST, SHA256_FAST)):
            streams = api.compress_batch(imgs, QUALITY, precision=precision,
                                         device=self.dev)
            got[precision] = hashlib.sha256(b"".join(streams)).hexdigest()
            if not self.rehearse and got[precision] != want:
                raise BenchError(f"{precision} corpus streams: sha256 "
                                 f"{got[precision]}, pinned {want}")
        self.notes["sha256"] = {**got, "pinned": not self.rehearse}

    def check_conformance(self) -> None:
        """``bench.py``'s conformance check as a bar: four exact streams of
        the batch entry point equal the oracle's bytes, and their PSNRs."""
        _, streams = bench_mode(self.images[:4], QUALITY, transform.EXACT,
                                "host", make_mesh(device=self.dev), 1)
        mism = [i for i, s in enumerate(streams)
                if s != container.compress(self.images[i], QUALITY)]
        if mism:
            raise BenchError(f"conformance: images {mism} differ from the "
                             "oracle's bytes")
        psnrs = [psnr(container.decompress(s), im)
                 for s, im in zip(streams, self.images[:4])]
        if not all(np.isfinite(p) for p in psnrs):
            raise BenchError(f"conformance: PSNRs {psnrs}")
        self.notes["conformance"] = {"byte_identical": 4, "psnr_db": psnrs}

    # -- the run ---------------------------------------------------------
    def mode_functions(self) -> dict:
        """The function of every name of :func:`mode_names`."""
        fns = {
            "cuda-fast/device": lambda: self.cuda_device(transform.FAST),
            "cuda-exact/device": lambda: self.cuda_device(transform.EXACT),
            "cuda-fast/staged-e2e": lambda: self.pipeline_e2e(True),
            "cuda-fast/host-e2e": lambda: self.pipeline_e2e(False),
            "api/staged-e2e": self.api_staged_e2e,
            "api/1image-e2e": self.api_1image_e2e,
            "cuda-fast/4k-device": self.cuda_4k_device,
            "batch-fast/device/staged": self.batch_fast_staged,
            "exact/host/e2e": self.exact_host_e2e,
            "decode/e2e": lambda: self.decode_e2e(False),
            "decode/e2e-indexed": lambda: self.decode_e2e(True),
            "decode/device-full": lambda: self.decode_device(
                "decode/device-full", self.streams(index=True), K_DECODE,
                "q50"),
            "decode/device-dense-q90": lambda: self.decode_device(
                "decode/device-dense-q90",
                self.streams(quality=90, index=True), K_DECODE, "q90"),
            "decode/device-custom-table": lambda: self.decode_device(
                "decode/device-custom-table", self.auto_table_stream(),
                K_DECODE, "auto"),
            "decode/entropy-host": self.entropy_host,
            "decode/device": self.transform_device,
            "decode/1stream-serial": self.one_stream_serial,
        }
        for nt in THREADS:
            fns[f"decode/1stream-indexed-{nt}t"] = (
                lambda nt=nt: self.one_stream_indexed(nt))
        return fns

    def run(self, name: str, fn) -> None:
        t0 = time.perf_counter()
        try:
            with _alarm(PHASE_SECONDS):
                samples = fn()
        except Exception:
            log(f"{name} FAILED:\n{traceback.format_exc()}")
            self.failed.append(name)
            return
        secs = time.perf_counter() - t0
        if samples is None:  # a check
            log(f"{name}: passed ({secs:.1f} s)")
            return
        self.modes[name] = summary([] if self.rehearse else samples)
        log(f"{name}: {self.modes[name]['median']} MP/s ({secs:.1f} s)")


def device_record(dev: torch.device) -> dict:
    """The card's name and power limit as ``nvidia-smi`` prints them, and
    the count of cards."""
    if dev.type != "cuda":
        return {"platform": "cpu", "rehearsal": True}
    lines = card_lines()
    name, _, limit = lines[dev.index].partition(", ")
    return {"platform": "gpu", "name": name, "power_limit": limit,
            "index": dev.index, "count": len(lines)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="the card to run on (default: the current one)")
    ap.add_argument("--rehearse", action="store_true",
                    help="every mode at a tiny size on the CPU; values null")
    args = ap.parse_args(argv)
    if args.rehearse:
        dev = torch.device("cpu")
    elif not torch.cuda.is_available():
        log("torch_bench: no CUDA device available (--rehearse runs on the "
            "CPU)")
        return 2
    else:
        dev = resolve_device(args.device)
    bench = Bench(dev, args.rehearse)
    log(f"corpus: {bench.images.shape} on {dev}")
    if dev.type == "cuda":
        bench.run("build", _build.build_all)
    bench.run("sha256", bench.check_sha256)
    fns = bench.mode_functions()
    for name in mode_names():
        bench.run(name, fns[name])
    bench.run("conformance", bench.check_conformance)
    headline = bench.modes.get("cuda-fast/device", {}).get("median")
    record = {
        "metric": "corpus_encode_throughput_per_chip",
        "value": headline,
        "unit": "MP/s",
        "device": device_record(dev),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "corpus": ("data/ (the reference images)"
                   if corpus.corpus_available() and not args.rehearse
                   else "synthetic_corpus"),
        "images": list(bench.images.shape),
        "quality": QUALITY,
        "modes": bench.modes,
        "failed": bench.failed,
        "notes": bench.notes,
    }
    print(json.dumps(record), flush=True)
    return 1 if bench.failed else 0


if __name__ == "__main__":
    sys.exit(main())
