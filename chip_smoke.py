#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the C host runtime (``tinyimgcodec_tpu_torch/native``, with
``cc``) and the eight CUDA kernels from ``tinyimgcodec_tpu_torch/csrc`` with
``nvcc``, holds each kernel against its plain PyTorch version on the card,
drives the port's main path -- the round trip: ``compress_batch`` of a 49 x
512 x 512 corpus (exact, fast, and fast through the v1 kernels), one
odd-shaped ``compress``, then ``decompress_batch`` / ``decompress`` of
those streams -- and the auto-table encode (``compress(...,
auto_generate_huffman_table=True)`` of every corpus image, a quality sweep
and a 4096x4096 image, and the decode of those streams) through the public
entry points, checks the bytes and the pixels against the float64 host
oracle, shows from the launch counters that each path went through the
kernels and from the engine's counters which decode leg took each image,
times the two host decode legs (C decoder), and times every kernel at the
corpus shapes beside its plain version and its bound.  Every kernel, each
redesigned for this card, is also held against its plain version at the
shapes that steer its paths
(odd block counts, ragged tiles, one huge image, thousands of one-block
images, streams denser than the staged window, corrupt chunk arrays,
blocks of a few bits, capacities that cut a block or dwarf the stream,
misaligned tensors), and ``encode2`` also on Huffman tables built at run
time, hand-made ones with 16-bit codes and ZRL prefixes of 32 and 48 bits
included, and with a DC predictor carried into each image's first block.

The ``parallel`` slice: one 7680x4320 image (past the 16 Mi pixels of one
kernel call, so encoded in two block ranges) through ``compress``,
``decompress`` and ``parallel.tiled.encode_tiled``, a 4096x4104 image with
auto tables, both against the oracle (phase ``tiled``); the tiled encode,
``compress_batch_sharded``, ``compress_batch`` with the index and
``decompress_batch_sharded`` in two gloo ranks on the one card and in NCCL
at a world of one, each rank a process of ``parallel.mesh.spawn`` (phase
``sharded``); ``compress_stream`` and
``decompress_stream`` over the corpus (phase ``stream``).  The same
entry points on a local mesh, two shards on ``cuda:0`` in this one
process, one thread a shard (phase ``local_mesh``: the 8K tiled encode,
the corpus through ``compress_batch`` and ``compress_batch_sharded``, its
decode through ``decompress_batch_sharded``, and a q=99 refusal on one
shard), each equal to the world of one's bytes and pixels, with its
launches counted by card; and on a local mesh in each process of a group,
two gloo ranks of two shards each, all on ``cuda:0`` (phase
``group_mesh``: the calls of ``sharded``, every process's launches
counted by card).

The conformance batteries of ``tinyimgcodec_tpu_torch/conformance.py``
(phase ``conformance``): adversarial content (noise, checkerboards, a
gradient, flat and saturated images, stripes) at q 1-95 at 128x128 and
512x512, the q=99 refusal, capacity budgets at a word's edge and at
``stitch``'s tail turns, small images, the device decode of that content
and auto-table streams, and a quality sweep of three corpus images at q
10-90, exact and fast, each against the oracle.

The engine's last two pieces: ``Engine.encode_to_words`` on the corpus
and the 7680x4320 image (phase ``encode_to_words``: the stitched words
are the oracle's payload in exact mode, the fast stream's in fast mode),
and the host-entropy leg on a batch, the 49 corpus streams without their
trailers, with the narrow upload the C decoder writes
(``engine.host_entropy_rows``; phase ``host_legs``: the oracle's pixels
in exact mode, the bytes uploaded, the leg's stages each timed alone).

The passes that ``torch_bench.py`` replays from CUDA graphs (phase
``bench``): the corpus encode fast and exact, the full decode of the
exact streams and the decode transform alone, each captured once and
replayed 10 times, each graph's output held equal to an eager pass's.

Output: one JSON object per phase, then the ``{"kernels": [...]}`` line,
the card's name and power limit as ``nvidia-smi`` prints them, and as the
last line ``{"ok": true, "device": {...}}``.  Any failed phase ends the
run with a non-zero exit code and no ``ok`` line.  Without a CUDA device
the script exits non-zero at once.

``--rehearse`` runs the same control flow at a tiny size on the CPU (plain
versions only) to find mistakes before a GPU is used; it never prints the
``ok`` line and always exits 1.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import signal
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate
# and the non-tensor-core float32 / float64 rates; integer work is counted
# at the float32 rate.
MEM_BYTES_PER_S = 3.35e12
FP32_PER_S = 67e12
FP64_PER_S = 34e12

REHEARSE = "--rehearse" in sys.argv[1:]
# run by this script under compute-sanitizer: only the corrupt-stream
# cases of the entropy decode check, then exit
SANITIZE_ONLY = "--sanitize-corrupt" in sys.argv[1:]


T_START = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One phase's line; ``at_s``: seconds since the script began."""
    at = round(time.perf_counter() - T_START, 1)
    print(json.dumps({"phase": phase, "at_s": at, **kw}), flush=True)


def fail(msg: str) -> None:
    print(json.dumps({"phase": "failed", "error": msg}), flush=True)
    sys.exit(1)


if not REHEARSE and not torch.cuda.is_available():
    print("chip_smoke: no CUDA device available", file=sys.stderr)
    sys.exit(2)

import tinyimgcodec_tpu_torch as codec  # noqa: E402
from tinyimgcodec_tpu_torch import (  # noqa: E402
    conformance, container, golden, huffman, native,
)
from tinyimgcodec_tpu_torch.conformance import (  # noqa: E402
    auto_table_route, ctas_past_window,
)
from tinyimgcodec_tpu_torch.corpus import (  # noqa: E402
    blocks_of_random_bits, seeded_image, synthetic_corpus,
)
from tinyimgcodec_tpu_torch.constants import (  # noqa: E402
    HEADER_BYTES, ZIGZAG_ORDER,
)
from tinyimgcodec_tpu_torch.device import card_info  # noqa: E402
from tinyimgcodec_tpu_torch.engine import (  # noqa: E402
    KERNEL_BLOCK_BITS, Engine,
)
from tinyimgcodec_tpu_torch.metrics import psnr  # noqa: E402
from tinyimgcodec_tpu_torch.ops import (  # noqa: E402
    _build, encode1, encode2, entropy_decode, exact_inverse, exact_transform,
    place, stitch, symbol_stats, transform,
)
from tinyimgcodec_tpu_torch import pipeline  # noqa: E402
from tinyimgcodec_tpu_torch.parallel import (  # noqa: E402
    batch as pbatch, make_mesh, spawn, stream as pstream, tiled,
)
from tinyimgcodec_tpu_torch.pipeline import (  # noqa: E402
    compress_batch_device, exact_coefficients,
)
from tinyimgcodec_tpu_torch.tables import (  # noqa: E402
    CodecTables, DecodeTables, dequant_steps, fast_decode_matrix,
)
import torch_bench  # noqa: E402

DEV = torch.device("cpu" if REHEARSE else "cuda")


def sync() -> None:
    if DEV.type == "cuda":
        torch.cuda.synchronize()


reset_counts = conformance.reset_launch_counts
counts = conformance.launch_counts


def time_ms(fn, reps: int) -> float:
    """Median over ``reps`` of one call's device time (CUDA events)."""
    if DEV.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# The profiler's device trace can lose a window's events (one run saw 1 of
# 20 decode launches and none of their zero fills): a loss shows as fewer
# launches of the wrapper's kernel than calls, and the window is profiled
# again, at most this many times in all.  More launches than calls, or too
# few in every window, fail the run.
PROFILE_TRIES = 3


def device_split(fn, reps: int, kernel: str) -> dict | None:
    """What one call of a wrapper launches on the card, read from
    ``torch.profiler`` over ``reps`` calls: for every kernel, memset and
    copy its launches a call and its mean device microseconds a call, and
    the windows profiled (``profiles``, see ``PROFILE_TRIES``).  Fails the
    run unless the wrapper's own ``kernel`` is among them with exactly one
    launch a call.  ``None`` on the CPU."""
    if DEV.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for tries in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        launches, micros = {}, {}
        for ev in prof.key_averages():
            dev_us = getattr(ev, "device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "cuda_time_total", 0.0)
            if (str(getattr(ev, "device_type", "")).endswith("CUDA")
                    and dev_us > 0):
                key = ev.key[:80]  # kernels sharing 80 characters add up
                launches[key] = launches.get(key, 0.0) + ev.count / reps
                micros[key] = micros.get(key, 0.0) + dev_us / reps
        own = sum(v for k, v in launches.items() if kernel in k)
        if own >= 1:
            break
    if own != 1:
        fail(f"profiler: {kernel} launched {own} times a call in window "
             f"{tries}; it saw {launches}")
    return {"launches_per_call": launches, "us_per_call": micros,
            "profiles": tries}


def blocks_of(images: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(images)).to(DEV)
    return transform.blockify(t).reshape(-1, 64).contiguous()


def eq(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and bool((a == b).all())


def max_abs_diff(*pairs) -> int:
    """Largest |a - b| over pairs of equally shaped integer or bool
    tensors: what a kernel's ``max_abs_err`` reports."""
    worst = 0
    for a, b in pairs:
        if a.shape != b.shape:
            fail(f"shapes differ: {tuple(a.shape)} and {tuple(b.shape)}")
        if a.numel():
            d = (a.to(torch.int64) - b.to(torch.int64)).abs().max()
            worst = max(worst, int(d))
    return worst


def decode_inputs(streams):
    """``prepare_batch`` of the streams and its arrays on the device:
    (prep, [words, chunk arrays...], tables), or None if not eligible."""
    return torch_bench.decode_inputs(streams, DEV)


# ---------------------------------------------------------------- phases


def phase_device() -> str:
    info = "cpu rehearsal" if REHEARSE else card_info()
    emit("device", card=info, torch=torch.__version__,
         cuda=torch.version.cuda,
         kind=None if REHEARSE else torch.cuda.get_device_name(0))
    return info


def phase_build() -> None:
    """The C host runtime (``native/``, with ``cc``) and the six CUDA
    kernels (``nvcc``, all started together).  A failed build fails the
    run."""
    t0 = time.perf_counter()
    native_path = native.library_path()
    native.lib()
    native_secs = time.perf_counter() - t0
    if REHEARSE:
        emit("build", native=os.path.basename(native_path),
             native_seconds=round(native_secs, 2))
        return
    t0 = time.perf_counter()
    _build.build_all()
    secs = time.perf_counter() - t0
    usage = {}
    for name, log in _build.build_log.items():
        lines = [ln.strip() for ln in log.splitlines()]
        usage[name] = {
            "registers": [int(m.group(1)) for ln in lines
                          if (m := re.search(r"Used (\d+) registers", ln))],
            # static shared memory; 0 where ptxas names none
            "static_shared_bytes": [
                int(m.group(1)) if (m := re.search(r"(\d+) bytes smem", ln))
                else 0 for ln in lines if "Used " in ln and "registers" in ln],
            "spilling": [ln for ln in lines if "spill stores" in ln
                         and not ln.startswith("0 bytes stack frame, "
                                               "0 bytes spill stores")],
        }
    emit("build", seconds=round(secs, 2), ptxas=usage,
         native=os.path.basename(native_path),
         native_seconds=round(native_secs, 2))


def tie_bar(zz_k: torch.Tensor, zz_p: torch.Tensor, blocks: torch.Tensor,
            tables: CodecTables) -> dict:
    """The float32 transform's bar: kernel and plain version may differ by
    one step on at most 1e-4 of the coefficients, each within 1e-3 of a
    half-integer before rounding (judged in float64); all else equal."""
    diff = (zz_k.to(torch.int64) - zz_p.to(torch.int64)).abs()
    nd = int((diff != 0).sum())
    worst = int(diff.max())
    y = blocks.to(torch.float64) @ tables.encode_matrix.to(torch.float64)
    y[:, 0] -= tables.dc_offset
    frac = (y - torch.floor(y) - 0.5).abs().T  # distance from a tie
    far = int(((diff != 0) & (frac > 1e-3)).sum())
    ok = worst <= 1 and far == 0 and nd <= 1e-4 * diff.numel()
    return {"ok": ok, "differing": nd, "of": diff.numel(), "max_step": worst,
            "not_near_tie": far}


def flag_limit(n: int) -> int:
    """Kernel/plain flag disagreements tolerated in n blocks: 0.01 % of
    them.  A product summed in another order moves a quotient by about
    1e-12, so a flag can differ only where a quotient lies that close to
    the edge of the 1e-9 tie window; every reading so far was 0."""
    return n // 10000


def oracle_zz(blocks: torch.Tensor, quality: int) -> np.ndarray:
    """(N, 64) uint8 blocks -> (N, 64) int32 zig-zag coefficients of the
    float64 oracle (``golden``: scipy's DCT, division, half to even)."""
    x = blocks.cpu().numpy().reshape(-1, 8, 8).astype(np.float64) - 128.0
    q = golden.quantize(golden.block_dct(x), quality)
    return q.reshape(-1, 64)[:, ZIGZAG_ORDER].astype(np.int32)


def exact_both(label: str, blocks: torch.Tensor, tables: CodecTables,
               quality: int) -> tuple:
    """The exact transform kernel against its plain version on the same
    blocks: both settle the blocks they flag in the oracle's own
    arithmetic, so their coefficients must equal the float64 oracle's in
    every block, and the two may disagree on at most :func:`flag_limit`
    flags (the tensor cores sum in another order; a kernel that flags too
    much fails here, not only in time), with counts equal to their flags'.
    Returns (the kernel's coefficients, counts)."""
    zz_k, fl_k, n_k = exact_transform.exact_transform(blocks, tables)
    zz_p, fl_p, n_p = exact_transform.exact_transform_plain(blocks, tables)
    sync()
    either = (fl_k != 0) | (fl_p != 0)
    flag_diff = int((fl_k != fl_p).sum())
    if flag_diff > flag_limit(blocks.shape[0]):
        fail(f"exact_transform[{label}]: {flag_diff} flags differ from the "
             f"plain version's, more than {flag_limit(blocks.shape[0])}")
    if int(n_k) != int((fl_k != 0).sum()) or int(n_p) != int(
            (fl_p != 0).sum()):
        fail(f"exact_transform[{label}]: a count differs from its flags")
    gold = oracle_zz(blocks, quality)
    if not (np.array_equal(zz_k.T.cpu().numpy(), gold)
            and np.array_equal(zz_p.T.cpu().numpy(), gold)):
        fail(f"exact_transform[{label}]: differs from the float64 oracle")
    return zz_k, {
        "coef_diff": int((zz_k != zz_p).sum()),
        "flag_diff": flag_diff,
        "flagged_either": int(either.sum()),
        "flagged_kernel": int((fl_k != 0).sum()),
        "max_abs_err": max_abs_diff((zz_k, zz_p)),
    }


def phase_kernel_check(corpus: np.ndarray) -> dict:
    """Each kernel against its plain version, same tensors on the card:
    at a moderate size on smooth and on dense content, and at the shapes
    the main path gives the kernels (the whole corpus).  Returns, per
    kernel, the largest |kernel - plain| measured over its outputs in all
    cases (for the float32 transform: the largest coefficient step)."""
    size = 32 if REHEARSE else 256
    rng = np.random.RandomState(7)
    smooth = synthetic_corpus(4, size)
    noise = rng.randint(0, 256, (4, size, size)).astype(np.uint8)
    errs = {"exact_transform": 0, "encode2": 0, "encode2_pixels": 0,
            "place": 0, "encode1": 0, "stitch": 0, "symbol_stats": 0}
    report = []
    for label, images, quality in (("smooth", smooth, 50),
                                   ("noise", noise, 90),
                                   ("corpus", corpus, 50)):
        nb = (images.shape[1] // 8) * (images.shape[2] // 8)
        tables = CodecTables.build(quality, DEV)
        blocks = blocks_of(images)
        n = blocks.shape[0]
        # -- exact_transform: the oracle's coefficients in every block -----
        zz_k, ex = exact_both(label, blocks, tables, quality)
        errs["exact_transform"] = max(errs["exact_transform"],
                                      ex["max_abs_err"])
        # -- encode2 from coefficients: rows, meta, overflow equal --------
        pk, mk, ok_ = encode2.encode2(zz_k, tables, nb, from_zz=True)
        pp, mp, op = encode2.encode2_plain(zz_k, tables, nb, from_zz=True)
        sync()
        errs["encode2"] = max(errs["encode2"],
                              max_abs_diff((pk, pp), (mk, mp)))
        if not (eq(pk, pp) and eq(mk, mp) and bool(ok_) == bool(op)):
            fail(f"encode2[{label}, from_zz]: kernel and plain version "
                 f"differ (rows {int((pk != pp).sum())}, meta "
                 f"{int((mk != mp).sum())}, overflow {bool(ok_)}/{bool(op)})")
        # -- encode2 from pixels: the tie bar on its coefficients, and
        #    equal words wherever the coefficients agree -------------------
        zzf_p = encode2.fast_coefficients_plain(blocks, tables)
        if DEV.type == "cuda":
            zzf_k = encode2.fast_coefficients(blocks, tables)
        else:
            zzf_k = zzf_p
        bar = tie_bar(zzf_k, zzf_p, blocks, tables)
        errs["encode2_pixels"] = max(errs["encode2_pixels"], bar["max_step"])
        if not bar["ok"]:
            fail(f"encode2[{label}, pixels]: tie bar not met: {bar}")
        pk2, mk2, ok2 = encode2.encode2(blocks, tables, nb)
        pp2, mp2, op2 = encode2.encode2_plain(zzf_k, tables, nb, from_zz=True)
        sync()
        if not (eq(pk2, pp2) and eq(mk2, mp2) and bool(ok2) == bool(op2)):
            fail(f"encode2[{label}, pixels]: words differ from the plain "
                 "entropy coding of the kernel's own coefficients")
        # -- place: stream, starts, total, overflow equal -----------------
        for cap in (-(-int(images.size * 4.0) // 32), n * 52,
                    max(1, int(mk[0, -1]) // 64)):
            sk = place.place(pk, mk, nb, cap)
            sp = place.place_plain(pk, mk, nb, cap)
            sync()
            errs["place"] = max(errs["place"], max_abs_diff(
                (sk[0], sp[0]), (sk[1], sp[1]), (sk[2], sp[2])))
            if not (eq(sk[0], sp[0]) and eq(sk[1], sp[1])
                    and int(sk[2]) == int(sp[2])
                    and bool(sk[3]) == bool(sp[3])):
                fail(f"place[{label}, cap={cap}]: kernel and plain differ")
        # -- encode1 from coefficients: words, bits, overflow equal -------
        zz_bm = zz_k.T.contiguous()  # block-major (N, 64)
        wk, bk, o1k = encode1.encode1(zz_bm, tables, nb, from_zz=True)
        wp, bp, o1p = encode1.encode1_plain(zz_bm, tables, nb, from_zz=True)
        sync()
        errs["encode1"] = max(errs["encode1"],
                              max_abs_diff((wk, wp), (bk, bp)))
        if not (eq(wk, wp) and eq(bk, bp) and bool(o1k) == bool(o1p)):
            fail(f"encode1[{label}, from_zz]: kernel and plain version "
                 f"differ (words {int((wk != wp).sum())}, bits "
                 f"{int((bk != bp).sum())})")
        # -- encode1 from pixels: the same transform kernel as encode2 (the
        #    tie bar above), then equal words to the plain entropy coding
        #    of those coefficients ------------------------------------------
        wk2, bk2, o2k = encode1.encode1(blocks, tables, nb)
        wp2, bp2, o2p = encode1.encode1_plain(zzf_k.T.contiguous(), tables,
                                              nb, from_zz=True)
        sync()
        errs["encode1"] = max(errs["encode1"],
                              max_abs_diff((wk2, wp2), (bk2, bp2)))
        if not (eq(wk2, wp2) and eq(bk2, bp2) and bool(o2k) == bool(o2p)):
            fail(f"encode1[{label}, pixels]: words differ from the plain "
                 "entropy coding of the transform kernel's coefficients")
        # -- stitch: roomy, exactly enough, one word short ----------------
        total_bits = int(mk[0, -1]) + int(mk[1, -1])
        exact_cap = -(-total_bits // 32)
        for cap, want_status in ((n * 52, 0), (exact_cap, 0),
                                 (exact_cap - 1, 2)):
            tk = stitch.stitch(wk, bk, nb, cap)
            tp = stitch.stitch_plain(wk, bk, nb, cap)
            sync()
            errs["stitch"] = max(errs["stitch"], max_abs_diff(
                *((tk[i], tp[i]) for i in range(4))))
            if not (eq(tk[0], tp[0]) and eq(tk[1], tp[1])
                    and int(tk[2]) == int(tp[2]) == total_bits
                    and int(tk[3]) == int(tp[3]) == want_status):
                fail(f"stitch[{label}, cap={cap}]: kernel and plain differ "
                     f"or status {int(tk[3])} != {want_status}")
        # the v1 stream is the v2 stream (same blocks, same offsets)
        s2 = place.place(pk, mk, nb, exact_cap)[0]
        if not eq(stitch.stitch(wk, bk, nb, exact_cap)[0], s2):
            fail(f"stitch[{label}]: stream differs from encode2 + place")
        # -- symbol_stats: every count and maximum equal, the batch's
        #    coefficients as one image and as its images' ranges ---------
        for ranges in ([zz_k], [zz_k[:, i:i + nb].contiguous()
                                for i in range(0, n, nb)]):
            hk = symbol_stats.stats_buffer(ranges)
            hp = symbol_stats.stats_buffer([r.cpu() for r in ranges])
            errs["symbol_stats"] = max(errs["symbol_stats"],
                                       max_abs_diff((hk.cpu(), hp)))
            if not eq(hk.cpu(), hp):
                fail(f"symbol_stats[{label}, {len(ranges)} ranges]: kernel "
                     "and plain version differ")
        report.append({
            "case": label, "shape": list(images.shape), "quality": quality,
            "blocks": n,
            "exact_coef_diff": ex["coef_diff"],
            "exact_flag_diff": ex["flag_diff"],
            "flagged": ex["flagged_either"],
            "flagged_kernel": ex["flagged_kernel"], "fast_tie_bar": bar,
            "total_bits": int(sk[2]),
        })
    emit("kernel_check", cases=report,
         tolerance={"exact_transform": "equal outside the blocks either "
                    "side flags (the tensor cores sum in another order); "
                    "flags differ in at most 0.01 % of blocks; equal to the "
                    "float64 oracle after the host recompute",
                    "encode2 from_zz": "equal", "place": "equal",
                    "encode1 from_zz": "equal", "symbol_stats": "equal",
                    "stitch": "equal, at a "
                    "roomy capacity, at the exact one and one word short "
                    "(status 2 only there); stream == encode2 + place",
                    "encode1 pixels": "equal to the plain entropy coding "
                    "of the shared transform kernel's coefficients",
                    "encode2 pixels": "|step| <= 1 on <= 1e-4 of "
                    "coefficients, each within 1e-3 of a tie"})
    return errs


def one_large_image(corpus: np.ndarray) -> np.ndarray:
    """(1, 4096, 4096): corpus images tiled up to the pipeline's pixel
    limit (64x64 in a rehearsal)."""
    side = 64 if REHEARSE else 4096
    reps = -(-side // corpus.shape[1])
    picks = corpus[np.arange(reps * reps) % corpus.shape[0]]
    big = picks.reshape(reps, reps, *corpus.shape[1:]).transpose(
        0, 2, 1, 3).reshape(reps * corpus.shape[1], -1)[None, :side, :side]
    return np.ascontiguousarray(big)


def worst_case_coefficients(rng, n: int) -> np.ndarray:
    """(64, n) int32: the longest legal block (63 coefficients of size 10
    with 16-bit codes, 1662 bits) alternating with short ones, so that it
    meets every bit phase."""
    zz = np.zeros((64, n), np.int32)
    zz[0] = np.where(np.arange(n) % 2 == 0, 1000, -1000)
    zz[1:] = rng.randint(512, 1024, (63, n)) * rng.choice([-1, 1], (63, n))
    zz[1:, 1::2] = 0
    zz[5, 1::2] = rng.randint(1, 8, n // 2)
    return zz


def encode2_both(label: str, zz: torch.Tensor, tables: CodecTables,
                 nb: int, dc_init: torch.Tensor | None = None) -> tuple:
    """``encode2`` from coefficients by the kernel and by the plain
    version: (the kernel's outputs, the largest |kernel - plain| over rows
    and meta).  Fails the run unless rows, meta and flag are equal."""
    a = encode2.encode2(zz, tables, nb, from_zz=True, dc_init=dc_init)
    b = encode2.encode2_plain(zz, tables, nb, from_zz=True, dc_init=dc_init)
    sync()
    if not (eq(a[0], b[0]) and eq(a[1], b[1]) and bool(a[2]) == bool(b[2])):
        fail(f"encode2[{label}]: kernel and plain version differ (rows "
             f"{int((a[0] != b[0]).sum())}, meta {int((a[1] != b[1]).sum())}, "
             f"overflow {bool(a[2])}/{bool(b[2])})")
    return a, max_abs_diff((a[0], b[0]), (a[1], b[1]))


def phase_encode2_shapes(corpus: np.ndarray) -> tuple[int, dict]:
    """``encode2`` against its plain version at the shapes that steer its
    copy paths and its scan: block counts that are no multiple of 4 or of
    the tile, a misaligned tensor, one 4096x4096 image (the longest
    look-back chain), thousands of one-block images, the longest legal
    block at every bit phase, both overflow flags, and repeated calls (the
    scan's state is reset by every call).  Returns the largest
    |kernel - plain| and the times of the one-image case."""
    rng = np.random.RandomState(23)
    worst = 0
    report = []

    def coefficients(images, quality):
        tables = CodecTables.build(quality, DEV)
        blocks = blocks_of(images)
        return tables, blocks, exact_transform.exact_transform(blocks,
                                                               tables)[0]

    def both_forms(label, images, quality):
        nonlocal worst
        tables, blocks, zz = coefficients(images, quality)
        nb = blocks.shape[0] // images.shape[0]
        _, err = encode2_both(label, zz, tables, nb)
        worst = max(worst, err)
        # pixel form: the plain coding of the transform kernel's own
        # coefficients (the tie bar on those is phase kernel_check's)
        zzf = encode2.fast_coefficients(blocks, tables)
        pk = encode2.encode2(blocks, tables, nb)
        pp = encode2.encode2_plain(zzf, tables, nb, from_zz=True)
        sync()
        if not (eq(pk[0], pp[0]) and eq(pk[1], pp[1])
                and bool(pk[2]) == bool(pp[2])):
            fail(f"encode2[{label}, pixels]: words differ from the plain "
                 "entropy coding of the kernel's own coefficients")
        report.append({"case": label, "blocks": int(blocks.shape[0]),
                       "nb": nb, "tiles": (blocks.shape[0] // nb)
                       * -(-nb // encode2.TILE)})
        return tables, blocks, zz, nb

    noise = lambda *shape: rng.randint(0, 256, shape).astype(np.uint8)
    # N = 135: no multiple of 4, an image is less than a tile
    both_forms("3 x 40x72, nb 45", noise(3, 40, 72), 90)
    # nb = 323: odd, two whole tiles and a ragged third; 4-byte copies
    both_forms("3 x 136x152, nb 323", noise(3, 136, 152), 90)
    # nb = 300: a ragged third tile, every row piece on 16 bytes
    tables, _, zz, nb = both_forms("3 x 120x160, nb 300",
                                   synthetic_corpus(3, 160)[:, :120], 50)
    # a DC predictor carried into every image's first block, both input
    # forms: 0 and +-1, values near +-2047, a difference of category 11,
    # and one that leaves the table (the flag must read alike)
    carried = []
    for label, images, quality in (
            ("3 x 136x152 noise", noise(3, 136, 152), 90),
            ("3 x 120x160", synthetic_corpus(3, 160)[:, :120], 50)):
        tables_c, blocks_c, zz_c = coefficients(images, quality)
        nb_c = blocks_c.shape[0] // 3
        zzf_c = encode2.fast_coefficients(blocks_c, tables_c)
        base = encode2.encode2(zz_c, tables_c, nb_c, from_zz=True)
        for form, coef in (("coefficients", zz_c), ("pixels", zzf_c)):
            first = coef[0, ::nb_c].to(torch.int64)
            sign = torch.where(first >= 0, 1, -1)
            for name, init in (
                    ("0, 1, -1", torch.tensor([0, 1, -1])),
                    ("2047, -2047, 2046", torch.tensor([2047, -2047, 2046])),
                    ("difference of category 11", first - 1500 * sign),
                    ("difference of 12 bits", first - 2100 * sign)):
                d = init.to(device=DEV, dtype=torch.int32)
                case = f"encode2[{label}, {form}, dc_init {name}]"
                if form == "coefficients":
                    (_, _, over), err = encode2_both(case, zz_c, tables_c,
                                                     nb_c, d)
                    worst = max(worst, err)
                else:
                    pk = encode2.encode2(blocks_c, tables_c, nb_c, dc_init=d)
                    pp = encode2.encode2_plain(zzf_c, tables_c, nb_c,
                                               from_zz=True, dc_init=d)
                    sync()
                    if not (eq(pk[0], pp[0]) and eq(pk[1], pp[1])
                            and bool(pk[2]) == bool(pp[2])):
                        fail(f"{case}: words differ from the plain coding "
                             "of the kernel's own coefficients")
                    over = pk[2]
                # near +-2047 the difference may pass 11 bits or not: the
                # two versions only have to agree
                want = {"difference of 12 bits": True,
                        "2047, -2047, 2046": None}.get(name, False)
                if want is not None and bool(over) != want:
                    fail(f"{case}: overflow flag {bool(over)}")
                carried.append({"case": f"{label}, {form}",
                                "dc_init": d.tolist(),
                                "overflow": bool(over)})
        zero = encode2.encode2(zz_c, tables_c, nb_c, from_zz=True,
                               dc_init=torch.zeros(3, dtype=torch.int32,
                                                   device=DEV))
        if not (eq(zero[0], base[0]) and eq(zero[1], base[1])):
            fail(f"encode2[{label}]: dc_init of zeros differs from none")
    report.append({"case": "carried DC predictor", "checked": carried})
    # the same coefficients one word off 16-byte alignment
    buf = torch.empty(zz.numel() + 1, dtype=torch.int32, device=DEV)
    shifted = buf[1:].view(zz.shape)
    shifted.copy_(zz)
    if DEV.type == "cuda" and shifted.data_ptr() % 16 == 0:
        fail("the misaligned view is aligned")
    _, err = encode2_both("nb 300, misaligned tensor", shifted, tables, nb)
    worst = max(worst, err)
    report.append({"case": "nb 300, tensor 4 bytes off 16-byte alignment"})
    # thousands of images of one block: every tile starts an image
    both_forms("4096 x 8x8, nb 1",
               noise(64 if REHEARSE else 4096, 8, 8), 75)
    # one image at the pipeline's pixel limit: 2048 tiles in one chain
    big = one_large_image(corpus)
    tables, blocks, zz, nb = both_forms(
        f"1 x {big.shape[1]}x{big.shape[2]}", big, 50)
    first = encode2.encode2(zz, tables, nb, from_zz=True)
    for _ in range(20):  # the same answer every time
        again = encode2.encode2(zz, tables, nb, from_zz=True)
        if not (eq(again[0], first[0]) and eq(again[1], first[1])):
            fail("encode2: repeated calls on one input differ")
    reps_t = 1 if REHEARSE else 20
    one_image = {
        "blocks": int(blocks.shape[0]),
        "from_zz_ms": time_ms(
            lambda: encode2.encode2(zz, tables, nb, from_zz=True), reps_t),
        "pixels_ms": time_ms(
            lambda: encode2.encode2(blocks, tables, nb), reps_t),
        "from_zz_bound_ms": blocks.shape[0] * (256 + 232)
        / MEM_BYTES_PER_S * 1e3,
        "pixels_bound_ms": blocks.shape[0] * (2 * 64 * 64 + 64 * 8)
        / FP32_PER_S * 1e3,
    }
    # the longest legal block (63 coefficients of size 10 with 16-bit
    # codes, 1662 bits) between short ones, so that it meets every phase
    tables = CodecTables.build(50, DEV)
    n = 512
    worst_zz = worst_case_coefficients(rng, n)
    (_, meta, over), err = encode2_both(
        "worst-case blocks", torch.from_numpy(worst_zz).to(DEV), tables, 64)
    worst = max(worst, err)
    if int(meta[1].max()) < 1600 or bool(over):
        fail("encode2[worst-case blocks]: not the longest legal block")
    phases = int(torch.unique(meta[0, ::2] & 31).numel())
    report.append({"case": "worst-case blocks", "max_bits":
                   int(meta[1].max()), "bit_phases_met": phases})
    # the two table-range flags
    for label, row, value in (("DC difference of 12 bits", 0, 2048),
                              ("AC coefficient of 11 bits", 7, 1024),
                              ("AC coefficient of 11 bits, last", 63, -1024)):
        flagged = worst_zz.copy()
        flagged[1:] = 0
        flagged[0] = 0
        flagged[row, 70] = value
        (_, _, over), err = encode2_both(
            label, torch.from_numpy(flagged).to(DEV), tables, 64)
        if not bool(over):
            fail(f"encode2[{label}]: overflow flag not raised")
        report.append({"case": label, "overflow": True})
    emit("encode2_shapes", cases=report, one_image=one_image,
         tolerance="rows, meta and flag equal to the plain version; pixel "
         "form equal to the plain coding of the transform kernel's "
         "coefficients; 20 repeated calls identical")
    return worst, one_image


def handmade_rows(image_bits: list, seed: int) -> tuple:
    """Blocks of the given bit lengths filled with random bits, as the
    encode kernel would hand them to ``place``: (packed, meta, nb) on the
    device."""
    packed, meta, nb, _ = blocks_of_random_bits(image_bits, seed)
    return (torch.from_numpy(packed.view(np.int32)).to(DEV),
            torch.from_numpy(meta).to(DEV), nb)


def phase_place_shapes(corpus: np.ndarray) -> tuple[int, dict]:
    """``place`` against its plain version at the shapes that steer the
    gather: spans that end inside and on image boundaries, thousands of
    one-block images (pad bits everywhere), the longest legal block at
    every bit phase, hand-made blocks of 6 and of 2 bits (6 and 16 a
    word), pads that share a word with both neighbours, one block, one
    4096x4096 image; each at the exact capacity, one word short, half, the
    pipeline's retry capacity and ten times the stream, into a buffer full
    of ones, twice.  Returns the largest |kernel - plain| and the times at
    the retry capacity and on the one image."""
    rng = np.random.RandomState(29)
    worst = 0
    report = []

    def check(label, packed, meta, nb, more_caps=()):
        nonlocal worst
        n = packed.shape[0]
        total = int(meta[0, -1]) + int(meta[1, -1])
        fits = -(-total // 32)
        caps = sorted({fits, max(fits - 1, 1), max(fits // 2, 1), n * 52,
                       10 * fits, *more_caps})
        for cap in caps:
            k = place.place(packed, meta, nb, cap)
            p = place.place_plain(packed, meta, nb, cap)
            sync()
            worst = max(worst, max_abs_diff(*((k[i], p[i]) for i in range(4))))
            if not (all(eq(k[i], p[i]) for i in range(3))
                    and bool(k[3]) == bool(p[3]) == (cap < fits)
                    and k[2].dtype == p[2].dtype and k[3].dtype == p[3].dtype
                    and k[2].shape == p[2].shape == k[3].shape == ()):
                fail(f"place[{label}, cap={cap}]: kernel and plain version "
                     f"differ (stream {int((k[0] != p[0]).sum())} words, "
                     f"total {int(k[2])}/{int(p[2])}, overflow "
                     f"{bool(k[3])}/{bool(p[3])})")
            if DEV.type == "cuda":
                # every word is stored, whatever the buffer held; and again
                buf = torch.full((cap,), -1, dtype=torch.int32, device=DEV)
                for _ in range(2):
                    place.launch_kernel(packed, meta, buf)
                    if not eq(buf, p[0]):
                        fail(f"place[{label}, cap={cap}]: a word of the "
                             "buffer was left as it was")
        report.append({"case": label, "blocks": n, "nb": nb,
                       "total_bits": total, "capacities": caps})

    def encoded(images, quality):
        tables = CodecTables.build(quality, DEV)
        blocks = blocks_of(images)
        nb = blocks.shape[0] // images.shape[0]
        zz = exact_transform.exact_transform(blocks, tables)[0]
        packed, meta, _ = encode2.encode2(zz, tables, nb, from_zz=True)
        return packed, meta, nb

    noise = lambda *shape: rng.randint(0, 256, shape).astype(np.uint8)
    check("3 x 40x72, nb 45", *encoded(noise(3, 40, 72), 90))
    check("3 x 136x152, nb 323", *encoded(noise(3, 136, 152), 90))
    check("4 x 128x128, nb 256: spans end on image boundaries",
          *encoded(synthetic_corpus(4, 128), 50),
          more_caps=(4 * 128 * 128 * 4 // 32,))
    check("4096 x 8x8, nb 1", *encoded(noise(64 if REHEARSE else 4096, 8, 8),
                                       75))
    tables = CodecTables.build(50, DEV)
    packed, meta, _ = encode2.encode2(
        torch.from_numpy(worst_case_coefficients(rng, 512)).to(DEV), tables,
        64, from_zz=True)
    longest = meta[1] == 1662
    phases = torch.unique(meta[0][longest] & 31).tolist()
    if not {0, 31} <= set(phases):
        fail(f"place[worst-case blocks]: phases met {phases}")
    check("worst-case blocks", packed, meta, 64)
    for label, image_bits in (
        ("6-bit blocks, six a word", [[6] * 600] * 3),
        ("2-bit blocks, sixteen a word", [[2] * 700] * 2),
        ("1662 bits at phases 0 and 31", [[1662, 6, 27, 1662, 6, 6, 6, 9]] * 2),
        ("pads share words", [[6, 6, 5, 2], [6, 3, 7, 1], [2, 2, 2, 3]]),
        ("one block", [[13]]),
    ):
        check(label, *handmade_rows(image_bits, len(label)))
    # one image at the pipeline's pixel limit: the longest blocks between
    # short ones take the bit offsets towards 2**28; the tiled corpus
    # image is the one timed
    nb = 64 if REHEARSE else 512 * 512
    packed, meta, _ = encode2.encode2(
        torch.from_numpy(worst_case_coefficients(rng, nb)).to(DEV), tables,
        nb, from_zz=True)
    if not REHEARSE and int(meta[0, -1]) < 1 << 27:
        fail("place[one image of worst-case blocks]: offsets stay below "
             "2**27 bits")
    check("1 x 4096x4096 of worst-case blocks", packed, meta, nb)
    del packed, meta
    big = one_large_image(corpus)
    packed, meta, nb = encoded(big, 50)
    cap = -(-int(big.size * 4.0) // 32)
    check("1 x 4096x4096", packed, meta, nb, more_caps=(cap,))
    reps = 1 if REHEARSE else 20
    owned = int((((meta[0] & 31) + meta[1] + 31) >> 5).sum())
    nbytes = owned * 4 + nb * 8 + cap * 4
    times = {"one_image_4096x4096": {
        "blocks": nb, "capacity_words": cap,
        "ms": time_ms(lambda: place.place(packed, meta, nb, cap), reps),
        "bound_ms": nbytes / MEM_BYTES_PER_S * 1e3}}
    emit("place_shapes", cases=report,
         tolerance="stream, image starts, total and flag equal to the plain "
         "version, dtypes and shapes too; every word of a buffer full of "
         "ones rewritten; two launches identical")
    return worst, times


def phase_encode1_shapes(corpus: np.ndarray) -> tuple[int, dict]:
    """``encode1`` against its plain version at the shapes that steer its
    tile: block counts of 1 and around the tile of 128, images of 1, 43,
    45, 300 and 323 blocks (predictor resets inside a tile, several a
    tile), a coefficient tensor off 16-byte alignment, the 1662-bit block
    beside 6-bit ones, both overflow flags, one 4096x4096 image, repeated
    calls.  Coefficient form: equal bit for bit.  Pixel form: equal to the
    plain coding of the transform kernel's own coefficients.  Returns the
    largest |kernel - plain| and the times of the one-image case."""
    rng = np.random.RandomState(31)
    worst = 0
    report = []

    def from_zz(label, zz_bm, tables, nb):
        nonlocal worst
        k = encode1.encode1(zz_bm, tables, nb, from_zz=True)
        p = encode1.encode1_plain(zz_bm, tables, nb, from_zz=True)
        sync()
        worst = max(worst, max_abs_diff((k[0], p[0]), (k[1], p[1])))
        if not (eq(k[0], p[0]) and eq(k[1], p[1]) and bool(k[2]) == bool(p[2])
                and k[2].dtype == p[2].dtype and k[2].shape == ()):
            fail(f"encode1[{label}, from_zz]: kernel and plain version "
                 f"differ (words {int((k[0] != p[0]).sum())}, bits "
                 f"{int((k[1] != p[1]).sum())}, overflow "
                 f"{bool(k[2])}/{bool(p[2])})")
        return k

    def both_forms(label, images, quality):
        nonlocal worst
        tables = CodecTables.build(quality, DEV)
        blocks = blocks_of(images)
        n = blocks.shape[0]
        nb = n // images.shape[0]
        zz_bm = exact_transform.exact_transform(blocks, tables)[0].T.contiguous()
        first = from_zz(label, zz_bm, tables, nb)
        # one word off 16-byte alignment: the 4-byte loads, same words
        buf = torch.empty(zz_bm.numel() + 1, dtype=torch.int32, device=DEV)
        shifted = buf[1:].view(zz_bm.shape)
        shifted.copy_(zz_bm)
        if DEV.type == "cuda" and shifted.data_ptr() % 16 == 0:
            fail("the misaligned view is aligned")
        again = from_zz(label + ", misaligned", shifted, tables, nb)
        if not (eq(again[0], first[0]) and eq(again[1], first[1])):
            fail(f"encode1[{label}]: the two load paths differ")
        zzf = encode2.fast_coefficients(blocks, tables).T.contiguous()
        k = encode1.encode1(blocks, tables, nb)
        p = encode1.encode1_plain(zzf, tables, nb, from_zz=True)
        sync()
        worst = max(worst, max_abs_diff((k[0], p[0]), (k[1], p[1])))
        if not (eq(k[0], p[0]) and eq(k[1], p[1]) and bool(k[2]) == bool(p[2])):
            fail(f"encode1[{label}, pixels]: words differ from the plain "
                 "entropy coding of the transform kernel's coefficients")
        report.append({"case": label, "blocks": n, "nb": nb,
                       "tiles": -(-n // 128)})
        return tables, blocks, zz_bm, nb

    noise = lambda *shape: rng.randint(0, 256, shape).astype(np.uint8)
    both_forms("1 x 8x8: one block", noise(1, 8, 8), 90)
    both_forms("1 x 8x1016, nb 127", noise(1, 8, 1016), 90)
    both_forms("127 x 8x8, nb 1", noise(127, 8, 8), 75)
    both_forms("3 x 8x344, nb 43: N 129", noise(3, 8, 344), 90)
    both_forms("3 x 40x72, nb 45", noise(3, 40, 72), 90)
    both_forms("1 x 120x160, nb 300", synthetic_corpus(1, 160)[:, :120], 50)
    both_forms("300 x 8x8, nb 1", noise(300, 8, 8), 50)
    both_forms("3 x 136x152, nb 323", noise(3, 136, 152), 90)
    both_forms("4096 x 8x8, nb 1", noise(64 if REHEARSE else 4096, 8, 8), 75)
    tables, blocks, zz_bm, nb = both_forms("1 x 4096x4096",
                                           one_large_image(corpus), 50)
    first = encode1.encode1(blocks, tables, nb)
    for _ in range(5):  # the same answer every time
        again = encode1.encode1(blocks, tables, nb)
        if not (eq(again[0], first[0]) and eq(again[1], first[1])):
            fail("encode1: repeated calls on one input differ")
    reps_t = 1 if REHEARSE else 20
    n = blocks.shape[0]
    one_image = {
        "blocks": n,
        "pixels_ms": time_ms(lambda: encode1.encode1(blocks, tables, nb),
                             reps_t),
        "from_zz_ms": time_ms(
            lambda: encode1.encode1(zz_bm, tables, nb, from_zz=True), reps_t),
        "pixels_bound_ms": n * (2 * 64 * 64 + 64 * 8) / FP32_PER_S * 1e3,
        "from_zz_bound_ms": n * (256 + 212) / MEM_BYTES_PER_S * 1e3,
    }
    del blocks, zz_bm, first, again
    # the 1662-bit block (52 full words) next to 6-bit ones, ragged tiles
    tables = CodecTables.build(50, DEV)
    for n, nb in ((512, 64), (129, 43), (135, 45)):
        zz = worst_case_coefficients(rng, n + n % 2)[:, :n]
        zz[1:, 1::2] = 0
        # long blocks' DCs alternate (a difference of 11 bits); a short
        # block repeats its neighbour's: difference 0, no AC, 6 bits
        zz[0, 0::2] = np.where(np.arange(zz[0, 0::2].size) % 2 == 0, 1000,
                               -1000)
        zz[0, 1::2] = zz[0, 0::2][: n // 2]
        _, bits, over = from_zz(
            f"worst-case blocks, N {n}",
            torch.from_numpy(np.ascontiguousarray(zz.T)).to(DEV), tables, nb)
        if int(bits.max()) != 1662 or int(bits.min()) != 6 or bool(over):
            fail(f"encode1[worst-case blocks, N {n}]: bits "
                 f"{int(bits.min())}..{int(bits.max())}")
        report.append({"case": f"worst-case blocks, N {n}, nb {nb}",
                       "max_bits": int(bits.max()),
                       "min_bits": int(bits.min())})
    for label, col, value in (("DC difference of 12 bits", 0, 2048),
                              ("AC coefficient of 11 bits", 7, 1024),
                              ("AC coefficient of 11 bits, last", 63, -1024)):
        flagged = np.zeros((300, 64), np.int32)
        flagged[270, col] = value
        if not bool(from_zz(label, torch.from_numpy(flagged).to(DEV), tables,
                            100)[2]):
            fail(f"encode1[{label}]: overflow flag not raised")
        report.append({"case": label, "overflow": True})
    emit("encode1_shapes", cases=report, one_image=one_image,
         tolerance="words, bits and flag equal to the plain version, aligned "
         "and misaligned; pixel form equal to the plain coding of the "
         "transform kernel's coefficients; 5 repeated calls identical")
    return worst, one_image


def phase_exact_shapes(corpus: np.ndarray) -> int:
    """``exact_transform`` against its plain version at the shapes that
    steer its tile and its copies: one block, block counts that are no
    multiple of the tile (and of 4: 4-byte stores), pixels 4 bytes past a
    16-byte boundary (4-byte loads), dense noise at q = 90 and the corpus;
    each under the bar of :func:`exact_both`.  Returns the largest
    |kernel - plain|."""
    rng = np.random.RandomState(37)
    worst = 0
    report = []

    def check(label, images, quality, skew=None):
        nonlocal worst
        tables = CodecTables.build(quality, DEV)
        blocks = blocks_of(images)
        if skew is not None:  # the same pixels at another address
            buf = torch.empty(blocks.numel() + 16, dtype=torch.uint8,
                              device=DEV)
            at = (skew - buf.data_ptr()) % 16
            view = buf[at:at + blocks.numel()].view(blocks.shape)
            view.copy_(blocks)
            if not view.is_contiguous() or view.data_ptr() % 16 != skew:
                fail(f"exact_transform[{label}]: the view is not {skew} "
                     "bytes past a 16-byte boundary")
            blocks = view
        _, ex = exact_both(label, blocks, tables, quality)
        worst = max(worst, ex["max_abs_err"])
        report.append({"case": label, "blocks": int(blocks.shape[0]),
                       "quality": quality, **ex})

    noise = lambda *shape: rng.randint(0, 256, shape).astype(np.uint8)
    check("1 x 8x8: one block", noise(1, 8, 8), 50)
    check("3 x 40x72: N 135, a ragged tile, 4-byte stores", noise(3, 40, 72),
          90)
    check("1 x 8x1032: N 129, one block in the second tile",
          noise(1, 8, 1032), 90)
    dense = noise(4, 256, 256)
    check("4 x 256x256 noise, q 90", dense, 90)
    check("4 x 256x256 noise, q 90, pixels 4 bytes past 16", dense, 90, 4)
    check("corpus, pixels 4 bytes past 16", corpus, 50, 4)
    emit("exact_shapes", cases=report,
         tolerance="coefficients equal to the plain version's in every block "
         "neither flags; flags differ in at most 0.01 % of blocks; equal to "
         "the float64 oracle after the flagged blocks are recomputed")
    return worst


def phase_stitch_shapes(corpus: np.ndarray) -> int:
    """``stitch`` against its plain version at the shapes that steer its
    scan and its gather: thousands of one-block images (every block starts
    an image), N no multiple of the span, image starts inside spans and
    words shared across span boundaries, one 4096x4096 image (the longest
    look-back chain), hand-made rows of 6 and of 2 bits (6 and 16 a word),
    full rows at bit phases 0 and 31, pads that share words; each at the
    pipeline's retry capacity, the exact capacity, one word short (status 2
    only there) and ten times the stream, and into a buffer full of ones
    through ``launch_kernels``, twice.  The stream must also equal
    ``encode2`` + ``place``'s (and, for the hand-made rows, the bits laid
    end to end).  Returns the largest |kernel - plain|."""
    rng = np.random.RandomState(41)
    worst = 0
    report = []

    def check(label, words, bits, nb, v2, stream_bits=None):
        nonlocal worst
        n = words.shape[0]
        total = int(stitch.stitch_plain(words, bits, nb, n * 52)[2])
        fits = -(-total // 32)
        caps = sorted({n * 52, fits, max(fits - 1, 1), 10 * fits})
        for cap in caps:
            k = stitch.stitch(words, bits, nb, cap)
            p = stitch.stitch_plain(words, bits, nb, cap)
            sync()
            worst = max(worst, max_abs_diff(*((k[i], p[i]) for i in range(4))))
            if not (all(eq(k[i], p[i]) for i in range(4))
                    and [(x.dtype, x.shape) for x in k]
                    == [(x.dtype, x.shape) for x in p]
                    and int(k[3]) == (2 if cap < fits else 0)):
                fail(f"stitch[{label}, cap={cap}]: kernel and plain version "
                     f"differ (stream {int((k[0] != p[0]).sum())} words, "
                     f"total {int(k[2])}/{int(p[2])}, status "
                     f"{int(k[3])}/{int(p[3])})")
            if DEV.type == "cuda":
                # every word is stored, whatever the buffer held; and again
                buf = torch.full((cap,), -1, dtype=torch.int32, device=DEV)
                for _ in range(2):
                    stitch.launch_kernels(words, bits, nb, buf)
                    if not eq(buf, p[0]):
                        fail(f"stitch[{label}, cap={cap}]: a word of the "
                             "buffer was left as it was")
        stream = stitch.stitch(words, bits, nb, fits)[0]
        if not eq(stream, place.place(*v2, nb, fits)[0]):
            fail(f"stitch[{label}]: stream differs from encode2 + place")
        if stream_bits is not None:
            padded = np.zeros(fits * 32, np.uint8)
            padded[:len(stream_bits)] = stream_bits
            want = np.packbits(padded).view(">u4").astype(np.uint32).view(
                np.int32)
            if not np.array_equal(stream.cpu().numpy(), want):
                fail(f"stitch[{label}]: stream differs from the bits laid "
                     "end to end")
        off = encode2.image_offsets(bits.to(torch.int64), nb)[0]
        span_first = off[::stitch.SPAN]
        report.append({
            "case": label, "blocks": n, "nb": nb, "total_bits": total,
            "capacities": caps, "spans": int(span_first.numel()),
            "span_boundaries_inside_a_word":
                int(((span_first[1:] & 31) != 0).sum()),
            "image_starts_inside_a_span":
                int(((torch.arange(0, n, nb) % stitch.SPAN) != 0).sum()),
        })

    def encoded(images, quality):
        tables = CodecTables.build(quality, DEV)
        blocks = blocks_of(images)
        nb = blocks.shape[0] // images.shape[0]
        words, bits, _ = encode1.encode1(blocks, tables, nb)
        packed, meta, _ = encode2.encode2(blocks, tables, nb)
        return words, bits, nb, (packed, meta)

    noise = lambda *shape: rng.randint(0, 256, shape).astype(np.uint8)
    check("4096 x 8x8, nb 1", *encoded(noise(64 if REHEARSE else 4096, 8, 8),
                                       75))
    check("3 x 40x72, nb 45: N 135, one ragged span",
          *encoded(noise(3, 40, 72), 90))
    check("3 x 136x152, nb 323: N 969, image starts inside spans",
          *encoded(noise(3, 136, 152), 90))
    if (report[-1]["span_boundaries_inside_a_word"] < 1
            or report[-1]["image_starts_inside_a_span"] < 1):
        fail(f"stitch[N 969]: the shape steers no path: {report[-1]}")
    big = one_large_image(corpus)
    check(f"1 x {big.shape[1]}x{big.shape[2]}", *encoded(big, 50))
    for label, image_bits in (
        ("6-bit blocks, six a word", [[6] * 600] * 3),
        ("2-bit blocks, sixteen a word", [[2] * 700] * 2),
        ("full rows at phases 0 and 31", [[1662, 6, 27, 1664, 6, 6, 6, 9]] * 2),
        ("pads share words", [[6, 6, 5, 2], [6, 3, 7, 1], [2, 2, 2, 3]]),
        ("nb 1, blocks of 2 to 299 bits", [[b] for b in range(2, 300)]),
        ("one block", [[13]]),
    ):
        seed = len(label)
        rows, meta, nb, stream_bits = blocks_of_random_bits(image_bits, seed,
                                                            from_bit0=True)
        packed, meta2, _ = handmade_rows(image_bits, seed)
        check(label, torch.from_numpy(rows.view(np.int32)).to(DEV),
              torch.from_numpy(meta[1]).to(DEV), nb, (packed, meta2),
              stream_bits)
    emit("stitch_shapes", cases=report,
         tolerance="stream, image starts, total and status equal to the plain "
         "version, dtypes and shapes too, status 2 only below the exact "
         "capacity; every word of a buffer full of ones rewritten, twice; "
         "stream == encode2 + place (and the bits laid end to end)")
    return worst


def decode_both(label: str, args, nb_total: int, tables):
    """The entropy decode kernel and its plain version on the same
    tensors: (ok as numpy, the kernel's zz, the largest |kernel - plain|
    over zz and ok).  Fails the run unless both are equal bit for bit."""
    zk, ok_k = entropy_decode.entropy_decode_chunks(*args, nb_total, tables)
    zp, ok_p = entropy_decode.entropy_decode_chunks_plain(
        *args, nb_total, tables)
    sync()
    err = max_abs_diff((zk, zp), (ok_k, ok_p))
    if not (eq(zk, zp) and eq(ok_k, ok_p)):
        fail(f"entropy_decode[{label}]: kernel and plain version differ "
             f"(zz {int((zk != zp).sum())}, ok {int((ok_k != ok_p).sum())}, "
             f"max |difference| {err})")
    return ok_k.cpu().numpy(), zk, err


def kernel_vs_plain_decode(label: str, streams) -> tuple:
    """:func:`decode_both` on the streams' own arrays: (prep, ok, the
    kernel's zz, the largest |kernel - plain|)."""
    got = decode_inputs(streams)
    if got is None:
        fail(f"entropy_decode[{label}]: prepare_batch refused the batch")
    prep, args, tables = got
    ok, zk, err = decode_both(label, args, prep["nb_total"], tables)
    return prep, ok, zk, err


def table_with_16_bit_codes(symbols) -> tuple:
    """A canonical table with one code of every length 1..16 ('0', '10',
    ... , fifteen ones and a zero) for the 16 ``symbols``; sixteen ones
    match no code."""
    mincode = np.zeros(17, np.int32)
    maxcode = np.full(17, -1, np.int32)
    valptr = np.zeros(17, np.int32)
    code = 0
    for l in range(1, 17):
        valptr[l] = l - 1
        mincode[l] = maxcode[l] = code
        code = (code + 1) << 1
    return mincode, maxcode, valptr, np.asarray(symbols, np.int32)


def check_decode_arrays(small: list[bytes]) -> dict:
    """The decode kernel against its plain version on inputs no stream
    gives: launch shapes with a tiny or no staged window, a table whose
    codes run to 16 bits (and DC symbols past 15) on random words, chunk
    starts that are negative or far off, and chunk arrays with a gap."""
    worst = 0
    ran = []
    prep, args, tables = decode_inputs(small)
    nb_total = prep["nb_total"]
    zp, ok_p = entropy_decode.entropy_decode_chunks_plain(
        *args, nb_total, tables)
    if DEV.type == "cuda":
        for shape in ((4, 4, 64), (4, 4, 0), (32, 2, 64), (1, 8, 8)):
            zk = torch.zeros((nb_total, 64), dtype=torch.int32, device=DEV)
            ok_k = torch.empty(ok_p.shape, dtype=torch.bool, device=DEV)
            entropy_decode.launch_kernel(args[0], args[1:], tables, zk, ok_k,
                                         shape)
            sync()
            worst = max(worst, max_abs_diff((zk, zp), (ok_k, ok_p)))
            if not (eq(zk, zp) and eq(ok_k, ok_p) and bool(ok_k.all())):
                fail(f"entropy_decode[launch shape {shape}]: differs from "
                     "the plain version")
            ran.append(f"shape {shape}")
    # a table with codes of every length up to 16, on random words
    rng = np.random.RandomState(16)
    words = rng.randint(0, 1 << 32, 4096, dtype=np.int64).astype(np.uint32)
    words[100:110] = 0xFFFFFFFF  # sixteen ones: no code
    dc16 = table_with_16_bit_codes(
        [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 15, 20, 200])
    ac16 = table_with_16_bit_codes(
        [0x01, 0x02, 0x11, 0x00, 0x03, 0x21, 0xF0, 0x12, 0x04, 0x31, 0x05,
         0x41, 0x13, 0x22, 0x0A, 0x7A])
    t16 = DecodeTables.from_numpy(dc16, ac16, fast_decode_matrix(50),
                                  dequant_steps(50), device=DEV)
    n = 64
    starts = np.arange(n, dtype=np.int64) * 2000
    starts[1] = 100 * 32
    arrays = [starts, np.full(n, 4), np.arange(n) * 4, np.zeros(n),
              np.full(n, 2 ** 31 - 1)]
    a16 = [torch.from_numpy(words.view(np.int32)).to(DEV)] + [
        torch.from_numpy(a.astype(np.int32)).to(DEV) for a in arrays]
    ok, _, err = decode_both("16-bit codes", a16, 4 * n, t16)
    worst = max(worst, err)
    if ok[1]:
        fail("entropy_decode[16-bit codes]: sixteen 1-bits matched a code")
    ran.append(f"16-bit codes ({int(ok.sum())}/{n} chunks ok)")
    # chunk starts that point nowhere
    bad = [a.clone() for a in args]
    bad[1][3] = -7
    bad[1][5] = 2 ** 31 - 64
    ok, _, err = decode_both("start outside", bad, nb_total, tables)
    worst = max(worst, err)
    if ok[3] or ok[5] or not np.delete(ok, [3, 5]).all():
        fail(f"entropy_decode[start outside]: ok = {ok.tolist()}")
    ran.append("negative and far-off chunk_start")
    # chunk arrays with a gap and a chunk that runs out of zz
    keep = [k for k in range(args[1].shape[0]) if k not in (2, 7)]
    gap = [args[0]] + [a[keep].clone() for a in args[1:]]
    gap[3][-1] = nb_total - 1  # its second block lies outside zz
    ok, _, err = decode_both("gap", gap, nb_total, tables)
    worst = max(worst, err)
    if ok[-1] or not ok[:-1].all():
        fail(f"entropy_decode[gap]: ok = {ok.tolist()}")
    ran.append("chunk arrays with a gap")
    return {"cases": ran, "max_abs_err": worst}


def corrupt_cases(base: list[bytes], nb: int) -> list:
    """Corrupted variants of ``base[0]`` (a TICX stream of ``nb`` blocks
    with several chunks), each with the set of chunks that must fail and
    the set that may: [(label, streams, must_fail, may_fail)]."""
    good = base[0]
    off, _, pay_end = container.parse_block_index(good, nb)
    n_chunks = len(off)
    out = []
    # a flipped payload byte: its chunk may fail (or the codes
    # resynchronise); take flips until three chunks really fail
    for pos in range(16 + 11, pay_end, 53):
        mut = bytearray(good)
        mut[pos] ^= 0xFF
        hit = int(np.searchsorted(off, (pos - 16) * 8 + 7, "right")) - 1
        out.append((f"flip@{pos}", [bytes(mut)] + base[1:], set(),
                    {hit, hit - 1}))
    # the payload cut short by 8 bytes with the trailer kept: the last
    # chunk runs off its data
    cut = good[: pay_end - 8] + good[pay_end:]
    out.append(("truncated", [cut] + base[1:], {n_chunks - 1},
                {n_chunks - 1}))
    # one trailer offset off by one: the chunk before it ends one bit
    # early for its bound, the chunk itself starts inside a code
    k = n_chunks // 2
    mut = bytearray(good)
    struct.pack_into("<I", mut, pay_end + 8 + 4 * k, int(off[k]) + 1)
    out.append(("offset+1", [bytes(mut)] + base[1:], {k - 1}, {k - 1, k}))
    return out


def check_corrupt(base: list[bytes], nb: int) -> dict:
    """The corrupt cases through kernel and plain version: equal ``zz``
    and ``ok``, the chunks that must fail do, no other chunk does."""
    flips_failed = 0
    ran = 0
    worst = 0
    for label, streams, must, may in corrupt_cases(base, nb):
        _, ok, _, err = kernel_vs_plain_decode(label, streams)
        worst = max(worst, err)
        failing = set(np.flatnonzero(~ok).tolist())
        if not (must <= failing <= may):
            fail(f"entropy_decode[{label}]: chunks {sorted(failing)} failed "
                 f"validation, expected {sorted(must)} within {sorted(may)}")
        ran += 1
        flips_failed += label.startswith("flip") and bool(failing)
    if flips_failed < 3:
        fail(f"only {flips_failed} flipped bytes broke a chunk")
    return {"cases": ran, "flips_that_failed_a_chunk": flips_failed,
            "max_abs_err": worst}


def small_indexed_streams() -> tuple[list[bytes], int]:
    """Three 128x128 streams with a 16-block TICX stride: 16 chunks each."""
    size = 64 if REHEARSE else 128
    imgs = synthetic_corpus(3, size)
    streams = codec.compress_batch(imgs, 50, index_stride=16, device=DEV)
    return streams, (size // 8) ** 2


def run_sanitizer() -> str:
    """The corrupt cases once more under compute-sanitizer's memcheck, when
    that tool is installed and can attach; says so otherwise."""
    tool = shutil.which("compute-sanitizer")
    if tool is None or REHEARSE:
        return "not run: compute-sanitizer is not on this machine"
    proc = subprocess.Popen(
        [tool, "--tool", "memcheck", sys.executable,
         os.path.abspath(__file__), "--sanitize-corrupt"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        process_group=0,
    )
    try:
        out, _ = proc.communicate(timeout=180)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        return "not run: compute-sanitizer did not finish in 180 s"
    m = re.search(r"ERROR SUMMARY: (\d+) error", out)
    if "Device not supported" in out:
        return ("not run: compute-sanitizer is installed but answers "
                "'Device not supported' on this machine")
    if m is None or '"sanitize_corrupt": "done"' not in out:
        tail = " | ".join(out.strip().splitlines()[-2:])[:200]
        return f"not run: compute-sanitizer could not attach ({tail})"
    if int(m.group(1)):
        fail(f"compute-sanitizer reports {m.group(1)} errors:\n{out[-3000:]}")
    return "memcheck: 0 errors"


def phase_decode_check(corpus: np.ndarray) -> int:
    """The entropy decode kernel against its plain version on the card, on
    valid streams (where every chunk must validate and the coefficients
    must be the host oracle's) and on corrupted ones.  Returns the largest
    |kernel - plain| measured over ``zz`` and ``ok`` in all cases."""
    report = []
    worst = 0
    odd = synthetic_corpus(3, 128)[:, :61, :83].copy()
    dyn_img = synthetic_corpus(1, 64 if REHEARSE else 128)[0]
    dyn = container.compress(dyn_img, 50, True, block_index=True)
    small, small_nb = small_indexed_streams()
    # seven flat images and one of dense noise: the noise image's CTAs
    # span far more of the stream than the batch's mean, past their window
    rng = np.random.RandomState(96)
    side = 32 if REHEARSE else 256
    mixed = np.empty((8, side, side), np.uint8)
    mixed[:] = (40 + 25 * np.arange(8)).reshape(8, 1, 1)
    mixed[5] = rng.randint(0, 256, (side, side))
    uneven = codec.compress_batch(mixed, 96, precision="fast",
                                  index_stride=16, device=DEV)
    past_window = None
    cases = [
        ("corpus q50", codec.compress_batch(corpus, 50, precision="fast",
                                            device=DEV)),
        ("corpus q90", codec.compress_batch(corpus, 90, precision="fast",
                                            device=DEV)),
        ("odd 61x83", codec.compress_batch(odd, 50, device=DEV)),
        ("stride 16", small),
        ("dynamic table", [dyn, dyn]),
        ("uneven density q96", uneven),
        ("stride 4096: one chunk an image", codec.compress_batch(
            synthetic_corpus(3, 32 if REHEARSE else 96), 50,
            index_stride=4096, device=DEV)),
        ("images of one block", codec.compress_batch(
            rng.randint(0, 256, (64 if REHEARSE else 2048, 8, 8)).astype(
                np.uint8), 50, device=DEV)),
    ]
    for label, streams in cases:
        prep, ok, zz, err = kernel_vs_plain_decode(label, streams)
        worst = max(worst, err)
        if not ok.all():
            fail(f"entropy_decode[{label}]: valid chunks failed validation")
        if label.startswith("uneven"):
            past_window = ctas_past_window(prep)
            if past_window < 1 and not REHEARSE:
                fail("entropy_decode[uneven density]: no CTA reaches past "
                     "its staged window")
        # the host oracle's coefficients, on the first and the last stream
        nb = prep["nb_per_image"]
        for i in (0, len(streams) - 1):
            a = container.decompress_to_arrays(streams[i])
            mine = zz[i * nb: (i + 1) * nb].cpu().numpy()
            if not (np.array_equal(mine[:, 0], a.dc)
                    and np.array_equal(mine[:, 1:], a.ac)):
                fail(f"entropy_decode[{label}]: stream {i} differs from "
                     "the host decoder's coefficients")
        report.append({"case": label, "streams": len(streams),
                       "chunks": int(ok.size), "blocks": prep["nb_total"],
                       "stride": prep["stride"],
                       "words": int(prep["words"].size),
                       "max_abs_err": err,
                       "own_table": prep["tables"] is not None})
    corrupt = check_corrupt(small, small_nb)
    arrays = check_decode_arrays(small)
    worst = max(worst, corrupt["max_abs_err"], arrays["max_abs_err"])
    emit("decode_check", cases=report, corrupt=corrupt, arrays=arrays,
         ctas_past_their_window=past_window,
         sanitizer=run_sanitizer(),
         tolerance="zz and ok equal bit for bit; valid streams: all chunks "
         "ok and coefficients equal to the host decoder's; corrupt "
         "streams: exactly the hit chunks fail, in both")
    return worst


def inverse_both(label: str, zz: torch.Tensor, h: int, w: int,
                 tables: DecodeTables) -> tuple[int, int]:
    """``exact_inverse`` and its plain version on the same rows: (the
    largest |kernel - plain| over the pixels, the flagged count).  Fails
    the run unless pixels and counts are equal."""
    pk, nk = exact_inverse.exact_inverse(zz, h, w, tables)
    pp, np_ = exact_inverse.exact_inverse_plain(zz, h, w, tables)
    sync()
    err = max_abs_diff((pk, pp))
    if not eq(pk, pp) or int(nk) != int(np_):
        fail(f"exact_inverse[{label}]: kernel and plain version differ "
             f"(pixels {int((pk != pp).sum())}, flagged {int(nk)} against "
             f"{int(np_)})")
    return err, int(nk)


def phase_inverse_check(corpus: np.ndarray) -> int:
    """The exact decode transform against its plain version on the card:
    the decoded rows of exact streams (the corpus, odd shapes, images of
    one block), whose pixels must also be the oracle's, and random rows
    (200 000 blocks in odd-shaped images, a DC sum that wraps in int32).
    Returns the largest |kernel - plain| over the pixels."""
    worst, report = 0, []
    rng = np.random.RandomState(23)
    odd = synthetic_corpus(3, 128)[:, :61, :83].copy()
    cases = [
        ("corpus q50", codec.compress_batch(corpus, 50, device=DEV)),
        ("corpus q90", codec.compress_batch(corpus, 90, device=DEV)),
        ("odd 61x83", codec.compress_batch(odd, 50, device=DEV)),
        ("images of one block", codec.compress_batch(
            rng.randint(0, 256, (64 if REHEARSE else 2048, 8, 8)).astype(
                np.uint8), 50, device=DEV)),
    ]
    for label, streams in cases:
        prep, args, dtab = decode_inputs(streams)
        h, w, _ = prep["shape"]
        zz = entropy_decode.entropy_decode_chunks(*args, prep["nb_total"],
                                                  dtab)[0]
        zz = zz.reshape(len(streams), prep["nb_per_image"], 64)
        err, flagged = inverse_both(label, zz, h, w, dtab)
        worst = max(worst, err)
        pix = exact_inverse.exact_inverse(zz, h, w, dtab)[0].cpu().numpy()
        for i in (0, len(streams) - 1):
            if not np.array_equal(pix[i], container.decompress(streams[i])):
                fail(f"exact_inverse[{label}]: image {i} differs from the "
                     "oracle")
        report.append({"case": label, "images": len(streams),
                       "shape": [h, w], "flagged": flagged,
                       "max_abs_err": err})
    tables = DecodeTables.build(50, False, DEV)
    b, h, w = (2, 40, 40) if REHEARSE else (5, 1597, 1599)
    nb = -(-h // 8) * -(-w // 8)
    zz = rng.randint(-8, 9, (b, nb, 64)) * (rng.rand(b, nb, 64) < 0.1)
    zz[..., 0] = np.diff(rng.randint(-64, 65, (b, nb)), axis=1, prepend=0)
    wrap = np.zeros((2, 96, 64), np.int64)
    wrap[..., 0] = 2 ** 31 - 1
    for label, rows, hw in (("random rows", zz, (h, w)),
                            ("DC sum past 2**31", wrap, (64, 96))):
        rows = torch.from_numpy(rows.astype(np.int32)).to(DEV)
        err, flagged = inverse_both(label, rows, *hw, tables)
        worst = max(worst, err)
        report.append({"case": label, "images": int(rows.shape[0]),
                       "shape": list(hw), "flagged": flagged,
                       "max_abs_err": err})
    emit("inverse_check", cases=report,
         tolerance="pixels and flagged counts equal bit for bit; the "
         "decoded streams' pixels equal to container.decompress")
    return worst


def first_flip_that_fails(stream: bytes, nb: int) -> bytes:
    """``stream`` with one payload byte inverted such that a chunk fails
    the device decoder's validation (many flips resynchronise and do
    not)."""
    pay_end = container.parse_block_index(stream, nb)[2]
    for pos in range(16 + 101, pay_end, max(1, (pay_end - 16) // 40)):
        mut = bytearray(stream)
        mut[pos] ^= 0xFF
        prep, args, tables = decode_inputs([bytes(mut)])
        _, ok = entropy_decode.entropy_decode_chunks(
            *args, prep["nb_total"], tables)
        if not bool(ok.all()):
            return bytes(mut)
    fail("no flipped byte broke a chunk")


def counted(label: str, fn, want: dict, per_path: dict):
    """One path of the round trip with launch counts of its own: every
    count is set to 0 just before ``fn()`` and read just after, and must
    be exactly what the path is made of.  ``want``: kernel -> the allowed
    counts (a tuple); a kernel not named must not have been launched."""
    reset_counts()
    out = fn()
    sync()
    got = counts()
    per_path[label] = got
    if not REHEARSE:
        if got["encode2"] != got["encode2_pixels"] + got["encode2_zz"]:
            fail(f"{label}: encode2's counts do not add up: {got}")
        for k, v in got.items():
            if k != "encode2" and v not in want.get(k, (0,)):
                fail(f"{label}: kernel {k} was launched {v} times, expected "
                     f"one of {want.get(k, (0,))}; all counts: {got}")
    return out


# what each path of the round trip launches; the stream assembly runs a
# second time only if the first capacity was too small
ENCODE_EXACT = {"exact_transform": (1,), "encode2_zz": (1,), "place": (1, 2)}
ENCODE_FAST = {"encode2_pixels": (1,), "place": (1, 2)}
ENCODE_V1 = {"encode1": (1,), "stitch": (1, 2)}
# an exact decode on the kernel leg; a fast one runs no exact_inverse
DECODE_KERNEL = {"entropy_decode": (1,), "exact_inverse": (1,)}
DECODE_FAST = {"entropy_decode": (1,)}


def phase_main_path(corpus: np.ndarray) -> tuple[dict, list[bytes],
                                                 list[bytes]]:
    """The round trip through the public entry points on the corpus:
    encode in both precisions and through the v1 kernels, decode on the
    device; each path between a reset and a reading of the launch
    counters.  Returns the counts summed over the paths, the exact
    streams and the fast ones."""
    quality = 50
    n_img = corpus.shape[0]
    nb = (corpus.shape[1] // 8) * (corpus.shape[2] // 8)
    per_path: dict = {}
    t0 = time.perf_counter()
    exact = counted("compress_batch exact", lambda: codec.compress_batch(
        corpus, quality, precision="exact", device=DEV),
        ENCODE_EXACT, per_path)
    fast = counted("compress_batch fast", lambda: codec.compress_batch(
        corpus, quality, precision="fast", device=DEV),
        ENCODE_FAST, per_path)
    fast_noindex = counted(
        "compress_batch fast, no index", lambda: codec.compress_batch(
            corpus, quality, precision="fast", block_index=False,
            device=DEV), ENCODE_FAST, per_path)
    v1 = counted("compress_batch_device fast v1",
                 lambda: compress_batch_device(
                     corpus, quality, precision="fast", device=DEV,
                     version="v1"), ENCODE_V1, per_path)
    odd = synthetic_corpus(1, 128)[0][:61, :83].copy()
    odd_bytes = counted("compress odd", lambda: codec.compress(
        odd, quality, device=DEV), ENCODE_EXACT, per_path)
    secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = Engine("exact", DEV)
    decoded = counted("decompress_batch exact",
                      lambda: engine.decompress_batch(exact),
                      DECODE_KERNEL, per_path)
    batch_stats = dict(engine.decode_stats)
    odd_decoded = counted("decompress odd", lambda: codec.decompress(
        odd_bytes, device=DEV), DECODE_KERNEL, per_path)
    decoded_fast = counted("decompress_batch fast",
                           lambda: codec.decompress_batch(
                               exact, precision="fast", device=DEV),
                           DECODE_FAST, per_path)
    decode_secs = time.perf_counter() - t0
    if v1 != fast_noindex:
        fail("v1 fast bytes differ from v2 fast bytes for images "
             f"{[i for i in range(n_img) if v1[i] != fast_noindex[i]]}")
    if [s[: len(t)] for s, t in zip(fast, fast_noindex)] != fast_noindex:
        fail("the block index changed the payload of a fast stream")
    if batch_stats != {"kernel": n_img, "host_entropy": 0,
                       "host_decoder": 0}:
        fail(f"decompress_batch took other legs than the kernel's: "
             f"{batch_stats}")

    # ---- check the bytes by the repo's own means: the float64 oracle ----
    t0 = time.perf_counter()
    n_img = corpus.shape[0]
    mism = [
        i for i in range(n_img)
        if exact[i] != container.compress(corpus[i], quality,
                                          block_index=True)
    ]
    if mism:
        fail(f"exact bytes differ from the oracle for images {mism}")
    if odd_bytes != container.compress(odd, quality, block_index=True):
        fail("odd-shaped compress differs from the oracle")
    odd_oracle = container.decompress(odd_bytes)
    if odd_oracle.shape != odd.shape:
        fail("odd-shaped stream decodes to the wrong shape")
    if not (odd_decoded.shape == odd.shape
            and np.array_equal(odd_decoded, odd_oracle)):
        fail("decompress of the odd-shaped stream differs from the oracle")
    if decoded.shape != corpus.shape or decoded.dtype != np.uint8:
        fail(f"decompress_batch returned {decoded.shape} {decoded.dtype}")
    worst = 0.0
    worst_dec = 0.0
    oracle = []
    for i in range(n_img):
        dec_e = container.decompress(exact[i])
        dec_f = container.decompress(fast[i])
        oracle.append(dec_e)
        if dec_e.shape != corpus[i].shape or dec_f.shape != corpus[i].shape:
            fail(f"image {i} decodes to the wrong shape")
        pe, pf = psnr(corpus[i], dec_e), psnr(corpus[i], dec_f)
        if not (np.isfinite(pe) and np.isfinite(pf)):
            fail(f"image {i}: PSNR not finite")
        worst = max(worst, abs(pe - pf))
        if not np.array_equal(decoded[i], dec_e):
            fail(f"decompress_batch: image {i} differs from the oracle in "
                 f"{int((decoded[i] != dec_e).sum())} pixels")
        worst_dec = max(worst_dec,
                        abs(psnr(corpus[i], decoded_fast[i]) - pe))
    if worst > 0.01:
        fail(f"fast-mode PSNR is {worst} dB from exact mode (> 0.01)")
    if worst_dec > 0.01:
        fail(f"fast-precision decode PSNR is {worst_dec} dB from the exact "
             "decode (> 0.01)")

    # ---- streams the kernel leg cannot take, and a corrupt one ----------
    pay_end = container.parse_block_index(exact[1], nb)[2]
    no_trailer = exact[1][:pay_end]
    flipped = first_flip_that_fails(exact[2], nb)
    flipped_oracle = container.decompress(flipped)
    legs = {}
    for label, batch, want, stats, kernels in (
        ("no_trailer_in_batch", [exact[0], no_trailer, flipped, exact[3]],
         [oracle[0], oracle[1], flipped_oracle, oracle[3]],
         {"kernel": 0, "host_entropy": 4, "host_decoder": 0},
         {"exact_inverse": (1,)}),
        ("corrupt_in_batch", [exact[0], flipped, exact[3], exact[4 % n_img]],
         [oracle[0], flipped_oracle, oracle[3], oracle[4 % n_img]],
         {"kernel": 3, "host_entropy": 0, "host_decoder": 1}, DECODE_KERNEL),
    ):
        got = counted(label, lambda: engine.decompress_batch(batch), kernels,
                      per_path)
        legs[label] = dict(engine.decode_stats)
        if legs[label] != stats:
            fail(f"{label}: legs {legs[label]}, expected {stats}")
        for i, (g, w) in enumerate(zip(got, want)):
            if not np.array_equal(g, w):
                fail(f"{label}: image {i} differs from the oracle")
    # the counts of the whole round trip: the sum over its paths; every
    # kernel must have been launched by one of them, but ``symbol_stats``,
    # which only the auto-table encode runs (its phase counts it)
    launched = {k: sum(c[k] for c in per_path.values())
                for k in next(iter(per_path.values()))}
    if not REHEARSE:
        for k, v in launched.items():
            if v < 1 and k != "symbol_stats":
                fail(f"main path launched kernel {k} {v} times")
    emit("main_path", images=list(corpus.shape), quality=quality,
         oracle_checked=f"all {n_img} exact streams byte-equal to "
         "container.compress(block_index=True); all exact and fast "
         f"streams decoded; v1 fast bytes == v2 fast bytes for {n_img}/"
         f"{n_img}; decompress_batch pixels == container.decompress for "
         f"{n_img}/{n_img}; odd-shaped decompress == oracle",
         fast_vs_exact_psnr_db=worst,
         fast_decode_vs_exact_decode_psnr_db=worst_dec,
         decode_legs_corpus=batch_stats, decode_legs=legs,
         launches=launched, launches_by_path=per_path,
         bytes_exact=sum(map(len, exact)), bytes_fast=sum(map(len, fast)),
         sha256_exact_streams=hashlib.sha256(b"".join(exact)).hexdigest(),
         sha256_fast_streams=hashlib.sha256(b"".join(fast)).hexdigest(),
         first_pass_seconds=round(secs, 3),
         first_decode_seconds=round(decode_secs, 3),
         check_seconds=round(time.perf_counter() - t0, 1))
    return launched, exact, fast


def auto_table_launches(n_img: int) -> dict:
    """What ``n_img`` auto-table encodes on the kernel route launch:
    ``exact_transform``, ``symbol_stats``, ``encode2`` from coefficients
    and ``place`` once an image each (an image of one block range),
    ``place`` once more where the capacity was too small."""
    return {"exact_transform": (n_img,), "symbol_stats": (n_img,),
            "encode2_zz": (n_img,),
            "place": tuple(range(n_img, 2 * n_img + 1))}


def handmade_specs() -> dict:
    """Run-time tables no image's own histogram gives: codes of 16
    bits for the rare DC and AC symbols (a DC put of up to 27 bits) with a
    ZRL code of 16 bits (prefixes of 16, 32 and 48 bits; the 32-bit one is
    one whole word), and the same with no ZRL code at all."""
    def spec(zrl: bool):
        dc = {c: 16 for c in range(12)}
        dc.update({0: 3, 1: 3, 2: 3, 3: 4, 4: 4, 5: 5})
        ac = {(r, s): 16 for r in range(16) for s in range(1, 11)}
        ac.update({(0, 0): 2, (0, 1): 3, (0, 2): 4, (1, 1): 5, (0, 3): 6})
        if zrl:
            ac[(15, 0)] = 16
        return huffman.spec_from_lengths(dc, ac)

    return {"16-bit codes, 16-bit ZRL": spec(True),
            "16-bit codes, no ZRL": spec(False)}


def runs_coefficients(rng, n: int, zrl: bool) -> np.ndarray:
    """(64, n) int32 coefficient-major blocks for hand-made tables: with
    ``zrl`` runs of 16, 32 and 48 zeros before coefficients of sizes up to
    10 (slots of up to 74 bits), else no run of 16 zeros; a quarter of the
    blocks dense (40 coefficients).  Every block stays under 52 words."""
    zz = np.zeros((64, n), np.int32)
    zz[0] = rng.randint(-1023, 1024, n)
    sign = lambda k: rng.choice([-1, 1], k)
    for b in range(n):
        kind = b % 4
        if not zrl:  # gaps of one or two zeros, 21 to 32 coefficients
            pos = np.arange(1 + kind, 64, 2 + kind % 2)
        elif kind == 3:
            pos = rng.choice(np.arange(1, 64), 40, replace=False)
        else:  # runs of 16 and 32, of 48, of 16 three times
            pos = ([1, 18, 51], [14, 63], [1, 5, 22, 39, 56])[kind]
        zz[pos, b] = rng.randint(1, 1024, len(pos)) * sign(len(pos))
    return zz


def phase_auto_table(corpus: np.ndarray) -> tuple[dict, int, list]:
    """Auto-table encode through the public entry point: every corpus image
    at q=50, a quality sweep on three images, the 4096x4096 image; bytes
    against the host oracle, the route against the engine's rule, launch
    counts per path, every stream decoded on its leg to the oracle's
    pixels.  Then ``encode2`` against its plain version on run-time
    tables, hand-made ones included.  Returns (launches by path, the
    largest |kernel - plain| of ``encode2``, the corpus streams)."""
    per_path: dict = {}
    n_img = corpus.shape[0]

    def encode(images, quality, label):
        routes = [auto_table_route(im, quality) for im in images]
        k = routes.count("kernel")
        want = auto_table_launches(k)
        # both routes transform and count the symbols
        want["exact_transform"] = want["symbol_stats"] = (len(images),)
        out = counted(label, lambda: [codec.compress(
            im, quality, auto_generate_huffman_table=True, device=DEV)
            for im in images], want, per_path)
        for i, (im, data) in enumerate(zip(images, out)):
            if data != container.compress(im, quality, True,
                                          block_index=True):
                fail(f"auto_table[{label}]: image {i} differs from "
                     "container.compress(..., True, block_index=True)")
        return out, routes

    t0 = time.perf_counter()
    streams, routes = encode(corpus, 50, f"compress auto_table x{n_img} q50")
    if routes != ["kernel"] * n_img:
        fail(f"auto_table: corpus at q=50 took routes {routes}")
    sweep = []
    picks = [0, 17 % n_img, 33 % n_img]
    for quality in (10, 90, 97, 99):
        out, r = encode(corpus[picks], quality,
                        f"compress auto_table q{quality} x{len(picks)}")
        sweep += [(quality, i, d, rt) for i, d, rt in zip(picks, out, r)]
    big = one_large_image(corpus)
    out, r = encode(big, 50, "compress auto_table 4096x4096 q50")
    sweep.append((50, "4096x4096", out[0], r[0]))
    encode_secs = time.perf_counter() - t0

    # every stream decoded, one call a stream (a table of its own each):
    # standard-range tables on the kernel leg, one decode launch each
    t0 = time.perf_counter()
    engine = Engine("exact", DEV)
    every = [(50, i, d, "kernel") for i, d in enumerate(streams)] + sweep
    want_leg = {"kernel": "kernel", "host": "host_entropy"}
    legs = {"kernel": 0, "host_entropy": 0, "host_decoder": 0}

    def decode_all():
        out = []
        for quality, i, data, route in every:
            out.append(engine.decompress(data))
            leg = want_leg[route]
            if engine.decode_stats[leg] != 1:
                fail(f"auto_table: q{quality} image {i} decoded on "
                     f"{engine.decode_stats}, expected {leg}")
            legs[leg] += 1
        return out

    on_kernel = sum(route == "kernel" for *_, route in every)
    decoded = counted(f"decompress auto_table x{len(every)}", decode_all,
                      {"entropy_decode": (on_kernel,),
                       "exact_inverse": (len(every),)}, per_path)
    for (quality, i, data, _), out in zip(every, decoded):
        if not np.array_equal(out, container.decompress(data)):
            fail(f"auto_table: q{quality} image {i} decodes to other "
                 "pixels than the oracle's")
    decode_secs = time.perf_counter() - t0

    # encode2 against its plain version on run-time tables
    worst = 0
    cases = []
    for quality, i in ((50, 0), (97, picks[1])):
        img = corpus[i:i + 1]
        spec = huffman.build_huffman_spec(golden.encode_arrays(img[0],
                                                               quality))
        if spec.extended:
            continue
        zz = exact_coefficients(blocks_of(img),
                                CodecTables.build(quality, DEV))
        _, err = encode2_both(f"table of image {i} q{quality}", zz,
                              CodecTables.from_spec(spec, quality, DEV),
                              zz.shape[1])
        worst = max(worst, err)
        cases.append({"case": f"table built for image {i} at q{quality}",
                      "max_code_bits": int(max(spec.dc_len.max(),
                                               spec.ac_len.max()))})
    rng = np.random.RandomState(61)
    for name, spec in handmade_specs().items():
        zrl = "no ZRL" not in name
        n = 256 if REHEARSE else 8192
        zz_np = runs_coefficients(rng, n, zrl)
        ac = np.ascontiguousarray(zz_np[1:].T)
        nz, run, size = huffman.ac_symbols(ac)
        slot = (run >> 4) * int(spec.ac_len[15, 0]) + spec.ac_len[
            run & 15, size] + size
        dc = np.diff(zz_np[0], prepend=np.int32(0))
        bits = huffman.block_bit_counts(dc, ac, spec)
        if bits.max() > KERNEL_BLOCK_BITS:
            fail(f"encode2[{name}]: a hand-made block passes 52 words")
        zz = torch.from_numpy(zz_np).to(DEV)
        tables = CodecTables.from_spec(spec, 50, DEV)
        for nb in (64, n):  # many images; one image (the longest scan)
            _, err = encode2_both(f"{name}, nb {nb}", zz, tables, nb)
            worst = max(worst, err)
        cases.append({"case": name, "blocks": n,
                      "zrl_prefix_bits": sorted(set(
                          ((run[nz] >> 4) * int(spec.ac_len[15, 0]))
                          .tolist())),
                      "max_slot_bits": int(slot[nz].max()),
                      "max_block_bits": int(bits.max())})
    if not any(c.get("max_slot_bits", 0) > 64 for c in cases):
        fail("encode2: no hand-made slot passed 64 bits")
    launched = {k: sum(c[k] for c in per_path.values())
                for k in next(iter(per_path.values()))}
    emit("auto_table", images=n_img, quality=50,
         oracle_checked=f"{n_img}/{n_img} corpus streams, q 10, 90, 97 "
         f"and 99 on images {picks} and the 4096x4096 image byte-equal to "
         "container.compress(..., True, block_index=True); every stream "
         "decoded to container.decompress's pixels",
         routes={f"q{q} image {i}": r for q, i, _, r in sweep},
         decode_legs=legs, launches=launched, launches_by_path=per_path,
         encode2_runtime_tables=cases, encode2_max_abs_err=worst,
         bytes_corpus=sum(map(len, streams)),
         sha256_corpus=hashlib.sha256(b"".join(streams)).hexdigest(),
         encode_and_check_seconds=round(encode_secs, 1),
         decode_and_check_seconds=round(decode_secs, 1),
         tolerance="bytes equal; pixels equal; encode2 rows, meta and flag "
         "equal to the plain version")
    return per_path, worst, streams


def host_ms(fn, reps: int) -> float:
    """Median host milliseconds of ``fn()`` between synchronisations,
    after one warm call."""
    times = []
    for _ in range(reps + 1):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[1:]))


def tiled_launches(k: int, exact: bool) -> dict:
    """What an image of ``k`` block ranges launches: per range the
    coefficients (``exact_transform``, or the fast transform pass, which
    is not among the counts), ``encode2`` from them, ``place`` once or
    twice."""
    want = {"encode2_zz": (k,), "place": tuple(range(k, 2 * k + 1))}
    if exact:
        want["exact_transform"] = (k,)
    return want


def encode_stages(img: np.ndarray, reps: int) -> dict:
    """Where an exact encode of one image through block ranges spends its
    time: each stage alone, host clock around a synchronised call."""
    nb = (img.shape[0] // 8) * (img.shape[1] // 8)
    tables = CodecTables.build(50, DEV)
    ranges = pipeline.sub_ranges(0, nb)

    def upload():
        return [pipeline.range_blocks(img, a, b, DEV) for a, b in ranges]

    blocks = upload()
    zz_list = [exact_coefficients(bl, tables) for bl in blocks]
    flagged = sum(int(exact_transform.exact_transform(bl, tables)[1].sum())
                  for bl in blocks)
    segments, offsets, _ = pipeline.encode_ranges(zz_list, tables, None,
                                                  4.0, with_offsets=True)

    def concat():
        words, bits = pipeline.concat_bits(
            [(w.cpu(), b) for w, b in segments], torch.device("cpu"))
        return pipeline.stream_bytes(words, bits)

    return {
        "upload_and_blockify_ms": host_ms(upload, reps),
        "exact_transform_ms": host_ms(lambda: [
            exact_transform.exact_transform(bl, tables) for bl in blocks],
            reps),
        "exact_coefficients_ms": host_ms(lambda: [
            exact_coefficients(bl, tables) for bl in blocks], reps),
        "encode_ranges_ms": host_ms(lambda: pipeline.encode_ranges(
            zz_list, tables, None, 4.0), reps),
        "encode_ranges_with_offsets_ms": host_ms(
            lambda: pipeline.encode_ranges(zz_list, tables, None, 4.0,
                                           with_offsets=True), reps),
        "pull_and_concat_on_host_ms": host_ms(concat, reps),
        "block_index_ms": host_ms(
            lambda: container.make_block_index(offsets), reps),
        "flagged_blocks": flagged, "blocks": nb, "block_ranges": len(ranges),
    }


def phase_tiled() -> dict:
    """The path of this slice at full size: one 7680x4320 image (33.2 MP,
    518 400 blocks: two block ranges of one call each on one card) through
    ``compress`` (exact and fast), ``decompress`` and
    ``parallel.tiled.encode_tiled`` in both assembly modes, and one
    4096x4104 image (just over the limit) with auto tables; bytes and
    pixels against the float64 oracle.  In a rehearsal the images are
    small and the limit is lowered to 100 blocks."""
    limit = pipeline.MAX_PIXELS
    if REHEARSE:
        pipeline.MAX_PIXELS = 64 * 100
    try:
        return _tiled_checks()
    finally:
        pipeline.MAX_PIXELS = limit


def _tiled_checks() -> dict:
    quality = 50
    h, w = (72, 136) if REHEARSE else (4320, 7680)
    img = seeded_image(h, w, 8)
    nb = (h // 8) * (w // 8)
    k = len(pipeline.sub_ranges(0, nb))
    if k < 2:
        fail(f"tiled: {h}x{w} is {k} block range, not two")
    per_path: dict = {}
    mesh = make_mesh(1, device=DEV)
    t0 = time.perf_counter()
    encode2.transform_launches = 0
    exact = counted(f"compress {w}x{h} exact", lambda: codec.compress(
        img, quality, device=DEV), tiled_launches(k, True), per_path)
    fast = counted(f"compress {w}x{h} fast", lambda: codec.compress(
        img, quality, precision="fast", device=DEV),
        tiled_launches(k, False), per_path)
    fast_transform = encode2.transform_launches
    if not REHEARSE and fast_transform != k:
        fail(f"tiled: the fast transform pass ran {fast_transform} times")
    engine = Engine("exact", DEV)
    decoded = counted(f"decompress {w}x{h}", lambda: engine.decompress(
        exact), DECODE_KERNEL, per_path)
    legs = dict(engine.decode_stats)
    decoded_fast = engine.decompress(fast)
    by_mode = {}
    for assemble in ("host", "device"):
        by_mode[assemble] = counted(
            f"encode_tiled {assemble}", lambda: tiled.encode_tiled(
                img, quality, mesh=mesh, assemble=assemble),
            tiled_launches(k, True), per_path)
    port_s = time.perf_counter() - t0
    if legs != {"kernel": 1, "host_entropy": 0, "host_decoder": 0}:
        fail(f"tiled: the decode took the legs {legs}")

    t0 = time.perf_counter()
    oracle = container.compress(img, quality, block_index=True)
    oracle_encode_s = time.perf_counter() - t0
    if exact != oracle:
        fail(f"tiled: the {w}x{h} exact stream differs from the oracle "
             f"({len(exact)} and {len(oracle)} bytes)")
    pay_end = container.parse_block_index(exact, nb)[2]
    for assemble, data in by_mode.items():
        if data != exact[:pay_end]:
            fail(f"tiled: encode_tiled(assemble={assemble!r}) differs from "
                 "the oracle's stream without its trailer")
    t0 = time.perf_counter()
    oracle_px = container.decompress(exact)
    oracle_decode_s = time.perf_counter() - t0
    if not np.array_equal(decoded, oracle_px):
        fail(f"tiled: decompress differs from the oracle in "
             f"{int((decoded != oracle_px).sum())} pixels")
    pe, pf = psnr(img, decoded), psnr(img, decoded_fast)
    if not (np.isfinite(pe) and abs(pe - pf) <= 0.01):
        fail(f"tiled: fast PSNR {pf} dB, exact {pe} dB (> 0.01 apart)")

    h2, w2 = (64, 104) if REHEARSE else (4096, 4104)
    img2 = seeded_image(h2, w2, 9)
    nb2 = (h2 // 8) * (w2 // 8)
    k2 = len(pipeline.sub_ranges(0, nb2))
    if k2 < 2:
        fail(f"tiled: {h2}x{w2} is not over the limit")
    want = tiled_launches(k2, True)
    want["symbol_stats"] = (k2,)  # one launch a range
    t0 = time.perf_counter()
    auto = counted(f"compress auto_table {w2}x{h2}", lambda: codec.compress(
        img2, quality, auto_generate_huffman_table=True, device=DEV),
        want, per_path)
    auto_port_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if auto != container.compress(img2, quality, True, block_index=True):
        fail(f"tiled: the {w2}x{h2} auto-table stream differs from "
             "container.compress(..., True, block_index=True)")
    auto_oracle_s = time.perf_counter() - t0

    reps = 1 if REHEARSE else 3
    mp = img.size / 1e6
    timing = {}
    for label, fn in (
            ("encode_exact", lambda: codec.compress(img, quality,
                                                    device=DEV)),
            ("encode_fast", lambda: codec.compress(
                img, quality, precision="fast", device=DEV)),
            ("decode_exact", lambda: engine.decompress(exact))):
        ms = host_ms(fn, reps)
        timing[f"{label}_ms"] = ms
        timing[f"{label}_MP_per_s"] = mp / ms * 1e3
    timing["oracle_encode_ms"] = oracle_encode_s * 1e3
    timing["oracle_decode_ms"] = oracle_decode_s * 1e3
    emit("tiled_breakdown", image=[h, w],
         note="stages of one exact encode and one exact decode of the "
         "large image, each timed alone (host clock, synchronised, "
         f"median of {reps}); encode: per block range the upload of its "
         "rows + blockify, exact_transform, exact_coefficients (the same + "
         "flags to the host + float64 recompute + patch), encode2 + place "
         "+ the totals (encode_ranges), then the pull and concatenation "
         "of the segments on the host and the TICX trailer",
         encode=encode_stages(img, reps), decode=decode_stages([exact], reps))
    emit("tiled", image=[h, w], blocks=nb, block_ranges=k,
         max_blocks_a_call=pipeline.MAX_PIXELS // 64, quality=quality,
         oracle_checked=f"{w}x{h} exact compress == container.compress("
         "block_index=True); encode_tiled host and device == that stream "
         "without its trailer; decompress == container.decompress; "
         f"{w2}x{h2} auto tables == container.compress(..., True, "
         "block_index=True)",
         fast_vs_exact_psnr_db=abs(pe - pf), psnr_exact_db=pe,
         decode_legs=legs, bytes_exact=len(exact), bytes_fast=len(fast),
         bytes_auto_table=len(auto), fast_transform_launches=fast_transform,
         launches_by_path=per_path,
         sha256_exact=hashlib.sha256(exact).hexdigest(),
         port_seconds=round(port_s, 1),
         auto_table_seconds=round(auto_port_s, 1),
         auto_table_oracle_seconds=round(auto_oracle_s, 1),
         timing_note="host clock around synchronised calls, median of "
         f"{reps} after a warm one; encodes from host memory, decode to "
         "host memory; oracle_* = container.compress / decompress, once",
         **timing)
    return {"per_path": per_path, "image": img, "exact": exact,
            "fast": fast, "pay_end": pay_end}


def phase_encode_to_words(corpus: np.ndarray, exact: list[bytes],
                          fast: list[bytes], big: dict) -> dict:
    """``Engine.encode_to_words`` on the card: the per-block words and bit
    counts of every corpus image and of the 7680x4320 image of ``tiled``
    (two block ranges, so the first row of the second is coded again on
    the host), stitched by ``native.stitch``, must be the payload of the
    oracle's stream (exact) or of the port's fast stream (fast).  Each
    path between a reset and a reading of the launch counters.  Returns
    the launches by path."""
    quality = 50
    n_img = corpus.shape[0]
    nb = (corpus.shape[1] // 8) * (corpus.shape[2] // 8)
    per_path: dict = {}
    engines = {p: Engine(p, DEV) for p in ("exact", "fast")}

    def payload(stream: bytes, n: int) -> bytes:
        return stream[HEADER_BYTES:container.parse_block_index(stream, n)[2]]

    def check(label, words, stream, n):
        w, bits = words
        if (w.dtype != np.uint32 or bits.dtype != np.int32
                or w.shape != (n, 52) or bits.shape != (n,)):
            fail(f"encode_to_words {label}: {w.dtype} {w.shape}, "
                 f"{bits.dtype} {bits.shape}")
        if native.stitch(w, bits) != payload(stream, n):
            fail(f"encode_to_words {label}: the stitched words differ from "
                 "the stream's payload")

    t0 = time.perf_counter()
    for precision, streams, want in (
            ("exact", exact, {"exact_transform": (n_img,),
                              "encode1": (n_img,)}),
            ("fast", fast, {"encode1": (n_img,)})):
        eng = engines[precision]
        got = counted(f"encode_to_words {precision} corpus", lambda: [
            eng.encode_to_words(im, quality) for im in corpus], want,
            per_path)
        for i in range(n_img):
            check(f"{precision} image {i}", got[i], streams[i], nb)
    corpus_s = time.perf_counter() - t0

    img = big["image"]
    nb_big = img.size // 64
    limit = pipeline.MAX_PIXELS
    if REHEARSE:
        pipeline.MAX_PIXELS = 64 * 100  # as in ``phase_tiled``
    try:
        k = len(pipeline.sub_ranges(0, nb_big))
        t0 = time.perf_counter()
        for precision, want in (
                ("exact", {"exact_transform": (k,), "encode1": (k,)}),
                ("fast", {"encode1": (k,)})):
            eng = engines[precision]
            got = counted(f"encode_to_words {precision} {img.shape[1]}x"
                          f"{img.shape[0]}",
                          lambda: eng.encode_to_words(img, quality), want,
                          per_path)
            check(f"{precision} {img.shape}", got, big[precision], nb_big)
        big_s = time.perf_counter() - t0
    finally:
        pipeline.MAX_PIXELS = limit
    emit("encode_to_words", images=list(corpus.shape),
         large_image=list(img.shape), block_ranges=k,
         checked=f"exact: the stitched words of {n_img} corpus images and "
         "of the large image == the oracle's payload; fast: == the port's "
         "fast (v2) payload", launches_by_path=per_path,
         corpus_seconds=round(corpus_s, 2),
         large_image_seconds=round(big_s, 2))
    return per_path


def sharded_rank(mesh, image: np.ndarray, corpus: np.ndarray,
                 exact: list[bytes]) -> dict:
    """One process of phases ``sharded`` and ``group_mesh`` (a spawned
    process): the tiled encode of the large image in both modes, the
    sharded encode of the corpus in both precisions and its encode with
    the index in both, its sharded decode; the launch counts, in all and
    by card, from a reset just before to a reading just after."""
    reset_counts()
    t0 = time.perf_counter()
    out = {
        "rank": mesh.rank, "size": mesh.size, "device": str(mesh.device),
        "shards": [[r, str(d)] for r, d in mesh.shards()],
        "backend": torch.distributed.get_backend(mesh.group),
        "tiled_host": tiled.encode_tiled(image, 50, mesh=mesh),
        "tiled_device": tiled.encode_tiled(image, 50, mesh=mesh,
                                           assemble="device"),
        "sharded_exact": pbatch.compress_batch_sharded(
            corpus, 50, mesh=mesh, precision="exact"),
        "sharded_fast": pbatch.compress_batch_sharded(corpus, 50, mesh=mesh),
        "batch_exact": pbatch.compress_batch(corpus, 50, mesh=mesh,
                                             block_index=True),
        "batch_fast": pbatch.compress_batch(corpus, 50, mesh=mesh,
                                            precision="fast",
                                            block_index=True),
        "decoded": pbatch.decompress_batch_sharded(exact, mesh=mesh),
    }
    sync()
    out["seconds"] = time.perf_counter() - t0
    out["counts"] = counts()
    out["by_card"] = conformance.launch_counts_by_card()
    out["shard_times"] = getattr(mesh, "last_run", None)
    return out


def check_sharded_rank(phase: str, label: str, r: dict, want: dict,
                       exact: list[bytes], fast: list[bytes]) -> None:
    """The bars of one :func:`sharded_rank` result; ``want``:
    :func:`sharded_want`; ``exact``, ``fast``: the corpus streams."""
    for key in ("tiled_host", "tiled_device"):
        if r[key] != want["tiled"]:
            fail(f"{phase}[{label}]: {key} differs from the oracle")
    for key in ("sharded_exact", "sharded_fast"):
        if r[key] != want[key]:
            fail(f"{phase}[{label}]: {key} differs from compress_batch's "
                 "bytes")
    if r["batch_exact"] != exact or r["batch_fast"] != fast:
        fail(f"{phase}[{label}]: compress_batch with the index differs "
             "from the corpus streams (sha256)")
    if not np.array_equal(r["decoded"], want["decoded"]):
        fail(f"{phase}[{label}]: decompress_batch_sharded differs from "
             "decompress_batch")
    if REHEARSE:
        return
    got = r["counts"]
    for k in ("exact_transform", "encode2_zz", "encode2_pixels", "place",
              "entropy_decode", "exact_inverse"):
        if got[k] < 1:
            fail(f"{phase}[{label}]: {k} was not launched")
    for k, cards in r["by_card"].items():
        if set(cards) - {0} or sum(cards.values()) != got[k]:
            fail(f"{phase}[{label}]: {k} counted {cards} by card, not all "
                 "on card 0 or not the total")


def sharded_want(corpus: np.ndarray, big: dict, exact: list[bytes]) -> dict:
    """What every rank of phases ``sharded`` and ``group_mesh`` must
    return: the 8K oracle's stream without its trailer, the corpus
    streams without theirs (exact) and one card's fast ones, one card's
    decode."""
    nb = (corpus.shape[1] // 8) * (corpus.shape[2] // 8)
    return {
        "tiled": big["exact"][:big["pay_end"]],
        "sharded_exact": [s[:container.parse_block_index(s, nb)[2]]
                          for s in exact],
        "sharded_fast": codec.compress_batch(corpus, 50, precision="fast",
                                             block_index=False, device=DEV),
        "decoded": codec.decompress_batch(exact, device=DEV),
    }


def phase_sharded(corpus: np.ndarray, big: dict, exact: list[bytes],
                  fast: list[bytes], want: dict) -> dict:
    """``parallel`` over processes on the one card: two ranks over gloo,
    each launching its kernels on ``cuda:0`` (NCCL puts no two ranks on
    one device), then NCCL at a world of one; the same calls in both.  The
    kernels and ``native/`` were built before the spawn.  A rank that
    fails fails the run.  ``want``: :func:`sharded_want`."""
    runs = [("gloo", 2, "cpu" if REHEARSE else "cuda:0"),
            ("gloo" if REHEARSE else "nccl", 1,
             "cpu" if REHEARSE else "cuda:0")]
    per_path: dict = {}
    report = []
    for backend, world, device in runs:
        t0 = time.perf_counter()
        results = spawn(sharded_rank, world, backend=backend, device=device,
                        args=(big["image"], corpus, exact))
        secs = time.perf_counter() - t0
        for r in results:
            label = f"{backend} x{world} rank {r['rank']}"
            if (r["size"], r["backend"]) != (world, backend):
                fail(f"sharded[{label}]: a mesh of {r['size']} over "
                     f"{r['backend']}")
            check_sharded_rank("sharded", label, r, want, exact, fast)
            per_path[label] = r["counts"]
            report.append({"ranks": label, "device": r["device"],
                           "rank_seconds": round(r["seconds"], 2)})
        report.append({"ranks": f"{backend} x{world}",
                       "spawn_seconds": round(secs, 1)})
    emit("sharded", runs=report, launches_by_path=per_path,
         checked=f"every rank: encode_tiled of the {big['image'].shape[1]}x"
         f"{big['image'].shape[0]} image (host and device) == the oracle's "
         "stream without its trailer; compress_batch_sharded of the corpus "
         "== compress_batch's bytes (exact, fast, no trailer); "
         "compress_batch with the index == the corpus streams (both "
         "sha256); decompress_batch_sharded == decompress_batch; every "
         "kernel launched, on card 0",
         unverified="NCCL at a world above one: NCCL puts no two ranks on "
         "one device, and this script runs on one card; "
         "scripts/torch_multicard.py checks NCCL at worlds 2 and 4, one "
         "card a rank, and every card of the machine, and writes "
         "reports/torch_multicard.json")
    return per_path


def doubled(want: dict) -> dict:
    """What two shards launch together when each launches what ``want``
    allows one call."""
    return {k: tuple(sorted({a + b for a in v for b in v}))
            for k, v in want.items()}


def phase_local_mesh(corpus: np.ndarray, big: dict, exact: list[bytes],
                     fast: list[bytes]) -> dict:
    """``parallel`` on a local mesh: two shards on ``cuda:0``, one thread
    each, in this process (``make_mesh(devices=...)``; the mesh over
    every card of a machine is ``scripts/torch_multicard.py``'s ``local``
    phase).  The 7680x4320 tiled encode (host and device assembly, exact;
    fast), the corpus through ``compress_batch`` with the index (exact,
    fast) and ``compress_batch_sharded`` (exact, fast), the exact streams
    through ``decompress_batch_sharded``: each equal to the world of one's
    bytes or pixels and, exact, to the oracle's; each path's launches
    counted in all and by card.  A q=99 batch that only the second
    shard's image leaves the tables must raise one table-range error and
    leave no shard thread behind."""
    devs = ["cpu" if REHEARSE else "cuda:0"] * 2
    mesh = make_mesh(devices=devs)
    one = make_mesh(1, device=DEV)
    image = big["image"]
    nb_big = (image.shape[0] // 8) * (image.shape[1] // 8)
    k = sum(len(pipeline.sub_ranges(*tiled.block_range(nb_big, 2, r)))
            for r in range(2))
    nb = (corpus.shape[1] // 8) * (corpus.shape[2] // 8)
    per_path: dict = {}
    by_card: dict = {}
    shards: dict = {}
    seconds: dict = {}

    def run(label, fn, want):
        t0 = time.perf_counter()
        out = counted(f"local x2 {label}", fn, want, per_path)
        seconds[label] = round(time.perf_counter() - t0, 3)
        by_card[label] = conformance.launch_counts_by_card()
        shards[label] = mesh.last_run
        return out

    payload = big["exact"][:big["pay_end"]]
    for assemble in ("host", "device"):
        got = run(f"encode_tiled {assemble}", lambda: tiled.encode_tiled(
            image, 50, mesh=mesh, assemble=assemble),
            tiled_launches(k, True))
        if got != payload:
            fail(f"local_mesh: encode_tiled({assemble!r}) differs from the "
                 "oracle's stream without its trailer")
    fast_one = tiled.encode_tiled(image, 50, mesh=one, precision="fast")
    if run("encode_tiled fast", lambda: tiled.encode_tiled(
            image, 50, mesh=mesh, precision="fast"),
            tiled_launches(k, False)) != fast_one:
        fail("local_mesh: the fast tiled encode differs from one shard's")
    if run("compress_batch exact", lambda: pbatch.compress_batch(
            corpus, 50, mesh=mesh, block_index=True),
            doubled(ENCODE_EXACT)) != exact:
        fail("local_mesh: compress_batch exact differs from the oracle")
    if run("compress_batch fast", lambda: pbatch.compress_batch(
            corpus, 50, mesh=mesh, precision="fast", block_index=True),
            doubled(ENCODE_FAST)) != fast:
        fail("local_mesh: compress_batch fast differs from one card's")
    if run("compress_batch_sharded exact",
           lambda: pbatch.compress_batch_sharded(
               corpus, 50, mesh=mesh, precision="exact"),
           doubled(ENCODE_EXACT)) != [
               s[:container.parse_block_index(s, nb)[2]] for s in exact]:
        fail("local_mesh: compress_batch_sharded exact differs from the "
             "oracle")
    if run("compress_batch_sharded fast",
           lambda: pbatch.compress_batch_sharded(corpus, 50, mesh=mesh),
           doubled(ENCODE_FAST)) != codec.compress_batch(
               corpus, 50, precision="fast", block_index=False, device=DEV):
        fail("local_mesh: compress_batch_sharded fast differs from one "
             "card's")
    decoded = run("decompress_batch_sharded",
                  lambda: pbatch.decompress_batch_sharded(exact, mesh=mesh),
                  doubled(DECODE_KERNEL))
    oracle_px = np.stack([container.decompress(s) for s in exact])
    if decoded is None or not np.array_equal(decoded, oracle_px):
        fail("local_mesh: decompress_batch_sharded differs from "
             "container.decompress")
    if not REHEARSE:
        for label, cards in by_card.items():
            for kern, got in cards.items():
                if set(got) - {0} or sum(got.values()) != per_path[
                        f"local x2 {label}"][kern]:
                    fail(f"local_mesh[{label}]: {kern} counted {got} by "
                         "card, not all on card 0 or not the total")

    battery = conformance.contents(64, 64)
    refused = np.stack([battery["stripes"], battery["noise"]])
    before = threading.active_count()
    t0 = time.perf_counter()
    try:
        pbatch.compress_batch_sharded(refused, 99, mesh=mesh,
                                      precision="exact")
        fail("local_mesh: the q=99 batch was not refused")
    except pipeline.TableRangeError as e:
        refusal = str(e)
    refusal_s = time.perf_counter() - t0
    left = threading.active_count() - before
    if left or conformance.TABLE_RANGE not in refusal:
        fail(f"local_mesh: the refusal {refusal!r} left {left} threads")
    emit("local_mesh", devices=devs, block_ranges=k,
         checked=f"encode_tiled of the {image.shape[1]}x{image.shape[0]} "
         "image (host, device) == the oracle's stream without its trailer, "
         "fast == one shard's; compress_batch with the index exact == the "
         "oracle, fast == one card's; compress_batch_sharded exact == the "
         "oracle's payloads, fast == one card's; decompress_batch_sharded "
         f"== container.decompress {len(exact)}/{len(exact)} on the "
         "kernel (one entropy_decode launch a shard); a q=99 refusal on "
         "shard 1 raised once, no thread left",
         launches_by_path=per_path, launches_by_card=by_card,
         seconds=seconds, shard_times=shards, refusal=refusal,
         refusal_seconds=round(refusal_s, 3))
    return per_path


def phase_group_mesh(corpus: np.ndarray, big: dict, exact: list[bytes],
                     fast: list[bytes], want: dict) -> dict:
    """A local mesh in each process of a group (JAX's mesh over every
    process's devices): two gloo ranks of two shards each, all four on
    ``cuda:0`` (NCCL puts no two ranks on one card; four cards are
    ``scripts/torch_multicard.py``'s ``group_local``), the calls and bars
    of phase ``sharded``.  ``want``: :func:`sharded_want`."""
    device = "cpu" if REHEARSE else "cuda:0"
    t0 = time.perf_counter()
    results = spawn(sharded_rank, 2, backend="gloo", device=device,
                    per_rank=2, args=(big["image"], corpus, exact))
    secs = time.perf_counter() - t0
    per_path: dict = {}
    by_card: dict = {}
    rows = []
    for p, r in enumerate(results):
        label = f"gloo x2 x2 process {p}"
        if (r["size"], r["backend"]) != (4, "gloo") or [
                s for s, _ in r["shards"]] != [r["rank"], r["rank"] + 1]:
            fail(f"group_mesh[{label}]: shards {r['shards']} of a mesh of "
                 f"{r['size']} over {r['backend']}")
        check_sharded_rank("group_mesh", label, r, want, exact, fast)
        per_path[label] = r["counts"]
        by_card[label] = r["by_card"]
        rows.append({"process": p, "shards": r["shards"],
                     "rank_seconds": round(r["seconds"], 2),
                     "shard_times": r["shard_times"]})
    emit("group_mesh", ranks=rows, spawn_seconds=round(secs, 1),
         launches_by_path=per_path, launches_by_card=by_card,
         sha256_exact_streams=hashlib.sha256(
             b"".join(results[0]["batch_exact"])).hexdigest(),
         sha256_fast_streams=hashlib.sha256(
             b"".join(results[0]["batch_fast"])).hexdigest(),
         checked=f"every process of 2 gloo ranks x 2 shards on {device}: "
         f"encode_tiled of the {big['image'].shape[1]}x"
         f"{big['image'].shape[0]} image (host and device) == the oracle's "
         "stream without its trailer; compress_batch_sharded of the corpus "
         "== compress_batch's bytes (exact, fast, no trailer); "
         "compress_batch with the index == the corpus streams (both "
         "sha256); decompress_batch_sharded == decompress_batch; every "
         "kernel launched, on card 0")
    return per_path


def phase_stream(corpus: np.ndarray) -> dict:
    """``compress_stream`` over the corpus (chunk 8: six chunks and a tail
    of one) against ``compress_batch``, ``decompress_stream`` against
    ``decompress_batch``, and the double-buffered stream timed beside the
    same chunks encoded one after another."""
    chunk = 2 if REHEARSE else 8
    n = corpus.shape[0]
    k = -(-n // chunk)
    per_path: dict = {}
    fast = codec.compress_batch(corpus, 50, precision="fast", device=DEV)
    exact = codec.compress_batch(corpus, 50, device=DEV)
    got = counted(f"compress_stream chunk {chunk}", lambda: list(
        pstream.compress_stream(iter(corpus), 50, chunk=chunk, device=DEV)),
        {"encode2_pixels": (k,), "place": tuple(range(k, 2 * k + 1))},
        per_path)
    if got != fast:
        fail("stream: compress_stream differs from compress_batch")
    decoded = counted(f"decompress_stream chunk {chunk}", lambda: list(
        pstream.decompress_stream(iter(exact), chunk=chunk, device=DEV)),
        {"entropy_decode": (k,), "exact_inverse": (k,)}, per_path)
    ref = codec.decompress_batch(exact, device=DEV)
    if not all(np.array_equal(a, b) for a, b in zip(decoded, ref)) or len(
            decoded) != n:
        fail("stream: decompress_stream differs from decompress_batch")

    def one_after_another():
        out = []
        for i in range(0, n, chunk):
            part = corpus[i:i + chunk]
            count = len(part)
            part = np.concatenate([part, part[-1:].repeat(chunk - count, 0)])
            out += compress_batch_device(
                torch.from_numpy(part).to(DEV), 50, precision="fast",
                block_index=True, device=DEV)[:count]
        return out

    if one_after_another() != fast:
        fail("stream: the chunks one after another differ")
    reps = 1 if REHEARSE else 5
    stream_ms = host_ms(lambda: list(pstream.compress_stream(
        iter(corpus), 50, chunk=chunk, device=DEV)), reps)
    serial_ms = host_ms(one_after_another, reps)
    # the parts: the uploads alone (pageable, as one after another does
    # them; pinned on a side stream, as the stream does), the encodes of
    # chunks already on the card
    parts = [np.concatenate([corpus[i:i + chunk], corpus[n - 1:n].repeat(
        max(0, i + chunk - n), 0)]) for i in range(0, n, chunk)]
    on_card = [torch.from_numpy(p).to(DEV) for p in parts]
    split = {
        "upload_pageable_ms": host_ms(
            lambda: [torch.from_numpy(p).to(DEV) for p in parts], reps),
        "encode_on_card_ms": host_ms(lambda: [compress_batch_device(
            t, 50, precision="fast", block_index=True, device=DEV)
            for t in on_card], reps),
    }
    if DEV.type == "cuda":
        side = torch.cuda.Stream(DEV)
        pinned = [torch.empty(parts[0].shape, dtype=torch.uint8,
                              pin_memory=True) for _ in range(2)]

        def upload_pinned():
            for i, p in enumerate(parts):
                np.copyto(pinned[i % 2].numpy(), p)
                with torch.cuda.stream(side):
                    pinned[i % 2].to(DEV, non_blocking=True)
                side.synchronize()

        split["upload_pinned_side_stream_ms"] = host_ms(upload_pinned, reps)
    emit("stream", images=n, chunk=chunk, chunks=k,
         checked="compress_stream == compress_batch (fast, indexed); "
         "decompress_stream == decompress_batch",
         launches_by_path=per_path, double_buffered_ms=stream_ms,
         one_after_another_ms=serial_ms, parts=split,
         timing_note=f"host clock, median of {reps} after a warm one; "
         "no bar: shows whether the copy of chunk i+1 overlaps chunk i")
    return per_path


def host_entropy_split():
    """``scripts/torch_host_entropy_split.py`` as a module: the stage
    split of the host-entropy leg, shared with the script that compares
    two trees."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", "torch_host_entropy_split.py")
    spec = importlib.util.spec_from_file_location("torch_host_entropy_split",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_entropy_batch(corpus: np.ndarray, exact: list[bytes], nb: int,
                       reps: int) -> dict:
    """The host-entropy leg on a batch: the corpus's exact streams with
    their trailers cut, through ``decompress_batch`` in both precisions.
    Exact pixels must equal ``container.decompress``'s for every image,
    fast ones come within 0.01 dB PSNR of them (the fast-decode bar of
    ``main_path``); every image must take the host-entropy leg.  Records
    the bytes the leg uploads (the narrow form beside the (B, nb, 64)
    int32 one) and the leg's stages, each timed alone."""
    cut = [s[:container.parse_block_index(s, nb)[2]] for s in exact]
    oracle = [container.decompress(s) for s in cut]
    out = {}
    for precision in ("exact", "fast"):
        engine = Engine(precision, DEV)
        got = engine.decompress_batch(cut)
        stats = dict(engine.decode_stats)
        if stats != {"kernel": 0, "host_entropy": len(cut),
                     "host_decoder": 0}:
            fail(f"host_legs batch {precision}: legs {stats}")
        if precision == "exact":
            bad = [i for i, o in enumerate(oracle)
                   if not np.array_equal(got[i], o)]
            if bad:
                fail(f"host_legs batch exact: images {bad} differ from "
                     "container.decompress")
        else:
            worst = max(abs(psnr(corpus[i], got[i]) - psnr(corpus[i], o))
                        for i, o in enumerate(oracle))
            if not worst <= 0.01:
                fail(f"host_legs batch fast: PSNR {worst} dB from the "
                     "oracle's decode (> 0.01)")
            out["fast_vs_exact_decode_psnr_db"] = worst
        out[f"legs_{precision}"] = stats
    split = host_entropy_split()
    for precision in ("exact", "fast"):
        out[f"stages_{precision}"] = split.host_entropy_stages(
            cut, precision, DEV, reps)
    up = out["stages_exact"]
    ratio = up["upload_bytes"] / up["int32_form_bytes"]
    if up["form"] != "narrow" or ratio > 0.3:
        fail(f"host_legs batch: the upload is {up['upload_bytes']} bytes "
             f"({up['upload_dtypes']}), {ratio:.3f} of the int32 form")
    out["upload_bytes_over_int32_form"] = ratio
    return out


def phase_host_legs(corpus: np.ndarray, exact: list[bytes]) -> dict:
    """The two host legs of decode at 512x512, now through the C decoder:
    a stream without its trailer (host entropy) and one with a corrupt
    chunk (host decoder).  The first is held to the pure-Python cursor's
    pixels; the second to ``container.decompress`` (the host decoder,
    which decodes a TICX stream chunk by chunk), and its C decode without
    the trailer to the Python cursor's.  Each is timed (host clock,
    synchronised, median).  Then the host-entropy leg on the batch of all
    the corpus's streams without trailers (``host_entropy_batch``)."""
    reps = 1 if REHEARSE else 5
    nb = (corpus.shape[1] // 8) * (corpus.shape[2] // 8)
    pay_end = container.parse_block_index(exact[1], nb)[2]
    flipped = first_flip_that_fails(exact[2], nb)
    cases = {"host_entropy": exact[1][:pay_end], "host_decoder": flipped}
    out = {}
    for leg, data in cases.items():
        serial = data[:container.parse_block_index(data, nb)[2]] if (
            leg == "host_decoder") else data
        t0 = time.perf_counter()
        cursor = golden.decode_arrays(
            container.decompress_to_arrays(serial, use_native=False))
        python_secs = time.perf_counter() - t0
        if not np.array_equal(container.decompress(serial), cursor):
            fail(f"host_legs[{leg}]: the C decoder and the Python cursor "
                 "differ")
        oracle = cursor if leg == "host_entropy" else container.decompress(
            data)
        engine = Engine("exact", DEV)
        times, host = [], []
        for _ in range(reps + 1):
            sync()
            t0 = time.perf_counter()
            got = engine.decompress_batch([data])
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            alone = container.decompress(data)
            host.append((time.perf_counter() - t0) * 1e3)
        stats = dict(engine.decode_stats)
        if stats[leg] != 1:
            fail(f"host_legs: the {leg} stream took {stats}")
        if not (np.array_equal(got[0], oracle)
                and np.array_equal(alone, oracle)):
            fail(f"host_legs: {leg} pixels differ from the oracle's")
        out[leg] = {"decompress_batch_ms": float(np.median(times[1:])),
                    "container_decompress_ms": float(np.median(host[1:])),
                    "python_cursor_decode_s": round(python_secs, 3),
                    "legs": stats}
    out["batch"] = host_entropy_batch(corpus, exact, nb, reps)
    emit("host_legs", image=f"{corpus.shape[1]}x{corpus.shape[2]}",
         repeats=reps,
         note="decompress_batch = the engine's whole call (for the corrupt "
         "stream the kernel leg runs first); container_decompress = the C "
         "decoder and the float64 inverse transform on the host alone; "
         "python_cursor_decode = the pure-Python oracle, once; batch = "
         f"the {len(exact)} streams without trailers through the "
         "host-entropy leg, its stages each timed alone (host clock, "
         "synchronised, median): the C decodes on the pool, compaction, "
         "upload, widening, then exact_inverse and the pull (exact) or "
         "undo_dpcm + decode_blocks and unblockify + pull (fast)", **out)
    return out


def phase_conformance(corpus: np.ndarray) -> dict:
    """The conformance batteries of ``tinyimgcodec_tpu_torch/conformance.py``
    through the public entry points: the adversarial battery at 128x128
    and 512x512 (64x64 in a rehearsal) and the quality sweep of corpus
    images 0, 17 and 33 at q 10-90, exact (bytes == the oracle's) and fast
    (PSNR within 0.01 dB of the oracle's), all between one reset and one
    reading of the launch counters; every kernel must have run.  One line
    a battery; any failed check fails the run.  Returns the launches by
    path."""
    sizes = (64,) if REHEARSE else (128, 512)
    n_img = corpus.shape[0]
    picks = [0, 17 % n_img, 33 % n_img]
    per_path: dict = {}
    t_start = time.perf_counter()
    reset_counts()
    batteries = []
    for size in sizes:
        batteries.append(conformance.adversarial(DEV, size))
    t0 = time.perf_counter()
    rows = conformance.quality_sweep(
        corpus[picks], conformance.SWEEP_QUALITIES, DEV,
        precisions=("exact", "fast"),
        names=[f"corpus[{i}]" for i in picks])
    sweep_secs = time.perf_counter() - t0
    sync()
    per_path["conformance"] = counts()
    failed = []
    for size, bat in zip(sizes, batteries):
        names = conformance.failed_names(bat)
        failed += [f"{size}x{size} {n}" for n in names]
        emit("conformance", battery=f"adversarial {size}x{size}",
             qualities=bat["qualities"], checks=len(bat["checks"]),
             passed=len(bat["checks"]) - len(names), failed=names,
             need=bat["need"], caps=bat["caps"],
             ctas_past_window_q90=bat["ctas_past_window_q90"],
             launches=bat["launches"], seconds=bat["seconds"])
    bad_rows = [f"{r['image']} q{r['q']} {r['precision']}" for r in rows
                if not r["passed"]]
    failed += bad_rows
    emit("conformance", battery="quality_sweep", images=picks,
         qualities=list(conformance.SWEEP_QUALITIES), checks=len(rows),
         passed=len(rows) - len(bad_rows), failed=bad_rows,
         rows=[{k: r[k] for k in ("image", "q", "precision", "bytes", "cr",
                                  "psnr", "first_call_s", "run_s")}
               for r in rows],
         seconds=round(sweep_secs, 2),
         tolerance="exact: bytes equal to container.compress(..., "
         "block_index=True); fast: PSNR within 0.01 dB of the oracle's")
    if not REHEARSE:
        for k, v in per_path["conformance"].items():
            if v < 1:
                fail(f"conformance launched kernel {k} {v} times")
    emit("conformance", launches_by_path=per_path,
         seconds=round(time.perf_counter() - t_start, 1))
    if failed:
        fail(f"conformance: failed checks {failed}")
    return per_path


# What the bench phase launches: each of its four passes once eagerly,
# once to warm up on a side stream and once while its graph is captured.
# A replay of the graph runs the captured kernels without a wrapper call,
# so replays are not counted.
BENCH_LAUNCHES = {"exact_transform": (3,), "encode2_pixels": (3,),
                  "encode2_zz": (3,), "place": (6,), "entropy_decode": (3,)}


def phase_bench(corpus: np.ndarray, exact: list[bytes]) -> dict:
    """The passes ``torch_bench.py`` replays from CUDA graphs, at k=10 on
    the corpus: the encode pass fast and exact (row 3), the full decode of
    the exact streams (row 4) and the decode transform from their
    host-decoded coefficients (row 5).  Each raises unless the graph's
    output equals an eager pass's.  All between one reset and one reading
    of the launch counters.  Returns the launches by path."""
    k = 10
    t0 = time.perf_counter()
    arrays = [container.decompress_to_arrays(s, index_workers=1)
              for s in exact]

    def run():
        mps = {}
        for precision in ("fast", "exact"):
            mps[f"encode {precision}"] = torch_bench.bench_device(
                corpus, 50, precision, k=k, dev=DEV, reps=1)[0]
        mps["decode"] = torch_bench.bench_decode_entropy_device(
            exact, k=k, dev=DEV, reps=1)[0]
        mps["decode transform"] = torch_bench.bench_decode_device(
            arrays, k=k, dev=DEV, reps=1)[0]
        return mps

    per_path: dict = {}
    try:
        mps = counted("bench", run, BENCH_LAUNCHES, per_path)
    except Exception as e:
        fail(f"bench: {type(e).__name__}: {e}")
    emit("bench", k=k, mp_per_s=mps, graph_equals_eager=True,
         launches_by_path=per_path,
         seconds=round(time.perf_counter() - t0, 1))
    return per_path


def phase_kernels(corpus: np.ndarray, launched: dict, errs: dict,
                  streams: list[bytes], one_image: dict, place_times: dict,
                  encode1_image: dict) -> list:
    """Every kernel at the corpus shapes: time, plain time, bound, and the
    device time of every launch inside its wrapper.  ``streams``: the main
    path's exact corpus streams, for the decoder; ``one_image``,
    ``place_times``, ``encode1_image``: the times of ``encode2``, ``place``
    and ``encode1`` on one 4096x4096 image."""
    quality = 50
    reps = 1 if REHEARSE else 20
    tables = CodecTables.build(quality, DEV)
    blocks = blocks_of(corpus)
    n = blocks.shape[0]
    nb = n // corpus.shape[0]
    cap = -(-int(corpus.size * 4.0) // 32)
    zz, _, _ = exact_transform.exact_transform(blocks, tables)
    packed, meta, _ = encode2.encode2(zz, tables, nb, from_zz=True)
    sync()
    owned = int((((meta[0] & 31) + meta[1] + 31) >> 5).sum())
    table_bytes = 4 * (12 + 176 + 8)

    def row(name, source, replaces, count, err, ms, plain_ms, nbytes, ops,
            rate, library_ms=None, kernel_only_ms=None, **more):
        t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
        t_ops = ops / rate * 1e3
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": count, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "bytes": nbytes, "operations": ops,
            # the launches alone, where the wrapper's "ms" also holds a
            # zero fill of the output and small tensor operations
            "kernel_only_ms": kernel_only_ms, **more,
        }

    def kernel_only(launch, words, reps):
        """The launches alone into a zeroed buffer that is not filled
        again between repeats (ORing the same words twice changes
        nothing, so the work is the same)."""
        if DEV.type != "cuda":
            return None
        buf = torch.zeros(words, dtype=torch.int32, device=DEV)
        return time_ms(lambda: launch(buf), reps)

    out = []
    src = "tinyimgcodec_tpu_torch/csrc/"
    # exact_transform: 64 B in, 256 + 4 B out; 2 x 512 multiply-adds + 64
    # multiplies in float64 per block
    out.append(row(
        "exact_transform", src + "exact_transform.cu",
        "tinyimgcodec_tpu/ops/pallas_exact.py:34",
        launched["exact_transform"], errs["exact_transform"],
        time_ms(lambda: exact_transform.exact_transform(blocks, tables), reps),
        time_ms(lambda: exact_transform.exact_transform_plain(blocks, tables),
                max(1, reps // 4)),
        n * (64 + 260) + 2 * 64 * 8, n * (2 * 2 * 512 + 64), FP64_PER_S,
        device_split=device_split(
            lambda: exact_transform.exact_transform(blocks, tables), reps,
            "exact_transform_kernel"),
    ))
    # encode2 from coefficients: 256 B in, 224 + 8 B out; ~8 integer
    # operations per coefficient
    out.append(row(
        "encode2", src + "encode2.cu",
        "tinyimgcodec_tpu/ops/pallas_encode2.py:88",
        launched["encode2_zz"], errs["encode2"],
        time_ms(lambda: encode2.encode2(zz, tables, nb, from_zz=True), reps),
        time_ms(lambda: encode2.encode2_plain(zz, tables, nb, from_zz=True),
                max(1, reps // 4)),
        n * (256 + 232) + table_bytes, n * 64 * 8, FP32_PER_S,
        device_split=device_split(
            lambda: encode2.encode2(zz, tables, nb, from_zz=True), reps,
            "encode2_kernel"),
        one_image_4096x4096={"blocks": one_image["blocks"],
                             "ms": one_image["from_zz_ms"],
                             "bound_ms": one_image["from_zz_bound_ms"]},
    ))
    # encode2 from pixels: 64 B in, the 64x64 float32 product on top
    out.append(row(
        "encode2_pixels", src + "encode2.cu",
        "tinyimgcodec_tpu/ops/pallas_encode2.py:88",
        launched["encode2_pixels"], errs["encode2_pixels"],
        time_ms(lambda: encode2.encode2(blocks, tables, nb), reps),
        time_ms(lambda: encode2.encode2_plain(blocks, tables, nb),
                max(1, reps // 4)),
        n * (64 + 232) + table_bytes + 64 * 64 * 4,
        n * (2 * 64 * 64 + 64 * 8), FP32_PER_S,
        device_split=device_split(
            lambda: encode2.encode2(blocks, tables, nb), reps,
            "encode2_kernel"),
        one_image_4096x4096={"blocks": one_image["blocks"],
                             "ms": one_image["pixels_ms"],
                             "bound_ms": one_image["pixels_bound_ms"]},
    ))
    # place: reads the words the blocks own and the meta, writes the stream
    words = packed.to(torch.int64) & 0xFFFFFFFF
    idx = (meta[0].to(torch.int64) >> 5).reshape(n, 1) + torch.arange(
        place.ROW_WORDS, device=DEV).reshape(1, -1)
    keep = idx < cap
    idx_k, words_k = idx[keep], words[keep]
    acc = torch.zeros(cap, dtype=torch.int64, device=DEV)
    out.append(row(
        "place", src + "place.cu",
        "tinyimgcodec_tpu/ops/pallas_place.py:345 (also :211, :67)",
        launched["place"], errs["place"],
        time_ms(lambda: place.place(packed, meta, nb, cap), reps),
        time_ms(lambda: place.place_plain(packed, meta, nb, cap),
                max(1, reps // 4)),
        owned * 4 + n * 8 + cap * 4, owned, FP32_PER_S,
        library_ms=time_ms(
            lambda: acc.zero_().index_add_(0, idx_k, words_k), reps),
        kernel_only_ms=kernel_only(
            lambda buf: place.launch_kernel(packed, meta, buf), cap, reps),
        device_split=device_split(
            lambda: place.place(packed, meta, nb, cap), reps, "place_kernel"),
        # the pipeline's second try after a capacity overflow: 52 words a
        # block, nearly all of them zeros that the kernel stores
        retry_capacity={
            "capacity_words": n * 52,
            "ms": time_ms(lambda: place.place(packed, meta, nb, n * 52), reps),
            "bound_ms": (owned * 4 + n * 8 + n * 52 * 4)
            / MEM_BYTES_PER_S * 1e3},
        **place_times,
    ))
    # encode1 from block-major coefficients, on no pipeline path: 256 B in
    zz_bm = zz.T.contiguous()
    encode1_from_zz = {
        "ms": time_ms(
            lambda: encode1.encode1(zz_bm, tables, nb, from_zz=True), reps),
        "bound_ms": (n * (256 + 212) + table_bytes) / MEM_BYTES_PER_S * 1e3,
        "device_split": device_split(
            lambda: encode1.encode1(zz_bm, tables, nb, from_zz=True), reps,
            "encode1_kernel"),
        "one_image_4096x4096": {
            "blocks": encode1_image["blocks"],
            "ms": encode1_image["from_zz_ms"],
            "bound_ms": encode1_image["from_zz_bound_ms"]},
    }
    del zz_bm
    # encode1 from pixels (the form the v1 path feeds): 64 B in, 208 + 4 B
    # out per block, the 64x64 float32 product and ~8 integer operations a
    # coefficient
    out.append(row(
        "encode1", src + "encode1.cu",
        "tinyimgcodec_tpu/ops/pallas_encode.py:75",
        launched["encode1"], errs["encode1"],
        time_ms(lambda: encode1.encode1(blocks, tables, nb), reps),
        time_ms(lambda: encode1.encode1_plain(blocks, tables, nb),
                max(1, reps // 4)),
        n * (64 + 212) + table_bytes + 64 * 64 * 4,
        n * (2 * 64 * 64 + 64 * 8), FP32_PER_S,
        device_split=device_split(
            lambda: encode1.encode1(blocks, tables, nb), reps,
            "encode1_kernel"),
        one_image_4096x4096={"blocks": encode1_image["blocks"],
                             "ms": encode1_image["pixels_ms"],
                             "bound_ms": encode1_image["pixels_bound_ms"]},
        from_zz=encode1_from_zz,
    ))
    # stitch: reads the row words that hold bits and the counts, writes
    # the stream
    words1, bits1, _ = encode1.encode1(blocks, tables, nb)
    row_words = int(((bits1 + 31) >> 5).sum())
    out.append(row(
        "stitch", src + "stitch.cu",
        "tinyimgcodec_tpu/ops/pallas_stitch.py:42",
        launched["stitch"], errs["stitch"],
        time_ms(lambda: stitch.stitch(words1, bits1, nb, cap), reps),
        time_ms(lambda: stitch.stitch_plain(words1, bits1, nb, cap),
                max(1, reps // 4)),
        row_words * 4 + n * 4 + cap * 4, row_words, FP32_PER_S,
        kernel_only_ms=kernel_only(
            lambda buf: stitch.launch_kernels(words1, bits1, nb, buf),
            cap, reps),
        device_split=device_split(
            lambda: stitch.stitch(words1, bits1, nb, cap), reps,
            "stitch_kernel"),
        # the pipeline's second try after a capacity overflow: 52 words a
        # block, nearly all of them zeros that the kernel stores
        retry_capacity={
            "capacity_words": n * 52,
            "ms": time_ms(lambda: stitch.stitch(words1, bits1, nb, n * 52),
                          reps),
            "bound_ms": (row_words * 4 + n * 4 + n * 52 * 4)
            / MEM_BYTES_PER_S * 1e3,
            "device_split": device_split(
                lambda: stitch.stitch(words1, bits1, nb, n * 52), reps,
                "stitch_kernel")},
    ))
    # entropy_decode: reads the stream words, the chunk arrays and the
    # tables, writes 256 B a block; per symbol a table lookup, the value
    # and the cursor (counted as 24 operations).  Once on the main path's
    # exact streams (q=50), once on denser ones (q=90).
    def decode_row(streams):
        prep, args, dtab = decode_inputs(streams)
        nb_total = prep["nb_total"]
        zz_d, ok_d = entropy_decode.entropy_decode_chunks(
            *args, nb_total, dtab)
        sync()
        chunks = ok_d.shape[0]
        per_block = (zz_d[:, 1:] != 0).sum(dim=1) + 2  # DC, ACs, EOB
        symbols = int(per_block.sum())
        # the longest serial chain: symbols of the chunk that has most
        ends = torch.cumsum(per_block, 0)[
            (args[3] + args[2] - 1).to(torch.int64)]
        longest = int(torch.diff(ends, prepend=ends.new_zeros(1)).max())
        nbytes = (args[0].numel() * 4 + 5 * 4 * chunks
                  + (dtab.huffman.numel() + dtab.lookup.numel()) * 4
                  + nb_total * 256 + chunks)
        # the launch alone into a zeroed buffer that is not zeroed again
        # between repeats (the same values land in the same places)
        zz_buf = torch.zeros((nb_total, 64), dtype=torch.int32, device=DEV)
        ok_buf = torch.empty((chunks,), dtype=torch.bool, device=DEV)
        return {
            "ms": time_ms(lambda: entropy_decode.entropy_decode_chunks(
                *args, nb_total, dtab), reps),
            "kernel_only_ms": None if DEV.type != "cuda" else time_ms(
                lambda: entropy_decode.launch_kernel(
                    args[0], args[1:], dtab, zz_buf, ok_buf), reps),
            "device_split": device_split(
                lambda: entropy_decode.entropy_decode_chunks(
                    *args, nb_total, dtab), reps, "entropy_decode_kernel"),
            "bytes": nbytes, "operations": symbols * 24,
            "bound_ms": max(nbytes / MEM_BYTES_PER_S,
                            symbols * 24 / FP32_PER_S) * 1e3,
            "chunks": chunks, "stream_words": int(args[0].numel()),
            "symbols": symbols, "longest_chunk_symbols": longest,
            "launch_shape": list(entropy_decode.launch_shape(
                chunks, args[0].numel())),
        }, (args, nb_total, dtab)

    q50, (args, nb_total, dtab) = decode_row(streams)
    q90, _ = decode_row(codec.compress_batch(corpus, 90, precision="fast",
                                             device=DEV))
    out.append(row(
        "entropy_decode", src + "entropy_decode.cu",
        "tinyimgcodec_tpu/ops/entropy_decode.py:267 (an XLA program in the "
        "JAX package, no Pallas kernel)",
        launched["entropy_decode"], errs["entropy_decode"], q50["ms"],
        time_ms(lambda: entropy_decode.entropy_decode_chunks_plain(
            *args, nb_total, dtab), 1),
        q50["bytes"], q50["operations"], FP32_PER_S,
        kernel_only_ms=q50["kernel_only_ms"],
        device_split=q50["device_split"],
        launch_shape=q50["launch_shape"], symbols=q50["symbols"],
        longest_chunk_symbols=q50["longest_chunk_symbols"], q90=q90,
    ))
    # exact_inverse: the decoded rows of the main path's exact streams to
    # the cropped pixels; 256 B in and 64 B out a block, the tables; two
    # 8x8x8 products of a multiply and an add each and 64 multiplies of
    # the dequantization in float64 a block
    zz_e = entropy_decode.entropy_decode_chunks(*args, nb_total, dtab)[0]
    zz_e = zz_e.reshape(corpus.shape[0], nb, 64)
    h, w = corpus.shape[1:]
    out.append(row(
        "exact_inverse", src + "exact_inverse.cu",
        "none: the JAX package's decode transform is an XLA program "
        "(tinyimgcodec_tpu/ops/transform.py: undo_dpcm, decode_blocks, "
        "unblockify)",
        launched["exact_inverse"], errs["exact_inverse"],
        time_ms(lambda: exact_inverse.exact_inverse(zz_e, h, w, dtab), reps),
        time_ms(lambda: exact_inverse.exact_inverse_plain(zz_e, h, w, dtab),
                max(1, reps // 4)),
        n * (256 + 64) + 3 * 64 * 8, n * (2 * 2 * 512 + 64), FP64_PER_S,
        device_split=device_split(
            lambda: exact_inverse.exact_inverse(zz_e, h, w, dtab), reps,
            "exact_inverse_kernel"),
        flagged=int(exact_inverse.exact_inverse(zz_e, h, w, dtab)[1]),
    ))
    # symbol_stats at the auto-table cell's shape: one 512x512 image's
    # coefficients (1 MB read once, the counts written once); about 20
    # integer operations a coefficient, far under any bound
    zz_one = [zz[:, :nb].contiguous()]
    out.append(row(
        "symbol_stats", src + "symbol_stats.cu",
        "none: the JAX package counts the symbols on the host "
        "(tinyimgcodec_tpu/engine.py:423, huffman.symbol_counts and "
        "block_bit_counts)",
        launched["symbol_stats"], errs["symbol_stats"],
        time_ms(lambda: symbol_stats.stats_buffer(zz_one), reps),
        time_ms(lambda: symbol_stats.stats_buffer([zz_one[0].cpu()]),
                max(1, reps // 4)),
        nb * 64 * 4 + symbol_stats.WORDS * 8, nb * 64 * 20, FP32_PER_S,
        image_blocks=nb,
        with_pull_ms=time_ms(lambda: symbol_stats.symbol_stats(zz_one),
                             reps),
        device_split=device_split(
            lambda: symbol_stats.stats_buffer(zz_one), reps,
            "symbol_stats_kernel"),
    ))
    return out


def auto_table_breakdown(img: np.ndarray, stage) -> None:
    """Where one exact auto-table encode of a 512x512 image spends its
    time: the steps of ``Engine._compress_auto_table``, each timed alone
    with ``stage`` (host clock, synchronised, median)."""
    from tinyimgcodec_tpu_torch.bitstream import BitWriter, concat_bit_payload
    quality = 50
    nb = img.size // 64
    tables = CodecTables.build(quality, DEV)

    def coefficients():
        blocks = transform.blockify(torch.from_numpy(img[None].copy()).to(
            DEV)).reshape(nb, 64)
        return exact_coefficients(blocks, tables)

    zz = coefficients()
    zz_np = zz.cpu().numpy()
    dc = np.diff(zz_np[0], prepend=np.int32(0)).astype(np.int32)
    ac = np.ascontiguousarray(zz_np[1:].T)

    counts = huffman.symbol_counts(dc, ac)
    spec = huffman.build_huffman_spec_from_counts(*counts)
    run_tables = CodecTables.from_spec(spec, quality, DEV)
    packed, meta, over = encode2.encode2(zz, run_tables, nb, from_zz=True)

    def encode2_place(packed, meta, over):
        words, _, total, _ = pipeline.place_words(packed, meta, over, nb,
                                                  nb * 8)
        return pipeline.stream_bytes(words, total), total

    payload, total = encode2_place(packed, meta, over)
    arrays = golden.CodecArrays(height=img.shape[0], width=img.shape[1],
                                quality=quality, dc=dc, ac=ac)

    def assemble():
        w = BitWriter()
        w.write_bytes(container.make_header(arrays, custom_table=True))
        container.write_huffman_table(w, spec.string_tables())
        data = concat_bit_payload(w.to_bytes(), w.bit_length(), payload,
                                  total)
        return data + container.make_block_index(
            meta[0].cpu().numpy().astype(np.int64))

    emit("auto_table_breakdown", image=list(img.shape), quality=quality,
         note="steps of one exact auto-table compress, each timed alone "
         "(host clock, synchronised, median); coefficients = upload + "
         "blockify + exact_transform (it settles its flagged blocks); "
         "symbol_stats = the histograms and block maxima on the card and "
         "their pull, the compress's path; pull_coefficients, "
         "symbol_counts and block_bit_counts = the host route's steps; "
         "then the Huffman tables; encode2_place = both kernels + the "
         "pull of status, total and stream",
         compress_ms=stage(lambda: codec.compress(
             img, quality, auto_generate_huffman_table=True, device=DEV)),
         coefficients_ms=stage(coefficients),
         pull_coefficients_ms=stage(lambda: zz.cpu().numpy()),
         symbol_stats_ms=stage(lambda: symbol_stats.symbol_stats([zz])),
         symbol_counts_ms=stage(lambda: huffman.symbol_counts(dc, ac)),
         huffman_tables_ms=stage(
             lambda: huffman.build_huffman_spec_from_counts(*counts)),
         block_bit_counts_ms=stage(
             lambda: huffman.block_bit_counts(dc, ac, spec).max()),
         codec_tables_from_spec_ms=stage(
             lambda: CodecTables.from_spec(spec, quality, DEV)),
         encode2_place_ms=stage(lambda: encode2_place(
             *encode2.encode2(zz, run_tables, nb, from_zz=True))),
         assemble_ms=stage(assemble))


def decode_stages(streams: list[bytes], reps: int) -> dict:
    """Where an exact decode of ``streams`` (uniform, TICX-indexed)
    spends its time: each stage alone, host clock around a synchronised
    call, median of ``reps``."""
    prep, args, dtab = decode_inputs(streams)
    h, w, quality = prep["shape"]
    b = len(streams)
    zz, _ = entropy_decode.entropy_decode_chunks(*args, prep["nb_total"],
                                                 dtab)
    zz = zz.reshape(b, -1, 64)
    pixels, flagged = exact_inverse.exact_inverse(zz, h, w, dtab)
    return {
        "prepare_batch_host_ms": host_ms(
            lambda: entropy_decode.prepare_batch(streams), reps),
        "upload_words_and_chunks_ms": host_ms(
            lambda: decode_inputs(streams), reps),
        "entropy_decode_ms": host_ms(
            lambda: entropy_decode.entropy_decode_chunks(
                *args, prep["nb_total"], dtab), reps),
        "exact_inverse_ms": host_ms(
            lambda: exact_inverse.exact_inverse(zz, h, w, dtab), reps),
        "pull_pixels_ms": host_ms(lambda: pixels.cpu(), reps),
        "flagged_blocks": int(flagged),
        "blocks": int(zz.shape[0] * zz.shape[1]),
        "stream_words": int(args[0].numel()),
        "chunks": int(args[1].numel()),
    }


def phase_timing(corpus: np.ndarray, streams: list[bytes],
                 auto: list[bytes]) -> None:
    """End-to-end corpus pass, warm: from host memory and from the card;
    the decode pass of the corpus streams back to pixels on the host; the
    auto-table pass (one ``compress`` an image) and the decode of its
    streams (``auto``)."""
    reps = 1 if REHEARSE else 5
    mp = corpus.size / 1e6
    staged = torch.from_numpy(corpus).to(DEV)
    res = {}
    for precision in ("exact", "fast"):
        for label, src in (("from_host", corpus), ("on_device", staged)):
            times = []
            for _ in range(reps + 1):
                sync()
                t0 = time.perf_counter()
                codec.compress_batch(src, 50, precision=precision, device=DEV)
                sync()
                times.append((time.perf_counter() - t0) * 1e3)
            ms = float(np.median(times[1:]))
            res[f"{precision}_{label}_ms"] = ms
            res[f"{precision}_{label}_MP_per_s"] = mp / ms * 1e3
    def stage(fn):
        times = []
        for _ in range(reps + 1):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times[1:]))

    # the fast pass through the v1 kernels beside the v2 pass above (no
    # block index: v1 returns no per-block offsets), and the decode pass
    for label, version in (("fast_v2_noindex", "v2"),
                           ("fast_v1_noindex", "v1")):
        ms = stage(lambda: compress_batch_device(
            staged, 50, precision="fast", device=DEV, version=version))
        res[f"{label}_on_device_ms"] = ms
        res[f"{label}_on_device_MP_per_s"] = mp / ms * 1e3
    for precision in ("exact", "fast"):
        ms = stage(lambda: codec.decompress_batch(
            streams, precision=precision, device=DEV))
        res[f"decode_{precision}_ms"] = ms
        res[f"decode_{precision}_MP_per_s"] = mp / ms * 1e3
    # auto-table encode: one compress call an image (tables are per image)
    for precision in ("exact", "fast"):
        ms = stage(lambda: [codec.compress(
            im, 50, auto_generate_huffman_table=True, precision=precision,
            device=DEV) for im in corpus])
        res[f"auto_table_{precision}_from_host_ms"] = ms
        res[f"auto_table_{precision}_from_host_MP_per_s"] = mp / ms * 1e3
    # the auto-table streams back to pixels (kernel leg, a table of its own
    # per stream: decoded one call a stream)
    ms = stage(lambda: [codec.decompress(d, device=DEV) for d in auto])
    res["auto_table_decode_exact_ms"] = ms
    res["auto_table_decode_exact_MP_per_s"] = mp / ms * 1e3
    auto_table_breakdown(corpus[0], stage)

    # where an exact pass spends its time: each stage alone, host clock
    # around a synchronised call, median of `reps`
    tables = CodecTables.build(50, DEV)
    nb = (corpus.shape[1] // 8) * (corpus.shape[2] // 8)
    blocks = transform.blockify(staged).reshape(-1, 64)
    zz, flags, _ = exact_transform.exact_transform(blocks, tables)
    packed, meta, _ = encode2.encode2(zz, tables, nb, from_zz=True)
    cap = -(-int(corpus.size * 4.0) // 32)
    stream, _, total, _ = place.place(packed, meta, nb, cap)
    nwords = -(-int(total) // 32)  # what a pass pulls, not the capacity
    breakdown = {
        "upload_ms": stage(lambda: torch.from_numpy(corpus).to(DEV)),
        "blockify_ms": stage(
            lambda: transform.blockify(staged).reshape(-1, 64)),
        "exact_transform_ms": stage(
            lambda: exact_transform.exact_transform(blocks, tables)),
        "exact_coefficients_ms": stage(
            lambda: exact_coefficients(blocks, tables)),
        "encode2_from_zz_ms": stage(
            lambda: encode2.encode2(zz, tables, nb, from_zz=True)),
        "encode2_pixels_ms": stage(
            lambda: encode2.encode2(blocks, tables, nb)),
        "place_ms": stage(lambda: place.place(packed, meta, nb, cap)),
        "pull_stream_and_offsets_ms": stage(
            lambda: (stream[:nwords].cpu(), meta[0].cpu())),
        "flagged_blocks": int(flags.sum()),
        "blocks": int(flags.numel()),
    }
    emit("breakdown", note="stages of one corpus pass, each timed alone "
         "(host clock, synchronised); exact_coefficients = exact_transform "
         "+ pull of the flags + float64 host recompute of the flagged "
         "blocks + patch", **breakdown)
    decode_breakdown = decode_stages(streams, reps)
    emit("decode_breakdown", note="stages of one exact decode pass of the "
         "corpus streams, each timed alone (host clock, synchronised); "
         "upload_words_and_chunks includes prepare_batch; exact_inverse = "
         "the one kernel from the rows to the cropped pixels, its flagged "
         "blocks settled on the card", **decode_breakdown)
    emit("timing", megapixels=mp, repeats=reps,
         note="host clock around compress_batch incl. the pull of the "
              "streams and the per-image slicing; on_device skips only "
              "the upload of the pixels; decode_* = decompress_batch of the "
              "exact corpus streams incl. prepare_batch on the host and "
              "the pull of the pixels; auto_table_* = one compress(..., "
              "auto_generate_huffman_table=True) an image, 49 calls, and "
              "one decompress a stream", **res)


def main() -> None:
    info = phase_device()
    phase_build()
    if SANITIZE_ONLY:
        emit("sanitize", corrupt=check_corrupt(*small_indexed_streams()))
        sync()
        print(json.dumps({"sanitize_corrupt": "done"}), flush=True)
        return
    corpus = synthetic_corpus(5, 64) if REHEARSE else synthetic_corpus(49, 512)
    errs = phase_kernel_check(corpus)
    shapes_err, one_image = phase_encode2_shapes(corpus)
    errs["encode2"] = max(errs["encode2"], shapes_err)
    place_err, place_times = phase_place_shapes(corpus)
    errs["place"] = max(errs["place"], place_err)
    encode1_err, encode1_image = phase_encode1_shapes(corpus)
    errs["encode1"] = max(errs["encode1"], encode1_err)
    errs["exact_transform"] = max(errs["exact_transform"],
                                  phase_exact_shapes(corpus))
    errs["stitch"] = max(errs["stitch"], phase_stitch_shapes(corpus))
    errs["entropy_decode"] = phase_decode_check(corpus)
    errs["exact_inverse"] = phase_inverse_check(corpus)
    launched, exact_streams, fast_streams = phase_main_path(corpus)
    auto_paths, auto_err, auto_streams = phase_auto_table(corpus)
    errs["encode2"] = max(errs["encode2"], auto_err)
    big = phase_tiled()
    words_paths = phase_encode_to_words(corpus, exact_streams, fast_streams,
                                        big)
    want = sharded_want(corpus, big, exact_streams)
    sharded_paths = phase_sharded(corpus, big, exact_streams, fast_streams,
                                  want)
    local_paths = phase_local_mesh(corpus, big, exact_streams, fast_streams)
    group_paths = phase_group_mesh(corpus, big, exact_streams, fast_streams,
                                   want)
    stream_paths = phase_stream(corpus)
    phase_host_legs(corpus, exact_streams)
    conformance_paths = phase_conformance(corpus)
    bench_paths = phase_bench(corpus, exact_streams)
    # the later slices' paths count with the round trip's
    for paths in (auto_paths, big["per_path"], words_paths, sharded_paths,
                  local_paths, group_paths, stream_paths, conformance_paths,
                  bench_paths):
        for c in paths.values():
            for k in launched:
                launched[k] += c[k]
    kernels = phase_kernels(corpus, launched, errs, exact_streams, one_image,
                            place_times, encode1_image)
    phase_timing(corpus, exact_streams, auto_streams)
    emit("done", seconds=round(time.perf_counter() - T_START, 1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(info, flush=True)
    if REHEARSE:
        print(json.dumps({"ok": False, "rehearsal": True}))
        sys.exit(1)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)


if __name__ == "__main__":
    main()
