#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the six CUDA kernels from ``tinyimgcodec_tpu_torch/csrc`` with
``nvcc``, holds each against its plain PyTorch version on the card, drives
the port's main path -- the round trip: ``compress_batch`` of a 49 x 512 x
512 corpus (exact, fast, and fast through the v1 kernels), one odd-shaped
``compress``, then ``decompress_batch`` / ``decompress`` of those streams
-- through the public entry points, checks the bytes and the pixels against
the float64 host oracle, shows from the launch counters that the path went
through the kernels and from the engine's counters which decode leg took
each image, and times every kernel at the corpus shapes beside its plain
version and its bound.

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

import json
import os
import re
import shutil
import signal
import struct
import subprocess
import sys
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


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg: str) -> None:
    print(json.dumps({"phase": "failed", "error": msg}), flush=True)
    sys.exit(1)


if not REHEARSE and not torch.cuda.is_available():
    print("chip_smoke: no CUDA device available", file=sys.stderr)
    sys.exit(2)

import tinyimgcodec_tpu_torch as codec  # noqa: E402
from tinyimgcodec_tpu_torch import container  # noqa: E402
from tinyimgcodec_tpu_torch.corpus import synthetic_corpus  # noqa: E402
from tinyimgcodec_tpu_torch.device import card_info  # noqa: E402
from tinyimgcodec_tpu_torch.engine import (  # noqa: E402
    Engine, _host_decode_blocks,
)
from tinyimgcodec_tpu_torch.metrics import psnr  # noqa: E402
from tinyimgcodec_tpu_torch.ops import (  # noqa: E402
    _build, encode1, encode2, entropy_decode, exact_transform, place, stitch,
    transform,
)
from tinyimgcodec_tpu_torch.pipeline import (  # noqa: E402
    _host_zz64, compress_batch_device, exact_coefficients,
)
from tinyimgcodec_tpu_torch.tables import (  # noqa: E402
    CodecTables, DecodeTables,
)

DEV = torch.device("cpu" if REHEARSE else "cuda")
KERNEL_MODULES = {
    "exact_transform": exact_transform, "encode2": encode2, "place": place,
    "encode1": encode1, "stitch": stitch, "entropy_decode": entropy_decode,
}
CHUNK_KEYS = ("chunk_start", "chunk_blocks", "chunk_block_base",
              "chunk_end_lo", "chunk_end_hi")


def sync() -> None:
    if DEV.type == "cuda":
        torch.cuda.synchronize()


def reset_counts() -> None:
    for m in KERNEL_MODULES.values():
        m.launches = 0
    encode2.launches_by_input = {"pixels": 0, "zz": 0}


def counts() -> dict:
    out = {k: m.launches for k, m in KERNEL_MODULES.items()}
    out["encode2_pixels"] = encode2.launches_by_input["pixels"]
    out["encode2_zz"] = encode2.launches_by_input["zz"]
    return out


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
    prep = entropy_decode.prepare_batch(streams)
    if prep is None:
        return None
    tables = DecodeTables.build(prep["shape"][2], prep["scaled_dct"], DEV,
                                huffman=prep["tables"])
    args = [torch.from_numpy(prep["words"].view(np.int32)).to(DEV)] + [
        torch.from_numpy(prep[k]).to(DEV) for k in CHUNK_KEYS]
    return prep, args, tables


# ---------------------------------------------------------------- phases


def phase_device() -> str:
    info = "cpu rehearsal" if REHEARSE else card_info()
    emit("device", card=info, torch=torch.__version__,
         cuda=torch.version.cuda,
         kind=None if REHEARSE else torch.cuda.get_device_name(0))
    return info


def phase_build() -> None:
    if REHEARSE:
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
            "spilling": [ln for ln in lines if "spill stores" in ln
                         and not ln.startswith("0 bytes stack frame, "
                                               "0 bytes spill stores")],
        }
    emit("build", seconds=round(secs, 2), ptxas=usage)


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
            "place": 0, "encode1": 0, "stitch": 0}
    report = []
    for label, images, quality in (("smooth", smooth, 50),
                                   ("noise", noise, 90),
                                   ("corpus", corpus, 50)):
        nb = (images.shape[1] // 8) * (images.shape[2] // 8)
        tables = CodecTables.build(quality, DEV)
        blocks = blocks_of(images)
        n = blocks.shape[0]
        # -- exact_transform: coefficients and flags, bit for bit ---------
        zz_k, fl_k = exact_transform.exact_transform(blocks, tables)
        zz_p, fl_p = exact_transform.exact_transform_plain(blocks, tables)
        sync()
        coef_diff = int((zz_k != zz_p).sum())
        flag_diff = int((fl_k != fl_p).sum())
        errs["exact_transform"] = max(
            errs["exact_transform"],
            int((zz_k.to(torch.int64) - zz_p.to(torch.int64)).abs().max()),
        )
        # a disagreement is tolerated only inside blocks that one side
        # flags, and only if the host recompute then settles both alike
        either = (fl_k != 0) | (fl_p != 0)
        if int(((zz_k != zz_p).any(dim=0) & ~either).sum()):
            fail(f"exact_transform[{label}]: unflagged coefficients differ")
        idx = torch.nonzero(either).reshape(-1)
        fixed = _host_zz64(blocks[idx].cpu().numpy(), quality).astype(np.int32)
        zz_fix = zz_k.clone()
        zz_fix[:, idx] = torch.from_numpy(fixed.T.copy()).to(DEV)
        gold = _host_zz64(blocks.cpu().numpy(), quality).astype(np.int32)
        if not np.array_equal(zz_fix.T.cpu().numpy(), gold):
            fail(f"exact_transform[{label}]: differs from the float64 "
                 "oracle after the flagged blocks are recomputed")
        # -- encode2 from coefficients: rows, meta, overflow equal --------
        pk, mk, ok_ = encode2.encode2(zz_fix, tables, nb, from_zz=True)
        pp, mp, op = encode2.encode2_plain(zz_fix, tables, nb, from_zz=True)
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
        zz_bm = zz_fix.T.contiguous()  # block-major (N, 64)
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
        report.append({
            "case": label, "shape": list(images.shape), "quality": quality,
            "blocks": n,
            "exact_coef_diff": coef_diff, "exact_flag_diff": flag_diff,
            "flagged": int(either.sum()), "fast_tie_bar": bar,
            "total_bits": int(sk[2]),
        })
    emit("kernel_check", cases=report,
         tolerance={"exact_transform": "equal (flag disagreements counted; "
                    "equal to the float64 oracle after host recompute)",
                    "encode2 from_zz": "equal", "place": "equal",
                    "encode1 from_zz": "equal", "stitch": "equal, at a "
                    "roomy capacity, at the exact one and one word short "
                    "(status 2 only there); stream == encode2 + place",
                    "encode1 pixels": "equal to the plain entropy coding "
                    "of the shared transform kernel's coefficients",
                    "encode2 pixels": "|step| <= 1 on <= 1e-4 of "
                    "coefficients, each within 1e-3 of a tie"})
    return errs


def kernel_vs_plain_decode(label: str, streams) -> tuple:
    """Entropy decode of the streams by the kernel and by the plain
    version on the same tensors: (prep, ok as numpy, the kernel's zz,
    the largest |kernel - plain| over zz and ok).  Fails the run unless
    ``zz`` and ``ok`` are equal bit for bit."""
    got = decode_inputs(streams)
    if got is None:
        fail(f"entropy_decode[{label}]: prepare_batch refused the batch")
    prep, args, tables = got
    zk, ok_k = entropy_decode.entropy_decode_chunks(
        *args, prep["nb_total"], tables)
    zp, ok_p = entropy_decode.entropy_decode_chunks_plain(
        *args, prep["nb_total"], tables)
    sync()
    err = max_abs_diff((zk, zp), (ok_k, ok_p))
    if not (eq(zk, zp) and eq(ok_k, ok_p)):
        fail(f"entropy_decode[{label}]: kernel and plain version differ "
             f"(zz {int((zk != zp).sum())}, ok {int((ok_k != ok_p).sum())}, "
             f"max |difference| {err})")
    return prep, ok_k.cpu().numpy(), zk, err


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
    cases = [
        ("corpus q50", codec.compress_batch(corpus, 50, precision="fast",
                                            device=DEV)),
        ("corpus q90", codec.compress_batch(corpus, 90, precision="fast",
                                            device=DEV)),
        ("odd 61x83", codec.compress_batch(odd, 50, device=DEV)),
        ("stride 16", small),
        ("dynamic table", [dyn, dyn]),
    ]
    for label, streams in cases:
        prep, ok, zz, err = kernel_vs_plain_decode(label, streams)
        worst = max(worst, err)
        if not ok.all():
            fail(f"entropy_decode[{label}]: valid chunks failed validation")
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
    worst = max(worst, corrupt["max_abs_err"])
    emit("decode_check", cases=report, corrupt=corrupt,
         sanitizer=run_sanitizer(),
         tolerance="zz and ok equal bit for bit; valid streams: all chunks "
         "ok and coefficients equal to the host decoder's; corrupt "
         "streams: exactly the hit chunks fail, in both")
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
DECODE_KERNEL = {"entropy_decode": (1,)}


def phase_main_path(corpus: np.ndarray) -> tuple[dict, list[bytes]]:
    """The round trip through the public entry points on the corpus:
    encode in both precisions and through the v1 kernels, decode on the
    device; each path between a reset and a reading of the launch
    counters.  Returns the counts summed over the paths and the exact
    streams."""
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
                           DECODE_KERNEL, per_path)
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
         {"kernel": 0, "host_entropy": 4, "host_decoder": 0}, {}),
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
    # kernel must have been launched by one of them
    launched = {k: sum(c[k] for c in per_path.values())
                for k in next(iter(per_path.values()))}
    if not REHEARSE:
        for k, v in launched.items():
            if v < 1:
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
         first_pass_seconds=round(secs, 3),
         first_decode_seconds=round(decode_secs, 3),
         check_seconds=round(time.perf_counter() - t0, 1))
    return launched, exact


def phase_kernels(corpus: np.ndarray, launched: dict, errs: dict,
                  streams: list[bytes]) -> list:
    """Every kernel at the corpus shapes: time, plain time, bound.
    ``streams``: the main path's exact corpus streams, for the decoder."""
    quality = 50
    reps = 1 if REHEARSE else 20
    tables = CodecTables.build(quality, DEV)
    blocks = blocks_of(corpus)
    n = blocks.shape[0]
    nb = n // corpus.shape[0]
    cap = -(-int(corpus.size * 4.0) // 32)
    zz, _ = exact_transform.exact_transform(blocks, tables)
    packed, meta, _ = encode2.encode2(zz, tables, nb, from_zz=True)
    sync()
    owned = int((((meta[0] & 31) + meta[1] + 31) >> 5).sum())
    table_bytes = 4 * (12 + 176 + 8)

    def row(name, source, replaces, count, err, ms, plain_ms, nbytes, ops,
            rate, library_ms=None, kernel_only_ms=None):
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
            "kernel_only_ms": kernel_only_ms,
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
    ))
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
    ))
    # entropy_decode: reads the stream words, the chunk arrays and the
    # tables, writes 256 B a block; per symbol a length search of at most
    # 16 compares plus the value (counted as 24 operations)
    prep, args, dtab = decode_inputs(streams)
    nb_total = prep["nb_total"]
    zz_d, ok_d = entropy_decode.entropy_decode_chunks(*args, nb_total, dtab)
    sync()
    symbols = int((zz_d[:, 1:] != 0).sum()) + 2 * nb_total
    zz_buf = torch.zeros((nb_total, 64), dtype=torch.int32, device=DEV)
    ok_buf = torch.empty((ok_d.shape[0],), dtype=torch.uint8, device=DEV)
    out.append(row(
        "entropy_decode", src + "entropy_decode.cu",
        "tinyimgcodec_tpu/ops/entropy_decode.py:267 (an XLA program in the "
        "JAX package, no Pallas kernel)",
        launched["entropy_decode"], errs["entropy_decode"],
        time_ms(lambda: entropy_decode.entropy_decode_chunks(
            *args, nb_total, dtab), reps),
        time_ms(lambda: entropy_decode.entropy_decode_chunks_plain(
            *args, nb_total, dtab), 1),
        args[0].numel() * 4 + 5 * 4 * ok_d.shape[0] + dtab.huffman.numel() * 4
        + nb_total * 256 + ok_d.shape[0],
        symbols * 24, FP32_PER_S,
        kernel_only_ms=None if DEV.type != "cuda" else time_ms(
            lambda: entropy_decode.launch_kernel(
                args[0], args[1:], dtab, zz_buf, ok_buf), reps),
    ))
    return out


def phase_timing(corpus: np.ndarray, streams: list[bytes]) -> None:
    """End-to-end corpus pass, warm: from host memory and from the card;
    and the decode pass of the corpus streams back to pixels on the host."""
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

    # where an exact pass spends its time: each stage alone, host clock
    # around a synchronised call, median of `reps`
    tables = CodecTables.build(50, DEV)
    nb = (corpus.shape[1] // 8) * (corpus.shape[2] // 8)
    blocks = transform.blockify(staged).reshape(-1, 64)
    zz, flags = exact_transform.exact_transform(blocks, tables)
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
            lambda: exact_coefficients(blocks, 50, tables)),
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
    # ---- where an exact decode pass spends its time ---------------------
    prep, args, dtab = decode_inputs(streams)
    h, w, quality = prep["shape"]
    b = len(streams)
    zz, _ = entropy_decode.entropy_decode_chunks(*args, prep["nb_total"],
                                                 dtab)
    zz = zz.reshape(b, -1, 64)

    def xform():
        zz_abs = transform.undo_dpcm(zz)
        return zz_abs, *transform.decode_blocks(
            zz_abs, quality, transform.EXACT, with_flags=True, tables=dtab)

    zz_abs, px_blocks, flags = xform()
    idx = torch.nonzero(flags.reshape(-1)).reshape(-1)

    def recompute():
        rows = zz_abs.reshape(-1, 64)[idx].cpu().numpy()
        fixed = _host_decode_blocks(rows, quality, False)
        px_blocks.reshape(-1, 8, 8)[idx] = torch.from_numpy(fixed).to(DEV)

    decode_breakdown = {
        "prepare_batch_host_ms": stage(
            lambda: entropy_decode.prepare_batch(streams)),
        "upload_words_and_chunks_ms": stage(
            lambda: decode_inputs(streams)),
        "entropy_decode_ms": stage(
            lambda: entropy_decode.entropy_decode_chunks(
                *args, prep["nb_total"], dtab)),
        "undo_dpcm_and_decode_blocks_ms": stage(xform),
        "flags_to_host_ms": stage(
            lambda: torch.nonzero(flags.reshape(-1)).cpu()),
        "flagged_recompute_ms": stage(recompute),
        "unblockify_and_pull_pixels_ms": stage(
            lambda: transform.unblockify(px_blocks, h, w).contiguous().cpu()),
        "flagged_blocks": int(idx.numel()),
        "blocks": int(flags.numel()),
        "stream_words": int(args[0].numel()),
        "chunks": int(args[1].numel()),
    }
    emit("decode_breakdown", note="stages of one exact decode pass of the "
         "corpus streams, each timed alone (host clock, synchronised); "
         "upload_words_and_chunks includes prepare_batch; flagged_recompute "
         "= pull of the flagged rows + float64 host inverse DCT + patch",
         **decode_breakdown)
    emit("timing", megapixels=mp, repeats=reps,
         note="host clock around compress_batch incl. the pull of the "
              "streams and the per-image slicing; on_device skips only "
              "the upload of the pixels; decode_* = decompress_batch of the "
              "exact corpus streams incl. prepare_batch on the host and "
              "the pull of the pixels", **res)


def main() -> None:
    t_start = time.perf_counter()
    info = phase_device()
    phase_build()
    if SANITIZE_ONLY:
        emit("sanitize", corrupt=check_corrupt(*small_indexed_streams()))
        sync()
        print(json.dumps({"sanitize_corrupt": "done"}), flush=True)
        return
    corpus = synthetic_corpus(5, 64) if REHEARSE else synthetic_corpus(49, 512)
    errs = phase_kernel_check(corpus)
    errs["entropy_decode"] = phase_decode_check(corpus)
    launched, exact_streams = phase_main_path(corpus)
    kernels = phase_kernels(corpus, launched, errs, exact_streams)
    phase_timing(corpus, exact_streams)
    emit("done", seconds=round(time.perf_counter() - t_start, 1))
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
