#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the three CUDA kernels from ``tinyimgcodec_tpu_torch/csrc`` with
``nvcc``, holds each against its plain PyTorch version on the card, drives
the port's main path (``compress_batch`` of a 49 x 512 x 512 corpus, exact
and fast, and one odd-shaped ``compress``) through the public API, checks
the bytes against the float64 host oracle, shows from the launch counters
that the path went through the kernels, and times every kernel at the
corpus shapes beside its plain version and its bound.

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
import re
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
from tinyimgcodec_tpu_torch.metrics import psnr  # noqa: E402
from tinyimgcodec_tpu_torch.ops import (  # noqa: E402
    _build, encode2, exact_transform, place, transform,
)
from tinyimgcodec_tpu_torch.pipeline import (  # noqa: E402
    _host_zz64, exact_coefficients,
)
from tinyimgcodec_tpu_torch.tables import CodecTables  # noqa: E402

DEV = torch.device("cpu" if REHEARSE else "cuda")
KERNEL_MODULES = {
    "exact_transform": exact_transform, "encode2": encode2, "place": place,
}


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
    the main path gives the kernels (the whole corpus)."""
    size = 32 if REHEARSE else 256
    rng = np.random.RandomState(7)
    smooth = synthetic_corpus(4, size)
    noise = rng.randint(0, 256, (4, size, size)).astype(np.uint8)
    errs = {"exact_transform": 0, "encode2": 0, "encode2_pixels": 0,
            "place": 0}
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
        if not (eq(pk, pp) and eq(mk, mp) and bool(ok_) == bool(op)):
            errs["encode2"] = 1
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
            if not (eq(sk[0], sp[0]) and eq(sk[1], sp[1])
                    and int(sk[2]) == int(sp[2])
                    and bool(sk[3]) == bool(sp[3])):
                errs["place"] = 1
                fail(f"place[{label}, cap={cap}]: kernel and plain differ")
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
                    "encode2 pixels": "|step| <= 1 on <= 1e-4 of "
                    "coefficients, each within 1e-3 of a tie"})
    return errs


def phase_main_path(corpus: np.ndarray) -> dict:
    """The public API on the corpus, both precisions, counters around it."""
    quality = 50
    reset_counts()
    t0 = time.perf_counter()
    exact = codec.compress_batch(corpus, quality, precision="exact",
                                 device=DEV)
    fast = codec.compress_batch(corpus, quality, precision="fast",
                                device=DEV)
    odd = synthetic_corpus(1, 128)[0][:61, :83].copy()
    odd_bytes = codec.compress(odd, quality, device=DEV)
    sync()
    secs = time.perf_counter() - t0
    launched = counts()
    if not REHEARSE:
        for k in ("exact_transform", "encode2_pixels", "encode2_zz", "place"):
            if launched[k] < 1:
                fail(f"main path launched kernel {k} {launched[k]} times")

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
    if container.decompress(odd_bytes).shape != odd.shape:
        fail("odd-shaped stream decodes to the wrong shape")
    worst = 0.0
    for i in range(n_img):
        dec_e = container.decompress(exact[i])
        dec_f = container.decompress(fast[i])
        if dec_e.shape != corpus[i].shape or dec_f.shape != corpus[i].shape:
            fail(f"image {i} decodes to the wrong shape")
        pe, pf = psnr(corpus[i], dec_e), psnr(corpus[i], dec_f)
        if not (np.isfinite(pe) and np.isfinite(pf)):
            fail(f"image {i}: PSNR not finite")
        worst = max(worst, abs(pe - pf))
    if worst > 0.01:
        fail(f"fast-mode PSNR is {worst} dB from exact mode (> 0.01)")
    emit("main_path", images=list(corpus.shape), quality=quality,
         oracle_checked=f"all {n_img} exact streams byte-equal to "
         "container.compress(block_index=True); all exact and fast "
         "streams decoded",
         fast_vs_exact_psnr_db=worst, launches=launched,
         bytes_exact=sum(map(len, exact)), bytes_fast=sum(map(len, fast)),
         first_pass_seconds=round(secs, 3),
         check_seconds=round(time.perf_counter() - t0, 1))
    return launched


def phase_kernels(corpus: np.ndarray, launched: dict, errs: dict) -> list:
    """Every kernel at the corpus shapes: time, plain time, bound."""
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
            rate, library_ms=None):
        t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
        t_ops = ops / rate * 1e3
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": count, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "bytes": nbytes, "operations": ops,
        }

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
    ))
    return out


def phase_timing(corpus: np.ndarray) -> None:
    """End-to-end corpus pass, warm: from host memory and from the card."""
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
    # where an exact pass spends its time: each stage alone, host clock
    # around a synchronised call, median of `reps`
    def stage(fn):
        times = []
        for _ in range(reps + 1):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times[1:]))

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
    emit("timing", megapixels=mp, repeats=reps,
         note="host clock around compress_batch incl. the pull of the "
              "streams and the per-image slicing; on_device skips only "
              "the upload of the pixels", **res)


def main() -> None:
    t_start = time.perf_counter()
    info = phase_device()
    phase_build()
    corpus = synthetic_corpus(2, 64) if REHEARSE else synthetic_corpus(49, 512)
    errs = phase_kernel_check(corpus)
    launched = phase_main_path(corpus)
    kernels = phase_kernels(corpus, launched, errs)
    phase_timing(corpus)
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
