#!/usr/bin/env python3
"""Where the wrappers of the PyTorch/CUDA port spend their device time.

Run from the root of a checkout, on a machine with an NVIDIA card:

    python3 scripts/torch_kernel_split.py

At the corpus shape (49 images of 512x512, quality 50) it calls the
wrappers of the encode kernels (``encode2`` and ``encode1`` in both input
forms, ``place`` at the pipeline's capacity and at its retry capacity,
``stitch`` at both capacities, ``exact_transform``) and the decode
wrappers (``entropy_decode``, ``exact_inverse``) under
``torch.profiler`` and prints, for each, the device time of every kernel,
memset and small tensor operation the wrapper launches (mean microseconds a
call), beside the wrapper's CUDA-event median and the host time of a call
that does not wait for the card.  It also prints the sha256 of the
concatenated fast-mode and exact-mode corpus streams, so that two trees can
be compared byte for byte.  It reads only the package's public functions,
so the same script runs on an older tree of the port, for a comparison
of two trees in one run on one card.

``--only NAME[,NAME...]`` splits only the wrappers whose label holds one
of the names (and skips the decode sweeps unless one names
``entropy_decode``); the stream hashes are printed always.  A sweep over
copies of the tree with a kernel's constants edited runs it that way.

Output: one JSON object a line.  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

if not torch.cuda.is_available():
    print("torch_kernel_split: no CUDA device available", file=sys.stderr)
    sys.exit(2)

import tinyimgcodec_tpu_torch as codec  # noqa: E402
from tinyimgcodec_tpu_torch.corpus import synthetic_corpus  # noqa: E402
from tinyimgcodec_tpu_torch.device import card_info  # noqa: E402
from tinyimgcodec_tpu_torch.ops import (  # noqa: E402
    _build, encode1, encode2, entropy_decode, exact_transform, place, stitch,
    transform,
)
from tinyimgcodec_tpu_torch.tables import CodecTables, DecodeTables  # noqa: E402

DEV = torch.device("cuda")
CALLS = 20
ONLY = (sys.argv[sys.argv.index("--only") + 1].split(",")
        if "--only" in sys.argv[1:] else None)
CHUNK_KEYS = ("chunk_start", "chunk_blocks", "chunk_block_base",
              "chunk_end_lo", "chunk_end_hi")


def wanted(label: str) -> bool:
    return ONLY is None or any(name in label for name in ONLY)


def event_median_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(CALLS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def host_us_per_call(fn) -> float:
    """Host time of one call that does not wait for the card: the rate at
    which the wrapper's Python enqueues its work (mean of ``CALLS`` calls
    back to back, one synchronisation before and after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / CALLS * 1e6


def split(label: str, fn) -> None:
    """Device time by kernel name over ``CALLS`` calls of ``fn``, beside
    the wrapper's CUDA-event median and its host time a call."""
    from torch.profiler import ProfilerActivity, profile

    if not wanted(label):
        return
    ms = event_median_ms(fn)
    host_us = host_us_per_call(fn)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        on_device = str(getattr(ev, "device_type", "")).endswith("CUDA")
        if on_device and dev_us > 0:
            # names cut to 100 characters; kernels that still share a name
            # add up
            row = rows.setdefault(ev.key[:100], {"us_per_call": 0.0,
                                                 "launches_per_call": 0.0})
            row["us_per_call"] += dev_us / CALLS
            row["launches_per_call"] += ev.count / CALLS
    total = sum(r["us_per_call"] for r in rows.values())
    print(json.dumps({
        "wrapper": label, "event_median_ms": ms, "host_us_per_call": host_us,
        "device_us_per_call": total,
        "kernels": rows if rows else "the profiler reported no device time",
    }), flush=True)


def decode_args(streams):
    prep = entropy_decode.prepare_batch(streams)
    dtab = DecodeTables.build(prep["shape"][2], prep["scaled_dct"], DEV,
                              huffman=prep["tables"])
    args = [torch.from_numpy(prep["words"].view(np.int32)).to(DEV)] + [
        torch.from_numpy(prep[k]).to(DEV) for k in CHUNK_KEYS]
    return prep, args, dtab


def sweep_chunks_a_warp(streams) -> None:
    """The decode kernel alone on a larger batch, over chunks a warp."""
    prep, args, dtab = decode_args(streams)
    zz = torch.zeros((prep["nb_total"], 64), dtype=torch.int32, device=DEV)
    ok = torch.empty((args[1].shape[0],), dtype=torch.bool, device=DEV)
    chosen = entropy_decode.launch_shape(ok.shape[0], args[0].shape[0])
    res = {}
    for cpw in (4, 8, 16, 32):
        st = min(chosen[2] * cpw // chosen[0] // 4 * 4 + 64,
                 entropy_decode.MAX_STAGE_WORDS)
        res[f"cpw{cpw}_warps{chosen[1]}"] = event_median_ms(
            lambda: entropy_decode.launch_kernel(
                args[0], args[1:], dtab, zz, ok, (cpw, chosen[1], st)))
    print(json.dumps({"decode_kernel_alone_ms_larger_batch": res,
                      "chosen_shape": list(chosen),
                      "chunks": int(ok.shape[0]),
                      "words": int(args[0].shape[0])}), flush=True)


def sweep_decode_shapes(args, prep, dtab) -> None:
    """The decode kernel alone (no allocation; into a buffer zeroed once,
    every repeat stores the same values) over chunks a warp, warps a CTA
    and the lookup table's width; CUDA-event medians, milliseconds."""
    from tinyimgcodec_tpu_torch.tables import (
        dequant_steps, fast_decode_matrix, standard_decode_tables,
    )

    nb_total = prep["nb_total"]
    zz = torch.zeros((nb_total, 64), dtype=torch.int32, device=DEV)
    ok = torch.empty((args[1].shape[0],), dtype=torch.bool, device=DEV)
    chosen = entropy_decode.launch_shape(ok.shape[0], args[0].shape[0])
    stage = chosen[2]
    quality = prep["shape"][2]
    res = {}
    for bits in (8, 9, 10, 11):
        tab = DecodeTables.from_numpy(
            *(prep["tables"] or standard_decode_tables()),
            fast_decode_matrix(quality), dequant_steps(quality),
            device=DEV, lookup_bits=bits)
        for cpw in (1, 2, 4, 8, 16, 32):
            for warps in (2, 4, 8):
                if bits != 10 and (cpw, warps) != chosen[:2]:
                    continue
                per_cta = cpw * warps
                st = stage * per_cta // (chosen[0] * chosen[1]) // 4 * 4 + 64
                st = min(st, entropy_decode.MAX_STAGE_WORDS)
                res[f"bits{bits}_cpw{cpw}_warps{warps}"] = event_median_ms(
                    lambda: entropy_decode.launch_kernel(
                        args[0], args[1:], tab, zz, ok, (cpw, warps, st)))
    res["no_stage_window"] = event_median_ms(
        lambda: entropy_decode.launch_kernel(
            args[0], args[1:], dtab, zz, ok, chosen[:2] + (0,)))
    print(json.dumps({"decode_kernel_alone_ms": res,
                      "chosen_shape": list(chosen),
                      "chunks": int(ok.shape[0]),
                      "words": int(args[0].shape[0])}), flush=True)


def split_assembly_and_v1(corpus, tables, blocks, zz, nb) -> None:
    """``place`` (at the pipeline's first capacity, 4 bits a pixel, and at
    its retry capacity, 52 words a block), the v1 kernels ``encode1`` and
    ``stitch``, and ``exact_transform``, each split by launch."""
    n = blocks.shape[0]
    cap = -(-int(corpus.size * 4.0) // 32)
    packed, meta, _ = encode2.encode2(zz, tables, nb, from_zz=True)
    split("place", lambda: place.place(packed, meta, nb, cap))
    split("place at the retry capacity",
          lambda: place.place(packed, meta, nb, n * 52))
    if wanted("place"):
        buf = torch.zeros(cap, dtype=torch.int32, device=DEV)
        print(json.dumps({"place_kernel_alone_ms": event_median_ms(
            lambda: place.launch_kernel(packed, meta, buf))}), flush=True)
    split("encode1 from pixels", lambda: encode1.encode1(blocks, tables, nb))
    zz_bm = zz.T.contiguous()  # block-major (N, 64)
    split("encode1 from coefficients",
          lambda: encode1.encode1(zz_bm, tables, nb, from_zz=True))
    words, bits, _ = encode1.encode1(blocks, tables, nb)
    split("stitch", lambda: stitch.stitch(words, bits, nb, cap))
    split("stitch at the retry capacity",
          lambda: stitch.stitch(words, bits, nb, n * 52))
    split("exact_transform",
          lambda: exact_transform.exact_transform(blocks, tables))


def main() -> None:
    print(json.dumps({"card": card_info(), "torch": torch.__version__}),
          flush=True)
    _build.build_all()
    corpus = synthetic_corpus(49, 512)
    tables = CodecTables.build(50, DEV)
    blocks = transform.blockify(
        torch.from_numpy(corpus).to(DEV)).reshape(-1, 64).contiguous()
    nb = blocks.shape[0] // corpus.shape[0]
    zz, _, _ = exact_transform.exact_transform(blocks, tables)
    split("encode2 from coefficients",
          lambda: encode2.encode2(zz, tables, nb, from_zz=True))
    split("encode2 from pixels", lambda: encode2.encode2(blocks, tables, nb))
    split("fast_coefficients (the transform alone)",
          lambda: encode2.fast_coefficients(blocks, tables))
    split_assembly_and_v1(corpus, tables, blocks, zz, nb)

    exact = codec.compress_batch(corpus, 50, precision="exact", device=DEV)
    fast = codec.compress_batch(corpus, 50, precision="fast", device=DEV)
    prep, args, dtab = decode_args(exact)
    split("entropy_decode", lambda: entropy_decode.entropy_decode_chunks(
        *args, prep["nb_total"], dtab))
    if hasattr(entropy_decode, "launch_shape") and wanted("entropy_decode"):
        sweep_decode_shapes(args, prep, dtab)
        sweep_chunks_a_warp(exact * 4)
    if wanted("exact_inverse"):
        from tinyimgcodec_tpu_torch.ops import exact_inverse

        rows = entropy_decode.entropy_decode_chunks(
            *args, prep["nb_total"], dtab)[0].reshape(len(exact), nb, 64)
        split("exact_inverse", lambda: exact_inverse.exact_inverse(
            rows, 512, 512, dtab))
    print(json.dumps({
        "sha256_fast_streams": hashlib.sha256(b"".join(fast)).hexdigest(),
        "sha256_exact_streams": hashlib.sha256(b"".join(exact)).hexdigest(),
        "bytes_fast": sum(map(len, fast)),
        "bytes_exact": sum(map(len, exact)),
    }), flush=True)


if __name__ == "__main__":
    main()
