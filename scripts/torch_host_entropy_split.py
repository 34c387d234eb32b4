#!/usr/bin/env python3
"""Where the host-entropy decode leg of the PyTorch/CUDA port spends its
time, stage by stage.

Run from the root of a checkout, on a machine with an NVIDIA card:

    python3 scripts/torch_host_entropy_split.py [--out FILE] [--reps N]

The leg decodes streams without a TICX trailer: the C decoder of
``native`` on a pool of threads, then the transform on the card.  On the
49 corpus streams (512x512, q=50, exact, trailers cut) it times, each
stage alone (host clock around a synchronised call, median of ``--reps``
after a warm call):

- ``c_decode_pool``: the entropy decode of every stream on the pool:
  where the engine has ``host_entropy_rows``, the batch entry point
  writing the narrow rows (one C call a worker, each taking the next
  stream),
  else one ``container.decompress_to_arrays`` a stream into int32 arrays;
- ``compaction``: what the decode gives into the upload form: the
  streams' outlier lists joined (``join_outliers``), else
  ``compact_coefficients`` over the ``np.stack`` of the arrays;
- ``upload``: that form to the card (pageable memory);
- ``widen_and_transform``: the widening (narrow form only), then in
  exact mode ``exact_inverse`` (one kernel to the cropped pixels, the
  flagged blocks settled on the card), in fast mode ``undo_dpcm``,
  ``decode_blocks`` and ``unblockify``;
- ``pull``: the pixels to the host;

beside the engine's whole call (``Engine(precision).decompress_batch``)
and the bytes the upload moves.  The decode and the upload form are the
tree's: ``decode`` says which of the two decodes ran; the form is the
narrow one (int16 DC, int8 AC and the outliers) where the engine has
``compact_coefficients``, else the (B, nb, 64) int32 of
``stack_coefficients``, so the same script runs on an older tree of the
port that has ``ops/exact_inverse.py``, for a comparison of two trees in
one call on one card.  It also
times the tree's ``torch_bench.bench_decode_device`` (the decode transform
alone, replayed from a CUDA graph; ``torch_bench.py``'s ``decode/device``).

``--rehearse`` runs it at a tiny size on the CPU.  Output: one JSON object
a precision, then one summary line.  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import tinyimgcodec_tpu_torch as codec  # noqa: E402
from tinyimgcodec_tpu_torch import container  # noqa: E402
from tinyimgcodec_tpu_torch import engine as engine_mod  # noqa: E402
from tinyimgcodec_tpu_torch.constants import (  # noqa: E402
    FLAG_CUSTOM_TABLE, FLAG_SCALED_DCT,
)
from tinyimgcodec_tpu_torch.ops import transform  # noqa: E402
from tinyimgcodec_tpu_torch.ops.exact_inverse import (  # noqa: E402
    exact_inverse,
)
from tinyimgcodec_tpu_torch.tables import DecodeTables  # noqa: E402


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_ms(fn, reps: int, dev: torch.device) -> float:
    """Median host milliseconds of ``fn()`` between synchronisations,
    after one warm call."""
    times = []
    for _ in range(reps + 1):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[1:]))


def batch_rows() -> bool:
    return hasattr(engine_mod, "host_entropy_rows")


def c_decode(streams: list[bytes]):
    """The leg's entropy stage: the engine's own where it has one, else
    what the engine did before it was one function (the same pool)."""
    if batch_rows():
        return engine_mod.host_entropy_rows(streams)
    fn = getattr(engine_mod, "host_entropy_arrays", None)
    if fn is not None:
        return fn(streams)
    workers = min(len(streams), os.cpu_count() or 1)
    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(
            lambda d: container.decompress_to_arrays(d, index_workers=1),
            streams))


def narrow_form() -> bool:
    return hasattr(engine_mod, "compact_coefficients")


def compact(decoded) -> list[np.ndarray]:
    """What ``c_decode`` gave -> the tree's upload form (a list of
    arrays)."""
    if batch_rows():
        return list(engine_mod.join_outliers(decoded))
    if narrow_form():
        return list(engine_mod.compact_coefficients(
            np.stack([a.dc for a in decoded]),
            np.stack([a.ac for a in decoded])))
    return [engine_mod.stack_coefficients(decoded)]


def upload(form: list[np.ndarray], dev: torch.device) -> list[torch.Tensor]:
    return [torch.from_numpy(x).to(dev) for x in form]


def widen(on_dev: list[torch.Tensor], dev: torch.device) -> torch.Tensor:
    if narrow_form():
        return engine_mod.widen_coefficients(*on_dev, dev)
    return on_dev[0]


def host_entropy_stages(streams: list[bytes], precision: str,
                        dev: torch.device, reps: int) -> dict:
    """The stage split of the leg on ``streams`` (uniform, no trailer)."""
    decoded = c_decode(streams)
    h, w, quality, flag = container.parse_header(streams[0])
    scaled = bool(flag & FLAG_SCALED_DCT) and not flag & FLAG_CUSTOM_TABLE
    h8, w8 = -(-h // 8) * 8, -(-w // 8) * 8
    tables = DecodeTables.build(quality, scaled, dev)
    form = compact(decoded)
    on_dev = upload(form, dev)

    def xform():
        zz = widen(on_dev, dev)
        if precision == transform.EXACT:
            return exact_inverse(zz, h, w, tables)
        blocks = transform.decode_blocks(
            transform.undo_dpcm(zz), quality,
            scaled_dct=scaled, tables=tables)
        return transform.unblockify(blocks, h8, w8)[:, :h, :w], None

    pixels, flagged = xform()
    flagged = None if flagged is None else int(flagged)
    eng = engine_mod.Engine(precision, dev)
    stages = {
        "c_decode_pool_ms": host_ms(lambda: c_decode(streams), reps, dev),
        "compaction_ms": host_ms(lambda: compact(decoded), reps, dev),
        "upload_ms": host_ms(lambda: upload(form, dev), reps, dev),
        "widen_and_transform_ms": host_ms(xform, reps, dev),
        "pull_ms": host_ms(
            lambda: pixels.contiguous().cpu().numpy(), reps, dev),
    }
    total = host_ms(lambda: eng.decompress_batch(streams), reps, dev)
    if eng.decode_stats["host_entropy"] != len(streams):
        raise SystemExit(f"the streams took {eng.decode_stats}")
    return {
        "precision": precision, "form": "narrow" if narrow_form() else
        "int32", "decode": "batch_rows" if batch_rows() else
        "per_stream_arrays", "images": len(streams), "shape": [h, w],
        "upload_bytes": int(sum(x.nbytes for x in form)),
        "int32_form_bytes": len(streams) * (h8 // 8) * (w8 // 8) * 64 * 4,
        "upload_dtypes": [str(x.dtype) for x in form],
        "outliers": int(form[2].size) if narrow_form() else None,
        "flagged_blocks": flagged, **stages,
        "sum_of_stages_ms": sum(stages.values()),
        "decompress_batch_ms": total,
    }


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the lines to this file")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rehearse", action="store_true",
                    help="a tiny corpus on the CPU")
    args = ap.parse_args()
    if not args.rehearse and not torch.cuda.is_available():
        print("torch_host_entropy_split: no CUDA device available",
              file=sys.stderr)
        sys.exit(2)
    from tinyimgcodec_tpu_torch.corpus import synthetic_corpus

    dev = torch.device("cpu" if args.rehearse else "cuda")
    corpus = synthetic_corpus(3, 64) if args.rehearse else synthetic_corpus(
        49, 512)
    card = "cpu rehearsal"
    if not args.rehearse:
        from tinyimgcodec_tpu_torch.device import card_info

        card = card_info()
    t0 = time.perf_counter()
    streams = codec.compress_batch(corpus, 50, precision="exact",
                                   block_index=False, device=dev)
    lines = [{"tree": os.path.basename(os.getcwd()), "card": card,
              "torch": torch.__version__, "cpu_count": os.cpu_count(),
              "encode_seconds": round(time.perf_counter() - t0, 2)}]
    for precision in ("exact", "fast"):
        lines.append(host_entropy_stages(streams, precision, dev, args.reps))
    import torch_bench

    arrays = [container.decompress_to_arrays(s, index_workers=1)
              for s in streams]
    samples, _ = torch_bench.bench_decode_device(arrays, k=100, dev=dev,
                                                 reps=args.reps)
    lines.append({"decode/device_MP_per_s": samples,
                  "median": float(np.median(samples)) if samples else None})
    out = "\n".join(json.dumps(x) for x in lines)
    print(out, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write(out + "\n")


if __name__ == "__main__":
    main()
