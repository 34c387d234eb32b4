"""Conformance batteries of the compiled kernels on the card.

The counterpart of the JAX package's two hardware scripts
(``scripts/hw_quality_sweep.py``, ``scripts/hw_adversarial.py``) as
functions, shared by ``scripts/torch_hw_quality_sweep.py``,
``scripts/torch_hw_adversarial.py`` and ``chip_smoke.py``.  Everything
goes through the public entry points (``api``, ``Engine``) or
``pipeline.compress_batch_device`` on ``device`` and is held to the port's
own ``container``, the float64 oracle.  On a CUDA device that runs the
hand-written kernels; on ``device="cpu"`` their plain versions.

A battery's record has the JAX scripts' shape: ``checks``, a list of
``{"name", "passed", ...}``, and ``all_passed``.  A check that fails is
recorded, never raised, so that one record shows every failure; the
callers exit non-zero on ``all_passed == False``.

The kernel launch counters (each wrapper's ``launches``) are read as
differences, never reset, so that a caller may count a whole battery as
one path.  They count CUDA launches only: on the CPU the checks that read
them record ``launches: None`` and rest on the bytes alone.  Each wrapper
also counts by card (``launches_by_card``), under a lock, so that the
shards of a local mesh, one thread a card, lose no count.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from . import api, container, golden, huffman, metrics
from .device import resolve_device
from .engine import KERNEL_BLOCK_BITS, Engine
from .ops import _build, encode1, encode2, entropy_decode, exact_inverse
from .ops import exact_transform
from .ops import place
from .ops import stitch
from .ops import symbol_stats
from .ops import transform
from .ops.entropy_decode import prepare_batch
from .pipeline import compress_batch_device, exact_coefficients
from .tables import CodecTables, DecodeTables

# the content battery's qualities (hw_adversarial.py:76) and the sweep's
# (hw_quality_sweep.py:41)
QUALITIES = (1, 10, 50, 90, 95)
SWEEP_QUALITIES = (10, 25, 50, 75, 90)
# the fast-mode bar of the port: PSNR within this of the oracle's
FAST_PSNR_DB = 0.01
# the tail words ``stitch`` zeroes a turn (``csrc/stitch.cu``: CHUNK)
STITCH_TAIL_WORDS = 4096
TABLE_RANGE = "Huffman table range"

_KERNELS = {"exact_transform": exact_transform, "encode2": encode2,
            "place": place, "encode1": encode1, "stitch": stitch,
            "entropy_decode": entropy_decode, "exact_inverse": exact_inverse,
            "symbol_stats": symbol_stats}


def contents(h: int, w: int) -> dict[str, np.ndarray]:
    """The seven adversarial images of ``hw_adversarial.py:34-46``: noise,
    checkerboards of 1 and 4 pixels, a horizontal gradient, flat 0, flat
    255 and one-pixel stripes, (h, w) uint8 each."""
    y, x = np.mgrid[0:h, 0:w]
    rng = np.random.RandomState(7)
    return {
        "noise": rng.randint(0, 256, (h, w)).astype(np.uint8),
        "checker1": ((x + y) % 2 * 255).astype(np.uint8),
        "checker4": (((x // 4 + y // 4) % 2) * 255).astype(np.uint8),
        "hgrad": (x * 255 // max(w - 1, 1)).astype(np.uint8),
        "flat0": np.zeros((h, w), np.uint8),
        "flat255": np.full((h, w), 255, np.uint8),
        "stripes": ((x % 2) * 255).astype(np.uint8),
    }


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch count, ``encode2`` also by input."""
    out = {k: m.launches for k, m in _KERNELS.items()}
    out["encode2_pixels"] = encode2.launches_by_input["pixels"]
    out["encode2_zz"] = encode2.launches_by_input["zz"]
    return out


def launch_counts_by_card() -> dict[str, dict[int, int]]:
    """Every kernel wrapper's launch count on each card (by index), for
    the cards it launched on."""
    with _build.COUNT_LOCK:
        return {k: dict(m.launches_by_card) for k, m in _KERNELS.items()}


def reset_launch_counts() -> None:
    """Every count of :func:`launch_counts` and
    :func:`launch_counts_by_card` to 0."""
    with _build.COUNT_LOCK:
        for m in _KERNELS.values():
            m.launches = 0
            m.launches_by_card = {}
        encode2.launches_by_input = {"pixels": 0, "zz": 0}


def _since(before: dict[str, int]) -> dict[str, int]:
    now = launch_counts()
    return {k: now[k] - before[k] for k in now}


def ctas_past_window(prep: dict) -> int:
    """How many CTAs of the decode kernel have chunks that reach past
    their staged window of the stream (and so read device memory), for
    the launch shape the wrapper picks for ``prepare_batch``'s ``prep``."""
    n = len(prep["chunk_start"])
    cpw, warps, stage = entropy_decode.launch_shape(n, len(prep["words"]))
    per = cpw * warps
    first = np.arange(0, n, per)
    last = np.minimum(first + per - 1, n - 1)
    lo = prep["chunk_start"][first].astype(np.int64) >> 5
    hi = prep["chunk_end_hi"][last].astype(np.int64) >> 5
    return int((hi - lo >= stage - 3).sum())


def auto_table_route(img: np.ndarray, quality: int) -> str:
    """The route an auto-table encode must take, by the engine's rule
    worked out on the float64 oracle's coefficients: ``"host"`` for an
    extended table or a block past ``KERNEL_BLOCK_BITS``, else
    ``"kernel"``."""
    arrays = golden.encode_arrays(img, quality)
    spec = huffman.build_huffman_spec(arrays)
    if spec.extended or (huffman.block_bit_counts(arrays.dc, arrays.ac, spec)
                         .max() > KERNEL_BLOCK_BITS):
        return "host"
    return "kernel"


def _sha(streams) -> str:
    return hashlib.sha256(b"".join(streams)).hexdigest()


def _payload(stream: bytes, nb: int) -> bytes:
    """An indexed stream without its TICX trailer: the stream
    ``container.compress`` writes without ``block_index``."""
    return stream[:container.parse_block_index(stream, nb)[2]]


def _refusal(fn) -> str | None:
    """``None`` when ``fn()`` raises ``ValueError`` about the Huffman
    table range; else what it did instead."""
    try:
        fn()
    except ValueError as e:
        if TABLE_RANGE in str(e):
            return None
        return f"ValueError: {e}"
    return "returned bytes"


def adversarial(device: str | torch.device | None = None, size: int = 128,
                log=None) -> dict:
    """The checks of ``hw_adversarial.py`` on ``size`` x ``size`` images of
    :func:`contents`, translated to the port (``log``: called with a line
    for each check as it is made):

    a. each quality of ``QUALITIES``: exact ``compress_batch`` bytes (with
       the index) == the oracle's; exact ``compress_batch_device`` without
       the index == ``container.compress(im, q)``; fast v2 and v1 streams
       decode through ``container.decompress`` to the true shape; fast v1
       bytes == fast v2 bytes;
    b. q=99: where the oracle refuses an image, ``compress_batch`` of the
       battery, ``compress`` of that image and the fast v1 path raise
       ``ValueError`` about the table range; ``compress`` of it with auto
       tables == the oracle's;
    c. capacity edges on the noise image at q=50: budgets of exactly
       ``cap`` words around the words it needs, the retry capacity
       ``n * 52`` and ``stitch``'s tail turns; exact == the oracle, fast v2
       and v1 == their own default-budget bytes at every cap;
    d. 64x64 images through ``api.compress_batch`` and ``api.compress`` ==
       the oracle, on the kernels (launch counters, on the card);
    e. the exact indexed streams of (a) at q=50 and 90 decoded
       by ``Engine("exact", device).decompress_batch``: pixels == the
       oracle's, every image on the kernel leg; at q=90 the CTAs whose
       chunks pass their staged window;
    f. ``compress(noise, q, auto_generate_huffman_table=True)`` at q=50
       and 90 == the oracle's, decoded on the kernel leg to the oracle's
       pixels, on the route the engine's rule gives.

    Returns the record: ``checks``, ``all_passed``, ``need``, ``caps``,
    ``ctas_past_window_q90``, ``launches`` (the battery's, on the card),
    ``seconds``."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    t_start = time.perf_counter()
    before = launch_counts()
    record = {"size": [size, size], "device": str(dev),
              "qualities": list(QUALITIES), "checks": [], "all_passed": True}

    def check(name: str, passed: bool, **extra) -> None:
        passed = bool(passed)
        record["checks"].append({"name": name, "passed": passed, **extra})
        record["all_passed"] = record["all_passed"] and passed
        if log is not None:
            log(f"{'PASS' if passed else 'FAIL'} {name} {extra}")

    battery = contents(size, size)
    names = list(battery)
    imgs = np.stack(list(battery.values()))
    nb = (size // 8) ** 2
    oracle: dict[int, list[bytes]] = {}  # the indexed oracle streams by q
    exact_by_q: dict[int, list[bytes]] = {}

    def refs_at(q):
        if q not in oracle:
            oracle[q] = [container.compress(im, q, block_index=True)
                         for im in imgs]
        return oracle[q]

    def exact_at(q):
        if q not in exact_by_q:
            exact_by_q[q] = api.compress_batch(imgs, q, precision="exact",
                                               device=dev)
        return exact_by_q[q]

    # -- a. content x quality ------------------------------------------
    for q in QUALITIES:
        t0 = time.perf_counter()
        refs = refs_at(q)
        out = exact_at(q)
        check(f"exact-byte-identity-q{q}", out == refs,
              mismatches=[n for n, a, b in zip(names, out, refs) if a != b],
              sha256=_sha(out), secs=round(time.perf_counter() - t0, 2))
        plain = [_payload(r, nb) for r in refs]
        dev_out = compress_batch_device(imgs, q, precision="exact",
                                        block_index=False, device=dev)
        check(f"exact-device-noindex-q{q}", dev_out == plain,
              mismatches=[n for n, a, b in zip(names, dev_out, plain)
                          if a != b])
        fast = compress_batch_device(imgs, q, precision="fast", device=dev)
        fast1 = compress_batch_device(imgs, q, precision="fast", device=dev,
                                      version="v1")
        bad = [f"{v} {n}" for v, streams in (("v2", fast), ("v1", fast1))
               for n, s, im in zip(names, streams, imgs)
               if container.decompress(s).shape != im.shape]
        check(f"fast-decodable-q{q}", not bad, wrong_shape=bad)
        check(f"fast-v1-equals-v2-q{q}", fast1 == fast,
              mismatches=[n for n, a, b in zip(names, fast1, fast) if a != b])

    # -- b. q=99: refused where the oracle refuses ----------------------
    refused = [n for n, im in zip(names, imgs)
               if _refusal(lambda: container.compress(im, 99)) is None]
    if not refused:
        check("q99-oracle-refuses", False)
    else:
        first = imgs[names.index(refused[0])]
        for label, fn in (
            ("compress_batch", lambda: api.compress_batch(
                imgs, 99, precision="exact", device=dev)),
            ("compress", lambda: api.compress(first, 99, device=dev)),
            ("fast-v1", lambda: compress_batch_device(
                imgs, 99, precision="fast", device=dev, version="v1")),
        ):
            got = _refusal(fn)
            check(f"q99-{label}-raises-like-oracle", got is None,
                  refused=refused, instead=got)
        auto = api.compress(first, 99, auto_generate_huffman_table=True,
                            device=dev)
        check("q99-auto-table-equals-oracle",
              auto == container.compress(first, 99, True, block_index=True),
              image=refused[0])

    # -- c. capacity edges ----------------------------------------------
    noise = imgs[:1]
    ref = _payload(refs_at(50)[0], nb)
    need = -(-(len(ref) - container.HEADER_BYTES) * 8 // 32)
    turn = -(-need // STITCH_TAIL_WORDS) * STITCH_TAIL_WORDS
    retry = nb * 52
    caps = sorted({need - 64, need - 1, need, need + 1, retry,
                   turn - 1, turn, turn + STITCH_TAIL_WORDS})
    default = {v: compress_batch_device(noise, 50, precision="fast",
                                        device=dev, version=v)[0]
               for v in ("v2", "v1")}
    for cap in caps:
        budget = cap * 32 / noise[0].size
        words = -(-int(noise[0].size * budget) // 32)
        got = {
            "exact": compress_batch_device(
                noise, 50, budget, precision="exact", device=dev)[0] == ref,
            **{f"fast_{v}": compress_batch_device(
                noise, 50, budget, precision="fast", device=dev,
                version=v)[0] == default[v] for v in ("v2", "v1")},
        }
        check(f"capacity-edge-{cap}", words == cap and all(got.values()),
              cap_words=words, **got)
    record.update(need=need, caps=caps, retry_words=retry,
                      stitch_turn_words=turn)

    # -- d. small images through the kernels ----------------------------
    small = np.stack(list(contents(64, 64).values()))
    refs64 = [container.compress(im, 50, block_index=True) for im in small]
    mark = launch_counts()
    out64 = api.compress_batch(small, 50, precision="exact", device=dev)
    one64 = api.compress(small[0], 50, precision="exact", device=dev)
    ran = _since(mark) if on_card else None
    through = ran is None or all(
        ran[k] >= 2 for k in ("exact_transform", "encode2_zz", "place"))
    check("small-batch-byte-identity", out64 == refs64 and through,
          launches=ran)
    check("single-small-image-byte-identity", one64 == refs64[0])

    # -- e. device decode of the battery's exact streams -----------------
    engine = Engine("exact", dev)
    for q in (50, 90):
        streams = exact_at(q)
        got = engine.decompress_batch(streams)
        legs = dict(engine.decode_stats)
        gold = np.stack([container.decompress(s) for s in streams])
        extra = {}
        if q == 90:
            extra["ctas_past_window"] = ctas_past_window(
                prepare_batch(streams))
            record["ctas_past_window_q90"] = extra["ctas_past_window"]
        check(f"device-entropy-decode-parity-q{q}",
              np.array_equal(got, gold) and legs["kernel"] == len(streams),
              legs=legs, **extra)

    # -- f. dynamic tables through the device decoder --------------------
    for q in (50, 90):
        route = auto_table_route(noise[0], q)
        mark = launch_counts()
        data = api.compress(noise[0], q, auto_generate_huffman_table=True,
                            device=dev)
        ran = _since(mark) if on_card else None
        routed = ran is None or (ran["encode2_zz"] >= 1) == (
            route == "kernel")
        dec = engine.decompress(data)
        legs = dict(engine.decode_stats)
        check(f"device-entropy-decode-parity-custom-table-q{q}",
              data == container.compress(noise[0], q, True, block_index=True)
              and routed and legs["kernel"] == 1
              and np.array_equal(dec, container.decompress(data)),
              route=route, legs=legs, launches=ran)

    record["launches"] = _since(before) if on_card else None
    record["seconds"] = round(time.perf_counter() - t_start, 2)
    return record


def quality_sweep(images, qualities=SWEEP_QUALITIES,
                  device: str | torch.device | None = None,
                  precisions=("exact",), names=None) -> list[dict]:
    """One row per image, quality and precision, as
    ``hw_quality_sweep.py:56-72``: each image alone through
    ``api.compress_batch`` (with the block index) twice, the first call
    timed as ``first_call_s`` (on a fresh process it holds the kernels'
    load), the second as ``run_s`` (host clock, synchronised); ``bytes``,
    ``cr`` (with the index; ``cr_no_index`` without it, the reference's
    layout), ``psnr`` and ``psnr_ref_formula`` of ``container.decompress``
    of the stream, and beside them the oracle's own (``oracle_*``, from
    ``container.compress(im, q, block_index=True)``).  ``passed``: exact
    rows are byte-identical to the oracle
    (``byte_identical_to_host_oracle``), fast rows decode to the true
    shape within ``FAST_PSNR_DB`` of the oracle's PSNR."""
    dev = resolve_device(device)
    images = [np.asarray(im) for im in images]
    names = names or [f"image{i}" for i in range(len(images))]
    rows = []

    def timed(fn):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    for name, img in zip(names, images):
        nb = (-(-img.shape[0] // 8)) * (-(-img.shape[1] // 8))
        for q in qualities:
            ref = container.compress(img, q, block_index=True)
            ref_dec = container.decompress(ref)
            oracle = {"oracle_bytes": len(ref),
                      "oracle_cr": metrics.compression_ratio(img, ref),
                      "oracle_psnr": metrics.psnr(ref_dec, img)}
            for precision in precisions:
                def call():
                    return api.compress_batch(img[None], q,
                                              precision=precision,
                                              device=dev)[0]

                _, first_s = timed(call)
                out, run_s = timed(call)
                dec = container.decompress(out)
                row = {
                    "image": name, "q": q, "precision": precision,
                    "bytes": len(out),
                    "cr": metrics.compression_ratio(img, out),
                    "cr_no_index": metrics.compression_ratio(
                        img, _payload(out, nb)),
                    "psnr": metrics.psnr(dec, img),
                    "psnr_ref_formula": metrics.psnr_reference(dec, img),
                    **oracle,
                    "first_call_s": first_s, "run_s": run_s,
                }
                if precision == "exact":
                    row["byte_identical_to_host_oracle"] = out == ref
                    row["passed"] = out == ref
                else:
                    row["psnr_gap_to_oracle_db"] = abs(
                        row["psnr"] - oracle["oracle_psnr"])
                    row["passed"] = (dec.shape == img.shape and row[
                        "psnr_gap_to_oracle_db"] <= FAST_PSNR_DB)
                rows.append(row)
    return rows


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def kernels_vs_plain(images: np.ndarray, quality: int = 50,
                     device: str | torch.device | None = None) -> dict:
    """Each of the eight kernel wrappers against its plain version on the
    same tensors on ``device``, at the shapes ``compress_batch`` of
    ``images`` (B, H, W) gives them (``chip_smoke.py``'s bars):

    - ``exact_transform``: coefficients equal to the plain version's and
      to the plain path's on the CPU on every block (each settles its
      tie-flagged blocks in the oracle's arithmetic), flags that differ in
      at most 0.01 % of the blocks (the tensor cores sum in another
      order);
    - ``encode2`` from those coefficients, ``place`` (at the batch's
      budget), ``encode1`` from them and ``stitch`` (at the exact
      capacity): every output equal;
    - ``encode2`` from pixels: the float32 transform equal to the plain
      one on every coefficient (``transform_steps`` 0: the kernel's order
      defines fast mode), and words equal to the plain entropy coding of
      the kernel's own coefficients;
    - ``entropy_decode`` of the images' exact indexed streams: ``zz`` and
      the chunk flags equal;
    - ``exact_inverse`` of those rows: the pixels and the count of
      flagged blocks equal;
    - ``symbol_stats`` of the exact coefficients, the batch as one block
      range: every count and maximum equal.

    Returns ``{"device", "checks", "all_passed", "digests"}``;
    ``digests``: the sha256 of each wrapper's outputs, so that the same
    call on another card can be held to this one's bit for bit.  On the
    CPU each wrapper is its plain version, and the checks pass
    trivially."""
    dev = resolve_device(device)
    record = {"device": str(dev), "checks": [], "all_passed": True,
              "digests": {}}

    def check(name: str, passed: bool, **extra) -> None:
        record["checks"].append({"name": name, "passed": bool(passed),
                                 **extra})
        record["all_passed"] = record["all_passed"] and bool(passed)

    def same(*pairs) -> bool:
        return all(a.shape == b.shape and bool((a == b).all())
                   for a, b in pairs)

    images = np.ascontiguousarray(transform.pad_to_blocks(
        np.asarray(images, dtype=np.uint8)))
    b, h, w = images.shape
    nb = (h // 8) * (w // 8)
    tables = CodecTables.build(quality, dev)
    blocks = transform.blockify(torch.from_numpy(images).to(dev)).reshape(
        -1, 64).contiguous()
    n = blocks.shape[0]
    digests = record["digests"]

    zk, fk, _ = exact_transform.exact_transform(blocks, tables)
    zp, fp, _ = exact_transform.exact_transform_plain(blocks, tables)
    either = (fk != 0) | (fp != 0)
    zz = exact_coefficients(blocks, tables)
    gold = exact_coefficients(blocks.cpu(), CodecTables.build(quality, "cpu"))
    check("exact_transform", same((zz.cpu(), gold), (zk, zp))
          and int((fk != fp).sum()) <= n // 10000,
          flag_diff=int((fk != fp).sum()), flagged=int(either.sum()))
    digests["exact_transform"] = _digest(zk, fk)

    pk, mk, ok = encode2.encode2(zz, tables, nb, from_zz=True)
    pp, mp, op = encode2.encode2_plain(zz, tables, nb, from_zz=True)
    check("encode2_zz", same((pk, pp), (mk, mp), (ok, op)))
    digests["encode2_zz"] = _digest(pk, mk, ok)

    zf = encode2.fast_coefficients(blocks, tables)
    step = (zf.to(torch.int64) - encode2.fast_coefficients_plain(
        blocks, tables).to(torch.int64)).abs()
    pk2, mk2, ok2 = encode2.encode2(blocks, tables, nb)
    pp2, mp2, op2 = encode2.encode2_plain(zf, tables, nb, from_zz=True)
    check("encode2_pixels", same((pk2, pp2), (mk2, mp2), (ok2, op2))
          and int(step.max()) == 0,
          transform_steps=int((step != 0).sum()))
    digests["encode2_pixels"] = _digest(zf, pk2, mk2, ok2)

    cap = -(-int(images.size * 4.0) // 32)
    sk = place.place(pk, mk, nb, cap)
    sp = place.place_plain(pk, mk, nb, cap)
    check("place", same(*zip(sk, sp)), cap_words=cap)
    digests["place"] = _digest(*sk)

    wk, bk, o1k = encode1.encode1(zz.T.contiguous(), tables, nb,
                                  from_zz=True)
    wp, bp, o1p = encode1.encode1_plain(zz.T.contiguous(), tables, nb,
                                        from_zz=True)
    check("encode1", same((wk, wp), (bk, bp), (o1k, o1p)))
    digests["encode1"] = _digest(wk, bk, o1k)

    total = int(mk[0, -1]) + int(mk[1, -1])
    tk = stitch.stitch(wk, bk, nb, -(-total // 32))
    tp = stitch.stitch_plain(wk, bk, nb, -(-total // 32))
    check("stitch", same(*zip(tk, tp)) and int(tk[2]) == total)
    digests["stitch"] = _digest(*tk)

    streams = compress_batch_device(images, quality, precision="exact",
                                    block_index=True, device=dev)
    prep = prepare_batch(streams)
    dt = DecodeTables.build(prep["shape"][2], prep["scaled_dct"], dev,
                            huffman=prep["tables"])
    args = [torch.from_numpy(prep["words"].view(np.int32)).to(dev)] + [
        torch.from_numpy(prep[k]).to(dev) for k in (
            "chunk_start", "chunk_blocks", "chunk_block_base",
            "chunk_end_lo", "chunk_end_hi")]
    dk = entropy_decode.entropy_decode_chunks(*args, prep["nb_total"], dt)
    dp = entropy_decode.entropy_decode_chunks_plain(*args, prep["nb_total"],
                                                    dt)
    check("entropy_decode", same(*zip(dk, dp)) and bool(dk[1].all()),
          chunks=int(dk[1].numel()))
    digests["entropy_decode"] = _digest(*dk)

    zb = dk[0].reshape(b, nb, 64)
    ik = exact_inverse.exact_inverse(zb, h, w, dt)
    ip = exact_inverse.exact_inverse_plain(zb, h, w, dt)
    check("exact_inverse", same(*zip(ik, ip)), flagged=int(ik[1]))
    digests["exact_inverse"] = _digest(*ik)

    hk = symbol_stats.stats_buffer([zz])
    check("symbol_stats", same((hk, symbol_stats.symbol_stats_plain(zz))))
    digests["symbol_stats"] = _digest(hk)
    return record


def failed_names(record: dict) -> list[str]:
    """The names of a record's failed checks."""
    return [c["name"] for c in record["checks"] if not c["passed"]]
