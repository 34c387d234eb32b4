"""The engine: one-image encode, and decode of one stream or a batch.

The counterpart of the JAX package's ``engine.Engine``.  ``compress`` runs
the batch pipeline with B = 1, so the one-image entry point and the batch
entry point are the same program.  ``compress(..., auto_table=True)`` codes
the image with Huffman tables built for it at run time: coefficients and
their symbol histograms on the device (``ops/symbol_stats.py``), the
tables on the host, then the same ``encode2`` + ``place`` kernels with
the new tables, in the pipeline's block ranges (or the host container
when the tables leave the kernels' range), each step a ``codec.encode.*``
stage span (``table`` and ``fallback`` its own).

Decode has three legs, chosen per stream by what the *stream* is, never
by what the device or the build did:

- **kernel**: a uniform batch of TICX-indexed streams (standard tables or
  one shared admissible dynamic table) is entropy-decoded on the device,
  one thread per chunk (``ops/entropy_decode.py``), then, in exact mode,
  one kernel from those rows to the cropped pixels (``ops/exact_inverse.py``:
  running DC, dequantize, inverse DCT, and the blocks flagged as sitting on
  a floor boundary settled in the oracle's arithmetic on the card), and one
  pull of the pixels; fast mode runs the plain float32 transform of
  ``ops/transform.py``;
- **host decoder**: an image of such a batch with a chunk that failed
  validation (a corrupt stream) is decoded by ``container.decompress``,
  which degrades block by block as the reference does;
- **host entropy**: streams the kernel leg cannot take (no trailer, an
  inadmissible table, an image of more than ``MAX_DECODE_BLOCKS`` blocks)
  are entropy-decoded by the C decoder of ``native``, one call a worker
  (each takes the next stream until none is left), straight into the
  narrow form the batch goes up in (int16 DC, int8 AC and a list of
  outliers, as :func:`compact_coefficients` and the JAX package's
  ``Engine._compact_coeffs`` give it; int16 AC where a stream has too
  many), and transformed on the device after widening there.

A uniform batch of more than ``MAX_DECODE_BLOCKS`` blocks is decoded on
the kernel leg in sub-batches cut at image boundaries.

``decode_stats`` counts the images each leg took in the last call.  Each
decode stage is a ``codec.decode.*`` span of ``profiling.span``; the
host-entropy leg's are ``.host_entropy`` (the C decodes into the narrow
rows), ``.compact`` (the streams' outlier lists joined) and ``.upload``
(the narrow copies and the widening), then the transform and the pull as
on the kernel leg.

``encode_to_words`` gives an image's per-block code words and bit counts
(the ``encode1`` kernel), from which a TICX trailer of any stride can be
built.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import container, native, profiling
from .bitstream import BitWriter, concat_bit_payload
from .constants import FLAG_CUSTOM_TABLE, FLAG_SCALED_DCT
from .device import resolve_device
from .golden import CodecArrays
from .huffman import block_bit_counts, build_huffman_spec_from_counts
from .ops import transform
from .ops.encode1 import BLOCK_WORDS, encode1
from .ops.encode2 import fast_coefficients
from .ops.entropy_decode import (
    chunk_table, entropy_decode_chunks, prepare_batch,
)
from .ops.exact_inverse import exact_inverse
from .ops.symbol_stats import symbol_stats
from .pipeline import (
    TableRangeError, compress_batch_device, concat_bits, encode_ranges,
    exact_coefficients, range_blocks, range_coefficients, stream_bytes,
    sub_ranges,
)
from .tables import CodecTables, DecodeTables

# The most blocks one decode launch takes: its coefficient output is
# indexed in int32 (nb_total * 64 < 2**31, ops/entropy_decode.py).
MAX_DECODE_BLOCKS = (1 << 31) // 64 - 1
# The most bits a block may take on the encode kernels: ``encode2``'s row,
# the ``n * 52``-word capacity retry and its ``MAX_BLOCKS`` assume it.
KERNEL_BLOCK_BITS = 52 * 32


def compact_coefficients(dc: np.ndarray, ac: np.ndarray):
    """Host-decoded int32 coefficients -> the narrow form the host-entropy
    leg uploads: ``(dc16, acN, exc_idx, exc_val)``.

    ``dc`` (..., nb) DC differences, ``ac`` (..., nb, 63) zig-zag AC.  A
    decodable stream bounds both by its tables (standard: |DC diff| <=
    2047, |AC| <= 1023; any table: 15 bits), so int16 holds them.  DC goes
    as int16; AC as int8 plus the outliers, their flat indices into ``ac``
    (int64: any batch) and their int16 value deltas, to be added after
    widening -- unless more than ``ac.size // 8`` coefficients lie outside
    int8 (or a delta would not fit int16, only for |AC| >= 32640), and
    then as int16 with no outliers.  The dtypes and the outlier rule are
    those of the JAX package's ``Engine._compact_coeffs``; its padding of
    the outlier list to a power of two, which bounds jit signatures there,
    is dropped."""
    dc16 = np.ascontiguousarray(dc, dtype=np.int16)
    ac = np.asarray(ac)
    ac8 = ac.astype(np.int8)  # wraps, as the JAX function's cast does
    idx = np.flatnonzero(ac8 != ac)
    val = ac.reshape(-1)[idx] - ac8.reshape(-1)[idx].astype(np.int64)
    if idx.size > ac.size // 8 or (
            idx.size and int(np.abs(val).max()) > np.iinfo(np.int16).max):
        return (dc16, np.ascontiguousarray(ac, dtype=np.int16),
                np.zeros(0, np.int64), np.zeros(0, np.int16))
    return dc16, ac8, idx.astype(np.int64), val.astype(np.int16)


def widen_coefficients(dc16: torch.Tensor, acN: torch.Tensor,
                       exc_idx: torch.Tensor, exc_val: torch.Tensor,
                       device: str | torch.device) -> torch.Tensor:
    """The narrow form of :func:`compact_coefficients`, already on
    ``device`` -> (..., nb, 64) int32 there, the DC differences in column
    0: widen, then add the outliers' deltas at their positions.  Plain
    torch, as the JAX package's XLA widening; a tensor on another device
    raises."""
    dev = resolve_device(device)
    for t in (dc16, acN, exc_idx, exc_val):
        if t.device != dev:
            raise ValueError(f"coefficients on {t.device}, expected {dev}")
    out = torch.empty((*dc16.shape, 64), dtype=torch.int32, device=dev)
    out[..., 0] = dc16
    out[..., 1:] = acN
    if exc_idx.numel():
        # flat AC index i is row i // 63, column i % 63 + 1 of the output
        out.view(-1).index_add_(0, exc_idx + exc_idx // 63 + 1,
                                exc_val.to(torch.int32))
    return out


def host_entropy_workers(n_streams: int) -> int:
    """The threads :func:`host_entropy_rows` decodes ``n_streams`` on:
    one a stream, at most one a core."""
    return min(n_streams, os.cpu_count() or 1)


def host_entropy_rows(streams: list[bytes]) -> native.BatchRows:
    """The entropy stage of the host-entropy leg: a uniform batch through
    the C decoder of ``native`` (``native.entropy_decode_batch``: one call
    a worker, each taking the next stream), straight into the batch's
    narrow upload form; each stream decoded as
    ``container.decompress_to_arrays(d, index_workers=1)`` decodes it.
    Where a stream cannot go narrow (more than an eighth of its AC values
    outside int8, or a delta beyond int16), the batch is decoded again
    with int16 AC."""
    plans = [container.payload_plan(d) for d in streams]
    workers = host_entropy_workers(len(streams))
    rows = native.entropy_decode_batch(plans, 1, workers)
    if (rows.counts < 0).any():
        rows = native.entropy_decode_batch(plans, 2, workers)
    return rows


def join_outliers(rows: native.BatchRows):
    """:func:`host_entropy_rows`' rows -> the narrow form of
    :func:`compact_coefficients`: ``(dc16, acN, exc_idx, exc_val)``, the
    streams' outlier lists joined in order (flat indices ascending, as
    ``compact_coefficients`` lists them)."""
    have = np.flatnonzero(rows.counts)  # none for int16 rows
    if not have.size:
        return rows.dc, rows.ac, np.zeros(0, np.int64), np.zeros(0, np.int16)
    return (rows.dc, rows.ac,
            np.concatenate([rows.idx[s, :rows.counts[s]] for s in have]),
            np.concatenate([rows.val[s, :rows.counts[s]] for s in have]))


_TABLE_RANGE_MESSAGE = (
    "coefficient magnitude exceeds the standard Huffman table range "
    "(quality too high for this input); re-encode with "
    "auto_generate_huffman_table=True -- dynamic tables extend to DC "
    "category 15 / AC size 15")


def _block_row(dc_diff: np.ndarray, ac: np.ndarray) -> tuple[np.ndarray, int]:
    """One block's (1,) DC difference and (1, 63) AC -> its (52,) uint32
    row, packed from bit 0 as ``encode1`` packs it, and its bit count: the
    standard tables through the C encoder of ``native``."""
    try:
        payload, nbits = native.entropy_encode(dc_diff, ac)
    except ValueError:
        raise ValueError(_TABLE_RANGE_MESSAGE) from None
    row = np.zeros(BLOCK_WORDS * 4, np.uint8)
    row[:len(payload)] = np.frombuffer(payload, np.uint8)
    return row.view(">u4").astype(np.uint32), nbits


def _stream_key(data: bytes) -> tuple[int, int, int, bool]:
    """(height, width, quality, scaled_dct) of a stream's header: streams
    with equal keys share one batched transform."""
    h, w, q, flag = container.parse_header(data)
    return h, w, q, bool(flag & FLAG_SCALED_DCT) and not (
        flag & FLAG_CUSTOM_TABLE)


class Engine:
    """Holds the precision and the device the codec runs on.

    ``device=None`` is the CUDA card; constructing an engine without one
    raises ``RuntimeError`` (pass ``device="cpu"`` to run the plain
    versions of the kernels, as the tests do).
    """

    def __init__(self, precision: str = transform.EXACT,
                 device: str | torch.device | None = None,
                 device_entropy: bool = True):
        """``device_entropy=False`` sends every stream through the host
        entropy leg (the transform still runs on ``device``)."""
        if precision not in (transform.EXACT, transform.FAST):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision
        self.device = resolve_device(device)
        self.device_entropy = bool(device_entropy)
        self.decode_stats = self._zero_stats()

    @staticmethod
    def _zero_stats() -> dict[str, int]:
        return {"kernel": 0, "host_entropy": 0, "host_decoder": 0}

    def compress(
        self, image: np.ndarray, quality: int = 50,
        auto_table: bool = False, block_index: bool | None = None,
        index_stride: int = container.INDEX_STRIDE,
    ) -> bytes:
        image = np.asarray(image)
        if image.ndim != 2:
            raise ValueError("expected a 2-D grayscale image")
        if block_index is None:
            block_index = True
        if auto_table:
            return self._compress_auto_table(image, int(quality),
                                             block_index, index_stride)
        # odd shapes are reflect-padded inside; the header keeps (H, W)
        return compress_batch_device(
            image[None], quality, precision=self.precision,
            block_index=block_index, index_stride=index_stride,
            device=self.device,
        )[0]

    def _compress_auto_table(self, image: np.ndarray, quality: int,
                             block_index: bool, index_stride: int) -> bytes:
        """Frequency-optimal Huffman tables for this image; the bytes of
        ``container.compress(image, quality, True, block_index=...)`` in
        exact mode.

        Coefficients on the device (exact: ``exact_transform``, which
        settles its flagged blocks in the oracle's arithmetic; fast: the
        float32 transform pass of ``encode2``), in block ranges of at most
        ``pipeline.MAX_PIXELS`` pixels; their symbol histograms and
        per-block maxima on the device too (``symbol_stats``, one launch a
        range, one pull of its counts), then the table on the host (the
        same canonical construction as the host path).  Then, before any
        encode launch, the route: the host container when the table is
        ``extended`` or some block would take more than
        ``KERNEL_BLOCK_BITS`` (the block rule of the JAX package,
        ``ops/entropy.py:263-268``; its other rule, no symbol slot above
        64 bits, does not apply: the kernel's bit sink takes the ZRL
        prefix and the code apart), else, range by range, ``encode2`` from
        the coefficients with the new tables (the DC predictor carried
        from range to range) and ``place``, the ranges stitched at bit
        offsets after the table segment.  No block passes
        ``SymbolStats.block_bits_bound`` of the longest code; only where
        that bound passes ``KERNEL_BLOCK_BITS`` or the table is extended
        are the coefficients pulled, for the exact per-block bit counts
        (``block_bit_counts``) and the host container.

        Stages (``codec.encode.*``): ``upload`` (the padding, then each
        range's copy and ``blockify``), ``transform``, ``table``
        (``symbol_stats``, the canonical tables, the route, and, nested in
        it, ``pull`` where the coefficients come to the host; counts
        ``blocks``, ``dc_symbols`` and ``ac_symbols`` (the symbols given a
        code), ``longest`` (the longest code), ``host_route`` and
        ``coeffs_pulled``), then on the kernel route ``entropy``,
        ``place``, ``pull`` (the blocks' offsets) and ``assemble`` (the
        join, the header, the table segment, the trailer); on the host
        route ``fallback`` (count ``images``)."""
        h, w = image.shape
        dev = self.device
        with profiling.span("codec.encode.upload"):
            padded = np.ascontiguousarray(
                transform.pad_to_blocks(image.astype(np.uint8, copy=False)))
            tables = CodecTables.build(quality, dev)
        h8, w8 = padded.shape
        nb = (h8 // 8) * (w8 // 8)
        # in sub-ranges of at most one kernel call's pixels, as the
        # pipeline cuts an image of more than ``MAX_PIXELS``
        zz_list = range_coefficients(padded, 0, nb, tables, self.precision,
                                     dev)
        # the coefficients stay on the device unless the route needs them;
        # the header needs only the shape and quality
        dc, ac = np.zeros(0, np.int32), np.zeros((0, 63), np.int32)
        with profiling.span("codec.encode.table") as stage:
            stats = symbol_stats(zz_list)
            spec = build_huffman_spec_from_counts(stats.dc_counts,
                                                  stats.ac_counts)
            longest = int(max(spec.dc_len.max(), spec.ac_len.max()))
            pulled = bool(spec.extended or stats.block_bits_bound(longest)
                          > KERNEL_BLOCK_BITS)
            host_route = spec.extended
            if pulled:
                with profiling.span("codec.encode.pull"):
                    zz_np = np.concatenate(
                        [zz.cpu().numpy() for zz in zz_list], axis=1)
                dc = np.diff(zz_np[0], prepend=np.int32(0)).astype(np.int32)
                ac = np.ascontiguousarray(zz_np[1:].T)
                host_route = bool(host_route or int(block_bit_counts(
                    dc, ac, spec).max()) > KERNEL_BLOCK_BITS)
            if not host_route:
                tables = CodecTables.from_spec(spec, quality, dev)
            stage.set(blocks=nb, dc_symbols=int(np.count_nonzero(
                spec.dc_len)), ac_symbols=int(np.count_nonzero(spec.ac_len)),
                longest=longest, host_route=int(host_route),
                coeffs_pulled=int(pulled))
        arrays = CodecArrays(height=h, width=w, quality=quality, dc=dc,
                             ac=ac)
        if host_route:
            with profiling.span("codec.encode.fallback", images=1):
                return container.compress_arrays(
                    arrays, True, block_index=block_index, spec=spec,
                    index_stride=index_stride,
                )
        segments, offsets, table_over = encode_ranges(
            zz_list, tables, None, bits_per_pixel_budget=4.0,
            with_offsets=block_index)
        if table_over:
            raise TableRangeError()
        with profiling.span("codec.encode.assemble"):
            words, total = concat_bits(segments, torch.device("cpu"))
            writer = BitWriter()
            writer.write_bytes(container.make_header(arrays,
                                                     custom_table=True))
            container.write_huffman_table(writer, spec.string_tables())
            data = concat_bit_payload(writer.to_bytes(), writer.bit_length(),
                                      stream_bytes(words, total), total)
            if block_index:
                # payload-relative offsets: the image starts at bit 0
                data += container.make_block_index(offsets,
                                                   stride=index_stride)
        return data

    def encode_to_words(self, image: np.ndarray,
                        quality: int) -> tuple[np.ndarray, np.ndarray]:
        """One image -> ``(words, block_bits)``: (nb, 52) uint32, each
        block's code words packed big-endian from bit 0 of its own row
        (zero after its last bit), and (nb,) int32 bit counts, with the DC
        predictor reset at the first block.  Exact mode gives the float64
        oracle's symbols: the JAX package's ``Engine.encode_to_words`` bit
        for bit.  ``native.stitch(words, block_bits)`` is the payload.

        ``encode1`` on the device, from ``exact_coefficients`` (exact) or
        from the pixels (fast), in the block ranges of
        ``pipeline.sub_ranges`` (one call each); the first block of a later
        range was coded with the predictor reset, so its row is coded
        again on the host from the previous range's last DC.  A
        coefficient outside the standard tables raises ``ValueError``."""
        image = np.asarray(image)
        if image.ndim != 2:
            raise ValueError("expected a 2-D grayscale image")
        quality = int(quality)
        padded = np.ascontiguousarray(
            transform.pad_to_blocks(image.astype(np.uint8, copy=False)))
        nb = (padded.shape[0] // 8) * (padded.shape[1] // 8)
        dev = self.device
        tables = CodecTables.build(quality, dev)
        ranges = sub_ranges(0, nb)
        words, bits, over = [], [], []
        prev_dc = 0
        for k, (a, b) in enumerate(ranges):
            blocks = range_blocks(padded, a, b, dev)
            if self.precision == transform.EXACT:
                zz = exact_coefficients(blocks, tables)
                w, n, flag = encode1(zz.T.contiguous(), tables, b - a,
                                     from_zz=True)
            else:
                w, n, flag = encode1(blocks, tables, b - a)
                # the coefficients the range ends need, only with a next
                zz = (fast_coefficients(blocks[[0, -1]], tables)
                      if len(ranges) > 1 else None)
            words.append(w.cpu().numpy().view(np.uint32))
            bits.append(n.cpu().numpy())
            over.append(bool(flag))
            if k:
                first = zz[:, 0].cpu().numpy().astype(np.int32)
                words[k][0], bits[k][0] = _block_row(
                    first[:1] - prev_dc, first[None, 1:])
            if zz is not None:
                prev_dc = int(zz[0, -1])
        if any(over):
            raise ValueError(_TABLE_RANGE_MESSAGE)
        return np.concatenate(words), np.concatenate(bits)

    # -- decode ----------------------------------------------------------
    def _pixels(self, zz: torch.Tensor, h: int, w: int, quality: int,
                scaled: bool, tables: DecodeTables | None = None):
        """(B, nb, 64) int32 coefficients on the device, DC still DPCM'd
        -> (B, h, w) uint8 numpy.  Exact: one ``exact_inverse`` launch,
        which settles the blocks flagged as sitting on a floor boundary on
        the card; their count, ``flagged`` on the transform span, is read
        after the pull, and only while the spans record.  Fast: the plain
        float32 transform."""
        if tables is None:
            tables = DecodeTables.build(quality, scaled, zz.device)
        if self.precision == transform.EXACT:
            with profiling.span("codec.decode.transform") as stage:
                imgs, flagged = exact_inverse(zz, h, w, tables)
            with profiling.span("codec.decode.pull"):
                out = imgs.cpu().numpy()
            if profiling.active():
                stage.set(flagged=int(flagged))
            return out
        with profiling.span("codec.decode.transform"):
            blocks = transform.decode_blocks(
                transform.undo_dpcm(zz), quality, scaled_dct=scaled,
                tables=tables)
        h8 = -(-h // 8) * 8
        w8 = -(-w // 8) * 8
        with profiling.span("codec.decode.pull"):
            imgs = transform.unblockify(blocks, h8, w8)[:, :h, :w]
            return imgs.contiguous().cpu().numpy()

    def _decompress_batch_device(self, streams: list[bytes]):
        """Uniform TICX streams -> (B, H, W) uint8 with the entropy stage
        on the device, or ``None`` when the batch is not eligible
        (``prepare_batch``, or an image of more than ``MAX_DECODE_BLOCKS``
        blocks).  A batch of more blocks than that is decoded in
        sub-batches cut at image boundaries.  Images with a chunk that
        fails validation are decoded by the host decoder."""
        h, w, _, _ = container.parse_header(streams[0])
        per = MAX_DECODE_BLOCKS // (-(-h // 8) * -(-w // 8))
        if per < 1:
            return None
        batches = [streams[i:i + per] for i in range(0, len(streams), per)]
        with profiling.span("codec.decode.prepare") as stage:
            preps = [prepare_batch(part) for part in batches]
            # custom-table payloads are realigned to a byte, one by one
            stage.set(streams=len(streams), realigned=sum(
                len(part) for part, prep in zip(batches, preps)
                if prep is not None and prep["tables"] is not None))
        if any(p is None for p in preps):
            return None
        parts = [self._decode_prepared(prep, part)
                 for prep, part in zip(preps, batches)]
        # one sub-batch (the rule) is returned as it is: a copy of its
        # pixels into fresh memory costs more than the decode kernel
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def _decode_prepared(self, prep: dict, streams: list[bytes]):
        """One ``prepare_batch`` result -> (B, H, W) uint8."""
        dev = self.device
        h, w, quality = prep["shape"]
        scaled = bool(prep["scaled_dct"])
        with profiling.span("codec.decode.upload"):
            tables = DecodeTables.build(quality, scaled, dev,
                                        huffman=prep["tables"])
            words = torch.from_numpy(prep["words"].view(np.int32)).to(dev)
            # the chunk arrays in one copy: rows of one (6, C) table
            chunks = torch.from_numpy(chunk_table(prep)).to(dev)
        with profiling.span("codec.decode.entropy"):
            zz, ok = entropy_decode_chunks(
                words, *chunks[:5], prep["nb_total"], tables)
        imgs = self._pixels(
            zz.reshape(len(streams), prep["nb_per_image"], 64), h, w,
            quality, scaled, tables,
        )
        ok_np = ok.cpu().numpy()
        failed = np.unique(prep["chunk_img"][~ok_np])
        if len(failed):
            with profiling.span("codec.decode.fallback", images=len(failed)):
                for i in failed:
                    imgs[i] = container.decompress(streams[int(i)])
        self.decode_stats["kernel"] += len(streams) - len(failed)
        self.decode_stats["host_decoder"] += len(failed)
        return imgs

    def _upload(self, compact) -> torch.Tensor:
        """``compact()``, the narrow form of :func:`compact_coefficients`
        (``codec.decode.compact``, counts ``outliers`` and ``wide``: 1
        where the AC goes up as int16) -> (B, nb, 64) int32 on the device:
        uploaded and widened there (``codec.decode.upload``)."""
        dev = self.device
        with profiling.span("codec.decode.compact") as stage:
            narrow = compact()
            stage.set(outliers=int(narrow[2].size),
                      wide=int(narrow[1].dtype == np.int16))
        with profiling.span("codec.decode.upload"):
            return widen_coefficients(
                *(torch.from_numpy(x).to(dev) for x in narrow), dev)

    def _arrays_pixels(self, key: tuple[int, int, int, bool],
                       zz: torch.Tensor) -> np.ndarray:
        """Coefficients ``zz`` on the device of images of one
        ``_stream_key`` ``key`` -> (B, H, W) uint8: one batched transform
        there."""
        h, w, quality, scaled = key
        return self._pixels(zz, h, w, quality, scaled)

    def _decompress_batch(self, streams: list[bytes]):
        if not streams:
            raise ValueError("empty batch")
        keys = [_stream_key(d) for d in streams]
        if any(k != keys[0] for k in keys[1:]):
            # mixed shapes or qualities: consecutive uniform runs, each
            # through the batched path, a list back in input order
            out: list[np.ndarray] = []
            start = 0
            for i in range(1, len(streams) + 1):
                if i == len(streams) or keys[i] != keys[start]:
                    out.extend(self._decompress_batch(streams[start:i]))
                    start = i
            if len({o.shape for o in out}) == 1:
                # same shapes, mixed qualities: still a stacked array
                return np.stack(out)
            return out
        if self.device_entropy:
            out = self._decompress_batch_device(streams)
            if out is not None:
                return out
        with profiling.span("codec.decode.host_entropy") as stage:
            rows = host_entropy_rows(streams)
            stage.set(streams=len(streams),
                      threads=host_entropy_workers(len(streams)),
                      narrow=len(streams) if rows.ac.dtype == np.int8 else 0)
        zz = self._upload(lambda: join_outliers(rows))
        self.decode_stats["host_entropy"] += len(streams)
        return self._arrays_pixels(keys[0], zz)

    def decompress_batch(self, streams: list[bytes]):
        """Compressed streams -> decoded uint8 images: a stacked
        (B, H, W) array, or a list of (H, W) arrays in input order when
        the shapes differ."""
        self.decode_stats = self._zero_stats()
        return self._decompress_batch(list(streams))

    def decompress(self, data: bytes) -> np.ndarray:
        """One stream: the batch of one."""
        return self.decompress_batch([data])[0]

    def decode_arrays(self, arrays: CodecArrays) -> np.ndarray:
        """Coefficient arrays (already entropy-decoded) -> image, with the
        transform on the device."""
        zz = self._upload(lambda: compact_coefficients(
            np.stack([arrays.dc]), np.stack([arrays.ac])))
        return self._arrays_pixels((arrays.height, arrays.width,
                                    int(arrays.quality),
                                    bool(arrays.scaled_dct)), zz)[0]
