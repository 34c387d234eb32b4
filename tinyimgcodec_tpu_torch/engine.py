"""The engine: one-image encode, and decode of one stream or a batch.

The counterpart of the JAX package's ``engine.Engine``.  ``compress`` runs
the batch pipeline with B = 1, so the one-image entry point and the batch
entry point are the same program.  ``compress(..., auto_table=True)`` codes
the image with Huffman tables built for it at run time: coefficients on
the device, histograms and tables on the host, then the same ``encode2`` +
``place`` kernels with the new tables (or the host container when the
tables leave the kernels' range).

Decode has three legs, chosen per stream by what the *stream* is, never
by what the device or the build did:

- **kernel**: a uniform batch of TICX-indexed streams (standard tables or
  one shared admissible dynamic table) is entropy-decoded on the device,
  one thread per chunk (``ops/entropy_decode.py``), then undo-DPCM,
  dequantize + inverse DCT (``ops/transform.py``), a float64 host
  recompute of the blocks flagged as sitting on a floor boundary, crop,
  and one pull of the pixels;
- **host decoder**: an image of such a batch with a chunk that failed
  validation (a corrupt stream) is decoded by ``container.decompress``,
  which degrades block by block as the reference does;
- **host entropy**: streams the kernel leg cannot take (no trailer, an
  inadmissible table, an image of more than ``MAX_DECODE_BLOCKS`` blocks)
  are entropy-decoded by the C decoder of ``native`` (through
  ``container``), one thread a stream, and transformed on the device.

A uniform batch of more than ``MAX_DECODE_BLOCKS`` blocks is decoded on
the kernel leg in sub-batches cut at image boundaries.

``decode_stats`` counts the images each leg took in the last call.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import container, golden
from .bitstream import BitWriter, concat_bit_payload
from .constants import FLAG_CUSTOM_TABLE, FLAG_SCALED_DCT, ZIGZAG_ORDER
from .device import resolve_device
from .golden import CodecArrays
from .huffman import (
    block_bit_counts, build_huffman_spec_from_counts, symbol_counts,
)
from .ops import transform
from .ops.entropy_decode import entropy_decode_chunks, prepare_batch
from .parallel import tiled
from .pipeline import TableRangeError, compress_batch_device, stream_bytes
from .tables import CodecTables, DecodeTables, dequant_multipliers

_CHUNK_KEYS = ("chunk_start", "chunk_blocks", "chunk_block_base",
               "chunk_end_lo", "chunk_end_hi")

# The most blocks one decode launch takes: its coefficient output is
# indexed in int32 (nb_total * 64 < 2**31, ops/entropy_decode.py).
MAX_DECODE_BLOCKS = (1 << 31) // 64 - 1
# The most bits a block may take on the encode kernels: ``encode2``'s row,
# the ``n * 52``-word capacity retry and its ``MAX_BLOCKS`` assume it.
KERNEL_BLOCK_BITS = 52 * 32


def _host_decode_blocks(zz_rows: np.ndarray, quality: int,
                        scaled_dct: bool) -> np.ndarray:
    """(k, 64) zig-zag rows (running DC) -> (k, 8, 8) uint8: the float64
    oracle's arithmetic, used to settle the flagged blocks."""
    coeffs = np.zeros((zz_rows.shape[0], 64), np.float64)
    coeffs[:, ZIGZAG_ORDER] = zz_rows
    coeffs = coeffs.reshape(-1, 8, 8)
    pix = golden.block_idct(coeffs * dequant_multipliers(quality, scaled_dct))
    return np.clip(pix + 128.0, 0.0, 255.0).astype(np.uint8)


def stack_coefficients(arrays: list[CodecArrays]) -> np.ndarray:
    """Host-decoded coefficient arrays of one shape -> (B, nb, 64) int32,
    the DC differences in column 0: what the host-entropy leg uploads for
    its transform on the device."""
    return np.concatenate(
        [np.stack([a.dc for a in arrays])[..., None],
         np.stack([a.ac for a in arrays])], axis=-1,
    ).astype(np.int32)


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

        Coefficients on the device (exact: ``exact_transform`` + the
        float64 recompute of flagged blocks; fast: the float32 transform
        pass of ``encode2``), in block ranges of at most
        ``pipeline.MAX_PIXELS`` pixels, pulled once for the histograms and
        the table (the same canonical construction as the host path).
        Then, before any launch, the route: the host container when the
        table is ``extended`` or some block would take more than
        ``KERNEL_BLOCK_BITS`` (the block rule of the JAX package,
        ``ops/entropy.py:263-268``; its other rule, no symbol slot above
        64 bits, does not apply: the kernel's bit sink takes the ZRL
        prefix and the code apart), else, range by range, ``encode2`` from
        the coefficients with the new tables (the DC predictor carried
        from range to range) and ``place``, the ranges stitched at bit
        offsets after the table segment."""
        h, w = image.shape
        padded = np.ascontiguousarray(
            transform.pad_to_blocks(image.astype(np.uint8, copy=False)))
        h8, w8 = padded.shape
        nb = (h8 // 8) * (w8 // 8)
        dev = self.device
        # in sub-ranges of at most one kernel call's pixels, as the tiled
        # path cuts an image of more than ``MAX_PIXELS``
        zz_list = tiled.range_coefficients(
            padded, 0, nb, quality, CodecTables.build(quality, dev),
            self.precision, dev)
        zz_np = np.concatenate([zz.cpu().numpy() for zz in zz_list], axis=1)
        dc = np.diff(zz_np[0], prepend=np.int32(0)).astype(np.int32)
        ac = np.ascontiguousarray(zz_np[1:].T)
        spec = build_huffman_spec_from_counts(*symbol_counts(dc, ac))
        arrays = CodecArrays(height=h, width=w, quality=quality, dc=dc,
                             ac=ac)
        if (spec.extended or int(block_bit_counts(dc, ac, spec).max())
                > KERNEL_BLOCK_BITS):
            return container.compress_arrays(
                arrays, True, block_index=block_index, spec=spec,
                index_stride=index_stride,
            )
        segments, offsets, table_over = tiled.encode_ranges(
            zz_list, CodecTables.from_spec(spec, quality, dev), None,
            bits_per_pixel_budget=4.0, with_offsets=block_index)
        if table_over:
            raise TableRangeError()
        words, total = tiled.concat_bits(
            [(w.cpu(), bits) for w, bits in segments], torch.device("cpu"))
        writer = BitWriter()
        writer.write_bytes(container.make_header(arrays, custom_table=True))
        container.write_huffman_table(writer, spec.string_tables())
        data = concat_bit_payload(writer.to_bytes(), writer.bit_length(),
                                  stream_bytes(words, total), total)
        if block_index:
            # payload-relative offsets: the image starts at bit 0
            data += container.make_block_index(offsets, stride=index_stride)
        return data

    # -- decode ----------------------------------------------------------
    def _pixels(self, zz: torch.Tensor, h: int, w: int, quality: int,
                scaled: bool, tables: DecodeTables | None = None):
        """(B, nb, 64) int32 coefficients on the device, DC still DPCM'd
        -> (B, h, w) uint8 numpy; blocks flagged as sitting on a floor
        boundary are recomputed in float64 on the host."""
        b, nb, _ = zz.shape
        zz_abs = transform.undo_dpcm(zz)
        blocks, flags = transform.decode_blocks(
            zz_abs, quality, self.precision, scaled_dct=scaled,
            with_flags=True, tables=tables,
        )
        idx = torch.nonzero(flags.reshape(-1)).reshape(-1)  # host sync
        if idx.numel():
            rows = zz_abs.reshape(-1, 64)[idx].cpu().numpy()
            fixed = _host_decode_blocks(rows, quality, scaled)
            blocks = blocks.reshape(-1, 8, 8)
            blocks[idx] = torch.from_numpy(fixed).to(blocks.device)
            blocks = blocks.reshape(b, nb, 8, 8)
        h8 = -(-h // 8) * 8
        w8 = -(-w // 8) * 8
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
        preps = [prepare_batch(streams[i:i + per])
                 for i in range(0, len(streams), per)]
        if any(p is None for p in preps):
            return None
        parts = [self._decode_prepared(prep, streams[k * per:(k + 1) * per])
                 for k, prep in enumerate(preps)]
        # one sub-batch (the rule) is returned as it is: a copy of its
        # pixels into fresh memory costs more than the decode kernel
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def _decode_prepared(self, prep: dict, streams: list[bytes]):
        """One ``prepare_batch`` result -> (B, H, W) uint8."""
        dev = self.device
        h, w, quality = prep["shape"]
        scaled = bool(prep["scaled_dct"])
        tables = DecodeTables.build(quality, scaled, dev,
                                    huffman=prep["tables"])
        words = torch.from_numpy(prep["words"].view(np.int32)).to(dev)
        chunks = [torch.from_numpy(prep[k]).to(dev) for k in _CHUNK_KEYS]
        zz, ok = entropy_decode_chunks(
            words, *chunks, prep["nb_total"], tables)
        imgs = self._pixels(
            zz.reshape(len(streams), prep["nb_per_image"], 64), h, w,
            quality, scaled, tables,
        )
        ok_np = ok.cpu().numpy()
        failed = np.unique(prep["chunk_img"][~ok_np])
        for i in failed:
            imgs[i] = container.decompress(streams[int(i)])
        self.decode_stats["kernel"] += len(streams) - len(failed)
        self.decode_stats["host_decoder"] += len(failed)
        return imgs

    def _decode_uniform_arrays(self, arrays: list[CodecArrays]) -> np.ndarray:
        """Host-decoded coefficient arrays of equal shape and quality ->
        (B, H, W) uint8: one batched transform on the device."""
        a0 = arrays[0]
        return self._pixels(
            torch.from_numpy(stack_coefficients(arrays)).to(self.device),
            a0.height, a0.width, int(a0.quality), bool(a0.scaled_dct),
        )

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
        if len(streams) > 1:
            # one C decode a stream, concurrently (the ctypes call releases
            # the GIL); no TICX threads inside them, which would
            # oversubscribe the cores
            workers = min(len(streams), os.cpu_count() or 1)
            with ThreadPoolExecutor(workers) as pool:
                arrays = list(pool.map(
                    lambda d: container.decompress_to_arrays(
                        d, index_workers=1), streams))
        else:
            arrays = [container.decompress_to_arrays(streams[0])]
        self.decode_stats["host_entropy"] += len(streams)
        return self._decode_uniform_arrays(arrays)

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
        return self._decode_uniform_arrays([arrays])[0]
