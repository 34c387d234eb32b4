"""The engine: one-image encode, and decode of one stream or a batch.

The counterpart of the JAX package's ``engine.Engine``.  ``compress`` runs
the batch pipeline with B = 1, so the one-image entry point and the batch
entry point are the same program.

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
  inadmissible table, mixed batches) are entropy-decoded by the
  pure-Python cursor of ``container`` and transformed on the device.

``decode_stats`` counts the images each leg took in the last call.
"""

from __future__ import annotations

import numpy as np
import torch

from . import container, golden
from .constants import FLAG_CUSTOM_TABLE, FLAG_SCALED_DCT, ZIGZAG_ORDER
from .device import resolve_device
from .golden import CodecArrays
from .ops import transform
from .ops.entropy_decode import entropy_decode_chunks, prepare_batch
from .pipeline import compress_batch_device
from .tables import DecodeTables, dequant_multipliers

_CHUNK_KEYS = ("chunk_start", "chunk_blocks", "chunk_block_base",
               "chunk_end_lo", "chunk_end_hi")


def _host_decode_blocks(zz_rows: np.ndarray, quality: int,
                        scaled_dct: bool) -> np.ndarray:
    """(k, 64) zig-zag rows (running DC) -> (k, 8, 8) uint8: the float64
    oracle's arithmetic, used to settle the flagged blocks."""
    coeffs = np.zeros((zz_rows.shape[0], 64), np.float64)
    coeffs[:, ZIGZAG_ORDER] = zz_rows
    coeffs = coeffs.reshape(-1, 8, 8)
    pix = golden.block_idct(coeffs * dequant_multipliers(quality, scaled_dct))
    return np.clip(pix + 128.0, 0.0, 255.0).astype(np.uint8)


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
            raise NotImplementedError(
                "dynamic Huffman tables on the device wait for the "
                "auto-table encode slice of the port; use backend='host'"
            )
        # odd shapes are reflect-padded inside; the header keeps (H, W)
        return compress_batch_device(
            image[None], quality, precision=self.precision,
            block_index=block_index, index_stride=index_stride,
            device=self.device,
        )[0]

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
        (``prepare_batch``).  Images with a chunk that fails validation
        are decoded by the host decoder."""
        prep = prepare_batch(streams)
        if prep is None:
            return None
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
        zz = np.concatenate(
            [np.stack([a.dc for a in arrays])[..., None],
             np.stack([a.ac for a in arrays])], axis=-1,
        ).astype(np.int32)
        return self._pixels(
            torch.from_numpy(zz).to(self.device), a0.height, a0.width,
            int(a0.quality), bool(a0.scaled_dct),
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
        arrays = [container.decompress_to_arrays(d) for d in streams]
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
