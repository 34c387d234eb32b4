"""Container format: header + entropy-coded payload <-> bytes (host path).

Wire format (reference-compatible where the reference is self-consistent):

- 16-byte header: ``height, width, quality, flag`` as four little-endian
  uint32 (reference codec.py:102-130 / c/img.c:183-192 write these in native
  byte order, which is LE on every supported platform).
- flag bit 31: a custom Huffman table immediately follows the header.
  NOTE: the reference *writes* this flag in big-endian bit order so its own
  decoder never sees it (verified bug, SURVEY quirk 2.5-1).  We write the
  flag little-endian like every other field, making the custom-table path
  actually round-trip; such streams are a documented extension.
- flag bit 30: "scaled DCT" stream from the embedded fixed-point encoder;
  the quality field then holds the qfactor shift 0..3 (c/img.c:183-192).
- Payload: per block, DC category code + magnitude bits, then AC (run,size)
  codes + magnitude bits, terminated by EOB -- big-endian bit packing,
  zero-padded to a byte boundary.

This module is the host/golden path and the byte oracle of the port:
the CUDA pipeline's exact mode produces identical bytes (tested).
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

from . import golden, native
from .bitstream import BitReader, BitWriter, bits_to_bytes
from .constants import (
    AC,
    DC,
    FLAG_CUSTOM_TABLE,
    FLAG_SCALED_DCT,
    HEADER_BYTES,
    string_code_tables,
)
from .golden import CodecArrays, bits_required
from .huffman import HuffmanSpec, build_huffman_spec

_DEFAULT_TABLES = string_code_tables()

# -- block-offset index extension (TICX) --------------------------------
#
# An optional trailer appended AFTER the payload: bit offsets of every
# INDEX_STRIDE-th block, enabling index-parallel entropy decode (the
# payload's variable-length codes otherwise force a serial bit cursor,
# SURVEY 3.2).  Reference decoders provably ignore trailing bytes (the
# per-block loop reads exactly nblocks blocks, codec.py:175-186; quirk
# 2.5-3/10), so indexed streams remain reference-decodable.
#
# Layout (little-endian), followed by [u32 body_len]["TICX"]:
#   u8 version(=1) | u8 log2(stride) | u16 0 | u32 n | u32 offsets[n]
INDEX_MAGIC = b"TICX"
INDEX_STRIDE = 64  # blocks per independently decodable chunk


def make_block_index(
    offsets: np.ndarray, stride: int = INDEX_STRIDE
) -> bytes:
    """Per-block payload bit offsets (nb,) -> TICX trailer bytes."""
    if stride & (stride - 1):
        raise ValueError("stride must be a power of two")
    sel = np.ascontiguousarray(offsets[::stride], dtype="<u4")
    body = (
        struct.pack("<BBHI", 1, stride.bit_length() - 1, 0, len(sel))
        + sel.tobytes()
    )
    return body + struct.pack("<I", len(body)) + INDEX_MAGIC


def index_fields(data: bytes, nblocks: int):
    """A TICX trailer's fixed fields, checked; its offsets are not read.

    Returns ``(start, stride, n)``: the trailer's first byte (the
    payload's end), the blocks a chunk and the count of chunk offsets; or
    None when there is no trailer, or its lengths, version, reserved field
    or chunk count do not fit ``nblocks``.  :func:`index_offsets_valid`
    checks the offsets themselves.
    """
    if len(data) < HEADER_BYTES + 16 or data[-4:] != INDEX_MAGIC:
        return None
    (body_len,) = struct.unpack_from("<I", data, len(data) - 8)
    start = len(data) - 8 - body_len
    if start < HEADER_BYTES or body_len < 8:
        return None
    version, lg_stride, reserved, n = struct.unpack_from("<BBHI", data, start)
    if version != 1 or reserved != 0 or body_len != 8 + 4 * n:
        return None
    stride = 1 << lg_stride
    if n == 0 or n != -(-nblocks // stride):
        return None
    return start, stride, n


def index_offsets_valid(off: np.ndarray, payload_bits) -> bool:
    """Whether every row of ``off`` ((B, n) int64 chunk bit offsets, one
    stream a row) starts at 0, rises strictly and ends before its
    stream's ``payload_bits`` (an int, or a (B,) array)."""
    return bool((off[:, 0] == 0).all()
                and (off[:, 1:] > off[:, :-1]).all()
                and (off[:, -1] < payload_bits).all())


def parse_block_index(data: bytes, nblocks: int):
    """Detect + validate a TICX trailer.

    Returns (chunk_bit_offsets, stride, payload_end_byte) or None.  The
    structural checks (exact length bookkeeping, monotone in-range
    offsets, matching chunk count) make an accidental payload collision
    with the magic effectively impossible; any inconsistency degrades to
    index-less serial decode.
    """
    fields = index_fields(data, nblocks)
    if fields is None:
        return None
    start, stride, n = fields
    off = np.frombuffer(data, dtype="<u4", count=n, offset=start + 8)
    off = off.astype(np.int64)
    if not index_offsets_valid(off[None], (start - HEADER_BYTES) * 8):
        return None
    return off, stride, start


def make_header(arrays: CodecArrays, custom_table: bool = False) -> bytes:
    flag = 0
    if custom_table:
        flag |= FLAG_CUSTOM_TABLE
    if arrays.scaled_dct:
        flag |= FLAG_SCALED_DCT
    return struct.pack(
        "<IIII", arrays.height, arrays.width, arrays.quality, flag
    )


def parse_header(data: bytes) -> tuple[int, int, int, int]:
    if len(data) < HEADER_BYTES:
        raise ValueError("truncated header")
    height, width, quality, flag = struct.unpack_from("<IIII", data)
    return height, width, quality, flag


def write_huffman_table(writer: BitWriter, tables: dict[str, dict]) -> None:
    """Serialize custom tables (extension of reference codec.py:73-84).

    Deviation from the reference wire layout: code lengths are stored as u8
    for both DC and AC (the reference's u4 DC length field cannot represent
    lengths >= 16, which its own tree construction can produce).
    """
    writer.write_uint(len(tables[DC]), 16)
    for category, codeword in tables[DC].items():
        writer.write_uint(category, 4)
        writer.write_uint(len(codeword), 8)
        writer.write_bitstring(codeword)
    writer.write_uint(len(tables[AC]), 16)
    for (run, size), codeword in tables[AC].items():
        writer.write_uint(run, 4)
        writer.write_uint(size, 4)
        writer.write_uint(len(codeword), 8)
        writer.write_bitstring(codeword)


def read_huffman_table(reader: BitReader) -> dict[str, dict]:
    dc: dict[int, str] = {}
    for _ in range(reader.read_uint(16)):
        category = reader.read_uint(4)
        length = reader.read_uint(8)
        code = reader.read_uint(length)
        dc[category] = format(code, f"0{length}b")
    ac: dict[tuple[int, int], str] = {}
    for _ in range(reader.read_uint(16)):
        run = reader.read_uint(4)
        size = reader.read_uint(4)
        length = reader.read_uint(8)
        code = reader.read_uint(length)
        ac[(run, size)] = format(code, f"0{length}b")
    return {DC: dc, AC: ac}


def _encode_payload(
    arrays: CodecArrays,
    tables: dict[str, dict],
    writer: BitWriter,
    offsets_out: list[int] | None = None,
) -> None:
    dc_tab, ac_tab = tables[DC], tables[AC]
    dc = arrays.dc
    ac = arrays.ac
    base = writer.bit_length()
    try:
        for i in range(arrays.nblocks):
            if offsets_out is not None:
                offsets_out.append(writer.bit_length() - base)
            d = int(dc[i])
            cat = int(bits_required(np.int32(d)))
            writer.write_bitstring(dc_tab[cat])
            writer.write_int(d)
            for run, value in golden.run_length_encode(ac[i]):
                size = int(bits_required(np.int32(value)))
                writer.write_bitstring(ac_tab[(run, size)])
                writer.write_int(value)
    except KeyError as e:
        # standard Annex-K tables stop at DC category 11 / AC size 10;
        # qualities 97-99 can exceed that on high-contrast input (the
        # reference dies with this same bare KeyError, codec.py:153-162)
        raise ValueError(
            "coefficient magnitude exceeds the standard Huffman table "
            f"range (symbol {e.args[0]!r}); re-encode with "
            "auto_generate_huffman_table=True -- dynamic tables extend "
            "to DC category 15 / AC size 15"
        ) from None


def compress(
    image: np.ndarray,
    quality: int = 50,
    auto_generate_huffman_table: bool = False,
    block_index: bool = False,
    index_stride: int = INDEX_STRIDE,
) -> bytes:
    """Image -> bytes (host/golden path; reference codec.py:133-164).

    block_index=True appends the TICX trailer for parallel decode;
    index_stride sets its chunk granularity (power of two).
    """
    arrays = golden.encode_arrays(np.asarray(image), quality)
    return compress_arrays(
        arrays, auto_generate_huffman_table, block_index,
        index_stride=index_stride,
    )


def compress_arrays(
    arrays: CodecArrays,
    auto_generate_huffman_table: bool = False,
    block_index: bool = False,
    spec: HuffmanSpec | None = None,
    index_stride: int = INDEX_STRIDE,
) -> bytes:
    """``spec``: a prebuilt HuffmanSpec for the auto-table path (skips
    recomputing histograms when the caller already built one)."""
    writer = BitWriter()
    offsets: list[int] | None = [] if block_index else None
    if auto_generate_huffman_table:
        if spec is None:
            spec = build_huffman_spec(arrays)
        tables = spec.string_tables()
        writer.write_bytes(make_header(arrays, custom_table=True))
        write_huffman_table(writer, tables)
        # TICX offsets are PAYLOAD-relative (bit 0 = first payload bit,
        # i.e. right after the table segment), so the trailer layout is
        # identical for standard- and custom-table streams.
        _encode_payload(arrays, tables, writer, offsets)
    else:
        writer.write_bytes(make_header(arrays))
        _encode_payload(arrays, _DEFAULT_TABLES, writer, offsets)
    data = writer.to_bytes()
    if offsets is not None:
        data += make_block_index(
            np.asarray(offsets, dtype=np.int64), stride=index_stride
        )
    return data


def _invert(table: dict) -> dict[str, object]:
    return {v: k for k, v in table.items()}


def _read_code(reader: BitReader, inverse: dict[str, object]):
    """Bit-at-a-time prefix match, <= 16 bits (reference huffman.py:66-74)."""
    prefix = ""
    for _ in range(17):
        if prefix in inverse:
            return inverse[prefix]
        prefix += str(reader.read_bit())
    raise ValueError("invalid Huffman code")


class PayloadPlan(NamedTuple):
    """What the C decoder of ``native`` reads of one stream: its header
    fields, ``payload`` (uint8: the bytes its cursor reads, a view of the
    stream where no realignment is needed), ``starts`` (int64 TICX chunk
    bit offsets, or None for the serial cursor) and ``stride`` (blocks a
    chunk), and ``luts`` (``(dc_lut, ac_lut)`` of a custom table, None for
    the standard tables)."""

    height: int
    width: int
    quality: int
    scaled_dct: bool
    nblocks: int
    payload: np.ndarray
    starts: np.ndarray | None
    stride: int
    luts: tuple | None


def payload_plan(data: bytes) -> PayloadPlan:
    """A stream's header parsed, and its payload and index chosen as the
    C decoder reads them: the TICX chunks where the trailer validates and
    the image has more than one chunk, else the serial cursor; a custom
    table's LUTs and its payload realigned to a byte."""
    height, width, quality, flag = parse_header(data)
    scaled_dct = bool(flag & FLAG_SCALED_DCT) and not (flag & FLAG_CUSTOM_TABLE)
    nblocks = -(-height // 8) * -(-width // 8)
    idx = parse_block_index(data, nblocks)
    luts = None
    if flag & FLAG_CUSTOM_TABLE:
        reader = BitReader(data)
        reader.seek(HEADER_BYTES * 8)
        tables = read_huffman_table(reader)
        payload_off = reader.tell()
        luts = (
            native.build_decode_lut(
                {c: (int(s, 2), len(s)) for c, s in tables[DC].items()}
            ),
            native.build_decode_lut(
                {
                    (r << 4) | sz: (int(s, 2), len(s))
                    for (r, sz), s in tables[AC].items()
                }
            ),
        )
        if idx is not None and idx[0][-1] >= idx[2] * 8 - payload_off:
            # parse_block_index's bound over-counts by the table-segment
            # bits here; a trailer whose last offset lands past the TRUE
            # payload end must degrade to the serial cursor, like any
            # other invalid index
            idx = None
        # the custom-table payload may start off a byte boundary: realign
        # by re-packing the remaining bits; TICX offsets are payload-
        # relative, so the index works unchanged on the realigned payload
        end = idx[2] * 8 if idx is not None and nblocks > idx[1] else None
        payload = np.frombuffer(
            bits_to_bytes(reader._bits[payload_off:end]), np.uint8)
    else:
        end = idx[2] if idx is not None and nblocks > idx[1] else len(data)
        payload = np.frombuffer(data, np.uint8, end - HEADER_BYTES,
                                HEADER_BYTES)
    if idx is None or nblocks <= idx[1]:
        starts, stride = None, 0
    else:
        starts, stride = idx[0], idx[1]
    return PayloadPlan(height, width, quality, scaled_dct, nblocks,
                       payload, starts, stride, luts)


def decompress_to_arrays(
    data: bytes, use_native: bool = True,
    index_workers: int | None = None,
) -> CodecArrays:
    """bytes -> coefficient arrays (entropy decode only).

    Runs the C LUT decoder of ``native`` (O(1) per code via a 16-bit peek
    table; a build that fails raises) on :func:`payload_plan`'s payload.
    ``use_native=False`` runs the pure-python bit cursor below instead:
    the behavioural oracle of the format, which the tests hold the C
    decoder against.

    index_workers: thread count for TICX index-parallel decode (None =
    all cores).  Callers decoding MANY streams concurrently should pass
    1 -- nesting an index pool inside a per-stream pool oversubscribes
    the cores and measures slower than the serial cursor.
    """
    if use_native:
        plan = payload_plan(data)
        if plan.starts is not None:
            dc, ac = native.entropy_decode_indexed(
                plan.payload, plan.nblocks, plan.starts, plan.stride,
                *(plan.luts or (None, None)), max_workers=index_workers,
            )
        else:
            dc, ac = native.entropy_decode(
                plan.payload, plan.nblocks, *(plan.luts or (None, None))
            )
        return CodecArrays(
            height=plan.height, width=plan.width, quality=plan.quality,
            dc=dc, ac=ac, scaled_dct=plan.scaled_dct,
        )

    height, width, quality, flag = parse_header(data)
    reader = BitReader(data)
    reader.seek(HEADER_BYTES * 8)
    if flag & FLAG_CUSTOM_TABLE:
        tables = read_huffman_table(reader)
    else:
        tables = _DEFAULT_TABLES
    scaled_dct = bool(flag & FLAG_SCALED_DCT) and not (flag & FLAG_CUSTOM_TABLE)
    nblocks = -(-height // 8) * -(-width // 8)

    inv_dc = _invert(tables[DC])
    inv_ac = _invert(tables[AC])
    dc = np.zeros(nblocks, dtype=np.int32)
    ac = np.zeros((nblocks, 63), dtype=np.int32)
    for i in range(nblocks):
        try:
            cat = _read_code(reader, inv_dc)
            dc[i] = reader.read_int(cat)
            pairs: list[tuple[int, int]] = []
            while True:
                run, size = _read_code(reader, inv_ac)
                value = reader.read_int(size)
                pairs.append((run, value))
                if (run, size) == (0, 0):
                    break
            ac[i] = golden.run_length_decode(pairs)
        except (EOFError, ValueError, IndexError):
            # Graceful degradation on truncated/corrupt streams: failed
            # blocks stay all-zero, later blocks are still attempted
            # (reference codec.py:178-186 per-block try/except semantics;
            # a zero DC diff carries the previous DC forward, quirk 2.5-10).
            dc[i] = 0
            ac[i] = 0
    return CodecArrays(
        height=height,
        width=width,
        quality=quality,
        dc=dc,
        ac=ac,
        scaled_dct=scaled_dct,
    )


def decompress(data: bytes) -> np.ndarray:
    """bytes -> uint8 image (host/golden path; reference codec.py:167-189)."""
    return golden.decode_arrays(decompress_to_arrays(data))
