"""Host-side bit stream utilities (numpy-vectorized, no C-extension deps).

Replaces the reference's ``bitarray``-backed ``BitBuffer``
(the reference's tinyimgcodec/bitbuffer.py:5-72) with a pure numpy design:

- ``BitWriter`` accumulates ``(value, nbits)`` symbols and packs them into
  big-endian bytes in one vectorized pass (``pack_symbols``), instead of
  growing a Python-level bit array per write.
- ``BitReader`` exposes a cursor over an unpacked bit vector with the same
  read semantics the reference decoder relies on (big-endian bit order;
  JPEG-style signed magnitude in ``read_int``, bitbuffer.py:56-66).
"""

from __future__ import annotations

import numpy as np


def pack_symbols(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Concatenate variable-length big-endian bit strings into bytes.

    values: uint64 array; symbol i contributes its low ``lengths[i]`` bits,
    most-significant-first.  lengths may be 0 (symbol contributes nothing).
    The final byte is zero-padded, matching bitarray.tobytes() semantics
    (reference bitbuffer.py:17-18).
    """
    values = np.asarray(values, dtype=np.uint64)
    lengths = np.asarray(lengths, dtype=np.int64)
    if values.size == 0:
        return b""
    # Expand each symbol to a fixed 64-bit lane, left-aligned at its length:
    # bit j (0-based, MSB-first within the symbol) lives at lane position j.
    shifts = (np.uint64(64) - lengths.astype(np.uint64))
    aligned = (values << shifts).astype(">u8")  # big-endian view for unpack
    bits = np.unpackbits(aligned.view(np.uint8)).reshape(-1, 64)
    lane = np.arange(64, dtype=np.int64)
    mask = lane[None, :] < lengths[:, None]
    flat = bits[mask]  # ragged compaction, bit order preserved
    return np.packbits(flat).tobytes()


def pack_ragged_words(words: np.ndarray, bit_lengths: np.ndarray) -> bytes:
    """Concatenate ragged big-endian word buffers into packed bytes.

    words: (N, W) uint32, each row a bit buffer (bit 0 at the MSB of
    word 0); bit_lengths: (N,) valid bits per row.  Host-side stitch used
    to assemble per-block/per-shard device packing output into the final
    payload (the C fast path in native/ supersedes this when built).
    """
    words = np.ascontiguousarray(words, dtype=np.uint32)
    n, w = words.shape
    if n == 0:
        return b""
    bits = np.unpackbits(words.astype(">u4").view(np.uint8), axis=1)
    lane = np.arange(w * 32, dtype=np.int64)
    mask = lane[None, :] < np.asarray(bit_lengths, dtype=np.int64)[:, None]
    return np.packbits(bits[mask]).tobytes()


def concat_bit_payload(
    prefix: bytes, prefix_bits: int, payload: bytes, payload_bits: int
) -> bytes:
    """Append a byte-aligned payload at bit position ``prefix_bits``.

    prefix: packed bytes whose first ``prefix_bits`` bits are valid (the
    rest zero-padded); payload: packed bytes whose first ``payload_bits``
    are valid.  Used to splice a device-assembled payload directly after a
    non-byte-aligned header+table section (custom-table streams start the
    entropy payload mid-byte, reference codec.py:150-153 semantics).
    """
    total_bytes = -(-(prefix_bits + payload_bits) // 8)
    pb = -(-payload_bits // 8)
    payload = payload[:pb]
    k = prefix_bits & 7
    if k == 0:
        return (prefix[: prefix_bits // 8] + payload)[:total_bytes]
    p = np.frombuffer(payload, np.uint8)
    shifted = np.zeros(pb + 1, np.uint8)
    shifted[:pb] = p >> k
    shifted[1:] |= (p << (8 - k)).astype(np.uint8)
    head = prefix_bits // 8
    first = (prefix[head] if head < len(prefix) else 0) | int(shifted[0])
    out = prefix[:head] + bytes([first]) + shifted[1:].tobytes()
    return out[:total_bytes]


def bits_to_bytes(bits: np.ndarray) -> bytes:
    return np.packbits(np.asarray(bits, dtype=np.uint8)).tobytes()


def bytes_to_bits(data: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(data, dtype=np.uint8))


class BitWriter:
    """Accumulates symbols; packs once at the end."""

    def __init__(self) -> None:
        self._values: list[int] = []
        self._lengths: list[int] = []
        self._nbits = 0  # sum of _lengths: bit_length() is asked per block

    def write_bits(self, value: int, nbits: int) -> None:
        """Append the low ``nbits`` of ``value``, MSB first."""
        if nbits < 0 or nbits > 64:
            raise ValueError("nbits must be in [0, 64]")
        if nbits:
            self._values.append(value & ((1 << nbits) - 1))
            self._lengths.append(nbits)
            self._nbits += nbits

    def write_uint(self, value: int, nbits: int) -> None:
        if value < 0 or (nbits < 64 and value >= (1 << nbits)):
            raise ValueError(f"uint {value} does not fit in {nbits} bits")
        self.write_bits(value, nbits)

    def write_int(self, value: int) -> None:
        """JPEG signed-magnitude: category-many bits; 0 writes nothing.

        Negative values are stored one's-complemented (bitbuffer.py:47-54).
        """
        if value == 0:
            return
        mag = abs(value)
        nbits = mag.bit_length()
        bits = mag if value > 0 else (~mag) & ((1 << nbits) - 1)
        self.write_bits(bits, nbits)

    def write_bitstring(self, s: str) -> None:
        self.write_bits(int(s, 2) if s else 0, len(s))

    def write_bytes(self, data: bytes) -> None:
        for b in data:
            self.write_bits(b, 8)

    def bit_length(self) -> int:
        return self._nbits

    def to_bytes(self) -> bytes:
        return pack_symbols(
            np.array(self._values, dtype=np.uint64),
            np.array(self._lengths, dtype=np.int64),
        )

    def extend_packed(self, values: np.ndarray, lengths: np.ndarray) -> None:
        """Bulk-append pre-computed symbol arrays (device entropy output)."""
        lengths = np.asarray(lengths, dtype=np.int64)
        values = np.asarray(values, dtype=np.uint64)
        keep = lengths > 0
        self._values.extend(int(v) for v in values[keep])
        self._lengths.extend(int(l) for l in lengths[keep])
        self._nbits += int(lengths[keep].sum())


class BitReader:
    """Cursor over a big-endian bit vector."""

    def __init__(self, data: bytes) -> None:
        self._bits = bytes_to_bits(data)
        self._pos = 0

    @property
    def nbits(self) -> int:
        return int(self._bits.size)

    def tell(self) -> int:
        return self._pos

    def seek(self, pos: int) -> None:
        self._pos = pos

    def remaining(self) -> int:
        return self.nbits - self._pos

    def read_bit(self) -> int:
        if self._pos >= self.nbits:
            raise EOFError("bit stream exhausted")
        b = int(self._bits[self._pos])
        self._pos += 1
        return b

    def read_uint(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        if self._pos + nbits > self.nbits:
            raise EOFError("bit stream exhausted")
        chunk = self._bits[self._pos : self._pos + nbits]
        self._pos += nbits
        out = 0
        for b in chunk:
            out = (out << 1) | int(b)
        return out

    def read_int(self, nbits: int) -> int:
        """JPEG signed-magnitude read (reference bitbuffer.py:56-66)."""
        if nbits == 0:
            return 0
        raw = self.read_uint(nbits)
        if raw >> (nbits - 1):  # leading 1 -> positive
            return raw
        return -((~raw) & ((1 << nbits) - 1))

    def read_bytes(self, size: int) -> bytes:
        if self._pos % 8 == 0:
            start = self._pos // 8
            self._pos += size * 8
            return bits_to_bytes(
                self._bits[start * 8 : start * 8 + size * 8]
            )
        out = bytearray(self.read_uint(8) for _ in range(size))
        return bytes(out)
