"""Chunk-parallel entropy decode of TICX-indexed streams.

The payload's variable-length codes force a serial bit cursor; the TICX
trailer records the payload bit offset of every ``stride``-th block, so a
stream is ``ceil(nb / stride)`` chunks that decode independently.  This
module decodes all chunks of a whole batch at once on the device.

Host half (NumPy only): :func:`canonical_tables` (admission check of a
stream's own Huffman table), :func:`prepare_batch` (streams -> payload
words and chunk arrays, or ``None`` when the batch cannot take this path),
:func:`chunk_table` (the one array that holds the chunk arrays).

Device half: :func:`entropy_decode_chunks` -> ``(zz (nb_total, 64) int32
zig-zag coefficients with the DPCM'd DC in column 0, ok (C,) bool)``.  On
the card it launches ``csrc/entropy_decode.cu``, one lane per chunk.
In the JAX package this function is an XLA program and not a Pallas
kernel; its slot budgets, resume passes, paired window tables and one-hot
matmul reassembly are mechanism of that machine and have no counterpart
here.

What bounds the kernel is not its bytes but the serial chain of each
chunk: a batch has only as many independent cursors as chunks, and a
symbol cannot start before the one before it gave its length.  So the
kernel makes the step short (a first-level lookup table,
``DecodeTables.lookup``, instead of a length search; the CTA's part of the
stream staged in shared memory; the next stream word fetched ahead; one
branch for everything rare) and spreads the chunks over many warps
(:func:`launch_shape`).  ``zz`` is zeroed before the launch and the kernel
stores only what it decodes: zeroing the rows inside the kernel instead
was measured and gained nothing (PERF.md), so there is one output path.

Validation (the same rule as the JAX package's): a chunk is ``ok`` only if
it decoded exactly its block count, every coefficient landed at a zig-zag
position in [0, 63], every code matched the table, and its final cursor
lies in ``[end_lo, end_hi]`` (the next chunk's recorded offset; for an
image's last chunk the byte-alignment pad).  A chunk stops at its first
violation; what it wrote before stays in ``zz``, and callers must not use
the blocks of a chunk that is not ``ok``.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np
import torch

from ..tables import CANONICAL_INTS, DecodeTables
from . import _build

# absolute per-block symbol bound: 1 DC + 63 AC values + <= 3 ZRL + EOB
MAX_BLOCK_SYMBOLS = 68

# Chunk bit offsets are int32 tensors, so a batch's payload must stay below
# 2**31 bits (256 MiB); the kernel's own cursor is 64-bit and cannot wrap.
MAX_PAYLOAD_BITS = 2 ** 31

launches = 0  # times the CUDA kernel was launched through the wrapper
launches_by_card: dict[int, int] = {}  # the same count, by card index

# Launch shape of the kernel (see :func:`launch_shape`): the best measured
# on an H100 at 12 544 chunks and within the spread of the best at 3136
# (scripts/torch_kernel_split.py; PERF.md).
CHUNKS_PER_WARP = 8
WARPS_PER_CTA = 4
MAX_STAGE_WORDS = 40960   # 160 KB of the 227 KB a CTA may use

# the chunk arrays of a prepared batch, in the row order of its chunk table
CHUNK_KEYS = ("chunk_start", "chunk_blocks", "chunk_block_base",
              "chunk_end_lo", "chunk_end_hi", "chunk_img")


# ------------------------------------------------------------- host half


def canonical_tables(tables: dict):
    """Parsed string-code tables -> ((dc), (ac)) in T.81 F.2.2.3 form.

    Host-side admission check for device decode of dynamic-table streams
    (``container.read_huffman_table`` output).  Returns ``(mincode,
    maxcode, valptr, huffval)`` tuples as
    ``tables.standard_decode_tables`` (huffval zero-padded to 256), or
    ``None`` when the table cannot drive the device decoder:

    * a code longer than 16 bits (the decoder matches in a 16-bit window);
    * codes that are not canonical (per-length consecutive, numbered by
      the standard shift law): the first-match length rule is only correct
      for canonical codes, which this codec's own table construction
      always emits;
    * extended-range symbols (DC category > 11 / AC size > 10), the same
      standard-range bound as the device encoder.
    """
    from ..constants import AC as AC_KEY
    from ..constants import DC as DC_KEY

    def build(code_map, sym_value):
        if not code_map:
            return None
        items = []
        for sym, s in code_map.items():
            l = len(s)
            if l < 1 or l > 16:
                return None
            v = sym_value(sym)
            if v is None:
                return None
            items.append((l, int(s, 2), v))
        items.sort()
        mincode = np.zeros(17, np.int32)
        maxcode = np.full(17, -1, np.int32)
        valptr = np.zeros(17, np.int32)
        huffval = np.zeros(256, np.int32)
        code = 0
        prev_l = 0
        for k, (l, c, v) in enumerate(items):
            code <<= l - prev_l
            prev_l = l
            if c != code:  # not the canonical numbering
                return None
            if maxcode[l] < 0:
                mincode[l] = code
                valptr[l] = k
            maxcode[l] = code
            huffval[k] = v
            code += 1
        return mincode, maxcode, valptr, huffval

    def dc_sym(cat):
        return cat if isinstance(cat, int) and 0 <= cat <= 11 else None

    def ac_sym(rs):
        try:
            run, size = rs
        except (TypeError, ValueError):
            return None
        if 0 <= run <= 15 and 0 <= size <= 10:
            return (run << 4) | size
        return None

    dc = build(tables[DC_KEY], dc_sym)
    ac = build(tables[AC_KEY], ac_sym)
    if dc is None or ac is None:
        return None
    return dc, ac


def prepare_batch(streams: list[bytes]):
    """Host-side prep: uniform TICX streams -> device input arrays.

    Returns ``None`` if any stream is ineligible (no or invalid TICX
    trailer, non-uniform shape / quality / flags / stride / tables, an
    inadmissible dynamic table -- :func:`canonical_tables` -- or a payload
    of ``MAX_PAYLOAD_BITS`` or more), else a dict of numpy arrays and
    metadata for :func:`entropy_decode_chunks`.  Dynamic-table streams
    contribute a ``"tables"`` entry (the canonical decode tuples) and have
    their payloads realigned to a byte here (the table segment ends
    off-byte); TICX offsets are payload-relative in both layouts, so the
    chunk arithmetic is the same.

    The six chunk arrays (:data:`CHUNK_KEYS`) are the rows of one
    C-contiguous (6, C) int32 array, :func:`chunk_table`, which one copy
    uploads.  The chunks tile the blocks: ``chunk_block_base`` and
    ``chunk_blocks`` come from the stride alone, never from a stream's
    trailer offsets, so chunk ``k`` begins where chunk ``k - 1`` ends, the
    first at block 0 and the last ending at ``nb_total``, whatever the
    streams hold.

    Per stream only the header and the trailer's fixed fields are read,
    as Python integers (and a dynamic table, and its payload realigned);
    the offsets are read, checked and turned into chunks once for the
    whole batch, as (B, n) arrays.
    """
    from .. import container
    from ..bitstream import BitReader, bits_to_bytes
    from ..constants import (
        FLAG_CUSTOM_TABLE,
        FLAG_SCALED_DCT,
        HEADER_BYTES,
    )

    if not streams:
        return None
    key0 = stride0 = tables0 = tabs0 = None
    ends, true_bits, cursors = [], [], []
    for data in streams:
        if len(data) < HEADER_BYTES:
            return None
        key = struct.unpack_from("<IIII", data)  # height, width, q, flag
        if key0 is None:
            key0 = key
            nb = -(-key[0] // 8) * -(-key[1] // 8)
        elif key != key0:  # uniform shape, quality and flags
            return None
        fields = container.index_fields(data, nb)
        if fields is None:
            return None
        start, stride, n = fields
        if n == 1 and stride > 1 << 31:
            # one chunk holds the whole image, whatever the stride; one
            # past int32 (a corrupt byte may say 2**255, which no int64
            # holds) is taken as the image's block count
            stride = nb
        if stride0 is None:
            stride0 = stride
        elif stride != stride0:  # one stride, so one chunk count
            return None
        if key[3] & FLAG_CUSTOM_TABLE:
            try:
                reader = BitReader(data)
                reader.seek(HEADER_BYTES * 8)
                tables = container.read_huffman_table(reader)
            except Exception:
                return None
            if tables0 is None:
                tables0 = tables
                # admission before any payload realignment: an
                # inadmissible table rejects in O(table)
                tabs0 = canonical_tables(tables0)
                if tabs0 is None:
                    return None
            elif tables != tables0:  # one table per batch
                return None
            cursors.append(reader)
            true_bits.append(start * 8 - reader.tell())
        else:
            true_bits.append((start - HEADER_BYTES) * 8)
        ends.append(start)

    b = len(streams)
    true_bits = np.array(true_bits, np.int64)
    off = np.frombuffer(b"".join([
        memoryview(data)[start + 8:start + 8 + 4 * n]
        for data, start in zip(streams, ends)
    ]), "<u4").reshape(b, n).astype(np.int64)
    # measured against the true payload: on a custom stream the trailer's
    # own bound over-counts by the table segment, and a corrupt trailer
    # must go to the serial host cursor instead of mis-chunking
    if not container.index_offsets_valid(off, true_bits):
        return None
    # each payload's bytes, zero-padded to a whole word
    words_in = (true_bits + 31) // 32
    if 32 * int(words_in.sum()) >= MAX_PAYLOAD_BITS:  # int32 chunk offsets
        return None
    base = 32 * (np.cumsum(words_in) - words_in)

    table = np.empty((6, b, n), np.int64)
    start_, blocks, block_base, end_lo, end_hi, img = table
    np.add(base[:, None], off, out=start_)
    blocks[:] = stride0
    blocks[:, -1] = nb - stride0 * (n - 1)
    block_base[:] = nb * np.arange(b)[:, None] + stride0 * np.arange(n)
    end_lo[:, :-1] = end_hi[:, :-1] = start_[:, 1:]
    # the final cursor must land in the writer's <= 7-bit byte-align pad
    # window, measured from the true payload bit length (for realigned
    # dynamic-table payloads the byte padding of the realignment is not
    # part of the stream)
    end_lo[:, -1] = base + np.maximum(true_bits - 7, 0)
    end_hi[:, -1] = base + true_bits
    img[:] = np.arange(b)[:, None]
    table = table.reshape(6, b * n).astype(np.int32)

    pieces = []
    for i, (data, start) in enumerate(zip(streams, ends)):
        if cursors:  # realigned to a byte, past the table segment
            payload = bits_to_bytes(
                cursors[i]._bits[cursors[i].tell():start * 8])
        else:
            payload = memoryview(data)[HEADER_BYTES:start]
        pieces += (payload, bytes(-len(payload) % 4))
    # the big-endian words in the host's (little-endian) order, swapped
    # in the one buffer the join fills: a second buffer for the swap, or
    # numpy's conversion from ">u4", costs more
    words = np.frombuffer(bytearray().join(pieces), "<u4")
    words.byteswap(inplace=True)
    flag = key0[3]
    return {
        "words": words,
        **dict(zip(CHUNK_KEYS, table)),
        "nb_total": b * nb,
        "nb_per_image": nb,
        "stride": int(stride0),
        "shape": key0[:3],
        "scaled_dct": bool(flag & FLAG_SCALED_DCT)
        and not (flag & FLAG_CUSTOM_TABLE),
        "tables": tabs0,
    }


def chunk_table(prep: dict) -> np.ndarray:
    """The (6, C) int32 array whose rows are ``prep``'s chunk arrays, in
    :data:`CHUNK_KEYS` order: the chunk table that one copy uploads."""
    table = prep[CHUNK_KEYS[0]].base
    if any(prep[k].base is not table for k in CHUNK_KEYS):
        raise ValueError("the chunk arrays are not rows of one table")
    return table


# ----------------------------------------------------------- device half


def _check(words, chunk_arrays, nb_total: int, tables: DecodeTables) -> int:
    if words.dtype != torch.int32 or words.ndim != 1:
        raise ValueError("words must be a 1-D int32 tensor (uint32 bits)")
    if words.shape[0] >= 1 << 31:
        raise ValueError("more than 2**31 - 1 stream words")
    c = chunk_arrays[0].shape[0]
    for a in chunk_arrays:
        if a.dtype != torch.int32 or a.shape != (c,):
            raise ValueError("chunk arrays must be (C,) int32 tensors")
        if a.device != words.device:
            raise ValueError("words and chunk arrays lie on different devices")
    if tables.device != words.device:
        raise ValueError("tables and words lie on different devices")
    if tables.huffman.shape != (2, CANONICAL_INTS):
        raise ValueError("tables.huffman must be (2, 307)")
    if nb_total < 1 or nb_total * 64 >= 1 << 31:
        raise ValueError(f"nb_total {nb_total} out of range")
    return c


def entropy_decode_chunks_plain(
    words: torch.Tensor, chunk_start: torch.Tensor,
    chunk_blocks: torch.Tensor, chunk_block_base: torch.Tensor,
    chunk_end_lo: torch.Tensor, chunk_end_hi: torch.Tensor,
    nb_total: int, tables: DecodeTables,
):
    """Plain PyTorch version (any device) of :func:`entropy_decode_chunks`:
    all chunks in lockstep, one symbol per chunk and step, a Python loop
    over the steps.  Same results as the kernel, bit for bit, ``zz`` of
    failed chunks included.  Meant for test sizes."""
    c = _check(words, (chunk_start, chunk_blocks, chunk_block_base,
                       chunk_end_lo, chunk_end_hi), nb_total, tables)
    dev = words.device
    i64 = dict(dtype=torch.int64, device=dev)
    nwords = words.shape[0]
    # two zero words after the end: reads past the stream give zero bits
    wpad = torch.cat([words.to(torch.int64) & 0xFFFFFFFF,
                      torch.zeros(2, **i64)])
    tab = tables.huffman.to(torch.int64)  # (2, 307); row 0 DC, row 1 AC
    mincode, maxcode = tab[:, 0:17], tab[:, 17:34]
    valptr, huffval = tab[:, 34:51], tab[:, 51:]
    lens = torch.arange(1, 17, **i64).reshape(1, 16)

    pos = chunk_start.to(torch.int64)
    nblk = chunk_blocks.to(torch.int64)
    base = chunk_block_base.to(torch.int64)
    done = torch.zeros(c, **i64)         # blocks finished
    p = torch.zeros(c, **i64)            # zig-zag position in the block
    nsym = torch.zeros(c, **i64)         # symbols taken in the block
    is_dc = torch.ones(c, dtype=torch.bool, device=dev)
    bad = pos < 0
    zz = torch.zeros(nb_total * 64, dtype=torch.int32, device=dev)

    while True:
        live = ~bad & (done < nblk)
        if not bool(live.any()):
            break
        blk = base + done
        # a block outside [0, nb_total) fails its chunk before any read
        bad = bad | (live & is_dc & ((blk < 0) | (blk >= nb_total)))
        live = live & ~bad
        mode = (~is_dc).to(torch.int64)  # table row
        wi = (pos >> 5).clamp(0, nwords)
        sh = pos & 31
        win = ((wpad[wi] << sh) & 0xFFFFFFFF) | (wpad[wi + 1] >> (32 - sh))
        c16 = win >> 16
        match = (c16.reshape(c, 1) >> (16 - lens)) <= maxcode[mode][:, 1:]
        found = match.any(dim=1)
        length = match.to(torch.int64).argmax(dim=1) + 1  # first match
        code = c16 >> (16 - length)
        idx = (valptr[mode, length] + code - mincode[mode, length]).clamp(
            0, huffval.shape[1] - 1)
        sym = huffval[mode, idx]
        size = torch.where(is_dc, sym.clamp(0, 15), sym & 15)
        mag = (((win << length) & 0xFFFFFFFF) >> (32 - size)) * (size > 0)
        half = 1 << (size - 1).clamp(min=0)
        value = torch.where((mag < half) & (size > 0),
                            mag - (1 << size) + 1, mag)

        # an AC step past the per-block symbol bound fails before reading
        spent = live & ~is_dc & (nsym >= MAX_BLOCK_SYMBOLS)
        nomatch = live & ~spent & ~found
        step = live & ~spent & found
        pos = torch.where(step, pos + length + size, pos)
        eob = step & ~is_dc & (sym == 0)
        ac = step & ~is_dc & (sym != 0)
        p_new = torch.where(ac, p + ((sym >> 4) & 15) + 1,
                            torch.zeros_like(p))
        beyond = ac & (p_new > 63)
        write = (step & is_dc) | (ac & ~beyond)
        tgt = (blk * 64 + p_new)[write]
        zz[tgt] = value[write].to(torch.int32)
        bad = bad | spent | nomatch | beyond
        p = torch.where(ac, p_new, torch.where(step, torch.zeros_like(p), p))
        nsym = torch.where(eob, torch.zeros_like(nsym),
                           torch.where(step, nsym + 1, nsym))
        done = done + eob.to(torch.int64)
        is_dc = torch.where(step, eob, is_dc)

    ok = (~bad & (done >= nblk) & (pos >= chunk_end_lo.to(torch.int64))
          & (pos <= chunk_end_hi.to(torch.int64)))
    return zz.reshape(nb_total, 64), ok


def _lib() -> ctypes.CDLL:
    lib = _build.load("entropy_decode")
    fn = lib.entropy_decode_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, ctypes.c_uint, p, p, p, p, p, p, p, i, p, p,
                       i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def launch_shape(nchunks: int, nwords: int) -> tuple[int, int, int]:
    """``(chunks a warp, warps a CTA, words of the CTA's stream window)``
    for a batch of ``nchunks`` chunks in ``nwords`` stream words; a
    function of the two sizes alone, so it costs no look at the data.

    The lanes of a warp step in lockstep and a warp is as slow as its
    longest chunk, so a warp takes few chunks and the card runs many
    warps.  The window is twice what the CTA's chunks span at the batch's
    mean density (a chunk past it reads device memory instead), capped at
    ``MAX_STAGE_WORDS``."""
    per_cta = CHUNKS_PER_WARP * WARPS_PER_CTA
    span = -(-nwords * per_cta // max(nchunks, 1))
    stage = min(MAX_STAGE_WORDS, (2 * span + 64 + 3) // 4 * 4)
    return CHUNKS_PER_WARP, WARPS_PER_CTA, stage


def launch_kernel(words: torch.Tensor, arrays, tables: DecodeTables,
                  zz: torch.Tensor, ok: torch.Tensor,
                  shape: tuple[int, int, int] | None = None) -> None:
    """The kernel launch alone, into ``zz`` (nb_total, 64) int32, zeroed
    by the caller (the kernel stores only the coefficients it decodes),
    and ``ok`` (C,) bool: what :func:`entropy_decode_chunks` does after it
    allocated them (a measurement can time just this).  ``shape``: another
    launch shape than :func:`launch_shape` gives (a measurement's sweep; a
    check of the reads outside a small or empty window)."""
    cpw, warps, stage = shape or launch_shape(ok.shape[0], words.shape[0])
    bits = tables.lookup.shape[1].bit_length() - 1
    with torch.cuda.device(words.device):
        err = _lib().entropy_decode_launch(
            words.data_ptr(), words.shape[0],
            *(a.data_ptr() for a in arrays),
            tables.huffman.data_ptr(), tables.lookup.data_ptr(), bits,
            zz.data_ptr(), ok.data_ptr(), ok.shape[0], zz.shape[0],
            cpw, warps, stage,
            _build.stream_handle(words.device),
        )
    _build.check(err, "entropy_decode")


def entropy_decode_chunks(
    words: torch.Tensor, chunk_start: torch.Tensor,
    chunk_blocks: torch.Tensor, chunk_block_base: torch.Tensor,
    chunk_end_lo: torch.Tensor, chunk_end_hi: torch.Tensor,
    nb_total: int, tables: DecodeTables,
):
    """Decode all chunks of a (multi-stream) payload word array.

    ``words``: (W,) int32 bit patterns of the big-endian payload words
    (streams byte-padded to word boundaries and concatenated).
    ``chunk_start``: (C,) global bit offset of each chunk;
    ``chunk_blocks``: its block count; ``chunk_block_base``: its first
    global block index; ``chunk_end_lo`` / ``chunk_end_hi``: inclusive
    bounds its final cursor must land in.  All as :func:`prepare_batch`
    makes them.  ``tables.huffman`` carries the canonical tables,
    ``tables.lookup`` the first-level table made from them.  Chunks must
    not share blocks.

    Blocks that no chunk owns, and what a chunk did not decode, are zero
    in ``zz``.

    Returns ``(zz (nb_total, 64) int32, ok (C,) bool)``.  CUDA tensors go
    to the kernel, CPU tensors to the plain version; nothing else is
    tried.
    """
    if words.device.type == "cpu":
        return entropy_decode_chunks_plain(
            words, chunk_start, chunk_blocks, chunk_block_base,
            chunk_end_lo, chunk_end_hi, nb_total, tables)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    arrays = [a.contiguous() for a in (
        chunk_start, chunk_blocks, chunk_block_base, chunk_end_lo,
        chunk_end_hi)]
    c = _check(words, arrays, nb_total, tables)
    words = words.contiguous()
    zz = torch.zeros((nb_total, 64), dtype=torch.int32, device=words.device)
    ok = torch.empty((c,), dtype=torch.bool, device=words.device)
    launch_kernel(words, arrays, tables, zz, ok)
    _build.count_launch(globals(), words.device)
    return zz, ok
