"""The plain reference of per-image Huffman tables
(``compress(image, quality, auto_generate_huffman_table=True)``): plain
Python and PyTorch on the CPU, nothing of the program.

The definition of the tables, which this module follows, is the one
below; the stream format around them is ``docs/FORMAT.md``'s.  The option
builds one DC and one AC table from the image's own quantized zig-zag
coefficients (the exact reference's float64 ones, ``codec.quantized``;
the DC differences in raster order, the first from 0).  Every step is
exact integer work, so one image has one table.

1. **Symbols and counts.**  DC: each block's category, the bit length of
   ``|DC difference|``.  AC: for each nonzero AC coefficient, in zig-zag
   order, with ``r`` zeros before it in its block (since the DC or the
   previous nonzero one): ``r // 16`` ZRL symbols (15, 0), then the
   symbol (``r % 16``, ``s``), ``s`` the bit length of ``|value|``.  Each
   block adds one EOB (0, 0), always.  Counted with ``torch.bincount``.
2. **Leaves.**  Each table is built apart, from its symbols with a count
   above 0, numbered 0, 1, 2, ... in symbol order: DC categories
   ascending; AC symbols run-major, (0, 0), (0, 1), ..., (0, 15), (1, 0),
   ..., (15, 15).
3. **Merge.**  While more than one node is left, take out the node with
   the smallest count (of equal counts, the smallest number), then the
   smallest of the rest, and put in one node with the sum of their counts
   and the next unused number (the first merged node takes the number
   after the last leaf's).  A leaf's depth is the number of merges above
   it.  A table of one symbol gives it depth 1.
4. **Limit to 16 bits** (JPEG Annex K.3, Figure K.3, without reserving
   the all-ones code).  Let ``bits[l]`` be the number of leaves at depth
   ``l`` and ``L`` the deepest depth.  While ``L > 16``: ``j = L - 2``;
   while ``bits[j] == 0``, ``j -= 1``; then ``bits[L] -= 2``,
   ``bits[L - 1] += 1``, ``bits[j + 1] += 2``, ``bits[j] -= 1``, and empty
   deepest levels go.
5. **Lengths.**  Sort the symbols by (depth of step 3, text) and hand out
   the lengths in that order: the first ``bits[1]`` symbols get 1 bit,
   the next ``bits[2]`` get 2 bits, and so on.  A symbol's *text* is the
   decimal number of a DC category (``7``, ``10``) and ``(r, s)`` of an
   AC symbol (``(0, 1)``, ``(15, 0)``: a comma and a space), compared
   character by character in ASCII order: ``10`` sorts before ``2``, and
   ``(1, 5)`` before ``(10, 0)`` before ``(2, 1)``.
6. **Codes** (canonical).  Sort the symbols by (length, text).  The first
   takes code 0; each next takes (the previous code + 1) shifted left by
   (its length - the previous length).
7. **Stream.**  The 16-byte header with flag bit 31, then the table
   segment: the DC entries by category ascending (u4 category, u8 length,
   the code), then the AC entries run-major, run ascending, then size
   ascending (u4 run, u4 size, u8 length, the code); only symbols with a
   code.  The payload follows the segment's last bit directly, in the
   same bit stream, coded with these codes (ZRL with the code of (15, 0),
   EOB with that of (0, 0)), and is zero-padded to a byte after it; then
   the TICX trailer of each ``stride``-th block's bit offset from the
   payload's first bit.  Packing and trailer are the exact reference's
   (``codec._pack``, ``codec._trailer``), unedited.

A DC category or AC size of 16 or more has no place in the segment and
raises ``ValueError``, as it does in the program.  The table segment and
the payload are the same whichever route the program takes (its kernels
or its host container), so every stream of the cell is covered.  A CPU
test holds :func:`encode_one` byte for byte to the program's oracle,
``container.compress(image, quality, True, block_index=True)``.
"""

from __future__ import annotations

import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from portbench.reference import codec

MAX_LENGTH = 16
CATEGORIES = 16  # DC categories and AC sizes a table segment can name
FLAG_CUSTOM_TABLE = 1 << 31
# a token's place in its block: DC code, DC magnitude, then at each
# zig-zag position its ZRLs (at most 3 before any coefficient), code and
# magnitude, then EOB
_SLOTS = 8


def _size(x: torch.Tensor) -> torch.Tensor:
    """The bit length of |x| (int64)."""
    a = x.abs()
    n = torch.zeros_like(a)
    while bool((a > 0).any()):
        n += (a > 0).to(n.dtype)
        a = a >> 1
    return n


def _magnitude(x: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """``x``, or its one's complement in ``size`` bits where negative."""
    return torch.where(x < 0, x + (1 << size) - 1, x)


def symbols(zz: torch.Tensor) -> dict:
    """(n, 64) int64 zig-zag blocks of one image, DC DPCM'd -> the symbols
    of each block: ``dc_size``; the nonzero AC coefficients' ``block``,
    ``pos`` (zig-zag position, 1..63), ``value``, ``run`` (zeros before it
    in its block) and ``size``."""
    ac = zz[:, 1:]
    block, col = torch.nonzero(ac, as_tuple=True)  # block-major, ascending
    value = ac[block, col]
    first = torch.ones_like(block, dtype=torch.bool)
    first[1:] = block[1:] != block[:-1]
    prev = torch.full_like(col, -1)
    prev[~first] = col[:-1][~first[1:]]
    out = {"dc": zz[:, 0], "dc_size": _size(zz[:, 0]), "block": block,
           "pos": col + 1, "value": value, "run": col - prev - 1,
           "size": _size(value)}
    if (int(out["dc_size"].max()) >= CATEGORIES
            or (len(value) and int(out["size"].max()) >= CATEGORIES)):
        raise ValueError("a DC category or AC size of 16 or more: no "
                         "table segment can code it")
    return out


def histograms(sym: dict, n_blocks: int):
    """The counts of each DC category (16,) and each AC symbol (16, 16)
    [run, size]: ZRLs at (15, 0), one EOB a block at (0, 0)."""
    dc = torch.bincount(sym["dc_size"], minlength=CATEGORIES)
    ac = torch.bincount((sym["run"] % 16) * CATEGORIES + sym["size"],
                        minlength=CATEGORIES * CATEGORIES)
    ac = ac.reshape(CATEGORIES, CATEGORIES).clone()
    ac[15, 0] += int((sym["run"] // 16).sum())
    ac[0, 0] += n_blocks
    return dc, ac


def _text(symbol) -> str:
    """A DC category's decimal number; an AC symbol's ``(r, s)``."""
    return str(symbol) if isinstance(symbol, int) else \
        f"({symbol[0]}, {symbol[1]})"


def code_lengths(counts: list) -> dict:
    """[(symbol, count)] in symbol order, counts above 0 -> {symbol: code
    length}: the merges, the 16-bit limit, lengths by (depth, text)."""
    if len(counts) == 1:
        return {counts[0][0]: 1}
    # a node: [count, number, the leaves under it]
    nodes = [[c, k, [s]] for k, (s, c) in enumerate(counts)]
    depth = {s: 0 for s, _ in counts}
    number = len(nodes)
    while len(nodes) > 1:
        a = min(nodes, key=lambda nd: (nd[0], nd[1]))
        nodes.remove(a)
        b = min(nodes, key=lambda nd: (nd[0], nd[1]))
        nodes.remove(b)
        for s in a[2] + b[2]:
            depth[s] += 1
        nodes.append([a[0] + b[0], number, a[2] + b[2]])
        number += 1
    at_depth = [0] * (max(depth.values()) + 1)
    for d in depth.values():
        at_depth[d] += 1
    while len(at_depth) - 1 > MAX_LENGTH:  # Annex K.3, Figure K.3
        deepest = len(at_depth) - 1
        j = deepest - 2
        while at_depth[j] == 0:
            j -= 1
        at_depth[deepest] -= 2
        at_depth[deepest - 1] += 1
        at_depth[j + 1] += 2
        at_depth[j] -= 1
        while at_depth[-1] == 0:
            at_depth.pop()
    order = sorted(depth, key=lambda s: (depth[s], _text(s)))
    lengths = [ln for ln, k in enumerate(at_depth) for _ in range(k)]
    return dict(zip(order, lengths))


def canonical_codes(lengths: dict) -> dict:
    """{symbol: length} -> {symbol: (code, length)}, in order of (length,
    text)."""
    out, code, last = {}, 0, None
    for s in sorted(lengths, key=lambda s: (lengths[s], _text(s))):
        if last is not None:
            code = (code + 1) << (lengths[s] - last)
        out[s] = (code, lengths[s])
        last = lengths[s]
    return out


def tables(dc_counts: torch.Tensor, ac_counts: torch.Tensor):
    """Histograms -> the DC and AC codes, {symbol: (code, length)}."""
    dc = [(c, int(dc_counts[c])) for c in range(CATEGORIES)
          if dc_counts[c]]
    ac = [((r, s), int(ac_counts[r, s])) for r in range(16)
          for s in range(CATEGORIES) if ac_counts[r, s]]
    return (canonical_codes(code_lengths(dc)),
            canonical_codes(code_lengths(ac)))


def _code_arrays(dc_codes: dict, ac_codes: dict):
    """The codes as lookup tensors: DC (16,) and AC (16, 16) code and
    length (0: no code)."""
    arrays = [torch.zeros(CATEGORIES, dtype=torch.int64) for _ in range(2)]
    arrays += [torch.zeros((16, CATEGORIES), dtype=torch.int64)
               for _ in range(2)]
    for c, (code, ln) in dc_codes.items():
        arrays[0][c], arrays[1][c] = code, ln
    for (r, s), (code, ln) in ac_codes.items():
        arrays[2][r, s], arrays[3][r, s] = code, ln
    return arrays


def segment_tokens(dc_codes: dict, ac_codes: dict):
    """The table segment as (value, bits) tokens, in stream order."""
    out = [(len(dc_codes), 16)]
    for c in sorted(dc_codes):
        code, ln = dc_codes[c]
        out += [(c, 4), (ln, 8), (code, ln)]
    out.append((len(ac_codes), 16))
    for r, s in sorted(ac_codes):
        code, ln = ac_codes[(r, s)]
        out += [(r, 4), (s, 4), (ln, 8), (code, ln)]
    return out


def payload_tokens(sym: dict, n_blocks: int, dc_codes: dict,
                   ac_codes: dict):
    """(values, bit lengths, each block's first token): every code and
    magnitude of the payload in stream order, int64."""
    dc_code, dc_len, ac_code, ac_len = _code_arrays(dc_codes, ac_codes)
    blocks = torch.arange(n_blocks)
    run, size, value = sym["run"], sym["size"], sym["value"]
    at = sym["block"] * (2 + 64 * _SLOTS) + 2 + (sym["pos"] - 1) * _SLOTS
    keys = [blocks * (2 + 64 * _SLOTS), blocks * (2 + 64 * _SLOTS) + 1]
    vals = [dc_code[sym["dc_size"]], _magnitude(sym["dc"], sym["dc_size"])]
    lens = [dc_len[sym["dc_size"]], sym["dc_size"]]
    for k in range(3):  # the ZRLs before a coefficient
        z = run // 16 > k
        keys.append(at[z] + k)
        vals.append(torch.full_like(at[z], int(ac_code[15, 0])))
        lens.append(torch.full_like(at[z], int(ac_len[15, 0])))
    keys += [at + 4, at + 5, blocks * (2 + 64 * _SLOTS) + 2 + 63 * _SLOTS]
    vals += [ac_code[run % 16, size], _magnitude(value, size),
             torch.full_like(blocks, int(ac_code[0, 0]))]
    lens += [ac_len[run % 16, size], size,
             torch.full_like(blocks, int(ac_len[0, 0]))]
    order = torch.argsort(torch.cat(keys), stable=True)
    values, lengths = torch.cat(vals)[order], torch.cat(lens)[order]
    first = torch.nonzero(torch.cat(keys)[order] % (2 + 64 * _SLOTS) == 0,
                          as_tuple=True)[0]
    return values, lengths, first


def encode_one(image: np.ndarray, quality: int,
               index_stride: int = 64) -> bytes:
    """One (H, W) uint8 image -> its stream."""
    if index_stride & (index_stride - 1):
        raise ValueError("index stride must be a power of two")
    h, w = image.shape
    zz = codec.quantized(np.asarray(image)[None], quality)[0]
    dpcm = torch.from_numpy(zz.astype(np.int64))
    dpcm[:, 0] = torch.diff(dpcm[:, 0],
                            prepend=torch.zeros(1, dtype=torch.int64))
    n = dpcm.shape[0]
    sym = symbols(dpcm)
    dc_codes, ac_codes = tables(*histograms(sym, n))
    seg = segment_tokens(dc_codes, ac_codes)
    values, lengths, first = payload_tokens(sym, n, dc_codes, ac_codes)
    values = np.concatenate([[v for v, _ in seg], values.numpy()])
    lengths = np.concatenate([[b for _, b in seg], lengths.numpy()])
    payloads, within = codec._pack(values.astype(np.int64),
                                   lengths.astype(np.int64),
                                   np.zeros(len(lengths), np.int64), 1)
    seg_bits = sum(b for _, b in seg)
    offsets = within[len(seg) + first.numpy()] - seg_bits
    header = struct.pack("<IIII", h, w, quality, FLAG_CUSTOM_TABLE)
    return header + payloads[0] + codec._trailer(offsets, index_stride)


def encode_pool(pool, quality: int, index_stride: int = 64):
    """The streams of each input of ``pool`` (a list of (B, H, W)
    arrays), each image with its own tables, an image a thread: a list of
    streams an input."""
    pieces = [(k, i) for k, x in enumerate(pool) for i in range(len(x))]

    def enc(piece):
        k, i = piece
        return encode_one(pool[k][i], quality, index_stride)

    with ThreadPoolExecutor(max(1, min(len(pieces),
                                       codec.POOL_THREADS))) as ex:
        done = dict(zip(pieces, ex.map(enc, pieces)))
    return [[done[(k, i)] for i in range(len(x))] for k, x in enumerate(pool)]
