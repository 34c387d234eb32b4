"""Fused entropy encode: kernel wrapper and plain version.

Input: (N, 64) uint8 block-major pixels (fast mode: the float32 transform
runs inside) or, with ``from_zz=True``, (64, N) int32 coefficient-major
quantized zig-zag coefficients (e.g. from ``ops/exact_transform.py``).
N is B images of ``nb`` blocks each.

Output, the interface of the JAX package's ``encode_pallas2``:

- ``packed`` (N, 56) int32 bit patterns: each block's big-endian stream
  words, already shifted to the bit phase the block has in the final
  stream (so assembly is pure word placement, ``ops/place.py``);
- ``meta`` (2, N) int32: row 0 the block's global stream bit offset (image
  starts rounded up to a byte), row 1 its bit count;
- ``overflow``: a 0-dim bool tensor, true when a DC difference needs more
  than 11 bits or an AC coefficient more than 10 (outside the tables).

Per block: DC DPCM against the previous block (at each image's first
block against zero, or against ``dc_init``: the caller's (B,) int32 first
predictors, with which a range of one image's blocks is coded as a
continuation of the range before it), DC category code + magnitude bits; for every nonzero AC
coefficient up to three ZRL codes (a run of 16 zeros each), the (run,
size) code and the magnitude bits; EOB always.  The tables are arguments:
the standard ones, or ones built at run time (codes of up to 16 bits).

Replaces ``tinyimgcodec_tpu/ops/pallas_encode2.py`` (``_make_kernel``).
On the card: ``csrc/encode2.cu``, one launch.  From coefficients its bound
is bytes, and the kernel moves each once: a CTA stages a tile of 128
blocks in shared memory, codes every block once (the packing gives the
count), gets its stream offset from a single-pass scan across the CTAs
(tests/test_torch_encode2.py holds that scan's arithmetic in plain Python
against :func:`image_offsets`) and shifts the rows to their bit phase while it copies them out.  From pixels
the bound is the float32 transform's operations; its coefficients go
straight into the shared-memory tile, never to device memory.  The wrapper
adds one small zero fill (the scan's state) and nothing else.

The plain version below computes the same words with whole-tensor
operations on int64 (torch has no 32-bit unsigned shifts on the CPU) and
agrees with the kernel bit for bit on either input.  The kernel's float32
arithmetic is what fast mode's bytes are (:func:`fast_coefficients_plain`
spells it out): they are the same on every device, and differ from exact
mode's wherever a float32 sum lands on the other side of a rounding tie.
"""

from __future__ import annotations

import ctypes

import torch

from ..tables import CodecTables
from . import _build

ROW_WORDS = 56
SLOTS = 65  # DC + 63 AC + EOB
TILE = 128  # blocks a CTA of the kernel owns; tiles do not straddle images
# A block is at most 52 words of 32 bits and an image start pads at most 7:
# beyond this many blocks a worst-case stream's bit offsets pass int32,
# which ``meta`` and the 32-bit value of the scan's state word carry.
MAX_BLOCKS = (2 ** 31 - 1) // (52 * 32 + 7)
_M32 = 0xFFFFFFFF

launches = 0  # times encode2() launched the CUDA kernels
launches_by_card: dict[int, int] = {}  # the same count, by card index
launches_by_input = {"pixels": 0, "zz": 0}  # the same count, by input form
transform_launches = 0  # times fast_coefficients() launched its kernel
# blocks a slice of the plain fast transform: its products take 16 MiB
FAST_SLICE = 1024


def _category(v: torch.Tensor) -> torch.Tensor:
    """Bit length of |v| (0 for 0), for int64 values below 2**32."""
    a = v.abs()
    cat = torch.zeros_like(a)
    for s in (16, 8, 4, 2, 1):
        big = (a >> s) > 0
        cat = cat + big * s
        a = torch.where(big, a >> s, a)
    return cat + (a > 0)


def _magnitude(v: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    return (v - (v < 0).to(v.dtype)) & ((1 << size) - 1)


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding values in [0, 2**32) -> the same bits as int32."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def fast_coefficients_plain(pixels: torch.Tensor,
                            tables: CodecTables) -> torch.Tensor:
    """(N, 64) uint8 -> (64, N) int32 in the kernel's float32 arithmetic,
    which defines fast mode's coefficients: for each coefficient k,
    ``acc = x[0] * M[0, k]``, then ``acc = acc + x[q] * M[q, k]`` for
    q = 1..63 in ascending order, every product and every sum rounded to
    float32 on its own (elementwise multiplies and adds: no matrix
    product or fused operation, whose order or rounding is the library's);
    then ``acc - dc_offset`` in float32 for k = 0 and round half to even."""
    n = pixels.shape[0]
    dev = pixels.device
    m = tables.encode_matrix
    off = torch.tensor(tables.dc_offset, dtype=torch.float32, device=dev)
    out = torch.empty((64, n), dtype=torch.int32, device=dev)
    for s in range(0, n, FAST_SLICE):
        x = pixels[s:s + FAST_SLICE].to(torch.float32)
        prod = torch.mul(x[:, :, None], m)  # [block, pixel, coefficient]
        acc = prod[:, 0].clone()
        for q in range(1, 64):
            acc = torch.add(acc, prod[:, q])
        acc[:, 0] = torch.sub(acc[:, 0], off)
        out[:, s:s + FAST_SLICE] = torch.round(acc).to(torch.int32).T
    return out


def block_slots(zz: torch.Tensor, tables: CodecTables, nb: int,
                dc_init: torch.Tensor | None = None):
    """Symbols of every block as 65 slots (DC, 63 AC positions, EOB).

    ``zz`` (64, N) int64 coefficients; ``dc_init`` the (N / nb,) DC
    predictors of the images' first blocks (zero when ``None``).  Returns ``(sw, soff, blk_bits,
    over)``: each slot's bits left-aligned in three 32-bit words ``sw``
    (3, 65, N) (an empty slot is zero; a slot holds up to three 16-bit ZRL
    codes and a 26-bit code + magnitude, 74 bits), its exclusive bit
    offset inside the block (65, N), the block's bit count (N,) and the
    table-range flag.  Shared by the plain versions of both encode
    kernels."""
    n = zz.shape[1]
    dev = zz.device
    dc_comb = tables.dc_comb.to(torch.int64) & _M32
    ac_comb = tables.ac_comb.to(torch.int64) & _M32
    zhi = tables.zrl_hi.to(torch.int64) & _M32
    zlo = tables.zrl_lo.to(torch.int64) & _M32

    # ---- DC slot --------------------------------------------------------
    dc = zz[0]
    prev = torch.roll(dc, 1)
    prev[::nb] = 0 if dc_init is None else dc_init.to(torch.int64)
    # 32-bit wrap-around of the difference, as the kernel computes it
    diff = ((dc - prev + (1 << 31)) & _M32) - (1 << 31)
    cat = _category(diff)
    over = (cat > 11).any()
    cat = cat.clamp(max=11)
    comb = dc_comb[cat]
    val = ((comb >> 8) << cat) | _magnitude(diff, cat)
    dc_bits = (comb & 0xFF) + cat  # at most 16 + 11
    dc_w0 = (val << (32 - dc_bits)) & _M32

    # ---- AC slots ---------------------------------------------------------
    ac = zz[1:]  # (63, N)
    nz = ac != 0
    pos = torch.arange(63, device=dev).reshape(63, 1)
    marked = torch.where(nz, pos, -1)
    last_incl = torch.cummax(marked, dim=0).values
    last_excl = torch.cat(
        [torch.full((1, n), -1, dtype=torch.int64, device=dev),
         last_incl[:-1]]
    )
    run = pos - last_excl - 1
    size = _category(ac)
    over = over | (nz & (size > 10)).any()
    size = size.clamp(max=10)
    z = (run >> 4).clamp(0, 3)
    comb = ac_comb[((run & 15) * 11 + size).clamp(0, 175)]
    val = ((comb >> 8) << size) | _magnitude(ac, size)  # <= 26 bits
    zrl_len = ac_comb[15 * 11] & 0xFF
    end = z * zrl_len + (comb & 0xFF) + size  # <= 3 * 16 + 26
    # word j of the slot holds its bits [32j, 32j + 32): the value's part
    # there, right-aligned to the word's end, then the ZRL prefix's words
    ac_w = []
    for j in range(3):
        r = end - 32 * (j + 1)  # how far the value ends past word j
        ac_w.append(torch.where(r >= 0, val >> r.clamp(0, 63),
                                val << (-r).clamp(0, 32)) & _M32)
    ac_w[0] = (ac_w[0] | zhi[z]) * nz
    ac_w[1] = (ac_w[1] | zlo[z]) * nz
    ac_w[2] = ac_w[2] * nz
    ac_bits = end * nz

    # ---- slots -> block-local bit offsets ---------------------------------
    eob = ac_comb[0]
    eob_len = eob & 0xFF
    eob_w0 = ((eob >> 8) << (32 - eob_len)) & _M32
    zero = torch.zeros((1, n), dtype=torch.int64, device=dev)
    sw = torch.stack([
        torch.cat([dc_w0.reshape(1, n), ac_w[0], zero + eob_w0]),
        torch.cat([zero, ac_w[1], zero]),
        torch.cat([zero, ac_w[2], zero]),
    ])
    slen = torch.cat([dc_bits.reshape(1, n), ac_bits, zero + eob_len])
    csum = torch.cumsum(slen, dim=0)
    return sw, csum - slen, csum[-1], over


def pack_slots(sw: torch.Tensor, soff: torch.Tensor, phase: torch.Tensor,
               row_words: int) -> torch.Tensor:
    """Place every slot of :func:`block_slots` at bit ``phase + soff`` of
    its block's row: (N, row_words) int32 bit patterns."""
    k, _, n = sw.shape
    so = soff + phase.reshape(1, n)
    sh = so & 31
    has = sh > 0
    nsh = (32 - sh) & 31
    # the slot's k words shifted right by sh spread over k + 1 words
    parts = [sw[0] >> sh]
    for i in range(1, k):
        parts.append((((sw[i - 1] << nsh) & _M32) * has) | (sw[i] >> sh))
    parts.append(((sw[k - 1] << nsh) & _M32) * has)
    tgt = (so >> 5).T.contiguous()  # (N, 65)
    rows = torch.zeros((n, row_words + k + 1), dtype=torch.int64,
                       device=sw.device)
    for i, c in enumerate(parts):  # disjoint bits: ADD == OR
        rows.scatter_add_(1, tgt + i, c.T.contiguous())
    return _as_i32(rows[:, :row_words].contiguous())


def image_offsets(blk_bits: torch.Tensor, nb: int):
    """Per-block global bit offsets (N,) int64 with every image's start
    rounded up to a byte, the image starts (B,) and the total bits (the
    last image is not padded)."""
    per_img = blk_bits.reshape(-1, nb)
    local = torch.cumsum(per_img, dim=1) - per_img
    starts, s = [], 0
    sums = per_img.sum(dim=1).tolist()
    for i, bits in enumerate(sums):
        starts.append(s)
        s += bits
        if i + 1 < len(sums):
            s = (s + 7) & ~7
    starts_t = torch.tensor(starts, dtype=torch.int64, device=blk_bits.device)
    return (local + starts_t.reshape(-1, 1)).reshape(-1), starts_t, s


def encode2_plain(x: torch.Tensor, tables: CodecTables, nb: int,
                  from_zz: bool = False, dc_init: torch.Tensor | None = None):
    """Plain PyTorch version (any device) of :func:`encode2`."""
    _check(x, tables, nb, from_zz, dc_init)
    zz = (x if from_zz else fast_coefficients_plain(x, tables)).to(torch.int64)
    sw, soff, blk_bits, over = block_slots(zz, tables, nb, dc_init)
    off, _, _ = image_offsets(blk_bits, nb)
    packed = pack_slots(sw, soff, off & 31, ROW_WORDS)
    meta = torch.stack([off, blk_bits]).to(torch.int32)
    return packed, meta, over


def _check(x: torch.Tensor, tables: CodecTables, nb: int,
           from_zz: bool, dc_init: torch.Tensor | None = None) -> int:
    if from_zz:
        if x.dtype != torch.int32 or x.ndim != 2 or x.shape[0] != 64:
            raise ValueError("from_zz input must be a (64, N) int32 tensor")
        n = x.shape[1]
    else:
        if x.dtype != torch.uint8 or x.ndim != 2 or x.shape[1] != 64:
            raise ValueError("pixel input must be an (N, 64) uint8 tensor")
        n = x.shape[0]
    if tables.device != x.device:
        raise ValueError("tables and input lie on different devices")
    if nb < 1 or n == 0 or n % nb:
        raise ValueError(f"N={n} is not a positive multiple of nb={nb}")
    if n > MAX_BLOCKS:
        raise ValueError(
            f"N={n} blocks: a worst-case stream's bit offsets would pass "
            f"int32 (at most {MAX_BLOCKS} blocks)")
    if dc_init is not None and (
            dc_init.dtype != torch.int32 or dc_init.shape != (n // nb,)
            or dc_init.device != x.device):
        raise ValueError(
            f"dc_init must be a ({n // nb},) int32 tensor on {x.device}")
    return n


def _lib() -> ctypes.CDLL:
    lib = _build.load("encode2")
    fn = lib.encode2_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [
            p, ctypes.c_int, p, ctypes.c_float, p, p, p, p,
            p, p, p, p, ctypes.c_int, ctypes.c_int, p,
        ]
        fn.restype = ctypes.c_int
        ft = lib.fast_transform_launch
        ft.argtypes = [p, p, ctypes.c_float, p, ctypes.c_int, p]
        ft.restype = ctypes.c_int
    return lib


def fast_coefficients(pixels: torch.Tensor,
                      tables: CodecTables) -> torch.Tensor:
    """The float32 transform pass of :func:`encode2` on its own: (N, 64)
    uint8 -> (64, N) int32.  Lets a test hold the kernel's coefficients
    against the plain version's before entropy coding hides them."""
    n = _check(pixels, tables, 1, False)
    if pixels.device.type == "cpu":
        return fast_coefficients_plain(pixels, tables)
    if pixels.device.type != "cuda":
        raise ValueError(f"unsupported device {pixels.device}")
    global transform_launches
    pixels = pixels.contiguous()
    zz = torch.empty((64, n), dtype=torch.int32, device=pixels.device)
    lib = _lib()
    with torch.cuda.device(pixels.device):
        err = lib.fast_transform_launch(
            pixels.data_ptr(), tables.encode_matrix.data_ptr(),
            tables.dc_offset, zz.data_ptr(), n,
            _build.stream_handle(pixels.device),
        )
    _build.check(err, "encode2 fast transform")
    with _build.COUNT_LOCK:
        transform_launches += 1
    return zz


def encode2(x: torch.Tensor, tables: CodecTables, nb: int,
            from_zz: bool = False, dc_init: torch.Tensor | None = None):
    """See the module docstring.  Returns ``(packed, meta, overflow)``.
    CUDA tensors go to the kernels, CPU tensors to the plain version;
    nothing else is tried."""
    if x.device.type == "cpu":
        return encode2_plain(x, tables, nb, from_zz, dc_init)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n = _check(x, tables, nb, from_zz, dc_init)
    if dc_init is not None:
        dc_init = dc_init.contiguous()
    x = x.contiguous()
    dev = x.device
    packed = torch.empty((n, ROW_WORDS), dtype=torch.int32, device=dev)
    meta = torch.empty((2, n), dtype=torch.int32, device=dev)
    # the scan's state, zeroed on every call: ticket, overflow flag, then
    # one word a tile
    tiles = (n // nb) * -(-nb // TILE)
    scan = torch.zeros((2 + tiles,), dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.encode2_launch(
            x.data_ptr(), int(from_zz), tables.encode_matrix.data_ptr(),
            tables.dc_offset, tables.dc_comb.data_ptr(),
            tables.ac_comb.data_ptr(), tables.zrl_hi.data_ptr(),
            tables.zrl_lo.data_ptr(),
            None if dc_init is None else dc_init.data_ptr(), scan.data_ptr(),
            packed.data_ptr(), meta.data_ptr(), n, int(nb),
            _build.stream_handle(dev),
        )
    _build.check(err, "encode2")
    _build.count_launch(globals(), dev)
    with _build.COUNT_LOCK:
        launches_by_input["zz" if from_zz else "pixels"] += 1
    return packed, meta, scan[1] != 0
