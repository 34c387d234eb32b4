"""Block-local entropy encode: kernel wrapper and plain version.

Input: (N, 64) uint8 block-major pixels (the float32 fast transform runs
inside) or, with ``from_zz=True``, (N, 64) int32 block-major quantized
zig-zag coefficients.  N is B images of ``nb`` blocks each; the DC
predictor resets at every image's first block.

Output, the function of the JAX package's ``encode_pallas``:

- ``words`` (N, 52) int32 bit patterns: each block's big-endian code
  words packed from bit 0 of its own row, zero after the last bit;
- ``bits`` (N,) int32: the block's bit count (at most 1662);
- ``overflow``: a 0-dim bool tensor, true when a DC difference needs more
  than 11 bits or an AC coefficient more than 10 (outside the tables).

``ops/stitch.py`` concatenates the ragged rows into one stream.  Together
they are the ``version="v1"`` encode path, whose bytes equal the
``encode2`` + ``place`` path's.

Replaces ``tinyimgcodec_tpu/ops/pallas_encode.py`` (``_make_kernel``).  On
the card: ``csrc/encode1.cu`` (see the note there), one launch: a CTA
stages a tile of 128 blocks in shared memory (from pixels the transform
writes into it, so no coefficient matrix exists in device memory), codes
every block once and copies the rows out 16 bytes a store.  It runs the
same device code for the transform and the symbols as ``csrc/encode2.cu``.
The plain version shares :func:`..encode2.block_slots` and
:func:`..encode2.fast_coefficients_plain` with ``encode2_plain`` and
agrees with the kernel bit for bit on either input.
"""

from __future__ import annotations

import ctypes

import torch

from ..tables import CodecTables
from . import _build
from .encode2 import block_slots, fast_coefficients_plain, pack_slots

BLOCK_WORDS = 52

launches = 0  # times encode1() launched the CUDA kernel
launches_by_card: dict[int, int] = {}  # the same count, by card index


def _check(x: torch.Tensor, tables: CodecTables, nb: int,
           from_zz: bool) -> int:
    want = torch.int32 if from_zz else torch.uint8
    if x.dtype != want or x.ndim != 2 or x.shape[1] != 64:
        raise ValueError(
            "input must be an (N, 64) tensor, uint8 pixels or (from_zz) "
            "int32 coefficients"
        )
    n = x.shape[0]
    if tables.device != x.device:
        raise ValueError("tables and input lie on different devices")
    if nb < 1 or n == 0 or n % nb:
        raise ValueError(f"N={n} is not a positive multiple of nb={nb}")
    return n


def encode1_plain(x: torch.Tensor, tables: CodecTables, nb: int,
                  from_zz: bool = False):
    """Plain PyTorch version (any device) of :func:`encode1`."""
    _check(x, tables, nb, from_zz)
    zz = x.T if from_zz else fast_coefficients_plain(x, tables)
    sw, soff, blk_bits, over = block_slots(zz.to(torch.int64), tables, nb)
    words = pack_slots(sw, soff, torch.zeros_like(blk_bits), BLOCK_WORDS)
    return words, blk_bits.to(torch.int32), over


def _lib() -> ctypes.CDLL:
    lib = _build.load("encode1")
    fn = lib.encode1_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [
            p, ctypes.c_int, p, ctypes.c_float, p, p, p, p,
            p, p, p, ctypes.c_int, ctypes.c_int, p,
        ]
        fn.restype = ctypes.c_int
    return lib


def encode1(x: torch.Tensor, tables: CodecTables, nb: int,
            from_zz: bool = False):
    """See the module docstring.  Returns ``(words, bits, overflow)``.
    CUDA tensors go to the kernel, CPU tensors to the plain version;
    nothing else is tried."""
    if x.device.type == "cpu":
        return encode1_plain(x, tables, nb, from_zz)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n = _check(x, tables, nb, from_zz)
    x = x.contiguous()
    if not from_zz and x.data_ptr() % 16:
        x = x.clone()  # the transform reads a block's pixels 16 bytes a load
    i32 = dict(dtype=torch.int32, device=x.device)
    words = torch.empty((n, BLOCK_WORDS), **i32)
    bits = torch.empty((n,), **i32)
    over = torch.zeros((1,), **i32)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.encode1_launch(
            x.data_ptr(), int(from_zz), tables.encode_matrix.data_ptr(),
            tables.dc_offset, tables.dc_comb.data_ptr(),
            tables.ac_comb.data_ptr(), tables.zrl_hi.data_ptr(),
            tables.zrl_lo.data_ptr(),
            words.data_ptr(), bits.data_ptr(), over.data_ptr(), n, int(nb),
            _build.stream_handle(x.device),
        )
    _build.check(err, "encode1")
    _build.count_launch(globals(), x.device)
    # the flag is 0 or 1: its first byte read as a bool, no launch
    return words, bits, over.view(torch.bool)[0]
