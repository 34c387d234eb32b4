"""Fused entropy encode: the port's plain version (the CUDA kernels' twin,
bit for bit on coefficient input) vs the JAX package's Pallas kernel in
interpret mode.  Every case has the shape (64, 128), nb = 64, so the JAX
side compiles once."""

import jax
import numpy as np
import pytest
import torch

from tinyimgcodec_tpu import golden as jgolden
from tinyimgcodec_tpu.constants import ZIGZAG_ORDER
from tinyimgcodec_tpu.ops import transform as jtransform
from tinyimgcodec_tpu.ops.pallas_encode2 import encode_pallas2
from tinyimgcodec_tpu_torch.ops import encode2 as tenc
from tinyimgcodec_tpu_torch.tables import CodecTables

from conftest import synthetic_image

QUALITY = 50
N, NB = 128, 64
TABLES = CodecTables.build(QUALITY, "cpu")

# jitted like the JAX pipeline's own stage: traced and compiled once
_JAX_ENCODE = jax.jit(
    lambda zz: encode_pallas2(
        zz, QUALITY, nb=NB, bt=64, interpret=True, from_zz=True
    )
)


def _both(zz_cm: np.ndarray):
    """zz (64, N) int32 through both packages -> (mine, theirs) as numpy
    (packed uint32 (N, 56), meta uint32 (2, N), overflow bool)."""
    pj, mj, oj = _JAX_ENCODE(zz_cm)
    pt, mt, ot = tenc.encode2(
        torch.from_numpy(zz_cm.copy()), TABLES, NB, from_zz=True
    )
    mine = (pt.numpy().view(np.uint32), mt.numpy().view(np.uint32), bool(ot))
    theirs = (np.asarray(pj), np.asarray(mj), bool(oj))
    return mine, theirs


def _assert_equal(mine, theirs):
    assert mine[0].shape == theirs[0].shape == (N, 56)
    assert np.array_equal(mine[1], theirs[1]), "meta differs"
    assert np.array_equal(mine[0], theirs[0]), "packed rows differ"
    assert mine[2] == theirs[2]


def _natural(quality=QUALITY, noise=False) -> np.ndarray:
    if noise:
        rng = np.random.RandomState(9)
        imgs = rng.randint(0, 256, (2, 64, 64)).astype(np.uint8)
    else:
        imgs = np.stack([synthetic_image(64, 64, seed=s) for s in (41, 42)])
    blocks = np.asarray(jtransform.blockify(imgs)).reshape(-1, 8, 8)
    co = jgolden.quantize(
        jgolden.block_dct(blocks.astype(np.float64) - 128.0), quality
    ).reshape(-1, 64)[:, ZIGZAG_ORDER]
    return np.ascontiguousarray(co.T.astype(np.int32))


def test_natural_content_all_outputs_equal():
    mine, theirs = _both(_natural())
    _assert_equal(mine, theirs)
    assert not mine[2]


def test_dense_noise_all_outputs_equal():
    mine, theirs = _both(_natural(quality=90, noise=True))
    _assert_equal(mine, theirs)


def test_image_boundary_resets_dc_and_aligns_to_a_byte():
    zz = _natural()
    mine, theirs = _both(zz)
    off, bits = mine[1][0].astype(np.int64), mine[1][1].astype(np.int64)
    assert off[0] == 0
    assert off[NB] % 8 == 0
    assert off[NB] == (off[NB - 1] + bits[NB - 1] + 7) // 8 * 8
    # inside an image offsets are the running sum of the counts
    assert np.array_equal(off[1:NB], np.cumsum(bits[: NB - 1]))
    assert np.array_equal(off[NB + 1:] - off[NB], np.cumsum(bits[NB:-1]))
    # DC reset: swapping image 0's content leaves image 1's rows' content
    # (up to its phase, which is 0 at a byte-aligned start) unchanged
    zz2 = zz.copy()
    zz2[:, :NB] = 0
    p2 = tenc.encode2(torch.from_numpy(zz2), TABLES, NB, from_zz=True)[0]
    assert np.array_equal(
        p2.numpy().view(np.uint32)[NB], mine[0][NB]
    )


@pytest.mark.parametrize("gap", [15, 16, 17, 31, 32, 47, 48, 49, 62])
def test_long_zero_runs(gap):
    """Runs >= 16, >= 32, >= 48 take one, two, three ZRL prefixes."""
    rng = np.random.RandomState(gap)
    zz = np.zeros((64, N), np.int32)
    zz[0] = rng.randint(-50, 50, N)
    zz[1 + gap] = rng.randint(1, 1023, N) * rng.choice([-1, 1], N)
    zz[63, ::3] = -1  # a second run after the first, to the last slot
    mine, theirs = _both(zz)
    _assert_equal(mine, theirs)


def test_worst_case_block_fills_the_row():
    """63 AC coefficients of size 10 with 16-bit codes: the longest legal
    block (1662 bits), at every bit phase."""
    rng = np.random.RandomState(3)
    zz = np.zeros((64, N), np.int32)
    zz[0] = np.where(np.arange(N) % 2 == 0, 1500, -1500)
    zz[1:] = rng.randint(512, 1024, (63, N)) * rng.choice([-1, 1], (63, N))
    zz[1:, 1::2] = 0  # short blocks in between move the phase around
    zz[5, 1::2] = rng.randint(1, 8, N // 2)
    mine, theirs = _both(zz)
    _assert_equal(mine, theirs)
    assert mine[1][1].max() >= 1600


@pytest.mark.parametrize(
    "row, value, expect",
    [(0, 2047, False), (0, 2048, True), (0, -2048, True),
     (7, 1023, False), (7, 1024, True), (63, -1024, True)],
)
def test_table_range_overflow_flag(row, value, expect):
    """DC difference of category 12 or an AC coefficient of size 11 lies
    outside the Annex K tables: the flag is raised, as in JAX."""
    zz = _natural()
    if row == 0:
        zz[0, NB:] = 0  # differences: +value, 0, -value
        zz[0, 71] = value
    zz[row, 70] = value
    mine, theirs = _both(zz)
    assert mine[2] == theirs[2] == expect
    if not expect:
        _assert_equal(mine, theirs)


def test_pixel_input_uses_the_fast_transform():
    imgs = np.stack([synthetic_image(64, 64, seed=s) for s in (41, 42)])
    blocks = torch.from_numpy(
        np.array(jtransform.blockify(imgs)).reshape(-1, 64)
    )
    zz = tenc.fast_coefficients(blocks, TABLES)
    a = tenc.encode2(blocks, TABLES, NB)
    b = tenc.encode2(zz, TABLES, NB, from_zz=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    theirs = np.asarray(jtransform.encode_blocks(
        np.asarray(jtransform.blockify(imgs)), QUALITY, jtransform.FAST
    )).reshape(-1, 64)
    diff = np.abs(zz.numpy().T.astype(np.int64) - theirs)
    # the tie bar of the float32 transform (see test_torch_transform.py)
    assert diff.max() <= 1 and (diff != 0).sum() <= 1e-4 * diff.size


# ---- the kernel's scan across its CTAs, as plain Python


def run_then(older: tuple, newer: tuple) -> tuple:
    """Composition of two runs of tiles, ``older`` first.  A run is
    ``(has, a1, a2)`` and maps the running stream offset ``s`` to
    ``align8(s + a1) + a2`` when it holds an image start (``has``), else
    to ``s + a1``.  ``align8(x + y) = x + align8(y)`` for ``x`` a multiple
    of 8 keeps the family closed; the operation is associative, not
    commutative.  The kernel's ``then``."""
    oh, o1, o2 = older
    nh, n1, n2 = newer
    if not nh:
        return (1, o1, o2 + n1) if oh else (0, o1 + n1, 0)
    if oh:
        return (1, o1, ((o2 + n1 + 7) & ~7) + n2)
    return (1, o1 + n1, n2)


def run_apply(run: tuple, s: int) -> int:
    has, a1, a2 = run
    return ((s + a1 + 7) & ~7) + a2 if has else s + a1


def tile_offsets(blk_bits: torch.Tensor, nb: int,
                 tile: int = tenc.TILE, window: int = 32, resolved=None):
    """The kernel's single-pass scan in plain Python: per-block global bit
    offsets (N,) int64 from the tile sums alone, as ``image_offsets``
    gives them.  Every tile walks back over its predecessors ``window`` at
    a time, reduces each window pairwise in order, and stops at the
    nearest tile that ``resolved(j)`` says already knows its end (tile -1,
    the start of the stream, always does) -- on the card that depends on
    timing; the result must not."""
    per_img = blk_bits.reshape(-1, nb).to(torch.int64)
    tpi = -(-nb // tile)
    sums, local = [], []
    for row in per_img:
        for t in range(tpi):
            part = row[t * tile:(t + 1) * tile]
            sums.append(int(part.sum()))
            local.append(torch.cumsum(part, 0) - part)
    ends: list[int] = []
    out = []
    for g, a in enumerate(sums):
        starts_image = g % tpi == 0
        acc = (0, 0, 0)
        j0 = g - 1
        while True:
            lanes = []
            known = None
            for j in range(j0, j0 - window, -1):
                if j < 0 or (resolved is None or resolved(j)):
                    known = 0 if j < 0 else ends[j]
                    break
                lanes.append((1, 0, sums[j]) if j % tpi == 0
                             else (0, sums[j], 0))
            while len(lanes) > 1:  # pairwise, the higher index is older
                lanes = [run_then(lanes[i + 1], lanes[i])
                         if i + 1 < len(lanes) else lanes[i]
                         for i in range(0, len(lanes), 2)]
            if lanes:
                acc = run_then(lanes[0], acc)
            if known is not None:
                at = run_apply(acc, known)
                break
            j0 -= window
        if starts_image:
            at = (at + 7) & ~7
        ends.append(at + a)
        out.append(local[g] + at)
    return torch.cat(out)


@pytest.mark.parametrize(
    "nb, images, tile, window",
    [(64, 2, 128, 32), (300, 3, 128, 32), (1, 37, 128, 32), (4096, 1, 128, 32),
     (100, 5, 16, 4), (33, 7, 8, 3), (40, 1, 4, 32), (5, 64, 4, 2)],
    ids=["two-tiles", "nb-not-a-multiple-of-the-tile", "one-block-images",
         "one-image-32-tiles", "small-tiles", "ragged-small", "B1-small",
         "many-images-small"],
)
@pytest.mark.parametrize("order", ["all-resolved", "none-resolved", "random"])
def test_tile_scan_composition_equals_image_offsets(nb, images, tile, window,
                                                    order):
    """The kernel's single-pass scan, in plain Python: tile sums composed
    as runs ``s -> align8(s + a1) + a2`` give ``image_offsets``' offsets,
    whichever predecessors already know their end when a tile looks."""
    rng = np.random.RandomState(nb * 131 + images)
    bits = torch.from_numpy(rng.randint(6, 1663, nb * images))
    want, starts, total = tenc.image_offsets(bits, nb)
    pick = np.random.RandomState(7)
    resolved = {"all-resolved": None, "none-resolved": lambda j: False,
                "random": lambda j: bool(pick.randint(0, 4) == 0)}[order]
    got = tile_offsets(bits, nb, tile=tile, window=window,
                            resolved=resolved)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    assert all(int(s) % 8 == 0 for s in starts)


def test_run_composition_is_associative_and_matches_its_meaning():
    rng = np.random.RandomState(11)

    def rand_run():
        if rng.randint(0, 2):
            return (1, int(rng.randint(0, 5000)), int(rng.randint(0, 5000)))
        return (0, int(rng.randint(0, 5000)), 0)

    for _ in range(300):
        a, b, c = rand_run(), rand_run(), rand_run()
        s = int(rng.randint(0, 10 ** 6))
        ab = run_then(a, b)
        assert run_apply(ab, s) == run_apply(b, run_apply(a, s))
        assert run_then(ab, c) == run_then(a, run_then(b, c))
        assert run_then((0, 0, 0), a) == a == run_then(a, (0, 0, 0))


def test_block_count_whose_offsets_would_pass_int32_is_refused():
    assert tenc.MAX_BLOCKS * (52 * 32 + 7) < 2 ** 31
    assert tenc.MAX_BLOCKS >= (16 << 20) // 64  # the pipeline's pixel limit
    # a (64, N) tensor of that width without its memory: one int, expanded
    wide = torch.empty((1,), dtype=torch.int32).expand(64, tenc.MAX_BLOCKS + 1)
    with pytest.raises(ValueError, match="int32"):
        tenc.encode2(wide, TABLES, 1, from_zz=True)


def test_wrapper_validates_and_counts_no_launch_on_cpu():
    before = tenc.launches
    tenc.encode2(torch.zeros((64, 8), dtype=torch.int32), TABLES, 4,
                 from_zz=True)
    assert tenc.launches == before
    with pytest.raises(ValueError):
        tenc.encode2(torch.zeros((64, 9), dtype=torch.int32), TABLES, 4,
                     from_zz=True)
    with pytest.raises(ValueError):
        tenc.encode2(torch.zeros((8, 64), dtype=torch.int32), TABLES, 4)
