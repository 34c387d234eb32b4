"""Exact transform: the port's plain version vs the JAX package's
double-float Pallas kernel in interpret mode, and vs the float64 oracle;
the CUDA kernel's tensor-core arithmetic (``csrc/exact_transform.cu``)
modelled lane by lane in numpy (:func:`dmma_model`), held against the
plain version; and the step both take on a tie-flagged block, scipy's DCT
in scipy's own order (``oracle_dct8``), held to scipy bit for bit and
modelled as the kernel's eight lanes a block run it."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tinyimgcodec_tpu import golden as jgolden
from tinyimgcodec_tpu.constants import ZIGZAG_ORDER
from tinyimgcodec_tpu.ops import transform as jtransform
from tinyimgcodec_tpu.ops.pallas_exact import exact_transform_pallas_cm
from tinyimgcodec_tpu_torch.ops import exact_transform as tex
from tinyimgcodec_tpu_torch.pipeline import exact_coefficients
from tinyimgcodec_tpu_torch.tables import CodecTables

from conftest import synthetic_image

QUALITY = 50
N_TIE = 8


@pytest.fixture(scope="module")
def case():
    """128 blocks: natural content, noise, and N_TIE constant-129 blocks
    (DC = 8/16 = 0.5 at quality 50: an exact rational tie).  One shape, so
    the JAX side compiles once."""
    rng = np.random.RandomState(5)
    img = synthetic_image(64, 96, seed=31)
    nat = np.asarray(jtransform.blockify(img)).reshape(-1, 64)  # 96 blocks
    noise = rng.randint(0, 256, (128 - 96 - N_TIE, 64)).astype(np.uint8)
    tie = np.full((N_TIE, 64), 129, np.uint8)
    blocks = np.concatenate([nat, noise, tie]).astype(np.uint8)
    zz_j, fl_j = exact_transform_pallas_cm(
        blocks.astype(np.int32).T, QUALITY, bt=64, interpret=True,
        with_flags=True,
    )
    tables = CodecTables.build(QUALITY, "cpu")
    zz_t, fl_t, _ = tex.exact_transform(torch.from_numpy(blocks), tables)
    gold = jgolden.quantize(
        jgolden.block_dct(
            blocks.reshape(-1, 8, 8).astype(np.float64) - 128.0
        ),
        QUALITY,
    ).reshape(-1, 64)[:, ZIGZAG_ORDER]
    return dict(
        blocks=blocks, tables=tables, gold=gold,
        zz_j=np.asarray(zz_j), fl_j=np.asarray(fl_j)[0].astype(bool),
        zz_t=zz_t.numpy(), fl_t=fl_t.numpy().astype(bool),
    )


def test_shapes_and_types(case):
    assert case["zz_t"].shape == case["zz_j"].shape == (64, 128)
    assert case["zz_t"].dtype == np.int32
    assert case["fl_t"].shape == (128,)


def test_unflagged_blocks_equal_the_jax_kernel(case):
    """The set of flagged blocks may differ (double-float error is not
    float64 error); every block neither side flags must agree."""
    keep = ~(case["fl_t"] | case["fl_j"])
    assert keep.sum() > 64
    assert np.array_equal(case["zz_t"][:, keep], case["zz_j"][:, keep])


def test_unflagged_blocks_equal_golden(case):
    keep = ~case["fl_t"]
    assert np.array_equal(case["zz_t"][:, keep].T, case["gold"][keep])


def test_flagged_blocks_equal_golden_too(case):
    assert case["fl_t"].sum() >= N_TIE
    assert np.array_equal(case["zz_t"].T, case["gold"])


def test_exact_tie_blocks_are_flagged(case):
    assert case["fl_t"][-N_TIE:].all(), "DC ties must be flagged"
    assert case["fl_j"][-N_TIE:].all()


def test_host_fixup_reaches_golden(case):
    zz = exact_coefficients(torch.from_numpy(case["blocks"]), case["tables"])
    assert np.array_equal(zz.numpy().T, case["gold"])


def test_wrapper_takes_the_plain_version_on_cpu_only(case):
    before = tex.launches
    a = tex.exact_transform(torch.from_numpy(case["blocks"]), case["tables"])
    b = tex.exact_transform_plain(
        torch.from_numpy(case["blocks"]), case["tables"]
    )
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[2].shape == () and a[2].dtype == torch.int64
    assert int(a[2]) == int(a[1].sum())
    assert tex.launches == before  # no kernel launch on a CPU tensor


def test_wrapper_rejects_wrong_input(case):
    with pytest.raises(ValueError):
        tex.exact_transform(torch.zeros((4, 64), dtype=torch.int32),
                            case["tables"])
    with pytest.raises(ValueError):
        tex.exact_transform(torch.zeros((4, 63), dtype=torch.uint8),
                            case["tables"])


# ---- the CUDA kernel's tensor-core arithmetic, lane by lane, in numpy -----

LANE = np.arange(32)
G, Q = LANE >> 2, LANE & 3  # the lane's group and its place in the group
TWO52 = 2.0 ** 52
RINT_MAGIC = 1.5 * 2.0 ** 52


def _kernel_source() -> str:
    return (Path(tex.__file__).resolve().parent.parent / "csrc"
            / "exact_transform.cu").read_text()


def _zz_slot() -> np.ndarray:
    """The kernel's ZZ_SLOT table, read from its source."""
    body = re.search(r"ZZ_SLOT\[64\] = \{([^}]*)\}", _kernel_source()).group(1)
    return np.array([int(v) for v in body.replace("\n", " ").split(",")])


def mma_m8n8k4(a, b, c):
    """``mma.sync.aligned.m8n8k4.row.col.f64``: per lane l = 4 g + q,
    ``a`` holds A[g][q], ``b`` B[q][g], ``c`` (..., 32, 2) C[g][2q + i];
    returns D = A B + C in C's layout.  Leading axes: blocks."""
    lead = np.broadcast_shapes(np.shape(a), np.shape(b), np.shape(c)[:-1])[:-1]
    A = np.zeros(lead + (8, 4))
    B = np.zeros(lead + (4, 8))
    C = np.zeros(lead + (8, 8))
    A[..., G, Q] = a
    B[..., Q, G] = b
    C[..., G, 2 * Q] = np.broadcast_to(c, lead + (32, 2))[..., 0]
    C[..., G, 2 * Q + 1] = np.broadcast_to(c, lead + (32, 2))[..., 1]
    D = A @ B + C
    return np.stack([D[..., G, 2 * Q], D[..., G, 2 * Q + 1]], axis=-1)


def mma_m16n8k8(a, b):
    """``mma.sync.aligned.m16n8k8.row.col.f64``: per lane l = 4 g + q, ``a``
    (..., 32, 4) holds A[g][q], A[g + 8][q], A[g][q + 4], A[g + 8][q + 4],
    ``b`` (..., 32, 2) B[q][g], B[q + 4][g]; returns D = A B (..., 32, 4):
    D[g][2q], D[g][2q + 1], D[g + 8][2q], D[g + 8][2q + 1]."""
    lead = np.broadcast_shapes(np.shape(a)[:-1], np.shape(b)[:-1])[:-1]
    a = np.broadcast_to(a, lead + (32, 4))
    b = np.broadcast_to(b, lead + (32, 2))
    A = np.zeros(lead + (16, 8))
    B = np.zeros(lead + (8, 8))
    A[..., G, Q], A[..., G + 8, Q] = a[..., 0], a[..., 1]
    A[..., G, Q + 4], A[..., G + 8, Q + 4] = a[..., 2], a[..., 3]
    B[..., Q, G], B[..., Q + 4, G] = b[..., 0], b[..., 1]
    D = A @ B
    return np.stack([D[..., G, 2 * Q], D[..., G, 2 * Q + 1],
                     D[..., G + 8, 2 * Q], D[..., G + 8, 2 * Q + 1]], axis=-1)


def shifted_pixel(byte):
    """byte - 128 as the kernel makes it: the bit pattern of 2**52 + byte,
    then one subtraction."""
    bits = (np.uint64(0x43300000) << np.uint64(32)) | byte.astype(np.uint64)
    return bits.view(np.float64) - (TWO52 + 128.0)


def rint_and_int32(q):
    """round half to even and the int32 result, by adding 1.5 * 2**52: the
    rounded value, and the low 32 bits of the sum's bit pattern."""
    t = q + RINT_MAGIC
    low = (t.view(np.uint64) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return t - RINT_MAGIC, low.view(np.int32)


def dmma_model(blocks: np.ndarray, tables):
    """What ``exact_transform_kernel`` computes for (N, 64) uint8 blocks,
    from the per-lane pieces of its two 8x8x4 products a block (stage 1)
    and its 16x8x8 product for two blocks (stage 2): returns the quantized
    coefficients before rounding (N, 8, 8), the (64, N) int32 zig-zag
    output and the (N,) flags."""
    d = tables.dct_basis.numpy()
    r = tables.recip_divisors.numpy()
    x = blocks.reshape(-1, 8, 8)
    n = x.shape[0]
    zero = np.zeros((n, 32, 2))
    # stage 1, Y = D X: A = D[g][q + 4s], B = X[q + 4s][g]
    y = mma_m8n8k4(d[G, Q], shifted_pixel(x[:, Q, G]), zero)
    y = mma_m8n8k4(d[G, Q + 4], shifted_pixel(x[:, Q + 4, G]), y)
    # stage 2, C = Y D^T over j = 2k + s, blocks 2i and 2i + 1 in one
    # 16x8x8 product: A = Y[g][2q + s] of each as the lane holds it,
    # B = D[g][2q + s]
    if n % 2:
        y = np.concatenate([y, y[-1:]])
    pair = y.reshape(-1, 2, 32, 2)
    a = np.stack([pair[:, 0, :, 0], pair[:, 1, :, 0],
                  pair[:, 0, :, 1], pair[:, 1, :, 1]], axis=-1)
    dd = mma_m16n8k8(a, np.stack([d[G, 2 * Q], d[G, 2 * Q + 1]], axis=-1))
    c = np.stack([dd[..., :2], dd[..., 2:]], axis=1).reshape(-1, 32, 2)[:n]
    q = np.empty((n, 8, 8))
    q[:, G, 2 * Q] = c[..., 0] * r[G, 2 * Q]
    q[:, G, 2 * Q + 1] = c[..., 1] * r[G, 2 * Q + 1]
    v, ints = rint_and_int32(q)
    flags = (np.abs(np.abs(q - v) - 0.5) < tex.TIE_SNAP).reshape(n, 64).any(1)
    zz = np.empty((64, n), np.int32)
    zz[_zz_slot()] = ints.reshape(n, 64).T
    return q, zz, flags.astype(np.int32)


def _reference_q(blocks: np.ndarray, tables) -> np.ndarray:
    d = tables.dct_basis.numpy()
    x = blocks.reshape(-1, 8, 8).astype(np.float64) - 128.0
    return d @ x @ d.T * tables.recip_divisors.numpy()


def _dense_blocks(seed, count=512):
    return np.random.RandomState(seed).randint(0, 256, (count, 64)).astype(
        np.uint8)


def test_zz_slot_is_the_inverse_zigzag():
    slot = _zz_slot()
    assert np.array_equal(slot[ZIGZAG_ORDER], np.arange(64))


def test_exponent_tricks_equal_the_conversions():
    byte = np.arange(256)
    assert np.array_equal(shifted_pixel(byte), byte - 128.0)
    rng = np.random.RandomState(3)
    q = np.concatenate([rng.uniform(-3000, 3000, 20000),
                        np.arange(-2048, 2048) + 0.5,  # exact ties
                        np.nextafter(np.arange(-50, 50) + 0.5, 0),
                        np.array([0.0, -0.0, 0.5, -0.5, 1.5, -1.5, 2.5])])
    v, ints = rint_and_int32(q)
    assert np.array_equal(v, np.rint(q))  # half to even
    assert np.array_equal(ints, np.rint(q).astype(np.int32))


@pytest.mark.parametrize("content, quality", [
    ("case", QUALITY), ("noise", 90), ("noise", 50), ("noise", 10),
    ("odd", 50)])
def test_fragment_model_equals_the_plain_version(case, content, quality):
    """The lane layout of the four DMMAs computes D X D^T: within 1e-12 of
    the float64 product, and the plain version's coefficients after
    rounding in every block that neither side flags."""
    blocks = {"case": case["blocks"],
              "odd": _dense_blocks(5, 333)}.get(content)
    if blocks is None:
        blocks = _dense_blocks(quality)
    tables = (case["tables"] if quality == QUALITY
              else CodecTables.build(quality, "cpu"))
    q, zz, flags = dmma_model(blocks, tables)
    assert np.abs(q - _reference_q(blocks, tables)).max() < 1e-12
    zz_p, fl_p, _ = tex.exact_transform_plain(torch.from_numpy(blocks), tables)
    keep = (flags == 0) & (fl_p.numpy() == 0)
    assert keep.sum() > 0.9 * len(blocks)
    assert np.array_equal(zz[:, keep], zz_p.numpy()[:, keep])
    if content == "case":  # the exact DC ties are flagged
        assert flags[-N_TIE:].all()


# ---- the settle step: scipy's DCT in scipy's order, bit for bit ----------

def _scipy_dct2(x: np.ndarray) -> np.ndarray:
    from scipy.fftpack import dct

    return dct(dct(x, norm="ortho", axis=-2), norm="ortho", axis=-1)


def _oracle_dct2(x: np.ndarray) -> np.ndarray:
    """(k, 8, 8) float64 -> the 2-D DCT through ``oracle_dct8``: columns
    (axis -2), then rows, as ``golden.block_dct``."""
    t = torch.from_numpy(x)
    y = torch.stack(tex.oracle_dct8([t[:, i, :] for i in range(8)]), dim=1)
    return torch.stack(tex.oracle_dct8([y[:, :, j] for j in range(8)]),
                       dim=2).numpy()


def _corpus_blocks(seed: int, count: int = 12) -> np.ndarray:
    """The blocks of ``count`` 256x256 images of the benchmark's corpus
    generator at ``seed``."""
    from portbench.generators.synthetic_corpus import image

    seqs = np.random.SeedSequence(seed).spawn(count)
    imgs = np.stack([image(256, 256, s) for s in seqs])
    return np.array(jtransform.blockify(imgs)).reshape(-1, 64)


def _tie_blocks() -> np.ndarray:
    """Blocks whose exact coefficient at quality 50 is a rounding tie: sums
    of 64 mod 128 (DC), a row pattern for (0, 4), a column pattern for
    (4, 0), a checker of 16 pixels for (4, 4); then every constant block
    (all-0 and all-255 among them; an odd level is a DC tie)."""
    rng = np.random.RandomState(41)
    dc = rng.randint(1, 255, (2000, 64))
    dc[:, 0] += (64 - dc.sum(axis=1)) % 128  # sum = 64 mod 128
    keep = dc[:, 0] <= 255
    s = np.array([1, -1, -1, 1, 1, -1, -1, 1])  # sign of cos((2j+1)pi/4)
    row = np.full((8, 8), 128)
    row[0] += 12 * s  # (0, 4): 8 * 12 / (8 * 24) = 0.5
    col = np.full((8, 8), 128)
    col[:, 0] += 9 * s  # (4, 0): 8 * 9 / (8 * 18) = 0.5
    checker = np.full((8, 8), 128)
    checker[:2] += 17 * np.outer(s, s)[:2]  # (4, 4): 16 * 17 / (8 * 68)
    const = np.repeat(np.arange(256)[:, None], 64, axis=1)
    blocks = np.concatenate([dc[keep], row.reshape(1, 64),
                             col.reshape(1, 64), checker.reshape(1, 64),
                             const])
    return blocks.astype(np.uint8)


def _dct_cases(name: str) -> np.ndarray:
    if name == "random":
        return np.random.RandomState(17).randint(
            0, 256, (200_000, 64)).astype(np.uint8)
    if name == "ties":
        return _tie_blocks()
    blocks = _corpus_blocks(int(name.split("-")[1]))
    tables = CodecTables.build(QUALITY, "cpu")
    _, flags, _ = tex.exact_transform_plain(torch.from_numpy(blocks), tables)
    flagged = blocks[flags.numpy() != 0]
    assert len(flagged) >= 100
    return flagged


@pytest.mark.parametrize("name", ["random", "corpus-1", "corpus-2",
                                  "corpus-3", "ties"])
def test_oracle_dct_is_scipys_bit_for_bit(name):
    blocks = _dct_cases(name)
    x = blocks.reshape(-1, 8, 8).astype(np.float64) - 128.0
    assert _oracle_dct2(x).tobytes() == _scipy_dct2(x).tobytes()


def test_constructed_ties_are_flagged_and_settled():
    blocks = _tie_blocks()
    tables = CodecTables.build(QUALITY, "cpu")
    zz, flags, count = tex.exact_transform_plain(torch.from_numpy(blocks),
                                                 tables)
    x = blocks.reshape(-1, 8, 8).astype(np.float64) - 128.0
    exact_q = (tables.dct_basis.numpy() @ x @ tables.dct_basis.numpy().T
               / tables.divisors.numpy())
    tie = (np.abs(np.abs(exact_q - np.rint(exact_q)) - 0.5) < 1e-6).reshape(
        -1, 64).any(axis=1)
    built = len(blocks) - 256 + 128  # the constructs, the odd levels
    assert tie.sum() == built and tie[:len(blocks) - 256].all()
    assert np.array_equal(flags.numpy() != 0, tie)
    assert int(count) == built
    gold = jgolden.quantize(jgolden.block_dct(x), QUALITY).reshape(
        -1, 64)[:, ZIGZAG_ORDER]
    assert np.array_equal(zz.numpy().T, gold)


@pytest.mark.parametrize("quality", [10, 50, 90])
def test_plain_version_equals_the_oracle_on_every_block(quality):
    """Divisors that are not whole numbers at quality 90 (16 x 0.2 = 3.2):
    a flagged block divides as the oracle does, not by the reciprocal."""
    blocks = np.concatenate([_corpus_blocks(quality, 4), _tie_blocks(),
                             _dense_blocks(quality, 4000)])
    tables = CodecTables.build(quality, "cpu")
    zz, flags, count = tex.exact_transform_plain(torch.from_numpy(blocks),
                                                 tables)
    assert int(count) == int(flags.sum()) > 0
    x = blocks.reshape(-1, 8, 8).astype(np.float64) - 128.0
    gold = jgolden.quantize(jgolden.block_dct(x), quality).reshape(
        -1, 64)[:, ZIGZAG_ORDER]
    assert np.array_equal(zz.numpy().T, gold)
    assert np.array_equal(
        tex.oracle_coefficients(torch.from_numpy(blocks), tables).numpy(),
        gold)


def _kernel_constant(name: str) -> float:
    got = re.search(rf"\b{name} = (-?0x[0-9a-fp.+-]+)[,;]",
                    _kernel_source())
    return float.fromhex(got.group(1))


def test_kernel_bakes_in_the_plain_versions_constants():
    """The kernel's ``dct8`` constants, read from its source, are the
    plain version's bit for bit."""
    assert (_kernel_constant("WR"), _kernel_constant("WI")) == tex._FFT_ROOT
    assert tuple(_kernel_constant(f"T{k}") for k in range(1, 8)) == (
        tex._DCT_TWIDDLE)
    assert _kernel_constant("HALF_SQRT2") == tex._HALF_SQRT2


def transpose8_model(v: np.ndarray) -> np.ndarray:
    """The kernel's ``transpose8``: (k, 8 lanes, 8 registers) -> the same
    after its three exchanges, lane l reading lane l ^ m's value."""
    v = v.copy()
    lane = np.arange(8)
    for m in (4, 2, 1):
        hi = (lane & m) != 0
        for i in range(8):
            if i & m:
                continue
            send = np.where(hi, v[..., i], v[..., i | m])
            got = send[..., lane ^ m]
            v[..., i] = np.where(hi, got, v[..., i])
            v[..., i | m] = np.where(hi, v[..., i | m], got)
    return v


def test_transpose_model_transposes():
    v = np.arange(3 * 64, dtype=np.float64).reshape(3, 8, 8)
    assert np.array_equal(transpose8_model(v), v.transpose(0, 2, 1))


@pytest.mark.parametrize("quality", [10, 50, 90])
def test_settle_model_equals_the_oracle(quality):
    """The settle step as the kernel's eight lanes run it: lane c takes
    column c of the pixels, the length-8 DCT, the exchange, the DCT of its
    row, division by its row of divisors, half to even; every coefficient
    the oracle's, on tie blocks and dense ones."""
    blocks = np.concatenate([_tie_blocks(), _dense_blocks(quality, 2000)])
    tables = CodecTables.build(quality, "cpu")
    px = blocks.reshape(-1, 8, 8).astype(np.float64) - 128.0
    lanes = px.transpose(0, 2, 1)  # [block, lane c, register i] = x[i][c]
    cols = np.stack(tex.oracle_dct8([lanes[..., i] for i in range(8)]), -1)
    rows = transpose8_model(cols)  # [block, lane c, register j] = Y[c][j]
    c = np.stack(tex.oracle_dct8([rows[..., j] for j in range(8)]), -1)
    q = np.rint(c / tables.divisors.numpy()).astype(np.int32)
    gold = jgolden.quantize(jgolden.block_dct(px), quality)
    assert np.array_equal(q, gold)
