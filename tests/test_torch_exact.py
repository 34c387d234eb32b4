"""Exact transform: the port's plain version vs the JAX package's
double-float Pallas kernel in interpret mode, and vs the float64 oracle;
and the CUDA kernel's tensor-core arithmetic (``csrc/exact_transform.cu``)
modelled lane by lane in numpy (:func:`dmma_model`), held against the
plain version."""

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
    zz_t, fl_t = tex.exact_transform(torch.from_numpy(blocks), tables)
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


def test_exact_tie_blocks_are_flagged(case):
    assert case["fl_t"][-N_TIE:].all(), "DC ties must be flagged"
    assert case["fl_j"][-N_TIE:].all()


def test_host_fixup_reaches_golden(case):
    zz = exact_coefficients(
        torch.from_numpy(case["blocks"]), QUALITY, case["tables"]
    )
    assert np.array_equal(zz.numpy().T, case["gold"])


def test_wrapper_takes_the_plain_version_on_cpu_only(case):
    before = tex.launches
    a = tex.exact_transform(torch.from_numpy(case["blocks"]), case["tables"])
    b = tex.exact_transform_plain(
        torch.from_numpy(case["blocks"]), case["tables"]
    )
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
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
    zz_p, fl_p = tex.exact_transform_plain(torch.from_numpy(blocks), tables)
    keep = (flags == 0) & (fl_p.numpy() == 0)
    assert keep.sum() > 0.9 * len(blocks)
    assert np.array_equal(zz[:, keep], zz_p.numpy()[:, keep])
    if content == "case":  # the exact DC ties are flagged
        assert flags[-N_TIE:].all()
