"""Exact transform: the port's plain version (the CUDA kernel's twin, bit
for bit) vs the JAX package's double-float Pallas kernel in interpret
mode, and vs the float64 oracle."""

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
