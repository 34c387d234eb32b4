"""Exact decode's transform on the CPU (``ops/exact_inverse.py``): the
settle step against scipy's inverse DCT bit for bit, the plain version
against the float64 oracle (``container.decompress``) pixel for pixel,
the tie flags, the running DC's wrap-around, the kernel's per-value
arithmetic, and the constants the kernel bakes in."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.fftpack import idct

from tinyimgcodec_tpu_torch import container, golden
from tinyimgcodec_tpu_torch.constants import INVERSE_ZIGZAG
from tinyimgcodec_tpu_torch.corpus import synthetic_corpus
from tinyimgcodec_tpu_torch.engine import Engine
from tinyimgcodec_tpu_torch.golden import CodecArrays
from tinyimgcodec_tpu_torch.ops import exact_inverse as tei
from tinyimgcodec_tpu_torch.ops import exact_transform as tex
from tinyimgcodec_tpu_torch.tables import DecodeTables, dequant_steps

from conftest import synthetic_image

KERNEL = (Path(tei.__file__).resolve().parent.parent / "csrc"
          / "exact_inverse.cu")


def _rows(arrays) -> torch.Tensor:
    """Oracle arrays (one or a list) -> (B, nb, 64) int32 zig-zag rows,
    DC as DPCM differences: what the decode kernel takes."""
    arrays = arrays if isinstance(arrays, list) else [arrays]
    return torch.from_numpy(np.stack([
        np.concatenate([a.dc[:, None], a.ac], axis=1) for a in arrays
    ]).astype(np.int32))


def _scipy_idct2(c: np.ndarray) -> np.ndarray:
    """The oracle's 2-D inverse DCT (``golden.block_idct``)."""
    return idct(idct(c, norm="ortho", axis=-2), norm="ortho", axis=-1)


def _oracle_idct2(c: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(c)
    y = torch.stack(tei.oracle_idct8([t[:, u, :] for u in range(8)]), dim=1)
    return torch.stack(tei.oracle_idct8([y[:, :, v] for v in range(8)]),
                       dim=2).numpy()


def _random_coefficients(seed: int, count: int) -> np.ndarray:
    """(count, 8, 8) integer coefficients shaped like decoded ones:
    magnitudes falling with frequency, most high ones zero, a DC over its
    whole range."""
    rng = np.random.RandomState(seed)
    u, v = np.mgrid[0:8, 0:8]
    scale = 40.0 / (1.0 + u + v)
    c = np.round(rng.laplace(size=(count, 8, 8)) * scale)
    c *= rng.rand(count, 8, 8) < 0.6 / (1.0 + 0.3 * (u + v))
    c[:, 0, 0] = rng.randint(-1024, 1024, count)
    return c


def _tie_coefficients() -> np.ndarray:
    """Dequantized blocks whose true values are integers: DC-only blocks
    whose DC is a multiple of 8 (every value DC / 8), and the rational
    (0, 4), (4, 0), (4, 4) terms (each adds +-C / 8 at every pixel) with
    the DC, every combination of multiples of 8 in -24..24."""
    m = 8.0 * np.arange(-3, 4)
    dc_only = np.zeros((400, 8, 8))
    dc_only[:, 0, 0] = 8.0 * np.arange(-200, 200)
    g = np.stack(np.meshgrid(m, m, m, m, indexing="ij"), -1).reshape(-1, 4)
    rational = np.zeros((len(g), 8, 8))
    rational[:, 0, 0], rational[:, 0, 4] = g[:, 0], g[:, 1]
    rational[:, 4, 0], rational[:, 4, 4] = g[:, 2], g[:, 3]
    return np.concatenate([dc_only, rational])


def _corpus_arrays(seed: int, count: int = 8, size: int = 512) -> list:
    """The oracle's arrays of ``count`` images of the benchmark's corpus
    generator at ``seed``, coded at quality 50."""
    from portbench.generators.synthetic_corpus import image

    seqs = np.random.SeedSequence(seed).spawn(count)
    return [container.decompress_to_arrays(
        container.compress(image(size, size, s), 50)) for s in seqs]


def _idct_cases(name: str) -> np.ndarray:
    if name.startswith("q"):
        steps = dequant_steps(int(name[1:]))
        c = _random_coefficients(int(name[1:]), 200_000)
        return c / steps[0] * steps[1] * steps[2]
    if name == "scaled":
        out = []
        for q in range(4):
            steps = dequant_steps(q, True)
            c = _random_coefficients(100 + q, 20_000)
            out.append(c / steps[0] * steps[1] * steps[2])
        return np.concatenate(out)
    if name == "ties":
        return _tie_coefficients()
    zz = _rows(_corpus_arrays(int(name.split("-")[1])))
    tables = DecodeTables.build(50, False, "cpu")
    c = tei.dequantized(zz, tables)
    flags = tei.tie_flags(tei.separable_values(c))
    assert int(flags.sum()) >= 10
    return c[flags].numpy()


@pytest.mark.parametrize("name", ["q10", "q50", "q90", "scaled", "ties",
                                  "corpus-1", "corpus-2", "corpus-3"])
def test_oracle_idct_is_scipys_bit_for_bit(name):
    """Over the columns then the rows, as the oracle runs scipy."""
    c = _idct_cases(name)
    assert _oracle_idct2(c).tobytes() == _scipy_idct2(c).tobytes()


def test_constructed_ties_are_flagged_and_settled():
    c = _tie_coefficients()
    values = tei.separable_values(torch.from_numpy(c))
    flags = tei.tie_flags(values)
    x = _scipy_idct2(c) + 128.0
    inside = ((x > 0.5) & (x < 255.5)).reshape(-1, 64).any(axis=1)
    # flagged: every block with a value the clip does not absorb
    assert np.array_equal(flags.numpy(), inside)
    assert flags[400:].all() and 200 < int(flags[:400].sum()) < 400
    want = np.clip(_scipy_idct2(c) + 128.0, 0.0, 255.0).astype(np.uint8)
    got = tei.oracle_pixels(torch.from_numpy(c)).numpy()
    assert np.array_equal(got, want)


def _oracle_pixels(arrays: list) -> np.ndarray:
    return np.stack([golden.decode_arrays(a) for a in arrays])


@pytest.mark.parametrize("quality", [10, 50, 90])
@pytest.mark.parametrize("shape", [(64, 96), (61, 83), (13, 200)])
def test_plain_version_equals_the_oracle(shape, quality):
    imgs = [synthetic_image(*shape, seed=s) for s in (5, 6, 7)]
    arrays = [container.decompress_to_arrays(
        container.compress(im, quality, block_index=True)) for im in imgs]
    tables = DecodeTables.build(quality, False, "cpu")
    pix, count = tei.exact_inverse_plain(_rows(arrays), *shape, tables)
    assert pix.dtype == torch.uint8 and pix.shape == (3, *shape)
    assert count.dtype == torch.int64 and count.shape == ()
    assert np.array_equal(pix.numpy(), _oracle_pixels(arrays))


@pytest.mark.parametrize("quality", [10, 50, 90])
def test_plain_version_equals_the_oracle_on_the_corpus(quality):
    """The port's fixed-seed corpus generator, 12 images of 128x128, and
    the wrapper on CPU tensors is the plain version."""
    imgs = synthetic_corpus(12, 128)
    arrays = [container.decompress_to_arrays(container.compress(im, quality))
              for im in imgs]
    tables = DecodeTables.build(quality, False, "cpu")
    pix, count = tei.exact_inverse(_rows(arrays), 128, 128, tables)
    assert np.array_equal(pix.numpy(), _oracle_pixels(arrays))
    plain = tei.exact_inverse_plain(_rows(arrays), 128, 128, tables)
    assert torch.equal(pix, plain[0]) and int(count) == int(plain[1])


@pytest.mark.parametrize("qfactor", [0, 2, 3])
def test_plain_version_equals_the_oracle_on_scaled_dct_streams(qfactor):
    """The embedded encoder's streams: the oracle divides by the AAN
    scales and multiplies by 2**qfactor before the quality-50 divisors;
    a flagged block needs those three roundings, not one product."""
    arrays = []
    for im in synthetic_corpus(3, 64):
        a = golden.encode_arrays(im, 50)
        a.quality, a.scaled_dct = qfactor, True
        arrays.append(container.decompress_to_arrays(
            container.compress_arrays(a, block_index=True)))
    tables = DecodeTables.build(qfactor, True, "cpu")
    assert tables.divides
    pix, _ = tei.exact_inverse_plain(_rows(arrays), 64, 64, tables)
    assert np.array_equal(pix.numpy(), _oracle_pixels(arrays))


def test_the_running_dc_wraps_as_the_oracles():
    """DC differences whose sum passes 2**31: the running DC wraps in
    int32, and comes back to values that are not clipped."""
    dc = np.array([2**31 - 1, 2**31 - 1, 4, -1, 0, 3], np.int32)
    arrays = CodecArrays(height=8, width=48, quality=50, dc=dc,
                         ac=np.zeros((6, 63), np.int32))
    pix, _ = tei.exact_inverse_plain(
        _rows(arrays), 8, 48, DecodeTables.build(50, False, "cpu"))
    want = golden.decode_arrays(arrays)
    assert np.array_equal(pix[0].numpy(), want)
    assert want[0, 16:].min() > 0 and want[0, 16:].max() < 255


def test_flagged_blocks_of_the_corpus_are_settled_to_the_oracle():
    """Every block the separable sums flag is the oracle's after the
    settle step, and the count is the flags'."""
    arrays = _corpus_arrays(4, count=4)
    zz = _rows(arrays)
    tables = DecodeTables.build(50, False, "cpu")
    flags = tei.tie_flags(tei.separable_values(tei.dequantized(zz, tables)))
    pix, count = tei.exact_inverse_plain(zz, 512, 512, tables)
    assert int(count) == int(flags.sum()) > 0
    assert np.array_equal(pix.numpy(), _oracle_pixels(arrays))


def test_engine_decodes_through_exact_inverse():
    imgs = synthetic_corpus(3, 64)
    streams = [container.compress(im, 50, block_index=True) for im in imgs]
    before = tei.launches
    eng = Engine("exact", "cpu")
    out = eng.decompress_batch(streams)
    assert eng.decode_stats["kernel"] == 3
    assert np.array_equal(out, np.stack([container.decompress(s)
                                         for s in streams]))
    assert tei.launches == before  # the CPU takes the plain version


def _kernel_pixel(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's step from a value x + 128 to its byte and its tie
    test, in float64 as the card runs it: rint by the 1.5 * 2**52 trick,
    the byte from rint's low word."""
    magic = 6755399441055744.0
    with np.errstate(invalid="ignore", over="ignore"):
        r8 = x + magic
        d = x - (r8 - magic)
        inside = (x > 0.5) & (x < 255.5)
        near = inside & (np.abs(d) < 1e-9)
        low = (r8.view(np.int64) & 0xFFFFFFFF).astype(np.uint32).astype(
            np.int32)
        p = np.where(inside, low - (d < 0.0), np.where(x > 0.5, 255, 0))
    return p, near


def test_kernel_value_step_equals_the_plain_version():
    rng = np.random.RandomState(3)
    edges = np.array([0.0, -0.0, 0.5, np.nextafter(0.5, 1), 1.0 - 1e-12,
                      1.0, 1.0 + 5e-10, 127.5, 128.0 - 2e-9, 254.5, 255.0,
                      255.0 - 1e-10, 255.5, np.nextafter(255.5, 0), 256.0,
                      -1e-12, 1e12, -1e12, 2.0 ** 40 + 3, np.inf, -np.inf,
                      np.nan])
    x = np.concatenate([edges, rng.uniform(-50, 300, 100_000),
                        rng.randint(-5, 300, 1000) + rng.uniform(
                            -2e-9, 2e-9, 1000)])
    x = np.resize(x, (-(-len(x) // 64) * 64)).reshape(-1, 8, 8)
    p, near = _kernel_pixel(x)
    t = torch.from_numpy(x)
    plain = torch.where(t > 0.5, torch.clamp(torch.floor(t), max=255.0),
                        torch.zeros((), dtype=torch.float64)).to(torch.uint8)
    assert np.array_equal(p.astype(np.uint8), plain.numpy())
    assert np.array_equal(near.reshape(-1, 64).any(1),
                          tei.tie_flags(t).numpy())


def _kernel_constant(name: str) -> float:
    got = re.search(rf"\b{name} = (-?0x[0-9a-fp.+-]+)[,;]",
                    KERNEL.read_text())
    return float.fromhex(got.group(1))


def test_kernel_bakes_in_the_plain_versions_constants():
    """The kernel's ``idct8`` constants and its zig-zag table, read from
    its source, are the plain version's bit for bit, and its scan's shape
    the wrapper's."""
    assert (_kernel_constant("WR"), _kernel_constant("WI")) == tex._FFT_ROOT
    assert tuple(_kernel_constant(f"T{k}") for k in range(1, 8)) == (
        tex._DCT_TWIDDLE)
    assert _kernel_constant("SQRT2") == tei._SQRT2
    table = re.search(r"ZZ_SLOT\[64\] = \{([^}]*)\}", KERNEL.read_text())
    assert [int(v) for v in table.group(1).split(",")] == list(
        INVERSE_ZIGZAG)

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             KERNEL.read_text()).group(1))

    # the wrapper sizes the scan's scratch by the kernel's shape
    assert const("SCAN_THREADS") * const("SCAN_PER") == tei.SCAN_BLOCKS


def test_wrapper_checks_its_input():
    tables = DecodeTables.build(50, False, "cpu")
    zz = torch.zeros((2, 6, 64), dtype=torch.int32)
    pix, count = tei.exact_inverse(zz, 16, 24, tables)
    assert pix.shape == (2, 16, 24) and bool((pix == 128).all())
    assert int(count) == 12  # 128.0 is an integer: every block flagged
    with pytest.raises(ValueError, match="int32"):
        tei.exact_inverse(zz.to(torch.int64), 16, 24, tables)
    with pytest.raises(ValueError, match="int32"):
        tei.exact_inverse(zz[0], 16, 24, tables)
    with pytest.raises(ValueError, match="blocks"):
        tei.exact_inverse(zz, 16, 32, tables)
    with pytest.raises(ValueError, match="devices"):
        tei.exact_inverse(zz.to("meta"), 16, 24, tables)
