"""The port's ``parallel`` package at a world of one, on the CPU (the plain
versions of the kernels), against the JAX package's ``parallel`` on its
virtual CPU devices and against the float64 oracle.

Exact mode has a bit-exact bar everywhere.  Fast mode has no oracle; its
bar is that cutting an image into block ranges, or a batch into chunks,
leaves its bytes as they were.  Several ranks: ``test_torch_distributed``.
"""

import numpy as np
import pytest
import torch

from tinyimgcodec_tpu import container as jcontainer
from tinyimgcodec_tpu.parallel import make_mesh as jmake_mesh
from tinyimgcodec_tpu.parallel.batch import (
    compress_batch as jcompress_batch,
    decompress_batch_sharded as jdecompress_batch_sharded,
)
from tinyimgcodec_tpu.parallel.tiled import encode_tiled as jencode_tiled
from tinyimgcodec_tpu_torch import api, container, pipeline
from tinyimgcodec_tpu_torch.ops.encode2 import encode2, encode2_plain
from tinyimgcodec_tpu_torch.ops.place import place_plain
from tinyimgcodec_tpu_torch.parallel import (
    Mesh, init_distributed, make_mesh,
)
from tinyimgcodec_tpu_torch.parallel import tiled
from tinyimgcodec_tpu_torch.parallel.batch import (
    compress_batch, compress_batch_sharded, decompress_batch_sharded,
    stage_images,
)
from tinyimgcodec_tpu_torch.parallel.stream import (
    compress_stream, decompress_stream,
)
from tinyimgcodec_tpu_torch.tables import CodecTables

from conftest import synthetic_image

CPU = "cpu"


def _one():
    return make_mesh(1, device=CPU)


@pytest.mark.parametrize("quality", [10, 90])
@pytest.mark.parametrize("shape", [(96, 128), (40, 56)])
def test_encode_tiled_matches_jax_and_oracle(shape, quality):
    """96x128 (192 blocks) and 40x56 (35 blocks, ragged over 2 and 8
    shards): the port's tiled encode in both assembly modes == the JAX
    package's on 2 and 8 devices == the oracle."""
    img = synthetic_image(*shape, seed=41)
    oracle = jcontainer.compress(img, quality)
    for n in (2, 8):
        assert jencode_tiled(img, quality, mesh=jmake_mesh(n)) == oracle
    for assemble in ("host", "device"):
        got = tiled.encode_tiled(img, quality, mesh=_one(),
                                 assemble=assemble)
        assert got == oracle


@pytest.mark.parametrize("assemble", ["host", "device"])
@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_encode_tiled_in_sub_ranges_keeps_the_bytes(precision, assemble,
                                                    monkeypatch):
    """With one call's limit lowered to 37 blocks, 100x123 (208 blocks)
    goes through six calls with the DC predictor carried from call to
    call, and the stream is the uncut one."""
    img = synthetic_image(100, 123, seed=45)
    whole = tiled.encode_tiled(img, 50, mesh=_one(), precision=precision)
    if precision == "exact":
        assert whole == jcontainer.compress(img, 50)
    calls = []
    real = pipeline.encode2

    def spy(x, tables, nb, from_zz=False, dc_init=None):
        calls.append((nb, None if dc_init is None else int(dc_init[0])))
        return real(x, tables, nb, from_zz=from_zz, dc_init=dc_init)

    monkeypatch.setattr(pipeline, "MAX_PIXELS", 64 * 37)
    monkeypatch.setattr(pipeline, "encode2", spy)
    got = tiled.encode_tiled(img, 50, mesh=_one(), precision=precision,
                             assemble=assemble)
    assert got == whole
    assert [nb for nb, _ in calls] == [37] * 5 + [23]
    assert calls[0][1] is None and all(d is not None for _, d in calls[1:])


@pytest.mark.parametrize("cuts", [[0, 64], [0, 1, 2, 64],
                                  [0, 13, 40, 41, 64]])
def test_encode2_dc_init_continues_a_range(cuts):
    """``encode2_plain`` over block ranges of one image, each with the DC
    before it carried in, then placed and concatenated at bit offsets,
    gives the single call's stream; without a carry the first predictor
    is zero, as with ``dc_init`` = 0."""
    rng = np.random.RandomState(5)
    zz = torch.from_numpy(rng.randint(-40, 41, (64, 64)).astype(np.int32))
    zz[0] = torch.from_numpy(rng.randint(-900, 900, 64).astype(np.int32))
    tables = CodecTables.build(50, torch.device(CPU))
    whole = encode2_plain(zz, tables, 64, from_zz=True)
    zero = encode2_plain(zz, tables, 64, from_zz=True,
                         dc_init=torch.zeros(1, dtype=torch.int32))
    assert all(torch.equal(a, b) for a, b in zip(whole[:2], zero[:2]))
    full, _, total, _ = place_plain(whole[0], whole[1], 64, 64 * 52)
    segments = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        prev = zz[0, a - 1:a] if a else None
        packed, meta, over = encode2(zz[:, a:b].contiguous(), tables, b - a,
                                     from_zz=True, dc_init=prev)
        assert not bool(over)
        words, _, bits, _ = place_plain(packed, meta, b - a, (b - a) * 52)
        segments.append((words, int(bits)))
    words, bits = pipeline.concat_bits(segments, torch.device(CPU))
    assert bits == int(total)
    assert pipeline.stream_bytes(words, bits) == pipeline.stream_bytes(
        full, int(total))


def test_encode2_dc_init_is_checked_and_can_overflow():
    tables = CodecTables.build(50, torch.device(CPU))
    zz = torch.zeros((64, 8), dtype=torch.int32)
    for bad in (torch.zeros(2, dtype=torch.int32),
                torch.zeros(1, dtype=torch.int64)):
        with pytest.raises(ValueError, match="dc_init"):
            encode2(zz, tables, 8, from_zz=True, dc_init=bad)
    # a carried predictor 2048 away needs a 12-bit DC difference
    far = torch.tensor([2048], dtype=torch.int32)
    assert bool(encode2(zz, tables, 8, from_zz=True, dc_init=far)[2])
    near = torch.tensor([-2047], dtype=torch.int32)
    assert not bool(encode2(zz, tables, 8, from_zz=True, dc_init=near)[2])


def test_encode_tiled_table_range_error():
    y, x = np.mgrid[0:64, 0:64]
    board = ((x % 8 >= 4) * 255).astype(np.uint8)
    with pytest.raises(ValueError, match="out of Huffman table range"):
        tiled.encode_tiled(board, 99, mesh=_one())
    with pytest.raises(ValueError, match="assemble"):
        tiled.encode_tiled(board, 50, mesh=_one(), assemble="nowhere")


def test_compress_batch_matches_jax_and_oracle():
    """6 images of 64x80: the port's data-parallel batch at a world of one
    == the JAX package's over 2 devices == the oracle; with the block
    index == the oracle's indexed streams."""
    imgs = np.stack([synthetic_image(64, 80, seed=s) for s in range(6)])
    theirs = jcompress_batch(imgs, 50, mesh=jmake_mesh(2))
    mine = compress_batch(imgs, 50, mesh=_one())
    indexed = compress_batch(imgs, 50, mesh=_one(), block_index=True)
    for i in range(6):
        assert mine[i] == theirs[i] == jcontainer.compress(imgs[i], 50)
        assert indexed[i] == jcontainer.compress(imgs[i], 50,
                                                 block_index=True)
    assert compress_batch(imgs, 50, mesh=_one(), assemble="device") == mine
    with pytest.raises(ValueError, match="block_index"):
        compress_batch(imgs, 50, mesh=_one(), assemble="device",
                       block_index=True)


def test_compress_batch_staged_and_sharded():
    """A staged batch and ``compress_batch_sharded`` (exact: the oracle's
    bytes; fast: ``compress_batch``'s); odd shapes keep their true size."""
    imgs = np.stack([synthetic_image(61, 59, seed=s) for s in range(5)])
    staged = stage_images(imgs, _one())
    assert staged[0].shape == (5, 64, 64) and staged[1] == 5
    refs = [jcontainer.compress(im, 50) for im in imgs]
    assert compress_batch(imgs, 50, mesh=_one(), staged=staged) == refs
    assert compress_batch_sharded(imgs, 50, mesh=_one(),
                                  precision="exact") == refs
    fast = compress_batch_sharded(imgs, 50, mesh=_one())
    assert fast == api.compress_batch(imgs, 50, precision="fast",
                                      block_index=False, device=CPU)
    assert container.parse_header(fast[0])[:2] == (61, 59)


def test_decompress_batch_sharded_matches_jax_and_oracle():
    imgs = np.stack([synthetic_image(64, 64, seed=s) for s in range(3)])
    streams = [jcontainer.compress(im, 50, block_index=True) for im in imgs]
    mine = decompress_batch_sharded(streams, mesh=_one())
    theirs = jdecompress_batch_sharded(streams, mesh=jmake_mesh(2))
    oracle = np.stack([jcontainer.decompress(s) for s in streams])
    assert np.array_equal(mine, oracle) and np.array_equal(theirs, oracle)
    fast = decompress_batch_sharded(streams, mesh=_one(), precision="fast")
    assert fast.shape == oracle.shape
    assert np.abs(fast.astype(int) - oracle).max() <= 1


def test_decompress_batch_sharded_returns_none_where_jax_does():
    img = synthetic_image(64, 64, seed=7)
    indexed = jcontainer.compress(img, 50, block_index=True)
    cases = {
        "empty": [],
        "no trailer": [jcontainer.compress(img, 50)],
        "custom tables": [jcontainer.compress(img, 50, True,
                                              block_index=True)],
        "shapes differ": [indexed, jcontainer.compress(
            img[:56], 50, block_index=True)],
    }
    for name, streams in cases.items():
        assert decompress_batch_sharded(streams, mesh=_one()) is None, name
        if streams and name != "custom tables":
            assert jdecompress_batch_sharded(
                streams, mesh=jmake_mesh(2)) is None, name


def test_compress_stream_equals_the_batch():
    """Chunks of 3 over 7 images (a padded tail of 1) == ``compress_batch``
    of the 7; odd shapes keep their size; a shape change raises."""
    imgs = np.stack([synthetic_image(64, 64, seed=70 + i) for i in range(7)])
    got = list(compress_stream(iter(imgs), 50, chunk=3, device=CPU))
    assert got == api.compress_batch(imgs, 50, precision="fast", device=CPU)
    exact = list(compress_stream(imgs, 50, chunk=3, precision="exact",
                                 block_index=False, device=CPU))
    assert exact == [jcontainer.compress(im, 50) for im in imgs]
    odd = [synthetic_image(60, 52, seed=90 + i) for i in range(3)]
    got_odd = list(compress_stream(odd, 50, chunk=2, device=CPU))
    assert got_odd == api.compress_batch(np.stack(odd), 50,
                                         precision="fast", device=CPU)
    assert container.parse_header(got_odd[0])[:2] == (60, 52)
    with pytest.raises(ValueError, match="one shape"):
        list(compress_stream([imgs[0], synthetic_image(32, 32)], chunk=2,
                             device=CPU))


def test_decompress_stream_flushes_on_a_shape_change():
    a = [synthetic_image(64, 64, seed=s) for s in range(4)]
    b = [synthetic_image(40, 48, seed=s) for s in range(2)]
    streams = [jcontainer.compress(im, 50, block_index=True)
               for im in a[:2] + b + a[2:]]
    got = list(decompress_stream(iter(streams), chunk=3, device=CPU))
    assert [g.shape for g in got] == [(64, 64)] * 2 + [(40, 48)] * 2 + [
        (64, 64)] * 2
    for g, s in zip(got, streams):
        assert np.array_equal(g, jcontainer.decompress(s))


def test_make_mesh_and_init_distributed():
    mesh = make_mesh(device=CPU)
    assert isinstance(mesh, Mesh)
    assert (mesh.size, mesh.rank, mesh.group, mesh.axis) == (1, 0, None,
                                                              "batch")
    assert mesh.all_gather_bytes([b"ab", b""]) == [b"ab", b""]
    assert not mesh.any(False) and mesh.any(True)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        make_mesh(2, device=CPU)
    with pytest.raises(ValueError):
        make_mesh(0, device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
    init_distributed(num_processes=1)  # one process: nothing to join
    assert not torch.distributed.is_initialized()
