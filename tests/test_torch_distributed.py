"""The port's ``parallel`` package over 2 and 4 gloo ranks on the CPU,
started by ``parallel.mesh.spawn``, against the JAX package's ``parallel``
on as many virtual CPU devices and against the float64 oracle.

One spawn a world size runs every check's rank work (a spawn costs a few
seconds); the tests then read its results.  The rank work imports no JAX:
the processes start from a fresh import of this module.
"""

import numpy as np
import pytest
import torch

from tinyimgcodec_tpu_torch import api, container
from tinyimgcodec_tpu_torch.corpus import synthetic_corpus
from tinyimgcodec_tpu_torch.parallel import spawn
from tinyimgcodec_tpu_torch.parallel.batch import (
    compress_batch, compress_batch_sharded, decompress_batch_sharded,
)
from tinyimgcodec_tpu_torch.parallel.tiled import encode_tiled

TILE = synthetic_corpus(1, 128)[0][:96].copy()  # 96x128: 192 blocks
TINY = synthetic_corpus(1, 64)[0][:8, :24].copy()  # 3 blocks
BATCH = synthetic_corpus(5, 64)[:, :61, :59].copy()  # ragged over 2 and 4


def _bars() -> np.ndarray:
    """Flat top half, bars at the bottom that need an AC size beyond the
    tables at q=99: only the later ranks' blocks overflow."""
    img = np.zeros((64, 64), np.uint8)
    img[32:] = ((np.arange(64) % 8 >= 4) * 255).astype(np.uint8)
    return img


def _streams() -> list[bytes]:
    return [container.compress(im, 50, block_index=True) for im in BATCH]


def _rank_work(mesh, streams):
    torch.set_num_threads(1)
    out = {"rank": mesh.rank, "size": mesh.size}
    for assemble in ("host", "device"):
        out[f"tiled_{assemble}"] = encode_tiled(TILE, 50, mesh=mesh,
                                                assemble=assemble)
    out["tiled_fast"] = encode_tiled(TILE, 50, mesh=mesh, precision="fast")
    out["tiled_tiny"] = encode_tiled(TINY, 50, mesh=mesh)
    try:
        encode_tiled(_bars(), 99, mesh=mesh)
        out["overflow"] = None
    except ValueError as e:
        out["overflow"] = str(e)
    out["batch"] = compress_batch(BATCH, 50, mesh=mesh, block_index=True)
    out["sharded_exact"] = compress_batch_sharded(BATCH, 50, mesh=mesh,
                                                  precision="exact")
    out["sharded_fast"] = compress_batch_sharded(BATCH, 50, mesh=mesh)
    out["decoded"] = decompress_batch_sharded(streams, mesh=mesh)
    no_trailer = [s[:container.parse_block_index(s, 64)[2]]
                  for s in streams]
    out["decode_none"] = decompress_batch_sharded(no_trailer, mesh=mesh)
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["2 ranks", "4 ranks"])
def runs(request):
    world = request.param
    return world, spawn(_rank_work, world, backend="gloo", device="cpu",
                        args=(_streams(),))


def test_every_rank_returns_the_same_results(runs):
    world, results = runs
    assert [r["rank"] for r in results] == list(range(world))
    assert all(r["size"] == world for r in results)
    for r in results[1:]:
        for k, v in r.items():
            if k != "rank":
                assert (np.array_equal(v, results[0][k])
                        if isinstance(v, np.ndarray) else v == results[0][k])


def test_tiled_matches_jax_and_oracle(runs):
    from tinyimgcodec_tpu import container as jcontainer
    from tinyimgcodec_tpu.parallel import make_mesh as jmake_mesh
    from tinyimgcodec_tpu.parallel.tiled import encode_tiled as jtiled

    world, results = runs
    oracle = jcontainer.compress(TILE, 50)
    assert jtiled(TILE, 50, mesh=jmake_mesh(world)) == oracle
    r = results[0]
    assert r["tiled_host"] == r["tiled_device"] == oracle
    # fast: the bytes of the same call at a world of one
    assert r["tiled_fast"] == encode_tiled(TILE, 50, precision="fast",
                                           device="cpu")


def test_tiled_with_empty_ranks(runs):
    """3 blocks over 2 ranks (2 + 1) and over 4 (1 + 1 + 1 + none)."""
    from tinyimgcodec_tpu import container as jcontainer

    _, results = runs
    assert results[0]["tiled_tiny"] == jcontainer.compress(TINY, 50)


def test_table_overflow_raises_on_every_rank(runs):
    _, results = runs
    for r in results:
        assert r["overflow"] is not None
        assert "out of Huffman table range" in r["overflow"]


def test_batch_matches_jax_and_oracle(runs):
    from tinyimgcodec_tpu import container as jcontainer
    from tinyimgcodec_tpu.parallel import make_mesh as jmake_mesh
    from tinyimgcodec_tpu.parallel.batch import (
        compress_batch as jcompress_batch,
    )

    world, results = runs
    theirs = jcompress_batch(BATCH, 50, mesh=jmake_mesh(world),
                             block_index=True)
    oracle = [jcontainer.compress(im, 50, block_index=True) for im in BATCH]
    assert results[0]["batch"] == theirs == oracle


def test_sharded_encode_of_a_ragged_batch(runs):
    from tinyimgcodec_tpu import container as jcontainer

    _, results = runs
    r = results[0]
    assert r["sharded_exact"] == [jcontainer.compress(im, 50)
                                  for im in BATCH]
    assert r["sharded_fast"] == api.compress_batch(
        BATCH, 50, precision="fast", block_index=False, device="cpu")


def test_sharded_decode_matches_jax_and_oracle(runs):
    from tinyimgcodec_tpu import container as jcontainer
    from tinyimgcodec_tpu.parallel import make_mesh as jmake_mesh
    from tinyimgcodec_tpu.parallel.batch import (
        decompress_batch_sharded as jdecompress,
    )

    world, results = runs
    streams = _streams()
    oracle = np.stack([jcontainer.decompress(s) for s in streams])
    assert np.array_equal(jdecompress(streams, mesh=jmake_mesh(world)),
                          oracle)
    assert np.array_equal(results[0]["decoded"], oracle)
    assert results[0]["decode_none"] is None
