"""The port's ``parallel`` package on a local mesh in each process of a
group -- 2 gloo ranks x 2 CPU shards, the counterpart of the JAX package's
mesh over every process's devices -- against a 4-shard ``LocalMesh`` in
this process, the float64 oracle and the JAX package's ``parallel`` on 4
of its virtual CPU devices.

One spawn runs every entry point once at a small size (the plain entropy
decoder is slow on many CPU shards, so the decode takes 16x16 images);
the tests read its results.  The module imports no JAX at its top: the
ranks start from a fresh import of it.
"""

import os
import threading

import numpy as np
import pytest
import torch

from tinyimgcodec_tpu_torch import conformance, container, pipeline
from tinyimgcodec_tpu_torch.corpus import seeded_image, synthetic_corpus
from tinyimgcodec_tpu_torch.jobs import CorpusEncodeJob
from tinyimgcodec_tpu_torch.parallel import (
    LocalMesh, make_mesh, rank_devices, spawn, tiled,
)
from tinyimgcodec_tpu_torch.parallel.batch import (
    compress_batch, compress_batch_sharded, decompress_batch_sharded,
    stage_images,
)

WORLD, PER_RANK = 2, 2
SHARDS = WORLD * PER_RANK
IMG = seeded_image(128, 128, 61)  # 16x16 blocks, 64 a shard
BATCH = synthetic_corpus(7, 32)  # 7 images: 2 a shard, the last padded
DECODE = synthetic_corpus(6, 16)


def _indexed(images) -> list[bytes]:
    return [container.compress(im, 50, block_index=True) for im in images]


def _refused() -> np.ndarray:
    """Four 64x64 images of which only the last shard's, noise, needs an
    AC size beyond the tables at q=99."""
    battery = conformance.contents(64, 64)
    return np.stack([battery["stripes"]] * (SHARDS - 1) + [battery["noise"]])


def _collectives(shard):
    """Every collective on one shard, tagged with its global rank."""
    r = shard.rank
    return {
        "rank": r, "local_rank": shard.local_rank, "size": shard.size,
        "device": str(shard.device), "comm_device": str(shard.comm_device),
        "result_wanted": shard.result_wanted,
        "gather": [int(t) for t in shard.all_gather(torch.tensor([r * 10]))],
        "varlen": [t.tolist() for t in shard.all_gather_varlen(
            torch.arange(r, dtype=torch.int32))],
        "any": [shard.any(r == k) for k in range(SHARDS)],
        "none": shard.any(False),
        "bytes": shard.all_gather_bytes([bytes([r]) * r, b"x"]),
        # the gathers hand every shard every result, not only shard 0
        "seen_by": shard.all_gather_bytes([str(r).encode()]),
    }


def _rank(mesh, streams, job_root):
    """One process of the spawn: every entry point once on its mesh of
    two CPU shards."""
    torch.set_num_threads(1)
    out = {"type": type(mesh).__name__, "size": mesh.size, "rank": mesh.rank,
           "shards": [r for r, _ in mesh.shards()],
           "backend": torch.distributed.get_backend(mesh.group)}
    views = []
    mesh.run(lambda shard: views.append(_collectives(shard)))
    out["views"] = sorted(views, key=lambda v: v["rank"])
    out["tiled_host"] = tiled.encode_tiled(IMG, 50, mesh=mesh)
    out["tiled_device"] = tiled.encode_tiled(IMG, 50, mesh=mesh,
                                             assemble="device")
    out["tiled_fast"] = tiled.encode_tiled(IMG, 50, mesh=mesh,
                                           precision="fast")
    out["batch"] = compress_batch(BATCH, 50, mesh=mesh, block_index=True)
    staged, b = stage_images(BATCH, mesh)
    out["staged_shapes"] = [tuple(t.shape) for t in staged]
    out["batch_staged"] = compress_batch(None, 50, mesh=mesh,
                                         staged=(staged, b),
                                         block_index=True)
    out["sharded_exact"] = compress_batch_sharded(BATCH, 50, mesh=mesh,
                                                  precision="exact")
    out["sharded_fast"] = compress_batch_sharded(BATCH, 50, mesh=mesh)
    out["decoded"] = decompress_batch_sharded(streams, mesh=mesh)
    out["decode_none"] = decompress_batch_sharded(
        [container.compress(DECODE[0], 50)] * 3, mesh=mesh)

    job = CorpusEncodeJob(os.path.join(job_root, f"rank{mesh.rank}"),
                          quality=50, batch_size=3, mesh=mesh)
    paths = job.run({f"im{i}": im for i, im in enumerate(BATCH)})
    out["job"] = {name: open(p, "rb").read() for name, p in paths.items()}

    before = threading.active_count()
    try:
        compress_batch_sharded(_refused(), 99, mesh=mesh, precision="exact")
        out["refusal"] = None
    except pipeline.TableRangeError as e:
        out["refusal"] = str(e)
    out["threads_left"] = threading.active_count() - before

    try:  # rank 0 asks for one device, rank 1 for two
        make_mesh(devices=["cpu"] * (1 + mesh.rank // PER_RANK))
        out["uneven"] = None
    except ValueError as e:
        out["uneven"] = str(e)
    return out


def card_rank(mesh, img, imgs):
    """One process of ``tests/test_torch_cuda.py``'s group meshes on the
    card: the tiled encode, the batch with the index (exact, fast), the
    sharded decode, and this process's launches by card."""
    conformance.reset_launch_counts()
    streams = compress_batch(imgs, 50, mesh=mesh, block_index=True)
    out = {"shards": [[r, str(d)] for r, d in mesh.shards()],
           "tiled": tiled.encode_tiled(img, 50, mesh=mesh),
           "batch": streams,
           "fast": compress_batch(imgs, 50, mesh=mesh, precision="fast",
                                  block_index=True),
           "decoded": decompress_batch_sharded(streams, mesh=mesh)}
    out["by_card"] = conformance.launch_counts_by_card()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(_rank, WORLD, backend="gloo", device="cpu",
                 per_rank=PER_RANK, args=(_indexed(DECODE),
                                          str(tmp_path_factory.mktemp("job"))))


@pytest.fixture(scope="module")
def local4():
    """The same entry points on a 4-shard local mesh in this process."""
    mesh = make_mesh(devices=["cpu"] * SHARDS)
    return {
        "tiled": tiled.encode_tiled(IMG, 50, mesh=mesh),
        "tiled_fast": tiled.encode_tiled(IMG, 50, mesh=mesh,
                                         precision="fast"),
        "batch": compress_batch(BATCH, 50, mesh=mesh, block_index=True),
        "sharded_exact": compress_batch_sharded(BATCH, 50, mesh=mesh,
                                                precision="exact"),
        "sharded_fast": compress_batch_sharded(BATCH, 50, mesh=mesh),
        "decoded": decompress_batch_sharded(_indexed(DECODE), mesh=mesh),
    }


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package on 4 virtual devices, once: ``encode_tiled``,
    ``compress_batch`` with the index, ``compress_batch_pallas_sharded``
    (exact, interpret mode) and ``decompress_batch_sharded``."""
    from tinyimgcodec_tpu.parallel import make_mesh as jmake_mesh
    from tinyimgcodec_tpu.parallel.batch import (
        compress_batch as jcompress_batch, compress_batch_pallas_sharded,
        decompress_batch_sharded as jdecode,
    )
    from tinyimgcodec_tpu.parallel.tiled import encode_tiled as jtiled

    jmesh = jmake_mesh(SHARDS)
    return {
        "tiled": jtiled(IMG, 50, mesh=jmesh),
        "batch": jcompress_batch(BATCH, 50, mesh=jmesh, block_index=True),
        "sharded": compress_batch_pallas_sharded(
            BATCH, quality=50, mesh=jmesh, precision="exact",
            interpret=True),
        "decoded": jdecode(_indexed(DECODE), mesh=jmesh),
    }


def test_every_process_holds_two_shards_of_four(ranks):
    """Shard = process rank x 2 + local index; the mesh is a local mesh
    carrying the gloo group."""
    assert [r["rank"] for r in ranks] == [0, 2]
    for p, r in enumerate(ranks):
        assert (r["type"], r["size"], r["backend"]) == ("LocalMesh", SHARDS,
                                                       "gloo")
        assert r["shards"] == [PER_RANK * p, PER_RANK * p + 1]
        assert r["staged_shapes"] == [(2, 32, 32)] * PER_RANK


def test_the_collectives_in_global_shard_order(ranks):
    """Each shard of each process sees every shard's tensor, varlen
    tensor, flag and bytes in global order; local shard 0 of every
    process wants the result."""
    views = [v for r in ranks for v in r["views"]]
    assert [v["rank"] for v in views] == list(range(SHARDS))
    for v in views:
        assert (v["size"], v["device"], v["comm_device"]) == (SHARDS, "cpu",
                                                              "cpu")
        assert v["local_rank"] == v["rank"] % PER_RANK
        assert v["result_wanted"] == (v["local_rank"] == 0)
        assert v["gather"] == [0, 10, 20, 30]
        assert v["varlen"] == [list(range(k)) for k in range(SHARDS)]
        assert v["any"] == [True] * SHARDS and v["none"] is False
        assert v["bytes"] == [x for k in range(SHARDS)
                              for x in (bytes([k]) * k, b"x")]
        assert v["seen_by"] == [str(k).encode() for k in range(SHARDS)]


def test_encode_tiled_matches_local_oracle_and_jax(ranks, local4, jax_ref):
    """The 256 blocks in four ranges, the DC carried across the shards and
    the processes: exact == the oracle == the JAX package's on 4 devices
    == a 4-shard local mesh, in both assembly modes, on every process;
    fast == the local mesh's fast bytes."""
    oracle = container.compress(IMG, 50)
    assert jax_ref["tiled"] == local4["tiled"] == oracle
    for r in ranks:
        assert r["tiled_host"] == r["tiled_device"] == oracle
        assert r["tiled_fast"] == local4["tiled_fast"]


def test_compress_batch_matches_local_oracle_and_jax(ranks, local4, jax_ref):
    """7 images over 4 shards, exact with the index, from host memory and
    staged: the oracle's streams, the JAX package's, the local mesh's."""
    want = _indexed(BATCH)
    assert jax_ref["batch"] == local4["batch"] == want
    for r in ranks:
        assert r["batch"] == r["batch_staged"] == want


def test_compress_batch_sharded_matches_local_oracle_and_jax(ranks, local4,
                                                             jax_ref):
    plain = [container.compress(im, 50) for im in BATCH]
    assert jax_ref["sharded"] == local4["sharded_exact"] == plain
    for r in ranks:
        assert r["sharded_exact"] == plain
        assert r["sharded_fast"] == local4["sharded_fast"]


def test_decompress_batch_sharded_matches_local_oracle_and_jax(ranks, local4,
                                                               jax_ref):
    oracle = np.stack([container.decompress(s) for s in _indexed(DECODE)])
    assert np.array_equal(jax_ref["decoded"], oracle)
    assert np.array_equal(local4["decoded"], oracle)
    for r in ranks:
        assert np.array_equal(r["decoded"], oracle)
        assert r["decode_none"] is None  # no trailer, as the JAX function


def test_corpus_job_on_the_group_mesh(ranks):
    """Every process's job writes the oracle's streams with the trailer."""
    want = dict(zip((f"im{i}" for i in range(len(BATCH))), _indexed(BATCH)))
    for r in ranks:
        assert r["job"] == want


def test_a_refusal_on_one_shard_is_raised_once_a_process(ranks):
    """Only shard 3's image leaves the tables at q=99: each process raises
    the table-range error once, process 0's for "another rank", and leaves
    no shard thread behind."""
    for r in ranks:
        assert conformance.TABLE_RANGE in r["refusal"]
        assert r["threads_left"] == 0
    assert "another rank" in ranks[0]["refusal"]


def test_an_uneven_device_count_raises_on_every_process(ranks):
    for r in ranks:
        assert "as many devices" in r["uneven"] and "[1, 2]" in r["uneven"]


def test_rank_devices():
    """Rank r's cards r*k .. r*k+k-1 (modulo the cards), or k times the
    device asked for."""
    assert rank_devices(1, "cpu", 2) == [torch.device("cpu")] * 2
    assert rank_devices(3, "cuda:0", 2) == [torch.device("cuda", 0)] * 2


def test_rank_devices_take_consecutive_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert rank_devices(1, "cuda", 2) == [torch.device("cuda", 2),
                                          torch.device("cuda", 3)]
    assert rank_devices(5, "cuda") == [torch.device("cuda", 1)]


def test_a_local_mesh_outside_a_group_is_unchanged():
    """Without a group a local mesh's shards are global and local alike."""
    mesh = make_mesh(devices=["cpu"] * 3)
    assert isinstance(mesh, LocalMesh) and mesh.group is None
    assert mesh.run(lambda s: [(v.local_rank, v.result_wanted)
                               for v in [s]] + s.all_gather_bytes(
                                   [bytes([s.rank])])) == [(0, True), b"\x00",
                                                           b"\x01", b"\x02"]
