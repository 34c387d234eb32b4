"""The port's ``parallel`` package on a local mesh -- several shards of one
process, one thread each -- on the CPU (the plain versions of the
kernels), against the JAX package's ``parallel`` on its 8 virtual devices
(``make_mesh(n)``) and against the float64 oracle.

A mesh of n CPU shards (``make_mesh(devices=["cpu"] * n)``) is the port's
counterpart of the JAX tests' n virtual host devices.  The JAX results are
computed once for the module, at one shape each.  Exact mode has a
bit-exact bar everywhere; fast mode's bar is the world of one's bytes.
A local mesh in each process of a group is
``tests/test_torch_group_mesh.py``'s.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tinyimgcodec_tpu_torch import (
    api, conformance, container, pipeline, profiling,
)
from tinyimgcodec_tpu_torch.corpus import seeded_image, synthetic_corpus
from tinyimgcodec_tpu_torch.jobs import CorpusEncodeJob
from tinyimgcodec_tpu_torch.parallel import (
    LocalMesh, Mesh, make_mesh, tiled,
)
from tinyimgcodec_tpu_torch.parallel.batch import (
    compress_batch, compress_batch_sharded, decompress_batch_sharded,
    stage_images,
)

CPU = "cpu"
SHARDS = [2, 4, 8]
IMG = seeded_image(40, 56, 42)  # 35 blocks: ragged over 2, 4 and 8 shards
TINY = seeded_image(16, 24, 3)  # 6 blocks: 8 shards leave two empty
BATCH = synthetic_corpus(5, 32)  # 5 images: ragged over 2, 4 and 8
# the decode's batch: small, since the plain entropy decoder runs many
# small torch operations, and n shard threads take turns at the GIL
DECODE = synthetic_corpus(5, 16)


def _local(n: int) -> LocalMesh:
    return make_mesh(devices=[CPU] * n)


def _one() -> Mesh:
    return make_mesh(device=CPU)


def _indexed(images=BATCH) -> list[bytes]:
    return [container.compress(im, 50, block_index=True) for im in images]


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's results, once: ``encode_tiled`` on 4 devices,
    ``compress_batch_pallas_sharded`` (exact, interpret mode) on 8 and
    ``decompress_batch_sharded`` on 4, with the batches on which it
    returns ``None``."""
    from tinyimgcodec_tpu.parallel import make_mesh as jmake_mesh
    from tinyimgcodec_tpu.parallel.batch import (
        compress_batch_pallas_sharded, decompress_batch_sharded as jdecode,
    )
    from tinyimgcodec_tpu.parallel.tiled import encode_tiled as jtiled

    streams = _indexed(DECODE)
    nones = _none_cases()
    return {
        "tiled": jtiled(IMG, 50, mesh=jmake_mesh(4)),
        "sharded": compress_batch_pallas_sharded(
            BATCH, quality=50, mesh=jmake_mesh(8), precision="exact",
            interpret=True),
        "decoded": jdecode(streams, mesh=jmake_mesh(4)),
        "none": {name: jdecode(s, mesh=jmake_mesh(4)) is None
                 for name, s in nones.items()},
    }


def _none_cases() -> dict[str, list[bytes]]:
    img = DECODE[0]
    indexed = container.compress(img, 50, block_index=True)
    return {
        "empty": [],
        "no trailer": [container.compress(img, 50)] * 3,
        "custom tables": [container.compress(img, 50, True,
                                             block_index=True)] * 3,
        "shapes differ": [indexed, indexed, container.compress(
            img[:8], 50, block_index=True)],
    }


@pytest.mark.parametrize("n", SHARDS)
def test_encode_tiled_matches_jax_and_oracle(n, jax_ref):
    """The 35 blocks over n shards, the DC carried from shard to shard:
    exact == ``container.compress`` == the JAX package's ``encode_tiled``
    in both assembly modes; fast == the world of one's fast bytes."""
    oracle = container.compress(IMG, 50)
    assert jax_ref["tiled"] == oracle
    mesh = _local(n)
    for assemble in ("host", "device"):
        assert tiled.encode_tiled(IMG, 50, mesh=mesh,
                                  assemble=assemble) == oracle
    assert [t["device"] for t in mesh.last_run] == [CPU] * n
    assert tiled.encode_tiled(IMG, 50, mesh=mesh, precision="fast") == \
        tiled.encode_tiled(IMG, 50, mesh=_one(), precision="fast")


@pytest.mark.parametrize("assemble", ["host", "device"])
def test_encode_tiled_with_empty_shards(assemble):
    """6 blocks over 8 shards: shards 6 and 7 hold no block, launch
    nothing and add an empty segment."""
    mesh = _local(8)
    assert tiled.block_range(6, 8, 7) == (6, 6)
    assert tiled.encode_tiled(TINY, 50, mesh=mesh, assemble=assemble) == \
        container.compress(TINY, 50)
    assert tiled.encode_tiled(TINY, 90, mesh=mesh, precision="fast",
                              assemble=assemble) == \
        tiled.encode_tiled(TINY, 90, mesh=_one(), precision="fast")


def test_encode_tiled_in_sub_ranges_on_each_shard(monkeypatch):
    """With one call's limit lowered to 7 blocks, each of 2 shards cuts
    its 18 blocks into three calls: the oracle's stream all the same."""
    monkeypatch.setattr(pipeline, "MAX_PIXELS", 64 * 7)
    assert pipeline.sub_ranges(*tiled.block_range(35, 2, 0)) == [
        (0, 7), (7, 14), (14, 18)]
    assert tiled.encode_tiled(IMG, 50, mesh=_local(2)) == \
        container.compress(IMG, 50)


@pytest.mark.parametrize("n", SHARDS)
def test_compress_batch_matches_the_oracle(n):
    """5 images over n shards (8: three shards repeat the last image),
    exact, with the index == the oracle's indexed streams; staged per
    shard the same; without the index == the oracle's plain streams."""
    mesh = _local(n)
    want = _indexed()
    assert compress_batch(BATCH, 50, mesh=mesh, block_index=True) == want
    staged, b = stage_images(BATCH, mesh)
    per = -(-5 // n)
    assert b == 5 and len(staged) == n
    assert all(t.shape == (per, 32, 32) for t in staged)
    assert compress_batch(BATCH, 50, mesh=mesh, staged=(staged, b),
                          block_index=True) == want
    assert compress_batch(BATCH, 50, mesh=mesh) == [
        container.compress(im, 50) for im in BATCH]


@pytest.mark.parametrize("n", SHARDS)
def test_compress_batch_sharded_matches_jax(n, jax_ref):
    """Exact == the JAX package's ``compress_batch_pallas_sharded`` on 8
    devices == the oracle; fast == one device's fast bytes."""
    mesh = _local(n)
    got = compress_batch_sharded(BATCH, 50, mesh=mesh, precision="exact")
    assert got == jax_ref["sharded"] == [container.compress(im, 50)
                                         for im in BATCH]
    assert compress_batch_sharded(BATCH, 50, mesh=mesh) == api.compress_batch(
        BATCH, 50, precision="fast", block_index=False, device=CPU)


@pytest.mark.parametrize("n", SHARDS)
def test_decompress_batch_sharded_matches_jax(n, jax_ref):
    """Pixels == the JAX package's on 4 devices == the oracle's, and
    ``None`` wherever the JAX function returns it."""
    mesh = _local(n)
    streams = _indexed(DECODE)
    oracle = np.stack([container.decompress(s) for s in streams])
    got = decompress_batch_sharded(streams, mesh=mesh)
    assert np.array_equal(got, oracle)
    assert np.array_equal(jax_ref["decoded"], oracle)
    for name, batch in _none_cases().items():
        assert decompress_batch_sharded(batch, mesh=mesh) is None, name
        assert jax_ref["none"][name], name


def _wait_for_threads(count: int) -> int:
    end = time.monotonic() + 10
    while threading.active_count() > count and time.monotonic() < end:
        time.sleep(0.05)
    return threading.active_count()


@pytest.mark.parametrize("entry", ["compress_batch_sharded", "encode_tiled"])
def test_a_refusal_on_one_shard_is_raised_once(entry):
    """At q=99 only the last shard's blocks leave the tables: the caller
    gets one table-range error, and no shard thread is left."""
    stripes = ((np.arange(64) % 2) * 255).astype(np.uint8)
    noise = np.random.RandomState(7).randint(0, 256, (64, 64))
    before = threading.active_count()
    mesh = _local(4)
    with pytest.raises(ValueError, match="Huffman table range") as err:
        if entry == "encode_tiled":
            # flat, then bars that need an AC size beyond the tables in
            # the last shard's two rows of blocks
            img = np.zeros((64, 64), np.uint8)
            img[48:] = ((np.arange(64) % 8 >= 4) * 255).astype(np.uint8)
            tiled.encode_tiled(img, 99, mesh=mesh)
        else:
            imgs = np.stack([np.tile(stripes, (64, 1))] * 3
                            + [noise.astype(np.uint8)])
            compress_batch_sharded(imgs, 99, mesh=mesh, precision="exact")
    assert isinstance(err.value, pipeline.TableRangeError)
    assert _wait_for_threads(before) == before


def test_an_error_outside_a_collective_breaks_the_barrier():
    """A shard that raises before a collective while the others wait in
    it: the others are released, the caller gets that shard's error (not
    the broken barrier), and every thread has ended."""
    before = threading.active_count()
    mesh = _local(4)

    def body(shard):
        if shard.rank == 2:
            raise KeyError("shard 2")
        shard.any(False)
        return shard.rank

    t0 = time.monotonic()
    with pytest.raises(KeyError, match="shard 2"):
        mesh.run(body)
    assert time.monotonic() - t0 < 10
    assert _wait_for_threads(before) == before
    assert mesh.run(lambda shard: shard.all_gather_bytes(
        [bytes([shard.rank])])) == [b"\x00", b"\x01", b"\x02", b"\x03"]


def test_the_collectives_of_a_local_mesh():
    """Each shard sees every shard's tensor, varlen tensor, flag and
    bytes in shard order; the mesh itself has no collectives."""
    mesh = _local(3)

    def body(shard):
        g = shard.all_gather(torch.tensor([shard.rank * 10]))
        v = shard.all_gather_varlen(torch.arange(shard.rank))
        return ([int(t) for t in g], [t.tolist() for t in v],
                shard.any(shard.rank == 1), shard.any(False),
                shard.result_wanted)

    assert mesh.run(body) == ([0, 10, 20], [[], [0], [0, 1]], True, False,
                              True)
    assert all(t["collective_s"] >= 0 and t["cpu_s"] >= 0
               for t in mesh.last_run)
    with pytest.raises(RuntimeError, match="LocalMesh.run"):
        mesh.any(True)


def _threads_with_short_switches(target, n: int) -> None:
    """``target(k)`` in ``n`` threads at once, the interpreter switching
    threads every microsecond; every thread must end within 60 s."""
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=target, args=(k,))
                   for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)


def test_launch_counts_lose_nothing_under_threads():
    """More threads than cores add launches on four cards through the
    wrappers' counting code: no count is lost, in all or by card."""
    from tinyimgcodec_tpu_torch.ops import _build, place

    n, per = 4 * (os.cpu_count() or 1), 400
    conformance.reset_launch_counts()
    try:
        _threads_with_short_switches(lambda k: [_build.count_launch(
            vars(place), torch.device("cuda", k % 4)) for _ in range(per)],
            n)
        assert conformance.launch_counts()["place"] == n * per
        assert conformance.launch_counts_by_card()["place"] == {
            k: n // 4 * per for k in range(4)}
    finally:
        conformance.reset_launch_counts()
    assert conformance.launch_counts_by_card()["place"] == {}


def test_the_exchange_under_more_shards_than_cores():
    """Twice as many shards as cores, each switching every microsecond:
    every one of 50 gathers hands every shard every shard's value."""
    mesh = _local(2 * (os.cpu_count() or 1))

    def body(shard):
        for i in range(50):
            got = shard.all_gather_bytes([bytes([shard.rank, i])])
            assert got == [bytes([r, i]) for r in range(shard.size)]
        return shard.rank

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.monotonic()
        assert mesh.run(body) == 0
        assert time.monotonic() - t0 < 60
    finally:
        sys.setswitchinterval(switch)


def test_corpus_job_on_a_local_mesh(tmp_path):
    """A job whose batches are split over 4 shards writes the oracle's
    streams with the trailer, as the JAX job's sharded path does."""
    imgs = {f"im{i}": im for i, im in enumerate(BATCH)}
    imgs["odd"] = seeded_image(16, 40, 9)
    job = CorpusEncodeJob(str(tmp_path / "job"), quality=50, batch_size=3,
                          mesh=_local(4))
    paths = job.run(imgs)
    for name, img in imgs.items():
        with open(paths[name], "rb") as f:
            assert f.read() == container.compress(img, 50, block_index=True)
    rec = profiling.run_record("job", 1.0, 1.0, mesh=_local(4))
    assert (rec["device"], rec["n_devices"]) == ("cpu", 4)


@pytest.fixture
def cards(monkeypatch):
    """A machine that seems to have four cards, card 2 current (nothing
    below touches a card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)


def test_make_mesh_spans_the_visible_cards(cards):
    """Outside a process group, as the JAX function over
    ``jax.devices()``: every card by default, the first n when asked, the
    current card for one, ``ValueError`` beyond the cards."""
    mesh = make_mesh()
    assert isinstance(mesh, LocalMesh) and mesh.size == 4
    assert mesh.devices == [torch.device("cuda", k) for k in range(4)]
    assert make_mesh(2).devices == [torch.device("cuda", 0),
                                    torch.device("cuda", 1)]
    one = make_mesh(1)
    assert (type(one), one.size, one.device) == (Mesh, 1,
                                                 torch.device("cuda", 2))
    with pytest.raises(ValueError, match="requested 5 devices, have 4"):
        make_mesh(5)
    assert make_mesh(device="cuda:3").device == torch.device("cuda", 3)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        make_mesh(2, device="cuda:3")


def test_make_mesh_with_explicit_devices():
    """``devices=`` may repeat a device; ``n_devices`` takes its first n;
    one device is a plain world of one."""
    mesh = make_mesh(devices=[CPU] * 3)
    assert isinstance(mesh, LocalMesh) and mesh.size == 3
    assert [r for r, _ in mesh.shards()] == [0, 1, 2]
    assert make_mesh(2, devices=[CPU] * 3).size == 2
    assert type(make_mesh(devices=[CPU])) is Mesh
    with pytest.raises(ValueError, match="requested 4 devices, have 3"):
        make_mesh(4, devices=[CPU] * 3)
    with pytest.raises(ValueError, match="not both"):
        make_mesh(device=CPU, devices=[CPU])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(devices=["cuda:0", "cuda:0"])
