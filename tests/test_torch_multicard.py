"""The port's several-card plumbing, on the CPU: which card a device, a
table cache and a rank names, the group timeout, a refusal raised on
every rank, and an image cut both over ranks and within each rank.

No card is needed: the card queries are monkeypatched where a rule reads
them, and the ranks are 4 gloo processes of one ``parallel.spawn`` whose
results the tests read.  ``scripts/torch_multicard.py --rehearse`` runs
the four-card script's control flow at a tiny size.
"""

import datetime
import inspect
import json
import os
import pathlib
import resource
import subprocess
import sys

import numpy as np
import pytest
import torch

from tinyimgcodec_tpu_torch import conformance, container, pipeline, tables
from tinyimgcodec_tpu_torch.corpus import seeded_image
from tinyimgcodec_tpu_torch.device import resolve_device
from tinyimgcodec_tpu_torch.parallel import mesh as pmesh
from tinyimgcodec_tpu_torch.parallel import (
    RankFailure, init_distributed, rank_card, spawn, tiled,
)
from tinyimgcodec_tpu_torch.parallel.batch import compress_batch_sharded
from tinyimgcodec_tpu_torch.tables import CodecTables, DecodeTables

REPO = pathlib.Path(__file__).resolve().parent.parent
WORLD = 4
# 96x128: 192 blocks, 48 a rank; a call of at most 26 blocks cuts each
# rank's range in two (26 + 22), as 16 Mi pixels cut a 16K frame's
HUGE = (96, 128)
CALL_BLOCKS = 26


@pytest.fixture
def cards(monkeypatch):
    """A machine that seems to have four cards, card 2 current."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)


def test_resolve_device_names_the_current_card(cards):
    assert resolve_device(None) == torch.device("cuda", 2)
    assert resolve_device("cuda") == torch.device("cuda", 2)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")


def test_table_caches_hold_one_entry_a_card(cards, monkeypatch):
    """Tables built for ``cuda:1`` and ``cuda:2`` (the current card, also
    asked for as ``None``-like ``"cuda"``) are two entries, each built
    for its own card."""
    built = []
    monkeypatch.setattr(tables, "_with_symbols",
                        lambda q, words, dev: built.append(dev) or dev)
    monkeypatch.setattr(DecodeTables, "from_numpy", classmethod(
        lambda cls, *a, device: built.append(device) or device))
    tables._build_cached.cache_clear()
    tables._build_decode_cached.cache_clear()
    try:
        got = [CodecTables.build(50, d) for d in ("cuda:1", "cuda", "cuda:2",
                                                  "cuda:1")]
        dec = [DecodeTables.build(50, False, d) for d in ("cuda", "cuda:1",
                                                           "cuda:2")]
        assert got == ["cuda:1", "cuda:2", "cuda:2", "cuda:1"]
        assert dec == ["cuda:2", "cuda:1", "cuda:2"]
        assert tables._build_cached.cache_info().currsize == 2
        assert tables._build_decode_cached.cache_info().currsize == 2
        assert built == ["cuda:1", "cuda:2", "cuda:2", "cuda:1"]
    finally:
        tables._build_cached.cache_clear()
        tables._build_decode_cached.cache_clear()


@pytest.mark.parametrize("local_rank, want", [(None, [0, 1, 2, 3, 0, 1]),
                                              ("3", [3] * 6)])
def test_rank_card_follows_local_rank(cards, monkeypatch, local_rank, want):
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    assert [rank_card(r) for r in range(6)] == want


@pytest.mark.parametrize("local_rank, timeout", [
    (None, None), ("1", datetime.timedelta(seconds=45))])
def test_init_distributed_sets_the_rank_card_and_timeout(
        cards, monkeypatch, local_rank, timeout):
    """Process 6 of 8 takes card ``6 % 4`` on one host, ``LOCAL_RANK``
    under a launcher; the group gets the timeout it was given."""
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    seen = {}
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda k: seen.setdefault("card", k))
    monkeypatch.setattr(pmesh.dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend,
                                                          **kw))
    init_distributed("localhost:1234", 8, 6, timeout=timeout)
    assert seen["card"] == (2 if local_rank is None else 1)
    assert seen["backend"] == "nccl"
    assert seen["world_size"] == 8 and seen["rank"] == 6
    assert seen.get("timeout") == timeout


def _echo(mesh, x):
    return x


def _boom(mesh):
    raise ValueError("boom")


def test_spawn_passes_a_group_timeout(monkeypatch, tmp_path):
    """``spawn``'s ranks join their group through the parent's store with
    its ``timeout`` (120 s unless given); a rank writes its result before
    the group's teardown, after a barrier; a rank that raises leaves its
    traceback beside the results."""
    default = inspect.signature(spawn).parameters["timeout"].default
    assert default == datetime.timedelta(seconds=120)
    seen = []
    monkeypatch.setattr(pmesh.dist, "TCPStore", lambda host, port, **kw: (
        "store", host, port, kw["is_master"], kw["timeout"]))
    monkeypatch.setattr(pmesh.dist, "init_process_group",
                        lambda backend, **kw: seen.append(kw))
    monkeypatch.setattr(pmesh.dist, "barrier",
                        lambda: seen.append((tmp_path / "0.pkl").exists()))
    monkeypatch.setattr(pmesh.dist, "destroy_process_group",
                        lambda: seen.append("destroyed"))
    limit = datetime.timedelta(seconds=7)
    pmesh._rank_main(0, _echo, 1, "gloo", "cpu", 1, 1234, str(tmp_path),
                     (5,), limit)
    assert seen[0]["timeout"] == limit
    assert seen[0]["store"] == ("store", "127.0.0.1", 1234, False, limit)
    assert seen[1:] == [True, "destroyed"]
    assert (tmp_path / "0.pkl").exists()
    with pytest.raises(ValueError, match="boom"):
        pmesh._rank_main(1, _boom, 1, "gloo", "cpu", 1, 1234, str(tmp_path),
                         (), limit)
    assert "ValueError: boom" in (tmp_path / "1.err").read_text()


def _abort_in_teardown(mesh):
    """Rank 1 dies by SIGABRT in its group's teardown, after its result is
    written (no core file)."""
    if mesh.rank == 1:
        resource.setrlimit(resource.RLIMIT_CORE, (0, 0))
        torch.distributed.destroy_process_group = os.abort
    return mesh.rank


def test_a_rank_that_dies_after_writing_its_result_is_named(monkeypatch):
    """``spawn`` names the rank, its signal and exit code, and that it had
    written its result; it does not fold the death into ``{-1: ...}``."""
    with pytest.raises(RankFailure) as err:
        spawn(_abort_in_teardown, 2, backend="gloo", device="cpu")
    assert list(err.value.errors) == [1]
    assert err.value.errors[1] == ("wrote its result, then ended by signal "
                                   "SIGABRT (exit code -6)")


def _store_port(mesh):
    from torch.distributed import distributed_c10d
    return distributed_c10d._get_default_store().underlying_store.port


def test_the_ranks_meet_at_the_parents_store(monkeypatch):
    """The parent binds the store's port (port 0: the system's choice)
    before any rank starts and holds it until every rank has ended; no
    port is chosen and released first."""
    made = []
    real = pmesh.dist.TCPStore

    def store(*a, **kw):
        made.append((a, kw))
        made.append(real(*a, **kw))
        return made[-1]

    monkeypatch.setattr(pmesh.dist, "TCPStore", store)
    ports = spawn(_store_port, 2, backend="gloo", device="cpu")
    assert not hasattr(pmesh, "_free_port")
    (args, kw), parent = made
    assert args == ("127.0.0.1", 0) and kw["is_master"] is True
    assert ports == [parent.port] * 2


def _rank_work(mesh):
    """A rank of the one spawn: its devices, ``two_cuts`` at a lowered
    call size (the encode2 calls counted), and a q=99 batch that only the
    last rank's image overflows."""
    torch.set_num_threads(1)
    pipeline.MAX_PIXELS = 64 * CALL_BLOCKS
    calls = []
    real = pipeline.encode2

    def counted(*a, **kw):
        calls.append(a[0].shape[1])
        return real(*a, **kw)

    pipeline.encode2 = counted
    img = seeded_image(*HUGE, 16)
    out = {"rank": mesh.rank, "device": str(mesh.device),
           "comm_device": str(mesh.comm_device),
           "exact": tiled.encode_tiled(img, 50, mesh=mesh),
           "fast": tiled.encode_tiled(img, 50, mesh=mesh, precision="fast"),
           "calls": list(calls)}
    battery = conformance.contents(64, 64)
    mixed = np.stack([battery["stripes"]] * (mesh.size - 1)
                     + [battery["noise"]])
    try:
        compress_batch_sharded(mixed, 99, mesh=mesh, precision="exact")
        out["refusal"] = None
    except ValueError as e:
        out["refusal"] = (type(e).__name__, str(e))
    return out


@pytest.fixture(scope="module")
def ranks():
    return spawn(_rank_work, WORLD, backend="gloo", device="cpu")


def test_ranks_compute_on_their_mesh_device(ranks):
    assert [r["rank"] for r in ranks] == list(range(WORLD))
    assert all(r["device"] == r["comm_device"] == "cpu" for r in ranks)


def test_two_cuts_over_four_ranks_equal_the_oracle(ranks, monkeypatch):
    """Each rank makes two calls (26 + 22 blocks); the stream, exact, is
    the payload of ``container.compress(..., block_index=True)`` and,
    fast, one process's encode of the image in one call."""
    img = seeded_image(*HUGE, 16)
    oracle = container.compress(img, 50, block_index=True)
    nb = (HUGE[0] // 8) * (HUGE[1] // 8)
    payload = oracle[:container.parse_block_index(oracle, nb)[2]]
    fast = tiled.encode_tiled(img, 50, precision="fast", device="cpu")
    for r in ranks:
        assert r["calls"] == [CALL_BLOCKS, 48 - CALL_BLOCKS] * 2
        assert r["exact"] == payload
        assert r["fast"] == fast
    monkeypatch.setattr(pipeline, "MAX_PIXELS", 64 * CALL_BLOCKS)
    from tinyimgcodec_tpu_torch import compress
    assert compress(img, 50, device="cpu") == oracle


def test_a_refusal_on_one_rank_is_raised_on_every_rank(ranks):
    """Only the last rank's image passes the tables at q=99: every rank
    raises the table-range error, none waits in the gather."""
    for r in ranks:
        kind, msg = r["refusal"]
        assert kind == "TableRangeError" and conformance.TABLE_RANGE in msg
        assert ("another rank" in msg) == (r["rank"] != WORLD - 1)


def test_multicard_script_rehearses_on_the_cpu(tmp_path):
    out = tmp_path / "multicard.json"
    proc = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "torch_multicard.py"),
         "--rehearse", "--out", str(out)],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    lines = proc.stdout.strip().splitlines()
    assert proc.returncode == 1, proc.stderr[-3000:]
    assert json.loads(lines[-1]) == {"ok": False, "rehearsal": True}
    rec = json.loads(out.read_text())
    assert rec["rehearsal"] and rec["all_passed"], [
        c for c in rec["checks"] if not c["passed"]]
    assert list(rec["phases"]) == ["cards", "per_card", "nccl", "two_cuts",
                                   "failure", "scaling", "local",
                                   "group_local"]
    assert [r["procs"] for r in rec["phases"]["scaling"]["rows"]] == [1, 2, 4]
    assert rec["phases"]["failure"]["ranks_raised"] == [0, 1, 2, 3]
    local = rec["phases"]["local"]
    assert [r["cards"] for r in local["scaling"]] == [1, 2, 4]
    assert local["scaling"][2]["devices"] == ["cpu"] * 4
    assert sum(c["phase"] == "local" for c in rec["checks"]) >= 10
    group = rec["phases"]["group_local"]
    assert [p["shards"] for p in group["processes"]] == [
        [[0, "cpu"], [1, "cpu"]], [[2, "cpu"], [3, "cpu"]]]
    assert [r["omp_num_threads"] for r in group["scaling"]][1] == "16"
    assert all(len(r["strong_tiled_exact"]["shard_collective_s_median"]) == 4
               and r["weak_exact"]["local_x4"] is not None
               and r["weak_exact"]["nccl_x4"] is not None
               for r in group["scaling"])
    assert sum(c["phase"] == "group_local" for c in rec["checks"]) >= 17
