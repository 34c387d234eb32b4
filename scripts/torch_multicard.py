#!/usr/bin/env python3
"""The port on every card of one machine and over NCCL ranks
-> reports/torch_multicard.json.

The several-card counterpart of the JAX package's
``__graft_entry__.py:dryrun_multichip`` and of ``chip_smoke.py``'s
``sharded`` phase (which has one card and so runs NCCL only at a world of
one).  It needs at least two cards: with fewer it exits 2 and writes
nothing.  It builds the kernels and ``native/`` once, before any rank is
spawned, then runs these phases, one JSON line each:

- ``cards``: every card's index, name and power limit
  (``nvidia-smi --query-gpu=name,power.limit``, in index order) and the
  topology (``nvidia-smi topo -m``), the host's cores, the card count;
- ``per_card``: one process runs on each card ``k`` in turn while its
  current card stays 0: ``compress_batch`` of the 49 x 512 x 512 corpus
  at q=50, exact and fast (sha256 of the streams against ``PERF.md``'s),
  ``decompress_batch`` of the exact streams (pixels == the oracle's, every
  image on the kernel leg), one auto-table ``compress`` (== the oracle),
  ``compress_stream`` (== the fast batch), and each of the six kernel
  wrappers against its plain version (``conformance.kernels_vs_plain``),
  its outputs also bit for bit equal to card 0's;
- ``nccl``: ``parallel.spawn`` at worlds 2 and 4, NCCL, one card a rank:
  the ranks' current cards are distinct and are ``range(world)``;
  ``encode_tiled`` of a 7680x4320 image (host and device assembly) ==
  the oracle's payload; ``compress_batch_sharded`` exact and fast ==
  ``compress_batch``; ``decompress_batch_sharded`` == ``decompress_batch``;
  ``compress_stream`` on each rank's card == the fast batch; every rank
  launched ``exact_transform``, ``encode2``, ``place`` and
  ``entropy_decode``;
- ``two_cuts`` (in the largest world's spawn): a 15360x8640 image (2 073
  600 blocks; at world 4 each rank's 518 400 blocks are two kernel calls
  of 262 144 + 256 256) through ``encode_tiled`` exact and fast == the
  one-card ``compress`` bytes; its exact stream decoded on one card ==
  the one-card stream's pixels;
- ``failure``: ``compress_batch_sharded`` at q=99 of the noise image of
  ``conformance.contents`` at the largest world: every rank raises the
  table-range ``ValueError``, ``spawn`` raises, in under 60 s;
- ``scaling`` at 1, 2 and 4 NCCL ranks (host clock, synchronised, a warm
  step, then ``--reps`` steps, each begun together on every rank): weak
  scaling of ``compress_batch_sharded`` (49 corpus images a rank, exact
  and fast), strong scaling of the 7680x4320 ``encode_tiled`` (exact) and
  of ``decompress_batch_sharded`` of the corpus; each rank's own encode
  of its 49 images and decode of the 49 streams with no collective beside
  it (``local_exact``, ``local_decode``); MP/s and efficiency against one
  rank, each rank's times and CPU seconds;
- ``local``: one process, no process group, ``make_mesh()`` over every
  card (``cuda:0..n-1``, one thread a card): every check of ``nccl``
  (each shard on its own card, ``compress_stream`` on each card at once),
  both corpus sha256 through ``compress_batch`` with the index (the
  default mesh), the 15360x8640 frame at two kernel calls a card (exact
  and fast == one card's ``compress``), ``CorpusEncodeJob`` on the
  default mesh (== the oracle's files), a q=99 batch that only the last
  card's image leaves the tables (one table-range error, no thread left),
  every card's launches of ``exact_transform``, ``encode2``, ``place``
  and ``entropy_decode`` (counted by card); then the ``scaling`` rows at
  1, 2 and 4 local cards (weak: 49 corpus images a card, exact and fast;
  strong: the 7680x4320 tiled encode, the decode of the 49 streams), each
  step's host CPU seconds and each shard's wall, thread CPU and
  collective seconds, beside the NCCL rows of the same call;
- ``group_local`` (four cards): 2 NCCL processes of one group, 2 cards
  each (``spawn(per_rank=2)``: process p's group on card 2p,
  ``make_mesh(devices=[cuda:2p, cuda:2p+1])``, a mesh of 4 shards): every
  check of ``nccl`` (each shard on its card; ``compress_stream`` on every
  card at once), the 15360x8640 frame at two kernel calls a shard (exact
  and fast == one card's ``compress``), a q=99 batch that only shard 3's
  image leaves the tables (raised once a process, no thread left), every
  card's launches of ``exact_transform``, ``encode2``, ``place`` and
  ``entropy_decode``; then the ``scaling`` rows (weak exact and fast, 49
  corpus images a card; strong: the 7680x4320 tiled encode, the decode of
  the 49 streams) with PyTorch's default threads and again with
  ``OMP_NUM_THREADS=16`` in each process, each beside this call's four
  NCCL ranks and one process over four cards: step ms, efficiency
  against one NCCL rank, each process's CPU seconds and each shard's
  wall, thread CPU and collective seconds a step.

Every check is recorded (``checks``: ``phase``, ``name``, ``passed``);
a failed one does not stop the run, and the script exits 0 only if all
passed.  The last line is ``{"ok": true, ...}`` only then.

``--rehearse`` runs the same code on the CPU at a tiny size, with gloo
ranks, CPU shards for the local meshes and the kernels' plain versions
(a lowered ``pipeline.MAX_PIXELS`` gives ``two_cuts``, ``local`` and
``group_local`` their two calls a rank or shard), to find faults before
the cards are used; it ends with ``{"ok": false, "rehearsal": true}`` and
exits 1.

Usage:
    python3 scripts/torch_multicard.py [--reps 20] [--out PATH]
        [--phases per_card,nccl,two_cuts,failure,scaling,local,group_local]
    python3 scripts/torch_multicard.py --rehearse [--out PATH]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import threading
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tinyimgcodec_tpu_torch import (  # noqa: E402
    api, conformance, container, native, pipeline,
)
from tinyimgcodec_tpu_torch.corpus import (  # noqa: E402
    seeded_image, synthetic_corpus,
)
from tinyimgcodec_tpu_torch.device import card_lines  # noqa: E402
from tinyimgcodec_tpu_torch.engine import Engine  # noqa: E402
from tinyimgcodec_tpu_torch.jobs import CorpusEncodeJob  # noqa: E402
from tinyimgcodec_tpu_torch.ops import _build  # noqa: E402
from tinyimgcodec_tpu_torch.parallel import (  # noqa: E402
    LocalMesh, RankFailure, make_mesh, spawn, tiled,
)
from tinyimgcodec_tpu_torch.parallel.batch import (  # noqa: E402
    compress_batch, compress_batch_sharded, decompress_batch_sharded,
)
from tinyimgcodec_tpu_torch.parallel.stream import (  # noqa: E402
    compress_stream,
)

QUALITY = 50
# sha256 of the corpus streams on the card (PERF.md section 5): exact,
# equal to the float64 oracle, and fast
EXACT_SHA = "bc527ae862612df9f10296110178e615b0e1d32cabeafbca22922d17581d6133"
FAST_SHA = "dcc29e818283cd09647bd85773969c24cd479dc0d5dba79b43b2469d78a47549"
FAILURE_S = 60.0
BASELINE_TARGET = ("BASELINE.json config 5: 0.8 scaling efficiency, the "
                   "JAX package's target on its own devices; no bar here")
PHASES = ("per_card", "nccl", "two_cuts", "failure", "scaling", "local",
          "group_local")


def sizes(rehearse: bool) -> dict:
    """The run's shapes: the corpus cell, the 8K frame, the 16K frame and
    the pixel limit that cuts it (``None``: the pipeline's own)."""
    if rehearse:
        return {"corpus": (5, 64), "big": (72, 136), "huge": (96, 128),
                "max_pixels": 64 * 26, "noise": 64}
    return {"corpus": (49, 512), "big": (4320, 7680), "huge": (8640, 15360),
            "max_pixels": None, "noise": 512}


def sha(items) -> str:
    h = hashlib.sha256()
    for x in items:
        h.update(x if isinstance(x, bytes) else np.ascontiguousarray(x)
                 .tobytes())
    return h.hexdigest()


def payloads(streams: list[bytes], nb: int) -> list[bytes]:
    """Indexed streams without their TICX trailers."""
    return [s[:container.parse_block_index(s, nb)[2]] for s in streams]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sync_all() -> None:
    """Every card of this process (nothing on the CPU)."""
    if torch.cuda.is_available():
        for k in range(torch.cuda.device_count()):
            torch.cuda.synchronize(k)


class Record:
    """The report: phases, checks, ``all_passed``; one line a phase."""

    def __init__(self, rehearse: bool):
        self.t0 = time.perf_counter()
        self.data = {"script": "scripts/torch_multicard.py",
                     "rehearsal": rehearse, "phases": {}, "checks": [],
                     "all_passed": True}

    def check(self, phase: str, name: str, passed: bool, **extra) -> None:
        passed = bool(passed)
        self.data["checks"].append({"phase": phase, "name": name,
                                    "passed": passed, **extra})
        self.data["all_passed"] = self.data["all_passed"] and passed
        if not passed:
            print(json.dumps({"failed": f"{phase}: {name}", **extra},
                             default=str), file=sys.stderr, flush=True)

    def phase(self, name: str, **kw) -> None:
        kw["at_s"] = round(time.perf_counter() - self.t0, 1)
        self.data["phases"][name] = kw
        failed = [c["name"] for c in self.data["checks"]
                  if c["phase"] == name and not c["passed"]]
        print(json.dumps({"phase": name, "failed_checks": failed, **kw},
                         default=str), flush=True)


def counts() -> dict:
    return conformance.launch_counts()


def since(before: dict) -> dict:
    now = counts()
    return {k: now[k] - before[k] for k in now}


def device_info(rehearse: bool) -> dict:
    """The card's index, name and power limit, its topology, the host's
    cores (``nvidia-smi``, ``os.cpu_count``)."""
    info = {"cores": os.cpu_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda}
    if rehearse:
        info.update(cards=["cpu rehearsal"], count=0)
        return info

    info["cards"] = [f"{k}, {line}" for k, line in enumerate(card_lines())]
    # a record, not a check: nvidia-smi may refuse it inside a container
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60)
    info["topology"] = {"exit": topo.returncode,
                        "lines": (topo.stdout + topo.stderr).splitlines()}
    info["count"] = torch.cuda.device_count()
    info["nccl"] = ".".join(map(str, torch.cuda.nccl.version()))
    shm = os.statvfs("/dev/shm")
    info["dev_shm_bytes"] = shm.f_frsize * shm.f_blocks
    return info


# ------------------------------------------------------------- per card

def phase_per_card(rec: Record, sz: dict, devices: list, refs: dict) -> None:
    """Each device in turn from this one process (current card left at 0):
    the corpus round trip, auto tables, the stream, the six kernels."""
    corpus = refs["corpus"]
    nb = (corpus.shape[1] // 8) * (corpus.shape[2] // 8)
    rows, first = [], None
    for dev in devices:
        on_card = dev.type == "cuda"
        label = str(dev)
        before = counts()
        t0 = time.perf_counter()
        exact = api.compress_batch(corpus, QUALITY, precision="exact",
                                   device=dev)
        fast = api.compress_batch(corpus, QUALITY, precision="fast",
                                  device=dev)
        engine = Engine("exact", dev)
        pixels = engine.decompress_batch(exact)
        legs = dict(engine.decode_stats)
        auto = api.compress(corpus[0], QUALITY,
                            auto_generate_huffman_table=True, device=dev)
        streamed = list(compress_stream(corpus, QUALITY, chunk=8, device=dev))
        kern = conformance.kernels_vs_plain(corpus, QUALITY, dev)
        sync(dev)
        secs = time.perf_counter() - t0
        ran = since(before)
        digest = {"exact": sha(exact), "fast": sha(fast),
                  **kern["digests"]}
        if first is None:
            first = digest
        want_exact = EXACT_SHA if on_card else refs["oracle_sha"]
        rec.check("per_card", f"{label}: exact corpus sha256",
                  digest["exact"] == want_exact, got=digest["exact"])
        if on_card:
            rec.check("per_card", f"{label}: fast corpus sha256",
                      digest["fast"] == FAST_SHA, got=digest["fast"])
        rec.check("per_card", f"{label}: decode == container.decompress",
                  np.array_equal(pixels, refs["oracle_pixels"])
                  and legs == {"kernel": len(exact), "host_entropy": 0,
                               "host_decoder": 0}, legs=legs)
        rec.check("per_card", f"{label}: auto-table compress == oracle",
                  auto == refs["auto"])
        rec.check("per_card", f"{label}: compress_stream == the fast batch",
                  streamed == fast)
        for c in kern["checks"]:
            rec.check("per_card", f"{label}: {c['name']} == plain version",
                      c["passed"], **{k: v for k, v in c.items()
                                      if k not in ("name", "passed")})
        rec.check("per_card", f"{label}: every output == {devices[0]}'s",
                  digest == first,
                  differing=[k for k in digest if digest[k] != first[k]])
        row = {"device": label, "seconds": round(secs, 2),
               "exact_sha256": digest["exact"], "fast_sha256": digest["fast"],
               "decode_legs": legs}
        if on_card:
            cur = torch.cuda.current_device()
            rec.check("per_card", f"{label}: current card stayed 0", cur == 0,
                      current=cur)
            rec.check("per_card", f"{label}: every kernel launched",
                      all(v >= 1 for v in ran.values()), launches=ran)
            peak = torch.cuda.max_memory_allocated(dev)
            rec.check("per_card", f"{label}: tensors on this card", peak > 0,
                      peak_bytes=peak)
            row.update(launches=ran, peak_bytes=peak)
        rows.append(row)
    rec.phase("per_card", cards=rows, checked=(
        "on each device, current card 0: compress_batch exact and fast "
        "(sha256), decompress_batch == container.decompress on the kernel "
        "leg, auto-table compress == the oracle, compress_stream == the "
        "fast batch, six kernel wrappers == their plain versions and == "
        "the first card's outputs"))


# ---------------------------------------------------------------- ranks

def shard_sync(mesh) -> None:
    """Every device of this process's shards."""
    for _, d in mesh.shards():
        sync(d)


def nccl_rank(mesh, sz: dict, exact: list[bytes], two_cuts: bool) -> dict:
    """One process of phases ``nccl`` and ``group_local`` (and of
    ``two_cuts`` in the largest world): sha256 of everything it computed,
    its shards and cards, a q=99 batch that only the last shard's image
    leaves the tables, its launches in all and by card."""
    on_card = mesh.device.type == "cuda"
    if not on_card:
        torch.set_num_threads(1)  # rehearsal: one core a rank
    before = counts()
    corpus = synthetic_corpus(*sz["corpus"])
    big = seeded_image(*sz["big"], 8)
    out = {"rank": mesh.rank, "size": mesh.size, "device": str(mesh.device),
           "shards": [[r, str(d)] for r, d in mesh.shards()],
           "comm_device": str(mesh.comm_device),
           "backend": torch.distributed.get_backend(mesh.group),
           "current_device": torch.cuda.current_device() if on_card else None,
           "local_rank_env": os.environ.get("LOCAL_RANK")}
    t0 = time.perf_counter()
    out["tiled_host"] = sha([tiled.encode_tiled(big, QUALITY, mesh=mesh)])
    out["tiled_device"] = sha([tiled.encode_tiled(
        big, QUALITY, mesh=mesh, assemble="device")])
    out["sharded_exact"] = sha(compress_batch_sharded(
        corpus, QUALITY, mesh=mesh, precision="exact"))
    out["sharded_fast"] = sha(compress_batch_sharded(corpus, QUALITY,
                                                     mesh=mesh))
    out["decoded"] = sha([decompress_batch_sharded(exact, mesh=mesh)])

    def stream_shard(shard):
        """compress_stream on this shard's card, every card at once; every
        shard's rank, current card and digest."""
        digest = sha(compress_stream(corpus, QUALITY, chunk=8,
                                     device=shard.device))
        cur = torch.cuda.current_device() if on_card else -1
        return shard.all_gather_bytes([f"{shard.rank} {cur} {digest}"
                                       .encode()])

    out["streams"] = [x.decode().split() for x in mesh.run(stream_shard)]
    shard_sync(mesh)
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = since(before)

    battery = conformance.contents(sz["noise"], sz["noise"])
    refused = np.stack([battery["stripes"]] * (mesh.size - 1)
                       + [battery["noise"]])
    threads = threading.active_count()
    t0 = time.perf_counter()
    try:
        compress_batch_sharded(refused, 99, mesh=mesh, precision="exact")
        out["refusal"] = None
    except pipeline.TableRangeError as e:
        out["refusal"] = str(e)
    out["refusal_seconds"] = time.perf_counter() - t0
    out["threads"] = [threads, threading.active_count()]

    if two_cuts:
        if sz["max_pixels"]:
            pipeline.MAX_PIXELS = sz["max_pixels"]
        huge = seeded_image(*sz["huge"], 16)
        nb = (huge.shape[0] // 8) * (huge.shape[1] // 8)
        ranges = [tiled.block_range(nb, mesh.size, r) for r, _ in mesh.shards()]
        before = counts()
        by_card = conformance.launch_counts_by_card()["encode2"]
        t0 = time.perf_counter()
        exact_huge = tiled.encode_tiled(huge, QUALITY, mesh=mesh)
        fast_huge = tiled.encode_tiled(huge, QUALITY, mesh=mesh,
                                       precision="fast")
        shard_sync(mesh)
        out["two_cuts"] = {
            "blocks": [b - a for a, b in ranges],
            "calls": [len(pipeline.sub_ranges(a, b)) for a, b in ranges],
            "exact": sha([exact_huge]), "fast": sha([fast_huge]),
            "seconds": time.perf_counter() - t0, "launches": since(before),
            "encode2_by_card": {
                k: v - by_card.get(k, 0) for k, v in
                conformance.launch_counts_by_card()["encode2"].items()},
            # rank 0 hands the stream back for the decode on one card
            "exact_stream": exact_huge if mesh.rank == 0 else None,
        }
    out["by_card"] = conformance.launch_counts_by_card()
    return out


def failure_rank(mesh, images: np.ndarray) -> list[bytes]:
    """One rank of phase ``failure``: must raise."""
    return compress_batch_sharded(images, 99, mesh=mesh, precision="exact")


def _timed(fn, reps: int, mesh) -> dict:
    """A warm step, then ``reps`` steps, each begun on every shard together
    (an ``any`` first) and ended by a synchronise of this process's
    devices: host seconds and the process's CPU seconds a step, and on a
    local mesh each of its shards' wall, thread CPU and collective
    seconds."""
    fn()
    wall, cpu, shards = [], [], []
    for _ in range(reps):
        mesh.run(lambda shard: shard.any(False))
        shard_sync(mesh)
        t0, c0 = time.perf_counter(), time.process_time()
        fn()
        shard_sync(mesh)
        wall.append(time.perf_counter() - t0)
        cpu.append(time.process_time() - c0)
        if isinstance(mesh, LocalMesh):
            shards.append(mesh.last_run)
    return {"s": wall, "cpu_s": cpu, "shards": shards}


def scaling_rank(mesh, sz: dict, exact: list[bytes], reps: int) -> dict:
    """One process of phases ``scaling`` and ``group_local``: its step
    times in every row (a rank of one card also times its own encode and
    decode with no collective beside them)."""
    if mesh.device.type == "cpu":
        torch.set_num_threads(1)
    corpus = synthetic_corpus(*sz["corpus"])
    weak = np.concatenate([corpus] * mesh.size)  # each shard's group: corpus
    big = seeded_image(*sz["big"], 8)
    dev = mesh.device
    fns = {
        "weak_exact": lambda: compress_batch_sharded(
            weak, QUALITY, mesh=mesh, precision="exact"),
        "weak_fast": lambda: compress_batch_sharded(weak, QUALITY,
                                                    mesh=mesh),
        "local_exact": lambda: pipeline.compress_batch_device(
            corpus, QUALITY, precision="exact", device=dev),
        "local_decode": lambda: Engine("exact", dev).decompress_batch(exact),
        "strong_tiled_exact": lambda: tiled.encode_tiled(big, QUALITY,
                                                         mesh=mesh),
        "strong_decode": lambda: decompress_batch_sharded(exact, mesh=mesh),
    }
    if isinstance(mesh, LocalMesh):
        del fns["local_exact"], fns["local_decode"]
    return {"rank": mesh.rank, "device": str(dev),
            "threads": torch.get_num_threads(),
            "omp_num_threads": os.environ.get("OMP_NUM_THREADS"),
            "rows": {k: _timed(fn, reps, mesh) for k, fn in fns.items()}}


# --------------------------------------------------------------- phases

def spawn_checked(rec: Record, phase: str, label: str, fn, world: int,
                  backend: str, device, args: tuple, per_rank: int = 1):
    """``spawn``; a rank that fails is a failed check (with every failed
    rank's traceback) and gives ``None``."""
    try:
        return spawn(fn, world, backend=backend, device=device, args=args,
                     per_rank=per_rank)
    except RankFailure as e:
        rec.check(phase, f"{label}: every rank ended", False,
                  errors={r: tb[-2000:] for r, tb in e.errors.items()})
        return None


def process_checks(rec: Record, phase: str, label: str, r: dict,
                   refs: dict, on_card: bool) -> None:
    """The checks of one process's :func:`nccl_rank` result, whatever its
    shards: bytes and pixels, the stream on every shard's card (shard k on
    card k), the refusal, the kernels it launched."""
    for key in ("tiled_host", "tiled_device"):
        rec.check(phase, f"{label}: encode_tiled {key[6:]} == oracle",
                  r[key] == refs["tiled"])
    rec.check(phase, f"{label}: compress_batch_sharded exact == "
              "compress_batch", r["sharded_exact"] == refs["sharded_exact"])
    rec.check(phase, f"{label}: compress_batch_sharded fast == "
              "compress_batch", r["sharded_fast"] == refs["sharded_fast"])
    rec.check(phase, f"{label}: decompress_batch_sharded == "
              "decompress_batch", r["decoded"] == refs["decoded"])
    n = r["size"]
    rec.check(phase, f"{label}: compress_stream on every shard's card == "
              "the fast batch", [int(x[0]) for x in r["streams"]]
              == list(range(n)) and all(x[2] == refs["stream"]
                                        for x in r["streams"])
              and (not on_card or [int(x[1]) for x in r["streams"]]
                   == list(range(n))), streams=r["streams"])
    last_here = n - 1 in [s for s, _ in r["shards"]]
    rec.check(phase, f"{label}: a refusal on shard {n - 1} raised once, no "
              f"thread left, in under {FAILURE_S:.0f} s",
              r["refusal"] is not None
              and conformance.TABLE_RANGE in r["refusal"]
              and (last_here or "another rank" in r["refusal"])
              and r["threads"][0] == r["threads"][1]
              and r["refusal_seconds"] < FAILURE_S,
              refusal=r["refusal"], threads=r["threads"])
    if on_card:
        got = r["launches"]
        rec.check(phase, f"{label}: launched exact_transform, encode2, "
                  "place, entropy_decode", all(got[k] >= 1 for k in (
                      "exact_transform", "encode2_zz", "encode2_pixels",
                      "place", "entropy_decode")), launches=got)


def phase_nccl(rec: Record, sz: dict, worlds: list[int], run: dict,
               refs: dict) -> dict | None:
    """Every world of ``worlds`` (the last also carries ``two_cuts``);
    returns the last world's rank results."""
    rows, per_path, last = [], {}, None
    for world in worlds:
        label = f"{run['backend']} x{world}"
        with_cuts = world == worlds[-1] and "two_cuts" in run["phases"]
        t0 = time.perf_counter()
        ranks = spawn_checked(rec, "nccl", label, nccl_rank, world,
                              run["backend"], run["device"],
                              (sz, refs["exact"], with_cuts))
        secs = time.perf_counter() - t0
        if ranks is None:
            continue
        if run["on_card"]:
            cards = [r["current_device"] for r in ranks]
            rec.check("nccl", f"{label}: one card a rank, cards 0..{world - 1}",
                      cards == list(range(world))
                      and [r["device"] for r in ranks]
                      == [f"cuda:{k}" for k in range(world)]
                      and all(r["comm_device"] == r["device"] for r in ranks),
                      cards=cards)
        for r in ranks:
            rl = f"{label} rank {r['rank']}"
            rec.check("nccl", f"{rl}: mesh of the world over {run['backend']}",
                      (r["size"], r["backend"]) == (world, run["backend"]))
            process_checks(rec, "nccl", rl, r, refs, run["on_card"])
            per_path[rl] = r["launches"]
            rows.append({"ranks": rl, "device": r["device"],
                         "current_device": r["current_device"],
                         "rank_seconds": round(r["seconds"], 2)})
        rows.append({"ranks": label, "spawn_seconds": round(secs, 1)})
        last = ranks
    rec.phase("nccl", backend=run["backend"], worlds=worlds, runs=rows,
              launches_by_rank=per_path, checked=(
                  "every rank: its own card; encode_tiled of the "
                  f"{sz['big'][1]}x{sz['big'][0]} image (host and device "
                  "assembly) == the oracle's payload; compress_batch_sharded "
                  "exact and fast == compress_batch (no trailer); "
                  "decompress_batch_sharded == decompress_batch; "
                  "compress_stream on every card at once == the fast batch; "
                  "a q=99 batch that only the last rank's image leaves the "
                  "tables raised on every rank; kernels launched"))
    return last


def one_card_huge(sz: dict, dev0):
    """The 16K frame, its blocks, and one card's ``compress`` of it:
    exact with the index, its payload, fast without, and the seconds."""
    h, w = sz["huge"]
    huge = seeded_image(h, w, 16)
    nb = (h // 8) * (w // 8)
    saved = pipeline.MAX_PIXELS
    if sz["max_pixels"]:
        pipeline.MAX_PIXELS = sz["max_pixels"]
    try:
        t0 = time.perf_counter()
        one = api.compress(huge, QUALITY, device=dev0)
        one_fast = api.compress(huge, QUALITY, precision="fast",
                                block_index=False, device=dev0)
        one_secs = time.perf_counter() - t0
    finally:
        pipeline.MAX_PIXELS = saved
    return huge, nb, one, payloads([one], nb)[0], one_fast, one_secs


def phase_two_cuts(rec: Record, sz: dict, world: int, ranks, run: dict,
                   dev0) -> None:
    """The 16K image's rank results against one card's ``compress``; the
    ranks' exact stream decoded on one card."""
    h, w = sz["huge"]
    huge, nb, one, one_exact, one_fast, one_secs = one_card_huge(sz, dev0)
    want = {"exact": sha([one_exact]), "fast": sha([one_fast])}
    rows = []
    for r in ranks:
        tc = r["two_cuts"]
        rl = f"{run['backend']} x{world} rank {r['rank']}"
        for mode in ("exact", "fast"):
            rec.check("two_cuts", f"{rl}: {mode} == one card's compress",
                      tc[mode] == want[mode])
        rec.check("two_cuts", f"{rl}: two kernel calls a rank",
                  tc["calls"] == [2]
                  and (not run["on_card"]
                       or tc["encode2_by_card"] == {r["rank"]: 4}),
                  blocks=tc["blocks"], calls=tc["calls"],
                  encode2_by_card=tc["encode2_by_card"])
        rows.append({"rank": r["rank"], "blocks": tc["blocks"],
                     "calls": tc["calls"], "seconds": round(tc["seconds"], 2)})
    stream = ranks[0]["two_cuts"]["exact_stream"]
    engine = Engine("exact", dev0)
    t0 = time.perf_counter()
    got = engine.decompress(stream)
    legs = dict(engine.decode_stats)
    want_px = engine.decompress(one)
    want_legs = dict(engine.decode_stats)
    dec_secs = time.perf_counter() - t0
    rec.check("two_cuts", "ranks' exact stream decoded on one card == one "
              "card's stream's pixels", np.array_equal(got, want_px)
              and got.shape == (h, w), legs=legs, one_card_legs=want_legs)
    rec.phase("two_cuts", image=[w, h], blocks=nb, world=world, ranks=rows,
              one_card_compress_seconds=round(one_secs, 2),
              decode_seconds=round(dec_secs, 2),
              exact_bytes=len(one_exact), fast_bytes=len(one_fast),
              max_pixels=pipeline.MAX_PIXELS if not sz["max_pixels"]
              else sz["max_pixels"])


def phase_failure(rec: Record, sz: dict, world: int, run: dict) -> None:
    """q=99 of the noise image over ``world`` ranks: every rank raises,
    and the phase ends in under ``FAILURE_S`` (a refusal on one rank
    only is ``tests/test_torch_multicard.py``'s, on gloo ranks)."""
    noise = conformance.contents(sz["noise"], sz["noise"])["noise"]
    t0 = time.perf_counter()
    try:
        spawn(failure_rank, world, backend=run["backend"],
              device=run["device"], args=(noise[None],))
        errors = {}
    except RankFailure as e:
        errors = e.errors
    secs = time.perf_counter() - t0
    raised = sorted(r for r, tb in errors.items()
                    if conformance.TABLE_RANGE in tb)
    rec.check("failure", "every rank raised the table-range ValueError in "
              f"under {FAILURE_S:.0f} s", raised == list(range(world))
              and len(errors) == world and secs < FAILURE_S,
              raised=raised, seconds=secs)
    rec.phase("failure", world=world, backend=run["backend"],
              ranks_raised=raised, seconds=round(secs, 2),
              last_lines={r: tb.strip().splitlines()[-1]
                          for r, tb in errors.items()})


def step_stats(step: list[float], total_mp: float, n: int, base: dict,
               key: str) -> dict:
    """A scaling row's steps: median, spread, MP/s, and the efficiency
    against the first row of ``key`` (``base`` keeps its MP/s)."""
    med = float(np.median(step))
    mps = total_mp / med
    base.setdefault(key, mps)
    return {"step_s_median": med, "step_s_min": min(step),
            "step_s_max": max(step),
            "step_s_p10_p90": [float(np.percentile(step, 10)),
                               float(np.percentile(step, 90))],
            "mp_per_step": total_mp, "mps": mps,
            "efficiency": mps / (n * base[key]), "step_s": step}


def phase_scaling(rec: Record, sz: dict, worlds: list[int], run: dict,
                  refs: dict, reps: int, card_lines: list[str]) -> None:
    """Weak and strong scaling rows at each world; no bar."""
    corpus_mp = sz["corpus"][0] * sz["corpus"][1] ** 2 / 1e6
    # the megapixels of one step: of each rank's 49 images in the weak
    # rows, of the one image or batch in the strong ones
    per_rank = ("weak_exact", "weak_fast", "local_exact", "local_decode")
    strong = {"strong_tiled_exact": sz["big"][0] * sz["big"][1] / 1e6,
              "strong_decode": corpus_mp}
    rows, base = [], {}
    for world in worlds:
        label = f"{run['backend']} x{world}"
        t0 = time.perf_counter()
        ranks = spawn_checked(rec, "scaling", label, scaling_rank, world,
                              run["backend"], run["device"],
                              (sz, refs["exact"], reps))
        secs = time.perf_counter() - t0
        if ranks is None:
            continue
        row = {"procs": world, "backend": run["backend"],
               "cards": card_lines[:world] if run["on_card"] else None,
               "cores": os.cpu_count(), "steps": reps,
               "spawn_and_join_s": secs, "threads": ranks[0]["threads"],
               "omp_num_threads": ranks[0]["omp_num_threads"]}
        for key in (*per_rank, *strong):
            # a step ends when its slowest rank does
            step = [max(r["rows"][key]["s"][i] for r in ranks)
                    for i in range(reps)]
            total = world * corpus_mp if key in per_rank else strong[key]
            row[key] = {
                **step_stats(step, total, world, base, key),
                "rank_s_median": [float(np.median(r["rows"][key]["s"]))
                                  for r in ranks],
                "rank_cpu_s_median": [float(np.median(
                    r["rows"][key]["cpu_s"])) for r in ranks],
            }
        rows.append(row)
        print(json.dumps({"scaling": label, **{
            k: [round(row[k]["mps"], 1), round(row[k]["efficiency"], 3)]
            for k in (*per_rank, *strong)}}), file=sys.stderr, flush=True)
    rec.check("scaling", "a row at every world", len(rows) == len(worlds),
              worlds=[r["procs"] for r in rows])
    rec.phase("scaling", rows=rows, baseline_target=BASELINE_TARGET, note=(
        "host clock around synchronised steps, each begun on every rank "
        "together (an all-reduce), a warm step first; a step is its "
        "slowest rank; efficiency = MP/s(N) / (N * MP/s(1)) for the weak "
        "rows (49 corpus images a rank) and the strong ones (the "
        "7680x4320 tiled encode, the decode of the 49 corpus streams); "
        "local_exact / local_decode: each rank's exact encode of its 49 "
        "images / decode of the 49 streams with no collective, run while "
        "the other ranks run theirs (the host's share); rank_cpu_s: the "
        "rank's process CPU seconds a step, all its threads"))


# ---------------------------------------------------------- local mesh

def local_mesh(n: int, on_card: bool):
    """A mesh of ``n`` devices of this process, no process group: the
    first ``n`` cards (``make_mesh(n)``; one card is a world of one), or
    ``n`` CPU shards in a rehearsal."""
    if on_card:
        return make_mesh(n)
    return make_mesh(devices=["cpu"] * n)


def local_checks(rec: Record, sz: dict, mesh, run: dict, refs: dict,
                 dev0) -> dict:
    """Every check of phase ``local`` on ``mesh`` (every card).  Returns
    the launches by card and the seconds of each part."""
    on_card = run["on_card"]
    n = mesh.size
    corpus = refs["corpus"]
    big = seeded_image(*sz["big"], 8)
    secs = {}
    conformance.reset_launch_counts()
    # the default mesh where the cards make it: every visible card
    default = None if on_card else mesh

    t0 = time.perf_counter()
    got = {
        "tiled": sha([tiled.encode_tiled(big, QUALITY, mesh=mesh)]),
        "tiled_device": sha([tiled.encode_tiled(big, QUALITY, mesh=mesh,
                                                assemble="device")]),
        "sharded_exact": sha(compress_batch_sharded(
            corpus, QUALITY, mesh=mesh, precision="exact")),
        "sharded_fast": sha(compress_batch_sharded(corpus, QUALITY,
                                                   mesh=mesh)),
        "decoded": sha([decompress_batch_sharded(refs["exact"],
                                                 mesh=default)]),
        "batch_exact": sha(compress_batch(corpus, QUALITY, mesh=default,
                                          block_index=True)),
        "batch_fast": sha(compress_batch(corpus, QUALITY, mesh=mesh,
                                         precision="fast",
                                         block_index=True)),
    }
    sync_all()
    secs["entry_points"] = time.perf_counter() - t0
    for key in ("tiled", "sharded_exact", "sharded_fast", "decoded"):
        rec.check("local", f"x{n}: {key} == one card's / the oracle's",
                  got[key] == refs[key])
    rec.check("local", f"x{n}: encode_tiled device == the oracle",
              got["tiled_device"] == refs["tiled"])
    want_exact = EXACT_SHA if on_card else refs["oracle_sha"]
    rec.check("local", f"x{n}: exact corpus sha256 (compress_batch with the "
              "index, the default mesh)", got["batch_exact"] == want_exact,
              got=got["batch_exact"])
    rec.check("local", f"x{n}: fast corpus sha256",
              got["batch_fast"] == (FAST_SHA if on_card else refs["stream"]),
              got=got["batch_fast"])

    def stream_shard(shard):
        """compress_stream on this shard's card, all cards at once; every
        shard's digest and current card."""
        digest = sha(compress_stream(corpus, QUALITY, chunk=8,
                                     device=shard.device))
        cur = torch.cuda.current_device() if on_card else -1
        return shard.all_gather_bytes([f"{cur} {digest}".encode()])

    t0 = time.perf_counter()
    streams = mesh.run(stream_shard)
    secs["streams"] = time.perf_counter() - t0
    cards = [int(x.split()[0]) for x in streams]
    rec.check("local", f"x{n}: compress_stream on each card == the fast "
              "batch", all(x.split()[1].decode() == refs["stream"]
                           for x in streams))
    if on_card:
        rec.check("local", f"x{n}: shard k on card k, made current",
                  cards == list(range(n)) and mesh.devices == [
                      torch.device("cuda", k) for k in range(n)],
                  cards=cards)

    huge, nb, _, one_exact, one_fast, _ = one_card_huge(sz, dev0)
    saved = pipeline.MAX_PIXELS
    if sz["max_pixels"]:
        pipeline.MAX_PIXELS = sz["max_pixels"]
    try:
        calls = [len(pipeline.sub_ranges(*tiled.block_range(nb, n, r)))
                 for r in range(n)]
        before = conformance.launch_counts_by_card()
        t0 = time.perf_counter()
        exact_huge = tiled.encode_tiled(huge, QUALITY, mesh=mesh)
        sync_all()
        secs["huge_exact"] = time.perf_counter() - t0
        after = conformance.launch_counts_by_card()
        fast_huge = tiled.encode_tiled(huge, QUALITY, mesh=mesh,
                                       precision="fast")
    finally:
        pipeline.MAX_PIXELS = saved
    huge_encode2 = {k: v - before["encode2"].get(k, 0)
                    for k, v in after["encode2"].items()}
    rec.check("local", f"x{n}: the {huge.shape[1]}x{huge.shape[0]} frame, "
              "exact and fast == one card's compress, two calls a shard",
              exact_huge == one_exact and fast_huge == one_fast
              and calls == [2] * n and (not on_card or huge_encode2 == {
                  k: 2 for k in range(n)}),
              calls=calls, encode2_by_card=huge_encode2)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tic-job-") as out:
        names = [f"im{i:03d}" for i in range(len(corpus))]
        job = CorpusEncodeJob(out, quality=QUALITY,
                              batch_size=len(corpus), mesh=default)
        paths = job.run(dict(zip(names, corpus)))
        files = [pathlib.Path(paths[k]).read_bytes() for k in names]
    secs["job"] = time.perf_counter() - t0
    rec.check("local", f"x{n}: CorpusEncodeJob on the default mesh == the "
              "oracle's streams", sha(files) == want_exact)

    battery = conformance.contents(sz["noise"], sz["noise"])
    refused = np.stack([battery["stripes"]] * (n - 1) + [battery["noise"]])
    threads = threading.active_count()
    t0 = time.perf_counter()
    try:
        compress_batch_sharded(refused, 99, mesh=mesh, precision="exact")
        raised = None
    except pipeline.TableRangeError as e:
        raised = str(e)
    secs["refusal"] = time.perf_counter() - t0
    rec.check("local", f"x{n}: a refusal on the last card raised once, no "
              f"thread left, in under {FAILURE_S:.0f} s",
              raised is not None and conformance.TABLE_RANGE in raised
              and threading.active_count() == threads
              and secs["refusal"] < FAILURE_S, raised=raised,
              threads=[threads, threading.active_count()])

    by_card = conformance.launch_counts_by_card()
    if on_card:
        for k in ("exact_transform", "encode2", "place", "entropy_decode"):
            rec.check("local", f"x{n}: every card launched {k}",
                      sorted(by_card[k]) == list(range(n)), by_card=by_card[k])
    return {"launches_by_card": by_card, "seconds": secs}


def local_scaling(sz: dict, refs: dict, reps: int, on_card: bool,
                  card_lines: list[str], nccl_rows: list) -> list:
    """The ``scaling`` rows at 1, 2 and 4 local cards (host clock around
    every card synchronised, a warm step first): weak (49 corpus images a
    card, exact and fast) and strong (the 8K tiled encode, the decode of
    the 49 streams); each step's process CPU seconds and each shard's
    wall, thread CPU and collective seconds; the NCCL row of as many
    ranks beside each."""
    corpus = refs["corpus"]
    big = seeded_image(*sz["big"], 8)
    corpus_mp = corpus.size / 1e6
    strong = {"strong_tiled_exact": big.size / 1e6,
              "strong_decode": corpus_mp}
    nccl = {r["procs"]: r for r in nccl_rows}
    rows, base = [], {}
    for n in (1, 2, 4):
        mesh = local_mesh(n, on_card)
        weak = np.concatenate([corpus] * n)
        fns = {
            "weak_exact": lambda: compress_batch_sharded(
                weak, QUALITY, mesh=mesh, precision="exact"),
            "weak_fast": lambda: compress_batch_sharded(weak, QUALITY,
                                                        mesh=mesh),
            "strong_tiled_exact": lambda: tiled.encode_tiled(
                big, QUALITY, mesh=mesh),
            "strong_decode": lambda: decompress_batch_sharded(
                refs["exact"], mesh=mesh),
        }
        row = {"cards": n, "devices": [str(d) for _, d in mesh.shards()],
               "card_lines": card_lines[:n] if on_card else None,
               "cores": os.cpu_count(), "threads": torch.get_num_threads(),
               "steps": reps}
        for key, fn in fns.items():
            fn()
            wall, cpu, shards = [], [], []
            for _ in range(reps):
                sync_all()
                t0, c0 = time.perf_counter(), time.process_time()
                fn()
                sync_all()
                wall.append(time.perf_counter() - t0)
                cpu.append(time.process_time() - c0)
                if isinstance(mesh, LocalMesh):
                    shards.append(mesh.last_run)
            total = n * corpus_mp if key.startswith("weak") else strong[key]
            row[key] = {
                **step_stats(wall, total, n, base, key),
                "cpu_s_median": float(np.median(cpu)),
                **{f"shard_{f}_median": [
                    float(np.median([s[r][f] for s in shards]))
                    for r in range(n)] if shards else None
                   for f in ("s", "cpu_s", "collective_s")},
                "nccl_same_procs": {
                    k: nccl[n][key][k] for k in (
                        "step_s_median", "mps", "efficiency",
                        "rank_cpu_s_median")}
                if key in nccl.get(n, {}) else None,
            }
        rows.append(row)
        print(json.dumps({"local scaling": n, **{
            k: [round(row[k]["mps"], 1), round(row[k]["efficiency"], 3)]
            for k in fns}}), file=sys.stderr, flush=True)
    return rows


def phase_local(rec: Record, sz: dict, run: dict, refs: dict, reps: int,
                card_lines: list[str], dev0) -> None:
    """One process over every card, no process group; see the module
    docstring."""
    on_card = run["on_card"]
    count = torch.cuda.device_count() if on_card else 4
    if on_card:
        mesh = make_mesh()
        rec.check("local", "make_mesh() is a mesh over every card",
                  isinstance(mesh, LocalMesh) and mesh.size == count,
                  size=mesh.size)
    else:
        mesh = local_mesh(count, on_card)
    t0 = time.perf_counter()
    checked = local_checks(rec, sz, mesh, run, refs, dev0)
    checks_s = time.perf_counter() - t0
    nccl_rows = rec.data["phases"].get("scaling", {}).get("rows", [])
    rows = local_scaling(sz, refs, reps, on_card, card_lines, nccl_rows)
    rec.check("local", "a scaling row at 1, 2 and 4 local cards",
              [r["cards"] for r in rows] == [1, 2, 4])
    rec.phase("local", cards=count, checks_seconds=round(checks_s, 2),
              **checked, scaling=rows, baseline_target=BASELINE_TARGET,
              note=(
                  "one process, one thread a card, no process group; host "
                  "clock around steps with every card synchronised, a warm "
                  "step first; efficiency = MP/s(N) / (N * MP/s(1)); "
                  "cpu_s: the process's CPU seconds a step (every thread); "
                  "shard_*: each shard's wall, thread CPU and collective "
                  "seconds inside the step; nccl_same_procs: the NCCL row "
                  "of as many ranks from this call's scaling phase"))


# ------------------------------------------------- a local mesh a process

GROUP_PROCS, GROUP_PER_RANK = 2, 2


def group_scaling(rec: Record, sz: dict, run: dict, refs: dict, reps: int,
                  card_lines: list[str], omp: str | None) -> dict | None:
    """The scaling rows of 2 processes x 2 shards, with ``OMP_NUM_THREADS``
    as this process has it (``omp`` ``None``) or set to ``omp`` in the
    ranks; beside them the ``scaling`` (NCCL) and ``local`` rows of four
    cards from this call, and the efficiency against this call's one
    NCCL rank."""
    saved = os.environ.get("OMP_NUM_THREADS")
    if omp is not None:
        os.environ["OMP_NUM_THREADS"] = omp
    try:
        t0 = time.perf_counter()
        ranks = spawn_checked(
            rec, "group_local", f"scaling, OMP_NUM_THREADS={omp}",
            scaling_rank, GROUP_PROCS, run["backend"], run["device"],
            (sz, refs["exact"], reps), per_rank=GROUP_PER_RANK)
        secs = time.perf_counter() - t0
    finally:
        if saved is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = saved
    if ranks is None:
        return None
    n = GROUP_PROCS * GROUP_PER_RANK
    corpus_mp = sz["corpus"][0] * sz["corpus"][1] ** 2 / 1e6
    total = {"weak_exact": n * corpus_mp, "weak_fast": n * corpus_mp,
             "strong_tiled_exact": sz["big"][0] * sz["big"][1] / 1e6,
             "strong_decode": corpus_mp}
    phases = rec.data["phases"]
    nccl = {r["procs"]: r for r in phases.get("scaling", {}).get("rows", [])}
    local = {r["cards"]: r for r in phases.get("local", {}).get("scaling",
                                                                [])}
    row = {"procs": GROUP_PROCS, "shards_a_proc": GROUP_PER_RANK,
           "backend": run["backend"],
           "cards": card_lines[:n] if run["on_card"] else None,
           "cores": os.cpu_count(), "steps": reps,
           "spawn_and_join_s": secs, "threads": ranks[0]["threads"],
           "omp_num_threads": ranks[0]["omp_num_threads"]}
    for key, mp in total.items():
        step = [max(r["rows"][key]["s"][i] for r in ranks)
                for i in range(reps)]
        base = {key: nccl[1][key]["mps"]} if 1 in nccl else {}
        stats = step_stats(step, mp, n, base, key)
        if 1 not in nccl:
            stats["efficiency"] = None
        shards = [s for r in ranks for s in zip(*r["rows"][key]["shards"])]
        row[key] = {
            **stats,
            "process_cpu_s_median": [float(np.median(r["rows"][key]["cpu_s"]))
                                     for r in ranks],
            **{f"shard_{f}_median": [float(np.median([x[f] for x in s]))
                                     for s in shards]
               for f in ("s", "cpu_s", "collective_s")},
            "nccl_x4": {k: nccl[4][key][k] for k in (
                "step_s_median", "mps", "efficiency")}
            if key in nccl.get(4, {}) else None,
            "local_x4": {k: local[4][key][k] for k in (
                "step_s_median", "mps", "efficiency", "cpu_s_median",
                "shard_collective_s_median")}
            if key in local.get(4, {}) else None,
        }
    print(json.dumps({"group scaling": f"OMP_NUM_THREADS={omp}", **{
        k: [round(row[k]["mps"], 1), row[k]["efficiency"]]
        for k in total}}), file=sys.stderr, flush=True)
    return row


def phase_group_local(rec: Record, sz: dict, run: dict, refs: dict,
                      reps: int, card_lines: list[str]) -> None:
    """2 processes of a group x 2 cards each (``spawn(per_rank=2)``: the
    group on each process's first card, ``make_mesh(devices=[its two
    cards])``); see the module docstring."""
    on_card = run["on_card"]
    n = GROUP_PROCS * GROUP_PER_RANK
    label = f"{run['backend']} x{GROUP_PROCS} x{GROUP_PER_RANK}"
    t0 = time.perf_counter()
    ranks = spawn_checked(rec, "group_local", label, nccl_rank, GROUP_PROCS,
                          run["backend"], run["device"],
                          (sz, refs["exact"], True), per_rank=GROUP_PER_RANK)
    spawn_s = time.perf_counter() - t0
    rows, by_card = [], {}
    if ranks is not None:
        h, w = sz["huge"]
        _, _, _, one_exact, one_fast, _ = one_card_huge(sz, refs["dev0"])
        for p, r in enumerate(ranks):
            pl = f"{label} process {p}"
            mine = [GROUP_PER_RANK * p + j for j in range(GROUP_PER_RANK)]
            rec.check("group_local", f"{pl}: shards {mine} of {n}",
                      (r["size"], r["backend"]) == (n, run["backend"])
                      and [s for s, _ in r["shards"]] == mine,
                      shards=r["shards"])
            if on_card:
                rec.check("group_local", f"{pl}: cards {mine}, its group on "
                          "the first", [d for _, d in r["shards"]]
                          == [f"cuda:{k}" for k in mine]
                          and r["current_device"] == mine[0]
                          and r["comm_device"] == f"cuda:{mine[0]}",
                          current_device=r["current_device"])
            process_checks(rec, "group_local", pl, r, refs, on_card)
            tc = r["two_cuts"]
            rec.check("group_local", f"{pl}: the {w}x{h} frame, exact and "
                      "fast == one card's compress, two calls a shard",
                      tc["exact"] == sha([one_exact])
                      and tc["fast"] == sha([one_fast])
                      and tc["calls"] == [2] * GROUP_PER_RANK
                      and (not on_card or tc["encode2_by_card"]
                           == {k: 4 for k in mine}),
                      calls=tc["calls"], encode2_by_card=tc["encode2_by_card"])
            by_card[pl] = r["by_card"]
            rows.append({"process": p, "shards": r["shards"],
                         "seconds": round(r["seconds"], 2),
                         "two_cuts_seconds": round(tc["seconds"], 3),
                         "refusal_seconds": round(r["refusal_seconds"], 3)})
        if on_card:
            for k in ("exact_transform", "encode2", "place",
                      "entropy_decode"):
                cards = sorted(c for b in by_card.values() for c in b[k])
                rec.check("group_local", f"every card launched {k}",
                          cards == list(range(n)), by_card={
                              pl: b[k] for pl, b in by_card.items()})
    scaling = [group_scaling(rec, sz, run, refs, reps, card_lines, omp)
               for omp in (None, "16")]
    rec.check("group_local", "a scaling row with the default threads and "
              "with OMP_NUM_THREADS=16", None not in scaling)
    rec.phase("group_local", procs=GROUP_PROCS, shards_a_proc=GROUP_PER_RANK,
              spawn_seconds=round(spawn_s, 1), processes=rows,
              launches_by_card=by_card, scaling=scaling,
              baseline_target=BASELINE_TARGET, note=(
                  "2 processes of one group, 2 cards each, one thread a "
                  "card; host clock around steps begun on every shard of "
                  "both processes together, ended with the process's cards "
                  "synchronised, a warm step first; a step is its slowest "
                  "process; efficiency = MP/s / (4 * MP/s of one NCCL rank "
                  "in this call's scaling phase); process_cpu_s: each "
                  "process's CPU seconds a step; shard_*: each shard's "
                  "wall, thread CPU and collective seconds inside the step "
                  "(local shard 0's collective seconds include the group "
                  "collective); nccl_x4, local_x4: this call's rows of four "
                  "NCCL ranks and of one process over four cards"))


# ----------------------------------------------------------------- main

def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rehearse", action="store_true",
                   help="gloo ranks on the CPU at a tiny size")
    p.add_argument("--reps", type=int, default=None,
                   help="timed steps a scaling row (default 20; 2 when "
                   "rehearsing)")
    p.add_argument("--phases", default=",".join(PHASES))
    p.add_argument("--out", default=str(REPO / "reports"
                                        / "torch_multicard.json"))
    args = p.parse_args(argv)
    rehearse = args.rehearse
    phases = args.phases.split(",")
    reps = args.reps or (2 if rehearse else 20)
    if not rehearse:
        if not torch.cuda.is_available():
            print("torch_multicard: no CUDA device available",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < 2:
            print("torch_multicard: needs at least two cards, found "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
    sz = sizes(rehearse)
    rec = Record(rehearse)
    rec.data["sizes"] = sz

    t0 = time.perf_counter()
    native.lib()
    if not rehearse:
        _build.build_all()  # before any spawn: the ranks load, never build
    build_s = time.perf_counter() - t0

    info = device_info(rehearse)
    rec.data["machine"] = info
    rec.phase("cards", build_seconds=round(build_s, 2), **info)
    count = info["count"]
    if rehearse:
        devices = [torch.device("cpu")]
        run = {"backend": "gloo", "device": "cpu", "on_card": False}
        worlds = [2, 4]
    else:
        devices = [torch.device("cuda", k) for k in range(count)]
        run = {"backend": "nccl", "device": None, "on_card": True}
        worlds = [w for w in (2, 4) if w <= count]
    run["phases"] = phases
    dev0 = devices[0]

    # the references, on the first device and from the oracle, as far as
    # the phases run need them
    corpus = synthetic_corpus(*sz["corpus"])
    nb = (corpus.shape[1] // 8) * (corpus.shape[2] // 8)
    t0 = time.perf_counter()
    exact = api.compress_batch(corpus, QUALITY, precision="exact",
                               device=dev0)
    refs = {
        "corpus": corpus, "exact": exact, "dev0": dev0,
        "oracle_sha": sha(container.compress(im, QUALITY, block_index=True)
                          for im in corpus) if rehearse else EXACT_SHA,
        "oracle_pixels": np.stack([container.decompress(s) for s in exact]),
        "auto": container.compress(corpus[0], QUALITY, True,
                                   block_index=True),
    }
    if {"nccl", "two_cuts", "local", "group_local"} & set(phases):
        big = seeded_image(*sz["big"], 8)
        oracle_big = container.compress(big, QUALITY)
        refs.update(
            tiled=sha([oracle_big]),
            sharded_exact=sha(payloads(exact, nb)),
            sharded_fast=sha(api.compress_batch(
                corpus, QUALITY, precision="fast", block_index=False,
                device=dev0)),
            decoded=sha([api.decompress_batch(exact, device=dev0)]),
            stream=sha(api.compress_batch(corpus, QUALITY, precision="fast",
                                          device=dev0)),
        )
        rec.check("references", "one card's 8K compress == the oracle",
                  payloads([api.compress(big, QUALITY, device=dev0)],
                           (big.shape[0] // 8) * (big.shape[1] // 8))[0]
                  == oracle_big)
    rec.data["references_seconds"] = round(time.perf_counter() - t0, 1)

    if "per_card" in phases:
        phase_per_card(rec, sz, devices, refs)
    ranks = None
    if "nccl" in phases or "two_cuts" in phases:
        ranks = phase_nccl(rec, sz, worlds, run, refs)
    if "two_cuts" in phases and ranks is not None:
        phase_two_cuts(rec, sz, worlds[-1], ranks, run, dev0)
    if "failure" in phases:
        phase_failure(rec, sz, worlds[-1], run)
    if "scaling" in phases:
        phase_scaling(rec, sz, [1, *worlds], run, refs, reps,
                      info["cards"])
    # a rehearsal's CPU shards decode through the plain decoder, many
    # small torch operations a shard taking turns at the GIL: one step
    shard_reps = 1 if rehearse else reps
    if "local" in phases:
        phase_local(rec, sz, run, refs, shard_reps, info["cards"], dev0)
    if "group_local" in phases:
        if rehearse or count >= GROUP_PROCS * GROUP_PER_RANK:
            phase_group_local(rec, sz, run, refs, shard_reps, info["cards"])
        else:
            rec.check("group_local", "four cards for 2 processes x 2 cards",
                      False, cards=count)

    rec.data["phases_run"] = phases
    rec.data["seconds"] = round(time.perf_counter() - rec.t0, 1)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec.data, indent=1, default=str))
    failed = [f"{c['phase']}: {c['name']}" for c in rec.data["checks"]
              if not c["passed"]]
    print(json.dumps({"checks": len(rec.data["checks"]), "failed": failed,
                      "report": str(out)}), flush=True)
    print("; ".join(info["cards"]), flush=True)
    if rehearse:
        print(json.dumps({"ok": False, "rehearsal": True}), flush=True)
        return 1
    ok = rec.data["all_passed"] and phases == list(PHASES)
    print(json.dumps({"ok": ok, "cards": count,
                      "worlds": worlds}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
