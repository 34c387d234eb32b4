"""A 1-D mesh: the ranks of a ``torch.distributed`` process group, or the
devices of this one process.

The counterpart of the JAX package's ``parallel/mesh.py``.  The codec
shards along one axis -- images, or the block ranges of one image -- so a
mesh is its shards in order, and every parallel entry point runs one SPMD
body on each shard (:meth:`Mesh.run`), which talks to the others only
through four collectives: ``all_gather``, ``all_gather_varlen``, ``any``
and ``all_gather_bytes``.  Two kinds of mesh carry that body:

- **a process group**, one device a process (rank): the collectives move
  their tensors on the group's device -- the card under NCCL, the CPU
  under gloo (whose ``all_gather`` takes no CUDA tensor).  With no group
  and one device, a world of one whose collectives return their input.
- **a local mesh** (:class:`LocalMesh`), several devices of this process,
  as JAX's mesh over ``jax.devices()``: one host thread a shard, each with
  its card made current; the collectives hand tensors between the shard
  threads through shared slots and a barrier, each tensor left on its
  shard's device (a reader moves what it reads with ``.to``).  A shard
  that raises breaks the barrier, so no other shard waits for it, and the
  caller gets one exception.  This is ``shard_map`` over a local mesh.

A group of processes that each drive several cards (JAX's multi-host
mesh) is not supported.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import tempfile
import threading
import time
import traceback

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..ops import _build


class _Exchange:
    """The slots and the barrier that the shard threads of one
    :meth:`LocalMesh.run` share, and each shard's seconds spent in
    collectives."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n)
        self.slots: list = [None] * n
        self.wait_s = [0.0] * n

    def gather(self, rank: int, value) -> list:
        """Every shard's ``value``, in shard order.  The second wait keeps
        a shard from writing its next value before all have read this
        one's."""
        t0 = time.perf_counter()
        self.slots[rank] = value
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        self.wait_s[rank] += time.perf_counter() - t0
        return out


class Mesh:
    """One shard's view of a mesh: the process group (``None`` for a world
    of one and for a shard of a :class:`LocalMesh`), the number of shards,
    this shard's rank, the device it computes on, and the name of the
    mesh's one axis."""

    def __init__(self, group, size: int, rank: int, device: torch.device,
                 axis: str = "batch", exchange: _Exchange | None = None):
        self.group = group
        self.size = size
        self.rank = rank
        self.device = device
        self.axis = axis
        self._exchange = exchange

    @property
    def comm_device(self) -> torch.device:
        """Where the collectives' tensors live: the CPU under gloo, this
        process's card (with its index) under NCCL, each shard's own
        device in a local mesh."""
        if self.group is not None and dist.get_backend(self.group) == "gloo":
            return torch.device("cpu")
        return self.device

    @property
    def result_wanted(self) -> bool:
        """Whether this shard's result is returned: on every rank of a
        process group, only shard 0's of a local mesh (the others may skip
        assembling it once they have handed over their part)."""
        return self._exchange is None or self.rank == 0

    def shards(self) -> list[tuple[int, torch.device]]:
        """The ranks and devices of the shards this process computes."""
        return [(self.rank, self.device)]

    def run(self, body, *args):
        """``body(shard, *args)`` on every shard of this process; returns
        the result of shard 0 (here: of this process's one shard)."""
        return body(self, *args)

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t`` (one shape on all ranks), in rank order, on
        :attr:`comm_device` (in a local mesh each on its shard's
        device)."""
        if self._exchange is not None:
            return self._exchange.gather(self.rank, t)
        if self.group is None:
            return [t]
        src = t.to(self.comm_device).contiguous()
        out = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(out, src, group=self.group)
        return out

    def all_gather_varlen(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's 1-D ``t`` of any length, in rank order: the
        lengths first, then the tensors padded to the longest."""
        if self._exchange is not None:
            return self._exchange.gather(self.rank, t.reshape(-1))
        if self.group is None:
            return [t]
        lens = [int(k) for k in self.all_gather(
            torch.tensor([t.numel()], dtype=torch.int64))]
        pad = torch.zeros(max(max(lens), 1), dtype=t.dtype,
                          device=self.comm_device)
        pad[:t.numel()] = t.reshape(-1)
        return [g[:k] for g, k in zip(self.all_gather(pad), lens)]

    def any(self, flag: bool) -> bool:
        """True on every rank if ``flag`` is true on any."""
        if self._exchange is not None:
            return any(self._exchange.gather(self.rank, bool(flag)))
        if self.group is None:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                         device=self.comm_device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())

    def all_gather_bytes(self, items: list[bytes]) -> list[bytes]:
        """Every rank's list of byte strings, concatenated in rank order."""
        if self._exchange is not None:
            return [x for part in self._exchange.gather(self.rank,
                                                        list(items))
                    for x in part]
        if self.group is None:
            return list(items)
        lens = torch.tensor([len(x) for x in items], dtype=torch.int64)
        blob = b"".join(items)
        data = (torch.frombuffer(bytearray(blob), dtype=torch.uint8)
                if blob else torch.empty(0, dtype=torch.uint8))
        out = []
        for ks, d in zip(self.all_gather_varlen(lens),
                         self.all_gather_varlen(data)):
            raw = d.cpu().numpy().tobytes()
            at = 0
            for k in ks.tolist():
                out.append(raw[at:at + k])
                at += k
        return out


class LocalMesh(Mesh):
    """A mesh over several devices of this one process (a device may
    repeat: two shards on one card share its default stream, n shards on
    the CPU are the counterpart of the JAX tests' virtual host devices).

    :meth:`run` builds the kernels first where a shard is a card (all
    sources at once; a no-op once built), then starts one thread a shard
    after the first (shard 0 runs on the calling thread), each inside
    ``torch.cuda.device`` of its card,
    and joins them all before it returns or raises; ``last_run`` then
    holds each shard's wall and thread CPU seconds and its seconds in
    collectives.  The collectives exist only on the shard views that
    :meth:`run` hands its body."""

    def __init__(self, devices: list[torch.device], axis: str = "batch"):
        super().__init__(None, len(devices), 0, devices[0], axis)
        self.devices = list(devices)
        self.last_run: list[dict] = []

    def shards(self) -> list[tuple[int, torch.device]]:
        return list(enumerate(self.devices))

    def run(self, body, *args):
        if any(d.type == "cuda" for d in self.devices):
            # every compiler at once, before the shards would each wait for
            # the other's build under the loader's lock
            _build.build_all()
        n = self.size
        exchange = _Exchange(n)
        results: list = [None] * n
        errors: list = [None] * n
        times: list = [None] * n

        def shard(r: int) -> None:
            dev = self.devices[r]
            view = Mesh(None, n, r, dev, self.axis, exchange)
            t0, c0 = time.perf_counter(), time.thread_time()
            try:
                if dev.type == "cuda":
                    with torch.cuda.device(dev):
                        results[r] = body(view, *args)
                else:
                    results[r] = body(view, *args)
            except BaseException as e:  # noqa: BLE001 -- re-raised below
                errors[r] = e
                exchange.barrier.abort()  # no shard waits for this one
            times[r] = {"device": str(dev),
                        "s": time.perf_counter() - t0,
                        "cpu_s": time.thread_time() - c0}

        threads = [threading.Thread(target=shard, args=(r,), daemon=True,
                                    name=f"tic-mesh-shard-{r}")
                   for r in range(1, n)]
        for t in threads:
            t.start()
        shard(0)
        for t in threads:
            t.join()
        for r in range(n):
            times[r]["collective_s"] = exchange.wait_s[r]
        self.last_run = times
        failed = [e for e in errors if e is not None]
        if failed:
            # a broken barrier is only the echo of another shard's error
            # (a shard released by a barrier that another then breaks may
            # wake to the break: its result is lost, but the run raises)
            own = [e for e in failed
                   if not isinstance(e, threading.BrokenBarrierError)]
            raise (own or failed)[0]
        return results[0]

    def _not_a_shard(self, *_):
        raise RuntimeError("a LocalMesh's collectives exist only inside "
                           "LocalMesh.run, on the shard it hands its body")

    all_gather = all_gather_varlen = any = all_gather_bytes = _not_a_shard


def _in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def make_mesh(n_devices: int | None = None, axis: str = "batch",
              device: str | torch.device | None = None,
              devices: list | None = None) -> Mesh:
    """A mesh, as the JAX function's over ``jax.devices()[:n_devices]``.

    Outside a process group: with neither ``device`` nor ``devices``, a
    :class:`LocalMesh` over the first ``n_devices`` visible cards
    ``cuda:0..n-1`` (``None``: all of them; one card is the current one,
    a plain world of one); more than ``torch.cuda.device_count()`` raises
    ``ValueError("requested n devices, have m")``, no card
    ``RuntimeError``.  ``device``: a world of one on it (``n_devices``
    ``None`` or 1).  ``devices``: an explicit list, repeats allowed (the
    first ``n_devices`` of it when that is given).

    Inside an initialised default process group: the group's ranks, one
    device a process (``device``, ``None`` = the card); ``n_devices``
    ``None`` or the group's size for the whole group, 1 for this process
    alone.  Several devices a process in a group (JAX's multi-host mesh)
    raise ``ValueError``."""
    if device is not None and devices is not None:
        raise ValueError("give device or devices, not both")
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        if n_devices is not None:
            if int(n_devices) > len(devs):
                raise ValueError(
                    f"requested {n_devices} devices, have {len(devs)}")
            devs = devs[:int(n_devices)]
        if not devs:
            raise ValueError("requested 0 devices")
        if len(devs) > 1 and _in_group():
            raise ValueError(
                f"a mesh of {len(devs)} devices in each process of a group "
                "of processes (JAX's multi-host mesh) is not supported: one "
                "device a rank, or one process over its devices")
        if len(devs) > 1:
            return LocalMesh(devs, axis)
        device, n_devices = devs[0], None
    dev = resolve_device(device)  # raises without a card unless asked
    group = _in_group()
    if group:
        have = dist.get_world_size()
    else:
        have = 1 if device is not None else torch.cuda.device_count()
    n = have if n_devices is None else int(n_devices)
    if n > have:
        raise ValueError(f"requested {n} devices, have {have}")
    if n < 1:
        raise ValueError(f"requested {n} devices")
    if group and n == have:
        return Mesh(dist.group.WORLD, have, dist.get_rank(), dev, axis)
    if n == 1:
        return Mesh(None, 1, 0, dev, axis)
    if group:
        raise ValueError(
            f"a mesh of {n} of the group's {have} processes: a mesh spans "
            "the whole group or one process")
    return LocalMesh([torch.device("cuda", k) for k in range(n)], axis)


def rank_card(rank: int) -> int:
    """The card of the process of global rank ``rank`` on its host:
    ``LOCAL_RANK`` where a launcher such as ``torchrun`` sets it (its
    ranks may span several hosts), else ``rank % device_count`` (one
    host)."""
    local = os.environ.get("LOCAL_RANK")
    if local is not None:
        return int(local)
    return rank % torch.cuda.device_count()


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     device: str | torch.device | None = None,
                     timeout: datetime.timedelta | None = None) -> None:
    """Join a process group (a no-op for one process).

    ``coordinator`` ``"host:port"`` of rank 0 (``None``: the ``env://``
    variables ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK`` that launchers such as ``torchrun`` set).  ``num_processes``
    defaults to ``WORLD_SIZE``.  ``backend``: ``"nccl"`` when the device
    is the card (``device=None``), ``"gloo"`` when asked for or when
    ``device="cpu"``.  Under NCCL this process's card is
    :func:`rank_card` of ``process_id`` unless ``device`` names one by
    index; it becomes the current card.  ``timeout``: how long a
    collective waits for the other ranks before it fails (``None``:
    ``torch.distributed``'s default, ten minutes under NCCL)."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return
    dev = torch.device("cuda") if device is None else torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if dev.type == "cuda":
        resolve_device(dev)  # raises without a card
        torch.cuda.set_device(dev.index if dev.index is not None
                              else rank_card(process_id))
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator}" if coordinator else "env://",
        world_size=num_processes, rank=process_id, **kw,
    )


class RankFailure(RuntimeError):
    """Raised by :func:`spawn` when a rank failed.  ``errors``: each
    failed rank's traceback, by rank (a rank ended by :func:`spawn`
    because another failed is not in it; a rank that died without a
    traceback leaves only ``{-1: what the join reported}``)."""

    def __init__(self, errors: dict[int, str]):
        self.errors = errors
        super().__init__("".join(
            f"\n-- rank {r} failed:\n{tb}" for r, tb in sorted(errors.items())))


# seconds the other ranks get to end once one has failed (a rank that
# raised after the same collective as the first ends within them)
GRACE_S = 10.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn, world: int, backend: str, device: str,
               port: int, out_dir: str, args: tuple,
               timeout: datetime.timedelta) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            # one host: the launcher's LOCAL_RANK, if any, is not ours
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    path = os.path.join(out_dir, str(rank))
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank, timeout=timeout)
    try:
        result = fn(make_mesh(device=dev), *args)
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".tmp", path + ".pkl")


def spawn(fn, world: int, backend: str | None = None,
          device: str | torch.device | None = None, args: tuple = (),
          timeout: datetime.timedelta = datetime.timedelta(seconds=120)):
    """Run ``fn(mesh, *args)`` in ``world`` new processes joined in one
    group on a free local TCP port; returns the ranks' results in rank
    order.  ``fn`` must be importable by name (the processes are started
    with ``spawn``).  ``device``: what every rank computes on (``None``
    or ``"cuda"`` = the card of each rank: rank r takes card
    ``r % device_count``; ``"cuda:0"`` puts them all on one card);
    ``backend`` as :func:`init_distributed` picks it.  ``timeout``: the
    group's, how long a collective waits for a rank that does not come.

    A rank that raises makes this raise :class:`RankFailure`, with the
    traceback of every rank that raised: once one rank has failed, the
    others get ``GRACE_S`` seconds to end, then are terminated."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    resolve_device(dev)  # raises on a card that is not there
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory(prefix="tic-spawn-") as out_dir:
        ctx = torch.multiprocessing.start_processes(
            _rank_main,
            args=(fn, world, backend, str(dev), _free_port(), out_dir, args,
                  timeout),
            nprocs=world, join=False, start_method="spawn",
        )
        try:
            while not ctx.join(grace_period=GRACE_S):
                pass
        except (torch.multiprocessing.ProcessRaisedException,
                torch.multiprocessing.ProcessExitedException) as e:
            errors = {}
            for r in range(world):
                err = os.path.join(out_dir, f"{r}.err")
                if os.path.exists(err):
                    with open(err) as f:
                        errors[r] = f.read()
            raise RankFailure(errors or {-1: str(e)}) from e
        results = []
        for r in range(world):
            with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
