"""A 1-D mesh: the ranks of a ``torch.distributed`` process group, the
devices of this one process, or both.

The counterpart of the JAX package's ``parallel/mesh.py``.  The codec
shards along one axis -- images, or the block ranges of one image -- so a
mesh is its shards in order, and every parallel entry point runs one SPMD
body on each shard (:meth:`Mesh.run`), which talks to the others only
through four collectives: ``all_gather``, ``all_gather_varlen``, ``any``
and ``all_gather_bytes``.  Three kinds of mesh carry that body:

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
- **a local mesh in each process of a group** (a :class:`LocalMesh` with
  a group, ``make_mesh(devices=[...])`` inside a group), JAX's mesh over
  every process's devices: k shards in each of the group's processes,
  ``world * k`` in all, shard ``rank * k + j`` the j-th of process
  ``rank``.  A collective is two levels: the local shards hand their
  values to local shard 0 through the slots, local shard 0 (the calling
  thread) makes one group collective for the whole process -- on the CPU
  under gloo, on the process's first card under NCCL -- and hands the
  ``world * k`` results back.  A shard that raises outside a collective
  breaks its process's barrier as above; the other processes then fail
  when the group's timeout ends, as a group of one device a rank does.
"""

from __future__ import annotations

import contextvars
import datetime
import os
import pickle
import signal
import sys
import tempfile
import threading
import time
import traceback

import torch
import torch.distributed as dist

from .. import profiling
from ..device import resolve_device
from ..ops import _build


class _Exchange:
    """The slots and the barrier that the shard threads of one process in
    one :meth:`LocalMesh.run` share, and each shard's seconds spent in
    collectives.  ``proc``: this process's view of the group (a
    :class:`Mesh` of one device a rank), ``None`` outside a group;
    ``first``: the global rank of this process's shard 0."""

    def __init__(self, n: int, proc: Mesh | None = None, first: int = 0):
        self.barrier = threading.Barrier(n)
        self.slots: list = [None] * n
        self.wait_s = [0.0] * n
        self.proc = proc
        self.first = first
        self.out = None

    def combine(self, rank: int, value, fn):
        """``fn(proc, every local shard's value)``, computed once, on local
        shard 0, and returned on every local shard.  Two waits suffice: a
        shard writes its next value only after the second, by which local
        shard 0 has read this one's; local shard 0 writes the next result
        only after the next first wait, by which every shard has read
        this one."""
        i = rank - self.first
        t0 = time.perf_counter()
        self.slots[i] = value
        self.barrier.wait()
        if i == 0:
            self.out = fn(self.proc, list(self.slots))
        self.barrier.wait()
        out = self.out
        self.wait_s[i] += time.perf_counter() - t0
        return out


def _gather(proc, values: list) -> list:
    if proc is None:
        return values
    dev = proc.comm_device
    parts = proc.all_gather(torch.stack([v.to(dev) for v in values]))
    return [t for part in parts for t in part.unbind(0)]


def _gather_varlen(proc, values: list) -> list:
    values = [v.reshape(-1) for v in values]
    if proc is None:
        return values
    dev = proc.comm_device
    lens = proc.all_gather(torch.tensor([v.numel() for v in values],
                                        dtype=torch.int64))
    data = proc.all_gather_varlen(torch.cat([v.to(dev) for v in values]))
    out = []
    for ks, d in zip(lens, data):
        at = 0
        for k in ks.tolist():
            out.append(d[at:at + k])
            at += k
    return out


def _any(proc, values: list) -> bool:
    flag = any(values)
    return flag if proc is None else proc.any(flag)


def _gather_bytes(proc, values: list) -> list:
    items = [x for part in values for x in part]
    return items if proc is None else proc.all_gather_bytes(items)


class Mesh:
    """One shard's view of a mesh: the process group (``None`` for a world
    of one and for a shard of a :class:`LocalMesh` outside a group), the
    number of shards, this shard's (global) rank, the device it computes
    on, and the name of the mesh's one axis."""

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
        process's card (with its index) under NCCL -- its first card when
        it holds several shards -- and each shard's own device in a local
        mesh outside a group."""
        if self._exchange is not None and self._exchange.proc is not None:
            return self._exchange.proc.comm_device
        if self.group is not None and dist.get_backend(self.group) == "gloo":
            return torch.device("cpu")
        return self.device

    @property
    def result_wanted(self) -> bool:
        """Whether this shard's result is returned: on every rank of a
        process group, only local shard 0's of a local mesh -- in each
        process of a group, so every process gets the result (the others
        may skip assembling it once they have handed over their part)."""
        return self.local_rank == 0

    @property
    def local_rank(self) -> int:
        """This shard's index among this process's shards."""
        if self._exchange is None:
            return 0
        return self.rank - self._exchange.first

    def shards(self) -> list[tuple[int, torch.device]]:
        """The ranks and devices of the shards this process computes."""
        return [(self.rank, self.device)]

    def run(self, body, *args):
        """``body(shard, *args)`` on every shard of this process; returns
        the result of shard 0 (here: of this process's one shard)."""
        return body(self, *args)

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t`` (one shape on all ranks), in rank order, on
        :attr:`comm_device` (in a local mesh outside a group each on its
        shard's device)."""
        if self._exchange is not None:
            return self._exchange.combine(self.rank, t, _gather)
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
            return self._exchange.combine(self.rank, t, _gather_varlen)
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
            return self._exchange.combine(self.rank, bool(flag), _any)
        if self.group is None:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                         device=self.comm_device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())

    def all_gather_bytes(self, items: list[bytes]) -> list[bytes]:
        """Every rank's list of byte strings, concatenated in rank order."""
        if self._exchange is not None:
            return self._exchange.combine(self.rank, list(items),
                                          _gather_bytes)
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
    the CPU are the counterpart of the JAX tests' virtual host devices),
    or over those of every process of ``group`` (``world * k`` shards,
    this process's the ``k`` from global rank ``rank * k``).

    :meth:`run` builds the kernels first where a shard is a card (all
    sources at once; a no-op once built), then starts one thread a shard
    after the first (shard 0 runs on the calling thread), each inside
    ``torch.cuda.device`` of its card,
    and joins them all before it returns or raises; ``last_run`` then
    holds each shard's wall and thread CPU seconds and its seconds in
    collectives.  Each shard runs in a copy of the caller's context, so
    its ``profiling`` spans carry the caller's call id, its rank and its
    device, and record while the caller is profiled.  The collectives
    exist only on the shard views that :meth:`run` hands its body."""

    def __init__(self, devices: list[torch.device], axis: str = "batch",
                 group=None):
        k = len(devices)
        self._proc = None
        if group is not None:
            world, me = dist.get_world_size(group), dist.get_rank(group)
            self._proc = Mesh(group, world, me, devices[0], axis)
        else:
            world, me = 1, 0
        super().__init__(group, world * k, me * k, devices[0], axis)
        self.devices = list(devices)
        self.last_run: list[dict] = []

    def shards(self) -> list[tuple[int, torch.device]]:
        return [(self.rank + j, d) for j, d in enumerate(self.devices)]

    def run(self, body, *args):
        if any(d.type == "cuda" for d in self.devices):
            # every compiler at once, before the shards would each wait for
            # the other's build under the loader's lock
            _build.build_all()
        n = len(self.devices)
        exchange = _Exchange(n, self._proc, self.rank)
        results: list = [None] * n
        errors: list = [None] * n
        times: list = [None] * n
        traced = profiling.active()
        contexts = [contextvars.copy_context() for _ in range(n)]

        def shard(r: int) -> None:
            dev = self.devices[r]
            view = Mesh(self.group, self.size, self.rank + r, dev, self.axis,
                        exchange)
            profiling.enter_shard(self.rank + r, dev, traced)
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

        threads = [threading.Thread(target=contexts[r].run,
                                    args=(shard, r), daemon=True,
                                    name=f"tic-mesh-shard-{r}")
                   for r in range(1, n)]
        for t in threads:
            t.start()
        contexts[0].run(shard, 0)
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


def _check_devices_a_process(k: int, dev: torch.device) -> None:
    """Raise ``ValueError`` on every process of the default group unless
    each gave ``k`` devices (a collective)."""
    proc = Mesh(dist.group.WORLD, dist.get_world_size(), dist.get_rank(),
                dev)
    counts = [int(c) for c in proc.all_gather(
        torch.tensor([k], dtype=torch.int64))]
    if len(set(counts)) > 1:
        raise ValueError("every process of a group must give make_mesh as "
                         f"many devices; by rank they gave {counts}")


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

    Inside an initialised default process group: by default the group's
    ranks, one device a process (``device``, ``None`` = the card);
    ``n_devices`` ``None`` or the group's size for the whole group, 1 for
    this process alone.  ``devices`` (JAX's mesh over every process's
    devices): k devices in each process, ``world * k`` shards in rank-major
    order (a :class:`LocalMesh` with the group; one device is the default
    mesh).  Every process must pass as many: the counts are all-gathered
    here, so every process calls this together, and a mismatch raises
    ``ValueError`` on every process.  Under NCCL the first of a process's
    devices must be the card its group was initialised on (the current
    card), where its group collectives run."""
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
        if _in_group():
            _check_devices_a_process(len(devs), devs[0])
            if len(devs) > 1:
                return LocalMesh(devs, axis, dist.group.WORLD)
        elif len(devs) > 1:
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
    index; it becomes the current card.  A process that drives k cards
    (``make_mesh(devices=[...])`` next) passes its first card here, by
    index (``device="cuda:i"``): its group collectives run there.
    ``timeout``: how long a collective waits for the other ranks before
    it fails (``None``: ``torch.distributed``'s default, ten minutes
    under NCCL)."""
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
    """Raised by :func:`spawn` when a rank failed.  ``errors``: by rank,
    each failed rank's traceback, or, for a rank that ended with no
    traceback (a signal, ``os._exit``), its exit code and whether it had
    written its result (a rank ended by :func:`spawn` because another
    failed is not in it)."""

    def __init__(self, errors: dict[int, str]):
        self.errors = errors
        super().__init__("".join(f"\n-- rank {r} failed:\n{tb}"
                                 for r, tb in sorted(errors.items())))


# seconds the other ranks get to end once one has failed (a rank that
# raised after the same collective as the first ends within them)
GRACE_S = 10.0


def rank_devices(rank: int, device: str | torch.device,
                 per_rank: int = 1) -> list[torch.device]:
    """The devices of rank ``rank`` of :func:`spawn` on one host: the
    cards ``rank * per_rank + j`` (modulo the cards there are) for
    ``"cuda"``, else ``per_rank`` times ``device`` (``"cuda:0"`` puts
    every shard of every rank on card 0; ``"cpu"``: CPU shards)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        # one host: the launcher's LOCAL_RANK, if any, is not ours
        count = torch.cuda.device_count()
        return [torch.device("cuda", (rank * per_rank + j) % count)
                for j in range(per_rank)]
    return [dev] * per_rank


def _rank_main(rank: int, fn, world: int, backend: str, device: str,
               per_rank: int, port: int, out_dir: str, args: tuple,
               timeout: datetime.timedelta) -> None:
    devs = rank_devices(rank, device, per_rank)
    if devs[0].type == "cuda":
        torch.cuda.set_device(devs[0])  # the group's card
    path = os.path.join(out_dir, str(rank))
    # the store is the parent's: it outlives every rank, and its port was
    # never released
    store = dist.TCPStore("127.0.0.1", port, is_master=False,
                          timeout=timeout)
    dist.init_process_group(backend, store=store, world_size=world,
                            rank=rank, timeout=timeout)
    try:
        mesh = (make_mesh(device=devs[0]) if per_rank == 1
                else make_mesh(devices=devs))
        result = fn(mesh, *args)
        # the result is safe before the teardown, whatever that does
        with open(path + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(path + ".tmp", path + ".pkl")
        # no rank tears the group down while another still works in it
        dist.barrier()
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _rank_process(*args) -> None:
    """``spawn``'s target: :func:`_rank_main`, then the process ends at
    once, before the interpreter finalizes.  A gloo worker thread may
    still drop the last reference to a collective's tensor after the
    collective has returned (the group's destructor can run after the
    interpreter's exit, as ``destroy_process_group`` says of its hooks);
    that release takes the interpreter lock, which a finalizing
    interpreter answers with ``pthread_exit``, whose unwinding through the
    worker's C++ frames calls ``std::terminate``: SIGABRT, now and then,
    in a rank that had done its work.  A rank that raises ends as
    ``torch.multiprocessing`` ends it, with its traceback."""
    _rank_main(*args)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def _no_traceback(out_dir: str, rank: int, code) -> str:
    """What :class:`RankFailure` says of a rank that ended without one."""
    how = (f"signal {signal.Signals(-code).name} (exit code {code})"
           if code is not None and code < 0 else f"exit code {code}")
    wrote = os.path.exists(os.path.join(out_dir, f"{rank}.pkl"))
    return (f"wrote its result, then ended by {how}" if wrote
            else f"ended by {how} before writing its result")


def spawn(fn, world: int, backend: str | None = None,
          device: str | torch.device | None = None, args: tuple = (),
          timeout: datetime.timedelta = datetime.timedelta(seconds=120),
          per_rank: int = 1):
    """Run ``fn(mesh, *args)`` in ``world`` new processes joined in one
    group; returns the ranks' results in rank order.  ``fn`` must be
    importable by name (the processes are started with ``spawn``).
    ``device``: what every rank computes on (``None`` or ``"cuda"`` = the
    card of each rank: rank r takes card ``r % device_count``; ``"cuda:0"``
    puts them all on one card); ``backend`` as :func:`init_distributed`
    picks it.  ``per_rank``: the devices of each rank (:func:`rank_devices`;
    for more than one, rank r takes cards ``r * per_rank ..``, its group
    on the first, and ``fn`` gets ``make_mesh(devices=...)``, a mesh of
    ``world * per_rank`` shards).  ``timeout``: the group's, how long a
    collective waits for a rank that does not come.  The ranks meet at a
    ``TCPStore`` that this process holds on a port it bound (port 0: the
    system's choice) until every rank has ended.

    A rank that raises makes this raise :class:`RankFailure`, with the
    traceback of every rank that raised: once one rank has failed, the
    others get ``GRACE_S`` seconds to end, then are terminated.  A rank
    that ends by a signal or a non-zero exit code without a traceback
    fails the same way, even after writing its result."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    resolve_device(dev)  # raises on a card that is not there
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False, timeout=timeout)
    with tempfile.TemporaryDirectory(prefix="tic-spawn-") as out_dir:
        ctx = torch.multiprocessing.start_processes(
            _rank_process,
            args=(fn, world, backend, str(dev), per_rank, store.port,
                  out_dir, args, timeout),
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
            if e.error_index not in errors:
                errors[e.error_index] = _no_traceback(
                    out_dir, e.error_index,
                    ctx.processes[e.error_index].exitcode)
            raise RankFailure(errors) from e
        finally:
            del store
        results = []
        for r in range(world):
            with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
