"""A 1-D mesh over the ranks of a ``torch.distributed`` process group.

The counterpart of the JAX package's ``parallel/mesh.py``.  One process
drives one device; the codec shards along one axis -- images, or the
block ranges of one image -- so a mesh is the group's ranks in order.
Collectives move their tensors on the group's device: the card under
NCCL, the CPU under gloo (whose ``all_gather`` takes no CUDA tensor).  A
mesh with no group is a world of one, and its collectives return their
input.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import tempfile
import traceback

import torch
import torch.distributed as dist

from ..device import resolve_device


class Mesh:
    """The process group (``None`` for a world of one), its size, this
    process's rank, the device this process computes on, and the name of
    the mesh's one axis."""

    def __init__(self, group, size: int, rank: int, device: torch.device,
                 axis: str = "batch"):
        self.group = group
        self.size = size
        self.rank = rank
        self.device = device
        self.axis = axis

    @property
    def comm_device(self) -> torch.device:
        """Where the collectives' tensors live: the CPU under gloo, this
        process's card (with its index) under NCCL."""
        if self.group is not None and dist.get_backend(self.group) == "gloo":
            return torch.device("cpu")
        return self.device

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t`` (one shape on all ranks), in rank order, on
        :attr:`comm_device`."""
        if self.group is None:
            return [t]
        src = t.to(self.comm_device).contiguous()
        out = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(out, src, group=self.group)
        return out

    def all_gather_varlen(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's 1-D ``t`` of any length, in rank order: the
        lengths first, then the tensors padded to the longest."""
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
        if self.group is None:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                         device=self.comm_device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())

    def all_gather_bytes(self, items: list[bytes]) -> list[bytes]:
        """Every rank's list of byte strings, concatenated in rank order."""
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


def make_mesh(n_devices: int | None = None, axis: str = "batch",
              device: str | torch.device | None = None) -> Mesh:
    """A mesh over the initialised default process group, or a world of
    one when none is initialised.  ``n_devices``: ``None`` or the group's
    size for the whole group, 1 for this process alone; more than the
    group has raises ``ValueError``, as the JAX function does.
    ``device``: what this process computes on (``None`` = the card)."""
    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    if n < 1:
        raise ValueError(f"requested {n} devices")
    if n == world and dist.is_available() and dist.is_initialized():
        return Mesh(dist.group.WORLD, world, rank, dev, axis)
    if n == 1:
        return Mesh(None, 1, 0, dev, axis)
    raise ValueError(
        f"a mesh of {n} of the group's {world} processes: a mesh spans the "
        "whole group or one process")


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
