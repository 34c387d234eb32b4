"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into ``build/`` at the root of the checkout (next to the
package), into a shared library whose file name carries a hash of the
source, of every header (``*.cuh``) beside it and of the flags, so an edit
to a shared header rebuilds every kernel; ``ctypes`` loads it.  There is no fallback: a build
that fails raises, with the compiler's output in the message.

``build_all`` starts one ``nvcc`` per source at the same time, which is
what a program that needs every kernel should call first.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(
    os.environ.get(
        "TINYIMGCODEC_TORCH_BUILD_DIR",
        Path(__file__).resolve().parents[2] / "build",
    )
)
KERNELS = ("exact_transform", "encode2", "place", "encode1", "stitch",
           "entropy_decode", "exact_inverse")

# -fmad=false: the kernels are held bit for bit against plain PyTorch
# versions that round after every multiply and every add; a contracted
# multiply-add would round once and move results that sit near a
# rounding tie.  No -use_fast_math for the same reason.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# held while a wrapper's launch counters change: the shards of a local
# mesh launch from several threads at once
COUNT_LOCK = threading.Lock()
build_log: dict[str, str] = {}


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
        if cand.exists():
            exe = str(cand)
    if exe is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels cannot be built "
            "(set CUDA_HOME or put nvcc on PATH)"
        )
    return exe


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str):
    src, out = _target(name)
    if out.exists():
        return None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return (proc, tmp, cmd), out


def _finish(name: str, started, out: Path) -> ctypes.CDLL:
    if started is not None:
        proc, tmp, cmd = started
        log, _ = proc.communicate()
        build_log[name] = log
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{log}"
            )
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _LIBS[name] = lib
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if need be."""
    with _LOCK:
        if name not in _LIBS:
            started, out = _start(name)
            _finish(name, started, out)
        return _LIBS[name]


def build_all() -> None:
    """Build every kernel source, all compilers started together."""
    with _LOCK:
        todo = [n for n in KERNELS if n not in _LIBS]
        started = [(n, *_start(n)) for n in todo]
        for n, st, out in started:
            _finish(n, st, out)


def count_launch(counters: dict, device: torch.device) -> None:
    """One launch on ``device`` added to a wrapper module's counters
    (``counters`` is its ``globals()``): ``launches`` and, by card index,
    ``launches_by_card``."""
    with COUNT_LOCK:
        counters["launches"] += 1
        by_card = counters["launches_by_card"]
        by_card[device.index] = by_card.get(device.index, 0) + 1


def stream_handle(device: torch.device) -> int:
    """The ``cudaStream_t`` of ``device``'s current stream, as a launch
    takes it.  Read without building a ``torch.cuda.Stream`` object where
    this PyTorch can (a wrapper calls this once a launch, and the object
    costs more host time than a small kernel runs on the card)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None and device.index is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {err}")
