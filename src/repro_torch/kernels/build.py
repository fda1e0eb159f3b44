"""Build and load the port's hand-written CUDA kernels.

Every source under ``repro_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes`` — no PyTorch headers, so a build takes seconds.  Libraries land
in ``build/kernels/`` at the repository root (git-ignored), named by a
digest of the source and the flags, so an edited source rebuilds and an
unchanged one is reused.  Nothing builds at import time: the first launch
of a kernel builds it, or ``build_all`` builds every source at once, one
``nvcc`` process per source, all started together.

Every failure of this layer (a build, a load, a launch, or a plan or
operand a kernel cannot take) raises ``KernelError``.  It is never a
transient fault: the write path's warn-and-evict guards re-raise it, so a
broken kernel cannot hide behind a lazy rebuild from the host.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

HEADERS = ("tile_launch.cuh",)   # included by the sources; part of each digest

BUILD_LOG: dict[str, str] = {}         # name -> nvcc/ptxas output
_LIBS: dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A kernel did not build, load or launch, or refused what it was
    given."""


class PlanError(KernelError, ValueError):
    """A kernel wrapper refused its plan or operands before the launch (a
    run outside its source, a misaligned row, a wrong dtype)."""


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise KernelError("nvcc not found: the CUDA kernels build only on a "
                          "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    text = src.read_bytes() + b"".join((CSRC / h).read_bytes()
                                       for h in HEADERS)
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)     # atomic: a concurrent builder sees all or none


def build_all(names) -> dict[str, Path]:
    """Build every named source in parallel; returns name -> library."""
    started = {n: _start(n) for n in names}
    for n, s in started.items():
        if s is not None:
            _finish(n, s)
    return {n: library_path(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use and cached."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([name])[name]
        try:
            lib = _LIBS[name] = ctypes.CDLL(str(path))
        except OSError as exc:
            raise KernelError(f"cannot load {path}: {exc}") from exc
    return lib


@functools.lru_cache(maxsize=None)
def kernel_fn(name: str):
    """The C entry point ``<name>_launch`` of library ``name``, built and
    bound on first use.  Every kernel of the port has the signature of
    ``launch_tiles`` in ``csrc/tile_launch.cuh``: four input pointers, the
    output, the tile count, BN, the row bytes and the stream; it returns a
    ``cudaError_t``."""
    fn = getattr(load(name), f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
