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
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# included by the sources; part of each digest
HEADERS = ("tile_launch.cuh", "flash_wgmma.cuh")

BUILD_LOG: dict[str, str] = {}         # name -> nvcc/ptxas output
_LIBS: dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()


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
    """The kernel library ``name``, built on first use and cached.  One
    build at a time: tenant worker threads may launch a kernel for the
    first time together, and a build's temporary file is named by the
    process, not the thread."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                path = build_all([name])[name]
                try:
                    lib = _LIBS[name] = ctypes.CDLL(str(path))
                except OSError as exc:
                    raise KernelError(f"cannot load {path}: {exc}") from exc
    return lib


# The binding shapes of the port's C entry points; each returns a
# ``cudaError_t``.  Tile copies (``launch_tiles`` in ``csrc/tile_launch.cuh``):
# four input pointers, the output, the tile count, BN, the row bytes and the
# stream.  The bitmap aggregate (``csrc/version_aggregate.cu``): the bitmap,
# the values, two outputs, R, W, BR, vid and the stream.  The membership
# scan (``csrc/membership_scan.cu``): the bitmap, two outputs, R, W, the row
# and word strides in elements, BR, vid and the stream.  Flash attention
# (``csrc/flash_attention.cu``):
# q, k, v, out, the row lse (or null), then B, Sq, Sk, H, Hkv, the q·k width
# Dqk, v's width Dv, v's row pitch, causal, dtype (0 float32, 1 bfloat16) and
# the stream.  Its backward (``csrc/flash_backward.cu``): q, k, v, o, dO,
# lse, dq, dk, dv, the dq workspace and delta, then B, Sq, Sk, H, Hkv, Dh,
# causal and the stream.  The
# SSD scan (``csrc/ssd_scan.cu``): xs, B, C, dt, a, y, the final state, the
# bf16 scratch (chunk states, decays), then B, L, H, P, N, Q, dtype and the
# stream.
TILE_ARGS = ([ctypes.c_void_p] * 5
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_void_p])
BITMAP_ARGS = ([ctypes.c_void_p] * 4
               + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p])
MEMBERSHIP_ARGS = ([ctypes.c_void_p] * 3
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
FLASH_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
FLASH_BWD_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
SSD_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _bind(name: str, entry: str, argtypes):
    fn = getattr(load(name), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def kernel_fn(name: str, entry: str | None = None):
    """The tile-copy C entry point ``entry`` (default ``<name>_launch``) of
    library ``name``, built and bound on first use, with the signature of
    ``launch_tiles``."""
    return _bind(name, entry or f"{name}_launch", TILE_ARGS)


@functools.lru_cache(maxsize=None)
def bitmap_fn(name: str):
    """The bitmap kernel ``<name>_launch`` of library ``name``, built and
    bound on first use, with the ``BITMAP_ARGS`` signature."""
    return _bind(name, f"{name}_launch", BITMAP_ARGS)


@functools.lru_cache(maxsize=None)
def membership_fn():
    """``membership_scan_launch``, built and bound on first use
    (``MEMBERSHIP_ARGS``)."""
    return _bind("membership_scan", "membership_scan_launch", MEMBERSHIP_ARGS)


@functools.lru_cache(maxsize=None)
def membership_instance_fn():
    """``membership_scan_instance`` (bitmap, row and word strides, BR, vid
    -> 1 for the vec4 instance, 0 for the strided one), built and bound on
    first use."""
    return _bind("membership_scan", "membership_scan_instance",
                 [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                  ctypes.c_int, ctypes.c_int])


@functools.lru_cache(maxsize=None)
def flash_fn():
    """``flash_attention_launch``, built and bound on first use
    (``FLASH_ARGS``)."""
    return _bind("flash_attention", "flash_attention_launch", FLASH_ARGS)


@functools.lru_cache(maxsize=None)
def flash_instance_fn():
    """``flash_attention_instance`` (Dqk, Dv, dtype -> the instance a
    launch at these widths runs, -1 if none takes them as they are), built
    and bound on first use."""
    return _bind("flash_attention", "flash_attention_instance",
                 [ctypes.c_int] * 3)


@functools.lru_cache(maxsize=None)
def flash_bwd_fn():
    """``flash_backward_launch``, built and bound on first use
    (``FLASH_BWD_ARGS``)."""
    return _bind("flash_backward", "flash_backward_launch", FLASH_BWD_ARGS)


@functools.lru_cache(maxsize=None)
def flash_bwd_instance_fn():
    """``flash_backward_instance`` (Dqk, Dv, dtype -> 1 where the backward
    kernel takes these widths and dtype, else 0), built and bound on first
    use."""
    return _bind("flash_backward", "flash_backward_instance",
                 [ctypes.c_int] * 3)


@functools.lru_cache(maxsize=None)
def flash_bwd_layout_fns():
    """``flash_backward_lse_pitch`` (Sq -> the row pitch of the float32 lse
    and delta) and ``flash_backward_workspace`` (B, H, Sq, Dh -> the dq
    workspace's float32 elements), built and bound on first use: the
    backward's source owns the layout its launch reads."""
    pitch = _bind("flash_backward", "flash_backward_lse_pitch", [ctypes.c_int])
    ws = _bind("flash_backward", "flash_backward_workspace",
               [ctypes.c_int] * 4)
    ws.restype = ctypes.c_longlong
    return pitch, ws


@functools.lru_cache(maxsize=None)
def ssd_fn():
    """``ssd_scan_launch``, built and bound on first use (``SSD_ARGS``)."""
    return _bind("ssd_scan", "ssd_scan_launch", SSD_ARGS)


def check_launch(err: int, what: str) -> None:
    """Raise ``KernelError`` for a C entry point's nonzero ``cudaError_t``:
    a refused launch never runs, and no later synchronise reports it."""
    if err:
        raise KernelError(f"{what} launch failed: cudaError {err}")
