"""Build and load the CUDA kernels (plain C interface, bound with ctypes).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
under ``build/repro_torch_kernels/`` at the root of the checkout, at first
use.  All missing libraries build at once, one ``nvcc`` process per source.
A library's file name carries a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source rebuilds and an
unchanged one loads from the cache.  Only the
sources in this package are compiled; nothing is fetched.

:func:`check_arg` is the launchers' check of each tensor before its
pointer crosses the C interface.

Flags: ``sm_90a`` (Hopper), ``-O3``, no fast math and ``--fmad=false`` so
divisions and products round as in the plain PyTorch versions, and
``-Xptxas -v`` so :data:`build_log` keeps each kernel's register and
shared-memory report.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "NVCC_FLAGS", "build", "library",
           "build_log", "check_arg"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("lss_state", "correction", "region_decide")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

build_log: dict = {}  # source name -> nvcc's output (ptxas report)
_libs: dict = {}  # source name -> loaded ctypes.CDLL


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); "
                       "the CUDA kernels are built from source at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # shared device code
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> list:
    """Compile every library of ``names`` that is not cached yet.

    The ``nvcc`` processes run in parallel; a failure raises after all of
    them have ended.  Returns the names that were compiled.
    """
    jobs = []
    try:
        for name in names:
            out = _lib_path(name)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((name, proc, tmp, out))
        failed = []
        for name, proc, tmp, out in jobs:
            build_log[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(name)
            else:
                os.replace(tmp, out)  # atomic: readers never see a half file
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(
                f"{n}.cu:\n{build_log[n]}" for n in failed))
    finally:
        for _, proc, tmp, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return [job[0] for job in jobs]


def check_arg(kernel: str, name: str, t, shape, dtype, device) -> None:
    """Raise unless tensor ``t`` is what the C interface of ``kernel``
    takes: on ``device``, of ``dtype`` and ``shape``, contiguous."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, not {device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} has dtype {t.dtype}, not {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"not {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} is not contiguous")


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib
