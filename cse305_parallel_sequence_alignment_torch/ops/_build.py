"""Build and load the port's native code at first use; the bucket check
and mode numbers the fill kernels share.

CUDA kernels (``csrc/*.cu``) are compiled by ``nvcc`` into shared
libraries with a plain C interface and loaded with ctypes; the host
replay/render library is compiled by ``g++`` from the port's own copy of
it, ``csrc/tsalib.cpp``: every source (``sources()``) lies under the
port's ``csrc/``. Outputs go to the package's ``_build/`` directory,
named by a digest of the source and the flags, so an edited source never
loads a stale library. A build writes a private temporary file and
renames it into place, so processes that build the same library at once
never see a half-written file.

Nothing here runs at import time, and nothing falls back: a compiler
that is missing or fails raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
TSALIB = CSRC / "tsalib.cpp"
KERNELS = ("rowcb", "walk", "longrow", "local", "diag", "banded",
           "halostair")  # csrc/<name>.cu
# mode numbers of csrc/diag.cu and csrc/rowcb.cu
MODES = {"global": 0, "semiglobal": 1, "overlap": 2}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-pthread"]


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "are built from csrc/ at first use and need the CUDA toolkit")
    return str(path)


def _build(name, compiler, flags, source):
    text = source.read_bytes()
    digest = hashlib.sha256(
        text + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD / f"lib{name}-{digest}.so"
    if not out.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = BUILD / f".{out.name}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [compiler, *flags, "-o", str(tmp), str(source)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"building {source.name} failed ({compiler}):\n"
                f"{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


def sources():
    """Every source file this module builds."""
    return [CSRC / f"{k}.cu" for k in KERNELS] + [TSALIB]


@functools.lru_cache(maxsize=None)
def cuda_library(name):
    """ctypes handle of ``csrc/<name>.cu``, compiled for sm_90a."""
    return _build(name, _nvcc(), NVCC_FLAGS, CSRC / f"{name}.cu")


@functools.lru_cache(maxsize=None)
def host_library():
    """ctypes handle of the host replay/render library (tsalib.cpp)."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host replay library is "
                           "built from tsalib.cpp at first use")
    return _build("tsa", gxx, GXX_FLAGS, TSALIB)


def check(err, what):
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def check_bucket(a, b, la, lb, st):
    """Raise on a bucket the fills of ops/rowcb.py, ops/diag.py and
    ops/longrow.py do not take: ``a`` (B, m) and ``b`` (B, n) uint8 codes,
    ``la``, ``lb`` and ``st`` (B,) int32, contiguous, on one device."""
    if a.dtype != torch.uint8 or b.dtype != torch.uint8:
        raise TypeError("a and b must be uint8 code tensors")
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must "
                         f"be (B, m) and (B, n)")
    B = a.shape[0]
    for name, v in (("la", la), ("lb", lb), ("st", st)):
        if v.dtype != torch.int32 or tuple(v.shape) != (B,):
            raise ValueError(f"{name} must be ({B},) int32, got "
                             f"{tuple(v.shape)} {v.dtype}")
    for v in (a, b, la, lb, st):
        if v.device != a.device:
            raise ValueError("all inputs must be on one device")
        if not v.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")
