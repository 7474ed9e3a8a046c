"""Hand-written CUDA kernels for Hopper, built at first use and bound with
ctypes.

Each `itrx_torch/csrc/<name>.cu` exposes a plain C interface.  `load(name)`
compiles it with nvcc for `sm_90a` into
`build/itrx_torch_kernels/<name>-<hash>.so` (the hash covers the source, the
shared headers `csrc/*.cuh` and the flags, so an edited source rebuilds),
then loads it.  Nothing is built
or loaded when this package is imported: the CPU tests import every module
on a machine with no nvcc and no card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]  # itrx_torch/
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "itrx_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its library is already built.  The
    compiler's output (ptxas register and shared-memory use) is kept beside
    the library as <library>.log."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True,
    )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library csrc/<name>.cu."""
    lib = ctypes.CDLL(str(build(name)))
    lib.itrx_cuda_error_string.argtypes = [ctypes.c_int]
    lib.itrx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, what: str, code: int) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError() != 0)."""
    if code != 0:
        msg = lib.itrx_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def current_stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
