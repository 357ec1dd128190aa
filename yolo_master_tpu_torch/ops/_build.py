"""Build and load the port's CUDA kernels (``csrc/*.cu``) with ``nvcc`` + ``ctypes``.

Each source file becomes one shared library with a plain C interface, built at
first use for Hopper (``sm_90a``) into ``yolo_master_tpu_torch/_build/``. The
library's file name carries a hash of its source and flags, so an edited
kernel is rebuilt and a stale build is never loaded. Nothing here runs at
import time: the CPU tests import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
SMEM_LIMIT_BYTES = 232448  # shared memory one Hopper thread block may use (227 KB)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (needed to build the CUDA kernels in yolo_master_tpu_torch/csrc)")


def _library_path(name: str, extra_flags: tuple) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(ARCH_FLAGS + BASE_FLAGS + list(extra_flags)).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def load_library(name: str, extra_flags: tuple = ()) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its hashed library is missing, then load it."""
    out = _library_path(name, extra_flags)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *ARCH_FLAGS, *BASE_FLAGS, *extra_flags, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees the old name or the whole file
    return ctypes.CDLL(str(out))


def check(status: int, what: str) -> None:
    """Raise when a kernel's C entry point returned a non-zero cudaError_t."""
    if status != 0:
        raise RuntimeError(f"{what} failed to launch: cudaError_t {status}")


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
