"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` file has a plain C interface. At first use it is
compiled by `nvcc` for Hopper (`sm_90a`) into a shared library under the
package's git-ignored `_build/` directory and loaded with ctypes. The
library's file name carries a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source is rebuilt and an unchanged
one is reused. Nothing here runs at import
time: the CPU tests import every module on machines without `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load_library", "build_log", "CSRC_DIR", "BUILD_DIR"]

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    """The nvcc of CUDA_HOME (as PyTorch resolves it), else the one on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "from csrc/ at first use and need the CUDA toolkit")
    return found


def _library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` if its library is missing, then load it.

    The compiler's report (registers, shared memory, spills from
    `-Xptxas -v`) is kept beside the library; `build_log(name)` returns it.
    """
    so = _library_path(name)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu "
                               f"(exit {res.returncode}):\n{res.stderr}")
        so.with_suffix(".log").write_text(
            f"{' '.join(cmd)}\nbuild_s={time.perf_counter() - t0:.3f}\n"
            f"{res.stdout}{res.stderr}")
        os.replace(tmp, so)  # atomic: concurrent builders never load a torn file
    return ctypes.CDLL(str(so))


def build_log(name: str) -> str:
    """The compile command, time and ptxas report of `csrc/<name>.cu`, or ''
    if this process loaded a library built earlier without one."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
