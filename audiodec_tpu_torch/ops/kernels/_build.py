"""Build a CUDA source of the package into a shared library and load it.

`nvcc -gencode arch=compute_90a,code=sm_90a` compiles `csrc/<name>.cu`, a
file with a plain C interface (no PyTorch headers, so the build takes
seconds), into `build/audiodec_tpu_torch/lib<name>.so` beside the package.
The library is rebuilt only when the SHA-256 of the source, the headers
of `csrc/` (`*.cuh`), the flags and `nvcc --version` changes; the hash is
kept in `lib<name>.so.sha256`.  The build runs at first use, never at
import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "audiodec_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (on PATH or under /usr/local/cuda)")
    return nvcc


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless the built library matches its hash."""
    src = CSRC / f"{name}.cu"
    nvcc = _nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
    headers = [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"\0".join([
        src.read_bytes(), *headers, " ".join(NVCC_FLAGS).encode(),
        version.encode(),
    ])).hexdigest()
    lib = BUILD_DIR / f"lib{name}.so"
    stamp = BUILD_DIR / f"lib{name}.so.sha256"
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.so"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees old or new
    stamp.write_text(digest)
    return lib


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load lib<name>.so once per process."""
    return ctypes.CDLL(str(build(name)))
