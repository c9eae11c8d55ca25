"""Build a native source of the package into a shared library and load it.

A CUDA source `csrc/<name>.cu`, a file with a plain C interface (no
PyTorch headers, so the build takes seconds), is compiled by `nvcc
-gencode arch=compute_90a,code=sm_90a`; a host source `csrc/<name>.cpp`
(the WAV codec) by `g++ -O3 -shared -fPIC`.  Either goes into
`build/audiodec_tpu_torch/lib<name>.so` beside the package, rebuilt only
when the SHA-256 of the source, the headers of `csrc/` (`*.cuh`, for the
CUDA sources), the flags and the compiler's `--version` changes; the hash
is kept in `lib<name>.so.sha256`.  The build runs at first use, never at
import, and a failed build raises.
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
CXX_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC"]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (on PATH or under /usr/local/cuda)")
    return nvcc


def _cxx() -> str:
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the WAV codec needs a C++ "
                           "compiler on PATH")
    return cxx


def build(name: str) -> Path:
    """Compile csrc/<name>.cu (or csrc/<name>.cpp) unless the built library
    matches its hash."""
    src = CSRC / f"{name}.cu"
    if src.exists():
        compiler, flags = _nvcc(), NVCC_FLAGS
        headers = [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    else:
        src = CSRC / f"{name}.cpp"
        compiler, flags, headers = _cxx(), CXX_FLAGS, []
    version = subprocess.run([compiler, "--version"], capture_output=True,
                             text=True, check=True).stdout
    digest = hashlib.sha256(b"\0".join([
        src.read_bytes(), *headers, " ".join(flags).encode(),
        version.encode(),
    ])).hexdigest()
    lib = BUILD_DIR / f"lib{name}.so"
    stamp = BUILD_DIR / f"lib{name}.so.sha256"
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.so"
    proc = subprocess.run([compiler, *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(compiler)} failed on "
                           f"{src}:\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees old or new
    stamp.write_text(digest)
    return lib


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load lib<name>.so once per process."""
    return ctypes.CDLL(str(build(name)))
