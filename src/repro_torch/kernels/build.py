"""Build a CUDA source of ``csrc/`` into a shared library and load it.

Each library is compiled by ``nvcc`` for ``sm_90a`` (Hopper) at first use,
into ``build/kernels/`` at the root of the checkout, under a name keyed by a
hash of its sources and flags: an edited source builds anew, an unchanged one
loads what is there. The library has a plain C interface and is loaded with
``ctypes``; nothing includes PyTorch's headers, so a build takes seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cuda.exists():
        return str(cuda)
    raise RuntimeError("nvcc not found: building a CUDA kernel needs the CUDA "
                       "toolkit (PATH or CUDA_HOME)")


def _library_path(name: str, sources: Sequence[str]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def report(name: str, sources: Sequence[str]) -> str:
    """ptxas's report of the library's build."""
    return _library_path(name, sources).with_suffix(".ptxas").read_text()


def build(name: str, sources: Sequence[str]) -> Path:
    """Compile ``sources`` (names under ``csrc/``) into one shared library,
    unless a library of these sources and flags is built already. A fresh
    build writes ptxas's report (registers, shared memory and spills of each
    kernel) to stderr and beside the library (``report(name, sources)``)."""
    out = _library_path(name, sources)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}) for {name}:\n"
                           f"{res.stdout}\n{res.stderr}")
    sys.stderr.write(res.stdout + res.stderr)
    out.with_suffix(".ptxas").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)                   # atomic: a concurrent build loses nothing
    return out


def load(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name, sources)))
