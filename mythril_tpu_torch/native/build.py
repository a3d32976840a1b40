"""Build the port's CUDA sources into shared libraries, at first use.

Each `csrc/<name>.cu` exposes a plain C entry point and is compiled by
nvcc into `_build/lib<name>.so`, which is then loaded with ctypes. No
source includes PyTorch's headers, so a build takes seconds. A library
whose stamp matches the hash of its source and flags is reused; a failed
build raises with nvcc's output.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>.so csrc/<name>.cu
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_LOADED: dict = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path(stem: str) -> Path:
    return BUILD / f"lib{stem}.so"


def _digest(src: Path) -> str:
    return hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()


def _fresh(stem: str) -> bool:
    stamp = BUILD / f"lib{stem}.sha256"
    return (lib_path(stem).exists() and stamp.exists()
            and stamp.read_text() == _digest(CSRC / f"{stem}.cu"))


def is_built() -> bool:
    return all(_fresh(src.stem) for src in CSRC.glob("*.cu"))


def build(stem: str, verbose: bool = False) -> float:
    """Compile csrc/<stem>.cu unless its library is fresh. Returns the
    wall seconds spent (0.0 when nothing was built)."""
    if _fresh(stem):
        return 0.0
    t0 = time.perf_counter()
    src = CSRC / f"{stem}.cu"
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = BUILD / f"lib{stem}.{os.getpid()}.tmp.so"
    cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stdout}{proc.stderr}")
    if verbose and (proc.stdout or proc.stderr):
        print((proc.stdout + proc.stderr).rstrip())
    os.replace(tmp, lib_path(stem))
    (BUILD / f"lib{stem}.sha256").write_text(_digest(src))
    return time.perf_counter() - t0


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from csrc/<stem>.cu (built if stale)."""
    lib = _LOADED.get(stem)
    if lib is None:
        if not (CSRC / f"{stem}.cu").exists():
            raise FileNotFoundError(CSRC / f"{stem}.cu")
        build(stem)
        lib = _LOADED[stem] = ctypes.CDLL(str(lib_path(stem)))
    return lib
