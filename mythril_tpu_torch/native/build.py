"""Build the port's CUDA sources into shared libraries, at first use.

Each `csrc/<name>.cu` exposes a plain C entry point and is compiled by
nvcc into `_build/lib<name>.so`, which is then loaded with ctypes; the
stale sources are compiled together, one nvcc each. No source includes
PyTorch's headers, so a build takes seconds. A library whose stamp
matches the hash of its source and flags is reused; a failed build
raises with nvcc's output.

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


def build(verbose: bool = False) -> dict:
    """Compile every csrc/*.cu whose library is stale: one nvcc per
    source, all started together. Returns {stem: (seconds from the start
    until its nvcc was seen to finish, nvcc's output)} for the sources it
    compiled; `verbose` asks ptxas for its register and spill report."""
    t0 = time.perf_counter()
    started = {}
    for src in sorted(CSRC.glob("*.cu")):
        stem = src.stem
        if _fresh(stem):
            continue
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = BUILD / f"lib{stem}.{os.getpid()}.tmp.so"
        cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(src)]
        started[stem] = (src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    done = {}
    try:
        for stem, (src, tmp, proc) in started.items():
            report, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{report}")
            os.replace(tmp, lib_path(stem))
            (BUILD / f"lib{stem}.sha256").write_text(_digest(src))
            done[stem] = (time.perf_counter() - t0, report.rstrip())
    finally:
        # a failed build leaves no other nvcc running
        for _, _, proc in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return done


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from csrc/<stem>.cu (every stale source
    is built first)."""
    lib = _LOADED.get(stem)
    if lib is None:
        if not (CSRC / f"{stem}.cu").exists():
            raise FileNotFoundError(CSRC / f"{stem}.cu")
        build()
        lib = _LOADED[stem] = ctypes.CDLL(str(lib_path(stem)))
    return lib
