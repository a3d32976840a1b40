"""Build the port's CUDA sources into shared libraries, at first use,
and launch their entries (`on_cuda` picks kernel or plain version by
where a wrapper's operands lie, `launch` calls an entry on PyTorch's
current stream).

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

import torch

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
    """The hash of a source, the headers beside it (csrc/*.cuh) and the
    flags."""
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    return hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()


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


def on_cuda(tensors, what: str) -> bool:
    """True where the operands of the kernel wrapper `what` lie on one
    CUDA device (launch the kernel), False where they lie on the CPU (run
    the plain version); raise for a mix of devices or any other device."""
    dev = tensors[0].get_device()
    if any(t.get_device() != dev for t in tensors[1:]):
        raise ValueError(f"{what} operands on {sorted({str(t.device) for t in tensors})}")
    if tensors[0].is_cuda:
        return True
    if tensors[0].device.type != "cpu":
        raise ValueError(f"{what} runs on cpu or cuda, not {tensors[0].device}")
    return False


def launch(fn, device: int, *args) -> None:
    """Call the C entry `fn(*args, stream)` with PyTorch's current stream
    on CUDA device `device` (so a CUDA graph capture or a side stream
    sees the launch), under a device guard only where that device is not
    the current one; raise if it returns a CUDA error."""
    stream = torch._C._cuda_getCurrentRawStream(device)
    if device == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {rc}")
