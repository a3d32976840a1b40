"""Build the port's CUDA sources into shared libraries, at first use,
and launch their entries (`on_cuda` picks kernel or plain version by
where a wrapper's operands lie, `launch` calls an entry on PyTorch's
current stream); and build the host solver library.

Each `csrc/<name>.cu` exposes a plain C entry point and is compiled by
nvcc into `_build/lib<name>.so`, which is then loaded with ctypes; the
stale sources are compiled together, one nvcc each. No source includes
PyTorch's headers, so a build takes seconds. A library whose stamp
matches the hash of its source and flags is reused; a failed build
raises with nvcc's output.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>.so csrc/<name>.cu

The host solver's two C++ sources (native/host/cdcl.cpp, the CDCL SAT
solver, and blast.cpp, the bit-blaster's circuits) are built by g++,
never nvcc, into one library, so the solver runs wherever g++ does:

    g++ -O3 -fPIC -shared -std=c++17 -o _build/libmythril_torch_host.so \
        native/host/cdcl.cpp native/host/blast.cpp

under a file lock (test workers build it once between them), written by
an atomic rename and reused while its stamp matches the hash of the
sources and flags (`build_host`, `load_host`). A failed build raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
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

HOST_SRC = PKG / "native" / "host"
HOST_SOURCES = ("cdcl.cpp", "blast.cpp")
HOST_STEM = "mythril_torch_host"
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_LOADED: dict = {}
#: one build or load at a time in a process: the analysis service's
#: arena warmup, its wave thread and its host walks' races may all reach
#: `load` first, and two nvcc runs of one source would share a temp file
_BUILD_MU = threading.RLock()


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
    with _BUILD_MU:
        return _build(verbose)


def _build(verbose: bool) -> dict:
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
        with _BUILD_MU:
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


# ---------------------------------------------------------------------------
# the host solver library (g++)
# ---------------------------------------------------------------------------


def gxx() -> str:
    found = shutil.which(os.environ.get("CXX") or "g++")
    if found is None:
        raise RuntimeError("g++ not found: the host solver library cannot be built")
    return found


def _host_digest() -> str:
    blob = b"".join(name.encode() + (HOST_SRC / name).read_bytes() for name in HOST_SOURCES)
    return hashlib.sha256(blob + " ".join(GXX_FLAGS).encode()).hexdigest()


def host_is_built() -> bool:
    stamp = BUILD / f"lib{HOST_STEM}.sha256"
    return (lib_path(HOST_STEM).exists() and stamp.exists()
            and stamp.read_text() == _host_digest())


def build_host() -> float:
    """Build the host solver library if it is stale; the seconds g++
    took (0.0 where the library was fresh). Several processes may call
    this at once: one builds under the lock, the others wait and reuse
    its library."""
    if host_is_built():
        return 0.0
    BUILD.mkdir(parents=True, exist_ok=True)
    with open(BUILD / f"lib{HOST_STEM}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if host_is_built():
            return 0.0
        t0 = time.perf_counter()
        tmp = BUILD / f"lib{HOST_STEM}.{os.getpid()}.tmp.so"
        cmd = [gxx(), *GXX_FLAGS, "-o", str(tmp),
               *(str(HOST_SRC / name) for name in HOST_SOURCES)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed on {', '.join(HOST_SOURCES)}:\n{proc.stdout}")
        os.replace(tmp, lib_path(HOST_STEM))
        (BUILD / f"lib{HOST_STEM}.sha256").write_text(_host_digest())
        return time.perf_counter() - t0


def load_host() -> ctypes.CDLL:
    """The loaded host solver library (built first where stale)."""
    lib = _LOADED.get(HOST_STEM)
    if lib is None:
        build_host()
        lib = _LOADED[HOST_STEM] = ctypes.CDLL(str(lib_path(HOST_STEM)))
    return lib
