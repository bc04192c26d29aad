"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` exports a plain `extern "C"` interface.  It is
compiled on first use with nvcc for Hopper (`sm_90a`) into a shared library
under `build/repro_torch/` at the repository root, named by the hash of the
source and of every shared header `csrc/*.cuh` (so an edited header
rebuilds), and loaded with ctypes.  Nothing is built when a module is
imported, and nothing outside the repository's sources goes into a build.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent.parent / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Built(NamedTuple):
    path: Path
    seconds: float     # compile time of this call (0.0 when already built)
    report: str        # nvcc/ptxas output: registers, shared memory, spills


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, PATH."""
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def source_digest(name: str) -> str:
    """Hash of csrc/<name>.cu together with every csrc/*.cuh header."""
    h = hashlib.sha256()
    for path in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def build(name: str, *, force: bool = False) -> Built:
    """Compile csrc/<name>.cu unless the library for this exact source is
    already in BUILD_DIR (or `force`).  Raises with the compiler's output
    on failure."""
    src = CSRC / f"{name}.cu"
    digest = source_digest(name)
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    if out.exists() and not force:
        return Built(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    report = (proc.stdout + proc.stderr).strip()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{report}")
    os.replace(tmp, out)
    return Built(out, seconds, report)


def build_all(names, *, force: bool = False) -> dict[str, Built]:
    """Build several kernels at once: one nvcc process per source, all
    started together.  Returns {name: Built}; raises the first failure."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        futures = {n: pool.submit(build, n, force=force) for n in names}
        return {n: f.result() for n, f in futures.items()}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    return ctypes.CDLL(str(build(name).path))
