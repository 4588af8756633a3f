"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
by ``nvcc`` for Hopper (``sm_90a``) into ``ultra_torchdrug_tpu_torch/build/``
and loaded with ctypes. The library's file name carries a hash of its source
and of the shared headers (``csrc/*.cuh``), so an edited source or header is
rebuilt and a stale library is never loaded. Build
errors raise with nvcc's output. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def sources() -> list:
    """Names of every kernel source in csrc/."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(cuda_home) / "bin" / "nvcc"
        if not candidate.exists():
            raise RuntimeError(
                "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
                "are built from csrc/ at first use and need the CUDA toolkit")
        nvcc = str(candidate)
    return nvcc


def library_path(name: str) -> Path:
    text = (CSRC_DIR / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile the named sources that have no up-to-date library, one nvcc
    process per source, all started together. Returns name -> library path;
    each build's compiler output (registers, spills) is kept beside its
    library as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, []
    for name in names:
        lib = library_path(name)
        out[name] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, lib, tmp, cmd, proc))
    failures = []
    for name, lib, tmp, cmd, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\n{log}")
            continue
        lib.with_suffix(".so.log").write_text(log)
        os.replace(tmp, lib)  # atomic: concurrent builders never see a partial file
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return out


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build([name])[name]))
