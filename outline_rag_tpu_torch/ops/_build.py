"""Build and load the package's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` of the package for ``sm_90a``, one
process per source, all started together, and links the objects into one
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds). The build happens at first use, into ``build/`` beside
``csrc/`` (listed in ``.gitignore``), under a file name keyed by a hash of
the sources and the flags, so an edited source never loads a stale library.
The library is loaded with ``ctypes``. A failed build raises; nothing falls
back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel
)


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output (ptxas resource usage); empty when cached


_lock = threading.Lock()
_built: BuildResult | None = None
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # noqa: PLC0415

    if CUDA_HOME:
        candidate = Path(CUDA_HOME) / "bin" / "nvcc"
        if candidate.exists():
            return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _run(cmd: list[str]) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True)


def build_library() -> BuildResult:
    """Compile the kernels unless a library for these exact sources and
    flags is already built; thread-safe, and safe across processes (the
    library is written under a temporary name and renamed into place)."""
    global _built
    with _lock:
        if _built is not None:
            return _built
        sources = _sources()
        digest = hashlib.sha256()
        for src in sources:
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        path = BUILD_DIR / f"libort_kernels_{digest.hexdigest()[:16]}.so"
        if path.exists():
            _built = BuildResult(path, 0.0, "")
            return _built
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        nvcc = _nvcc()
        cus = [s for s in sources if s.suffix == ".cu"]
        objects = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in cus]
        compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)] for s, o in zip(cus, objects)]
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]
        t0 = time.perf_counter()
        try:
            with ThreadPoolExecutor(len(compiles)) as pool:  # every source at once
                runs = list(zip(compiles, pool.map(_run, compiles)))
            if all(r.returncode == 0 for _, r in runs):
                runs.append((link, _run(link)))
            log = "".join(r.stdout + r.stderr for _, r in runs)
            for cmd, r in runs:
                if r.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(f"nvcc failed (exit {r.returncode}):\n{' '.join(cmd)}\n{log}")
        finally:
            for obj in objects:
                obj.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
        os.replace(tmp, path)
        _built = BuildResult(path, seconds, log)
        return _built


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    built = build_library()
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(built.path))
        return _lib
