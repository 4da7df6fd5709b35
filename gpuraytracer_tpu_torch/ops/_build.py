"""Builds the port's CUDA sources into shared libraries and loads them.

Each ``ops/csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/gpuraytracer_tpu_torch/lib<name>-<hash>.so``
beside the package (a git-ignored directory), then loaded with ``ctypes``.
The hash covers the source text, the headers beside it (``csrc/*.cuh``) and
the compiler flags, so an edited source is rebuilt and an unchanged one is
reused. Nothing here runs at import: the build happens inside the first call
that needs the card, and a failed build raises — there is no fallback.
``load_libraries`` builds several sources at once, one ``nvcc`` each.
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
from typing import Dict, List, Sequence

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
# Every kernel source of the package: the path tracer's draws and trace, its
# backward, the MIS integrator and its backward, the silhouette records and
# their backward.
SOURCES = ("path_kernels", "shade_kernels", "mis_kernels", "mis_bwd_kernels",
           "soft_kernels")
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "gpuraytracer_tpu_torch")

# No --use_fast_math, and no FMA contraction: see the note at the top of
# csrc/path_kernels.cu. -Xptxas -v prints registers, shared memory and spills.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class BuiltLibrary:
    """A loaded kernel library and the record of how it was built."""

    lib: ctypes.CDLL
    path: Path
    nvcc: str
    log: str  # compiler output (the -Xptxas -v resource report)
    seconds: float  # build time; 0.0 when an existing build was reused


_LOADED: Dict[str, BuiltLibrary] = {}
_LOCK = threading.Lock()


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, the PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def load_library(name: str) -> BuiltLibrary:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    if name in _LOADED:
        return _LOADED[name]
    source = CSRC_DIR / f"{name}.cu"
    text = source.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"lib{name}-{digest[:16]}.so"
    log_path = out.with_suffix(".log")
    nvcc = find_nvcc()
    seconds = 0.0
    if out.exists() and log_path.exists():
        log = log_path.read_text()
    else:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}-{threading.get_ident()}.so")
        start = time.perf_counter()
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
            capture_output=True, text=True)
        seconds = time.perf_counter() - start
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source} (exit {proc.returncode}):\n{log}")
        log_path.write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    built = BuiltLibrary(lib=ctypes.CDLL(str(out)), path=out, nvcc=nvcc,
                         log=log, seconds=seconds)
    with _LOCK:
        return _LOADED.setdefault(name, built)


def load_libraries(names: Sequence[str] = SOURCES) -> List[BuiltLibrary]:
    """Build and load several sources (all of them unless told otherwise),
    their ``nvcc`` runs side by side."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return list(pool.map(load_library, names))
