"""ctypes bindings for the native C++ host runtime (native/gpurt_native.cpp).

Counterpart of ``gpuraytracer_tpu/native.py``, a copy rather than an import.
It builds the repository's ``native/gpurt_native.cpp`` with ``g++`` into
``build/gpuraytracer_tpu_torch/native/libgpurt_native-<hash>.so`` (a
git-ignored directory; the hash covers the source and the flags), compiling
to a name of its own and ``os.replace``-ing it into place, so that processes
building at once never load a half-written library. It never writes to
``native/``. Every entry point has a pure-Python or numpy version in the
package (``image.py``), so the package works without a toolchain; the
native path is the fast one for large images (the reference's host runtime
is native Swift, and this is its C++ analog). Host I/O only: nothing here
touches the card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
SOURCE = _ROOT / "native" / "gpurt_native.cpp"
BUILD_DIR = _ROOT / "build" / "gpuraytracer_tpu_torch" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
LIBS = ("-lz",)

_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode()).hexdigest()
    return BUILD_DIR / f"libgpurt_native-{digest[:16]}.so"


def build() -> Path:
    """Build the library (if this source and these flags have not been
    built yet) and return its path; raises ``RuntimeError`` with the
    compiler's output when ``g++`` fails or is missing."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{' '.join(cmd)} failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed (exit {proc.returncode}):"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def load(strict: bool = False) -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None where it cannot be
    built or loaded, or, with ``strict``, the error with the compiler's
    output. A failure is remembered for the process unless ``strict``."""
    global _lib, _tried
    if _lib is not None or (_tried and not strict):
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError):
        if strict:
            raise
        return None

    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.gpurt_tonemap.argtypes = [f32p, u8p, ctypes.c_int64,
                                  ctypes.c_float, ctypes.c_float]
    lib.gpurt_tonemap.restype = None
    lib.gpurt_png_encode.argtypes = [u8p, ctypes.c_int32, ctypes.c_int32,
                                     ctypes.c_int32, u8p, ctypes.c_int64]
    lib.gpurt_png_encode.restype = ctypes.c_int64
    lib.gpurt_compile_triangles.argtypes = [f32p, ctypes.c_int64, f32p]
    lib.gpurt_compile_c2.argtypes = [f32p, f32p, ctypes.c_int64, f32p]
    lib.gpurt_halton_table.argtypes = [ctypes.c_uint32, ctypes.c_int64,
                                       ctypes.c_int32, f32p]
    lib.gpurt_row_means.argtypes = [f32p, ctypes.c_int32, ctypes.c_int32, f32p]
    for fn in (lib.gpurt_compile_triangles, lib.gpurt_compile_c2,
               lib.gpurt_halton_table, lib.gpurt_row_means):
        fn.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def tonemap(hdr: np.ndarray, exposure: float = 2.0,
            gamma: float = 2.2) -> np.ndarray:
    """Native exposure / Reinhard / gamma -> uint8 (image.swift:46-65)."""
    lib = load(strict=True)
    hdr = np.ascontiguousarray(hdr, np.float32)
    out = np.empty(hdr.shape, np.uint8)
    lib.gpurt_tonemap(_fptr(hdr), _u8ptr(out), hdr.size,
                      ctypes.c_float(exposure), ctypes.c_float(gamma))
    return out


def png_encode(rgb: np.ndarray) -> bytes:
    """Native PNG encode of [H, W, 3|4] uint8."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] not in (3, 4):
        raise ValueError(f"expected [H, W, 3|4] uint8, got {rgb.shape}")
    lib = load(strict=True)
    h, w, c = rgb.shape
    cap = rgb.size + rgb.size // 100 + 4096
    out = np.empty(cap, np.uint8)
    n = lib.gpurt_png_encode(_u8ptr(rgb), w, h, c, _u8ptr(out), cap)
    if n < 0:
        raise RuntimeError("gpurt_png_encode failed")
    return out[:n].tobytes()


def write_png(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_encode(rgb))


def compile_triangles(verts: np.ndarray):
    """Native intersection-constant precompute: verts [T, 3, 3] f32 ->
    (packed [T, 11] f32: n, c0, s1, c1, s2; c2 [T] f32), the constants of
    ``intersect.compile_scene``."""
    verts = np.ascontiguousarray(verts, np.float32)
    if verts.ndim != 3 or verts.shape[1:] != (3, 3):
        raise ValueError(f"expected [T, 3, 3] vertices, got {verts.shape}")
    lib = load(strict=True)
    t = verts.shape[0]
    out11 = np.empty((t, 11), np.float32)
    c2 = np.empty((t,), np.float32)
    lib.gpurt_compile_triangles(_fptr(verts), t, _fptr(out11))
    lib.gpurt_compile_c2(_fptr(verts), _fptr(out11), t, _fptr(c2))
    return out11, c2


def halton_table(start: int, count: int, dim: int) -> np.ndarray:
    """Radical inverses of indices [start, start + count) at Halton
    dimension ``dim`` (0 to 23, the library's primes)."""
    if not 0 <= dim < 24 or count < 0:
        raise ValueError(f"dimension {dim} or count {count} out of range")
    lib = load(strict=True)
    out = np.empty(count, np.float32)
    lib.gpurt_halton_table(ctypes.c_uint32(start), count, dim, _fptr(out))
    return out


def row_means(hdr: np.ndarray) -> np.ndarray:
    """Per-row mean of [H, W, 3] float32 -> [H, 3]."""
    hdr = np.ascontiguousarray(hdr, np.float32)
    if hdr.ndim != 3 or hdr.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] radiance, got {hdr.shape}")
    lib = load(strict=True)
    h, w, _ = hdr.shape
    out = np.empty((h, 3), np.float32)
    lib.gpurt_row_means(_fptr(hdr), h, w, _fptr(out))
    return out
