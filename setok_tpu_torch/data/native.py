"""ctypes bindings for the native image-preprocessing library.

The counterpart of `setok_tpu/data/native.py`, over the port's own copy of
the source, `setok_tpu_torch/csrc/fast_image.cpp`: g++ builds it into
`build/` of the checkout at first use (the same library name as the
JAX package's, hashed by the source). Unlike the JAX package, nothing here
falls back: where g++ is missing or the build fails, `get_lib` raises, so
a caller that asked for the native path never gets PIL's quietly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "csrc" / "fast_image.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"libfast_image_torch-{h.hexdigest()[:16]}.so"


def _compile() -> Path:
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                       check=True, capture_output=True, text=True)
    except FileNotFoundError:
        raise RuntimeError("g++ not found: the native image path "
                           "(use_native=True) builds csrc/fast_image.cpp "
                           "with it") from None
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"g++ failed on {SRC}:\n{e.stderr}") from None
    os.replace(tmp, path)
    return path


def get_lib() -> ctypes.CDLL:
    """The library, built and bound once; raises where it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_compile()))
            f32p = ctypes.POINTER(ctypes.c_float)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.resize_bilinear_normalize.argtypes = [
                u8p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int,
                ctypes.c_int, f32p, f32p, ctypes.c_float, ctypes.c_float]
            lib.assemble_batch.argtypes = [
                ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int, f32p, ctypes.c_int, ctypes.c_int, f32p, f32p,
                ctypes.c_float, ctypes.c_float, ctypes.c_int]
            _lib = lib
        return _lib


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def resize_normalize(img: np.ndarray, size: int,
                     mean: Sequence[float] = (0.0, 0.0, 0.0),
                     std: Sequence[float] = (1.0, 1.0, 1.0),
                     scale: float = 1.0, offset: float = 0.0) -> np.ndarray:
    """uint8 (H, W, 3) → float32 (size, size, 3): bilinear resize fused
    with (x/255 - mean)/std · scale + offset."""
    lib = get_lib()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"(H, W, 3) uint8 image expected, got {img.shape}")
    out = np.empty((size, size, 3), np.float32)
    m = np.asarray(mean, np.float32)
    s = np.asarray(std, np.float32)
    lib.resize_bilinear_normalize(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), img.shape[0],
        img.shape[1], _f32p(out), size, size, _f32p(m), _f32p(s),
        ctypes.c_float(scale), ctypes.c_float(offset))
    return out


def assemble_batch(images, size: int,
                   mean: Sequence[float] = (0.0, 0.0, 0.0),
                   std: Sequence[float] = (1.0, 1.0, 1.0),
                   scale: float = 1.0, offset: float = 0.0,
                   num_threads: Optional[int] = None) -> np.ndarray:
    """N uint8 (H, W, 3) images of any sizes → (N, size, size, 3) float32
    in one call that releases the GIL, over `num_threads` threads (default
    the CPU count)."""
    lib = get_lib()
    arrs = [np.ascontiguousarray(im, dtype=np.uint8) for im in images]
    if not arrs:
        raise ValueError("no images")
    for a in arrs:
        if a.ndim != 3 or a.shape[2] != 3:
            raise ValueError(f"(H, W, 3) uint8 image expected, got "
                             f"{a.shape}")
    n = len(arrs)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ptrs = (u8p * n)(*[a.ctypes.data_as(u8p) for a in arrs])
    shapes = np.asarray([[a.shape[0], a.shape[1]] for a in arrs],
                        np.int32).reshape(-1)
    out = np.empty((n, size, size, 3), np.float32)
    m = np.asarray(mean, np.float32)
    s = np.asarray(std, np.float32)
    lib.assemble_batch(
        ptrs, shapes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
        _f32p(out), size, size, _f32p(m), _f32p(s), ctypes.c_float(scale),
        ctypes.c_float(offset), num_threads or os.cpu_count() or 1)
    return out
