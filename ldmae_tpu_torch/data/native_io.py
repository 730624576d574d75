"""ctypes binding of the native PNG writer (port of ``write_pngs`` in
``ldmae_tpu/data/native_io.py``).

``native/ldmae_io.cpp``'s ``png_encode_batch`` encodes a batch of uint8
images to PNG files on its own threads (zlib, filter 0). The library is
built with ``g++`` at first use into ``build/ldmae_io/`` beside the package
(``native/`` is the JAX package's and is left alone), under a name keyed on
the source's hash. Where ``g++`` or zlib is missing a warning says so and
the images are written with PIL. This is host code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path
from typing import List, Optional

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
SRC = _ROOT / "native" / "ldmae_io.cpp"
BUILD_DIR = _ROOT / "build" / "ldmae_io"

_lib = None
_failed = False
_lock = threading.Lock()
# PNGs written by each route, for the checks that the native writer ran
WRITTEN = {"native": 0, "pil": 0}


def _build() -> Optional[Path]:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libldmae_io_{digest}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(SRC), "-lz", "-lpthread", "-o", str(tmp)],
                       check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        detail = getattr(e, "stderr", "") or e
        warnings.warn(f"native PNG writer: the build failed ({detail}); writing PNGs with PIL")
        return None
    tmp.replace(so)
    return so


def get_lib():
    """The loaded library, built at first use; None where it cannot be built
    (tried once a process)."""
    global _lib, _failed
    with _lock:
        if _lib is None and not _failed:
            so = _build()
            if so is None:
                _failed = True
            else:
                lib = ctypes.CDLL(str(so))
                lib.png_encode_batch.restype = ctypes.c_int
                lib.png_encode_batch.argtypes = [
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ]
                _lib = lib
        return _lib


def write_pngs(images: np.ndarray, paths: List[str], level: int = 1, num_threads: int = 0) -> int:
    """(N, H, W, 3) uint8 -> N PNG files at ``paths`` (zlib ``level``, 0
    threads: one per core); returns the number written. A file the native
    writer could not write raises ``OSError``."""
    images = np.ascontiguousarray(images, dtype=np.uint8)
    n, h, w, c = images.shape
    if c != 3 or len(paths) != n:
        raise ValueError(f"write_pngs: {images.shape} images for {len(paths)} paths; (N, H, W, 3) uint8 expected")
    lib = get_lib()
    if lib is None:
        from PIL import Image

        for img, p in zip(images, paths):
            Image.fromarray(img).save(p, format="PNG", compress_level=level)
        WRITTEN["pil"] += n
        return n
    names = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    ok = lib.png_encode_batch(images.ctypes.data_as(ctypes.c_void_p), n, h, w, names, level, num_threads)
    if ok != n:
        raise OSError(f"native PNG writer wrote {ok}/{n} files (disk full or an unwritable path?)")
    WRITTEN["native"] += n
    return ok
