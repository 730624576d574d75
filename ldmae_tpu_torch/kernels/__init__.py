"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled at first use by ``nvcc`` into a shared library with
a plain C interface, loaded with ``ctypes``; no PyTorch header is included,
so a build takes seconds (the attention sources, with a kernel for each
head-dim class, take longest). Builds go to ``build/ldmae_kernels/`` beside the
package under a name keyed on a hash of the sources, the flags and the
compiler, so a changed source rebuilds and an unchanged one loads. ``build`` compiles several sources in
parallel, one ``nvcc`` each. Importing this module needs neither ``nvcc``
nor a GPU.

Every C entry returns the CUDA error of its launch; ``check`` raises on a
non-zero one. ``on_device`` calls an entry on a tensor's device and current
stream.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ldmae_kernels"

# --split-compile=0: nvcc runs a source's device-code optimisation in as
# many threads as the machine has CPUs (the attention sources' many
# instantiations took about twice as long in one thread each)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0",
]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# The C entries of the two attention libraries, bf16 and fp32 (the same
# names and arguments, so the wrappers pick a library by dtype).
_ATTENTION = {
    "ldmae_flash_attention_fwd": [_P] * 5 + [_I] * 4 + [_P],
    "ldmae_flash_attention_rope_fwd": [_P] * 9 + [_I] * 4 + [_P],
    "ldmae_flash_attention_qknorm_rope_fwd": [_P] * 10 + [_I] * 4 + [_L] * 3 + [_I, _F, _P],
    "ldmae_flash_attention_fused_rope_fwd": [_P] * 8 + [_I] * 4 + [_L] * 3 + [_I, _P],
    "ldmae_flash_attention_bwd": [_P] * 12 + [_I] * 4 + [_P],
    "ldmae_flash_attention_rope_bwd": [_P] * 16 + [_I] * 4 + [_P],
}

# library name -> (source, {C entry: argtypes})
LIBRARIES = {
    "flash_attention": (
        "flash_attention.cu",
        _ATTENTION | {"ldmae_flash_attention_resident_fwd": [_P] * 4 + [_I] * 3 + [_P],
                      "ldmae_rate_probe": [_P, _I, _I, _I, _P]},
    ),
    "flash_attention_fp32": ("flash_attention_fp32.cu", _ATTENTION),
    "fused_norm_modulate": (
        "fused_norm_modulate.cu",
        {"ldmae_fused_norm_modulate": [_P, _P, _P, _P, _L, _L, _P, _I, _I, _I, _I, _F, _I, _P],
         "ldmae_fused_norm_modulate_bwd_grid": [_I, _I, _I, _I, _P],
         "ldmae_fused_norm_modulate_bwd": [_P] * 4 + [_L] + [_P] * 5 + [_L] + [_I] * 4 + [_F, _I, _I, _P]},
    ),
    "fused_matmul_silu": (
        "fused_matmul_silu.cu",
        {"ldmae_fused_matmul_silu": [_P, _P, _P, _P, _I, _I, _I, _P],
         "ldmae_fused_matmul_silu_f32": [_P, _P, _P, _P, _I, _I, _I, _P]},
    ),
    "dense": (
        "dense.cu",
        {"ldmae_dense_bias_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
         "ldmae_int8_dense": [_P] * 6 + [_I] * 4 + [_P],
         "ldmae_dense_f32_out": [_P, _P, _P, _I, _I, _I, _P],
         "ldmae_int8_dense_i32": [_P, _P, _P, _I, _I, _I, _P]},
    ),
    "fused_quant": (
        "fused_quant.cu",
        {
            "ldmae_fused_norm_modulate_quant": [_P, _P, _P, _P, _L, _L, _P, _P, _I, _I, _I, _I, _F, _I, _P],
            "ldmae_fused_silu_mul_quant": [_P, _P, _P, _L, _I, _I, _P],
            "ldmae_silu_mul_amax": [_P, _P, _L, _I, _I, _P],
            "ldmae_silu_mul_quant_scaled": [_P, _P, _P, _P, _L, _I, _I, _P],
        },
    ),
}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc") if os.environ.get("CUDA_HOME") else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str, nvcc: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS + [nvcc, name]).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named libraries (default: all) that are not built yet,
    one ``nvcc`` per source, all started together. Returns, per library,
    the seconds its build took (0 when it was already built) and the
    compiler's ``-Xptxas -v`` report. Raises when a build fails."""
    nvcc = nvcc_path()
    names = list(LIBRARIES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    report: Dict[str, dict] = {}
    t0 = time.time()
    for name in names:
        out = _lib_path(name, nvcc)
        if out.exists():
            report[name] = {"seconds": 0.0, "ptxas": "", "path": str(out)}
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / LIBRARIES[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.time() - t0, "ptxas": log, "path": str(out)}
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return report


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The library ``name`` with argtypes and restype set (built if needed)."""
    info = build([name])[name]
    lib = ctypes.CDLL(info["path"])
    for fn, argtypes in LIBRARIES[name][1].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def on_device(x, entry, *args) -> int:
    """``entry(*args, stream)`` with x's device current and ``stream`` its
    current CUDA stream. The device guard is entered only when another device
    is current, and the stream is read as a raw handle: the guard and a
    ``torch.cuda.Stream`` object took about 0.01 ms of host time a call,
    more than half of #3's device time at batch 8 (PERF.md section 6)."""
    idx = x.device.index
    if idx == torch.cuda.current_device():
        return entry(*args, torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return entry(*args, torch._C._cuda_getCurrentRawStream(idx))
