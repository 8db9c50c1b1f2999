"""Build and load the hand-written Hopper kernels in `csrc/`.

The CUDA sources are compiled with `nvcc` for `sm_90a` -- one `nvcc` per
source, all started together, then one link -- into a shared library with a
plain C interface, loaded with `ctypes`; no PyTorch headers, so a build
takes seconds.  Nothing is built when the package is
imported: the first kernel launch (or an explicit `build()`) compiles into
`_build/<hash of sources and flags>/` beside the package and later calls
load that file.  Every C entry point launches on the stream it is given,
allocates nothing and returns `cudaGetLastError()`; `launch` raises when
that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu", "cross_attention.cu", "probes.cu",
           "rope.cu", "elementwise.cu")
HEADERS = ("hopper_common.cuh",)
BUILD_ROOT = PACKAGE_DIR / "_build"
LIB_NAME = "libsa_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# argument types of each C entry point; every pointer and the stream is a
# c_void_p (a plain int would be cut to 32 bits)
SIGNATURES = {
    # q, k, v, k_lens, out, lse, B, Lq, Lk, N, D, scale_log2, stream
    "sa_flash_fwd_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # q8, k8, v, sqk, k_lens, out, lse, B, Lq, Lk, N, D, stream
    "sa_flash_fwd_int8_qk": [_P] * 7 + [_I] * 5 + [_P],
    # q8, k8, v8, sv, sqk, k_lens, out, lse, B, Lq, Lk, N, D, stream
    "sa_flash_fwd_int8_qkv": [_P] * 8 + [_I] * 5 + [_P],
    # q8, k8, v8, sv, sqk, k_lens, out, lse, B, Lq, Lk, N, D, pv_block, stream
    "sa_flash_fwd_int8_qkpv": [_P] * 8 + [_I] * 6 + [_P],
    # q8, k8, v, sqk, mstat, k_lens, out, lse, B, Lq, Lk, N, D, stream
    "sa_flash_fwd_int8_static_qk": [_P] * 8 + [_I] * 5 + [_P],
    # q8, k8, v8, sv, sqk, mstat, k_lens, out, lse, B, Lq, Lk, N, D, stream
    "sa_flash_fwd_int8_static_qkv": [_P] * 9 + [_I] * 5 + [_P],
    # q, k, v, dout, lse, delta, k_lens, dq_acc, dk, dv, dk_part, dv_part,
    # B, Lq, Lk, N, D, splits, scale, scale_log2, stream
    "sa_flash_bwd": [_P] * 12 + [_I] * 6 + [_F, _F, _P],
    # q, k, table, qr, kr, B, Lq, Lk, N, D, stream
    "sa_rope_rotate": [_P] * 5 + [_I] * 5 + [_P],
    # dq32, dk32, dv32, table, dq, dk, dv, B, Lq, Lk, N, D, stream
    "sa_rope_finalize_bwd": [_P] * 7 + [_I] * 5 + [_P],
    # q, k1, v1, k2, v2, out, B, Lq, L1, L2, N, D, scale_log2, stream
    "sa_dual_context": [_P] * 6 + [_I] * 6 + [_F, _P],
    # a, b, out, M, N, K, epilogue, stream
    "sa_mm_probe": [_P] * 3 + [_I] * 4 + [_P],
    # q, k, v, out, BH, L, D, int8, stream
    "sa_dots_probe": [_P] * 4 + [_I] * 4 + [_P],
    # x, out, n, fp32, c0, c1, stream
    "sa_gelu_tanh": [_P, _P, _L, _I, _F, _F, _P],
    # x, g, dx, n, fp32, c0, c1, stream
    "sa_gelu_tanh_bwd": [_P, _P, _P, _L, _I, _F, _F, _P],
}

_lock = threading.Lock()
_lib = None


def source_paths():
    return [CSRC / name for name in SOURCES + HEADERS]


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_paths():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the Hopper kernels are built from csrc/ at first "
            "use and need the CUDA toolkit (sm_90a)"
        )
    return nvcc


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def build() -> Path:
    """Compile the kernels unless this exact source set is already built:
    every source to an object file in parallel, then one link.  The
    compiler's resource report (-Xptxas -v) is kept in `build.log` beside
    the library."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=out.parent))
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    jobs = []
    for name in SOURCES:
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(work / f"{name}.o")]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    log, failed = "", False
    for cmd, proc in jobs:
        output, _ = proc.communicate()
        log += f"$ {' '.join(cmd)}\n{output}"
        failed |= proc.returncode != 0
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(work / LIB_NAME), *(str(work / f"{n}.o") for n in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        failed = proc.returncode != 0
    (out.parent / "build.log").write_text(log + f"\nseconds: {time.perf_counter() - t0:.2f}\n")
    if failed:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError(f"nvcc failed:\n{log}")
    os.replace(work / LIB_NAME, out)  # atomic: a concurrent build sees all or nothing
    shutil.rmtree(work, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call one C entry point on PyTorch's current CUDA stream (appended as
    the last argument) and raise if the launch was refused."""
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(library(), name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
