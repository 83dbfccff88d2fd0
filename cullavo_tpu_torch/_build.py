"""Builds and loads the port's CUDA kernels (``csrc/*.cu``).

All sources compile with ``nvcc`` (one compiler process per source, all
started together; ``SPLIT`` compiles a source with many template
instantiations as several parts, each with a ``-D`` that selects its share)
and link into ONE shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers: a source that
includes them takes minutes to compile, a plain-C one seconds).  The
library lands in ``cullavo_tpu_torch/_build/`` under a name keyed by a hash
of the sources and flags, so an edited kernel rebuilds and an unchanged one
is reused.  Nothing is built at import time: the first kernel launch calls
``lib()``.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into an exception carrying the CUDA error
string.  Pointer and stream arguments are declared ``c_void_p`` (ctypes
would otherwise pass a Python int as a 32-bit C int and cut the address).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# source -> (its part macro, parts): nf4_gemv_sm90.cu's four formats (K6,
# K11, K14, K3: 37 instantiations) are four compilers side by side
SPLIT = {"nf4_gemv_sm90.cu": ("NF4_GEMV_PART", 4)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the kernels' entry points (csrc/*.cu, extern "C")
SIGNATURES = {
    # K1 / K1-lse / K8: the layout pointer is 24 int64 (tensor-map extents
    # and byte strides of q, k, v, o)
    "cullavo_flash_fwd": [_P] * 4 + [_I] * 4 + [_P, _F, _P],
    "cullavo_flash_fwd_lse": [_P] * 5 + [_I] * 4 + [_P, _F, _P],
    "cullavo_flash_rows": [_P] * 7 + [_I] * 6 + [_P, _F, _P],
    # K2: x, mult, xi, sx, M, K, the multiplier's kind and the plan (vectors
    # a thread, threads, blocks); its residency query
    "cullavo_quant_rows": [_P] * 4 + [_I] * 6 + [_P],
    "cullavo_quant_rows_resident": [_I] * 3,
    # K3: x, sq_inv, q8, scale8, xs, out, workspace, counters, M, K, N and
    # the plan (nt, g, splits)
    "cullavo_int8_linear": [_P] * 8 + [_I] * 6 + [_P],
    "cullavo_wwin_decode": [_P] * 7 + [_I] * 7 + [_L] * 9 + [_F, _P],
    "cullavo_wwin_decode_q8": [_P] * 9 + [_I] * 7 + [_L] * 13 + [_F, _P],
    # K6 / K11: x, weight, scale, out, split-K workspace and counters, M, K,
    # N (K6: x's plane stride) and the plan (nt, g, splits)
    "cullavo_nf4_gemv_planar": [_P] * 6 + [_I] * 7 + [_P],
    "cullavo_nf4_gemv_q4": [_P] * 6 + [_I] * 6 + [_P],
    "cullavo_nf4_dequant_planar": [_P] * 3 + [_I] * 2 + [_P],
    "cullavo_nf4_dequant_q4": [_P] * 3 + [_I] * 2 + [_P],
    # K9: value, loc, att, out, the level shapes and starts, L, B, S, Q, Hh,
    # hd, P, the dtypes and the plan (queries a tile, tiles)
    "cullavo_msdeform": [_P] * 6 + [_I] * 11 + [_P],
    # K10: ctx, gates, taps, acc, partial, out, kernels, L, B, C, H, W, the
    # strides, scaling, erf, bf16 and the plan (planes, tile h/w, gap, pitch,
    # slots a thread)
    "cullavo_focal_ctx": [_P] * 7 + [_I] * 5 + [_L] * 4 + [_I] * 9 + [_P],
    "cullavo_flash_decode": [_P] * 7 + [_I] * 6 + [_L] * 11 + [_F, _P],
    "cullavo_flash_packed": [_P] * 4 + [_I] * 5 + [_F, _P],
    # K14: x, words, scale, out, workspace, counters, M, K, N and the plan
    "cullavo_p32_linear": [_P] * 6 + [_I] * 6 + [_P],
}

_lib = None
build_info: dict = {}


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return nvcc


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if no build of the current
    sources exists.  ``build_info`` records the build's wall time and the
    compiler's register/shared-memory report."""
    global _lib
    if _lib is not None:
        return _lib
    h = hashlib.sha256((" ".join(NVCC_FLAGS) + repr(sorted(SPLIT.items()))).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    path = BUILD_DIR / f"libcullavo_kernels_{h.hexdigest()[:16]}.so"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.time()
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            macro, n = SPLIT.get(src.name, (None, 1))
            for k in range(n):
                obj = BUILD_DIR / f"{src.stem}.{k}.{os.getpid()}.o"
                part = [f"-D{macro}={k}"] if macro else []
                jobs.append((obj, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, *part, "-c", "-o", str(obj), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        logs = [(obj, proc, proc.communicate()[1]) for obj, proc in jobs]
        failed = [f"{obj.name} ({proc.returncode}):\n{err}"
                  for obj, proc, err in logs if proc.returncode != 0]
        link = None
        if not failed:
            link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                                   *[str(obj) for obj, _, _ in logs]],
                                  capture_output=True, text=True)
        for obj, _, _ in logs:
            obj.unlink(missing_ok=True)
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        os.replace(tmp, path)
        build_info.update(seconds=time.time() - t0,
                          ptxas="".join(err for _, _, err in logs))
    else:
        build_info.update(seconds=0.0, ptxas="(cached build)")
    so = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(so, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    so.cullavo_error_string.argtypes = [ctypes.c_int]
    so.cullavo_error_string.restype = ctypes.c_char_p
    _lib = so
    return so


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        msg = _lib.cullavo_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
