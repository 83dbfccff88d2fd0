"""Where a block of K10 (the focal-modulation context, ``csrc/focal_ctx.cu``)
spends its time: clock cycles per phase on one CUDA card.

    python3 cullavo_tpu_torch/scripts/focal_phases.py [--variant base|no_gates|no_gelu|no_conv]

Builds an instrumented copy of ``csrc/focal_ctx.cu`` (that file alone, with
nvcc, into a temporary directory): thread 0 of every block records
``clock64()`` at the block's start and after the prologue, each level's
barrier, the plane sums and the output.  A variant takes one part of every
level out, to weigh it: ``no_gates`` (no gate loads: every gate reads as 1),
``no_gelu`` (the conv's sums pass on without GELU), ``no_conv`` (each level
passes its input on).  Then runs K10 through ``ops.focal.focal_ctx_kernel``
at each FocalNet-L stage of the X-Decoder eval (batch 8, a 512^2 image,
levels k = 3, 5, 7, 9, bf16, tanh GELU, ctx and gates the strided views of
the ``f`` projection) and prints one JSON line per stage: the plan's planes
a block and slots a thread, the blocks, and the mean cycles a block of each
phase.  Only ``base`` computes K10's function; the variants are for
weighing, and their outputs are not checked.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
SRC = os.path.join(ROOT, "cullavo_tpu_torch", "csrc", "focal_ctx.cu")
MAX_BLOCKS = 8192
PHASES = ("prologue", "level 0", "level 1", "level 2", "level 3", "sums", "output")
STAGES = ((128, 128, 192), (64, 64, 384), (32, 32, 768), (16, 16, 1536))
KERNELS = (3, 5, 7, 9)

# (anchor, replacement): the instrumentation, then each variant's edit
PROBES = [
    ("namespace {\n\nconstexpr int kMaxLevels = 8;",
     f"__device__ unsigned long long g_phase[{MAX_BLOCKS} * 8];\n"
     "namespace {\n\nconstexpr int kMaxLevels = 8;"),
    ("  const long long b = blockIdx.z;\n\n  // the block's planes",
     "  const long long b = blockIdx.z;\n"
     "  const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;\n"
     f"#define PHASE(i) if (tid == 0 && blk < {MAX_BLOCKS}) g_phase[blk * 8 + (i)] = clock64();\n"
     "  PHASE(0)\n\n  // the block's planes"),
    ("  asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n  __syncthreads();\n",
     "  asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n  __syncthreads();\n  PHASE(1)\n"),
    ("    __syncthreads();\n    float* t = in;",
     "    __syncthreads();\n    if (l < 4) PHASE(2 + l)\n    float* t = in;"),
    ("  if (!f.one_pass && tid == 0) partial[",
     "  PHASE(6)\n  if (!f.one_pass && tid == 0) partial["),
]
TAIL = """
extern "C" int cullavo_focal_phases(void* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase)));
}
"""
VARIANTS = {
    "base": [],
    "no_gates": [
        ("    for (int s = 0; s < S; ++s) v[s] = p[static_cast<long long>(min(s, rows - 1)) "
         "* W];\n", ""),
        ("  __device__ __forceinline__ float get(int s) const { return to_f(v[s]); }",
         "  __device__ __forceinline__ float get(int) const { return 1.f; }")],
    "no_gelu": [("      for (int s = 0; s < S; ++s) o[s] = gelu(o[s], f.erf_gelu);\n", "")],
    "no_conv": [("      if (vec) {\n        const float* c = in + (col - r) * Pt + row0 - 4;",
                 "      for (int s = 0; s < S; ++s) o[s] = in[col * Pt + row0 + s];\n"
                 "      if (k < 0) {\n        const float* c = in + (col - r) * Pt + row0 - 4;"),
                ("      } else {\n        conv_any(",
                 "      } else if (k < 0) {\n        conv_any(")],
}


def instrumented_source(variant: str) -> str:
    """csrc/focal_ctx.cu with the phase stamps and the variant's edit; raises
    if the source no longer holds an anchor."""
    text = open(SRC).read()
    for anchor, repl in PROBES + VARIANTS[variant]:
        if text.count(anchor) != 1:
            raise RuntimeError(f"focal_phases: anchor not found once in {SRC}: {anchor[:60]!r}")
        text = text.replace(anchor, repl)
    # the last stamp: after the output loop, before the kernel returns
    end = "    else emit(g2);\n  }\n}\n"
    if text.count(end) != 1:
        raise RuntimeError("focal_phases: the end of the kernel is not where it was")
    return text.replace(end, "    else emit(g2);\n  }\n  __syncthreads();\n  PHASE(7)\n}\n") + TAIL


def build(variant: str, workdir: str) -> ctypes.CDLL:
    """The instrumented K10 as a shared library, bound as the port's kernel
    library (only K10's entry point is used)."""
    from cullavo_tpu_torch import _build

    cu = os.path.join(workdir, "focal_phases.cu")
    so = os.path.join(workdir, "libfocal_phases.so")
    with open(cu, "w") as fh:
        fh.write(instrumented_source(variant))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:-2], "-shared", "-o", so, cu], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    lib.cullavo_focal_ctx.argtypes = _build.SIGNATURES["cullavo_focal_ctx"]
    lib.cullavo_focal_ctx.restype = ctypes.c_int
    lib.cullavo_focal_phases.argtypes = [ctypes.c_void_p]
    lib.cullavo_focal_phases.restype = ctypes.c_int
    _build._lib = lib
    return lib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", choices=tuple(VARIANTS), default="base")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("focal_phases: needs a CUDA card")
    sys.path.insert(0, ROOT)
    from cullavo_tpu_torch.ops import focal

    device = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    with tempfile.TemporaryDirectory(prefix="focal_phases_") as work:
        lib = build(args.variant, work)
        g = torch.Generator(device=device).manual_seed(0)
        L = len(KERNELS)
        for H, W, C in STAGES:
            fx = torch.randn((8, 2 * C + L + 1, H * W), generator=g,
                             device=device).to(torch.bfloat16)
            taps = torch.cat([torch.randn((C, k * k), generator=g, device=device) * (0.6 / k)
                              for k in KERNELS], dim=1)
            for _ in range(3):   # the last call's stamps stay
                focal.focal_ctx_kernel(fx[:, C:2 * C], fx[:, 2 * C:], taps, H, W, KERNELS, True,
                                       True)
            torch.cuda.synchronize(device)
            stamps = np.zeros(MAX_BLOCKS * 8, dtype=np.uint64)
            if lib.cullavo_focal_phases(stamps.ctypes.data) != 0:
                raise RuntimeError("focal_phases: reading the stamps failed")
            plan = focal.focal_plan(H, W, C, KERNELS, focal.FOCAL_SMEM, 8, sms)
            blocks = min(plan["ctas"], MAX_BLOCKS)
            cycles = np.diff(stamps.reshape(-1, 8)[:blocks].astype(np.int64), axis=1)
            print(json.dumps({"variant": args.variant, "stage": f"[8,{C},{H}x{W}]",
                              "planes": plan["planes"], "ns": plan["ns"], "blocks": blocks,
                              "cycles": {p: round(float(c), 1)
                                         for p, c in zip(PHASES, cycles.mean(axis=0))},
                              "total": round(float(cycles.sum(axis=1).mean()), 1)}), flush=True)


if __name__ == "__main__":
    main()
