"""The gated focal-modulation context of a FocalNet block (counterpart of
``cullavo_tpu/ops/focal_pallas.py``).

``focal_ctx_plain(ctx, gates, level_weights, H, W, kernels, scaling,
approximate)``: ctx ``[B, C, H*W]``, gates ``[B, L+1, H*W]``, level_weights
``[C, sum(k^2)]`` (each level's k x k depthwise taps, row-major, levels
concatenated: ``pack_level_weights``).  Per level a zero-padded depthwise
conv (no bias), then GELU, gated and summed; then the gated GELU of the
last level's spatial mean; then ``/ (L + 1)`` when ``scaling``.  All of it
in f32 with one rounding to ctx's dtype, as the TPU kernel does.  GELU is
the tanh form for ``approximate=True`` (the TPU kernel's only form, and the
bf16 model's), the erf form otherwise (the f32 model's).

``focal_ctx_kernel`` is K10 (``csrc/focal_ctx.cu``, counted on
``focal_ctx_kernel.launches``): the plain version for a tensor on the CPU,
the kernel for a CUDA tensor (bf16 or f32, any map size, 1 to 8 levels of
odd k), and it raises on any other device.  There is no size guard and no
opt-out: on the card every FocalNet block launches K10.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from cullavo_tpu_torch import _build


def pack_level_weights(level_kernels) -> torch.Tensor:
    """Depthwise kernels ``[C, 1, k, k]`` (one per level) -> f32
    ``[C, sum(k^2)]`` with the taps of each level row-major (dy, dx)."""
    return torch.cat([k.reshape(k.shape[0], -1).float() for k in level_kernels], dim=1)


def gelu(x, approximate: bool):
    """GELU in its tanh form (``approximate``) or its erf form."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def focal_ctx_plain(ctx, gates, level_weights, H: int, W: int, kernels, scaling: bool,
                    approximate: bool):
    """The plain version: cuDNN's depthwise conv on the CPU or the card."""
    B, C, HW = ctx.shape
    L = len(kernels)
    x = ctx.float().reshape(B, C, H, W)
    g = gates.float().reshape(B, L + 1, H, W)
    acc = torch.zeros_like(x)
    col = 0
    for lvl, k in enumerate(kernels):
        taps = level_weights[:, col:col + k * k].float().reshape(C, 1, k, k)
        col += k * k
        x = gelu(F.conv2d(x, taps, padding=k // 2, groups=C), approximate)
        acc = acc + x * g[:, lvl:lvl + 1]
    glob = gelu(x.mean(dim=(2, 3), keepdim=True), approximate)
    acc = acc + glob * g[:, L:L + 1]
    if scaling:
        acc = acc / (L + 1)
    return acc.reshape(B, C, HW).to(ctx.dtype)


def focal_ctx_kernel(ctx, gates, level_weights, H: int, W: int, kernels, scaling: bool,
                     approximate: bool):
    """K10 on CUDA tensors, the plain version on CPU tensors; same contract
    as ``focal_ctx_plain``."""
    if ctx.device.type == "cpu":
        return focal_ctx_plain(ctx, gates, level_weights, H, W, kernels, scaling, approximate)
    if ctx.device.type != "cuda":
        raise ValueError(f"focal_ctx_kernel: unsupported device {ctx.device}")
    return _focal_ctx_cuda(ctx, gates, level_weights, H, W, tuple(kernels), scaling,
                           approximate)


focal_ctx_kernel.launches = 0


def _focal_ctx_cuda(ctx, gates, level_weights, H, W, kernels, scaling, approximate):
    B, C, HW = ctx.shape
    L = len(kernels)
    if ctx.dtype not in (torch.bfloat16, torch.float32) or gates.dtype != ctx.dtype:
        raise ValueError(f"focal_ctx_kernel: ctx and gates must be both bf16 or both f32, "
                         f"got {ctx.dtype} and {gates.dtype}")
    if HW != H * W or gates.shape != (B, L + 1, HW):
        raise ValueError(f"focal_ctx_kernel: ctx {tuple(ctx.shape)} / gates "
                         f"{tuple(gates.shape)} do not match H={H} W={W} L={L}")
    if level_weights.shape != (C, sum(k * k for k in kernels)):
        raise ValueError("focal_ctx_kernel: level_weights must be [C, sum(k^2)]")
    for t in (gates, level_weights):
        if t.device != ctx.device:
            raise ValueError("focal_ctx_kernel: inputs on different devices")
    if ctx.stride(2) != 1:
        ctx = ctx.contiguous()
    if gates.stride(2) != 1:
        gates = gates.contiguous()
    taps = level_weights.float().contiguous()
    ks = (ctypes.c_int * L)(*[int(k) for k in kernels])
    lib = _build.lib()
    n_tiles = lib.cullavo_focal_ctx_tiles(ctypes.addressof(ks), L, H, W)
    if n_tiles < 0:
        raise ValueError(f"focal_ctx_kernel: the kernel takes 1 to 8 levels of odd k whose "
                         f"halo fits a 16-pixel tile, got {kernels}")
    acc = torch.empty((B, C, HW), dtype=torch.float32, device=ctx.device)
    partial = torch.empty((B, C, n_tiles), dtype=torch.float32, device=ctx.device)
    out = torch.empty((B, C, HW), dtype=ctx.dtype, device=ctx.device)
    err = lib.cullavo_focal_ctx(
        ctx.data_ptr(), gates.data_ptr(), taps.data_ptr(), acc.data_ptr(), partial.data_ptr(),
        out.data_ptr(), ctypes.addressof(ks), L, B, C, H, W, ctx.stride(0), ctx.stride(1),
        gates.stride(0), gates.stride(1), int(scaling), int(not approximate),
        int(ctx.dtype == torch.bfloat16), torch.cuda.current_stream(ctx.device).cuda_stream)
    _build.check(err, "focal_ctx_kernel")
    focal_ctx_kernel.launches += 1
    return out
