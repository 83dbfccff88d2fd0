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
odd k), and it raises on any other device.  It is a
``torch.autograd.Function``: the backward differentiates the plain version
on the saved inputs, as the JAX kernel's custom VJP differentiates its XLA
chain; a launch that would return an output with no gradient raises.  There is no size guard and no
opt-out: on the card every FocalNet block launches K10.  ``focal_plan``
(pure, cached) lays the launch out: whole planes a block where a plane and
its zero ring fit in shared memory (one kernel, nothing but the output
allocated), tiles with a halo and a second, elementwise pass where not.
"""
from __future__ import annotations

import ctypes
import functools

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


# the kernel's fixed shape (csrc/focal_ctx.cu): threads a block, outputs a
# slot (a thread's column strip), slots a thread, and the shared memory a
# block may take on the H100 (and H200): 227 KB
FOCAL_THREADS = 512
FOCAL_SLOT_ROWS = 16
FOCAL_MAX_SLOTS = 3
FOCAL_SMEM = 232448
_FOCAL_TILES = (128, 112, 96, 80, 64, 48, 32, 16)   # tiled path: tile sides, widest first


def _focal_levels(kernels) -> tuple:
    ks = tuple(int(k) for k in kernels)
    if not 1 <= len(ks) <= 8 or any(k < 1 or k % 2 == 0 for k in ks):
        raise ValueError(f"focal_plan: the kernel takes 1 to 8 levels of odd k, got {ks}")
    return ks


def _focal_layout(wh, ww, planes, ring, tap_pitch):
    """(bytes, gap, pitch, cols) of a block's shared memory for ``planes``
    windows of wh x ww: two column-major buffers of ``cols`` columns (the
    window and a zero ring of ``ring`` columns each side) of ``pitch`` floats
    (the planes stacked with ``gap`` zero rows between and around them, the
    last plane's overhang to whole 16-row groups and the 16-byte strips'
    overreach of 4 rows), the planes' taps and their sums.  Plane rows start
    at multiples of 4 (gap and wh + gap) where wh allows, so a strip is six
    16-byte loads; a pitch of 4 modulo 8 floats puts any 8 consecutive
    columns' 16-byte loads on distinct banks."""
    gap = -(-ring // 4) * 4
    groups = -(-wh // FOCAL_SLOT_ROWS)
    rows = gap + planes * (wh + gap) + groups * FOCAL_SLOT_ROWS - wh + 4
    pitch = rows + (4 - rows) % 8
    cols = ww + 2 * ring
    return 4 * (2 * cols * pitch + planes * (tap_pitch + FOCAL_THREADS // 32)), gap, pitch, cols


@functools.lru_cache(maxsize=None)
def focal_plan(H: int, W: int, C: int, kernels, smem_bytes: int = FOCAL_SMEM, batch: int = 1,
               sms: int = 132) -> dict:
    """The launch of K10 for ``batch`` x ``C`` planes of H x W on a card of
    ``sms`` SMs whose blocks may take ``smem_bytes`` of shared memory, as a
    pure function.  ``path`` "one_pass": ``planes`` whole planes of one b a
    block (the count that minimises waves x slots a thread, then the most
    planes: a block's prologue and reductions are paid once for all of
    them); "tiled" where no plane fits: one tile of one
    plane a block, the widest square tile whose window (the tile and the
    halo of every level's radius, clipped to the map) fits.  ``tiles``:
    each block's output rectangle (y0, x0, h, w) of the map; ``channels``:
    each block's channel range; ``ns``: slots a thread; ``smem``: bytes a
    block.  Raises on what the kernel does not take."""
    ks = _focal_levels(kernels)
    if min(H, W, C, batch, sms) < 1:
        raise ValueError(f"focal_plan: no plan for H={H} W={W} C={C} batch={batch} sms={sms}")
    ring, halo = max(k // 2 for k in ks), sum(k // 2 for k in ks)
    tap_pitch = -(-sum(k * k for k in ks) // 16) * 16
    tap_pitch += 16 if tap_pitch % 32 == 0 else 0
    cap = FOCAL_THREADS * FOCAL_MAX_SLOTS
    per_plane = -(-H // FOCAL_SLOT_ROWS) * W

    def plan(path, planes, th, tw, wh, ww, layout):
        n, gap, pitch, cols = layout
        slots = planes * -(-wh // FOCAL_SLOT_ROWS) * ww
        tiles = tuple((y, x, min(th, H - y), min(tw, W - x))
                      for y in range(0, H, th) for x in range(0, W, tw))
        channels = tuple((c, min(c + planes, C)) for c in range(0, C, planes))
        return dict(path=path, planes=planes, tile=(th, tw), window=(wh, ww), gap=gap,
                    pitch=pitch, cols=cols, ring=ring, halo=halo, smem=n, slots=slots,
                    ns=-(-slots // FOCAL_THREADS), threads=FOCAL_THREADS, tiles=tiles,
                    channels=channels, ctas=batch * len(tiles) * len(channels))

    best = None
    for planes in range(1, C + 1):
        if planes * per_plane > cap:
            break
        layout = _focal_layout(H, W, planes, ring, tap_pitch)
        if layout[0] > smem_bytes:
            break
        ns = -(-planes * per_plane // FOCAL_THREADS)
        waves = -(-batch * -(-C // planes) // sms)
        key = (waves * ns, -planes)
        if best is None or key < best[0]:
            best = (key, planes, layout)
    if best is not None:
        return plan("one_pass", best[1], H, W, H, W, best[2])
    for side in _FOCAL_TILES:
        th, tw = min(side, H), min(side, W)
        wh, ww = min(H, th + 2 * halo), min(W, tw + 2 * halo)
        if -(-wh // FOCAL_SLOT_ROWS) * ww > cap:
            continue
        layout = _focal_layout(wh, ww, 1, ring, tap_pitch)
        if layout[0] <= smem_bytes:
            return plan("tiled", 1, th, tw, wh, ww, layout)
    raise ValueError(f"focal_plan: levels {ks} (halo {halo}) leave no tile of H={H} W={W} "
                     f"within {smem_bytes} bytes of shared memory")


def focal_ctx_kernel(ctx, gates, level_weights, H: int, W: int, kernels, scaling: bool,
                     approximate: bool):
    """K10 on CUDA tensors, the plain version on CPU tensors; same contract
    as ``focal_ctx_plain``.  Differentiable in ctx, gates and
    level_weights: the backward differentiates ``focal_ctx_plain`` on the
    saved inputs (the JAX kernel's custom VJP, an XLA backward)."""
    if ctx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"focal_ctx_kernel: unsupported device {ctx.device}")
    return _FocalCtx.apply(ctx, gates, level_weights, H, W, tuple(int(k) for k in kernels),
                           bool(scaling), bool(approximate))


focal_ctx_kernel.launches = 0


class _FocalCtx(torch.autograd.Function):
    """K10 (or, on the CPU, the plain version) forward; the plain
    version's autograd backward, with the incoming gradient cast to ctx's
    dtype."""

    @staticmethod
    def forward(fctx, ctx, gates, level_weights, H, W, kernels, scaling, approximate):
        fctx.save_for_backward(ctx, gates, level_weights)
        fctx.meta = (H, W, kernels, scaling, approximate)
        if ctx.device.type == "cpu":
            return focal_ctx_plain(ctx, gates, level_weights, H, W, kernels, scaling,
                                   approximate)
        return _focal_ctx_cuda(ctx, gates, level_weights, H, W, kernels, scaling, approximate)

    @staticmethod
    def backward(fctx, grad):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(fctx.saved_tensors, fctx.needs_input_grad[:3])]
        with torch.enable_grad():
            out = focal_ctx_plain(*inputs, *fctx.meta)
        wanted = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad(out, wanted, grad.to(out.dtype)) if wanted else ())
        return tuple(next(got) if t.requires_grad else None for t in inputs) + (None,) * 5


def _focal_ctx_cuda(ctx, gates, level_weights, H, W, kernels, scaling, approximate):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (ctx, gates, level_weights)):
        raise RuntimeError("focal_ctx_kernel: a launch outside its autograd Function would "
                           "return an output with no gradient")
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
    plan = focal_plan(H, W, C, kernels, FOCAL_SMEM, B,
                      torch.cuda.get_device_properties(ctx.device).multi_processor_count)
    ks = (ctypes.c_int * L)(*[int(k) for k in kernels])
    lib = _build.lib()
    out = torch.empty((B, C, HW), dtype=ctx.dtype, device=ctx.device)
    acc = partial = None
    if plan["path"] == "tiled":   # the second pass's inputs
        acc = torch.empty((B, C, HW), dtype=torch.float32, device=ctx.device)
        partial = torch.empty((B, C, len(plan["tiles"])), dtype=torch.float32, device=ctx.device)
    err = lib.cullavo_focal_ctx(
        ctx.data_ptr(), gates.data_ptr(), taps.data_ptr(), None if acc is None else acc.data_ptr(),
        None if partial is None else partial.data_ptr(), out.data_ptr(), ctypes.addressof(ks), L,
        B, C, H, W, ctx.stride(0), ctx.stride(1), gates.stride(0), gates.stride(1), int(scaling),
        int(not approximate), int(ctx.dtype == torch.bfloat16), plan["planes"], *plan["tile"],
        plan["gap"], plan["pitch"], plan["ns"], torch.cuda.current_stream(ctx.device).cuda_stream)
    _build.check(err, "focal_ctx_kernel")
    focal_ctx_kernel.launches += 1
    return out
