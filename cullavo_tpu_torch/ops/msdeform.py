"""Multi-scale deformable attention (counterpart of ``cullavo_tpu/ops/msdeform.py``
and ``cullavo_tpu/ops/msdeform_pallas.py``).

``ms_deform_attn(value, spatial_shapes, sampling_locations,
attention_weights)``: value ``[B, S, Hh, hd]`` (the levels' maps flattened
and concatenated), locations ``[B, Q, Hh, L, P, 2]`` in [0, 1] as (x, y),
weights ``[B, Q, Hh, L, P]``; returns ``[B, Q, Hh * hd]`` in the value's
dtype.  Bilinear sampling with grid_sample's ``align_corners=False``
convention (x = loc_x * W - 0.5); corners outside a map contribute zero;
the weighted sum over levels and points is taken in f32.

``ms_deform_attn_kernel`` is K9 (``csrc/msdeform.cu``, counted on
``ms_deform_attn_kernel.launches``): the plain version for a tensor on the
CPU, the kernel for a CUDA tensor (bf16 or f32 value, head dim 32, 64 or
128, up to 8 levels, weights in bf16 or f32 read as they are), and it raises
on any other device.  It is a ``torch.autograd.Function`` whose backward
differentiates the plain version on the saved inputs (the JAX kernel's
custom VJP); a launch that would return an output with no gradient
raises.  There is no size guard and no opt-out: on the card
the module always launches K9.  ``msdeform_plan`` (pure) picks K9's query
tiles and grid.
``msdeform_attn_module_forward`` is the MSDeformAttn module around it.
"""
from __future__ import annotations

import ctypes

import torch

from cullavo_tpu_torch import _build


def _bilinear_sample_level(value_lvl, loc):
    """value_lvl [B, H, W, Hh, hd]; loc [B, Q, Hh, P, 2] (x, y) in [0, 1] ->
    [B, Q, Hh, P, hd] in f32."""
    B, Hl, Wl, Hh, hd = value_lvl.shape
    _, Q, _, P, _ = loc.shape
    x = loc[..., 0].float() * Wl - 0.5
    y = loc[..., 1].float() * Hl - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    fl = value_lvl.reshape(B, Hl * Wl, Hh, hd).permute(0, 2, 1, 3)      # [B, Hh, HW, hd]

    def gather(yy, xx):
        yc = yy.clamp(0, Hl - 1).long()
        xc = xx.clamp(0, Wl - 1).long()
        idx = (yc * Wl + xc).permute(0, 2, 1, 3).reshape(B, Hh, Q * P, 1)
        got = torch.gather(fl, 2, idx.expand(B, Hh, Q * P, hd))
        got = got.reshape(B, Hh, Q, P, hd).permute(0, 2, 1, 3, 4)
        valid = (yy >= 0) & (yy <= Hl - 1) & (xx >= 0) & (xx <= Wl - 1)
        return got * valid[..., None].to(got.dtype)

    v00, v01 = gather(y0, x0), gather(y0, x0 + 1)
    v10, v11 = gather(y0 + 1, x0), gather(y0 + 1, x0 + 1)
    return (v00 * (1 - wx) + v01 * wx) * (1 - wy) + (v10 * (1 - wx) + v11 * wx) * wy


def ms_deform_attn(value, spatial_shapes, sampling_locations, attention_weights):
    """The plain version (the JAX package's XLA gather): returns
    [B, Q, Hh * hd] in value's dtype."""
    B, S, Hh, hd = value.shape
    Q = sampling_locations.shape[1]
    out = torch.zeros((B, Q, Hh, hd), dtype=torch.float32, device=value.device)
    offset = 0
    for lvl, (Hl, Wl) in enumerate(spatial_shapes):
        v = value[:, offset:offset + Hl * Wl].reshape(B, Hl, Wl, Hh, hd)
        sampled = _bilinear_sample_level(v, sampling_locations[:, :, :, lvl])
        w = attention_weights[:, :, :, lvl][..., None].float()
        out = out + (sampled * w).sum(dim=3)
        offset += Hl * Wl
    return out.reshape(B, Q, Hh * hd).to(value.dtype)


def ms_deform_attn_kernel(value, spatial_shapes, sampling_locations, attention_weights):
    """K9 on CUDA tensors, the plain version on CPU tensors; same contract
    as ``ms_deform_attn``.  Differentiable in value, locations and weights:
    the backward differentiates ``ms_deform_attn`` on the saved inputs (the
    JAX kernel's custom VJP, an XLA backward)."""
    if value.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ms_deform_attn_kernel: unsupported device {value.device}")
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    return _MsDeformAttn.apply(value, shapes, sampling_locations, attention_weights)


ms_deform_attn_kernel.launches = 0


class _MsDeformAttn(torch.autograd.Function):
    """K9 (or, on the CPU, the plain version) forward; the plain version's
    autograd backward, with the incoming gradient cast to value's dtype."""

    @staticmethod
    def forward(fctx, value, spatial_shapes, loc, att):
        fctx.save_for_backward(value, loc, att)
        fctx.shapes = spatial_shapes
        if value.device.type == "cpu":
            return ms_deform_attn(value, spatial_shapes, loc, att)
        return _ms_deform_attn_cuda(value, spatial_shapes, loc, att)

    @staticmethod
    def backward(fctx, grad):
        need = (fctx.needs_input_grad[0],) + fctx.needs_input_grad[2:4]
        inputs = [t.detach().requires_grad_(n) for t, n in zip(fctx.saved_tensors, need)]
        with torch.enable_grad():
            out = ms_deform_attn(inputs[0], fctx.shapes, inputs[1], inputs[2])
        wanted = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad(out, wanted, grad.to(out.dtype)) if wanted else ())
        g_value, g_loc, g_att = (next(got) if t.requires_grad else None for t in inputs)
        return g_value, None, g_loc, g_att


# K9's block: 8 warps over a tile of 64 queries of one (b, head)
MSDEFORM_WARPS, MSDEFORM_TILE = 8, 64


def msdeform_plan(B: int, Q: int, Hh: int) -> dict:
    """K9's launch (pure): a block of ``warps`` warps serves one (b, head)
    and a tile of ``tile_q`` consecutive queries (warp w takes queries w, w
    + warps, ... of its tile), so that neighbouring queries share L1 lines;
    ``grid`` is (tiles, Hh, B)."""
    if min(B, Q, Hh) < 1:
        raise ValueError(f"msdeform_plan: needs B, Q, Hh >= 1 (B={B}, Q={Q}, Hh={Hh})")
    return {"warps": MSDEFORM_WARPS, "tile_q": MSDEFORM_TILE,
            "grid": (-(-Q // MSDEFORM_TILE), Hh, B)}


def _ms_deform_attn_cuda(value, spatial_shapes, loc, att):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (value, loc, att)):
        raise RuntimeError("ms_deform_attn_kernel: a launch outside its autograd Function "
                           "would return an output with no gradient")
    B, S, Hh, hd = value.shape
    Q = loc.shape[1]
    L = len(spatial_shapes)
    P = loc.shape[4]
    if value.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"ms_deform_attn_kernel: value must be bf16 or f32, got {value.dtype}")
    if att.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"ms_deform_attn_kernel: weights must be bf16 or f32, got {att.dtype}")
    if hd not in (32, 64, 128):
        raise ValueError(f"ms_deform_attn_kernel: the kernel takes head dim 32, 64 or 128, got {hd}")
    if not 1 <= L <= 8:
        raise ValueError(f"ms_deform_attn_kernel: the kernel takes 1 to 8 levels, got {L}")
    if sum(h * w for h, w in spatial_shapes) != S:
        raise ValueError("ms_deform_attn_kernel: the levels do not add up to S")
    if S * Hh * hd >= 2 ** 31:
        raise ValueError("ms_deform_attn_kernel: a batch's value map must hold < 2^31 elements")
    if loc.shape != (B, Q, Hh, L, P, 2) or att.shape != (B, Q, Hh, L, P):
        raise ValueError(f"ms_deform_attn_kernel: locations {tuple(loc.shape)} / weights "
                         f"{tuple(att.shape)} do not match [B, Q, Hh, L, P(, 2)]")
    for t in (loc, att):
        if t.device != value.device:
            raise ValueError("ms_deform_attn_kernel: inputs on different devices")
    value, att = value.contiguous(), att.contiguous()
    loc = loc.float().contiguous()
    if value.data_ptr() % 16:
        raise ValueError("ms_deform_attn_kernel: value must be 16-byte aligned")
    out = torch.empty((B, Q, Hh * hd), dtype=value.dtype, device=value.device)
    if B * Q == 0:
        return out
    plan = msdeform_plan(B, Q, Hh)
    shapes = (ctypes.c_int * (2 * L))(*[int(x) for hw in spatial_shapes for x in hw])
    starts, s = [], 0
    for h, w in spatial_shapes:
        starts.append(s)
        s += h * w
    starts = (ctypes.c_int * L)(*starts)
    lib = _build.lib()
    err = lib.cullavo_msdeform(
        value.data_ptr(), loc.data_ptr(), att.data_ptr(), out.data_ptr(),
        ctypes.addressof(shapes), ctypes.addressof(starts), L, B, S, Q, Hh, hd, P,
        int(value.dtype == torch.bfloat16), int(att.dtype == torch.bfloat16),
        plan["tile_q"], plan["grid"][0], torch.cuda.current_stream(value.device).cuda_stream)
    _build.check(err, "ms_deform_attn_kernel")
    ms_deform_attn_kernel.launches += 1
    return out


def msdeform_attn_module_forward(params, query, value, spatial_shapes, reference_points,
                                 num_heads: int, num_levels: int, num_points: int):
    """The full MSDeformAttn module: value/offset/weight projections around
    the core op.  params: {"value_proj", "offset", "weight", "output"}, each
    {"w" [in, out], "b"}.  query [B, Q, D]; value [B, S, D];
    reference_points [B, Q, L, 2] normalized centers (f32)."""
    B, Q, D = query.shape
    S = value.shape[1]
    hd = D // num_heads
    v = (value @ params["value_proj"]["w"] + params["value_proj"]["b"]).reshape(
        B, S, num_heads, hd)
    off = (query @ params["offset"]["w"] + params["offset"]["b"]).reshape(
        B, Q, num_heads, num_levels, num_points, 2)
    w = (query @ params["weight"]["w"] + params["weight"]["b"]).reshape(
        B, Q, num_heads, num_levels * num_points)
    w = torch.softmax(w.float(), dim=-1).to(w.dtype).reshape(
        B, Q, num_heads, num_levels, num_points)
    norm = torch.tensor([[wl, hl] for (hl, wl) in spatial_shapes], dtype=torch.float32,
                        device=query.device)
    loc = (reference_points.float()[:, :, None, :, None, :]
           + off.float() / norm[None, None, None, :, None, :])
    out = ms_deform_attn_kernel(v, spatial_shapes, loc, w)
    return out @ params["output"]["w"] + params["output"]["b"]
