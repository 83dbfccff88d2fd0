"""FocalNet backbone (counterpart of ``cullavo_tpu/models/xdecoder/focalnet.py``).

Conv-embed stem (7x7/4), four stages of focal-modulation blocks, post-LN
with layerscale and the scaled modulator, stage-end 3x3/2 conv downsampling,
a LayerNorm per output; the ``focal_dw`` variant adds the residual depthwise
3x3 convs and its own post-LN ordering.

The port runs channels-first: activations ``[B, C, H, W]``, 1x1 projections
as ``w.T @ x`` over ``[B, C, H*W]``, LayerNorm over the channel axis.  The
focal context then already lies in K10's ``[B, C, H*W]`` layout, so every
block hands its projection's slices to ``ops.focal.focal_ctx_kernel``
without a transpose.  Parameters: stacked ``[depth, ...]`` block leaves as
in JAX, linear weights ``[in, out]``; convolution kernels in PyTorch's
``[out, in/groups, k, k]`` (``checkpoint/from_jax.py`` converts).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cullavo_tpu_torch.ops.focal import focal_ctx_kernel, gelu, pack_level_weights


@dataclasses.dataclass(frozen=True)
class FocalNetConfig:
    embed_dim: int = 192
    depths: Sequence[int] = (2, 2, 18, 2)
    focal_levels: Sequence[int] = (4, 4, 4, 4)
    focal_windows: Sequence[int] = (3, 3, 3, 3)
    focal_factor: int = 2
    mlp_ratio: float = 4.0
    patch_size: int = 4
    use_conv_embed: bool = True
    use_postln: bool = True
    use_postln_in_modulation: bool = False
    use_layerscale: bool = True
    layerscale_value: float = 1e-4
    scaling_modulator: bool = True
    # GELU policy: None = tanh form for bf16 activations, exact erf for f32
    # (the JAX model's); True forces erf, False tanh
    exact_gelu: "bool | None" = None
    use_dw: bool = False
    out_indices: Sequence[int] = (0, 1, 2, 3)
    layer_norm_eps: float = 1e-5

    @property
    def num_features(self):
        return [self.embed_dim * (2 ** i) for i in range(len(self.depths))]


def init_focalnet_params(cfg: FocalNetConfig, gen: torch.Generator, device,
                         dtype=torch.float32) -> dict:
    def dense(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.02).to(dtype)

    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=device)

    def norm(c):
        return {"scale": full((c,), 1.0), "bias": full((c,), 0.0)}

    C0 = cfg.embed_dim
    k_stem = 7 if cfg.use_conv_embed else cfg.patch_size
    params: dict = {"stem": {"kernel": dense(C0, 3, k_stem, k_stem), "bias": full((C0,), 0.0),
                             "norm": norm(C0)},
                    "stages": []}
    for i, depth in enumerate(cfg.depths):
        C = cfg.num_features[i]
        L = cfg.focal_levels[i]
        hidden = int(C * cfg.mlp_ratio)
        gamma = cfg.layerscale_value if cfg.use_layerscale else 1.0
        blocks = {
            "norm1_s": full((depth, C), 1.0), "norm1_b": full((depth, C), 0.0),
            "f_w": dense(depth, C, 2 * C + L + 1), "f_b": full((depth, 2 * C + L + 1), 0.0),
            "h_w": dense(depth, C, C), "h_b": full((depth, C), 0.0),
            "proj_w": dense(depth, C, C), "proj_b": full((depth, C), 0.0),
            "norm2_s": full((depth, C), 1.0), "norm2_b": full((depth, C), 0.0),
            "fc1_w": dense(depth, C, hidden), "fc1_b": full((depth, hidden), 0.0),
            "fc2_w": dense(depth, hidden, C), "fc2_b": full((depth, C), 0.0),
            "gamma1": full((depth, C), gamma), "gamma2": full((depth, C), gamma),
        }
        for lvl in range(L):
            k = cfg.focal_factor * lvl + cfg.focal_windows[i]
            blocks[f"focal{lvl}_w"] = dense(depth, C, 1, k, k)
        if cfg.use_dw:
            for name in ("dw1", "dw2"):
                blocks[f"{name}_w"] = dense(depth, C, 1, 3, 3)
                blocks[f"{name}_b"] = full((depth, C), 0.0)
        stage = {"blocks": blocks}
        if i < len(cfg.depths) - 1:
            C2 = cfg.num_features[i + 1]
            kd = 3 if cfg.use_conv_embed else 2
            stage["downsample"] = {"kernel": dense(C2, C, kd, kd), "bias": full((C2,), 0.0),
                                   "norm": norm(C2)}
        params["stages"].append(stage)
    params["out_norms"] = {str(i): norm(cfg.num_features[i]) for i in cfg.out_indices}
    return params


def layer_norm_cf(x, scale, bias, eps):
    """LayerNorm over the channel axis of [B, C, ...] (f32 statistics, as
    the JAX ``layer_norm`` over NHWC's last axis)."""
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=1, keepdim=True)
    var = xf.var(dim=1, keepdim=True, unbiased=False)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return (xf * scale.float().reshape(shape) + bias.float().reshape(shape)).to(dtype)


def linear_cf(x, w, b):
    """A 1x1 projection of channels-first x [B, C, ...] with w [C, C_out]."""
    B, C = x.shape[:2]
    y = torch.matmul(w.t(), x.reshape(B, C, -1)) + b[:, None]
    return y.reshape(B, w.shape[1], *x.shape[2:])


def _per_channel(v):
    return v[None, :, None, None]


def _approx_gelu(dtype, exact_gelu) -> bool:
    """The GELU policy (see ``FocalNetConfig.exact_gelu``): True = tanh form."""
    if exact_gelu is None:
        return dtype == torch.bfloat16
    return not exact_gelu


def _depthwise_conv(x, kernel):
    """[B, C, H, W] depthwise conv with a [C, 1, k, k] kernel, padding k // 2."""
    return F.conv2d(x, kernel, padding=kernel.shape[-1] // 2, groups=x.shape[1])


def focal_modulation(x, w, focal_level: int, scaling_modulator: bool, exact_gelu=None):
    """x [B, C, H, W] -> [B, C, H, W]: q, context and gates from one
    projection; the gated multi-level context through K10 (its plain version
    on the CPU); modulation by the ``h`` projection; output projection."""
    B, C, H, W = x.shape
    fx = linear_cf(x, w["f_w"], w["f_b"]).reshape(B, -1, H * W)
    q, ctx, gates = fx[:, :C], fx[:, C:2 * C], fx[:, 2 * C:]
    kernels = tuple(int(w[f"focal{lvl}_w"].shape[-1]) for lvl in range(focal_level))
    taps = pack_level_weights([w[f"focal{lvl}_w"] for lvl in range(focal_level)])
    ctx_all = focal_ctx_kernel(ctx, gates, taps, H, W, kernels, scaling_modulator,
                               _approx_gelu(x.dtype, exact_gelu))
    out = q * linear_cf(ctx_all, w["h_w"], w["h_b"])
    return linear_cf(out, w["proj_w"], w["proj_b"]).reshape(B, C, H, W)


def _block(h, w, cfg: FocalNetConfig, L: int):
    eps = cfg.layer_norm_eps
    approx = _approx_gelu(h.dtype, cfg.exact_gelu)

    def mlp(y):
        return linear_cf(gelu(linear_cf(y, w["fc1_w"], w["fc1_b"]), approx),
                         w["fc2_w"], w["fc2_b"])

    if cfg.use_dw:
        h = h + _depthwise_conv(h, w["dw1_w"]) + _per_channel(w["dw1_b"])
    shortcut = h
    y = h
    if not cfg.use_postln:
        y = layer_norm_cf(y, w["norm1_s"], w["norm1_b"], eps)
    y = focal_modulation(y, w, L, cfg.scaling_modulator, exact_gelu=cfg.exact_gelu)
    if cfg.use_postln and not cfg.use_dw:
        y = layer_norm_cf(y, w["norm1_s"], w["norm1_b"], eps)    # focal.py: the branch
    h = shortcut + _per_channel(w["gamma1"]) * y
    if cfg.use_postln and cfg.use_dw:
        h = layer_norm_cf(h, w["norm1_s"], w["norm1_b"], eps)    # focal_dw.py: the sum
    if cfg.use_dw:
        h = h + _depthwise_conv(h, w["dw2_w"]) + _per_channel(w["dw2_b"])
    if cfg.use_dw and cfg.use_postln:
        h = h + _per_channel(w["gamma2"]) * mlp(h)
        return layer_norm_cf(h, w["norm2_s"], w["norm2_b"], eps)
    if cfg.use_postln:
        return h + _per_channel(w["gamma2"]) * layer_norm_cf(mlp(h), w["norm2_s"],
                                                             w["norm2_b"], eps)
    return h + _per_channel(w["gamma2"]) * mlp(layer_norm_cf(h, w["norm2_s"], w["norm2_b"], eps))


def focalnet_forward(params, cfg: FocalNetConfig, images, remat: bool = False) -> dict:
    """images [B, 3, H, W] (normalized) -> {"res2".."res5": [B, C, h, w]}.
    ``remat`` checkpoints each block (``torch.utils.checkpoint``: its
    activations, K10's launch included, are recomputed in the backward)."""
    eps = cfg.layer_norm_eps
    stem = params["stem"]
    stride = 4 if cfg.use_conv_embed else cfg.patch_size
    # padding 2 in focal.py, 3 in focal_dw.py: the same size, shifted sampling
    pad = (3 if cfg.use_dw else 2) if cfg.use_conv_embed else 0
    x = F.conv2d(images, stem["kernel"], stem["bias"], stride=stride, padding=pad)
    x = layer_norm_cf(x, stem["norm"]["scale"], stem["norm"]["bias"], eps)
    outs = {}
    for i, stage in enumerate(params["stages"]):
        blocks = stage["blocks"]
        for d in range(blocks["f_w"].shape[0]):
            w = {k: v[d] for k, v in blocks.items()}
            if remat:
                x = checkpoint(_block, x, w, cfg, cfg.focal_levels[i], use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = _block(x, w, cfg, cfg.focal_levels[i])
        if str(i) in params["out_norms"]:
            n = params["out_norms"][str(i)]
            outs[f"res{i + 2}"] = layer_norm_cf(x, n["scale"], n["bias"], eps)
        if "downsample" in stage:
            ds = stage["downsample"]
            x = F.conv2d(x, ds["kernel"], ds["bias"], stride=2,
                         padding=1 if cfg.use_conv_embed else 0)
            x = layer_norm_cf(x, ds["norm"]["scale"], ds["norm"]["bias"], eps)
    return outs
