"""Deformable-attention pixel decoder (counterpart of
``cullavo_tpu/models/xdecoder/deform_encoder.py``): 1x1 projections (with
GroupNorm) of res3..res5, a 6-layer deformable-attention encoder over the
three levels together (8 heads, 4 points per level, level embeddings in the
positional stream, reference points at pixel centers), then an FPN step
with res2 for the mask features.  Each layer's attention is
``ops.msdeform.msdeform_attn_module_forward``, whose core is K9 on the card.

Channels-first maps ``[B, C, H, W]``; convolution kernels ``[out, in, k, k]``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from cullavo_tpu_torch.models.llava.clip_vit import layer_norm
from cullavo_tpu_torch.models.xdecoder.decoder import resize, sine_position_embedding
from cullavo_tpu_torch.models.xdecoder.fpn import conv, conv_kernel, group_norm
from cullavo_tpu_torch.ops.msdeform import msdeform_attn_module_forward

N_LEVELS = 3   # res5, res4, res3


@dataclasses.dataclass(frozen=True)
class DeformEncoderConfig:
    in_channels: Sequence[int] = (192, 384, 768, 1536)  # res2..res5
    conv_dim: int = 512
    mask_dim: int = 512
    num_layers: int = 6
    num_heads: int = 8
    num_points: int = 4
    ffn_dim: int = 1024
    gn_groups: int = 32
    layer_norm_eps: float = 1e-5


def _offset_bias(cfg: DeformEncoderConfig):
    """Deformable-DETR offset init: per head a direction on the unit square's
    boundary, scaled by the point index."""
    H, L, P = cfg.num_heads, N_LEVELS, cfg.num_points
    thetas = np.arange(H) * (2 * np.pi / H)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    bias = np.tile(grid[:, None, None, :], (1, L, P, 1))
    for p in range(P):
        bias[:, :, p] *= (p + 1)
    return bias.reshape(-1)


def init_deform_encoder_params(cfg: DeformEncoderConfig, gen: torch.Generator, device,
                               dtype=torch.float32) -> dict:
    D = cfg.conv_dim
    HLP = cfg.num_heads * N_LEVELS * cfg.num_points

    def dense(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.02).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def norm():
        return {"scale": torch.ones((D,), dtype=dtype, device=device), "bias": zeros(D)}

    params: dict = {
        "input_proj": [{"kernel": conv_kernel(gen, 1, cin, D, device, dtype), "bias": zeros(D),
                        "norm": norm()} for cin in cfg.in_channels[1:]],
        "level_embed": dense(N_LEVELS, D),
        "layers": [],
        "lateral": {"kernel": conv_kernel(gen, 1, cfg.in_channels[0], D, device, dtype),
                    "bias": zeros(D), "norm": norm()},
        "output": {"kernel": conv_kernel(gen, 3, D, D, device, dtype), "bias": zeros(D),
                   "norm": norm()},
        "mask_features": {"kernel": conv_kernel(gen, 1, D, cfg.mask_dim, device, dtype),
                          "bias": zeros(cfg.mask_dim)},
    }
    offset_b = torch.as_tensor(_offset_bias(cfg), dtype=torch.float32, device=device).to(dtype)
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "attn": {"value_proj": {"w": dense(D, D), "b": zeros(D)},
                     "offset": {"w": zeros(D, 2 * HLP), "b": offset_b.clone()},
                     "weight": {"w": zeros(D, HLP), "b": zeros(HLP)},
                     "output": {"w": dense(D, D), "b": zeros(D)}},
            "ln1_s": torch.ones((D,), dtype=dtype, device=device), "ln1_b": zeros(D),
            "fc1_w": dense(D, cfg.ffn_dim), "fc1_b": zeros(cfg.ffn_dim),
            "fc2_w": dense(cfg.ffn_dim, D), "fc2_b": zeros(D),
            "ln2_s": torch.ones((D,), dtype=dtype, device=device), "ln2_b": zeros(D)})
    return params


def deform_encoder_forward(params, cfg: DeformEncoderConfig, features: dict):
    """features {"res2".."res5": [B, C, H, W]} -> (mask_features, the res5
    encoder output, the pyramid [res5', res4', res3'])."""
    eps = cfg.layer_norm_eps
    D = cfg.conv_dim
    srcs, poss, shapes = [], [], []
    for i, name in enumerate(["res5", "res4", "res3"]):       # coarse to fine
        proj = params["input_proj"][2 - i]                      # stored res3..res5
        x = group_norm(conv(features[name], proj), proj["norm"]["scale"],
                       proj["norm"]["bias"], cfg.gn_groups)
        B, _, H, W = x.shape
        # the level embedding joins the positional stream (the query), not the value
        pos = sine_position_embedding(H, W, D, x.device) + params["level_embed"][i].float()
        srcs.append(x.reshape(B, D, H * W).transpose(1, 2))
        poss.append(pos.to(x.dtype)[None].expand(B, H * W, D))
        shapes.append((H, W))
    src = torch.cat(srcs, dim=1)
    pos = torch.cat(poss, dim=1)
    B = src.shape[0]

    # reference points: each level's pixel centers, normalized, shared by all levels
    refs = []
    for (H, W) in shapes:
        ys = (torch.arange(H, dtype=torch.float32, device=src.device) + 0.5) / H
        xs = (torch.arange(W, dtype=torch.float32, device=src.device) + 0.5) / W
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        refs.append(torch.stack([xx, yy], -1).reshape(-1, 2))
    ref = torch.cat(refs, dim=0)[None, :, None, :].expand(B, -1, N_LEVELS, 2)

    x = src
    for lw in params["layers"]:
        attn_out = msdeform_attn_module_forward(lw["attn"], x + pos, x, shapes, ref,
                                                cfg.num_heads, N_LEVELS, cfg.num_points)
        x = layer_norm(x + attn_out, lw["ln1_s"], lw["ln1_b"], eps)
        y = torch.relu(x @ lw["fc1_w"] + lw["fc1_b"]) @ lw["fc2_w"] + lw["fc2_b"]
        x = layer_norm(x + y, lw["ln2_s"], lw["ln2_b"], eps)

    outs, offset = [], 0
    for (H, W) in shapes:
        outs.append(x[:, offset:offset + H * W].transpose(1, 2).reshape(B, D, H, W))
        offset += H * W

    # FPN step with res2 for the mask features
    lat = params["lateral"]
    cur = group_norm(conv(features["res2"], lat), lat["norm"]["scale"], lat["norm"]["bias"],
                     cfg.gn_groups)
    up = resize(outs[-1], cur.shape[-2:], "bilinear")
    oc = params["output"]
    y = torch.relu(group_norm(conv(cur + up, oc), oc["norm"]["scale"], oc["norm"]["bias"],
                              cfg.gn_groups))
    return conv(y, params["mask_features"]), outs[0], outs
