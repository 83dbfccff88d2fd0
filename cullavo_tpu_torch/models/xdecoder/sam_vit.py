"""SAM-ViT backbone, ViTDet style (counterpart of
``cullavo_tpu/models/xdecoder/sam_vit.py``): 16x16 patch embedding plus an
absolute position embedding (bilinearly resized to the patch grid),
transformer blocks with windowed attention (global at the configured
indexes) and the decomposed relative-position bias, then the SimpleFPN neck
that turns the stride-16 map into {res2..res5}.

The blocks run on ``[B, H, W, D]`` tokens as in JAX; the neck and the
returned maps are channels-first ``[B, C, H, W]``.  Kernels: patch and neck
convolutions ``[out, in, k, k]``, transposed convolutions ``[in, out, 2,
2]`` (PyTorch's layouts; ``checkpoint/from_jax.py`` converts).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from cullavo_tpu_torch.models.llava.clip_vit import layer_norm
from cullavo_tpu_torch.models.xdecoder.decoder import resize


@dataclasses.dataclass(frozen=True)
class SamVitConfig:
    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 768            # SAM-ViT-B
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    window_size: int = 14
    global_attn_indexes: Sequence[int] = (2, 5, 8, 11)
    use_rel_pos: bool = True
    out_dims: Sequence[int] = (128, 256, 512, 1024)
    layer_norm_eps: float = 1e-6


def init_sam_vit_params(cfg: SamVitConfig, gen: torch.Generator, device,
                        dtype=torch.float32) -> dict:
    D = cfg.embed_dim
    hd = D // cfg.num_heads
    grid = cfg.img_size // cfg.patch_size
    hidden = int(D * cfg.mlp_ratio)

    def dense(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.02).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    params = {"patch_embed": {"kernel": dense(D, 3, cfg.patch_size, cfg.patch_size),
                              "bias": zeros(D)},
              "pos_embed": dense(grid, grid, D), "blocks": []}
    for i in range(cfg.depth):
        size = grid if i in cfg.global_attn_indexes else cfg.window_size
        params["blocks"].append({
            "ln1_s": ones(D), "ln1_b": zeros(D),
            "qkv_w": dense(D, 3 * D), "qkv_b": zeros(3 * D),
            "proj_w": dense(D, D), "proj_b": zeros(D),
            "rel_h": zeros(2 * size - 1, hd), "rel_w": zeros(2 * size - 1, hd),
            "ln2_s": ones(D), "ln2_b": zeros(D),
            "fc1_w": dense(D, hidden), "fc1_b": zeros(hidden),
            "fc2_w": dense(hidden, D), "fc2_b": zeros(D)})
    d4c = max(cfg.out_dims[0] * 2, D // 2)
    d8c = max(cfg.out_dims[1], D // 2)
    d32c = max(cfg.out_dims[3], D * 2)

    def conv_t(cin, cout):
        return {"kernel": dense(cin, cout, 2, 2), "bias": zeros(cout)}

    def conv(cin, cout, k=1):
        return {"kernel": dense(cout, cin, k, k), "bias": zeros(cout)}

    def gn(c):
        return {"scale": ones(c), "bias": zeros(c)}

    od = cfg.out_dims
    params["neck"] = {
        "down4": {"up1": conv_t(D, d4c), "gn1": gn(d4c), "up2": conv_t(d4c, d4c // 2),
                  "gn2": gn(d4c // 2), "conv": conv(d4c // 2, od[0]), "gn3": gn(od[0])},
        "down8": {"up1": conv_t(D, d8c), "gn1": gn(d8c), "conv": conv(d8c, od[1]),
                  "gn2": gn(od[1])},
        "down16": {"conv": conv(D, od[2]), "gn": gn(od[2])},
        "down32": {"conv1": conv(D, d32c, k=2), "gn1": gn(d32c), "conv2": conv(d32c, od[3]),
                   "gn2": gn(od[3])},
    }
    return params


def _rel_pos_bias(q, rel_h, rel_w, H, W):
    """Decomposed relative-position bias for q [Bn, H*W, hd] -> f32
    [Bn, H*W, H*W]: bias[b, (i, j), (kh, kw)] = q . Rh[i, kh] + q . Rw[j, kw]."""
    def get(rel, S):
        idx = (torch.arange(S, device=q.device)[:, None]
               - torch.arange(S, device=q.device)[None, :]) + (S - 1)
        return rel[idx].float()                                  # [S, S, hd]

    Bn = q.shape[0]
    r_q = q.float().reshape(Bn, H, W, -1)
    rel_h_term = torch.einsum("bhwc,hkc->bhwk", r_q, get(rel_h, H))
    rel_w_term = torch.einsum("bhwc,wkc->bhwk", r_q, get(rel_w, W))
    bias = rel_h_term[:, :, :, :, None] + rel_w_term[:, :, :, None, :]
    return bias.reshape(Bn, H * W, H * W)


def _attn(x, w, heads, use_rel_pos):
    """x [Bn, H, W, C] (a window or the whole map)."""
    Bn, H, W, C = x.shape
    hd = C // heads
    qkv = x.reshape(Bn, H * W, C) @ w["qkv_w"] + w["qkv_b"]
    qkv = qkv.reshape(Bn, H * W, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv.reshape(3, Bn * heads, H * W, hd)
    s = torch.matmul((q * (hd ** -0.5)).float(), k.float().transpose(-1, -2))
    if use_rel_pos:
        s = s + _rel_pos_bias(q, w["rel_h"], w["rel_w"], H, W)
    p = torch.softmax(s, dim=-1).to(x.dtype)
    o = torch.matmul(p.float(), v.float()).to(x.dtype)
    o = o.reshape(Bn, heads, H, W, hd).permute(0, 2, 3, 1, 4).reshape(Bn, H, W, C)
    return o @ w["proj_w"] + w["proj_b"]


def sam_vit_forward(params, cfg: SamVitConfig, images) -> dict:
    """images [B, 3, H, W] -> {"res2".."res5": [B, C, h, w]}."""
    eps = cfg.layer_norm_eps
    pe = params["patch_embed"]
    x = F.conv2d(images, pe["kernel"], pe["bias"], stride=cfg.patch_size)
    B, D, H, W = x.shape
    pos = params["pos_embed"]
    if tuple(pos.shape[:2]) != (H, W):
        pos = resize(pos.permute(2, 0, 1)[None], (H, W), "bilinear")[0].permute(1, 2, 0)
    x = x.permute(0, 2, 3, 1) + pos[None]
    for i, w in enumerate(params["blocks"]):
        shortcut = x
        y = layer_norm(x, w["ln1_s"], w["ln1_b"], eps)
        if i in cfg.global_attn_indexes:
            y = _attn(y, w, cfg.num_heads, cfg.use_rel_pos)
        else:
            ws = cfg.window_size
            pad_b, pad_r = (-H) % ws, (-W) % ws
            yp = F.pad(y, (0, 0, 0, pad_r, 0, pad_b))
            nh, nw = (H + pad_b) // ws, (W + pad_r) // ws
            yw = yp.reshape(B, nh, ws, nw, ws, D).permute(0, 1, 3, 2, 4, 5)
            yw = _attn(yw.reshape(B * nh * nw, ws, ws, D), w, cfg.num_heads, cfg.use_rel_pos)
            yw = yw.reshape(B, nh, nw, ws, ws, D).permute(0, 1, 3, 2, 4, 5)
            y = yw.reshape(B, H + pad_b, W + pad_r, D)[:, :H, :W]
        x = shortcut + y
        y = layer_norm(x, w["ln2_s"], w["ln2_b"], eps)
        x = x + (F.gelu(y @ w["fc1_w"] + w["fc1_b"]) @ w["fc2_w"] + w["fc2_b"])
    return simple_fpn_forward(params["neck"], x.permute(0, 3, 1, 2))


def _group_norm1(x, p, eps=1e-5):
    """GroupNorm(1, C): normalization over (C, H, W) per sample."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2, 3), keepdim=True)
    var = xf.var(dim=(1, 2, 3), keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"].float()[None, :, None, None]
            + p["bias"].float()[None, :, None, None]).to(x.dtype)


def _conv_t(x, p):
    return F.conv_transpose2d(x, p["kernel"], p["bias"], stride=2)


def _conv(x, p, stride=1):
    return F.conv2d(x, p["kernel"], p["bias"], stride=stride)


def simple_fpn_forward(neck, x):
    """SimpleFPN: one stride-16 map [B, D, H, W] -> the 4-level pyramid."""
    g = F.gelu
    d4 = neck["down4"]
    y = g(_group_norm1(_conv_t(x, d4["up1"]), d4["gn1"]))
    y = _group_norm1(_conv_t(y, d4["up2"]), d4["gn2"])
    res2 = g(_group_norm1(_conv(y, d4["conv"]), d4["gn3"]))
    d8 = neck["down8"]
    y = _group_norm1(_conv_t(x, d8["up1"]), d8["gn1"])
    res3 = g(_group_norm1(_conv(y, d8["conv"]), d8["gn2"]))
    d16 = neck["down16"]
    res4 = g(_group_norm1(_conv(x, d16["conv"]), d16["gn"]))
    d32 = neck["down32"]
    y = _group_norm1(_conv(x, d32["conv1"], stride=2), d32["gn1"])
    res5 = g(_group_norm1(_conv(y, d32["conv2"]), d32["gn2"]))
    return {"res2": res2, "res3": res3, "res4": res4, "res5": res5}
