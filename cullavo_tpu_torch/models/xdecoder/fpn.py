"""FPN pixel decoder with a transformer-encoded top level (counterpart of
``cullavo_tpu/models/xdecoder/fpn.py``): 1x1 input projection of res5, a
post-norm DETR encoder with sine positions over it, the top-down path of
1x1 laterals (GroupNorm) + nearest upsampling + 3x3 output convs
(GroupNorm, ReLU), and the 3x3 mask-features head.

Channels-first ``[B, C, H, W]``; convolution kernels ``[out, in, k, k]``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from cullavo_tpu_torch.models.llava.clip_vit import layer_norm
from cullavo_tpu_torch.models.xdecoder.decoder import resize, sine_position_embedding


@dataclasses.dataclass(frozen=True)
class FPNConfig:
    in_channels: Sequence[int] = (192, 384, 768, 1536)  # res2..res5 (FocalNet-L)
    conv_dim: int = 512
    mask_dim: int = 512
    gn_groups: int = 32
    enc_layers: int = 6
    enc_heads: int = 8
    enc_ffn: int = 2048
    layer_norm_eps: float = 1e-5


def conv_kernel(gen, k, cin, cout, device, dtype):
    """He-normal [cout, cin, k, k]."""
    fan_in = k * k * cin
    return (torch.randn((cout, cin, k, k), generator=gen, device=device)
            * (2.0 / fan_in) ** 0.5).to(dtype)


def init_fpn_params(cfg: FPNConfig, gen: torch.Generator, device, dtype=torch.float32) -> dict:
    D = cfg.conv_dim

    def dense(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.02).to(dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    def gn():
        return {"scale": ones(D), "bias": zeros(D)}

    params: dict = {
        "input_proj": {"kernel": conv_kernel(gen, 1, cfg.in_channels[-1], D, device, dtype),
                       "bias": zeros(D)},
        "encoder_layers": [],
        "output_convs": [],   # index 0 = res5 level, then res4, res3, res2
        "lateral_convs": [],  # res4, res3, res2
        "mask_features": {"kernel": conv_kernel(gen, 3, D, cfg.mask_dim, device, dtype),
                          "bias": zeros(cfg.mask_dim)},
    }
    for _ in range(cfg.enc_layers):
        params["encoder_layers"].append({
            "q_w": dense(D, D), "q_b": zeros(D), "k_w": dense(D, D), "k_b": zeros(D),
            "v_w": dense(D, D), "v_b": zeros(D), "o_w": dense(D, D), "o_b": zeros(D),
            "ln1_s": ones(D), "ln1_b": zeros(D),
            "fc1_w": dense(D, cfg.enc_ffn), "fc1_b": zeros(cfg.enc_ffn),
            "fc2_w": dense(cfg.enc_ffn, D), "fc2_b": zeros(D),
            "ln2_s": ones(D), "ln2_b": zeros(D)})
    for _ in range(4):
        params["output_convs"].append({"kernel": conv_kernel(gen, 3, D, D, device, dtype),
                                       "bias": zeros(D), "norm": gn()})
    for cin in cfg.in_channels[-2::-1]:
        params["lateral_convs"].append({"kernel": conv_kernel(gen, 1, cin, D, device, dtype),
                                        "bias": zeros(D), "norm": gn()})
    return params


def group_norm(x, scale, bias, groups: int, eps: float = 1e-5):
    """[B, C, H, W] group norm: f32 statistics, normalized value rounded to
    x's dtype, then the affine in x's dtype (the JAX order)."""
    B, C, H, W = x.shape
    g = x.reshape(B, groups, C // groups, H, W).float()
    mean = g.mean(dim=(2, 3, 4), keepdim=True)
    var = g.var(dim=(2, 3, 4), keepdim=True, unbiased=False)
    g = ((g - mean) * torch.rsqrt(var + eps)).reshape(B, C, H, W).to(x.dtype)
    return g * scale[None, :, None, None] + bias[None, :, None, None]


def conv(x, w, stride=1):
    """Conv with "SAME" padding for odd kernels at stride 1, VALID for 1x1."""
    k = w["kernel"].shape[-1]
    return F.conv2d(x, w["kernel"], w["bias"], stride=stride, padding=k // 2)


def _encoder_layer(w, x, pos, heads, eps):
    """Post-norm DETR encoder layer: q = k = x + pos, v = x."""
    B, N, D = x.shape
    hd = D // heads
    q = ((x + pos) @ w["q_w"] + w["q_b"]).reshape(B, N, heads, hd).transpose(1, 2)
    k = ((x + pos) @ w["k_w"] + w["k_b"]).reshape(B, N, heads, hd).transpose(1, 2)
    v = (x @ w["v_w"] + w["v_b"]).reshape(B, N, heads, hd).transpose(1, 2)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (hd ** -0.5)
    p = torch.softmax(s, dim=-1).to(x.dtype)
    a = torch.matmul(p.float(), v.float()).to(x.dtype).transpose(1, 2).reshape(B, N, D)
    x = layer_norm(x + (a @ w["o_w"] + w["o_b"]), w["ln1_s"], w["ln1_b"], eps)
    y = torch.relu(x @ w["fc1_w"] + w["fc1_b"]) @ w["fc2_w"] + w["fc2_b"]
    return layer_norm(x + y, w["ln2_s"], w["ln2_b"], eps)


def fpn_forward(params, cfg: FPNConfig, features: dict):
    """features {"res2".."res5": [B, C, H, W]} -> (mask_features
    [B, mask_dim, H2, W2], transformer_features [B, D, H5, W5], the pyramid
    [res5', res4', res3'] each [B, D, h, w])."""
    eps = cfg.layer_norm_eps
    x5 = features["res5"]
    B, _, H5, W5 = x5.shape
    D = cfg.conv_dim
    t = conv(x5, params["input_proj"])
    seq = t.reshape(B, D, H5 * W5).transpose(1, 2)
    pos = sine_position_embedding(H5, W5, D, x5.device)[None].to(seq.dtype)
    for lw in params["encoder_layers"]:
        seq = _encoder_layer(lw, seq, pos, cfg.enc_heads, eps)
    transformer_features = seq.transpose(1, 2).reshape(B, D, H5, W5)

    oc = params["output_convs"][0]
    y = torch.relu(group_norm(conv(transformer_features, oc), oc["norm"]["scale"],
                              oc["norm"]["bias"], cfg.gn_groups))
    multi_scale = [y]
    for i, name in enumerate(["res4", "res3", "res2"]):
        lat = params["lateral_convs"][i]
        oc = params["output_convs"][i + 1]
        cur = group_norm(conv(features[name], lat), lat["norm"]["scale"], lat["norm"]["bias"],
                         cfg.gn_groups)
        up = resize(y, cur.shape[-2:], "nearest")
        y = torch.relu(group_norm(conv(cur + up, oc), oc["norm"]["scale"], oc["norm"]["bias"],
                                  cfg.gn_groups))
        if len(multi_scale) < 3:
            multi_scale.append(y)
    return conv(y, params["mask_features"]), transformer_features, multi_scale
