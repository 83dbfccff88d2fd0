"""DaViT backbone (counterpart of ``cullavo_tpu/models/xdecoder/davit.py``):
per-stage convolutional patch embeds (kernels 7/2/2/2, strides 4/2/2/2,
padding 3/0/0/0; LayerNorm after the first, before the others), then stages
of dual blocks: a spatial block (depthwise 3x3 conv, pre-norm window
attention, depthwise conv, pre-norm MLP) followed by a channel block (the
same with channel-group attention, a softmax over channels).  The outputs
``res2``-``res5`` are the raw stage outputs (DaViT has no output norms).

Channels-first like the port's other backbones: activations ``[B, C, H,
W]``, LayerNorm over the channel axis, linears as ``linear_cf``; the
attentions lay the tokens out channels-last inside.  Window attention pads
the normalized map with zeros to whole windows, and the padded tokens take
part in the attention unmasked, as the reference's do; channel attention
scales q by ``N ** -0.5`` (N the tokens of the map), as the reference does.
Plain PyTorch: JAX computes DaViT in XLA, with no Pallas kernel behind it.
Parameters: linear weights ``[in, out]``; convolution kernels in
PyTorch's ``[out, in/groups, k, k]`` (``checkpoint/from_jax.py`` converts).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from cullavo_tpu_torch.models.xdecoder.focalnet import _approx_gelu, layer_norm_cf, linear_cf
from cullavo_tpu_torch.ops.focal import gelu


@dataclasses.dataclass(frozen=True)
class DaViTConfig:
    embed_dims: Sequence[int] = (128, 256, 512, 1024)
    num_heads: Sequence[int] = (4, 8, 16, 32)
    num_groups: Sequence[int] = (4, 8, 16, 32)
    depths: Sequence[int] = (1, 1, 9, 1)            # dual blocks a stage
    window_size: int = 12
    mlp_ratio: float = 4.0
    patch_kernel: Sequence[int] = (7, 2, 2, 2)
    patch_stride: Sequence[int] = (4, 2, 2, 2)
    patch_pad: Sequence[int] = (3, 0, 0, 0)
    patch_prenorm: Sequence[bool] = (False, True, True, True)
    layer_norm_eps: float = 1e-5
    exact_gelu: "bool | None" = None                # FocalNet's GELU policy
    out_indices: Sequence[int] = (0, 1, 2, 3)


def init_davit_params(cfg: DaViTConfig, gen: torch.Generator, device,
                      dtype=torch.float32) -> dict:
    def dense(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.02).to(dtype)

    def full(n, v):
        return torch.full((n,), v, dtype=dtype, device=device)

    params: dict = {"stages": [], "patch_embeds": []}
    in_ch = 3
    for i, dim in enumerate(cfg.embed_dims):
        k = cfg.patch_kernel[i]
        nd = in_ch if cfg.patch_prenorm[i] else dim
        params["patch_embeds"].append({"kernel": dense(dim, in_ch, k, k), "bias": full(dim, 0.0),
                                       "norm": {"scale": full(nd, 1.0), "bias": full(nd, 0.0)}})
        hidden = int(dim * cfg.mlp_ratio)

        def sub():
            return {"conv1": dense(dim, 1, 3, 3), "conv1_b": full(dim, 0.0),
                    "ln_attn_s": full(dim, 1.0), "ln_attn_b": full(dim, 0.0),
                    "qkv_w": dense(dim, 3 * dim), "qkv_b": full(3 * dim, 0.0),
                    "proj_w": dense(dim, dim), "proj_b": full(dim, 0.0),
                    "conv2": dense(dim, 1, 3, 3), "conv2_b": full(dim, 0.0),
                    "ln_ffn_s": full(dim, 1.0), "ln_ffn_b": full(dim, 0.0),
                    "fc1_w": dense(dim, hidden), "fc1_b": full(hidden, 0.0),
                    "fc2_w": dense(hidden, dim), "fc2_b": full(dim, 0.0)}

        params["stages"].append([{"spatial": sub(), "channel": sub()}
                                 for _ in range(cfg.depths[i])])
        in_ch = dim
    return params


def _per_channel(v):
    return v[None, :, None, None]


def _dwconv(x, kernel, bias):
    """Depthwise 3x3, padding 1; the bias added after the convolution's
    rounding, as JAX adds it."""
    return F.conv2d(x, kernel, padding=1, groups=x.shape[1]) + _per_channel(bias)


def _window_attention(x, w, heads: int, window: int, eps: float):
    """x [B, C, H, W] -> the same: non-overlapping window attention over the
    normalized map zero-padded to whole windows."""
    B, C, H, W = x.shape
    y = layer_norm_cf(x, w["ln_attn_s"], w["ln_attn_b"], eps)
    pad_b, pad_r = (-H) % window, (-W) % window
    y = F.pad(y, (0, pad_r, 0, pad_b))
    nh, nw = (H + pad_b) // window, (W + pad_r) // window
    T = window * window
    y = y.reshape(B, C, nh, window, nw, window).permute(0, 2, 4, 3, 5, 1).reshape(-1, T, C)
    hd = C // heads
    qkv = (y @ w["qkv_w"] + w["qkv_b"]).reshape(-1, T, 3, heads, hd)
    q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
    # f32 scores and softmax, probabilities rounded to y's dtype, f32 sums
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (hd ** -0.5)
    p = torch.softmax(s, dim=-1).to(y.dtype)
    a = torch.matmul(p.float(), v.float()).to(y.dtype)
    a = a.transpose(1, 2).reshape(-1, T, C) @ w["proj_w"] + w["proj_b"]
    a = a.reshape(B, nh, nw, window, window, C).permute(0, 5, 1, 3, 2, 4)
    return x + a.reshape(B, C, nh * window, nw * window)[:, :, :H, :W]


def _channel_attention(x, w, groups: int, eps: float):
    """x [B, C, H, W] -> the same: attention among the channels of each of
    ``groups`` groups, over all N = H W tokens (q scaled by N ** -0.5)."""
    B, C, H, W = x.shape
    N = H * W
    y = layer_norm_cf(x, w["ln_attn_s"], w["ln_attn_b"], eps).reshape(B, C, N).transpose(1, 2)
    hd = C // groups
    qkv = (y @ w["qkv_w"] + w["qkv_b"]).reshape(B, N, 3, groups, hd)
    q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))          # [B, g, N, hd]
    q = q * (N ** -0.5)
    # attn[d, e] = sum_n q[n, d] k[n, e]; out[n, d] = sum_e attn[d, e] v[n, e]
    attn = torch.softmax(torch.matmul(q.float().transpose(-1, -2), k.float()),
                         dim=-1).to(y.dtype)
    out = torch.matmul(v.float(), attn.float().transpose(-1, -2)).to(y.dtype)
    out = out.transpose(1, 2).reshape(B, N, C) @ w["proj_w"] + w["proj_b"]
    return x + out.transpose(1, 2).reshape(B, C, H, W)


def _dual_sub_block(x, w, attn_fn, eps: float, exact_gelu):
    x = x + _dwconv(x, w["conv1"], w["conv1_b"])
    x = attn_fn(x, w)
    x = x + _dwconv(x, w["conv2"], w["conv2_b"])
    y = layer_norm_cf(x, w["ln_ffn_s"], w["ln_ffn_b"], eps)
    h = gelu(linear_cf(y, w["fc1_w"], w["fc1_b"]), _approx_gelu(y.dtype, exact_gelu))
    return x + linear_cf(h, w["fc2_w"], w["fc2_b"])


def davit_forward(params, cfg: DaViTConfig, images) -> dict:
    """images [B, 3, H, W] (normalized) -> {"res2".."res5": [B, C, h, w]}."""
    eps = cfg.layer_norm_eps
    x = images
    outs = {}
    for i, blocks in enumerate(params["stages"]):
        pe = params["patch_embeds"][i]
        if cfg.patch_prenorm[i]:
            x = layer_norm_cf(x, pe["norm"]["scale"], pe["norm"]["bias"], eps)
        x = F.conv2d(x, pe["kernel"], stride=cfg.patch_stride[i],
                     padding=cfg.patch_pad[i]) + _per_channel(pe["bias"])
        if not cfg.patch_prenorm[i]:
            x = layer_norm_cf(x, pe["norm"]["scale"], pe["norm"]["bias"], eps)
        for blk in blocks:
            x = _dual_sub_block(x, blk["spatial"], lambda y, w: _window_attention(
                y, w, cfg.num_heads[i], cfg.window_size, eps), eps, cfg.exact_gelu)
            x = _dual_sub_block(x, blk["channel"], lambda y, w: _channel_attention(
                y, w, cfg.num_groups[i], eps), eps, cfg.exact_gelu)
        if i in cfg.out_indices:
            outs[f"res{i + 2}"] = x
    return outs
