"""BLIP-2 vision tower, EVA-ViT-g as HF's Blip2 ships it (counterpart of
``cullavo_tpu/models/blip2/vision.py``): the patchify "conv" as reshape +
matmul, a class embedding, a learned position table over 1 + patches,
pre-norm blocks with a fused QKV projection and exact GELU, a
post-LayerNorm.  The random initializer has JAX's tree (no patch or QKV
bias); a snapshot's import (``checkpoint/zoo_import.py``) adds the
checkpoint's ``patch_b`` and ``layers.qkv_b``, which the forward adds.
Stacked ``[L, ...]`` layer leaves; attention is a plain matmul + f32
softmax, as JAX leaves it to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from cullavo_tpu_torch.models.blip2.config import Blip2VisionConfig
from cullavo_tpu_torch.models.llava.clip_vit import layer_norm

ACTIVATIONS = {"gelu": F.gelu}   # the hidden_act of every BLIP-2 config the zoo runs


def normal(gen, shape, std, dtype, device):
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def init_blip2_vision_params(cfg: Blip2VisionConfig, gen: torch.Generator, device,
                             dtype=torch.float32) -> dict:
    """Random parameters in the JAX layout and scales (N(0, 0.02), zero
    biases, unit LayerNorm gains) drawn from ``gen`` on ``device``."""
    D, I, L, P = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers, cfg.patch_size

    def nrm(*shape):
        return normal(gen, shape, 0.02, dtype, device)

    def full(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "class_emb": nrm(D),
        "patch_kernel": nrm(3 * P * P, D),
        "pos_emb": nrm(cfg.num_patches + 1, D),
        "layers": {
            "qkv": nrm(L, D, 3 * D), "proj": nrm(L, D, D), "proj_b": full(0.0, L, D),
            "ln1": full(1.0, L, D), "ln1_b": full(0.0, L, D),
            "ln2": full(1.0, L, D), "ln2_b": full(0.0, L, D),
            "fc1": nrm(L, D, I), "fc1_b": full(0.0, L, I),
            "fc2": nrm(L, I, D), "fc2_b": full(0.0, L, D),
        },
        "post_ln": full(1.0, D), "post_ln_b": full(0.0, D),
    }


def blip2_vision_forward(params: dict, cfg: Blip2VisionConfig, pixel_values: torch.Tensor,
                         compute_dtype=None) -> torch.Tensor:
    """pixel_values [B, 3, H, W] -> last hidden state [B, 1 + P, D], post-LN."""
    B = pixel_values.shape[0]
    P, D, H, hd = cfg.patch_size, cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim
    n = cfg.image_size // P
    dtype = compute_dtype or params["patch_kernel"].dtype
    act = ACTIVATIONS[cfg.hidden_act]
    eps = cfg.layer_norm_eps

    x = pixel_values.to(dtype).reshape(B, 3, n, P, n, P)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(B, n * n, 3 * P * P)
    x = x @ params["patch_kernel"].to(dtype)
    if "patch_b" in params:      # a snapshot's patch bias (JAX's import drops it)
        x = x + params["patch_b"].to(dtype)
    cls = params["class_emb"].to(dtype).expand(B, 1, D)
    h = torch.cat([cls, x], dim=1) + params["pos_emb"].to(dtype)
    T = h.shape[1]
    layers = params["layers"]
    for li in range(cfg.num_hidden_layers):
        w = {k: a[li].to(dtype) for k, a in layers.items()}
        x = layer_norm(h, w["ln1"], w["ln1_b"], eps)
        qkv = x @ w["qkv"]
        if "qkv_b" in w:         # a snapshot's q / zero / v bias (JAX's import drops it)
            qkv = qkv + w["qkv_b"]
        qkv = qkv.reshape(B, T, 3, H, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        att = torch.matmul(q, k.transpose(-1, -2)).float() * (hd ** -0.5)
        att = torch.softmax(att, dim=-1).to(dtype)
        o = torch.matmul(att, v).transpose(1, 2).reshape(B, T, D)
        h = h + (o @ w["proj"] + w["proj_b"])
        x = layer_norm(h, w["ln2"], w["ln2_b"], eps)
        x = act((x @ w["fc1"] + w["fc1_b"]).float()).to(dtype)
        h = h + (x @ w["fc2"] + w["fc2_b"])
    return layer_norm(h, params["post_ln"], params["post_ln_b"], eps)
