"""CLIP ViT vision tower in PyTorch (counterpart of
``cullavo_tpu/models/llava/clip_vit.py``).

Same stacked parameter layout ([L, ...] per-layer leaves), same math: the
patchify "conv" as reshape + matmul, class embedding prepended, learned
position embeddings, pre-LayerNorm blocks with QuickGELU, and the hidden
state of layer ``num_hidden_layers + feature_layer + 1`` returned.
Attention is a plain matmul + f32 softmax, as in JAX.  Training: stacked
LoRA adapters with a per-layer mask, and per-layer rematerialization.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from cullavo_tpu_torch.models.llava.config import ClipVisionConfig
from cullavo_tpu_torch.models.llava.lora import lora_update


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf * scale.float() + bias.float()).to(dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def patchify(pixel_values: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, 3, H, W] -> [B, N, 3*P*P], channel-major like a conv weight
    reshaped as [D, 3, P, P] -> [3*P*P, D]."""
    B, C, H, W = pixel_values.shape
    gh, gw = H // patch, W // patch
    x = pixel_values.reshape(B, C, gh, patch, gw, patch)
    x = x.permute(0, 2, 4, 1, 3, 5)                # [B, gh, gw, C, P, P]
    return x.reshape(B, gh * gw, C * patch * patch)


def clip_vision_forward(params: dict, cfg: ClipVisionConfig,
                        pixel_values: torch.Tensor,
                        feature_layer: int = -2,
                        lora: Optional[dict] = None,
                        lora_scaling: float = 0.0,
                        remat: bool = False) -> torch.Tensor:
    """Hidden states after ``num_hidden_layers + feature_layer + 1`` encoder
    layers (HF's ``hidden_states[feature_layer]``), shape [B, N+1, D].
    ``lora``: stacked adapters with per-layer masks (no dropout in the
    tower).  ``remat`` checkpoints each encoder layer: without it the
    backward keeps every layer's [B, heads, N+1, N+1] attention scores."""
    B = pixel_values.shape[0]
    D, H = cfg.hidden_size, cfg.num_attention_heads
    hd = cfg.head_dim
    eps = cfg.layer_norm_eps
    dtype = params["patch_embedding"].dtype

    patches = patchify(pixel_values.to(dtype), cfg.patch_size)
    x = patches @ params["patch_embedding"]                      # [B, N, D]
    cls = params["class_embedding"].expand(B, 1, D)
    x = torch.cat([cls, x], dim=1)
    x = x + params["position_embedding"][None]
    x = layer_norm(x, params["pre_ln"]["scale"], params["pre_ln"]["bias"], eps)

    n_run = cfg.num_hidden_layers + feature_layer + 1 if feature_layer < 0 else feature_layer
    T = x.shape[1]
    layers = params["layers"]
    for name in ("q", "k", "v", "o", "fc1", "fc2"):
        if isinstance(layers[name], dict):
            raise NotImplementedError("an int8 vision tower waits for the NF4 slice")

    def heads(t):
        return t.reshape(B, T, H, hd).transpose(1, 2)

    def layer(x, li):
        w = {name: a[li] for name, a in layers.items()}
        ad = {t: {k: a[li] for k, a in ab.items()} for t, ab in (lora or {}).items()}

        def mm(x, name):
            y = x @ w[name] + w[name + "_b"]
            if name in ad:
                y = y + lora_update(x, ad[name], lora_scaling, y.dtype)
            return y

        residual = x
        y = layer_norm(x, w["ln1_scale"], w["ln1_bias"], eps)
        q, k, v = heads(mm(y, "q")), heads(mm(y, "k")), heads(mm(y, "v"))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (hd ** -0.5)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        attn = torch.matmul(probs.float(), v.float()).to(x.dtype)
        attn = attn.transpose(1, 2).reshape(B, T, D)
        x = residual + mm(attn, "o")
        residual = x
        y = layer_norm(x, w["ln2_scale"], w["ln2_bias"], eps)
        return residual + mm(quick_gelu(mm(y, "fc1")), "fc2")

    for li in range(n_run):
        x = checkpoint(layer, x, li, use_reentrant=False) if remat else layer(x, li)
    return x
