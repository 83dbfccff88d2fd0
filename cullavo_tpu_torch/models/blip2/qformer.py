"""Q-Former, the BLIP-2 query transformer (counterpart of
``cullavo_tpu/models/blip2/qformer.py``): BERT-style post-norm blocks over
the learned queries, cross-attention to the image features every
``cross_attention_frequency`` layers, a per-layer list of parameter dicts
(the cross-attention layers differ in structure).  The instruction-text
input of InstructBLIP (``use_text_input``) waits for the InstructBLIP slice.
"""
from __future__ import annotations

import torch

from cullavo_tpu_torch.models.blip2.config import QFormerConfig
from cullavo_tpu_torch.models.blip2.vision import ACTIVATIONS, normal
from cullavo_tpu_torch.models.llava.clip_vit import layer_norm


def init_qformer_params(cfg: QFormerConfig, gen: torch.Generator, device,
                        dtype=torch.float32) -> dict:
    """Random parameters in the JAX layout and scales, from ``gen``."""
    if cfg.use_text_input:
        raise NotImplementedError("the text-input Q-Former (InstructBLIP) waits for the "
                                  "InstructBLIP slice")
    D, I, Dv = cfg.hidden_size, cfg.intermediate_size, cfg.encoder_hidden_size

    def dense(d_in, d_out):
        return {"w": normal(gen, (d_in, d_out), 0.02, dtype, device),
                "b": torch.zeros((d_out,), dtype=dtype, device=device)}

    def ln():
        return {"g": torch.ones((D,), dtype=dtype, device=device),
                "b": torch.zeros((D,), dtype=dtype, device=device)}

    def attention(kv_dim):
        return {"q": dense(D, D), "k": dense(kv_dim, D), "v": dense(kv_dim, D),
                "o": dense(D, D), "ln": ln()}

    layers = []
    for li in range(cfg.num_hidden_layers):
        layer = {"att": attention(D), "ffn_q": {"fc1": dense(D, I), "fc2": dense(I, D),
                                                "ln": ln()}}
        if li % cfg.cross_attention_frequency == 0:
            layer["cross"] = attention(Dv)
        layers.append(layer)
    return {"layernorm": ln(), "layers": layers}


def _dense(x, w, dtype):
    return x @ w["w"].to(dtype) + w["b"].to(dtype)


def _mha(x, kv, w, num_heads, head_dim, eps, dtype):
    """BERT attention block: projections, f32 softmax, output dense and the
    post-norm residual; ``kv`` is the image features for cross-attention."""
    B, T, D = x.shape
    S = kv.shape[1]
    q = _dense(x, w["q"], dtype).reshape(B, T, num_heads, head_dim).transpose(1, 2)
    k = _dense(kv, w["k"], dtype).reshape(B, S, num_heads, head_dim).transpose(1, 2)
    v = _dense(kv, w["v"], dtype).reshape(B, S, num_heads, head_dim).transpose(1, 2)
    att = torch.matmul(q, k.transpose(-1, -2)).float() * (head_dim ** -0.5)
    att = torch.softmax(att, dim=-1).to(dtype)
    o = torch.matmul(att, v).transpose(1, 2).reshape(B, T, D)
    return layer_norm(_dense(o, w["o"], dtype) + x, w["ln"]["g"], w["ln"]["b"], eps)


def _ffn(x, w, act, eps, dtype):
    h = act(_dense(x, w["fc1"], dtype).float()).to(dtype)
    return layer_norm(_dense(h, w["fc2"], dtype) + x, w["ln"]["g"], w["ln"]["b"], eps)


def qformer_forward(params: dict, cfg: QFormerConfig, query_embeds: torch.Tensor,
                    encoder_hidden_states: torch.Tensor, text_ids=None, text_mask=None,
                    compute_dtype=None) -> torch.Tensor:
    """query_embeds [B, Q, D], image features [B, S, Dv] -> query hidden
    states [B, Q, D]."""
    if text_ids is not None or cfg.use_text_input:
        raise NotImplementedError("the Q-Former's text input (InstructBLIP) waits for the "
                                  "InstructBLIP slice")
    dtype = compute_dtype or query_embeds.dtype
    eps = cfg.layer_norm_eps
    act = ACTIVATIONS[cfg.hidden_act]
    h = layer_norm(query_embeds.to(dtype), params["layernorm"]["g"],
                   params["layernorm"]["b"], eps)
    image = encoder_hidden_states.to(dtype)
    for w in params["layers"]:
        h = _mha(h, h, w["att"], cfg.num_attention_heads, cfg.head_dim, eps, dtype)
        if "cross" in w:
            h = _mha(h, image, w["cross"], cfg.num_attention_heads, cfg.head_dim, eps, dtype)
        h = _ffn(h, w["ffn_q"], act, eps, dtype)
    return h
