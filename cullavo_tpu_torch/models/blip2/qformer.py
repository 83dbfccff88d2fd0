"""Q-Former, the BLIP-2 query transformer (counterpart of
``cullavo_tpu/models/blip2/qformer.py``): BERT-style post-norm blocks over
the learned queries, cross-attention to the image features every
``cross_attention_frequency`` layers, a per-layer list of parameter dicts
(the cross-attention layers differ in structure).

InstructBLIP's text input (``use_text_input``): the instruction's word and
position embeddings follow the queries, one LayerNorm normalises the
concatenation, queries and text self-attend jointly under the text's key
mask, only the query rows cross-attend, and each block's FFN is split by
position (``ffn_q`` for the queries, ``ffn_t`` for the text); the query
rows are returned.  ``qformer_encode_text`` runs the text alone (the
zero-shot ImageNet eval's class prompts) and pools its first token.
"""
from __future__ import annotations

import torch

from cullavo_tpu_torch.models.blip2.config import QFormerConfig
from cullavo_tpu_torch.models.blip2.vision import ACTIVATIONS, normal
from cullavo_tpu_torch.models.llava.clip_vit import layer_norm

NEG_INF = -1e9


def init_qformer_params(cfg: QFormerConfig, gen: torch.Generator, device,
                        dtype=torch.float32) -> dict:
    """Random parameters in the JAX layout and scales, from ``gen``, in
    JAX's order: per layer the self-attention, ``ffn_q``, the
    cross-attention where it has one and ``ffn_t`` (text input), then the
    word and position tables (text input)."""
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

    def ffn():
        return {"fc1": dense(D, I), "fc2": dense(I, D), "ln": ln()}

    layers = []
    for li in range(cfg.num_hidden_layers):
        layer = {"att": attention(D), "ffn_q": ffn()}
        if li % cfg.cross_attention_frequency == 0:
            layer["cross"] = attention(Dv)
        if cfg.use_text_input:
            layer["ffn_t"] = ffn()
        layers.append(layer)
    params = {"layernorm": ln(), "layers": layers}
    if cfg.use_text_input:
        params["word_emb"] = normal(gen, (cfg.vocab_size, D), 0.02, dtype, device)
        params["pos_emb"] = normal(gen, (cfg.max_position_embeddings, D), 0.02, dtype, device)
    return params


def _dense(x, w, dtype):
    return x @ w["w"].to(dtype) + w["b"].to(dtype)


def _mha(x, kv, w, mask_bias, num_heads, head_dim, eps, dtype):
    """BERT attention block: projections, f32 softmax (plus the additive
    ``mask_bias`` [B, 1, 1, S] where given), output dense and the post-norm
    residual; ``kv`` is the image features for cross-attention."""
    B, T, D = x.shape
    S = kv.shape[1]
    q = _dense(x, w["q"], dtype).reshape(B, T, num_heads, head_dim).transpose(1, 2)
    k = _dense(kv, w["k"], dtype).reshape(B, S, num_heads, head_dim).transpose(1, 2)
    v = _dense(kv, w["v"], dtype).reshape(B, S, num_heads, head_dim).transpose(1, 2)
    att = torch.matmul(q, k.transpose(-1, -2)).float() * (head_dim ** -0.5)
    if mask_bias is not None:
        att = att + mask_bias
    att = torch.softmax(att, dim=-1).to(dtype)
    o = torch.matmul(att, v).transpose(1, 2).reshape(B, T, D)
    return layer_norm(_dense(o, w["o"], dtype) + x, w["ln"]["g"], w["ln"]["b"], eps)


def _ffn(x, w, act, eps, dtype):
    h = act(_dense(x, w["fc1"], dtype).float()).to(dtype)
    return layer_norm(_dense(h, w["fc2"], dtype) + x, w["ln"]["g"], w["ln"]["b"], eps)


def _key_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, S] 1/0 -> additive f32 bias [B, 1, 1, S]."""
    return torch.where(mask[:, None, None, :] != 0, 0.0, NEG_INF).to(torch.float32)


def _text_embeds(params: dict, text_ids: torch.Tensor, dtype) -> torch.Tensor:
    T = text_ids.shape[1]
    return params["word_emb"].to(dtype)[text_ids.long()] + params["pos_emb"].to(dtype)[:T][None]


def qformer_forward(params: dict, cfg: QFormerConfig, query_embeds: torch.Tensor,
                    encoder_hidden_states: torch.Tensor, text_ids=None, text_mask=None,
                    compute_dtype=None) -> torch.Tensor:
    """query_embeds [B, Q, D], image features [B, S, Dv], optionally the
    instruction ``text_ids`` / ``text_mask`` [B, Tt] (text-input weights
    only) -> query hidden states [B, Q, D]."""
    dtype = compute_dtype or query_embeds.dtype
    eps = cfg.layer_norm_eps
    act = ACTIVATIONS[cfg.hidden_act]
    Q = query_embeds.shape[1]
    h = query_embeds.to(dtype)
    self_bias = None
    if text_ids is not None:
        text_ids = text_ids.to(h.device)
        h = torch.cat([h, _text_embeds(params, text_ids, dtype)], dim=1)
        ones = torch.ones(query_embeds.shape[:2], dtype=torch.int64, device=h.device)
        self_bias = _key_bias(torch.cat([ones, text_mask.to(h.device).long()], dim=1))
    h = layer_norm(h, params["layernorm"]["g"], params["layernorm"]["b"], eps)
    image = encoder_hidden_states.to(dtype)
    for w in params["layers"]:
        h = _mha(h, h, w["att"], self_bias, cfg.num_attention_heads, cfg.head_dim, eps, dtype)
        hq, ht = h[:, :Q], h[:, Q:]
        if "cross" in w:
            hq = _mha(hq, image, w["cross"], None, cfg.num_attention_heads, cfg.head_dim, eps,
                      dtype)
        hq = _ffn(hq, w["ffn_q"], act, eps, dtype)
        h = hq if text_ids is None else torch.cat([hq, _ffn(ht, w["ffn_t"], act, eps, dtype)],
                                                  dim=1)
    return h[:, :Q]


def qformer_encode_text(params: dict, cfg: QFormerConfig, text_ids: torch.Tensor,
                        text_mask: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """The text alone (no queries, no cross-attention) through the
    self-attention and ``ffn_t`` of every layer -> the first token's state
    [B, D]: the class-prompt branch of the zero-shot ImageNet eval (the
    reference's BLIP2ImageNetPipeline).  Needs text-input weights."""
    if not cfg.use_text_input:
        raise ValueError("qformer_encode_text needs the text-input Q-Former "
                         "(use_text_input weights)")
    dtype = compute_dtype or params["word_emb"].dtype
    eps = cfg.layer_norm_eps
    act = ACTIVATIONS[cfg.hidden_act]
    dev = params["word_emb"].device
    h = layer_norm(_text_embeds(params, text_ids.to(dev), dtype), params["layernorm"]["g"],
                   params["layernorm"]["b"], eps)
    bias = _key_bias(text_mask.to(dev))
    for w in params["layers"]:
        h = _mha(h, h, w["att"], bias, cfg.num_attention_heads, cfg.head_dim, eps, dtype)
        h = _ffn(h, w["ffn_t"], act, eps, dtype)
    return h[:, 0]
