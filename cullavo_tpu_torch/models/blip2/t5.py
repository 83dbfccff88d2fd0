"""T5 v1.1 / Flan-T5 encoder-decoder, the language tower of BLIP-2
flan-t5-* (counterpart of ``cullavo_tpu/models/blip2/t5.py``).

T5 specifics: an RMS LayerNorm without mean or bias, UNscaled dot-product
attention (the 1/sqrt(d) is folded into the weights), an additive
relative-position bias that layer 0's bucket table defines for every layer,
a gated-GELU FFN and an untied lm_head.  Parameters are the JAX tree with
stacked ``[L, ...]`` encoder and decoder leaves; the forwards loop over the
layers.

Decoding keeps the self-attention cache ``[L, B, H, S, d_kv]`` (head
major).  A one-token step reads it without the current position
(``stale_cache``) through ``sdpa_decode_stale`` (K12 on the card) with the
current token's bucket-0 bias, then writes the token's k/v into the cache
IN PLACE (the returned cache is the input tensors).  The cross-attention
recomputes its k/v from the encoder states at every step, as JAX does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from cullavo_tpu_torch.models.beam import beam_search
from cullavo_tpu_torch.models.llava.llama import sdpa_decode_stale

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 2048          # flan-t5-xl
    d_kv: int = 64
    num_heads: int = 32
    d_ff: int = 5120
    num_layers: int = 24         # encoder
    num_decoder_layers: int = 24
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    decoder_start_token_id: int = 0
    pad_token_id: int = 0
    eos_token_id: int = 1

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv


def tiny_t5_config() -> T5Config:
    return T5Config(vocab_size=110, d_model=32, d_kv=8, num_heads=4, d_ff=48,
                    num_layers=2, num_decoder_layers=2,
                    relative_attention_num_buckets=8,
                    relative_attention_max_distance=16)


def t5_layer_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def init_t5_params(cfg: T5Config, gen: torch.Generator, device, dtype=torch.float32) -> dict:
    """Random parameters in the JAX layout and scales (N(0, 0.05) weights,
    N(0, 1) embeddings and bucket tables, unit norms) from ``gen``."""
    D, I, H, dk = cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.d_kv

    def nrm(shape, scale=0.05):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def stack_block(L, cross):
        blk = {"q": nrm((L, D, H * dk)), "k": nrm((L, D, H * dk)),
               "v": nrm((L, D, H * dk)), "o": nrm((L, H * dk, D)), "ln1": ones(L, D),
               "wi0": nrm((L, D, I)), "wi1": nrm((L, D, I)), "wo": nrm((L, I, D)),
               "ln_ff": ones(L, D)}
        if cross:
            blk.update({"cq": nrm((L, D, H * dk)), "ck": nrm((L, D, H * dk)),
                        "cv": nrm((L, D, H * dk)), "co": nrm((L, H * dk, D)),
                        "ln_cross": ones(L, D)})
        return blk

    nb = cfg.relative_attention_num_buckets
    return {
        "embed_tokens": nrm((cfg.vocab_size, D), 1.0),
        "enc_rel_bias": nrm((nb, H), 1.0),
        "dec_rel_bias": nrm((nb, H), 1.0),
        "encoder": stack_block(cfg.num_layers, cross=False),
        "enc_final_ln": ones(D),
        "decoder": stack_block(cfg.num_decoder_layers, cross=True),
        "dec_final_ln": ones(D),
        "lm_head": nrm((D, cfg.vocab_size)),
    }


def _relative_position_bucket(rel_pos: torch.Tensor, bidirectional: bool, num_buckets: int,
                              max_distance: int) -> torch.Tensor:
    """HF T5Attention._relative_position_bucket, bucket for bucket as JAX
    computes it: int32 positions, the log in f32 in JAX's order, the f32
    constant log(max_distance / max_exact), truncation to int32."""
    rel_pos = rel_pos.to(torch.int32)
    ret = torch.zeros_like(rel_pos)
    n = -rel_pos
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(torch.int32) * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    log_ratio = float(np.float32(np.log(max_distance / max_exact)))
    large = torch.log(n.float() / max_exact + 1e-9) / log_ratio * (num_buckets - max_exact)
    val_if_large = (max_exact + large.to(torch.int32)).clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def relative_position_bias(table: torch.Tensor, q_pos: torch.Tensor, k_pos: torch.Tensor,
                           bidirectional: bool, cfg: T5Config) -> torch.Tensor:
    """table [num_buckets, H], positions [Tq], [Tk] -> bias [1, H, Tq, Tk]."""
    bucket = _relative_position_bucket(k_pos[None, :] - q_pos[:, None], bidirectional,
                                       cfg.relative_attention_num_buckets,
                                       cfg.relative_attention_max_distance)
    return table[bucket.long()].permute(2, 0, 1)[None]


def _heads(x, B, T, H, dk):
    return x.reshape(B, T, H, dk).transpose(1, 2)


def _attn(x, kv, wq, wk, wv, wo, bias, H, dk, dtype):
    """UNscaled T5 attention with an additive [*, H, Tq, Tk] bias."""
    B, T, _ = x.shape
    S = kv.shape[1]
    q, k, v = _heads(x @ wq, B, T, H, dk), _heads(kv @ wk, B, S, H, dk), _heads(kv @ wv, B, S, H, dk)
    att = torch.matmul(q, k.transpose(-1, -2)).float() + bias
    att = torch.softmax(att, dim=-1).to(dtype)
    return torch.matmul(att, v).transpose(1, 2).reshape(B, T, -1) @ wo


def _gated_ffn(x, w, dtype):
    h = F.gelu((x @ w["wi0"]).float(), approximate="tanh")
    return (h.to(dtype) * (x @ w["wi1"])) @ w["wo"]


def _layer(stack: dict, li: int) -> dict:
    return {k: a[li] for k, a in stack.items()}


def t5_encode(params: dict, cfg: T5Config, input_embeds: torch.Tensor,
              attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, T, D] embeddings + [B, T] mask -> encoder hidden [B, T, D]."""
    T = input_embeds.shape[1]
    H, dk, eps = cfg.num_heads, cfg.d_kv, cfg.layer_norm_epsilon
    dtype = input_embeds.dtype
    pos = torch.arange(T, device=input_embeds.device)
    bias = relative_position_bias(params["enc_rel_bias"], pos, pos, True, cfg)
    bias = bias + torch.where(attention_mask[:, None, None, :] != 0, 0.0, NEG_INF)
    h = input_embeds
    for li in range(cfg.num_layers):
        w = _layer(params["encoder"], li)
        x = t5_layer_norm(h, w["ln1"], eps)
        h = h + _attn(x, x, w["q"], w["k"], w["v"], w["o"], bias, H, dk, dtype)
        h = h + _gated_ffn(t5_layer_norm(h, w["ln_ff"], eps), w, dtype)
    return t5_layer_norm(h, params["enc_final_ln"], eps)


def t5_decode_step(params: dict, cfg: T5Config, dec_embeds: torch.Tensor,
                   enc_hidden: torch.Tensor, enc_mask: torch.Tensor,
                   position_ids: torch.Tensor, self_cache: Optional[dict] = None,
                   cache_index: Optional[int] = None, stale_cache: bool = False):
    """Decoder forward -> (final hidden [B, T, D], cache).  Without a cache:
    a causal pass over ``dec_embeds`` at ``position_ids`` [T].  With
    ``self_cache`` and ``stale_cache``: one new token at position
    ``cache_index`` (``position_ids`` = [cache_index]) attends the slots
    written before it plus itself; its k/v are then written into the cache
    in place (at the last slot if ``cache_index`` is past it, as JAX's
    ``dynamic_update_slice`` clamps).  A cache without ``stale_cache`` (the
    multi-token cached forward) is not used by any generate and raises."""
    if self_cache is not None and not stale_cache:
        raise NotImplementedError("t5_decode_step: a cached forward without stale_cache is "
                                  "not used by the zoo's decoding and is not ported")
    B, T, _ = dec_embeds.shape
    H, dk, eps = cfg.num_heads, cfg.d_kv, cfg.layer_norm_epsilon
    dtype = dec_embeds.dtype
    dev = dec_embeds.device
    table = params["dec_rel_bias"]
    position_ids = position_ids.to(dev)
    key_pos = position_ids if self_cache is None else torch.arange(self_cache["k"].shape[3],
                                                                   device=dev)
    self_bias = relative_position_bias(table, position_ids, key_pos, False, cfg)
    causal = position_ids[:, None] >= key_pos[None, :]
    if self_cache is not None:
        # the written slots only: the current position joins out of band
        causal = causal & (key_pos[None, :] <= cache_index - 1)
        self0_bias = relative_position_bias(table, position_ids, position_ids, False, cfg)
        slot = min(max(int(cache_index), 0), self_cache["k"].shape[3] - 1)
    self_bias = self_bias + torch.where(causal[None, None], 0.0, NEG_INF)
    cross_bias = torch.where(enc_mask[:, None, None, :] != 0, 0.0, NEG_INF)
    h = dec_embeds
    for li in range(cfg.num_decoder_layers):
        w = _layer(params["decoder"], li)
        x = t5_layer_norm(h, w["ln1"], eps)
        q, k, v = (_heads(x @ w[n], B, T, H, dk) for n in ("q", "k", "v"))
        if self_cache is not None:
            kc, vc = self_cache["k"][li], self_cache["v"][li]
            o = sdpa_decode_stale(q, kc.to(dtype), vc.to(dtype), k, v, self_bias,
                                  self_bias=self0_bias, scale=1.0)
            kc[:, :, slot] = k[:, :, 0].to(kc.dtype)
            vc[:, :, slot] = v[:, :, 0].to(vc.dtype)
        else:
            att = torch.matmul(q, k.transpose(-1, -2)).float() + self_bias
            o = torch.matmul(torch.softmax(att, dim=-1).to(dtype), v)
        h = h + o.transpose(1, 2).reshape(B, T, -1) @ w["o"]
        x = t5_layer_norm(h, w["ln_cross"], eps)
        h = h + _attn(x, enc_hidden, w["cq"], w["ck"], w["cv"], w["co"], cross_bias, H, dk, dtype)
        h = h + _gated_ffn(t5_layer_norm(h, w["ln_ff"], eps), w, dtype)
    return t5_layer_norm(h, params["dec_final_ln"], eps), self_cache


def t5_forward(params: dict, cfg: T5Config, enc_embeds: torch.Tensor, enc_mask: torch.Tensor,
               decoder_input_ids: torch.Tensor) -> torch.Tensor:
    """Full encoder-decoder forward -> logits [B, Td, V]."""
    enc = t5_encode(params, cfg, enc_embeds, enc_mask)
    Td = decoder_input_ids.shape[1]
    h, _ = t5_decode_step(params, cfg, params["embed_tokens"][decoder_input_ids], enc, enc_mask,
                          torch.arange(Td, device=enc.device))
    return h @ params["lm_head"]


def t5_init_cache(cfg: T5Config, batch: int, max_len: int, dtype=torch.float32,
                  device=None) -> dict:
    shape = (cfg.num_decoder_layers, batch, cfg.num_heads, max_len, cfg.d_kv)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _step(params, cfg, tok, enc, enc_mask, cache, i):
    """One stale-cache decode step of token ids tok [B, 1] at position i ->
    (last hidden [B, D], cache)."""
    h, cache = t5_decode_step(params, cfg, params["embed_tokens"][tok], enc, enc_mask,
                              torch.tensor([i], device=enc.device), cache, i, stale_cache=True)
    return h[:, -1], cache


def t5_generate(params: dict, cfg: T5Config, enc_embeds: torch.Tensor, enc_mask: torch.Tensor,
                max_new_tokens: int, eos_token_id: Optional[int] = None) -> torch.Tensor:
    """Greedy decode from the decoder start token, stopping when every row
    has emitted eos; returns [B, max_new_tokens] (zeros after a row's eos)."""
    eos = cfg.eos_token_id if eos_token_id is None else eos_token_id
    enc = t5_encode(params, cfg, enc_embeds, enc_mask)
    B, dev = enc.shape[0], enc.device
    cache = t5_init_cache(cfg, B, max_new_tokens, enc.dtype, dev)
    start = torch.full((B, 1), cfg.decoder_start_token_id, dtype=torch.long, device=dev)
    h, cache = _step(params, cfg, start, enc, enc_mask, cache, 0)
    tok = torch.argmax(h @ params["lm_head"], dim=-1)
    out = torch.zeros((B, max_new_tokens), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    i = 0
    while i < max_new_tokens and not bool(done.all()):
        out[:, i] = torch.where(done, out[:, i], tok.to(torch.int32))
        done = done | (tok == eos)
        h, cache = _step(params, cfg, tok[:, None], enc, enc_mask, cache, i + 1)
        tok = torch.argmax(h @ params["lm_head"], dim=-1)
        i += 1
    return out


def t5_beam_generate(params: dict, cfg: T5Config, enc_embeds: torch.Tensor,
                     enc_mask: torch.Tensor, max_new_tokens: int, num_beams: int = 5,
                     length_penalty: float = 1.0,
                     eos_token_id: Optional[int] = None) -> torch.Tensor:
    """Beam-search decode with the HF scorer's semantics (``models/beam``):
    the reference's BLIP-2 configuration is beam 5, length penalty -1, at
    most 10 new tokens.  Returns [B, max_new_tokens]."""
    eos = cfg.eos_token_id if eos_token_id is None else eos_token_id
    enc = t5_encode(params, cfg, enc_embeds, enc_mask)
    B, dev = enc.shape[0], enc.device
    # each batch row becomes num_beams contiguous beam rows
    enc_x = torch.repeat_interleave(enc, num_beams, dim=0)
    mask_x = torch.repeat_interleave(enc_mask, num_beams, dim=0)
    cache = t5_init_cache(cfg, B * num_beams, max_new_tokens + 1, enc.dtype, dev)

    def decode_one(tok, cache, i):
        h, cache = _step(params, cfg, tok[:, None].long(), enc_x, mask_x, cache, i)
        return h @ params["lm_head"], cache

    start = torch.full((B * num_beams,), cfg.decoder_start_token_id, dtype=torch.long,
                       device=dev)
    init_logits, cache = decode_one(start, cache, 0)

    def reorder(cache, flat_parent):
        return {k: a.index_select(1, flat_parent) for k, a in cache.items()}

    return beam_search(decode_one, reorder, init_logits, cache, B, num_beams, max_new_tokens,
                       eos, pad_token_id=cfg.pad_token_id, length_penalty=length_penalty)
