"""LLaMA decoder in PyTorch (counterpart of ``cullavo_tpu/models/llava/llama.py``).

Parameters are the JAX package's dict layout with every per-layer weight
stacked on a leading layer axis (``params["layers"][name]`` is [L, ...]);
the forward is a Python loop over layers that indexes those stacks (views,
no copies).  The KV cache keeps the S-major ``[L, S, B, KV, hd]`` layout.

Modes in this slice:
  * no-cache forward, and the cache-building prefill (``prefill_pad_len``);
    attention is the causal flash kernel (K1) on the right-padded batch;
  * ``stale_cache`` T = 1 decode over a bf16 cache with a scalar
    ``cache_index``: attention reads the cache without the current token,
    folds the fresh k/v in out of band, and the fresh k/v are then written
    into the cache IN PLACE (the returned cache is the input tensors).
Other modes (int8 KV cache, speculative windows, per-row write positions,
cached T > 1 forwards, adapters) wait for slice 3 and raise.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from cullavo_tpu_torch.models.llava.config import LlamaConfig
from cullavo_tpu_torch.ops import nf4 as nf4_ops
from cullavo_tpu_torch.ops.flash_attention import flash_attention

NEG_INF = -0.7 * torch.finfo(torch.float32).max


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return xf.to(dtype) * weight


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for rotary embedding at the given positions [B, T]."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    freqs = positions[..., None].float() * inv_freq            # [B, T, hd/2]
    emb = torch.cat([freqs, freqs], dim=-1)                    # [B, T, hd]
    return torch.cos(emb), torch.sin(emb)


def _rotate(x, cos, sin):
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, H, T, hd]; cos/sin: [B, T, hd].  HF rotate-half convention."""
    return _rotate(x, cos[:, None], sin[:, None])


def apply_rope_bthd(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``apply_rope`` on the projection layout x [B, T, H, hd]."""
    return _rotate(x, cos[:, :, None], sin[:, :, None])


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, KV, T, hd] -> [B, KV * n_rep, T, hd]."""
    return x if n_rep == 1 else torch.repeat_interleave(x, n_rep, dim=1)


def sdpa(q, k, v, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Scaled dot-product attention, f32 softmax.  [B, H, T, hd] layout."""
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(q.dtype).float(), v.float()).to(q.dtype)


def sdpa_decode_stale_smajor(q, k_cache, v_cache, k_cur, v_cur, bias, n_rep=1):
    """One-token decode attention over an S-major cache slice
    ``[S, B, KV, hd]`` that does NOT yet hold the current token; the current
    token's k/v (already repeated to H heads) join the softmax out of band.
    q, k_cur, v_cur: [B, H, 1, hd]; bias: [B|1, 1|H, 1, S] additive.
    Plain torch, as the JAX package leaves this to XLA."""
    if q.shape[2] != 1:
        raise NotImplementedError("decode windows W > 1 (speculative "
                                  "verification) wait for slice 3")
    scale = q.shape[-1] ** -0.5
    k = k_cache if n_rep == 1 else torch.repeat_interleave(k_cache, n_rep, dim=2)
    v = v_cache if n_rep == 1 else torch.repeat_interleave(v_cache, n_rep, dim=2)
    qf = q.float()
    s_self = (qf * k_cur.float()).sum(dim=-1, keepdim=True) * scale   # [B, H, 1, 1]
    s_cache = torch.einsum("bhqd,sbhd->bhqs", qf, k.float()) * scale + bias
    m = torch.maximum(s_cache.amax(dim=-1, keepdim=True), s_self)
    e_c = torch.exp(s_cache - m)
    e_s = torch.exp(s_self - m)
    denom = e_c.sum(dim=-1, keepdim=True) + e_s
    out = torch.einsum("bhqs,sbhd->bhqd", (e_c / denom).to(q.dtype).float(), v.float())
    out = out + (e_s / denom) * v_cur.float()
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layer_slice(w, li: int):
    """Layer ``li`` of a stacked leaf (a tensor or an int8 dict of tensors)."""
    if isinstance(w, dict):
        return {k: a[li] for k, a in w.items()}
    return w[li]


def _mm(x, w):
    if isinstance(w, dict):
        return nf4_ops.int8_linear_policy(x, w)
    return x @ w


def _mm_group(x, w, names):
    """q/k/v (or gate/up) share one activation-quantization pass when every
    member is a SmoothQuant-calibrated int8 dict and M is prefill-sized."""
    ws = [w[n] for n in names]
    if nf4_ops.s8s8_group_enabled(ws, x):
        return list(nf4_ops.int8_linear_s8s8_group(x, tuple(ws)))
    return [_mm(x, wn) for wn in ws]


def _attention_bias(attention_mask, position_ids, key_pos):
    """Additive f32 bias [B, 1, T, S]: causal on logical positions, key
    validity from ``attention_mask``."""
    ok = (position_ids[:, :, None] >= key_pos[:, None, :]) & attention_mask[:, None, :].bool()
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok[:, None], zero, torch.full_like(zero, NEG_INF))


def llama_forward(
    params: dict,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,          # [B, T, D]
    attention_mask: torch.Tensor,         # [B, S] 1/0; S = T (no cache) or max_len
    position_ids: torch.Tensor,           # [B, T]
    cache: Optional[dict] = None,
    cache_index: Optional[int] = None,    # scalar cache write offset
    key_position_ids: Optional[torch.Tensor] = None,  # [B, S] logical pos per slot
    use_flash: Optional[bool] = None,     # None = auto (flash without a cache)
    stale_cache: bool = False,
    prefill_pad_len: Optional[int] = None,
):
    """Run the decoder stack; returns (final_hidden, new_cache).

    Without a cache the attention is causal over T.  With ``use_flash``
    (the default when there is no cache) it is the
    flash kernel's bias-free contract: exact for every valid row of a
    right-padded batch, while padded rows (discarded downstream) also see
    padded keys.  ``use_flash=False`` runs ``sdpa`` with the full key-padding
    bias.  ``prefill_pad_len``: each layer also writes its k/v into a
    zero-initialised ``[L, prefill_pad_len, B, KV, hd]`` cache, returned as
    ``{"k", "v"}``.

    ``stale_cache`` (T = 1): the cache is read without the current position
    (``attention_mask`` must not include it yet), and each layer then writes
    the current k/v at ``cache_index`` in place."""
    B, T, D = inputs_embeds.shape
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    n_rep = H // KV
    dtype = inputs_embeds.dtype
    if cfg.sliding_window is not None:
        raise NotImplementedError("Mistral sliding-window attention (BakLLaVA) "
                                  "waits for slice 6")
    if cache is not None and "k_s" in cache:
        raise NotImplementedError("the int8 KV cache waits for slice 3")
    if cache is not None and not stale_cache:
        raise NotImplementedError("cached T > 1 forwards (prefix reuse) wait for slice 3")
    if stale_cache:
        if cache is None:
            raise ValueError("stale_cache needs a cache")
        if T != 1:
            raise NotImplementedError("speculative windows (T > 1) wait for slice 3")
        if not isinstance(cache_index, int):
            raise NotImplementedError("per-row cache write positions (serving "
                                      "slot pools) wait for slice 3")
    if prefill_pad_len is not None and cache is not None:
        raise ValueError("prefill_pad_len builds a cache; it takes no cache")
    if use_flash is None:
        use_flash = cache is None

    cos, sin = rope_cos_sin(position_ids, hd, cfg.rope_theta)
    bias = None
    if cache is not None or not use_flash:
        if cache is None:
            key_pos = torch.arange(T, device=position_ids.device)[None, :]
        elif key_position_ids is not None:
            key_pos = key_position_ids
        else:
            key_pos = torch.arange(cache["k"].shape[1], device=position_ids.device)[None, :]
        bias = _attention_bias(attention_mask, position_ids, key_pos)

    layers = params["layers"]
    L = layers["input_ln"].shape[0]
    new_cache = None
    if prefill_pad_len is not None:
        new_cache = {"k": torch.zeros((L, prefill_pad_len, B, KV, hd), dtype=dtype,
                                      device=inputs_embeds.device),
                     "v": torch.zeros((L, prefill_pad_len, B, KV, hd), dtype=dtype,
                                      device=inputs_embeds.device)}
    elif stale_cache:
        new_cache = cache

    h = inputs_embeds
    for li in range(L):
        w = {name: _layer_slice(a, li) for name, a in layers.items()}
        residual = h
        x = rms_norm(h, w["input_ln"], cfg.rms_norm_eps)
        yq, yk, yv = _mm_group(x, w, ("q", "k", "v"))
        q = apply_rope_bthd(yq.reshape(B, T, H, hd), cos, sin)     # [B, T, H, hd]
        k = apply_rope_bthd(yk.reshape(B, T, KV, hd), cos, sin)
        v = yv.reshape(B, T, KV, hd)
        # [B, heads, T, hd] views of the projection layout (no copies)
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if cache is None:
            if prefill_pad_len is not None:
                new_cache["k"][li, :T] = k.transpose(0, 1)        # S-major slots
                new_cache["v"][li, :T] = v.transpose(0, 1)
            if use_flash:
                attn = flash_attention(qh, repeat_kv(kh, n_rep), repeat_kv(vh, n_rep))
            else:
                attn = sdpa(qh, repeat_kv(kh, n_rep), repeat_kv(vh, n_rep), bias)
        else:
            kc, vc = cache["k"][li], cache["v"][li]
            attn = sdpa_decode_stale_smajor(
                qh, kc.to(dtype), vc.to(dtype), repeat_kv(kh, n_rep),
                repeat_kv(vh, n_rep), bias, n_rep=n_rep)
            kc[cache_index] = k[:, 0].to(kc.dtype)                # in place
            vc[cache_index] = v[:, 0].to(vc.dtype)
        attn = attn.transpose(1, 2).reshape(B, T, H * hd)
        h = residual + _mm(attn, w["o"])

        residual = h
        x = rms_norm(h, w["post_ln"], cfg.rms_norm_eps)
        y_gate, y_up = _mm_group(x, w, ("gate", "up"))
        gate = F.silu(y_gate.float()).to(dtype)
        h = residual + _mm(gate * y_up, w["down"])
    return rms_norm(h, params["norm"], cfg.rms_norm_eps), new_cache


def lm_logits(params: dict, cfg: LlamaConfig, hidden: torch.Tensor) -> torch.Tensor:
    """[B, T, D] -> f32 logits [B, T, V] (f32 products and accumulation)."""
    head = params["lm_head"] if "lm_head" in params else params["embed_tokens"].T
    return torch.matmul(hidden.float(), head.float())
