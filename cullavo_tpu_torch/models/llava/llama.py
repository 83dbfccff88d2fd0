"""LLaMA decoder in PyTorch (counterpart of ``cullavo_tpu/models/llava/llama.py``).

Parameters are the JAX package's dict layout with every per-layer weight
stacked on a leading layer axis (``params["layers"][name]`` is [L, ...]);
the forward is a Python loop over layers that indexes those stacks (views,
no copies).  The KV cache keeps the S-major ``[L, S, B, KV, hd]`` layout,
bf16 (``{"k", "v"}``) or int8 with bf16 per-vector scale planes
(``{"k", "v", "k_s", "v_s"}``, planes ``[L, S, B, KV]``).

Modes:
  * no-cache forward, and the cache-building prefill (``prefill_pad_len``,
    ``kv_quant``); attention is the causal flash kernel (K1) on the
    right-padded batch, or, with ``CULLAVO_FLASH_PACKED=1`` (MHA, head dim a
    multiple of 128), K13 on the packed projection layout;
  * ``stale_cache`` decode of T >= 1 fresh tokens (T = 1: the classic step;
    T > 1: a speculative-verification window) with a scalar ``cache_index``
    or a per-row int32 ``[B]`` one: attention reads the cache without the
    fresh tokens and folds their k/v in out of band (bf16 and int8 caches:
    K4 / K5 on CUDA tensors; an f32 cache at T = 1, the VL zoo's Vicuna
    tower: ``sdpa_decode_stale``, K12 over the layer's S-major slice read
    in place; the plain ``sdpa_decode_stale_smajor[_q8]`` on CPU tensors),
    and the fresh k/v are then written into the cache IN PLACE (the
    returned cache is the input tensors);
  * a cached forward without ``stale_cache`` (the prefill of the BLIP-2
    Vicuna tower, JAX's ``sdpa_smajor`` branch): the T tokens are written at
    the scalar ``cache_index`` first, then attend the whole cache under the
    bias of ``key_position_ids`` and the mask, in plain PyTorch (JAX leaves
    it to XLA).  Over an int8 cache (``sdpa_smajor_q8``) it raises.
A prefix-reuse suffix prefill is one such window of width T at a scalar
``cache_index``; windows wider than the kernels' 64 rows take the plain
attention on either device.  Mistral's sliding window (BakLLaVA) masks
the keys at positions <= query position - W: in the bias of every cached
forward (so K4 and K12 take it), and where it binds in a forward without a
cache (T > W) on the plain attention with that bias, as JAX runs XLA
there; ``llama_forward.window_prefills`` counts those forwards.

Training: the no-cache forward is differentiable end to end (no in-place
write on that path), takes a single stack of LoRA adapters (``lora``, with
``lora_scaling``, ``lora_dropout`` and a ``dropout_rng``) and can
rematerialize each layer in the backward (``remat``).
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cullavo_tpu_torch.models.llava.config import LlamaConfig
from cullavo_tpu_torch.models.llava.lora import lora_update
from cullavo_tpu_torch.ops import nf4 as nf4_ops
from cullavo_tpu_torch.ops.flash_attention import (decode_partials, flash_attention,
                                                   flash_attention_packed)
from cullavo_tpu_torch.ops.wwin_decode import MAX_W as WWIN_MAX_W
from cullavo_tpu_torch.ops.wwin_decode import (NEG_INF, _fold_scale, _window_scores,
                                               _window_scores_q8, _window_values_q8,
                                               wwin_decode_smajor,
                                               wwin_decode_smajor_q8)


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


def sdpa_decode_stale(q, k_cache, v_cache, k_cur, v_cur, bias, self_bias=None, scale=None):
    """One-token decode attention over a cache that does NOT hold the
    current token, whose k/v join the softmax out of band (joint f32
    softmax over S + 1 keys); the VL zoo's decode step.

    q, k_cur, v_cur: [B, H, 1, hd]; k_cache, v_cache: [B, KV, S, hd] (KV = H
    in the zoo; a layer of the stacked cache, read in place); bias: [B|1,
    H|1, 1, S] additive f32 (a large negative value on unwritten slots);
    self_bias: optional [B|1, H|1, 1, 1] bias on the current position (T5's
    relative-position bucket 0); scale: default 1/sqrt(hd), 1.0 for T5.
    The cache part is ``decode_partials`` (K12 on CUDA tensors, its plain
    version on CPU ones); the current token is merged here in f32."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    o, m, l = decode_partials(q, k_cache, v_cache, bias[:, :, 0], scale)
    s_self = (q.float() * k_cur.float()).sum(dim=-1)[..., 0] * scale       # [B, H]
    if self_bias is not None:
        s_self = s_self + self_bias.float()[:, :, 0, 0]
    m_tot = torch.maximum(m, s_self)
    w_cache = l * torch.exp(m - m_tot)
    w_self = torch.exp(s_self - m_tot)
    out = (o * w_cache[..., None] + w_self[..., None] * v_cur.float()[:, :, 0])
    return (out / (w_cache + w_self)[..., None]).to(q.dtype)[:, :, None]


def sdpa_decode_stale_plain(q, k_cache, v_cache, k_cur, v_cur, bias, self_bias=None,
                            scale=None):
    """``sdpa_decode_stale`` in the JAX package's arithmetic (one softmax
    over the cache scores and the current score, the probabilities rounded
    to q's dtype for the cache's PV product); KV = H.  The yardstick of the
    kernel route on the card."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s_cache = torch.matmul(q.float(), k_cache.float().transpose(-1, -2)) * scale + bias
    s_self = (q.float() * k_cur.float()).sum(dim=-1, keepdim=True) * scale
    if self_bias is not None:
        s_self = s_self + self_bias
    m = torch.maximum(s_cache.amax(dim=-1, keepdim=True), s_self)
    e_c = torch.exp(s_cache - m)
    e_s = torch.exp(s_self - m)
    denom = e_c.sum(dim=-1, keepdim=True) + e_s
    out = torch.matmul((e_c / denom).to(q.dtype).float(), v_cache.float())
    return (out + (e_s / denom) * v_cur.float()).to(q.dtype)


def round_cache_len(n: int) -> int:
    """Round a KV-cache length up to a multiple of 128 slots (extra slots
    stay masked).  Every speculative caller rounds through this, as the JAX
    package's callers do, so both packages size their caches alike."""
    return -(-n // 128) * 128


def sdpa_decode_stale_smajor(q, k_cache, v_cache, k_cur, v_cur, bias, n_rep=1, scale=None):
    """Decode attention over an S-major cache slice ``[S, B, KV, hd]`` that
    does NOT yet hold the fresh tokens; their k/v (already repeated to H
    heads) join the softmax out of band.  q, k_cur, v_cur: [B, H, W, hd]
    (W = 1 classic decode; W > 1 speculative window, intra-window causal);
    bias: [B|1, 1|H, W, S] additive.  Plain torch, as the JAX package
    leaves this to XLA."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    k = k_cache if n_rep == 1 else torch.repeat_interleave(k_cache, n_rep, dim=2)
    v = v_cache if n_rep == 1 else torch.repeat_interleave(v_cache, n_rep, dim=2)
    s_self = _window_scores(q, k_cur, scale)                          # [B, H, W, W]
    s_cache = torch.einsum("bhqd,sbhd->bhqs", q.float(), k.float()) * scale + bias
    m = torch.maximum(s_cache.amax(dim=-1, keepdim=True), s_self.amax(dim=-1, keepdim=True))
    e_c = torch.exp(s_cache - m)
    e_s = torch.exp(s_self - m)
    denom = e_c.sum(dim=-1, keepdim=True) + e_s.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqs,sbhd->bhqd", (e_c / denom).to(q.dtype).float(), v.float())
    out = out + torch.matmul(e_s / denom, v_cur.float())
    return out.to(q.dtype)


def sdpa_smajor(q, k_cache, v_cache, bias, n_rep=1, scale=None):
    """Attention of q [B, H, T, hd] over a whole S-major cache slice
    ``[S, B, KV, hd]`` (the fresh tokens already written), additive bias
    [B|1, 1|H, T, S]; f32 scores and softmax, the probabilities rounded to
    q's dtype for the PV product (JAX's ``sdpa_smajor``)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    k = k_cache if n_rep == 1 else torch.repeat_interleave(k_cache, n_rep, dim=2)
    v = v_cache if n_rep == 1 else torch.repeat_interleave(v_cache, n_rep, dim=2)
    s = torch.einsum("bhqd,sbhd->bhqs", q.float(), k.float()) * scale + bias
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,sbhd->bhqd", p.float(), v.float()).to(q.dtype)


def quantize_kv(x: torch.Tensor):
    """Symmetric per-vector int8 quantization over the head dim:
    x [..., hd] float -> (int8 [..., hd], bf16 scale [...]).  The codes are
    made from the f32 scale; the scale is rounded to bf16 afterwards."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1).clamp_min(1e-8)
    scale = nf4_ops._div(amax, torch.full_like(amax, 127.0))
    q = torch.round(nf4_ops._div(xf, scale[..., None])).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def sdpa_decode_stale_smajor_q8(q, k_q, k_s, v_q, v_s, k_cur, v_cur, bias,
                                n_rep=1, scale=None, win_q8=None):
    """``sdpa_decode_stale_smajor`` over an int8 cache slice: k_q/v_q int8
    [S, B, KV, hd], k_s/v_s [S, B, KV] per-vector scales folded OUTSIDE the
    dots (scores = (q.k_int8) * k_s, out = (p * v_s).v_int8).  The fresh
    window's k/v stay at full precision and arrive repeated to H heads.

    ``win_q8`` (W > 1): the window's quantized k/v as they are about to be
    written to the cache; the window then takes the cache's compute path
    (``ops.wwin_decode._window_scores_q8``), which keeps the speculative
    stream equal to the sequential one under an int8 cache."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if n_rep != 1:
        k_q, v_q = (torch.repeat_interleave(t, n_rep, dim=2) for t in (k_q, v_q))
        k_s, v_s = (torch.repeat_interleave(t, n_rep, dim=2) for t in (k_s, v_s))
    s_cache = torch.einsum("bhqd,sbhd->bhqs", q.float(), k_q.to(q.dtype).float())
    s_cache = s_cache * (_fold_scale(k_s) * scale) + bias
    quant_win = win_q8 is not None and q.shape[2] > 1
    if quant_win:
        s_self, eye, v_wq, v_ws = _window_scores_q8(q, k_cur, win_q8, n_rep, scale)
    else:
        s_self = _window_scores(q, k_cur, scale)                      # [B, H, W, W]
    m = torch.maximum(s_cache.amax(dim=-1, keepdim=True), s_self.amax(dim=-1, keepdim=True))
    e_c = torch.exp(s_cache - m)
    e_s = torch.exp(s_self - m)
    denom = e_c.sum(dim=-1, keepdim=True) + e_s.sum(dim=-1, keepdim=True)
    p = (e_c / denom) * _fold_scale(v_s)
    out = torch.einsum("bhqs,sbhd->bhqd", p.to(q.dtype).float(), v_q.to(q.dtype).float())
    if quant_win:
        out = out + _window_values_q8(e_s / denom, eye, v_wq, v_ws, v_cur, q.dtype)
    else:
        out = out + torch.matmul(e_s / denom, v_cur.float())
    return out.to(q.dtype)


def init_llama_params(cfg: LlamaConfig, gen: torch.Generator, device,
                      dtype=torch.float32) -> dict:
    """Random decoder parameters in the JAX layout (stacked [L, ...] layer
    leaves), drawn from ``gen`` on ``device`` in JAX's order: the
    embedding N(0, 0.02), then q, k, v, o, gate, up, down and (untied) the
    head, each N(0, 1/fan_in); unit norms."""
    L, D, I = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    def n(shape, std):
        return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)

    def dense(shape):
        return n(shape, shape[-2] ** -0.5)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    params = {
        "embed_tokens": n((cfg.vocab_size, D), 0.02),
        "layers": {
            "input_ln": ones(L, D),
            "q": dense((L, D, H * hd)), "k": dense((L, D, KV * hd)),
            "v": dense((L, D, KV * hd)), "o": dense((L, H * hd, D)),
            "post_ln": ones(L, D),
            "gate": dense((L, D, I)), "up": dense((L, D, I)), "down": dense((L, I, D)),
        },
        "norm": ones(D),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense((D, cfg.vocab_size))
    return params


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  kv_quant: Optional[str] = None, device=None) -> dict:
    """Zeroed S-major KV cache ``[L, S, B, KV, hd]``.  ``kv_quant="int8"``
    stores int8 values + per-(slot, batch, head) bf16 scale planes
    ``k_s/v_s [L, S, B, KV]``: half the footprint and half the bytes a
    decode step reads."""
    L, KV, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    shape = (L, max_len, batch, KV, hd)
    if kv_quant == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_s": torch.zeros(shape[:4], dtype=torch.bfloat16, device=device),
                "v_s": torch.zeros(shape[:4], dtype=torch.bfloat16, device=device)}
    if kv_quant is not None:
        raise ValueError(f"unknown kv_quant {kv_quant!r}")
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _write_window(buf, li: int, cache_index, new):
    """Write the window ``new`` [T, B, ...] into ``buf[li]`` ([S, B, ...]) IN
    PLACE at slots ``cache_index .. cache_index + T - 1``: one slab for a
    scalar index, one per-row scatter for an int32 [B] tensor.  A per-row
    slot outside [0, S) is DROPPED (rows that are done or exhausted rely on
    it), never clamped into a live slot: its entry goes to the slot modulo S
    and rewrites that slot's own old value.  A row's T consecutive slots stay
    distinct modulo S (T <= S), so the scatter has no duplicate target."""
    T, B = new.shape[:2]
    layer = buf[li]
    if not isinstance(cache_index, torch.Tensor):
        layer[cache_index:cache_index + T] = new
        return
    S = layer.shape[0]
    if T > S:
        raise ValueError(f"a window of {T} tokens does not fit a cache of {S} slots")
    pos = cache_index.long()[None, :] + torch.arange(T, device=new.device)[:, None]  # [T, B]
    keep = ((pos >= 0) & (pos < S)).reshape(T, B, *([1] * (new.dim() - 2)))
    slot = pos % S
    rows = torch.arange(B, device=new.device).expand(T, B)
    layer[slot, rows] = torch.where(keep, new, layer[slot, rows])


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layer_slice(w, li: int):
    """Layer ``li`` of a stacked leaf (a tensor or an int8 dict of tensors)."""
    if isinstance(w, dict):
        return {k: a[li] for k, a in w.items()}
    return w[li]


def _mm(x, w):
    """x @ w for a dense, an int8, a planar NF4 or a byte-packed NF4 (q4)
    weight.  NF4 on CUDA tensors: the kernels (K6/K11 fused below M = 512,
    K7/K11's dequant entry once above), with a gradient for x; on CPU
    tensors the JAX package's own branch, a dense matmul against the
    dequantized weight in x's dtype.  A q4 dict's d_in is x's last dim."""
    if nf4_ops.is_quantized_planar(w):
        return nf4_ops.nf4_linear_planar_vjp(x, w)
    if nf4_ops.is_quantized(w):
        return nf4_ops.nf4_linear_fused_vjp(x, w, x.shape[-1])
    if isinstance(w, dict):
        return nf4_ops.int8_linear_policy(x, w)
    return x @ w


# order of the per-target dropout seeds within a layer
_TARGET_INDEX = {"q": 0, "k": 1, "v": 2, "o": 3, "gate": 4, "up": 5, "down": 6}


class _Adapters:
    """One layer's slice of a single or a multi stack of LoRA adapters, with
    the layer's dropout seeds (None: no dropout) and, for a multi stack, each
    batch row's adapter (``adapter_ids``, int64 [B])."""

    def __init__(self, lora, li, scaling, dropout, seeds, adapter_ids=None, rows=None):
        self.ad = {t: {k: a[li] for k, a in ab.items()} for t, ab in (lora or {}).items()}
        self.scaling, self.dropout, self.seeds = scaling, dropout, seeds
        self.adapter_ids, self.rows = adapter_ids, rows

    def add(self, y, x, name):
        """y + scaling * ((drop(x) @ a) @ b) when ``name`` has an adapter."""
        ad = self.ad.get(name)
        if ad is None:
            return y
        seed = None if self.seeds is None else self.seeds[_TARGET_INDEX[name]]
        return y + lora_update(x, ad, self.scaling, y.dtype, self.dropout, seed,
                               self.adapter_ids, self.rows)


def _mm_group(x, w, names, adapters):
    """q/k/v (or gate/up) share one activation-quantization pass when every
    member is a SmoothQuant-calibrated int8 dict and M is prefill-sized; NF4
    and dense members go one by one.  Each member then takes its adapter."""
    ws = [w[n] for n in names]
    if nf4_ops.s8s8_group_enabled(ws, x):
        ys = nf4_ops.int8_linear_s8s8_group(x, tuple(ws))
    else:
        ys = [_mm(x, wn) for wn in ws]
    return [adapters.add(y, x, n) for n, y in zip(names, ys)]


def _attention_bias(attention_mask, position_ids, key_pos, window=None):
    """Additive f32 bias [B, 1, T, S]: causal on logical positions, key
    validity from ``attention_mask``, and with Mistral's ``window`` only the
    keys at positions > query position - window (HF's convention)."""
    ok = (position_ids[:, :, None] >= key_pos[:, None, :]) & attention_mask[:, None, :].bool()
    if window is not None:
        ok = ok & (key_pos[:, None, :] > position_ids[:, :, None] - window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok[:, None], zero, torch.full_like(zero, NEG_INF))


def llama_forward(
    params: dict,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,          # [B, T, D]
    attention_mask: torch.Tensor,         # [B, S] 1/0; S = T (no cache) or max_len
    position_ids: torch.Tensor,           # [B, T]
    cache: Optional[dict] = None,
    cache_index=None,                     # cache write offset: int, or int32 [B] per row
    key_position_ids: Optional[torch.Tensor] = None,  # [B, S] logical pos per slot
    use_flash: Optional[bool] = None,     # None = auto (flash without a cache)
    stale_cache: bool = False,
    prefill_pad_len: Optional[int] = None,
    kv_quant: Optional[str] = None,       # "int8": the prefill builds a quantized cache
    lora: Optional[dict] = None,          # {target: {"a": [L, D, r], "b": [L, r, N]}}, or a
                                          # multi stack ([L, K, D, r], [L, K, r, N])
    lora_scaling: float = 0.0,
    lora_dropout: float = 0.0,
    dropout_rng: Optional[torch.Generator] = None,   # a CPU generator: the layers' seeds
    remat: bool = False,                  # checkpoint each layer (no-cache forward only)
    adapter_ids: Optional[torch.Tensor] = None,   # [B]: each row's set of a multi stack
    dropout_rows: Optional[tuple] = None,  # (offset, total): these rows of a global batch
):
    """Run the decoder stack; returns (final_hidden, new_cache).

    Without a cache the attention is causal over T.  With ``use_flash``
    (the default when there is no cache) it is the
    flash kernel's bias-free contract: exact for every valid row of a
    right-padded batch, while padded rows (discarded downstream) also see
    padded keys.  ``use_flash=False`` runs ``sdpa`` with the full key-padding
    bias.  ``prefill_pad_len``: each layer also writes its k/v into a
    zero-initialised ``[L, prefill_pad_len, B, KV, hd]`` cache (see
    ``init_kv_cache``; ``kv_quant="int8"`` quantizes them per vector).

    ``stale_cache`` (T >= 1 fresh tokens): the cache is read without the
    fresh positions (``attention_mask`` must not include them yet; they are
    mutually causal), and each layer then writes the fresh k/v at
    ``cache_index .. cache_index + T - 1`` in place, quantized when the
    cache carries scale planes.  A per-row ``cache_index`` drops writes that
    fall outside the cache.

    A ``cache`` without ``stale_cache``: each layer writes the T tokens' k/v
    at the scalar ``cache_index`` in place, then the tokens attend every
    slot under ``attention_mask`` [B, S] and causality on
    ``key_position_ids`` (JAX's ``sdpa_smajor`` branch).

    ``lora``: runtime LoRA, ``y = x @ w + lora_scaling * ((drop(x) @ a) @ b)``
    per target.  Dropout is on when ``dropout_rng`` is given and
    ``lora_dropout`` > 0: one seed per layer and target is drawn from
    ``dropout_rng`` (a CPU generator, advanced by this call), and each mask
    is a pure function of its seed.  ``remat`` wraps each layer in
    ``torch.utils.checkpoint``: the backward keeps only the layer inputs
    and recomputes the rest (the adapters' ``x @ a`` included), with the
    same dropout masks.  ``dropout_rows`` (offset, total): the batch is
    rows offset.. of a global batch of ``total`` (a data-parallel rank's);
    each mask is drawn for the global batch and these rows taken.  A multi
    stack (``lora.stack_adapter_sets``) needs ``adapter_ids``: row b takes
    set ``adapter_ids[b]`` in every layer."""
    B, T, D = inputs_embeds.shape
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    n_rep = H // KV
    dtype = inputs_embeds.dtype
    # Mistral's sliding window: in the bias of every cached forward (K4 and
    # K12 take it as it is), and in a forward without a cache where it
    # binds (T > W: a query W or more positions past the first key), which
    # then runs the plain attention with the bias, as JAX runs XLA there
    # (its flash kernel takes no window); ``llama_forward.window_prefills``
    # counts those forwards.  T <= W: the window cuts nothing, K1 stays.
    window = cfg.sliding_window
    window_binds = window is not None and cache is None and T > window
    if window_binds and use_flash:
        raise ValueError(f"use_flash with a sliding window of {window} < T = {T}: the flash "
                         "kernel takes no window")
    if cache is not None and not stale_cache:
        # the BLIP-2 Vicuna tower's prefill (JAX's blip2_generate and
        # blip2_beam_generate, reached from entry._eval_vl_zoo with
        # MODEL.ZOO: instructblip)
        if "k_s" in cache:
            raise NotImplementedError("a cached forward without stale_cache over an int8 cache "
                                      "(JAX's sdpa_smajor_q8) waits for queue 1 item 4 of "
                                      "ROADMAP.md; no JAX entry reaches it")
        if isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1:
            raise ValueError("a per-row cache_index needs stale_cache")
    if stale_cache and cache is None:
        raise ValueError("stale_cache needs a cache")
    if prefill_pad_len is not None and cache is not None:
        raise ValueError("prefill_pad_len builds a cache; it takes no cache")
    if kv_quant not in (None, "int8"):
        raise ValueError(f"unknown kv_quant {kv_quant!r}")
    if lora and any(ab["a"].dim() == 4 for ab in lora.values()):
        if adapter_ids is None:
            raise ValueError("multi-stacked lora adapters need adapter_ids ([B] int32 "
                             "per-row picks)")
        adapter_ids = adapter_ids.to(inputs_embeds.device, torch.int64)
    if remat and (cache is not None or prefill_pad_len is not None):
        raise ValueError("remat is for the no-cache (training) forward")
    # an existing quantized cache carries its scale planes; a prefill opts in
    kv_q8 = kv_quant == "int8" or (cache is not None and "k_s" in cache)
    if use_flash is None:
        use_flash = cache is None and not window_binds
    if window_binds:
        llama_forward.window_prefills += 1
    # JAX's opt-in packed-heads forward (CULLAVO_FLASH_PACKED=1, read per
    # call): q/k/v stay [B, T, H*hd] from the projections to the o-projection
    # (K13); MHA with a head dim that is a multiple of 128, no cache
    packed = (use_flash and cache is None and hd % 128 == 0 and H == KV
              and os.environ.get("CULLAVO_FLASH_PACKED", "0") == "1")

    cos, sin = rope_cos_sin(position_ids, hd, cfg.rope_theta)
    bias = None
    if cache is not None or not use_flash:
        if cache is None:
            key_pos = torch.arange(T, device=position_ids.device)[None, :]
        elif key_position_ids is not None:
            key_pos = key_position_ids
        else:
            key_pos = torch.arange(cache["k"].shape[1], device=position_ids.device)[None, :]
        bias = _attention_bias(attention_mask, position_ids, key_pos, window)

    layers = params["layers"]
    L = layers["input_ln"].shape[0]
    new_cache = None
    if prefill_pad_len is not None:
        new_cache = init_kv_cache(cfg, B, prefill_pad_len, dtype, kv_quant,
                                  device=inputs_embeds.device)
    elif cache is not None:     # written in place, stale or not
        new_cache = cache
    # K4/K5 take windows of 1..WWIN_MAX_W rows, which covers the engine's
    # default suffix buckets; only a suffix bucket configured wider than that
    # takes the plain attention (the JAX package sends wide windows to its
    # XLA branch), and the engine counts those in ``suffix_wide_windows``
    plain_attn = inputs_embeds.device.type == "cpu" or T > WWIN_MAX_W
    # an f32 cache (the VL zoo's towers run in f32): K12 takes the one-token
    # step; K4 takes bf16 only, and no path decodes an f32 window
    f32_step = stale_cache and not kv_q8 and dtype == torch.float32 and not plain_attn
    if f32_step and T != 1:
        raise NotImplementedError(f"an f32 stale-cache window of {T} tokens on "
                                  f"{inputs_embeds.device}: the card decodes f32 one token "
                                  "at a time (K12); K4 takes bf16")

    seeds = None
    if lora and dropout_rng is not None and lora_dropout > 0.0:
        seeds = torch.randint(0, 2 ** 62, (L, len(_TARGET_INDEX)),
                              generator=dropout_rng).tolist()

    def layer(h, li):
        w = {name: _layer_slice(a, li) for name, a in layers.items()}
        ad = _Adapters(lora, li, lora_scaling, lora_dropout,
                       None if seeds is None else seeds[li], adapter_ids, dropout_rows)
        residual = h
        x = rms_norm(h, w["input_ln"], cfg.rms_norm_eps)
        yq, yk, yv = _mm_group(x, w, ("q", "k", "v"), ad)
        q = apply_rope_bthd(yq.reshape(B, T, H, hd), cos, sin)     # [B, T, H, hd]
        k = apply_rope_bthd(yk.reshape(B, T, KV, hd), cos, sin)
        v = yv.reshape(B, T, KV, hd)
        # [B, heads, T, hd] views of the projection layout (no copies)
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        k_sm, v_sm = k.transpose(0, 1), v.transpose(0, 1)          # [T, B, KV, hd] slots
        if cache is None:
            if prefill_pad_len is not None and kv_q8:
                for name, plane, x_sm in (("k", "k_s", k_sm), ("v", "v_s", v_sm)):
                    codes, scales = quantize_kv(x_sm)
                    new_cache[name][li, :T] = codes
                    new_cache[plane][li, :T] = scales
            elif prefill_pad_len is not None:
                new_cache["k"][li, :T] = k_sm
                new_cache["v"][li, :T] = v_sm
            if packed:
                attn = flash_attention_packed(q.reshape(B, T, H * hd), k.reshape(B, T, KV * hd),
                                              v.reshape(B, T, KV * hd), H)
            elif use_flash:
                attn = flash_attention(qh, repeat_kv(kh, n_rep), repeat_kv(vh, n_rep))
            else:
                attn = sdpa(qh, repeat_kv(kh, n_rep), repeat_kv(vh, n_rep), bias)
        elif kv_q8:
            # CUDA tensors: K5 reads the stacked cache in place; CPU: plain slice
            kr, vr = repeat_kv(kh, n_rep), repeat_kv(vh, n_rep)
            kq, ks = quantize_kv(k_sm)
            vq, vs = quantize_kv(v_sm)
            win_q8 = (kq, ks, vq, vs) if T > 1 else None
            if plain_attn:
                attn = sdpa_decode_stale_smajor_q8(
                    qh, cache["k"][li], cache["k_s"][li], cache["v"][li], cache["v_s"][li],
                    kr, vr, bias, n_rep=n_rep, win_q8=win_q8)
            else:
                attn = wwin_decode_smajor_q8(
                    qh, cache["k"], cache["k_s"], cache["v"], cache["v_s"], li,
                    kr, vr, bias, n_rep=n_rep, win_q8=win_q8)
            for name, new in (("k", kq), ("k_s", ks), ("v", vq), ("v_s", vs)):
                _write_window(cache[name], li, cache_index, new)
        elif not stale_cache:
            # JAX's sdpa_smajor: write the window first, then attend the slice
            _write_window(cache["k"], li, cache_index, k_sm.to(cache["k"].dtype))
            _write_window(cache["v"], li, cache_index, v_sm.to(cache["v"].dtype))
            attn = sdpa_smajor(qh, cache["k"][li].to(dtype), cache["v"][li].to(dtype), bias,
                               n_rep=n_rep)
        else:
            # CUDA tensors: K4 (bf16) reads the stacked cache in place, K12
            # (f32, T = 1) the layer's [S, B, KV, hd] slice as a [B, KV, S,
            # hd] view; CPU: plain slice
            kr, vr = repeat_kv(kh, n_rep), repeat_kv(vh, n_rep)
            if f32_step:
                attn = sdpa_decode_stale(qh, cache["k"][li].permute(1, 2, 0, 3),
                                         cache["v"][li].permute(1, 2, 0, 3), kr, vr, bias)
            elif plain_attn:
                attn = sdpa_decode_stale_smajor(
                    qh, cache["k"][li].to(dtype), cache["v"][li].to(dtype), kr, vr, bias,
                    n_rep=n_rep)
            else:
                attn = wwin_decode_smajor(qh, cache["k"], cache["v"], li, kr, vr, bias,
                                          n_rep=n_rep)
            _write_window(cache["k"], li, cache_index, k_sm.to(cache["k"].dtype))
            _write_window(cache["v"], li, cache_index, v_sm.to(cache["v"].dtype))
        if not packed:
            attn = attn.transpose(1, 2).reshape(B, T, H * hd)
        h = residual + ad.add(_mm(attn, w["o"]), attn, "o")

        residual = h
        x = rms_norm(h, w["post_ln"], cfg.rms_norm_eps)
        y_gate, y_up = _mm_group(x, w, ("gate", "up"), ad)
        gate = F.silu(y_gate.float()).to(dtype)
        down_in = gate * y_up
        return residual + ad.add(_mm(down_in, w["down"]), down_in, "down")

    h = inputs_embeds
    for li in range(L):
        h = checkpoint(layer, h, li, use_reentrant=False) if remat else layer(h, li)
    return rms_norm(h, params["norm"], cfg.rms_norm_eps), new_cache


llama_forward.window_prefills = 0


def lm_logits(params: dict, cfg: LlamaConfig, hidden: torch.Tensor) -> torch.Tensor:
    """[B, T, D] -> f32 logits [B, T, V] (f32 products and accumulation)."""
    head = params["lm_head"] if "lm_head" in params else params["embed_tokens"].T
    return torch.matmul(hidden.float(), head.float())
