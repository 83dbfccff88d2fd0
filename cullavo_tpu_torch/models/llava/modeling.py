"""LLaVA-1.5 in PyTorch: vision tower + projector + LLaMA, token merge,
the fused ``generate`` (greedy or sampled), two-phase generation (greedy or
sampled; speculative greedy), and the serving engine's device functions:
prefix reuse, the slot pool and decode quanta, greedy or sampled, with
unmerged runtime LoRA adapters, one set or a multi stack picked per row by
``adapter_ids`` (counterpart of ``cullavo_tpu/models/llava/modeling.py``).

Parameters are plain dicts of tensors in the JAX package's layout, and the
prefill/decode states keep its keys and layouts (S-major cache
``[L, S, B, KV, hd]``, bf16 or int8 with scale planes), so the tests
compare like with like.  Where JAX donates a state and returns an updated
copy, the port updates it in place (``merge_decode_state``,
``generate_decode``, ``generate_decode_spec``, ``decode_quantum[_spec]``,
``write_slot[s]``); the functions say so.
Generation runs eagerly: a Python loop over decode steps with ``write_idx``
a host integer (the fused ``generate`` reads one done flag per step to
stop early), or over speculative windows with ``write_idx`` an int32
[B] tensor on the device and one host read per window.  A sampled draw
takes its Gumbel noise from an explicit ``torch.Generator`` (JAX's key),
one [B, V] draw per sampled batch of tokens, in JAX's order.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from cullavo_tpu_torch.models.llava.clip_vit import clip_vision_forward, init_clip_vision_params
from cullavo_tpu_torch.models.llava.config import LlavaConfig
from cullavo_tpu_torch.models.llava.llama import (NEG_INF, init_llama_params, llama_forward,
                                                  lm_logits)

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _normal(gen, shape, std, dtype, device):
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def init_llava_params(cfg: LlavaConfig, generator: torch.Generator,
                      device, dtype=torch.float32) -> dict:
    """Random parameters in the JAX layout (stacked [L, ...] layer leaves),
    drawn from ``generator`` on ``device`` (same shapes and scales as the
    JAX initializer; the values differ, as the generators do)."""
    Dv, D = cfg.vision.hidden_size, cfg.text.hidden_size

    def dense(shape):
        return _normal(generator, shape, shape[-2] ** -0.5, dtype, device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    vision = init_clip_vision_params(cfg.vision, generator, device, dtype)
    language = init_llama_params(cfg.text, generator, device, dtype)
    return {
        "vision_tower": vision,
        "projector": {"linear_1": {"kernel": dense((Dv, D)), "bias": zeros(D)},
                      "linear_2": {"kernel": dense((D, D)), "bias": zeros(D)}},
        "language_model": language,
    }


# ---------------------------------------------------------------------------
# vision features and token merge
# ---------------------------------------------------------------------------

def image_features(params: dict, cfg: LlavaConfig, pixel_values: torch.Tensor,
                   lora: Optional[dict] = None, lora_scaling: float = 0.0,
                   remat: bool = False) -> torch.Tensor:
    """[B, 3, H, W] -> [B, num_image_tokens, D_text]."""
    hidden = clip_vision_forward(params["vision_tower"], cfg.vision, pixel_values,
                                 cfg.vision_feature_layer,
                                 lora=(lora or {}).get("vision_tower"),
                                 lora_scaling=lora_scaling, remat=remat)
    if cfg.vision_feature_select_strategy == "default":
        hidden = hidden[:, 1:]  # drop CLS
    proj = params["projector"]
    x = hidden @ proj["linear_1"]["kernel"] + proj["linear_1"]["bias"]
    x = F.gelu(x.float(), approximate="none").to(x.dtype)
    return x @ proj["linear_2"]["kernel"] + proj["linear_2"]["bias"]


def merge_image_features(cfg: LlavaConfig, input_ids: torch.Tensor,
                         inputs_embeds: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """Place image features at the ``image_token_id`` positions of each row:
    the k-th image slot of a row (in sequence order) gets ``feats[b, k]``.
    Differentiable in ``feats`` and ``inputs_embeds`` (the gradient reaches
    the projector and the embedding table)."""
    is_img = input_ids == cfg.image_token_id                        # [B, T]
    slot_rank = (torch.cumsum(is_img.to(torch.int64), dim=1) - 1).clamp(0, feats.shape[1] - 1)
    gathered = torch.gather(feats, 1, slot_rank[..., None].expand(-1, -1, feats.shape[-1]))
    return torch.where(is_img[..., None], gathered.to(inputs_embeds.dtype), inputs_embeds)


def expand_image_token(input_ids, attention_mask, labels, image_token_id: int,
                       num_image_tokens: int, ignore_index: int = -100):
    """Host-side (numpy) expansion of each ``<image>`` token into
    ``num_image_tokens`` positions (mask 1, label ``ignore_index``)."""
    out_ids, out_mask, out_labels = [], [], []
    for i, tok in enumerate(np.asarray(input_ids).tolist()):
        if tok == image_token_id:
            out_ids.extend([image_token_id] * num_image_tokens)
            out_mask.extend([1] * num_image_tokens)
            out_labels.extend([ignore_index] * num_image_tokens)
        else:
            out_ids.append(tok)
            out_mask.append(int(np.asarray(attention_mask)[i]) if attention_mask is not None else 1)
            out_labels.append(int(np.asarray(labels)[i]) if labels is not None else ignore_index)
    return (np.array(out_ids, np.int32), np.array(out_mask, np.int32),
            np.array(out_labels, np.int32))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _positions(attention_mask):
    return (torch.cumsum(attention_mask.to(torch.int64), dim=1) - 1).clamp_min(0)


def llava_forward(params: dict, cfg: LlavaConfig, input_ids: torch.Tensor,
                  pixel_values: Optional[torch.Tensor], attention_mask: torch.Tensor,
                  position_ids: Optional[torch.Tensor] = None,
                  cache: Optional[dict] = None, cache_index=None,
                  full_attention_mask: Optional[torch.Tensor] = None,
                  key_position_ids: Optional[torch.Tensor] = None,
                  last_logit_only: bool = False, stale_cache: bool = False,
                  prefill_pad_len: Optional[int] = None,
                  use_flash: Optional[bool] = None,
                  kv_quant: Optional[str] = None,
                  lora: Optional[dict] = None, lora_scaling: float = 0.0,
                  lora_dropout: float = 0.0,
                  dropout_rng: Optional[torch.Generator] = None,
                  remat: bool = False, return_hidden: bool = False,
                  adapter_ids: Optional[torch.Tensor] = None):
    """Returns (f32 logits [B, T or 1, V], new_cache), or with
    ``return_hidden`` the final hidden states in place of the logits (the
    trainer projects them chunk by chunk).  ``cache_index``: an int, or an
    int32 [B] tensor of per-row write positions.  ``lora``:
    ``{"language_model": ..., "vision_tower": ...}`` adapter stacks; a multi
    stack of LLM adapters (``lora.stack_adapter_sets``) takes each row's set
    from ``adapter_ids`` [B].
    Differentiable where the inputs ask for it; the generation functions
    call it without gradients."""
    embed = params["language_model"]["embed_tokens"]
    # indexing, not F.embedding: its backward (index_put with accumulation)
    # sorts the indices and is deterministic, where the embedding backward
    # adds with atomics
    inputs_embeds = embed[input_ids.clamp(0, embed.shape[0] - 1).long()]
    if pixel_values is not None:
        feats = image_features(params, cfg, pixel_values, lora, lora_scaling, remat=remat)
        inputs_embeds = merge_image_features(cfg, input_ids, inputs_embeds, feats)
    if position_ids is None:
        position_ids = _positions(attention_mask)
    mask = full_attention_mask if cache is not None else attention_mask
    hidden, new_cache = llama_forward(
        params["language_model"], cfg.text, inputs_embeds, mask, position_ids,
        cache, cache_index, key_position_ids, use_flash=use_flash,
        stale_cache=stale_cache, prefill_pad_len=prefill_pad_len, kv_quant=kv_quant,
        lora=(lora or {}).get("language_model"), lora_scaling=lora_scaling,
        lora_dropout=lora_dropout, dropout_rng=dropout_rng, remat=remat,
        adapter_ids=adapter_ids)
    if last_logit_only:
        # only the last valid position feeds sampling
        last = attention_mask.sum(dim=1).to(torch.int64) - 1
        hidden = hidden[torch.arange(hidden.shape[0], device=hidden.device), last][:, None]
    if return_hidden:
        return hidden, new_cache
    return lm_logits(params["language_model"], cfg.text, hidden), new_cache


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor, attention_mask: torch.Tensor,
                   ignore_index: int = -100):
    """Shifted masked cross-entropy: predict token t+1 from position t,
    positions with ``ignore_index`` or mask 0 excluded, mean over the valid
    ones.  Returns (loss, n_valid)."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:].long()
    shift_mask = (attention_mask[:, 1:] != 0) & (shift_labels != ignore_index)
    safe_labels = torch.where(shift_mask, shift_labels, torch.zeros_like(shift_labels))
    logprobs = torch.log_softmax(shift_logits, dim=-1)
    token_ll = logprobs.gather(-1, safe_labels[..., None])[..., 0]
    n_valid = shift_mask.sum()
    loss = -(torch.where(shift_mask, token_ll, torch.zeros_like(token_ll))).sum() \
        / n_valid.clamp_min(1)
    return loss, n_valid


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 128
    do_sample: bool = False
    temperature: float = 0.9
    top_k: int = 50
    top_p: float = 0.95
    eos_token_id: int = 2


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))`` in f32, ``u`` uniform in
    [tiny, 1) drawn from ``generator`` on ``device``: the form of
    ``jax.random.gumbel`` (its default "low" mode) on torch's stream.  The
    samplers look it up here at every draw, so a test can replay JAX's
    noise through it."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def _filter_logits(logits: torch.Tensor, gen: GenerationConfig) -> torch.Tensor:
    """logits [B, V] -> f32 [B, V] with the dropped tokens at ``NEG_INF``, in
    HF's order: temperature, then top-k (every token below the k-th largest
    value goes, so ties at the k-th value all stay), then top-p (the sorted
    tokens whose preceding mass exceeds ``top_p`` go, the first always
    stays).  The top-p mass is summed in f64 against ``top_p`` rounded to
    f32 (JAX's threshold), so the kept set does not depend on the device's
    summation order; JAX sums in f32, and can differ on a token whose
    preceding mass lies within f32 rounding of ``top_p``."""
    logits = logits.float() / torch.tensor(gen.temperature, dtype=torch.float32,
                                           device=logits.device)
    if gen.top_k > 0:
        kth = torch.topk(logits, gen.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)
    if gen.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits.double(), dim=-1)
        top_p = torch.tensor(gen.top_p, dtype=torch.float32).item()
        cutoff_mask = torch.cumsum(probs, dim=-1) - probs > top_p
        cutoff = torch.where(cutoff_mask, torch.full_like(sorted_logits, torch.inf),
                             sorted_logits).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, torch.full_like(logits, NEG_INF), logits)
    return logits


def _sample_token(logits: torch.Tensor, gen: GenerationConfig,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits [B, V] -> [B] int32.  Greedy: the first maximal index.
    Sampled: ``argmax(filtered + gumbel)``, the Gumbel-max draw that
    ``jax.random.categorical`` makes, with the noise from ``gumbel_noise``
    on ``generator``; a sampled draw without a generator raises."""
    if not gen.do_sample:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise NotImplementedError("sampled decoding needs an explicit torch.Generator (the "
                                  "rng of generate, generate_decode and decode_quantum; the "
                                  "serving engine holds one seeded from its seed)")
    filtered = _filter_logits(logits, gen)
    noise = gumbel_noise(filtered.shape, generator, filtered.device)
    return torch.argmax(filtered + noise, dim=-1).to(torch.int32)


_PRESERVE_FP32_KEYS = ("scale", "scale8", "absmax", "absmax_scale", "absmax_offset")


def _cast_params(params, compute_dtype, from_bf16: bool = False):
    """Cast float leaves to the compute dtype EXCEPT quantization scales
    (``_PRESERVE_FP32_KEYS`` stay f32).  ``from_bf16=False`` (the default
    here, the mode of the two-phase functions and the trainer) casts only
    f32/f16 leaves and leaves bf16 ones alone; ``from_bf16=True`` (the
    fused ``generate``, as in JAX) casts bf16 leaves too.  Returns a new
    dict; a leaf already in the dtype is returned as is (no copy)."""
    src = ((torch.float32, torch.bfloat16, torch.float16) if from_bf16
           else (torch.float32, torch.float16))

    def cast(key, a):
        if isinstance(a, dict):
            return {k: cast(k, v) for k, v in a.items()}
        if a.dtype not in src or key in _PRESERVE_FP32_KEYS:
            return a
        return a.to(compute_dtype)

    return {k: cast(k, v) for k, v in params.items()}


@torch.no_grad()
def generate(params: dict, cfg: LlavaConfig, input_ids: torch.Tensor,
             pixel_values: Optional[torch.Tensor], attention_mask: torch.Tensor,
             gen: GenerationConfig, max_len: int, rng: Optional[torch.Generator] = None,
             compute_dtype=torch.float32) -> torch.Tensor:
    """Prefill + decode in one call (JAX's fused ``generate``):
    ``generate_prefill`` with every float leaf cast to ``compute_dtype``
    (bf16 ones too), then the steps of ``_decode_steps`` drawing from
    ``rng`` (a ``torch.Generator`` on the inputs' device; None: seed 0).
    Like JAX's ``while_loop`` it stops once every row is done; the output
    is eos-padded to ``max_new_tokens``, equal to a run without the stop.
    Returns [B, max_new_tokens] int32."""
    if rng is None:
        rng = torch.Generator(device=input_ids.device).manual_seed(0)
    lm = _cast_params(params, compute_dtype, from_bf16=True)
    state = generate_prefill(lm, cfg, input_ids, pixel_values, attention_mask, max_len,
                             compute_dtype=compute_dtype)
    return _decode_steps(lm, cfg, state, gen, lambda lg: _sample_token(lg, gen, rng),
                         early_stop=True)


@torch.no_grad()
def generate_prefill(params: dict, cfg: LlavaConfig, input_ids: torch.Tensor,
                     pixel_values: Optional[torch.Tensor],
                     attention_mask: torch.Tensor, max_len: int,
                     compute_dtype=torch.bfloat16,
                     kv_quant: Optional[str] = None, lora: Optional[dict] = None,
                     lora_scaling: float = 0.0,
                     adapter_ids: Optional[torch.Tensor] = None) -> dict:
    """Prefill phase: build the cache (``kv_quant="int8"``: int8 codes +
    bf16 scale planes) and return the decode state (``logits``, ``cache``,
    ``full_mask``, ``key_pos``, ``cur_pos``, ``write_idx``,
    ``adapter_ids``) — the JAX state layout.

    ``lora``: unmerged runtime adapters over the (possibly quantized) base
    (cast like the parameters); a multi stack applies row b's set
    ``adapter_ids[b]`` (zeros when None), and the ids travel in the state so
    that the decode applies each row's set too."""
    B, T = input_ids.shape
    dev = input_ids.device
    lm = _cast_params(params, compute_dtype)
    lora = _cast_params(lora, compute_dtype) if lora else None
    adapter_ids = (torch.zeros((B,), dtype=torch.int32, device=dev) if adapter_ids is None
                   else adapter_ids.to(dev, torch.int32))
    full_mask = torch.zeros((B, max_len), dtype=torch.int32, device=dev)
    full_mask[:, :T] = attention_mask.to(torch.int32)
    position_ids = _positions(attention_mask)
    key_pos = torch.zeros((B, max_len), dtype=torch.int32, device=dev)
    key_pos[:, :T] = position_ids.to(torch.int32)
    logits, cache = llava_forward(lm, cfg, input_ids, pixel_values, attention_mask,
                                  position_ids, last_logit_only=True,
                                  prefill_pad_len=max_len, kv_quant=kv_quant, lora=lora,
                                  lora_scaling=lora_scaling, adapter_ids=adapter_ids)
    last_idx = attention_mask.sum(dim=1).to(torch.int32) - 1
    return {"logits": logits[:, 0], "cache": cache, "full_mask": full_mask,
            "key_pos": key_pos, "cur_pos": last_idx + 1, "write_idx": T,
            "adapter_ids": adapter_ids}


def alloc_decode_state(chunk_state: dict, total_batch: int) -> dict:
    """A zeroed full-batch decode state shaped like ``chunk_state`` (cache
    batch axis 2, every other leaf axis 0)."""
    def z(a, axis):
        shape = list(a.shape)
        shape[axis] = total_batch
        return torch.zeros(shape, dtype=a.dtype, device=a.device)

    return {"logits": z(chunk_state["logits"], 0),
            "cache": {name: z(a, 2) for name, a in chunk_state["cache"].items()},
            "full_mask": z(chunk_state["full_mask"], 0),
            "key_pos": z(chunk_state["key_pos"], 0),
            "cur_pos": z(chunk_state["cur_pos"], 0),
            "write_idx": chunk_state["write_idx"],
            "adapter_ids": z(chunk_state["adapter_ids"], 0)}


def merge_decode_state(big: dict, chunk: dict, batch_offset: int) -> dict:
    """Write a prefill chunk's state into the full-batch state IN PLACE
    (rows ``batch_offset:batch_offset + chunk_rows``) and return it.  All
    chunks share the prompt length (equal ``write_idx``)."""
    o = batch_offset
    n = chunk["logits"].shape[0]
    big["logits"][o:o + n] = chunk["logits"].to(big["logits"].dtype)
    for name, a in chunk["cache"].items():
        big["cache"][name][:, :, o:o + n] = a
    for key in ("full_mask", "key_pos", "cur_pos", "adapter_ids"):
        big[key][o:o + n] = chunk[key]
    big["write_idx"] = chunk["write_idx"]
    return big


def generate_prefill_chunked(params: dict, cfg: LlavaConfig, input_ids: torch.Tensor,
                             pixel_values: Optional[torch.Tensor],
                             attention_mask: torch.Tensor, max_len: int, chunk: int,
                             compute_dtype=torch.bfloat16,
                             kv_quant: Optional[str] = None, lora: Optional[dict] = None,
                             lora_scaling: float = 0.0,
                             adapter_ids: Optional[torch.Tensor] = None) -> dict:
    """Prefill in batch chunks of ``chunk`` rows, merged into one full-batch
    decode state (decode cost is dominated by the batch-independent weight
    stream, so one large decode batch amortizes it).  A non-divisible batch
    runs one smaller final chunk."""
    B = input_ids.shape[0]
    if chunk >= B:
        return generate_prefill(params, cfg, input_ids, pixel_values, attention_mask,
                                max_len, compute_dtype=compute_dtype, kv_quant=kv_quant,
                                lora=lora, lora_scaling=lora_scaling, adapter_ids=adapter_ids)
    lora = _cast_params(lora, compute_dtype) if lora else None   # once for every chunk
    state = None
    for off in range(0, B, chunk):
        cs = generate_prefill(params, cfg, input_ids[off:off + chunk],
                              None if pixel_values is None else pixel_values[off:off + chunk],
                              attention_mask[off:off + chunk], max_len,
                              compute_dtype=compute_dtype, kv_quant=kv_quant, lora=lora,
                              lora_scaling=lora_scaling,
                              adapter_ids=None if adapter_ids is None
                              else adapter_ids[off:off + chunk])
        if state is None:
            state = alloc_decode_state(cs, B)
        merge_decode_state(state, cs, off)
        del cs   # free the chunk's cache before the next chunk's prefill
    return state


def _decode_steps(lm: dict, cfg: LlavaConfig, state: dict, gen: GenerationConfig,
                  draw, early_stop: bool, lora: Optional[dict] = None,
                  lora_scaling: float = 0.0) -> torch.Tensor:
    """The token that ``draw`` (logits [B, V] -> [B] int32) takes from the
    prefill logits, then stale-cache T = 1 steps over ``lm`` (and ``lora``,
    both already cast; each row's set from the state's ``adapter_ids``) up
    to ``max_new_tokens``, each drawing its token; finished rows emit
    eos.  ``early_stop``: stop once every row is done, reading one flag from
    the device per step (the rest of the output stays eos).  The state's
    cache, ``full_mask`` and ``key_pos`` are updated IN PLACE (JAX donates
    the state).  Returns [B, max_new_tokens] int32."""
    eos = gen.eos_token_id
    tok = draw(state["logits"])
    out = torch.full((tok.shape[0], gen.max_new_tokens), eos, dtype=torch.int32,
                     device=tok.device)
    out[:, 0] = tok
    done = tok == eos
    cur_pos, write_idx = state["cur_pos"], int(state["write_idx"])
    full_mask, key_pos, cache = state["full_mask"], state["key_pos"], state["cache"]
    for step in range(1, gen.max_new_tokens):
        if early_stop and bool(done.all()):
            break
        logits, cache = llava_forward(lm, cfg, tok[:, None], None, None,
                                      cur_pos[:, None], cache, write_idx,
                                      full_mask, key_pos, stale_cache=True, lora=lora,
                                      lora_scaling=lora_scaling,
                                      adapter_ids=state.get("adapter_ids"))
        full_mask[:, write_idx] = 1
        key_pos[:, write_idx] = cur_pos
        nxt = draw(logits[:, 0])
        nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
        out[:, step] = nxt
        done = done | (nxt == eos)
        tok, cur_pos, write_idx = nxt, cur_pos + 1, write_idx + 1
    return out


@torch.no_grad()
def generate_decode(params: dict, cfg: LlavaConfig, state: dict, gen: GenerationConfig,
                    rng: Optional[torch.Generator] = None, compute_dtype=torch.bfloat16,
                    lora: Optional[dict] = None, lora_scaling: float = 0.0):
    """Decode phase: ``_decode_steps`` without the early stop (all rows run
    to the end), over a bf16 or an int8 cache.  Sampled: the first token and
    every step draw from ``rng`` in turn (JAX splits its key before each
    draw); a sampled config without ``rng`` raises.  Returns tokens
    [B, max_new_tokens] int32."""
    lora = _cast_params(lora, compute_dtype) if lora else None
    return _decode_steps(_cast_params(params, compute_dtype), cfg, state, gen,
                         lambda lg: _sample_token(lg, gen, rng), early_stop=False,
                         lora=lora, lora_scaling=lora_scaling)


# ---------------------------------------------------------------------------
# speculative decode (prompt-lookup drafting)
# ---------------------------------------------------------------------------

def _ngram_draft(hist, hist_len, cur_tok, k: int):
    """Prompt-lookup drafting on the device: propose the ``k-1`` tokens that
    followed the most recent previous occurrence of the current context in
    the token history.  Bigram context (prev_tok, cur_tok) preferred, unigram
    fallback, else repeat ``cur_tok`` (a harmless always-available draft).

    hist: [B, S] int32 history (prompt + emitted tokens, cur_tok LAST);
    hist_len: [B] valid lengths; returns [B, k-1] int32."""
    B, S = hist.shape
    idx = torch.arange(S, device=hist.device)[None]
    # exclude the current occurrence itself (hist_len-1 holds cur_tok)
    uni = (hist == cur_tok[:, None]) & (idx < (hist_len - 1)[:, None])
    prev = torch.gather(hist, 1, (hist_len - 2).clamp_min(0).long()[:, None])
    prev_hist = torch.cat([torch.full_like(hist[:, :1], -1), hist[:, :-1]], dim=1)
    bi = uni & (prev_hist == prev) & (hist_len[:, None] >= 2)
    j_bi = torch.where(bi, idx, -1).amax(dim=1)
    j_uni = torch.where(uni, idx, -1).amax(dim=1)
    j = torch.where(j_bi >= 0, j_bi, j_uni)                       # [B], -1 = none
    pos = j[:, None] + 1 + torch.arange(k - 1, device=hist.device)[None]
    valid = (j >= 0)[:, None] & (pos < hist_len[:, None])
    draft = torch.gather(hist, 1, pos.clamp(0, S - 1))
    return torch.where(valid, draft, cur_tok[:, None]).to(torch.int32)


def _put_rows(dst, start, keep, val):
    """``dst[b, start[b] + j] = val[b, j]`` where ``keep[b, j]``, IN PLACE.
    A position outside ``dst`` is dropped: its entry goes to the position
    modulo the width and rewrites that position's own old value (a row's
    consecutive positions stay distinct modulo the width)."""
    B, W = keep.shape
    N = dst.shape[1]
    pos = start.long()[:, None] + torch.arange(W, device=dst.device)[None]
    ok = keep & (pos >= 0) & (pos < N)
    slot = pos % N
    rows = torch.arange(B, device=dst.device)[:, None].expand(B, W)
    dst[rows, slot] = torch.where(ok, val.to(dst.dtype), dst[rows, slot])


@torch.no_grad()
def generate_decode_spec(params: dict, cfg: LlavaConfig, state: dict,
                         gen: GenerationConfig, spec_k: int, prompt_ids, prompt_len,
                         compute_dtype=torch.bfloat16, extra_hist=None,
                         return_state: bool = False):
    """Greedy speculative decode with prompt-lookup drafting.

    Each iteration runs ONE forward over a ``spec_k``-token window (cur_tok
    + spec_k-1 drafted tokens, intra-window causal) and emits the verified
    prefix: 1..spec_k tokens per forward.  A draft token is kept only when it
    EQUALS the argmax the model produces, so the emitted stream is the
    greedy stream of ``generate_decode`` whatever the drafts are; drafting
    only changes how many forwards it takes.  Caveat: the window's logits
    come from a T=W matmul whose f32 reduction order can differ from the T=1
    step's in the last bit, so an EXACT tie between two logits can resolve
    differently than in sequential decode (observable with degenerate
    random weights, immaterial for real checkpoints).

    The cache takes the speculative k/v eagerly: rejected slots never get
    their ``full_mask`` bit and are overwritten by later windows.  The
    state's cache, ``full_mask`` and ``key_pos`` are updated IN PLACE.  The
    loop reads one boolean from the device per window.

    prompt_ids/prompt_len: the right-padded prompt and its per-row valid
    lengths, the lookup corpus.  ``extra_hist`` [B, E] optionally prepends
    extra lookup text; rows must fill it fully.  Returns (tokens
    [B, max_new_tokens] int32, stats {"windows", "emitted"} as ints);
    ``emitted`` includes each row's prefill-sampled first token, so draft
    acceptance = (emitted - B - windows) / (windows * (spec_k - 1)).  With
    ``return_state`` the final decode state follows (``write_idx`` an int32
    [B] tensor)."""
    if gen.do_sample:
        raise ValueError("speculative decode is greedy-only (exactness "
                         "contract); use generate_decode for sampling")
    if spec_k < 2:
        raise ValueError("spec_k < 2 is plain greedy decode: use generate_decode")
    lm = _cast_params(params, compute_dtype)
    dev = state["logits"].device
    B, W = prompt_ids.shape[0], spec_k
    max_new, eos = gen.max_new_tokens, gen.eos_token_id

    parts = [] if extra_hist is None else [extra_hist.to(dev, torch.int32)]
    parts += [prompt_ids.to(dev, torch.int32),
              torch.zeros((B, max_new + W), dtype=torch.int32, device=dev)]
    hist = torch.cat(parts, dim=1)
    hist_len = prompt_len.to(dev, torch.int32)
    if extra_hist is not None:
        hist_len = hist_len + extra_hist.shape[1]

    first = torch.argmax(state["logits"], dim=-1).to(torch.int32)
    out = torch.full((B, max_new + W), eos, dtype=torch.int32, device=dev)
    out[:, 0] = first
    hist[torch.arange(B, device=dev), hist_len.long()] = first
    hist_len = hist_len + 1
    n_emit = torch.ones((B,), dtype=torch.int32, device=dev)
    done = first == eos
    write_idx = state["write_idx"]
    if not isinstance(write_idx, torch.Tensor):
        write_idx = torch.full((B,), write_idx, dtype=torch.int32, device=dev)
    cur_tok, cur_pos = first, state["cur_pos"]
    full_mask, key_pos, cache = state["full_mask"], state["key_pos"], state["cache"]
    j = torch.arange(W, device=dev)[None]
    n_windows = 0

    while bool((~done & (n_emit < max_new)).any()):
        draft = _ngram_draft(hist, hist_len, cur_tok, W)           # [B, W-1]
        tokens_in = torch.cat([cur_tok[:, None], draft], dim=1)
        logits, cache = llava_forward(lm, cfg, tokens_in, None, None, cur_pos[:, None] + j,
                                      cache, write_idx, full_mask, key_pos,
                                      stale_cache=True)
        t = torch.argmax(logits, dim=-1).to(torch.int32)           # [B, W]
        match = (draft == t[:, :-1]).to(torch.int32)               # [B, W-1]
        a = torch.cumprod(match, dim=1).sum(dim=1)
        within = (t == eos) & (j <= a[:, None])
        has_eos = within.any(dim=1)
        e = torch.where(has_eos, torch.argmax(within.to(torch.int32), dim=1) + 1, a + 1)
        # done rows and rows that already emitted max_new stop advancing
        e = torch.where(done | (n_emit >= max_new), 0, e).to(torch.int32)   # [B] emitted
        keep = j < e[:, None]
        _put_rows(out, n_emit, keep, t)
        _put_rows(hist, hist_len, keep, t)
        # kv slot j holds tokens_in[j]; valid exactly when j < e (the
        # rejected slots keep full_mask 0 and get overwritten later)
        _put_rows(full_mask, write_idx, keep, torch.ones_like(t))
        _put_rows(key_pos, write_idx, keep, cur_pos[:, None] + j)
        last = torch.gather(t, 1, (e - 1).clamp_min(0).long()[:, None])[:, 0]
        cur_tok = torch.where(e > 0, last, cur_tok)
        done = done | has_eos
        cur_pos, write_idx = cur_pos + e, write_idx + e
        n_emit, hist_len = n_emit + e, hist_len + e
        n_windows += 1

    tokens = out[:, :max_new]
    stats = {"windows": n_windows, "emitted": int(n_emit.clamp_max(max_new).sum())}
    if return_state:
        final_state = {"logits": state["logits"], "cache": cache, "full_mask": full_mask,
                       "key_pos": key_pos, "cur_pos": cur_pos, "write_idx": write_idx,
                       "adapter_ids": state["adapter_ids"]}
        return tokens, stats, final_state
    return tokens, stats


# ---------------------------------------------------------------------------
# serving: prefix reuse, the slot pool, decode quanta
# ---------------------------------------------------------------------------

def extract_prefix_state(state: dict, row: int) -> dict:
    """COPY one row of a prefill/decode state into a reusable 1-row prefix
    state (cache batch axis 2).  The serving engine keeps these in its prefix
    registry: a copy, so that the registry does not keep the whole chunk
    alive."""
    r = int(row)
    return {"cache": {name: a[:, :, r:r + 1].clone() for name, a in state["cache"].items()},
            "full_mask": state["full_mask"][r:r + 1].clone(),
            "key_pos": state["key_pos"][r:r + 1].clone(),
            "write_idx": state["write_idx"]}


@torch.no_grad()
def generate_prefill_prefix(params: dict, cfg: LlavaConfig, prefix_state: dict,
                            suffix_ids: torch.Tensor, pixel_values: Optional[torch.Tensor],
                            suffix_mask: torch.Tensor, prefix_len: int,
                            compute_dtype=torch.bfloat16, lora: Optional[dict] = None,
                            lora_scaling: float = 0.0,
                            adapter_ids: Optional[torch.Tensor] = None) -> dict:
    """Prefill that CONTINUES from a cached KV prefix.

    ``prefix_state``: a 1-row state (``extract_prefix_state``) whose cache
    slots ``[0, prefix_len)`` hold the KV of tokens identical across the
    batch.  ``suffix_ids`` [B, W]: each row's remaining right-padded tokens;
    ``pixel_values`` rides along when the image run lies in the suffix.
    Returns a state interchangeable with ``generate_prefill``'s where row
    b's prompt is ``prefix ++ suffix_b`` laid out in slots
    ``[0, prefix_len + W)``.

    The suffix runs as ONE ``stale_cache`` window of width W: attention reads
    the prefix cache gated to ``[0, prefix_len)`` (slots past it in a longer
    stored prefix stay masked) plus the intra-window causal fresh block, and
    each layer writes its W-slot slab at ``prefix_len`` in place, into a real
    B-row copy of the prefix (the stored row is not touched).  ``lora``,
    ``lora_scaling`` and ``adapter_ids`` as in ``generate_prefill`` (the
    prefix was built with the same set: the engine keys it by adapter)."""
    B, W = suffix_ids.shape
    dev = suffix_ids.device
    P = int(prefix_len)
    lm = _cast_params(params, compute_dtype)
    lora = _cast_params(lora, compute_dtype) if lora else None
    adapter_ids = (torch.zeros((B,), dtype=torch.int32, device=dev) if adapter_ids is None
                   else adapter_ids.to(dev, torch.int32))
    cache = {name: a.expand(-1, -1, B, *a.shape[3:]).contiguous()
             for name, a in prefix_state["cache"].items()}
    S = cache["k"].shape[1]
    slots = torch.arange(S, device=dev)[None]
    pfx_valid = (slots < P).to(torch.int32)
    full_mask = pfx_valid.expand(B, S).contiguous()
    key_pos = torch.where(pfx_valid > 0, slots, 0).to(torch.int32).expand(B, S).contiguous()
    suffix_pos = P + _positions(suffix_mask)                           # [B, W]
    logits, cache = llava_forward(lm, cfg, suffix_ids, pixel_values, suffix_mask, suffix_pos,
                                  cache, P, full_mask, key_pos, stale_cache=True,
                                  last_logit_only=True, lora=lora, lora_scaling=lora_scaling,
                                  adapter_ids=adapter_ids)
    full_mask[:, P:P + W] = suffix_mask.to(torch.int32)
    key_pos[:, P:P + W] = suffix_pos.to(torch.int32)
    return {"logits": logits[:, 0], "cache": cache, "full_mask": full_mask,
            "key_pos": key_pos,
            "cur_pos": (P + suffix_mask.sum(dim=1)).to(torch.int32),
            "write_idx": P + W, "adapter_ids": adapter_ids}


@torch.no_grad()
def decode_quantum(params: dict, cfg: LlavaConfig, state: dict, gen: GenerationConfig,
                   num_steps: int, rng: Optional[torch.Generator] = None,
                   compute_dtype=torch.bfloat16, lora: Optional[dict] = None,
                   lora_scaling: float = 0.0):
    """Continuous-batching decode: ``num_steps`` T=1 steps over a slot POOL
    whose rows are independent requests mid-generation: per-row write
    positions (``state["write_idx"]`` [B]), current tokens (``cur_tok``) and
    done flags (``done``).  Never samples from ``state["logits"]`` (the
    engine samples each row's first token at admission).  The pool's cache,
    ``full_mask`` and ``key_pos`` are updated IN PLACE; rows whose write
    position runs past the cache stop writing.  No host read.  Sampled: each
    step draws [B, V] noise from ``rng`` (JAX splits its key per step).
    ``lora`` applies each row's set from the state's ``adapter_ids``.

    Returns (tokens [B, num_steps] int32, new_state)."""
    lm = _cast_params(params, compute_dtype)
    lora = _cast_params(lora, compute_dtype) if lora else None
    adapter_ids = state.get("adapter_ids")
    eos = gen.eos_token_id
    tok, cur_pos, write_idx = state["cur_tok"], state["cur_pos"], state["write_idx"]
    full_mask, key_pos, cache, done = (state["full_mask"], state["key_pos"], state["cache"],
                                       state["done"])
    one = torch.ones((tok.shape[0], 1), dtype=torch.bool, device=tok.device)
    toks = []
    for _ in range(num_steps):
        logits, cache = llava_forward(lm, cfg, tok[:, None], None, None, cur_pos[:, None],
                                      cache, write_idx, full_mask, key_pos, stale_cache=True,
                                      lora=lora, lora_scaling=lora_scaling,
                                      adapter_ids=adapter_ids)
        _put_rows(full_mask, write_idx, one, one)
        _put_rows(key_pos, write_idx, one, cur_pos[:, None])
        nxt = _sample_token(logits[:, 0], gen, rng)
        nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
        done = done | (nxt == eos)
        toks.append(nxt)
        tok, cur_pos, write_idx = nxt, cur_pos + 1, write_idx + 1
    new_state = {**state, "cache": cache, "cur_pos": cur_pos, "write_idx": write_idx,
                 "cur_tok": tok, "done": done}
    return torch.stack(toks, dim=1), new_state


@torch.no_grad()
def decode_quantum_spec(params: dict, cfg: LlavaConfig, state: dict, hist_state: dict,
                        gen: GenerationConfig, num_steps: int, spec_k: int,
                        compute_dtype=torch.bfloat16, lora: Optional[dict] = None,
                        lora_scaling: float = 0.0):
    """``decode_quantum`` with prompt-lookup speculative windows
    (``generate_decode_spec``'s machinery on the serving slot pool).

    Each iteration runs ONE ``spec_k``-token verification forward per pool
    row (per-row W-slot cache writes; rejected slots never get their
    ``full_mask`` bit), and a row emits 1..``spec_k`` tokens per forward, so
    the quantum takes between ``ceil(num_steps / spec_k)`` and ``num_steps``
    forwards.  Greedy-only: a draft survives only when it equals the argmax,
    so the stream is that of ``decode_quantum``.

    ``hist_state``: ``{"hist": [B, Hcap] int32, "hist_len": [B] int32}``, the
    per-slot lookup corpus (prompt + emitted tokens, current token last),
    filled by the engine at admission and extended here.  The pool and the
    history are updated IN PLACE; the loop reads one boolean from the device
    per window.

    Returns ``(tokens [B, num_steps], n_emit [B], new_state,
    new_hist_state)``: row b's valid tokens are ``tokens[b, :n_emit[b]]``
    (done and idle rows emit 0); ``new_hist_state["n_fwd"]`` counts the
    forwards so far (a host int).  Unlike the JAX function, a window never
    carries a row past the quantum's end (see the loop).  ``lora`` as in
    ``decode_quantum``."""
    if gen.do_sample:
        raise ValueError("speculative decode is greedy-only (exactness "
                         "contract); use decode_quantum for sampling")
    if spec_k < 2:
        raise ValueError("spec_k < 2 is plain decode: use decode_quantum")
    lm = _cast_params(params, compute_dtype)
    lora = _cast_params(lora, compute_dtype) if lora else None
    adapter_ids = state.get("adapter_ids")
    dev = state["cur_tok"].device
    B, W, eos = state["cur_tok"].shape[0], spec_k, gen.eos_token_id
    out = torch.full((B, num_steps + W), eos, dtype=torch.int32, device=dev)   # W of slack
    n_emit = torch.zeros((B,), dtype=torch.int32, device=dev)
    cur_tok, cur_pos, write_idx = state["cur_tok"], state["cur_pos"], state["write_idx"]
    full_mask, key_pos, cache, done = (state["full_mask"], state["key_pos"], state["cache"],
                                       state["done"])
    hist, hist_len = hist_state["hist"], hist_state["hist_len"]
    j = torch.arange(W, device=dev)[None]
    n_fwd = 0

    while bool((~done & (n_emit < num_steps)).any()):
        draft = _ngram_draft(hist, hist_len, cur_tok, W)           # [B, W-1]
        tokens_in = torch.cat([cur_tok[:, None], draft], dim=1)
        logits, cache = llava_forward(lm, cfg, tokens_in, None, None, cur_pos[:, None] + j,
                                      cache, write_idx, full_mask, key_pos,
                                      stale_cache=True, lora=lora, lora_scaling=lora_scaling,
                                      adapter_ids=adapter_ids)
        t = torch.argmax(logits, dim=-1).to(torch.int32)           # [B, W]
        match = (draft == t[:, :-1]).to(torch.int32)               # [B, W-1]
        a = torch.cumprod(match, dim=1).sum(dim=1)
        within = (t == eos) & (j <= a[:, None])
        has_eos = within.any(dim=1)
        n_eos = torch.argmax(within.to(torch.int32), dim=1) + 1
        e = torch.where(has_eos, n_eos, a + 1)
        # a row emits no more than the quantum has room for: the verified
        # tokens past it are left to the next quantum, which derives them
        # again (advancing the row over them would drop them from the stream)
        e = torch.minimum(e, num_steps - n_emit)
        e = torch.where(done | (n_emit >= num_steps), 0, e).to(torch.int32)   # [B] emitted
        keep = j < e[:, None]
        _put_rows(out, n_emit, keep, t)
        _put_rows(hist, hist_len, keep, t)
        _put_rows(full_mask, write_idx, keep, torch.ones_like(t))
        _put_rows(key_pos, write_idx, keep, cur_pos[:, None] + j)
        last = torch.gather(t, 1, (e - 1).clamp_min(0).long()[:, None])[:, 0]
        cur_tok = torch.where(e > 0, last, cur_tok)
        done = done | (has_eos & (e > 0) & (n_eos <= e))
        cur_pos, write_idx = cur_pos + e, write_idx + e
        n_emit, hist_len = n_emit + e, hist_len + e
        n_fwd += 1

    new_state = {**state, "cache": cache, "cur_pos": cur_pos, "write_idx": write_idx,
                 "cur_tok": cur_tok, "done": done}
    hist_out = {"hist": hist, "hist_len": hist_len,
                "n_fwd": int(hist_state.get("n_fwd", 0)) + n_fwd}
    return out[:, :num_steps], n_emit, new_state, hist_out


def write_slot(pool: dict, chunk: dict, row: int, slot: int, first_tok: int,
               done0: bool) -> dict:
    """Admit one prefilled request into a slot of the decode pool, IN PLACE.

    ``chunk`` is a ``generate_prefill`` state (scalar ``write_idx``);
    ``row`` selects the request's row in it, ``slot`` the pool row to
    overwrite (host ints, both inside their ranges).  ``first_tok`` and
    ``done0`` come from sampling the chunk's prefill logits at admission."""
    row, slot = int(row), int(slot)
    n_rows, n_slots = chunk["full_mask"].shape[0], pool["full_mask"].shape[0]
    if not (0 <= row < n_rows and 0 <= slot < n_slots):
        raise IndexError(f"write_slot: row {row} of {n_rows}, slot {slot} of {n_slots}")
    for name, a in chunk["cache"].items():
        pool["cache"][name][:, :, slot] = a[:, :, row]
    for key in ("full_mask", "key_pos", "cur_pos"):
        pool[key][slot] = chunk[key][row]
    pool["write_idx"][slot] = int(chunk["write_idx"])
    pool["cur_tok"][slot] = int(first_tok)
    pool["done"][slot] = bool(done0)
    if "adapter_ids" in pool:
        pool["adapter_ids"][slot] = chunk["adapter_ids"][row]
    return pool


def write_slots(pool: dict, chunk: dict, slots, first_toks, done0) -> dict:
    """Admit a whole prefill chunk into the decode pool, IN PLACE: chunk row
    i goes to pool row ``slots[i]``; rows whose slot lies outside the pool
    (the engine marks prefill pad rows and requests that finished at
    admission with -1) are NOT admitted.  ``slots`` is host data (the engine
    builds it there): the rows to drop are taken out on the host, so that a
    negative slot can never wrap onto a live pool row and no two chunk rows
    share a target."""
    slots = np.asarray(slots.cpu() if isinstance(slots, torch.Tensor) else slots).astype(np.int64)
    n_slots = pool["full_mask"].shape[0]
    rows = np.nonzero((slots >= 0) & (slots < n_slots))[0]
    if len(set(slots[rows].tolist())) != len(rows):
        raise ValueError(f"write_slots: duplicate target slots in {slots.tolist()}")
    if not len(rows):
        return pool
    dev = pool["full_mask"].device
    src = torch.as_tensor(rows, device=dev)
    dst = torch.as_tensor(slots[rows], device=dev)
    for name, a in chunk["cache"].items():
        pool["cache"][name].index_copy_(2, dst, a.index_select(2, src))
    for key in ("full_mask", "key_pos", "cur_pos") + (("adapter_ids",) if "adapter_ids" in pool
                                                       else ()):
        pool[key].index_copy_(0, dst, chunk[key].index_select(0, src).to(pool[key].dtype))
    first = torch.as_tensor(np.asarray(first_toks), device=dev).to(torch.int32)
    done = torch.as_tensor(np.asarray(done0), device=dev).to(torch.bool)
    pool["write_idx"].index_fill_(0, dst, int(chunk["write_idx"]))
    pool["cur_tok"].index_copy_(0, dst, first.index_select(0, src))
    pool["done"].index_copy_(0, dst, done.index_select(0, src))
    return pool
