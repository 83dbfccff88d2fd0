"""BLIP-2 / InstructBLIP assembly: EVA-ViT-g -> Q-Former -> projection ->
language tower (counterpart of ``cullavo_tpu/models/blip2/modeling.py``).
Two towers are ported: Flan-T5 (``blip2-flan-t5-*``, the reference's
headline BLIP-2 checkpoint; encoder-decoder) and LLaMA / Vicuna
(``instructblip-vicuna-*``, the decoder of ``models/llava/llama.py``, whose
S-major cache ``[L, S, B, KV, hd]`` it shares): forward, greedy and beam
decode, with InstructBLIP's instruction text into the Q-Former.  The
decoder-only towers prefill once per row (a cached forward at slot 0,
future slots masked) and decode one token a step with ``stale_cache``
(on the card in f32: K12 over each layer's slice).  The zero-shot ImageNet
branches are ``blip2_image_embed`` and ``blip2_text_embed``.  The OPT tower
(``blip2-opt-*``) raises and names the item it waits for.  A snapshot's
weights come through ``checkpoint/zoo_import.py`` (JAX's
``import_blip2_torch`` takes a transformers model).
"""
from __future__ import annotations

import torch

from cullavo_tpu_torch.models.beam import beam_search
from cullavo_tpu_torch.models.blip2.config import Blip2Config
from cullavo_tpu_torch.models.blip2.qformer import (init_qformer_params, qformer_encode_text,
                                                    qformer_forward)
from cullavo_tpu_torch.models.blip2.t5 import (init_t5_params, t5_beam_generate, t5_forward,
                                               t5_generate)
from cullavo_tpu_torch.models.blip2.vision import (blip2_vision_forward,
                                                   init_blip2_vision_params, normal)
from cullavo_tpu_torch.models.llava.llama import init_kv_cache, init_llama_params, llama_forward


def _refuse_opt(cfg: Blip2Config, what: str) -> None:
    if cfg.text_is_opt:
        raise NotImplementedError(f"{what}: the OPT tower (blip2-opt-*) waits for the BLIP-2 "
                                  "OPT item (queue 1 item 2.6 of ROADMAP.md)")


def init_blip2_params(cfg: Blip2Config, gen: torch.Generator, device,
                      dtype=torch.float32) -> dict:
    """Random parameters in the JAX layout and scales, drawn from ``gen``
    (a seeded ``torch.Generator`` on ``device``): vision, Q-Former, query
    tokens, projection, then the T5 or LLaMA tower."""
    _refuse_opt(cfg, "init_blip2_params")
    D_q, D_lm = cfg.qformer.hidden_size, cfg.lm_hidden_size
    params = {
        "vision": init_blip2_vision_params(cfg.vision, gen, device, dtype),
        "qformer": init_qformer_params(cfg.qformer, gen, device, dtype),
        "query_tokens": normal(gen, (cfg.num_query_tokens, D_q), 0.02, dtype, device),
        "projection": {"w": normal(gen, (D_q, D_lm), 0.02, dtype, device),
                       "b": torch.zeros((D_lm,), dtype=dtype, device=device)},
    }
    init_lm = init_t5_params if cfg.text_is_t5 else init_llama_params
    params["language_model"] = init_lm(cfg.text, gen, device, dtype)
    return params


def encode_image(params: dict, cfg: Blip2Config, pixel_values: torch.Tensor,
                 qformer_text_ids=None, qformer_text_mask=None,
                 compute_dtype=None) -> torch.Tensor:
    """pixel_values [B, 3, H, W] -> projected query features [B, Q, D_lm]."""
    img = blip2_vision_forward(params["vision"], cfg.vision, pixel_values, compute_dtype)
    queries = params["query_tokens"].expand(img.shape[0], *params["query_tokens"].shape)
    qh = qformer_forward(params["qformer"], cfg.qformer, queries, img,
                         text_ids=qformer_text_ids, text_mask=qformer_text_mask,
                         compute_dtype=compute_dtype)
    return qh @ params["projection"]["w"] + params["projection"]["b"]


def _prefix_inputs(params, lang_img, input_ids, attention_mask):
    """[queries; prompt] embeddings and their mask [B, Q + T]: the T5
    encoder's input, the decoder-only towers' prompt."""
    text = params["language_model"]["embed_tokens"][input_ids.long()].to(lang_img.dtype)
    ones = torch.ones(lang_img.shape[:2], dtype=attention_mask.dtype, device=lang_img.device)
    return torch.cat([lang_img, text], dim=1), torch.cat([ones, attention_mask], dim=1)


def _positions(mask: torch.Tensor) -> torch.Tensor:
    """Logical positions of a right-padded prompt: cumsum(mask) * mask - 1,
    at least 0."""
    return (torch.cumsum(mask, dim=1) * mask - 1).clamp_min(0)


def _lm_embed(params: dict, ids: torch.Tensor) -> torch.Tensor:
    return params["language_model"]["embed_tokens"][ids.long()]


def _lm_logits(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    return hidden @ params["language_model"]["lm_head"]


def _lm_forward(params, cfg: Blip2Config, embeds, mask, pos, cache=None, cache_index=None,
                key_position_ids=None, stale_cache=False):
    """The LLaMA tower; without a cache the attention takes the key-padding
    bias (JAX's ``sdpa`` branch off the TPU), not the flash kernel's
    right-padded contract."""
    return llama_forward(params["language_model"], cfg.text, embeds, mask, pos, cache,
                         cache_index, key_position_ids, use_flash=False if cache is None else None,
                         stale_cache=stale_cache)


def blip2_forward(params: dict, cfg: Blip2Config, pixel_values, input_ids, attention_mask,
                  qformer_text_ids=None, qformer_text_mask=None, decoder_input_ids=None,
                  compute_dtype=None) -> torch.Tensor:
    """T5 tower: encodes [queries; prompt] and returns the decoder's logits
    [B, Td, V] over ``decoder_input_ids``.  LLaMA tower: the logits [B, Q +
    T, V] of [queries; prompt]."""
    _refuse_opt(cfg, "blip2_forward")
    lang_img = encode_image(params, cfg, pixel_values, qformer_text_ids, qformer_text_mask,
                            compute_dtype)
    embeds, mask = _prefix_inputs(params, lang_img, input_ids, attention_mask)
    if cfg.text_is_t5:
        return t5_forward(params["language_model"], cfg.text, embeds, mask, decoder_input_ids)
    h, _ = _lm_forward(params, cfg, embeds, mask, _positions(mask))
    return _lm_logits(params, h)


def _prefill(params, cfg: Blip2Config, embeds, mask0, spare: int):
    """The decoder-only prompt written into a zeroed cache of T + ``spare``
    slots (future slots masked, their positions 0): (cache, full mask, key
    positions, logits of each row's last valid position, that position)."""
    B, T = mask0.shape
    dev = embeds.device
    pos0 = _positions(mask0)
    cache = init_kv_cache(cfg.text, B, T + spare, embeds.dtype, device=dev)
    full_mask = torch.cat([mask0, torch.zeros((B, spare), dtype=mask0.dtype, device=dev)], dim=1)
    key_pos = torch.cat([pos0, torch.zeros((B, spare), dtype=pos0.dtype, device=dev)], dim=1)
    h, cache = _lm_forward(params, cfg, embeds, full_mask, pos0, cache, 0, key_pos)
    rows = torch.arange(B, device=dev)
    last_idx = mask0.sum(dim=1).long() - 1
    return cache, full_mask, key_pos, _lm_logits(params, h[rows, last_idx]), pos0[rows, last_idx]


def _step(params, cfg: Blip2Config, tok, cache, full_mask, key_pos, idx: int, new_pos, dtype):
    """One token a row at cache slot ``idx`` (stale cache, written in place),
    then the slot marked valid at ``new_pos``; returns the last hidden
    state's logits."""
    emb = _lm_embed(params, tok[:, None]).to(dtype)
    h, _ = _lm_forward(params, cfg, emb, full_mask, new_pos[:, None], cache, idx, key_pos,
                       stale_cache=True)
    full_mask[:, idx] = 1
    key_pos[:, idx] = new_pos.to(key_pos.dtype)
    return _lm_logits(params, h[:, -1])


def blip2_generate(params: dict, cfg: Blip2Config, pixel_values, input_ids, attention_mask,
                   max_new_tokens: int, eos_token_id: int = -1, qformer_text_ids=None,
                   qformer_text_mask=None, compute_dtype=None) -> torch.Tensor:
    """Greedy decode; returns [B, max_new_tokens] int32.  The LLaMA tower
    fills a row's slots after its eos with 0, and stops once every row is
    done (JAX's ``while_loop``)."""
    _refuse_opt(cfg, "blip2_generate")
    lang_img = encode_image(params, cfg, pixel_values, qformer_text_ids, qformer_text_mask,
                            compute_dtype)
    embeds, mask0 = _prefix_inputs(params, lang_img, input_ids, attention_mask)
    if cfg.text_is_t5:
        return t5_generate(params["language_model"], cfg.text, embeds, mask0, max_new_tokens,
                           eos_token_id)
    B, T = mask0.shape
    cache, full_mask, key_pos, logits, last_pos = _prefill(params, cfg, embeds, mask0,
                                                           max_new_tokens)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = torch.zeros((B, max_new_tokens), dtype=torch.int32, device=embeds.device)
    done = torch.zeros((B,), dtype=torch.bool, device=embeds.device)
    for i in range(max_new_tokens):
        out[:, i] = torch.where(done, out[:, i], tok)
        done = done | (tok == eos_token_id)
        # the step after the last one, or after every row is done, is never read
        if i + 1 == max_new_tokens or bool(done.all()):
            break
        last_pos = last_pos + 1
        logits = _step(params, cfg, tok, cache, full_mask, key_pos, T + i, last_pos,
                       embeds.dtype)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    return out


def blip2_beam_generate(params: dict, cfg: Blip2Config, pixel_values, input_ids,
                        attention_mask, max_new_tokens: int, num_beams: int = 5,
                        length_penalty: float = 1.0, eos_token_id: int = -1,
                        pad_token_id: int = 0, qformer_text_ids=None, qformer_text_mask=None,
                        compute_dtype=None) -> torch.Tensor:
    """Beam-search decode (the reference's BLIP-2 / InstructBLIP settings:
    beam 5, length penalty -1, at most 10 new tokens); returns [B,
    max_new_tokens].  The T5 tower pads with its config's pad id.  The
    LLaMA tower prefills each row once into a cache of T + max_new_tokens +
    1 slots, repeats it to B x num_beams rows along the cache's batch axis
    (2 of [L, S, B, KV, hd]) and runs ``models.beam.beam_search`` with the
    state (cache, full mask, key positions): a step writes its slot in
    place, and the reorder gathers only the cache (the masks and positions
    of a row's beams are equal), as JAX's does."""
    _refuse_opt(cfg, "blip2_beam_generate")
    lang_img = encode_image(params, cfg, pixel_values, qformer_text_ids, qformer_text_mask,
                            compute_dtype)
    embeds, mask0 = _prefix_inputs(params, lang_img, input_ids, attention_mask)
    if cfg.text_is_t5:
        return t5_beam_generate(params["language_model"], cfg.text, embeds, mask0,
                                max_new_tokens, num_beams=num_beams,
                                length_penalty=length_penalty, eos_token_id=eos_token_id)
    B, T = mask0.shape
    nb = num_beams
    cache, full_mask, key_pos, logits, last_pos = _prefill(params, cfg, embeds, mask0,
                                                           max_new_tokens + 1)
    cache = {k: a.repeat_interleave(nb, dim=2) for k, a in cache.items()}
    full_mask, key_pos, last_pos, init_logits = (
        a.repeat_interleave(nb, dim=0) for a in (full_mask, key_pos, last_pos, logits.float()))

    def step_fn(tok, state, step_idx):
        cache, full_mask, key_pos = state
        logits = _step(params, cfg, tok, cache, full_mask, key_pos, T + step_idx - 1,
                       last_pos + step_idx, embeds.dtype)
        return logits.float(), (cache, full_mask, key_pos)

    def reorder_fn(state, flat_parent):
        cache, full_mask, key_pos = state
        return ({k: a.index_select(2, flat_parent) for k, a in cache.items()}, full_mask,
                key_pos)

    return beam_search(step_fn, reorder_fn, init_logits, (cache, full_mask, key_pos), B, nb,
                       max_new_tokens, eos_token_id, pad_token_id=pad_token_id,
                       length_penalty=length_penalty)


def _l2_rows(pooled: torch.Tensor) -> torch.Tensor:
    return pooled / torch.linalg.vector_norm(pooled.float(), dim=-1,
                                             keepdim=True).to(pooled.dtype)


def blip2_image_embed(params: dict, cfg: Blip2Config, pixel_values,
                      compute_dtype=None) -> torch.Tensor:
    """The L2-normalised first query state [B, D_q] (no text into the
    Q-Former): the image branch of the zero-shot ImageNet eval."""
    img = blip2_vision_forward(params["vision"], cfg.vision, pixel_values, compute_dtype)
    queries = params["query_tokens"].expand(img.shape[0], *params["query_tokens"].shape)
    qh = qformer_forward(params["qformer"], cfg.qformer, queries, img,
                         compute_dtype=compute_dtype)
    return _l2_rows(qh[:, 0])


def blip2_text_embed(params: dict, cfg: Blip2Config, text_ids, text_mask,
                     compute_dtype=None) -> torch.Tensor:
    """The L2-normalised pooled Q-Former text state [B, D_q]: the class
    branch of the zero-shot ImageNet eval."""
    return _l2_rows(qformer_encode_text(params["qformer"], cfg.qformer, text_ids, text_mask,
                                        compute_dtype))
