"""BLIP-2 assembly: EVA-ViT-g -> Q-Former -> projection -> language tower
(counterpart of ``cullavo_tpu/models/blip2/modeling.py``).  The Flan-T5
tower (``blip2-flan-t5-*``, the reference's headline BLIP-2 checkpoint) is
ported: forward, greedy and beam decode.  The OPT tower (``blip2-opt-*``)
and InstructBLIP's Vicuna tower raise and name the slice they wait for;
``import_blip2_torch`` (which takes a transformers model) has no
counterpart: the snapshot path comes with a later slice.
"""
from __future__ import annotations

import torch

from cullavo_tpu_torch.models.blip2.config import Blip2Config
from cullavo_tpu_torch.models.blip2.qformer import init_qformer_params, qformer_forward
from cullavo_tpu_torch.models.blip2.t5 import (init_t5_params, t5_beam_generate, t5_forward,
                                               t5_generate)
from cullavo_tpu_torch.models.blip2.vision import (blip2_vision_forward,
                                                   init_blip2_vision_params, normal)


def _t5_only(cfg: Blip2Config, what: str) -> None:
    if cfg.text_is_opt:
        raise NotImplementedError(f"{what}: the OPT tower (blip2-opt-*) waits for the BLIP-2 "
                                  "OPT slice")
    if not cfg.text_is_t5:
        raise NotImplementedError(f"{what}: the Vicuna tower waits for the InstructBLIP slice")


def init_blip2_params(cfg: Blip2Config, gen: torch.Generator, device,
                      dtype=torch.float32) -> dict:
    """Random parameters in the JAX layout and scales, drawn from ``gen``
    (a seeded ``torch.Generator`` on ``device``): vision, Q-Former, query
    tokens, projection, then the T5 tower."""
    _t5_only(cfg, "init_blip2_params")
    D_q, D_lm = cfg.qformer.hidden_size, cfg.lm_hidden_size
    params = {
        "vision": init_blip2_vision_params(cfg.vision, gen, device, dtype),
        "qformer": init_qformer_params(cfg.qformer, gen, device, dtype),
        "query_tokens": normal(gen, (cfg.num_query_tokens, D_q), 0.02, dtype, device),
        "projection": {"w": normal(gen, (D_q, D_lm), 0.02, dtype, device),
                       "b": torch.zeros((D_lm,), dtype=dtype, device=device)},
    }
    params["language_model"] = init_t5_params(cfg.text, gen, device, dtype)
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


def _t5_inputs(params, lang_img, input_ids, attention_mask):
    """[queries; prompt] embeddings and their mask, the T5 encoder's input."""
    text = params["language_model"]["embed_tokens"][input_ids].to(lang_img.dtype)
    ones = torch.ones(lang_img.shape[:2], dtype=attention_mask.dtype, device=lang_img.device)
    return torch.cat([lang_img, text], dim=1), torch.cat([ones, attention_mask], dim=1)


def blip2_forward(params: dict, cfg: Blip2Config, pixel_values, input_ids, attention_mask,
                  qformer_text_ids=None, qformer_text_mask=None, decoder_input_ids=None,
                  compute_dtype=None) -> torch.Tensor:
    """T5 tower: encodes [queries; prompt] and returns the decoder's logits
    [B, Td, V] over ``decoder_input_ids``."""
    _t5_only(cfg, "blip2_forward")
    lang_img = encode_image(params, cfg, pixel_values, qformer_text_ids, qformer_text_mask,
                            compute_dtype)
    embeds, mask = _t5_inputs(params, lang_img, input_ids, attention_mask)
    return t5_forward(params["language_model"], cfg.text, embeds, mask, decoder_input_ids)


def blip2_generate(params: dict, cfg: Blip2Config, pixel_values, input_ids, attention_mask,
                   max_new_tokens: int, eos_token_id: int = -1, qformer_text_ids=None,
                   qformer_text_mask=None, compute_dtype=None) -> torch.Tensor:
    """Greedy decode through the T5 tower; returns [B, max_new_tokens]."""
    _t5_only(cfg, "blip2_generate")
    lang_img = encode_image(params, cfg, pixel_values, qformer_text_ids, qformer_text_mask,
                            compute_dtype)
    embeds, mask = _t5_inputs(params, lang_img, input_ids, attention_mask)
    return t5_generate(params["language_model"], cfg.text, embeds, mask, max_new_tokens,
                       eos_token_id)


def blip2_beam_generate(params: dict, cfg: Blip2Config, pixel_values, input_ids,
                        attention_mask, max_new_tokens: int, num_beams: int = 5,
                        length_penalty: float = 1.0, eos_token_id: int = -1,
                        qformer_text_ids=None, qformer_text_mask=None,
                        compute_dtype=None) -> torch.Tensor:
    """Beam-search decode through the T5 tower (the reference's settings:
    beam 5, length penalty -1, at most 10 new tokens), padded with the T5
    config's pad id; returns [B, max_new_tokens]."""
    _t5_only(cfg, "blip2_beam_generate")
    lang_img = encode_image(params, cfg, pixel_values, qformer_text_ids, qformer_text_mask,
                            compute_dtype)
    embeds, mask = _t5_inputs(params, lang_img, input_ids, attention_mask)
    return t5_beam_generate(params["language_model"], cfg.text, embeds, mask, max_new_tokens,
                            num_beams=num_beams, length_penalty=length_penalty,
                            eos_token_id=eos_token_id)
