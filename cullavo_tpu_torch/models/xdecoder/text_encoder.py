"""X-Decoder language encoder (counterpart of
``cullavo_tpu/models/xdecoder/text_encoder.py``): the CLIP-style causal text
transformer (learned positions, pre-LN blocks with QuickGELU, final LN,
TF-style LayerNorm eps 1e-12), the sentence embedding at the argmax-id
(end-of-text) position through ``lang_proj``, and the eval-time class
embeddings averaged over the prompt-template ensemble, the token
embeddings (``forward_language_token``) and the train-time class
embeddings (one random template per class).

Parameters keep the JAX layout: stacked ``[L, ...]`` layer leaves, linear
weights ``[in, out]``.  ``import_hf_clip_text`` maps an HF CLIP text state
dict onto them (``clip_text_config`` gives its geometry).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from cullavo_tpu_torch.models.llava.clip_vit import layer_norm, quick_gelu
from cullavo_tpu_torch.models.xdecoder.decoder import l2_normalize
from cullavo_tpu_torch.utils.constants import get_prompt_templates, prompt_engineering

NEG_INF = -1e30
CLASS_CHUNK = 16   # classes per forward of the eval-time embeddings (x ~81 templates)


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    vocab_size: int = 49408       # CLIP BPE
    width: int = 512
    heads: int = 8
    layers: int = 12
    context_length: int = 77
    autoregressive: bool = True
    layer_norm_eps: float = 1e-12  # the reference's TF-style LayerNorm
    dim_lang: int = 512           # projection output


def init_text_encoder_params(cfg: TextEncoderConfig, gen: torch.Generator, device,
                             dtype=torch.float32) -> dict:
    W, L = cfg.width, cfg.layers

    def dense(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.02).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "token_embedding": dense(cfg.vocab_size, W),
        "positional_embedding": dense(cfg.context_length, W),
        "layers": {
            "ln1_s": ones(L, W), "ln1_b": zeros(L, W),
            "qkv_w": dense(L, W, 3 * W), "qkv_b": zeros(L, 3 * W),
            "o_w": dense(L, W, W), "o_b": zeros(L, W),
            "ln2_s": ones(L, W), "ln2_b": zeros(L, W),
            "fc_w": dense(L, W, 4 * W), "fc_b": zeros(L, 4 * W),
            "proj_w": dense(L, 4 * W, W), "proj_b": zeros(L, W),
        },
        "ln_final": {"scale": ones(W), "bias": zeros(W)},
        "lang_proj": dense(W, cfg.dim_lang),
        "logit_scale": zeros(),   # exp(0) = 1; a loaded checkpoint sets it
    }


def _text_layer(x, w, bias, cfg: TextEncoderConfig):
    B, T, W = x.shape
    H = cfg.heads
    hd = W // H
    eps = cfg.layer_norm_eps
    y = layer_norm(x, w["ln1_s"], w["ln1_b"], eps)
    q, k, v = (y @ w["qkv_w"] + w["qkv_b"]).split(W, dim=-1)
    q, k, v = (t.reshape(B, T, H, hd).transpose(1, 2) for t in (q, k, v))
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (hd ** -0.5)
    p = torch.softmax(s + bias, dim=-1).to(x.dtype)
    a = torch.matmul(p.float(), v.float()).to(x.dtype)
    x = x + (a.transpose(1, 2).reshape(B, T, W) @ w["o_w"] + w["o_b"])
    y = layer_norm(x, w["ln2_s"], w["ln2_b"], eps)
    return x + (quick_gelu(y @ w["fc_w"] + w["fc_b"]) @ w["proj_w"] + w["proj_b"])


def text_transformer_forward(params, cfg: TextEncoderConfig, input_ids, attention_mask,
                             remat: bool = False):
    """[B, T] ids -> last hidden state [B, T, W].  ``remat`` checkpoints
    each layer (``torch.utils.checkpoint``)."""
    B, T = input_ids.shape
    dev = params["token_embedding"].device
    input_ids = input_ids.to(dev).long()
    x = params["token_embedding"][input_ids] + params["positional_embedding"][None, :T]
    if cfg.autoregressive:
        # the reference applies only the causal mask here: padded keys stay
        # visible (the EOT row and those before it are unaffected)
        ok = torch.tril(torch.ones((T, T), dtype=torch.bool, device=dev))[None, None]
    else:
        ok = (attention_mask.to(dev) != 0)[:, None, None, :]
    bias = torch.where(ok, 0.0, NEG_INF).to(torch.float32)
    lw = params["layers"]
    for i in range(lw["qkv_w"].shape[0]):
        w = {k: v[i] for k, v in lw.items()}
        if remat:
            x = checkpoint(_text_layer, x, w, bias, cfg, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _text_layer(x, w, bias, cfg)
    eps = cfg.layer_norm_eps
    return layer_norm(x, params["ln_final"]["scale"], params["ln_final"]["bias"], eps)


def _eot_rows(hidden, input_ids):
    eot = torch.argmax(input_ids.to(hidden.device).long(), dim=-1)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), eot]


def forward_language(params, cfg, input_ids, attention_mask, norm=True, remat=False):
    """Sentence embeddings [B, dim_lang] at the argmax-id (EOT) position."""
    hidden = text_transformer_forward(params, cfg, input_ids, attention_mask, remat=remat)
    cls = _eot_rows(hidden, input_ids) @ params["lang_proj"]
    return l2_normalize(cls) if norm else cls


def forward_language_token(params, cfg, input_ids, attention_mask, norm=False, remat=False):
    """(token embeddings [B, T, dim_lang], sentence embedding [B, dim_lang]),
    both through ``lang_proj``."""
    hidden = text_transformer_forward(params, cfg, input_ids, attention_mask, remat=remat)
    token = hidden @ params["lang_proj"]
    cls = _eot_rows(hidden, input_ids) @ params["lang_proj"]
    if norm:
        return l2_normalize(token), l2_normalize(cls)
    return token, cls


def _clean(name: str) -> str:
    return name.replace("-other", "").replace("-merged", "").replace("-stuff", "")


def class_embeddings_ensembled(params, cfg, tokenize: Callable, class_names: Sequence[str],
                               add_background: bool = False):
    """Eval-time class embeddings: the mean over the prompt-template
    ensemble per class, renormalized.  ``tokenize(texts) -> (ids [N, T],
    mask [N, T])`` numpy arrays.  The classes are encoded ``CLASS_CHUNK``
    at a time (one forward over all their templates' sentences)."""
    templates = get_prompt_templates()
    names = list(class_names) + (["A background in coco."] if add_background else [])
    groups = [[name] if name == "A background in coco."
              else [t.format(_clean(name)) for t in templates] for name in names]
    dev = params["token_embedding"].device
    out = []
    for i in range(0, len(groups), CLASS_CHUNK):
        part = groups[i:i + CLASS_CHUNK]
        ids, mask = tokenize([t for g in part for t in g])
        emb = forward_language(params, cfg, torch.as_tensor(np.asarray(ids), device=dev),
                               torch.as_tensor(np.asarray(mask), device=dev), norm=True)
        start = 0
        for g in part:
            mean = emb[start:start + len(g)].mean(dim=0)
            out.append(mean / (torch.linalg.vector_norm(mean) + 1e-7))
            start += len(g)
    return torch.stack(out)


def class_embeddings_train(params, cfg, tokenize, class_names, rng: np.random.Generator,
                           add_background: bool = False):
    """Train-time class embeddings: one random prompt template per class
    (drawn from ``rng``), normalized."""
    texts = [prompt_engineering(_clean(c), topk=10000, suffix=".", rng=rng) for c in class_names]
    if add_background:
        texts.append("A background in coco.")
    ids, mask = tokenize(texts)
    dev = params["token_embedding"].device
    return forward_language(params, cfg, torch.as_tensor(np.asarray(ids), device=dev),
                            torch.as_tensor(np.asarray(mask), device=dev), norm=True)


def clip_text_config(width: int = 768, heads: int = 12, layers: int = 12,
                     dim_lang: int = 768) -> TextEncoderConfig:
    """HF ``CLIPTextModelWithProjection`` geometry (CLIP-L/336 defaults);
    HF's LayerNorms use eps 1e-5, the reference's own text tower 1e-12."""
    return TextEncoderConfig(width=width, heads=heads, layers=layers, dim_lang=dim_lang,
                             layer_norm_eps=1e-5)


def import_hf_clip_text(state, cfg: TextEncoderConfig, device="cpu") -> dict:
    """An HF ``CLIPModel`` / ``CLIPTextModelWithProjection`` state dict
    (numpy arrays or tensors) -> the text encoder's parameters on
    ``device``: q, k, v packed into ``qkv``, linear weights transposed; a
    state without ``logit_scale`` (a text-only export) gets 0 (scale 1)."""
    sd = {k.replace("text_model.", ""): np.asarray(v, np.float32) for k, v in state.items()}

    def stack(fmt, transpose=False):
        return np.stack([sd[fmt.format(i)].T if transpose else sd[fmt.format(i)]
                         for i in range(cfg.layers)])

    enc = "encoder.layers.{}."
    qkv_w = np.concatenate([stack(enc + f"self_attn.{n}_proj.weight", True) for n in "qkv"],
                           axis=2)
    qkv_b = np.concatenate([stack(enc + f"self_attn.{n}_proj.bias") for n in "qkv"], axis=1)
    params = {
        "token_embedding": sd["embeddings.token_embedding.weight"],
        "positional_embedding": sd["embeddings.position_embedding.weight"],
        "layers": {
            "ln1_s": stack(enc + "layer_norm1.weight"), "ln1_b": stack(enc + "layer_norm1.bias"),
            "qkv_w": qkv_w, "qkv_b": qkv_b,
            "o_w": stack(enc + "self_attn.out_proj.weight", True),
            "o_b": stack(enc + "self_attn.out_proj.bias"),
            "ln2_s": stack(enc + "layer_norm2.weight"), "ln2_b": stack(enc + "layer_norm2.bias"),
            "fc_w": stack(enc + "mlp.fc1.weight", True), "fc_b": stack(enc + "mlp.fc1.bias"),
            "proj_w": stack(enc + "mlp.fc2.weight", True), "proj_b": stack(enc + "mlp.fc2.bias"),
        },
        "ln_final": {"scale": sd["final_layer_norm.weight"], "bias": sd["final_layer_norm.bias"]},
        "lang_proj": sd["text_projection.weight"].T,
        "logit_scale": sd.get("logit_scale", np.zeros((), np.float32)).reshape(()),
    }

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, np.float32)).to(device)

    return conv(params)
