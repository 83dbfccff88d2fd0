"""Import HuggingFace LLaVA weights (safetensors shards or state dicts) into
the port's stacked-params tree (counterpart of
``cullavo_tpu/checkpoint/hf_import.py``).

Both HF naming eras map to one canonical form (``_normalize_key``): new
(transformers >= 4.52: ``model.language_model.*``, ``model.vision_tower.*``,
``model.multi_modal_projector.*``) and old (``language_model.model.*``,
``vision_tower.vision_model.*``, ``multi_modal_projector.*``).  Linear
weights are transposed from HF [out, in] to [in, out]; per-layer tensors are
stacked along a leading layer axis.

Where the JAX package differs, the port does not copy it:
``llava_config_from_json`` raises when ``config.json`` is missing (JAX
quietly returns the 7B config), and ``load_llava_safetensors`` reads the
shards with the port's own reader, keeps the snapshot's dtype unless told
otherwise (JAX converts to f32 on the host, ~28 GB for 7B; its numpy reader
cannot read bf16 at all) and builds the stacks on ``device``.

A text-only ``LlamaForCausalLM`` snapshot (the topic classifier's LLaMA-2):
``llama_config_from_json`` and ``load_llama_causal_lm_safetensors``.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Mapping

import torch

from cullavo_tpu_torch.checkpoint.safetensors_io import read_safetensors
from cullavo_tpu_torch.models.llava.config import ClipVisionConfig, LlamaConfig, LlavaConfig

__all__ = ["from_hf_state_dict", "llava_config_from_json", "load_llava_safetensors",
           "to_hf_state_dict", "llama_from_causal_lm_state_dict", "llama_config_from_json",
           "load_llama_causal_lm_safetensors", "read_config_json", "read_safetensors_dir"]


def read_config_json(model_dir: str) -> dict:
    """A snapshot's ``config.json``; a missing one raises."""
    path = os.path.join(model_dir, "config.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no config.json under {model_dir}: the architecture is "
                                "read from the snapshot, never assumed")
    with open(path) as f:
        return json.load(f)


def llava_config_from_json(model_dir: str) -> LlavaConfig:
    """A LlavaConfig from an HF snapshot's ``config.json`` (its
    ``text_config`` / ``vision_config`` fields that the dataclasses know)."""
    hf = read_config_json(model_dir)
    tc, vc = hf.get("text_config", {}), hf.get("vision_config", {})

    def take(cls, src):
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in src.items() if k in fields})

    return LlavaConfig(
        vision=take(ClipVisionConfig, vc), text=take(LlamaConfig, tc),
        projector_hidden_act=hf.get("projector_hidden_act", "gelu"),
        vision_feature_layer=hf.get("vision_feature_layer", -2),
        vision_feature_select_strategy=hf.get("vision_feature_select_strategy", "default"),
        image_token_id=hf.get("image_token_index", 32000),
        pad_token_id=hf.get("pad_token_id", 32001))


_PREFIXES = (("model.language_model.", "lm."), ("language_model.model.", "lm."),
             ("language_model.lm_head.", "lm_head."),
             ("model.vision_tower.vision_model.", "vt."), ("vision_tower.vision_model.", "vt."),
             ("model.multi_modal_projector.", "proj."), ("multi_modal_projector.", "proj."))


def _normalize_key(key: str) -> str:
    """Map either HF naming era to a canonical one."""
    for old, new in _PREFIXES:
        if key.startswith(old):
            return new + key[len(old):]
    return key


_LM_LAYER = {"input_ln": ("input_layernorm.weight", False),
             "q": ("self_attn.q_proj.weight", True), "k": ("self_attn.k_proj.weight", True),
             "v": ("self_attn.v_proj.weight", True), "o": ("self_attn.o_proj.weight", True),
             "post_ln": ("post_attention_layernorm.weight", False),
             "gate": ("mlp.gate_proj.weight", True), "up": ("mlp.up_proj.weight", True),
             "down": ("mlp.down_proj.weight", True)}
_VT_LAYER = {"ln1_scale": ("layer_norm1.weight", False), "ln1_bias": ("layer_norm1.bias", False),
             "q": ("self_attn.q_proj.weight", True), "q_b": ("self_attn.q_proj.bias", False),
             "k": ("self_attn.k_proj.weight", True), "k_b": ("self_attn.k_proj.bias", False),
             "v": ("self_attn.v_proj.weight", True), "v_b": ("self_attn.v_proj.bias", False),
             "o": ("self_attn.out_proj.weight", True), "o_b": ("self_attn.out_proj.bias", False),
             "ln2_scale": ("layer_norm2.weight", False), "ln2_bias": ("layer_norm2.bias", False),
             "fc1": ("mlp.fc1.weight", True), "fc1_b": ("mlp.fc1.bias", False),
             "fc2": ("mlp.fc2.weight", True), "fc2_b": ("mlp.fc2.bias", False)}


def _getter(sd: Mapping, dtype, device):
    """get(name) -> the tensor on ``device`` in ``dtype`` (None: as stored);
    stack(fmt, n, transpose) -> the per-layer tensors stacked there."""
    def get(name):
        t = torch.as_tensor(sd[name])
        return t.to(device=device, dtype=dtype or t.dtype)

    def stack(fmt, n, transpose=False):
        return torch.stack([get(fmt.format(i)).T if transpose else get(fmt.format(i))
                            for i in range(n)])

    return get, stack


def _lm_tree(get, stack, prefix: str, n: int) -> dict:
    return {"embed_tokens": get(f"{prefix}embed_tokens.weight"),
            "layers": {key: stack(f"{prefix}layers.{{}}.{suffix}", n, tr)
                       for key, (suffix, tr) in _LM_LAYER.items()},
            "norm": get(f"{prefix}norm.weight")}


def from_hf_state_dict(state: Mapping, cfg: LlavaConfig, dtype=None, device="cpu") -> dict:
    """The LLaVA params tree from a flat HF state dict (tensors or numpy
    arrays), on ``device`` in ``dtype`` (None: each tensor's own dtype)."""
    sd = {_normalize_key(k): v for k, v in state.items()}
    get, stack = _getter(sd, dtype, device)
    Lt, Lv = cfg.text.num_hidden_layers, cfg.vision.num_hidden_layers
    lm = _lm_tree(get, stack, "lm.", Lt)
    if "lm_head.weight" in sd:
        lm["lm_head"] = get("lm_head.weight").T.contiguous()
    # HF CLIP has a historical typo: "pre_layrnorm"
    pre_ln = "vt.pre_layrnorm" if "vt.pre_layrnorm.weight" in sd else "vt.pre_layernorm"
    patch_w = get("vt.embeddings.patch_embedding.weight")           # [D, 3, P, P]
    vt = {
        "class_embedding": get("vt.embeddings.class_embedding"),
        "patch_embedding": patch_w.reshape(patch_w.shape[0], -1).T.contiguous(),   # [3*P*P, D]
        "position_embedding": get("vt.embeddings.position_embedding.weight"),
        "pre_ln": {"scale": get(f"{pre_ln}.weight"), "bias": get(f"{pre_ln}.bias")},
        "layers": {key: stack(f"vt.encoder.layers.{{}}.{suffix}", Lv, tr)
                   for key, (suffix, tr) in _VT_LAYER.items()},
        "post_ln": {"scale": get("vt.post_layernorm.weight"),
                    "bias": get("vt.post_layernorm.bias")},
    }
    proj = {lin: {"kernel": get(f"proj.{lin}.weight").T.contiguous(),
                  "bias": get(f"proj.{lin}.bias")} for lin in ("linear_1", "linear_2")}
    return {"vision_tower": vt, "projector": proj, "language_model": lm}


def read_safetensors_dir(model_dir: str) -> dict:
    """Every ``*.safetensors`` shard under ``model_dir`` by the port's reader."""
    files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no safetensors under {model_dir}")
    state: dict = {}
    for path in files:
        state.update(read_safetensors(path))
    return state


def load_llava_safetensors(model_dir: str, cfg: LlavaConfig, dtype=None, device="cpu") -> dict:
    """Every ``*.safetensors`` shard under ``model_dir``, read with the port's
    reader, imported by ``from_hf_state_dict`` onto ``device``."""
    return from_hf_state_dict(read_safetensors_dir(model_dir), cfg, dtype, device)


def to_hf_state_dict(params: dict, cfg: LlavaConfig) -> dict:
    """Back to HF (new-era) names, the inverse of ``from_hf_state_dict``:
    name -> tensor on the params' device (transposes made contiguous)."""
    out: dict = {}
    lm, vt, proj = params["language_model"], params["vision_tower"], params["projector"]
    pre = "model.language_model."
    out[pre + "embed_tokens.weight"] = lm["embed_tokens"]
    for key, (suffix, transpose) in _LM_LAYER.items():
        for i in range(cfg.text.num_hidden_layers):
            a = lm["layers"][key][i]
            out[f"{pre}layers.{i}.{suffix}"] = a.T.contiguous() if transpose else a
    out[pre + "norm.weight"] = lm["norm"]
    if "lm_head" in lm:
        out["lm_head.weight"] = lm["lm_head"].T.contiguous()
    P, D = cfg.vision.patch_size, cfg.vision.hidden_size
    vpre = "model.vision_tower.vision_model."
    out[vpre + "embeddings.class_embedding"] = vt["class_embedding"]
    out[vpre + "embeddings.patch_embedding.weight"] = (
        vt["patch_embedding"].T.reshape(D, 3, P, P).contiguous())
    out[vpre + "embeddings.position_embedding.weight"] = vt["position_embedding"]
    out[vpre + "pre_layrnorm.weight"] = vt["pre_ln"]["scale"]
    out[vpre + "pre_layrnorm.bias"] = vt["pre_ln"]["bias"]
    out[vpre + "post_layernorm.weight"] = vt["post_ln"]["scale"]
    out[vpre + "post_layernorm.bias"] = vt["post_ln"]["bias"]
    for key, (suffix, transpose) in _VT_LAYER.items():
        for i in range(cfg.vision.num_hidden_layers):
            a = vt["layers"][key][i]
            out[f"{vpre}encoder.layers.{i}.{suffix}"] = a.T.contiguous() if transpose else a
    for lin in ("linear_1", "linear_2"):
        out[f"model.multi_modal_projector.{lin}.weight"] = proj[lin]["kernel"].T.contiguous()
        out[f"model.multi_modal_projector.{lin}.bias"] = proj[lin]["bias"]
    return out


def llama_from_causal_lm_state_dict(state: Mapping, cfg: LlamaConfig, dtype=None,
                                    device="cpu") -> dict:
    """A text-only LlamaForCausalLM / MistralForCausalLM state dict -> the
    ``language_model`` subtree (stacked layers); a missing ``lm_head`` is
    the tied embedding."""
    sd = {(k[len("model."):] if k.startswith("model.") else k): v for k, v in state.items()}
    get, stack = _getter(sd, dtype, device)
    lm = _lm_tree(get, stack, "", cfg.num_hidden_layers)
    lm["lm_head"] = (get("lm_head.weight") if "lm_head.weight" in sd
                     else lm["embed_tokens"]).T.contiguous()
    return lm


def llama_config_from_json(model_dir: str) -> LlamaConfig:
    """A LlamaConfig from a text-only ``LlamaForCausalLM`` snapshot's
    ``config.json``: the fields the JAX topic classifier reads (vocabulary,
    widths, depth, heads, kv heads defaulting to the heads, positions, RMS
    eps, rope theta defaulting to 10000, the sliding window)."""
    hc = read_config_json(model_dir)
    return LlamaConfig(
        vocab_size=hc["vocab_size"], hidden_size=hc["hidden_size"],
        intermediate_size=hc["intermediate_size"], num_hidden_layers=hc["num_hidden_layers"],
        num_attention_heads=hc["num_attention_heads"],
        num_key_value_heads=hc.get("num_key_value_heads") or hc["num_attention_heads"],
        max_position_embeddings=hc["max_position_embeddings"], rms_norm_eps=hc["rms_norm_eps"],
        rope_theta=hc.get("rope_theta") or 10000.0, sliding_window=hc.get("sliding_window"))


def load_llama_causal_lm_safetensors(model_dir: str, cfg: LlamaConfig, dtype=None,
                                     device="cpu") -> dict:
    """A text-only ``LlamaForCausalLM`` snapshot's shards (the port's reader,
    the snapshot's dtype unless ``dtype``) -> the ``language_model`` subtree
    on ``device`` (``llama_from_causal_lm_state_dict``)."""
    return llama_from_causal_lm_state_dict(read_safetensors_dir(model_dir), cfg, dtype, device)
