"""The reference's ``epoch{N}`` checkpoint tree, written and read by the port
(counterpart of ``cullavo_tpu/checkpoint/reference_layout.py``).

The reference's ``BaseModel.save_pretrained`` writes::

    SAVE_DIR/epoch{N}/CuLLaVO.pt                       # non-LLM weights (torch)
    SAVE_DIR/epoch{N}/cullavo/language_model/adapter_model.safetensors
    SAVE_DIR/epoch{N}/cullavo/language_model/adapter_config.json
    SAVE_DIR/epoch{N}/cullavo/vision_tower/adapter_model.safetensors
    SAVE_DIR/epoch{N}/cullavo/vision_tower/adapter_config.json
    SAVE_DIR/epoch{N}/cullavo/multi_modal_projector.pt
    SAVE_DIR/epoch{N}/cullavo/lm_head.pt
    SAVE_DIR/epoch{N}/cullavo/embed_tokens.pt

with PEFT's key names (``base_model.model.<module path>.lora_{A,B}.weight``)
in torch's ``[r, d_in]`` / ``[d_out, r]`` convention.  The ``.pt`` files go
through ``torch.save`` / ``torch.load``, the adapters through the port's own
safetensors writer and reader.  The stacked ``[L, d_in, r]`` adapters of
the trainable partition are sliced per layer and transposed; a vision
adapter's layer ``mask`` decides which layers are written and becomes
``layers_to_transform``.  Reading fills a template partition: a template
target whose module the checkpoint's ``target_modules`` leaves out stays
zero (an identity adapter), a missing key of a module it claims raises.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import torch

from cullavo_tpu_torch.checkpoint.safetensors_io import read_safetensors, write_safetensors
from cullavo_tpu_torch.parallel.mesh import process_index

# the stacked target name -> the HF module path inside the tower
_LLM_MODULES = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
                "o": "self_attn.o_proj", "gate": "mlp.gate_proj", "up": "mlp.up_proj",
                "down": "mlp.down_proj"}
_VIS_MODULES = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
                "o": "self_attn.out_proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
_LLM_PREFIX = "base_model.model.model.layers"
_VIS_PREFIX = "base_model.model.vision_model.encoder.layers"


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().cpu()


def _torch_load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def _layer_mask(ad: dict):
    return ad["mask"].reshape(-1).tolist() if "mask" in ad else None


def _adapter_flat(lora_tree: dict, modules: dict, prefix: str) -> dict:
    """Stacked {target: {a [L, d_in, r], b [L, r, d_out], mask?}} -> flat
    PEFT-named tensors; layers a vision ``mask`` turns off are not written."""
    flat = {}
    for t, ad in lora_tree.items():
        mask = _layer_mask(ad)
        for i in range(ad["a"].shape[0]):
            if mask is not None and mask[i] == 0:
                continue
            mod = f"{prefix}.{i}.{modules[t]}"
            flat[f"{mod}.lora_A.weight"] = _cpu(ad["a"][i].T)
            flat[f"{mod}.lora_B.weight"] = _cpu(ad["b"][i].T)
    return flat


def _adapter_unflat(flat: dict, template: dict, modules: dict, prefix: str,
                    target_modules=None) -> dict:
    """The inverse of ``_adapter_flat`` into the shapes, dtypes, devices and
    vision masks of ``template``."""
    out = {}
    for t, ad in template.items():
        a, b = torch.zeros_like(ad["a"]), torch.zeros_like(ad["b"])
        mask = _layer_mask(ad)
        transformed = target_modules is None or modules[t].split(".")[-1] in target_modules
        for i in range(a.shape[0]):
            mod = f"{prefix}.{i}.{modules[t]}"
            ka, kb = f"{mod}.lora_A.weight", f"{mod}.lora_B.weight"
            if ka in flat:
                a[i] = flat[ka].T.to(a.dtype)
                b[i] = flat[kb].T.to(b.dtype)
            elif transformed and (mask is None or mask[i] != 0):
                raise KeyError(f"adapter key {ka} missing from checkpoint")
        out[t] = {"a": a, "b": b}
        if "mask" in ad:
            out[t]["mask"] = ad["mask"]
    return out


def save_reference_layout(save_dir: str, epoch: int, trainable: dict, lora_cfg,
                          other_state: Optional[dict] = None) -> str:
    """Write one ``epoch{N}`` tree from a trainable partition (``{"lora",
    "projector", "lm_head", "embed_tokens"}``).  ``other_state``: extra
    (non-LLM) weights for ``CuLLaVO.pt``, empty for the LLaVA workloads.
    Returns the epoch directory.  Under several processes only rank 0
    writes."""
    ep = os.path.join(save_dir, f"epoch{epoch}")
    if process_index() != 0:
        return ep
    cullavo = os.path.join(ep, "cullavo")
    llm_dir = os.path.join(cullavo, "language_model")
    vis_dir = os.path.join(cullavo, "vision_tower")
    for d in (llm_dir, vis_dir):
        os.makedirs(d, exist_ok=True)
    torch.save({k: _cpu(v) for k, v in (other_state or {}).items()},
               os.path.join(ep, "CuLLaVO.pt"))

    def adapter_config(modules, layers_to_transform=None):
        cfg = {"peft_type": "LORA", "task_type": "CAUSAL_LM", "r": int(lora_cfg.r),
               "lora_alpha": float(lora_cfg.alpha), "lora_dropout": float(lora_cfg.dropout),
               "bias": "none", "target_modules": sorted(m.split(".")[-1]
                                                        for m in modules.values())}
        if layers_to_transform is not None:
            cfg["layers_to_transform"] = layers_to_transform
        return cfg

    lora = trainable["lora"]
    write_safetensors(_adapter_flat(lora.get("language_model", {}), _LLM_MODULES, _LLM_PREFIX),
                      os.path.join(llm_dir, "adapter_model.safetensors"))
    with open(os.path.join(llm_dir, "adapter_config.json"), "w") as f:
        json.dump(adapter_config(_LLM_MODULES), f)

    vis_tree = lora.get("vision_tower", {})
    layers = next(([i for i, on in enumerate(_layer_mask(ad)) if on]
                   for ad in vis_tree.values() if "mask" in ad), None)
    write_safetensors(_adapter_flat(vis_tree, _VIS_MODULES, _VIS_PREFIX),
                      os.path.join(vis_dir, "adapter_model.safetensors"))
    with open(os.path.join(vis_dir, "adapter_config.json"), "w") as f:
        json.dump(adapter_config(_VIS_MODULES, layers), f)

    proj = trainable["projector"]
    torch.save({f"{lin}.{nm}": _cpu(proj[lin]["kernel"].T if nm == "weight"
                                    else proj[lin]["bias"])
                for lin in ("linear_1", "linear_2") for nm in ("weight", "bias")},
               os.path.join(cullavo, "multi_modal_projector.pt"))
    if trainable.get("lm_head") is not None:
        torch.save({"weight": _cpu(trainable["lm_head"].T)}, os.path.join(cullavo, "lm_head.pt"))
    torch.save({"weight": _cpu(trainable["embed_tokens"])},
               os.path.join(cullavo, "embed_tokens.pt"))
    return ep


def load_reference_layout(path: str, trainable_template: dict) -> dict:
    """Read an ``epoch{N}`` tree (the directory, or its ``CuLLaVO.pt`` as the
    reference's ``RESUME_FROM`` names it) into a trainable partition shaped
    like ``trainable_template``: every leaf in the template leaf's dtype and
    on its device."""
    if path.endswith(".pt"):
        path = os.path.dirname(path)
    cullavo = os.path.join(path, "cullavo")
    if not os.path.isdir(cullavo):
        raise FileNotFoundError(f"no 'cullavo' adapter dir under {path!r} (reference "
                                "BaseModel.from_pretrained layout)")

    def read_targets(d):
        cfg_path = os.path.join(d, "adapter_config.json")
        if not os.path.isfile(cfg_path):
            return None
        with open(cfg_path) as f:
            return set(json.load(f).get("target_modules") or []) or None

    def like(value, t):
        return value.to(device=t.device, dtype=t.dtype)

    lora = {}
    for tower, modules, prefix in (("language_model", _LLM_MODULES, _LLM_PREFIX),
                                   ("vision_tower", _VIS_MODULES, _VIS_PREFIX)):
        d = os.path.join(cullavo, tower)
        lora[tower] = _adapter_unflat(read_safetensors(os.path.join(d, "adapter_model.safetensors")),
                                      trainable_template["lora"].get(tower, {}), modules, prefix,
                                      read_targets(d))
    proj_sd = _torch_load(os.path.join(cullavo, "multi_modal_projector.pt"))
    tproj = trainable_template["projector"]
    out = {"lora": lora,
           "projector": {lin: {"kernel": like(proj_sd[f"{lin}.weight"].T, tproj[lin]["kernel"]),
                               "bias": like(proj_sd[f"{lin}.bias"], tproj[lin]["bias"])}
                         for lin in ("linear_1", "linear_2")},
           "embed_tokens": like(_torch_load(os.path.join(cullavo, "embed_tokens.pt"))["weight"],
                                trainable_template["embed_tokens"]),
           "lm_head": None}
    if trainable_template.get("lm_head") is not None:
        out["lm_head"] = like(_torch_load(os.path.join(cullavo, "lm_head.pt"))["weight"].T,
                              trainable_template["lm_head"])
    return out
