"""LLM base-weight quantization (the int8 branch of
``cullavo_tpu/models/llava/lora.py::quantize_llm_weights``).  Adapters
(single, multi-stacked, runtime LoRA) wait for the NF4 slice."""
from __future__ import annotations

import torch

from cullavo_tpu_torch.ops.nf4 import quantize_linear_int8

LLM_TARGETS = ("q", "k", "v", "o", "gate", "up", "down")
# targets that consume the SAME input tensor share one activation
# quantization pass (nf4.int8_linear_s8s8_group), so they must share one
# SmoothQuant scale
SHARED_INPUT_GROUPS = (("q", "k", "v"), ("gate", "up"))


def quantize_llm_weights(params: dict, bits: int = 8,
                         smooth_scales: dict | None = None) -> dict:
    """Quantize the stacked LLaMA linear weights to int8 per output channel
    (the reference's load_in_8bit eval mode).  Embeddings, lm_head, norms,
    projector and vision tower stay in high precision.

    ``smooth_scales``: target name -> per-input-channel SmoothQuant scale
    ([K] or stacked [L, K]); calibrated dicts take the s8s8 prefill path.
    Members of a shared-input group must carry equal scales."""
    if bits != 8:
        raise NotImplementedError("NF4 (bits=4) base weights wait for the NF4 slice")
    smooth_scales = smooth_scales or {}
    for group in SHARED_INPUT_GROUPS:
        present = [t for t in group if smooth_scales.get(t) is not None]
        for t in present[1:]:
            if not torch.equal(torch.as_tensor(smooth_scales[present[0]]),
                               torch.as_tensor(smooth_scales[t])):
                raise ValueError(
                    f"calibration scales for group {group} differ at {t!r}: "
                    "members sharing an input tensor must share ONE scale")
    lm = dict(params["language_model"])
    layers = dict(lm["layers"])
    for t in LLM_TARGETS:
        layers[t] = quantize_linear_int8(layers[t], smooth_scale=smooth_scales.get(t))
    lm["layers"] = layers
    return {**params, "language_model": lm}
