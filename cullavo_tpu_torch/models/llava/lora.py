"""LLM base-weight quantization (``quantize_llm_weights`` and
``maybe_quantize_base`` of ``cullavo_tpu/models/llava/lora.py``): int8 per
output channel, or planar NF4.  Adapters (single, multi-stacked, runtime
LoRA) wait for a later slice."""
from __future__ import annotations

import torch

from cullavo_tpu_torch.ops.nf4 import BLOCK, quantize_linear_int8, quantize_linear_planar

LLM_TARGETS = ("q", "k", "v", "o", "gate", "up", "down")
# targets that consume the SAME input tensor share one activation
# quantization pass (nf4.int8_linear_s8s8_group), so they must share one
# SmoothQuant scale
SHARED_INPUT_GROUPS = (("q", "k", "v"), ("gate", "up"))


def _quantize_target(w, bits: int, name: str, smooth_scale=None):
    if bits == 8:
        return quantize_linear_int8(w, smooth_scale=smooth_scale)
    d_in, d_out = w.shape[-2], w.shape[-1]
    if d_in % 8 or d_out % BLOCK:
        # not left dense silently, and not quantized to a layout nothing runs
        raise NotImplementedError(
            f"NF4 target {name!r} is [{d_in}, {d_out}]: the planar layout needs "
            f"d_in % 8 == 0 and d_out % {BLOCK} == 0; the byte-packed layout for other "
            "dims (Pallas rows 8 and 9) is not ported yet")
    return quantize_linear_planar(w)


def quantize_llm_weights(params: dict, bits: int = 4,
                         smooth_scales: dict | None = None) -> dict:
    """Quantize the stacked LLaMA linear weights (the frozen Q-LoRA base):
    ``bits=4`` planar NF4, ``bits=8`` int8 per output channel (the
    reference's load_in_8bit eval mode).  Embeddings, lm_head, norms,
    projector and vision tower stay in high precision.

    ``smooth_scales`` (bits=8 only): target name -> per-input-channel
    SmoothQuant scale ([K] or stacked [L, K]); calibrated dicts take the
    s8s8 prefill path.  Members of a shared-input group must carry equal
    scales."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 (NF4) or 8 (int8), got {bits}")
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
        layers[t] = _quantize_target(layers[t], bits, t, smooth_scales.get(t))
    lm["layers"] = layers
    return {**params, "language_model": lm}


def maybe_quantize_base(params: dict, bits: int) -> dict:
    """Config-driven base quantization (``MODEL.LLM.BITS``: 4 = NF4, 8 =
    int8).  No-op when ``bits`` is neither, or when the LLM linears are
    already quantized dicts.

    One target at a time, and each dense target is TAKEN OUT of the input
    tree's ``layers`` dict as its quantized form lands (JAX donates it), so
    the dense and the packed copy of a 7B base never coexist whole: the
    caller keeps using the returned tree."""
    layers_in = params["language_model"]["layers"]
    if bits not in (4, 8) or any(isinstance(w, dict) for w in layers_in.values()):
        return params
    lm = dict(params["language_model"])
    layers = dict(layers_in)
    for t in LLM_TARGETS:
        layers[t] = _quantize_target(layers_in.pop(t), bits, t)
    lm["layers"] = layers
    return {**params, "language_model": lm}
