"""LoRA adapters and LLM base-weight quantization for the stacked-params
LLaVA stack (counterpart of ``cullavo_tpu/models/llava/lora.py``).

Adapters: r = 64, alpha = 16, dropout 0.05 on every LLM linear
(q/k/v/o/gate/up/down) and on layers 12..22 of the vision tower, stacked
along the layer axis like the base weights (``{"a": [L, d_in, r], "b":
[L, r, d_out]}``, vision adapters with a per-layer ``mask``).  The
separately trainable full modules are the projector, ``lm_head`` and
``embed_tokens``.  Base quantization (``quantize_llm_weights``,
``maybe_quantize_base``): int8 per output channel, or NF4 (planar where
the dims allow it, byte-packed ``q4`` otherwise, as the JAX quantizer
picks).
Multi-stacked adapter sets (``stack_adapter_sets``, ``{"a": [L, K, d_in,
r], "b": [L, K, r, d_out]}``) serve K LLM adapter sets at once, each batch
row picking its own by ``adapter_ids``.  The int8 vision tower is not
ported (no entry point of the JAX package reaches it)."""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from cullavo_tpu_torch.models.llava.config import LlavaConfig
from cullavo_tpu_torch.ops.nf4 import (BLOCK, quantize_linear, quantize_linear_int8,
                                       quantize_linear_planar)

LLM_TARGETS = ("q", "k", "v", "o", "gate", "up", "down")
VISION_TARGETS = ("q", "k", "v", "o", "fc1", "fc2")
# targets that consume the SAME input tensor share one activation
# quantization pass (nf4.int8_linear_s8s8_group), so they must share one
# SmoothQuant scale
SHARED_INPUT_GROUPS = (("q", "k", "v"), ("gate", "up"))


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 64
    alpha: float = 16.0
    dropout: float = 0.05
    vision_layer_start: int = 12
    vision_layer_stop: int = 23

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


def _shapes_of(layers: dict, targets) -> dict:
    """Logical [L, d_in, d_out] shapes, also of quantized weights (the
    production order loads, quantizes, THEN attaches LoRA); None for a
    byte-packed q4 dict, whose flat leaves do not carry them."""
    out = {}
    for t in targets:
        if t not in layers:
            continue
        w = layers[t]
        if not isinstance(w, dict):
            out[t] = tuple(w.shape)
        elif "q4p" in w:                   # planar NF4: q4p [L, d_in/8, d_out]
            L, k8, d_out = w["q4p"].shape
            out[t] = (L, k8 * 8, d_out)
        elif "q8" in w:                    # int8 keeps the logical shape
            out[t] = tuple(w["q8"].shape)
        elif "q4" in w:                    # flat q4: the caller supplies cfg dims
            out[t] = None
        else:
            raise NotImplementedError(f"adapter shapes for a weight dict with keys "
                                      f"{sorted(w)} (a layout the port does not run)")
    return out


def init_lora_params(params: dict, cfg: LlavaConfig, lora: LoraConfig,
                     generator: torch.Generator, dtype=torch.float32) -> dict:
    """A/B pairs for each targeted stacked weight, on the device of the base:
    A ~ N(0, 1/d_in) drawn from ``generator`` (which must live on that
    device), B = 0.  Vision adapters exist for all layers; a ``mask`` zeroes
    the layers outside [vision_layer_start, vision_layer_stop)."""
    out: dict = {"language_model": {}, "vision_tower": {}}
    device = params["language_model"]["embed_tokens"].device

    def normal_a(L, d_in):
        a = torch.randn((L, d_in, lora.r), generator=generator, device=device)
        return (a * d_in ** -0.5).to(dtype)

    tc = cfg.text
    cfg_dims = {"q": (tc.hidden_size, tc.num_attention_heads * tc.head_dim),
                "k": (tc.hidden_size, tc.num_key_value_heads * tc.head_dim),
                "v": (tc.hidden_size, tc.num_key_value_heads * tc.head_dim),
                "o": (tc.num_attention_heads * tc.head_dim, tc.hidden_size),
                "gate": (tc.hidden_size, tc.intermediate_size),
                "up": (tc.hidden_size, tc.intermediate_size),
                "down": (tc.intermediate_size, tc.hidden_size)}
    for t, shape in _shapes_of(params["language_model"]["layers"], LLM_TARGETS).items():
        L, d_in, d_out = shape or (tc.num_hidden_layers,) + cfg_dims[t]
        out["language_model"][t] = {
            "a": normal_a(L, d_in),
            "b": torch.zeros((L, lora.r, d_out), dtype=dtype, device=device)}
    vl = params["vision_tower"]["layers"]
    Lv = vl["q"].shape[0]
    start, stop = lora.vision_layer_start, min(lora.vision_layer_stop, Lv)
    if start < stop:
        for t, (L, d_in, d_out) in _shapes_of(vl, VISION_TARGETS).items():
            mask = torch.zeros((L, 1, 1), dtype=dtype, device=device)
            mask[start:stop] = 1.0
            out["vision_tower"][t] = {
                "a": normal_a(L, d_in) * mask,
                "b": torch.zeros((L, lora.r, d_out), dtype=dtype, device=device),
                "mask": mask}
    return out


def dropout_mask(x: torch.Tensor, rate: float, seed: int, rows: Optional[tuple] = None):
    """Keep-mask for LoRA dropout on x, a pure function of ``seed`` (so a
    rematerialized layer draws the same mask again).  ``rows`` (offset,
    total): x holds rows offset.. of a batch of ``total``; the mask is drawn
    for that whole batch and these rows taken, so that a data-parallel rank
    drops what one process would."""
    g = torch.Generator(device=x.device).manual_seed(seed)
    if rows is None:
        return torch.rand(x.shape, generator=g, device=x.device) >= rate
    offset, total = rows
    full = torch.rand((total,) + tuple(x.shape[1:]), generator=g, device=x.device)
    return full[offset:offset + x.shape[0]] >= rate


def lora_update(x, adapter: dict, scaling: float, out_dtype,
                dropout: float = 0.0, seed: Optional[int] = None,
                adapter_ids: Optional[torch.Tensor] = None, rows: Optional[tuple] = None):
    """The low-rank term ``scaling * ((drop(x) @ a) @ b)`` (times the
    per-layer mask of a vision adapter) for ONE layer's adapter slice.
    Dropout (``seed`` given and ``dropout`` > 0) zeroes inputs and scales
    the kept ones by 1 / (1 - dropout); ``rows`` as in ``dropout_mask``.

    A multi stack's layer slice (``a`` [K, d_in, r], ``b`` [K, r, d_out])
    gives row b of x [B, T, d_in] adapter ``adapter_ids[b]``: the rows'
    ``a`` and ``b`` are gathered by index (JAX's one-hot einsum selects the
    same values exactly) and applied as batched products."""
    xa = x
    if seed is not None and dropout > 0.0:
        xa = torch.where(dropout_mask(x, dropout, seed, rows), x / (1.0 - dropout),
                         torch.zeros_like(x))
    a, b = adapter["a"], adapter["b"]
    if a.dim() == 3:
        if "mask" in adapter:
            raise NotImplementedError("multi-stacked adapters with per-layer masks (vision "
                                      "tower style) are not supported: serve vision adapters "
                                      "as a shared single stack")
        update = torch.matmul(torch.matmul(xa, a[adapter_ids]), b[adapter_ids])
    else:
        update = (xa @ a) @ b
    if "mask" in adapter:
        update = update * adapter["mask"].reshape(())
    return scaling * update.to(out_dtype)


def lora_matmul(x, w, adapter: Optional[dict], scaling: float,
                dropout_seed: Optional[int] = None, dropout: float = 0.0):
    """``x @ w`` plus the low-rank update when an adapter is present."""
    y = x @ w
    if adapter is None:
        return y
    return y + lora_update(x, adapter, scaling, y.dtype, dropout, dropout_seed)


def merge_lora(params: dict, lora_params: dict, lora: LoraConfig) -> dict:
    """Fold adapters into (unquantized) base weights; returns a new tree."""
    merged = dict(params)
    for tower in ("language_model", "vision_tower"):
        adapters = lora_params.get(tower, {})
        base_layers = dict(merged[tower]["layers"])
        for t, ab in adapters.items():
            update = torch.einsum("lir,lro->lio", ab["a"], ab["b"]) * lora.scaling
            if "mask" in ab:
                update = update * ab["mask"]
            base_layers[t] = (base_layers[t].float() + update.float()).to(base_layers[t].dtype)
        merged[tower] = {**merged[tower], "layers": base_layers}
    return merged


def trainable_partition(params: dict, lora_params: dict) -> dict:
    """The trainable leaves: LoRA adapters + projector + lm_head +
    embed_tokens; everything else is frozen."""
    return {"lora": lora_params,
            "projector": params["projector"],
            "lm_head": params["language_model"].get("lm_head"),
            "embed_tokens": params["language_model"]["embed_tokens"]}


def strip_trainable(params: dict) -> dict:
    """The base tree without the trainable leaves (projector / lm_head /
    embed_tokens): their live copies are in the train state."""
    lm = {k: v for k, v in params["language_model"].items()
          if k not in ("lm_head", "embed_tokens")}
    out = {k: v for k, v in params.items() if k != "projector"}
    out["language_model"] = lm
    return out


def apply_trainable(params: dict, trainable: dict):
    """Recombine trainable leaves into the full tree; returns
    (full_params, lora_params)."""
    lm = dict(params["language_model"])
    lm["embed_tokens"] = trainable["embed_tokens"]
    if trainable.get("lm_head") is not None:
        lm["lm_head"] = trainable["lm_head"]
    full = {**params, "projector": trainable["projector"], "language_model": lm}
    return full, trainable["lora"]


def add_step2_adapters(params: dict, step1_lora: dict, cfg: LlavaConfig, lora: LoraConfig,
                       generator: torch.Generator, merge_step1: bool = False,
                       dtype=torch.float32):
    """A fresh adapter set for step-2 training over the same targets;
    returns ``(base_params, step2_lora)``.  ``merge_step1`` folds the step-1
    adapters into the (unquantized) base first."""
    base = params
    if merge_step1 and step1_lora:
        base = merge_lora(params, step1_lora, lora)
    return base, init_lora_params(base, cfg, lora, generator, dtype)


def _structure(tree):
    if isinstance(tree, dict):
        return tuple(sorted((k, _structure(v)) for k, v in tree.items()))
    return None


def stack_adapter_sets(sets: list) -> dict:
    """Stack K structurally identical LLM adapter dicts for per-request
    multi-adapter serving: each ``{target: {a: [L, D, r], b: [L, r, N]}}``
    becomes ``{target: {a: [L, K, D, r], b: [L, K, r, N]}}``, the layer axis
    first (the forward slices layers) and the adapter axis second (each
    batch row picks one by ``adapter_ids``).  Leaves of different float
    dtypes are promoted, as ``jnp.stack`` does.

    Pass the LANGUAGE-MODEL adapter subtree only: vision-tower adapters
    carry per-layer masks, which the multi path rejects.  Differing
    structures or leaf shapes raise."""
    if not sets:
        raise ValueError("stack_adapter_sets: need at least one adapter set")
    structs = [_structure(s) for s in sets]
    if any(st != structs[0] for st in structs[1:]):
        raise ValueError(f"adapter sets differ in structure: {structs}")

    def stack(*leaves):
        shapes = {tuple(leaf.shape) for leaf in leaves}
        if len(shapes) != 1:
            raise ValueError(f"adapter leaf shapes differ: {shapes}")
        dtype = functools.reduce(torch.promote_types, [leaf.dtype for leaf in leaves])
        return torch.stack([leaf.to(dtype) for leaf in leaves], dim=1)

    def walk(*nodes):
        if isinstance(nodes[0], dict):
            return {k: walk(*(n[k] for n in nodes)) for k in nodes[0]}
        return stack(*nodes)

    return walk(*sets)


def _quantize_target(w, bits: int, smooth_scale=None):
    if bits == 8:
        return quantize_linear_int8(w, smooth_scale=smooth_scale)
    d_in, d_out = w.shape[-2], w.shape[-1]
    # the planar layout where the dims allow it, the flat byte layout
    # otherwise (the JAX quantizer's choice)
    if d_in % 8 == 0 and d_out % BLOCK == 0:
        return quantize_linear_planar(w)
    return quantize_linear(w)


def quantize_llm_weights(params: dict, bits: int = 4,
                         smooth_scales: dict | None = None) -> dict:
    """Quantize the stacked LLaMA linear weights (the frozen Q-LoRA base):
    ``bits=4`` NF4 (planar, or byte-packed q4 where d_in % 8 or d_out % 64
    is not 0), ``bits=8`` int8 per output channel (the
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
        layers[t] = _quantize_target(layers[t], bits, smooth_scales.get(t))
    lm["layers"] = layers
    return {**params, "language_model": lm}


def quantize_stacked(layer, n: int, bits: int, parallel=None):
    """The stacked base leaf of one LLM linear from its layers (``layer(i)``:
    the dense [d_in, d_out] weight of layer i), quantized one layer at a
    time as ``quantize_llm_weights`` quantizes the stack (``bits`` 4 or 8;
    else kept dense).  ``parallel`` (a ``ParallelContext`` on a sharded
    grid): each stacked leaf keeps only this rank's slice, as JAX's rule
    shards the whole ``[n, ...]`` leaf, and comes back as a ``Shard``; the
    whole stack, dense or quantized, never exists."""
    from cullavo_tpu_torch.parallel.mesh import Shard, shard_spec

    def one(i):
        w = layer(i)
        return _quantize_target(w, bits) if bits in (4, 8) else {"w": w}

    out, specs = {}, {}
    for i in range(n):
        for k, x in one(i).items():
            if i == 0:
                whole = (n,) + tuple(x.shape)
                specs[k] = None if parallel is None else shard_spec(
                    whole, (parallel.fsdp, parallel.tensor))
                shape = list(whole)
                if specs[k] is not None:
                    shape[specs[k][0]] //= parallel.axis_size(specs[k][1])
                out[k] = torch.empty(shape, dtype=x.dtype, device=x.device)
            spec = specs[k]
            out[k][i] = x if spec is None else parallel.own(x, spec[0] - 1, spec[1])
    out = {k: v if specs[k] is None else Shard(v, specs[k], parallel) for k, v in out.items()}
    return out["w"] if "w" in out else out


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
        layers[t] = _quantize_target(layers_in.pop(t), bits)
    lm["layers"] = layers
    return {**params, "language_model": lm}
