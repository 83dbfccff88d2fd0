"""CuLLaVO training pipeline (counterpart of
``cullavo_tpu/pipelines/cullavo_pipeline.py``): step-1 Q-LoRA training over
LLaVA: model and optimizer state, batch synthesis, the train step.  The
step2_pre dataset generation (``generate_step2_rows``) needs sampling and
the fused ``generate`` and waits for their slice.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cullavo_tpu_torch.data.step1_synthesis import collate_step1, synthesize_step1
from cullavo_tpu_torch.models.llava.config import LlavaConfig
from cullavo_tpu_torch.models.llava.lora import (LoraConfig, init_lora_params,
                                                 maybe_quantize_base, strip_trainable,
                                                 trainable_partition)
from cullavo_tpu_torch.pipelines.base import register_pipeline
from cullavo_tpu_torch.trainer.optimizer import cullavo_optimizer
from cullavo_tpu_torch.trainer.step import TrainState, make_train_step
from cullavo_tpu_torch.utils.tree import tree_map


@register_pipeline("CuLLaVOPipeline")
class CuLLaVOPipeline:
    """Owns model config + tokenizer + data synthesis + the train step.
    ``params`` live on the device the step runs on."""

    def __init__(self, cfg, model_cfg: LlavaConfig, tokenizer, params):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.tokenizer = tokenizer
        self.params = params
        self.workload = cfg.get("WORKLOAD", "step1")
        self._rng = np.random.default_rng(cfg.get("SEED", 0))

    # -- model ------------------------------------------------------------
    def initialize_model(self):
        opt = self.cfg.get("OPTIMIZER") or {}
        llm_cfg = (self.cfg.get("MODEL") or {}).get("LLM") or {}
        # the Q-LoRA base is quantized at load (MODEL.LLM.BITS: 4 = NF4,
        # 8 = int8); a no-op on a base that already is
        self.params = maybe_quantize_base(self.params, int(llm_cfg.get("BITS", 0) or 0))

        def _opt_get(key, default):
            for src in (llm_cfg, opt):
                if src.get(key) is not None:
                    return src.get(key)
            return default

        lora_cfg = LoraConfig(
            r=int(_opt_get("LORA_R", 64)),
            alpha=float(_opt_get("LORA_ALPHA", 16)),
            dropout=0.05,
            # the reference pins range(12, 23) of the 24-layer CLIP tower;
            # configurable so that tiny towers can carry adapters too
            vision_layer_start=int(_opt_get("LORA_VISION_START", 12)),
            vision_layer_stop=int(_opt_get("LORA_VISION_STOP", 23)))
        device = self.params["language_model"]["embed_tokens"].device
        lora = init_lora_params(self.params, self.model_cfg, lora_cfg,
                                torch.Generator(device=device).manual_seed(1))
        # f32 masters whatever the snapshot's dtype (JAX reads snapshots in f32)
        trainable = tree_map(lambda t: t.float(), trainable_partition(self.params, lora))
        frozen = strip_trainable(self.params)
        tx = cullavo_optimizer(float(self.cfg.get("LR", 2e-5)),
                               int(self.cfg.get("TOTAL_STEPS", 1000)),
                               eta_min=float(self.cfg.get("LAST_LR", 0.0)),
                               grad_clip=float(self.cfg.get("GRAD_MAX", 10.0)),
                               grad_accum=int(self.cfg.get("GRAD_CUM", 1)))
        state = TrainState(trainable, tx.init(trainable), 0)
        # the production memory configuration: per-layer remat, bf16 compute
        # over f32 masters, chunked CE so [B, T, V] logits never exist
        self.step_fn = make_train_step(self.model_cfg, lora_cfg, tx, remat=True,
                                       compute_dtype=torch.bfloat16, loss_chunk=256)
        self.state, self.frozen, self.lora_cfg = state, frozen, lora_cfg
        return state

    # -- data -------------------------------------------------------------
    def make_batch(self, records: list, pad_to: Optional[int] = None) -> dict:
        """step1: synthesize the prompts in the input pipeline, on the host;
        the batch lands on the parameters' device."""
        samples = [synthesize_step1(r, self.tokenizer, self._rng) for r in records]
        batch = collate_step1(samples, self.tokenizer, self.model_cfg.num_image_tokens,
                              pad_to=pad_to, image_size=self.model_cfg.vision.image_size)
        device = self.params["language_model"]["embed_tokens"].device
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in batch.items()}

    # -- train ------------------------------------------------------------
    def forward_step(self, state, batch, rng):
        return self.step_fn(state, self.frozen, batch, rng)

    # -- step2_pre data generation ----------------------------------------
    def generate_step2_rows(self, *args, **kwargs):
        raise NotImplementedError("generate_step2_rows needs sampled decoding and the fused "
                                  "generate; it comes with the step2 training slice")

    def evaluate_model(self):
        raise NotImplementedError("use generate_step2_rows for step2_pre")
