"""CuLLaVO pipeline (counterpart of
``cullavo_tpu/pipelines/cullavo_pipeline.py``): step-1 Q-LoRA training over
LLaVA (model and optimizer state, batch synthesis, the train step) and the
step2_pre model-in-the-loop dataset generation (``generate_step2_rows``:
sampled continuations through the fused ``generate``, parsed for boxes and
classes, drawn, written as PNGs and ``lbk_new_version.json`` rows).  With a
``ParallelContext`` (several processes) the train step takes this rank's
rows of each global batch, and step2_pre gathers the ranks' rows for rank 0
to write.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from cullavo_tpu_torch.data import png_io
from cullavo_tpu_torch.data.image_processing import preprocess_numpy
from cullavo_tpu_torch.data.step1_synthesis import collate_step1, synthesize_step1
from cullavo_tpu_torch.data.text_format import COLOR_LIST, draw_boxes, parse_boxes_and_classes
from cullavo_tpu_torch.models.llava.config import LlavaConfig
from cullavo_tpu_torch.models.llava.modeling import GenerationConfig, generate
from cullavo_tpu_torch.models.llava.lora import (LoraConfig, init_lora_params,
                                                 maybe_quantize_base, strip_trainable,
                                                 trainable_partition)
from cullavo_tpu_torch.parallel.mesh import Layout
from cullavo_tpu_torch.pipelines.base import register_pipeline
from cullavo_tpu_torch.trainer.optimizer import cullavo_optimizer
from cullavo_tpu_torch.trainer.step import TrainState, make_train_step
from cullavo_tpu_torch.utils.tree import tree_map


@register_pipeline("CuLLaVOPipeline")
class CuLLaVOPipeline:
    """Owns model config + tokenizer + data synthesis + the train step.
    ``params`` live on the device the step runs on."""

    def __init__(self, cfg, model_cfg: LlavaConfig, tokenizer, params, parallel=None):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.tokenizer = tokenizer
        self.params = params
        self.parallel = parallel
        self.workload = cfg.get("WORKLOAD", "step1")
        self._rng = np.random.default_rng(cfg.get("SEED", 0))
        self.device = params["language_model"]["embed_tokens"].device
        self.layout = None      # the trainable tree's, on a grid of processes

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
        lora = init_lora_params(self.params, self.model_cfg, lora_cfg,
                                torch.Generator(device=self.device).manual_seed(1))
        # f32 masters whatever the snapshot's dtype (JAX reads snapshots in f32)
        trainable = tree_map(lambda t: t.float(), trainable_partition(self.params, lora))
        frozen = strip_trainable(self.params)
        norm_fn = {}
        if self.parallel is not None:
            # this rank's shards only, as JAX's _fsdp_spec places them
            self.layout = Layout(self.parallel, trainable)
            trainable = self.layout.shard(trainable)
            frozen = self.parallel.shard_tree(frozen)
            self.params = frozen
            norm_fn = {"norm_fn": self.layout.global_norm}
        tx = cullavo_optimizer(float(self.cfg.get("LR", 2e-5)),
                               int(self.cfg.get("TOTAL_STEPS", 1000)),
                               eta_min=float(self.cfg.get("LAST_LR", 0.0)),
                               grad_clip=float(self.cfg.get("GRAD_MAX", 10.0)),
                               grad_accum=int(self.cfg.get("GRAD_CUM", 1)), **norm_fn)
        state = TrainState(trainable, tx.init(trainable), 0)
        # the production memory configuration: per-layer remat, bf16 compute
        # over f32 masters, chunked CE so [B, T, V] logits never exist
        self.step_fn = make_train_step(self.model_cfg, lora_cfg, tx, remat=True,
                                       compute_dtype=torch.bfloat16, loss_chunk=256,
                                       layout=self.layout)
        # the state is the caller's: a copy kept here would outlive the steps
        self.frozen, self.lora_cfg = frozen, lora_cfg
        return state

    # -- data -------------------------------------------------------------
    def make_batch(self, records: list, pad_to: Optional[int] = None) -> dict:
        """step1: synthesize the prompts in the input pipeline, on the host;
        the batch lands on the parameters' device."""
        samples = [synthesize_step1(r, self.tokenizer, self._rng) for r in records]
        batch = collate_step1(samples, self.tokenizer, self.model_cfg.num_image_tokens,
                              pad_to=pad_to, image_size=self.model_cfg.vision.image_size)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    # -- train ------------------------------------------------------------
    def forward_step(self, state, batch, rng):
        return self.step_fn(state, self.frozen, batch, rng)

    # -- step2_pre data generation ----------------------------------------
    def generate_step2_rows(self, images_u8, prompts_ids: np.ndarray,
                            attention_mask: np.ndarray, out_dir: str, max_new_tokens: int = 256,
                            batch_size: Optional[int] = None, parallel_ctx=None,
                            index_offset: int = 0) -> list:
        """Model-in-the-loop enrichment: sample a caption + boxes
        continuation per row (temperature 0.9, top-k 50, top-p 0.95), parse
        it, draw the boxes on the row's image, and emit the dataset rows.

        Generation runs in chunks of ``batch_size`` rows (default: the
        config's BATCH_SIZE, 8); the last short chunk is padded by repeating
        its last row, so every chunk has one shape.  Each chunk draws its
        seed from the pipeline's numpy rng, as JAX draws its PRNG key, and
        samples from a ``torch.Generator`` on the parameters' device seeded
        with it.  Each chunk's pixels are preprocessed from ``images_u8``
        (any sequence of uint8 [H, W, 3] arrays, indexed lazily).  The
        compute dtype is the base's own (its embedding table's): f32 for an
        f32 snapshot or the smoke model, bf16 for a bf16 snapshot; on the
        card the attention kernels take bf16 only, so an f32 base there
        raises.  Images go to ``out_dir`` as
        ``step2_{index_offset + b}.png`` through the port's PNG writer, the
        rows to ``out_dir/lbk_new_version.json``.  ``parallel_ctx`` (several
        processes, each generating its shard of the rows, ``index_offset``
        its first row's global index): the ranks' rows are gathered in rank
        order, rank 0 writes the JSON and every rank returns the merged
        rows."""
        emb = self.params["language_model"]["embed_tokens"]
        device, dtype = emb.device, emb.dtype
        if device.type == "cuda" and dtype != torch.bfloat16:
            raise ValueError(f"generate_step2_rows: a {dtype} base on {device}; the card's "
                             "attention kernels (K1, K4) take bf16 only")
        gen = GenerationConfig(max_new_tokens=max_new_tokens, do_sample=True,
                               temperature=0.9, top_k=50, top_p=0.95,
                               eos_token_id=self.tokenizer.eos_token_id)
        N = prompts_ids.shape[0]
        bs = max(1, min(int(batch_size or self.cfg.get("BATCH_SIZE", 8)), N))
        rows = []
        os.makedirs(out_dir, exist_ok=True)
        for start in range(0, N, bs):
            sel = np.arange(start, min(start + bs, N))
            pad = (np.concatenate([sel, np.full(bs - len(sel), sel[-1])])
                   if len(sel) < bs else sel)
            pix = preprocess_numpy([np.asarray(images_u8[b]) for b in pad],
                                   size=self.model_cfg.vision.image_size)
            rng = torch.Generator(device=device).manual_seed(int(self._rng.integers(1 << 31)))
            out = generate(
                self.params, self.model_cfg, torch.from_numpy(prompts_ids[pad]).to(device),
                torch.from_numpy(np.ascontiguousarray(pix)).to(device),
                torch.from_numpy(attention_mask[pad]).to(device), gen,
                max_len=prompts_ids.shape[1] + max_new_tokens, rng=rng,
                compute_dtype=dtype).cpu()
            for j, b in enumerate(sel):
                text = self.tokenizer.decode(out[j].tolist())
                boxes, classes, err = parse_boxes_and_classes(text)
                if err or boxes is None or len(boxes) == 0:
                    continue
                img = np.asarray(images_u8[b])
                H, W = img.shape[:2]
                abs_boxes = boxes * np.asarray([W, H, W, H], np.float32)
                drawn = draw_boxes(img, abs_boxes, COLOR_LIST[:len(boxes)])
                img_name = f"step2_{index_offset + b}.png"
                png_io.write_png(os.path.join(out_dir, img_name), drawn)
                rows.append({"image": img_name, "boxes": boxes.tolist(),
                             "classes": classes, "text": text})
        if parallel_ctx is not None:
            rows = [r for shard in parallel_ctx.allgather_objects(rows) for r in shard]
            if not parallel_ctx.is_main:
                return rows
        with open(os.path.join(out_dir, "lbk_new_version.json"), "w") as f:
            json.dump(rows, f)
        return rows

    def evaluate_model(self):
        raise NotImplementedError("use generate_step2_rows for step2_pre")
