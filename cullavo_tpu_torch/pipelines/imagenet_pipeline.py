"""Zero-shot ImageNet classification (counterpart of
``cullavo_tpu/pipelines/imagenet_pipeline.py``, the reference's
LLaVAImageNetPipeline and its BLIP-2 / InstructBLIP variants): each image's
normalised embedding against normalised class embeddings, cosine top-1 and
top-5 accuracy, and a per-class CSV (``imagenet_per_class.csv``).

Top-k ties keep the lower class index first, as ``jax.lax.top_k`` does
(``models.beam.top_k``; ``torch.topk`` promises no order among ties).
"""
from __future__ import annotations

import csv
import os
from collections import defaultdict
from typing import Iterable, Optional

import numpy as np
import torch

from cullavo_tpu_torch.models.beam import top_k
from cullavo_tpu_torch.pipelines.base import register_pipeline


@register_pipeline("LLaVAImageNetPipeline")
class ImageNetPipeline:
    def __init__(self, cfg, image_embed_fn, class_embeds: torch.Tensor, class_names: list,
                 batch_size: int = 64):
        """``image_embed_fn(pixel_values [B, 3, H, W]) -> [B, D]`` normalised,
        on ``class_embeds``' device; ``class_embeds [C, D]`` normalised."""
        self.cfg = cfg
        self.image_embed_fn = image_embed_fn
        self.class_embeds = class_embeds
        self.class_names = class_names
        self.batch_size = batch_size

    def evaluate_model(self, dataset: Iterable[dict], limit: Optional[int] = None,
                       out_dir: Optional[str] = None) -> dict:
        """dataset rows: {"pixel_values" [3, H, W], "label"} -> {"top1", "top5"
        (percent, rounded to 2 places), "n"}; with ``out_dir`` the per-class
        CSV (class, top1, n; then TOTAL).  Fresh counts every call."""
        per_class = defaultdict(lambda: [0, 0])
        top5_hits = total = 0
        rows = list(dataset)
        if limit:
            rows = rows[:limit]
        dev = self.class_embeds.device
        for i in range(0, len(rows), self.batch_size):
            chunk = rows[i:i + self.batch_size]
            pix = torch.from_numpy(np.stack([r["pixel_values"] for r in chunk])).to(dev)
            sim = self.image_embed_fn(pix) @ self.class_embeds.T            # [B, C]
            top5 = top_k(sim, min(5, sim.shape[-1]))[1].cpu().tolist()
            for r, t5 in zip(chunk, top5):
                label = int(r["label"])
                total += 1
                per_class[label][1] += 1
                per_class[label][0] += int(t5[0] == label)
                top5_hits += int(label in t5)
        top1_acc = 100.0 * sum(v[0] for v in per_class.values()) / max(total, 1)
        top5_acc = 100.0 * top5_hits / max(total, 1)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, "imagenet_per_class.csv"), "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["class", "top1", "n"])
                for label, (hit, n) in sorted(per_class.items()):
                    name = self.class_names[label] if label < len(self.class_names) else label
                    w.writerow([name, round(100.0 * hit / max(n, 1), 2), n])
                w.writerow(["TOTAL", round(top1_acc, 2), total])
        return {"top1": round(top1_acc, 2), "top5": round(top5_acc, 2), "n": total}
