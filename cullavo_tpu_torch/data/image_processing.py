"""CLIP image preprocessing (LLaVA-1.5 front end): the host path that
``collate_step1`` needs (counterpart of ``preprocess_numpy`` in
``cullavo_tpu/data/image_processing.py``).

HF ``CLIPImageProcessor`` semantics for llava-1.5: resize the shortest edge
to ``size`` (bicubic, antialiased), center-crop ``size`` x ``size``, rescale
by 1/255, normalize with the CLIP mean and std.  The resize is
``torch.nn.functional.interpolate`` on the CPU (Keys cubic with a = -0.5,
the kernel ``jax.image.resize`` uses too).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
CLIP_SIZE = 336


def _resize_shortest_then_crop(img: torch.Tensor, size: int) -> torch.Tensor:
    """[H, W, 3] float -> [size, size, 3]: shortest-edge resize + center crop."""
    H, W = img.shape[0], img.shape[1]
    if H <= W:
        new_h, new_w = size, max(size, int(round(W * size / H)))
    else:
        new_h, new_w = max(size, int(round(H * size / W))), size
    x = F.interpolate(img.permute(2, 0, 1)[None], size=(new_h, new_w), mode="bicubic",
                      antialias=True, align_corners=False)[0].permute(1, 2, 0)
    top, left = (new_h - size) // 2, (new_w - size) // 2
    return x[top:top + size, left:left + size]


def preprocess_numpy(images: list, size: int = CLIP_SIZE) -> np.ndarray:
    """Ragged image sizes: list of [H, W, 3] (or gray [H, W], or RGBA) uint8
    -> stacked [B, 3, size, size] float32, CLIP-normalized."""
    out = []
    for im in images:
        if im.ndim == 2:
            im = np.stack([im] * 3, axis=-1)
        if im.shape[-1] == 4:
            im = im[..., :3]
        x = torch.from_numpy(np.ascontiguousarray(im)).float() / 255.0
        out.append(_resize_shortest_then_crop(x, size).numpy())
    batch = np.stack(out)
    batch = (batch - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(CLIP_STD, np.float32)
    return batch.transpose(0, 3, 1, 2)
