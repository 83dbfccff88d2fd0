"""Request wire-format helpers of the ``serve`` entry point (counterpart of
``cullavo_tpu/serving/io.py``).

A request row is a plain dict:

    {"id": int, "prompt": str | "input_ids": [int, ...],
     "image": path(.npy [3,H,W] f32 | image file) | nested list [3,H,W] | null,
     "max_new_tokens": int}

``request_from_row`` turns it into a ``serving.Request`` with the engine's
prompt contract: when an image is given, the prompt must carry either one
``<image>`` placeholder token (expanded here into the full image-token run,
``modeling.expand_image_token``) or the already-expanded run.
"""
from __future__ import annotations

import numpy as np

from cullavo_tpu_torch.data.image_processing import preprocess_numpy
from cullavo_tpu_torch.data.mappers.eval_mappers import load_image_rgb
from cullavo_tpu_torch.models.llava.modeling import expand_image_token
from cullavo_tpu_torch.serving.engine import Request

__all__ = ["load_pixels", "request_from_row"]


def load_pixels(path: str, image_size: int) -> np.ndarray:
    """``.npy`` -> as stored (preprocessed pixels); any other file -> decoded
    (``load_image_rgb``, which needs PIL) and CLIP-preprocessed."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    return preprocess_numpy([load_image_rgb(path)], size=image_size)[0]


def request_from_row(row: dict, model_cfg, tokenizer) -> Request:
    """One JSON row -> Request."""
    n_img = model_cfg.num_image_tokens
    if "input_ids" in row:
        ids = np.asarray(row["input_ids"], np.int32)
    elif "prompt" in row:
        if tokenizer is None:
            raise ValueError(
                f"request {row.get('id')}: 'prompt' given but no tokenizer is "
                "configured (weights-only snapshot): send 'input_ids'")
        ids = np.asarray(tokenizer.encode(row["prompt"]), np.int32)
    else:
        raise ValueError(f"request {row.get('id')}: needs 'input_ids' or 'prompt'")
    if ids.ndim != 1 or ids.size == 0:
        raise ValueError(f"request {row.get('id')}: input_ids must be a non-empty "
                         "1-D token list")
    pix = None
    if row.get("image") is not None:
        img = row["image"]
        side = model_cfg.vision.image_size
        if isinstance(img, str):
            pix = load_pixels(img, side)
        else:                       # inline nested list [3, H, W]
            pix = np.asarray(img, np.float32)
        if pix.shape != (3, side, side):
            raise ValueError(f"request {row.get('id')}: image shape {pix.shape} != "
                             f"(3, {side}, {side})")
        c = int(np.sum(ids == model_cfg.image_token_id))
        if c == 1:
            # expand the single <image> placeholder into the image run
            ids, _, _ = expand_image_token(ids, np.ones_like(ids), np.zeros_like(ids),
                                           model_cfg.image_token_id, n_img)
            ids = np.asarray(ids, np.int32)
        elif c != n_img:
            # decoding from unmerged text embeddings would return garbage
            # with no signal: fail loudly instead
            raise ValueError(
                f"request {row.get('id')}: image given but the prompt holds {c} image "
                f"tokens (expected 1 placeholder or the expanded {n_img}-token run); "
                "check the tokenizer maps <image> to the image token id")
    return Request(req_id=row["id"], input_ids=ids, pixel_values=pix,
                   max_new_tokens=int(row.get("max_new_tokens", 32)),
                   adapter_id=int(row.get("adapter_id", 0)))
