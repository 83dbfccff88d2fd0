"""COCO panoptic records and the mapper that turns one into a step-1
training sample (counterpart of ``cullavo_tpu/data/coco_panoptic.py``).

  * ``rgb2id`` / ``id2rgb`` — panopticapi's RGB <-> segment-id encoding
    (``png_io``'s).
  * ``load_coco_panoptic_json`` / ``register_coco_panoptic`` — the
    panoptic JSON walked into one record per image (image file names as
    the annotation's ``.png`` renamed ``.jpg``; category ids mapped to
    contiguous ids; thing flags from the categories).
  * ``resize_image`` — the square bicubic resize of ``jax.image.resize``
    (``models/xdecoder/decoder.resize``), clipped and truncated to uint8.
  * ``PanopticMapper`` — record -> image at the model's resolution, the
    non-crowd segments' classes, boxes (in model pixels), thing flags and
    nearest-resized masks.  Its default loader is ``load_image_file``
    (``mappers.eval_mappers``'s): by a file's magic bytes, a PNG through
    the port's own reader (``png_io``), any other file through PIL.

  * ``pad_targets`` — mapped records stacked into the X-Decoder's padded
    targets (classes, masks, normalized cxcywh boxes, validity).
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from cullavo_tpu_torch.data.mappers.eval_mappers import load_image_file
from cullavo_tpu_torch.data.png_io import id2rgb, rgb2id  # noqa: F401 (id2rgb re-exported)
from cullavo_tpu_torch.data.registry import register_dataset
from cullavo_tpu_torch.models.xdecoder.decoder import resize


def load_coco_panoptic_json(json_file: str, image_dir: str, panoptic_dir: str,
                            metadata: dict) -> list:
    """Panoptic annotation JSON -> list of records (one per image)."""
    with open(json_file) as f:
        info = json.load(f)
    cat_id_to_contiguous = metadata.get("dataset_id_to_contiguous_id") or {
        c["id"]: i for i, c in enumerate(sorted(info.get("categories", []),
                                                key=lambda c: c["id"]))}
    thing_ids = metadata.get("thing_dataset_ids") or {
        c["id"] for c in info.get("categories", []) if c.get("isthing")}
    records = []
    for ann in info["annotations"]:
        records.append({
            "image_id": ann["image_id"],
            "file_name": os.path.join(image_dir, ann["file_name"].replace(".png", ".jpg")),
            "pan_seg_file_name": os.path.join(panoptic_dir, ann["file_name"]),
            "segments_info": [
                {"id": s["id"],
                 "category_id": cat_id_to_contiguous.get(s["category_id"], s["category_id"]),
                 "iscrowd": s.get("iscrowd", 0),
                 "isthing": s["category_id"] in thing_ids}
                for s in ann["segments_info"]],
        })
    return records


def register_coco_panoptic(name: str, json_file: str, image_dir: str, panoptic_dir: str,
                           metadata: Optional[dict] = None):
    md = dict(metadata or {})
    register_dataset(name, lambda: load_coco_panoptic_json(json_file, image_dir,
                                                           panoptic_dir, md), md)


def resize_image(img: np.ndarray, size: int, method: str = "bicubic") -> np.ndarray:
    """Square resize of a uint8 [H, W, C] image as ``jax.image.resize`` does
    it (f32, antialiased when shrinking), clipped to [0, 255] and truncated
    to uint8."""
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).permute(2, 0, 1)[None]
    out = resize(x, (size, size), method)[0].permute(1, 2, 0).numpy()
    return np.clip(out, 0, 255).astype(np.uint8)


class PanopticMapper:
    """record -> {"image" [S, S, 3] u8, "image_id", "classes" [N], "boxes"
    [N, 4] abs xyxy in model pixels, "is_thing" [N], "masks" [N, S, S]};
    crowd segments and segments absent from the map are dropped, and a
    record left with none maps to None."""

    def __init__(self, image_size: int = 336, load_image=None):
        self.image_size = image_size
        self._load_image = load_image or load_image_file

    def __call__(self, record: dict) -> Optional[dict]:
        img = record.get("image")
        if img is None:
            img = self._load_image(record["file_name"])
        pan = record.get("pan_seg")
        if pan is None:
            pan = self._load_image(record["pan_seg_file_name"])
        seg_ids = rgb2id(pan)

        S = self.image_size
        H, W = seg_ids.shape
        img = resize_image(img, S)
        # nearest resize of the masks to the model resolution
        yy = np.clip((np.arange(S) + 0.5) * H / S, 0, H - 1).astype(np.int64)
        xx = np.clip((np.arange(S) + 0.5) * W / S, 0, W - 1).astype(np.int64)

        classes, boxes, is_thing, masks = [], [], [], []
        for seg in record["segments_info"]:
            if seg.get("iscrowd", 0):
                continue
            m = seg_ids == seg["id"]
            if not m.any():
                continue
            ys, xs = np.nonzero(m)
            scale_x, scale_y = S / W, S / H
            boxes.append([xs.min() * scale_x, ys.min() * scale_y,
                          (xs.max() + 1) * scale_x, (ys.max() + 1) * scale_y])
            classes.append(seg["category_id"])
            is_thing.append(bool(seg.get("isthing", True)))
            masks.append(m[yy][:, xx])
        if not classes:
            return None
        return {"image": img, "image_id": record.get("image_id"),
                "classes": np.asarray(classes, np.int32),
                "boxes": np.asarray(boxes, np.float32),
                "is_thing": np.asarray(is_thing, bool),
                "masks": np.stack(masks).astype(np.float32)}


def pad_targets(mapped: list, max_instances: int, mask_size: Optional[int] = None) -> dict:
    """Mapped records (None for a dropped one) -> {"image" [B, S, S, 3] u8,
    "classes" [B, N] i32, "boxes" [B, N, 4] normalized cxcywh, "valid" [B,
    N], "masks" [B, N, ms, ms] f32}, N = ``max_instances``; masks
    nearest-resized to ``mask_size`` when it differs from S."""
    B = len(mapped)
    first = next((m for m in mapped if m is not None), None)
    if first is None:
        raise ValueError("all records empty")
    S = first["image"].shape[0]
    ms = mask_size or S
    classes = np.zeros((B, max_instances), np.int32)
    boxes = np.zeros((B, max_instances, 4), np.float32)
    valid = np.zeros((B, max_instances), bool)
    masks = np.zeros((B, max_instances, ms, ms), np.float32)
    images = np.zeros((B, S, S, 3), np.uint8)
    for i, m in enumerate(mapped):
        if m is None:
            continue
        n = min(len(m["classes"]), max_instances)
        images[i] = m["image"]
        classes[i, :n] = m["classes"][:n]
        valid[i, :n] = True
        b = m["boxes"][:n] / S
        boxes[i, :n] = np.stack([(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2,
                                 b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], -1)
        if ms != S:
            mm = resize(torch.from_numpy(np.ascontiguousarray(m["masks"][:n]))[None],
                        (ms, ms), "nearest")[0]
            masks[i, :n] = mm.numpy()
        else:
            masks[i, :n] = m["masks"][:n]
    return {"image": images, "classes": classes, "boxes": boxes, "valid": valid,
            "masks": masks}
