"""Dataset registrations (counterpart of ``cullavo_tpu/data/datasets.py``):
so far VQAv2, a questions JSON and an optional annotations JSON keyed by
``question_id`` (the reference's register_vqa_datasets.py), and the COCO
segment decoders ``polygons_to_mask`` (even-odd scanline fill) and
``rle_to_mask`` (uncompressed, column-major RLE), numpy only.  The other
kinds of the JAX module (RefCOCO, ImageNet, ADE20K pairs, the bulk table)
come with the slices that evaluate them."""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from cullavo_tpu_torch.data.registry import register_dataset


def load_vqa(questions_json: str, annotations_json: Optional[str],
             image_dir: str, image_template: str = "COCO_val2014_{:012d}.jpg") -> list:
    with open(questions_json) as f:
        questions = json.load(f)["questions"]
    ann_by_qid = {}
    if annotations_json and os.path.exists(annotations_json):
        with open(annotations_json) as f:
            for ann in json.load(f)["annotations"]:
                ann_by_qid[ann["question_id"]] = ann
    rows = []
    for q in questions:
        ann = ann_by_qid.get(q["question_id"])
        rows.append({
            "question_id": q["question_id"],
            "question": q["question"],
            "image_id": q["image_id"],
            "file_name": os.path.join(image_dir, image_template.format(q["image_id"])),
            "answers": [a["answer"] for a in ann["answers"]] if ann else None,
            "question_type": ann.get("question_type") if ann else None,
            "answer_type": ann.get("answer_type") if ann else None,
        })
    return rows


def register_vqa(name: str, questions_json: str, annotations_json: Optional[str],
                 image_dir: str, **kw):
    register_dataset(name, lambda: load_vqa(questions_json, annotations_json,
                                            image_dir, **kw),
                     {"gt_json": annotations_json})


def polygons_to_mask(segmentation, height: int, width: int) -> np.ndarray:
    """COCO polygon(s) (or an RLE dict) -> uint8 [height, width] mask: the
    even-odd rule sampled at pixel centres, one scanline at a time."""
    if isinstance(segmentation, dict):
        return rle_to_mask(segmentation)
    mask = np.zeros((height, width), np.uint8)
    for poly in segmentation:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        x0, y0 = pts[:, 0], pts[:, 1]
        x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
        for yi, y in enumerate(np.arange(height) + 0.5):
            cross = ((y0 <= y) & (y1 > y)) | ((y1 <= y) & (y0 > y))
            if not cross.any():
                continue
            xs = np.sort(x0[cross] + (y - y0[cross]) / (y1[cross] - y0[cross])
                         * (x1[cross] - x0[cross]))
            for a, b in zip(xs[0::2], xs[1::2]):
                lo = max(int(np.ceil(a - 0.5)), 0)
                hi = min(int(np.ceil(b - 0.5)), width)
                if hi > lo:
                    mask[yi, lo:hi] = 1
    return mask


def rle_to_mask(rle: dict) -> np.ndarray:
    """Uncompressed COCO RLE ``{"counts": [...], "size": [h, w]}`` -> uint8
    [h, w] mask (runs alternate 0 and 1, column-major); a compressed counts
    string raises."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        raise ValueError("compressed RLE strings not supported; decode upstream")
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape(w, h).T
