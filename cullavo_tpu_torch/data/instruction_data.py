"""Step-2 instruction-tuning data: ShareGPT4V / lbkllava conversation rows
(counterpart of ``cullavo_tpu/data/instruction_data.py``; numpy only, run in
the input pipeline on the host).

  * ``load_conversation_json``: the rows of a conversation JSON, without
    those whose image file is missing (the lbkllava registration's filter);
  * ``synthesize_step2``: a row's multi-turn human/gpt pairs as
    "USER:/ASSISTANT:" turns with the labels masked over the prompts, a zero
    image for text-only rows, and, when the row has boxes and the dice
    comes up, the boxes drawn on the image with a box-description turn
    appended (the step-2 colour augmentation);
  * ``iter_step2_batches``: shuffled batches through ``collate_step1``.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

from cullavo_tpu_torch.data.step1_synthesis import PromptBuilder, collate_step1
from cullavo_tpu_torch.data.text_format import COLOR_LIST, boxes2string, classes2string, draw_boxes


def load_conversation_json(json_file: str, image_root: Optional[str] = None,
                           require_image: bool = False) -> list:
    """Rows: ``{"image": relpath | None, "conversations": [{"from": "human" |
    "gpt", "value": str}, ...]}``, optional ``"boxes"`` / ``"classes"``.  With
    ``image_root``, a row whose image file is missing is dropped and the
    others gain ``"image_path"``; ``require_image`` drops the text-only rows
    (only without ``image_root``, as in JAX)."""
    with open(json_file) as f:
        rows = json.load(f)
    out = []
    for row in rows:
        img = row.get("image")
        if img and image_root:
            path = os.path.join(image_root, img)
            if not os.path.exists(path):
                continue
            row = {**row, "image_path": path}
        elif require_image and not img:
            continue
        out.append(row)
    return out


def synthesize_step2(record: dict, tokenizer, rng: np.random.Generator,
                     image: Optional[np.ndarray] = None, image_size: int = 336,
                     box_color_augment: bool = True) -> dict:
    """One conversation row -> ``{"image", "input_ids", "labels"}``.  The
    dice is one ``rng.integers(2)`` draw, made only for a row with boxes."""
    turns = record["conversations"]
    b = PromptBuilder(tokenizer)
    b.start()

    pairs = []
    for i in range(0, len(turns) - 1, 2):
        human, gpt = turns[i], turns[i + 1]
        if human.get("from") != "human" or gpt.get("from") != "gpt":
            continue
        pairs.append((human["value"].replace("<image>", "").strip(), gpt["value"].strip()))

    img = image
    if img is None:
        img = np.zeros((image_size, image_size, 3), np.uint8)    # text-only rows
    boxes = record.get("boxes")
    if boxes is not None and box_color_augment and len(boxes) > 0 \
            and int(rng.integers(2)) == 0:
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        H, W = img.shape[:2]
        abs_boxes = boxes * np.asarray([W, H, W, H], np.float32)
        img = draw_boxes(img, abs_boxes, COLOR_LIST[:len(boxes)])
        classes = record.get("classes", ["object"] * len(boxes))
        pairs.append((
            "provide multiple object names with their numbering index and the "
            "objects' bounding box coordinates in the image.",
            f"Sure, it is {classes2string(classes)} at {boxes2string(boxes)}."))

    for q, a in pairs:
        b.add_turn(q, a)
    ids, labels = b.finish()
    return {"image": img, "input_ids": ids, "labels": labels}


def iter_step2_batches(rows: Sequence[dict], tokenizer, num_image_tokens: int,
                       batch_size: int, rng: np.random.Generator, image_loader=None,
                       image_size: int = 336, pad_to: Optional[int] = None):
    """Batches of ``batch_size`` rows in the order of ``rng.permutation``
    (the short tail dropped), each through ``collate_step1``; a row's image
    comes from ``image_loader(row["image_path"])`` where both exist."""
    order = rng.permutation(len(rows))
    for i in range(0, len(order) - batch_size + 1, batch_size):
        samples = []
        for j in order[i:i + batch_size]:
            row = rows[j]
            img = None
            if image_loader and row.get("image_path"):
                img = image_loader(row["image_path"])
            samples.append(synthesize_step2(row, tokenizer, rng, img, image_size=image_size))
        yield collate_step1(samples, tokenizer, num_image_tokens, pad_to=pad_to,
                            image_size=image_size)
