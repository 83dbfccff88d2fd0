"""Eval-time mappers: registered dataset records -> pipeline eval rows
(counterpart of ``cullavo_tpu/data/mappers/eval_mappers.py``).  So far the
VQA mapper (the reference's vqa_dataset_mapper.py); the X-Decoder mappers
come with the dataset kinds that need them."""
from __future__ import annotations

from typing import Optional

import numpy as np

from cullavo_tpu_torch.data.image_processing import CLIP_SIZE, preprocess_numpy


def load_image_rgb(path: str) -> np.ndarray:
    """An image file -> uint8 [H, W, 3].  Needs PIL, imported here only: where
    it is not installed this raises, and records carry decoded ``image``
    arrays instead."""
    from PIL import Image

    with Image.open(path) as im:
        return np.array(im.convert("RGB"))


class VQAEvalMapper:
    """load_vqa record -> VQAPipeline row: CLIP-preprocessed pixel_values +
    question/answers passthrough.  A record's in-memory ``image`` array is
    taken first; only without one is ``file_name`` decoded."""

    def __init__(self, image_size: Optional[int] = None, load_image=load_image_rgb):
        self.image_size = image_size
        self.load_image = load_image

    def __call__(self, record: dict) -> dict:
        img = record.get("image")
        if img is None:
            img = self.load_image(record["file_name"])
        size = self.image_size or CLIP_SIZE
        pix = preprocess_numpy([np.asarray(img)], size=size)[0]
        return {"question_id": record["question_id"],
                "question": record["question"],
                "pixel_values": pix,
                "answers": record.get("answers"),
                "question_type": record.get("question_type"),
                "answer_type": record.get("answer_type")}
