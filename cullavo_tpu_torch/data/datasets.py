"""Dataset registrations (counterpart of ``cullavo_tpu/data/datasets.py``):
so far VQAv2, a questions JSON and an optional annotations JSON keyed by
``question_id`` (the reference's register_vqa_datasets.py).  The other kinds
of the JAX module (RefCOCO, ImageNet, ADE20K pairs, the bulk table) come
with the slices that evaluate them."""
from __future__ import annotations

import json
import os
from typing import Optional

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
