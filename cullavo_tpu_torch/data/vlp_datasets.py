"""The VLP Arrow splits (counterpart of ``cullavo_tpu/data/vlp_datasets.py``):
the karpathy caption arrows (``vlp_val`` / ``vlp_captioning_val`` and the
``*_val2017`` variants) and the instruction / instp families that share
their row format (columns ``image`` bytes, ``caption`` list of strings or
a string, ``image_id`` int or string).  The files are read by the port's own
``data.arrow_ipc`` (memory-mapped; an image's bytes are a slice of the map,
decoded when a row is asked for).

Record rules, as JAX's: val rows keep their caption lists; vlp train rows
explode to one caption each; instruction / instp train rows keep the field
whole (``[captions]``); string ids parse on ``_`` for the vlp family and on
``/`` and ``.`` for the instruction and instp families.  ``ArrowImageLoader``
decodes PNG bytes with ``png_io``; any other bytes go to PIL through
``load_image_rgb``, which raises where PIL is missing (the card's machine
has none, so it reads PNGs only).
"""
from __future__ import annotations

import io
import os
from typing import Optional, Sequence

import numpy as np

from cullavo_tpu_torch.data import png_io
from cullavo_tpu_torch.data.arrow_ipc import ArrowFile
from cullavo_tpu_torch.data.mappers.eval_mappers import load_image_rgb
from cullavo_tpu_torch.data.registry import list_datasets, register_dataset

EVALUATOR_MAPPER = {
    "vlp_val": "retrieval", "vlp_train": "retrieval",
    "vlp_captioning_val": "captioning",
    "vlp_val2017": "retrieval", "vlp_captioning_val2017": "captioning",
    "instruction_train": "retrieval", "instruction_val": "retrieval",
    "instruction_captioning_val": "captioning",
    "instruction_val2017": "retrieval",
    "instruction_captioning_val2017": "captioning",
    "instp_train": "retrieval", "instp_val": "retrieval",
    "instp_captioning_val": "captioning",
    "instp_val2017": "retrieval", "instp_captioning_val2017": "captioning",
}

PREDEFINED_SPLITS = {
    "vlp_val": ["coco_caption_karpathy_test.arrow"],
    "vlp_captioning_val": ["coco_caption_karpathy_test.arrow"],
    "vlp_val2017": ["coco_caption_karpathy_val2017.arrow"],
    "vlp_captioning_val2017": ["coco_caption_karpathy_val2017.arrow"],
    "instruction_train": ["instruction_coco2017.arrow", "instruction_gqa.arrow",
                          "instruction_ocr_vqa.arrow", "instruction_textvqa.arrow",
                          "instruction_vg.arrow"],
    "instruction_val": ["coco_caption_karpathy_test.arrow"],
    "instruction_captioning_val": ["coco_caption_karpathy_test.arrow"],
    "instruction_val2017": ["coco_caption_karpathy_val2017.arrow"],
    "instruction_captioning_val2017": ["coco_caption_karpathy_val2017.arrow"],
    "instp_train": ["instruction_pretrain_558k.arrow"],
    "instp_val": ["coco_caption_karpathy_test.arrow"],
    "instp_captioning_val": ["coco_caption_karpathy_test.arrow"],
    "instp_val2017": ["coco_caption_karpathy_val2017.arrow"],
    "instp_captioning_val2017": ["coco_caption_karpathy_val2017.arrow"],
}


def load_vlp_arrows(root: str, arrow_paths: Sequence[str]) -> list:
    return [ArrowFile(os.path.join(root, p)) for p in arrow_paths]


def load_vlp_records(tables, name: str) -> list:
    """The rows of ``tables`` (``ArrowFile``s) under ``name``'s rules (see
    the module docstring)."""
    instruction_family = name.startswith(("instruction_", "instp_"))
    ret = []
    for arr_id, arr in enumerate(tables):
        captions_col, ids_col = arr.column("caption"), arr.column("image_id")
        for i in range(len(arr)):
            captions = captions_col[i]
            image_id = ids_col[i]
            if not isinstance(image_id, int):
                image_id = (int(str(image_id).split("/")[-1].split(".")[0])
                            if instruction_family
                            else int(str(image_id).split("_")[-1].split(".")[0]))
            if "val" in name:
                ret.append({"image_id": image_id, "captions": captions,
                            "arr_id": arr_id, "cur_id": i})
            elif instruction_family:
                ret.append({"image_id": image_id, "captions": [captions],
                            "arr_id": arr_id, "cur_id": i})
            else:
                for caption in captions:
                    ret.append({"image_id": image_id, "captions": [caption],
                                "arr_id": arr_id, "cur_id": i})
    return ret


class ArrowImageLoader:
    """record -> uint8 RGB [H, W, 3], decoded from its row of the tables."""

    def __init__(self, tables):
        self.tables = tables

    def __call__(self, record: dict) -> np.ndarray:
        data = self.tables[record["arr_id"]].column("image")[record["cur_id"]]
        if data is None:
            raise ValueError(f"{self.tables[record['arr_id']].path}: row {record['cur_id']} "
                             "has no image")
        if bytes(data[:len(png_io.SIGNATURE)]) == png_io.SIGNATURE:
            return png_io.decode_png_rgb(bytes(data))
        return load_image_rgb(io.BytesIO(data))


def _family_subdir(name: str) -> str:
    """'llava_dataset' for the instruction / instp families,
    'pretrain_arrows_code224' for vlp; used where the directory exists."""
    return ("llava_dataset" if name.startswith(("instruction_", "instp_"))
            else "pretrain_arrows_code224")


def register_vlp(name: str, root: str, arrow_paths: Optional[Sequence[str]] = None,
                 gt_json: Optional[str] = None):
    """Register ``name`` over its arrows under ``root`` (its family's
    subdirectory when that exists); the metadata's ``image_loader`` dict
    gets its ``loader`` (an ``ArrowImageLoader``) when the rows first load."""
    paths = list(arrow_paths or PREDEFINED_SPLITS.get(name, []))
    if not paths:
        raise ValueError(f"no arrow paths for {name!r}")
    sub = os.path.join(root, _family_subdir(name))
    if os.path.isdir(sub):
        root = sub
    state = {}

    def load():
        tables = load_vlp_arrows(root, paths)
        state["loader"] = ArrowImageLoader(tables)
        return load_vlp_records(tables, name)

    register_dataset(name, load, {"evaluator_type": EVALUATOR_MAPPER.get(name, "retrieval"),
                                  "gt_json": gt_json, "image_loader": state})


def register_all_vlp(root: str) -> list:
    """Register every split of ``PREDEFINED_SPLITS`` under ``root``; the
    names registered already (a second call in one process) are left as
    they are.  Returns the names registered by this call."""
    have = set(list_datasets())
    done = [name for name in PREDEFINED_SPLITS if name not in have]
    for name in done:
        register_vlp(name, root)
    return done
