"""Dataset class-name constants and CLIP prompt templates (the port's own
copy of what it needs from ``cullavo_tpu/utils/constants.py``): the label
sets of the X-Decoder's eval datasets (COCO panoptic, ADE20K 150 and 847,
ImageNet-1k, Cityscapes, BDD, ScanNet, SUN-RGBD, Pascal VOC), ImageNet's
1000 synset folder names (the folder scan's label order), COCO's 91
semantic names (the topic classifier's default classes), the
prompt-template ensemble of its eval-time class embeddings, the
one-template sampler of its training and ``class_names_for``, a dataset
name's label set by name fragment.  Public dataset metadata, stored as JSON
in ``assets/class_names.json`` and loaded at first use."""
from __future__ import annotations

import functools
import json
import os
import random

_ASSET = os.path.join(os.path.dirname(__file__), "assets", "class_names.json")

_NAMES = ("ADE20K_847", "ADE_PANOPTIC_CLASSES", "BDD_PANO", "BDD_SEM", "CITYSCAPES",
          "COCO_PANOPTIC_CLASSES", "COCO_SEMANTIC_CLASSES", "IMAGENET_CLASSES",
          "IMAGENET_FOLDER_NAMES", "PASCAL_CLASSES", "SCAN_20", "SCAN_37", "SCAN_40",
          "SUN_RGBD_37")

__all__ = list(_NAMES) + ["get_prompt_templates", "prompt_engineering", "class_names_for",
                          "class_names_by_key", "class_names_key_for"]


@functools.lru_cache(maxsize=1)
def _load() -> dict:
    with open(_ASSET) as f:
        return json.load(f)


def __getattr__(name: str):
    if name in _NAMES:
        return _load()[name]
    raise AttributeError(name)


def get_prompt_templates() -> list:
    return list(_load()["CLIP_PROMPT_TEMPLATES"])


def prompt_engineering(classname, topk: int = 1, suffix: str = ".", rng=None) -> str:
    """One of the first ``topk`` templates, filled in with the class name
    (a list or tuple of names: one of them).  ``rng``: a numpy Generator,
    a ``random.Random`` or the ``random`` module (the default)."""
    templates = get_prompt_templates()
    n = min(len(templates), topk)
    if rng is None:
        rng = random
    if hasattr(rng, "integers"):          # numpy Generator
        idx = int(rng.integers(n))

        def pick(seq):
            return seq[int(rng.integers(len(seq)))]
    else:
        idx = rng.randrange(n)
        pick = rng.choice
    if isinstance(classname, (list, tuple)):
        classname = pick(classname)
    return templates[idx].replace(".", suffix).format(
        classname.replace(",", "").replace("+", " "))


# name fragment -> table, tried in this order (the reference's get_class_names)
_DATASET_CLASS_KEYS = {
    "coco": "COCO_PANOPTIC_CLASSES",
    "coco_panoptic": "COCO_PANOPTIC_CLASSES",
    "ade": "ADE_PANOPTIC_CLASSES",
    "ade20k_full": "ADE20K_847",
    "imagenet": "IMAGENET_CLASSES",
    "cityscapes": "CITYSCAPES",
    "bdd_sem": "BDD_SEM",
    "bdd_pano": "BDD_PANO",
    "scannet_20": "SCAN_20",
    "scannet_37": "SCAN_37",
    "scannet_40": "SCAN_40",
    "sunrgbd": "SUN_RGBD_37",
    "pascal": "PASCAL_CLASSES",
}


def class_names_by_key(key: str) -> list:
    """The table named ``key`` (a bulk registration's ``class_names_key``);
    an unknown key raises KeyError."""
    if key not in _NAMES:
        raise KeyError(f"no class-name table {key!r}; have {sorted(_NAMES)}")
    return list(_load()[key])


def class_names_key_for(dataset_name: str):
    """The table of the first name fragment of ``_DATASET_CLASS_KEYS`` in
    the lowercased dataset name, or None."""
    key = dataset_name.lower()
    return next((table for fragment, table in _DATASET_CLASS_KEYS.items() if fragment in key),
                None)


def class_names_for(dataset_name: str) -> list:
    """The label set of a dataset by ``class_names_key_for``; none raises
    KeyError."""
    table = class_names_key_for(dataset_name)
    if table is None:
        raise KeyError(f"no class-name list registered for dataset {dataset_name!r}")
    return class_names_by_key(table)
