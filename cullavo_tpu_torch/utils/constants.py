"""Dataset class-name constants and CLIP prompt templates (the port's own
copy of what it needs from ``cullavo_tpu/utils/constants.py``): the COCO
panoptic label set and the prompt-template ensemble of the X-Decoder's
eval-time class embeddings.  Public dataset metadata, stored as JSON in
``assets/class_names.json`` and loaded at first use."""
from __future__ import annotations

import functools
import json
import os

_ASSET = os.path.join(os.path.dirname(__file__), "assets", "class_names.json")

_NAMES = ("COCO_PANOPTIC_CLASSES",)

__all__ = list(_NAMES) + ["get_prompt_templates"]


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
