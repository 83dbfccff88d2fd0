"""Dataset class-name constants and CLIP prompt templates (the port's own
copy of what it needs from ``cullavo_tpu/utils/constants.py``): the COCO
panoptic label set, the prompt-template ensemble of the X-Decoder's
eval-time class embeddings and the one-template sampler of its training.  Public dataset metadata, stored as JSON in
``assets/class_names.json`` and loaded at first use."""
from __future__ import annotations

import functools
import json
import os
import random

_ASSET = os.path.join(os.path.dirname(__file__), "assets", "class_names.json")

_NAMES = ("COCO_PANOPTIC_CLASSES",)

__all__ = list(_NAMES) + ["get_prompt_templates", "prompt_engineering"]


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
