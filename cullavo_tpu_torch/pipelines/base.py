"""Pipeline registry (counterpart of ``cullavo_tpu/pipelines/base.py``):
pipelines are plain classes registered by name; the entry layer looks them
up from the config key ``PIPELINE``."""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

_PIPELINES: Dict[str, Callable] = {}


def register_pipeline(name: str):
    def deco(cls):
        _PIPELINES[name] = cls
        return cls
    return deco


def build_pipeline(name: str, cfg, **kw):
    if name not in _PIPELINES:
        raise KeyError(f"pipeline {name!r} not registered; have {sorted(_PIPELINES)}")
    return _PIPELINES[name](cfg, **kw)


def list_pipelines():
    return sorted(_PIPELINES)


def batch_timing(data_t, compute_t, eval_t, n_images, batch, warmup) -> dict:
    """Per-batch means over the batches after the first ``warmup`` ones,
    how many batches that is, and the images per second over them."""
    w = min(warmup, max(len(compute_t) - 1, 0))
    out = {"data_s": float(np.mean(data_t[w:])) if data_t[w:] else 0.0,
           "compute_s": float(np.mean(compute_t[w:])) if compute_t[w:] else 0.0,
           "eval_s": float(np.mean(eval_t[w:])) if eval_t[w:] else 0.0,
           "eval_batch": batch, "batches_timed": len(compute_t) - w}
    total = sum(data_t[w:]) + sum(compute_t[w:]) + sum(eval_t[w:])
    imgs = max(n_images - w * batch, 0)
    if total > 0 and imgs > 0:
        out["images_per_s"] = imgs / total
    return out
