"""Pipeline registry (counterpart of ``cullavo_tpu/pipelines/base.py``):
pipelines are plain classes registered by name; the entry layer looks them
up from the config key ``PIPELINE``."""
from __future__ import annotations

from typing import Callable, Dict

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
