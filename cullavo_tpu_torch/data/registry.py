"""Dataset registry (the port's copy of ``cullavo_tpu/data/registry.py``):
datasets register a loader function and metadata under a name; loaders
return lists of dict records; ``get_dataset`` / ``get_metadata`` mirror
detectron2's DatasetCatalog / MetadataCatalog."""
from __future__ import annotations

from typing import Callable, Dict

_DATASETS: Dict[str, Callable[[], list]] = {}
_METADATA: Dict[str, dict] = {}


def register_dataset(name: str, loader: Callable[[], list], metadata: dict = None):
    if name in _DATASETS:
        raise KeyError(f"dataset {name!r} already registered")
    _DATASETS[name] = loader
    _METADATA[name] = dict(metadata or {})


def get_dataset(name: str) -> list:
    if name not in _DATASETS:
        raise KeyError(f"dataset {name!r} not registered; have {sorted(_DATASETS)}")
    return _DATASETS[name]()


def get_metadata(name: str) -> dict:
    return _METADATA.get(name, {})


def list_datasets() -> list:
    return sorted(_DATASETS)


def clear():  # test helper
    _DATASETS.clear()
    _METADATA.clear()
