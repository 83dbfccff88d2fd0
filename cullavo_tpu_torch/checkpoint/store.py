"""Checkpoints of the training state (counterpart of
``cullavo_tpu/checkpoint/store.py``'s npz store).

``save_checkpoint(ckpt_dir, step, state)`` writes ``{ckpt_dir}/step_{N}/``:
``arrays.npz`` with every leaf and ``manifest.json`` with the step and the
keys.  A leaf's key is its path in JAX's ``keystr`` form: ``['name']`` for a
dict key, ``[i]`` for a list or tuple index, ``.field`` for a dataclass
field (the port's ``TrainState``: ``.trainable['lora']['language_model']
['q']['a']``, ``.opt_state['mu']...``, ``.step``).  None leaves are empty
subtrees, as in JAX, and are not written.  Leaves are tensors (any device),
numpy arrays or Python numbers; a leaf numpy cannot hold (bf16, a string,
an object) raises.  A params-only dict written by either package reads in
the other.

``load_checkpoint(ckpt_dir, step=None, template=None)`` rebuilds the tree:
with a ``template`` (a freshly initialized ``TrainState``, optimizer moments
included) exactly its structure, tensors on the template leaf's device in
the saved dtype, Python numbers where the template holds them; without one,
the keys are parsed into plain dicts and lists of numpy arrays.

``save_adapters(out_dir, lora_params, lora_config)`` writes a PEFT-like
adapter directory: ``adapter_model.safetensors`` (the same keystr names,
written by the port's own safetensors writer in each leaf's dtype, bf16
included) and ``adapter_config.json``.  ``load_adapters(out_dir,
template=None)`` reads one back as ``(tree, config)``, CPU tensors in the
stored dtype, through the port's own reader (the JAX reader,
``safe_open(framework="np")``, raises on bf16 where safetensors predates
ml_dtypes).  A directory written by either package reads in the other, bit
for bit.  ``export_hf`` and the orbax pair are not ported.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Optional

import numpy as np
import torch

from cullavo_tpu_torch.checkpoint.safetensors_io import read_safetensors, write_safetensors
from cullavo_tpu_torch.parallel.mesh import process_index

ADAPTER_FILE, ADAPTER_CONFIG = "adapter_model.safetensors", "adapter_config.json"

_TOKEN = re.compile(r"\[u?'([^']*)'\]|\[(\d+)\]|\.([A-Za-z_]\w*)")


def _children(node):
    """(key string, child) pairs of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", v) for k, v in node.items()]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{f.name}", getattr(node, f.name)) for f in dataclasses.fields(node)]
    return None


def _flatten(node, prefix="") -> dict:
    """{keystr path: leaf}, None leaves left out."""
    kids = _children(node)
    if kids is None:
        return {} if node is None else {prefix: node}
    out = {}
    for key, child in kids:
        out.update(_flatten(child, prefix + key))
    return out


def _to_numpy(key: str, leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"checkpoint leaf {key}: numpy cannot hold {leaf.dtype}")
        return leaf.detach().cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "biuf":
        raise TypeError(f"checkpoint leaf {key}: numpy cannot hold a {type(leaf).__name__} "
                        f"({arr.dtype})")
    return arr


def _from_numpy(arr, like):
    if isinstance(arr, torch.Tensor):       # an adapter file's leaf (load_adapters)
        return arr.to(like.device) if isinstance(like, torch.Tensor) else arr
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(like.device)
    if isinstance(like, (bool, int, float)):
        return type(like)(arr)
    return arr


def _rebuild(node, prefix, flat):
    kids = _children(node)
    if kids is None:
        return None if node is None else _from_numpy(flat[prefix], node)
    built = [_rebuild(child, prefix + key, flat) for key, child in kids]
    if isinstance(node, dict):
        return dict(zip(node.keys(), built))
    if isinstance(node, (list, tuple)):
        return type(node)(built)
    return dataclasses.replace(node, **{f.name: v for f, v in
                                        zip(dataclasses.fields(node), built)})


def _unflatten(flat: dict, template: Any = None) -> Any:
    if template is not None:
        missing = [k for k in _flatten(template) if k not in flat]
        if missing:
            raise KeyError(f"checkpoint missing {len(missing)} leaves, e.g. {missing[:3]}")
        return _rebuild(template, "", flat)
    root: dict = {}
    for key, value in flat.items():
        parts = [m.group(1) if m.group(1) is not None
                 else (int(m.group(2)) if m.group(2) is not None else m.group(3))
                 for m in _TOKEN.finditer(key)]
        if not parts:                     # a scalar root
            return value
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def fix(node):
        if isinstance(node, dict):
            keys = list(node)
            if keys and all(isinstance(k, int) for k in keys) and sorted(keys) == list(
                    range(len(keys))):
                return [fix(node[i]) for i in range(len(keys))]
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(root)


def save_checkpoint(ckpt_dir: str, step: int, state: Any) -> str:
    """Write ``{ckpt_dir}/step_{step}/`` (``arrays.npz`` + ``manifest.json``);
    returns that directory.  Under several processes only rank 0 writes."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    if process_index() != 0:
        return path
    os.makedirs(path, exist_ok=True)
    arrays = {k: _to_numpy(k, v) for k, v in _flatten(state).items()}
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"step": step, "keys": list(arrays)}, f)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir) if d.startswith("step_")]
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None, template: Any = None) -> Any:
    """Read ``step_{step}`` (the latest without ``step``); ``template``
    restores the exact structure (required for a ``TrainState``)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        flat = {k: data[k] for k in manifest["keys"]}
    return _unflatten(flat, template=template)


def save_adapters(out_dir: str, lora_params: Any, lora_config: dict) -> str:
    """Write ``{out_dir}/adapter_model.safetensors`` (every tensor leaf of
    ``lora_params`` under its keystr path, in its own dtype) and
    ``adapter_config.json``; returns ``out_dir``.  Only rank 0 writes."""
    if process_index() != 0:
        return out_dir
    os.makedirs(out_dir, exist_ok=True)
    flat = {k: torch.as_tensor(v) for k, v in _flatten(lora_params).items()}
    write_safetensors(flat, os.path.join(out_dir, ADAPTER_FILE))
    with open(os.path.join(out_dir, ADAPTER_CONFIG), "w") as f:
        json.dump(lora_config, f)
    return out_dir


def load_adapters(out_dir: str, template: Any = None) -> tuple:
    """(adapter tree, config dict) from an adapter directory.  Without
    ``template`` the keystr paths parse into plain dicts of CPU tensors in
    the stored dtype; with one (e.g. ``init_lora_params``'s output), its
    exact structure, each leaf moved to the template leaf's device."""
    flat = read_safetensors(os.path.join(out_dir, ADAPTER_FILE))
    with open(os.path.join(out_dir, ADAPTER_CONFIG)) as f:
        cfg = json.load(f)
    return _unflatten(flat, template=template), cfg
