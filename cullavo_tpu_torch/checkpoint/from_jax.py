"""Weight bridge between the JAX package's parameter trees and the port.

``llava_params_from_numpy`` takes a JAX LLaVA parameter tree whose leaves
are numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
port's parameters: the same nested dicts with torch tensors on ``device``,
bit for bit.  Stacked ``[L, ...]`` layer leaves stay stacked; f32, bf16
and int8 leaves keep their dtype; int8 weight dicts ``{q8, scale8,
sq_inv}`` pass through as dicts.  Dict kinds outside this slice raise.
``llava_params_to_numpy`` is the inverse (the round trip is exact).
"""
from __future__ import annotations

import numpy as np
import torch

from cullavo_tpu_torch.ops.nf4 import check_slice_kind

_PLAIN_DTYPES = (np.dtype(np.float32), np.dtype(np.int8))


def _leaf_to_torch(a, device) -> torch.Tensor:
    a = np.array(a)   # a writable, contiguous copy the tensor may own
    if a.dtype.name == "bfloat16":   # ml_dtypes.bfloat16: move the raw bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    elif a.dtype in _PLAIN_DTYPES:
        t = torch.from_numpy(a)
    else:
        raise TypeError(f"unsupported parameter dtype {a.dtype}")
    return t.to(device)


def llava_params_from_numpy(tree: dict, device) -> dict:
    """numpy parameter tree (JAX layout) -> dict of torch tensors on device."""
    def conv(node):
        if isinstance(node, dict):
            check_slice_kind(node)
            return {k: conv(v) for k, v in node.items()}
        return _leaf_to_torch(node, device)

    return conv(tree)


def llava_params_to_numpy(params: dict) -> dict:
    """The inverse of ``llava_params_from_numpy``: bf16 leaves come back as
    ``ml_dtypes.bfloat16`` arrays."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        t = node.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    return conv(params)
