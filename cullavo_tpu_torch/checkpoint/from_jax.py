"""Weight and decode-state bridge between the JAX package's trees and the port.

``llava_params_from_numpy`` takes a JAX LLaVA parameter tree whose leaves
are numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
port's parameters: the same nested dicts with torch tensors on ``device``,
bit for bit.  Stacked ``[L, ...]`` layer leaves stay stacked; f32, bf16,
int8 and int32 leaves keep their dtype; int8 weight dicts ``{q8, scale8,
sq_inv}`` and planar NF4 dicts ``{q4p int32, scale f32}`` pass through as
dicts, in the layout the kernels read.  Dict kinds not ported yet raise.
``llava_params_to_numpy`` is the inverse (the round trip is exact).
``decode_state_from_numpy`` does the same for a prefill/decode state, so
both packages can continue from one prefilled cache.
"""
from __future__ import annotations

import numpy as np
import torch

from cullavo_tpu_torch.ops.nf4 import check_slice_kind

_PLAIN_DTYPES = (np.dtype(np.float32), np.dtype(np.int8), np.dtype(np.int32))


def _leaf_to_torch(a, device) -> torch.Tensor:
    a = np.array(a)   # a writable, contiguous copy the tensor may own
    if a.dtype.name == "bfloat16":   # ml_dtypes.bfloat16: move the raw bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    elif a.dtype in _PLAIN_DTYPES:
        t = torch.from_numpy(a)
    else:
        raise TypeError(f"unsupported leaf dtype {a.dtype}")
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


def decode_state_from_numpy(state: dict, device) -> dict:
    """A JAX decode state with numpy leaves (``logits``, ``cache`` {``k``,
    ``v`` and, for the int8 cache, ``k_s``, ``v_s``}, ``full_mask``,
    ``key_pos``, ``cur_pos``, ``write_idx``, optional ``adapter_ids``) ->
    the port's state on ``device``, bit for bit.  A scalar ``write_idx``
    becomes a host int (the plain decode loop's form), a per-row one an
    int32 [B] tensor."""
    out = {key: _leaf_to_torch(state[key], device)
           for key in ("logits", "full_mask", "key_pos", "cur_pos")}
    out["cache"] = {name: _leaf_to_torch(a, device) for name, a in state["cache"].items()}
    widx = np.asarray(state["write_idx"])
    out["write_idx"] = int(widx) if widx.ndim == 0 else _leaf_to_torch(widx, device)
    out["adapter_ids"] = (_leaf_to_torch(state["adapter_ids"], device) if "adapter_ids" in state
                          else torch.zeros_like(out["cur_pos"]))
    return out
