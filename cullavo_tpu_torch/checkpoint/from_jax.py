"""Weight and decode-state bridge between the JAX package's trees and the port.

``llava_params_from_numpy`` takes a JAX LLaVA parameter tree whose leaves
are numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
port's parameters: the same nested dicts with torch tensors on ``device``,
bit for bit.  Stacked ``[L, ...]`` layer leaves stay stacked; f32, bf16,
int8, uint8 and int32 leaves keep their dtype; int8 weight dicts ``{q8,
scale8, sq_inv}``, planar NF4 dicts ``{q4p int32, scale f32}`` and
byte-packed NF4 dicts ``{q4 uint8, scale f32}`` pass through as dicts, in
the layout the kernels read.  Dict kinds not ported yet raise.
``llava_params_to_numpy`` is the inverse (the round trip is exact).
``nf4_tensor_from_numpy`` / ``nf4_tensor_to_numpy`` carry a JAX
``NF4Tensor`` (its arrays as numpy) to the port's ``ops.nf4.NF4Tensor``
and back.
``decode_state_from_numpy`` does the same for a prefill/decode state, so
both packages can continue from one prefilled cache.

Training state: ``lora_from_numpy`` / ``trainable_from_numpy`` convert an
adapter tree and the trainable partition (``{"lora", "projector", "lm_head",
"embed_tokens"}``, an absent ``lm_head`` stays None);
``opt_state_from_numpy`` takes the optax state of ``cullavo_optimizer``
(its ``ScaleByAdamState`` count/mu/nu, under ``MultiStepsState`` when
gradients accumulate) to the port's ``{count, mu, nu}`` state, leaf for
leaf.  Each has an inverse, so both packages can continue from one state.

X-Decoder: ``xdecoder_params_from_numpy`` takes the JAX model tree (NHWC
activations, HWIO convolution kernels, DaViT's depthwise ``conv1`` /
``conv2`` among them, stacked depthwise ``(depth, k, k, 1, C)`` focal and dw
kernels, SAM's ``HWOI`` transposed-convolution kernels)
to the port's layouts (PyTorch's ``[out, in, k, k]``, ``[depth, C, 1, k,
k]``, ``[in, out, 2, 2]`` spatially flipped); every other leaf keeps its
layout.  ``xdecoder_params_to_numpy`` is the inverse (exact).

VL zoo: ``blip2_params_from_numpy`` (the Q-Former's per-layer list stays a
list, the text-input Q-Former's ``ffn_t``, ``word_emb`` and ``pos_emb``
and an OPT, Flan-T5 or LLaMA tower alike: OPT's stacked ``[L, ...]``
leaves and its tables keep JAX's layout) and ``kosmos2_params_from_numpy`` keep
every leaf's layout and dtype; their ``_to_numpy`` inverses are exact.
``topic_params_from_numpy`` carries the topic classifier's two towers (the
LLaMA ``{"language_model": ...}`` and the CLIP text encoder) the same way.
"""
from __future__ import annotations

import numpy as np
import torch

from cullavo_tpu_torch.ops.nf4 import NF4Tensor, check_slice_kind
from cullavo_tpu_torch.utils.tree import tree_map

_PLAIN_DTYPES = (np.dtype(np.float32), np.dtype(np.int8), np.dtype(np.uint8),
                 np.dtype(np.int32))
# an NF4Tensor's original dtype, by numpy name
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


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


def nf4_tensor_from_numpy(t, device) -> NF4Tensor:
    """A JAX ``NF4Tensor`` whose arrays are numpy -> the port's, on device."""
    def conv(a):
        return None if a is None else _leaf_to_torch(a, device)

    return NF4Tensor(conv(t.packed), conv(t.absmax), tuple(t.shape),
                     _TORCH_DTYPES[np.dtype(t.dtype).name], conv(t.absmax_scale),
                     conv(t.absmax_offset))


def nf4_tensor_to_numpy(t: NF4Tensor) -> dict:
    """The port's NF4Tensor -> its fields as numpy arrays (``shape`` a tuple,
    ``dtype`` the torch dtype's name), the arguments of JAX's NF4Tensor."""
    def conv(a):
        return None if a is None else _leaf_to_numpy(a)

    return {"packed": conv(t.packed), "absmax": conv(t.absmax), "shape": tuple(t.shape),
            "dtype": str(t.dtype).removeprefix("torch."),
            "absmax_scale": conv(t.absmax_scale), "absmax_offset": conv(t.absmax_offset)}


def _leaf_to_numpy(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def llava_params_to_numpy(params: dict) -> dict:
    """The inverse of ``llava_params_from_numpy``: bf16 leaves come back as
    ``ml_dtypes.bfloat16`` arrays."""
    return tree_map(_leaf_to_numpy, params)


def trainable_from_numpy(tree: dict, device) -> dict:
    """A numpy tree of trainable leaves (the trainable partition, or a part
    of it) -> the same tree of tensors on ``device``; None stays None."""
    return tree_map(lambda a: _leaf_to_torch(a, device), tree)


def trainable_to_numpy(tree: dict) -> dict:
    return tree_map(_leaf_to_numpy, tree)


# an adapter tree is one kind of trainable tree
lora_from_numpy, lora_to_numpy = trainable_from_numpy, trainable_to_numpy


def _is_adam(node) -> bool:
    return hasattr(node, "mu") and hasattr(node, "nu")


def opt_state_from_numpy(opt_state, device) -> dict:
    """The optax state of ``cullavo_optimizer`` with numpy leaves
    (``jax.tree.map(np.asarray, state)``, which keeps the named tuples) ->
    the port's state on ``device``."""
    if hasattr(opt_state, "inner_opt_state"):        # optax MultiStepsState
        return {"mini_step": int(opt_state.mini_step),
                "gradient_step": int(opt_state.gradient_step),
                "inner": opt_state_from_numpy(opt_state.inner_opt_state, device),
                "acc_grads": trainable_from_numpy(opt_state.acc_grads, device)}

    def find(node):
        if _is_adam(node):
            return node
        if isinstance(node, tuple):
            return next((hit for hit in map(find, node) if hit is not None), None)
        return None

    adam = find(opt_state)
    if adam is None:
        raise TypeError("no ScaleByAdamState (count, mu, nu) in the optimizer state")
    return {"count": int(adam.count), "mu": trainable_from_numpy(adam.mu, device),
            "nu": trainable_from_numpy(adam.nu, device)}


def opt_state_to_numpy(state: dict, like):
    """The inverse: the port's state written into the structure of ``like``,
    an optax state of the same optimizer (for instance ``tx.init(params)``)."""
    if hasattr(like, "inner_opt_state"):
        return like._replace(mini_step=np.int32(state["mini_step"]),
                             gradient_step=np.int32(state["gradient_step"]),
                             inner_opt_state=opt_state_to_numpy(state["inner"],
                                                                like.inner_opt_state),
                             acc_grads=trainable_to_numpy(state["acc_grads"]))
    if _is_adam(like):
        return like._replace(count=np.int32(state["count"]),
                             mu=trainable_to_numpy(state["mu"]),
                             nu=trainable_to_numpy(state["nu"]))
    if "count" in getattr(like, "_fields", ()):      # the schedule's own count
        return like._replace(count=np.int32(state["count"]))
    if isinstance(like, tuple):
        parts = [opt_state_to_numpy(state, part) for part in like]
        return type(like)(*parts) if hasattr(like, "_fields") else tuple(parts)
    return like


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


def _xdecoder_leaf(path: tuple, a: torch.Tensor, to_port: bool) -> torch.Tensor:
    """One X-Decoder leaf between the JAX layout and the port's."""
    name = path[-1]
    if name == "kernel" and len(path) > 1 and path[-2] in ("up1", "up2"):
        # transposed conv: JAX (kh, kw, out, in) applied unflipped over the
        # dilated input == PyTorch's (in, out, kh, kw) flipped
        return (a.permute(3, 2, 0, 1).flip(2, 3) if to_port
                else a.flip(2, 3).permute(2, 3, 1, 0)).contiguous()
    if (name == "kernel" or name in ("conv1", "conv2")) and a.dim() == 4:
        # HWIO <-> [out, in/groups, k, k] (DaViT's conv1 / conv2 are depthwise)
        return (a.permute(3, 2, 0, 1) if to_port else a.permute(2, 3, 1, 0)).contiguous()
    if (name.startswith("focal") or name in ("dw1_w", "dw2_w")) and a.dim() == 5:
        # stacked depthwise kernels: (depth, k, k, 1, C) <-> (depth, C, 1, k, k)
        return (a.permute(0, 4, 3, 1, 2) if to_port else a.permute(0, 3, 4, 2, 1)).contiguous()
    return a


def _walk(node, path, fn):
    if isinstance(node, dict):
        return {k: _walk(v, path + (k,), fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_walk(v, path + (str(i),), fn) for i, v in enumerate(node)]
    return fn(path, node)


def xdecoder_params_from_numpy(tree: dict, device) -> dict:
    """numpy X-Decoder parameter tree (JAX layout) -> the port's parameters
    on ``device``."""
    return _walk(tree, (), lambda path, a: _xdecoder_leaf(path, _leaf_to_torch(a, "cpu"),
                                                          True).to(device))


def xdecoder_params_to_numpy(params: dict) -> dict:
    """The inverse of ``xdecoder_params_from_numpy``."""
    return _walk(params, (), lambda path, t: _leaf_to_numpy(
        _xdecoder_leaf(path, t.detach().cpu(), False)))


def blip2_params_from_numpy(tree: dict, device) -> dict:
    """A JAX BLIP-2 tree of numpy leaves -> the port's, on ``device``."""
    return tree_map(lambda a: _leaf_to_torch(a, device), tree)


def blip2_params_to_numpy(params: dict) -> dict:
    return tree_map(_leaf_to_numpy, params)


# a KOSMOS-2 tree carries no layout of its own either
kosmos2_params_from_numpy, kosmos2_params_to_numpy = blip2_params_from_numpy, blip2_params_to_numpy


def topic_params_from_numpy(llama_tree: dict, clip_tree: dict, device) -> tuple:
    """The topic classifier's towers, JAX trees of numpy leaves -> the
    port's (LLaMA ``{"language_model": ...}``, CLIP text encoder) on
    ``device``, every leaf in its layout and dtype."""
    return (blip2_params_from_numpy(llama_tree, device),
            blip2_params_from_numpy(clip_tree, device))
