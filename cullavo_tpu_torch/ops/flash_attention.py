"""Causal prefill attention: the hand-written CUDA kernel K1 and its plain
PyTorch version (counterpart of ``cullavo_tpu/ops/flash_attention.py``).

``flash_attention`` takes the contract the LLaMA prefill uses on the TPU
(``llama.py`` flash branch): causal, right-padded, bias-free, global iota
query positions, kv heads already repeated, S == T.  For a tensor on the
CPU it runs ``mha_reference``; for a CUDA tensor it launches
``csrc/flash_fwd.cu`` or raises.  Other modes (explicit positions, key
masks, non-causal) wait for slice 4 (training) and raise.
"""
from __future__ import annotations

import torch

from cullavo_tpu_torch import _build

NEG_INF = -1e30


def mha_reference(q, k, v, causal=True):
    """Naive attention, q/k/v [B, H, T, d]: f32 scores, f32 softmax,
    probabilities rounded to the input dtype for the PV product with f32
    accumulation.  The functional spec of the kernel."""
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        T, S = q.shape[2], k.shape[2]
        mask = (torch.arange(T, device=q.device)[:, None]
                >= torch.arange(S, device=q.device)[None, :])
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(q.dtype).float(), v.float()).to(q.dtype)


def flash_attention(q, k, v, q_positions=None, kv_valid=None, causal=True):
    """Causal attention over q/k/v [B, H, T, d] (heads may be strided views
    of [B, T, H, d] projection outputs; d must be contiguous).  Returns
    [B, H, T, d]; on CUDA the result is a [B, H, T, d] view of a
    [B, T, H, d] buffer, so ``.transpose(1, 2).reshape(B, T, H * d)`` is free.

    Valid (prefix) rows of a right-padded batch are exact: causality hides
    every padded key from every valid query.  Padded query rows see padded
    keys and are discarded downstream."""
    if q_positions is not None or kv_valid is not None or not causal:
        raise NotImplementedError(
            "flash_attention: explicit q_positions / kv_valid / non-causal "
            "attention waits for slice 4 (training)")
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_attention: q/k/v shapes differ "
                         f"({tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)})")
    if q.device.type == "cpu":
        return mha_reference(q, k, v, causal=True)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _flash_cuda(q, k, v)


flash_attention.launches = 0


def _flash_cuda(q, k, v):
    B, H, T, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be bf16 on {q.device}")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} needs a contiguous head dim, "
                             "strides that are multiples of 8 and 16-byte alignment")
    if d != 128:
        raise ValueError(f"flash_attention: the CUDA kernel takes head dim 128, got {d}")
    out = torch.empty((B, T, H, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lib = _build.lib()
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = lib.cullavo_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, T, d,
        *strides, d ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out
