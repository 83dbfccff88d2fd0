"""Fused attention: the hand-written CUDA forward kernels and the chunked
backward (counterpart of ``cullavo_tpu/ops/flash_attention.py``).

``flash_attention(q, k, v, q_positions, kv_valid, causal)`` takes what the
JAX function takes: q ``[B, H, T, d]``, k/v ``[B, H, S, d]`` (kv heads
already repeated), optional logical query positions ``[B, T]`` and 0/1 key
validity ``[B, S]``, causal or not, S and T independent.  It is a
``torch.autograd.Function``: the forward is a kernel, the backward the
JAX package's chunked recomputation in plain PyTorch (there it is plain XLA
too, no TPU kernel).

Forward on a CUDA tensor (``csrc/flash_fwd.cu``; bf16, head dim 128):
  * K1, the bias-free contract (causal, iota positions, no key mask,
    S == T): exact for every valid row of a right-padded batch;
  * K1-lse, the same launch that also writes the f32 log-sum-exp
    ``[B, H, T]``, whenever a gradient is needed;
  * K8, every other mode: scores masked by ``kv_valid[b, s] != 0 and (not
    causal or q_positions[b, t] >= s)``, with or without the lse.
For a tensor on the CPU the forward is ``mha_reference``; on any other
device it raises.  A masked score is the finite ``NEG_INF``: a row with no
visible key returns the mean of v and ``lse = NEG_INF + log(S)``, and gets
no gradient (the backward zeroes its probabilities).

One-token decode (``csrc/flash_decode.cu``, K12; f32 or bf16, head dim a
multiple of 8 up to 128): ``decode_partials(q, k_cache, v_cache, bias,
scale)`` returns the normalised f32 output with the row max and sum, so a
caller can fold in keys the kernel did not see (the zoo's
``sdpa_decode_stale``); ``flash_decode(q, k_cache, v_cache, q_position,
kv_valid)`` is the JAX function's entry on top of it.  On CPU tensors both
take ``_decode_partials_plain``.
"""
from __future__ import annotations

import types

import torch

from cullavo_tpu_torch import _build

NEG_INF = -1e30


def _visible(q_len, k_len, device, causal, positions, kv_valid):
    """Boolean mask broadcastable to [B, 1, T, S], or None when every key
    is visible."""
    mask = None
    if causal:
        qpos = (positions if positions is not None
                else torch.arange(q_len, device=device)[None, :])
        mask = (qpos[:, :, None] >= torch.arange(k_len, device=device)[None, None, :])[:, None]
    if kv_valid is not None:
        ok = (kv_valid != 0)[:, None, None, :]
        mask = ok if mask is None else mask & ok
    return mask


def mha_reference(q, k, v, causal=True, positions=None, kv_valid=None, need_lse=False):
    """Naive attention, q [B, H, T, d], k/v [B, H, S, d]: f32 scores, f32
    softmax, probabilities rounded to the input dtype for the PV product
    with f32 accumulation.  The functional spec of the kernels.  With
    ``need_lse`` returns ``(o, lse)``, lse f32 [B, H, T]."""
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    mask = _visible(q.shape[2], k.shape[2], q.device, causal, positions, kv_valid)
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(q.dtype).float(), v.float()).to(q.dtype)
    if need_lse:
        return out, torch.logsumexp(scores, dim=-1)
    return out


def _fit_block(pref: int, T: int, step: int = 128) -> int:
    """Largest ``step``-multiple <= ``pref`` dividing T, else the largest
    divisor of T within ``pref``."""
    pref = min(pref, T)
    best = 0
    for b in range(step, pref + 1, step):
        if T % b == 0:
            best = b
    if best:
        return best
    for b in range(pref, 0, -1):
        if T % b == 0:
            return b
    return T


def _mm_f32(a, b):
    """``a @ b`` with operands in their own dtype and an f32 result (f32
    accumulation): the tensor cores' rate for bf16 operands without rounding
    the sums to bf16."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.device.type == "cpu":
        return torch.matmul(a.float(), b.float())
    B, H = a.shape[:2]
    out = torch.bmm(a.reshape(B * H, *a.shape[2:]), b.reshape(B * H, *b.shape[2:]),
                    out_dtype=torch.float32)
    return out.reshape(B, H, *out.shape[1:])


def _flash_bwd(q, k, v, q_positions, kv_valid, causal, o, lse, do):
    """dq, dk, dv by blockwise recomputation, chunked over query rows so
    peak memory is O(chunk * S), not O(T * S).  Dot operands in the input
    dtype, f32 sums; probabilities are recomputed from the saved lse and
    zeroed under the mask, so a wholly masked row (whose forward probability
    is 1 everywhere) gives no gradient."""
    B, H, T, d = q.shape
    S = k.shape[2]
    scale = d ** -0.5
    ch = _fit_block(512, T, 8)
    op_dt = q.dtype
    kT = k.transpose(-1, -2)
    vT = v.transpose(-1, -2)
    dk = torch.zeros((B, H, S, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros((B, H, S, d), dtype=torch.float32, device=q.device)
    dq = torch.empty((B, H, T, d), dtype=q.dtype, device=q.device)
    for c0 in range(0, T, ch):
        sl = slice(c0, c0 + ch)
        qc, doc = q[:, :, sl], do[:, :, sl].to(op_dt)
        p = torch.exp(_mm_f32(qc, kT) * scale - lse[:, :, sl, None])
        pos = None
        if causal:
            pos = (q_positions[:, sl] if q_positions is not None
                   else torch.arange(c0, c0 + ch, device=q.device)[None, :])
        mask = _visible(ch, S, q.device, causal, pos, kv_valid)
        if mask is not None:
            p = torch.where(mask, p, torch.zeros_like(p))
        dv += _mm_f32(p.to(op_dt).transpose(-1, -2), doc)
        dp = _mm_f32(doc, vT)
        delta = (doc.float() * o[:, :, sl].float()).sum(dim=-1, keepdim=True)
        ds = (p * (dp - delta) * scale).to(op_dt)
        dq[:, :, sl] = _mm_f32(ds, k).to(q.dtype)
        dk += _mm_f32(ds.transpose(-1, -2), qc)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_valid, causal):
        need_lse = any(ctx.needs_input_grad[:3])
        if q.device.type == "cpu":
            res = mha_reference(q, k, v, causal, q_positions, kv_valid, need_lse=need_lse)
        else:
            res = _flash_cuda(q, k, v, q_positions, kv_valid, causal, need_lse)
        if not need_lse:
            return res
        o, lse = res
        ctx.save_for_backward(q, k, v, q_positions, kv_valid, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_positions, kv_valid, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, q_positions, kv_valid, ctx.causal, o, lse, do)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, q_positions=None, kv_valid=None, causal=True):
    """Attention over q [B, H, T, d] and k/v [B, H, S, d] (heads may be
    strided views of [B, T, H, d] projection outputs; d must be contiguous),
    differentiable in q, k and v.  Returns [B, H, T, d]; on CUDA the result
    is a [B, H, T, d] view of a [B, T, H, d] buffer, so
    ``.transpose(1, 2).reshape(B, T, H * d)`` is free.

    ``q_positions``: [B, T] logical positions for the causal mask (None:
    the row index, exact for right-padded batches).  ``kv_valid``: [B, S]
    0/1 key validity.  With both None, ``causal`` and S >= T, valid (prefix)
    rows of a right-padded batch are exact: causality hides every padded key
    from every valid query; padded query rows see padded keys and are
    discarded downstream."""
    if q.dim() != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not [B, H, T, d] / [B, H, S, d]")
    B, _, T, _ = q.shape
    S = k.shape[2]
    if q_positions is not None and tuple(q_positions.shape) != (B, T):
        raise ValueError(f"flash_attention: q_positions must be [{B}, {T}], got "
                         f"{tuple(q_positions.shape)}")
    if kv_valid is not None and tuple(kv_valid.shape) != (B, S):
        raise ValueError(f"flash_attention: kv_valid must be [{B}, {S}], got "
                         f"{tuple(kv_valid.shape)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _FlashAttention.apply(q, k, v, q_positions, kv_valid, causal)


# launch counts: K1 on ``flash_attention`` itself, K1-lse and K8 on their own
flash_attention.launches = 0
flash_lse = types.SimpleNamespace(launches=0)
flash_rows = types.SimpleNamespace(launches=0)


def _decode_partials_plain(q, k_cache, v_cache, bias, scale):
    """Plain version of K12: q [B, H, 1, d], caches [B, KV, S, d] (head h
    reads kv head h // (H / KV)), bias f32 [B, H, S] -> (o [B, H, d]
    normalised, m, l [B, H]), all f32.  A key at -inf counts 0; a row of
    such keys gives o = 0, m = -inf, l = 0."""
    B, H, _, d = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    q4 = q.reshape(B, KV, H // KV, d).float()
    s = torch.einsum("bgrd,bgsd->bgrs", q4, k_cache.float()).reshape(B, H, S) * scale + bias
    m = s.amax(dim=-1)
    p = torch.where(s == -torch.inf, torch.zeros_like(s), torch.exp(s - m[..., None]))
    l = p.sum(dim=-1)
    o = torch.einsum("bgrs,bgsd->bgrd", p.reshape(B, KV, H // KV, S), v_cache.float())
    o = o.reshape(B, H, d) / torch.where(l == 0, torch.ones_like(l), l)[..., None]
    return o, m, l


def decode_partials(q, k_cache, v_cache, bias, scale):
    """Attention of one new token per (b, h) over S cache keys: returns
    ``(o, m, l)``, o f32 [B, H, d] = softmax(scale * q.k + bias) @ v, and the
    f32 row max m and sum l [B, H] of that softmax (its lse is m + log l).

    q [B, H, 1, d]; k_cache / v_cache [B, KV, S, d] with H a multiple of KV
    (any strides: a layer of a stacked cache is read in place); bias
    additive, broadcastable to [B, H, S] (a broadcast axis is read with
    stride 0, not copied).  K12 on CUDA tensors (counted on
    ``decode_partials.launches``), the plain version on CPU tensors."""
    B, H, one, d = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape or one != 1 \
            or k_cache.shape[0] != B or k_cache.shape[3] != d or H % k_cache.shape[1]:
        raise ValueError(f"decode_partials: q {tuple(q.shape)}, caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} are not [B, H, 1, d] / [B, KV, S, d]")
    bias = bias.float().expand(B, H, k_cache.shape[2])
    if q.device.type == "cpu":
        return _decode_partials_plain(q, k_cache, v_cache, bias, scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_partials: unsupported device {q.device}")
    return _decode_cuda(q, k_cache, v_cache, bias, scale)


decode_partials.launches = 0


def flash_decode(q, k_cache, v_cache, q_position, kv_valid):
    """One new token against a KV-grouped cache (the JAX function's entry):
    q [B, H, 1, d], caches [B, KV, S, d], ``q_position`` [B] the token's
    logical position, ``kv_valid`` [B, S]; key s is visible where
    ``kv_valid[b, s] != 0 and s <= q_position[b]``.  Returns [B, H, 1, d]
    in q's dtype.  A masked score is ``NEG_INF``, as in JAX, so a row with
    no visible key averages v, over the S keys (JAX pads S to a multiple of
    128 and averages over the padding too)."""
    o, _, _ = decode_partials(q, k_cache, v_cache, decode_bias(q_position, kv_valid),
                              q.shape[-1] ** -0.5)
    return o.to(q.dtype)[:, :, None]


def decode_bias(q_position, kv_valid):
    """``flash_decode``'s mask as an additive f32 bias [B, 1, S]: 0 where
    ``kv_valid[b, s] != 0 and s <= q_position[b]``, else ``NEG_INF`` (added
    to a score it gives NEG_INF, as the Pallas kernel's ``where`` does)."""
    B, S = kv_valid.shape
    keys = torch.arange(S, device=kv_valid.device)
    visible = (kv_valid != 0) & (keys[None, :] <= q_position.reshape(B, 1))
    return torch.where(visible, 0.0, NEG_INF).float()[:, None, :]


def _flash_cuda(q, k, v, q_positions, kv_valid, causal, need_lse):
    B, H, T, d = q.shape
    S = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be bf16 on {q.device}")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} needs a contiguous head dim, "
                             "strides that are multiples of 8 and 16-byte alignment")
    if d != 128:
        raise ValueError(f"flash_attention: the CUDA kernels take head dim 128, got {d}")
    out = torch.empty((B, T, H, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device) if need_lse else None
    lib = _build.lib()
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if causal and q_positions is None and kv_valid is None and S == T:
        if need_lse:
            err = lib.cullavo_flash_fwd_lse(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                B, H, T, d, *strides, d ** -0.5, stream)
            counter = flash_lse
        else:
            err = lib.cullavo_flash_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, T, d,
                *strides, d ** -0.5, stream)
            counter = flash_attention
    else:
        masks = []
        for name, m in (("q_positions", q_positions), ("kv_valid", kv_valid)):
            if m is not None:
                if m.device != q.device or m.dtype.is_floating_point:
                    raise ValueError(f"flash_attention: {name} must be an integer or "
                                     f"boolean tensor on {q.device}")
                m = m.to(torch.int32).contiguous()
            masks.append(m)
        err = lib.cullavo_flash_rows(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if need_lse else None,
            *(None if m is None else m.data_ptr() for m in masks), int(causal),
            B, H, T, S, d, *strides, d ** -0.5, stream)
        counter = flash_rows
    _build.check(err, "flash_attention")
    counter.launches += 1
    return (out, lse) if need_lse else out


def _decode_cuda(q, k_cache, v_cache, bias, scale):
    B, H, _, d = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16) or d % 8 or not 8 <= d <= 128:
        raise ValueError("decode_partials: the CUDA kernel takes f32 or bf16 with a head dim "
                         f"that is a multiple of 8 up to 128, got {q.dtype} d={d}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache), ("bias", bias)):
        if t.device != q.device:
            raise ValueError(f"decode_partials: {name} must be on {q.device}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != q.dtype or t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"decode_partials: {name} must be {q.dtype} with a contiguous "
                             "head dim, 16-byte aligned rows and a 16-byte aligned base")
    if q.stride(3) != 1:
        raise ValueError("decode_partials: q needs a contiguous head dim")
    o = torch.empty((B, H, d), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    err = _build.lib().cullavo_flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), bias.data_ptr(), o.data_ptr(),
        m.data_ptr(), l.data_ptr(), int(q.dtype == torch.bfloat16), B, H, KV, S, d,
        *q.stride()[:2], *k_cache.stride()[:3], *v_cache.stride()[:3], *bias.stride(),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_partials")
    decode_partials.launches += 1
    return o, m, l
