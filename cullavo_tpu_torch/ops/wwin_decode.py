"""W-window decode attention over the stacked S-major KV cache: the
hand-written CUDA kernels K4 (bf16 cache) and K5 (int8 cache), their plain
PyTorch versions and the merge with the intra-window part (counterpart of
``cullavo_tpu/ops/wwin_decode.py``).

The stale-cache decode forward attends W fresh tokens (W = 1: the classic
decode step; W > 1: a speculative-verification window) against the cache as
it stands.  The cache part reads the full stacked ``[L, S, B, KV, hd]``
buffer in place through the layer index and returns flash-style partials
``(acc [B, H, W, hd] f32 unnormalised, m, l [B, H, W] f32)``;
``_merge_self_window`` joins them with the W x W intra-window block and
divides.  For tensors on the CPU the cache part is ``_cache_part_plain`` /
``_cache_part_q8_plain``; for CUDA tensors it launches K4 or K5 (both in
``csrc/wwin_decode_sm90.cu``: the one-row step on ``csrc/decode_rows.cuh``'s
lane-group body, wider windows on its ``mma.sync`` body, each a template
over the cache type), or raises.
"""
from __future__ import annotations

import torch

from cullavo_tpu_torch import _build

NEG_INF = -0.7 * torch.finfo(torch.float32).max
_VALID_FLOOR = 0.5 * NEG_INF      # scores below this are masked slots
MAX_W = 128                       # widest window the kernels take


def _window_scores(q, k_cur, scale):
    """Scores of the fresh decode window against itself: [B, H, W, W] with
    the intra-window causal mask (query i sees fresh keys j <= i).  W = 1
    reduces to the q.k_cur dot with no mask."""
    W = q.shape[2]
    if W == 1:
        return (q.float() * k_cur.float()).sum(dim=-1, keepdim=True) * scale
    s = torch.matmul(q.float(), k_cur.float().transpose(-1, -2)) * scale
    i = torch.arange(W, device=q.device)
    return torch.where(i[:, None] >= i[None, :], s, torch.full_like(s, NEG_INF))


def _fold_scale(s: torch.Tensor) -> torch.Tensor:
    """[S, B, H] per-key scales -> f32 [B, H, 1, S], broadcastable over scores."""
    return s.float().permute(1, 2, 0)[:, :, None, :]


def _bias_rows(bias, B, W, S):
    """[B|1, 1, W, S] additive key-validity bias -> f32 [B, W, S]."""
    if bias.dim() != 4 or bias.shape[1] != 1:
        raise ValueError(f"wwin_decode: bias must be [B|1, 1, W, S], got {tuple(bias.shape)}")
    return bias.expand(B, 1, W, S)[:, 0]


def _softmax_partials(s, v, n_rep, p_scale, dtype):
    """(acc, m, l) from scores s [B, KV, n_rep, W, S] and values v
    [S, B, KV, hd] f32; ``p_scale`` [B, KV, 1, 1, S] (or None) multiplies the
    probabilities before they are rounded to ``dtype`` for the PV product."""
    B, KV, _, W, _ = s.shape
    m = s.amax(dim=-1)
    # all-masked rows: s == m == NEG_INF would exp to 1, so gate them
    p = torch.where(s > _VALID_FLOOR, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    pv = p if p_scale is None else p * p_scale
    acc = torch.einsum("bgrws,sbgd->bgrwd", pv.to(dtype).float(), v)
    H = KV * n_rep
    return acc.reshape(B, H, W, -1), m.reshape(B, H, W), l.reshape(B, H, W)


def _cache_part_plain(q, kc, vc, li, bias, n_rep, scale):
    """Plain version of K4.  q [B, H, W, hd]; kc/vc [L, S, B, KV, hd]; bias
    [B, W, S] f32.  Head h = g * n_rep + r reads kv head g."""
    B, H, W, hd = q.shape
    KV = H // n_rep
    k = kc[li].to(q.dtype).float()
    v = vc[li].to(q.dtype).float()
    q5 = q.reshape(B, KV, n_rep, W, hd).float()
    s = torch.einsum("bgrwd,sbgd->bgrws", q5, k) * scale + bias[:, None, None]
    return _softmax_partials(s, v, n_rep, None, q.dtype)


def _cache_part_q8_plain(q, kc, ksc, vc, vsc, li, bias, n_rep, scale):
    """Plain version of K5: int8 codes kc/vc [L, S, B, KV, hd] with bf16
    scale planes ksc/vsc [L, S, B, KV]; the scales fold around the dots
    (scores = (q.codes_k) * (k_s * scale), out = (p * v_s).codes_v)."""
    B, H, W, hd = q.shape
    KV = H // n_rep
    k = kc[li].to(q.dtype).float()
    v = vc[li].to(q.dtype).float()
    k_s = ksc[li].float().permute(1, 2, 0)[:, :, None, None, :]     # [B, KV, 1, 1, S]
    v_s = vsc[li].float().permute(1, 2, 0)[:, :, None, None, :]
    q5 = q.reshape(B, KV, n_rep, W, hd).float()
    s = torch.einsum("bgrwd,sbgd->bgrws", q5, k) * (k_s * scale) + bias[:, None, None]
    return _softmax_partials(s, v, n_rep, v_s, q.dtype)


def _window_scores_q8(q, k_cur, win_q8, n_rep, scale):
    """Intra-window scores [B, H, W, W] under the int8 cache.  ``win_q8`` is
    the window's quantized k/v as they are about to be written to the cache,
    ``(k_wq [W, B, KV, hd] int8, k_ws [W, B, KV], v_wq, v_ws)`` before the
    head repeat.  Off-diagonal entries (draft key j < query i) take the SAME
    int8 + folded-scale path a later sequential step would read those slots
    back with; the diagonal (each token's own key) stays at full precision,
    as the W = 1 step keeps it.  Also returns the diagonal mask and the
    window's quantized values repeated to H heads, for ``_window_values_q8``."""
    k_wq, k_ws, v_wq, v_ws = win_q8
    if n_rep != 1:
        k_wq, v_wq = (torch.repeat_interleave(t, n_rep, dim=2) for t in (k_wq, v_wq))
        k_ws, v_ws = (torch.repeat_interleave(t, n_rep, dim=2) for t in (k_ws, v_ws))
    s_w = torch.einsum("bhqd,wbhd->bhqw", q.float(), k_wq.to(q.dtype).float())
    s_w = s_w * (_fold_scale(k_ws) * scale)                           # [B, H, W, W]
    diag = (q.float() * k_cur.float()).sum(dim=-1) * scale             # [B, H, W]
    i = torch.arange(q.shape[2], device=q.device)
    eye = i[:, None] == i[None, :]
    s_self = torch.where(eye, diag[..., None],
                         torch.where(i[:, None] > i[None, :], s_w,
                                     torch.full_like(s_w, NEG_INF)))
    return s_self, eye, v_wq, v_ws


def _window_values_q8(p_self, eye, v_wq, v_ws, v_cur, dtype):
    """The window's share of the output from normalised probabilities
    ``p_self`` [B, H, W, W]: draft values j < i through the cache compute
    path (``(p * v_s)`` rounded to ``dtype``, times the codes), each token's
    own value at full precision."""
    p_off = torch.where(eye, torch.zeros_like(p_self), p_self) * _fold_scale(v_ws)
    out = torch.einsum("bhqw,wbhd->bhqd", p_off.to(dtype).float(), v_wq.to(dtype).float())
    p_diag = torch.where(eye, p_self, torch.zeros_like(p_self)).sum(dim=-1)
    return out + p_diag[..., None] * v_cur.float()


def _merge_self_window(q, k_cur, v_cur, acc, m, l, scale, win_q8=None, n_rep=1):
    """Merge the cache part's partial softmax with the intra-window
    self-attention; k_cur/v_cur [B, H, W, hd].  With ``win_q8`` and W > 1
    the window takes the int8 cache's compute path (``_window_scores_q8``)."""
    quant_win = win_q8 is not None and q.shape[2] > 1
    if quant_win:
        s_self, eye, v_wq, v_ws = _window_scores_q8(q, k_cur, win_q8, n_rep, scale)
    else:
        s_self = _window_scores(q, k_cur, scale)                      # [B, H, W, W]
    m_tot = torch.maximum(m[..., None], s_self.amax(dim=-1, keepdim=True))
    e_s = torch.exp(s_self - m_tot)
    corr = torch.exp(m[..., None] - m_tot)
    denom = l[..., None] * corr + e_s.sum(dim=-1, keepdim=True)
    out = acc * corr
    if quant_win:
        out = out / denom + _window_values_q8(e_s / denom, eye, v_wq, v_ws, v_cur, q.dtype)
        return out.to(q.dtype)
    out = out + torch.matmul(e_s, v_cur.float())
    return (out / denom).to(q.dtype)


def _check_launch_inputs(name, q, kc, vc, cache_dtype, planes):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    B, H, W, hd = q.shape
    if q.dtype != torch.bfloat16 or hd != 128 or not 1 <= W <= MAX_W:
        raise ValueError(f"{name}: the CUDA kernel takes bf16 queries with head dim 128 "
                         f"and 1 <= W <= {MAX_W}, got {q.dtype} {tuple(q.shape)}")
    align = 16 // kc.element_size()
    for label, t, dt in (("kc", kc, cache_dtype), ("vc", vc, cache_dtype)) + tuple(
            (label, t, torch.bfloat16) for label, t in planes):
        if t.dtype != dt or t.device != q.device:
            raise ValueError(f"{name}: {label} must be {dt} on {q.device}")
    if kc.shape != vc.shape or kc.stride() != vc.stride() or kc.dim() != 5 or kc.shape[4] != hd:
        raise ValueError(f"{name}: kc/vc must be [L, S, B, KV, {hd}] with equal strides")
    for label, t in (("kc", kc), ("vc", vc)):
        if t.stride(4) != 1 or any(s % align for s in t.stride()[:4]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} needs a contiguous head dim, 16-byte "
                             "aligned rows and a 16-byte aligned base")
    if q.stride(3) != 1 or any(s % 2 for s in q.stride()[:3]) or q.data_ptr() % 4:
        raise ValueError(f"{name}: q needs a contiguous head dim and even strides")
    if planes and (planes[0][1].shape != kc.shape[:4] or planes[1][1].shape != kc.shape[:4]
                   or planes[0][1].stride() != planes[1][1].stride()):
        raise ValueError(f"{name}: the scale planes must be [L, S, B, KV] with equal strides")


def _prepare(name, q, kc, li, bias, n_rep):
    B, H, W, hd = q.shape
    L, S, Bc, KV = kc.shape[:4]
    if H != KV * n_rep or Bc != B or not 0 <= int(li) < L:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit cache {tuple(kc.shape)} "
                         f"at layer {li} with n_rep={n_rep}")
    return _bias_rows(bias, B, W, S)


def _alloc_out(q):
    B, H, W, hd = q.shape
    acc = torch.empty((B, H, W, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H, W), dtype=torch.float32, device=q.device)
    return acc, m, torch.empty_like(m)


def _bias_for_kernel(bias_rows):
    """The kernel reads bias[b, w, slot] through (b, w) strides with unit
    slot stride; a broadcast batch axis keeps stride 0 (no copy)."""
    if bias_rows.dtype != torch.float32:
        raise ValueError("wwin_decode: bias must be float32")
    return bias_rows if bias_rows.stride(2) == 1 else bias_rows.contiguous()


def _run_cache_part(q, kc, vc, li, bias_rows, n_rep, scale):
    """(acc, m, l) of the bf16-cache part: K4 on CUDA tensors (counted on
    ``wwin_decode_smajor.launches``), its plain version on CPU tensors."""
    if q.device.type == "cpu":
        return _cache_part_plain(q, kc, vc, li, bias_rows, n_rep, scale)
    _check_launch_inputs("wwin_decode_smajor", q, kc, vc, torch.bfloat16, ())
    B, H, W, hd = q.shape
    S, KV = kc.shape[1], kc.shape[3]
    bias_rows = _bias_for_kernel(bias_rows)
    acc, m, l = _alloc_out(q)
    err = _build.lib().cullavo_wwin_decode(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), bias_rows.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), int(li), B, KV, n_rep, W, S, hd,
        *q.stride()[:3], *kc.stride()[:4], *bias_rows.stride()[:2], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "wwin_decode_smajor")
    wwin_decode_smajor.launches += 1
    return acc, m, l


def _run_cache_part_q8(q, kc, ksc, vc, vsc, li, bias_rows, n_rep, scale):
    """(acc, m, l) of the int8-cache part: K5 on CUDA tensors (counted on
    ``wwin_decode_smajor_q8.launches``), its plain version on CPU tensors."""
    if q.device.type == "cpu":
        return _cache_part_q8_plain(q, kc, ksc, vc, vsc, li, bias_rows, n_rep, scale)
    _check_launch_inputs("wwin_decode_smajor_q8", q, kc, vc, torch.int8,
                         (("ksc", ksc), ("vsc", vsc)))
    B, H, W, hd = q.shape
    S, KV = kc.shape[1], kc.shape[3]
    bias_rows = _bias_for_kernel(bias_rows)
    acc, m, l = _alloc_out(q)
    err = _build.lib().cullavo_wwin_decode_q8(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), ksc.data_ptr(), vsc.data_ptr(),
        bias_rows.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(), int(li),
        B, KV, n_rep, W, S, hd, *q.stride()[:3], *kc.stride()[:4], *ksc.stride()[:4],
        *bias_rows.stride()[:2], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "wwin_decode_smajor_q8")
    wwin_decode_smajor_q8.launches += 1
    return acc, m, l


def _repeat_heads(x, H, n_rep):
    return x if x.shape[1] == H else torch.repeat_interleave(x, n_rep, dim=1)


def wwin_decode_smajor(q, kc, vc, li, k_cur, v_cur, bias, n_rep=1, scale=None):
    """W-window stale-cache attention reading the FULL stacked cache (no
    per-layer slice copy).  q/k_cur/v_cur: [B, H, W, hd] (k_cur/v_cur may
    still have KV heads); kc/vc: [L, S, B, KV, hd]; li: layer index; bias:
    [B|1, 1, W, S] additive key validity.  Any S; 1 <= W <= 128 on CUDA."""
    B, H, W, hd = q.shape
    scale = hd ** -0.5 if scale is None else scale
    bias_rows = _prepare("wwin_decode_smajor", q, kc, li, bias, n_rep)
    acc, m, l = _run_cache_part(q, kc, vc, li, bias_rows, n_rep, scale)
    return _merge_self_window(q, _repeat_heads(k_cur, H, n_rep),
                              _repeat_heads(v_cur, H, n_rep), acc, m, l, scale)


wwin_decode_smajor.launches = 0


def wwin_decode_smajor_q8(q, kc, ksc, vc, vsc, li, k_cur, v_cur, bias, n_rep=1,
                          scale=None, win_q8=None):
    """``wwin_decode_smajor`` over the int8 cache: kc/vc int8 [L, S, B, KV,
    hd], ksc/vsc bf16 [L, S, B, KV] per-vector scales.  ``win_q8``: the
    window's quantized k/v (see ``_merge_self_window``)."""
    B, H, W, hd = q.shape
    scale = hd ** -0.5 if scale is None else scale
    bias_rows = _prepare("wwin_decode_smajor_q8", q, kc, li, bias, n_rep)
    acc, m, l = _run_cache_part_q8(q, kc, ksc, vc, vsc, li, bias_rows, n_rep, scale)
    return _merge_self_window(q, _repeat_heads(k_cur, H, n_rep),
                              _repeat_heads(v_cur, H, n_rep), acc, m, l, scale,
                              win_q8=win_q8, n_rep=n_rep)


wwin_decode_smajor_q8.launches = 0
