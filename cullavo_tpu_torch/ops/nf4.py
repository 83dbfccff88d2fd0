"""Quantized linears (counterpart of ``cullavo_tpu/ops/nf4.py``): SmoothQuant
W8A8 int8 weights, planar NF4 weights and the byte-packed NF4 formats.

Weight dicts keep the JAX layout: int8 ``{"q8": int8 [..., K, N], "scale8":
f32 [..., 1, N], "sq_inv": bf16 [..., 1, K]}``; planar NF4 ``{"q4p": int32
[..., K/8, N], "scale": f32 [..., K, N/64]}`` (bits 4i..4i+3 of word
[k8, n] hold the code of element (i * K/8 + k8, n); one absmax per row and
64-column block); byte-packed NF4 ``{"q4": uint8 [..., K*N/2], "scale": f32
[..., K*N/64]}`` (``quantize_linear``: the flat row-major weight in blocks of
64, two codes per byte, high nibble first) and ``NF4Tensor`` (the same
packing of any 2-D array, with a double-quantized absmax).  Five kernels
live here:

* K2 ``quantize_rows`` (``csrc/quant_rows.cu``): the per-token activation
  quantizer in front of every s8s8 prefill GEMM, bit-identical to the JAX
  chain (``_quant_inv_scale``).
* K3 ``int8_linear`` (``csrc/nf4_gemv_sm90.cu``, the int8 instantiation of
  K6's template): ``x @ (q8 * scale8)`` with the weight kept int8 in device
  memory, at every M (decode, and the prefill of dicts without ``sq_inv``);
  ``int8_gemv_plan`` picks its tiles and splits.
* K6 ``nf4_linear_planar`` (``csrc/nf4_gemv_sm90.cu``): ``x @ dequant(q4p,
  scale)`` with the weight kept 4-bit in device memory, for M < 512.
* K7 ``nf4_dequant_planar`` (``csrc/nf4_planar.cu``): planar NF4 -> dense
  bf16 once, in front of a plain matmul, for M >= 512.
* K11 ``nf4_linear_q4`` (``csrc/nf4_gemv_sm90.cu``, K6's template over
  bytes) / ``nf4_dequant_q4`` (``csrc/nf4_q4.cu``): the byte-packed
  counterparts of K6 and K7, for ``q4`` dicts whose N is a multiple of 64
  (one absmax per row and 64-column block) and for ``nf4_matmul_fused``
  over an ``NF4Tensor`` (absmax decoded first).  ``nf4_gemv_plan`` picks
  the fused kernels' tiles and splits.

Each wrapper takes its plain PyTorch version for a tensor on the CPU and
launches its kernel (or raises) for a CUDA tensor.  The int8 x int8 ->
int32 product at prefill M is ``torch._int_mm`` (cuBLAS) on the card, as
JAX leaves it to XLA's ``dot_general``; on the CPU it is an exact int32
matmul.  Dict kinds outside this slice raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from cullavo_tpu_torch import _build

# M at or above this -> s8s8 (compute-bound prefill); below -> the
# weight-only stream (memory-bound decode).  The JAX default.
_S8S8_MIN_M = 1024

_NOT_IN_SLICE = {
    "q8t": "the transposed int8 layout ('q8t') waits for a later slice",
    "o_w": "static LLM.int8 outlier dicts ('o_w') wait for slice 4 (calibration)",
    "sa": "static activation scales ('sa') wait for slice 4 (calibration)",
}


def check_slice_kind(q: dict) -> None:
    """Raise for an int8/NF4 dict kind this port does not run yet."""
    for key, msg in _NOT_IN_SLICE.items():
        if key in q:
            raise NotImplementedError(msg)


def _div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise IEEE division of two tensors.  ``scalar / t`` is
    ``reciprocal(t) * scalar`` in torch, and ``t / scalar`` on CUDA
    multiplies by the rounded reciprocal: both round twice and break the
    bit-equality of quantization scales with the JAX chain and the kernels."""
    return torch.div(a, b)


def _rows(x):
    M = 1
    for s in x.shape[:-1]:
        M *= s
    return M


# ---------------------------------------------------------------------------
# weight quantization
# ---------------------------------------------------------------------------

def quantize_linear_int8(w: torch.Tensor, smooth_scale=None) -> dict:
    """[..., d_in, d_out] -> {"q8", "scale8"} per-output-channel absmax int8.

    ``smooth_scale`` (per-input-channel [K] or [..., K]): SmoothQuant
    migration; the weight is quantized as ``diag(s) @ W`` and ``sq_inv =
    bf16(1 / s)`` [..., 1, K] is stored so the runtime computes
    ``(x / s) @ diag(s) W``.  Same f32 formulation as the JAX quantizer,
    so codes and scales are bit-equal."""
    wf = w.float()
    s = None
    if smooth_scale is not None:
        s = torch.as_tensor(smooth_scale, dtype=torch.float32, device=w.device)
        wf = wf * s[..., :, None]
    absmax = wf.abs().amax(dim=-2, keepdim=True)
    scale = _div(torch.where(absmax == 0, torch.ones_like(absmax), absmax),
                 torch.full_like(absmax, 127.0))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    out = {"q8": q, "scale8": scale}
    if s is not None:
        lead = tuple(w.shape[:-2])
        out["sq_inv"] = _div(torch.ones_like(s), s).to(torch.bfloat16)[..., None, :].expand(
            lead + (1, w.shape[-2])).contiguous()
    return out


# ---------------------------------------------------------------------------
# K3: int8 weight-only linear
# ---------------------------------------------------------------------------

def _int8_linear_plain(x, q):
    """bf16/f32 ``(x * sq_inv) @ q8`` accumulated in f32, times scale8 per
    column after the dot, one rounding to x's dtype."""
    if "sq_inv" in q:
        x = x * q["sq_inv"].reshape(1, -1).to(x.dtype)
    y = torch.matmul(x.float(), q["q8"].float()) * q["scale8"].reshape(1, -1).float()
    return y.to(x.dtype)


def int8_linear(x: torch.Tensor, q: dict) -> torch.Tensor:
    """x [..., K] @ dequant(q) with the scale applied after the dot."""
    check_slice_kind(q)
    if x.device.type == "cpu":
        return _int8_linear_plain(x, q)
    if x.device.type != "cuda":
        raise ValueError(f"int8_linear: unsupported device {x.device}")
    return _int8_linear_cuda(x, q)


int8_linear.launches = 0


def _int8_linear_cuda(x, q):
    """K3 on CUDA tensors: one launch of the int8 instantiation of the fused
    template at every M (with ``sq_inv``, its prologue writes bf16(x *
    sq_inv) first, in the same C entry point)."""
    q8, scale8, sq_inv = q["q8"], q["scale8"], q.get("sq_inv")
    K, N = q8.shape[-2], q8.shape[-1]
    if x.dtype != torch.bfloat16 or x.shape[-1] != K:
        raise ValueError(f"int8_linear: x must be bf16 [..., {K}], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if q8.dtype != torch.int8 or q8.dim() != 2 or not q8.is_contiguous():
        raise ValueError("int8_linear: q8 must be a contiguous int8 [K, N] matrix")
    if N % 16 or K % 8 or q8.data_ptr() % 16:
        raise ValueError(f"int8_linear: the kernel needs N % 16 == 0, K % 8 == 0 "
                         f"and a 16-byte aligned weight (K={K}, N={N})")
    if scale8.dtype != torch.float32 or scale8.numel() != N or not scale8.is_contiguous():
        raise ValueError("int8_linear: scale8 must be a contiguous f32 [1, N]")
    for t in (q8, scale8) + ((sq_inv,) if sq_inv is not None else ()):
        if t.device != x.device:
            raise ValueError("int8_linear: weight and activation on different devices")
    if sq_inv is not None:
        sq_inv = sq_inv.to(torch.bfloat16).contiguous()
        if sq_inv.numel() != K:
            raise ValueError("int8_linear: sq_inv must hold K values")
        if sq_inv.data_ptr() % 16:
            sq_inv = sq_inv.clone()
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    M = x2.shape[0]
    if M < 1:
        raise ValueError("int8_linear: x has no rows")
    plan = int8_gemv_plan(M, K, N, _sm_count(x.device))
    ws, ctr = _gemv_scratch(plan, x.device)
    xs = None if sq_inv is None else torch.empty_like(x2)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    lib = _build.lib()
    err = lib.cullavo_int8_linear(
        x2.data_ptr(), None if sq_inv is None else sq_inv.data_ptr(), q8.data_ptr(),
        scale8.data_ptr(), None if xs is None else xs.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), None if ctr is None else ctr.data_ptr(), M, K, N,
        plan["nt"], plan["g"], plan["splits"], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "int8_linear")
    int8_linear.launches += 1
    return out.reshape(*lead, N)


# ---------------------------------------------------------------------------
# K2: per-row activation quantization (s8s8 prefill)
# ---------------------------------------------------------------------------

def _quant_inv_scale(a: torch.Tensor):
    """(inv, sx) from an f32 row absmax: codes = round(x * inv) and sx is
    exactly 1 / inv.  Constant numerators only and one rounding point (see
    the JAX ``_quant_inv_scale`` for why), so the kernel and this chain
    agree bit for bit."""
    inv = _div(torch.full_like(a, 127.0), torch.clamp_min(a, 1e-12))
    sx = _div(torch.ones_like(inv), inv)
    return inv, sx


def _quantize_rows_plain(x2, mult):
    xf = x2.float()
    if mult is not None:
        xf = xf * mult.float().reshape(1, -1)
    inv, sx = _quant_inv_scale(xf.abs().amax(dim=-1, keepdim=True))
    xi = torch.clamp(torch.round(xf * inv), -127, 127).to(torch.int8)
    return xi, sx


def quantize_rows(x2: torch.Tensor, mult=None):
    """(xi int8 [M, K], sx f32 [M, 1]) = per-row quant of ``x2 * mult``;
    ``mult`` is the [1, K] SmoothQuant ``sq_inv`` (or None)."""
    if x2.device.type == "cpu":
        return _quantize_rows_plain(x2, mult)
    if x2.device.type != "cuda":
        raise ValueError(f"quantize_rows: unsupported device {x2.device}")
    return _quantize_rows_cuda(x2, mult)


quantize_rows.launches = 0

# K2's vectors of 8 bf16 a thread (its instantiations) and row width
QUANT_VPT = (2, 4, 6, 8)
QUANT_MAX_K = 24576


def quant_rows_plan(M: int, K: int, sms: int, resident: Optional[int] = None) -> dict:
    """K2's launch (pure): ``vpt`` 16-byte vectors a thread (the fewest of
    ``QUANT_VPT`` that keep a row within 256 threads; 8 past that), the
    ``threads`` of a block (a multiple of 32, at most 384), and ``blocks``:
    ``resident`` blocks an SM (what the card reports for the instantiation;
    by default as many as 2048 threads allow) on ``sms`` SMs, never more
    than M.  Block b quantizes rows b, b + blocks, ...; thread t owns
    vectors t + j * threads (j < vpt) of each row."""
    if K % 8 or not 0 < K <= QUANT_MAX_K or M < 1:
        raise ValueError(f"quant_rows_plan: needs M >= 1, K % 8 == 0 and K <= "
                         f"{QUANT_MAX_K} (M={M}, K={K})")
    nvec = K // 8
    vpt = next((v for v in QUANT_VPT if -(-nvec // v) <= 256), QUANT_VPT[-1])
    per_row = -(-nvec // vpt)        # threads a row needs
    threads = 32 * -(-per_row // 32)
    resident = resident if resident is not None else 2048 // threads
    return {"vpt": vpt, "threads": threads, "blocks": min(M, sms * max(1, resident))}


_QUANT_MULT = {None: 0, torch.bfloat16: 1, torch.float32: 2}


@functools.lru_cache(maxsize=None)
def _quant_card(device_index: int, vpt: int, kind: int, threads: int):
    """(SMs, K2 blocks an SM holds) as the card reports them for one
    instantiation and block size."""
    resident = _build.lib().cullavo_quant_rows_resident(vpt, kind, threads)
    if resident < 1:
        raise RuntimeError(f"quantize_rows: no block of {threads} threads fits an SM")
    return torch.cuda.get_device_properties(device_index).multi_processor_count, resident


def _quantize_rows_cuda(x2, mult):
    if x2.dtype != torch.bfloat16 or x2.dim() != 2 or not x2.is_contiguous():
        raise ValueError("quantize_rows: x2 must be a contiguous bf16 [M, K]")
    M, K = x2.shape
    if K % 8 or K > QUANT_MAX_K or x2.data_ptr() % 16:
        raise ValueError(f"quantize_rows: the kernel needs K % 8 == 0, "
                         f"K <= {QUANT_MAX_K} and 16-byte alignment (K={K})")
    if mult is not None:
        if mult.numel() != K or mult.device != x2.device:
            raise ValueError("quantize_rows: mult must hold K values on x2's device")
        if mult.dtype not in _QUANT_MULT:
            raise ValueError(f"quantize_rows: mult must be bf16 or f32, got {mult.dtype}")
        mult = mult.reshape(K)
        if not mult.is_contiguous() or mult.data_ptr() % 16:
            raise ValueError("quantize_rows: mult must be contiguous and 16-byte aligned")
    xi = torch.empty((M, K), dtype=torch.int8, device=x2.device)
    sx = torch.empty((M, 1), dtype=torch.float32, device=x2.device)
    if M == 0:
        return xi, sx
    kind = _QUANT_MULT[None if mult is None else mult.dtype]
    plan = quant_rows_plan(M, K, 1)
    plan = quant_rows_plan(M, K, *_quant_card(x2.device.index, plan["vpt"], kind,
                                               plan["threads"]))
    lib = _build.lib()
    err = lib.cullavo_quant_rows(
        x2.data_ptr(), None if mult is None else mult.data_ptr(),
        xi.data_ptr(), sx.data_ptr(), M, K, kind, plan["vpt"], plan["threads"], plan["blocks"],
        torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, "quantize_rows")
    quantize_rows.launches += 1
    return xi, sx


# ---------------------------------------------------------------------------
# s8s8 prefill path
# ---------------------------------------------------------------------------

def _s8s8_prequant(x2: torch.Tensor, q: dict):
    """Per-row activation quantization for the s8s8 path, with ``q``'s
    SmoothQuant ``sq_inv``.  Returns (xi int8 [M, K], sx f32 [M, 1])."""
    check_slice_kind(q)
    return quantize_rows(x2, q.get("sq_inv"))


def _int_dot(xi, q8):
    """Exact int8 x int8 -> int32 product.  On the card cuBLAS's int8
    tensor-core GEMM wants the weight K-major: the [K, N] row-major q8 is
    copied to column-major storage first (on an H100, [4536, 11008] x
    [11008, 4096]: 3.37 ms on the row-major operand, 0.82 ms copy included)."""
    if xi.device.type == "cpu":
        return torch.matmul(xi.to(torch.int32), q8.to(torch.int32))
    return torch._int_mm(xi, q8.t().contiguous().t())


def _s8s8_apply(xi, sx, q):
    """int8 dot + epilogue ``acc * sx * s_col`` (in that order) -> f32."""
    s_col = q["scale8"].reshape(1, -1).float()
    return _int_dot(xi, q["q8"]).float() * sx * s_col


def int8_linear_s8s8_group(x: torch.Tensor, qs: tuple):
    """Several linears on the SAME input (q/k/v; gate/up) share ONE
    activation quantization pass, made with ``qs[0]``'s calibration (the
    quantizer enforces one shared scale per group).  Returns a tuple of
    outputs in x.dtype."""
    K = x.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).to(torch.bfloat16).contiguous()
    xi, sx = _s8s8_prequant(x2, qs[0])
    return tuple(_s8s8_apply(xi, sx, q).reshape(*lead, -1).to(x.dtype)
                 for q in qs)


def int8_linear_s8s8(x: torch.Tensor, q: dict) -> torch.Tensor:
    """W8A8 forward for a SmoothQuant-calibrated dict: bf16 input, per-token
    int8 activations, int8 GEMM, f32 epilogue."""
    check_slice_kind(q)
    if "sq_inv" not in q:
        raise NotImplementedError("dynamic LLM.int8 outlier decomposition "
                                  "(uncalibrated s8s8) waits for slice 4")
    return int8_linear_s8s8_group(x, (q,))[0]


def int8_linear_s8s8_auto(x: torch.Tensor, q: dict) -> torch.Tensor:
    """s8s8 at prefill-sized M, the weight-only stream at decode M."""
    if _rows(x) >= _S8S8_MIN_M and "q8" in q:
        return int8_linear_s8s8(x, q)
    return int8_linear(x, q)


def s8s8_group_enabled(ws, x) -> bool:
    """True when the grouped s8s8 path runs: every weight is a
    SmoothQuant-calibrated int8 dict and M is prefill-sized."""
    if not all(isinstance(w, dict) and "q8" in w and "sq_inv" in w for w in ws):
        return False
    return _rows(x) >= _S8S8_MIN_M


def int8_linear_policy(x: torch.Tensor, q: dict) -> torch.Tensor:
    """The int8 linear of the model towers (the JAX default policy "auto"):
    s8s8 (phase-aware) for calibrated dicts, the exact weight-only linear
    otherwise."""
    check_slice_kind(q)
    if "sq_inv" in q and "q8" in q:
        return int8_linear_s8s8_auto(x, q)
    return int8_linear(x, q)


# ---------------------------------------------------------------------------
# planar NF4
# ---------------------------------------------------------------------------

NF4_CODE = np.array([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
], dtype=np.float32)

# midpoints between adjacent codebook entries -> nearest-value quantization
NF4_MIDPOINTS = (NF4_CODE[1:] + NF4_CODE[:-1]) / 2.0

BLOCK = 64          # values per absmax block (bnb nf4 default)

# M at or above this -> dequant once (K7) + a dense matmul; below -> the fused
# kernel (K6), which keeps the weight stream 4-bit.  The JAX default.
_NF4_DEQ_M_THRESHOLD = 512


def is_quantized_planar(w) -> bool:
    return isinstance(w, dict) and "q4p" in w


def _planar_dims(q: dict, d_in=None, d_out=None):
    """(d_in, d_out) of a 2-D planar dict, from its leaf shapes."""
    k8, n = q["q4p"].shape[-2], q["q4p"].shape[-1]
    if (d_in not in (None, 8 * k8)) or (d_out not in (None, n)):
        raise ValueError(f"planar NF4 dict is [{8 * k8}, {n}], not [{d_in}, {d_out}]")
    return 8 * k8, n


def quantize_linear_planar(w: torch.Tensor) -> dict:
    """[..., d_in, d_out] -> {"q4p": int32 [..., d_in/8, d_out], "scale": f32
    [..., d_in, d_out/BLOCK]} on w's device.  Blockwise absmax over 64
    consecutive output columns, nearest codebook entry by midpoint
    comparisons, eight row-planes per int32 word: codes and scales are
    bit-equal to the JAX quantizer's.  Works one leading matrix at a time,
    so the f32 temporaries stay one matrix large."""
    *lead, d_in, d_out = w.shape
    if d_in % 8 or d_out % BLOCK:
        raise ValueError(f"planar NF4 needs d_in % 8 == 0 and d_out % {BLOCK} == 0, "
                         f"got [{d_in}, {d_out}]")
    k8, nb = d_in // 8, d_out // BLOCK
    mats = w.reshape(-1, d_in, d_out)
    words = torch.empty((mats.shape[0], k8, d_out), dtype=torch.int32, device=w.device)
    scale = torch.empty((mats.shape[0], d_in, nb), dtype=torch.float32, device=w.device)
    for l in range(mats.shape[0]):
        blocks = mats[l].float().reshape(d_in, nb, BLOCK)
        absmax = blocks.abs().amax(dim=-1)
        normed = _div(blocks, torch.where(absmax == 0, torch.ones_like(absmax),
                                          absmax)[..., None].expand_as(blocks))
        codes = torch.zeros(blocks.shape, dtype=torch.int64, device=w.device)
        for m in NF4_MIDPOINTS.tolist():
            codes += normed > m
        codes = codes.reshape(d_in, d_out)
        packed = torch.zeros((k8, d_out), dtype=torch.int64, device=w.device)
        for i in range(8):
            packed |= codes[i * k8:(i + 1) * k8] << (4 * i)
        # plane 7 reaches bit 31: fold into the signed 32-bit range exactly
        packed = torch.where(packed >= 2 ** 31, packed - 2 ** 32, packed)
        words[l] = packed.to(torch.int32)
        scale[l] = absmax
    return {"q4p": words.reshape(*lead, k8, d_out), "scale": scale.reshape(*lead, d_in, nb)}


def dequant_linear_planar(q: dict, d_in=None, d_out=None, dtype=torch.bfloat16):
    """Planar -> dense [d_in, d_out]: ``code_f32 * scale_f32`` rounded once
    to ``dtype``.  The plain version of K7, and the weight of the plain
    linear on CPU tensors."""
    d_in, d_out = _planar_dims(q, d_in, d_out)
    words = q["q4p"].reshape(d_in // 8, d_out)
    codes = torch.cat([(words >> (4 * i)) & 0xF for i in range(8)], dim=0)   # [d_in, d_out]
    vals = torch.from_numpy(NF4_CODE).to(words.device)[codes.long()]
    scale = q["scale"].reshape(d_in, d_out // BLOCK).float()
    vals = vals.reshape(d_in, d_out // BLOCK, BLOCK) * scale[..., None]
    return vals.reshape(d_in, d_out).to(dtype)


def _nf4_linear_planar_plain(x, q, d_in=None, d_out=None):
    """The arithmetic of K6 (the TPU kernel's "scale on x" variant): per
    64-column block c, ``bf16(f32(x) * scale[:, c]) @ bf16(code)`` with f32
    products and sums, one rounding to x's dtype."""
    d_in, d_out = _planar_dims(q, d_in, d_out)
    lead = x.shape[:-1]
    xf = x.reshape(-1, d_in).float()
    words = q["q4p"].reshape(d_in // 8, d_out)
    codes = torch.cat([(words >> (4 * i)) & 0xF for i in range(8)], dim=0)
    table = torch.from_numpy(NF4_CODE).to(words.device).to(torch.bfloat16).float()
    vals = table[codes.long()].reshape(d_in, d_out // BLOCK, BLOCK)          # [K, NB, 64]
    scale = q["scale"].reshape(d_in, d_out // BLOCK).float()
    xs = (xf[:, :, None] * scale[None]).to(torch.bfloat16).float()           # [M, K, NB]
    y = torch.einsum("mkc,kcn->mcn", xs, vals)
    return y.reshape(*lead, d_out).to(x.dtype)


def _check_planar_cuda(name, q, device):
    words, scale = q["q4p"], q["scale"]
    if words.dim() != 2 or scale.dim() != 2:
        raise ValueError(f"{name}: takes one [K/8, N] matrix, got q4p {tuple(words.shape)}")
    K, N = 8 * words.shape[0], words.shape[1]
    if N % BLOCK:
        raise ValueError(f"{name}: the kernel needs N % {BLOCK} == 0 (N={N})")
    if words.dtype != torch.int32 or not words.is_contiguous() or words.data_ptr() % 16:
        raise ValueError(f"{name}: q4p must be a contiguous, 16-byte aligned int32 [K/8, N]")
    if (scale.dtype != torch.float32 or tuple(scale.shape) != (K, N // BLOCK)
            or not scale.is_contiguous()):
        raise ValueError(f"{name}: scale must be a contiguous f32 [{K}, {N // BLOCK}]")
    if words.device != device or scale.device != device:
        raise ValueError(f"{name}: weight and activation on different devices")
    return K, N


def nf4_linear_planar(x: torch.Tensor, q: dict, d_in=None, d_out=None) -> torch.Tensor:
    """Fused planar dequant-matmul ``x [..., K] @ dequant(q)`` (K6): the
    weight stays 4-bit in device memory."""
    _planar_dims(q, d_in, d_out)
    if x.device.type == "cpu":
        return _nf4_linear_planar_plain(x, q)
    if x.device.type != "cuda":
        raise ValueError(f"nf4_linear_planar: unsupported device {x.device}")
    return _nf4_linear_planar_cuda(x, q)


nf4_linear_planar.launches = 0


# the fused kernels' tiling (csrc/nf4_gemv_sm90.cu): k values per ring stage,
# token tiles (the wgmma N side; K3 also 128 and 256 at prefill M), 64-column
# blocks per CTA (one consumer warpgroup each; for K6 / K11 a CTA of 4
# measured faster than more CTAs of 1 or 2; for K3 2 measured at least as
# fast as 4 at the 7B shapes and decode M, and 2 is the most beside a 256-token
# accumulator) and the most splits along K
_GEMV_KSTAGE = 64
_GEMV_TOKENS = (16, 32, 64)
_INT8_TOKENS = (16, 32, 64, 128, 256)
_GEMV_WIDTHS = (4, 2, 1)
_INT8_WIDTHS = (2, 1)
_GEMV_MAX_SPLITS = 8


def _gemv_plan(M, K, N, sms, tokens, widths):
    nt = next((t for t in tokens if M <= t), tokens[-1])
    ntok = -(-M // nt)
    nb, n_kst = -(-N // BLOCK), -(-K // _GEMV_KSTAGE)
    g = next(g for g in widths if g <= nb)
    ncol = -(-nb // g)
    splits = max(1, min(_GEMV_MAX_SPLITS, n_kst, sms // (ncol * ntok)))
    kst = [r * n_kst // splits for r in range(splits + 1)]
    k_ranges = tuple((a * _GEMV_KSTAGE, min(b * _GEMV_KSTAGE, K)) for a, b in zip(kst, kst[1:]))
    return dict(nt=nt, g=g, splits=splits, ntok=ntok, ncol=ncol, n_kst=n_kst, k_ranges=k_ranges,
                grid=(splits, ncol, ntok), ctas=splits * ncol * ntok,
                workspace=splits * ncol * ntok * 64 * g * nt if splits > 1 else 0)


@functools.lru_cache(maxsize=None)
def nf4_gemv_plan(M: int, K: int, N: int, sms: int) -> dict:
    """The launch of K6 / K11 for ``x [M, K] @ w [K, N]`` on a card of ``sms``
    SMs, as a pure function: token tile ``nt`` (M above 64 takes several),
    64-column blocks per CTA ``g`` (the widest that N has), splits along K
    (split ``r`` takes the ring stages ``[r * n_kst // splits, (r + 1) *
    n_kst // splits)`` of ``n_kst`` stages of 64 k, as the kernel computes
    them: ``k_ranges``), the most that keep the grid ``(splits, ncol, ntok)``
    within one wave (one CTA per SM), and the split-K workspace in floats."""
    if M < 1 or K < 8 or K % 8 or N < BLOCK or N % BLOCK or sms < 1:
        raise ValueError(f"nf4_gemv_plan: no plan for M={M} K={K} N={N} on {sms} SMs "
                         f"(M >= 1, K % 8 == 0, N % {BLOCK} == 0)")
    return _gemv_plan(M, K, N, sms, _GEMV_TOKENS, _GEMV_WIDTHS)


@functools.lru_cache(maxsize=None)
def int8_gemv_plan(M: int, K: int, N: int, sms: int) -> dict:
    """The launch of K3 (the int8 instantiation of the same template), as
    ``nf4_gemv_plan`` but with token tiles up to 256 (a prefill M takes
    tiles of 256 and, with the grid past one wave, no split: no workspace),
    at most 2 blocks per CTA, and any N % 16 == 0 (``ceil(N / 64)`` column
    blocks, the last one ragged)."""
    if M < 1 or K < 8 or K % 8 or N < 16 or N % 16 or sms < 1:
        raise ValueError(f"int8_gemv_plan: no plan for M={M} K={K} N={N} on {sms} SMs "
                         f"(M >= 1, K % 8 == 0, N % 16 == 0)")
    return _gemv_plan(M, K, N, sms, _INT8_TOKENS, _INT8_WIDTHS)


_P32_WIDTHS = (1, 2, 4)


@functools.lru_cache(maxsize=None)
def p32_gemv_plan(M: int, K: int, N: int, sms: int) -> dict:
    """The launch of K14 (the matmul probe's int8 weights packed four to an
    int32 word, ``[K/4, N]``: the fourth format of the same template) as a
    pure function.  A ring stage is 64 word rows (256 k); ``kq_ranges`` are
    the word rows of each split (word row kk holds k = j * K/4 + kk, j = 0..3).
    The narrowest of 1, 2 and 4 blocks per CTA whose grid fits one wave
    before any split (else 4), then splits only to fill the wave, as the
    other formats: at M = 1-64 over [4096, 11008] 2 blocks a CTA and no
    split, 86 CTAs, which measured faster on an H100 than 4 blocks in 3
    splits (129 CTAs) or 1 block in two waves.  Any N % 4 == 0 (the last
    column block ragged), K % 8 == 0."""
    if M < 1 or K < 8 or K % 8 or N < 4 or N % 4 or sms < 1:
        raise ValueError(f"p32_gemv_plan: no plan for M={M} K={K} N={N} on {sms} SMs "
                         f"(M >= 1, K % 8 == 0, N % 4 == 0)")
    nb, ntok = -(-N // BLOCK), -(-M // next((t for t in _GEMV_TOKENS if M <= t), _GEMV_TOKENS[-1]))
    widths = [g for g in _P32_WIDTHS if g <= nb]
    g = next((g for g in widths if -(-nb // g) * ntok <= sms), widths[-1])
    plan = dict(_gemv_plan(M, K // 4, N, sms, _GEMV_TOKENS, (g,)))
    plan["kq_ranges"] = plan.pop("k_ranges")
    return plan


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# per device: the split-K tile counters of the fused kernels (two per tile)
# and the stream they were made for; zero between launches (the kernel's
# last split of a tile resets them), so every launch that uses them runs in
# order on that one stream
_GEMV_COUNTERS: dict = {}


def _gemv_scratch(plan: dict, device):
    """(workspace f32, counters int32) for one launch of K6 / K11 / K3 / K14.
    A split launch on another stream than the counters' raises: two streams
    at once would share them."""
    if plan["splits"] == 1:
        return None, None
    n = 2 * plan["ncol"] * plan["ntok"]
    stream = torch.cuda.current_stream(device).cuda_stream
    ctr, owner = _GEMV_COUNTERS.get(device, (None, stream))
    if owner != stream:
        raise RuntimeError(f"split-K launch on stream {stream:#x}: the tile counters of "
                           f"{device} belong to stream {owner:#x}, and launches that share "
                           "them must run in order on one stream")
    if ctr is None or ctr.numel() < n:
        ctr = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _GEMV_COUNTERS[device] = (ctr, stream)
    return torch.empty(plan["workspace"], dtype=torch.float32, device=device), ctr


def _nf4_linear_planar_cuda(x, q):
    K, N = _check_planar_cuda("nf4_linear_planar", q, x.device)
    if x.dtype != torch.bfloat16 or x.shape[-1] != K:
        raise ValueError(f"nf4_linear_planar: x must be bf16 [..., {K}], got "
                         f"{x.dtype} {tuple(x.shape)}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    if M < 1:
        raise ValueError("nf4_linear_planar: x has no rows")
    # the kernel reads x's planes through a map whose plane stride must be a
    # multiple of 16 bytes: where K/8 is not a multiple of 8, pad each plane
    xp = -(-(K // 8) // 8) * 8
    if xp != K // 8:
        x2 = torch.nn.functional.pad(x2.reshape(M, 8, K // 8), (0, xp - K // 8)).reshape(M, 8 * xp)
    elif x2.data_ptr() % 16:
        x2 = x2.clone()
    plan = nf4_gemv_plan(M, K, N, _sm_count(x.device))
    ws, ctr = _gemv_scratch(plan, x.device)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    lib = _build.lib()
    err = lib.cullavo_nf4_gemv_planar(
        x2.data_ptr(), q["q4p"].data_ptr(), q["scale"].data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), None if ctr is None else ctr.data_ptr(), M, K, N,
        xp, plan["nt"], plan["g"], plan["splits"], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "nf4_linear_planar")
    nf4_linear_planar.launches += 1
    return out.reshape(*lead, N)


def nf4_dequant_planar(q: dict, d_in=None, d_out=None, dtype=torch.bfloat16) -> torch.Tensor:
    """Planar NF4 -> dense [d_in, d_out] in one pass (K7), bit-equal to
    ``dequant_linear_planar``."""
    _planar_dims(q, d_in, d_out)
    device = q["q4p"].device
    if device.type == "cpu":
        return dequant_linear_planar(q, dtype=dtype)
    if device.type != "cuda":
        raise ValueError(f"nf4_dequant_planar: unsupported device {device}")
    if dtype != torch.bfloat16:
        raise ValueError(f"nf4_dequant_planar: the kernel writes bf16, not {dtype}")
    K, N = _check_planar_cuda("nf4_dequant_planar", q, device)
    out = torch.empty((K, N), dtype=torch.bfloat16, device=device)
    lib = _build.lib()
    err = lib.cullavo_nf4_dequant_planar(
        q["q4p"].data_ptr(), q["scale"].data_ptr(), out.data_ptr(), K, N,
        torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, "nf4_dequant_planar")
    nf4_dequant_planar.launches += 1
    return out


nf4_dequant_planar.launches = 0


def nf4_linear_planar_auto(x: torch.Tensor, q: dict, d_in=None, d_out=None) -> torch.Tensor:
    """Fused kernel at small M, dequant once + a dense bf16 matmul at
    prefill-sized M (the fused kernel would spend its time decoding)."""
    if _rows(x) >= _NF4_DEQ_M_THRESHOLD:
        w = nf4_dequant_planar(q, d_in, d_out, torch.bfloat16)
        return (x.to(torch.bfloat16) @ w).to(x.dtype)
    return nf4_linear_planar(x, q, d_in, d_out)


class _Nf4LinearPlanar(torch.autograd.Function):
    """``nf4_linear_planar_auto`` with a gradient for x only: the packed
    base is frozen (Q-LoRA), so the codes and scales get none."""

    @staticmethod
    def forward(ctx, x, words, scale):
        ctx.save_for_backward(words, scale)
        return nf4_linear_planar_auto(x, {"q4p": words, "scale": scale})

    @staticmethod
    def backward(ctx, dy):
        words, scale = ctx.saved_tensors
        w = nf4_dequant_planar({"q4p": words, "scale": scale}, dtype=torch.bfloat16)
        dx = dy.to(torch.bfloat16) @ w.T
        return dx.to(dy.dtype), None, None


def nf4_linear_planar_vjp(x: torch.Tensor, q: dict, d_in=None, d_out=None) -> torch.Tensor:
    """Differentiable ``x @ dequant(q)`` over a frozen planar NF4 weight:
    forward ``nf4_linear_planar_auto`` (K6 below M = 512, K7 + a dense bf16
    matmul above), backward ``dx = dy.bf16 @ K7(q).T``; no gradient for the
    weight.  The backward saves only the 4-bit words and scales, never the
    dense weight.  On CPU tensors: a dense matmul against the dequantized
    weight in x's dtype, differentiated by autograd (the JAX package's own
    branch off the TPU)."""
    _planar_dims(q, d_in, d_out)
    if x.device.type == "cpu":
        return x @ dequant_linear_planar(q, dtype=x.dtype)
    return _Nf4LinearPlanar.apply(x, q["q4p"], q["scale"])


# ---------------------------------------------------------------------------
# byte-packed NF4: quantize_linear dicts ("q4") and NF4Tensor
# ---------------------------------------------------------------------------

ABSMAX_BLOCK = 256  # absmax values per double-quant block


def _create_dynamic_map(signed: bool = True, max_exponent_bits: int = 7,
                        total_bits: int = 8) -> np.ndarray:
    """bitsandbytes' dynamic 8-bit map (sorted, 256 entries): the port's copy
    of ``create_dynamic_map`` in ``cullavo_tpu/ops/nf4_oracle.py``, which the
    JAX quantizer's double quantization uses."""
    data = []
    non_sign_bits = total_bits - 1
    additional_items = 2 ** (non_sign_bits - max_exponent_bits) - 1
    for i in range(max_exponent_bits):
        fraction_items = int(
            2 ** (i + non_sign_bits - max_exponent_bits) + 1 if signed
            else 2 ** (i + non_sign_bits - max_exponent_bits + 1) + 1)
        boundaries = np.linspace(0.1, 1, fraction_items)
        means = (boundaries[:-1] + boundaries[1:]) / 2.0
        data += ((10 ** (-(max_exponent_bits - 1) + i)) * means).tolist()
        if signed:
            data += (-(10 ** (-(max_exponent_bits - 1) + i)) * means).tolist()
    if additional_items > 0:
        boundaries = np.linspace(0.1, 1, additional_items + 1)
        means = (boundaries[:-1] + boundaries[1:]) / 2.0
        data += ((10 ** (-(max_exponent_bits - 1) + max_exponent_bits - 1))
                 * means).tolist()
        if signed:
            data += (-(10 ** (-(max_exponent_bits - 1) + max_exponent_bits - 1))
                     * means).tolist()
    data.append(0)
    data.append(1.0)
    if len(data) != 2 ** total_bits:
        raise ValueError(f"dynamic map has {len(data)} entries, not {2 ** total_bits}")
    data.sort()
    return np.asarray(data, dtype=np.float32)


DYNAMIC_MAP = _create_dynamic_map(signed=True)
DYNAMIC_MIDPOINTS = (DYNAMIC_MAP[1:] + DYNAMIC_MAP[:-1]) / 2.0


@dataclasses.dataclass
class NF4Tensor:
    """Packed NF4 representation of a 2-D array (flattened blockwise)."""
    packed: torch.Tensor          # uint8 [n/2]: two 4-bit codes per byte (high nibble first)
    absmax: torch.Tensor          # f32 [n/BLOCK], or uint8 dynamic-map codes when
                                  # double-quantized
    shape: tuple                  # original shape
    dtype: torch.dtype            # original dtype
    absmax_scale: Optional[torch.Tensor] = None   # f32 per-256-block absmax
    absmax_offset: Optional[torch.Tensor] = None  # f32 scalar (mean of absmax)


def _codes_by_midpoints(normed: torch.Tensor, midpoints: np.ndarray, dtype) -> torch.Tensor:
    """Nearest codebook entry by strict comparisons against the midpoints
    (bitsandbytes' rule: a value on a midpoint takes the lower code), each
    midpoint an f32 constant, as the JAX quantizer compares them."""
    codes = torch.zeros(normed.shape, dtype=dtype, device=normed.device)
    for m in midpoints.tolist():
        codes += normed > m
    return codes


def _encode_blockwise(x_flat: torch.Tensor):
    """f32 [n] -> (uint8 codes [n], f32 absmax [n/BLOCK])."""
    n = x_flat.shape[0]
    if n % BLOCK:
        raise ValueError(f"size {n} is not a multiple of the NF4 block {BLOCK}")
    blocks = x_flat.reshape(-1, BLOCK)
    absmax = blocks.abs().amax(dim=1)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    normed = _div(blocks, scale[:, None].expand_as(blocks))
    return _codes_by_midpoints(normed, NF4_MIDPOINTS, torch.uint8).reshape(-1), absmax


def _pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    return (codes[0::2] << 4) | codes[1::2]


def _unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [..., n/2] -> int64 codes [..., n], high nibble first."""
    return torch.stack([(packed >> 4).long(), (packed & 0xF).long()], dim=-1).flatten(-2)


def quantize_nf4(x: torch.Tensor, double_quant: bool = True) -> NF4Tensor:
    """Blockwise NF4 of any array (bitsandbytes' quantize_4bit, nf4), with
    the absmax double-quantized by default: the mean of the absmax array is
    the offset, the centred absmax goes through the dynamic 8-bit map in
    blocks of 256 with an f32 scale per block.  Codes bit-equal to the JAX
    quantizer's; the offset is an f32 mean whose summation order may differ
    from XLA's by an ulp."""
    shape, dtype = tuple(x.shape), x.dtype
    codes, absmax = _encode_blockwise(x.float().reshape(-1))
    packed = _pack_nibbles(codes)
    if not double_quant:
        return NF4Tensor(packed, absmax, shape, dtype)
    offset = absmax.mean()
    q, ab_scale = _quantize_absmax(absmax, offset)
    return NF4Tensor(packed, q, shape, dtype, absmax_scale=ab_scale, absmax_offset=offset)


def _quantize_absmax(absmax: torch.Tensor, offset: torch.Tensor):
    """Double quantization of the f32 absmax array around ``offset``: uint8
    dynamic-map codes [m] and the f32 scale of each 256-block."""
    m = absmax.shape[0]
    pad = (-m) % ABSMAX_BLOCK
    ab = torch.nn.functional.pad(absmax - offset, (0, pad)).reshape(-1, ABSMAX_BLOCK)
    ab_absmax = ab.abs().amax(dim=1)
    ab_scale = torch.where(ab_absmax == 0, torch.ones_like(ab_absmax), ab_absmax)
    normed = _div(ab, ab_scale[:, None].expand_as(ab))
    q = _codes_by_midpoints(normed, DYNAMIC_MIDPOINTS, torch.int32)
    return q.reshape(-1)[:m].to(torch.uint8), ab_scale


def _decode_absmax(t: NF4Tensor) -> torch.Tensor:
    """The f32 per-block absmax of an NF4Tensor (double quantization undone)."""
    if t.absmax_scale is None:
        return t.absmax.float()
    m = t.absmax.shape[0]
    pad = (-m) % ABSMAX_BLOCK
    idx = torch.nn.functional.pad(t.absmax.long(), (0, pad)).reshape(-1, ABSMAX_BLOCK)
    dyn = torch.from_numpy(DYNAMIC_MAP).to(t.absmax.device)
    ab = dyn[idx] * t.absmax_scale[:, None]
    return ab.reshape(-1)[:m] + t.absmax_offset


def dequantize_nf4(t: NF4Tensor, dtype=None) -> torch.Tensor:
    """Packed NF4 -> dense array of the original shape: ``code_f32 *
    absmax_f32`` rounded once to ``dtype`` (the original dtype by default)."""
    code = torch.from_numpy(NF4_CODE).to(t.packed.device)
    vals = code[_unpack_nibbles(t.packed)]
    vals = vals.reshape(-1, BLOCK) * _decode_absmax(t)[:, None]
    return vals.reshape(t.shape).to(dtype or t.dtype)


def nf4_matmul(x: torch.Tensor, w: NF4Tensor, dtype=None) -> torch.Tensor:
    """x @ dequant(w): the JAX package's XLA form."""
    return x @ dequantize_nf4(w, dtype or x.dtype)


def quantize_linear(w: torch.Tensor) -> dict:
    """[..., d_in, d_out] -> {"q4": uint8 [..., d_in*d_out/2], "scale": f32
    [..., d_in*d_out/BLOCK]}: each matrix flattened row-major and encoded in
    blocks of 64 (any shape whose size is a multiple of 64), codes and
    scales bit-equal to the JAX quantizer's.  One leading matrix at a time,
    so the f32 temporaries stay one matrix large."""
    *lead, d_in, d_out = w.shape
    n = d_in * d_out
    mats = w.reshape(-1, n)
    packed = torch.empty((mats.shape[0], n // 2), dtype=torch.uint8, device=w.device)
    scale = torch.empty((mats.shape[0], n // BLOCK), dtype=torch.float32, device=w.device)
    for l in range(mats.shape[0]):
        codes, absmax = _encode_blockwise(mats[l].float())
        packed[l] = _pack_nibbles(codes)
        scale[l] = absmax
    return {"q4": packed.reshape(*lead, n // 2), "scale": scale.reshape(*lead, n // BLOCK)}


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q4" in w


def _q4_dims(q: dict, d_in: int, d_out=None):
    """(d_in, d_out) of one layer's q4 dict; d_out from the leaf sizes."""
    n2 = q["q4"].numel()
    if d_out is None:
        d_out = 2 * n2 // d_in
    if d_in * d_out != 2 * n2 or q["scale"].numel() * BLOCK != 2 * n2:
        raise ValueError(f"q4 dict of {2 * n2} values is not [{d_in}, {d_out}]")
    return d_in, d_out


def dequant_linear(q: dict, d_in: int, d_out: int, dtype=torch.bfloat16) -> torch.Tensor:
    """One layer's q4 dict -> dense [d_in, d_out]: ``code_f32 * scale_f32``
    rounded once to ``dtype``.  The plain version of K11's dequant entry."""
    _q4_dims(q, d_in, d_out)
    code = torch.from_numpy(NF4_CODE).to(q["q4"].device)
    vals = code[_unpack_nibbles(q["q4"].reshape(-1))]
    vals = vals.reshape(-1, BLOCK) * q["scale"].reshape(-1)[:, None].float()
    return vals.reshape(d_in, d_out).to(dtype)


def nf4_linear(x: torch.Tensor, q: dict, d_in: int, d_out: int) -> torch.Tensor:
    """x @ dequant(q) in x's dtype: the JAX package's XLA form."""
    return x @ dequant_linear(q, d_in, d_out, x.dtype)


def _nf4_linear_q4_plain(x, q, d_in, d_out):
    """The arithmetic of the TPU kernel (row 9): the f32 dequantized weight,
    an f32 product, one rounding to x's dtype."""
    w = dequant_linear(q, d_in, d_out, torch.float32)
    y = x.reshape(-1, d_in).float() @ w
    return y.reshape(*x.shape[:-1], d_out).to(x.dtype)


def _check_q4_cuda(name, q4, scale, K, N, device):
    """q4 as uint8 [K, N/2] (a flat leaf viewed 2-D), scale f32 [K, N/64]."""
    if K % 8 or N % BLOCK:
        raise ValueError(f"{name}: the kernel needs K % 8 == 0 and N % {BLOCK} == 0 "
                         f"(K={K}, N={N}): one absmax per row and 64-column block")
    if q4.dtype != torch.uint8 or not q4.is_contiguous() or q4.data_ptr() % 16:
        raise ValueError(f"{name}: q4 must be a contiguous, 16-byte aligned uint8 leaf")
    if scale.dtype != torch.float32 or not scale.is_contiguous():
        raise ValueError(f"{name}: scale must be a contiguous f32 leaf")
    if q4.numel() * 2 != K * N or scale.numel() * BLOCK != K * N:
        raise ValueError(f"{name}: q4/scale hold {q4.numel() * 2} / {scale.numel() * BLOCK} "
                         f"values, not [{K}, {N}]")
    if q4.device != device or scale.device != device:
        raise ValueError(f"{name}: weight and activation on different devices")


def _nf4_q4_cuda(name, x, q4, scale, K, N):
    """K11 on CUDA tensors: bf16 x [..., K] @ deq(q4 [K, N/2], scale [K, N/64])."""
    _check_q4_cuda(name, q4, scale, K, N, x.device)
    if x.dtype != torch.bfloat16 or x.shape[-1] != K:
        raise ValueError(f"{name}: x must be bf16 [..., {K}], got {x.dtype} {tuple(x.shape)}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    M = x2.shape[0]
    if M < 1:
        raise ValueError(f"{name}: x has no rows")
    plan = nf4_gemv_plan(M, K, N, _sm_count(x.device))
    ws, ctr = _gemv_scratch(plan, x.device)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    lib = _build.lib()
    err = lib.cullavo_nf4_gemv_q4(
        x2.data_ptr(), q4.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), None if ctr is None else ctr.data_ptr(), M, K, N,
        plan["nt"], plan["g"], plan["splits"], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, name)
    nf4_linear_q4.launches += 1
    return out.reshape(*lead, N)


def nf4_linear_q4(x: torch.Tensor, q: dict, d_in: int, d_out=None) -> torch.Tensor:
    """Fused byte-packed dequant-matmul ``x [..., d_in] @ dequant(q)`` (K11,
    Pallas row 9, ``nf4_linear_pallas``): the weight stays 4-bit in device
    memory.  One layer's q4 dict."""
    d_in, d_out = _q4_dims(q, d_in, d_out)
    if x.device.type == "cpu":
        return _nf4_linear_q4_plain(x, q, d_in, d_out)
    if x.device.type != "cuda":
        raise ValueError(f"nf4_linear_q4: unsupported device {x.device}")
    return _nf4_q4_cuda("nf4_linear_q4", x, q["q4"], q["scale"], d_in, d_out)


nf4_linear_q4.launches = 0


def nf4_dequant_q4(q: dict, d_in: int, d_out=None, dtype=torch.bfloat16) -> torch.Tensor:
    """One layer's q4 dict -> dense bf16 [d_in, d_out] in one pass (K11's
    dequant entry), bit-equal to ``dequant_linear``."""
    d_in, d_out = _q4_dims(q, d_in, d_out)
    device = q["q4"].device
    if device.type == "cpu":
        return dequant_linear(q, d_in, d_out, dtype)
    if device.type != "cuda":
        raise ValueError(f"nf4_dequant_q4: unsupported device {device}")
    if dtype != torch.bfloat16:
        raise ValueError(f"nf4_dequant_q4: the kernel writes bf16, not {dtype}")
    _check_q4_cuda("nf4_dequant_q4", q["q4"], q["scale"], d_in, d_out, device)
    out = torch.empty((d_in, d_out), dtype=torch.bfloat16, device=device)
    lib = _build.lib()
    err = lib.cullavo_nf4_dequant_q4(
        q["q4"].data_ptr(), q["scale"].data_ptr(), out.data_ptr(), d_in, d_out,
        torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, "nf4_dequant_q4")
    nf4_dequant_q4.launches += 1
    return out


nf4_dequant_q4.launches = 0


def nf4_linear_q4_auto(x: torch.Tensor, q: dict, d_in: int, d_out=None) -> torch.Tensor:
    """K11 fused below M = 512; at prefill-sized M, K11's dequant entry once
    and a dense bf16 matmul (JAX leaves the q4 product to XLA's dequant +
    dot)."""
    if _rows(x) >= _NF4_DEQ_M_THRESHOLD:
        w = nf4_dequant_q4(q, d_in, d_out, torch.bfloat16)
        return (x.to(torch.bfloat16) @ w).to(x.dtype)
    return nf4_linear_q4(x, q, d_in, d_out)


def nf4_matmul_fused(x: torch.Tensor, w: NF4Tensor) -> torch.Tensor:
    """``x [M, K] @ dequantize_nf4(w)`` for a 2-D NF4Tensor (Pallas row 8):
    the absmax is decoded first (``_decode_absmax``, outside the TPU kernel
    too); its packed bytes are the row-major [K, N/2] layout of a q4 dict,
    so on CUDA tensors it is K11 fed the decoded absmax as its [K, N/64]
    scale.  On CPU tensors: the f32 dequantized weight, an f32 product, one
    rounding to x's dtype (the TPU kernel's arithmetic)."""
    K, N = w.shape
    if x.dim() != 2 or x.shape[1] != K:
        raise ValueError(f"nf4_matmul_fused: x must be [M, {K}], got {tuple(x.shape)}")
    if N % BLOCK:
        raise ValueError(f"nf4_matmul_fused: N={N} must be a multiple of the NF4 block {BLOCK}")
    absmax = _decode_absmax(w)
    if x.device.type == "cpu":
        y = x.float() @ dequantize_nf4(w, torch.float32)
        return y.to(x.dtype)
    if x.device.type != "cuda":
        raise ValueError(f"nf4_matmul_fused: unsupported device {x.device}")
    return _nf4_q4_cuda("nf4_matmul_fused", x, w.packed, absmax, K, N)


class _Nf4LinearQ4(torch.autograd.Function):
    """``nf4_linear_q4_auto`` with a gradient for x only (the packed base is
    frozen): backward ``dx = dy @ dequant(q).T``, as JAX's ``_nf4f_bwd``."""

    @staticmethod
    def forward(ctx, x, q4, scale, d_in, d_out):
        ctx.save_for_backward(q4, scale)
        ctx.dims = (d_in, d_out)
        return nf4_linear_q4_auto(x, {"q4": q4, "scale": scale}, d_in, d_out)

    @staticmethod
    def backward(ctx, dy):
        q4, scale = ctx.saved_tensors
        w = nf4_dequant_q4({"q4": q4, "scale": scale}, *ctx.dims, dtype=torch.bfloat16)
        dx = dy.to(torch.bfloat16) @ w.T
        return dx.to(dy.dtype), None, None, None, None


def nf4_linear_fused_vjp(x: torch.Tensor, q: dict, d_in: int, d_out=None) -> torch.Tensor:
    """Differentiable ``x @ dequant(q)`` over a frozen q4 weight.  CUDA
    tensors: K11 (fused below M = 512, dequant entry + a dense bf16 matmul
    above), backward ``dx = dy.bf16 @ K11-dequant(q).T``, saving only the
    4-bit bytes and scales.  CPU tensors: the JAX package's own branch for
    q4 dicts (``nf4_linear``: dequant in x's dtype, then the product),
    differentiated by autograd."""
    d_in, d_out = _q4_dims(q, d_in, d_out)
    if x.device.type == "cpu":
        return nf4_linear(x, q, d_in, d_out)
    return _Nf4LinearQ4.apply(x, q["q4"], q["scale"], d_in, d_out)
