"""The int8 half of ``cullavo_tpu/ops/nf4.py``: SmoothQuant W8A8 weights.

Weight dicts keep the JAX layout: ``{"q8": int8 [..., K, N], "scale8": f32
[..., 1, N], "sq_inv": bf16 [..., 1, K]}``.  Two kernels live here:

* K2 ``quantize_rows`` (``csrc/quant_rows.cu``): the per-token activation
  quantizer in front of every s8s8 prefill GEMM, bit-identical to the JAX
  chain (``_quant_inv_scale``).
* K3 ``int8_linear`` (``csrc/int8_matmul.cu``): ``x @ (q8 * scale8)`` with
  the weight kept int8 in device memory, the decode-M linear.

Each wrapper takes its plain PyTorch version for a tensor on the CPU and
launches its kernel (or raises) for a CUDA tensor.  The int8 x int8 ->
int32 product at prefill M is ``torch._int_mm`` (cuBLAS) on the card, as
JAX leaves it to XLA's ``dot_general``; on the CPU it is an exact int32
matmul.  Dict kinds outside this slice raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from cullavo_tpu_torch import _build

# M at or above this -> s8s8 (compute-bound prefill); below -> the
# weight-only stream (memory-bound decode).  The JAX default.
_S8S8_MIN_M = 1024

_NOT_IN_SLICE = {
    "q8t": "the transposed int8 layout ('q8t') waits for the NF4 slice",
    "o_w": "static LLM.int8 outlier dicts ('o_w') wait for slice 4 (calibration)",
    "sa": "static activation scales ('sa') wait for slice 4 (calibration)",
    "q4": "NF4 weights wait for the NF4 slice",
    "q4p": "NF4 weights wait for the NF4 slice",
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


def _int8_linear_splits(M: int, K: int, N: int, device) -> int:
    """K splits so that the (column block x row block x split) grid covers
    the SMs about twice (the kernel's 128-column, 16-row, 64-k tiles)."""
    blocks = -(-N // 128) * -(-M // 16)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-K // 64), -(-2 * sms // blocks)))


def _int8_linear_cuda(x, q):
    q8, scale8, sq_inv = q["q8"], q["scale8"], q.get("sq_inv")
    K, N = q8.shape[-2], q8.shape[-1]
    if x.dtype != torch.bfloat16 or x.shape[-1] != K:
        raise ValueError(f"int8_linear: x must be bf16 [..., {K}], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if q8.dtype != torch.int8 or q8.dim() != 2 or not q8.is_contiguous():
        raise ValueError("int8_linear: q8 must be a contiguous int8 [K, N] matrix")
    if N % 16 or K % 4 or q8.data_ptr() % 16:
        raise ValueError(f"int8_linear: the kernel needs N % 16 == 0, K % 4 == 0 "
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
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    splits = _int8_linear_splits(M, K, N, x.device)
    xs = torch.empty((-(-M // 16) * 16, K), dtype=torch.float32, device=x.device)
    partial = torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    lib = _build.lib()
    err = lib.cullavo_int8_linear(
        x2.data_ptr(), None if sq_inv is None else sq_inv.data_ptr(),
        q8.data_ptr(), scale8.data_ptr(), xs.data_ptr(), partial.data_ptr(),
        out.data_ptr(), M, K, N, splits, torch.cuda.current_stream(x.device).cuda_stream)
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


def _quantize_rows_cuda(x2, mult):
    if x2.dtype != torch.bfloat16 or x2.dim() != 2 or not x2.is_contiguous():
        raise ValueError("quantize_rows: x2 must be a contiguous bf16 [M, K]")
    M, K = x2.shape
    if K % 8 or K * 2 > 48 * 1024 or x2.data_ptr() % 16:
        raise ValueError(f"quantize_rows: the kernel needs K % 8 == 0, "
                         f"K <= 24576 and 16-byte alignment (K={K})")
    if mult is not None:
        if mult.numel() != K or mult.device != x2.device:
            raise ValueError("quantize_rows: mult must hold K values on x2's device")
        mult = mult.reshape(K).float().contiguous()
    xi = torch.empty((M, K), dtype=torch.int8, device=x2.device)
    sx = torch.empty((M, 1), dtype=torch.float32, device=x2.device)
    lib = _build.lib()
    err = lib.cullavo_quant_rows(
        x2.data_ptr(), None if mult is None else mult.data_ptr(),
        xi.data_ptr(), sx.data_ptr(), M, K,
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
