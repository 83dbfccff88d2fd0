"""Decode-shaped matmul probe: where does the int8 per-token time go?
(counterpart of ``scripts/matmul_probe.py``)

    python -m cullavo_tpu_torch.scripts.matmul_probe [--device cpu]

Times the product [M, 4096] @ [4096, 11008] (one 7B MLP shape) over L
DISTINCT stacked weights, so that no weight stays in the card's 50 MB L2
cache (one int8 weight is 45.1 MB), with CUDA events around R passes over
the L layers (wall clock on the CPU) after one warm-up pass.  Variants, by
the JAX script's names:

  conv          int8 weights, scale after the dot: K3 (``ops/nf4.int8_linear``)
                with unit smooth scales
  conv_pre      int8 weights with the scale folded in before the dot (plain torch)
  conv_t        int8 weights stored transposed [N, K] (plain torch)
  s8s8          per-row int8 activations x int8 weights, int32 sums
                (``torch._int_mm`` on the card, as the port's int8 path; the
                weight is stored column-major once, and x padded to the 17
                rows the library call needs)
  conv_p32_xla  int8 weights packed four to an int32 word, the plain version
                (``p32_linear_plain``)                 [with p32]
  p32_pallas    the same through K14 (``p32_linear``: the packed format of
                the fused template, ``csrc/nf4_gemv_sm90.cu``)   [with p32]
  bf16          dense bf16 weights (the int8 values times their scale)

Every variant computes the same function and is held to the first (conv)
on layer 0: a largest difference above 2e-2 of the largest output raises.
Prints one JSON line per variant (``variant``, ``ms_per_dot``, ``gb_per_s``
over the weight bytes, ``M``, ``layers``).

Env: PROBE_M (default 8), PROBE_L (default 24 layers), PROBE_P32 (any
value: add the two p32 variants).
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from cullavo_tpu_torch import _build
from cullavo_tpu_torch.ops import nf4

K, N = 4096, 11008
REPS = 10
PARITY_TOL = 2e-2
_INT_MM_MIN_M = 17      # torch._int_mm wants more than 16 rows


def pack_p32(w8: torch.Tensor) -> torch.Tensor:
    """int8 [..., K, N] -> int32 [..., K/4, N]: byte j of word (k, n) is
    W[j * K/4 + k, n] (the JAX script's packing)."""
    kq = w8.shape[-2] // 4
    b = w8.to(torch.int32) & 0xFF
    return (b[..., 0 * kq:1 * kq, :] | (b[..., 1 * kq:2 * kq, :] << 8)
            | (b[..., 2 * kq:3 * kq, :] << 16) | (b[..., 3 * kq:4 * kq, :] << 24))


def p32_linear_plain(x, w32, scale):
    """x [M, K] @ the packed int8 weight, f32 products and sums over the four
    K-quarters, times the f32 per-column scale, rounded to bf16 once."""
    kq = w32.shape[0]
    y = torch.zeros((x.shape[0], w32.shape[1]), dtype=torch.float32, device=x.device)
    for j in range(4):
        b = (w32 >> (8 * j)) & 0xFF
        wj = ((b ^ 0x80) - 0x80).float()
        y = y + x[:, j * kq:(j + 1) * kq].float() @ wj
    return (y * scale.reshape(1, -1).float()).to(torch.bfloat16)


def p32_linear(x, w32, scale):
    """K14 on CUDA tensors (counted on ``p32_linear.launches``), the plain
    version on CPU tensors: x bf16 [M, K], w32 int32 [K/4, N], scale f32 [N]
    -> bf16 [M, N]."""
    if x.device.type == "cpu":
        return p32_linear_plain(x, w32, scale)
    if x.device.type != "cuda":
        raise ValueError(f"p32_linear: unsupported device {x.device}")
    return _p32_cuda(x, w32, scale)


p32_linear.launches = 0


def _p32_cuda(x, w32, scale):
    M, Kx = x.shape
    kq, n = w32.shape
    if x.dtype != torch.bfloat16 or Kx != 4 * kq or w32.dtype != torch.int32 \
            or scale.dtype != torch.float32 or scale.numel() != n:
        raise ValueError(f"p32_linear: x must be bf16 [M, {4 * kq}], w32 int32 [K/4, N] and "
                         f"scale f32 [N]; got {x.dtype} {tuple(x.shape)}, {w32.dtype} "
                         f"{tuple(w32.shape)}, {scale.dtype} {tuple(scale.shape)}")
    for name, t in (("x", x), ("w32", w32), ("scale", scale)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"p32_linear: {name} must be contiguous, 16-byte aligned and on "
                             f"{x.device}")
    plan = nf4.p32_gemv_plan(M, Kx, n, nf4._sm_count(x.device))
    ws, ctr = nf4._gemv_scratch(plan, x.device)
    out = torch.empty((M, n), dtype=torch.bfloat16, device=x.device)
    err = _build.lib().cullavo_p32_linear(
        x.data_ptr(), w32.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), None if ctr is None else ctr.data_ptr(), M, Kx, n,
        plan["nt"], plan["g"], plan["splits"], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "p32_linear")
    p32_linear.launches += 1
    return out


def _s8s8(x, w_cm, s):
    """Per-row int8 activations (the JAX script's rounding) times the int8
    weight, int32 sums, the two scales after."""
    xf = x.float()
    cm = xf.abs().amax(dim=-1, keepdim=True)
    xi = torch.clamp(torch.round(xf / cm * 127), -127, 127).to(torch.int8)
    if x.device.type == "cpu":
        acc = torch.matmul(xi.to(torch.int32), w_cm.to(torch.int32))
    else:
        pad = max(0, _INT_MM_MIN_M - xi.shape[0])
        acc = torch._int_mm(torch.nn.functional.pad(xi, (0, 0, 0, pad)), w_cm)[:xi.shape[0]]
    return (acc.float() * (cm / 127.0) * s).to(torch.bfloat16)


def _time_ms(fn, device, reps):
    """ms of one ``fn()`` pass, averaged over ``reps`` passes after a warm-up:
    CUDA events on the card, the wall clock on the CPU."""
    fn()
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def main(M=None, L=None, p32=None, device=None) -> list:
    """Run every variant; returns their JSON rows.  On the card unless
    ``device`` names another (the CPU runs the plain versions)."""
    M = int(os.environ.get("PROBE_M", 8)) if M is None else M
    L = int(os.environ.get("PROBE_L", 24)) if L is None else L
    p32 = bool(os.environ.get("PROBE_P32")) if p32 is None else p32
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("matmul_probe: no CUDA device; pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    reps = REPS if device.type == "cuda" else 1
    g = torch.Generator(device=device).manual_seed(0)
    w8 = torch.randint(-127, 128, (L, K, N), generator=g, device=device, dtype=torch.int8)
    rng = np.random.default_rng(1)
    scale = torch.from_numpy(rng.random((L, 1, N), np.float32) * 0.01).to(device)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(device).to(
        torch.bfloat16)
    unit = torch.ones((1, K), dtype=torch.bfloat16, device=device)
    bytes_i8, bytes_bf16 = K * N, 2 * K * N

    variants = [
        ("conv", lambda l: nf4.int8_linear(x, {"q8": w8[l], "scale8": scale[l], "sq_inv": unit}),
         bytes_i8),
        ("conv_pre", lambda l: x @ (w8[l].to(torch.bfloat16) * scale[l].to(torch.bfloat16)),
         bytes_i8)]
    w8t = w8.transpose(1, 2).contiguous()                  # [L, N, K]
    variants.append(("conv_t", lambda l: (x @ w8t[l].to(torch.bfloat16).T)
                     * scale[l].to(torch.bfloat16), bytes_i8))
    w_cm = w8t.transpose(1, 2)                             # [L, K, N] column-major
    variants.append(("s8s8", lambda l: _s8s8(x, w_cm[l], scale[l]), bytes_i8))
    if p32:
        w32 = pack_p32(w8)                                 # [L, K/4, N]
        s_flat = scale.reshape(L, N).contiguous()
        variants.append(("conv_p32_xla", lambda l: p32_linear_plain(x, w32[l], s_flat[l]),
                         bytes_i8))
        variants.append(("p32_pallas", lambda l: p32_linear(x, w32[l], s_flat[l]), bytes_i8))
    wb = (w8.float() * scale).to(torch.bfloat16) if device.type == "cpu" else torch.stack(
        [(w8[l].float() * scale[l]).to(torch.bfloat16) for l in range(L)])
    variants.append(("bf16", lambda l: x @ wb[l], bytes_bf16))

    rows, ref = [], None
    with torch.no_grad():
        for name, dot, per_dot_bytes in variants:
            y = dot(0).float()
            if ref is None:
                ref = y
            err = ((y - ref).abs().max() / (ref.abs().max() + 1e-9)).item()
            if not err <= PARITY_TOL:
                raise RuntimeError(f"matmul_probe: {name} differs from conv by {err:.3e} of the "
                                   f"largest output (tol {PARITY_TOL})")
            ms = _time_ms(lambda: [dot(l) for l in range(L)], device, reps) / L
            row = {"variant": name, "ms_per_dot": round(ms, 4),
                   "gb_per_s": round(per_dot_bytes / ms / 1e6, 4), "M": M, "layers": L,
                   "parity_rel_err": err, "device": str(device)}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    argv = sys.argv[1:]
    main(device=argv[argv.index("--device") + 1] if "--device" in argv else None)
