"""Prefill-shaped attention microbenchmark: plain attention against the
masked flash kernel (counterpart of ``scripts/attn_probe.py``).

    python -m cullavo_tpu_torch.scripts.attn_probe [--device cpu]

Shape of the 7B VQA prefill: [B, 32 heads, T = 648, 128] bf16 with a causal
mask on explicit positions and 7 right-padded keys, over L layers of
inputs.  The plain version (``llama.sdpa`` with an additive bias) writes the
[B, H, T, T] f32 scores and probabilities to device memory; the kernel
(``flash_attention`` with ``q_positions`` and ``kv_valid``, K8 on a CUDA
tensor) never does.  Each variant is timed with CUDA events over the L
layers (wall clock on the CPU) and must agree with the other.  Prints one
JSON line per variant.

Env: PROBE_B (default 6), PROBE_T (default 648), PROBE_L layers (default 8).
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from cullavo_tpu_torch.models.llava.llama import _attention_bias, sdpa
from cullavo_tpu_torch.ops.flash_attention import flash_attention


def _time_ms(fn, device, reps=4):
    """Median ms of ``fn`` over ``reps`` runs after one warm-up run."""
    fn()
    samples = []
    for _ in range(reps):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(device)
            samples.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            samples.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(samples))


def probe(device, B=None, T=None, L=None) -> list:
    """Run both variants on ``device``; returns their result rows."""
    B = int(os.environ.get("PROBE_B", 6)) if B is None else B
    T = int(os.environ.get("PROBE_T", 648)) if T is None else T
    L = int(os.environ.get("PROBE_L", 8)) if L is None else L
    H, hd = 32, 128
    device = torch.device(device)
    rng = np.random.default_rng(0)
    # heads as strided views of the [B, T, H, hd] projection layout
    qkv = [[torch.from_numpy(rng.standard_normal((B, T, H, hd)).astype(np.float32) * 0.1)
            .to(device).to(torch.bfloat16).transpose(1, 2) for _ in range(3)] for _ in range(L)]
    mask = torch.ones((B, T), dtype=torch.int32, device=device)
    mask[:, -7:] = 0                    # right padding (the 641-real-token prompt)
    positions = (torch.cumsum(mask, dim=1) - 1).clamp_min(0).to(torch.int32)
    # llama's own bias: causal on logical positions (key j sits at index j)
    bias = _attention_bias(mask, positions, torch.arange(T, device=device)[None, :])

    variants = (("sdpa", lambda q, k, v: sdpa(q, k, v, bias)),
                ("flash", lambda q, k, v: flash_attention(q, k, v, q_positions=positions,
                                                          kv_valid=mask, causal=True)))
    rows, outs = [], {}
    with torch.no_grad():
        for name, attn in variants:
            outs[name] = attn(*qkv[0]).float()
            ms = _time_ms(lambda: [attn(*layer) for layer in qkv], device) / L
            rows.append({"variant": name, "ms_per_layer": round(ms, 4), "B": B, "T": T,
                         "L": L, "device": str(device)})
    valid = mask.bool()[:, None, :, None]
    err = ((outs["flash"] - outs["sdpa"]) * valid).abs().max().item()
    if not err <= 2e-2:
        raise RuntimeError(f"attn_probe: flash and sdpa disagree on valid rows: {err}")
    for row in rows:
        row["max_abs_diff"] = err
        print(json.dumps(row), flush=True)
    return rows


def main(argv):
    if "--device" in argv:
        device = argv[argv.index("--device") + 1]
    elif torch.cuda.is_available():
        device = "cuda"
    else:
        raise SystemExit("attn_probe: no CUDA device; pass --device cpu to run on the CPU")
    probe(device)


if __name__ == "__main__":
    main(sys.argv[1:])
