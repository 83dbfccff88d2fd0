#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cullavo_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py             # kernels + 7B VQA batch
    python3 chip_smoke.py --profile   # the same + a profiled batch

Phases (each raises on failure, and the script exits non-zero):
  1. print the card's name and power limit (nvidia-smi); disable TF32.
  2. build the port's CUDA kernels from ``cullavo_tpu_torch/csrc``.
  3. compare each kernel with its plain PyTorch version on the card at the
     shapes of the LLaVA-1.5-7B int8 VQA path (K1 flash prefill, K2 row
     quantizer, K3 int8 weight-only linear; also the library s8s8 GEMM),
     and time both with CUDA events (L2 flushed before every launch).
  4. build random LLaVA-1.5-7B weights on the card from a seeded
     ``torch.Generator``: bf16 vision tower, projector, embeddings and head;
     int8 SmoothQuant LLM linears with smooth scales exp(N(0, 0.3)) shared
     per input group.
  5. check the kernel path against the plain path on a small input: the
     first two LLM layers at full width, prefill + one decode step, on the
     card and on the CPU.
  6. answer 14 VQA-shaped requests (641 real tokens right-padded to 648,
     576 image tokens, 336x336 pixels, 16 greedy tokens) through
     ``generate_prefill_chunked`` (chunk 7) + ``generate_decode``, twice;
     the tokens must be in the vocabulary and equal across the runs, and
     every kernel must have launched in the first run.
The last two lines are the kernels' JSON record and the result line.
Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCH, CHUNK, PROMPT_TEXT, PAD_TO, NEW_TOKENS = 14, 7, 64, 8, 16


def log(*a):
    print(*a, flush=True)


def bench_ms(fn, device, reps=20):
    """Median ms of ``fn`` over ``reps`` launches, CUDA events around each,
    with the 50 MB L2 flushed before every launch (the main path meets each
    weight cold)."""
    import torch

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(end))
    del flush
    return statistics.median(times)


def check_kernels(device):
    """Phase 3: kernel vs plain version at main-path shapes."""
    import torch

    from cullavo_tpu_torch.ops import flash_attention as fa
    from cullavo_tpu_torch.ops import nf4

    g = torch.Generator(device=device).manual_seed(SEED + 1)
    bf = torch.bfloat16
    rec = {}

    # K1: causal flash prefill, heads as strided views of [B, T, H, d]
    H, T, d = 32, PAD_TO * -(-(1 + 576 + PROMPT_TEXT) // PAD_TO), 128
    for B in (2, CHUNK):
        q, k, v = (torch.randn((B, T, H, d), generator=g, device=device).to(bf).transpose(1, 2)
                   for _ in range(3))
        out = fa.flash_attention(q, k, v)
        ref = fa.mha_reference(q, k, v)
        torch.cuda.synchronize(device)
        err = (out.float() - ref.float()).abs().max().item()
        log(f"K1 flash_fwd B={B} H={H} T={T} d={d}: max_abs_err={err:.3e} "
            f"(tol |d| <= 1e-2 + 1e-2 |ref|: bf16 rounding of P and O)")
        if not torch.allclose(out.float(), ref.float(), rtol=1e-2, atol=1e-2):
            raise RuntimeError(f"K1 disagrees with mha_reference: {err}")
    ms = bench_ms(lambda: fa.flash_attention(q, k, v), device)
    plain = bench_ms(lambda: fa.mha_reference(q, k, v), device)
    log(f"K1 B={CHUNK}: kernel {ms:.4f} ms, plain {plain:.4f} ms")
    rec["flash_fwd"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                            shape=f"q/k/v [{CHUNK},{H},{T},{d}] bf16 causal")

    # K2: per-row quantizer, bit-equal codes; timed at the main-path M
    k2_err = 0.0
    for M, K in ((1296, 4096), (1296, 11008), (CHUNK * T, 4096), (CHUNK * T, 11008)):
        x = torch.randn((M, K), generator=g, device=device).to(bf) * 3
        mult = (1.0 / torch.exp(torch.randn((1, K), generator=g, device=device) * 0.3)).to(bf)
        xi, sx = nf4.quantize_rows(x, mult)
        xr, sr = nf4._quantize_rows_plain(x, mult)
        torch.cuda.synchronize(device)
        n_bad = int((xi != xr).sum().item())
        srel = ((sx - sr).abs() / sr.abs()).max().item()
        k2_err = max(k2_err, (xi.int() - xr.int()).abs().max().item())
        log(f"K2 quant_rows [{M}, {K}]: code mismatches={n_bad}, sx max rel err={srel:.3e}")
        if n_bad or not srel <= 2e-7:
            raise RuntimeError(f"K2 disagrees with its plain version at [{M}, {K}]")
        if M == CHUNK * T and K == 4096:
            ms = bench_ms(lambda: nf4.quantize_rows(x, mult), device)
            plain = bench_ms(lambda: nf4._quantize_rows_plain(x, mult), device)
            log(f"K2 [{M}, {K}]: kernel {ms:.4f} ms, plain {plain:.4f} ms")
            rec["quant_rows"] = dict(ms=ms, plain_ms=plain, shape=f"x [{M},{K}] bf16 + sq_inv")
        # the library int8 GEMM of the s8s8 path, exact against f64
        if K == 11008 and M == CHUNK * T:
            q8 = torch.randint(-127, 128, (K, 4096), generator=g, device=device,
                               dtype=torch.int8)
            acc = nf4._int_dot(xi, q8)
            exact = (xi.double() @ q8.double()).to(torch.int32)
            if not torch.equal(acc, exact):
                raise RuntimeError("s8s8 int8 GEMM (torch._int_mm) is not exact")
            gemm_ms = bench_ms(lambda: nf4._int_dot(xi, q8), device, reps=10)
            rm_ms = bench_ms(lambda: torch._int_mm(xi, q8), device, reps=10)
            log(f"s8s8 GEMM [{M}, {K}] x [{K}, 4096] (torch._int_mm): exact; "
                f"{gemm_ms:.4f} ms with the column-major copy, {rm_ms:.4f} ms on the "
                "row-major weight as stored")
    rec["quant_rows"]["max_abs_err"] = float(k2_err)

    # K3: int8 weight-only linear at decode M = 14
    errs, ms_sum, plain_sum, eager_sum = [], 0.0, 0.0, 0.0
    for K, N in ((4096, 4096), (4096, 11008), (11008, 4096)):
        x = torch.randn((BATCH, K), generator=g, device=device).to(bf)
        w = torch.randn((K, N), generator=g, device=device) * K ** -0.5
        s = torch.exp(torch.randn((K,), generator=g, device=device) * 0.3)
        q = nf4.quantize_linear_int8(w, smooth_scale=s)
        y = nf4.int8_linear(x, q)
        ref = nf4._int8_linear_plain(x, q)
        torch.cuda.synchronize(device)
        err = (y.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        ok = torch.allclose(y.float(), ref.float(), rtol=2 ** -7, atol=1e-3 * scale)
        log(f"K3 int8_linear M={BATCH} K={K} N={N}: max_abs_err={err:.3e} "
            f"(max |y| {scale:.3f}; tol one bf16 ulp + 1e-3 max|y|)")
        if not ok:
            raise RuntimeError(f"K3 disagrees with its plain version at K={K} N={N}")
        errs.append(err)
        ms = bench_ms(lambda: nf4.int8_linear(x, q), device)
        plain = bench_ms(lambda: nf4._int8_linear_plain(x, q), device)
        eager = bench_ms(lambda: (x * q["sq_inv"]) @ q["q8"].to(bf) * q["scale8"].to(bf), device)
        log(f"K3 M={BATCH} K={K} N={N}: kernel {ms:.4f} ms, plain(f32) {plain:.4f} ms, "
            f"eager bf16 dequant {eager:.4f} ms, int8 bytes {K * N / 1e6:.1f} MB")
        ms_sum, plain_sum, eager_sum = ms_sum + ms, plain_sum + plain, eager_sum + eager
    rec["int8_linear"] = dict(max_abs_err=max(errs), ms=ms_sum, plain_ms=plain_sum,
                              shape=f"M={BATCH}, (K,N) in (4096,4096),(4096,11008),"
                                    "(11008,4096), ms summed over the three")
    log(f"K3 sum of the three shapes: kernel {ms_sum:.4f} ms, plain {plain_sum:.4f} ms, "
        f"eager bf16 dequant {eager_sum:.4f} ms")
    return rec


def build_params(cfg, device):
    """Phase 4: random LLaVA-1.5-7B weights on the card, int8 SmoothQuant LLM."""
    import torch

    from cullavo_tpu_torch.models.llava.lora import quantize_llm_weights
    from cullavo_tpu_torch.models.llava.modeling import init_llava_params

    g = torch.Generator(device=device).manual_seed(SEED)
    params = init_llava_params(cfg, g, device, dtype=torch.bfloat16)
    D, I = cfg.text.hidden_size, cfg.text.intermediate_size

    def smooth(K):
        return torch.exp(torch.randn((K,), generator=g, device=device) * 0.3)

    s_attn, s_o, s_mlp, s_down = smooth(D), smooth(D), smooth(D), smooth(I)
    scales = {"q": s_attn, "k": s_attn, "v": s_attn, "o": s_o,
              "gate": s_mlp, "up": s_mlp, "down": s_down}
    params = quantize_llm_weights(params, bits=8, smooth_scales=scales)
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    return params


def reference_check(params, cfg, device):
    """Phase 5: the first two LLM layers at full width, prefill (B=2, T=40,
    one row right-padded) and one decode step, kernel path on the card vs
    plain path on the CPU, same weights."""
    import torch

    from cullavo_tpu_torch.models.llava.config import LlavaConfig
    from cullavo_tpu_torch.models.llava.modeling import generate_prefill, llava_forward

    cfg2 = LlavaConfig(text=dataclasses.replace(cfg.text, num_hidden_layers=2))
    lm = params["language_model"]

    def cut(a):
        return {k: v[:2] for k, v in a.items()} if isinstance(a, dict) else a[:2]

    lm2 = {"embed_tokens": lm["embed_tokens"], "lm_head": lm["lm_head"], "norm": lm["norm"],
           "layers": {n: cut(a) for n, a in lm["layers"].items()}}

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    g = torch.Generator().manual_seed(SEED + 2)
    B, T, S = 2, 40, 44
    ids = torch.randint(4, 32000, (B, T), generator=g, dtype=torch.int32)
    mask = torch.ones((B, T), dtype=torch.int32)
    mask[1, 33:] = 0
    out = {}
    for dev in (device, torch.device("cpu")):
        p = {"language_model": to(lm2, dev)}
        st = generate_prefill(p, cfg2, ids.to(dev), None, mask.to(dev), S)
        tok = st["logits"].argmax(-1).to(torch.int32)
        full_mask, key_pos = st["full_mask"].clone(), st["key_pos"].clone()
        logits, _ = llava_forward(
            {"language_model": p["language_model"]}, cfg2, tok[:, None], None, None,
            st["cur_pos"][:, None], st["cache"], st["write_idx"], full_mask, key_pos,
            stale_cache=True)
        out[dev.type] = (st["logits"].float().cpu(), logits[:, 0].float().cpu())
    worst = 0.0
    for name, a, b in (("prefill", out["cuda"][0], out["cpu"][0]),
                       ("decode", out["cuda"][1], out["cpu"][1])):
        if a.shape != (B, cfg.text.vocab_size) or not torch.isfinite(a).all():
            raise RuntimeError(f"reference check: bad {name} logits {tuple(a.shape)}")
        err = (a - b).abs().max().item()
        worst = max(worst, err)
        log(f"reference check ({name} logits, 2 layers at 7B width, card vs CPU): "
            f"max_abs_err={err:.3e}, max |logit| {b.abs().max().item():.3f} (tol 0.1)")
    if not worst <= 0.1:
        raise RuntimeError(f"kernel path disagrees with the plain path: {worst}")


def run_main_path(params, cfg, device):
    """Phase 6: the 14-request VQA batch, twice."""
    import torch

    from cullavo_tpu_torch.models.llava.modeling import (GenerationConfig,
                                                         generate_decode,
                                                         generate_prefill_chunked)

    g = torch.Generator(device=device).manual_seed(SEED + 3)
    n_img = cfg.num_image_tokens
    T = 1 + n_img + PROMPT_TEXT
    T_pad = -(-T // PAD_TO) * PAD_TO
    ids = torch.randint(4, 32000, (BATCH, T_pad), generator=g, device=device, dtype=torch.int32)
    ids[:, 1:1 + n_img] = cfg.image_token_id
    mask = torch.ones((BATCH, T_pad), dtype=torch.int32, device=device)
    mask[:, T:] = 0
    pix = torch.randn((BATCH, 3, 336, 336), generator=g, device=device)
    gen = GenerationConfig(max_new_tokens=NEW_TOKENS, do_sample=False, eos_token_id=-1)

    def run(phase=contextlib.nullcontext):
        """One batch; ``phase(name)`` wraps each phase (e.g. a profiler)."""
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        with phase("prefill"):
            state = generate_prefill_chunked(params, cfg, ids, pix, mask, T_pad + NEW_TOKENS,
                                             CHUNK, compute_dtype=torch.bfloat16)
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        with phase("decode"):
            tokens = generate_decode(params, cfg, state, gen, compute_dtype=torch.bfloat16)
            torch.cuda.synchronize(device)
        t2 = time.perf_counter()
        return tokens.cpu(), t1 - t0, t2 - t1

    return run, T, T_pad


def profile_main_path(run):
    """``--profile``: one more batch under torch.profiler; per phase, the
    device-busy share of the wall time and the kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    profs = {}

    @contextlib.contextmanager
    def phase(name):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            yield
        profs[name] = prof

    _, pre, dec = run(phase)
    for name, wall in (("prefill", pre), ("decode", dec)):
        ka = profs[name].key_averages()
        busy = sum(e.self_device_time_total for e in ka) / 1e6
        log(f"profile {name}: wall {wall:.4f} s (profiled), device busy {busy:.4f} s "
            f"({100 * busy / wall:.1f}%)")
        log(ka.table(sort_by="self_device_time_total", row_limit=18,
                     max_name_column_width=70))


def main(argv):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this "
                         "script runs only on a CUDA GPU")
    sys.path.insert(0, REPO)
    from cullavo_tpu_torch import _build
    from cullavo_tpu_torch.models.llava.config import LlavaConfig
    from cullavo_tpu_torch.ops import flash_attention as fa
    from cullavo_tpu_torch.ops import nf4

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    # phase 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # phase 2
    t0 = time.perf_counter()
    _build.lib()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s wall "
        f"(nvcc {_build.build_info['seconds']:.2f} s)")
    for line in _build.build_info["ptxas"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  ptxas:", line.strip())

    # phase 3
    rec = check_kernels(device)
    wrappers = {"flash_fwd": fa.flash_attention, "quant_rows": nf4.quantize_rows,
                "int8_linear": nf4.int8_linear}
    meta = {"flash_fwd": ("cullavo_tpu_torch/csrc/flash_fwd.cu",
                          "cullavo_tpu/ops/flash_attention.py:259"),
            "quant_rows": ("cullavo_tpu_torch/csrc/quant_rows.cu",
                           "cullavo_tpu/ops/nf4.py:1157"),
            "int8_linear": ("cullavo_tpu_torch/csrc/int8_matmul.cu",
                            "cullavo_tpu/ops/nf4.py:912")}

    # phases 4-6
    cfg = LlavaConfig()
    t0 = time.perf_counter()
    params = build_params(cfg, device)
    log(f"7B params built in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB allocated")
    reference_check(params, cfg, device)

    run, T, T_pad = run_main_path(params, cfg, device)
    torch.cuda.reset_peak_memory_stats(device)
    for w in wrappers.values():
        w.launches = 0
    tok1, pre1, dec1 = run()
    counts = {name: w.launches for name, w in wrappers.items()}
    log(f"launches on the main path: {counts}")
    if not all(counts.values()):
        raise RuntimeError(f"a kernel of the path never launched: {counts}")
    tok2, pre2, dec2 = run()
    V = cfg.text.vocab_size
    if tok1.shape != (BATCH, NEW_TOKENS) or tok1.min() < 0 or tok1.max() >= V:
        raise RuntimeError(f"bad tokens: shape {tuple(tok1.shape)}, "
                           f"range [{tok1.min()}, {tok1.max()}]")
    if not torch.equal(tok1, tok2):
        raise RuntimeError("two runs of the batch gave different tokens")
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    for i, (pre, dec) in enumerate(((pre1, dec1), (pre2, dec2)), 1):
        log(f"run {i}: prefill {pre:.4f} s, decode {dec:.4f} s "
            f"({dec / (NEW_TOKENS - 1) * 1e3:.3f} ms per decode step), "
            f"{BATCH / (pre + dec):.4f} images/s")
    log(f"batch {BATCH}, prompt {T} real tokens padded to {T_pad}, chunk {CHUNK}, "
        f"{NEW_TOKENS} greedy tokens; tokens identical across runs; "
        f"peak memory {peak:.2f} GiB; tokens[0] {tok1[0].tolist()}")
    if "--profile" in argv:
        profile_main_path(run)

    kernels = [{"name": name, "route": "cuda", "source": meta[name][0],
                "replaces": meta[name][1], "launches": counts[name],
                **{k: rec[name][k] for k in ("max_abs_err", "ms", "plain_ms", "shape")}}
               for name in wrappers]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
