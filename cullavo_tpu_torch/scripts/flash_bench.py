"""Times the forward flash kernels (K1, K1-lse, K8, K13), the decode
attention kernels (K12, K4, K5), the fused NF4 dequant-matmuls (K6, K11),
the int8 weight-only linear (K3), the focal-modulation context (K10), the
probe's p32 product (K14), the row quantizer (K2), the planar NF4 dequant
(K7) and multi-scale deformable attention (K9) at the shapes of their main
paths on one CUDA card, so that two checkouts of the port can be compared
on the same card and the same inputs.

    python3 cullavo_tpu_torch/scripts/flash_bench.py [--root DIR] [--rounds N]
        [--forms all|flash|decode|nf4|int8|focal|p32|quant|dequant|deform ...]

``--root`` names the checkout whose ``cullavo_tpu_torch`` is imported
(default: the one holding this file): one copy of this script times an
older checkout's kernels through the entry points both share
(``flash_attention``, ``_flash_cuda``, ``flash_attention_packed``,
``decode_partials``, ``wwin_decode._run_cache_part``,
``wwin_decode._run_cache_part_q8``, ``nf4_linear_planar``, ``nf4_linear_q4``,
``int8_linear``, ``focal.focal_ctx_kernel``, ``matmul_probe.p32_linear``,
``quantize_rows``, ``nf4_dequant_planar``, ``msdeform.ms_deform_attn_kernel``).
Run it once per
checkout in turns (older, newer, newer, older) and compare within one
machine.  The inputs are drawn from a seeded generator on the card, so
every run sees the same bytes.  Each form is timed as the median of 20
launches between CUDA events, the 50 MB L2 flushed and the card kept busy
~0.5 ms ahead of each launch, so that the events time the card and not the
wrapper's host work.  The host's microseconds per call (checks, allocation,
launch) are measured apart, as the least of five means over 100 calls
queued without a sync.  The forms take turns, ``--rounds`` times.

Shapes (``PERF.md`` §6): K1 at the greedy prefill [7, 32, 648, 128]; K1-lse
at the train step [8, 32, 1024, 128]; K8 with its lse at the attention
probe [6, 32, 648, 128] (positions, 7 right-padded keys, causal); K13 at
[8, 1024, 32*128] and [7, 648, 32*128].  K12 at the LLaMA-7B decode shape
[14, 32, 768, 128] bf16 (every key valid) and at the VL zoo's f32 decode
shapes, T5-XL [5, 32, 11, 64] (unscaled, a per-head bias) and KOSMOS-2 [1,
32, 130, 64], each over one layer of a stacked [24, B, 32, S, 64] cache; K4
at the greedy step (W = 1 over a 664-slot view of a 768-slot stacked cache,
batch 14, 32 kv heads, per-row valid lengths), the speculative window (W =
4, S = 768) and the serving engine's suffix prefills (W = 32, 64, 128 over
a dense 4-row copy of a 608-slot prefix); K5 at the same shapes over the
cache quantized to int8 codes and bf16 scale planes.  K6 (planar NF4) and K11
(byte-packed NF4) at the three LLaMA-2-7B weight shapes (4096, 4096),
(4096, 11008) and (11008, 4096) and M = 14 (the greedy batch), 64 (the
serving decode) and 511 (the largest fused M), the weights quantized from a
seeded draw.  K3 at the same three shapes and the M of its paths: 8
(``vl_test``'s decode, a dict without ``sq_inv``), 14 and 56 (the greedy
batch and the speculative windows, SmoothQuant dicts with ``sq_inv``) and
5632 (``vl_test``'s prefill, no ``sq_inv``).  K10 at each FocalNet-L stage
of the X-Decoder eval (batch 8, a 512^2 image: maps 128^2 to 16^2 at C =
192 to 1536, levels k = 3, 5, 7, 9, bf16, tanh GELU, ctx and gates the
strided views of the ``f`` projection that ``focal_modulation`` passes) and
at stage 1 of the 512 x 640 bucket (128 x 160); ``focal_forward`` is one
forward's 24 launches (2, 2, 18, 2 blocks) summed from the stage medians.
K14 at M = 1, 8 and 64 over the probe's [4096, 11008] weight.  K2 at the
greedy batch's prefill chunk, [4536, 4096] and [4536, 11008] (7 prompts of
648 tokens; the down projection's K), bf16 x times a bf16 ``sq_inv``.  K7
at (4096, 11008).  K9 at the deformable encoder's shape at 512^2 (B 8, S =
Q = 16^2 + 32^2 + 64^2, 8 heads x 64, 3 levels x 4 points, bf16) at two
draws: (u) points uniform over [-0.1, 1.1] with softmaxed weights (phase 3
of ``chip_smoke.py``), and (p) the locations and weights that
``msdeform_attn_module_forward`` builds in one layer of the seeded encoder
(``init_deform_encoder_params``: each point a few pixels from its query's
own pixel centre, uniform weights).  Prints the
card's name and power limit, then one JSON line: ``{"root", "device",
"power_limit", "ms": {form: [median per round]}, "host_us": {form: [least
per round]}}`` (and ``focal_forward`` with the K10 stages).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
LEAD_CYCLES = 1_000_000


def _bench_ms(torch, fn, device, reps=20):
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(LEAD_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _host_us(torch, fn, device, n=100, rounds=5):
    """The least of ``rounds`` means over ``n`` calls queued without a sync:
    the host's own cost per call, with the machine's other load least in
    the way."""
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize(device)
        best = min(best, (t1 - t0) / n * 1e6)
    return best


def _flash_forms(torch, fa, device):
    """name -> a call of one forward form on its inputs (made here, once)."""
    g = torch.Generator(device=device).manual_seed(0)
    bf, H, d = torch.bfloat16, 32, 128

    def heads(B, T):   # strided head views of [B, T, H, d] projection outputs
        return [torch.randn((B, T, H, d), generator=g, device=device).to(bf).transpose(1, 2)
                for _ in range(3)]

    def packed(B, T):
        return [torch.randn((B, T, H * d), generator=g, device=device).to(bf) for _ in range(3)]

    k1 = heads(7, 648)
    k1_lse = heads(8, 1024)
    k8 = heads(6, 648)
    valid = (torch.arange(648, device=device)[None, :] < 648 - 7).int().expand(6, 648)
    pos = (torch.cumsum(valid, dim=1) - 1).clamp_min(0).int()
    k13_train, k13_prefill = packed(8, 1024), packed(7, 648)
    return {"K1 [7,32,648,128]": lambda: fa.flash_attention(*k1),
            "K1-lse [8,32,1024,128]": lambda: fa._flash_cuda(*k1_lse, None, None, True, True),
            "K8-lse [6,32,648,128] qpos+kvalid causal":
                lambda: fa._flash_cuda(*k8, pos, valid, True, True),
            "K13 [8,1024,32*128]": lambda: fa.flash_attention_packed(*k13_train, H),
            "K13 [7,648,32*128]": lambda: fa.flash_attention_packed(*k13_prefill, H)}


def _decode_forms(torch, fa, ww, device):
    """name -> a call of K12, K4 or K5 on its inputs (made here, once)."""
    from cullavo_tpu_torch.models.llava.llama import quantize_kv

    g = torch.Generator(device=device).manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32

    def rnd(*shape, dtype=f32):
        return torch.randn(shape, generator=g, device=device).to(dtype)

    forms = {}
    # K12, the 7B shape: q [14, 32, 1, 128], caches [14, 32, 768, 128], every key valid
    q7, k7, v7 = (rnd(*s, dtype=bf) for s in ((14, 32, 1, 128), (14, 32, 768, 128),
                                                (14, 32, 768, 128)))
    b7 = torch.zeros((14, 1, 768), device=device)
    forms["K12 [14,32,768,128] bf16"] = lambda: fa.decode_partials(q7, k7, v7, b7, 128 ** -0.5)
    # K12, the zoo: one layer of a stacked f32 cache [24, B, 32, S, 64]
    for name, B, S, scale in (("T5-XL [5,32,11,64] f32", 5, 11, 1.0),
                              ("KOSMOS-2 [1,32,130,64] f32", 1, 130, 64 ** -0.5)):
        kc, vc = rnd(24, B, 32, S, 64), rnd(24, B, 32, S, 64)
        q = rnd(B, 32, 1, 64)
        written = torch.arange(S, device=device) < S - 3
        bias = torch.where(written, 0.0, -1e9)[None, None, :]
        if scale == 1.0:   # T5: a per-head relative bias over the cache
            bias = rnd(1, 32, S) + bias
        forms[f"K12 {name}"] = (
            lambda a=(q, kc[11], vc[11], bias, scale): fa.decode_partials(*a))
    # K4: a stacked bf16 cache [2, 768, 14, 32, 128], layer 1
    L, S_full, B, KV, hd = 2, 768, 14, 32, 128
    kc, vc = rnd(L, S_full, B, KV, hd, dtype=bf), rnd(L, S_full, B, KV, hd, dtype=bf)
    n_valid = torch.randint(640, 664, (B,), generator=g, device=device)
    # K5: the same cache as int8 codes [L, S, B, KV, hd] and bf16 planes [L, S, B, KV]
    q8 = (*quantize_kv(kc), *quantize_kv(vc))
    for W, S in ((1, 664), (1, 768), (4, 768)):
        q = rnd(B, W, KV, hd, dtype=bf).transpose(1, 2)
        ok = torch.arange(S, device=device)[None, :] < n_valid[:, None]
        bias = torch.where(ok, 0.0, ww.NEG_INF)[:, None, :].expand(B, W, S).contiguous()
        if S == 664:   # the greedy bf16 step: a strided view
            forms[f"K4 W={W} S={S} B={B}"] = (
                lambda a=(q, kc[:, :S], vc[:, :S], 1, bias, 1, hd ** -0.5):
                ww._run_cache_part(*a))
            continue
        if W == 4:
            forms[f"K4 W={W} S={S} B={B}"] = (
                lambda a=(q, kc, vc, 1, bias, 1, hd ** -0.5): ww._run_cache_part(*a))
        forms[f"K5 W={W} S={S} B={B}"] = (
            lambda a=(q, *q8, 1, bias, 1, hd ** -0.5): ww._run_cache_part_q8(*a))
    # K4 and K5: the suffix prefills over a dense 4-row copy of a 608-slot prefix
    ks, vs = (t[:, :, :4].contiguous() for t in (kc, vc))
    q8s = tuple(t[:, :, :4].contiguous() for t in q8)
    ok = torch.arange(S_full, device=device) < 608
    for W in (32, 64, 128):
        q = rnd(4, W, KV, hd, dtype=bf).transpose(1, 2)
        bias = torch.where(ok, 0.0, ww.NEG_INF)[None, None, :].expand(4, W, S_full).contiguous()
        forms[f"K4 W={W} S={S_full} B=4 suffix"] = (
            lambda a=(q, ks, vs, 1, bias, 1, hd ** -0.5): ww._run_cache_part(*a))
        forms[f"K5 W={W} S={S_full} B=4 suffix"] = (
            lambda a=(q, *q8s, 1, bias, 1, hd ** -0.5): ww._run_cache_part_q8(*a))
    return forms


def _nf4_forms(torch, nf4, device):
    """name -> a call of K6 or K11 on its inputs (made here, once)."""
    g = torch.Generator(device=device).manual_seed(0)
    forms = {}
    for K, N in ((4096, 4096), (4096, 11008), (11008, 4096)):
        w = torch.randn((K, N), generator=g, device=device) * K ** -0.5
        planar, q4 = nf4.quantize_linear_planar(w), nf4.quantize_linear(w)
        for M in (14, 64, 511):
            x = torch.randn((M, K), generator=g, device=device).to(torch.bfloat16)
            forms[f"K6 M={M} ({K},{N})"] = lambda a=(x, planar): nf4.nf4_linear_planar(*a)
            forms[f"K11 M={M} ({K},{N})"] = lambda a=(x, q4, K): nf4.nf4_linear_q4(*a)
        del w
    return forms


def _int8_forms(torch, nf4, device):
    """name -> a call of K3 on its inputs (made here, once)."""
    g = torch.Generator(device=device).manual_seed(0)
    forms = {}
    for K, N in ((4096, 4096), (4096, 11008), (11008, 4096)):
        w = torch.randn((K, N), generator=g, device=device) * K ** -0.5
        s = torch.exp(torch.randn((K,), generator=g, device=device) * 0.3)
        smooth, plain = nf4.quantize_linear_int8(w, smooth_scale=s), nf4.quantize_linear_int8(w)
        for M, q in ((8, plain), (14, smooth), (56, smooth), (5632, plain)):
            x = torch.randn((M, K), generator=g, device=device).to(torch.bfloat16)
            kind = "sq_inv" if "sq_inv" in q else "no sq_inv"
            forms[f"K3 M={M} ({K},{N}) {kind}"] = lambda a=(x, q): nf4.int8_linear(*a)
        del w
    return forms


FOCAL_STAGES = ((128, 128, 192, 2), (64, 64, 384, 2), (32, 32, 768, 18), (16, 16, 1536, 2))
FOCAL_KERNELS = (3, 5, 7, 9)


def _focal_forms(torch, focal, device):
    """name -> a call of K10 at a FocalNet-L stage (inputs made here, once)."""
    g = torch.Generator(device=device).manual_seed(0)
    L = len(FOCAL_KERNELS)
    forms = {}
    for i, (H, W, C, _) in enumerate(FOCAL_STAGES + ((128, 160, 192, 0),)):
        fx = torch.randn((8, 2 * C + L + 1, H * W), generator=g, device=device).to(torch.bfloat16)
        taps = torch.cat([torch.randn((C, k * k), generator=g, device=device) * (0.6 / k)
                          for k in FOCAL_KERNELS], dim=1)
        a = (fx[:, C:2 * C], fx[:, 2 * C:], taps, H, W, FOCAL_KERNELS, True, True)
        name = (f"K10 stage {i + 1} [8,{C},{H}x{W}]" if i < 4
                else f"K10 bucket stage 1 [8,{C},{H}x{W}]")
        forms[name] = lambda a=a: focal.focal_ctx_kernel(*a)
    return forms


def _p32_forms(torch, mp, device):
    """name -> a call of K14 on the probe's weight (inputs made here, once)."""
    g = torch.Generator(device=device).manual_seed(0)
    w8 = torch.randint(-128, 128, (mp.K, mp.N), generator=g, device=device, dtype=torch.int8)
    w32 = mp.pack_p32(w8)
    scale = torch.rand((mp.N,), generator=g, device=device) * 0.01
    forms = {}
    for M in (1, 8, 64):
        x = torch.randn((M, mp.K), generator=g, device=device).to(torch.bfloat16)
        forms[f"K14 M={M} [{mp.K},{mp.N}]"] = lambda a=(x, w32, scale): mp.p32_linear(*a)
    return forms


def _quant_forms(torch, nf4, device):
    """name -> a call of K2 on its inputs (made here, once)."""
    g = torch.Generator(device=device).manual_seed(0)
    forms = {}
    for K in (4096, 11008):
        x = (torch.randn((4536, K), generator=g, device=device) * 3).to(torch.bfloat16)
        mult = (1.0 / torch.exp(torch.randn((1, K), generator=g, device=device) * 0.3)).to(
            torch.bfloat16)
        forms[f"K2 [4536,{K}] sq_inv bf16"] = lambda a=(x, mult): nf4.quantize_rows(*a)
    return forms


def _dequant_forms(torch, nf4, device):
    """name -> a call of K7 on its inputs (made here, once)."""
    g = torch.Generator(device=device).manual_seed(0)
    q = nf4.quantize_linear_planar(torch.randn((4096, 11008), generator=g, device=device)
                                   * 4096 ** -0.5)
    return {"K7 (4096,11008)": lambda: nf4.nf4_dequant_planar(q)}


DEFORM_LEVELS = ((16, 16), (32, 32), (64, 64))


def deform_draws(torch, device, B=8, dtype=None):
    """(value, levels, loc, att) of K9 at the encoder's shape (B, S = Q =
    5376, 8 heads x 64, 3 levels x 4 points) at draw "u" (points uniform
    over [-0.1, 1.1], softmaxed weights) and draw "p" (what
    ``msdeform_attn_module_forward`` hands K9 in one layer of the seeded
    encoder); seeded, on ``device``.  Uses only entry points every checkout
    of the port has."""
    from cullavo_tpu_torch.models.xdecoder import deform_encoder as de
    from cullavo_tpu_torch.ops import msdeform

    dtype = dtype or torch.bfloat16
    g = torch.Generator(device=device).manual_seed(0)
    cfg = de.DeformEncoderConfig()
    Hh, L, P = cfg.num_heads, len(DEFORM_LEVELS), cfg.num_points
    hd, S = cfg.conv_dim // Hh, sum(h * w for h, w in DEFORM_LEVELS)
    value = torch.randn((B, S, Hh, hd), generator=g, device=device).to(dtype)
    loc = torch.rand((B, S, Hh, L, P, 2), generator=g, device=device) * 1.2 - 0.1
    att = torch.softmax(torch.randn((B, S, Hh, L * P), generator=g, device=device), -1)
    draws = {"u": (value, DEFORM_LEVELS, loc, att.reshape(B, S, Hh, L, P).to(dtype))}
    # draw p: one encoder layer's module, its core call captured
    params = de.init_deform_encoder_params(cfg, g, device, dtype)["layers"][0]["attn"]
    refs = []
    for h, w in DEFORM_LEVELS:      # each level's pixel centres, as the encoder builds them
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        refs.append(torch.stack([xx, yy], -1).reshape(-1, 2))
    ref = torch.cat(refs, 0)[None, :, None, :].expand(B, S, L, 2)
    query = torch.randn((B, S, cfg.conv_dim), generator=g, device=device).to(dtype)
    src = torch.randn((B, S, cfg.conv_dim), generator=g, device=device).to(dtype)
    seen = []

    def capture(v, levels, loc_, att_):     # the module's core call, not launched
        seen.append((v, levels, loc_, att_))
        return torch.zeros((B, S, Hh * hd), dtype=v.dtype, device=device)

    kernel = msdeform.ms_deform_attn_kernel
    msdeform.ms_deform_attn_kernel = capture
    msdeform.msdeform_attn_module_forward(params, query, src, DEFORM_LEVELS, ref, Hh, L, P)
    msdeform.ms_deform_attn_kernel = kernel
    draws["p"] = seen[0]
    return draws


def _deform_forms(torch, msdeform, device):
    """name -> a call of K9 at draws (u) and (p) (inputs made here, once)."""
    return {f"K9 [8,5376,8,64] bf16 draw {d}": lambda a=a: msdeform.ms_deform_attn_kernel(*a)
            for d, a in deform_draws(torch, device).items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)),
                    help="the checkout whose cullavo_tpu_torch is timed")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--forms", nargs="+",
                    choices=("all", "flash", "decode", "nf4", "int8", "focal", "p32", "quant",
                             "dequant", "deform"),
                    default=["all"])
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("flash_bench: needs a CUDA card")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from cullavo_tpu_torch.ops import flash_attention as fa
    from cullavo_tpu_torch.ops import focal, msdeform, nf4
    from cullavo_tpu_torch.ops import wwin_decode as ww
    from cullavo_tpu_torch.scripts import matmul_probe as mp

    for mod in (fa, ww, nf4, focal, mp, msdeform):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise SystemExit(f"flash_bench: imported {mod.__file__}, not from {root}")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    name, limit = (x.strip() for x in smi.splitlines()[0].split(","))
    print(smi.splitlines()[0], flush=True)
    forms = {}
    if {"all", "flash"} & set(args.forms):
        forms.update(_flash_forms(torch, fa, device))
    if {"all", "decode"} & set(args.forms):
        forms.update(_decode_forms(torch, fa, ww, device))
    if {"all", "nf4"} & set(args.forms):
        forms.update(_nf4_forms(torch, nf4, device))
    if {"all", "int8"} & set(args.forms):
        forms.update(_int8_forms(torch, nf4, device))
    if {"all", "focal"} & set(args.forms):
        forms.update(_focal_forms(torch, focal, device))
    if {"all", "p32"} & set(args.forms):
        forms.update(_p32_forms(torch, mp, device))
    if {"all", "quant"} & set(args.forms):
        forms.update(_quant_forms(torch, nf4, device))
    if {"all", "dequant"} & set(args.forms):
        forms.update(_dequant_forms(torch, nf4, device))
    if {"all", "deform"} & set(args.forms):
        forms.update(_deform_forms(torch, msdeform, device))
    ms = {n: [] for n in forms}
    host = {n: [] for n in forms}
    for _ in range(args.rounds):
        for n, fn in forms.items():
            ms[n].append(round(_bench_ms(torch, fn, device), 4))
            host[n].append(round(_host_us(torch, fn, device), 1))
    res = {"root": root, "device": name, "power_limit": limit, "ms": ms, "host_us": host}
    stages = [n for n in ms if n.startswith("K10 stage")]
    if len(stages) == len(FOCAL_STAGES):   # one FocalNet-L forward, per round
        res["focal_forward"] = [
            round(sum(st[3] * ms[n][r] for st, n in zip(FOCAL_STAGES, stages)), 4)
            for r in range(args.rounds)]
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
