#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cullavo_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py               # kernels, the 7B serving and train paths, X-Decoder
                                        # eval, vl_test from a written 7B snapshot, the VL zoo
    python3 chip_smoke.py --profile     # the same + a profiled run of each path

Phases (each raises on failure, and the script exits non-zero):
  1. print the card's name and power limit (nvidia-smi); disable TF32.
  2. build the port's CUDA kernels from ``cullavo_tpu_torch/csrc``.
  3. compare each kernel with its plain PyTorch version on the card at the
     shapes of the LLaVA-1.5-7B int8 VQA paths (K1 flash prefill, K2 row
     quantizer, K3 int8 weight-only linear, K4/K5 W-window decode attention
     over the stacked bf16/int8 KV cache; also the library s8s8 GEMM), time
     both with CUDA events (L2 flushed before every launch), time the one
     PyTorch call that computes the same function where there is one, and
     work out each kernel's bound (bytes over 3.35 TB/s against operations
     over the card's peak rate) from the inputs of this run.  K4/K5 are held
     at the decode windows (W = 1 and 4, B = 14) and at the serving engine's
     suffix prefills (W = 32, 64 and 128, B = 4, cache gated to a 608-token
     prefix).  Then the planar
     NF4 kernels at the three 7B weight shapes: K7 (dequant to dense bf16)
     bit-equal to its plain version, K6 (fused dequant-matmul) at M = 1, 14,
     64, 256 and 511 within 1e-2 + 1e-2 |ref|, timed at the serving decode
     M = 64 beside the dense bf16 matmul.  Then the training kernels: K1-lse
     (the causal flash forward that also writes the log-sum-exp) at the train
     shape [8, 32, 1024, 128], o within 1e-2 + 1e-2 |ref| and the f32 lse
     within 2e-3; K8 (the masked flash forward with explicit positions and
     key validity) at the probe shape [6, 32, 648, 128] with right padding,
     with left padding (a wholly masked row), with S > T and non-causal; the
     autograd function's dq, dk, dv against autograd through the plain
     version (within 2e-2 of the largest entry) and its chunked backward
     timed at the train shape; ``nf4_linear_planar_vjp``'s dx against the
     dense matmul at M = 8192.  Then the X-Decoder kernels: K9
     (multi-scale deformable attention) at the deformable encoder's shape
     at a 512² image (value [8, 5376, 8, 64], 3 levels x 4 points), at
     the 512 x 640 bucket's non-square levels and at a ragged Q, points
     partly outside the maps; K10 (the gated focal-modulation context) at
     each FocalNet-L stage at 512², batch 8; both in bf16 (within 1e-2 +
     1e-2 |ref|) and f32 (within 1e-5 + 1e-5 |ref|), K10 with both GELU
     forms; timed beside a yardstick (K9: one ``grid_sample`` per level,
     the reference's composition; K10: the cuDNN depthwise ``conv2d``
     chain in bf16, the model's own), K10 summed over one forward.  Then
     K11, the byte-packed NF4 kernel, at the three 7B weight shapes: its
     dequant entry bit-equal to ``dequant_linear``, its fused entry at M = 1,
     14, 64, 256 and 511 within 1e-2 + 1e-2 |ref| of the f32 plain version,
     and as row 8 (an NF4Tensor with its absmax decoded on the card) against
     ``dequantize_nf4`` + the product; timed at M = 14 and 64 beside the
     bound and the dense bf16 matmul on the dequantized weight.  Then K12,
     the one-token decode attention, through ``flash_decode`` at the 7B
     decode shape [14, 32, 768, 128] bf16 (KV = 32 and 8, S = 700, a wholly
     masked row) and through ``sdpa_decode_stale`` at the T5-XL and
     KOSMOS-2 decode shapes in f32 (the current token merged), within 1e-2
     + 1e-2 |ref| (bf16) and 1e-5 + 1e-5 |ref| (f32); timed at the 7B shape
     beside the bound, the plain version and ``scaled_dot_product_attention``
     with a boolean mask, and at the zoo's shapes.
  4. build random LLaVA-1.5-7B weights on the card from a seeded
     ``torch.Generator``: bf16 vision tower, projector, embeddings and head;
     int8 SmoothQuant LLM linears with smooth scales exp(N(0, 0.3)) shared
     per input group.
  5. check the kernel path against the plain path on a small input: the
     first two LLM layers at full width, prefill, one decode step and a
     W = 4 window forward with per-row write positions over a bf16 and an
     int8 cache, on the card and on the CPU.
  6. answer 14 VQA-shaped requests (641 real tokens right-padded to 648,
     576 image tokens, 336x336 pixels, 16 greedy tokens) through
     ``generate_prefill_chunked`` (chunk 7) + ``generate_decode``, twice;
     the tokens must be in the vocabulary and equal across the runs, and
     K1-K4 must have launched in the first run.
  6b. the same requests with the int8 KV cache and speculative windows of 4
     (cache of ``round_cache_len(648 + 16 + 4)`` slots) through
     ``generate_decode_spec``, twice, and once through ``generate_decode``
     over the int8 cache: tokens equal across the speculative runs, K5
     launched, window and token counts consistent, every speculative token
     the sequential step's argmax within 0.1 (teacher-forced replay), and
     every row whose greedy top-2 logit gaps all exceed 0.1 equal to the
     int8 greedy stream.  One more speculative run over the bf16 cache at
     8 layers drives K4 at W = 4 and is held the same way.
  7. the serving path over an NF4 base: ``entry.serve`` once in its tiny
     smoke mode; then 7B weights with the LLM linears quantized to planar NF4
     target by target (``maybe_quantize_base``), the 2-layer check of phase 5
     on that base (an M = 528 prefill through K7, a W = 4 window and a
     32-token suffix prefill through K6), and a ``ServingEngine`` built by
     ``entry._engine_from_cfg`` from ``configs/serve.yaml``'s SERVE block
     (int8 KV cache, spec_k 4, prefix reuse, 16 slots) answering 24
     requests, 8 images x 3 questions, twice on fresh engines: results of the
     right length, 8 prefix misses, 16 hits and 16 x 608 tokens saved,
     identical tokens in both runs, every token the sequential step's argmax
     within 0.1 in a teacher-forced replay from a FULL prefill, and K1, K5,
     K6 and K7 launched.
  8. the train path: ``entry.train`` once in its tiny smoke mode; the
     2-layer full-width check of the Q-LoRA train step (loss and every
     gradient, kernel path on the card against the plain path on the CPU);
     then, over the NF4 base of phase 7, the state built by
     ``CuLLaVOPipeline.initialize_model`` (r = 64 adapters on the seven LLM
     targets and on vision layers 12-22, f32 masters, AdamW) and 4 steps of
     ``forward_step`` (remat, bf16 compute, chunked loss, dropout 0.05) on
     one batch of 8 right-padded to T = 1024, twice from the same seed: every
     loss finite, the loss of step 4 below step 1, ``grad_norm`` finite and
     non-zero, the two runs equal within 1e-3 relative, the frozen base
     bit-unchanged, and K1-lse and K7 launched as often as the shapes say.
  8b. the package's ``attn_probe`` at its default shape, which runs K8.
  9. the X-Decoder eval path: ``entry.evaluate`` on
     configs/xdecoder_test.yaml with ``DATASETS.TEST`` unset (returns {});
     then both configurations (FocalNet-L + FPN, SAM-ViT-B + deformable
     encoder) at full width and cut depth, f32, on one 256 x 320 image,
     card (kernels) against CPU (plain versions): class embeddings, class
     and mask logits within 1e-3 of their largest entry; then each at full
     width and depth in bf16 (random weights, the 133 COCO panoptic
     classes + background through the 12-layer text encoder):
     ``XDecoderPipeline.evaluate_model`` with the semantic,
     panoptic and instance tasks on 16 synthetic images (12 of 512², 4 of
     480 x 640) with synthetic ground truth, batch 8, twice: identical
     outputs, ids in range, finite metrics, K10 24 and K9 6 launches per
     forward; images/s, compute s per batch and peak memory printed.
  10. the vl_test eval from a snapshot: random LLaVA-1.5-7B bf16 weights
     written as a snapshot in the HF layout (config.json with
     llava-hf/llava-1.5-7b-hf's widths, a LLaMA-style BPE tokenizer.json
     with <image> and <pad> at 32000/32001, bf16 safetensors shards by the
     port's own writer; full depth) and read back through the port's loader,
     bit for bit; then ``entry.evaluate`` on configs/vl_test.yaml (BITS 8,
     batch 8, 16 new tokens) with ``LOAD_PATH`` the snapshot over an
     in-memory VQA dataset of 16 questions on 8 random images, twice:
     n = 16, a finite accuracy in [0, 100], identical answers, K1, K3 and
     K4 launched; load seconds, images/s and peak memory printed.
  10b. the byte-packed NF4 base: those weights' LLM linears as q4
     (``quantize_linear``) and as planar NF4; one weight's K11 dequant
     bit-equal to K7's; phase 5's 2-layer check on the q4 base; the
     14-request greedy batch over the q4 base twice (K11 launched 7 x 32 x
     15 times fused plus 7 x 32 per prefill chunk through its dequant
     entry); rows with decisive logits equal to the planar base's stream.
  11. the VL zoo: ``entry.evaluate`` with ``MODEL.ZOO`` blip2 and kosmos2
     at the JAX package's tiny configs on the card (4 questions each, K12
     launched); BLIP-2 Flan-T5-XL and KOSMOS-2 at full width and 2 layers
     per tower, f32 on the card against f64 on the CPU (the forward's
     logits and four decode steps); then each at full width and depth in
     f32 (3.94 G and 1.66 G random parameters built on the card) answering
     16 questions on 8 random 224^2 images through
     ``VLZooVQAPipeline.evaluate_model`` with its native answerer and the
     byte tokenizer, twice: n = 16, identical answers, K12 launched as the
     shapes predict; questions/s, ms per question by phase, peak memory.
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
SPEC_K, SPEC_BF16_LAYERS, LOGIT_TOL = 4, 8, 0.1
NF4_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))   # (K, N) of the 7B linears
# configs/serve.yaml's SERVE block, with the prompt bucket of the traffic below
SERVE_CFG = {"REQUESTS": None, "RESULTS": "serve_results.jsonl", "SLOTS": 16, "QUANTUM": 8,
             "PREFILL_CHUNK": 4, "PROMPT_BUCKETS": [648], "KV_QUANT": "int8", "SPEC_K": 4,
             "EOS_TOKEN_ID": 2, "DO_SAMPLE": False, "PREFIX": True, "ADMIT_GROUPS": 1}
SERVE_MODEL_CFG = {"LLM": {"LOAD_PATH": None, "BITS": 4}}
SERVE_IMAGES, SERVE_QUESTIONS, SERVE_HEAD_TEXT, SERVE_SHARED_TEXT = 8, 3, 4, 32
SERVE_OWN_TEXT, SERVE_BUDGETS = (8, 28), (8, 16, 24, 32)
SERVE_DECODE_M = SERVE_CFG["SLOTS"] * SERVE_CFG["SPEC_K"]
SERVE_SUFFIX_W = (32, 64, 128)   # the engine's default suffix buckets
# configs/cullavo_step1.yaml (the Q-LoRA train step), its dataset left unset
TRAIN_CFG = {"NAME": "cullavo_step1", "PIPELINE": "CuLLaVOPipeline", "WORKLOAD": "step1",
             "BATCH_SIZE": 8, "LR": 2.0e-5, "LAST_LR": 0.0, "GRAD_MAX": 10.0, "GRAD_CUM": 1,
             "SEED": 0,
             "MODEL": {"LLM": {"BITS": 4, "LORA_R": 64, "LORA_ALPHA": 16, "GRAD_CKPT": True,
                               "LOAD_PATH": None}},
             "DATASETS": {"TRAIN": None}}
TRAIN_T, TRAIN_STEPS, TRAIN_LEN_RANGE = 1024, 4, (700, 1024)
PROBE_SHAPE = (6, 32, 648, 128)   # the attention probe's default shape
# NVIDIA H100 SXM data sheet: HBM3 bytes/s, dense operations/s by input type
HBM_BPS = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
# the X-Decoder eval path: configs/xdecoder_test.yaml (FocalNet-L + FPN) and
# configs/xdecoder/samvitb_deform_lang.yaml (SAM-ViT-B + deformable encoder),
# as the dicts their yaml files hold (this script reads no yaml); images
# as bench_xdecoder.py evaluates them (512^2, batch 8, bf16)
_XDEC_DECODER = {"HIDDEN_DIM": 512, "NUM_OBJECT_QUERIES": 201, "NHEADS": 8,
                 "DIM_FEEDFORWARD": 2048, "DEC_LAYERS": 10}
_XDEC_TEXT = {"WIDTH": 512, "HEADS": 8, "LAYERS": 12, "CONTEXT_LENGTH": 77}
XDEC_CONFIGS = {
    "configs/xdecoder_test.yaml": {
        "NAME": "xdecoder_test", "PIPELINE": "XDecoderPipeline",
        "MODEL": {"BACKBONE": {"NAME": "focal", "EMBED_DIM": 192, "DEPTHS": [2, 2, 18, 2],
                               "FOCAL_LEVELS": [4, 4, 4, 4], "FOCAL_WINDOWS": [3, 3, 3, 3]},
                  "ENCODER": {"NAME": "transformer_encoder_fpn", "CONVS_DIM": 512,
                              "MASK_DIM": 512, "NUM_CLASSES": 133},
                  "DECODER": dict(_XDEC_DECODER), "TEXT": dict(_XDEC_TEXT)},
        "DATASETS": {"TEST": None}},
    "configs/xdecoder/samvitb_deform_lang.yaml": {
        "NAME": "xdecoder_test_samvitb_deform", "PIPELINE": "XDecoderPipeline",
        "MODEL": {"BACKBONE": {"NAME": "vit", "VIT": {"SIZE": "base", "OUT_FEATURES": [
                      "res2", "res3", "res4", "res5"]}},
                  "ENCODER": {"NAME": "transformer_encoder_deform", "CONVS_DIM": 512,
                              "MASK_DIM": 512, "NUM_CLASSES": 133,
                              "DEFORMABLE_TRANSFORMER_ENCODER_IN_FEATURES": [
                                  "res3", "res4", "res5"],
                              "COMMON_STRIDE": 4, "TRANSFORMER_ENC_LAYERS": 6},
                  "DECODER": dict(_XDEC_DECODER), "TEXT": dict(_XDEC_TEXT)},
        "DATASETS": {"TEST": None}},
}
XDEC_FOCAL, XDEC_DEFORM = XDEC_CONFIGS   # the two paths, by config file
XDEC_BATCH, XDEC_SIDE, XDEC_DATASET = 8, 512, "coco_2017_val_panoptic_with_sem_seg"
XDEC_SIZES = ((512, 512),) * 12 + ((480, 640),) * 4   # the last four: bucket 512 x 640
XDEC_CHECK_HW = (256, 320)
XDEC_THINGS = frozenset(range(80))   # COCO panoptic: the first 80 classes are things
# the VL eval path: configs/vl_test.yaml as the dict it holds, over a
# LLaVA-1.5-7B snapshot written in llava-hf/llava-1.5-7b-hf's layout and an
# in-memory VQA dataset (records carry decoded images: no PIL beside the card)
VL_CFG = {"NAME": "vl_test", "PIPELINE": "LLaVAVQAVALPipeline", "BATCH_SIZE": 8,
          "MAX_NEW_TOKENS": 16, "LIMIT": 0, "MODEL": {"LLM": {"LOAD_PATH": None, "BITS": 8}},
          "DATASETS": {"TEST": None}}
VL_DATASET, VL_IMAGES, VL_QUESTIONS = "chip_vqa_synthetic", 8, 16
VL_IMAGE_HW = ((480, 640), (336, 336), (640, 480), (375, 500))
VL_SHARD_LAYERS = 8          # LLM layers per safetensors shard
TOKENIZER_MERGES = 400
_OBJECTS = ("car", "dog", "cat", "man", "woman", "bicycle", "table", "plate", "sofa", "window",
            "giraffe", "horse", "bus", "train", "umbrella", "kite", "pizza", "clock", "bird",
            "boat")
_ATTRS = ("color", "size", "shape", "name", "number", "type")
TOKENIZER_CORPUS = tuple(
    ["A chat between a curious human and an artificial intelligence assistant. The assistant "
     "gives helpful, detailed, and polite answers to the human's questions."]
    + [f"USER: What is the {a} of the {o}? ASSISTANT: the {o} is {a}"
       for o in _OBJECTS for a in _ATTRS]
    + [f"USER: How many {o}s are there in the picture? ASSISTANT: two {o}s" for o in _OBJECTS]
    + [f"USER: Is the {o} next to the {o2}? ASSISTANT: yes, it is"
       for o, o2 in zip(_OBJECTS, _OBJECTS[1:])])
VL_QUESTION_TEXT = ("What is the color of the car?", "How many dogs are there?",
                    "Is the man riding a bicycle?", "What is on the table?",
                    "Where is the cat sitting?", "What sport is being played?",
                    "What time of day is it?", "Are there any people in the picture?")
VL_ANSWERS = ("red", "two", "yes", "no", "food", "sofa", "tennis", "night")
# the VL zoo path: Salesforce/blip2-flan-t5-xl and microsoft/kosmos-2-patch14-224
# at full width and depth in f32 (as the pipeline's ModelSpec loads them), each
# answering 16 questions on 8 random 224^2 images with its reference decode
# (BLIP-2: beam 5, length penalty -1; KOSMOS-2: greedy), <= 10 new tokens
ZOO_DATASET, ZOO_IMAGES, ZOO_QUESTIONS, ZOO_SIDE, ZOO_NEW, ZOO_BEAMS = (
    "chip_vqa_zoo", 8, 16, 224, 10, 5)
# the card-vs-CPU check: layers per tower; the card's f32 error against the
# CPU's f64 result may be ZOO_TOL times the CPU's own f32 error, + 1e-5 max |ref|
ZOO_CUT, ZOO_TOL = 2, 4.0


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


def bound(n_bytes, n_ops, op_type):
    """The least ms the card could take: each input byte read once and each
    output byte written once at the memory rate, against the operations at
    the peak rate of their type; and which of the two it is."""
    t_bytes, t_ops = n_bytes / HBM_BPS * 1e3, n_ops / PEAK_OPS[op_type] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def device_seconds(ka):
    """The device time of a profile's ``key_averages()``: the self times of
    its device-side events (kernels, copies); an operator's row repeats the
    time of the kernels it launched, so summing every row counts it twice."""
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in ka if e.device_type == DeviceType.CUDA) / 1e6


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


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
    # a yardstick timed here only: the port never calls it
    lib = bench_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True), device)
    bd = bound(nbytes(q, k, v, out), 4 * CHUNK * H * T * T * d / 2, "bf16")
    log(f"K1 B={CHUNK}: kernel {ms:.4f} ms, plain {plain:.4f} ms, library sdpa {lib:.4f} ms, "
        f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    rec["flash_fwd"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, **bd,
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
            # ~6 f32 operations per element; no single PyTorch call does it
            bd = bound(nbytes(x, mult, xi, sx), 6 * M * K, "f32")
            log(f"K2 [{M}, {K}]: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
            rec["quant_rows"] = dict(ms=ms, plain_ms=plain, library_ms=None, **bd,
                                     shape=f"x [{M},{K}] bf16 + sq_inv")
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
    errs, ms_sum, plain_sum, eager_sum, k3_bytes, k3_ops = [], 0.0, 0.0, 0.0, 0, 0
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
        k3_bytes += nbytes(x, q["q8"], q["scale8"], q["sq_inv"], y)
        k3_ops += 2 * BATCH * K * N
    bd = bound(k3_bytes, k3_ops, "bf16")
    rec["int8_linear"] = dict(max_abs_err=max(errs), ms=ms_sum, plain_ms=plain_sum,
                              library_ms=eager_sum, **bd,
                              shape=f"M={BATCH}, (K,N) in (4096,4096),(4096,11008),"
                                    "(11008,4096), ms summed over the three")
    log(f"K3 sum of the three shapes: kernel {ms_sum:.4f} ms, plain {plain_sum:.4f} ms, "
        f"eager bf16 dequant (library) {eager_sum:.4f} ms, bound {bd['bound_ms']:.4f} ms "
        f"({bd['bound_by']})")
    rec.update(check_wwin_kernels(device, g))
    rec.update(check_nf4_kernels(device, g))
    rec.update(check_q4_kernels(device, g))
    rec.update(check_train_kernels(device, g))
    rec.update(check_xdecoder_kernels(device, g))
    rec.update(check_decode_kernels(device, g))
    return rec


def check_train_kernels(device, g):
    """Phase 3, the training kernels: K1-lse and K8 against ``mha_reference``
    (o within 1e-2 + 1e-2 |ref|: P and O round to bf16 at other places; the
    f32 lse within 2e-3), the autograd function's gradients against autograd
    through the plain version, the chunked backward's time at the train
    shape, and ``nf4_linear_planar_vjp``'s dx against the dense matmul."""
    import torch

    from cullavo_tpu_torch.models.llava.lora import dropout_mask
    from cullavo_tpu_torch.ops import flash_attention as fa
    from cullavo_tpu_torch.ops import nf4

    bf = torch.bfloat16
    sdpa_lib = torch.nn.functional.scaled_dot_product_attention   # a yardstick only
    rec = {}

    def qkv(B, H, T, S, d):
        return (torch.randn((B, T, H, d), generator=g, device=device).to(bf).transpose(1, 2),
                *(torch.randn((B, S, H, d), generator=g, device=device).to(bf).transpose(1, 2)
                  for _ in range(2)))

    def hold(name, got, want):
        (o, lse), (o_ref, lse_ref) = got, want
        torch.cuda.synchronize(device)
        err = (o.float() - o_ref.float()).abs().max().item()
        lerr = (lse - lse_ref).abs().max().item()
        log(f"{name}: o max_abs_err={err:.3e} (tol 1e-2 + 1e-2 |ref|), lse max_abs_err="
            f"{lerr:.3e} (f32, tol 2e-3)")
        if not (torch.isfinite(o).all() and torch.isfinite(lse).all()
                and torch.allclose(o.float(), o_ref.float(), rtol=1e-2, atol=1e-2)
                and torch.allclose(lse, lse_ref, rtol=1e-5, atol=2e-3)):
            raise RuntimeError(f"{name} disagrees with mha_reference: {err}, lse {lerr}")
        return err

    # K1-lse at the train shape
    B, H, T, d = TRAIN_CFG["BATCH_SIZE"], 32, TRAIN_T, 128
    q, k, v = qkv(B, H, T, T, d)
    got = fa._flash_cuda(q, k, v, None, None, True, True)
    err = hold(f"K1-lse flash_fwd_lse B={B} H={H} T={T} d={d}", got,
               fa.mha_reference(q, k, v, need_lse=True))
    if not torch.equal(got[0], fa.flash_attention(q, k, v)):
        raise RuntimeError("K1-lse and K1 give different outputs")
    ms = bench_ms(lambda: fa._flash_cuda(q, k, v, None, None, True, True), device)
    plain = bench_ms(lambda: fa.mha_reference(q, k, v, need_lse=True), device, reps=5)
    lib = bench_ms(lambda: sdpa_lib(q, k, v, is_causal=True), device)
    flops = 4 * B * H * T * T * d / 2
    bd = bound(nbytes(q, k, v, *got), flops, "bf16")
    log(f"K1-lse B={B} T={T}: kernel {ms:.4f} ms, plain {plain:.4f} ms, library sdpa {lib:.4f} "
        f"ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    rec["flash_fwd_lse"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, **bd,
                                shape=f"q/k/v [{B},{H},{T},{d}] bf16 causal + lse f32")

    # the backward of the autograd function at the train shape (plain
    # PyTorch in the port, as it is plain XLA in the JAX package)
    o, lse = got
    do = torch.randn((B, T, H, d), generator=g, device=device).to(bf).transpose(1, 2)
    bwd_ms = bench_ms(lambda: fa._flash_bwd(q, k, v, None, None, True, o, lse, do), device,
                      reps=5)
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
    lib_out = sdpa_lib(ql, kl, vl, is_causal=True)
    lib_bwd = bench_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True),
                       device, reps=5)
    plain_out = fa.mha_reference(ql, kl, vl)
    plain_bwd = bench_ms(lambda: torch.autograd.grad(plain_out, (ql, kl, vl), do,
                                                     retain_graph=True), device, reps=5)
    bd = bound(nbytes(q, k, v, o, lse, do, q, k, v), 2.5 * flops, "bf16")
    log(f"flash backward (chunked PyTorch) B={B} T={T}: {bwd_ms:.4f} ms, autograd through the "
        f"plain version {plain_bwd:.4f} ms, library sdpa backward {lib_bwd:.4f} ms, bound "
        f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    del ql, kl, vl, lib_out, plain_out, o, lse, do, got
    torch.cuda.empty_cache()

    # K8 at the probe shape: right padding (timed), left padding, S > T, non-causal
    B, H, T, d = PROBE_SHAPE
    for label, Tq, S, causal, left in (("right-padded", T, T, True, False),
                                       ("left-padded", T, T, True, True),
                                       ("S > T", 200, T, True, False),
                                       ("non-causal", T, T, False, False)):
        q, k, v = qkv(B, H, Tq, S, d)
        idx = torch.arange(S, device=device)[None, :].expand(B, S)
        valid = ((idx >= 7) if left else (idx < S - 7)).int()
        pos = (torch.cumsum(valid, dim=1) - 1).clamp_min(0)[:, S - Tq:].int()
        if left:   # key j sits at index j; the padded queries see no key
            pos = torch.where(valid[:, S - Tq:] != 0, idx[:, S - Tq:], -1).int()
        got = fa._flash_cuda(q, k, v, pos, valid, causal, True)
        want = fa.mha_reference(q, k, v, causal, pos, valid, need_lse=True)
        err = hold(f"K8 flash_rows {label} B={B} H={H} T={Tq} S={S}", got, want)
        if left and not ((got[1][:, :, :7] <= -1e29).all() and torch.allclose(
                got[0][:, :, 0].float(), v.float().mean(dim=2), atol=2e-2)):
            raise RuntimeError("K8: a wholly masked row is not the mean of v")
        if label != "right-padded":
            continue
        ms = bench_ms(lambda: fa._flash_cuda(q, k, v, pos, valid, causal, True), device)
        plain = bench_ms(lambda: fa.mha_reference(q, k, v, causal, pos, valid, need_lse=True),
                         device, reps=5)
        visible = (pos[:, :, None] >= idx[:, None, :]) & (valid != 0)[:, None, :]
        # rows with no visible key need every key (p = 1): there are none here
        n_pairs = int(visible.sum().item())
        lib = bench_ms(lambda: sdpa_lib(q, k, v, attn_mask=visible[:, None]), device)
        bd = bound(nbytes(q, k, v, *got, pos, valid), 4 * H * n_pairs * d, "bf16")
        log(f"K8 B={B} T={Tq}: kernel {ms:.4f} ms, plain {plain:.4f} ms, library sdpa (boolean "
            f"mask) {lib:.4f} ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}, "
            f"{n_pairs} visible pairs of {B * Tq * S})")
        rec["flash_rows"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, **bd,
                                 shape=f"q/k/v [{B},{H},{Tq},{d}] bf16, qpos [{B},{Tq}], "
                                       f"kvalid [{B},{S}], causal + lse f32")

    # dq, dk, dv of the autograd function against autograd through the plain version
    for label, masked in (("bias-free (K1-lse)", False), ("masked (K8)", True)):
        q, k, v = qkv(2, 8, 520, 520, d)
        do = torch.randn((2, 8, 520, d), generator=g, device=device).to(bf)
        idx = torch.arange(520, device=device)[None, :].expand(2, 520)
        valid = (idx >= 7).int() if masked else None
        pos = torch.where(valid != 0, idx, -1).int() if masked else None
        grads = []
        for fn in (fa.flash_attention, fa.mha_reference):
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            out = (fn(*leaves, pos, valid, True) if fn is fa.flash_attention
                   else fn(*leaves, True, pos, valid))
            grads.append(torch.autograd.grad(out, leaves, do))
        torch.cuda.synchronize(device)
        for name, a, b in zip(("dq", "dk", "dv"), *grads):
            err = (a.float() - b.float()).abs().max().item()
            top = b.float().abs().max().item()
            log(f"flash backward {label} {name}: max_abs_err={err:.3e}, max |ref| {top:.3f} "
                "(tol 2e-2 of the largest entry: P, dS and dO round to bf16)")
            if not (torch.isfinite(a).all() and err <= 2e-2 * top):
                raise RuntimeError(f"flash backward {label}: {name} disagrees: {err}")
        if masked and (grads[0][0][:, :, :7].any() or grads[0][1][:, :, :7].any()):
            raise RuntimeError("flash backward: a masked row or key got a gradient")

    # nf4_linear_planar_vjp: dx = dy.bf16 @ K7(q).T against the dense matmul
    M = TRAIN_CFG["BATCH_SIZE"] * TRAIN_T
    vjp = dict(ms=0.0, dense=0.0, n_bytes=0, n_ops=0)
    for K, N in NF4_SHAPES:
        qw = nf4.quantize_linear_planar(torch.randn((K, N), generator=g, device=device)
                                        * K ** -0.5)
        x = torch.randn((M, K), generator=g, device=device).to(bf).requires_grad_(True)
        dy = torch.randn((M, N), generator=g, device=device).to(bf)
        y = nf4.nf4_linear_planar_vjp(x, qw)
        dx, = torch.autograd.grad(y, x, dy, retain_graph=True)
        w = nf4.dequant_linear_planar(qw)
        ref = (dy.float() @ w.float().T)
        torch.cuda.synchronize(device)
        err = (dx.float() - ref).abs().max().item()
        log(f"nf4_linear_planar_vjp dx M={M} K={K} N={N}: max_abs_err={err:.3e}, max |dx| "
            f"{ref.abs().max().item():.3f} (tol 1e-2 + 1e-2 |ref|: one bf16 rounding)")
        if not torch.allclose(dx.float(), ref, rtol=1e-2, atol=1e-2):
            raise RuntimeError(f"nf4_linear_planar_vjp: dx disagrees at K={K} N={N}: {err}")
        vjp["ms"] += bench_ms(lambda: torch.autograd.grad(y, x, dy, retain_graph=True), device,
                              reps=5)
        vjp["dense"] += bench_ms(lambda: dy @ w.T, device, reps=5)
        vjp["n_bytes"] += nbytes(dy, qw["q4p"], qw["scale"], dx)
        vjp["n_ops"] += 2 * M * K * N
        del qw, x, dy, y, dx, w, ref
    bd = bound(vjp["n_bytes"], vjp["n_ops"], "bf16")
    log(f"nf4_linear_planar_vjp backward, sum of the three shapes at M={M}: K7 + matmul "
        f"{vjp['ms']:.4f} ms, the dense bf16 matmul alone {vjp['dense']:.4f} ms, bound "
        f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")

    # what a rematerialized layer pays again for its adapters: the seven
    # u = x @ a products (the JAX remat policy saves u) and the dropout masks
    u_ms, mask_ms = 0.0, 0.0
    for K, n_targets in ((4096, 6), (11008, 1)):     # q k v o gate up; down
        x = torch.randn((M, K), generator=g, device=device).to(bf)
        a = torch.randn((K, 64), generator=g, device=device).to(bf)
        u_ms += n_targets * bench_ms(lambda: x @ a, device, reps=5)
        mask_ms += n_targets * bench_ms(lambda: dropout_mask(x, 0.05, 1), device, reps=5)
    log(f"one layer's adapters at M={M}, r=64: the seven x @ a products {u_ms:.4f} ms, the "
        f"seven dropout masks {mask_ms:.4f} ms (both run again in the rematerialized backward)")
    torch.cuda.empty_cache()
    return rec


def msdeform_grid_sample(value, shapes, loc, att):
    """The reference's PyTorch composition of multi-scale deformable
    attention (one ``grid_sample`` per level, then the weighted sum): a
    yardstick timed here only, the port never calls it."""
    import torch
    import torch.nn.functional as F

    B, S, Hh, hd = value.shape
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    grids = (2 * loc - 1).to(value.dtype)
    sampled, start = [], 0
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w].flatten(2).transpose(1, 2).reshape(B * Hh, hd, h, w)
        start += h * w
        sampled.append(F.grid_sample(v, grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1),
                                     mode="bilinear", padding_mode="zeros", align_corners=False))
    a = att.transpose(1, 2).reshape(B * Hh, 1, Q, L * P)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * a).sum(-1)
    return out.view(B, Hh * hd, Q).transpose(1, 2)


def focal_chain_cudnn(ctx, gates, level_weights, H, W, kernels):
    """The FocalNet model's own chain in the working dtype: cuDNN's
    depthwise ``conv2d(groups=C)``, tanh GELU, gates, the global term, the
    scaling (what JAX's XLA branch computes at bf16): a yardstick timed
    here only, the port never calls it."""
    import torch
    import torch.nn.functional as F

    B, C, _ = ctx.shape
    L = len(kernels)
    x = ctx.reshape(B, C, H, W)
    g = gates.reshape(B, L + 1, H, W)
    acc = torch.zeros_like(x)
    for lvl, w in enumerate(level_weights):
        x = F.gelu(F.conv2d(x, w, padding=w.shape[-1] // 2, groups=C), approximate="tanh")
        acc = acc + x * g[:, lvl:lvl + 1]
    acc = acc + F.gelu(x.mean((2, 3), keepdim=True), approximate="tanh") * g[:, L:L + 1]
    return (acc / (L + 1)).reshape(B, C, H * W)


def check_xdecoder_kernels(device, g):
    """Phase 3, the X-Decoder kernels.  K9 (multi-scale deformable
    attention) at the deformable encoder's shape at a 512^2 image (B 8, S = Q
    = 64^2 + 32^2 + 16^2, 8 heads x 64, 3 levels x 4 points), at the 512 x 640
    bucket's non-square levels and at a Q that fills no tile; points drawn
    in [-0.1, 1.1] (some outside every map).  K10 (the gated focal context)
    at each FocalNet-L stage at a 512^2 image, batch 8, both GELU forms.
    Both within 1e-2 + 1e-2 |ref| of the plain version in bf16 (one
    rounding of the output) and within 1e-5 + 1e-5 |ref| in f32 (sums in
    another order: the plain focal chain runs on cuDNN)."""
    import torch

    from cullavo_tpu_torch.models.xdecoder.focalnet import FocalNetConfig
    from cullavo_tpu_torch.ops import focal, msdeform

    bf, f32 = torch.bfloat16, torch.float32
    rec = {}

    def hold(name, got, ref, dtype):
        torch.cuda.synchronize(device)
        err = (got.float() - ref.float()).abs().max().item()
        tol = (1e-5, 1e-5) if dtype == f32 else (1e-2, 1e-2)
        log(f"{name}: max_abs_err={err:.3e} (tol {tol[0]:g} + {tol[1]:g} |ref|)")
        if not (got.dtype == dtype and torch.isfinite(got).all()
                and torch.allclose(got.float(), ref.float(), atol=tol[0], rtol=tol[1])):
            raise RuntimeError(f"{name} disagrees with its plain version: {err}")
        return err

    # K9
    side = XDEC_SIDE // 8
    path_shapes = ((side // 4, side // 4), (side // 2, side // 2), (side, side))
    bucket_shapes = ((16, 20), (32, 40), (64, 80))
    Hh, hd, P = 8, 64, 4

    def deform_case(shapes, B, Q, dtype):
        S, L = sum(h * w for h, w in shapes), len(shapes)
        value = torch.randn((B, S, Hh, hd), generator=g, device=device).to(dtype)
        loc = torch.rand((B, Q, Hh, L, P, 2), generator=g, device=device) * 1.2 - 0.1
        att = torch.softmax(torch.randn((B, Q, Hh, L * P), generator=g, device=device), -1)
        return value, loc, att.reshape(B, Q, Hh, L, P).to(dtype)

    errs = []
    S_path = sum(h * w for h, w in path_shapes)
    for shapes, B, Q in ((path_shapes, XDEC_BATCH, S_path), (bucket_shapes, 2, 6720),
                         (path_shapes, 2, 3001)):
        for dtype in (bf, f32):
            value, loc, att = deform_case(shapes, B, Q, dtype)
            got = msdeform.ms_deform_attn_kernel(value, shapes, loc, att)
            ref = msdeform.ms_deform_attn(value, shapes, loc, att)
            errs.append(hold(f"K9 ms_deform_attn levels {shapes} B={B} Q={Q} {dtype}", got, ref,
                             dtype))
            if dtype == f32 and Q == S_path:
                lib_out = msdeform_grid_sample(value, shapes, loc, att)
                if not torch.allclose(lib_out, ref, atol=1e-4, rtol=1e-4):
                    raise RuntimeError("the grid_sample yardstick disagrees with the plain version")
    value, loc, att = deform_case(path_shapes, XDEC_BATCH, S_path, bf)
    out = msdeform.ms_deform_attn_kernel(value, path_shapes, loc, att)
    ms = bench_ms(lambda: msdeform.ms_deform_attn_kernel(value, path_shapes, loc, att), device)
    plain = bench_ms(lambda: msdeform.ms_deform_attn(value, path_shapes, loc, att), device)
    lib = bench_ms(lambda: msdeform_grid_sample(value, path_shapes, loc, att), device)
    # the least work: per sampling point and channel 4 corner multiply-adds,
    # the attention weight folded into the corner weights (f32)
    points = XDEC_BATCH * S_path * Hh * len(path_shapes) * P
    bd = bound(nbytes(value, loc, att, out), 2 * 4 * hd * points, "f32")
    log(f"K9 B={XDEC_BATCH} Q=S={S_path}: kernel {ms:.4f} ms, plain {plain:.4f} ms, grid_sample "
        f"yardstick {lib:.4f} ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}, "
        f"{nbytes(value, loc, att, out) / 1e6:.1f} MB)")
    rec["ms_deform_attn"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain, library_ms=lib, **bd,
        shape=f"value [{XDEC_BATCH},{S_path},{Hh},{hd}] bf16, levels {path_shapes}, "
              f"loc [{XDEC_BATCH},{S_path},{Hh},3,{P},2] f32, one launch (6 per forward); "
              "library_ms: one grid_sample per level + weighted sum")

    # K10: one launch per FocalNet-L block, stage by stage
    fcfg = FocalNetConfig()
    kernels = tuple(fcfg.focal_factor * lvl + fcfg.focal_windows[0]
                    for lvl in range(fcfg.focal_levels[0]))
    L, taps_per = len(kernels), sum(k * k for k in kernels)
    errs, tot = [], dict(ms=0.0, plain=0.0, lib=0.0, bytes=0, ops=0)
    for i, depth in enumerate(fcfg.depths):
        C, s = fcfg.num_features[i], XDEC_SIDE // 4 // 2 ** i
        for dtype in (f32, bf):
            fx = torch.randn((XDEC_BATCH, 2 * C + L + 1, s * s), generator=g,
                             device=device).to(dtype)
            # taps of std 0.6 / k: every level's output stays of order one
            taps = torch.cat([torch.randn((C, k * k), generator=g, device=device) * (0.6 / k)
                              for k in kernels], dim=1)
            ctx, gates = fx[:, C:2 * C], fx[:, 2 * C:]       # views, as focal_modulation passes
            for approximate in (True, False):
                got = focal.focal_ctx_kernel(ctx, gates, taps, s, s, kernels, True, approximate)
                ref = focal.focal_ctx_plain(ctx, gates, taps, s, s, kernels, True, approximate)
                errs.append(hold(f"K10 focal_ctx stage {i + 1} [{XDEC_BATCH},{C},{s}x{s}] {dtype} "
                                 f"{'tanh' if approximate else 'erf'}", got, ref, dtype))
        cols = [sum(kk * kk for kk in kernels[:j]) for j in range(L + 1)]
        weights = [taps[:, cols[j]:cols[j + 1]].to(bf).reshape(C, 1, k, k)
                   for j, k in enumerate(kernels)]
        ms = bench_ms(lambda: focal.focal_ctx_kernel(ctx, gates, taps, s, s, kernels, True, True),
                      device)
        plain = bench_ms(lambda: focal.focal_ctx_plain(ctx, gates, taps, s, s, kernels, True, True),
                         device)
        lib = bench_ms(lambda: focal_chain_cudnn(ctx, gates, weights, s, s, kernels), device)
        ops = 2 * taps_per * XDEC_BATCH * C * s * s
        n_bytes = nbytes(ctx, gates, taps, got)
        bd = bound(n_bytes, ops, "f32")
        log(f"K10 stage {i + 1} (x{depth} blocks): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"cuDNN chain {lib:.4f} ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
        tot = dict(ms=tot["ms"] + depth * ms, plain=tot["plain"] + depth * plain,
                   lib=tot["lib"] + depth * lib, bytes=tot["bytes"] + depth * n_bytes,
                   ops=tot["ops"] + depth * ops)
    bd = bound(tot["bytes"], tot["ops"], "f32")
    log(f"K10 one FocalNet-L forward ({sum(fcfg.depths)} launches): kernel {tot['ms']:.4f} ms, "
        f"plain {tot['plain']:.4f} ms, cuDNN chain {tot['lib']:.4f} ms, bound "
        f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}, {tot['ops'] / 1e9:.1f} GFLOP)")
    rec["focal_ctx"] = dict(
        max_abs_err=max(errs), ms=tot["ms"], plain_ms=tot["plain"], library_ms=tot["lib"], **bd,
        shape=f"FocalNet-L at {XDEC_SIDE}^2, batch {XDEC_BATCH}, bf16, tanh GELU, L=4 (k 3-9): "
              "ms summed over one forward's 24 launches (2, 2, 18, 2 blocks at C 192-1536); "
              "library_ms: the cuDNN depthwise conv2d chain in bf16")
    return rec


def check_nf4_kernels(device, g):
    """Phase 3, K6 and K7: the planar NF4 kernels against their plain
    versions at the three 7B weight shapes.  K7 bit for bit.  K6 at M = 1,
    14, 64, 256, 511 within 1e-2 + 1e-2 |ref| on the bf16 output (one bf16
    ulp, 2^-8 relative, plus the f32 sums taken in another order); its time
    is the sum over the three shapes at the serving decode M (16 slots x
    spec_k 4), K7's the widest shape's."""
    import torch

    from cullavo_tpu_torch.ops import nf4

    bf = torch.bfloat16
    k6 = dict(err=0.0, ms=0.0, plain=0.0, dense=0.0, n_bytes=0, n_ops=0)
    rec = {}
    for K, N in NF4_SHAPES:
        w = torch.randn((K, N), generator=g, device=device) * K ** -0.5
        q = nf4.quantize_linear_planar(w)
        dense = nf4.nf4_dequant_planar(q)
        ref_w = nf4.dequant_linear_planar(q)
        torch.cuda.synchronize(device)
        n_bad = int((dense.view(torch.int16) != ref_w.view(torch.int16)).sum().item())
        qerr = (ref_w.float() - w).abs().max().item()
        log(f"K7 nf4_dequant_planar K={K} N={N}: mismatching bf16 values={n_bad} "
            f"(bit-equal demanded); NF4 rounding of the random weight {qerr:.3e}")
        if n_bad or dense.shape != (K, N):
            raise RuntimeError(f"K7 disagrees with dequant_linear_planar at K={K} N={N}")
        ms = bench_ms(lambda: nf4.nf4_dequant_planar(q), device)
        plain = bench_ms(lambda: nf4.dequant_linear_planar(q), device, reps=5)
        # one f32 multiply per weight; no PyTorch call takes planar NF4 words
        bd = bound(nbytes(q["q4p"], q["scale"], dense), K * N, "f32")
        log(f"K7 K={K} N={N}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
            f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}, "
            f"{nbytes(q['q4p'], q['scale'], dense) / 1e6:.1f} MB)")
        if (K, N) == NF4_SHAPES[1]:
            rec["nf4_dequant_planar"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                                             library_ms=None, **bd,
                                             shape=f"q4p [{K // 8},{N}] int32 + scale "
                                                   f"[{K},{N // 64}] f32 -> [{K},{N}] bf16")
        for M in (1, 14, SERVE_DECODE_M, 256, 511):
            x = torch.randn((M, K), generator=g, device=device).to(bf)
            y = nf4.nf4_linear_planar(x, q)
            ref = nf4._nf4_linear_planar_plain(x, q)
            torch.cuda.synchronize(device)
            diff = (y.float() - ref.float()).abs()
            err = diff.max().item()
            excess = (diff - 1e-2 - 1e-2 * ref.float().abs()).max().item()
            log(f"K6 nf4_linear_planar M={M} K={K} N={N}: max_abs_err={err:.3e} "
                f"(max |y| {ref.float().abs().max().item():.3f}; tol 1e-2 + 1e-2 |ref|, "
                f"worst excess {excess:.3e})")
            if not (torch.isfinite(y).all() and excess <= 0):
                raise RuntimeError(f"K6 disagrees with its plain version at M={M} K={K} N={N}")
            k6["err"] = max(k6["err"], err)
            if M != SERVE_DECODE_M:
                continue
            ms = bench_ms(lambda: nf4.nf4_linear_planar(x, q), device)
            plain = bench_ms(lambda: nf4._nf4_linear_planar_plain(x, q), device, reps=5)
            # a yardstick only: the dense bf16 product reads 3.6x the bytes
            dense_ms = bench_ms(lambda: x @ dense, device)
            log(f"K6 M={M} K={K} N={N}: kernel {ms:.4f} ms, plain {plain:.4f} ms, dense bf16 "
                f"torch.matmul on the dequantized weight {dense_ms:.4f} ms, 4-bit weight "
                f"bytes {nbytes(q['q4p'], q['scale']) / 1e6:.1f} MB")
            k6["ms"], k6["plain"], k6["dense"] = (k6["ms"] + ms, k6["plain"] + plain,
                                                  k6["dense"] + dense_ms)
            k6["n_bytes"] += nbytes(x, q["q4p"], q["scale"], y)
            k6["n_ops"] += 2 * M * K * N
        del w, q, dense, ref_w
    bd = bound(k6["n_bytes"], k6["n_ops"], "bf16")
    log(f"K6 sum of the three shapes at M={SERVE_DECODE_M}: kernel {k6['ms']:.4f} ms, plain "
        f"{k6['plain']:.4f} ms, dense bf16 matmul {k6['dense']:.4f} ms, bound "
        f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}, {k6['n_bytes'] / 1e6:.1f} MB)")
    rec["nf4_linear_planar"] = dict(max_abs_err=k6["err"], ms=k6["ms"], plain_ms=k6["plain"],
                                    library_ms=None, **bd,
                                    shape=f"M={SERVE_DECODE_M}, (K,N) in (4096,4096),"
                                          "(4096,11008),(11008,4096), ms summed over the three")
    torch.cuda.empty_cache()
    return rec


def check_q4_kernels(device, g):
    """Phase 3, K11: the byte-packed NF4 kernel against its plain versions at
    the three 7B weight shapes.  The dequant entry bit for bit against
    ``dequant_linear``; the fused entry at M = 1, 14, 64, 256, 511 within
    1e-2 + 1e-2 |ref| of the f32 plain version (the kernel takes the f32
    weight as two bf16 terms, 2^-17 relative, and sums in another order;
    both sides round once to bf16, so they differ by one ulp); row 8's
    form: ``quantize_nf4`` of the same weight, its absmax decoded on the card,
    through K11, against ``dequantize_nf4`` + an f32 product.  Timed at
    M = 14 (the greedy batch's decode, the JSON record) and M = 64, summed
    over the three shapes, beside the bound and a yardstick: the dense bf16
    ``torch.matmul`` on the dequantized weight (no PyTorch call takes
    byte-packed NF4)."""
    import torch

    from cullavo_tpu_torch.ops import nf4

    bf = torch.bfloat16
    timed = {M: dict(ms=0.0, plain=0.0, dense=0.0, n_bytes=0, n_ops=0) for M in (BATCH, 64)}
    row8 = dict(err=0.0, ms=0.0, k11=0.0, plain=0.0, n_bytes=0, n_ops=0)
    err, rec = 0.0, {}
    for K, N in NF4_SHAPES:
        w = torch.randn((K, N), generator=g, device=device) * K ** -0.5
        q = nf4.quantize_linear(w)
        dense = nf4.nf4_dequant_q4(q, K)
        ref_w = nf4.dequant_linear(q, K, N)
        torch.cuda.synchronize(device)
        n_bad = int((dense.view(torch.int16) != ref_w.view(torch.int16)).sum().item())
        log(f"K11 nf4_dequant_q4 K={K} N={N}: mismatching bf16 values={n_bad} (bit-equal "
            "demanded)")
        if n_bad or dense.shape != (K, N):
            raise RuntimeError(f"K11 dequant disagrees with dequant_linear at K={K} N={N}")
        if (K, N) == NF4_SHAPES[1]:
            ms = bench_ms(lambda: nf4.nf4_dequant_q4(q, K), device)
            plain = bench_ms(lambda: nf4.dequant_linear(q, K, N), device, reps=5)
            bd = bound(nbytes(q["q4"], q["scale"], dense), K * N, "f32")
            log(f"K11 dequant K={K} N={N}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
                f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
            rec["nf4_dequant_q4"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, library_ms=None,
                                         **bd, shape=f"q4 [{K},{N // 2}] uint8 + scale "
                                                     f"[{K},{N // 64}] f32 -> [{K},{N}] bf16")
        for M in (1, BATCH, 64, 256, 511):
            x = torch.randn((M, K), generator=g, device=device).to(bf)
            y = nf4.nf4_linear_q4(x, q, K)
            ref = nf4._nf4_linear_q4_plain(x, q, K, N)
            torch.cuda.synchronize(device)
            diff = (y.float() - ref.float()).abs()
            excess = (diff - 1e-2 - 1e-2 * ref.float().abs()).max().item()
            log(f"K11 nf4_linear_q4 M={M} K={K} N={N}: max_abs_err={diff.max().item():.3e} (max "
                f"|y| {ref.float().abs().max().item():.3f}; tol 1e-2 + 1e-2 |ref|, worst excess "
                f"{excess:.3e})")
            if not (torch.isfinite(y).all() and excess <= 0):
                raise RuntimeError(f"K11 disagrees with its plain version at M={M} K={K} N={N}")
            err = max(err, diff.max().item())
            if M not in timed:
                continue
            ms = bench_ms(lambda: nf4.nf4_linear_q4(x, q, K), device)
            plain = bench_ms(lambda: nf4._nf4_linear_q4_plain(x, q, K, N), device, reps=5)
            dense_ms = bench_ms(lambda: x @ dense, device)
            log(f"K11 M={M} K={K} N={N}: kernel {ms:.4f} ms, plain {plain:.4f} ms, dense bf16 "
                f"torch.matmul on the dequantized weight {dense_ms:.4f} ms")
            t = timed[M]
            t["ms"], t["plain"], t["dense"] = t["ms"] + ms, t["plain"] + plain, t["dense"] + dense_ms
            t["n_bytes"] += nbytes(x, q["q4"], q["scale"], y)
            t["n_ops"] += 2 * M * K * N
        # row 8: an NF4Tensor (double-quantized absmax) through the same kernel
        t8 = nf4.quantize_nf4(w)
        x = torch.randn((BATCH, K), generator=g, device=device).to(bf)
        y8 = nf4.nf4_matmul_fused(x, t8)
        ref8 = (x.float() @ nf4.dequantize_nf4(t8, torch.float32)).to(bf)
        torch.cuda.synchronize(device)
        d8 = (y8.float() - ref8.float()).abs()
        excess = (d8 - 1e-2 - 1e-2 * ref8.float().abs()).max().item()
        log(f"K11 as row 8 (nf4_matmul_fused, NF4Tensor, absmax decoded on the card) M={BATCH} "
            f"K={K} N={N}: max_abs_err={d8.max().item():.3e} (worst excess {excess:.3e})")
        if not (torch.isfinite(y8).all() and excess <= 0):
            raise RuntimeError(f"row 8 through K11 disagrees with dequantize_nf4 at K={K} N={N}")
        row8["err"] = max(row8["err"], d8.max().item())
        row8["ms"] += bench_ms(lambda: nf4.nf4_matmul_fused(x, t8), device)
        absmax8 = nf4._decode_absmax(t8)
        row8["k11"] += bench_ms(lambda: nf4._nf4_q4_cuda("nf4_matmul_fused", x, t8.packed,
                                                          absmax8, K, N), device)
        row8["plain"] += bench_ms(
            lambda: (x.float() @ nf4.dequantize_nf4(t8, torch.float32)).to(bf), device, reps=5)
        row8["n_bytes"] += nbytes(x, t8.packed, t8.absmax, t8.absmax_scale, t8.absmax_offset, y8)
        row8["n_ops"] += 2 * BATCH * K * N
        del w, q, dense, ref_w, t8
    for M, t in timed.items():
        bd = bound(t["n_bytes"], t["n_ops"], "bf16")
        log(f"K11 sum of the three shapes at M={M}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain']:.4f} ms, dense bf16 matmul {t['dense']:.4f} ms, bound "
            f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}, {t['n_bytes'] / 1e6:.1f} MB)")
    bd = bound(row8["n_bytes"], row8["n_ops"], "bf16")
    log(f"K11 as row 8, sum of the three shapes at M={BATCH} (absmax decode included): "
        f"{row8['ms']:.4f} ms (K11 alone {row8['k11']:.4f} ms), plain (dequantize_nf4 + f32 "
        f"product) {row8['plain']:.4f} ms, "
        f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}, {row8['n_bytes'] / 1e6:.1f} MB), "
        f"max_abs_err {row8['err']:.3e}")
    t = timed[BATCH]
    rec["nf4_linear_q4"] = dict(max_abs_err=max(err, row8["err"]), ms=t["ms"], plain_ms=t["plain"],
                                library_ms=None, **bound(t["n_bytes"], t["n_ops"], "bf16"),
                                shape=f"M={BATCH}, (K,N) in (4096,4096),(4096,11008),"
                                      "(11008,4096), ms summed over the three")
    torch.cuda.empty_cache()
    return rec


def check_wwin_kernels(device, g):
    """Phase 3, K4 and K5: the cache part of the W-window decode attention
    against its plain version, over a stacked 32-layer cache at the paths'
    shapes: decode windows of W = 1 and 4 over the batch of 14 (S = 768 for
    the speculative batch, a 664-slot view for the plain greedy batch;
    per-row valid lengths, one row with no valid slot), and the serving
    engine's suffix prefills, W = 32, 64 and 128 over a prefill chunk of 4
    rows whose cache is gated to the shared 608-token prefix, as
    ``generate_prefill_prefix`` gates it.  acc within 2e-3 relative +
    2^-8 * l (the kernel rounds each probability to bf16 against its warp's
    running maximum, the plain version against the final one), m and l
    within 2e-3 relative, the merged bf16 output within 1e-2 + 1e-2 |ref|
    (one bf16 ulp)."""
    import torch

    from cullavo_tpu_torch.models.llava.llama import quantize_kv, round_cache_len
    from cullavo_tpu_torch.ops import wwin_decode as ww

    bf = torch.bfloat16
    L, B, KV, hd = 32, BATCH, 32, 128
    T = PAD_TO * -(-(1 + 576 + PROMPT_TEXT) // PAD_TO)
    S_spec, S_plain = round_cache_len(T + NEW_TOKENS + SPEC_K), T + NEW_TOKENS
    scale = hd ** -0.5
    cache = {"k": torch.empty((L, S_spec, B, KV, hd), dtype=bf, device=device),
             "v": torch.empty((L, S_spec, B, KV, hd), dtype=bf, device=device)}
    q8 = {name: torch.empty((L, S_spec, B, KV, hd), dtype=torch.int8, device=device)
          for name in ("k", "v")}
    q8.update({name: torch.empty((L, S_spec, B, KV), dtype=bf, device=device)
               for name in ("k_s", "v_s")})
    for li in range(L):   # layer by layer: the f32 draws of a whole cache would be 11 GB
        for name in ("k", "v"):
            cache[name][li] = torch.randn((S_spec, B, KV, hd), generator=g, device=device)
            q8[name][li], q8[name + "_s"][li] = quantize_kv(cache[name][li])
    masked_row = 3
    n_valid = torch.randint(T - 7, T + NEW_TOKENS, (B,), generator=g, device=device)
    n_valid[masked_row] = 0                                  # a row with no valid slot
    # a suffix prefill: every row of the chunk reads the same stored prefix
    B_sfx = SERVE_CFG["PREFILL_CHUNK"]
    prefix_len = (1 + SERVE_HEAD_TEXT + 576 + SERVE_SHARED_TEXT) // 32 * 32
    n_valid_sfx = torch.full((B_sfx,), prefix_len, device=device)

    def window(W, S, n_val):
        Bw = n_val.shape[0]
        q = torch.randn((Bw, W, KV, hd), generator=g, device=device).to(bf).transpose(1, 2)
        k_cur, v_cur = (torch.randn((Bw, KV, W, hd), generator=g, device=device).to(bf)
                        for _ in range(2))
        ok = torch.arange(S, device=device)[None, :] < n_val[:, None]
        bias = torch.where(ok, 0.0, ww.NEG_INF)[:, None, None, :].expand(Bw, 1, W, S).contiguous()
        return q, k_cur, v_cur, bias

    def partial_err(got, want, masked):
        (acc, m, l), (acc_r, m_r, l_r) = got, want
        for name, a, r in (("m", m, m_r), ("l", l, l_r)):
            if not torch.allclose(a, r, rtol=2e-3, atol=1e-3):
                raise RuntimeError(f"{name} disagrees: {(a - r).abs().max().item()}")
        excess = (acc - acc_r).abs() - 2e-3 * acc_r.abs() - 2.0 ** -8 * l_r[..., None]
        if not (excess <= 0).all() or (masked is not None
                                       and (acc[masked].any() or l[masked].any())):
            raise RuntimeError(f"acc disagrees: excess {excess.max().item()}")
        return (acc - acc_r).abs().max().item()

    cases = [(W, S, False) for S in (S_spec, S_plain) for W in (1, SPEC_K)]
    cases += [(W, S_spec, True) for W in SERVE_SUFFIX_W]

    rec = {}
    for name, kernel, plain, wrapper, tensors in (
            ("wwin_decode", ww._run_cache_part, ww._cache_part_plain, ww.wwin_decode_smajor,
             (cache["k"], cache["v"])),
            ("wwin_decode_q8", ww._run_cache_part_q8, ww._cache_part_q8_plain,
             ww.wwin_decode_smajor_q8, (q8["k"], q8["k_s"], q8["v"], q8["v_s"]))):
        worst = 0.0
        # the suffix prefill's cache: a dense copy of the prefix for each chunk row
        sfx_tensors = tuple(t[:, :, :B_sfx].contiguous() for t in tensors)
        for W, S, suffix in cases:
            n_val, masked = (n_valid_sfx, None) if suffix else (n_valid, masked_row)
            Bw = n_val.shape[0]
            # S = 664: a strided view
            ops = sfx_tensors if suffix else tuple(t[:, :S] for t in tensors)
            q, k_cur, v_cur, bias = window(W, S, n_val)
            win = None
            if name == "wwin_decode_q8" and W > 1:
                win = (*quantize_kv(k_cur.permute(2, 0, 1, 3)),
                       *quantize_kv(v_cur.permute(2, 0, 1, 3)))
            for li in (0, L // 2, L - 1) if S == S_spec else (L - 1,):
                got = kernel(q, *ops, li, bias[:, 0], 1, scale)
                want = plain(q, *ops, li, bias[:, 0], 1, scale)
                torch.cuda.synchronize(device)
                acc_err = partial_err(got, want, masked)
                kw = {} if win is None else {"win_q8": win}
                out = wrapper(q, *ops, li, k_cur, v_cur, bias, **kw)
                ref = ww._merge_self_window(q, k_cur, v_cur, *want, scale, **kw)
                torch.cuda.synchronize(device)
                err = (out.float() - ref.float()).abs().max().item()
                worst = max(worst, err)
                log(f"{name} B={Bw} W={W} S={S} li={li}: acc max_abs_err={acc_err:.3e} (tol 2e-3 "
                    f"rel + 2^-8 l), merged bf16 output max_abs_err={err:.3e} (tol 1e-2 + 1e-2 "
                    "|ref|)")
                if not (torch.isfinite(out).all()
                        and torch.allclose(out.float(), ref.float(), rtol=1e-2, atol=1e-2)):
                    raise RuntimeError(f"{name} disagrees with its plain version: {err}")
            # what this run's data needs: the valid slots' k and v (and scale
            # planes), q, bias and the partials; 4 operations per q.k and p.v term
            n_slots = int(n_val.clamp_max(S).sum().item())
            esz = tensors[0].element_size()
            need = (2 * n_slots * KV * hd * esz + (4 * n_slots * KV if len(tensors) == 4 else 0)
                    + nbytes(q, bias[:, 0], *got))
            bd = bound(need, 4 * n_slots * KV * W * hd, "bf16")
            li = L // 2
            ms = bench_ms(lambda: kernel(q, *ops, li, bias[:, 0], 1, scale), device)
            plain_ms = bench_ms(lambda: plain(q, *ops, li, bias[:, 0], 1, scale), device)
            lib = None
            if name == "wwin_decode":
                # a yardstick timed here only (the port never calls it): the
                # normalised cache-only attention over the layer's slice
                kl, vl = (t[li].permute(1, 2, 0, 3) for t in ops)
                lib = bench_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, kl, vl, attn_mask=bias), device)
            log(f"{name} B={Bw} W={W} S={S}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                f"sdpa {'none' if lib is None else f'{lib:.4f} ms'}, bound {bd['bound_ms']:.4f} ms "
                f"({bd['bound_by']}, {need / 1e6:.1f} MB needed)")
            # the record keeps each kernel at the shape its main path gives it:
            # K4 the plain greedy step (W = 1, S = 664), K5 the speculative window
            if (W, S, suffix) == ((1, S_plain, False) if name == "wwin_decode"
                                  else (SPEC_K, S_spec, False)):
                rec[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib, **bd,
                                 shape=f"q [{B},{KV},{W},{hd}] bf16, cache [{L},{S},{B},{KV},{hd}] "
                                       f"{str(tensors[0].dtype).split('.')[1]}, one layer")
        rec[name]["max_abs_err"] = worst
        del sfx_tensors, ops
    del cache, q8
    torch.cuda.empty_cache()
    return rec


def check_decode_kernels(device, g):
    """Phase 3, K12 (one-token decode attention) against its plain version
    on the same inputs.  Row 5's form through ``flash_decode``'s mask
    (``kv_valid[b, s] & s <= q_position[b]`` as an additive bias): the
    LLaMA-7B decode shape [14, 32, 768, 128] bf16 with KV = H, a GQA case
    with KV = 8, S = 700 (not a multiple of 128) and a wholly masked row
    at S = 768 (the mean of v).  The zoo's forms through
    ``sdpa_decode_stale`` (the current token merged in f32) against
    ``sdpa_decode_stale_plain`` (JAX's arithmetic), each over a layer of
    the stacked f32 cache read in place: T5-XL's decoder (5 beams, 32
    heads, S = 11, d = 64, scale 1, a per-head relative bias + the causal
    mask, ``self_bias``) and KOSMOS-2's (1 row, 32 heads, S = its longest
    prompt + 10, d = 64, scaled, a key-validity mask) at the first, a middle
    and the last decode step.  Tolerances: 1e-5 + 1e-5 |ref| in f32 and
    1e-2 + 1e-2 |ref| in bf16 (the plain version widens the same inputs to
    f32 and sums in another order; in bf16 the output rounds once, at up to
    one ulp).  Timed at the 7B shape with every key valid beside the plain
    version, the bound (the valid cache bytes over 3.35 TB/s) and
    ``scaled_dot_product_attention`` with a boolean mask (a yardstick the
    port never calls); and at the zoo's shapes."""
    import torch

    from cullavo_tpu_torch.data.tokenizer import ByteTokenizer
    from cullavo_tpu_torch.models.llava.llama import sdpa_decode_stale, sdpa_decode_stale_plain
    from cullavo_tpu_torch.ops import flash_attention as fa
    from cullavo_tpu_torch.pipelines.vl_zoo_pipeline import MODEL_SPECS

    bf, f32 = torch.bfloat16, torch.float32
    tols = {f32: 1e-5, bf: 1e-2}

    def hold(label, got, want, dtype):
        err = (got.float() - want.float()).abs().max().item()
        log(f"K12 {label}: max_abs_err={err:.3e} (tol {tols[dtype]:g} + {tols[dtype]:g} |ref|)")
        if not (torch.isfinite(got).all()
                and torch.allclose(got.float(), want.float(), atol=tols[dtype],
                                   rtol=tols[dtype])):
            raise RuntimeError(f"K12 disagrees with its plain version at {label}: {err}")
        return err

    def partials(label, q, k, v, bias, scale):
        """K12 against the plain version: o within the tolerance, m and l
        within 1e-5 relative (one f32 rounding of the dot each)."""
        B, H, S = q.shape[0], q.shape[1], k.shape[2]
        got = fa.decode_partials(q, k, v, bias, scale)
        want = fa._decode_partials_plain(q, k, v, bias.float().expand(B, H, S), scale)
        torch.cuda.synchronize(device)
        for name, a, r in zip("ml", got[1:], want[1:]):
            if not torch.allclose(a, r, atol=1e-5, rtol=1e-5):
                raise RuntimeError(f"K12 {name} disagrees at {label}: {(a - r).abs().max()}")
        return hold(label, got[0], want[0], q.dtype), got, want

    worst = 0.0
    B, H, S, d = BATCH, 32, 768, 128
    for KV, S_case, masked in ((32, S, False), (8, S, False), (32, 700, False), (32, S, True)):
        q = torch.randn((B, H, 1, d), generator=g, device=device).to(bf)
        k, v = (torch.randn((B, KV, S_case, d), generator=g, device=device).to(bf)
                for _ in range(2))
        pos = torch.randint(S_case // 2, S_case, (B,), generator=g, device=device)
        valid = (torch.rand((B, S_case), generator=g, device=device) > 0.05).to(torch.int32)
        if masked:
            pos[5] = -1                                  # row 5 sees no key
        label = f"flash_decode [{B},{H}/{KV},{S_case},{d}] bf16" + (" masked row" if masked else "")
        err, _, want = partials(label, q, k, v, fa.decode_bias(pos, valid), d ** -0.5)
        out = fa.flash_decode(q, k, v, pos, valid)
        worst = max(worst, err, hold(label + " (entry)", out[:, :, 0], want[0], bf))
        if masked and not torch.allclose(out[5, :, 0].float(), v[5].float().mean(dim=1),
                                         atol=1e-2, rtol=1e-2):
            raise RuntimeError("K12: the wholly masked row is not the mean of v")

    # timing at the 7B decode shape, every key valid (the bound's bytes)
    q = torch.randn((B, H, 1, d), generator=g, device=device).to(bf)
    k, v = (torch.randn((B, H, S, d), generator=g, device=device).to(bf) for _ in range(2))
    valid = torch.ones((B, S), dtype=torch.int32, device=device)
    pos = torch.full((B,), S - 1, device=device)
    bias = fa.decode_bias(pos, valid)
    err, got, _ = partials(f"timing case [{B},{H},{S},{d}] bf16", q, k, v, bias, d ** -0.5)
    worst = max(worst, err)
    ms = bench_ms(lambda: fa.decode_partials(q, k, v, bias, d ** -0.5), device)
    plain = bench_ms(lambda: fa._decode_partials_plain(q, k, v, bias.expand(B, H, S), d ** -0.5),
                     device)
    mask = (bias == 0)[:, :, None, :]                      # [B, 1, 1, S] boolean
    lib = bench_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), device)
    bd = bound(nbytes(q, k, v, bias, *got), 4 * B * H * S * d, "bf16")
    log(f"K12 [{B},{H},{S},{d}] bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms, library sdpa "
        f"(boolean mask) {lib:.4f} ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}, "
        f"{nbytes(k, v) / 1e6:.1f} MB of cache)")
    rec = dict(ms=ms, plain_ms=plain, library_ms=lib, **bd,
               shape=f"q [{B},{H},1,{d}], k/v [{B},{H},{S},{d}] bf16, every key valid")
    del q, k, v, bias, got, mask

    # the zoo's forms, over one layer of a stacked f32 cache
    tok = ByteTokenizer()
    prompt = 1 + 64 + max(len(tok.encode(MODEL_SPECS["kosmos2"].prompt.format(q=x)))
                          for x in VL_QUESTION_TEXT)
    for name, Bz, Sz, n0, scale, t5 in (("T5-XL decoder", ZOO_BEAMS, ZOO_NEW + 1, 0, 1.0, True),
                                        ("KOSMOS-2 decoder", 1, prompt + ZOO_NEW, prompt,
                                         64 ** -0.5, False)):
        kc, vc = (torch.randn((24, Bz, 32, Sz, 64), generator=g, device=device) for _ in range(2))
        li = 11
        for step in (0, ZOO_NEW // 2, ZOO_NEW - 1):
            q, k_cur, v_cur = (torch.randn((Bz, 32, 1, 64), generator=g, device=device)
                               for _ in range(3))
            written = torch.arange(Sz, device=device) < n0 + step
            if t5:
                bias = (torch.randn((1, 32, 1, Sz), generator=g, device=device)
                        + torch.where(written, 0.0, -1e9))
                self_bias = torch.randn((1, 32, 1, 1), generator=g, device=device)
            else:
                bias = torch.where(written, 0.0, -1e9).expand(Bz, 1, 1, Sz)
                self_bias = None
            label = f"{name} B={Bz} S={Sz} step {step}"
            worst = max(worst, partials(label, q, kc[li], vc[li], bias[:, :, 0], scale)[0])
            out = sdpa_decode_stale(q, kc[li], vc[li], k_cur, v_cur, bias, self_bias=self_bias,
                                    scale=scale)
            ref = sdpa_decode_stale_plain(q, kc[li], vc[li], k_cur, v_cur, bias,
                                          self_bias=self_bias, scale=scale)
            worst = max(worst, hold(label + " merged", out, ref, f32))
        z_ms = bench_ms(lambda: fa.decode_partials(q, kc[li], vc[li], bias[:, :, 0], scale),
                        device)
        z_plain = bench_ms(lambda: fa._decode_partials_plain(
            q, kc[li], vc[li], bias[:, :, 0].expand(Bz, 32, Sz), scale), device)
        z_merged = bench_ms(lambda: sdpa_decode_stale(q, kc[li], vc[li], k_cur, v_cur, bias,
                                                      self_bias=self_bias, scale=scale), device)
        z_bd = bound(nbytes(q, kc[li], vc[li], bias), 4 * Bz * 32 * Sz * 64, "f32")
        log(f"K12 {name} [{Bz},32,{Sz},64] f32: kernel {z_ms:.4f} ms, plain {z_plain:.4f} ms, "
            f"sdpa_decode_stale (K12 + the f32 merge) {z_merged:.4f} ms, bound "
            f"{z_bd['bound_ms']:.6f} ms ({z_bd['bound_by']})")
        del kc, vc
    rec["max_abs_err"] = worst
    torch.cuda.empty_cache()
    return {"flash_decode": rec}


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


def cut_layers(params, cfg, n):
    """The model cut to its first ``n`` LLM layers (views of the stacks)."""
    lm = params["language_model"]

    def cut(a):
        return {k: v[:n] for k, v in a.items()} if isinstance(a, dict) else a[:n]

    lm_n = {**lm, "layers": {name: cut(a) for name, a in lm["layers"].items()}}
    return ({**params, "language_model": lm_n},
            dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_hidden_layers=n)))


def reference_check(params, cfg, device):
    """Phase 5: the first two LLM layers at full width, kernel path on the
    card vs plain path on the CPU, same weights: prefill (B=2, T=40, one row
    right-padded), one decode step, and a W = 4 window forward with per-row
    write positions over a bf16 and an int8 cache."""
    import torch

    from cullavo_tpu_torch.models.llava.modeling import generate_prefill, llava_forward

    params2, cfg2 = cut_layers(params, cfg, 2)

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    g = torch.Generator().manual_seed(SEED + 2)
    B, T, S, W = 2, 40, 48, SPEC_K
    ids = torch.randint(4, 32000, (B, T), generator=g, dtype=torch.int32)
    win = torch.randint(4, 32000, (B, W), generator=g, dtype=torch.int32)
    mask = torch.ones((B, T), dtype=torch.int32)
    mask[1, 33:] = 0
    out = {}
    for dev in (device, torch.device("cpu")):
        p = {"language_model": to(params2["language_model"], dev)}
        got = {}
        for kv_quant in (None, "int8"):
            st = generate_prefill(p, cfg2, ids.to(dev), None, mask.to(dev), S, kv_quant=kv_quant)
            pos = st["cur_pos"][:, None] + torch.arange(W, device=dev)[None]
            # per-row write positions: each row's window starts at its own length
            logits, _ = llava_forward(p, cfg2, win.to(dev), None, None, pos, st["cache"],
                                      st["cur_pos"], st["full_mask"], st["key_pos"],
                                      stale_cache=True)
            got[f"window W={W}, {kv_quant or 'bf16'} cache"] = logits.float().cpu()
        st = generate_prefill(p, cfg2, ids.to(dev), None, mask.to(dev), S)
        tok = st["logits"].argmax(-1).to(torch.int32)
        logits, _ = llava_forward(p, cfg2, tok[:, None], None, None, st["cur_pos"][:, None],
                                  st["cache"], st["write_idx"], st["full_mask"], st["key_pos"],
                                  stale_cache=True)
        got["prefill"], got["decode"] = st["logits"].float().cpu()[:, None], logits.float().cpu()
        out[dev.type] = got
    worst = 0.0
    for name, a in out["cuda"].items():
        b = out["cpu"][name]
        if a.shape[0] != B or a.shape[2] != cfg.text.vocab_size or not torch.isfinite(a).all():
            raise RuntimeError(f"reference check: bad {name} logits {tuple(a.shape)}")
        err = (a - b).abs().max().item()
        worst = max(worst, err)
        log(f"reference check ({name} logits, 2 layers at 7B width, card vs CPU): "
            f"max_abs_err={err:.3e}, max |logit| {b.abs().max().item():.3f} (tol 0.1)")
    if not worst <= 0.1:
        raise RuntimeError(f"kernel path disagrees with the plain path: {worst}")


def make_requests(cfg, device):
    """The 14 VQA-shaped requests both paths answer."""
    import torch

    g = torch.Generator(device=device).manual_seed(SEED + 3)
    n_img = cfg.num_image_tokens
    T = 1 + n_img + PROMPT_TEXT
    T_pad = -(-T // PAD_TO) * PAD_TO
    ids = torch.randint(4, 32000, (BATCH, T_pad), generator=g, device=device, dtype=torch.int32)
    ids[:, 1:1 + n_img] = cfg.image_token_id
    mask = torch.ones((BATCH, T_pad), dtype=torch.int32, device=device)
    mask[:, T:] = 0
    side = cfg.vision.image_size
    pix = torch.randn((BATCH, 3, side, side), generator=g, device=device)
    return ids, mask, pix, T, T_pad


def make_run(params, cfg, device, requests, kv_quant=None, spec_k=None):
    """One batch of the 14 requests: plain greedy decode, or speculative
    windows with ``spec_k``; bf16 or int8 KV cache."""
    import torch

    from cullavo_tpu_torch.models.llava.llama import round_cache_len
    from cullavo_tpu_torch.models.llava.modeling import (GenerationConfig, generate_decode,
                                                         generate_decode_spec,
                                                         generate_prefill_chunked)

    ids, mask, pix, _, T_pad = requests
    gen = GenerationConfig(max_new_tokens=NEW_TOKENS, do_sample=False, eos_token_id=-1)
    cache_len = (T_pad + NEW_TOKENS if not spec_k
                 else round_cache_len(T_pad + NEW_TOKENS + spec_k))

    def run(phase=contextlib.nullcontext):
        """``phase(name)`` wraps each phase (e.g. a profiler).  Returns
        (tokens, prefill s, decode s, speculative stats or None)."""
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        with phase("prefill"):
            state = generate_prefill_chunked(params, cfg, ids, pix, mask, cache_len, CHUNK,
                                             compute_dtype=torch.bfloat16, kv_quant=kv_quant)
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        with phase("decode"):
            if spec_k:
                tokens, stats = generate_decode_spec(params, cfg, state, gen, spec_k, ids,
                                                     mask.sum(dim=1),
                                                     compute_dtype=torch.bfloat16)
            else:
                tokens, stats = generate_decode(params, cfg, state, gen,
                                                compute_dtype=torch.bfloat16), None
            torch.cuda.synchronize(device)
        t2 = time.perf_counter()
        return tokens.cpu(), t1 - t0, t2 - t1, stats

    return run


def replay(params, cfg, device, requests, tokens, kv_quant, chunk=CHUNK):
    """Teacher-forced sequential decode: a full prefill, then T = 1
    stale-cache steps fed ``tokens`` [B, N].  Returns, per position, how far
    the given token's logit lies below the step's maximum (0 where it is the
    argmax) and the step's top-2 gap, both [B, N] on the host."""
    import torch

    from cullavo_tpu_torch.models.llava.modeling import generate_prefill_chunked, llava_forward

    ids, mask, pix, _, T_pad = requests
    st = generate_prefill_chunked(params, cfg, ids, pix, mask, T_pad + tokens.shape[1], chunk,
                                  compute_dtype=torch.bfloat16, kv_quant=kv_quant)
    toks = tokens.to(device).long()
    cur_pos, write_idx = st["cur_pos"], st["write_idx"]
    below, gap = [], []

    def score(logits, i):
        top = torch.topk(logits, 2, dim=-1).values
        below.append(top[:, 0] - logits.gather(1, toks[:, i:i + 1])[:, 0])
        gap.append(top[:, 0] - top[:, 1])

    score(st["logits"], 0)
    for i in range(tokens.shape[1] - 1):
        logits, _ = llava_forward(params, cfg, toks[:, i:i + 1].int(), None, None,
                                  cur_pos[:, None], st["cache"], write_idx, st["full_mask"],
                                  st["key_pos"], stale_cache=True)
        st["full_mask"][:, write_idx] = 1
        st["key_pos"][:, write_idx] = cur_pos
        score(logits[:, 0], i + 1)
        cur_pos, write_idx = cur_pos + 1, write_idx + 1
    return torch.stack(below, dim=1).cpu(), torch.stack(gap, dim=1).cpu()


def check_streams(label, params, cfg, device, requests, kv_quant, tok_spec, tok_greedy):
    """The speculative stream against the greedy one.  In bf16 a window
    forward and a one-token step round at other places (another M in the
    linears; draft keys joined in the window merge, not read back by the
    kernel), so their logits differ by up to about the tolerance phase 5
    holds the kernel path to, and a near-tie of the random-weight logits may
    resolve either way.  Held: every speculative token is the sequential
    step's argmax within ``LOGIT_TOL`` (teacher-forced replay of the
    speculative tokens), and every row whose greedy top-2 gaps all exceed
    ``LOGIT_TOL`` is reproduced token for token."""
    import torch

    below, _ = replay(params, cfg, device, requests, tok_spec, kv_quant)
    self_below, gap = replay(params, cfg, device, requests, tok_greedy, kv_quant)
    same = (tok_spec == tok_greedy).all(dim=1)
    decisive = gap.min(dim=1).values > LOGIT_TOL
    for b in (~same).nonzero().flatten().tolist():
        first = int((tok_spec[b] != tok_greedy[b]).nonzero()[0])
        log(f"{label}: row {b} leaves the greedy stream at position {first} (greedy top-2 gap "
            f"there {gap[b, first]:.4f}, the row's least gap {gap[b].min():.4f}): speculative "
            f"{tok_spec[b].tolist()}, greedy {tok_greedy[b].tolist()}")
    log(f"{label}: {int(same.sum())} of {len(same)} speculative rows equal the greedy stream; "
        f"{int(decisive.sum())} rows have every greedy top-2 gap above {LOGIT_TOL} and "
        f"{int((decisive & same).sum())} of them are equal; worst speculative token lies "
        f"{below.max():.4f} below the sequential step's maximum (tol {LOGIT_TOL}); the replayed "
        f"greedy stream lies {self_below.max():.4f} below")
    if not (below.max() <= LOGIT_TOL and (same | ~decisive).all()):
        raise RuntimeError(f"{label}: the speculative stream is not the greedy stream")
    return int(same.sum())


def check_tokens(tokens, vocab):
    if tokens.shape != (BATCH, NEW_TOKENS) or tokens.min() < 0 or tokens.max() >= vocab:
        raise RuntimeError(f"bad tokens: shape {tuple(tokens.shape)}, "
                           f"range [{tokens.min()}, {tokens.max()}]")


def counted(wrappers, run):
    """Run one batch with every launch count set to 0 just before it and
    read just after."""
    for w in wrappers.values():
        w.launches = 0
    result = run()
    return result, {name: w.launches for name, w in wrappers.items()}


def run_greedy_path(params, cfg, device, requests, wrappers):
    """Phase 6: plain greedy decode over the bf16 cache, twice.  Returns the
    first run's launch counts and the batch function."""
    import torch

    _, _, _, T, T_pad = requests
    run = make_run(params, cfg, device, requests)
    torch.cuda.reset_peak_memory_stats(device)
    (tok1, pre1, dec1, _), counts = counted(wrappers, run)
    log(f"launches on the greedy bf16-cache path: {counts}")
    path = ("flash_fwd", "quant_rows", "int8_linear", "wwin_decode")
    if not all(counts[name] for name in path):
        raise RuntimeError(f"a kernel of the path never launched: {counts}")
    tok2, pre2, dec2, _ = run()
    check_tokens(tok1, cfg.text.vocab_size)
    if not torch.equal(tok1, tok2):
        raise RuntimeError("two runs of the batch gave different tokens")
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    for i, (pre, dec) in enumerate(((pre1, dec1), (pre2, dec2)), 1):
        log(f"greedy run {i}: prefill {pre:.4f} s, decode {dec:.4f} s "
            f"({dec / (NEW_TOKENS - 1) * 1e3:.3f} ms per decode step), "
            f"{BATCH / (pre + dec):.4f} images/s")
    log(f"batch {BATCH}, prompt {T} real tokens padded to {T_pad}, chunk {CHUNK}, "
        f"{NEW_TOKENS} greedy tokens; tokens identical across runs; "
        f"peak memory {peak:.2f} GiB; tokens[0] {tok1[0].tolist()}")
    return counts, run


def run_spec_path(params, cfg, device, requests, wrappers):
    """Phase 6b: int8 KV cache + speculative windows, twice; the int8 greedy
    stream they must reproduce; the bf16 window at a smaller depth.  Returns
    the first run's launch counts and the batch function."""
    import torch

    B, V = BATCH, cfg.text.vocab_size
    run = make_run(params, cfg, device, requests, kv_quant="int8", spec_k=SPEC_K)
    torch.cuda.reset_peak_memory_stats(device)
    (tok1, pre1, dec1, st1), counts = counted(wrappers, run)
    log(f"launches on the speculative int8-cache path: {counts}")
    tok2, pre2, dec2, st2 = run()
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    (tok_g, pre_g, dec_g, _), counts_g = counted(
        wrappers, make_run(params, cfg, device, requests, kv_quant="int8"))
    log(f"launches on the greedy int8-cache path: {counts_g}")
    if not (counts["wwin_decode_q8"] and counts_g["wwin_decode_q8"]):
        raise RuntimeError(f"K5 never launched: {counts}, {counts_g}")
    for tok in (tok1, tok_g):
        check_tokens(tok, V)
    if not torch.equal(tok1, tok2) or st1 != st2:
        raise RuntimeError("two speculative runs gave different tokens or counts")
    windows, emitted = st1["windows"], st1["emitted"]
    if not (B <= emitted <= NEW_TOKENS * B
            and -(-(NEW_TOKENS - 1) // SPEC_K) <= windows <= NEW_TOKENS - 1):
        raise RuntimeError(f"inconsistent speculative counts: {st1}")
    if counts["wwin_decode_q8"] != windows * cfg.text.num_hidden_layers:
        raise RuntimeError(f"K5 launches {counts['wwin_decode_q8']} != windows x layers")
    for i, (pre, dec) in enumerate(((pre1, dec1), (pre2, dec2)), 1):
        log(f"speculative run {i}: prefill {pre:.4f} s, decode {dec:.4f} s "
            f"({dec / windows * 1e3:.3f} ms per window), {B / (pre + dec):.4f} images/s")
    log(f"int8 greedy run: prefill {pre_g:.4f} s, decode {dec_g:.4f} s "
        f"({dec_g / (NEW_TOKENS - 1) * 1e3:.3f} ms per decode step), "
        f"{B / (pre_g + dec_g):.4f} images/s")
    # the acceptance formula of generate_decode_spec, per row (a row that
    # reaches its 16 tokens early still counts the later windows: a floor)
    log(f"int8 KV cache, spec_k {SPEC_K}: windows {windows}, emitted {emitted}, "
        f"{(emitted - B) / (windows * B):.3f} tokens per row and window, draft acceptance "
        f"(emitted / B - 1 - windows) / (windows * (spec_k - 1)) = "
        f"{(emitted / B - 1 - windows) / (windows * (SPEC_K - 1)):.3f}; tokens identical "
        f"across runs; peak memory {peak:.2f} GiB; tokens[0] {tok1[0].tolist()}")
    check_streams("int8 cache", params, cfg, device, requests, "int8", tok1, tok_g)

    # the bf16 window (K4 at W = spec_k) at a smaller depth
    params_n, cfg_n = cut_layers(params, cfg, SPEC_BF16_LAYERS)
    (tok_s, _, dec_s, st_s), counts_s = counted(
        wrappers, make_run(params_n, cfg_n, device, requests, spec_k=SPEC_K))
    tok_p = make_run(params_n, cfg_n, device, requests)()[0]
    check_tokens(tok_s, V)
    log(f"bf16 cache, spec_k {SPEC_K}, {SPEC_BF16_LAYERS} layers: {st_s}, "
        f"{dec_s / st_s['windows'] * 1e3:.3f} ms per window, launches {counts_s}")
    if counts_s["wwin_decode"] != st_s["windows"] * SPEC_BF16_LAYERS:
        raise RuntimeError("K4 launches != windows x layers on the bf16 speculative run")
    check_streams(f"bf16 cache, {SPEC_BF16_LAYERS} layers", params_n, cfg_n, device, requests,
                  None, tok_s, tok_p)
    return counts, run


def profile_path(name, run):
    """``--profile``: one more batch under torch.profiler; per phase, the
    device-busy share of the wall time and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    profs = {}

    @contextlib.contextmanager
    def phase(label):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            yield
        profs[label] = prof

    _, pre, dec, _ = run(phase)
    for label, wall in (("prefill", pre), ("decode", dec)):
        ka = profs[label].key_averages()
        busy = device_seconds(ka)
        log(f"profile {name} {label}: wall {wall:.4f} s (profiled), device busy {busy:.4f} s "
            f"({100 * busy / wall:.1f}%)")
        log(ka.table(sort_by="self_device_time_total", row_limit=18,
                     max_name_column_width=70))


def build_nf4_params(cfg, device):
    """Phase 7: random LLaVA-1.5-7B weights on the card with the NF4 base of
    ``MODEL.LLM.BITS: 4``: bf16 everywhere, then the seven LLM targets
    quantized to planar NF4 one at a time (the dense target is released as
    its packed form lands)."""
    import torch

    from cullavo_tpu_torch.models.llava.lora import maybe_quantize_base
    from cullavo_tpu_torch.models.llava.modeling import init_llava_params

    g = torch.Generator(device=device).manual_seed(SEED + 4)
    params = init_llava_params(cfg, g, device, dtype=torch.bfloat16)
    params = maybe_quantize_base(params, SERVE_MODEL_CFG["LLM"]["BITS"])
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    return params


def reference_check_nf4(params, cfg, device, label="NF4"):
    """Phase 5 on the NF4 base: the first two LLM layers at full width, kernel
    path on the card vs plain path on the CPU (a dense matmul against the
    dequantized weight), same weights: a prefill of M = 2 x 264 = 528 rows
    (K7 + a dense matmul on the card), a W = 4 window with per-row write
    positions and a 32-token suffix prefill from row 0's prefix (K6), over
    the int8 cache."""
    import torch

    from cullavo_tpu_torch.models.llava.modeling import (extract_prefix_state,
                                                         generate_prefill,
                                                         generate_prefill_prefix,
                                                         llava_forward)

    params2, cfg2 = cut_layers(params, cfg, 2)

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    g = torch.Generator().manual_seed(SEED + 5)
    B, T, S, W, P, WS = 2, 264, 384, SPEC_K, 224, 32
    ids = torch.randint(4, 32000, (B, T), generator=g, dtype=torch.int32)
    win = torch.randint(4, 32000, (B, W), generator=g, dtype=torch.int32)
    sfx = torch.randint(4, 32000, (B, WS), generator=g, dtype=torch.int32)
    mask = torch.ones((B, T), dtype=torch.int32)
    mask[1, 250:] = 0
    smask = torch.ones((B, WS), dtype=torch.int32)
    smask[1, 20:] = 0
    out = {}
    for dev in (device, torch.device("cpu")):
        p = {"language_model": to(params2["language_model"], dev)}
        st = generate_prefill(p, cfg2, ids.to(dev), None, mask.to(dev), S, kv_quant="int8")
        got = {"prefill M=528": st["logits"].float().cpu()[:, None]}
        prefix = extract_prefix_state(st, 0)
        pos = st["cur_pos"][:, None] + torch.arange(W, device=dev)[None]
        logits, _ = llava_forward(p, cfg2, win.to(dev), None, None, pos, st["cache"],
                                  st["cur_pos"], st["full_mask"], st["key_pos"],
                                  stale_cache=True)
        got[f"window W={W}"] = logits.float().cpu()
        st2 = generate_prefill_prefix(p, cfg2, prefix, sfx.to(dev), None, smask.to(dev), P)
        got[f"suffix prefill P={P} W={WS}"] = st2["logits"].float().cpu()[:, None]
        out[dev.type] = got
    worst = 0.0
    for name, a in out["cuda"].items():
        b = out["cpu"][name]
        if a.shape[0] != B or a.shape[2] != cfg.text.vocab_size or not torch.isfinite(a).all():
            raise RuntimeError(f"{label} reference check: bad {name} logits {tuple(a.shape)}")
        err = (a - b).abs().max().item()
        worst = max(worst, err)
        log(f"{label} reference check ({name} logits, 2 layers at 7B width, int8 cache, card vs "
            f"CPU): max_abs_err={err:.3e}, max |logit| {b.abs().max().item():.3f} (tol 0.1)")
    if not worst <= 0.1:
        raise RuntimeError(f"{label} kernel path disagrees with the plain path: {worst}")


def make_serving_requests(cfg):
    """The serving traffic: 8 random images x 3 questions, image-major.  A
    prompt is bos + 4 text + 576 image + 32 text tokens shared by the
    image's three requests (613), then 8-28 tokens of its own; token budgets
    cycle through 8, 16, 24, 32."""
    import numpy as np

    from cullavo_tpu_torch.serving import Request

    rng = np.random.default_rng(SEED + 6)
    n_img, side = cfg.num_image_tokens, cfg.vision.image_size
    reqs = []
    for im in range(SERVE_IMAGES):
        pix = rng.normal(size=(3, side, side)).astype(np.float32)
        head = rng.integers(4, 32000, size=(1 + SERVE_HEAD_TEXT + n_img + SERVE_SHARED_TEXT,))
        head[0] = 1
        head[1 + SERVE_HEAD_TEXT:1 + SERVE_HEAD_TEXT + n_img] = cfg.image_token_id
        for qn in range(SERVE_QUESTIONS):
            own = rng.integers(4, 32000, size=(int(rng.integers(SERVE_OWN_TEXT[0],
                                                                 SERVE_OWN_TEXT[1] + 1)),))
            i = len(reqs)
            reqs.append(Request(req_id=i, input_ids=np.concatenate([head, own]).astype(np.int32),
                                pixel_values=pix,
                                max_new_tokens=SERVE_BUDGETS[i % len(SERVE_BUDGETS)]))
    return reqs


def make_serving_run(params, cfg, device, reqs):
    """One run of the serving traffic on a fresh engine, built as ``serve``
    builds it: every request submitted, then ``step()`` until all are
    answered.  Returns (results, engine, quanta, wall s)."""
    import torch

    from cullavo_tpu_torch import entry

    def run():
        buckets = SERVE_CFG["PROMPT_BUCKETS"]
        max_len = int(SERVE_CFG.get("MAX_LEN", max(buckets) + max(r.max_new_tokens for r in reqs)))
        _, eng = entry._engine_from_cfg(SERVE_CFG, cfg, params, None, buckets, max_len)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        quanta = 0
        while eng.pending or eng.active:
            eng.step()
            quanta += 1
        torch.cuda.synchronize(device)
        return dict(eng.results), eng, quanta, time.perf_counter() - t0

    return run


def check_serving_streams(params, cfg, device, reqs, results):
    """Every served token against a teacher-forced sequential replay that
    starts from a FULL prefill of each prompt (so prefix reuse, the
    speculative windows and the slot pool are all held): the token must be
    the step's argmax within ``LOGIT_TOL``."""
    import numpy as np
    import torch

    n, T_pad = len(reqs), SERVE_CFG["PROMPT_BUCKETS"][0]
    N = max(len(results[r.req_id]) for r in reqs)
    ids = torch.zeros((n, T_pad), dtype=torch.int32)
    mask = torch.zeros((n, T_pad), dtype=torch.int32)
    toks = torch.zeros((n, N), dtype=torch.int64)
    valid = torch.zeros((n, N), dtype=torch.bool)
    for i, r in enumerate(reqs):
        out = results[r.req_id]
        ids[i, :len(r.input_ids)] = torch.from_numpy(r.input_ids)
        mask[i, :len(r.input_ids)] = 1
        toks[i, :len(out)] = torch.tensor(out)
        toks[i, len(out):] = out[-1]
        valid[i, :len(out)] = True
    pix = torch.from_numpy(np.stack([r.pixel_values for r in reqs])).to(device)
    requests = (ids.to(device), mask.to(device), pix, None, T_pad)
    below, gap = replay(params, cfg, device, requests, toks, SERVE_CFG["KV_QUANT"],
                        chunk=SERVE_CFG["PREFILL_CHUNK"])
    worst = below[valid].max().item()
    log(f"serving replay: worst served token lies {worst:.4f} below the sequential step's "
        f"maximum over {int(valid.sum())} tokens of {n} requests (tol {LOGIT_TOL}); "
        f"{int((gap[valid] <= LOGIT_TOL).sum())} of those steps have a top-2 gap within "
        f"the tolerance")
    if not worst <= LOGIT_TOL:
        raise RuntimeError(f"a served token is not the sequential step's argmax: {worst}")


def run_serving_path(params, cfg, device, wrappers):
    """Phase 7: the 24 requests through the engine twice.  Returns the first
    run's launch counts and the run function."""
    import torch

    reqs = make_serving_requests(cfg)
    run = make_serving_run(params, cfg, device, reqs)
    torch.cuda.reset_peak_memory_stats(device)
    (res1, eng, quanta, wall1), counts = counted(wrappers, run)
    log(f"launches on the serving path: {counts}")
    res2, _, _, wall2 = run()
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    eos, V = SERVE_CFG["EOS_TOKEN_ID"], cfg.text.vocab_size
    for r in reqs:
        out = res1.get(r.req_id)
        if (not out or len(out) > r.max_new_tokens or min(out) < 0 or max(out) >= V
                or (len(out) < r.max_new_tokens and out[-1] != eos)):
            raise RuntimeError(f"request {r.req_id}: bad result {out} "
                               f"(budget {r.max_new_tokens})")
    if res1 != res2:
        raise RuntimeError("two serving runs gave different tokens")
    n_hit = SERVE_IMAGES * (SERVE_QUESTIONS - 1)
    head = 1 + SERVE_HEAD_TEXT + cfg.num_image_tokens + SERVE_SHARED_TEXT
    want = {"prefix_misses": SERVE_IMAGES, "prefix_hits": n_hit,
            "prefix_tokens_saved": n_hit * (head // 32 * 32)}
    if any(eng.counters[k] != v for k, v in want.items()):
        raise RuntimeError(f"prefix counters {eng.counters} != {want}")
    for name in ("flash_fwd", "wwin_decode_q8", "nf4_linear_planar", "nf4_dequant_planar"):
        if not counts[name]:
            raise RuntimeError(f"{name} never launched on the serving path: {counts}")
    n_tok = sum(len(v) for v in res1.values())
    windows = eng.hist["n_fwd"]
    # tokens that came out of decode windows: all but each request's first
    lat = eng.latency()
    for i, wall in enumerate((wall1, wall2), 1):
        log(f"serving run {i}: {len(reqs)} requests, {n_tok} tokens in {wall:.4f} s: "
            f"{len(reqs) / wall:.4f} requests/s, {n_tok / wall:.3f} tokens/s")
    log(f"serving run 1: TTFT p50 {lat['ttft']['p50']} s p95 {lat['ttft']['p95']} s, E2E p50 "
        f"{lat['e2e']['p50']} s p95 {lat['e2e']['p95']} s; {quanta} scheduler steps, {windows} "
        f"windows of {SERVE_CFG['SPEC_K']}, {(n_tok - len(reqs)) / windows:.3f} tokens per "
        f"forward over the pool; counters {eng.counters}; pool of {eng.num_slots} slots x "
        f"{eng.max_len}; peak memory {peak:.2f} GiB; tokens identical across runs; "
        f"request 0 {res1[0]}")
    check_serving_streams(params, cfg, device, reqs, res1)
    return counts, run


def profile_serving(run):
    """``--profile``: one more serving run under torch.profiler; the
    device-busy share of the wall time and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, _, wall = run()
    ka = prof.key_averages()
    busy = device_seconds(ka)
    log(f"profile serving run: wall {wall:.4f} s (profiled), device busy {busy:.4f} s "
        f"({100 * busy / wall:.1f}%)")
    log(ka.table(sort_by="self_device_time_total", row_limit=24, max_name_column_width=70))


def serve_smoke(device):
    """Phase 7, first: ``entry.serve`` in its smoke mode (tiny random model,
    four synthetic requests, the SERVE block's settings) on the card."""
    import tempfile

    from cullavo_tpu_torch import entry

    with tempfile.TemporaryDirectory() as tmp:
        scfg = {**SERVE_CFG, "PROMPT_BUCKETS": None,
                "RESULTS": os.path.join(tmp, "serve_results.jsonl")}
        summary = entry.serve({"MODEL": {"LLM": {"LOAD_PATH": None, "BITS": 0}}, "SERVE": scfg},
                              device=device)
        with open(scfg["RESULTS"]) as f:
            rows = [json.loads(line) for line in f]
    eos = SERVE_CFG["EOS_TOKEN_ID"]
    if summary["requests"] != 4 or len(rows) != 4 or not all(
            len(r["tokens"]) == 4 + 2 * r["id"]
            or (0 < len(r["tokens"]) < 4 + 2 * r["id"] and r["tokens"][-1] == eos)
            for r in rows):
        raise RuntimeError(f"entry.serve smoke mode: bad results {rows}")
    log(f"entry.serve smoke mode on the card: {summary}")


def train_smoke(device):
    """Phase 8, first: ``entry.train`` in its smoke mode (tiny random model
    over an NF4 base, one Q-LoRA step on two synthetic records) on the card."""
    import math

    from cullavo_tpu_torch import entry

    metrics = entry.train(TRAIN_CFG, device=device)
    if not (math.isfinite(metrics["loss_llm"]) and 0 < metrics["grad_norm"] < math.inf):
        raise RuntimeError(f"entry.train smoke mode: bad metrics {metrics}")
    log(f"entry.train smoke mode on the card: {metrics}")


def _capture_tx():
    """An optimizer that moves nothing and keeps the gradients as its state."""
    import torch

    from cullavo_tpu_torch.trainer.optimizer import GradientTransformation
    from cullavo_tpu_torch.utils.tree import tree_map

    return GradientTransformation(lambda p: tree_map(torch.zeros_like, p),
                                  lambda g, s, p: (tree_map(torch.zeros_like, g), g))


def reference_check_train(params, cfg, device):
    """Phase 8: the Q-LoRA train step at full width and small depth, kernel
    path on the card against plain path on the CPU from one state: 2 LLM
    layers, 3 vision layers on a 112 x 112 image (64 image tokens), batch 2
    right-padded to T = 264 (M = 528: K7 and K1-lse on the card), r = 64
    adapters with random non-zero ``b``, remat, bf16 compute over f32
    masters, chunked loss, no dropout.  Held: the loss within 2e-2 relative
    and every gradient leaf (LoRA, projector, embed_tokens, lm_head) within
    5e-2 of the CPU leaf's largest entry (bf16 rounds at other places on the
    two devices)."""
    import torch

    from cullavo_tpu_torch.models.llava import lora as lora_mod
    from cullavo_tpu_torch.trainer.step import TrainState, make_train_step
    from cullavo_tpu_torch.utils.tree import tree_leaves, tree_map

    params2, cfg2 = cut_layers(params, cfg, 2)
    n_vis, side = 3, 112
    vcfg = dataclasses.replace(cfg.vision, num_hidden_layers=n_vis, image_size=side)
    cfg2 = dataclasses.replace(cfg2, vision=vcfg)
    vt = params2["vision_tower"]
    params2 = {**params2, "vision_tower": {
        **vt, "position_embedding": vt["position_embedding"][:vcfg.num_positions],
        "layers": {k: a[:n_vis] for k, a in vt["layers"].items()}}}
    lcfg = lora_mod.LoraConfig(r=64, alpha=16.0, dropout=0.0, vision_layer_start=0,
                               vision_layer_stop=2)
    g = torch.Generator(device=device).manual_seed(SEED + 7)
    lora = lora_mod.init_lora_params(params2, cfg2, lcfg, g)
    for tower in lora.values():
        for ab in tower.values():
            ab["b"] = torch.randn(ab["b"].shape, generator=g, device=device) * 0.01
    trainable = tree_map(lambda t: t.float(), lora_mod.trainable_partition(params2, lora))
    frozen = lora_mod.strip_trainable(params2)

    gc = torch.Generator().manual_seed(SEED + 8)
    B, T, n_img = 2, 264, cfg2.num_image_tokens
    ids = torch.randint(4, 32000, (B, T), generator=gc, dtype=torch.int32)
    ids[:, 1:1 + n_img] = cfg2.image_token_id
    mask = torch.ones((B, T), dtype=torch.int32)
    mask[1, 250:] = 0
    labels = torch.where(mask != 0, ids, -100)
    labels[:, :1 + n_img + 8] = -100
    batch = {"input_ids": ids, "attention_mask": mask, "labels": labels,
             "pixel_values": torch.randn((B, 3, side, side), generator=gc),
             "weights": torch.tensor([1.0, 0.5])}
    step = make_train_step(cfg2, lcfg, _capture_tx(), remat=True, compute_dtype=torch.bfloat16,
                           loss_chunk=64)
    out = []
    for dev in (device, torch.device("cpu")):
        move = lambda t: t.to(dev)   # noqa: E731
        st, met = step(TrainState(tree_map(move, trainable), None, 0), tree_map(move, frozen),
                       tree_map(move, batch), None)
        out.append((float(met["loss_llm"]), float(met["grad_norm"]),
                    tree_map(lambda t: t.float().cpu(), st.opt_state)))
    (loss_c, norm_c, g_c), (loss_p, norm_p, g_p) = out
    log(f"train-step check (2 LLM + {n_vis} vision layers at 7B width, card vs CPU): loss "
        f"{loss_c:.5f} vs {loss_p:.5f} (tol 2e-2 relative), grad_norm {norm_c:.5f} vs "
        f"{norm_p:.5f}")
    if not abs(loss_c - loss_p) <= 2e-2 * abs(loss_p):
        raise RuntimeError(f"train-step check: loss {loss_c} vs {loss_p}")

    def named(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from named(v, f"{prefix}{k}/")
            elif v is not None and k != "mask":
                yield prefix + k, v

    worst = ("", 0.0)
    for (name, a), (_, b) in zip(named(g_c), named(g_p)):
        top = b.abs().max().item()
        rel = (a - b).abs().max().item() / top
        worst = max(worst, (name, rel), key=lambda x: x[1])
        if not (torch.isfinite(a).all() and top > 0 and rel <= 5e-2):
            raise RuntimeError(f"train-step check: gradient {name} differs by {rel:.3e} of its "
                               f"largest entry {top:.3e}")
    log(f"train-step check: {len(tree_leaves(g_p))} gradient leaves; the worst, {worst[0]}, "
        f"differs by {worst[1]:.3e} of its largest entry (tol 5e-2)")


def make_train_batch(cfg, device):
    """The train batch: 8 rows right-padded to T = 1024, real lengths spread
    over 700-1024, 576 image tokens after bos, 336 x 336 pixels, labels on
    the text after the first 8 text tokens, weights 1."""
    import torch

    g = torch.Generator(device=device).manual_seed(SEED + 9)
    B, T, n_img = TRAIN_CFG["BATCH_SIZE"], TRAIN_T, cfg.num_image_tokens
    lo, hi = TRAIN_LEN_RANGE
    lengths = torch.linspace(lo, hi, B).round().long().to(device)
    ids = torch.randint(4, 32000, (B, T), generator=g, device=device, dtype=torch.int32)
    ids[:, 1:1 + n_img] = cfg.image_token_id
    mask = (torch.arange(T, device=device)[None, :] < lengths[:, None]).int()
    labels = torch.where(mask != 0, ids, -100)
    labels[:, :1 + n_img + 8] = -100
    side = cfg.vision.image_size
    return {"input_ids": ids, "attention_mask": mask, "labels": labels,
            "pixel_values": torch.randn((B, 3, side, side), generator=g, device=device),
            "weights": torch.ones((B,), device=device)}, int(lengths.sum())


def _base_digest(frozen):
    """Sums over the frozen base, leaf by leaf: equal digests mean the step
    changed no frozen bit (int32 words summed exactly, floats as their bits)."""
    import torch

    def digest(t):
        if t.dtype.is_floating_point:
            t = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
        return int(t.long().sum().item())

    out = []

    def walk(tree):
        for v in tree.values():
            if isinstance(v, dict):
                walk(v)
            elif v is not None:
                out.append(digest(v))

    walk(frozen)
    return out


def run_train_path(params_nf4, cfg, device, wrappers):
    """Phase 8: 4 Q-LoRA steps at the full width and depth of LLaVA-1.5-7B
    over the NF4 base, twice from the same seed.  Returns the first run's
    launch counts, the pipeline and the batch."""
    import math

    import torch

    from cullavo_tpu_torch.pipelines.base import build_pipeline
    from cullavo_tpu_torch.utils.tree import tree_leaves, tree_map

    # the masters of the trainable full modules are f32
    lm = params_nf4["language_model"]
    params = {**params_nf4,
              "projector": tree_map(lambda t: t.float(), params_nf4["projector"]),
              "language_model": {**lm, "embed_tokens": lm["embed_tokens"].float(),
                                 "lm_head": lm["lm_head"].float()}}
    pipe = build_pipeline(TRAIN_CFG["PIPELINE"], TRAIN_CFG, model_cfg=cfg, tokenizer=None,
                          params=params)
    batch, n_real = make_train_batch(cfg, device)
    B, T, L = TRAIN_CFG["BATCH_SIZE"], TRAIN_T, cfg.text.num_hidden_layers

    def run(steps=TRAIN_STEPS):
        state = pipe.initialize_model()
        rng = torch.Generator().manual_seed(SEED)
        losses, norms, secs = [], [], []
        for _ in range(steps):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            state, met = pipe.forward_step(state, batch, rng)
            torch.cuda.synchronize(device)
            secs.append(time.perf_counter() - t0)
            losses.append(float(met["loss_llm"]))
            norms.append(float(met["grad_norm"]))
        return state, losses, norms, secs

    state0 = pipe.initialize_model()
    n_train = sum(t.numel() for t in tree_leaves(state0.trainable))
    log(f"train state: {n_train / 1e6:.1f} M trainable parameters (r = {pipe.lora_cfg.r} "
        f"adapters on {len(state0.trainable['lora']['language_model'])} LLM targets and "
        f"{len(state0.trainable['lora']['vision_tower'])} vision targets, projector, lm_head, "
        f"embed_tokens), f32 masters, {torch.cuda.memory_allocated(device) / 2**30:.2f} GiB "
        "allocated with the NF4 base")
    del state0
    before = _base_digest(pipe.frozen)
    torch.cuda.reset_peak_memory_stats(device)
    (state, losses, norms, secs), counts = counted(wrappers, run)
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    log(f"launches on the train path: {counts}")
    _, losses2, norms2, secs2 = run()
    if _base_digest(pipe.frozen) != before:
        raise RuntimeError("the train step changed the frozen base")
    if not all(math.isfinite(x) for x in losses + norms) or min(norms) <= 0:
        raise RuntimeError(f"train path: bad losses {losses} or grad norms {norms}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"train path: the loss did not fall: {losses}")
    drift = max(abs(a - b) / abs(a) for a, b in zip(losses + norms, losses2 + norms2))
    log(f"two runs from one seed: losses {losses} and {losses2}; equal bit for bit: "
        f"{losses == losses2 and norms == norms2}; largest relative difference {drift:.3e} "
        "(tol 1e-3: cuBLAS may pick another split of a reduction between runs)")
    if not drift <= 1e-3:
        raise RuntimeError(f"train path: two runs from one seed differ by {drift}")
    # per step: every layer's attention runs in the forward and again in the
    # rematerialized backward; every NF4 linear dequantizes there and once
    # more for dx (M = 8192 is above the fused kernel's threshold)
    want = {"flash_fwd_lse": TRAIN_STEPS * 2 * L, "nf4_dequant_planar": TRAIN_STEPS * 3 * 7 * L,
            "nf4_linear_planar": 0, "flash_fwd": 0}
    if any(counts[k] != n for k, n in want.items()):
        raise RuntimeError(f"train path: launches {counts} != predicted {want}")
    if state.step != TRAIN_STEPS or state.opt_state["count"] != TRAIN_STEPS:
        raise RuntimeError(f"train path: step count {state.step}")
    for i, sec in enumerate((secs, secs2), 1):
        med = statistics.median(sec[1:])
        log(f"train run {i}: s per step {[round(x, 4) for x in sec]}, median of steps 2-"
            f"{TRAIN_STEPS} {med:.4f} s: {B * T / med:.1f} padded tokens/s, "
            f"{n_real / med:.1f} real tokens/s")
    log(f"batch {B} x T {T} ({n_real} real tokens), NF4 base, r 64, remat, bf16 compute, loss "
        f"chunk 256, dropout 0.05: losses {[round(x, 5) for x in losses]}, grad_norm "
        f"{[round(x, 4) for x in norms]}, peak memory {peak:.2f} GiB")
    return counts, pipe, batch


def profile_train(pipe, batch, device):
    """``--profile``: one warm step, then one step under torch.profiler; the
    device-busy share of the wall time and the kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    state = pipe.initialize_model()
    rng = torch.Generator().manual_seed(SEED)
    state, _ = pipe.forward_step(state, batch, rng)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe.forward_step(state, batch, rng)
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    ka = prof.key_averages()
    busy = device_seconds(ka)
    log(f"profile train step: wall {wall:.4f} s (profiled), device busy {busy:.4f} s "
        f"({100 * busy / wall:.1f}%)")
    log(ka.table(sort_by="self_device_time_total", row_limit=30, max_name_column_width=70))


def run_attn_probe(device, wrappers):
    """Phase 8b: the package's attention probe at its default shape: plain
    attention against ``flash_attention`` with explicit positions and a key
    mask (K8), 8 layers.  Returns the launch counts of its run."""
    from cullavo_tpu_torch.scripts import attn_probe

    rows, counts = counted(wrappers, lambda: attn_probe.probe(device, *PROBE_SHAPE[::2], 8))
    by = {r["variant"]: r for r in rows}
    log(f"attn_probe B={PROBE_SHAPE[0]} T={PROBE_SHAPE[2]}: plain {by['sdpa']['ms_per_layer']} "
        f"ms per layer, flash_attention (K8) {by['flash']['ms_per_layer']} ms per layer; "
        f"launches {counts}")
    # one call for the comparison, then a warm-up and 4 timed passes over 8 layers
    if counts["flash_rows"] != 1 + 5 * 8:
        raise RuntimeError(f"attn_probe: K8 launches {counts['flash_rows']} != 41")
    return counts


def _tree_to(node, **kw):
    """An X-Decoder parameter tree (nested dicts and lists of tensors) with
    ``.to(**kw)`` applied to every leaf."""
    if isinstance(node, dict):
        return {k: _tree_to(v, **kw) for k, v in node.items()}
    if isinstance(node, list):
        return [_tree_to(v, **kw) for v in node]
    return node.to(**kw)


def xdecoder_entry_smoke(device):
    """Phase 9a: ``entry.evaluate`` on configs/xdecoder_test.yaml with
    ``DATASETS.TEST`` unset: the full model's random weights and the text
    tokenizer are built on the card, and the result is ``{}`` as in JAX."""
    from cullavo_tpu_torch import entry

    t0 = time.perf_counter()
    results = entry.evaluate(XDEC_CONFIGS[XDEC_FOCAL], device=device)
    if results != {}:
        raise RuntimeError(f"entry.evaluate({XDEC_FOCAL}): {results}, not {{}}")
    log(f"entry.evaluate({XDEC_FOCAL}) on the card: {results} in "
        f"{time.perf_counter() - t0:.1f} s")


def xdecoder_cut(path):
    """The config of ``path`` at full width with its depth cut: one block
    per FocalNet stage and one FPN encoder layer, or two SAM-ViT blocks (the
    second global) and one deformable layer; 2 decoder and 2 text layers."""
    from cullavo_tpu_torch.models.from_config import xdecoder_model_config_from

    full = xdecoder_model_config_from(XDEC_CONFIGS[path])
    if path == XDEC_FOCAL:
        backbone = dataclasses.replace(full.backbone, depths=(1, 1, 1, 1))
        encoder = dataclasses.replace(full.fpn, enc_layers=1)
    else:
        backbone = dataclasses.replace(full.backbone, depth=2, global_attn_indexes=(1,))
        encoder = dataclasses.replace(full.fpn, num_layers=1)
    return dataclasses.replace(full, backbone=backbone, fpn=encoder,
                               decoder=dataclasses.replace(full.decoder, dec_layers=2),
                               text=dataclasses.replace(full.text, layers=2))


def reference_check_xdecoder(device, wrappers):
    """Phase 9b: each configuration at full width and cut depth, f32, on one
    256 x 320 image, kernels on the card against the plain versions on the
    CPU (same weights, drawn on the CPU): class embeddings of 8 classes and
    the background, the class and mask logits of ``forward_eval`` within
    1e-3 of their largest entry (TF32 off; a mask logit near 0 can flip a
    cross-attention bit between the two)."""
    import numpy as np
    import torch

    from cullavo_tpu_torch.entry import _make_text_tokenize
    from cullavo_tpu_torch.models.xdecoder.model import forward_eval, init_xdecoder_model_params
    from cullavo_tpu_torch.models.xdecoder.text_encoder import class_embeddings_ensembled
    from cullavo_tpu_torch.utils.constants import COCO_PANOPTIC_CLASSES

    h, w = XDEC_CHECK_HW
    image = np.random.default_rng(SEED).normal(size=(1, h, w, 3)).astype(np.float32)
    for path in XDEC_CONFIGS:
        cfg = xdecoder_cut(path)
        tokenize = _make_text_tokenize(XDEC_CONFIGS[path], cfg.text)
        params = init_xdecoder_model_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
        outs = []
        for dev in (torch.device("cpu"), device):
            p = _tree_to(params, device=dev)

            def run():
                with torch.inference_mode():
                    emb = class_embeddings_ensembled(p["text"], cfg.text, tokenize,
                                                     COCO_PANOPTIC_CLASSES[:8],
                                                     add_background=True)
                    return (emb,) + forward_eval(p, cfg, torch.as_tensor(image, device=dev),
                                                 emb)[:2]

            got, counts = counted(wrappers, run)
            outs.append([t.float().cpu() for t in got])
        worst = []
        for name, b, a in zip(("class embeddings", "pred_logits", "pred_masks"), *outs):
            rel = ((a - b).abs().max() / b.abs().max()).item()
            worst.append(rel)
            log(f"{path} cut ({h}x{w}, f32) {name} {tuple(a.shape)}: card vs CPU "
                f"max |d| / max |ref| = {rel:.3e} (tol 1e-3)")
        need = "focal_ctx" if path == XDEC_FOCAL else "ms_deform_attn"
        if not (max(worst) <= 1e-3 and counts[need]):
            raise RuntimeError(f"{path}: the card's cut model disagrees with the CPU's "
                               f"({worst}) or {need} never launched ({counts})")


def xdecoder_rows(num_classes):
    """The eval set: 16 normalized random images (12 of 512^2, 4 of 480 x
    640) with synthetic ground truth of 64-pixel blocks: a semantic map, a
    panoptic map with one segment per class, up to 4 instance masks."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    rows = []
    for i, (h, w) in enumerate(XDEC_SIZES):
        blocks = rng.integers(0, num_classes, (-(-h // 64), -(-w // 64)))
        sem = np.kron(blocks, np.ones((64, 64), np.int64))[:h, :w]
        cats = np.unique(sem)
        rows.append({
            "image": rng.normal(size=(h, w, 3)).astype(np.float32), "image_id": i,
            "sem_seg": sem, "pan_seg_gt": (sem + 1).astype(np.int32),
            "segments_gt": [{"id": int(c) + 1, "category_id": int(c),
                             "isthing": int(c) in XDEC_THINGS} for c in cats],
            "instances_gt": {"masks": np.stack([sem == c for c in cats[:4]]),
                             "classes": cats[:4]}})
    return rows


def _same(a, b) -> bool:
    """Two nested dicts of numpy arrays hold equal arrays."""
    import numpy as np

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return np.array_equal(a, b)


def check_xdecoder_results(res, batches, num_classes):
    """Ids in range, finite scores and metrics."""
    import numpy as np

    for out in batches:
        if "sem" in out and not (0 <= out["sem"].min() and out["sem"].max() < num_classes):
            raise RuntimeError("semantic ids out of range")
        inst = out["inst"]
        if not (np.isfinite(inst["scores"]).all() and 0 <= inst["classes"].min()
                and inst["classes"].max() < num_classes):
            raise RuntimeError("instance scores or classes out of range")
    for o in res["panoptic_outputs"]:
        ids = {s["id"] for s in o["segments"]}
        if not (set(np.unique(o["panoptic"]).tolist()) <= ids | {0}
                and all(0 <= s["category_id"] < num_classes for s in o["segments"])):
            raise RuntimeError(f"panoptic ids out of range: {o['segments']}")
    metrics = [v for key in ("sem_seg", "panoptic", "instance_ap") for v in res.get(key, {}).values()]
    if "sem_seg" not in res or not all(np.isfinite(v) for v in metrics):
        raise RuntimeError(f"metrics not finite: {res.get('sem_seg')} {res.get('panoptic')} "
                           f"{res.get('instance_ap')}")


def run_xdecoder_path(path, device, wrappers, smi):
    """Phase 9c: one configuration at full width and depth in bf16 (random
    weights from a seeded generator on the card), class embeddings of the
    133 COCO panoptic classes and the background through the 12-layer text
    encoder, then ``XDecoderPipeline.evaluate_model`` with the semantic,
    panoptic and instance tasks on the 16 images at ``EVAL_BATCH`` 8, twice.
    Returns the first run's launch counts and the pipeline."""
    import torch

    from cullavo_tpu_torch.entry import _make_text_tokenize
    from cullavo_tpu_torch.models.from_config import xdecoder_model_config_from
    from cullavo_tpu_torch.models.xdecoder.model import init_xdecoder_model_params
    from cullavo_tpu_torch.models.xdecoder.text_encoder import class_embeddings_ensembled
    from cullavo_tpu_torch.pipelines.base import build_pipeline
    from cullavo_tpu_torch.pipelines.xdecoder_pipeline import tasks_for_dataset
    from cullavo_tpu_torch.utils.constants import COCO_PANOPTIC_CLASSES

    cfg_dict = XDEC_CONFIGS[path]
    model_cfg = xdecoder_model_config_from(cfg_dict)
    t0 = time.perf_counter()
    params = init_xdecoder_model_params(model_cfg, torch.Generator(device=device).manual_seed(SEED),
                                        device, dtype=torch.bfloat16)
    with torch.inference_mode():
        text = class_embeddings_ensembled(params["text"], model_cfg.text,
                                          _make_text_tokenize(cfg_dict, model_cfg.text),
                                          COCO_PANOPTIC_CLASSES, add_background=True)
    torch.cuda.synchronize(device)
    log(f"{path}: bf16 weights and {tuple(text.shape)} class embeddings in "
        f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated(device) / 2**30:.2f} GiB "
        "allocated")
    pipe = build_pipeline(cfg_dict["PIPELINE"], cfg_dict, model_cfg=model_cfg, params=params,
                          text_class_embeds=text, tasks=tasks_for_dataset(XDEC_DATASET),
                          eval_batch=XDEC_BATCH)
    rows = xdecoder_rows(model_cfg.num_classes)
    run_batch = pipe._run_batch
    runs = []
    for _ in range(2):
        batches = []

        def recording(*a, _batches=batches):
            out = run_batch(*a)
            _batches.append(out)
            return out

        pipe._run_batch = recording
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        res, counts = counted(wrappers, lambda: pipe.evaluate_model(rows, thing_ids=XDEC_THINGS))
        wall = time.perf_counter() - t0
        runs.append((res, batches, counts, wall, torch.cuda.max_memory_allocated(device) / 2**30))
    pipe._run_batch = run_batch
    (res, batches, counts, _, _), (res2, batches2, _, _, _) = runs
    log(f"launches on the {path} eval path: {counts}")
    forwards = len(batches)
    if path == XDEC_FOCAL:
        want = {"focal_ctx": sum(model_cfg.backbone.depths) * forwards, "ms_deform_attn": 0}
    else:
        want = {"ms_deform_attn": model_cfg.fpn.num_layers * forwards, "focal_ctx": 0}
    if any(counts[k] != n for k, n in want.items()):
        raise RuntimeError(f"{path}: launches {counts} != predicted {want} ({forwards} forwards)")
    check_xdecoder_results(res, batches, model_cfg.num_classes)
    pan = [(o["image_id"], o["segments"]) for o in res["panoptic_outputs"]]
    if not (all(_same(a, b) for a, b in zip(batches, batches2)) and len(batches) == len(batches2)
            and pan == [(o["image_id"], o["segments"]) for o in res2["panoptic_outputs"]]):
        raise RuntimeError(f"{path}: two runs gave different outputs")
    n_seg = sum(len(s) for _, s in pan)
    n_inst = sum(len(o["scores"]) for o in res["instance_outputs"])
    n_keep = sum(int(out["pan"]["keep"].sum()) for out in batches)
    log(f"{path}: {len(rows)} images in {forwards} batches of {XDEC_BATCH}; outputs identical "
        f"across the two runs; {n_keep} queries kept for the panoptic map (class score > "
        f"{model_cfg.object_mask_threshold}, not the background) over the batches' "
        f"{forwards * XDEC_BATCH} rows, {n_seg} panoptic segments, {n_inst} instances; sem_seg "
        f"{res['sem_seg']}, panoptic {res.get('panoptic')}, instance AP {res.get('instance_ap')}")
    for i, (r, _, _, wall, peak) in enumerate(runs, 1):
        t = r["timing"]
        log(f"{path} run {i} ({smi}): {t.get('images_per_s', 0.0):.4f} images/s after the first "
            f"batch, compute {t['compute_s']:.4f} s per batch (data {t['data_s']:.4f}, eval "
            f"{t['eval_s']:.4f}), wall {wall:.3f} s, peak memory {peak:.2f} GiB")
    return counts, pipe, rows


def profile_xdecoder(pipe, rows, device):
    """``--profile``: one more 512^2 batch of 8 through the pipeline's
    device part under torch.profiler; the device-busy share of the wall
    time and the kernels by device time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = rows[:XDEC_BATCH]
    img = np.stack([r["image"] for r in batch])
    hw = np.asarray([r["image"].shape[:2] for r in batch], np.int32)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe._run_batch(img, hw, (XDEC_SIDE, XDEC_SIDE))
    wall = time.perf_counter() - t0
    ka = prof.key_averages()
    busy = device_seconds(ka)
    log(f"profile X-Decoder eval batch ({pipe.cfg['NAME']}): wall {wall:.4f} s (profiled), device "
        f"busy {busy:.4f} s ({100 * busy / wall:.1f}%)")
    log(ka.table(sort_by="self_device_time_total", row_limit=24, max_name_column_width=70))


def _merge_pair(seq, a, b):
    out, i = [], 0
    while i < len(seq):
        if i + 1 < len(seq) and seq[i] == a and seq[i + 1] == b:
            out.append(a + b)
            i += 2
        else:
            out.append(seq[i])
            i += 1
    return out


def write_tokenizer(path):
    """A LLaMA-style ``tokenizer.json`` (the family llava-hf/llava-1.5-7b-hf
    ships) as plain JSON: <unk>, <s>, </s> at 0-2, the 256 byte-fallback
    tokens <0x00>..<0xFF>, the corpus' characters ("▁" among them), then
    ``TOKENIZER_MERGES`` BPE merges learned here on a small corpus (the most
    frequent pair first); <image> and <pad> as added tokens at 32000 and
    32001; the legacy Prepend/Replace normalizer and the Replace,
    ByteFallback, Fuse, Strip decoder; and its tokenizer_config.json."""
    from collections import Counter

    words = ["\u2581" + t.replace(" ", "\u2581") for t in TOKENIZER_CORPUS]
    vocab = (["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
             + sorted({c for w in words for c in w}))
    seqs, merges = [list(w) for w in words], []
    for _ in range(TOKENIZER_MERGES):
        counts = Counter(pair for seq in seqs for pair in zip(seq, seq[1:]))
        if not counts:
            break
        (a, b), n = max(counts.items(), key=lambda kv: (kv[1], kv[0]))
        if n < 2:
            break
        merges.append(f"{a} {b}")
        if a + b not in vocab:
            vocab.append(a + b)
        seqs = [_merge_pair(seq, a, b) for seq in seqs]
    added = [(0, "<unk>"), (1, "<s>"), (2, "</s>"), (32000, "<image>"), (32001, "<pad>")]
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": c, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True}
                         for i, c in added],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "\u2581"},
            {"type": "Replace", "pattern": {"String": " "}, "content": "\u2581"}]},
        "pre_tokenizer": None,
        "post_processor": {"type": "TemplateProcessing",
                           "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                                      {"Sequence": {"id": "A", "type_id": 0}}],
                           "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                                    {"Sequence": {"id": "A", "type_id": 0}},
                                    {"SpecialToken": {"id": "<s>", "type_id": 1}},
                                    {"Sequence": {"id": "B", "type_id": 1}}],
                           "special_tokens": {"<s>": {"id": "<s>", "ids": [1],
                                                      "tokens": ["<s>"]}}},
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "\u2581"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": True, "byte_fallback": True,
                  "vocab": {t: i for i, t in enumerate(vocab)}, "merges": merges}}
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "LlamaTokenizer", "add_bos_token": True,
                   "add_eos_token": False, "bos_token": "<s>", "eos_token": "</s>",
                   "unk_token": "<unk>", "pad_token": "<pad>", "legacy": False,
                   "clean_up_tokenization_spaces": False, "model_max_length": 4096}, f)
    return len(vocab), len(merges)


def write_snapshot(params, cfg, path):
    """A LLaVA-1.5-7B snapshot in the HF layout: config.json with
    llava-hf/llava-1.5-7b-hf's widths, the tokenizer files, and the weights as
    bf16 safetensors shards (``VL_SHARD_LAYERS`` LLM layers each, the rest in
    the first) written by the port's own writer, with the shard index.
    Returns the bytes of weights written."""
    import re

    from cullavo_tpu_torch.checkpoint.hf_import import to_hf_state_dict
    from cullavo_tpu_torch.checkpoint.safetensors_io import write_safetensors

    t, v = cfg.text, cfg.vision
    hf = {"architectures": ["LlavaForConditionalGeneration"], "model_type": "llava",
          "ignore_index": -100, "image_token_index": cfg.image_token_id,
          "pad_token_id": cfg.pad_token_id, "projector_hidden_act": cfg.projector_hidden_act,
          "vision_feature_layer": cfg.vision_feature_layer,
          "vision_feature_select_strategy": cfg.vision_feature_select_strategy,
          "tie_word_embeddings": False, "torch_dtype": "bfloat16", "vocab_size": t.vocab_size,
          "text_config": {"model_type": "llama", "vocab_size": t.vocab_size,
                          "hidden_size": t.hidden_size, "intermediate_size": t.intermediate_size,
                          "num_hidden_layers": t.num_hidden_layers,
                          "num_attention_heads": t.num_attention_heads,
                          "num_key_value_heads": t.num_key_value_heads,
                          "max_position_embeddings": t.max_position_embeddings,
                          "rms_norm_eps": t.rms_norm_eps, "rope_theta": t.rope_theta},
          "vision_config": {"model_type": "clip_vision_model", "hidden_size": v.hidden_size,
                            "intermediate_size": v.intermediate_size,
                            "num_hidden_layers": v.num_hidden_layers,
                            "num_attention_heads": v.num_attention_heads,
                            "image_size": v.image_size, "patch_size": v.patch_size,
                            "projection_dim": 768, "hidden_act": v.hidden_act}}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f, indent=1)
    n_vocab, n_merges = write_tokenizer(path)
    shards = {}
    for name, a in to_hf_state_dict(params, cfg).items():
        m = re.match(r"model\.language_model\.layers\.(\d+)\.", name)
        shards.setdefault(1 + int(m.group(1)) // VL_SHARD_LAYERS if m else 0, {})[name] = a
    weight_map, total = {}, 0
    for k in sorted(shards):
        fname = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        write_safetensors(shards[k], os.path.join(path, fname), {"format": "pt"})
        weight_map.update({name: fname for name in shards[k]})
        total += nbytes(*shards[k].values())
    shards.clear()
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    log(f"tokenizer.json: {n_vocab} tokens, {n_merges} merges, <image> 32000, <pad> 32001")
    return total


def vqa_records():
    """The in-memory VQA dataset: ``VL_QUESTIONS`` questions on
    ``VL_IMAGES`` random images of four sizes, ten answers each."""
    import numpy as np

    rng = np.random.default_rng(SEED + 9)
    images = [rng.integers(0, 256, VL_IMAGE_HW[i % len(VL_IMAGE_HW)] + (3,), dtype=np.uint8)
              for i in range(VL_IMAGES)]
    return [{"question_id": 1000 + i, "image_id": i % VL_IMAGES, "image": images[i % VL_IMAGES],
             "question": VL_QUESTION_TEXT[i % len(VL_QUESTION_TEXT)],
             "answers": [VL_ANSWERS[(i + j) % len(VL_ANSWERS)] for j in (0,) * 6 + (1,) * 4],
             "question_type": "what", "answer_type": "other"} for i in range(VL_QUESTIONS)]


def _tree_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _tree_leaves(v, f"{prefix}{k}/")]
    return [(prefix, tree)]


def run_vl_snapshot_path(cfg, device, wrappers, smi):
    """Phase 10: random LLaVA-1.5-7B bf16 weights from a seeded generator on
    the card, written as a snapshot in the HF layout (``write_snapshot``)
    into a temporary directory and read back through the port's loader (the
    config equal, every tensor bit-equal to the written one, before any
    quantization); then ``entry.evaluate`` on configs/vl_test.yaml with
    ``LOAD_PATH`` the snapshot (``BITS: 8``, batch 8, 16 new tokens) over the
    registered in-memory dataset of 16 questions, twice: n = 16, a finite
    overall accuracy in [0, 100], identical answers in both runs'
    vqa_results.json, and K1, K3 and K4 launched (K2 quantizes activations
    only for SmoothQuant-calibrated dicts, which ``BITS: 8`` from a snapshot
    does not make, in either package).  Returns the run's launch counts and
    the written weights (for phase 10b)."""
    import math
    import tempfile

    import torch

    from cullavo_tpu_torch import entry
    from cullavo_tpu_torch.checkpoint.hf_import import (llava_config_from_json,
                                                        load_llava_safetensors)
    from cullavo_tpu_torch.data.registry import register_dataset
    from cullavo_tpu_torch.models.llava.modeling import init_llava_params
    from cullavo_tpu_torch.pipelines import vqa_pipeline

    params = init_llava_params(cfg, torch.Generator(device=device).manual_seed(SEED + 6), device,
                               dtype=torch.bfloat16)
    records = vqa_records()
    register_dataset(VL_DATASET, lambda: records, {})
    runs = []
    with tempfile.TemporaryDirectory(prefix="cullavo_snapshot_") as snap:
        t0 = time.perf_counter()
        total = write_snapshot(params, cfg, snap)
        t_write = time.perf_counter() - t0
        torch.cuda.empty_cache()
        if llava_config_from_json(snap) != cfg:
            raise RuntimeError("the snapshot's config.json does not give back the 7B config")
        t0 = time.perf_counter()
        loaded = load_llava_safetensors(snap, cfg, device=device)
        torch.cuda.synchronize(device)
        t_load = time.perf_counter() - t0
        want, got = dict(_tree_leaves(params)), dict(_tree_leaves(loaded))
        bad = [k for k, a in want.items()
               if k not in got or a.dtype != got[k].dtype or a.shape != got[k].shape
               or not torch.equal(a.view(torch.int16), got[k].view(torch.int16))]
        log(f"snapshot: {total / 1e9:.3f} GB of bf16 weights in "
            f"{len([f for f in os.listdir(snap) if f.endswith('.safetensors')])} shards, "
            f"written in {t_write:.2f} s, loaded onto the card in {t_load:.2f} s "
            f"({total / 1e9 / t_load:.2f} GB/s); {len(got)} tensors, mismatching {len(bad)} "
            "(bit-equal demanded)")
        if bad or len(want) != len(got):
            raise RuntimeError(f"the loaded snapshot differs from the written weights: {bad[:5]}")
        del loaded, want, got
        torch.cuda.empty_cache()
        # time the load (+ quantization), the prefills and the decodes of
        # each run through the module functions the entry and the pipeline call
        timers = {"build": (entry, "_build_llava"),
                  "prefill": (vqa_pipeline, "generate_prefill_chunked"),
                  "decode": (vqa_pipeline, "generate_decode")}
        spent = {k: [] for k in timers}
        shapes = []

        def timed(key, fn):
            def run(*a, **kw):
                torch.cuda.synchronize(device)
                t = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize(device)
                spent[key].append(time.perf_counter() - t)
                if key == "prefill":
                    shapes.append(tuple(a[2].shape))
                return out
            return run

        originals = {k: getattr(mod, name) for k, (mod, name) in timers.items()}
        for k, (mod, name) in timers.items():
            setattr(mod, name, timed(k, originals[k]))
        for i in range(2):
            out_dir = os.path.join(snap, f"out{i}")
            vl = {**VL_CFG, "MODEL": {"LLM": {**VL_CFG["MODEL"]["LLM"], "LOAD_PATH": snap}},
                  "DATASETS": {"TEST": [VL_DATASET]}, "SAVE_DIR": out_dir}
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            res, counts = counted(wrappers, lambda: entry.evaluate(vl))
            wall = time.perf_counter() - t0
            with open(os.path.join(out_dir, "vqa_results.json")) as f:
                answers = json.load(f)
            runs.append((res[VL_DATASET], counts, wall, {k: sum(v) for k, v in spent.items()},
                         answers, torch.cuda.max_memory_allocated(device) / 2**30))
            for v in spent.values():
                v.clear()
            torch.cuda.empty_cache()
        for k, (mod, name) in timers.items():
            setattr(mod, name, originals[k])
    (res, counts, _, _, answers, _), (res2, _, _, _, answers2, _) = runs
    log(f"launches on the vl_test path: {counts}")
    if not (res["n"] == VL_QUESTIONS and math.isfinite(res["overall"])
            and 0.0 <= res["overall"] <= 100.0 and len(answers) == VL_QUESTIONS):
        raise RuntimeError(f"vl_test: bad metrics {res}")
    if answers != answers2 or res != res2:
        raise RuntimeError("vl_test: two runs gave different answers")
    if not all(counts[k] for k in ("flash_fwd", "int8_linear", "wwin_decode")):
        raise RuntimeError(f"vl_test: a kernel of the path never launched: {counts}")
    log(f"vl_test: {res}; answers identical across the two runs; answers[:3] "
        f"{[a['answer'] for a in answers[:3]]}")
    log(f"vl_test prefill shapes (ids [rows, bucket]): {shapes[:2]}")
    for i, (_, _, wall, t, _, peak) in enumerate(runs, 1):
        ev = wall - t["build"]
        log(f"vl_test run {i} ({smi}): snapshot load + int8 quantization {t['build']:.3f} s, "
            f"eval {ev:.3f} s (prefill {t['prefill']:.3f} s, decode {t['decode']:.3f} s, the "
            f"rest on the host {ev - t['prefill'] - t['decode']:.3f} s), "
            f"{VL_QUESTIONS / ev:.4f} images/s (eval only), {VL_QUESTIONS / wall:.4f} images/s "
            f"with the load, peak memory {peak:.2f} GiB")
    return counts, params


def run_q4_path(params, cfg, device, requests, wrappers, smi):
    """Phase 10b: phase 10's bf16 weights with the seven LLM targets quantized
    to byte-packed NF4 (``quantize_linear``, q4) and, for comparison, to
    planar NF4.  One target's dequantized weight through K11 bit-equal to
    K7's, its codes and scales equal across the layouts; phase 5's 2-layer
    check on the q4 base (card K11 against the CPU plain path, within 0.1);
    the 14-request greedy batch of phase 6 over the q4 base twice (tokens in
    the vocabulary, equal across runs, K11 launched as the shapes predict:
    7 x 32 x 15 fused at the decode M = 14, 7 x 32 per prefill chunk through
    the dequant entry); every row whose top-2 logit gaps all exceed 0.1 equal
    to the stream over the planar base.  Returns the run's launch counts."""
    import torch

    from cullavo_tpu_torch.models.llava.lora import LLM_TARGETS
    from cullavo_tpu_torch.ops import nf4

    lm = params["language_model"]
    q4, planar = dict(lm["layers"]), dict(lm["layers"])
    t0 = time.perf_counter()
    for t in LLM_TARGETS:
        q4[t] = nf4.quantize_linear(lm["layers"][t])
        planar[t] = nf4.quantize_linear_planar(lm["layers"][t])
    torch.cuda.synchronize(device)
    log(f"q4 and planar NF4 bases quantized on the card in {time.perf_counter() - t0:.2f} s")
    K, N = lm["layers"]["gate"].shape[-2:]
    a, b = {k: v[0] for k, v in q4["gate"].items()}, {k: v[0] for k, v in planar["gate"].items()}
    deq_q4, deq_planar = nf4.nf4_dequant_q4(a, K), nf4.nf4_dequant_planar(b)
    codes_q4 = nf4._unpack_nibbles(a["q4"]).reshape(K, N)
    codes_planar = torch.cat([(b["q4p"] >> (4 * i)) & 0xF for i in range(8)], dim=0)
    same = (torch.equal(deq_q4.view(torch.int16), deq_planar.view(torch.int16))
            and torch.equal(codes_q4, codes_planar.long())
            and torch.equal(a["scale"].reshape(K, N // 64), b["scale"]))
    log(f"gate of layer 0 [{K}, {N}]: K11 dequant {'bit-equal to' if same else 'DIFFERS from'} "
        "K7, codes and scales equal across the two layouts")
    if not same:
        raise RuntimeError("the q4 and planar layouts disagree on one weight")
    del deq_q4, deq_planar, codes_q4, codes_planar
    p_q4 = {**params, "language_model": {**lm, "layers": q4}}
    p_planar = {**params, "language_model": {**lm, "layers": planar}}
    reference_check_nf4(p_q4, cfg, device, label="q4")
    run = make_run(p_q4, cfg, device, requests)
    torch.cuda.reset_peak_memory_stats(device)
    (tok1, pre1, dec1, _), counts = counted(wrappers, run)
    tok2, pre2, dec2, _ = run()
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    check_tokens(tok1, cfg.text.vocab_size)
    if not torch.equal(tok1, tok2):
        raise RuntimeError("two runs of the q4 batch gave different tokens")
    L, n = cfg.text.num_hidden_layers, len(LLM_TARGETS)
    want = {"nf4_linear_q4": n * L * (NEW_TOKENS - 1),
            "nf4_dequant_q4": n * L * -(-BATCH // CHUNK)}
    log(f"launches on the q4 greedy path: {counts}; K11 predicted {want}")
    if any(counts[k] != v for k, v in want.items()):
        raise RuntimeError(f"K11 launches {counts} != predicted {want}")
    tok_p = make_run(p_planar, cfg, device, requests)()[0]
    _, gap = replay(p_q4, cfg, device, requests, tok1, None)
    rows_same = (tok1 == tok_p).all(dim=1)
    decisive = gap.min(dim=1).values > LOGIT_TOL
    log(f"q4 vs planar base: {int(rows_same.sum())} of {BATCH} rows equal; {int(decisive.sum())} "
        f"rows have every top-2 gap above {LOGIT_TOL}, {int((decisive & rows_same).sum())} of "
        "them equal")
    if not (rows_same | ~decisive).all():
        raise RuntimeError("a decisive row of the q4 base left the planar base's stream")
    for i, (pre, dec) in enumerate(((pre1, dec1), (pre2, dec2)), 1):
        log(f"q4 greedy run {i} ({smi}): prefill {pre:.4f} s, decode {dec:.4f} s "
            f"({dec / (NEW_TOKENS - 1) * 1e3:.3f} ms per decode step), "
            f"{BATCH / (pre + dec):.4f} images/s, peak memory {peak:.2f} GiB")
    return counts


def zoo_records():
    """``ZOO_QUESTIONS`` VQA-shaped questions on ``ZOO_IMAGES`` random
    224^2 images, ten answers each."""
    import numpy as np

    rng = np.random.default_rng(SEED + 11)
    images = [rng.integers(0, 256, (ZOO_SIDE, ZOO_SIDE, 3), dtype=np.uint8)
              for _ in range(ZOO_IMAGES)]
    return [{"question_id": 2000 + i, "image_id": i % ZOO_IMAGES, "image": images[i % ZOO_IMAGES],
             "question": VL_QUESTION_TEXT[i % len(VL_QUESTION_TEXT)],
             "answers": [VL_ANSWERS[(i + j) % len(VL_ANSWERS)] for j in (0,) * 6 + (1,) * 4],
             "question_type": "what", "answer_type": "other"} for i in range(ZOO_QUESTIONS)]


def _zoo_models():
    """(name, config, initializer, answerer factory, decoder layers) of the
    two zoo towers, at the published widths and depths."""
    from cullavo_tpu_torch.models import kosmos2 as k2
    from cullavo_tpu_torch.models.blip2 import blip2_flant5xl_config, init_blip2_params
    from cullavo_tpu_torch.pipelines import vl_zoo_pipeline as zoo

    b2 = blip2_flant5xl_config()
    kc = k2.Kosmos2Config()
    return (("blip2", b2, init_blip2_params, zoo.native_blip2_answer_fn, b2.text.num_decoder_layers),
            ("kosmos2", kc, k2.init_kosmos2_params, zoo.native_kosmos2_answer_fn, kc.text.layers))


def _cut_zoo_config(name, cfg):
    r = dataclasses.replace
    if name == "blip2":
        return r(cfg, vision=r(cfg.vision, num_hidden_layers=ZOO_CUT),
                 qformer=r(cfg.qformer, num_hidden_layers=ZOO_CUT),
                 text=r(cfg.text, num_layers=ZOO_CUT, num_decoder_layers=ZOO_CUT))
    return r(cfg, vision=r(cfg.vision, num_hidden_layers=ZOO_CUT),
             text=r(cfg.text, layers=ZOO_CUT))


def _zoo_probe(name, cfg, params, inputs):
    """The forward's logits and the hidden states of four one-token decode
    steps over the cache (K12 on the card), on one device."""
    import torch

    from cullavo_tpu_torch.models import kosmos2 as k2
    from cullavo_tpu_torch.models.blip2 import modeling as b2m
    from cullavo_tpu_torch.models.blip2 import t5 as t5m

    pix, ids, dec = inputs
    dev = pix.device
    mask = torch.ones_like(ids)
    steps = []
    if name == "blip2":
        logits = b2m.blip2_forward(params, cfg, pix, ids, mask, decoder_input_ids=dec)
        lm = params["language_model"]
        embeds, emask = b2m._t5_inputs(params, b2m.encode_image(params, cfg, pix), ids, mask)
        enc = t5m.t5_encode(lm, cfg.text, embeds, emask)
        cache = t5m.t5_init_cache(cfg.text, 1, dec.shape[1], enc.dtype, dev)
        for i in range(dec.shape[1]):
            h, cache = t5m.t5_decode_step(lm, cfg.text, lm["embed_tokens"][dec[:, i:i + 1]], enc,
                                          emask, torch.tensor([i], device=dev), cache, i,
                                          stale_cache=True)
            steps.append(h[:, 0])
        return logits, torch.stack(steps, 1)
    n_img, T = cfg.latent_query_num, ids.shape[1]
    img_mask = torch.zeros_like(ids)
    img_mask[:, 1:1 + n_img] = 1
    logits = k2.kosmos2_forward(params, cfg, pix, ids, img_mask, mask)
    emb = k2._scatter_image_embeds(params["embed_tokens"][ids],
                                   k2.kosmos2_image_features(params, cfg, pix), img_mask != 0)
    n = dec.shape[1]
    full = torch.cat([mask, torch.zeros((1, n), dtype=mask.dtype, device=dev)], dim=1)
    pos = k2.kosmos2_position_ids(mask, cfg.text.pad_token_id)
    key_pos = torch.cat([pos, torch.zeros((1, n), dtype=pos.dtype, device=dev)], dim=1)
    cache = k2.kosmos2_init_cache(cfg.text, 1, T + n, emb.dtype, dev)
    k2.kosmos2_text_forward(params, cfg.text, emb, full, pos, cache, 0, key_pos)
    for i in range(n):
        p = pos[:, -1:] + 1 + i
        h, cache = k2.kosmos2_text_forward(params, cfg.text, params["embed_tokens"][dec[:, i:i + 1]],
                                           full, p, cache, T + i, key_pos, stale_cache=True)
        full[:, T + i] = 1
        key_pos[:, T + i] = p[:, 0]
        steps.append(h[:, 0])
    return logits, torch.stack(steps, 1)


def reference_check_zoo(device, wrappers):
    """Phase 11's card-vs-CPU check: each zoo model at full width and
    ``ZOO_CUT`` layers per tower: the forward's logits and four decode
    steps' hidden states (K12 on the card, its plain version on the CPU),
    f32 on the card (TF32 off) against f64 on the CPU (the softmaxes and
    K12's plain version stay f32, as the models compute them), within ``ZOO_TOL``
    times the CPU's own f32 error plus 1e-5 of the largest entry.  The
    measure is relative because the random-weight T5 is sensitive: its
    unscaled attention scores reach about +-100, and the CPU's f32 result
    alone differs from f64 by about 2.6e-4 of the largest logit (KOSMOS-2:
    about 2e-7)."""
    import numpy as np
    import torch

    from cullavo_tpu_torch.data.tokenizer import ByteTokenizer
    from cullavo_tpu_torch.pipelines import vl_zoo_pipeline as zoo
    from cullavo_tpu_torch.utils.tree import tree_map

    tok = ByteTokenizer()
    for name, cfg, init, _, _ in _zoo_models():
        cut = _cut_zoo_config(name, cfg)
        params = init(cut, torch.Generator(device=device).manual_seed(SEED + 12), device)
        vocab = cut.text.vocab_size
        ids = zoo._fold_ids(np.asarray(tok.encode("Question: What is on the table? Answer:")),
                            vocab).tolist()
        if name == "kosmos2":
            ids = [1] + [3] * cut.latent_query_num + ids
        ids = torch.tensor([ids], device=device)
        g = torch.Generator(device=device).manual_seed(SEED + 13)
        pix = torch.randn((1, 3, ZOO_SIDE, ZOO_SIDE), generator=g, device=device)
        dec = torch.randint(4, min(vocab, 260), (1, 4), generator=g, device=device)
        inputs = (pix, ids, dec)
        got, counts = counted(wrappers, lambda: _zoo_probe(name, cut, params, inputs))
        cpu_inputs = tuple(t.cpu() for t in inputs)
        cpu = tree_map(lambda t: t.cpu(), params)
        want32 = _zoo_probe(name, cut, cpu, cpu_inputs)
        cpu = tree_map(lambda t: t.double(), cpu)
        want = _zoo_probe(name, cut, cpu, (cpu_inputs[0].double(), *cpu_inputs[1:]))
        for what, a, r32, r in zip(("logits", "decode-step hidden states"), got, want32, want):
            err = (a.cpu().double() - r).abs().max().item()
            err_cpu = (r32.double() - r).abs().max().item()
            scale = r.abs().max().item()
            tol = ZOO_TOL * err_cpu + 1e-5 * scale
            log(f"{name} card (f32) vs CPU (f64), {ZOO_CUT} layers per tower at full width, "
                f"{what} {tuple(r.shape)}: max_abs_err={err:.3e}; the CPU's f32 {err_cpu:.3e}; "
                f"max |ref| {scale:.3f}; tol {tol:.3e}")
            if not (torch.isfinite(a).all() and err <= tol):
                raise RuntimeError(f"{name}: the card disagrees with the CPU on {what}: {err}")
        if counts["flash_decode"] != ZOO_CUT * dec.shape[1]:
            raise RuntimeError(f"{name} check: K12 launched {counts['flash_decode']} times, "
                               f"expected {ZOO_CUT * dec.shape[1]}")
        del params, cpu
        torch.cuda.empty_cache()


def zoo_entry_smoke(device, wrappers):
    """``entry.evaluate`` with ``MODEL.ZOO: blip2`` and ``kosmos2`` at the
    JAX package's tiny configs (the checkpoint-free path) on the card, over
    four of phase 11's questions: n = 4, an accuracy in [0, 100], K12
    launched."""
    import math

    from cullavo_tpu_torch import entry
    from cullavo_tpu_torch.data.registry import register_dataset

    records = zoo_records()
    register_dataset(ZOO_DATASET, lambda: records, {})
    for zoo_name in ("blip2", "kosmos2"):
        cfg = {"NAME": "vl_test", "MAX_NEW_TOKENS": ZOO_NEW, "LIMIT": 4,
               "MODEL": {"ZOO": zoo_name}, "DATASETS": {"TEST": [ZOO_DATASET]}}
        res, counts = counted(wrappers, lambda: entry.evaluate(cfg))
        r = res[ZOO_DATASET]
        log(f"entry.evaluate MODEL.ZOO {zoo_name} (tiny config, card): {r}; K12 launches "
            f"{counts['flash_decode']}")
        if not (r["n"] == 4 and math.isfinite(r["overall"]) and 0 <= r["overall"] <= 100
                and counts["flash_decode"] > 0):
            raise RuntimeError(f"entry.evaluate MODEL.ZOO {zoo_name}: {r}, {counts}")


def run_zoo_path(device, wrappers, smi, profile):
    """Phase 11: each zoo model at full width and depth in f32 with seeded
    random weights built on the card answers ``ZOO_QUESTIONS`` questions
    (CLIP-preprocessed at 224^2 beforehand, as ``entry.evaluate``'s mapper
    does) through ``VLZooVQAPipeline.evaluate_model`` with its native
    answerer and the byte tokenizer, twice: n = 16, a finite accuracy,
    identical answers, and K12 launched as the shapes predict (BLIP-2:
    decoder layers x 10 beam steps x questions; KOSMOS-2: decoder layers x
    the greedy steps each question ran, one per token up to its first eos).
    Prints questions/s, ms per question by phase, peak memory and K12's
    launches.  Returns the K12 launches of the two models' first runs."""
    import math

    import torch

    from cullavo_tpu_torch.data.mappers.eval_mappers import VQAEvalMapper
    from cullavo_tpu_torch.data.tokenizer import ByteTokenizer
    from cullavo_tpu_torch.models import kosmos2 as k2
    from cullavo_tpu_torch.models.blip2 import modeling as b2m
    from cullavo_tpu_torch.models.blip2 import t5 as t5m
    from cullavo_tpu_torch.pipelines import vl_zoo_pipeline as zoo
    from cullavo_tpu_torch.utils.tree import tree_leaves

    mapper = VQAEvalMapper(image_size=ZOO_SIDE)
    rows = []
    for rec in zoo_records():
        m = mapper(rec)
        m["image"] = m.pop("pixel_values")
        rows.append(m)
    total = {}
    for name, cfg, init, answer_fn, n_layers in _zoo_models():
        t0 = time.perf_counter()
        params = init(cfg, torch.Generator(device=device).manual_seed(SEED + 14), device)
        torch.cuda.synchronize(device)
        n_params = sum(t.numel() for t in tree_leaves(params))
        log(f"{name}: {n_params / 1e9:.3f} G parameters in f32 built on the card in "
            f"{time.perf_counter() - t0:.1f} s")
        fn = answer_fn(cfg, params, ByteTokenizer(), max_new_tokens=ZOO_NEW)
        # phase timers around the module functions the answerer reaches
        if name == "blip2":
            timers = {"answer": (zoo, "blip2_beam_generate"), "vision": (b2m, "encode_image"),
                      "encoder": (t5m, "t5_encode")}
        else:
            timers = {"answer": (zoo, "kosmos2_generate"),
                      "vision": (k2, "kosmos2_image_features"), "text": (k2, "kosmos2_text_forward")}
        spent = dict.fromkeys(("answer", "vision", "encoder"), 0.0)
        outs = []

        def timed(key, fn_):
            def run(*a, **kw):
                torch.cuda.synchronize(device)
                t = time.perf_counter()
                out = fn_(*a, **kw)
                torch.cuda.synchronize(device)
                dt = time.perf_counter() - t
                if key != "text":
                    spent[key] += dt
                elif not kw.get("stale_cache"):     # the prompt's cached forward
                    spent["encoder"] += dt
                if key == "answer":
                    outs.append(out.cpu())
                return out
            return run

        originals = {k: getattr(mod, attr) for k, (mod, attr) in timers.items()}
        for k, (mod, attr) in timers.items():
            setattr(mod, attr, timed(k, originals[k]))
        runs = []
        for _ in range(2):
            pipe = zoo.VLZooVQAPipeline(None, name, answer_fn=fn)
            spent.update(dict.fromkeys(spent, 0.0))
            outs.clear()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            res, counts = counted(wrappers, lambda: pipe.evaluate_model(rows))
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            runs.append((res, counts, wall, dict(spent), list(outs),
                         [r["answer"] for r in pipe.evaluator.results],
                         torch.cuda.max_memory_allocated(device) / 2**30))
        for k, (mod, attr) in timers.items():
            setattr(mod, attr, originals[k])
        (res, counts, _, _, toks, answers, _), (res2, _, _, _, toks2, answers2, _) = runs
        if name == "blip2":
            want = n_layers * ZOO_NEW * ZOO_QUESTIONS
        else:   # greedy with the early stop: one step per token up to the first eos
            steps = [int((o[0] == 2).nonzero()[0]) + 1 if (o[0] == 2).any() else ZOO_NEW
                     for o in toks]
            want = n_layers * sum(steps)
        log(f"launches on the {name} zoo path: {counts}; K12 predicted {want}")
        if counts["flash_decode"] != want:
            raise RuntimeError(f"{name}: K12 launched {counts['flash_decode']} times, not {want}")
        if not (res["n"] == ZOO_QUESTIONS and math.isfinite(res["overall"])
                and 0.0 <= res["overall"] <= 100.0):
            raise RuntimeError(f"{name}: bad metrics {res}")
        if answers != answers2 or res != res2 or not all(
                torch.equal(a, b) for a, b in zip(toks, toks2)):
            raise RuntimeError(f"{name}: two runs gave different answers")
        log(f"{name}: {res}; answers identical across the two runs; answers[:3] {answers[:3]}")
        for i, (_, c, wall, t, _, _, peak) in enumerate(runs, 1):
            per_q = 1e3 / ZOO_QUESTIONS
            decode = t["answer"] - t["vision"] - t["encoder"]
            log(f"{name} run {i} ({smi}): {ZOO_QUESTIONS / wall:.4f} questions/s "
                f"({wall:.3f} s for {ZOO_QUESTIONS}); ms per question: vision + "
                f"{'Q-Former/projection' if name == 'blip2' else 'latent-query projection'} "
                f"{t['vision'] * per_q:.2f}, {'T5 encoder' if name == 'blip2' else 'prompt prefill'} "
                f"{t['encoder'] * per_q:.2f}, decode {decode * per_q:.2f}, the rest (host: "
                f"tokenizer, pipeline, scoring) {(wall - t['answer']) * per_q:.2f}; peak memory "
                f"{peak:.2f} GiB; K12 launches {c['flash_decode']}")
        total[name] = counts["flash_decode"]
        if profile:
            profile_zoo(name, fn, rows[0])
        del params, fn, pipe
        torch.cuda.empty_cache()
    return total


def profile_zoo(name, fn, row):
    """``--profile``: one more answer under torch.profiler; the device-busy
    share of its wall time and the kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(row["question"], row["image"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    busy = device_seconds(ka)
    log(f"profile {name} one answer: wall {wall:.4f} s (profiled), device busy {busy:.4f} s "
        f"({100 * busy / wall:.1f}%)")
    log(ka.table(sort_by="self_device_time_total", row_limit=18, max_name_column_width=70))


def main(argv):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this "
                         "script runs only on a CUDA GPU")
    sys.path.insert(0, REPO)
    from cullavo_tpu_torch import _build
    from cullavo_tpu_torch.models.llava.config import LlavaConfig
    from cullavo_tpu_torch.ops import flash_attention as fa
    from cullavo_tpu_torch.ops import focal, msdeform, nf4
    from cullavo_tpu_torch.ops import wwin_decode as ww

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
                "int8_linear": nf4.int8_linear, "wwin_decode": ww.wwin_decode_smajor,
                "wwin_decode_q8": ww.wwin_decode_smajor_q8,
                "nf4_linear_planar": nf4.nf4_linear_planar,
                "nf4_dequant_planar": nf4.nf4_dequant_planar,
                "flash_fwd_lse": fa.flash_lse, "flash_rows": fa.flash_rows,
                "ms_deform_attn": msdeform.ms_deform_attn_kernel,
                "focal_ctx": focal.focal_ctx_kernel,
                "nf4_linear_q4": nf4.nf4_linear_q4, "nf4_dequant_q4": nf4.nf4_dequant_q4,
                "flash_decode": fa.decode_partials}
    meta = {"flash_fwd": ("cullavo_tpu_torch/csrc/flash_fwd.cu",
                          "cullavo_tpu/ops/flash_attention.py:259"),
            "quant_rows": ("cullavo_tpu_torch/csrc/quant_rows.cu",
                           "cullavo_tpu/ops/nf4.py:1157"),
            "int8_linear": ("cullavo_tpu_torch/csrc/int8_matmul.cu",
                            "cullavo_tpu/ops/nf4.py:912"),
            "wwin_decode": ("cullavo_tpu_torch/csrc/wwin_decode.cu",
                            "cullavo_tpu/ops/wwin_decode.py:52"),
            "wwin_decode_q8": ("cullavo_tpu_torch/csrc/wwin_decode.cu",
                               "cullavo_tpu/ops/wwin_decode.py:104"),
            "nf4_linear_planar": ("cullavo_tpu_torch/csrc/nf4_planar.cu",
                                  "cullavo_tpu/ops/nf4.py:627"),
            "nf4_dequant_planar": ("cullavo_tpu_torch/csrc/nf4_planar.cu",
                                   "cullavo_tpu/ops/nf4.py:729"),
            "flash_fwd_lse": ("cullavo_tpu_torch/csrc/flash_fwd.cu",
                              "cullavo_tpu/ops/flash_attention.py:259"),
            "flash_rows": ("cullavo_tpu_torch/csrc/flash_fwd.cu",
                           "cullavo_tpu/ops/flash_attention.py:142"),
            "ms_deform_attn": ("cullavo_tpu_torch/csrc/msdeform.cu",
                               "cullavo_tpu/ops/msdeform_pallas.py:43"),
            "focal_ctx": ("cullavo_tpu_torch/csrc/focal_ctx.cu",
                          "cullavo_tpu/ops/focal_pallas.py:34"),
            # K11 replaces row 9 and, fed the decoded absmax, row 8
            # (cullavo_tpu/ops/nf4.py:222, nf4_matmul_fused); its dequant
            # entry serves row 9's prefill M
            "nf4_linear_q4": ("cullavo_tpu_torch/csrc/nf4_q4.cu",
                              "cullavo_tpu/ops/nf4.py:464"),
            "nf4_dequant_q4": ("cullavo_tpu_torch/csrc/nf4_q4.cu",
                               "cullavo_tpu/ops/nf4.py:464"),
            # K12: row 5's decode kernel in the general form the zoo's
            # stale-cache decode needs (cullavo_tpu/models/llava/llama.py:174)
            "flash_decode": ("cullavo_tpu_torch/csrc/flash_decode.cu",
                             "cullavo_tpu/ops/flash_attention.py:687")}

    # phases 4-6b
    cfg = LlavaConfig()
    t0 = time.perf_counter()
    params = build_params(cfg, device)
    log(f"7B params built in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB allocated")
    reference_check(params, cfg, device)
    requests = make_requests(cfg, device)
    counts, run_greedy = run_greedy_path(params, cfg, device, requests, wrappers)
    counts_spec, run_spec = run_spec_path(params, cfg, device, requests, wrappers)
    if "--profile" not in argv:   # the profiled batches at the end need the int8 model
        del params, run_greedy, run_spec
        torch.cuda.empty_cache()

    # phase 7
    serve_smoke(device)
    t0 = time.perf_counter()
    params_nf4 = build_nf4_params(cfg, device)
    log(f"7B params with the NF4 base built in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB allocated")
    reference_check_nf4(params_nf4, cfg, device)
    counts_serve, run_serve = run_serving_path(params_nf4, cfg, device, wrappers)

    # phases 8 and 8b
    train_smoke(device)
    reference_check_train(params_nf4, cfg, device)
    counts_train, train_pipe, train_batch = run_train_path(params_nf4, cfg, device, wrappers)
    counts_probe = run_attn_probe(device, wrappers)
    if "--profile" not in argv:
        del params_nf4, train_pipe, train_batch, run_serve
        torch.cuda.empty_cache()

    # phase 9
    xdecoder_entry_smoke(device)
    reference_check_xdecoder(device, wrappers)
    counts_focal, focal_pipe, xdec_rows = run_xdecoder_path(XDEC_FOCAL, device, wrappers, smi)
    counts_deform, _, _ = run_xdecoder_path(XDEC_DEFORM, device, wrappers, smi)
    if "--profile" not in argv:
        del focal_pipe, xdec_rows
        torch.cuda.empty_cache()

    # phases 10 and 10b
    counts_vl, params_vl = run_vl_snapshot_path(cfg, device, wrappers, smi)
    counts_q4 = run_q4_path(params_vl, cfg, device, requests, wrappers, smi)
    del params_vl
    torch.cuda.empty_cache()

    # phase 11
    zoo_entry_smoke(device, wrappers)
    reference_check_zoo(device, wrappers)
    counts_zoo = run_zoo_path(device, wrappers, smi, "--profile" in argv)
    # each kernel's launches on the main path that runs it: K1-K4 the greedy
    # bf16-cache batch, K5 the speculative int8-cache batch, K6 and K7 the
    # serving run, K1-lse the train steps, K8 the attention probe, K9 the
    # SAM-ViT-B + deformable eval, K10 the FocalNet-L + FPN eval
    counts["wwin_decode_q8"] = counts_spec["wwin_decode_q8"]
    for name in ("nf4_linear_planar", "nf4_dequant_planar"):
        counts[name] = counts_serve[name]
    counts["flash_fwd_lse"] = counts_train["flash_fwd_lse"]
    counts["flash_rows"] = counts_probe["flash_rows"]
    counts["focal_ctx"] = counts_focal["focal_ctx"]
    counts["ms_deform_attn"] = counts_deform["ms_deform_attn"]
    for name in ("nf4_linear_q4", "nf4_dequant_q4"):
        counts[name] = counts_q4[name]
    # K12: the two zoo models' first runs of phase 11, each counted from 0
    counts["flash_decode"] = sum(counts_zoo.values())
    log(f"launches on the vl_test path (BITS 8 from the snapshot): {counts_vl}")
    log(f"K7 launches on the train path: {counts_train['nf4_dequant_planar']}")
    if not all(counts.values()):
        raise RuntimeError(f"a kernel never launched on its main path: {counts}")
    if "--profile" in argv:   # last: an attached profiler slows every later launch
        profile_xdecoder(focal_pipe, xdec_rows, device)
        profile_train(train_pipe, train_batch, device)
        profile_serving(run_serve)
        profile_path("greedy bf16-cache", run_greedy)
        profile_path("speculative int8-cache", run_spec)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    kernels = [{"name": name, "route": "cuda", "source": meta[name][0],
                "replaces": meta[name][1], "launches": counts[name],
                **{k: rec[name][k] for k in keys}}
               for name in wrappers]
    for k in kernels:
        if k["name"] == "nf4_linear_q4":
            k["also_replaces"] = "cullavo_tpu/ops/nf4.py:222"
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
