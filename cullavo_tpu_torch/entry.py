"""Entry points of the port (counterpart of ``cullavo_tpu/entry.py``): so
far ``serve``, the continuous-batching engine over a JSONL request stream,
``train`` in its smoke mode (one Q-LoRA step on synthetic records), and
``evaluate`` for the VL eval (``vl_test``: LLaVA from a local HF snapshot
or the smoke model, or a zoo tower, BLIP-2 Flan-T5 or KOSMOS-2, with tiny
random weights, over registered VQA datasets) and the X-Decoder
workloads (model, weights and text tokenizer built from the config; their
dataset kinds come with a later data slice).

``MODEL.LLM.LOAD_PATH`` names a local snapshot: ``config.json``,
``*.safetensors`` shards and ``tokenizer.json`` (read by the port's own
readers, kept in the snapshot's dtype, loaded onto the device).  A missing
file raises; the JAX entry's quiet fallbacks (the 7B config, the byte
tokenizer) are not copied.

The entry points take the parsed config as a dict (the layout of
``configs/serve.yaml``) and run on the GPU unless the caller names another
device.  The command line, the other commands and the HTTP mode come with
later slices.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

from cullavo_tpu_torch.checkpoint.hf_import import llava_config_from_json, load_llava_safetensors
from cullavo_tpu_torch.data.datasets import register_vqa
from cullavo_tpu_torch.data.mappers.eval_mappers import VQAEvalMapper
from cullavo_tpu_torch.data.registry import get_dataset
from cullavo_tpu_torch.data.tokenizer import ByteTokenizer, HFTokenizer
from cullavo_tpu_torch.models.blip2 import tiny_blip2_config
from cullavo_tpu_torch.models.kosmos2 import tiny_kosmos2_config
from cullavo_tpu_torch.models.llava.config import tiny_llava_config
from cullavo_tpu_torch.models.llava.lora import maybe_quantize_base
from cullavo_tpu_torch.models.from_config import xdecoder_model_config_from
from cullavo_tpu_torch.models.llava.modeling import GenerationConfig, init_llava_params
from cullavo_tpu_torch.models.xdecoder.model import init_xdecoder_model_params
from cullavo_tpu_torch.pipelines import cullavo_pipeline  # noqa: F401 (registration)
from cullavo_tpu_torch.pipelines import vqa_pipeline  # noqa: F401 (registration)
from cullavo_tpu_torch.pipelines import xdecoder_pipeline  # noqa: F401 (registration)
from cullavo_tpu_torch.pipelines.base import build_pipeline
from cullavo_tpu_torch.pipelines.vl_zoo_pipeline import (MODEL_SPECS, VLZooVQAPipeline,
                                                         native_blip2_answer_fn,
                                                         native_kosmos2_answer_fn)
from cullavo_tpu_torch.serving import Request, ServingEngine
from cullavo_tpu_torch.serving.io import request_from_row


def _device(device):
    """``None`` means the GPU, and raises where there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def smoke_llava_config():
    """The tiny random model of the smoke modes: the JAX package's
    ``tiny_llava_config(260)`` with its two text heads widened to the head
    dim of 128 that the attention kernels take, so that the same model runs
    on the card and on the CPU."""
    cfg = tiny_llava_config(260)
    text = dataclasses.replace(cfg.text, hidden_size=256, intermediate_size=512,
                               num_attention_heads=2, num_key_value_heads=2)
    return dataclasses.replace(cfg, text=text)


def _build_llava(cfg: dict, device):
    """(model config, params on ``device``, tokenizer) from ``MODEL.LLM``:
    a local HF snapshot (``LOAD_PATH``), or the tiny random smoke model; then
    the base quantization of ``BITS`` (4 = NF4, 8 = int8)."""
    llm_cfg = (cfg.get("MODEL") or {}).get("LLM") or {}
    model_path = llm_cfg.get("LOAD_PATH")
    if model_path:
        model_cfg = llava_config_from_json(model_path)
        # before the weights: a snapshot without a tokenizer fails at once
        tokenizer = HFTokenizer(model_path)
        params = load_llava_safetensors(model_path, model_cfg, device=device)
    else:
        print("[entry] no MODEL.LLM.LOAD_PATH: using tiny random model (smoke mode)",
              file=sys.stderr)
        model_cfg = smoke_llava_config()
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_llava_params(model_cfg, gen, device)
        tokenizer = ByteTokenizer()
    # the reference loads the LLM quantized (BITS: 4 = NF4 Q-LoRA base,
    # 8 = int8): honor it
    params = maybe_quantize_base(params, int(llm_cfg.get("BITS") or 0))
    return model_cfg, params, tokenizer


def _engine_from_cfg(scfg: dict, model_cfg, params, tokenizer, buckets, max_len):
    """``SERVE.*`` config block -> (GenerationConfig, ServingEngine)."""
    if scfg.get("ADAPTERS"):
        raise NotImplementedError("SERVE.ADAPTERS: per-request adapter sets wait for the "
                                  "multi-adapter serving slice")
    default_eos = getattr(tokenizer, "eos_token_id", 2)
    gen = GenerationConfig(
        do_sample=bool(scfg.get("DO_SAMPLE", False)),
        temperature=float(scfg.get("TEMPERATURE", 0.9)),
        eos_token_id=int(scfg.get("EOS_TOKEN_ID", 2 if default_eos is None else default_eos)))
    eng = ServingEngine(
        params, model_cfg, gen,
        num_slots=int(scfg.get("SLOTS", 8)), max_len=max_len,
        prompt_buckets=buckets,
        prefill_chunk=int(scfg.get("PREFILL_CHUNK", 2)),
        quantum=int(scfg.get("QUANTUM", 8)),
        kv_quant=scfg.get("KV_QUANT") or None,
        compute_dtype=(torch.bfloat16 if str(scfg.get("DTYPE", "bfloat16")) == "bfloat16"
                       else torch.float32),
        spec_k=int(scfg["SPEC_K"]) if scfg.get("SPEC_K") else None,
        prefix_cache=bool(scfg.get("PREFIX", True)),
        prefix_min=int(scfg.get("PREFIX_MIN", 32)),
        suffix_buckets=tuple(scfg.get("SUFFIX_BUCKETS") or (32, 64, 128)),
        max_prefixes=int(scfg["MAX_PREFIXES"]) if scfg.get("MAX_PREFIXES") else None,
        admit_groups=(None if scfg.get("ADMIT_GROUPS", 1) in (None, 0)
                      else int(scfg.get("ADMIT_GROUPS", 1))))
    return gen, eng


def serve(cfg: dict, device=None) -> dict:
    """Serving workload: run the continuous-batching engine over a JSONL
    request stream and write a JSONL result stream.

    Request rows: ``{"id": int, "prompt": str | "input_ids": [int, ...],
    "image": path(.npy [3,H,W] f32) | nested list, "max_new_tokens": int}``.
    With ``SERVE.REQUESTS`` unset, a few random smoke requests are
    synthesized.  Returns (and prints) the run's summary."""
    device = _device(device)
    model_cfg, params, tokenizer = _build_llava(cfg, device)
    scfg = cfg.get("SERVE", {}) or {}
    n_img = model_cfg.num_image_tokens
    if scfg.get("PORT") is not None:
        raise NotImplementedError("SERVE.PORT: the HTTP server waits for a later slice")

    req_path = scfg.get("REQUESTS")
    if req_path:
        with open(req_path) as f:
            reqs = [request_from_row(json.loads(line), model_cfg, tokenizer)
                    for line in f if line.strip()]
    else:
        print("[entry] no SERVE.REQUESTS: synthesizing 4 random smoke requests",
              file=sys.stderr)
        rng = np.random.default_rng(0)
        reqs = []
        side = model_cfg.vision.image_size
        for i in range(4):
            ids = rng.integers(3, model_cfg.text.vocab_size - 2,
                               size=(1 + n_img + 4 + i,)).astype(np.int32)
            ids[1:1 + n_img] = model_cfg.image_token_id
            pix = rng.normal(size=(3, side, side)).astype(np.float32)
            reqs.append(Request(req_id=i, input_ids=ids, pixel_values=pix,
                                max_new_tokens=4 + 2 * i))

    # buckets: configured, or derived from the request lengths (64-multiples)
    buckets = scfg.get("PROMPT_BUCKETS") or sorted(
        {-(-len(r.input_ids) // 64) * 64 for r in reqs})
    max_new_max = max(r.max_new_tokens for r in reqs)
    max_len = int(scfg.get("MAX_LEN", max(buckets) + max_new_max))
    gen, eng = _engine_from_cfg(scfg, model_cfg, params, tokenizer, buckets, max_len)
    for r in reqs:
        eng.submit(r)
    t0 = time.time()
    results = eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0

    out_path = scfg.get("RESULTS", "serve_results.jsonl")
    with open(out_path, "w") as f:
        for r in reqs:
            toks = results[r.req_id]
            text = tokenizer.decode(toks[:-1] if toks and toks[-1] == gen.eos_token_id else toks)
            f.write(json.dumps({"id": r.req_id, "tokens": toks, "text": text}) + "\n")
    summary = {"requests": len(reqs),
               "tokens": sum(len(v) for v in results.values()),
               "wall_s": round(dt, 3),
               "requests_per_s": round(len(reqs) / max(dt, 1e-9), 3),
               "results": out_path}
    print(json.dumps(summary))
    return summary


def _smoke_records():
    """Two synthetic step-1 records: a random 64 x 64 image with two boxed
    "thing" instances each."""
    rng = np.random.default_rng(0)
    return [{"image": rng.integers(0, 255, (64, 64, 3), dtype=np.uint8),
             "classes": np.asarray([0, 2]),
             "boxes": np.asarray([[4, 4, 30, 30], [10, 12, 40, 44]], np.float32),
             "is_thing": np.asarray([True, True])} for _ in range(2)]


def train(cfg: dict, device=None) -> dict:
    """Training workload.  Without ``DATASETS.TRAIN``: one smoke step of the
    Q-LoRA train step (``CuLLaVOPipeline``) on synthetic records; returns
    (and prints) its metrics, ``loss_llm`` and ``grad_norm``."""
    if "xdecoder" in cfg.get("NAME", ""):
        raise NotImplementedError("X-Decoder training waits for the training part of the "
                                  "X-Decoder slice")
    if cfg.get("RESUME_FROM"):
        raise NotImplementedError("RESUME_FROM (reference-layout checkpoints) waits for the "
                                  "training-loop slice")
    if (cfg.get("DATASETS") or {}).get("TRAIN"):
        raise NotImplementedError("DATASETS.TRAIN (the dataset path and the training loop) "
                                  "waits for the training-loop slice")
    device = _device(device)
    model_cfg, params, tokenizer = _build_llava(cfg, device)
    # the prompts carry the tokenizer's <image> id; the model merges image
    # features at its config's id: make them one
    model_cfg = dataclasses.replace(model_cfg, image_token_id=tokenizer.image_token_id)
    pipe = build_pipeline(cfg.get("PIPELINE", "CuLLaVOPipeline"), cfg, model_cfg=model_cfg,
                          tokenizer=tokenizer, params=params)
    state = pipe.initialize_model()
    print("[entry] no DATASETS.TRAIN configured: smoke step only", file=sys.stderr)
    batch = pipe.make_batch(_smoke_records(), pad_to=None)
    state, metrics = pipe.forward_step(state, batch, torch.Generator().manual_seed(0))
    metrics = {k: float(v) for k, v in metrics.items()}
    print(metrics)
    return metrics


def _dataset_names(cfg: dict) -> list:
    names = (cfg.get("DATASETS") or {}).get("TEST")
    if not names:
        return []
    return [names] if isinstance(names, str) else list(names)


def _make_text_tokenize(cfg: dict, text_cfg):
    """``tokenize(texts) -> (ids, mask)`` padded to the context length: the
    deterministic md5 word hash of the smoke mode (a CLIP BPE tokenizer,
    ``MODEL.TEXT.TOKENIZER``, waits for the checkpoint slice)."""
    if ((cfg.get("MODEL") or {}).get("TEXT") or {}).get("TOKENIZER"):
        raise NotImplementedError("MODEL.TEXT.TOKENIZER (the CLIP BPE tokenizer) waits for the "
                                  "checkpoint slice; leave it unset for the hash tokenizer")
    T, V = text_cfg.context_length, text_cfg.vocab_size

    def _word_id(w: str) -> int:
        # md5, not hash(): the same table in every process and run
        h = int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little")
        return 2 + h % (V - 3)

    def tokenize(texts):
        ids = np.zeros((len(texts), T), np.int32)
        mask = np.zeros((len(texts), T), np.int32)
        for i, t in enumerate(texts):
            row = [1] + [_word_id(w) for w in t.lower().split()[: T - 2]]
            ids[i, :len(row)] = row
            ids[i, len(row)] = V - 1          # EOT = the argmax id (CLIP convention)
            mask[i, :len(row) + 1] = 1
        return ids, mask

    return tokenize


def _load_xdecoder_params(cfg: dict, model_cfg, device):
    """Random weights from seed 0 (smoke mode); ``RESUME_FROM`` waits for
    the checkpoint slice."""
    if cfg.get("RESUME_FROM"):
        raise NotImplementedError("RESUME_FROM (X-Decoder checkpoints) waits for the "
                                  "checkpoint slice")
    print("[entry] no RESUME_FROM: random weights (smoke mode)", file=sys.stderr)
    return init_xdecoder_model_params(model_cfg, torch.Generator(device=device).manual_seed(0),
                                      device)


def register_datasets_from_cfg(cfg: dict) -> None:
    """``DATASETS.REGISTER: {name: {KIND: vqa, QUESTIONS_JSON, ANNOTATIONS_JSON,
    IMAGE_DIR, IMAGE_TEMPLATE}}``.  The other kinds and the bulk registration
    from a ``DETECTRON2_DATASETS`` / ``DATASET`` root raise: they wait for
    the slices that evaluate them (the JAX entry swallows the bulk errors)."""
    root = os.environ.get("DETECTRON2_DATASETS") or os.environ.get("DATASET")
    if root and os.path.isdir(root):
        raise NotImplementedError(f"bulk dataset registration from {root!r} waits for the "
                                  "X-Decoder data slice; unset DETECTRON2_DATASETS / DATASET")
    for name, spec in dict((cfg.get("DATASETS") or {}).get("REGISTER") or {}).items():
        kind = spec.get("KIND", "semseg")
        if kind != "vqa":
            raise NotImplementedError(f"DATASETS.REGISTER kind {kind!r} ({name}): only 'vqa' "
                                      "is ported")
        kw = {"image_template": str(spec["IMAGE_TEMPLATE"])} if spec.get("IMAGE_TEMPLATE") else {}
        register_vqa(name, spec["QUESTIONS_JSON"], spec.get("ANNOTATIONS_JSON"),
                     spec["IMAGE_DIR"], **kw)


def _eval_vl(cfg: dict, device) -> dict:
    """vl_test: LLaVA (``MODEL.LLM``) through the VQA pipeline of ``PIPELINE``
    over each ``DATASETS.TEST`` entry, with ``KV_QUANT``, ``SPEC_K``,
    ``BATCH_SIZE``, ``MAX_NEW_TOKENS``, ``LIMIT`` and ``SAVE_DIR``."""
    model = cfg.get("MODEL") or {}
    if model.get("ZOO"):
        return _eval_vl_zoo(cfg, model["ZOO"], device)
    if model.get("TOPIC"):
        raise NotImplementedError("MODEL.TOPIC (the per-class topic classifier) waits for the "
                                  "rest of the VL-zoo slice")
    model_cfg, params, tokenizer = _build_llava(cfg, device)
    extra = {}
    if cfg.get("KV_QUANT"):
        extra["kv_quant"] = cfg["KV_QUANT"]
    if cfg.get("SPEC_K"):
        extra["spec_k"] = int(cfg["SPEC_K"])
    pipe = build_pipeline(cfg.get("PIPELINE", "LLaVAVQAVALPipeline"), cfg,
                          model_cfg=model_cfg, tokenizer=tokenizer, params=params,
                          batch_size=int(cfg.get("BATCH_SIZE", 8)),
                          max_new_tokens=int(cfg.get("MAX_NEW_TOKENS", 16)), **extra)
    limit = int(cfg.get("LIMIT", 0)) or None
    mapper = VQAEvalMapper(image_size=model_cfg.vision.image_size)
    return {name: pipe.evaluate_model(map(mapper, get_dataset(name)), limit=limit,
                                      out_dir=cfg.get("SAVE_DIR"))
            for name in _dataset_names(cfg)}


def _eval_vl_zoo(cfg: dict, zoo: str, device) -> dict:
    """vl_test with a zoo tower (``MODEL.ZOO``): the native answerer with
    the tiny config and seeded random weights (the JAX entry's
    checkpoint-free path) through ``VLZooVQAPipeline`` over each
    ``DATASETS.TEST`` entry, ``MAX_NEW_TOKENS`` (10), ``LIMIT`` and
    ``SAVE_DIR``.  BLIP-2 (Flan-T5) and KOSMOS-2 run; the rest raise."""
    model = cfg.get("MODEL") or {}
    if zoo not in MODEL_SPECS:
        raise SystemExit(f"unknown MODEL.ZOO {zoo!r}; one of {sorted(MODEL_SPECS)}")
    if model.get("ZOO_PATH"):
        raise NotImplementedError("MODEL.ZOO_PATH (a local HF snapshot of a zoo model) waits for "
                                  "the zoo snapshot slice: its Unigram and WordPiece tokenizers")
    if model.get("ZOO_TORCH"):
        raise NotImplementedError("MODEL.ZOO_TORCH (the transformers harness) has no counterpart: "
                                  "the port answers through its native towers")
    if zoo == "instructblip":
        raise NotImplementedError("MODEL.ZOO: instructblip (Vicuna tower, text-input Q-Former) "
                                  "waits for the InstructBLIP slice")
    if zoo == "bakllava":
        raise NotImplementedError("MODEL.ZOO: bakllava (Mistral's sliding-window attention) "
                                  "waits for the BakLLaVA slice")
    mnt = int(cfg.get("MAX_NEW_TOKENS", 10))
    if zoo == "blip2":
        answer_fn = native_blip2_answer_fn(max_new_tokens=mnt, device=device)
        img_size = tiny_blip2_config("t5").vision.image_size
    else:
        answer_fn = native_kosmos2_answer_fn(max_new_tokens=mnt, device=device)
        img_size = tiny_kosmos2_config().vision.image_size
    pipe = VLZooVQAPipeline(cfg, zoo, answer_fn=answer_fn)
    limit = int(cfg.get("LIMIT", 0)) or None
    mapper = VQAEvalMapper(image_size=img_size)
    out_dir = cfg.get("SAVE_DIR")
    results = {}
    for name in _dataset_names(cfg):
        def rows():
            for rec in get_dataset(name):
                m = mapper(rec)
                m["image"] = m.pop("pixel_values")
                yield m
        results[name] = pipe.evaluate_model(rows(), limit=limit)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            pipe.evaluator.dump_results(os.path.join(out_dir, "vqa_results.json"))
    return results


def _eval_xdecoder(cfg: dict, device) -> dict:
    """The xdecoder workload: the model, its weights and the text tokenizer
    from the config, then ``XDecoderPipeline`` per ``DATASETS.TEST`` entry."""
    model_cfg = xdecoder_model_config_from(cfg)
    _load_xdecoder_params(cfg, model_cfg, device)
    _make_text_tokenize(cfg, model_cfg.text)
    if _dataset_names(cfg):
        raise NotImplementedError("DATASETS.TEST for the X-Decoder: its dataset kinds and eval "
                                  "mappers wait for the X-Decoder data slice")
    return {}


def evaluate(cfg: dict, device=None) -> dict:
    """Eval workload by ``NAME``: ``vl_test`` and ``xdecoder*`` run here;
    step2-pre data generation and ImageNet wait for their slices."""
    device = _device(device)
    register_datasets_from_cfg(cfg)
    name = cfg.get("NAME", "")
    if "step2_pre" in name:
        raise NotImplementedError("step2-pre data generation waits for the training-loop slice")
    if "imagenet" in name:
        raise NotImplementedError("ImageNet eval waits for the rest of the VL-zoo slice")
    if "vl_test" in name or name == "vl":
        results = _eval_vl(cfg, device)
    elif "xdecoder" in name:
        results = _eval_xdecoder(cfg, device)
    else:
        print(f"[entry] unknown eval workload {name!r} (expect one of xdecoder_test / "
              "vl_test / imagenet_test / cullavo_step2_pre)", file=sys.stderr)
        raise SystemExit(2)
    print(json.dumps(results, default=float))
    return results
