"""Entry points of the port (counterpart of ``cullavo_tpu/entry.py``):
``main``, the command line (``python -m cullavo_tpu_torch
{train,eval,serve} --conf_files ... [--config_overrides JSON] [--overrides
K V ...]``, read by the port's own config reader); ``serve``, the
continuous-batching engine over a JSONL request stream or, with
``SERVE.PORT``, behind the HTTP front end (``serving/server.py``), greedy
or sampled (``DO_SAMPLE``), with runtime LoRA adapters (``ADAPTERS``: one
directory for every request, or several picked per request by
``adapter_id``); ``train`` (the
Q-LoRA epoch loop over a registered COCO-panoptic dataset with
``step_{N}`` and reference ``epoch{N}`` checkpoints and ``RESUME_FROM``,
or one smoke step on synthetic records); and ``evaluate`` for the VL eval
(``vl_test``: LLaVA from a local HF snapshot or the smoke model, with the
question-topic classifier of ``MODEL.TOPIC`` (``tiny``, or
``{LLAMA_PATH, CLIP_PATH}`` snapshots), or a zoo tower, BLIP-2 Flan-T5,
InstructBLIP, KOSMOS-2 or BakLLaVA, from a local HF snapshot
(``MODEL.ZOO_PATH``) or, but for BakLLaVA, with tiny random weights, over
registered VQA datasets), the zero-shot ImageNet eval (``imagenet_test``:
the BLIP-2 family's Q-Former text and image embeddings, from an
InstructBLIP snapshot or tiny random weights, over registered ``imagenet``
class folders), the step2_pre data generation
(``cullavo_step2_pre``: sampled captions with boxes over a registered
``conversations`` dataset) and the X-Decoder workloads: joint training
(``train`` with an "xdecoder" ``NAME``, over registered
``coco_panoptic_caption_grounding`` datasets) and eval (``RESUME_FROM`` a
reference checkpoint or the port's own, the CLIP BPE tokenizer of
``MODEL.TEXT.TOKENIZER``, then ``XDecoderPipeline``, ``RefCOCOPipeline``,
``VLPRetrievalPipeline`` or ``COCOCaptionXDecPipeline`` per
``DATASETS.TEST`` entry over registered ``semseg``, ``coco_panoptic`` and
``refcoco`` datasets or the bulk table under ``DETECTRON2_DATASETS``, the
VLP Arrow splits of its ``vlp`` directory included).

``MODEL.LLM.LOAD_PATH`` names a local snapshot: ``config.json``,
``*.safetensors`` shards and ``tokenizer.json`` (read by the port's own
readers, kept in the snapshot's dtype, loaded onto the device).  A missing
file raises; the JAX entry's quiet fallbacks (the 7B config, the byte
tokenizer) are not copied.

The entry points take the parsed config as a dict (the layout of
``configs/serve.yaml``) and run on the GPU unless the caller names another
device; ``main`` too (its ``device`` is a keyword for tests, not a flag).
Several processes come with a later slice.
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
from cullavo_tpu_torch.checkpoint.reference_layout import (load_reference_layout,
                                                           save_reference_layout)
from cullavo_tpu_torch.checkpoint.store import load_adapters, load_checkpoint, save_checkpoint
from cullavo_tpu_torch.checkpoint.xdecoder_import import (align_and_update,
                                                          import_xdecoder_checkpoint, unused_keys)
from cullavo_tpu_torch.config import load_opt_command
from cullavo_tpu_torch.data.coco_caption_grounding import (
    JointTrainMapper, collate_joint, register_coco_panoptic_caption_grounding)
from cullavo_tpu_torch.data.clip_tokenizer import CLIPTokenizer
from cullavo_tpu_torch.data.coco_panoptic import (PanopticMapper, load_image_file,
                                                   register_coco_panoptic)
from cullavo_tpu_torch.data.datasets import (load_semseg_pairs, register_all_segmentation,
                                             register_imagenet, register_refcoco, register_vqa)
from cullavo_tpu_torch.data.image_processing import preprocess_numpy
from cullavo_tpu_torch.data.instruction_data import load_conversation_json
from cullavo_tpu_torch.data.mappers.eval_mappers import (PanopticEvalMapper, RefCOCOEvalMapper,
                                                         SemSegEvalMapper, VQAEvalMapper,
                                                         normalize_np)
from cullavo_tpu_torch.data.registry import get_dataset, get_metadata, register_dataset
from cullavo_tpu_torch.data.step1_synthesis import SYSTEM_PROMPT
from cullavo_tpu_torch.data.tokenizer import ByteTokenizer, HFTokenizer
from cullavo_tpu_torch.models.blip2 import tiny_blip2_config
from cullavo_tpu_torch.models.kosmos2 import tiny_kosmos2_config
from cullavo_tpu_torch.models.llava.config import smoke_llava_config
from cullavo_tpu_torch.models.llava.lora import maybe_quantize_base, stack_adapter_sets
from cullavo_tpu_torch.models.from_config import xdecoder_model_config_from
from cullavo_tpu_torch.models.llava.modeling import (GenerationConfig, expand_image_token,
                                                     init_llava_params)
from cullavo_tpu_torch.models.xdecoder.model import init_xdecoder_model_params
from cullavo_tpu_torch.models.xdecoder.text_encoder import class_embeddings_ensembled
from cullavo_tpu_torch.pipelines import cullavo_pipeline  # noqa: F401 (registration)
from cullavo_tpu_torch.pipelines import vlp_pipeline  # noqa: F401 (registration)
from cullavo_tpu_torch.pipelines import vqa_pipeline  # noqa: F401 (registration)
from cullavo_tpu_torch.pipelines import xdecoder_pipeline  # noqa: F401 (registration)
from cullavo_tpu_torch.pipelines.base import build_pipeline
from cullavo_tpu_torch.pipelines.imagenet_pipeline import ImageNetPipeline
from cullavo_tpu_torch.pipelines.xdecoder_pipeline import EvalTasks, tasks_for_dataset
from cullavo_tpu_torch.pipelines.vl_zoo_pipeline import (MODEL_SPECS, VLZooVQAPipeline,
                                                         native_bakllava_answer_fn,
                                                         native_blip2_answer_fn,
                                                         native_blip2_imagenet_fns,
                                                         native_kosmos2_answer_fn)
from cullavo_tpu_torch.pipelines.vqa_pipeline import make_reference_topic_fn, make_tiny_topic_fn
from cullavo_tpu_torch.serving import Request, ServingEngine
from cullavo_tpu_torch.serving.io import request_from_row
from cullavo_tpu_torch.serving.server import make_server
from cullavo_tpu_torch.trainer.loop import LoopConfig, train_loop
from cullavo_tpu_torch.trainer.optimizer import xdecoder_optimizer
from cullavo_tpu_torch.trainer.step import TrainState
from cullavo_tpu_torch.trainer.xdecoder_step import make_xdecoder_joint_train_step
from cullavo_tpu_torch.utils import constants
from cullavo_tpu_torch.utils.tree import tree_map


def _device(device):
    """``None`` means the GPU, and raises where there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


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


def _load_serving_adapters(scfg: dict, model_cfg, params):
    """``SERVE.ADAPTERS: [dir, ...]`` -> (lora tree on the parameters'
    device in the stored dtype, scaling), or (None, 0.0) without it.

    One directory: the reference's eval mode (unmerged adapters over the
    quantized base), its vision-tower adapters included.  Several: one multi
    stack of their LLM adapters (``stack_adapter_sets``), each request
    picking one by ``adapter_id`` (its index in the list).  The scaling is
    ``SERVE.LORA_SCALING`` when given, else each ``adapter_config.json``'s
    ``scaling`` (or ``alpha / r``).  Raises, where the JAX entry carries on:
    several directories of which one holds vision-tower adapters (the multi
    path is LLM-only, so those sets would answer otherwise than alone), and
    several directories whose scalings differ without ``LORA_SCALING`` (JAX
    serves them all at the last one's)."""
    paths = scfg.get("ADAPTERS") or []
    if not paths:
        return None, 0.0
    device = params["language_model"]["embed_tokens"].device
    sets, vision, scales = [], [], []
    for p in paths:
        tree, acfg = load_adapters(p)
        sets.append(tree["language_model"])
        vision.append(tree.get("vision_tower") or None)
        scales.append(float(acfg.get("scaling")
                            or float(acfg.get("alpha", 16.0)) / float(acfg.get("r", 64))))
    if scfg.get("LORA_SCALING") is not None:
        scale = float(scfg["LORA_SCALING"])
    elif len(set(scales)) > 1:
        raise ValueError(f"SERVE.ADAPTERS: the sets' scalings differ "
                         f"({dict(zip(paths, scales))}) and one scaling serves them all: "
                         "set SERVE.LORA_SCALING")
    else:
        scale = scales[0]
    if len(sets) == 1:
        lora = {"language_model": sets[0]}
        if vision[0]:
            lora["vision_tower"] = vision[0]
    else:
        lost = [p for p, v in zip(paths, vision) if v]
        if lost:
            raise ValueError(f"SERVE.ADAPTERS: multi-adapter serving is LLM-only, and the "
                             f"vision-tower adapters of {lost} would be lost (serve such a "
                             "set alone)")
        lora = {"language_model": stack_adapter_sets(sets)}
    return tree_map(lambda a: a.to(device), lora), scale


def _engine_from_cfg(scfg: dict, model_cfg, params, tokenizer, buckets, max_len):
    """``SERVE.*`` config block -> (GenerationConfig, ServingEngine)."""
    lora, lora_scaling = _load_serving_adapters(scfg, model_cfg, params)
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
        lora=lora, lora_scaling=lora_scaling,
        spec_k=int(scfg["SPEC_K"]) if scfg.get("SPEC_K") else None,
        prefix_cache=bool(scfg.get("PREFIX", True)),
        prefix_min=int(scfg.get("PREFIX_MIN", 32)),
        suffix_buckets=tuple(scfg.get("SUFFIX_BUCKETS") or (32, 64, 128)),
        max_prefixes=int(scfg["MAX_PREFIXES"]) if scfg.get("MAX_PREFIXES") else None,
        admit_groups=(None if scfg.get("ADMIT_GROUPS", 1) in (None, 0)
                      else int(scfg.get("ADMIT_GROUPS", 1))))
    return gen, eng


def _serve_http(scfg: dict, model_cfg, params, tokenizer):
    """``SERVE.PORT`` set: run the HTTP endpoint until interrupted (SIGINT
    stops the scheduler and closes the socket).  Buckets are fixed up
    front: ``SERVE.PROMPT_BUCKETS``, by default one bucket for an image and
    72 text tokens; ``MAX_LEN`` defaults to the largest bucket plus
    ``MAX_NEW_TOKENS_MAX`` (64).  Prints ``[entry] serving on
    http://host:port`` on stderr once bound; returns the (closed) server."""
    n_img = model_cfg.num_image_tokens
    buckets = scfg.get("PROMPT_BUCKETS") or [-(-(1 + n_img + 72) // 64) * 64]
    max_new_max = int(scfg.get("MAX_NEW_TOKENS_MAX", 64))
    max_len = int(scfg.get("MAX_LEN", max(buckets) + max_new_max))
    _, eng = _engine_from_cfg(scfg, model_cfg, params, tokenizer, buckets, max_len)
    server = make_server(eng, model_cfg, tokenizer, host=str(scfg.get("HOST", "127.0.0.1")),
                         port=int(scfg.get("PORT", 0)),
                         timeout_s=float(scfg.get("TIMEOUT_S", 300.0)))
    host, port = server.server_address[:2]
    print(f"[entry] serving on http://{host}:{port} (buckets={buckets}, max_len={max_len})",
          file=sys.stderr, flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.runner.stop()
        server.server_close()
    return server


def serve(cfg: dict, device=None):
    """Serving workload: run the continuous-batching engine over a JSONL
    request stream and write a JSONL result stream, or with ``SERVE.PORT``
    serve HTTP (``_serve_http``) until interrupted.

    Request rows: ``{"id": int, "prompt": str | "input_ids": [int, ...],
    "image": path(.npy [3,H,W] f32) | nested list, "max_new_tokens": int,
    "adapter_id": int}``.  With ``SERVE.REQUESTS`` unset, a few random smoke
    requests are synthesized.  Returns (and prints) the run's summary; the
    HTTP mode returns the closed server."""
    device = _device(device)
    model_cfg, params, tokenizer = _build_llava(cfg, device)
    scfg = cfg.get("SERVE", {}) or {}
    n_img = model_cfg.num_image_tokens
    if scfg.get("PORT") is not None:
        return _serve_http(scfg, model_cfg, params, tokenizer)

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
    """Training workload (``configs/cullavo_step1.yaml``): LLaVA from
    ``MODEL.LLM`` (a snapshot, or the tiny smoke model) with the base
    quantized at ``BITS``, the Q-LoRA state of ``CuLLaVOPipeline``, the
    trainable partition read from ``RESUME_FROM`` when set (the reference
    ``epoch{N}`` layout; the optimizer state stays fresh, as in JAX).

    With ``DATASETS.TRAIN`` (a registered dataset; ``DATASETS.REGISTER``
    registers it first): the epoch loop over its records, mapped lazily by
    ``PanopticMapper`` at the vision tower's resolution, shuffled per epoch
    by ``np.random.default_rng(epoch)``, in batches of ``BATCH_SIZE`` (a
    record that maps to None is skipped; the short tail is dropped), with
    ``EPOCHS``, ``PERIOD``, ``LOG_EVERY`` and ``SAVE_DIR`` (each save writes
    ``step_{N}/`` and ``epoch{N}/``); returns ``{"state", "history"}``.
    Without it: one smoke step on synthetic records; returns (and prints)
    its metrics, ``loss_llm`` and ``grad_norm``.  A conversations dataset in
    ``DATASETS.TRAIN`` raises a ``ValueError`` before the model is built.
    A ``NAME`` with "xdecoder" goes to ``train_xdecoder``."""
    register_datasets_from_cfg(cfg)
    if "xdecoder" in cfg.get("NAME", ""):
        return train_xdecoder(cfg, device=device)
    dataset_name = (cfg.get("DATASETS") or {}).get("TRAIN")
    records = get_dataset(dataset_name) if dataset_name else []
    if records and "conversations" in records[0]:
        raise ValueError(f"DATASETS.TRAIN {dataset_name!r} is a conversations dataset: the "
                         "training loop takes coco_panoptic records (step-2 training on "
                         "conversations is no path of the JAX entry either; there its rows "
                         "fail in PanopticMapper)")
    device = _device(device)
    model_cfg, params, tokenizer = _build_llava(cfg, device)
    # the prompts carry the tokenizer's <image> id; the model merges image
    # features at its config's id: make them one
    model_cfg = dataclasses.replace(model_cfg, image_token_id=tokenizer.image_token_id)
    pipe = build_pipeline(cfg.get("PIPELINE", "CuLLaVOPipeline"), cfg, model_cfg=model_cfg,
                          tokenizer=tokenizer, params=params)
    state = pipe.initialize_model()
    if cfg.get("RESUME_FROM"):
        state = TrainState(load_reference_layout(cfg["RESUME_FROM"], state.trainable),
                           state.opt_state, state.step)
        pipe.state = state
        print(f"[entry] resumed trainable state from {cfg['RESUME_FROM']}", file=sys.stderr)

    if not dataset_name:
        print("[entry] no DATASETS.TRAIN configured: smoke step only", file=sys.stderr)
        batch = pipe.make_batch(_smoke_records(), pad_to=None)
        state, metrics = pipe.forward_step(state, batch, torch.Generator().manual_seed(0))
        metrics = {k: float(v) for k, v in metrics.items()}
        print(metrics)
        return metrics

    batch_size = int(cfg.get("BATCH_SIZE", 8))
    mapper = PanopticMapper(image_size=model_cfg.vision.image_size)

    def data_iter(epoch):
        order = np.random.default_rng(epoch).permutation(len(records))
        buf = []
        for j in order:
            rec = records[j] if "is_thing" in records[j] else mapper(records[j])
            if rec is not None:
                buf.append(rec)
            if len(buf) == batch_size:
                yield pipe.make_batch(buf)
                buf = []

    def save_fn(save_dir, global_step, st, epoch):
        save_checkpoint(save_dir, global_step, st)
        ep = save_reference_layout(save_dir, epoch, st.trainable, pipe.lora_cfg)
        print(f"[entry] reference-layout checkpoint at {ep}", file=sys.stderr)

    loop_cfg = LoopConfig(max_epochs=int(cfg.get("EPOCHS", 1)),
                          checkpoint_period=int(cfg.get("PERIOD", 0) or 0),
                          log_every=int(cfg.get("LOG_EVERY", 10)),
                          save_dir=cfg.get("SAVE_DIR"))
    state, history = train_loop(state, pipe.frozen, pipe.step_fn, data_iter,
                                steps_per_epoch=len(records) // batch_size, cfg=loop_cfg,
                                rng=torch.Generator().manual_seed(0),
                                log_fn=lambda d: print(d, file=sys.stderr), save_fn=save_fn)
    return {"state": state, "history": history}


def _resolve_class_names(ds_name: str, md: dict) -> list:
    """A dataset's class vocabulary: its ``class_names`` metadata, else the
    table its ``class_names_key`` names (bulk registration writes one), else
    the table of a fragment of its name (``constants.class_names_for``).
    Anything else raises: the JAX entry's last resort, COCO's names for any
    dataset, is a silent fallback the port does not copy."""
    if md.get("class_names"):
        return list(md["class_names"])
    key = md.get("class_names_key") or constants.class_names_key_for(ds_name)
    if key is None:
        raise ValueError(f"no class names for dataset {ds_name!r}: give CLASS_NAMES, or a "
                         "name with a fragment of constants._DATASET_CLASS_KEYS")
    return constants.class_names_by_key(key)


def train_xdecoder(cfg: dict, device=None):
    """X-Decoder joint training (``NAME`` with "xdecoder"): the model, its
    weights (seed 0) and the text tokenizer from the config,
    ``xdecoder_optimizer`` (``SOLVER.BASE_LR``, ``MAX_ITER``,
    ``CLIP_VALUE``), the joint step (``REMAT``, default on; bf16 compute over
    f32 masters unless ``FP32_TRAIN``), then the epochs over every
    ``DATASETS.TRAIN`` dataset (class names from ``CLASS_NAMES`` or, for a
    COCO dataset, the COCO panoptic table):
    records in ``np.random.default_rng(SEED)`` order through
    ``JointTrainMapper`` (``INPUT.IMAGE_SIZE``), constant batches of
    ``BATCH_SIZE`` (records that map to None are skipped, the tail dropped),
    collated by ``collate_joint`` (``MAX_INSTANCES``).  ``SAVE_DIR``: the
    parameters through the npz store at the last step.  Without
    ``DATASETS.TRAIN``, returns None after building the model, as JAX
    does; else ``{"state", "history"}`` (every step's metrics as floats).
    One process: a ``MESH_*`` other than 0 raises."""
    if any(int(cfg.get(k, 0) or 0) != 0 for k in ("MESH_DATA", "MESH_FSDP", "MESH_TENSOR")):
        raise NotImplementedError("MESH_*: the sharded X-Decoder step waits for the "
                                  "multi-process training slice")
    device = _device(device)
    model_cfg = xdecoder_model_config_from(cfg)
    params = _load_xdecoder_params(cfg, model_cfg, device)
    tokenize = _make_text_tokenize(cfg, model_cfg.text)
    sol = cfg.get("SOLVER") or {}
    tx = xdecoder_optimizer(base_lr=float(sol.get("BASE_LR", 1e-4)),
                            total_steps=int(sol.get("MAX_ITER", 1000)),
                            grad_clip=float(sol.get("CLIP_VALUE", 0.01)))
    state = TrainState(params, tx.init(params), 0)
    step_fn = make_xdecoder_joint_train_step(
        model_cfg, tx, remat=bool(cfg.get("REMAT", True)),
        compute_dtype=None if cfg.get("FP32_TRAIN") else torch.bfloat16)
    names = (cfg.get("DATASETS") or {}).get("TRAIN")
    if isinstance(names, str):
        names = [names]
    if not names:
        print("[entry] no DATASETS.TRAIN: nothing to do", file=sys.stderr)
        return None
    records = [r for nm in names for r in get_dataset(nm)]
    md = get_metadata(names[0]) or {}
    class_names = _resolve_class_names(names[0], md)
    image_size = int((cfg.get("INPUT") or {}).get("IMAGE_SIZE", 512))
    mapper = JointTrainMapper(image_size=image_size, class_names=class_names)
    cls_ids, cls_mask = tokenize([f"a photo of a {c}." for c in class_names]
                                 + ["A background in coco."])
    batch_size = int(cfg.get("BATCH_SIZE", 8))
    seed = int(cfg.get("SEED", 0))
    rng_np = np.random.default_rng(seed)
    generator = torch.Generator(device=device).manual_seed(seed)
    history = []

    def full_batches(order):
        buf = []
        for j in order:
            m = mapper(records[j])
            if m is not None:
                buf.append(m)
                if len(buf) == batch_size:
                    yield buf
                    buf = []

    for _ in range(int(cfg.get("EPOCHS", 1))):
        for mapped in full_batches(rng_np.permutation(len(records))):
            batch = collate_joint(mapped, tokenize, class_names, rng_np,
                                  max_instances=int(cfg.get("MAX_INSTANCES", 20)))
            batch["image"] = np.stack([normalize_np(m["image"]) for m in mapped])
            batch["class_ids"], batch["class_mask"] = cls_ids, cls_mask
            state, metrics = step_fn(state, batch, generator)
            metrics = {k: float(v) for k, v in metrics.items()}
            history.append(metrics)
            print({"step": len(history), "loss_total": metrics["loss_total"],
                   "grad_norm": metrics["grad_norm"]}, file=sys.stderr)
    if cfg.get("SAVE_DIR"):
        save_checkpoint(cfg["SAVE_DIR"], len(history), {"params": state.trainable})
    if device.type == "cuda":
        print(f"[entry] peak device memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f}"
              " GiB", file=sys.stderr)
    return {"state": state, "history": history}


def _dataset_names(cfg: dict) -> list:
    names = (cfg.get("DATASETS") or {}).get("TEST")
    if not names:
        return []
    return [names] if isinstance(names, str) else list(names)


def _make_text_tokenize(cfg: dict, text_cfg):
    """``tokenize(texts) -> (ids, mask)`` int32, padded to the context
    length: the CLIP BPE tokenizer of ``MODEL.TEXT.TOKENIZER`` (HF's CLIP
    layout, read by ``data.clip_tokenizer``), else the deterministic md5
    word hash of the smoke mode."""
    T, V = text_cfg.context_length, text_cfg.vocab_size
    path = ((cfg.get("MODEL") or {}).get("TEXT") or {}).get("TOKENIZER")
    if path:
        tk = CLIPTokenizer.from_dir(path)
        if len(tk.vocab) > V:
            raise ValueError(f"{path}: {len(tk.vocab)} tokens for a text encoder of {V}")
        return lambda texts: tk(list(texts), T)

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


def _make_text_decode(cfg: dict):
    """ids -> caption text for the captioning evaluator: the CLIP BPE
    tokenizer of ``MODEL.TEXT.TOKENIZER`` (ids up to the first
    <|endoftext|>, special tokens dropped), else the ids joined as numbers
    (the smoke mode's captions)."""
    path = ((cfg.get("MODEL") or {}).get("TEXT") or {}).get("TOKENIZER")
    if not path:
        return lambda ids: " ".join(str(int(i)) for i in ids)
    tk = CLIPTokenizer.from_dir(path)
    eot = tk.eos_token_id

    def decode(ids):
        ids = [int(i) for i in ids]
        if eot in ids:
            ids = ids[:ids.index(eot)]
        return tk.decode(ids, skip_special_tokens=True)

    return decode


def _vlp_image_loader(ds_name: str, md: dict, records: list):
    """The images of a VLP dataset's rows: the registration's Arrow loader,
    else ``load_image_file`` where the rows carry a ``file_name``; anything
    else raises, naming the dataset."""
    loader = (md.get("image_loader") or {}).get("loader")
    if loader is not None:
        return loader
    if records and all("file_name" in r for r in records):
        return lambda r: load_image_file(r["file_name"])
    raise ValueError(f"{ds_name}: no image loader in its registration and rows without a "
                     "file_name")


def _eval_vlp(cfg: dict, ds_name: str, md: dict, records: list, model_cfg, params, tokenize):
    """One retrieval or captioning dataset (``BATCH_SIZE``, default 8;
    ``VLP_IMAGE_SIZE``, default 224; the captions to
    ``SAVE_DIR/<name>_captions.json``)."""
    kw = {"batch_size": int(cfg.get("BATCH_SIZE", 8)),
          "image_size": int(cfg.get("VLP_IMAGE_SIZE", 224))}
    image_loader = _vlp_image_loader(ds_name, md, records)
    if md.get("evaluator_type") == "captioning" or "captioning" in ds_name:
        out_dir = cfg.get("SAVE_DIR")
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        pipe = build_pipeline("COCOCaptionXDecPipeline", cfg, model_cfg=model_cfg, params=params,
                              image_loader=image_loader, decode_text=_make_text_decode(cfg),
                              start_token_id=model_cfg.text.vocab_size - 2, **kw)
        return pipe.evaluate_model(records, out_path=(
            os.path.join(out_dir, f"{ds_name}_captions.json") if out_dir else None))
    pipe = build_pipeline("VLPRetrievalPipeline", cfg, model_cfg=model_cfg, params=params,
                          tokenize=tokenize, image_loader=image_loader, **kw)
    return pipe.evaluate_model(records)


def _read_reference_state(path: str) -> dict:
    """A reference-layout state dict file -> {key: f32 numpy}: a torch
    file (``.pt``, ``.pth``, ``.bin``; its ``model`` sub-dict when it has
    one) or an ``.npz``."""
    if path.endswith((".pt", ".pth", ".bin")):
        raw = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(raw, dict) and isinstance(raw.get("model"), dict):
            raw = raw["model"]
        return {k: v.float().numpy() for k, v in raw.items() if isinstance(v, torch.Tensor)}
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k].astype(np.float32) for k in z.files}


def _load_xdecoder_params(cfg: dict, model_cfg, device):
    """The model's parameters on ``device``: random from seed 0 without
    ``RESUME_FROM`` (smoke mode); else the checkpoint it names, every leaf
    of the model read from it (``checkpoint.xdecoder_import``; a missing,
    extra or misshapen leaf raises): a directory of the port's own store
    (``step_{N}/`` of an X-Decoder ``train``; its ``params``), or a
    reference-layout state dict file.  ``DTYPE: bfloat16`` casts them."""
    params = init_xdecoder_model_params(model_cfg, torch.Generator(device=device).manual_seed(0),
                                        device)
    resume = cfg.get("RESUME_FROM")
    if not resume:
        print("[entry] no RESUME_FROM: random weights (smoke mode)", file=sys.stderr)
    elif os.path.isdir(resume):
        state = load_checkpoint(resume)
        params = align_and_update(params, state.get("params", state))
    else:
        state = _read_reference_state(resume)
        unused = unused_keys(state, model_cfg)
        if unused:
            print(f"[entry] {resume}: {len(unused)} keys the model does not read, e.g. "
                  f"{unused[:4]}", file=sys.stderr)
        params = align_and_update(params, import_xdecoder_checkpoint(state, model_cfg))
    dtype = str(cfg.get("DTYPE") or "float32")
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"DTYPE {dtype!r}: float32 or bfloat16")
    if dtype == "bfloat16":
        params = tree_map(lambda t: t.to(torch.bfloat16), params)
    return params


def register_datasets_from_cfg(cfg: dict) -> None:
    """The bulk table under a ``DETECTRON2_DATASETS`` / ``DATASET`` root
    (``datasets.register_all_segmentation``), then ``DATASETS.REGISTER:
    {name: {KIND: ..., ...}}`` for six kinds: ``semseg`` (``IMAGE_DIR``,
    ``ANN_DIR``, ``IMAGE_EXT``, ``NUM_CLASSES``, ``IGNORE_LABEL``,
    ``CLASS_NAMES``, ``TASKS``), ``refcoco`` (``REFS_JSON``,
    ``INSTANCES_JSON``, ``IMAGE_DIR``, ``SPLIT``), ``vqa``
    (``QUESTIONS_JSON``, ``ANNOTATIONS_JSON``, ``IMAGE_DIR``,
    ``IMAGE_TEMPLATE``), ``coco_panoptic`` (``JSON``, ``IMAGE_DIR``,
    ``PANOPTIC_DIR``, ``NUM_CLASSES``, ``CLASS_NAMES``, ``TASKS``),
    ``coco_panoptic_caption_grounding`` (those of ``coco_panoptic`` but
    ``TASKS``, plus ``CAPTION_JSON``, ``GROUNDING_JSON`` and ``LVIS_JSON``),
    ``conversations`` (``JSON``, ``IMAGE_ROOT``) and ``imagenet`` (``ROOT``,
    ``FOLDERS``, ``CLASS_NAMES``).  Loaders run when a dataset is first
    asked for."""
    root = os.environ.get("DETECTRON2_DATASETS") or os.environ.get("DATASET")
    if root and os.path.isdir(root):
        register_all_segmentation(root)
    for name, spec in dict((cfg.get("DATASETS") or {}).get("REGISTER") or {}).items():
        kind = spec.get("KIND", "semseg")
        if kind == "semseg":
            register_dataset(
                name, (lambda d=spec["IMAGE_DIR"], a=spec["ANN_DIR"],
                       e=spec.get("IMAGE_EXT", ".jpg"): load_semseg_pairs(d, a, image_ext=e)),
                {"num_classes": int(spec.get("NUM_CLASSES", 133)),
                 "ignore_label": int(spec.get("IGNORE_LABEL", 255)),
                 "class_names": list(spec.get("CLASS_NAMES", [])) or None,
                 "tasks": spec.get("TASKS")})
        elif kind == "refcoco":
            register_refcoco(name, spec["REFS_JSON"], spec["INSTANCES_JSON"], spec["IMAGE_DIR"],
                             split=spec.get("SPLIT", "val"))
        elif kind == "coco_panoptic":
            register_coco_panoptic(
                name, spec["JSON"], spec["IMAGE_DIR"], spec["PANOPTIC_DIR"],
                metadata={"num_classes": int(spec.get("NUM_CLASSES", 133)),
                          "class_names": list(spec.get("CLASS_NAMES", [])) or None,
                          "tasks": spec.get("TASKS")})
        elif kind == "coco_panoptic_caption_grounding":
            register_coco_panoptic_caption_grounding(
                name, spec["JSON"], spec["IMAGE_DIR"], spec["PANOPTIC_DIR"], spec["CAPTION_JSON"],
                spec["GROUNDING_JSON"],
                metadata={"num_classes": int(spec.get("NUM_CLASSES", 133)),
                          "class_names": list(spec.get("CLASS_NAMES", [])) or None},
                lvis_json=spec.get("LVIS_JSON"))
        elif kind == "conversations":
            register_dataset(name, (lambda j=spec["JSON"], r=spec.get("IMAGE_ROOT"):
                                    load_conversation_json(j, r)), {})
        elif kind == "vqa":
            kw = ({"image_template": str(spec["IMAGE_TEMPLATE"])} if spec.get("IMAGE_TEMPLATE")
                  else {})
            register_vqa(name, spec["QUESTIONS_JSON"], spec.get("ANNOTATIONS_JSON"),
                         spec["IMAGE_DIR"], **kw)
        elif kind == "imagenet":
            if "ROOT" not in spec:
                raise ValueError(f"DATASETS.REGISTER {name}: the imagenet kind needs ROOT")
            register_imagenet(name, spec["ROOT"],
                              folder_names=list(spec.get("FOLDERS", [])) or None,
                              class_names=list(spec.get("CLASS_NAMES", [])) or None)
        else:
            raise ValueError(f"unknown DATASETS.REGISTER KIND {kind!r} ({name})")


def _eval_vl(cfg: dict, device) -> dict:
    """vl_test: LLaVA (``MODEL.LLM``) through the VQA pipeline of ``PIPELINE``
    over each ``DATASETS.TEST`` entry, with ``KV_QUANT``, ``SPEC_K``,
    ``BATCH_SIZE``, ``MAX_NEW_TOKENS``, ``LIMIT`` and ``SAVE_DIR``; with
    ``MODEL.TOPIC`` (``tiny`` or ``{LLAMA_PATH, CLIP_PATH}``) the
    question-topic classifier buckets the accuracy (``vqa_per_class.csv``)."""
    model = cfg.get("MODEL") or {}
    if model.get("ZOO"):
        return _eval_vl_zoo(cfg, model["ZOO"], device)
    extra = {}
    topic = model.get("TOPIC")
    if isinstance(topic, str) and topic.lower() == "tiny":
        extra["topic_fn"] = make_tiny_topic_fn(device=device)
    elif isinstance(topic, dict) and {"LLAMA_PATH", "CLIP_PATH"} <= set(topic):
        extra["topic_fn"] = make_reference_topic_fn(topic["LLAMA_PATH"], topic["CLIP_PATH"],
                                                    device=device)
    elif topic:
        raise ValueError(f"MODEL.TOPIC {topic!r}: 'tiny' or {{LLAMA_PATH, CLIP_PATH}}")
    model_cfg, params, tokenizer = _build_llava(cfg, device)
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
    """vl_test with a zoo tower (``MODEL.ZOO``) through ``VLZooVQAPipeline``
    over each ``DATASETS.TEST`` entry, ``MAX_NEW_TOKENS`` (10), ``LIMIT`` and
    ``SAVE_DIR``.  With ``MODEL.ZOO_PATH`` (a local HF snapshot) the native
    answerer of the snapshot's kind, as JAX's entry dispatches them: BLIP-2
    Flan-T5, InstructBLIP, KOSMOS-2 or BakLLaVA; each row's image goes to
    the answerer as decoded (the reference hands the processor the image; the
    JAX entry's mapper CLIP-preprocesses it first, and its answerers then
    preprocess those pixels as an image again).  Without a snapshot the
    tiny config with seeded random weights (JAX's checkpoint-free path) for
    BLIP-2, InstructBLIP and KOSMOS-2; BakLLaVA needs a snapshot.
    ``ZOO_TORCH`` raises."""
    model = cfg.get("MODEL") or {}
    if zoo not in MODEL_SPECS:
        raise SystemExit(f"unknown MODEL.ZOO {zoo!r}; one of {sorted(MODEL_SPECS)}")
    if model.get("ZOO_TORCH"):
        raise NotImplementedError("MODEL.ZOO_TORCH (the transformers harness) has no counterpart: "
                                  "the port answers through its native towers")
    zoo_path = model.get("ZOO_PATH")
    mnt = int(cfg.get("MAX_NEW_TOKENS", 10))
    img_size = None
    if zoo_path:
        if zoo in ("blip2", "instructblip"):
            answer_fn = native_blip2_answer_fn(hf_model_dir=zoo_path, max_new_tokens=mnt,
                                               kind="flant5" if zoo == "blip2"
                                               else "instructblip", device=device)
        elif zoo == "kosmos2":
            answer_fn = native_kosmos2_answer_fn(hf_model_dir=zoo_path, max_new_tokens=mnt,
                                                 device=device)
        else:
            answer_fn = native_bakllava_answer_fn(zoo_path, max_new_tokens=mnt, device=device)
    elif zoo in ("blip2", "instructblip"):
        answer_fn = native_blip2_answer_fn(max_new_tokens=mnt, device=device,
                                           kind="instructblip" if zoo == "instructblip"
                                           else "flant5")
        # both smoke towers read JAX's T5 image size (the tiny configs share it)
        img_size = tiny_blip2_config("t5").vision.image_size
    elif zoo == "kosmos2":
        answer_fn = native_kosmos2_answer_fn(max_new_tokens=mnt, device=device)
        img_size = tiny_kosmos2_config().vision.image_size
    else:
        raise SystemExit(f"MODEL.ZOO: {zoo} needs MODEL.ZOO_PATH (local HF snapshot) — "
                         "blip2/instructblip/kosmos2 have checkpoint-free native smoke answerers")
    pipe = VLZooVQAPipeline(cfg, zoo, model_path=zoo_path, answer_fn=answer_fn)
    limit = int(cfg.get("LIMIT", 0)) or None
    mapper = VQAEvalMapper(image_size=img_size)
    out_dir = cfg.get("SAVE_DIR")
    results = {}
    for name in _dataset_names(cfg):
        def rows(name=name):
            for rec in get_dataset(name):
                if zoo_path:
                    image = rec.get("image")
                    m = {k: rec.get(k) for k in ("question_id", "question", "answers",
                                                 "question_type", "answer_type")}
                    m["image"] = load_image_file(rec["file_name"]) if image is None else image
                else:
                    m = mapper(rec)
                    m["image"] = m.pop("pixel_values")
                yield m
        results[name] = pipe.evaluate_model(rows(), limit=limit)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            pipe.evaluator.dump_results(os.path.join(out_dir, "vqa_results.json"))
    return results


def _eval_imagenet(cfg: dict, device) -> dict:
    """imagenet_test: zero-shot classification over each ``DATASETS.TEST``
    class-folder dataset (``LIMIT``, ``BATCH_SIZE`` (64), ``SAVE_DIR``):
    ``native_blip2_imagenet_fns`` ('This is {class}' through the text-input
    Q-Former against the pooled image queries: tiny random weights, or
    ``MODEL.ZOO_PATH``'s InstructBLIP snapshot; an image through the port's
    PNG reader, other formats through PIL, then CLIP preprocessing at the
    tower's size) into ``ImageNetPipeline``."""
    model = cfg.get("MODEL") or {}
    zoo = model.get("ZOO", "blip2")
    limit = int(cfg.get("LIMIT", 0)) or None
    results = {}
    for name in _dataset_names(cfg):
        class_names = (get_metadata(name) or {}).get("class_names") or []
        embed_fn, class_embeds = native_blip2_imagenet_fns(
            hf_model_dir=model.get("ZOO_PATH"), class_names=class_names,
            kind="instructblip" if zoo == "instructblip" else "flant5", device=device)
        side = embed_fn.image_size
        pipe = ImageNetPipeline(cfg, embed_fn, class_embeds, class_names,
                                batch_size=int(cfg.get("BATCH_SIZE", 64)))

        def rows(name=name, side=side):
            for rec in get_dataset(name):
                yield {"pixel_values": preprocess_numpy([load_image_file(rec["file_name"])],
                                                        side)[0],
                       "label": rec["label"]}
        results[name] = pipe.evaluate_model(rows(), limit=limit, out_dir=cfg.get("SAVE_DIR"))
    return results


def _eval_tasks(ds_name: str, md: dict) -> EvalTasks:
    """The semantic / instance / panoptic switches: the dataset's ``TASKS``
    (a list of names or a dict of flags; other keys dropped), else the
    reference's per-dataset table, else semantic only."""
    t = md.get("tasks")
    if isinstance(t, (list, tuple)):
        t = {k: True for k in t}
    if t:
        known = {"semantic", "instance", "panoptic"}
        return EvalTasks(**{str(k).lower(): bool(v) for k, v in dict(t).items()
                            if str(k).lower() in known})
    return tasks_for_dataset(ds_name, default=EvalTasks(semantic=True))


def _eval_xdecoder(cfg: dict, device) -> dict:
    """The xdecoder workload: the model, its weights and the text tokenizer
    from the config, then per ``DATASETS.TEST`` entry (``LIMIT`` rows,
    ``EVAL_BATCH``, ``SAVE_DIR``): a retrieval or captioning dataset (its
    ``evaluator_type``, or a name starting with "vlp") through
    ``VLPRetrievalPipeline`` or ``COCOCaptionXDecPipeline``
    (``_eval_vlp``; no class names are looked up for it); a dataset with
    "ref" in its name, or whose rows carry ``text``, through
    ``RefCOCOPipeline``; any other through ``XDecoderPipeline`` with its
    class names' prompt-ensembled embeddings, ``PanopticEvalMapper`` for
    panoptic records else ``SemSegEvalMapper``, and the thing ids of its
    segments.  Returns the metric dicts by dataset."""
    model_cfg = xdecoder_model_config_from(cfg)
    params = _load_xdecoder_params(cfg, model_cfg, device)
    tokenize = _make_text_tokenize(cfg, model_cfg.text)
    limit = int(cfg.get("LIMIT", 0)) or None
    out_dir = cfg.get("SAVE_DIR")
    eval_batch = int(cfg.get("EVAL_BATCH", 8))
    results = {}
    for ds_name in _dataset_names(cfg):
        every = get_dataset(ds_name)
        records = every[:limit]
        md = get_metadata(ds_name) or {}
        if md.get("evaluator_type") in ("retrieval", "captioning") or ds_name.startswith("vlp"):
            results[ds_name] = _eval_vlp(cfg, ds_name, md, records, model_cfg, params, tokenize)
            continue
        if "ref" in ds_name or (records and "text" in records[0]):
            pipe = build_pipeline("RefCOCOPipeline", cfg, model_cfg=model_cfg, params=params,
                                  tokenize=tokenize, eval_batch=eval_batch)
            results[ds_name] = pipe.evaluate_model(map(RefCOCOEvalMapper(), records),
                                                   out_dir=out_dir)
            continue
        with torch.inference_mode():
            text_embeds = class_embeddings_ensembled(params["text"], model_cfg.text, tokenize,
                                                     _resolve_class_names(ds_name, md),
                                                     add_background=True)
        panoptic = bool(records and "pan_seg_file_name" in records[0])
        mapper = PanopticEvalMapper() if panoptic else SemSegEvalMapper()
        thing_ids = frozenset(s["category_id"] for r in every if panoptic
                              for s in r["segments_info"] if s.get("isthing", True))
        pipe = build_pipeline("XDecoderPipeline", cfg, model_cfg=model_cfg, params=params,
                              text_class_embeds=text_embeds, tasks=_eval_tasks(ds_name, md),
                              eval_batch=eval_batch)
        out = pipe.evaluate_model(map(mapper, records), thing_ids=thing_ids)
        # the metrics only: the per-image outputs stay out of the report
        results[ds_name] = {k: v for k, v in out.items()
                            if k not in ("panoptic_outputs", "instance_outputs")}
    return results


STEP2_PRE_QUESTION = ("provide multiple object names with their numbering index and the "
                      "objects' bounding box coordinates in the image.")


def step2_pre_prompt_ids(tokenizer, num_image_tokens: int) -> np.ndarray:
    """step2_pre's one prompt (the system prompt, the image, the boxes
    question) as int32 ids [T], its ``<image>`` expanded to
    ``num_image_tokens`` positions."""
    prompt = SYSTEM_PROMPT + "<image>" + f" USER: {STEP2_PRE_QUESTION} ASSISTANT:"
    ids, _, _ = expand_image_token(np.asarray(tokenizer.encode(prompt), np.int32), None, None,
                                   tokenizer.image_token_id, num_image_tokens)
    return ids


class _LazyImages:
    """The rows' images, decoded when the pipeline asks for one: an
    in-memory ``image`` array, else the file at ``image_path`` (PNG by the
    port's reader, other formats through PIL)."""

    def __init__(self, rows: list):
        self.rows = rows

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        r = self.rows[int(i)]
        img = r.get("image")
        if not isinstance(img, np.ndarray):
            # conversation rows carry "image" as a relative path string
            img = load_image_file(r["image_path"])
        return np.asarray(img)


def _eval_step2_pre(cfg: dict, device) -> dict:
    """cullavo_step2_pre: model-in-the-loop dataset generation over the first
    ``DATASETS.TEST`` entry (``LIMIT`` rows; rows without an image are
    skipped): one prompt, the system prompt with the image and the boxes
    question, through ``CuLLaVOPipeline.generate_step2_rows`` with
    ``MAX_NEW_TOKENS``, ``BATCH_SIZE`` and ``SAVE_DIR`` (default
    ``step2_pre_out``).  One process (JAX shards the rows over processes)."""
    model_cfg, params, tokenizer = _build_llava(cfg, device)
    # the prompt carries the tokenizer's <image> id; the model merges image
    # features at its config's id: make them one
    model_cfg = dataclasses.replace(model_cfg, image_token_id=tokenizer.image_token_id)
    pipe = build_pipeline("CuLLaVOPipeline", cfg, model_cfg=model_cfg, tokenizer=tokenizer,
                          params=params)
    out_dir = cfg.get("SAVE_DIR") or "step2_pre_out"
    limit = int(cfg.get("LIMIT", 0)) or None
    names = _dataset_names(cfg)
    records = get_dataset(names[0]) if names else []
    if limit:
        records = records[:limit]
    ids_row = step2_pre_prompt_ids(tokenizer, model_cfg.num_image_tokens)
    keep = [r for r in records if isinstance(r.get("image"), np.ndarray) or r.get("image_path")]
    if not keep:
        print("[entry] step2_pre: no images in dataset", file=sys.stderr)
        return {"rows": 0}
    ids = np.tile(ids_row[None], (len(keep), 1))
    rows = pipe.generate_step2_rows(_LazyImages(keep), ids, np.ones_like(ids), out_dir,
                                    max_new_tokens=int(cfg.get("MAX_NEW_TOKENS", 256)),
                                    batch_size=int(cfg.get("BATCH_SIZE", 8)))
    return {"rows": len(rows), "out_dir": out_dir}


def evaluate(cfg: dict, device=None) -> dict:
    """Eval workload by ``NAME``: ``cullavo_step2_pre``, ``imagenet*``,
    ``vl_test`` and ``xdecoder*``."""
    device = _device(device)
    register_datasets_from_cfg(cfg)
    name = cfg.get("NAME", "")
    if "step2_pre" in name:
        results = _eval_step2_pre(cfg, device)
    elif "imagenet" in name:
        results = _eval_imagenet(cfg, device)
    elif "vl_test" in name or name == "vl":
        results = _eval_vl(cfg, device)
    elif "xdecoder" in name:
        results = _eval_xdecoder(cfg, device)
    else:
        print(f"[entry] unknown eval workload {name!r} (expect one of xdecoder_test / "
              "vl_test / imagenet_test / cullavo_step2_pre)", file=sys.stderr)
        raise SystemExit(2)
    print(json.dumps(results, default=float))
    return results


def _maybe_init_distributed():
    """``CULLAVO_NUM_PROCS`` > 1 asks for several processes, which the port
    does not run yet."""
    num = os.environ.get("CULLAVO_NUM_PROCS")
    if num and int(num) > 1:
        raise NotImplementedError(f"CULLAVO_NUM_PROCS={num}: several processes wait for the "
                                  "parallelism slice; run one process")


def main(argv=None, device=None):
    """The command line: parse ``argv`` (``sys.argv[1:]`` when None) with
    ``load_opt_command`` and run ``train``, ``evaluate`` (``eval``) or
    ``serve`` on the config, on the GPU unless ``device`` names another."""
    _maybe_init_distributed()
    cfg, args = load_opt_command(argv)
    cfg = cfg.to_dict()
    if args.command == "train":
        return train(cfg, device=device)
    if args.command == "serve":
        return serve(cfg, device=device)
    return evaluate(cfg, device=device)


if __name__ == "__main__":
    main()
