"""VQA evaluation pipeline on the torch port (counterpart of
``cullavo_tpu/pipelines/vqa_pipeline.py``): bucketed, batched greedy
decoding through ``generate_prefill_chunked`` + ``generate_decode`` (or
``generate_decode_spec`` with ``spec_k``), over a bf16 or an int8 KV cache,
and VQA consensus accuracy (``LLaVAVQAVALPipeline``), or the VQAv2
test-dev submission file (``LLaVAVQATESTPipeline``).  Topic classification
waits for a later slice."""
from __future__ import annotations

import csv
import os
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from cullavo_tpu_torch.data.evaluation.vqa_eval import VQAEvaluator
from cullavo_tpu_torch.models.llava.config import LlavaConfig
from cullavo_tpu_torch.models.llava.llama import round_cache_len
from cullavo_tpu_torch.models.llava.modeling import (GenerationConfig,
                                                     expand_image_token,
                                                     generate_decode,
                                                     generate_decode_spec,
                                                     generate_prefill_chunked)
from cullavo_tpu_torch.pipelines.base import register_pipeline

# the LLaVA-1.5 system prompt (cullavo_tpu/data/step1_synthesis.py)
SYSTEM_PROMPT = ("A chat between a curious human and an artificial intelligence "
                 "assistant. The assistant gives helpful, detailed, and polite "
                 "answers to the human's questions. ")


def _bucket(n: int, buckets=(64, 96, 128, 192, 256)) -> int:
    for b in buckets:
        if n <= b:
            return b
    # beyond the table (the real 576-image-token prompt is ~650 ids): round
    # UP to the next 64-multiple, never truncate
    return -(-n // 64) * 64


@register_pipeline("LLaVAVQAVALPipeline")
class VQAPipeline:
    def __init__(self, cfg, model_cfg: LlavaConfig, tokenizer, params: dict,
                 topic_fn: Optional[Callable[[str], str]] = None,
                 batch_size: int = 8, max_new_tokens: int = 16,
                 prefill_chunk: Optional[int] = None,
                 kv_quant: Optional[str] = None, spec_k: Optional[int] = None):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.tokenizer = tokenizer
        self.params = params
        self.topic_fn = topic_fn
        self.batch_size = batch_size
        self.max_new_tokens = max_new_tokens
        # prefill in chunks of this many rows, decode the whole batch at once
        self.prefill_chunk = prefill_chunk
        # "int8": quantized KV cache (llama.init_kv_cache); None = bf16 cache
        self.kv_quant = kv_quant
        # speculative decode window (prompt-lookup drafting, greedy-only,
        # token-exact vs plain greedy); None/0 = plain decode
        self.spec_k = spec_k
        self.device = params["language_model"]["embed_tokens"].device

    def build_prompt(self, question: str) -> np.ndarray:
        text = SYSTEM_PROMPT + "<image>" + f" USER: {question} ASSISTANT:"
        ids = np.asarray(self.tokenizer.encode(text), np.int32)
        ids, _, _ = expand_image_token(ids, None, None, self.tokenizer.image_token_id,
                                       self.model_cfg.num_image_tokens)
        return ids

    def answer_batch(self, questions: list, pixel_values: np.ndarray) -> list:
        """Greedy decode a batch; prompts are right-padded to a shared
        bucket length."""
        id_rows = [self.build_prompt(q) for q in questions]
        L = _bucket(max(len(r) for r in id_rows))
        B = len(id_rows)
        ids = np.full((B, L), self.tokenizer.pad_token_id, np.int32)
        mask = np.zeros((B, L), np.int32)
        for i, row in enumerate(id_rows):
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        gen = GenerationConfig(max_new_tokens=self.max_new_tokens, do_sample=False,
                               eos_token_id=self.tokenizer.eos_token_id)
        # speculative caches take spec_k spare slots, rounded as the JAX
        # pipeline rounds them
        cache_len = (L + self.max_new_tokens if not self.spec_k
                     else round_cache_len(L + self.max_new_tokens + self.spec_k))
        ids_t = torch.from_numpy(ids).to(self.device)
        mask_t = torch.from_numpy(mask).to(self.device)
        state = generate_prefill_chunked(
            self.params, self.model_cfg, ids_t,
            torch.from_numpy(np.asarray(pixel_values, np.float32)).to(self.device),
            mask_t, cache_len, self.prefill_chunk or B, compute_dtype=torch.bfloat16,
            kv_quant=self.kv_quant)
        if self.spec_k:
            out, _ = generate_decode_spec(self.params, self.model_cfg, state, gen,
                                          self.spec_k, ids_t, mask_t.sum(dim=1),
                                          compute_dtype=torch.bfloat16)
        else:
            out = generate_decode(self.params, self.model_cfg, state, gen,
                                  compute_dtype=torch.bfloat16)
        out = out.cpu().numpy()
        answers = []
        for b in range(B):
            toks = out[b].tolist()
            if self.tokenizer.eos_token_id in toks:
                toks = toks[:toks.index(self.tokenizer.eos_token_id)]
            answers.append(self.tokenizer.decode(toks).strip())
        return answers

    def evaluate_model(self, dataset: Iterable[dict], limit: Optional[int] = None,
                       out_dir: Optional[str] = None) -> dict:
        """dataset rows: {"question_id", "question", "pixel_values" [3,H,W],
        "answers": [10 strings], optional "question_type"/"answer_type"}."""
        evaluator = VQAEvaluator()
        per_topic: dict = {}
        rows = list(dataset)
        if limit:
            rows = rows[:limit]
        for i in range(0, len(rows), self.batch_size):
            chunk = rows[i:i + self.batch_size]
            pix = np.stack([r["pixel_values"] for r in chunk])
            answers = self.answer_batch([r["question"] for r in chunk], pix)
            for r, ans in zip(chunk, answers):
                evaluator.process(r["question_id"], ans, r["answers"],
                                  r.get("question_type"), r.get("answer_type"))
                if self.topic_fn is not None:
                    per_topic.setdefault(self.topic_fn(r["question"]), VQAEvaluator()).process(
                        r["question_id"], ans, r["answers"])
        results = evaluator.evaluate()
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            evaluator.dump_results(os.path.join(out_dir, "vqa_results.json"))
            with open(os.path.join(out_dir, "vqa_per_class.csv"), "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["class", "accuracy", "n"])
                for topic, ev in sorted(per_topic.items()):
                    r = ev.evaluate()
                    w.writerow([topic, r["overall"], r["n"]])
                w.writerow(["TOTAL", results["overall"], results["n"]])
        return results


@register_pipeline("LLaVAVQATESTPipeline")
class VQATestPipeline(VQAPipeline):
    """VQAv2 test / test-dev submission run: the val pipeline's decode path
    over rows without annotations; no accuracy, the product is the EvalAI
    submission JSON (``vqa_submission.json``, a list of ``{"question_id",
    "answer"}``)."""

    def evaluate_model(self, dataset: Iterable[dict], limit: Optional[int] = None,
                       out_dir: Optional[str] = None) -> dict:
        evaluator = VQAEvaluator()
        rows = list(dataset)
        if limit:
            rows = rows[:limit]
        for i in range(0, len(rows), self.batch_size):
            chunk = rows[i:i + self.batch_size]
            pix = np.stack([r["pixel_values"] for r in chunk])
            answers = self.answer_batch([r["question"] for r in chunk], pix)
            for r, ans in zip(chunk, answers):
                evaluator.process(r["question_id"], ans, r.get("answers"))
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            evaluator.dump_results(os.path.join(out_dir, "vqa_submission.json"))
        return {"n": len(evaluator.results), "submission": True}
