"""VQA evaluation pipeline on the torch port (counterpart of
``cullavo_tpu/pipelines/vqa_pipeline.py``): bucketed, batched greedy
decoding through ``generate_prefill_chunked`` + ``generate_decode`` (or
``generate_decode_spec`` with ``spec_k``), over a bf16 or an int8 KV cache,
and VQA consensus accuracy (``LLaVAVQAVALPipeline``), or the VQAv2
test-dev submission file (``LLaVAVQATESTPipeline``).

The reference's question-topic classifier buckets the accuracy by class
(``topic_fn``, the per-class CSV): ``make_topic_fn`` over built towers (a
LLaMA picks the question's object word by in-context sampling, a CLIP text
tower matches 'a photo of {word}' to the classes), from two local snapshots
(``make_reference_topic_fn``: a text-only LlamaForCausalLM and a CLIP text
model, read by the port's own readers) or on tiny random towers
(``make_tiny_topic_fn``, ``MODEL.TOPIC: tiny``)."""
from __future__ import annotations

import csv
import os
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from cullavo_tpu_torch.checkpoint.hf_import import (read_config_json, read_safetensors_dir,
                                                    llama_config_from_json,
                                                    load_llama_causal_lm_safetensors)
from cullavo_tpu_torch.data.clip_tokenizer import CLIPTokenizer
from cullavo_tpu_torch.data.evaluation.vqa_eval import VQAEvaluator
from cullavo_tpu_torch.data.tokenizer import ByteTokenizer, HFTokenizer
from cullavo_tpu_torch.models.llava.config import LlavaConfig, smoke_llava_config
from cullavo_tpu_torch.models.llava.llama import init_llama_params, round_cache_len
from cullavo_tpu_torch.models.llava.modeling import (GenerationConfig,
                                                     expand_image_token, generate,
                                                     generate_decode,
                                                     generate_decode_spec,
                                                     generate_prefill_chunked)
from cullavo_tpu_torch.models.xdecoder.text_encoder import (TextEncoderConfig,
                                                            clip_text_config, forward_language,
                                                            import_hf_clip_text,
                                                            init_text_encoder_params)
from cullavo_tpu_torch.pipelines.base import register_pipeline
from cullavo_tpu_torch.utils import constants

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


# ---------------------------------------------------------------------------
# the question-topic classifier
# ---------------------------------------------------------------------------

def topic_prompt(question: str) -> str:
    """The reference's in-context topic-word prompt, verbatim (its missing
    period and space after 'asks' included)."""
    return ("Choose object the question asks" +
            "ex) what color is the man's shirt? shirt. " +
            "ex) how many bikes have helmets? helmets. " +
            "ex) were there any books on the table? books. " +
            "ex) what is he on top of? he. " +
            f"ex) where are the dogs looking at? dogs. ex) {question}")


def _device(device) -> torch.device:
    """The caller's device, else the GPU (raising where there is none)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _clip_embed(params, cfg, clip_tok, texts: list) -> torch.Tensor:
    enc = clip_tok(texts, padding=True, return_tensors="np")
    dev = params["token_embedding"].device
    with torch.inference_mode():
        return forward_language(params, cfg, torch.from_numpy(np.asarray(enc["input_ids"])).to(dev),
                                torch.from_numpy(np.asarray(enc["attention_mask"])).to(dev))


def make_topic_fn(llama_params: dict, llava_cfg: LlavaConfig, llama_tok, clip_params: dict,
                  clip_cfg: TextEncoderConfig, clip_tok, class_names=None, seed: int = 0,
                  max_new_tokens: int = 10) -> Callable[[str], str]:
    """``topic_fn(question) -> class name`` over built towers: the LLaMA
    (``llama_params["language_model"]``, computing in its weights' dtype)
    samples the object word after ``topic_prompt`` (temperature 0.9, top-p
    0.9, no top-k, at most ``max_new_tokens``; the prompt right-padded to
    its ``_bucket``; the decoded new tokens up to eos, cut at the first
    '.'), then the CLIP text tower's embedding of 'a photo of {word}' picks
    the class of highest cosine against 'a photo of {class}' (default
    classes: COCO's 91 semantic names; ties to the lower index).

    ``llama_tok(text, return_tensors="np") -> {"input_ids": [1, n]}`` with
    ``decode`` and ``eos_token_id``; ``clip_tok(texts, padding=True,
    return_tensors="np") -> {"input_ids", "attention_mask"}`` (the HF
    calling conventions).  The draws: one CPU ``torch.Generator`` seeded by
    ``seed`` gives each question, in order, the seed of the generator its
    ``generate`` samples from (JAX splits ``PRNGKey(seed)`` once a question)."""
    class_names = list(class_names or constants.COCO_SEMANTIC_CLASSES)
    lm = llama_params["language_model"]["embed_tokens"]
    class_embeds = _clip_embed(clip_params, clip_cfg, clip_tok,
                               [f"a photo of {c}" for c in class_names])
    gen = GenerationConfig(max_new_tokens=max_new_tokens, do_sample=True, temperature=0.9,
                           top_p=0.9, top_k=0,
                           eos_token_id=getattr(llama_tok, "eos_token_id", 2) or 2)
    draws = torch.Generator().manual_seed(seed)

    def topic_fn(question: str) -> str:
        ids = np.asarray(llama_tok(topic_prompt(question), return_tensors="np")["input_ids"])
        sub = int(torch.randint(0, 2 ** 62, (1,), generator=draws))
        n = ids.shape[1]
        L = _bucket(n)
        row = np.zeros((1, L), np.int64)
        row[0, :n] = ids[0]
        mask = np.zeros((1, L), np.int64)
        mask[0, :n] = 1
        out = generate(llama_params, llava_cfg, torch.from_numpy(row).to(lm.device), None,
                       torch.from_numpy(mask).to(lm.device), gen, max_len=L + max_new_tokens,
                       rng=torch.Generator(device=lm.device).manual_seed(sub),
                       compute_dtype=lm.dtype)
        toks = out[0].tolist()
        if gen.eos_token_id in toks:
            toks = toks[:toks.index(gen.eos_token_id)]
        # only the new tokens: the reference's [len(prompt):] slice
        word = llama_tok.decode(toks, skip_special_tokens=True).strip().split(".")[0]
        emb = _clip_embed(clip_params, clip_cfg, clip_tok, [f"a photo of {word}"])
        return class_names[int(torch.argmax(class_embeds @ emb[0]))]

    return topic_fn


class _LlamaTokCall:
    """``HFTokenizer`` in the HF calling convention ``make_topic_fn`` takes
    (bos as the snapshot's ``add_bos_token`` says, as AutoTokenizer adds it)."""

    def __init__(self, tok: HFTokenizer):
        self.tok = tok
        self.eos_token_id = tok.eos_token_id

    def __call__(self, text: str, return_tensors="np"):
        return {"input_ids": np.asarray([self.tok.encode(text)], np.int64)}

    def decode(self, ids, skip_special_tokens=True):
        return self.tok.decode(ids, skip_special_tokens=skip_special_tokens)


class _ClipTokCall:
    """``CLIPTokenizer`` as ``CLIPTokenizer(texts, padding=True)``: [bos] +
    ids + [eos], rows padded with <|endoftext|> (the highest id, so
    ``forward_language``'s argmax finds each row's first eos) to the
    longest row, not to the context length."""

    def __init__(self, tok: CLIPTokenizer, context_length: int = 77):
        self.tok = tok
        self.context_length = context_length

    def __call__(self, texts, padding=True, return_tensors="np"):
        ids, mask = self.tok(list(texts), context_length=self.context_length)
        width = int(mask.sum(axis=1).max())
        return {"input_ids": ids[:, :width], "attention_mask": mask[:, :width]}


def make_reference_topic_fn(llama_model_dir: str, clip_model_dir: str, class_names=None,
                            seed: int = 0, max_new_tokens: int = 10,
                            device=None) -> Callable[[str], str]:
    """The reference's topic classifier from two local snapshots (LLaMA-2-7b
    chat and CLIP-L/336 there): a text-only LlamaForCausalLM
    (``config.json``, ``*.safetensors`` in their dtype, ``tokenizer.json``
    through ``HFTokenizer``) and a CLIP text model with its projection
    (``config.json``, its own or a CLIPModel's ``text_config``,
    ``*.safetensors``, the CLIP BPE files), through ``make_topic_fn``.
    ``device``: default the GPU.  ``MODEL.TOPIC: {LLAMA_PATH, CLIP_PATH}``."""
    dev = _device(device)
    lcfg = llama_config_from_json(llama_model_dir)
    llama_tok = _LlamaTokCall(HFTokenizer(llama_model_dir))
    lparams = {"language_model": load_llama_causal_lm_safetensors(llama_model_dir, lcfg,
                                                                  device=dev)}
    hc = read_config_json(clip_model_dir)
    tc = hc.get("text_config", hc)
    ccfg = clip_text_config(width=tc["hidden_size"], heads=tc["num_attention_heads"],
                            layers=tc["num_hidden_layers"],
                            dim_lang=tc.get("projection_dim", hc.get("projection_dim")))
    clip_tok = _ClipTokCall(CLIPTokenizer.from_dir(clip_model_dir),
                            tc.get("max_position_embeddings", 77))
    state = {k: v.float() for k, v in read_safetensors_dir(clip_model_dir).items()}
    cparams = import_hf_clip_text(state, ccfg, device=dev)
    return make_topic_fn(lparams, LlavaConfig(text=lcfg), llama_tok, cparams, ccfg, clip_tok,
                         class_names=class_names, seed=seed, max_new_tokens=max_new_tokens)


class _ByteHFTok:
    """``ByteTokenizer`` in the HF calling convention, for the tiny topic
    classifier: ids folded below ``vocab_size - 1``; with ``eot_is_max``
    every row ends with the top id (the CLIP side finds its EOT by argmax)."""

    def __init__(self, vocab_size: int, max_len: int = 77, eot_is_max: bool = False):
        self._bt = ByteTokenizer()
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.eot_is_max = eot_is_max
        self.eos_token_id = self._bt.eos_token_id

    def __call__(self, texts, padding=True, return_tensors="np"):
        if isinstance(texts, str):
            texts = [texts]
        rows = []
        for t in texts:
            ids = [i % (self.vocab_size - 1) for i in self._bt.encode(t)][:self.max_len - 1]
            if self.eot_is_max:
                ids.append(self.vocab_size - 1)
            rows.append(ids)
        L = min(self.max_len, max(len(r) for r in rows))
        out = np.zeros((len(rows), L), np.int64)
        mask = np.zeros((len(rows), L), np.int64)
        for i, r in enumerate(rows):
            out[i, :len(r)] = r[:L]
            mask[i, :len(r)] = 1
        return {"input_ids": out, "attention_mask": mask}

    def decode(self, ids, skip_special_tokens=True):
        return self._bt.decode(ids, skip_special_tokens)


def tiny_topic_configs():
    """(LLaMA, CLIP text) configs of the tiny topic classifier: the smoke
    LLaVA's text tower (head dim 128, which the card's kernels take) and a
    2-layer text tower of width 32 over the byte vocabulary."""
    return smoke_llava_config(), TextEncoderConfig(width=32, heads=4, layers=2, dim_lang=32,
                                                   vocab_size=260, context_length=64)


def make_tiny_topic_fn(class_names=None, seed: int = 0, max_new_tokens: int = 10,
                       device=None) -> Callable[[str], str]:
    """The topic classifier on tiny RANDOM towers with byte tokenizers
    (``MODEL.TOPIC: tiny``): the path of ``make_reference_topic_fn`` with no
    snapshot.  The LLaMA's weights come from seed ``seed``, in bf16 on the
    card (its attention kernels take bf16) and f32 elsewhere; the CLIP
    tower's from ``seed + 1``, f32.  ``device``: default the GPU."""
    dev = _device(device)
    lcfg, ccfg = tiny_topic_configs()
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    lparams = {"language_model": init_llama_params(
        lcfg.text, torch.Generator(device=dev).manual_seed(seed), dev, dtype)}
    cparams = init_text_encoder_params(ccfg, torch.Generator(device=dev).manual_seed(seed + 1),
                                       dev)
    return make_topic_fn(lparams, lcfg, _ByteHFTok(lcfg.text.vocab_size), cparams, ccfg,
                         _ByteHFTok(ccfg.vocab_size, max_len=ccfg.context_length,
                                    eot_is_max=True),
                         class_names=class_names, seed=seed, max_new_tokens=max_new_tokens)
