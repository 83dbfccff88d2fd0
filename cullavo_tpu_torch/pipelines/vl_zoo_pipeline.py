"""Zero-shot VQA over the VL zoo (counterpart of
``cullavo_tpu/pipelines/vl_zoo_pipeline.py``): the reference's BLIP-2,
InstructBLIP, KOSMOS-2 and BakLLaVA baselines, each a ``ModelSpec`` (prompt
format, generation settings) run on the VQA harness by
``VLZooVQAPipeline``; and the zero-shot ImageNet functions of the BLIP-2
family (``native_blip2_imagenet_fns``).

The port answers through its native towers: ``native_blip2_answer_fn``
(Flan-T5 BLIP-2, or with ``kind="instructblip"`` InstructBLIP's Vicuna
tower with the question into the Q-Former: beam 5, length penalty -1, at
most 10 new tokens), ``native_kosmos2_answer_fn`` (greedy, the text after
the last 'Answer:') and ``native_bakllava_answer_fn`` (LLaVA over Mistral's
sliding window, greedy).  Without weights the first two build the JAX
package's tiny configs with seeded random weights and the byte tokenizer
(the checkpoint-free smoke path); a caller may pass a config, weights and a
tokenizer.  With ``hf_model_dir`` (a local HF snapshot) each builds the
published configuration JAX hard-codes (``_blip2_cfg_cls``,
``Kosmos2Config()``, ``bakllava_config()``), holds the snapshot's
``config.json`` to it, and reads the weights (``checkpoint/zoo_import.py``,
``hf_import.load_llava_safetensors``), the tokenizers
(``data/tokenizer_json.py``: T5's Unigram, InstructBLIP's WordPiece
Q-Former tokenizer under ``qformer_tokenizer/``; ``data/tokenizer.py``:
Vicuna's and Mistral's BPE) and KOSMOS-2's processor
(``data/kosmos2_processor.py``) with the port's own code.  The BLIP-2 family
reads its snapshots in f32, as JAX does; BakLLaVA reads them in bf16 on the
card, so that K1 and K4 run, and in the snapshot's dtype elsewhere.  The HF harness (a pipeline
without an ``answer_fn`` loads the checkpoint with transformers) and the
OPT tower raise.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from cullavo_tpu_torch.checkpoint.hf_import import load_llava_safetensors, read_config_json
from cullavo_tpu_torch.checkpoint.zoo_import import (check_blip2_config, check_kosmos2_config,
                                                     compare_config, load_blip2_safetensors,
                                                     load_kosmos2_safetensors)
from cullavo_tpu_torch.data.evaluation.vqa_eval import VQAEvaluator
from cullavo_tpu_torch.data.image_processing import preprocess_numpy
from cullavo_tpu_torch.data.kosmos2_processor import NUM_IMAGE_TOKENS, Kosmos2Processor
from cullavo_tpu_torch.data.tokenizer import ByteTokenizer, HFTokenizer
from cullavo_tpu_torch.data.tokenizer_json import TokenizerJSON
from cullavo_tpu_torch.models.blip2 import (Blip2Config, blip2_beam_generate,
                                            blip2_flant5xl_config, blip2_image_embed,
                                            blip2_text_embed, init_blip2_params,
                                            instructblip_vicuna7b_config, tiny_blip2_config)
from cullavo_tpu_torch.models.blip2.modeling import blip2_generate
from cullavo_tpu_torch.models.kosmos2 import (Kosmos2Config, init_kosmos2_params,
                                              kosmos2_generate, tiny_kosmos2_config)
from cullavo_tpu_torch.models.llava.config import bakllava_config
from cullavo_tpu_torch.models.llava.modeling import GenerationConfig, expand_image_token, generate
from cullavo_tpu_torch.pipelines.base import register_pipeline
from cullavo_tpu_torch.utils.tree import tree_leaves


@dataclasses.dataclass
class ModelSpec:
    name: str
    model_cls: str                      # transformers class name
    prompt: str = "Question: {q} Short answer:"
    gen_kwargs: dict = dataclasses.field(default_factory=dict)
    dtype: str = "float32"


MODEL_SPECS = {
    # the reference's BLIP2VQAVALPipeline (beam 5, length penalty -1, <= 10 tokens)
    "blip2": ModelSpec("Salesforce/blip2-flan-t5-xl",
                       "Blip2ForConditionalGeneration",
                       prompt="Question: {q} Short answer:",
                       gen_kwargs=dict(num_beams=5, max_new_tokens=10,
                                       length_penalty=-1.0)),
    # its InstructBLIPVQAVALPipeline
    "instructblip": ModelSpec("Salesforce/instructblip-vicuna-7b",
                              "InstructBlipForConditionalGeneration",
                              prompt="{q} Answer briefly.",
                              gen_kwargs=dict(num_beams=5, max_new_tokens=10,
                                              length_penalty=-1.0)),
    # its KOSMOS2VQAVALPipeline (f32, no <grounding> prefix, the text after
    # the last 'Answer:')
    "kosmos2": ModelSpec("microsoft/kosmos-2-patch14-224",
                         "Kosmos2ForConditionalGeneration",
                         prompt="Question: {q} Answer:",
                         gen_kwargs=dict(max_new_tokens=10)),
    # its BakLLaVAVQAVALPipeline (greedy)
    "bakllava": ModelSpec("llava-hf/bakLlava-v1-hf",
                          "LlavaForConditionalGeneration",
                          prompt="USER: <image>\n{q} ASSISTANT:",
                          gen_kwargs=dict(do_sample=False, max_new_tokens=128)),
}


def _resolve_device(device, params):
    """The caller's device, else the weights', else the GPU (raising where
    there is none)."""
    if device is not None:
        return torch.device(device)
    if params is not None:
        return tree_leaves(params)[0].device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _fold_ids(ids: np.ndarray, vocab: int) -> np.ndarray:
    """Fold ids past a tiny vocabulary into it (smoke mode only: a real
    checkpoint's tokenizer fits its own vocabulary), as JAX folds them."""
    return np.where(ids >= vocab, 4 + ids % max(vocab - 4, 1), ids)


def _fit_image(image, side: int) -> np.ndarray:
    """[3, H, W] f32 pixels, nearest-resampled to side x side if needed."""
    pix = np.asarray(image, np.float32)
    if pix.ndim == 3 and pix.shape[0] == 3 and pix.shape[1:] != (side, side):
        ri = np.linspace(0, pix.shape[1] - 1, side).astype(int)
        ci = np.linspace(0, pix.shape[2] - 1, side).astype(int)
        pix = pix[:, ri][:, :, ci]
    return pix


def _decode(tokenizer, toks) -> str:
    return (tokenizer.decode(toks) if hasattr(tokenizer, "decode")
            else " ".join(map(str, toks)))


def _blip2_cfg_cls(kind: str):
    """kind -> (the published config, its HF class name), shared by the
    answerer and the ImageNet functions: "flant5", "opt" or "instructblip"."""
    if kind == "flant5":
        return blip2_flant5xl_config(), "Blip2ForConditionalGeneration"
    if kind == "opt":
        return Blip2Config(), "Blip2ForConditionalGeneration"
    if kind == "instructblip":
        return instructblip_vicuna7b_config(), "InstructBlipForConditionalGeneration"
    raise ValueError(f"unknown BLIP-2 kind {kind!r}: flant5, opt or instructblip")


def native_blip2_answer_fn(model_cfg=None, params=None, tokenizer=None,
                           max_new_tokens: int = 10, num_beams: int = 5,
                           length_penalty: float = -1.0, hf_model_dir: Optional[str] = None,
                           kind: str = "flant5", device=None) -> Callable:
    """``answer(question, image) -> str`` through a BLIP-2 tower with the
    reference's decode (beam 5, length penalty -1, <= 10 tokens, eos 1,
    ids <= 1 dropped).  ``kind="instructblip"``: the prompt '{q} Answer
    briefly.', which a text-input Q-Former also reads (its ids folded into
    the Q-Former's vocabulary).  With no ``model_cfg`` the JAX package's
    tiny config (T5, or for InstructBLIP the "llama_text" one) with random
    weights from seed 0 (values differ from JAX's PRNG) and the byte
    tokenizer drive the whole path; answers are arbitrary strings.
    ``hf_model_dir``: a local snapshot of ``kind``'s published checkpoint
    (``_hf_blip2_answer_fn``).  ``device``: default the weights' device,
    else the GPU."""
    if hf_model_dir is not None:
        return _hf_blip2_answer_fn(hf_model_dir, kind, max_new_tokens, num_beams,
                                   length_penalty, device)
    _blip2_cfg_cls(kind)
    if kind == "opt":
        raise NotImplementedError("native_blip2_answer_fn(kind='opt'): the OPT tower waits for "
                                  "the BLIP-2 OPT item (queue 1 item 2.6 of ROADMAP.md)")
    dev = _resolve_device(device, params)
    if model_cfg is None:
        model_cfg = tiny_blip2_config("llama_text" if kind == "instructblip" else "t5")
        params = init_blip2_params(model_cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokenizer = ByteTokenizer() if tokenizer is None else tokenizer
    vocab = model_cfg.text.vocab_size
    qf_vocab = model_cfg.qformer.vocab_size
    use_qf_text = model_cfg.qformer.use_text_input
    side = model_cfg.vision.image_size
    spec = MODEL_SPECS["instructblip" if kind == "instructblip" else "blip2"]

    def answer(question: str, image) -> str:
        text = spec.prompt.format(q=question)
        raw = np.asarray(tokenizer.encode(text), np.int64)
        ids = _fold_ids(raw, vocab)
        pix = torch.from_numpy(_fit_image(image, side)[None]).to(dev)
        kwargs = {}
        if use_qf_text:
            # the instruction-aware Q-Former reads the prompt too (the
            # reference's qformer_tokenizer input)
            qids = _fold_ids(raw, qf_vocab)
            kwargs = {"qformer_text_ids": torch.from_numpy(qids[None]).to(dev),
                      "qformer_text_mask": torch.ones((1, len(qids)), dtype=torch.int64,
                                                      device=dev)}
        out = blip2_beam_generate(
            params, model_cfg, pix, torch.from_numpy(ids[None]).to(dev),
            torch.ones((1, len(ids)), dtype=torch.int64, device=dev), max_new_tokens,
            num_beams=num_beams, length_penalty=length_penalty, eos_token_id=1, **kwargs)
        return _decode(tokenizer, [int(t) for t in out[0].tolist() if int(t) > 1])

    return answer


def _imagenet_fns(model_cfg: Blip2Config, params: dict, ids: np.ndarray, mask: np.ndarray):
    """(image_embed_fn, class_embeds) from the class prompts' Q-Former ids
    and mask [C, W]: the L2-normalised pooled text states [C, D_q] and
    ``image_embed_fn(pixel_values [B, 3, S, S])``, the L2-normalised first
    query state [B, D_q], with its ``image_size`` S.  On the weights'
    device."""
    dev = tree_leaves(params)[0].device
    with torch.inference_mode():
        class_embeds = blip2_text_embed(params, model_cfg, torch.from_numpy(ids).to(dev),
                                        torch.from_numpy(mask).to(dev))

    def image_embed_fn(pixel_values):
        with torch.inference_mode():
            return blip2_image_embed(params, model_cfg, pixel_values)

    image_embed_fn.image_size = model_cfg.vision.image_size
    return image_embed_fn, class_embeds


def blip2_imagenet_fns(model_cfg: Blip2Config, params: dict, class_names, tokenizer=None):
    """(image_embed_fn, class_embeds) of the zero-shot ImageNet eval over a
    built text-input tower: 'This is {class}' through the Q-Former's text
    branch (byte-tokenizer ids folded into its vocabulary, right-padded),
    L2-normalised, [C, D_q]; ``image_embed_fn`` as ``_imagenet_fns``."""
    tokenizer = ByteTokenizer() if tokenizer is None else tokenizer
    qv = model_cfg.qformer.vocab_size
    rows = [_fold_ids(np.asarray(tokenizer.encode(f"This is {c}"), np.int64), qv)
            for c in class_names]
    W = max(len(r) for r in rows)
    ids = np.zeros((len(rows), W), np.int64)
    mask = np.zeros((len(rows), W), np.int64)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
        mask[i, :len(r)] = 1
    return _imagenet_fns(model_cfg, params, ids, mask)


def native_blip2_imagenet_fns(hf_model_dir: Optional[str] = None, class_names=(),
                              kind: str = "flant5", device=None):
    """(image_embed_fn, class_embeds) for ``ImageNetPipeline``, the form of
    the reference's BLIP2 / InstructBLIP ImageNet pipelines.  Without a
    snapshot: the tiny "llama_text" config (the tiny config with text-input
    Q-Former weights) with random weights from seed 0 and the byte
    tokenizer, through ``blip2_imagenet_fns``.  ``hf_model_dir``: ``kind``'s
    published config with the text-input Q-Former, its weights read from
    the snapshot in f32, 'This is {class}' through the Q-Former tokenizer
    (``qformer_tokenizer/``, else the snapshot's own) padded to the longest
    row.  A BLIP-2 snapshot has no Q-Former text weights and raises a
    ``ValueError`` that names them (JAX's import dies on a bare KeyError).
    ``device``: default the GPU."""
    _blip2_cfg_cls(kind)
    dev = _resolve_device(device, None)
    if hf_model_dir is None:
        cfg = tiny_blip2_config("llama_text")
        params = init_blip2_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        return blip2_imagenet_fns(cfg, params, list(class_names))
    cfg, _ = _blip2_cfg_cls(kind)
    cfg = dataclasses.replace(cfg, qformer=dataclasses.replace(cfg.qformer, use_text_input=True))
    check_blip2_config(hf_model_dir, cfg)
    params = load_blip2_safetensors(hf_model_dir, cfg, dtype=torch.float32, device=dev)
    qdir = os.path.join(hf_model_dir, "qformer_tokenizer")
    tok = TokenizerJSON(qdir if os.path.isdir(qdir) else hf_model_dir)
    ids, mask = tok([f"This is {c}" for c in class_names])
    return _imagenet_fns(cfg, params, ids, mask)


def native_kosmos2_answer_fn(model_cfg=None, params=None, tokenizer=None,
                             max_new_tokens: int = 10, hf_model_dir: Optional[str] = None,
                             device=None) -> Callable:
    """``answer(question, image) -> str`` through KOSMOS-2: the prompt
    ``[bos, <image> x latent_query_num, 'Question: {q} Answer:']``, greedy
    decode with eos 2, the text after the last 'Answer:'.  With no
    ``model_cfg`` the tiny config with random weights from seed 0 and the
    byte tokenizer (smoke mode).  ``hf_model_dir``: a local
    microsoft/kosmos-2-patch14-224 snapshot (``_hf_kosmos2_answer_fn``)."""
    if hf_model_dir is not None:
        return _hf_kosmos2_answer_fn(hf_model_dir, max_new_tokens, device)
    dev = _resolve_device(device, params)
    if model_cfg is None:
        model_cfg = tiny_kosmos2_config()
        params = init_kosmos2_params(model_cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokenizer = ByteTokenizer() if tokenizer is None else tokenizer
    vocab = model_cfg.text.vocab_size
    n_img = model_cfg.latent_query_num
    side = model_cfg.vision.image_size
    spec = MODEL_SPECS["kosmos2"]

    def answer(question: str, image) -> str:
        text = spec.prompt.format(q=question)
        tids = _fold_ids(np.asarray(tokenizer.encode(text), np.int64), vocab)
        # HF kosmos2 prompt layout: [bos, <image> * latent_query_num, text...]
        ids = np.concatenate([[1], np.full((n_img,), 3, np.int64), tids])
        img_mask = np.zeros_like(ids)
        img_mask[1:1 + n_img] = 1
        pix = torch.from_numpy(_fit_image(image, side)[None]).to(dev)
        out = kosmos2_generate(
            params, model_cfg, pix, torch.from_numpy(ids[None]).to(dev),
            torch.from_numpy(img_mask[None]).to(dev),
            torch.ones((1, len(ids)), dtype=torch.int64, device=dev), max_new_tokens,
            eos_token_id=2)
        ans = _decode(tokenizer, [int(t) for t in out[0].tolist() if int(t) > 2])
        return ans.split("Answer:")[-1].strip() if "Answer:" in ans else ans

    return answer


def _hf_blip2_answer_fn(model_dir: str, kind: str, max_new_tokens: int, num_beams: int,
                        length_penalty: float, device=None) -> Callable:
    """``answer(question, image)`` from a local snapshot: ``kind``'s
    published config (held to the snapshot's config.json), the weights in
    f32, the prompt through the snapshot's tokenizer (Flan-T5's Unigram, or
    InstructBLIP's Vicuna BPE and, into the Q-Former, its WordPiece
    ``qformer_tokenizer/``), the image through the CLIP preprocessing at the
    tower's size, then beam search (greedy when ``num_beams`` is 1) with the
    tokenizer's eos and pad (0 when it has none), the special tokens
    dropped from the decoded answer."""
    cfg, _ = _blip2_cfg_cls(kind)
    if kind == "opt":
        raise NotImplementedError("native_blip2_answer_fn(kind='opt'): the OPT tower waits for "
                                  "the BLIP-2 OPT item (queue 1 item 2.6 of ROADMAP.md)")
    check_blip2_config(model_dir, cfg)
    dev = _resolve_device(device, None)
    params = load_blip2_safetensors(model_dir, cfg, dtype=torch.float32, device=dev)
    if kind == "instructblip":
        tok = HFTokenizer(model_dir)
        qtok = TokenizerJSON(os.path.join(model_dir, "qformer_tokenizer"))
        pad = tok.config_pad_token_id or 0
    else:
        tok, qtok = TokenizerJSON(model_dir), None
        pad = tok.pad_token_id or 0
    eos = tok.eos_token_id if tok.eos_token_id is not None else -1
    spec = MODEL_SPECS["instructblip" if kind == "instructblip" else "blip2"]

    def row(ids):
        return (torch.tensor([ids], dtype=torch.int64, device=dev),
                torch.ones((1, len(ids)), dtype=torch.int64, device=dev))

    def answer(question: str, image) -> str:
        text = spec.prompt.format(q=question)
        ids, mask = row(tok.encode(text))
        pix = torch.from_numpy(preprocess_numpy([np.asarray(image)],
                                                cfg.vision.image_size)).to(dev)
        kwargs = {}
        if qtok is not None:
            qids, qmask = row(qtok.encode(text))
            kwargs = {"qformer_text_ids": qids, "qformer_text_mask": qmask}
        with torch.inference_mode():
            if num_beams > 1:
                out = blip2_beam_generate(params, cfg, pix, ids, mask, max_new_tokens,
                                          num_beams=num_beams, length_penalty=length_penalty,
                                          eos_token_id=eos, pad_token_id=pad, **kwargs)
            else:
                out = blip2_generate(params, cfg, pix, ids, mask, max_new_tokens,
                                     eos_token_id=eos, **kwargs)
        return tok.decode(out[0].tolist(), skip_special_tokens=True).strip()

    return answer


def _hf_kosmos2_answer_fn(model_dir: str, max_new_tokens: int, device=None) -> Callable:
    """``answer(question, image)`` from a local KOSMOS-2 snapshot: the
    published config (held to config.json), the weights in f32, the port's
    ``Kosmos2Processor`` (the prompt's image-token layout and the
    snapshot's CLIP pixels), greedy decode to the tokenizer's eos, the
    special tokens dropped, the text after the last 'Answer:'."""
    cfg = Kosmos2Config()
    check_kosmos2_config(model_dir, cfg)
    if cfg.latent_query_num != NUM_IMAGE_TOKENS:
        raise ValueError(f"KOSMOS-2 with {cfg.latent_query_num} latent queries: the processor "
                         f"lays out {NUM_IMAGE_TOKENS} image tokens")
    dev = _resolve_device(device, None)
    params = load_kosmos2_safetensors(model_dir, cfg, dtype=torch.float32, device=dev)
    proc = Kosmos2Processor(model_dir)
    eos = proc.tokenizer.eos_token_id if proc.tokenizer.eos_token_id is not None else -1

    def answer(question: str, image) -> str:
        text = MODEL_SPECS["kosmos2"].prompt.format(q=question)
        ids, attn, img_mask, pix = (torch.from_numpy(a).to(dev) for a in proc(image, text))
        with torch.inference_mode():
            out = kosmos2_generate(params, cfg, pix, ids, img_mask, attn, max_new_tokens,
                                   eos_token_id=eos)
        txt = proc.tokenizer.decode(out[0].tolist(), skip_special_tokens=True)
        return txt.split("Answer:")[-1].strip()

    return answer


def native_bakllava_answer_fn(model_dir: str, max_new_tokens: int = 128,
                              device=None) -> Callable:
    """``answer(question, image)`` through BakLLaVA-1 from a local
    llava-hf/bakLlava-v1-hf snapshot: ``bakllava_config()`` (held to the
    snapshot's config.json: widths, depth, heads, kv heads, the sliding
    window, rope theta, vocabulary), the weights in bf16 on the card and
    in the snapshot's dtype elsewhere (the compute dtype too), the
    snapshot's BPE tokenizer, the prompt
    'USER: <image>\\n{q} ASSISTANT:' with its <image> expanded to the
    vision tower's patches, greedy decode of at most ``max_new_tokens`` to
    the tokenizer's eos.  ``device``: default the GPU."""
    cfg = bakllava_config()
    hf = read_config_json(model_dir)
    t, v = cfg.text, cfg.vision
    # a field config.json leaves out takes MistralConfig's / CLIP's default,
    # which bakllava_config() matches
    want = {"image_token_index": cfg.image_token_id}
    want.update({f"text_config.{k}": getattr(t, k) for k in (
        "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "sliding_window", "rope_theta")})
    want.update({f"vision_config.{k}": getattr(v, k) for k in (
        "hidden_size", "num_hidden_layers", "num_attention_heads", "image_size", "patch_size")})
    compare_config(model_dir, hf, want)
    dev = _resolve_device(device, None)
    # the card computes in bf16 (K1 and K4 take bf16) whatever the files
    # hold; elsewhere the snapshot's dtype (the CPU tests hold f32 to JAX's)
    params = load_llava_safetensors(model_dir, cfg, device=dev,
                                    dtype=torch.bfloat16 if dev.type == "cuda" else None)
    dtype = params["language_model"]["embed_tokens"].dtype
    tok = HFTokenizer(model_dir)
    if tok.image_token_id != cfg.image_token_id:
        raise ValueError(f"{model_dir}: the tokenizer's <image> is {tok.image_token_id}, the "
                         f"model's {cfg.image_token_id}")
    gen = GenerationConfig(max_new_tokens=max_new_tokens, do_sample=False,
                           eos_token_id=tok.eos_token_id)

    def answer(question: str, image) -> str:
        text = MODEL_SPECS["bakllava"].prompt.format(q=question)
        ids, mask, _ = expand_image_token(tok.encode(text), None, None, tok.image_token_id,
                                          cfg.num_image_tokens)
        pix = preprocess_numpy([np.asarray(image)], cfg.vision.image_size)
        out = generate(params, cfg, torch.from_numpy(ids[None].astype(np.int64)).to(dev),
                       torch.from_numpy(pix).to(dev, dtype),
                       torch.from_numpy(mask[None].astype(np.int64)).to(dev), gen,
                       max_len=len(ids) + max_new_tokens, compute_dtype=dtype)
        return tok.decode(out[0].tolist(), skip_special_tokens=True).strip()

    return answer


@register_pipeline("VLZooVQAPipeline")
class VLZooVQAPipeline:
    """Runs a ``MODEL_SPECS`` entry (or a custom spec) on the VQA harness
    through an injected ``answer_fn`` (a native answerer above)."""

    def __init__(self, cfg, spec, model_path: Optional[str] = None,
                 answer_fn: Optional[Callable] = None):
        self.cfg = cfg
        self.spec = MODEL_SPECS[spec] if isinstance(spec, str) else spec
        self.model_path = model_path or self.spec.name
        self._answer_fn = answer_fn
        self.evaluator = VQAEvaluator()

    def answer(self, question: str, image) -> str:
        if self._answer_fn is None:
            raise NotImplementedError(
                f"VLZooVQAPipeline({self.spec.name}): the HF harness loads the checkpoint with "
                "transformers, which the port does not use; pass a native answer_fn")
        return self._answer_fn(question, image)

    def evaluate_model(self, dataset: Iterable[dict], limit: Optional[int] = None) -> dict:
        rows = itertools.islice(dataset, limit) if limit else dataset
        for r in rows:
            ans = self.answer(r["question"], r.get("image"))
            self.evaluator.process(r["question_id"], ans, r["answers"],
                                   r.get("question_type"), r.get("answer_type"))
        return self.evaluator.evaluate()
