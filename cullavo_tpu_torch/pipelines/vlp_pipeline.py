"""VLP eval pipelines (counterpart of ``cullavo_tpu/pipelines/vlp_pipeline.py``):
image <-> caption retrieval (ir@k / tr@k) and greedy captioning with the
caption metrics, over rows of the karpathy Arrow splits
(``data/vlp_datasets.py``).

Images are resized to a square (``resize_image``, bicubic) and normalized
on the host, then batched.  Retrieval follows the karpathy protocol: every
caption of an image joins the text pool, grouped by ``image_id``, and the
score is the 0.5 / 0.5 ensemble of the class-token and backbone
embeddings where the model has a ``backbone_proj``.  Captioning scores
with the raw token-embedding table when its width equals ``dim_proj``,
else with ``token_embedding @ lang_proj``; each step re-encodes the
partial caption through the text encoder (an all-ones mask over the whole
context); a row's ``captioning_mask`` [H, W] (True = excluded) is resized
by nearest index (``linspace``) to the image square.  Both return JAX's
metric dict plus "timing": per-batch data / compute / eval seconds and
images/s after the first batch, for captioning also the trunk's seconds a
batch and the milliseconds a decode step (a synchronize between the two;
none inside the decode loop).
"""
from __future__ import annotations

import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from cullavo_tpu_torch.data.coco_panoptic import resize_image
from cullavo_tpu_torch.data.evaluation.evaluators import CaptioningEvaluator, RetrievalEvaluator
from cullavo_tpu_torch.data.mappers.eval_mappers import normalize_np
from cullavo_tpu_torch.models.xdecoder import text_encoder as te
from cullavo_tpu_torch.models.xdecoder.decoder import forward_captioning
from cullavo_tpu_torch.models.xdecoder.model import (XDecoderModelConfig,
                                                     backbone_and_pixel_decoder,
                                                     evaluate_retrieval_embedding)
from cullavo_tpu_torch.pipelines.base import batch_timing, register_pipeline


def _prep_image(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 [H, W, 3] -> normalized f32 [size, size, 3]."""
    return normalize_np(resize_image(img, size))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@register_pipeline("VLPRetrievalPipeline")
class VLPRetrievalPipeline:
    """Image <-> caption retrieval over the karpathy test split."""

    def __init__(self, cfg, model_cfg: XDecoderModelConfig, params, tokenize: Callable,
                 image_loader: Callable, image_size: int = 224, batch_size: int = 8):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.params = params
        self.tokenize = tokenize
        self.image_loader = image_loader
        self.image_size = image_size
        self.batch_size = max(1, int(batch_size))
        self.device = params["decoder"]["query_feat"].device

    @torch.inference_mode()
    def _embed(self, imgs: np.ndarray, ids: np.ndarray, mask: np.ndarray):
        """(image embeddings, backbone embeddings or None, text embeddings),
        as numpy."""
        emb, emb2 = evaluate_retrieval_embedding(self.params, self.model_cfg,
                                                 torch.as_tensor(imgs, device=self.device))
        t_emb = te.forward_language(self.params["text"], self.model_cfg.text,
                                    torch.as_tensor(ids, device=self.device),
                                    torch.as_tensor(mask, device=self.device))

        def host(t):
            return None if t is None else t.float().cpu().numpy()

        return host(emb), host(emb2), host(t_emb)

    def evaluate_model(self, dataset: Iterable[dict], limit: Optional[int] = None,
                       warmup: int = 1) -> dict:
        """dataset rows: {"captions", "image_id", ...} that ``image_loader``
        turns into uint8 images.  Returns ir@1/5/10, tr@1/5/10 and "timing"."""
        rows = list(dataset)
        if limit:
            rows = rows[:limit]
        ev = RetrievalEvaluator()
        B = self.batch_size
        data_t, compute_t, eval_t = [], [], []
        t_last = time.perf_counter()
        for i in range(0, len(rows), B):
            chunk = rows[i:i + B]
            imgs = np.stack([_prep_image(self.image_loader(r), self.image_size) for r in chunk])
            texts, owner = [], []
            for b, r in enumerate(chunk):
                caps = list(r.get("captions") or [""])
                texts.extend(caps)
                owner.extend([b] * len(caps))
            ids, mask = self.tokenize(texts)
            t0 = time.perf_counter()
            data_t.append(t0 - t_last)
            img_emb, img_emb2, t_emb = self._embed(imgs, np.asarray(ids), np.asarray(mask))
            t1 = time.perf_counter()
            compute_t.append(t1 - t0)
            owner = np.asarray(owner)
            for b, r in enumerate(chunk):
                ev.add(img_emb[b], t_emb[owner == b], image_id=r.get("image_id", i + b),
                       image_emb2=img_emb2[b] if img_emb2 is not None else None)
            t_last = time.perf_counter()
            eval_t.append(t_last - t1)
        out = ev.results()
        out["timing"] = batch_timing(data_t, compute_t, eval_t, len(rows), B, warmup)
        return out


@register_pipeline("COCOCaptionXDecPipeline")
class VLPCaptioningPipeline:
    """Captioning eval through the decoder's greedy caption head, scored by
    ``CaptioningEvaluator``."""

    def __init__(self, cfg, model_cfg: XDecoderModelConfig, params, image_loader: Callable,
                 decode_text: Callable, start_token_id: int = 49406, image_size: int = 224,
                 batch_size: int = 8):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.params = params
        self.image_loader = image_loader
        self.decode_text = decode_text
        self.start_token_id = start_token_id
        self.image_size = image_size
        self.batch_size = max(1, int(batch_size))
        self.device = params["decoder"]["query_feat"].device

    def vocab_table(self):
        """The table the caption slots are scored against: the raw token
        embeddings when their width is ``dim_proj``, else through
        ``lang_proj``."""
        tp = self.params["text"]
        vocab = tp["token_embedding"]
        if vocab.shape[-1] != self.model_cfg.decoder.dim_proj:
            vocab = vocab @ tp["lang_proj"]
        return vocab

    def token_embeddings(self, ids):
        """[B, T] ids -> the caption slots' embeddings [B, T, dim_lang]: the
        text encoder over the whole context, mask all ones."""
        mask = torch.ones(ids.shape, dtype=torch.int32, device=ids.device)
        token_emb, _ = te.forward_language_token(self.params["text"], self.model_cfg.text, ids,
                                                 mask)
        return token_emb

    @torch.inference_mode()
    def decode(self, imgs: np.ndarray, captioning_mask: Optional[np.ndarray] = None):
        """Normalized images [B, S, S, 3] -> (ids [B, contxt_len] numpy, the
        trunk's seconds, the decode loop's seconds)."""
        t0 = time.perf_counter()
        mask_features, pyramid = backbone_and_pixel_decoder(
            self.params, self.model_cfg, torch.as_tensor(imgs, device=self.device))
        cm = None if captioning_mask is None else torch.as_tensor(captioning_mask,
                                                                  device=self.device)
        _sync(self.device)
        t1 = time.perf_counter()
        ids = forward_captioning(self.params["decoder"], self.model_cfg.decoder, pyramid,
                                 mask_features, self.token_embeddings, self.vocab_table(),
                                 self.start_token_id, captioning_mask=cm)
        ids = ids.cpu().numpy()
        return ids, t1 - t0, time.perf_counter() - t1

    def evaluate_model(self, dataset: Iterable[dict], limit: Optional[int] = None,
                       out_path: Optional[str] = None, warmup: int = 1) -> dict:
        """dataset rows: {"captions", "image_id", optional "captioning_mask"
        [H, W] bool}.  Returns the caption metrics and "timing"; writes the
        captions to ``out_path`` (JSON) when given."""
        rows = list(dataset)
        if limit:
            rows = rows[:limit]
        ev = CaptioningEvaluator()
        B, S = self.batch_size, self.image_size
        data_t, compute_t, eval_t, trunk_t, loop_t = [], [], [], [], []
        t_last = time.perf_counter()
        for i in range(0, len(rows), B):
            chunk = rows[i:i + B]
            imgs = np.stack([_prep_image(self.image_loader(r), S) for r in chunk])
            cm = None
            if any("captioning_mask" in r for r in chunk):
                # rows without a mask get an all-False one (no region excluded)
                cm = np.zeros((len(chunk), S, S), bool)
                for b, r in enumerate(chunk):
                    if "captioning_mask" in r:
                        m = np.asarray(r["captioning_mask"], bool)
                        ri = np.linspace(0, m.shape[0] - 1, S).astype(int)
                        ci = np.linspace(0, m.shape[1] - 1, S).astype(int)
                        cm[b] = m[ri][:, ci]
            t0 = time.perf_counter()
            data_t.append(t0 - t_last)
            ids, trunk_s, loop_s = self.decode(imgs, cm)
            t1 = time.perf_counter()
            compute_t.append(t1 - t0)
            trunk_t.append(trunk_s)
            loop_t.append(loop_s)
            for b, r in enumerate(chunk):
                ev.add(r["image_id"], self.decode_text(ids[b].tolist()), r["captions"])
            t_last = time.perf_counter()
            eval_t.append(t_last - t1)
        if out_path:
            ev.dump_results(out_path)
        out = ev.results()
        out["timing"] = batch_timing(data_t, compute_t, eval_t, len(rows), B, warmup)
        w = min(warmup, max(len(loop_t) - 1, 0))
        cfgd = self.model_cfg.decoder
        steps = min(cfgd.captioning_step, cfgd.contxt_len - 1)
        out["timing"]["trunk_s"] = float(np.mean(trunk_t[w:])) if trunk_t[w:] else 0.0
        out["timing"]["step_ms"] = (1e3 * float(np.mean(loop_t[w:])) / steps
                                    if loop_t[w:] else 0.0)
        return out
