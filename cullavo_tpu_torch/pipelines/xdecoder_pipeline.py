"""X-Decoder segmentation eval pipeline (counterpart of
``cullavo_tpu/pipelines/xdecoder_pipeline.py``): per-dataset semantic /
instance / panoptic toggles, images bucketed to multiples of 128 and
batched (the short tail padded with zero images whose outputs are not
read), class-name text embeddings computed once by the caller, and
data / compute / eval timing.

Per batch, everything per pixel stays on the device, as in JAX's fused
program: the bicubic upsample to the bucket, the semantic argmax map, the
panoptic winner maps with their per-query counts and the instance bit
planes; only those compact tensors cross to the host, where the panoptic
seg-id loop and the metrics run.

``RefCOCOPipeline`` is the referring-segmentation eval: one phrase per
row through ``evaluate_grounding``, rows grouped by image bucket and text
length (a multiple of 16, capped at the text encoder's context), batched
(a short batch padded with zero images that repeat row 0's phrase; their
outputs are not read), cIoU / mIoU / precision@tau in total and per
category, ``ref_coco.csv`` under ``out_dir``, and timing as
``XDecoderPipeline``'s.
"""
from __future__ import annotations

import collections
import csv
import dataclasses
import os
import time
from typing import Iterable, Optional

import numpy as np
import torch

from cullavo_tpu_torch.data.evaluation.evaluators import InstanceSegEvaluator, PanopticEvaluator
from cullavo_tpu_torch.models.xdecoder.model import (XDecoderModelConfig, evaluate_grounding,
                                                     forward_eval,
                                                     instance_inference_device,
                                                     panoptic_assemble_host,
                                                     panoptic_inference_device,
                                                     semantic_inference_argmax,
                                                     unpack_mask_planes)
from cullavo_tpu_torch.pipelines.base import batch_timing, register_pipeline


@dataclasses.dataclass
class EvalTasks:
    """Explicit per-dataset flags (the reference's hook_switcher)."""
    semantic: bool = True
    instance: bool = False
    panoptic: bool = False


_SEM_ONLY = {"cityscapes_fine_sem_seg_val", "scannet_21_val_seg",
             "scannet_38_val_seg", "scannet_41_val_seg", "sunrgbd_37_val_seg",
             "context_59_val_seg", "context_459_val_seg", "voc_2012_val_seg",
             "bdd10k_val_sem_seg", "ade20k_full_sem_seg_val"}
_INST_ONLY = {"cityscapes_fine_instance_seg_val"}
_SEM_PANO = {"cityscapes_fine_panoptic_val", "scannet_21_panoptic_val",
             "bdd10k_40_panoptic_val"}
_ALL_ON = {"coco_2017_val_panoptic_with_sem_seg", "ade20k_panoptic_val",
           "coco_2017_test-dev"}
_NO_SEG = {"vlp_val", "vlp_captioning_val", "vlp_val2017",
           "vlp_captioning_val2017", "imagenet_val", "refcocog_val_google",
           "phrasecut_val", "phrasecut_test", "refcocop_val_unc",
           "refcoco_val_unc", "refcocog_val_umd", "pascalvoc_val_Point",
           "grounding_coco_entity_val", "vlp_coco_entity_val", "vqav2_train",
           "vqav2_test", "vqav2_test-dev", "vqav2_val", "sharegpt4v"}


def tasks_for_dataset(name: str, default: Optional[EvalTasks] = None) -> EvalTasks:
    """The reference's per-dataset switches; a name it does not define
    gives ``default``, or raises ValueError without one."""
    if name in _SEM_ONLY:
        return EvalTasks(semantic=True, instance=False, panoptic=False)
    if name in _INST_ONLY or "seginw" in name:
        return EvalTasks(semantic=False, instance=True, panoptic=False)
    if name in _SEM_PANO:
        return EvalTasks(semantic=True, instance=False, panoptic=True)
    if name in _ALL_ON:
        return EvalTasks(semantic=True, instance=True, panoptic=True)
    if name in _NO_SEG:
        return EvalTasks(semantic=False, instance=False, panoptic=False)
    if default is not None:
        return default
    raise ValueError(f"dataset switcher is not defined for {name!r}")


class GroundingMetrics:
    """cIoU / mIoU / precision@{0.5..0.9} accumulator."""

    def __init__(self):
        self.inter = 0.0
        self.union = 0.0
        self.ious: list = []

    def add(self, pred_mask: np.ndarray, gt_mask: np.ndarray):
        p = pred_mask > 0
        g = gt_mask > 0.5
        inter = float(np.logical_and(p, g).sum())
        union = float(np.logical_or(p, g).sum())
        self.inter += inter
        self.union += union
        self.ious.append(inter / union if union > 0 else 0.0)

    def results(self) -> dict:
        ious = np.asarray(self.ious) if self.ious else np.zeros(1)
        out = {"cIoU": 100.0 * self.inter / max(self.union, 1.0),
               "mIoU": 100.0 * float(ious.mean())}
        for tau in (0.5, 0.6, 0.7, 0.8, 0.9):
            out[f"precision@{tau}"] = 100.0 * float((ious > tau).mean())
        return out


class SemSegMetrics:
    """Confusion-matrix mIoU."""

    def __init__(self, num_classes: int, ignore_label: int = 255):
        self.num_classes = num_classes
        self.ignore = ignore_label
        self.conf = np.zeros((num_classes, num_classes), np.int64)

    def add(self, pred: np.ndarray, gt: np.ndarray):
        keep = gt != self.ignore
        p = pred[keep].astype(np.int64)
        g = gt[keep].astype(np.int64)
        idx = g * self.num_classes + p
        self.conf += np.bincount(idx, minlength=self.num_classes ** 2).reshape(
            self.num_classes, self.num_classes)

    def results(self) -> dict:
        tp = np.diag(self.conf).astype(np.float64)
        fp = self.conf.sum(0) - tp
        fn = self.conf.sum(1) - tp
        iou = tp / np.maximum(tp + fp + fn, 1)
        acc = tp / np.maximum(self.conf.sum(1), 1)
        valid = self.conf.sum(1) > 0
        return {"mIoU": 100.0 * float(iou[valid].mean()) if valid.any() else 0.0,
                "fwIoU": 100.0 * float((iou * self.conf.sum(1)).sum()
                                       / max(self.conf.sum(), 1)),
                "mACC": 100.0 * float(acc[valid].mean()) if valid.any() else 0.0,
                "pACC": 100.0 * float(tp.sum() / max(self.conf.sum(), 1))}


def _bucket_hw(h: int, w: int, step: int = 128) -> tuple:
    """Round (h, w) up to multiples of ``step``."""
    return (-(-h // step) * step, -(-w // step) * step)


@register_pipeline("XDecoderPipeline")
class XDecoderPipeline:
    def __init__(self, cfg, model_cfg: XDecoderModelConfig, params, text_class_embeds,
                 tasks: EvalTasks = EvalTasks(), bucket_step: int = 128, eval_batch: int = 8):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.params = params
        self.text_class_embeds = text_class_embeds
        self.tasks = tasks
        self.bucket_step = bucket_step
        self.eval_batch = max(1, int(eval_batch))
        self.device = params["decoder"]["query_feat"].device
        # the classes scored are the class embeddings' (the background row
        # last), which may be more than the config's NUM_CLASSES: the JAX
        # pipeline counts the config's, and a 150-class dataset under a
        # 133-class config overflows its confusion matrix there
        self.num_classes = int(text_class_embeds.shape[0]) - 1

    @torch.inference_mode()
    def _run_batch(self, img: np.ndarray, hw: np.ndarray, out_size) -> dict:
        """One padded batch through the model and the device-side inferences;
        returns the compact outputs as numpy arrays."""
        cfgm, tasks = self.model_cfg, self.tasks
        images = torch.as_tensor(img, device=self.device)
        mask_cls, mask_pred, _ = forward_eval(self.params, cfgm, images,
                                              self.text_class_embeds, out_size=out_size)
        out = {}
        B = images.shape[0]
        if tasks.semantic:
            out["sem"] = torch.stack([semantic_inference_argmax(mask_cls[j], mask_pred[j])
                                      for j in range(B)])
        if tasks.panoptic:
            pans = [panoptic_inference_device(mask_cls[j], mask_pred[j],
                                              cfgm.object_mask_threshold, valid_hw=hw[j])
                    for j in range(B)]
            out["pan"] = {k: torch.stack([p[k] for p in pans]) for k in pans[0]}
        if tasks.instance:
            insts = [instance_inference_device(mask_cls[j], mask_pred[j], self.num_classes,
                                               cfgm.test_topk_per_image, valid_hw=hw[j])
                     for j in range(B)]
            out["inst"] = {k: torch.stack([p[k] for p in insts]) for k in insts[0]}

        def host(node):
            if isinstance(node, dict):
                return {k: host(v) for k, v in node.items()}
            return node.cpu().numpy()

        return host(out)

    def evaluate_model(self, dataset: Iterable[dict], limit: Optional[int] = None,
                       thing_ids=frozenset(), warmup: int = 1) -> dict:
        """dataset rows: {"image" [H, W, 3] float (normalized), optional
        "sem_seg" [H, W] int gt, "pan_seg_gt" + "segments_gt",
        "instances_gt" {"masks", "classes"}, "image_id"}.  Returns the
        metric dict, the per-image panoptic / instance outputs and timing."""
        rows = list(dataset)
        if limit:
            rows = rows[:limit]
        sem_metrics = SemSegMetrics(self.num_classes)
        pan_outputs, inst_outputs = [], []
        inst_metrics = InstanceSegEvaluator() if self.tasks.instance else None
        pan_metrics = PanopticEvaluator(self.num_classes) if self.tasks.panoptic else None
        data_t, compute_t, eval_t = [], [], []
        n_images = 0
        t_last = time.perf_counter()
        by_bucket = collections.OrderedDict()
        for i, row in enumerate(rows):
            h, w = row["image"].shape[:2]
            by_bucket.setdefault(_bucket_hw(h, w, self.bucket_step), []).append(i)
        B = self.eval_batch
        for (bh, bw), idxs in by_bucket.items():
            for off in range(0, len(idxs), B):
                group = idxs[off:off + B]
                first = rows[group[0]]["image"]
                img = np.zeros((B, bh, bw, first.shape[2]), first.dtype)
                hw = np.zeros((B, 2), np.int32)
                for j, i in enumerate(group):
                    r = rows[i]["image"]
                    img[j, :r.shape[0], :r.shape[1]] = r
                    hw[j] = r.shape[:2]
                t0 = time.perf_counter()
                data_t.append(t0 - t_last)
                # the device-to-host copy ends the compute window
                out_host = self._run_batch(img, hw, (bh, bw))
                t1 = time.perf_counter()
                compute_t.append(t1 - t0)
                n_images += len(group)
                for j, i in enumerate(group):
                    row = rows[i]
                    h, w = row["image"].shape[:2]
                    if "sem" in out_host and "sem_seg" in row:
                        sem_metrics.add(out_host["sem"][j][:h, :w].astype(np.int64),
                                        row["sem_seg"])
                    if self.tasks.panoptic:
                        dev_j = {k: v[j] for k, v in out_host["pan"].items()}
                        pan, segs = panoptic_assemble_host(dev_j, thing_ids,
                                                           self.model_cfg.overlap_threshold)
                        pan = pan[:h, :w]
                        pan_outputs.append({"image_id": row.get("image_id"), "panoptic": pan,
                                            "segments": segs})
                        if "pan_seg_gt" in row:
                            pan_metrics.add(pan, segs, row["pan_seg_gt"], row["segments_gt"])
                    if self.tasks.instance:
                        inst = out_host["inst"]
                        masks = unpack_mask_planes(inst["mask_planes"][j],
                                                   inst["scores"].shape[1])[:, :h, :w]
                        inst_outputs.append({"image_id": row.get("image_id"),
                                             "scores": inst["scores"][j],
                                             "classes": inst["classes"][j], "masks": masks})
                        if "instances_gt" in row:
                            gt = row["instances_gt"]
                            inst_metrics.add(masks, inst["classes"][j], inst["scores"][j],
                                             np.asarray(gt["masks"]).astype(bool),
                                             np.asarray(gt["classes"]))
                t_last = time.perf_counter()
                eval_t.append(t_last - t1)
        out: dict = {}
        if self.tasks.semantic:
            out["sem_seg"] = sem_metrics.results()
        if self.tasks.panoptic:
            out["panoptic_outputs"] = pan_outputs
            if (pan_metrics.tp.sum() + pan_metrics.fp.sum() + pan_metrics.fn.sum()) > 0:
                out["panoptic"] = pan_metrics.results()
        if self.tasks.instance:
            out["instance_outputs"] = inst_outputs
            if inst_metrics.n_gt:
                out["instance_ap"] = inst_metrics.results()
        out["timing"] = batch_timing(data_t, compute_t, eval_t, n_images, self.eval_batch, warmup)
        return out


@register_pipeline("RefCOCOPipeline")
class RefCOCOPipeline:
    def __init__(self, cfg, model_cfg: XDecoderModelConfig, params, tokenize,
                 eval_batch: int = 8):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.params = params
        self.tokenize = tokenize
        self.eval_batch = max(1, int(eval_batch))
        self.device = params["decoder"]["query_feat"].device
        self.total = GroundingMetrics()
        self.per_class: dict = {}

    def _prep(self, row):
        """row -> (image bucket, text length, ids [L], mask [L])."""
        ids, mask = self.tokenize([row["text"]])
        ids, mask = np.asarray(ids).reshape(-1), np.asarray(mask).reshape(-1)
        tlen = min(-(-max(len(ids), 1) // 16) * 16, self.model_cfg.text.context_length)
        if len(ids) >= tlen:
            ids, mask = ids[:tlen], mask[:tlen]
        else:
            ids, mask = np.pad(ids, (0, tlen - len(ids))), np.pad(mask, (0, tlen - len(mask)))
        h, w = row["image"].shape[:2]
        return _bucket_hw(h, w), tlen, ids, mask

    @torch.inference_mode()
    def _run_batch(self, img, ids, mask, out_size) -> np.ndarray:
        pred = evaluate_grounding(self.params, self.model_cfg,
                                  torch.as_tensor(img, device=self.device), ids, mask,
                                  out_size=out_size)
        return pred.float().cpu().numpy()

    def evaluate_model(self, dataset: Iterable[dict], limit: Optional[int] = None,
                       out_dir: Optional[str] = None, warmup: int = 1) -> dict:
        """dataset rows: {"image" [H, W, 3] float (normalized), "text",
        "gt_mask" [H, W], optional "category"}.  Returns cIoU, mIoU and
        precision@{0.5, ..., 0.9} over every row, and "timing"."""
        rows = list(dataset)
        if limit:
            rows = rows[:limit]
        prepped = [self._prep(r) for r in rows]
        by_bucket = collections.OrderedDict()
        for i, (ib, tb, _, _) in enumerate(prepped):
            by_bucket.setdefault((ib, tb), []).append(i)
        B = self.eval_batch
        data_t, compute_t, eval_t = [], [], []
        n_images = 0
        t_last = time.perf_counter()
        for ((bh, bw), tlen), idxs in by_bucket.items():
            for off in range(0, len(idxs), B):
                group = idxs[off:off + B]
                first = rows[group[0]]["image"]
                img = np.zeros((B, bh, bw, first.shape[2]), first.dtype)
                ids_b = np.zeros((B, tlen), np.int32)
                mask_b = np.zeros((B, tlen), np.int32)
                for j, i in enumerate(group):
                    r = rows[i]["image"]
                    img[j, :r.shape[0], :r.shape[1]] = r
                    ids_b[j], mask_b[j] = prepped[i][2], prepped[i][3]
                # pad rows repeat row 0's phrase (all-zero ids would send the
                # text encoder's argmax pooling to position 0)
                ids_b[len(group):], mask_b[len(group):] = ids_b[0], mask_b[0]
                t0 = time.perf_counter()
                data_t.append(t0 - t_last)
                pred = self._run_batch(img, ids_b, mask_b, (bh, bw))
                t1 = time.perf_counter()
                compute_t.append(t1 - t0)
                n_images += len(group)
                for j, i in enumerate(group):
                    row = rows[i]
                    h, w = row["image"].shape[:2]
                    p = pred[j][:h, :w]
                    self.total.add(p, row["gt_mask"])
                    if row.get("category") is not None:
                        self.per_class.setdefault(row["category"], GroundingMetrics()).add(
                            p, row["gt_mask"])
                t_last = time.perf_counter()
                eval_t.append(t_last - t1)
        results = self.total.results()
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, "ref_coco.csv"), "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["class"] + list(results))
                for cls, gm in sorted(self.per_class.items()):
                    r = gm.results()
                    w.writerow([cls] + [round(r[k], 2) for k in results])
                w.writerow(["TOTAL"] + [round(results[k], 2) for k in results])
        results["timing"] = batch_timing(data_t, compute_t, eval_t, n_images, B, warmup)
        return results
