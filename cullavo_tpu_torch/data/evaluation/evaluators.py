"""Segmentation evaluators (the port's own copy of ``PanopticEvaluator``
and ``InstanceSegEvaluator`` from ``cullavo_tpu/data/evaluation/evaluators.py``,
numpy only): panoptic quality by the panopticapi definition, and COCO-style
mask AP (pycocotools' matching and 101-point accumulation)."""
from __future__ import annotations

from collections import Counter, defaultdict

import numpy as np


class PanopticEvaluator:
    """Panoptic Quality: PQ = Σ IoU(TP) / (|TP| + |FP|/2 + |FN|/2), matched at
    IoU > 0.5 per category (the panopticapi definition used by
    COCOPanopticEvaluator)."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.iou_sum = np.zeros(num_classes)
        self.tp = np.zeros(num_classes, np.int64)
        self.fp = np.zeros(num_classes, np.int64)
        self.fn = np.zeros(num_classes, np.int64)

    def add(self, pred_seg: np.ndarray, pred_segments: list,
            gt_seg: np.ndarray, gt_segments: list):
        """pred/gt_seg: [H, W] segment-id maps (0 = VOID); segments: [{"id",
        "category_id", optional "iscrowd"}] lists.

        Full panopticapi pq_compute_single_core semantics: the void overlap
        is subtracted from each union; crowd GT segments never match and
        never count FN; an unmatched prediction whose area is >50% void (+
        same-class crowd) is ignored, not FP.  The (gt, pred) intersection
        histogram is the vectorized OFFSET trick — per-pixel python Counters
        were ~100 ms+/image at COCO resolutions."""
        VOID = 0
        pred_by_id = {s["id"]: s for s in pred_segments}
        gt_by_id = {s["id"]: s for s in gt_segments}
        gt_flat = gt_seg.reshape(-1).astype(np.int64)
        pred_flat = pred_seg.reshape(-1).astype(np.int64)
        OFFSET = int(pred_flat.max()) + 2 if pred_flat.size else 1
        pairs, counts = np.unique(gt_flat * OFFSET + pred_flat,
                                  return_counts=True)
        joint = {(int(p) // OFFSET, int(p) % OFFSET): int(c)
                 for p, c in zip(pairs, counts)}
        gids, gcounts = np.unique(gt_flat, return_counts=True)
        gt_area = dict(zip(gids.tolist(), gcounts.tolist()))
        pids, pcounts = np.unique(pred_flat, return_counts=True)
        pred_area = dict(zip(pids.tolist(), pcounts.tolist()))

        crowd_by_cat: dict = {}
        for gid, seg in gt_by_id.items():
            if seg.get("iscrowd", 0):
                crowd_by_cat[seg["category_id"]] = gid

        matched_gt, matched_pred = set(), set()
        for (gid, pid), inter in joint.items():
            if gid == VOID or pid == VOID:
                continue
            if gid not in gt_by_id or pid not in pred_by_id:
                continue
            if gt_by_id[gid].get("iscrowd", 0):
                continue
            if gt_by_id[gid]["category_id"] != pred_by_id[pid]["category_id"]:
                continue
            union = (gt_area[gid] + pred_area[pid] - inter
                     - joint.get((VOID, pid), 0))
            iou = inter / union if union > 0 else 0.0
            if iou > 0.5:
                c = gt_by_id[gid]["category_id"]
                self.tp[c] += 1
                self.iou_sum[c] += iou
                matched_gt.add(gid)
                matched_pred.add(pid)
        for gid, seg in gt_by_id.items():
            if (gid not in matched_gt and gt_area.get(gid, 0) > 0
                    and not seg.get("iscrowd", 0)):
                self.fn[seg["category_id"]] += 1
        for pid, seg in pred_by_id.items():
            if pid in matched_pred or pred_area.get(pid, 0) == 0:
                continue
            ignore = joint.get((VOID, pid), 0)
            crowd_gid = crowd_by_cat.get(seg["category_id"])
            if crowd_gid is not None:
                ignore += joint.get((crowd_gid, pid), 0)
            if ignore / pred_area[pid] > 0.5:
                continue
            self.fp[seg["category_id"]] += 1

    def results(self) -> dict:
        denom = self.tp + self.fp / 2 + self.fn / 2
        valid = denom > 0
        pq = np.zeros(self.num_classes)
        sq = np.zeros(self.num_classes)
        rq = np.zeros(self.num_classes)
        pq[valid] = self.iou_sum[valid] / denom[valid]
        sq[self.tp > 0] = self.iou_sum[self.tp > 0] / self.tp[self.tp > 0]
        rq[valid] = self.tp[valid] / denom[valid]
        return {"PQ": 100.0 * float(pq[valid].mean()) if valid.any() else 0.0,
                "SQ": 100.0 * float(sq[valid].mean()) if valid.any() else 0.0,
                "RQ": 100.0 * float(rq[valid].mean()) if valid.any() else 0.0,
                "n_categories": int(valid.sum())}


class InstanceSegEvaluator:
    """COCO-style mask AP (AP@[.5:.95], AP50, AP75) — the used subset of the
    reference's ``InstanceSegEvaluator`` (datasets/evaluation/
    instance_evaluation.py → detectron2 COCOEvaluator → pycocotools).

    Pure-numpy reimplementation of pycocotools' matching/accumulation:
    per image+class, detections sorted by score greedily match the unmatched
    GT with the highest IoU above the threshold; PR curves accumulate over
    score-sorted detections across images; AP is the 101-point interpolated
    mean precision; classes average only where GT exists.  Area ranges and
    maxDets variants are omitted (the reference reports the 'all'/100 cell).
    """

    def __init__(self, iou_thresholds=None):
        self.thrs = (np.arange(0.5, 0.955, 0.05) if iou_thresholds is None
                     else np.asarray(iou_thresholds, np.float64))
        # per class: list of (score, iou_row [n_gt]) per image, and gt counts
        self.dets = defaultdict(list)    # cls -> [(score, img_id, ious[n_gt])]
        self.n_gt = Counter()            # cls -> total gt instances
        self._img = 0

    @staticmethod
    def _mask_iou(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
        """pred [N, H, W] bool, gt [M, H, W] bool → IoU [N, M]."""
        p = pred.reshape(pred.shape[0], -1).astype(np.float32)
        g = gt.reshape(gt.shape[0], -1).astype(np.float32)
        inter = p @ g.T
        union = p.sum(1)[:, None] + g.sum(1)[None, :] - inter
        return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)

    def add(self, pred_masks, pred_classes, pred_scores, gt_masks, gt_classes):
        """One image.  pred_masks [N, H, W] bool, gt_masks [M, H, W] bool."""
        img_id = self._img
        self._img += 1
        pred_classes = np.asarray(pred_classes)
        gt_classes = np.asarray(gt_classes)
        for c in np.unique(gt_classes):
            self.n_gt[int(c)] += int((gt_classes == c).sum())
        if len(pred_classes) == 0:
            return
        pred_masks = np.asarray(pred_masks)
        gt_masks = (np.asarray(gt_masks)
                    if len(gt_classes) else np.zeros((0,) + pred_masks.shape[1:], bool))
        for c in np.unique(pred_classes):
            p_idx = np.where(pred_classes == c)[0]
            g_idx = np.where(gt_classes == c)[0]
            ious = (self._mask_iou(pred_masks[p_idx], gt_masks[g_idx])
                    if len(g_idx) else np.zeros((len(p_idx), 0)))
            for row, pi in enumerate(p_idx):
                self.dets[int(c)].append(
                    (float(pred_scores[pi]), img_id, ious[row]))

    def _ap_for_class(self, c: int) -> np.ndarray:
        """AP per IoU threshold for one class (101-point interpolation)."""
        dets = sorted(self.dets.get(c, []), key=lambda d: -d[0])
        n_gt = self.n_gt[c]
        T = len(self.thrs)
        aps = np.zeros(T)
        if n_gt == 0:
            return aps  # excluded from the mean by the caller
        for t, thr in enumerate(self.thrs):
            matched = defaultdict(set)  # img_id -> matched gt indices
            tp = np.zeros(len(dets))
            for i, (score, img_id, ious) in enumerate(dets):
                best, best_g = thr, -1
                for g in range(len(ious)):
                    if g in matched[img_id]:
                        continue
                    if ious[g] >= best:
                        best, best_g = ious[g], g
                if best_g >= 0:
                    matched[img_id].add(best_g)
                    tp[i] = 1.0
            cum_tp = np.cumsum(tp)
            recall = cum_tp / n_gt
            precision = cum_tp / np.arange(1, len(dets) + 1)
            # monotone-nonincreasing precision envelope
            for i in range(len(precision) - 1, 0, -1):
                precision[i - 1] = max(precision[i - 1], precision[i])
            rec_pts = np.linspace(0, 1, 101)
            idx = np.searchsorted(recall, rec_pts, side="left")
            aps[t] = float(np.mean(
                [precision[i] if i < len(precision) else 0.0 for i in idx]))
        return aps

    def results(self) -> dict:
        classes = sorted(set(self.n_gt) | set(self.dets))
        per_thr = [self._ap_for_class(c) for c in classes if self.n_gt[c] > 0]
        if not per_thr:
            return {"AP": 0.0, "AP50": 0.0, "AP75": 0.0}
        per_thr = np.stack(per_thr)             # [n_cls, n_thr]
        mean = per_thr.mean(axis=0)
        out = {"AP": 100.0 * float(mean.mean())}
        # AP50/AP75 only when that exact threshold is evaluated — a
        # nearest-threshold pick would silently mislabel the metric
        for name, t in (("AP50", 0.5), ("AP75", 0.75)):
            hit = np.where(np.isclose(self.thrs, t))[0]
            out[name] = 100.0 * float(mean[hit[0]]) if hit.size else float("nan")
        return out
