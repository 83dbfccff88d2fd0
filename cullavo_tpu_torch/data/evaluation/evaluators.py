"""Evaluators (the port's own copy of ``PanopticEvaluator``,
``InstanceSegEvaluator``, ``RetrievalEvaluator``, ``ClassificationEvaluator``
and ``CaptioningEvaluator`` from ``cullavo_tpu/data/evaluation/evaluators.py``,
numpy only): panoptic quality by the panopticapi definition, COCO-style
mask AP (pycocotools' matching and 101-point accumulation), karpathy
image <-> text recall@k (with the 0.5 / 0.5 backbone ensemble; numpy's
``argsort`` breaks ties), top-1 / top-5, and the caption metrics (CIDEr-D,
corpus BLEU-1..4, ROUGE-L, ``METEOR_approx`` over exact and Lancaster-stem
matches; ``SPICE`` None)."""
from __future__ import annotations

import json
import math
from collections import Counter, defaultdict

import numpy as np

from cullavo_tpu_torch.data.coco_caption_grounding import stem


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


class RetrievalEvaluator:
    """Image↔text retrieval recall@k (datasets/evaluation/retrieval_evaluation.py).

    Karpathy protocol: each image contributes ALL its captions (typically 5)
    to the text pool, grouped by ``image_id`` — text→image recall (ir@k)
    counts a hit when any top-k image carries the caption's image_id;
    image→text (tr@k) when any top-k caption belongs to the image.  The
    two-arg ``add(image_emb, text_emb)`` form (1:1 pairs) remains for
    pairwise tables."""

    def __init__(self, ks=(1, 5, 10)):
        self.ks = ks
        self.image_embs: list = []
        self.image_embs2: list = []       # backbone-ensemble embeddings
        self.image_ids: list = []
        self.text_embs: list = []
        self.text_img_ids: list = []

    def add(self, image_emb: np.ndarray, text_embs: np.ndarray, image_id=None,
            image_emb2: np.ndarray = None):
        """``image_emb2``: optional second (backbone) embedding — the
        reference's retrieval_emsemble averages its normalized score matrix
        0.5/0.5 with the class-token one (retrieval_evaluation.py:160-166)."""
        if image_id is None:
            image_id = len(self.image_embs)
        self.image_embs.append(np.asarray(image_emb))
        if image_emb2 is not None:
            self.image_embs2.append(np.asarray(image_emb2))
        self.image_ids.append(image_id)
        for t in np.atleast_2d(np.asarray(text_embs)):
            self.text_embs.append(t)
            self.text_img_ids.append(image_id)

    def results(self) -> dict:
        img = np.stack(self.image_embs)
        txt = np.stack(self.text_embs)
        img = img / (np.linalg.norm(img, axis=-1, keepdims=True) + 1e-7)
        txt = txt / (np.linalg.norm(txt, axis=-1, keepdims=True) + 1e-7)
        sim = img @ txt.T                                   # [N_img, N_txt]
        if self.image_embs2:
            assert len(self.image_embs2) == len(self.image_embs), \
                "image_emb2 must be given for every image or none"
            img2 = np.stack(self.image_embs2)
            img2 = img2 / (np.linalg.norm(img2, axis=-1, keepdims=True) + 1e-7)
            sim = 0.5 * sim + 0.5 * (img2 @ txt.T)
        img_ids = np.asarray(self.image_ids)
        txt_ids = np.asarray(self.text_img_ids)
        kmax = max(self.ks)
        top_txt = (-sim).argsort(axis=1)[:, :kmax]          # per image
        top_img = (-sim.T).argsort(axis=1)[:, :kmax]        # per text
        out = {}
        for k in self.ks:
            ir = np.mean([img_ids[top_img[j, :k]].tolist().count(txt_ids[j]) > 0
                          for j in range(txt.shape[0])])
            tr = np.mean([txt_ids[top_txt[i, :k]].tolist().count(img_ids[i]) > 0
                          for i in range(img.shape[0])])
            out[f"ir@{k}"] = 100.0 * float(ir)
            out[f"tr@{k}"] = 100.0 * float(tr)
        return out


class ClassificationEvaluator:
    """Top-1/top-5 (datasets/evaluation/classification_evaluation.py)."""

    def __init__(self):
        self.top1 = 0
        self.top5 = 0
        self.total = 0

    def add(self, logits: np.ndarray, label: int):
        order = np.argsort(-np.asarray(logits))
        self.total += 1
        if order[0] == label:
            self.top1 += 1
        if label in order[:5]:
            self.top5 += 1

    def results(self) -> dict:
        n = max(self.total, 1)
        return {"top1": 100.0 * self.top1 / n, "top5": 100.0 * self.top5 / n, "n": self.total}


def _cider_ngrams(tokens: list, n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


class CaptioningEvaluator:
    """Caption metrics: native CIDEr-D-style score (TF-IDF weighted n-gram
    cosine, n=1..4) + results-JSON writer in the format the reference's
    evaluator emits before shelling out to the Java tool."""

    def __init__(self):
        self.records: list = []   # (image_id, candidate, [references])

    def add(self, image_id, candidate: str, references: list):
        # keep the RAW candidate beside the scoring tokens: dump_results
        # must emit what the model produced, not a lowercased re-join
        self.records.append((image_id, candidate.lower().split(),
                             [r.lower().split() for r in references],
                             candidate))

    def _cider(self) -> float:
        if not self.records:
            return 0.0
        N = 4
        # document frequency over reference sets
        df = [defaultdict(float) for _ in range(N)]
        for _, _, refs, _ in self.records:
            for n in range(N):
                seen = set()
                for ref in refs:
                    seen |= set(_cider_ngrams(ref, n + 1).keys())
                for g in seen:
                    df[n][g] += 1.0
        n_docs = len(self.records)
        scores = []
        for _, cand, refs, _ in self.records:
            score_n = []
            for n in range(N):
                c_counts = _cider_ngrams(cand, n + 1)
                c_vec = {g: c * math.log(max(n_docs / max(df[n].get(g, 0.0), 1.0), 1.0))
                         for g, c in c_counts.items()}
                c_norm = math.sqrt(sum(v * v for v in c_vec.values())) or 1.0
                ref_scores = []
                for ref in refs:
                    r_counts = _cider_ngrams(ref, n + 1)
                    r_vec = {g: c * math.log(max(n_docs / max(df[n].get(g, 0.0), 1.0), 1.0))
                             for g, c in r_counts.items()}
                    r_norm = math.sqrt(sum(v * v for v in r_vec.values())) or 1.0
                    dot = sum(min(c_vec.get(g, 0.0), v) * v for g, v in r_vec.items())
                    # length penalty (CIDEr-D)
                    delta = len(cand) - len(ref)
                    penalty = math.exp(-(delta ** 2) / (2 * 6.0 ** 2))
                    ref_scores.append(penalty * dot / (c_norm * r_norm))
                score_n.append(10.0 * sum(ref_scores) / max(len(ref_scores), 1))
            scores.append(sum(score_n) / N)
        return float(np.mean(scores))

    def _bleu4(self) -> dict:
        """Corpus BLEU-1..4 with brevity penalty and per-reference clipping
        (the coco-caption Bleu scorer's corpus formulation)."""
        if not self.records:
            return {f"Bleu_{n}": 0.0 for n in range(1, 5)}
        match = [0.0] * 4
        total = [0.0] * 4
        cand_len = 0
        ref_len = 0
        for _, cand, refs, _ in self.records:
            if not refs:      # a record with no annotations can't score BLEU
                continue
            cand_len += len(cand)
            # closest reference length (ties → shorter), per BLEU spec
            ref_len += min((abs(len(r) - len(cand)), len(r)) for r in refs)[1]
            for n in range(4):
                c_counts = _cider_ngrams(cand, n + 1)
                max_ref = Counter()
                for ref in refs:
                    for g, c in _cider_ngrams(ref, n + 1).items():
                        max_ref[g] = max(max_ref[g], c)
                match[n] += sum(min(c, max_ref.get(g, 0)) for g, c in c_counts.items())
                total[n] += max(sum(c_counts.values()), 0)
        bp = 1.0 if cand_len > ref_len else math.exp(1.0 - ref_len / max(cand_len, 1))
        out = {}
        logp = 0.0
        for n in range(4):
            p = match[n] / total[n] if total[n] else 0.0
            logp += math.log(max(p, 1e-12))
            out[f"Bleu_{n + 1}"] = bp * math.exp(logp / (n + 1))
        return out

    @staticmethod
    def _lcs(a: list, b: list) -> int:
        if not a or not b:
            return 0
        dp = [0] * (len(b) + 1)
        for x in a:
            prev = 0
            for j, y in enumerate(b, 1):
                cur = dp[j]
                dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
                prev = cur
        return dp[len(b)]

    def _rouge_l(self) -> float:
        """ROUGE-L F-measure, beta=1.2, max over references (coco-caption
        Rouge scorer)."""
        if not self.records:
            return 0.0
        beta = 1.2
        scores = []
        for _, cand, refs, _ in self.records:
            best = 0.0
            for ref in refs:
                lcs = self._lcs(cand, ref)
                p = lcs / max(len(cand), 1)
                r = lcs / max(len(ref), 1)
                if p > 0 and r > 0:
                    f = (1 + beta ** 2) * p * r / (r + beta ** 2 * p)
                    best = max(best, f)
            scores.append(best)
        return float(np.mean(scores))

    def _meteor(self) -> float:
        """METEOR (exact + stem matching): F_mean with alpha=0.9, fragmentation
        penalty gamma=0.5, beta=3 — the standard parameters of the coco
        evaluation.  The reference shells out to the METEOR-1.5 Java jar
        (captioning_evaluation.py:18-19), whose synonym/paraphrase modules
        need WordNet data; this native scorer implements the exact+stem
        stages (the dominant contributors), documented deviation."""
        if not self.records:
            return 0.0
        def match_spans(cand, ref):
            """Greedy left-to-right alignment on exact-or-stem equality;
            returns (#matches, #chunks)."""
            used = [False] * len(ref)
            pos = []
            for i, w in enumerate(cand):
                sw = stem(w)
                for j, r in enumerate(ref):
                    if not used[j] and (w == r or sw == stem(r)):
                        used[j] = True
                        pos.append(j)
                        break
            if not pos:
                return 0, 0
            chunks = 1
            for a, b in zip(pos, pos[1:]):
                if b != a + 1:
                    chunks += 1
            return len(pos), chunks

        alpha, beta, gamma = 0.9, 3.0, 0.5
        scores = []
        for _, cand, refs, _ in self.records:
            best = 0.0
            for ref in refs:
                m, chunks = match_spans(cand, ref)
                if m == 0:
                    continue
                p = m / len(cand)
                r = m / len(ref)
                f = p * r / (alpha * p + (1 - alpha) * r)
                frag = chunks / m
                best = max(best, f * (1.0 - gamma * frag ** beta))
            scores.append(best)
        return float(np.mean(scores))

    def results(self) -> dict:
        """The reference's 4-metric report (BLEU/METEOR/ROUGE/CIDEr via
        pycocoevalcap, captioning_evaluation.py:18-19) computed natively.
        SPICE (scene-graph parse) requires the Java parser and is omitted."""
        out = {"CIDEr": round(self._cider(), 4), "n": len(self.records)}
        out.update({k: round(v, 4) for k, v in self._bleu4().items()})
        out["ROUGE_L"] = round(self._rouge_l(), 4)
        # labeled as approximate so reports cannot be mistaken for
        # pycocoevalcap output: the native scorer covers the exact+stem
        # stages only (no WordNet synonym/paraphrase modules), and SPICE's
        # Java scene-graph parser is unavailable — emitted as null
        out["METEOR_approx"] = round(self._meteor(), 4)
        out["meteor_variant"] = "exact+stem"
        out["SPICE"] = None
        return out

    def dump_results(self, path: str):
        rows = [{"image_id": iid, "caption": raw}
                for iid, _, _, raw in self.records]
        with open(path, "w") as f:
            json.dump(rows, f)
