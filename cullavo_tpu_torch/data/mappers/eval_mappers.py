"""Eval-time mappers: registered dataset records -> pipeline eval rows
(counterpart of ``cullavo_tpu/data/mappers/eval_mappers.py``):

  * ``SemSegEvalMapper``   -> ``XDecoderPipeline`` semantic rows
  * ``PanopticEvalMapper`` -> rows with semantic, panoptic and instance
    ground truth (mIoU, PQ and mask AP)
  * ``RefCOCOEvalMapper``  -> ``RefCOCOPipeline`` grounding rows (polygon or
    RLE segments through ``datasets.polygons_to_mask`` / ``rle_to_mask``)
  * ``VQAEvalMapper``      -> ``VQAPipeline`` rows

A record's in-memory ``image`` (and ``sem_seg`` / ``pan_seg`` /
``gt_mask``) is taken first; only without one is the file read.  Images
are read by ``load_image_file``: by the file's magic bytes, a PNG through
the port's own reader (``png_io``), any other file through
``load_image_rgb`` (PIL, imported there only: the machine with the card has
none).  Label maps are read the same way by ``load_mask_png``, in the
file's own channels.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from cullavo_tpu_torch.data import png_io
from cullavo_tpu_torch.data.image_processing import CLIP_SIZE, preprocess_numpy
from cullavo_tpu_torch.models.xdecoder.model import PIXEL_MEAN, PIXEL_STD


def load_image_rgb(path, rgb: bool = True) -> np.ndarray:
    """An image file (a path or a binary file object) through PIL -> uint8
    [H, W, 3] (``rgb``), or its own channels.  Needs PIL, imported here only: where it is not installed this
    raises, and records carry decoded arrays instead."""
    from PIL import Image

    with Image.open(path) as im:
        return np.array(im.convert("RGB") if rgb else im)


def _is_png(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(len(png_io.SIGNATURE)) == png_io.SIGNATURE


def load_image_file(path: str) -> np.ndarray:
    """An image file -> uint8 RGB [H, W, 3]: a PNG through ``png_io``,
    anything else through ``load_image_rgb`` (PIL)."""
    return png_io.read_png(path) if _is_png(path) else load_image_rgb(path)


def load_mask_png(path: str) -> np.ndarray:
    """A label map -> its array in the file's own channels ([H, W] for a
    grey PNG): a PNG through ``png_io``, anything else through PIL."""
    return png_io.read_png_array(path) if _is_png(path) else load_image_rgb(path, rgb=False)


def normalize_np(img: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] -> the X-Decoder's normalized f32, on the host."""
    return ((img.astype(np.float32) - np.asarray(PIXEL_MEAN, np.float32))
            / np.asarray(PIXEL_STD, np.float32))


class SemSegEvalMapper:
    """{"file_name", "sem_seg_file_name"} -> {"image" (normalized),
    "sem_seg" int64, "image_id"}."""

    def __init__(self, load_image=load_image_file, load_mask=load_mask_png):
        self.load_image = load_image
        self.load_mask = load_mask

    def __call__(self, record: dict) -> dict:
        img = record.get("image")
        if img is None:
            img = self.load_image(record["file_name"])
        sem = record.get("sem_seg")
        if sem is None:
            sem = self.load_mask(record["sem_seg_file_name"])
        return {"image": normalize_np(np.asarray(img)),
                "sem_seg": np.asarray(sem).astype(np.int64),
                "image_id": record.get("image_id", record.get("file_name"))}


class PanopticEvalMapper:
    """A COCO-panoptic record -> an eval row with semantic, panoptic and
    instance ground truth: ``image`` (normalized), ``sem_seg`` [H, W]
    category ids (``ignore_label`` where no segment), ``pan_seg_gt`` [H, W]
    segment ids (0 void; the non-crowd segments renumbered from 1),
    ``segments_gt`` [{"id", "category_id", "isthing"}] and, when a thing
    is present, ``instances_gt`` {"masks" [M, H, W] bool, "classes" [M]}."""

    def __init__(self, ignore_label: int = 255, load_image=load_image_file):
        self.ignore = ignore_label
        self.load_image = load_image

    def __call__(self, record: dict) -> dict:
        img = record.get("image")
        if img is None:
            img = self.load_image(record["file_name"])
        pan = record.get("pan_seg")
        if pan is None:
            pan = self.load_image(record["pan_seg_file_name"])
        seg_ids = png_io.rgb2id(np.asarray(pan))
        H, W = seg_ids.shape
        sem = np.full((H, W), self.ignore, np.int64)
        pan_gt = np.zeros((H, W), np.int32)
        segments_gt, inst_masks, inst_classes = [], [], []
        for seg in record["segments_info"]:
            m = seg_ids == seg["id"]
            if not m.any() or seg.get("iscrowd", 0):
                continue
            cat = int(seg["category_id"])
            sem[m] = cat
            pan_gt[m] = len(segments_gt) + 1
            segments_gt.append({"id": len(segments_gt) + 1, "category_id": cat,
                                "isthing": bool(seg.get("isthing", True))})
            if seg.get("isthing", True):
                inst_masks.append(m)
                inst_classes.append(cat)
        row = {"image": normalize_np(np.asarray(img)), "sem_seg": sem, "pan_seg_gt": pan_gt,
               "segments_gt": segments_gt, "image_id": record.get("image_id")}
        if inst_masks:
            row["instances_gt"] = {"masks": np.stack(inst_masks),
                                   "classes": np.asarray(inst_classes, np.int64)}
        return row


class RefCOCOEvalMapper:
    """A ``load_refcoco`` record -> {"image" (normalized), "text", "gt_mask",
    "category", "image_id"}: the referred object's polygons or RLE as a
    mask."""

    def __init__(self, load_image=load_image_file):
        self.load_image = load_image

    def __call__(self, record: dict) -> dict:
        # datasets imports coco_panoptic, which imports this module
        from cullavo_tpu_torch.data.datasets import polygons_to_mask

        img = record.get("image")
        if img is None:
            img = self.load_image(record["file_name"])
        gt = record.get("gt_mask")
        if gt is None:
            gt = polygons_to_mask(record["segmentation"], record["height"], record["width"])
        return {"image": normalize_np(np.asarray(img)), "text": record["text"],
                "gt_mask": np.asarray(gt), "category": record.get("category_id"),
                "image_id": record.get("image_id")}


class VQAEvalMapper:
    """load_vqa record -> VQAPipeline row: CLIP-preprocessed pixel_values +
    question/answers passthrough.  A record's in-memory ``image`` array is
    taken first; only without one is ``file_name`` decoded."""

    def __init__(self, image_size: Optional[int] = None, load_image=load_image_rgb):
        self.image_size = image_size
        self.load_image = load_image

    def __call__(self, record: dict) -> dict:
        img = record.get("image")
        if img is None:
            img = self.load_image(record["file_name"])
        size = self.image_size or CLIP_SIZE
        pix = preprocess_numpy([np.asarray(img)], size=size)[0]
        return {"question_id": record["question_id"],
                "question": record["question"],
                "pixel_values": pix,
                "answers": record.get("answers"),
                "question_type": record.get("question_type"),
                "answer_type": record.get("answer_type")}
