"""Dataset registrations (counterpart of ``cullavo_tpu/data/datasets.py``):

  * VQAv2: a questions JSON and an optional annotations JSON keyed by
    ``question_id`` (the reference's register_vqa_datasets.py);
  * RefCOCO: refs (umd) JSON + COCO instances JSON, one row per sentence
    of each reference of the split (``load_refcoco``);
  * image / annotation directory pairs (``load_semseg_pairs``) and COCO
    instances JSON (``load_coco_instance_json``);
  * ``register_all_segmentation(root)``, the reference's table of
    segmentation datasets under a ``DETECTRON2_DATASETS`` root, family by
    family (``SEGMENTATION_FAMILIES``): a family whose directory is absent
    is skipped with one line on stderr, one that is present but lacks a
    file it needs raises ``FileNotFoundError``, and one whose names are
    all registered already (a second call in one process) is left as it
    is.  The VLP Arrow splits register from ``<root>/vlp`` when it exists
    (``vlp_datasets.register_all_vlp``).
  * the COCO segment decoders ``polygons_to_mask`` (even-odd scanline fill)
    and ``rle_to_mask`` (uncompressed, column-major RLE), numpy only.

ImageNet's folder scan comes with the ImageNet eval."""
from __future__ import annotations

import json
import os
import sys
from typing import Optional

import numpy as np

from cullavo_tpu_torch.data.coco_panoptic import load_coco_panoptic_json
from cullavo_tpu_torch.data.registry import list_datasets, register_dataset
from cullavo_tpu_torch.data.vlp_datasets import register_all_vlp


def load_vqa(questions_json: str, annotations_json: Optional[str],
             image_dir: str, image_template: str = "COCO_val2014_{:012d}.jpg") -> list:
    with open(questions_json) as f:
        questions = json.load(f)["questions"]
    ann_by_qid = {}
    if annotations_json and os.path.exists(annotations_json):
        with open(annotations_json) as f:
            for ann in json.load(f)["annotations"]:
                ann_by_qid[ann["question_id"]] = ann
    rows = []
    for q in questions:
        ann = ann_by_qid.get(q["question_id"])
        rows.append({
            "question_id": q["question_id"],
            "question": q["question"],
            "image_id": q["image_id"],
            "file_name": os.path.join(image_dir, image_template.format(q["image_id"])),
            "answers": [a["answer"] for a in ann["answers"]] if ann else None,
            "question_type": ann.get("question_type") if ann else None,
            "answer_type": ann.get("answer_type") if ann else None,
        })
    return rows


def register_vqa(name: str, questions_json: str, annotations_json: Optional[str],
                 image_dir: str, **kw):
    register_dataset(name, lambda: load_vqa(questions_json, annotations_json,
                                            image_dir, **kw),
                     {"gt_json": annotations_json})


def polygons_to_mask(segmentation, height: int, width: int) -> np.ndarray:
    """COCO polygon(s) (or an RLE dict) -> uint8 [height, width] mask: the
    even-odd rule sampled at pixel centres, one scanline at a time."""
    if isinstance(segmentation, dict):
        return rle_to_mask(segmentation)
    mask = np.zeros((height, width), np.uint8)
    for poly in segmentation:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        x0, y0 = pts[:, 0], pts[:, 1]
        x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
        for yi, y in enumerate(np.arange(height) + 0.5):
            cross = ((y0 <= y) & (y1 > y)) | ((y1 <= y) & (y0 > y))
            if not cross.any():
                continue
            xs = np.sort(x0[cross] + (y - y0[cross]) / (y1[cross] - y0[cross])
                         * (x1[cross] - x0[cross]))
            for a, b in zip(xs[0::2], xs[1::2]):
                lo = max(int(np.ceil(a - 0.5)), 0)
                hi = min(int(np.ceil(b - 0.5)), width)
                if hi > lo:
                    mask[yi, lo:hi] = 1
    return mask


def rle_to_mask(rle: dict) -> np.ndarray:
    """Uncompressed COCO RLE ``{"counts": [...], "size": [h, w]}`` -> uint8
    [h, w] mask (runs alternate 0 and 1, column-major); a compressed counts
    string raises."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        raise ValueError("compressed RLE strings not supported; decode upstream")
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape(w, h).T


# ---------------------------------------------------------------------------
# RefCOCO (umd refs)
# ---------------------------------------------------------------------------

def load_refcoco(refs_json: str, instances_json: str, image_dir: str,
                 split: str = "val") -> list:
    """refs_json: a list of {"ann_id", "image_id", "split", "category_id",
    "sentences": [{"sent"}]}; instances_json: COCO instances with polygon
    or RLE segmentations by annotation id.  One row per sentence of each
    reference of ``split`` whose annotation and image exist."""
    with open(refs_json) as f:
        refs = json.load(f)
    with open(instances_json) as f:
        inst = json.load(f)
    anns = {a["id"]: a for a in inst["annotations"]}
    imgs = {i["id"]: i for i in inst["images"]}
    rows = []
    for ref in refs:
        if ref.get("split") != split:
            continue
        ann, img = anns.get(ref["ann_id"]), imgs.get(ref["image_id"])
        if ann is None or img is None:
            continue
        for sent in ref["sentences"]:
            rows.append({"image_id": ref["image_id"],
                         "file_name": os.path.join(image_dir, img["file_name"]),
                         "height": img["height"], "width": img["width"],
                         "text": sent["sent"], "category_id": ref.get("category_id"),
                         "segmentation": ann.get("segmentation"), "bbox": ann.get("bbox")})
    return rows


def register_refcoco(name: str, refs_json: str, instances_json: str, image_dir: str,
                     split: str = "val"):
    register_dataset(name, lambda: load_refcoco(refs_json, instances_json, image_dir, split), {})


# ---------------------------------------------------------------------------
# segmentation datasets
# ---------------------------------------------------------------------------

def load_semseg_pairs(image_dir: str, ann_dir: str, image_ext: str = ".jpg",
                      ann_ext: str = ".png") -> list:
    """Each image of ``image_dir`` with ``image_ext`` whose annotation
    ``<stem><ann_ext>`` exists in ``ann_dir`` (detectron2's load_sem_seg)."""
    rows = []
    for fn in sorted(os.listdir(image_dir)):
        if not fn.endswith(image_ext):
            continue
        ann = os.path.join(ann_dir, fn[:-len(image_ext)] + ann_ext)
        if os.path.exists(ann):
            rows.append({"file_name": os.path.join(image_dir, fn), "sem_seg_file_name": ann})
    return rows


def load_scannet_semseg(dirname: str, split: str, label_folder: str) -> list:
    """ScanNet frames: ``meta/{split}.txt`` lists color-image paths relative
    to ``images/``; each label lies beside its image with "color" ->
    ``label_folder`` and .jpg -> .png in the relative path."""
    with open(os.path.join(dirname, "meta", split + ".txt")) as f:
        fileids = [ln.split()[0] for ln in f if ln.strip()]
    rows = []
    for rel in fileids:
        sem_rel = rel.replace("color", label_folder).replace(".jpg", ".png")
        rows.append({"file_name": os.path.join(dirname, "images", rel),
                     "sem_seg_file_name": os.path.join(dirname, "images", sem_rel),
                     "image_id": rel.replace("/", "_").rsplit(".", 1)[0]})
    return rows


def load_coco_instance_json(json_file: str, image_dir: str) -> list:
    """A COCO instances JSON -> one row per image with its annotations,
    category ids remapped to contiguous 0-based indices (sorted by id)."""
    with open(json_file) as f:
        data = json.load(f)
    remap = {cid: i for i, cid in enumerate(sorted(c["id"] for c in data.get("categories", [])))}
    anns_by_img: dict = {}
    for a in data["annotations"]:
        anns_by_img.setdefault(a["image_id"], []).append(a)
    return [{"file_name": os.path.join(image_dir, img["file_name"]), "image_id": img["id"],
             "height": img["height"], "width": img["width"],
             "annotations": [{"bbox": a["bbox"],
                              "category_id": remap.get(a["category_id"], a["category_id"]),
                              "segmentation": a.get("segmentation"),
                              "iscrowd": a.get("iscrowd", 0)}
                             for a in anns_by_img.get(img["id"], [])]}
            for img in data["images"]]


def load_pascalvoc_interactive(dirname: str, split: str, slice_size: int = 5) -> list:
    """PascalVOC interactive-segmentation rows: the image, its instance and
    class PNGs, ``slice_size`` objects at most."""
    with open(os.path.join(dirname, "ImageSets", "Segmentation", split + ".txt")) as f:
        fileids = [ln.strip() for ln in f if ln.strip()]
    return [{"file_name": os.path.join(dirname, "JPEGImages", fid + ".jpg"),
             "inst_name": os.path.join(dirname, "SegmentationObject", fid + ".png"),
             "semseg_name": os.path.join(dirname, "SegmentationClass", fid + ".png"),
             "slice_size": slice_size} for fid in fileids]


_SEM = {"evaluator_type": "sem_seg"}
_SCANNET_LABELS = {"scannet_41_val_seg": ("label41", "SCAN_40"),
                   "scannet_38_val_seg": ("label38", "SCAN_37"),
                   "scannet_21_val_seg": ("label21", "SCAN_20")}


def _pairs(image_dir, ann_dir, image_ext=".jpg", ann_ext=".png"):
    return lambda: load_semseg_pairs(image_dir, ann_dir, image_ext, ann_ext)


def _panoptic(json_file, image_dir, pan_dir):
    return lambda: load_coco_panoptic_json(json_file, image_dir, pan_dir, {})


def _scannet_sem(base):
    return {name: ((lambda folder=folder: load_scannet_semseg(base, "val", folder)),
                   {"class_names_key": key, "ignore_label": 0, **_SEM})
            for name, (folder, key) in _SCANNET_LABELS.items()}


def _coco_stuff(base):
    return {f"coco_2017_{split}_stuff_10k_sem_seg": (
        _pairs(os.path.join(base, "images_detectron2", split),
               os.path.join(base, "annotations_detectron2", split)),
        {"ignore_label": 255, **_SEM}) for split in ("train", "test")}


def segmentation_families(root: str) -> list:
    """The reference's segmentation table under ``root``: per family its
    directory, the files it needs there, and ``{dataset name: (loader,
    metadata)}``."""
    scannet = os.path.join(root, "scannet_frames_25k")
    sun = os.path.join(root, "sun_rgbd")
    bdd = os.path.join(root, "bdd100k")
    ade = os.path.join(root, "ADEChallengeData2016")
    ade_full = os.path.join(root, "ADE20K_2021_17_01")
    stuff = os.path.join(root, "coco", "coco_stuff_10k")
    voc = os.path.join(root, "PascalVOC")
    j = os.path.join
    return [
        ("scannet_semseg", scannet, [j(scannet, "meta", "val.txt")], _scannet_sem(scannet)),
        ("scannet_panoptic", scannet, [j(scannet, "scannet_panoptic.json")],
         {"scannet_21_panoptic_val": (
             _panoptic(j(scannet, "scannet_panoptic.json"), j(scannet, "images"),
                       j(scannet, "scannet_panoptic")),
             {"class_names_key": "SCAN_20", "evaluator_type": "scannet_panoptic"})}),
        ("sunrgbd_semseg", sun, [j(sun, "image", "val"), j(sun, "label37", "val")],
         {"sunrgbd_37_val_seg": (_pairs(j(sun, "image", "val"), j(sun, "label37", "val")),
                                 {"class_names_key": "SUN_RGBD_37", "ignore_label": 0, **_SEM})}),
        ("bdd_semseg", bdd, [j(bdd, "images/10k/val"), j(bdd, "labels/sem_seg/masks/val")],
         {"bdd10k_val_sem_seg": (_pairs(j(bdd, "images/10k/val"),
                                        j(bdd, "labels/sem_seg/masks/val")),
                                 {"class_names_key": "BDD_SEM", "ignore_label": 255, **_SEM})}),
        ("bdd_panoptic", bdd, [j(bdd, "labels/pan_seg/meta_pan.json")],
         {"bdd10k_40_panoptic_val": (
             _panoptic(j(bdd, "labels/pan_seg/meta_pan.json"), j(bdd, "images/10k/val"),
                       j(bdd, "labels/pan_seg/bitmasks/val")),
             {"class_names_key": "BDD_PANO", "evaluator_type": "bdd_panoptic_pano"})}),
        ("ade20k_panoptic", ade, [j(ade, "ade20k_panoptic_val.json")],
         {"ade20k_panoptic_val": (
             _panoptic(j(ade, "ade20k_panoptic_val.json"), j(ade, "images/validation"),
                       j(ade, "ade20k_panoptic_val")),
             {"class_names_key": "ADE_PANOPTIC_CLASSES",
              "evaluator_type": "ade20k_panoptic_seg"})}),
        ("ade20k_instance", ade, [j(ade, "ade20k_instance_val.json")],
         {"ade20k_instance_val": (
             (lambda: load_coco_instance_json(j(ade, "ade20k_instance_val.json"),
                                              j(ade, "images/validation"))),
             {"class_names_key": "ADE_PANOPTIC_CLASSES", "evaluator_type": "coco"})}),
        ("ade20k_full", ade_full, [j(ade_full, "images_detectron2/val"),
                                   j(ade_full, "annotations_detectron2/val")],
         {"ade20k_full_sem_seg_val": (
             _pairs(j(ade_full, "images_detectron2/val"), j(ade_full, "annotations_detectron2/val"),
                    ".jpg", ".tif"),
             {"class_names_key": "ADE20K_847", "ignore_label": 65535, **_SEM})}),
        ("coco_stuff_10k", stuff, [j(stuff, "images_detectron2"),
                                   j(stuff, "annotations_detectron2")], _coco_stuff(stuff)),
        ("pascalvoc_interactive", voc, [j(voc, "ImageSets", "Segmentation", "val.txt")],
         {"pascalvoc_val_Point": ((lambda: load_pascalvoc_interactive(voc, "val")),
                                  {"class_names_key": "PASCAL_CLASSES",
                                   "evaluator_type": "interactive"})}),
    ]


def register_all_segmentation(root: str) -> list:
    """Register every family of ``segmentation_families(root)`` whose
    directory exists (see the module docstring); returns the names
    registered by this call."""
    done, have = [], set(list_datasets())
    for family, directory, needs, datasets in segmentation_families(root):
        if all(name in have for name in datasets):
            continue
        if not os.path.isdir(directory):
            print(f"[datasets] {family}: no {directory}, not registered", file=sys.stderr)
            continue
        absent = [p for p in needs if not os.path.exists(p)]
        if absent:
            raise FileNotFoundError(f"{family} under {root}: {directory} exists but lacks "
                                    f"{absent}")
        for name, (loader, md) in datasets.items():
            register_dataset(name, loader, md)
            done.append(name)
    if os.path.isdir(os.path.join(root, "vlp")):
        done += register_all_vlp(os.path.join(root, "vlp"))
    return done
