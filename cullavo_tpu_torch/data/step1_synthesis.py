"""Step-1 object-understanding instruction synthesis (data-pipeline stage;
the port's own copy of ``cullavo_tpu/data/step1_synthesis.py``: numpy only).

Reproduces the training-data *content* of the reference's ``step1_process``
(cullavo/arch_cullavo.py:96-339): per COCO panoptic image, draw colored boxes
over "thing" instances and emit a randomized chain of Q/A turns
(image→classes+boxes, image→colors, class→color|box, and per sampled object
color↔box and box|color→class), with labels masked over prompt spans.

Divergences from the reference (deliberate, documented):
  * Runs in the input pipeline (host workers), NOT inside model.forward —
    the reference re-tokenizes and rasterizes on the accelerator hot path
    every step (SURVEY.md §3.1 flags this as a major perf hazard).
  * ``input_ids`` are built by concatenating per-turn token ids — the
    reference tokenizes the full concatenated string and separately
    concatenates per-turn label ids, which only aligns when sentencepiece
    splits identically at turn boundaries; building both streams from the
    same per-turn ids makes prompt/label alignment exact by construction.
  * Empty batches (no "thing" instances anywhere) yield a zero-weight
    sample instead of a skipped step, so SPMD ranks never diverge
    (the reference's divergence hazard: arch_cullavo.py:135,309 +
    CuLLaVOPipeline.py:88, see SURVEY.md §5).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from cullavo_tpu_torch.data.image_processing import preprocess_numpy
from cullavo_tpu_torch.data.text_format import (COLOR_LIST, box2string, classesboxes2string,
                                                classescolors2string, draw_boxes, list2string)
from cullavo_tpu_torch.models.llava.modeling import expand_image_token
from cullavo_tpu_torch.utils import constants

SYSTEM_PROMPT = ("A chat between a curious human and an artificial intelligence "
                 "assistant. The assistant gives helpful, detailed, and polite "
                 "answers to the human's questions. ")
IGNORE_INDEX = -100


def clean_class_name(name: str) -> str:
    return name.replace("-merged", "").replace("-other", "").replace("-stuff", "")


@dataclasses.dataclass
class PromptBuilder:
    """Accumulates multi-turn (prompt, answer) pairs into aligned id/label
    streams.  Mirrors make_system_prompt / make_and_add_prompt_and_label
    (arch_cullavo.py:28-61) with exact by-construction alignment."""

    tokenizer: object    # encode(text, add_special_tokens) -> ids
    ids: list = dataclasses.field(default_factory=list)
    labels: list = dataclasses.field(default_factory=list)

    def start(self):
        prefix = self.tokenizer.encode(SYSTEM_PROMPT + "<image>", add_special_tokens=True)
        self.ids = list(prefix)
        self.labels = [IGNORE_INDEX] * len(prefix)
        return self

    def add_turn(self, prompt: str, answer: str):
        prompt = " USER: " + prompt + " ASSISTANT:"
        p_ids = self.tokenizer.encode(prompt, add_special_tokens=False)
        full_ids = self.tokenizer.encode(prompt + " " + str(answer) + "</s>",
                                         add_special_tokens=False)
        labels = list(full_ids)
        labels[:len(p_ids)] = [IGNORE_INDEX] * len(p_ids)
        self.ids.extend(full_ids)
        self.labels.extend(labels)
        return self

    def finish(self):
        return np.asarray(self.ids, np.int32), np.asarray(self.labels, np.int32)


def synthesize_step1(
    record: dict,
    tokenizer,
    rng: np.random.Generator,
    fix_num: int = 5,
    class_names: Optional[Sequence[str]] = None,
) -> Optional[dict]:
    """One COCO panoptic record → (boxed image, ids, labels) or None.

    ``record``: {"image": uint8 [H, W, 3], "classes": int [N],
    "boxes": float [N, 4] absolute xyxy, "is_thing": bool [N]}.
    Returns None when the image has no thing instances (caller substitutes a
    zero-weight sample).
    """
    names = list(class_names) if class_names is not None else constants.COCO_PANOPTIC_CLASSES
    colors = list(COLOR_LIST)
    rng.shuffle(colors)

    is_thing = np.asarray(record["is_thing"], bool)
    thing_idx = np.nonzero(is_thing)[0][:len(colors)]
    if thing_idx.size == 0:
        return None

    image = np.asarray(record["image"])
    H, W = image.shape[:2]
    class_ids = np.asarray(record["classes"])[thing_idx]
    classes = [clean_class_name(names[c]) for c in class_ids]
    boxes_abs = np.asarray(record["boxes"], np.float32)[thing_idx]
    boxes = boxes_abs / np.asarray([W, H, W, H], np.float32)
    used_colors = colors[:len(thing_idx)]

    boxed = draw_boxes(image, boxes_abs, used_colors)

    b = PromptBuilder(tokenizer).start()

    # IMAGE -> CLASS, BOX
    prompt = ("provide multiple object names with their numbering index and "
              "the objects' bounding box coordinates in the image.")
    tail = ("There is an object in the image." if len(classes) == 1
            else f"There are {len(classes)} objects in the image.")
    b.add_turn(prompt, f"Sure, it is {classesboxes2string(classes, boxes)}. {tail}")

    # IMAGE -> COLOR
    prompt = "provide multiple bounding box colors in the image."
    tail = ("There is a bounding box in the image." if len(used_colors) == 1
            else f"There are {len(used_colors)} bounding boxes in the image.")
    b.add_turn(prompt, f"Sure, it is {list2string(used_colors)} color. {tail}")

    # CLASS -> COLOR | CLASS -> BOX
    uniq_ids, first_pos = np.unique(class_ids, return_index=True)
    pick = int(rng.integers(len(uniq_ids)))
    sel_id = uniq_ids[pick]
    sel_name = clean_class_name(names[sel_id])
    sel_mask = class_ids == sel_id
    sel_classes = [c for c, m in zip(classes, sel_mask) if m]
    sel_boxes = boxes[sel_mask]
    sel_colors = [c for c, m in zip(used_colors, sel_mask) if m]
    tail = ("There is a bounding box in the image." if len(sel_classes) == 1
            else f"There are {len(sel_classes)} bounding boxes in the image.")
    if int(rng.integers(2)) == 0:
        b.add_turn(f"provide multiple bounding box colors corresponding {sel_name} in the image.",
                   f"Sure, it is {classescolors2string(sel_classes, sel_colors)} color. {tail}")
    else:
        b.add_turn(f"provide multiple bounding box coordinates for {sel_name} in the image.",
                   f"Sure, it is {classesboxes2string(sel_classes, sel_boxes)} color. {tail}")

    # per sampled object: color<->box and box|color -> class
    order = rng.permutation(len(boxes))[:fix_num]
    for i in order:
        cls, box, color = classes[i], boxes[i], used_colors[i]
        if int(rng.integers(2)) == 0:
            b.add_turn(f"provide a bounding box coordinate of {color} bounding box color.",
                       f"Sure, it is {box2string(box)}. There is a {color} bounding box color")
        else:
            b.add_turn(f"provide a bounding box color of bounding box coordinate {box2string(box)}.",
                       f"Sure, it is {color} color.")
        if int(rng.integers(2)) == 0:
            b.add_turn(f"provide an object name for bounding box coordinate {box2string(box)}.",
                       f"Sure, it is {cls}.")
        else:
            b.add_turn(f"provide an object name for {color} bounding box.",
                       f"Sure, it is {cls}.")

    ids, labels = b.finish()
    return {"image": boxed, "input_ids": ids, "labels": labels}


def collate_step1(
    samples: Sequence[Optional[dict]],
    tokenizer,
    num_image_tokens: int,
    pad_to: Optional[int] = None,
    image_size: int = 336,
) -> dict:
    """Pad/expand a list of synthesized samples into fixed-shape arrays.

    Expands the single ``<image>`` slot to ``num_image_tokens`` positions,
    right-pads ids/labels/mask, stacks preprocessed pixels, and emits a
    per-sample ``weight`` (0.0 for empty substitutes) so the loss stays
    SPMD-uniform.  ``pad_to`` buckets sequence length for static shapes.
    """
    rows = []
    for s in samples:
        if s is None:
            ids = np.asarray(tokenizer.encode(SYSTEM_PROMPT + "<image>"), np.int32)
            labels = np.full_like(ids, IGNORE_INDEX)
            img = np.zeros((image_size, image_size, 3), np.uint8)
            rows.append((img, ids, labels, 0.0))
        else:
            rows.append((s["image"], s["input_ids"], s["labels"], 1.0))

    expanded = []
    for img, ids, labels, wt in rows:
        e_ids, e_mask, e_labels = expand_image_token(
            ids, None, labels, tokenizer.image_token_id, num_image_tokens, IGNORE_INDEX)
        expanded.append((img, e_ids, e_mask, e_labels, wt))

    max_len = max(len(e[1]) for e in expanded)
    if pad_to is not None:
        if max_len > pad_to:
            raise ValueError(f"sequence {max_len} exceeds pad_to={pad_to}")
        max_len = pad_to

    B = len(expanded)
    input_ids = np.full((B, max_len), tokenizer.pad_token_id, np.int32)
    attention_mask = np.zeros((B, max_len), np.int32)
    labels = np.full((B, max_len), IGNORE_INDEX, np.int32)
    weights = np.zeros((B,), np.float32)
    images = []
    for i, (img, e_ids, e_mask, e_labels, wt) in enumerate(expanded):
        n = len(e_ids)
        input_ids[i, :n] = e_ids
        attention_mask[i, :n] = e_mask
        labels[i, :n] = e_labels
        weights[i] = wt
        images.append(img)
    pixel_values = preprocess_numpy(images, image_size)
    return {"input_ids": input_ids, "attention_mask": attention_mask,
            "labels": labels, "pixel_values": pixel_values, "weights": weights}
