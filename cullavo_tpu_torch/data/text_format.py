"""Text formatting for CuLLaVO object-understanding instruction data (the
port's own copy of ``cullavo_tpu/data/text_format.py``: numpy only).

These functions define the *training data format* — the exact strings the
model is trained to emit — so their outputs must match the reference
formatters byte-for-byte (cullavo/utils/utils.py:69-127), while the
implementation here is fresh.

Also includes the inverse parser used by step2 data generation to pull
``[x1, x2, x3, x4]`` box lists and ``(... class)`` names back out of decoded
text (cullavo/utils/utils.py:46-64).
"""
from __future__ import annotations

import re
from typing import Iterable, Sequence

import numpy as np

# 20-color palette used to draw and name boxes (cullavo/utils/utils.py:14-33).
COLOR_LIST = [
    "white", "red", "orange", "coral", "yellow", "green", "blue", "navy",
    "gold", "pink", "purple", "brown", "violet", "olive", "lime", "cyan",
    "magenta", "silver", "gray", "black",
]

# RGB values for the palette (CSS/X11 colors), used by the box rasterizer.
COLOR_RGB = {
    "white": (255, 255, 255), "red": (255, 0, 0), "orange": (255, 165, 0),
    "coral": (255, 127, 80), "yellow": (255, 255, 0), "green": (0, 128, 0),
    "blue": (0, 0, 255), "navy": (0, 0, 128), "gold": (255, 215, 0),
    "pink": (255, 192, 203), "purple": (128, 0, 128), "brown": (165, 42, 42),
    "violet": (238, 130, 238), "olive": (128, 128, 0), "lime": (0, 255, 0),
    "cyan": (0, 255, 255), "magenta": (255, 0, 255), "silver": (192, 192, 192),
    "gray": (128, 128, 128), "black": (0, 0, 0),
}


_NUMBER = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")


def list2string(items: Iterable) -> str:
    return ", ".join(str(x) for x in items)


def box2string(box: Sequence[float]) -> str:
    return "[" + ", ".join(f"{round(float(x), 3):.3f}" for x in box) + "]"


def boxes2string(boxes: Iterable[Sequence[float]]) -> str:
    return "[" + ", ".join(box2string(b) for b in boxes) + "]"


def _numbered(classes: Sequence[str]):
    """Yield '#k class' tags where k counts repeats of the same class name."""
    seen: dict[str, int] = {}
    for c in classes:
        seen[c] = seen.get(c, 0) + 1
        yield seen[c], c


def classesboxes2string(classes: Sequence[str], boxes) -> str:
    return ", ".join(f"(#{k} {c}) {box2string(b)}"
                     for (k, c), b in zip(_numbered(classes), boxes))


def classescolors2string(classes: Sequence[str], colors: Sequence[str]) -> str:
    return ", ".join(f"(#{k} {c}) {col}"
                     for (k, c), col in zip(_numbered(classes), colors))


def classes2string(classes: Sequence[str]) -> str:
    return ", ".join(f"(#{k}) {c}" for k, c in _numbered(classes))


def parse_boxes_and_classes(text: str):
    """Extract ([N, 4] boxes, class names) from generated text.

    Returns (boxes, classes, error).  Error semantics match the reference
    parser: unbalanced or mismatched bracket counts → (None, None, True);
    a box without exactly 4 numbers is dropped together with its class.
    The numbers are matched and converted one by one; nothing of the
    model's output is evaluated.
    """
    sb = [i for i, ch in enumerate(text) if ch == "["]
    eb = [i for i, ch in enumerate(text) if ch == "]"]
    sc = [i for i, ch in enumerate(text) if ch == "("]
    ec = [i for i, ch in enumerate(text) if ch == ")"]
    if len(sb) != len(eb) or len(sc) != len(ec) or len(sc) != len(sb):
        return None, None, True
    boxes, classes = [], []
    for b0, b1, c0, c1 in zip(sb, eb, sc, ec):
        items = [t.strip() for t in text[b0 + 1:b1].split(",")] if text[b0 + 1:b1].strip() else []
        if b1 < b0 or not all(_NUMBER.fullmatch(t) for t in items):
            return None, None, True
        cls = text[c0 + 1:c1].split(" ")[-1]
        if len(items) == 4:
            boxes.append([float(t) for t in items])
            classes.append(cls)
    return np.asarray(boxes, np.float32).reshape(-1, 4), classes, False


def draw_boxes(image: np.ndarray, boxes_xyxy: np.ndarray, colors: Sequence[str],
               thickness: int = 2) -> np.ndarray:
    """Rasterize colored box outlines onto an RGB uint8 image.

    NumPy replacement for the detectron2 Visualizer overlay that the
    reference calls per training sample (cullavo/arch_cullavo.py:149-153).
    ``boxes_xyxy`` in absolute pixel coords.
    """
    out = np.ascontiguousarray(image).copy()
    H, W = out.shape[:2]
    for box, color in zip(np.asarray(boxes_xyxy), colors):
        rgb = np.asarray(COLOR_RGB[color], out.dtype)
        x0, y0, x1, y1 = [int(round(float(v))) for v in box]
        x0, x1 = sorted((max(0, min(x0, W - 1)), max(0, min(x1, W - 1))))
        y0, y1 = sorted((max(0, min(y0, H - 1)), max(0, min(y1, H - 1))))
        t = thickness
        out[y0:y0 + t, x0:x1 + 1] = rgb
        out[max(0, y1 - t + 1):y1 + 1, x0:x1 + 1] = rgb
        out[y0:y1 + 1, x0:x0 + t] = rgb
        out[y0:y1 + 1, max(0, x1 - t + 1):x1 + 1] = rgb
    return out
