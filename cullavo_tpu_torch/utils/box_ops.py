"""Box coordinate transforms and IoU (counterpart of
``cullavo_tpu/utils/box_ops.py``): cxcywh <-> xyxy, pairwise IoU and
generalized IoU, and the boxes of binary masks, batched over the leading
axes."""
from __future__ import annotations

import torch


def box_cxcywh_to_xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(b):
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], dim=-1)


def box_area(b):
    return (b[..., 2] - b[..., 0]).clamp_min(0) * (b[..., 3] - b[..., 1]).clamp_min(0)


def pairwise_iou(a, b):
    """a [N, 4], b [M, 4] xyxy -> (iou [N, M], union [N, M])."""
    area_a = box_area(a)[:, None]
    area_b = box_area(b)[None, :]
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a + area_b - inter
    return inter / union.clamp_min(1e-8), union


def generalized_box_iou(a, b):
    """Pairwise gIoU [N, M] of xyxy boxes."""
    iou, union = pairwise_iou(a, b)
    lt = torch.minimum(a[:, None, :2], b[None, :, :2])
    rb = torch.maximum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    hull = (wh[..., 0] * wh[..., 1]).clamp_min(1e-8)
    return iou - (hull - union) / hull


def masks_to_boxes(masks):
    """[N, H, W] masks (> 0.5 is inside) -> [N, 4] xyxy f32, zeros for an
    empty mask."""
    N, H, W = masks.shape
    dev = masks.device
    ys = torch.arange(H, device=dev)[None, :, None]
    xs = torch.arange(W, device=dev)[None, None, :]
    m = masks > 0.5
    big = torch.tensor(10 ** 8, device=dev)
    neg = torch.tensor(-1, device=dev)
    x0 = torch.where(m, xs, big).amin(dim=(1, 2))
    y0 = torch.where(m, ys, big).amin(dim=(1, 2))
    x1 = torch.where(m, xs, neg).amax(dim=(1, 2)) + 1
    y1 = torch.where(m, ys, neg).amax(dim=(1, 2)) + 1
    boxes = torch.stack([x0, y0, x1, y1], dim=-1).float()
    empty = ~m.any(dim=2).any(dim=1)
    return torch.where(empty[:, None], torch.zeros_like(boxes), boxes)
