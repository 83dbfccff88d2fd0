"""Hungarian matcher of the set criterion (counterpart of
``cullavo_tpu/models/xdecoder/matcher.py``): the class, point-sampled
sigmoid-BCE and dice costs on the tensors' device, the assignment on the
host by scipy's ``linear_sum_assignment`` (the JAX package's CPU path,
``_lsa_host``).  ``hungarian_match.host_seconds`` adds up the wall time of
every assignment, the device-to-host copy of its cost included."""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from cullavo_tpu_torch.ops.point_sample import (drawn_rows, drawn_shape, point_sample_batch,
                                                uniform_points)


def batch_sigmoid_ce_cost(inputs, targets):
    """inputs [..., Q, P] logits, targets [..., N, P] -> [..., Q, N] mean-BCE cost."""
    P = inputs.shape[-1]
    pos = F.softplus(-inputs)
    neg = F.softplus(inputs)
    return (pos @ targets.transpose(-1, -2) + neg @ (1.0 - targets).transpose(-1, -2)) / P


def batch_dice_cost(inputs, targets):
    """inputs [..., Q, P] logits, targets [..., N, P] -> [..., Q, N] (1 - dice)."""
    probs = torch.sigmoid(inputs)
    numerator = 2.0 * (probs @ targets.transpose(-1, -2))
    denominator = probs.sum(-1)[..., :, None] + targets.sum(-1)[..., None, :]
    return 1.0 - (numerator + 1.0) / (denominator + 1.0)


def _lsa_host(cost: np.ndarray, n_valid: np.ndarray):
    """Per batch element, the assignment over the first ``n_valid`` target
    columns; (rows [B, N] int64: target j's query, valid [B, N])."""
    from scipy.optimize import linear_sum_assignment

    B, _, N = cost.shape
    rows = np.zeros((B, N), np.int64)
    valid = np.zeros((B, N), np.bool_)
    for b in range(B):
        n = int(n_valid[b])
        if n == 0:
            continue
        r, c = linear_sum_assignment(cost[b, :, :n])
        rows[b, :n] = r[np.argsort(c)]
        valid[b, :n] = True
    return rows, valid


def hungarian_match(cost, n_valid):
    """cost [B, Q, N] (N padded targets), n_valid [B] -> (src_idx [B, N]
    long: the query matched to target j, valid [B, N] bool), on cost's
    device.  Non-finite costs become +-1e8 first, as in JAX."""
    t0 = time.perf_counter()
    c = torch.nan_to_num(cost.detach().float(), nan=1e8, posinf=1e8, neginf=-1e8)
    nv = n_valid.detach().cpu().numpy() if torch.is_tensor(n_valid) else np.asarray(n_valid)
    rows, valid = _lsa_host(c.cpu().numpy(), nv)
    out = (torch.from_numpy(rows).to(cost.device), torch.from_numpy(valid).to(cost.device))
    hungarian_match.host_seconds += time.perf_counter() - t0
    return out


hungarian_match.host_seconds = 0.0


def compute_match_costs(pred_logits, pred_masks, tgt_classes, tgt_masks, tgt_valid,
                        generator: torch.Generator, num_points: int = 12544,
                        cost_class: float = 2.0, cost_mask: float = 5.0,
                        cost_dice: float = 5.0, coords=None, rows=None):
    """pred_logits [B, Q, C], pred_masks [B, Q, H, W], targets padded to N
    with ``tgt_valid`` [B, N] -> cost [B, Q, N] (no gradient), over uniform
    points drawn from ``generator`` (or ``coords`` [B, P, 2]; ``rows``:
    ``point_sample.drawn_shape``'s)."""
    B = pred_logits.shape[0]
    with torch.no_grad():
        probs = torch.softmax(pred_logits, dim=-1)
        safe = tgt_classes.long().clamp(0, pred_logits.shape[-1] - 1)
        cls_cost = -torch.gather(probs, 2, safe[:, None, :].expand(-1, probs.shape[1], -1))
        if coords is None:
            coords = drawn_rows(uniform_points(drawn_shape((B, num_points, 2), rows), generator,
                                               pred_masks.device), rows)
        pred_pts = point_sample_batch(pred_masks, coords)
        # the targets are sampled bilinearly, not binarized (the reference)
        tgt_pts = point_sample_batch(tgt_masks.float(), coords)
        cost = (cost_class * cls_cost + cost_mask * batch_sigmoid_ce_cost(pred_pts, tgt_pts)
                + cost_dice * batch_dice_cost(pred_pts, tgt_pts))
        return torch.where(tgt_valid.bool()[:, None, :], cost, torch.full_like(cost, 1e8))
