"""Point sampling for the mask losses, PointRend style (counterpart of
``cullavo_tpu/ops/point_sample.py``).

``point_sample_batch(features [N, C, H, W], coords [N, P, 2])`` samples
bilinearly at normalized (x, y) in [0, 1] with grid_sample's conventions
(``align_corners=False``: x = c * W - 0.5; zero padding outside the map)
and returns [N, C, P] in f32.  It gathers the four corners and blends them
with the arithmetic of JAX's gather form, so the two packages agree to a
few ulps at every coordinate, the edges included.

``uncertain_point_coords`` importance-samples: uniform oversampling, the
most uncertain fraction (``-|logit|`` largest) kept, the rest uniform.
Every uniform draw goes through ``uniform_points`` with an explicit
``torch.Generator``; a caller that wants other draws passes ``coords`` to
the losses or replaces ``uniform_points``.
"""
from __future__ import annotations

import torch


def uniform_points(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Uniform f32 draws in [0, 1) of ``shape`` from ``generator`` (which
    lives on ``device``'s type)."""
    return torch.rand(shape, generator=generator, device=device, dtype=torch.float32)


def drawn_shape(shape, rows=None) -> tuple:
    """The shape to draw for ``shape``'s rows: ``rows`` (start, stop, total)
    names a rank's rows start:stop of a global batch's ``total`` (the draws
    are the global batch's, as in one process), None the whole shape."""
    return tuple(shape) if rows is None else (rows[2],) + tuple(shape[1:])


def drawn_rows(draws, rows=None):
    """This rank's rows of ``drawn_shape``'s draws."""
    return draws if rows is None else draws[rows[0]:rows[1]]


def point_sample_batch(features, coords, align_corners: bool = False):
    """[N, C, H, W], [N, P, 2] -> [N, C, P] f32."""
    N, C, H, W = features.shape
    P = coords.shape[1]
    c = coords.float()
    if align_corners:
        x, y = c[..., 0] * (W - 1), c[..., 1] * (H - 1)
    else:
        x, y = c[..., 0] * W - 0.5, c[..., 1] * H - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[:, None], (y - y0)[:, None]
    flat = features.float().reshape(N, C, H * W)

    def corner(yy, xx):
        yc = yy.clamp(0, H - 1).long()
        xc = xx.clamp(0, W - 1).long()
        got = torch.gather(flat, 2, (yc * W + xc)[:, None, :].expand(N, C, P))
        valid = (yy >= 0) & (yy <= H - 1) & (xx >= 0) & (xx <= W - 1)
        return got * valid[:, None].to(got.dtype)

    top = corner(y0, x0) * (1 - wx) + corner(y0, x0 + 1) * wx
    bot = corner(y0 + 1, x0) * (1 - wx) + corner(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def point_sample(features, coords, align_corners: bool = False):
    """[C, H, W], [P, 2] -> [C, P] f32."""
    return point_sample_batch(features[None], coords[None], align_corners)[0]


def calculate_uncertainty(logits):
    """-|logit|: largest where the mask prediction is least certain."""
    return -torch.abs(logits)


def uncertain_point_coords(mask_logits, generator: torch.Generator, num_points: int,
                           oversample_ratio: float = 3.0,
                           importance_sample_ratio: float = 0.75, rows=None):
    """mask_logits [N, 1, H, W] -> [N, num_points, 2] coords (no gradient);
    ``rows``: ``drawn_shape``'s, for both draws."""
    N = mask_logits.shape[0]
    dev = mask_logits.device
    n_sampled = int(num_points * oversample_ratio)
    coords = drawn_rows(uniform_points(drawn_shape((N, n_sampled, 2), rows), generator, dev),
                        rows)
    with torch.no_grad():
        uncert = calculate_uncertainty(point_sample_batch(mask_logits.detach(), coords))[:, 0]
    n_uncertain = int(importance_sample_ratio * num_points)
    n_random = num_points - n_uncertain
    top = torch.topk(uncert, n_uncertain, dim=1).indices
    picked = torch.gather(coords, 1, top[..., None].expand(N, n_uncertain, 2))
    if n_random > 0:
        extra = uniform_points(drawn_shape((N, n_random, 2), rows), generator, dev)
        picked = torch.cat([picked, drawn_rows(extra, rows)], dim=1)
    return picked
