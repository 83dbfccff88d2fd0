"""The X-Decoder's two kernel ops of the torch port against the JAX package.

``ms_deform_attn`` (the plain version of K9) against JAX's XLA gather, its
Pallas kernel (interpret mode on the CPU, as ``tests/test_ops.py`` runs it)
and its python oracle; ``focal_ctx_plain`` (the plain version of K10)
against JAX's Pallas ``fused_focal_ctx`` (tanh GELU) and against the
FocalNet model's own XLA chain (erf GELU at f32).  Inputs come from a numpy
seed, f32, small non-square shapes, 2-4 levels, sampling points outside the
maps; atol 1e-5.  The kernels themselves are held against these plain
versions on a card in ``tests/test_torch_package.py`` (marked ``cuda``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cullavo_tpu.models.xdecoder.focalnet import _depthwise_conv
from cullavo_tpu.ops import msdeform as jms
from cullavo_tpu.ops.focal_pallas import fused_focal_ctx
from cullavo_tpu.ops.focal_pallas import pack_level_weights as jpack
from cullavo_tpu.ops.msdeform_pallas import ms_deform_attn_pallas
from cullavo_tpu_torch.ops import focal as tfocal
from cullavo_tpu_torch.ops import msdeform as tms


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


MSDEFORM_CASES = [
    # (levels, Q, Hh, hd, P): non-square levels, Q not a multiple of 128
    (((6, 10), (3, 5)), 37, 2, 32, 4),
    (((8, 6), (4, 3), (2, 2)), 150, 4, 32, 4),
    (((7, 9), (4, 5), (2, 3), (1, 2)), 20, 2, 64, 3),
]


def _msdeform_inputs(shapes, Q, Hh, hd, P, seed):
    rng = np.random.default_rng(seed)
    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    B = 2
    value = rng.normal(size=(B, S, Hh, hd)).astype(np.float32)
    # about a tenth of the points fall outside [0, 1]
    loc = rng.uniform(-0.1, 1.1, (B, Q, Hh, L, P, 2)).astype(np.float32)
    att = rng.random((B, Q, Hh, L, P)).astype(np.float32)
    att = att / att.sum(axis=(3, 4), keepdims=True)
    return value, loc, att


def _jax_msdeform(value, shapes, loc, att):
    """JAX's XLA gather and its Pallas kernel (interpret mode), each jitted:
    one compile instead of op-by-op dispatch (the same values)."""
    shapes = tuple(tuple(hw) for hw in shapes)
    args = (jnp.asarray(value), jnp.asarray(loc), jnp.asarray(att))
    return (jax.jit(lambda v, lo, a: jms.ms_deform_attn(v, shapes, lo, a))(*args),
            jax.jit(lambda v, lo, a: ms_deform_attn_pallas(v, shapes, lo, a))(*args))


@pytest.mark.parametrize("shapes,Q,Hh,hd,P", MSDEFORM_CASES)
def test_ms_deform_attn_plain_matches_jax(shapes, Q, Hh, hd, P):
    value, loc, att = _msdeform_inputs(shapes, Q, Hh, hd, P, seed=len(shapes))
    got = tms.ms_deform_attn(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                             torch.from_numpy(att)).numpy()
    xla, pallas = _jax_msdeform(value, shapes, loc, att)
    np.testing.assert_allclose(got, np.asarray(xla), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-5, rtol=0)
    if len(shapes) == 2:   # the python oracle is slow: one case
        oracle = jms.ms_deform_attn_reference(value, shapes, loc, att)
        np.testing.assert_allclose(got, oracle, atol=1e-5, rtol=0)


def test_ms_deform_attn_kernel_wrapper_takes_the_plain_version_on_cpu():
    shapes, Q, Hh, hd, P = MSDEFORM_CASES[0]
    value, loc, att = (torch.from_numpy(a) for a in _msdeform_inputs(shapes, Q, Hh, hd, P, 0))
    n0 = tms.ms_deform_attn_kernel.launches
    got = tms.ms_deform_attn_kernel(value, shapes, loc, att)
    assert tms.ms_deform_attn_kernel.launches == n0
    assert torch.equal(got, tms.ms_deform_attn(value, shapes, loc, att))
    with pytest.raises(ValueError, match="unsupported device"):
        tms.ms_deform_attn_kernel(value.to("meta"), shapes, loc.to("meta"), att.to("meta"))


def test_msdeform_module_forward_matches_jax():
    rng = np.random.default_rng(7)
    shapes = ((6, 10), (3, 5), (2, 3))
    B, D, heads, L, P = 2, 64, 4, 3, 4
    S = sum(h * w for h, w in shapes)
    Q = S
    f32 = np.float32
    params = {"value_proj": {"w": rng.normal(0, 0.1, (D, D)).astype(f32),
                             "b": rng.normal(0, 0.1, (D,)).astype(f32)},
              "offset": {"w": rng.normal(0, 0.1, (D, heads * L * P * 2)).astype(f32),
                         "b": rng.normal(0, 1.0, (heads * L * P * 2,)).astype(f32)},
              "weight": {"w": rng.normal(0, 0.1, (D, heads * L * P)).astype(f32),
                         "b": np.zeros((heads * L * P,), f32)},
              "output": {"w": rng.normal(0, 0.1, (D, D)).astype(f32),
                         "b": np.zeros((D,), f32)}}
    query = rng.normal(size=(B, Q, D)).astype(f32)
    value = rng.normal(size=(B, S, D)).astype(f32)
    ref_pts = rng.uniform(0, 1, (B, Q, L, 2)).astype(f32)
    want = jax.jit(lambda p, q, v, r: jms.msdeform_attn_module_forward(
        p, q, v, shapes, r, heads, L, P))(jax.tree.map(jnp.asarray, params), jnp.asarray(query),
                                          jnp.asarray(value), jnp.asarray(ref_pts))
    tp = {k: {n: torch.from_numpy(a) for n, a in v.items()} for k, v in params.items()}
    got = tms.msdeform_attn_module_forward(tp, torch.from_numpy(query), torch.from_numpy(value),
                                           shapes, torch.from_numpy(ref_pts), heads, L, P)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


FOCAL_CASES = [
    # (B, C, H, W, kernels): non-square maps, L = 2..4
    (2, 8, 7, 12, (3, 5)),
    (1, 16, 10, 6, (3, 5, 7)),
    (2, 8, 9, 13, (3, 5, 7, 9)),
    (1, 8, 4, 5, (3, 5, 7, 9)),    # the map is smaller than the widest kernel
]


def _focal_inputs(B, C, H, W, kernels, seed):
    rng = np.random.default_rng(seed)
    L = len(kernels)
    ctx = rng.normal(size=(B, C, H * W)).astype(np.float32)
    gates = rng.normal(size=(B, L + 1, H * W)).astype(np.float32)
    kws = [(rng.normal(size=(k, k, 1, C)) * 0.3).astype(np.float32) for k in kernels]
    return ctx, gates, kws


def _port_taps(kws):
    """HWIO (k, k, 1, C) -> the port's [C, 1, k, k], packed."""
    return tfocal.pack_level_weights([torch.from_numpy(k).permute(3, 2, 0, 1) for k in kws])


@pytest.mark.parametrize("B,C,H,W,kernels", FOCAL_CASES)
@pytest.mark.parametrize("scaling", [True, False])
def test_focal_ctx_plain_matches_pallas_tanh(B, C, H, W, kernels, scaling):
    ctx, gates, kws = _focal_inputs(B, C, H, W, kernels, seed=C + H)
    lw = _port_taps(kws)
    assert torch.equal(lw, torch.from_numpy(np.array(jpack([jnp.asarray(k) for k in kws]))))
    got = tfocal.focal_ctx_plain(torch.from_numpy(ctx), torch.from_numpy(gates), lw, H, W,
                                 kernels, scaling, approximate=True)
    want = jax.jit(lambda c, g, lw: fused_focal_ctx(c, g, lw, H, W, kernels, scaling))(
        jnp.asarray(ctx), jnp.asarray(gates), jpack([jnp.asarray(k) for k in kws]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("B,C,H,W,kernels", FOCAL_CASES[:3])
def test_focal_ctx_plain_matches_the_models_erf_chain(B, C, H, W, kernels):
    """The f32 model's chain (focalnet.py focal_modulation, XLA branch):
    exact-erf GELU, NHWC depthwise convs."""
    ctx, gates, kws = _focal_inputs(B, C, H, W, kernels, seed=3 * C + W)
    L = len(kernels)

    @jax.jit
    def chain(ctx, gates, kws):
        x = ctx.reshape(B, C, H, W).transpose(0, 2, 3, 1)
        g = gates.reshape(B, L + 1, H, W).transpose(0, 2, 3, 1)
        acc = jnp.zeros_like(x)
        for lvl in range(L):
            x = jax.nn.gelu(_depthwise_conv(x, kws[lvl]), approximate=False)
            acc = acc + x * g[..., lvl:lvl + 1]
        glob = jax.nn.gelu(jnp.mean(x, axis=(1, 2), keepdims=True), approximate=False)
        acc = (acc + glob * g[..., L:L + 1]) / (L + 1)
        return acc.transpose(0, 3, 1, 2).reshape(B, C, H * W)

    want = np.asarray(chain(jnp.asarray(ctx), jnp.asarray(gates), [jnp.asarray(k) for k in kws]))
    got = tfocal.focal_ctx_plain(torch.from_numpy(ctx), torch.from_numpy(gates),
                                 _port_taps(kws), H, W, kernels, True, approximate=False)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_focal_ctx_kernel_wrapper_takes_the_plain_version_on_cpu():
    B, C, H, W, kernels = FOCAL_CASES[0]
    ctx, gates, kws = _focal_inputs(B, C, H, W, kernels, seed=0)
    ctx, gates, lw = torch.from_numpy(ctx), torch.from_numpy(gates), _port_taps(kws)
    n0 = tfocal.focal_ctx_kernel.launches
    got = tfocal.focal_ctx_kernel(ctx, gates, lw, H, W, kernels, True, True)
    assert tfocal.focal_ctx_kernel.launches == n0
    assert torch.equal(got, tfocal.focal_ctx_plain(ctx, gates, lw, H, W, kernels, True, True))
    with pytest.raises(ValueError, match="unsupported device"):
        tfocal.focal_ctx_kernel(ctx.to("meta"), gates.to("meta"), lw.to("meta"), H, W,
                                kernels, True, True)


# ---------------------------------------------------------------------------
# K10's launch planner (pure: ``focal_plan``), held on the CPU
# ---------------------------------------------------------------------------

FOCALNET_L_KERNELS = (3, 5, 7, 9)
# FocalNet-L's four stage maps and channels at a 512^2 image and at the
# 512 x 640 bucket
FOCALNET_L_MAPS = [(128, 128, 192), (64, 64, 384), (32, 32, 768), (16, 16, 1536),
                   (128, 160, 192), (64, 80, 384), (32, 40, 768), (16, 20, 1536)]


@pytest.mark.parametrize("H,W,C,kernels,smem", [
    (128, 128, 192, FOCALNET_L_KERNELS, tfocal.FOCAL_SMEM),
    (16, 20, 1536, FOCALNET_L_KERNELS, tfocal.FOCAL_SMEM),
    (160, 160, 8, FOCALNET_L_KERNELS, tfocal.FOCAL_SMEM),       # just past one pass
    (300, 200, 3, FOCALNET_L_KERNELS, tfocal.FOCAL_SMEM),
    (128, 128, 192, FOCALNET_L_KERNELS, 100_000),                 # a smaller card
    (100, 75, 96, (3, 5, 7), 60_000),
    (70, 130, 16, (3, 5, 7, 9, 11, 13, 15, 17), tfocal.FOCAL_SMEM),
    (5, 3, 8, FOCALNET_L_KERNELS, tfocal.FOCAL_SMEM),
    (33, 17, 4, (1,), 20_000)])
def test_focal_plan_covers_every_pixel_once_within_shared_memory(H, W, C, kernels, smem):
    """Every (channel, pixel) of the map in exactly one block's output, the
    blocks' shared memory within the limit given, every slot of a block's
    widest window held by its threads, the buffer's ring as wide as the
    widest radius, its columns the window and the ring on both sides, its
    column pitch room for the stacked planes and their gaps (rows at
    multiples of 4, a pitch of 4 modulo 8 floats); a tiled window is its tile
    with the halo of every level's radius, clipped to the map."""
    plan = tfocal.focal_plan(H, W, C, kernels, smem, 8, 132)
    cover = np.zeros((C, H, W), dtype=int)
    for c0, c1 in plan["channels"]:
        for y0, x0, h, w in plan["tiles"]:
            cover[c0:c1, y0:y0 + h, x0:x0 + w] += 1
    assert (cover == 1).all()
    assert plan["smem"] <= smem
    assert plan["slots"] <= plan["threads"] * plan["ns"] and plan["ns"] <= tfocal.FOCAL_MAX_SLOTS
    ring, halo = max(k // 2 for k in kernels), sum(k // 2 for k in kernels)
    wh, ww = plan["window"]
    th, tw = plan["tile"]
    assert plan["ring"] == ring and plan["halo"] == halo
    assert plan["gap"] >= ring and plan["gap"] % 4 == 0 and plan["cols"] == ww + 2 * ring
    assert plan["pitch"] % 8 == 4
    assert plan["pitch"] >= plan["gap"] + plan["planes"] * (wh + plan["gap"]) + 4
    assert plan["ctas"] == 8 * len(plan["tiles"]) * len(plan["channels"])
    if plan["path"] == "one_pass":
        assert plan["tiles"] == ((0, 0, H, W),) and (wh, ww) == (H, W)
    else:
        assert plan["planes"] == 1 and (wh, ww) == (min(H, th + 2 * halo), min(W, tw + 2 * halo))
        assert (th, tw) != (H, W)


@pytest.mark.parametrize("H,W,C", FOCALNET_L_MAPS)
def test_focal_plan_takes_one_pass_at_every_focalnet_l_stage(H, W, C):
    """At both X-Decoder buckets every FocalNet-L stage map fits a block
    whole: one kernel, no scratch; small maps put several planes in a block
    and keep every thread's slot count at the least the grid allows."""
    plan = tfocal.focal_plan(H, W, C, FOCALNET_L_KERNELS, tfocal.FOCAL_SMEM, 8, 132)
    assert plan["path"] == "one_pass"
    assert plan["planes"] == 1 if H == 128 else plan["planes"] > 1
    slots_per_plane = -(-H // 16) * W
    assert plan["slots"] == plan["planes"] * slots_per_plane


@pytest.mark.parametrize("kernels", [(3, 4), (2,), (), (3,) * 9, (0, 3), (-1,)])
def test_focal_plan_refuses_even_k_and_more_than_eight_levels(kernels):
    with pytest.raises(ValueError, match="1 to 8 levels of odd k"):
        tfocal.focal_plan(32, 32, 8, kernels)


def test_focal_plan_refuses_a_halo_no_tile_can_hold():
    with pytest.raises(ValueError, match="no tile"):
        tfocal.focal_plan(64, 64, 8, (15,) * 8, 20_000)


@pytest.mark.parametrize("H,W,C,kernels,smem", [(40, 37, 3, (3, 5, 7), 16_000),
                                                (23, 50, 2, (3, 5, 7, 9), 20_000)])
def test_focal_plan_tiles_and_their_halo_give_the_plain_chain(H, W, C, kernels, smem):
    """The tiled path's arithmetic restated with the plan's tiles: each tile's
    window (the tile and its halo, clipped to the map) run through every
    level with zero padding at the window's edge, then cut to the tile,
    gives the plain version's gated sum (the global term added apart):
    the halo of the summed radii is enough."""
    plan = tfocal.focal_plan(H, W, C, kernels, smem, 1, 132)
    assert plan["path"] == "tiled" and len(plan["tiles"]) > 1
    rng = np.random.default_rng(H * W)
    L = len(kernels)
    ctx = torch.from_numpy(rng.normal(size=(1, C, H, W)).astype(np.float32))
    gates = torch.from_numpy(rng.normal(size=(1, L + 1, H, W)).astype(np.float32))
    taps = [torch.from_numpy((rng.normal(size=(C, 1, k, k)) * 0.3).astype(np.float32))
            for k in kernels]
    acc = torch.zeros_like(ctx)
    x = ctx
    for lvl, k in enumerate(kernels):        # the plain chain, less the global term
        x = tfocal.gelu(torch.nn.functional.conv2d(x, taps[lvl], padding=k // 2, groups=C), True)
        acc = acc + x * gates[:, lvl:lvl + 1]
    halo = plan["halo"]
    for y0, x0, h, w in plan["tiles"]:
        wy0, wx0 = max(0, y0 - halo), max(0, x0 - halo)
        wy1, wx1 = min(H, y0 + h + halo), min(W, x0 + w + halo)
        xw, aw = ctx[:, :, wy0:wy1, wx0:wx1], 0
        for lvl, k in enumerate(kernels):
            xw = tfocal.gelu(torch.nn.functional.conv2d(xw, taps[lvl], padding=k // 2, groups=C),
                             True)
            aw = aw + xw * gates[:, lvl:lvl + 1, wy0:wy1, wx0:wx1]
        got = aw[:, :, y0 - wy0:y0 - wy0 + h, x0 - wx0:x0 - wx0 + w]
        torch.testing.assert_close(got, acc[:, :, y0:y0 + h, x0:x0 + w], atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# K9's launch planner (pure: ``msdeform_plan``), held on the CPU; and the
# plain K9 at the deform encoder's own draw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Q,Hh", [(8, 5376, 8), (2, 6720, 8), (2, 3001, 8), (2, 77, 2),
                                    (1, 1, 1), (3, 64, 1), (2, 65, 4)])
def test_msdeform_plan_covers_every_query_once(B, Q, Hh):
    """Every query of every (b, head) in exactly one (tile, warp) walk: the
    deform encoder's Q = S at 512^2 and at the 512 x 640 bucket, Q that
    fills no tile, one query, exactly one tile, one past it."""
    plan = tms.msdeform_plan(B, Q, Hh)
    tiles, heads, batch = plan["grid"]
    assert (heads, batch) == (Hh, B)
    warps, tile_q = plan["warps"], plan["tile_q"]
    assert 1 <= warps <= 32 and tile_q >= warps
    seen = np.zeros(Q, dtype=int)
    for t in range(tiles):
        q0, q1 = t * tile_q, min(Q, (t + 1) * tile_q)
        assert q0 < q1                       # no tile without queries
        for w in range(warps):
            seen[q0 + w:q1:warps] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("B,Q,Hh", [(0, 10, 8), (2, 0, 8), (2, 10, 0)])
def test_msdeform_plan_refuses_empty_grids(B, Q, Hh):
    with pytest.raises(ValueError, match="msdeform_plan"):
        tms.msdeform_plan(B, Q, Hh)


def test_ms_deform_attn_plain_matches_jax_at_the_encoders_draw():
    """The encoder's own draw (draw p): every query's reference point is its
    pixel centre, the offset projection is the Deformable-DETR bias (point p
    at (p + 1) pixels along its head's direction, on every level) and the
    weights are uniform, as ``init_deform_encoder_params`` starts them.  The
    plain K9 against JAX's XLA gather and its Pallas kernel (interpret
    mode)."""
    from cullavo_tpu_torch.models.xdecoder import deform_encoder as tde

    cfg = tde.DeformEncoderConfig()
    shapes = ((2, 3), (4, 6), (8, 12))
    Hh, L, P, hd, B = cfg.num_heads, len(shapes), cfg.num_points, 32, 2
    S = sum(h * w for h, w in shapes)
    rng = np.random.default_rng(11)
    value = rng.normal(size=(B, S, Hh, hd)).astype(np.float32)
    refs = []
    for h, w in shapes:
        yy, xx = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w, indexing="ij")
        refs.append(np.stack([xx, yy], -1).reshape(-1, 2))
    ref = np.concatenate(refs).astype(np.float32)                        # [Q, 2]
    off = tde._offset_bias(cfg).reshape(Hh, L, P, 2).astype(np.float32)
    norm = np.array([[w, h] for h, w in shapes], np.float32)            # (W, H) a level
    loc = ref[None, :, None, None, None, :] + (off / norm[None, :, None, :])[None, None]
    loc = np.ascontiguousarray(np.broadcast_to(loc, (B, S, Hh, L, P, 2)), np.float32)
    att = np.full((B, S, Hh, L, P), 1.0 / (L * P), np.float32)
    assert (loc < 0).any() and (loc > 1).any()    # the edge queries reach past their maps
    got = tms.ms_deform_attn(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                             torch.from_numpy(att)).numpy()
    xla, pallas = _jax_msdeform(value, shapes, loc, att)
    np.testing.assert_allclose(got, np.asarray(xla), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-5, rtol=0)
