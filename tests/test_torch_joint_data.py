"""The port's X-Decoder training pieces against the JAX package, on the CPU:
box ops, point sampling (edges included, JAX's uniform draws replayed),
the matcher's costs and assignments, every loss of the set criterion and
the grounding / caption / language losses on the same predictions and
targets (random points pinned on both sides), the warmup schedules and the
optimizer's parameter groups, and the joint-training data: the Lancaster
stemmer and hashes, polygon and RLE masks, the caption-grounding loader
(with LVIS), ``JointTrainMapper`` over files written with the port's PNG
writer, ``pad_targets`` and ``collate_joint`` from one numpy seed; and
``forward_seg_train`` with grounding tokens, ``make_xdecoder_train_step``
and ``class_embeddings_train`` on the tiny model.

JAX's references are jitted, one compile each; tolerances: point samples
1e-6, costs 1e-5 of their largest entry, criterion losses 1e-5 relative,
the seg forward's losses 1e-4 relative, data equal.
"""
import importlib.util
import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cullavo_tpu.data import coco_caption_grounding as jcg
from cullavo_tpu.data import coco_panoptic as jpan
from cullavo_tpu.data import datasets as jds
from cullavo_tpu.models.xdecoder import criterion as jcrit
from cullavo_tpu.models.xdecoder import language_loss as jll
from cullavo_tpu.models.xdecoder import matcher as jmatch
from cullavo_tpu.ops import point_sample as jps
from cullavo_tpu.trainer import optimizer as jopt
from cullavo_tpu.utils import box_ops as jbox
from cullavo_tpu.utils import constants as jconst
from cullavo_tpu_torch.data import coco_caption_grounding as tcg
from cullavo_tpu_torch.data import coco_panoptic as tpan
from cullavo_tpu_torch.data import datasets as tds
from cullavo_tpu_torch.models.xdecoder import criterion as tcrit
from cullavo_tpu_torch.models.xdecoder import language_loss as tll
from cullavo_tpu_torch.models.xdecoder import matcher as tmatch
from cullavo_tpu_torch.ops import point_sample as tps
from cullavo_tpu_torch.trainer import optimizer as topt
from cullavo_tpu_torch.utils import box_ops as tbox
from cullavo_tpu_torch.utils import constants as tconst
from cullavo_tpu_torch.utils.tree import tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASS_NAMES = ["person", "cat", "tree", "sky", "grass", "wall"]
N_THINGS = 3
CRIT = jcrit.CriterionConfig(num_classes=6, num_points=64)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Draws:
    """Pinned random points: the k-th uniform draw of a run (a matcher's
    points, an importance sample) is the k-th array of a seeded numpy
    sequence, in both packages.  ``reset`` starts the sequence again."""

    def __init__(self, seed):
        self.seed = seed
        self.reset()

    def reset(self):
        self.rng = np.random.default_rng(self.seed)
        self.shapes = []

    def next(self, shape):
        self.shapes.append(tuple(shape))
        return self.rng.random(tuple(shape), dtype=np.float32)

    def pin_jax(self, monkeypatch):
        monkeypatch.setattr(jax.random, "uniform",
                            lambda key, shape=(), *a, **k: jnp.asarray(self.next(shape)))
        monkeypatch.setattr(jcrit, "uncertain_point_coords", lambda m, rng, n, *a, **k:
                            jnp.asarray(self.next((m.shape[0], n, 2))))

    def pin_port(self, monkeypatch):
        def uniform(shape, generator, device):
            return torch.from_numpy(self.next(shape)).to(device)

        monkeypatch.setattr(tmatch, "uniform_points", uniform)
        monkeypatch.setattr(tcrit, "uniform_points", uniform)
        monkeypatch.setattr(tcrit, "uncertain_point_coords", lambda m, gen, n, *a, **k:
                            torch.from_numpy(self.next((m.shape[0], n, 2))))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _close(got, want, atol=1e-6, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=rtol)


def _rel(got, want, tol=1e-5):
    got, want = float(got), float(want)
    assert abs(got - want) <= tol * max(abs(want), 1e-6), (got, want)


# ---------------------------------------------------------------------------
# box ops and point sampling
# ---------------------------------------------------------------------------

def test_box_ops_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0.05, 0.95, (7, 4)).astype(np.float32)
    b = rng.uniform(0.05, 0.95, (5, 4)).astype(np.float32)
    xa, xb = jbox.box_cxcywh_to_xyxy(a), jbox.box_cxcywh_to_xyxy(b)
    _close(tbox.box_cxcywh_to_xyxy(_t(a)), xa)
    _close(tbox.box_xyxy_to_cxcywh(_t(np.asarray(xa))), jbox.box_xyxy_to_cxcywh(xa))
    _close(tbox.box_area(_t(np.asarray(xa))), jbox.box_area(xa))
    for got, want in zip(tbox.pairwise_iou(_t(np.asarray(xa)), _t(np.asarray(xb))),
                         jbox.pairwise_iou(xa, xb)):
        _close(got, want)
    _close(tbox.generalized_box_iou(_t(np.asarray(xa)), _t(np.asarray(xb))),
           jbox.generalized_box_iou(xa, xb))
    masks = (rng.random((4, 9, 11)) > 0.8).astype(np.float32)
    masks[2] = 0
    _close(tbox.masks_to_boxes(_t(masks)), jbox.masks_to_boxes(jnp.asarray(masks)))


def _edge_coords(P, rng, H, W):
    """Uniform points plus the map's edges: 0, 1, half a pixel in, the last
    pixel centre, just outside."""
    edges = np.asarray([0.0, 1.0, 0.5 / W, 1 - 0.5 / W, 0.5 / H, 1 - 0.5 / H, -0.01, 1.01, 0.5],
                       np.float32)
    ex, ey = np.meshgrid(edges, edges)
    grid = np.stack([ex.ravel(), ey.ravel()], -1)
    return np.concatenate([grid, rng.random((P - len(grid), 2), dtype=np.float32)])


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("P", [200, 2500])
def test_point_sample_matches_jax_at_the_edges(align_corners, P):
    """Against JAX's tent-matmul form; past 2048 points JAX chunks that form
    through a loop whose products stray ~4e-6 from the exact bilinear
    value, so there the reference is JAX's gather form, vmapped."""
    rng = np.random.default_rng(P)
    N, C, H, W = 3, 5, 12, 17
    feats = rng.normal(size=(N, C, H, W)).astype(np.float32)
    coords = np.stack([_edge_coords(P, rng, H, W) for _ in range(N)])
    got = tps.point_sample_batch(_t(feats), _t(coords), align_corners=align_corners)
    if P <= 2048:
        want = jps.point_sample_batch(jnp.asarray(feats), jnp.asarray(coords),
                                      align_corners=align_corners)
    else:
        want = jax.vmap(lambda f, c: jps.point_sample(f, c, align_corners=align_corners))(
            jnp.asarray(feats), jnp.asarray(coords))
    _close(got, want)
    _close(tps.point_sample(_t(feats[0]), _t(coords[0]), align_corners=align_corners),
           jps.point_sample(jnp.asarray(feats[0]), jnp.asarray(coords[0]),
                            align_corners=align_corners))


def test_uncertain_point_coords_replays_jax_draws(monkeypatch):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(4, 1, 16, 20)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jps.uncertain_point_coords(jnp.asarray(logits), key, 50, 3.0, 0.75)
    k1, k2 = jax.random.split(key)
    draws = [np.asarray(jax.random.uniform(k1, (4, 150, 2))),
             np.asarray(jax.random.uniform(k2, (4, 13, 2)))]
    monkeypatch.setattr(tps, "uniform_points", lambda shape, gen, dev: _t(draws.pop(0)))
    got = tps.uncertain_point_coords(_t(logits), None, 50, 3.0, 0.75)
    assert not draws
    _close(got, want)
    _close(tps.calculate_uncertainty(_t(logits)), jps.calculate_uncertainty(logits))


# ---------------------------------------------------------------------------
# matcher and criterion
# ---------------------------------------------------------------------------

def _predictions(rng, B=2, Q=7, C=7, H=16, W=16, aux=3):
    def layer():
        return {"pred_logits": rng.normal(size=(B, Q, C)).astype(np.float32),
                "pred_masks": rng.normal(size=(B, Q, H, W)).astype(np.float32) * 2,
                "pred_boxes": rng.normal(size=(B, Q, 4)).astype(np.float32)}
    out = layer()
    out["aux_outputs"] = [layer() for _ in range(aux)]
    return out


def _targets(rng, B=2, N=4, H=32, W=32, C=6):
    valid = np.zeros((B, N), bool)
    valid[0, :3] = True
    valid[1, :1] = True
    masks = np.zeros((B, N, H, W), np.float32)
    for b in range(B):
        for n in range(N):
            y, x = rng.integers(0, H // 2, 2)
            masks[b, n, y:y + H // 2, x:x + W // 3] = 1.0
    return {"classes": rng.integers(0, C, (B, N)).astype(np.int32),
            "masks": masks, "boxes": rng.uniform(0.1, 0.6, (B, N, 4)).astype(np.float32),
            "valid": valid}


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(v, fn) for v in tree]
    return fn(tree)


def test_match_costs_and_hungarian_match_equal_jax():
    rng = np.random.default_rng(2)
    out, tg = _predictions(rng), _targets(rng)
    coords = rng.random((2, 96, 2), dtype=np.float32)
    args = (out["pred_logits"], out["pred_masks"], tg["classes"], tg["masks"], tg["valid"])
    want = np.asarray(jmatch.compute_match_costs(*map(jnp.asarray, args), None, num_points=96,
                                                 coords=jnp.asarray(coords)))
    got = tmatch.compute_match_costs(*map(_t, args), None, num_points=96,
                                     coords=_t(coords)).numpy()
    ok = np.broadcast_to(tg["valid"][:, None, :], want.shape)
    _close(got[ok], want[ok], atol=1e-5 * np.abs(want[ok]).max())
    assert (got[~ok] == 1e8).all()
    n_valid = tg["valid"].sum(1)
    j_src, j_ok = jmatch.hungarian_match(jnp.asarray(want), jnp.asarray(n_valid))
    t_src, t_ok = tmatch.hungarian_match(_t(want), _t(n_valid))
    np.testing.assert_array_equal(t_src.numpy(), np.asarray(j_src))
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    _close(tmatch.batch_dice_cost(_t(out["pred_masks"][0, :, 0]), _t(tg["masks"][0, :, 0, :16])),
           jmatch.batch_dice_cost(out["pred_masks"][0, :, 0], tg["masks"][0, :, 0, :16]),
           atol=1e-6)


def test_set_criterion_matches_jax_with_points_pinned():
    """Every layer's match and loss; padded target slots name query 0 (the
    JAX scatter's last-slot-wins semantics are part of loss_labels)."""
    rng = np.random.default_rng(4)
    out, tg = _predictions(rng), _targets(rng)
    B, N = tg["valid"].shape
    pins = {r: {"match": rng.random((B, 80, 2), dtype=np.float32),
                "loss": rng.random((B * N, 64, 2), dtype=np.float32)} for r in range(4)}
    want, j_idx = jax.jit(lambda o, t, p: jcrit.set_criterion(
        o, t, CRIT, jax.random.PRNGKey(0), return_indices="all", pinned_coords=p))(
        _tree(out, jnp.asarray), _tree(tg, jnp.asarray), _tree(pins, jnp.asarray))
    got, t_idx = tcrit.set_criterion(_tree(out, _t), _tree(tg, _t), tcrit.CriterionConfig(
        num_classes=6, num_points=64), None, return_indices="all", pinned_coords=_tree(pins, _t))
    assert set(got) == set(want) and len(got) == 20
    for k in want:
        _rel(got[k], want[k])
    for r in range(4):
        np.testing.assert_array_equal(t_idx[r][0].numpy(), np.asarray(j_idx[r][0]))
        np.testing.assert_array_equal(t_idx[r][1].numpy(), np.asarray(j_idx[r][1]))


def test_grounding_match_and_losses_match_jax(monkeypatch):
    rng = np.random.default_rng(5)
    B, Qg, G, D = 2, 6, 3, 16
    g_masks = rng.normal(size=(B, Qg, 16, 16)).astype(np.float32) * 2
    g_texts = rng.normal(size=(B, Qg, D)).astype(np.float32)
    tgt = (rng.random((B, G, 32, 32)) > 0.6).astype(np.float32)
    embs = rng.normal(size=(B, G, D)).astype(np.float32)
    gvalid = np.asarray([[True, True, False], [True, True, True]])
    ghash = np.asarray([[3, 3, 0], [1, 2, 1]], np.int64)
    scale = np.float32(0.7)
    def run(mods, crit, gm, gt, tg, em, gv, sc, gh, take):
        src, ok, sim = mods.match_groundings(gm, gt, tg, em, gv, sc, None, crit)
        bce, dice = mods.loss_groundings(take(gm, src), tg, ok, None, crit)
        return src, ok, sim, bce, dice, mods.loss_grounding_ce(sim, src, ok, gh)

    args = (g_masks, g_texts, tgt, embs, gvalid, scale, ghash)
    Draws(9).pin_jax(monkeypatch)
    want = jax.jit(lambda *a: run(jcrit, CRIT, *a, lambda m, i: jnp.take_along_axis(
        m, i[:, :, None, None], 1)))(*map(jnp.asarray, args))
    Draws(9).pin_port(monkeypatch)
    got = run(tcrit, tcrit.CriterionConfig(num_classes=6, num_points=64), *map(_t, args),
              lambda m, i: torch.gather(m, 1, i[:, :, None, None].expand(-1, -1, 16, 16)))
    (js, jo, jsim, *jl), (ts, to, tsim, *tl) = (tuple(map(np.asarray, want[:3])) + want[3:],
                                                tuple(x.numpy() for x in got[:3]) + got[3:])
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(to, jo)
    _close(tsim, jsim, atol=1e-5 * np.abs(jsim).max())
    for got, want in zip(tl, jl):
        _rel(got, want)


def test_caption_and_language_losses_match_jax():
    rng = np.random.default_rng(6)
    B, Q, N, P, D, T, V = 2, 9, 3, 4, 16, 6, 20
    preds = rng.normal(size=(B, Q, D)).astype(np.float32)
    src = np.asarray([[0, 3, 0], [5, 0, 0]])            # padded slots name query 0
    valid = np.asarray([[True, True, False], [True, False, False]])
    labels = rng.integers(0, 6, (B, N)).astype(np.int32)
    lhash = rng.integers(1, 4, (B, N)).astype(np.int64)
    class_embs = rng.normal(size=(7, D)).astype(np.float32)
    cap_embs = rng.normal(size=(B, P, D)).astype(np.float32)
    chash = np.asarray([[1, 2, 7, 0], [3, 3, 9, 0]], np.int64)
    cvalid = np.asarray([[True, True, True, False], [True, True, True, True]])
    scale = np.float32(1.3)
    cap = rng.normal(size=(B, T, D)).astype(np.float32)
    ids = rng.integers(0, V, (B, T)).astype(np.int32)
    tmask = np.asarray([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]], np.int32)
    vocab = rng.normal(size=(V, D)).astype(np.float32)
    img, txt = rng.normal(size=(B, D)).astype(np.float32), rng.normal(size=(B, D)).astype(
        np.float32)
    pos = rng.random((B, B)) > 0.5

    def run(crit, ll, a):
        return (crit.loss_captions(*a[:10]),
                crit.loss_captionings(a[10], a[10], a[11], a[12], a[13], a[9]),
                ll.image_text_contrastive_loss(a[14], a[15], a[9]),
                ll.fine_grained_itc_loss(a[0], a[10], a[12], a[9]),
                ll.multilabel_contrastive_loss(a[14], a[15], a[16], a[9]),
                ll.vl_similarity(a[14], a[15], a[9]))

    args = (preds, src, valid, labels, lhash, class_embs, cap_embs, chash, cvalid, scale,
            cap, ids, tmask, vocab, img, txt, pos)
    want = jax.jit(lambda *a: run(jcrit, jll, a))(*map(jnp.asarray, args))
    got = run(tcrit, tll, tuple(map(_t, args)))
    for g, w in zip(got[:5], want[:5]):
        _rel(g, w)
    _close(got[5], want[5], atol=1e-5)
    # a data axis of one rank (its gather and share the identity): the
    # batch-coupled losses take the same path and give the same values
    one_rank = types.SimpleNamespace(gather=lambda x: x, share=lambda x: x,
                                     sum=lambda x: x, rows=lambda k=1: (0, B * k, B * k),
                                     total=B)
    targs = tuple(map(_t, args))
    assert torch.equal(tll.vl_contrastive_loss(_t(img), _t(txt), 1.0, data_axis=one_rank),
                       tll.vl_contrastive_loss(_t(img), _t(txt), 1.0))
    assert torch.equal(tll.fine_grained_itc_loss(*targs[0:1], targs[10], targs[12], targs[9],
                                                 data_axis=one_rank), got[3])
    assert torch.equal(tcrit.loss_captions(*targs[:10], data_axis=one_rank), got[0])


# ---------------------------------------------------------------------------
# schedules and the optimizer's groups
# ---------------------------------------------------------------------------

def test_warmup_schedules_match_jax():
    jc, tc = jopt.warmup_cosine(1e-4, 50, 10), topt.warmup_cosine(1e-4, 50, 10)
    jm = jopt.warmup_multistep(2e-4, (20, 35), 0.1, 5)
    tm = topt.warmup_multistep(2e-4, (20, 35), 0.1, 5)
    steps = np.arange(0, 60)
    for port, jax_fn in ((tc, jc), (tm, jm)):
        want = np.asarray(jax.vmap(jax_fn)(steps))
        got = np.asarray([port(s) for s in steps], np.float32)
        # f32 on both sides; XLA's cos is not numpy's correctly rounded one: an
        # ulp of cos near -0.8 is 3 ulps of 0.5 (1 + cos)
        assert (np.abs(got - want) <= 4 * np.spacing(want)).all(), (got, want)


def test_xdecoder_optimizer_groups_and_step_match_jax():
    from cullavo_tpu_torch.checkpoint.from_jax import (xdecoder_params_from_numpy,
                                                       xdecoder_params_to_numpy)
    from cullavo_tpu_torch.models.xdecoder import model as tmodel

    params = xdecoder_params_to_numpy(tmodel.init_xdecoder_model_params(
        tmodel.tiny_xdecoder_config(), torch.Generator().manual_seed(0), "cpu"))
    jtx = jopt.xdecoder_optimizer(1e-3, 20, warmup_steps=2, grad_clip=0.5)
    inner = jax.eval_shape(jtx.init, params)[1].inner_states
    want = {}
    for group, st in inner.items():
        leaves = jax.tree_util.tree_flatten_with_path(
            st.inner_state[0].mu, is_leaf=lambda x: type(x).__name__ == "MaskedNode")[0]
        for path, leaf in leaves:
            if type(leaf).__name__ != "MaskedNode":
                want[jax.tree_util.keystr(path)] = group
    tparams = xdecoder_params_from_numpy(params, "cpu")
    got = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + f"['{k}']")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + f"[{i}]")
        else:
            got[path] = node

    walk(topt.xdecoder_param_labels(tparams), "")
    assert got == want and set(got.values()) == {"backbone", "lang", "norm", "embed",
                                                 "default"}
    # three steps on a small tree, one leaf per group
    small = {"backbone": {"w": np.linspace(-1, 1, 6, dtype=np.float32)},
             "text": {"proj": np.linspace(0.5, 2, 4, dtype=np.float32)},
             "decoder": {"ln_s": np.ones(3, np.float32), "query_feat": np.full(3, 0.3, np.float32),
                         "w": np.linspace(-2, 2, 5, dtype=np.float32)}}
    rng = np.random.default_rng(7)
    grads = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), small)
             for _ in range(3)]
    jp, jst = jax.tree.map(jnp.asarray, small), jtx.init(small)
    ttx = topt.xdecoder_optimizer(1e-3, 20, warmup_steps=2, grad_clip=0.5)
    tp = tree_map(_t, small)
    tst = ttx.init(tp)
    upd = jax.jit(jtx.update)
    for g in grads:
        u, jst = upd(jax.tree.map(jnp.asarray, g), jst, jp)
        jp = jax.tree.map(lambda p, d: p + d, jp, u)
        tu, tst = ttx.update(tree_map(_t, g), tst, tp)
        tp = topt.apply_updates(tp, tu)
    for k in small:
        for n in small[k]:
            _close(tp[k][n], jp[k][n], atol=1e-6)


# ---------------------------------------------------------------------------
# joint-training data
# ---------------------------------------------------------------------------

WORDS = ("running dogs happiness cities generously maximum frisbee grass people sitting eating "
         "hydrate possibly apples apple-other cakes motorcycle traffic light dining table "
         "a dog running on the grass, two people sitting x ee 123abc wall-other-merged").split()


def test_stem_hash_and_nouns_match_jax():
    captions = ["A dog running on the grass.", "two people sitting near a wooden fence!",
                "the traffic light, the dining table and apples", ""]
    for w in WORDS + captions:
        assert tcg.stem(w) == jcg.stem(w), w
        assert tcg.text_hash(w) == jcg.text_hash(w), w
    for c in captions:
        assert tcg.extract_nouns(c) == jcg.extract_nouns(c)
        assert (tcg.extract_caption_nouns(c, class_names=CLASS_NAMES)
                == jcg.extract_caption_nouns(c, class_names=CLASS_NAMES))
        assert (tcg.extract_caption_nouns(c, {"dog": (0.99,), "grass": (0.2,)})
                == jcg.extract_caption_nouns(c, {"dog": (0.99,), "grass": (0.2,)}))
    classes = np.asarray([[0, 5, 2], [133, -1, 4]])
    np.testing.assert_array_equal(tcg.labels_hash_for(classes, CLASS_NAMES),
                                  jcg.labels_hash_for(classes, CLASS_NAMES))
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    for name in ("cat", ["tree", "bush"], "a,b+c"):
        assert (tconst.prompt_engineering(name, topk=10000, rng=r1)
                == jconst.prompt_engineering(name, topk=10000, rng=r2))


def test_polygon_and_rle_masks_match_jax():
    polys = [[[2.3, 1.0, 14.7, 3.5, 9.0, 12.2, 1.0, 8.0]],
             [[0, 0, 20, 0, 20, 5, 0, 5], [5, 8, 12, 8, 12, 15]]]
    for poly in polys:
        np.testing.assert_array_equal(tds.polygons_to_mask(poly, 16, 21),
                                      jds.polygons_to_mask(poly, 16, 21))
    rle = {"counts": [3, 5, 10, 2, 40], "size": [6, 10]}
    np.testing.assert_array_equal(tds.rle_to_mask(rle), jds.rle_to_mask(rle))
    np.testing.assert_array_equal(tds.polygons_to_mask(rle, 6, 10), jds.rle_to_mask(rle))
    with pytest.raises(ValueError):
        tds.rle_to_mask({"counts": "abc", "size": [2, 2]})


@pytest.fixture(scope="module")
def joint_files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("joint"))
    spec = chip_smoke().write_joint_dataset(root, [(64, 64), (48, 80), (64, 64), (80, 48)],
                                            CLASS_NAMES, N_THINGS, seed=1, captions=3)
    lvis = {"annotations": [{"image_id": 1, "segmentation": [[0, 0, 4, 0, 4, 4]],
                             "category_id": 333},
                            {"image_id": 9, "segmentation": [], "category_id": 1}]}
    spec["LVIS_JSON"] = os.path.join(root, "lvis.json")
    with open(spec["LVIS_JSON"], "w") as f:
        json.dump(lvis, f)
    return spec


def _load(mod, spec, lvis):
    return mod.load_coco_panoptic_caption_grounding_json(
        spec["JSON"], spec["IMAGE_DIR"], spec["PANOPTIC_DIR"], spec["CAPTION_JSON"],
        spec["GROUNDING_JSON"], {}, lvis_json=spec["LVIS_JSON"] if lvis else None)


@pytest.mark.parametrize("lvis", [False, True])
def test_loader_matches_jax(joint_files, lvis):
    got, want = _load(tcg, joint_files, lvis), _load(jcg, joint_files, lvis)
    assert got == want and len(got) == 4
    assert ("lvis_info" in got[0]) == lvis
    assert len(got[0]["captions"]) == 3 and len(got[0]["grounding_info"]) == 2


def _mapped(mod, spec, S=64):
    mapper = mod.JointTrainMapper(image_size=S, class_names=CLASS_NAMES)
    return [mapper(r) for r in _load(mod, spec, False)]


def _assert_same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, (np.ndarray, jax.Array)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype
    else:
        assert got == want


def test_joint_mapper_matches_jax(joint_files):
    got, want = _mapped(tcg, joint_files), _mapped(jcg, joint_files)
    _assert_same(got, want)
    assert all(len(m["grounding_masks"]) == 2 for m in got)


def _tokenize(texts, T=8, V=64):
    ids = np.zeros((len(texts), T), np.int32)
    mask = np.zeros((len(texts), T), np.int32)
    for i, t in enumerate(texts):
        row = [1] + [2 + jcg.text_hash(w) % (V - 3) for w in t.lower().split()[:T - 2]]
        ids[i, :len(row)] = row
        ids[i, len(row)] = V - 1
        mask[i, :len(row) + 1] = 1
    return ids, mask


@pytest.mark.parametrize("seed,mask_size", [(0, None), (5, 32)])
def test_collate_joint_and_pad_targets_match_jax(joint_files, seed, mask_size):
    mapped = _mapped(jcg, joint_files)
    mapped.insert(1, None)
    got = tcg.collate_joint(mapped, _tokenize, CLASS_NAMES, np.random.default_rng(seed),
                            max_instances=3, max_positives=3, max_groundings=2,
                            mask_size=mask_size)
    want = jcg.collate_joint(mapped, _tokenize, CLASS_NAMES, np.random.default_rng(seed),
                             max_instances=3, max_positives=3, max_groundings=2,
                             mask_size=mask_size)
    _assert_same(got, want)
    assert got["caption_valid"][0].all() and got["grounding_valid"][2].all()
    _assert_same(tpan.pad_targets(mapped, 6, mask_size), jpan.pad_targets(mapped, 6, mask_size))


def test_forward_seg_train_and_seg_step_match_jax(joint_files, monkeypatch):
    """``forward_seg_train`` with grounding tokens (the seg losses of every
    layer and the grounding BCE + dice) against JAX's, jitted, points pinned
    on both sides, within 1e-4 relative; ``make_xdecoder_train_step``'s
    loss_total is their sum and its gradient norm finite and > 0."""
    from cullavo_tpu.models.xdecoder import model as jmodel
    from cullavo_tpu_torch.checkpoint.from_jax import (xdecoder_params_from_numpy,
                                                       xdecoder_params_to_numpy)
    from cullavo_tpu_torch.models.xdecoder import model as tmodel
    from cullavo_tpu_torch.trainer.step import TrainState
    from cullavo_tpu_torch.trainer.xdecoder_step import make_xdecoder_train_step

    jcfg, tcfg = jmodel.tiny_xdecoder_config(), tmodel.tiny_xdecoder_config()
    rng = np.random.default_rng(12)
    params = jax.tree.map(lambda a: a + rng.normal(0, 0.02, a.shape).astype(np.float32),
                          xdecoder_params_to_numpy(tmodel.init_xdecoder_model_params(
                              tcfg, torch.Generator().manual_seed(1), "cpu")))
    mapped = _mapped(tcg, joint_files)[:2]
    batch = tcg.collate_joint(mapped, _tokenize, CLASS_NAMES, np.random.default_rng(4),
                              max_instances=4, max_groundings=2)
    batch["image"] = rng.normal(size=batch["image"].shape).astype(np.float32)
    targets = {k: batch[k] for k in ("classes", "masks", "boxes", "valid", "grounding_masks",
                                     "grounding_valid")}
    text = rng.normal(size=(7, 64)).astype(np.float32)
    gtok = rng.normal(size=(2, 2, 64)).astype(np.float32)
    Draws(21).pin_jax(monkeypatch)
    want = jax.jit(lambda p, im, t, e, g: jmodel.forward_seg_train(
        p, jcfg, im, t, e, jax.random.PRNGKey(0), grounding_tokens=g))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(batch["image"]),
        _tree(targets, jnp.asarray), jnp.asarray(text), jnp.asarray(gtok))
    Draws(21).pin_port(monkeypatch)
    got = tmodel.forward_seg_train(xdecoder_params_from_numpy(params, "cpu"), tcfg,
                                   _t(batch["image"]), _tree(targets, _t), _t(text), None,
                                   grounding_tokens=_t(gtok))
    assert set(got) == set(want) and len(got) == 22
    for k in want:
        _rel(got[k], want[k], tol=1e-4)
    Draws(21).pin_port(monkeypatch)
    tx = topt.xdecoder_optimizer(1e-4, 10)
    tp = xdecoder_params_from_numpy(params, "cpu")
    step = make_xdecoder_train_step(tcfg, tx)
    state, metrics = step(TrainState(tp, tx.init(tp), 0),
                          dict(_tree(targets, _t), image=_t(batch["image"]),
                               grounding_tokens=_t(gtok)), _t(text), None)
    _rel(metrics["loss_total"], sum(float(v) for v in want.values()), tol=1e-4)
    assert np.isfinite(float(metrics["grad_norm"])) and float(metrics["grad_norm"]) > 0
    assert state.step == 1


def test_class_embeddings_train_matches_jax(monkeypatch):
    """One random prompt template per class, drawn from the same numpy
    seed, through each package's text encoder (JAX's jitted): 1e-5."""
    from cullavo_tpu.models.xdecoder import text_encoder as jte
    from cullavo_tpu_torch import entry as tentry
    from cullavo_tpu_torch.checkpoint.from_jax import (xdecoder_params_from_numpy,
                                                       xdecoder_params_to_numpy)
    from cullavo_tpu_torch.models.xdecoder import model as tmodel
    from cullavo_tpu_torch.models.xdecoder import text_encoder as tte

    tcfg = tmodel.tiny_xdecoder_config()
    text = xdecoder_params_to_numpy(tmodel.init_xdecoder_model_params(
        tcfg, torch.Generator().manual_seed(2), "cpu"))["text"]
    tokenize = tentry._make_text_tokenize({}, tcfg.text)
    forward = jte.forward_language
    embed = jax.jit(lambda p, i, m: forward(p, tcfg.text, i, m, norm=True))
    monkeypatch.setattr(jte, "forward_language", lambda p, c, i, m, norm: embed(p, i, m))
    want = jte.class_embeddings_train(jax.tree.map(jnp.asarray, text), tcfg.text, tokenize,
                                      CLASS_NAMES, np.random.default_rng(5), add_background=True)
    got = tte.class_embeddings_train(xdecoder_params_from_numpy({"text": text}, "cpu")["text"],
                                     tcfg.text, tokenize, CLASS_NAMES, np.random.default_rng(5),
                                     add_background=True)
    assert got.shape == (len(CLASS_NAMES) + 1, tcfg.text.dim_lang)
    _close(got, want, atol=1e-5)
