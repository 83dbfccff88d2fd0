"""The torch port's X-Decoder eval path against the JAX package, on the CPU.

Two tiny models, one per configuration of the path: ``tiny_xdecoder_config()``
(FocalNet + FPN) and a tiny SAM-ViT + deformable encoder (the sizes of
``tests/test_xdecoder_import.py``).  The port's initializer draws each model
(its tree is held to JAX's), every leaf gets seeded numpy noise (so that
zero-initialized biases and relative position tables take part), and the
same numpy tree goes to JAX and through ``checkpoint.from_jax`` to the port.
JAX runs each stage jitted, once per model.  Everything runs in f32; module
outputs agree within atol 1e-4 + rtol 1e-4, the id maps of the inferences
exactly (the semantic map where the top-2 class scores differ by more than
1e-4).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cullavo_tpu.entry as jentry
import cullavo_tpu.models.from_config as jfc
import cullavo_tpu.models.xdecoder.decoder as jdec
import cullavo_tpu.models.xdecoder.deform_encoder as jdef
import cullavo_tpu.models.xdecoder.focalnet as jfocal
import cullavo_tpu.models.xdecoder.fpn as jfpn
import cullavo_tpu.models.xdecoder.model as jmodel
import cullavo_tpu.models.xdecoder.sam_vit as jsam
import cullavo_tpu.models.xdecoder.text_encoder as jte
import cullavo_tpu.pipelines.xdecoder_pipeline as jpipe
import cullavo_tpu_torch.entry as tentry
import cullavo_tpu_torch.models.from_config as tfc
import cullavo_tpu_torch.models.xdecoder.decoder as tdec
import cullavo_tpu_torch.models.xdecoder.deform_encoder as tdef
import cullavo_tpu_torch.models.xdecoder.focalnet as tfocal
import cullavo_tpu_torch.models.xdecoder.fpn as tfpn
import cullavo_tpu_torch.models.xdecoder.model as tmodel
import cullavo_tpu_torch.models.xdecoder.sam_vit as tsam
import cullavo_tpu_torch.models.xdecoder.text_encoder as tte
import cullavo_tpu_torch.pipelines.xdecoder_pipeline as tpipe
from cullavo_tpu_torch.checkpoint.from_jax import (xdecoder_params_from_numpy,
                                                   xdecoder_params_to_numpy)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the two tiny models, in both packages
# ---------------------------------------------------------------------------

def _jax_sam_deform_config():
    base = jmodel.tiny_xdecoder_config()
    return dataclasses.replace(
        base, backbone_name="vit", encoder_name="transformer_encoder_deform",
        backbone=jsam.SamVitConfig(img_size=256, patch_size=16, embed_dim=32, depth=2,
                                   num_heads=2, window_size=2, global_attn_indexes=(1,),
                                   out_dims=(8, 16, 32, 64)),
        fpn=jdef.DeformEncoderConfig(in_channels=(8, 16, 32, 64), conv_dim=64, mask_dim=32,
                                     num_layers=2, num_heads=4, num_points=2, ffn_dim=64,
                                     gn_groups=8))


_PORT_CLASSES = {"FocalNetConfig": tfocal.FocalNetConfig, "FPNConfig": tfpn.FPNConfig,
                 "SamVitConfig": tsam.SamVitConfig,
                 "DeformEncoderConfig": tdef.DeformEncoderConfig,
                 "XDecoderConfig": tdec.XDecoderConfig, "TextEncoderConfig": tte.TextEncoderConfig,
                 "CriterionConfig": tmodel.CriterionConfig}


def port_config(jcfg):
    """The port's config with the same fields as a JAX model config."""
    fields = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        if dataclasses.is_dataclass(v):
            v = _PORT_CLASSES[type(v).__name__](**dataclasses.asdict(v))
        fields[f.name] = v
    return tmodel.XDecoderModelConfig(**fields)


def _noisy_numpy(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a, np.float32)
                                   + rng.normal(0, 0.02, np.shape(a)).astype(np.float32)),
                        tree)


def _jit(fn, *args):
    """One jitted JAX call (a tiny model runs 4-5x faster jitted than op by op)."""
    return jax.jit(fn)(*args)


class Model:
    """One tiny model in both packages: the port's initializer (fast, and
    its tree is held to JAX's by ``test_init_tree_matches_jax``) plus seeded
    noise, as numpy; JAX's outputs at every stage on one batch of images."""

    def __init__(self, jcfg, seed):
        self.jcfg = jcfg
        self.tcfg = port_config(jcfg)
        init = tmodel.init_xdecoder_model_params(self.tcfg, torch.Generator().manual_seed(seed),
                                                 "cpu")
        self.np = _noisy_numpy(xdecoder_params_to_numpy(init), seed)
        self.jp = jax.tree.map(jnp.asarray, self.np)
        self.tp = xdecoder_params_from_numpy(self.np, "cpu")
        self.x, self.t_emb = _images(4), _class_embeds(self)
        self.feats = _jit(lambda p, im: jmodel._backbone_apply(p, jcfg, im),
                          self.jp["backbone"], self.x)
        self.enc = _jit(lambda p, f: jmodel._encoder_apply(p, jcfg, f), self.jp["fpn"],
                        self.feats)
        self.dec = _jit(lambda p, pyr, m, t, s: jdec.xdecoder_forward(
            p, jcfg.decoder, pyr, m, text_class_embeds=t, logit_scale=s, task="eval"),
            self.jp["decoder"], self.enc[2], self.enc[0], self.t_emb,
            self.jp["text"]["logit_scale"])
        self.eval = _jit(lambda p, im, t: jmodel.forward_eval(p, jcfg, im, t, out_size=(64, 96)),
                         self.jp, self.x, self.t_emb)


@pytest.fixture(scope="module")
def focal_model():
    return Model(jmodel.tiny_xdecoder_config(), 0)


@pytest.fixture(scope="module")
def sam_model():
    return Model(_jax_sam_deform_config(), 1)


@pytest.fixture(scope="module", params=["focal_fpn", "samvit_deform"])
def model(request, focal_model, sam_model):
    return focal_model if request.param == "focal_fpn" else sam_model


def _images(seed, B=2, H=64, W=96):
    return np.random.default_rng(seed).normal(size=(B, H, W, 3)).astype(np.float32)


def _class_embeds(model, seed=8):
    C = model.jcfg.num_classes + 1
    return np.random.default_rng(seed).normal(
        size=(C, model.jcfg.decoder.dim_proj)).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


# ---------------------------------------------------------------------------
# resize sites
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,src,dst", [
    ("bicubic", (16, 24), (8, 12)),      # the cross-attention mask (downscale)
    ("bicubic", (16, 24), (2, 3)),
    ("bicubic", (32, 32), (8, 8)),
    ("bicubic", (16, 24), (64, 96)),     # forward_eval's upsample
    ("bicubic", (32, 32), (128, 128)),
    ("bilinear", (16, 16), (8, 12)),     # the SAM position embedding (downscale)
    ("bilinear", (16, 16), (8, 8)),
    ("bilinear", (8, 12), (16, 24)),     # the deform encoder's upsample
    ("bilinear", (7, 5), (16, 16)),
    ("nearest", (2, 3), (4, 6)),         # the FPN's top-down path
    ("nearest", (3, 5), (7, 10)),
])
def test_resize_matches_jax_image_resize(method, src, dst):
    x = np.random.default_rng(5).normal(size=(2, 3) + src).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 3) + dst, method=method)
    got = tdec.resize(torch.from_numpy(x), dst, method)
    _close(got, want, atol=2e-6, rtol=0)


def test_sine_position_embedding_matches_jax():
    _close(tdec.sine_position_embedding(5, 7, 64), jdec.sine_position_embedding(5, 7, 64),
           atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_init_tree_matches_jax(model):
    """The port's initializer, through the bridge, gives JAX's tree: the
    same leaves at the same paths with the same shapes."""
    want = jax.eval_shape(lambda k: jmodel.init_xdecoder_model_params(model.jcfg, k),
                          jax.random.PRNGKey(0))
    got = jax.tree_util.tree_leaves_with_path(model.np)
    want = jax.tree_util.tree_leaves_with_path(want)
    assert [(jax.tree_util.keystr(k), np.shape(a)) for k, a in got] == \
        [(jax.tree_util.keystr(k), a.shape) for k, a in want]


@pytest.mark.parametrize("use_dw", [False, True])
def test_focalnet_forward_matches_jax(use_dw):
    jcfg = jfocal.FocalNetConfig(embed_dim=16, depths=(1, 2, 1, 1), focal_levels=(2, 3, 2, 2),
                                 focal_windows=(3, 3, 3, 3), use_dw=use_dw)
    tcfg = tfocal.FocalNetConfig(**dataclasses.asdict(jcfg))
    np_params = _noisy_numpy(xdecoder_params_to_numpy(
        tfocal.init_focalnet_params(tcfg, torch.Generator().manual_seed(2), "cpu")), 2)
    x = _images(3)
    want = _jit(lambda p, im: jfocal.focalnet_forward(p, jcfg, im),
                jax.tree.map(jnp.asarray, np_params), x)
    got = tfocal.focalnet_forward(xdecoder_params_from_numpy(np_params, "cpu"), tcfg, _nchw(x))
    assert sorted(got) == sorted(want) == ["res2", "res3", "res4", "res5"]
    for k in want:
        _close(got[k].permute(0, 2, 3, 1), want[k])


def test_backbones_match_jax(model):
    got = tmodel._backbone_apply(model.tp["backbone"], model.tcfg, _nchw(model.x))
    assert sorted(got) == sorted(model.feats)
    for k in model.feats:
        _close(got[k].permute(0, 2, 3, 1), model.feats[k])


def test_pixel_decoders_match_jax(model):
    """The FPN (focal) and the deformable encoder (SAM) on the same features."""
    jm, jt, jpyr = model.enc
    tm, tt, tpyr = tmodel._encoder_apply(model.tp["fpn"], model.tcfg,
                                         {k: _nchw(v) for k, v in model.feats.items()})
    _close(tm.permute(0, 2, 3, 1), jm)
    _close(tt.permute(0, 2, 3, 1), jt)
    assert len(tpyr) == len(jpyr) == 3
    for a, b in zip(tpyr, jpyr):
        _close(a.permute(0, 2, 3, 1), b)


def _tokenize(model):
    return jentry._make_text_tokenize({}, model.jcfg.text)


def test_text_encoder_matches_jax(focal_model):
    m = focal_model
    tok = _tokenize(m)
    ids, mask = tok(["a photo of a cat.", "there is a large dog in the scene", "x"])
    want = _jit(lambda p, i, k: jte.forward_language(p, m.jcfg.text, i, k), m.jp["text"], ids,
                mask)
    got = tte.forward_language(m.tp["text"], m.tcfg.text, torch.from_numpy(ids),
                               torch.from_numpy(mask))
    _close(got, want)
    # more classes than one chunk of the port's encoder
    names = ["person", "wall-other-merged", "sky-other", "dog"] * 5
    want = jte.class_embeddings_ensembled(m.jp["text"], m.jcfg.text, tok, names,
                                          add_background=True)
    got = tte.class_embeddings_ensembled(m.tp["text"], m.tcfg.text, tok, names,
                                         add_background=True)
    assert got.shape == (21, m.jcfg.text.dim_lang) and tte.CLASS_CHUNK < 21
    _close(got, want)
    tokp = tentry._make_text_tokenize({}, m.tcfg.text)
    for a, b in zip(tokp(["a photo of a cat."]), tok(["a photo of a cat."])):
        np.testing.assert_array_equal(a, b)


def test_xdecoder_decoder_matches_jax(model):
    """``xdecoder_forward(task="eval")`` on the same pyramid: every layer's
    predictions (the cross-attention masks in between agree, or the later
    layers would not)."""
    jm, _, jpyr = model.enc
    want = model.dec
    got = tdec.xdecoder_forward(model.tp["decoder"], model.tcfg.decoder,
                                [_nchw(p) for p in jpyr], _nchw(jm),
                                text_class_embeds=torch.from_numpy(model.t_emb),
                                logit_scale=model.tp["text"]["logit_scale"], task="eval")
    for key in ("pred_logits", "pred_masks", "pred_boxes", "pred_captions"):
        _close(got[key], want[key])
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == model.jcfg.decoder.dec_layers
    for a, b in zip(got["aux_outputs"], want["aux_outputs"]):
        _close(a["pred_masks"], b["pred_masks"])
    allowed = jdec.structured_self_attn_allowed(model.jcfg.decoder, False)
    np.testing.assert_array_equal(
        tdec.structured_self_attn_allowed(model.tcfg.decoder, False).numpy(), np.asarray(allowed))


def test_forward_eval_matches_jax(model):
    got = tmodel.forward_eval(model.tp, model.tcfg, torch.from_numpy(model.x),
                              torch.from_numpy(model.t_emb), out_size=(64, 96))
    for a, b in zip(got, model.eval):
        _close(a, b)


# ---------------------------------------------------------------------------
# inferences
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def eval_outputs(focal_model):
    """One image's class and upsampled mask logits (numpy, from JAX)."""
    cls, masks, _ = focal_model.eval
    # sharpen the logits: some queries pass the 0.8 threshold, and the
    # masks decide the winners of the panoptic map
    return np.array(cls[0]) * 20.0, np.array(masks[0]) * 20.0


def test_semantic_inference_matches_jax(eval_outputs):
    cls, masks = eval_outputs
    want = jmodel.semantic_inference(jnp.asarray(cls), jnp.asarray(masks))
    _close(tmodel.semantic_inference(torch.from_numpy(cls), torch.from_numpy(masks)), want,
           atol=1e-6, rtol=1e-5)
    got = tmodel.semantic_inference_argmax(torch.from_numpy(cls), torch.from_numpy(masks)).numpy()
    want_ids = np.asarray(jmodel.semantic_inference_argmax(jnp.asarray(cls), jnp.asarray(masks)))
    top2 = np.sort(np.asarray(want), axis=0)[-2:]
    decisive = (top2[1] - top2[0]) > 1e-4
    assert decisive.mean() > 0.9
    np.testing.assert_array_equal(got[decisive], want_ids[decisive])


@pytest.mark.parametrize("valid_hw", [None, (50, 70)])
def test_panoptic_inference_matches_jax(eval_outputs, valid_hw):
    cls, masks = eval_outputs
    want = jmodel.panoptic_inference_device(jnp.asarray(cls), jnp.asarray(masks), 0.8,
                                            valid_hw=None if valid_hw is None
                                            else jnp.asarray(valid_hw))
    got = tmodel.panoptic_inference_device(torch.from_numpy(cls), torch.from_numpy(masks), 0.8,
                                           valid_hw=valid_hw)
    assert np.asarray(want["keep"]).sum() >= 2
    for k in ("mask_ids", "winner_ok", "mask_area", "original_area", "labels", "keep"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    _close(got["scores"], want["scores"], atol=1e-6, rtol=0)
    thing_ids = {0, 2, 4}
    pan_t, seg_t = tmodel.panoptic_assemble_host({k: v.numpy() for k, v in got.items()},
                                                 thing_ids, 0.5)
    pan_j, seg_j = jmodel.panoptic_assemble_host(jax.tree.map(np.asarray, want), thing_ids, 0.5)
    np.testing.assert_array_equal(pan_t, pan_j)
    assert seg_t == seg_j and len(seg_t) >= 1


@pytest.mark.parametrize("valid_hw", [None, (40, 90)])
def test_instance_inference_matches_jax(eval_outputs, valid_hw):
    """Top-k order is compared as a set of (class, query) detections."""
    cls, masks = eval_outputs
    C = cls.shape[1] - 1
    want = jmodel.instance_inference_device(jnp.asarray(cls), jnp.asarray(masks), C, 40,
                                            valid_hw=None if valid_hw is None
                                            else jnp.asarray(valid_hw))
    got = tmodel.instance_inference_device(torch.from_numpy(cls), torch.from_numpy(masks), C, 40,
                                           valid_hw=valid_hw)
    assert got["mask_planes"].shape == want["mask_planes"].shape == (2, 64, 96)
    bits_t = tmodel.unpack_mask_planes(got["mask_planes"].numpy(), 40)
    bits_j = jmodel.unpack_mask_planes(np.asarray(want["mask_planes"]), 40)

    def detections(classes, scores, bits):
        return sorted((int(c), round(float(s), 5), b.tobytes())
                      for c, s, b in zip(np.asarray(classes), np.asarray(scores), bits))

    assert detections(got["classes"].numpy(), got["scores"].numpy(), bits_t) == \
        detections(want["classes"], want["scores"], bits_j)
    plain_t = tmodel.instance_inference(torch.from_numpy(cls), torch.from_numpy(masks), C, 40)
    plain_j = jmodel.instance_inference(jnp.asarray(cls), jnp.asarray(masks), C, 40)
    _close(np.sort(plain_t["scores"].numpy()), np.sort(np.asarray(plain_j["scores"])),
           atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the pipeline end to end
# ---------------------------------------------------------------------------

def _rows(C, seed):
    """Normalized images of mixed sizes (two buckets, a padded batch tail)
    with synthetic semantic, panoptic and instance ground truth."""
    rng = np.random.default_rng(seed)
    rows = []
    for i, (h, w) in enumerate([(100, 120), (128, 96), (90, 128), (130, 70)]):
        sem = rng.integers(0, C, (h, w)).astype(np.int64)
        pan = (sem // 2 + 1).astype(np.int32)
        segs = [{"id": int(s), "category_id": int(2 * (s - 1))} for s in np.unique(pan)]
        inst = {"masks": np.stack([sem == 0, sem == 2]), "classes": np.asarray([0, 2])}
        rows.append({"image": rng.normal(size=(h, w, 3)).astype(np.float32), "image_id": i,
                     "sem_seg": sem, "pan_seg_gt": pan, "segments_gt": segs,
                     "instances_gt": inst})
    return rows


def test_pipeline_evaluate_model_matches_jax(model):
    jcfg = dataclasses.replace(model.jcfg, object_mask_threshold=0.25, overlap_threshold=0.5)
    tcfg = dataclasses.replace(model.tcfg, object_mask_threshold=0.25, overlap_threshold=0.5)
    t_emb = _class_embeds(model, 12) * 6.0
    rows = _rows(jcfg.num_classes, 13)
    tasks = dict(semantic=True, instance=True, panoptic=True)
    thing = frozenset({0, 2})
    want = jpipe.XDecoderPipeline(None, jcfg, model.jp, jnp.asarray(t_emb),
                                  tasks=jpipe.EvalTasks(**tasks), eval_batch=2).evaluate_model(
        rows, thing_ids=thing)
    got = tpipe.XDecoderPipeline(None, tcfg, model.tp, torch.from_numpy(t_emb),
                                 tasks=tpipe.EvalTasks(**tasks), eval_batch=2).evaluate_model(
        rows, thing_ids=thing)
    assert set(got) == set(want)
    assert got["sem_seg"] == pytest.approx(want["sem_seg"], abs=1e-9)
    for a, b in zip(got["panoptic_outputs"], want["panoptic_outputs"]):
        assert a["image_id"] == b["image_id"] and a["segments"] == b["segments"]
        np.testing.assert_array_equal(a["panoptic"], b["panoptic"])
    assert sum(len(o["segments"]) for o in got["panoptic_outputs"]) >= 1
    if "panoptic" in want:
        assert got["panoptic"] == pytest.approx(want["panoptic"], abs=1e-9)
    for a, b in zip(got["instance_outputs"], want["instance_outputs"]):
        order_a = np.lexsort((np.round(a["scores"], 5), a["classes"]))
        order_b = np.lexsort((np.round(b["scores"], 5), b["classes"]))
        np.testing.assert_array_equal(a["classes"][order_a], b["classes"][order_b])
        _close(a["scores"][order_a], b["scores"][order_b], atol=1e-5, rtol=0)
        np.testing.assert_array_equal(a["masks"][order_a], b["masks"][order_b])
    assert got["instance_ap"] == pytest.approx(want["instance_ap"], abs=1e-6)
    assert got["timing"]["eval_batch"] == 2 and got["timing"]["compute_s"] > 0


def test_tasks_for_dataset_matches_jax():
    for name in ("coco_2017_val_panoptic_with_sem_seg", "ade20k_full_sem_seg_val",
                 "cityscapes_fine_instance_seg_val", "seginw_x_val", "vlp_val",
                 "scannet_21_panoptic_val"):
        assert dataclasses.asdict(tpipe.tasks_for_dataset(name)) == \
            dataclasses.asdict(jpipe.tasks_for_dataset(name))
    with pytest.raises(ValueError):
        tpipe.tasks_for_dataset("no_such_set")
    assert tpipe._bucket_hw(480, 640) == jpipe._bucket_hw(480, 640) == (512, 640)
    assert tpipe.tasks_for_dataset("no_such_set", default=tpipe.EvalTasks()) == tpipe.EvalTasks()


# ---------------------------------------------------------------------------
# the weight bridge, the configs, the entry point
# ---------------------------------------------------------------------------

def test_weight_bridge_round_trip(model):
    back = xdecoder_params_to_numpy(model.tp)
    flat_a = jax.tree_util.tree_leaves_with_path(model.np)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [jax.tree_util.keystr(k) for k, _ in flat_a] == \
        [jax.tree_util.keystr(k) for k, _ in flat_b]
    for (k, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape, jax.tree_util.keystr(k)
        np.testing.assert_array_equal(a, b)


def _yaml(path):
    import yaml

    with open(os.path.join(REPO, path)) as f:
        return yaml.safe_load(f)


CONFIGS = ["configs/xdecoder_test.yaml", "configs/xdecoder_train.yaml"] + sorted(
    os.path.join("configs/xdecoder", n) for n in os.listdir(os.path.join(REPO, "configs/xdecoder")))


def _plain(cfg):
    if dataclasses.is_dataclass(cfg):
        return {"__class__": type(cfg).__name__,
                **{f.name: _plain(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}}
    if isinstance(cfg, (list, tuple)):
        return [_plain(v) for v in cfg]
    return cfg


@pytest.mark.parametrize("path", CONFIGS)
def test_from_config_matches_jax(path):
    cfg = _yaml(path)
    assert _plain(tfc.xdecoder_model_config_from(cfg)) == \
        _plain(jfc.xdecoder_model_config_from(cfg))


def test_focal_configs_load_with_the_jax_readers_defaults():
    """The reader takes FocalNet keys under MODEL.BACKBONE.FOCAL, the repo's
    focal configs put them under MODEL.BACKBONE: FocalNet-T configs load
    FocalNet-L's widths in both packages (a JAX fault the port keeps for
    parity; ROADMAP queue 3)."""
    cfg = _yaml("configs/xdecoder/xdecoder_focalt_lang.yaml")
    assert cfg["MODEL"]["BACKBONE"]["EMBED_DIM"] == 96
    bb = tfc.xdecoder_model_config_from(cfg).backbone
    assert (bb.embed_dim, tuple(bb.depths), tuple(bb.focal_levels)) == (192, (2, 2, 18, 2),
                                                                        (4, 4, 4, 4))
    assert bb.use_dw


def test_entry_evaluate_on_cpu():
    cfg = {"NAME": "xdecoder_test", "PIPELINE": "XDecoderPipeline", "MODEL": {"TINY": True},
           "DATASETS": {"TEST": None}}
    assert tentry.evaluate(cfg, device="cpu") == {}
    # an unregistered dataset, a missing checkpoint and a missing tokenizer raise
    with pytest.raises(KeyError, match="not registered"):
        tentry.evaluate({**cfg, "DATASETS": {"TEST": ["coco_2017_val_panoptic_with_sem_seg"]}},
                        device="cpu")
    with pytest.raises(FileNotFoundError):
        tentry.evaluate({**cfg, "RESUME_FROM": "x.pt"}, device="cpu")
    with pytest.raises(FileNotFoundError, match="vocab.json"):
        tentry.evaluate({**cfg, "MODEL": {"TINY": True, "TEXT": {"TOKENIZER": "/x"}}},
                        device="cpu")
    assert tentry.evaluate({"NAME": "vl_test"}, device="cpu") == {}   # no DATASETS.TEST
    # step2_pre runs (no DATASETS.TEST: no rows, as in JAX); ImageNet waits for its slice
    assert tentry.evaluate({"NAME": "cullavo_step2_pre"}, device="cpu") == {"rows": 0}
    with pytest.raises(NotImplementedError):
        tentry.evaluate({"NAME": "imagenet_test"}, device="cpu")
    with pytest.raises(SystemExit):
        tentry.evaluate({"NAME": "nothing"}, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tentry.evaluate(cfg)


def test_chip_smoke_config_dicts_equal_the_yaml_files():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for path, cfg in smoke.XDEC_CONFIGS.items():
        assert cfg == _yaml(path), path
