"""The X-Decoder eval from a checkpoint, port against the JAX package on the
CPU: the reference-layout import (bit for bit against the JAX importer
through ``checkpoint.from_jax``, its inverse, the strict align), the HF
CLIP text import, ``evaluate_grounding`` and ``RefCOCOPipeline``, the
dataset loaders and eval mappers of the semseg / refcoco / bulk kinds, and
``entry.main`` (``eval --conf_files configs/xdecoder_test.yaml`` at a tiny
width under ``MODEL.BACKBONE.FOCAL``) against JAX's ``entry.evaluate``
with ``RESUME_FROM`` a written ``.pt`` (``.npz`` and a store directory
equal to it), ``MODEL.TEXT.TOKENIZER`` a written CLIP vocabulary and three
registered datasets.

JAX's eval programs are jitted once for the module (one cache keyed by the
model config, the tasks and the bucket) and share one image bucket (128 x
128), one batch (3) and one task set with the pipeline tests.  Tolerances:
module outputs within atol 1e-4 + rtol 1e-4 in f32; metric dicts within
1e-6 (in percent; they agree exactly on this data).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cullavo_tpu.checkpoint.xdecoder_import as jimp
import cullavo_tpu.config as jconfig
import cullavo_tpu.data.datasets as jds
import cullavo_tpu.data.mappers.eval_mappers as jmap
import cullavo_tpu.data.registry as jreg
import cullavo_tpu.entry as jentry
import cullavo_tpu.models.from_config as jfc
import cullavo_tpu.models.xdecoder.davit as jdavit
import cullavo_tpu.models.xdecoder.model as jmodel
import cullavo_tpu.models.xdecoder.text_encoder as jte
import cullavo_tpu.pipelines.xdecoder_pipeline as jpipe
import cullavo_tpu_torch.checkpoint.xdecoder_import as timp
import cullavo_tpu_torch.data.datasets as tds
import cullavo_tpu_torch.data.mappers.eval_mappers as tmap
import cullavo_tpu_torch.data.registry as treg
import cullavo_tpu_torch.data.vlp_datasets as tvlp
import cullavo_tpu_torch.entry as tentry
import cullavo_tpu_torch.models.from_config as tfc
import cullavo_tpu_torch.models.xdecoder.davit as tdavit
import cullavo_tpu_torch.models.xdecoder.model as tmodel
import cullavo_tpu_torch.models.xdecoder.text_encoder as tte
import cullavo_tpu_torch.pipelines.xdecoder_pipeline as tpipe
from cullavo_tpu_torch.checkpoint.from_jax import (xdecoder_params_from_numpy,
                                                   xdecoder_params_to_numpy)
from cullavo_tpu_torch.checkpoint.store import save_checkpoint
from cullavo_tpu_torch.data import png_io
from test_torch_joint_data import chip_smoke
from test_torch_xdecoder import _jax_sam_deform_config, _noisy_numpy, port_config
from test_xdecoder_import import (_davit_state, _deform_state, _samvit_state,
                                  _synthetic_reference_state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-4, rtol=1e-4)
CLASSES = ["person", "car", "dog", "wall", "sky", "grass"]
N_THINGS = 3
SIZES = [(96, 128), (128, 112), (120, 100), (128, 128)]   # one bucket: 128 x 128
BATCH = 3
# configs/xdecoder_test.yaml at a tiny width: the FocalNet keys under
# MODEL.BACKBONE.FOCAL, where both readers take them
TINY = {"MODEL": {"BACKBONE": {"FOCAL": {"EMBED_DIM": 16, "DEPTHS": [1, 1, 1, 1],
                                         "FOCAL_LEVELS": [2, 2, 2, 2],
                                         "FOCAL_WINDOWS": [3, 3, 3, 3]}},
                  "ENCODER": {"CONVS_DIM": 64, "MASK_DIM": 32, "NUM_CLASSES": len(CLASSES),
                              "TRANSFORMER_ENC_LAYERS": 1},
                  "DECODER": {"HIDDEN_DIM": 64, "NUM_OBJECT_QUERIES": 9, "NHEADS": 4,
                              "DIM_FEEDFORWARD": 128, "DEC_LAYERS": 3},
                  "TEXT": {"WIDTH": 32, "HEADS": 4, "LAYERS": 2, "CONTEXT_LENGTH": 16},
                  "DIM_PROJ": 64},
        "EVAL_BATCH": BATCH}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_registries(monkeypatch):
    """Each test registers into empty registries of both packages."""
    for reg in (jreg, treg):
        monkeypatch.setattr(reg, "_DATASETS", {})
        monkeypatch.setattr(reg, "_METADATA", {})


_JAX_FNS: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _shared_jax_programs():
    """JAX's pipelines jit per instance; here one program per (model config,
    tasks, bucket) serves every pipeline of the module."""
    x_fn, r_fn = jpipe.XDecoderPipeline._fn_for, jpipe.RefCOCOPipeline._fn_for

    def xdec(self, out_size):
        key = ("x", self.model_cfg, dataclasses.astuple(self.tasks), out_size)
        if key not in _JAX_FNS:
            _JAX_FNS[key] = x_fn(self, out_size)
        return _JAX_FNS[key]

    def ref(self, out_size):
        key = ("r", self.model_cfg, out_size)
        if key not in _JAX_FNS:
            _JAX_FNS[key] = r_fn(self, out_size)
        return _JAX_FNS[key]

    jpipe.XDecoderPipeline._fn_for, jpipe.RefCOCOPipeline._fn_for = xdec, ref
    yield
    jpipe.XDecoderPipeline._fn_for, jpipe.RefCOCOPipeline._fn_for = x_fn, r_fn


def _flat(tree):
    return timp._flatten(tree)


def _assert_trees_equal(got, want):
    fg, fw = _flat(got), _flat(want)
    assert fg.keys() == fw.keys(), sorted(set(fg) ^ set(fw))[:6]
    for k in fw:
        a, b = torch.as_tensor(np.array(fg[k])), torch.as_tensor(np.array(fw[k]))
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b), k


# ---------------------------------------------------------------------------
# the reference-layout import
# ---------------------------------------------------------------------------

def _hf_clip_text_state(W=32, L=2, V=99, P=77, proj=24, seed=3):
    """An HF ``CLIPModel`` state dict of random numpy arrays, by key name."""
    rng = np.random.default_rng(seed)
    sd = {"text_model.embeddings.token_embedding.weight": (V, W),
          "text_model.embeddings.position_embedding.weight": (P, W),
          "text_model.final_layer_norm.weight": (W,), "text_model.final_layer_norm.bias": (W,),
          "text_projection.weight": (proj, W), "logit_scale": ()}
    for i in range(L):
        b = f"text_model.encoder.layers.{i}."
        for n in ("q", "k", "v", "out"):
            sd[f"{b}self_attn.{n}_proj.weight"], sd[f"{b}self_attn.{n}_proj.bias"] = (W, W), (W,)
        for n in ("layer_norm1", "layer_norm2"):
            sd[f"{b}{n}.weight"], sd[f"{b}{n}.bias"] = (W,), (W,)
        sd[f"{b}mlp.fc1.weight"], sd[f"{b}mlp.fc1.bias"] = (2 * W, W), (2 * W,)
        sd[f"{b}mlp.fc2.weight"], sd[f"{b}mlp.fc2.bias"] = (W, 2 * W), (W,)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in sd.items()}


# ---------------------------------------------------------------------------
# the tiny model of the module, grounding and RefCOCOPipeline
# ---------------------------------------------------------------------------

class Tiny:
    """TINY's model in both packages: the port's initializer plus seeded
    noise (JAX layout, numpy), and its reference-layout state."""

    def __init__(self):
        self.jcfg = jfc.xdecoder_model_config_from(TINY)
        self.tcfg = tfc.xdecoder_model_config_from(TINY)
        init = tmodel.init_xdecoder_model_params(self.tcfg, torch.Generator().manual_seed(5),
                                                 "cpu")
        self.np = _noisy_numpy(xdecoder_params_to_numpy(init), 5)
        self.jp = jax.tree.map(jnp.asarray, self.np)
        self.tp = xdecoder_params_from_numpy(self.np, "cpu")
        self.state = timp.reference_state_from_params(self.tp, self.tcfg)


@pytest.fixture(scope="module")
def tiny():
    return Tiny()


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clip_vocab"))
    corpus = ([t.format(c) for c in CLASSES for t in tte.get_prompt_templates()]
              + [f"the {c} on the left" for c in CLASSES])
    chip_smoke().write_clip_tokenizer(path, corpus, n_ids=2048)
    return path


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """The three datasets as files, and their DATASETS.REGISTER entries."""
    root = tmp_path_factory.mktemp("xeval_data")
    cs = chip_smoke()
    # both seg datasets with all three tasks: one JAX program serves them
    sem = dict(cs.write_semseg_dataset(str(root / "semseg"), SIZES, CLASSES, seed=1),
               TASKS={"SEMANTIC": True, "PANOPTIC": True, "INSTANCE": True, "GROUNDING": True})
    pan = cs.write_joint_dataset(str(root / "panoptic"), SIZES, CLASSES, N_THINGS, seed=2)
    pan = {"KIND": "coco_panoptic", "JSON": pan["JSON"], "IMAGE_DIR": pan["IMAGE_DIR"],
           "PANOPTIC_DIR": pan["PANOPTIC_DIR"], "NUM_CLASSES": len(CLASSES),
           "CLASS_NAMES": CLASSES, "TASKS": ["semantic", "panoptic", "instance"]}
    ref = cs.write_refcoco_dataset(str(root / "refcoco"), SIZES, CLASSES, seed=3)
    return {"xeval_semseg": sem, "xeval_coco_panoptic": pan, "xeval_refcoco": ref}


def _ref_rows(spec):
    recs = jds.load_refcoco(spec["REFS_JSON"], spec["INSTANCES_JSON"], spec["IMAGE_DIR"])
    return [jmap.RefCOCOEvalMapper()(r) for r in recs]


def test_import_matches_jax_bit_for_bit():
    """FocalNet + FPN + decoder + text encoder (the JAX tests' synthetic
    state, no input_proj keys: the identity), SAM-ViT and the deformable
    encoder module by module, and the HF CLIP text import."""
    jcfg = jmodel.tiny_xdecoder_config()
    tcfg = port_config(jcfg)
    sd = _synthetic_reference_state(jcfg)
    want = xdecoder_params_from_numpy(
        jax.tree.map(np.asarray, jimp.import_xdecoder_checkpoint(sd, jcfg)), "cpu")
    target = tmodel.init_xdecoder_model_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    got = timp.align_and_update(target, timp.import_xdecoder_checkpoint(sd, tcfg))
    _assert_trees_equal(got, want)
    assert timp.unused_keys(sd, tcfg) == []

    scfg, tcfg = _jax_sam_deform_config(), port_config(_jax_sam_deform_config())
    for jfn, tfn, sub_j, sub_t, state in (
            (jimp.import_sam_vit, timp.import_sam_vit, scfg.backbone, tcfg.backbone,
             _samvit_state(scfg.backbone)),
            (jimp.import_deform_encoder, timp.import_deform_encoder, scfg.fpn, tcfg.fpn,
             _deform_state(scfg.fpn))):
        want = xdecoder_params_from_numpy(jax.tree.map(np.asarray, jfn(state, sub_j)), "cpu")
        _assert_trees_equal(tfn(state, sub_t), want)

    # import_hf_clip_text: JAX's own test holds its import to transformers'
    # CLIP text model; the port's equals JAX's leaf for leaf, with and
    # without logit_scale
    jcfg = jte.clip_text_config(width=32, heads=4, layers=2, dim_lang=24)
    tcfg = tte.clip_text_config(width=32, heads=4, layers=2, dim_lang=24)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    state = _hf_clip_text_state()
    for sd in (state, {k: v for k, v in state.items() if k != "logit_scale"}):
        got = tte.import_hf_clip_text(sd, tcfg)
        _assert_trees_equal(got, jax.tree.map(np.asarray, jte.import_hf_clip_text(sd, jcfg)))
    ids = np.random.default_rng(4).integers(1, 90, size=(3, 9)).astype(np.int64)
    ids[:, -1] = 98
    want = jte.forward_language(jte.import_hf_clip_text(state, jcfg), jcfg, jnp.asarray(ids),
                                jnp.ones((3, 9)))
    out = tte.forward_language(tte.import_hf_clip_text(state, tcfg), tcfg, torch.tensor(ids),
                               torch.ones(3, 9))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


def test_reference_state_round_trips():
    """FocalNet + FPN and SAM-ViT + the deformable encoder: the written
    state holds every key of the table and reads back bit-equal through
    both packages' importers."""
    for jcfg in (jmodel.tiny_xdecoder_config(), _jax_sam_deform_config()):
        tcfg = port_config(jcfg)
        init = tmodel.init_xdecoder_model_params(tcfg, torch.Generator().manual_seed(3), "cpu")
        params = xdecoder_params_from_numpy(_noisy_numpy(xdecoder_params_to_numpy(init), 3), "cpu")
        state = {k: v.numpy() for k, v in timp.reference_state_from_params(params, tcfg).items()}
        assert set(state) == {e.key for e in timp.reference_table(tcfg)}
        _assert_trees_equal(timp.align_and_update(init, timp.import_xdecoder_checkpoint(state, tcfg)),
                            params)
        jback = jimp.import_xdecoder_checkpoint(state, jcfg)
        _assert_trees_equal(xdecoder_params_from_numpy(jax.tree.map(np.asarray, jback), "cpu"),
                            params)


def test_missing_extra_and_misshapen_leaves_raise():
    jcfg = jmodel.tiny_xdecoder_config()
    tcfg = port_config(jcfg)
    sd = _synthetic_reference_state(jcfg)
    target = tmodel.init_xdecoder_model_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    for key in ("backbone.layers.2.blocks.0.modulation.f.weight",
                "sem_seg_head.predictor.lang_encoder.logit_scale"):
        with pytest.raises(KeyError, match=key.replace(".", r"\.")):
            timp.import_xdecoder_checkpoint({k: v for k, v in sd.items() if k != key}, tcfg)
    # the documented defaults: GroupNorm-conv biases, backbone_proj
    no_bias = {k: v for k, v in sd.items() if k != "sem_seg_head.pixel_decoder.layer_1.bias"}
    loaded = timp.import_xdecoder_checkpoint(no_bias, tcfg)
    assert not loaded["fpn"]["output_convs"][3]["bias"].any()
    assert not loaded["backbone_proj"].any()
    # a checkpoint of wider FocalNet stages under the tiny widths
    wide_j = dataclasses.replace(jcfg, backbone=dataclasses.replace(jcfg.backbone, embed_dim=24))
    wide = _synthetic_reference_state(wide_j)
    with pytest.raises(ValueError, match=r"shape .*'backbone', 'stem', 'kernel'"):
        timp.align_and_update(target, timp.import_xdecoder_checkpoint(wide, tcfg))
    extra = timp.import_xdecoder_checkpoint(sd, tcfg)
    extra["decoder"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="not in the model 1"):
        timp.align_and_update(target, extra)
    del extra["decoder"]["stray"], extra["decoder"]["query_feat"]
    with pytest.raises(ValueError, match="missing 1"):
        timp.align_and_update(target, extra)
    assert timp.unused_keys({**sd, "criterion.empty_weight": np.ones(7)}, tcfg) == [
        "criterion.empty_weight"]
    # DaViT (the JAX tests' small configuration): bit-equal to JAX's import
    dcfg = jdavit.DaViTConfig(embed_dims=(8, 16, 32, 64), num_heads=(2, 2, 4, 4),
                              num_groups=(2, 2, 4, 4), depths=(1, 1, 1, 1), window_size=4)
    dstate = _davit_state(dcfg)
    _assert_trees_equal(timp.import_davit(dstate, tdavit.DaViTConfig(**dataclasses.asdict(dcfg))),
                        xdecoder_params_from_numpy(jax.tree.map(
                            np.asarray, jimp.import_davit(dstate, dcfg)), "cpu"))


def test_evaluate_grounding_matches_jax(tiny, vocab, data_root):
    rows = _ref_rows(data_root["xeval_refcoco"])[:BATCH]
    tokenize = tentry._make_text_tokenize({"MODEL": {"TEXT": {"TOKENIZER": vocab}}},
                                          tiny.tcfg.text)
    ids, mask = tokenize([r["text"] for r in rows])
    img = np.zeros((BATCH, 128, 128, 3), np.float32)
    for j, r in enumerate(rows):
        img[j, :r["image"].shape[0], :r["image"].shape[1]] = r["image"]
    pipe = jpipe.RefCOCOPipeline(None, tiny.jcfg, tiny.jp, None)
    want = np.asarray(pipe._fn_for((128, 128))(tiny.jp, jnp.asarray(img), jnp.asarray(ids),
                                               jnp.asarray(mask)))
    with torch.inference_mode():
        got = tmodel.evaluate_grounding(tiny.tp, tiny.tcfg, torch.from_numpy(img), ids, mask,
                                        out_size=(128, 128))
        small = tmodel.evaluate_grounding(tiny.tp, tiny.tcfg, torch.from_numpy(img),
                                          ids[:, None], mask[:, None])
    assert got.shape == (BATCH, 128, 128) and small.shape == (BATCH, 32, 32)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _close_metrics(got: dict, want: dict, abs_tol: float):
    assert set(got) - {"timing"} == set(want) - {"timing"}
    for k in want:
        if k != "timing":
            assert got[k] == pytest.approx(want[k], abs=abs_tol), k


@pytest.fixture(scope="module")
def jax_refcoco(tiny, vocab, data_root, tmp_path_factory):
    """JAX's RefCOCOPipeline at batch 3 (its metrics are per row: the batch
    does not change them), and the CSV it writes."""
    out = tmp_path_factory.mktemp("jax_refcoco")
    tk = jentry._make_text_tokenize({"MODEL": {"TEXT": {"TOKENIZER": vocab}}}, tiny.jcfg.text)
    res = jpipe.RefCOCOPipeline(None, tiny.jcfg, tiny.jp, tk, eval_batch=BATCH).evaluate_model(
        _ref_rows(data_root["xeval_refcoco"]), out_dir=str(out))
    return res, (out / "ref_coco.csv").read_text().splitlines()


def test_refcoco_pipeline_matches_jax(tiny, vocab, data_root, jax_refcoco, tmp_path):
    """Batches of 1 and 3 on mixed image sizes: JAX's metrics and CSV."""
    rows = _ref_rows(data_root["xeval_refcoco"])
    assert len({r["image"].shape for r in rows}) > 1
    want, csv_want = jax_refcoco
    tk = tentry._make_text_tokenize({"MODEL": {"TEXT": {"TOKENIZER": vocab}}}, tiny.tcfg.text)
    for batch in (1, BATCH):
        pipe = tpipe.RefCOCOPipeline(None, tiny.tcfg, tiny.tp, tk, eval_batch=batch)
        got = pipe.evaluate_model(rows, out_dir=str(tmp_path / str(batch)))
        _close_metrics(got, want, 1e-6)
        assert got["timing"]["eval_batch"] == batch and got["timing"]["compute_s"] > 0
        assert set(pipe.per_class) == {r["category"] for r in rows}
        assert (tmp_path / str(batch) / "ref_coco.csv").read_text().splitlines() == csv_want


# ---------------------------------------------------------------------------
# datasets and mappers
# ---------------------------------------------------------------------------

def test_loaders_and_mappers_match_jax(data_root):
    ref = data_root["xeval_refcoco"]
    args = (ref["REFS_JSON"], ref["INSTANCES_JSON"], ref["IMAGE_DIR"])
    assert tds.load_refcoco(*args) == jds.load_refcoco(*args)
    assert tds.load_refcoco(*args, split="train") == jds.load_refcoco(*args, split="train")
    sem = data_root["xeval_semseg"]
    recs = tds.load_semseg_pairs(sem["IMAGE_DIR"], sem["ANN_DIR"])
    assert recs == jds.load_semseg_pairs(sem["IMAGE_DIR"], sem["ANN_DIR"]) and len(recs) == 4
    pan = data_root["xeval_coco_panoptic"]
    from cullavo_tpu.data.coco_panoptic import load_coco_panoptic_json as jload
    from cullavo_tpu_torch.data.coco_panoptic import load_coco_panoptic_json as tload
    pan_recs = tload(pan["JSON"], pan["IMAGE_DIR"], pan["PANOPTIC_DIR"], {})
    for mappers, records in (((tmap.SemSegEvalMapper(), jmap.SemSegEvalMapper()), recs),
                             ((tmap.PanopticEvalMapper(), jmap.PanopticEvalMapper()), pan_recs),
                             ((tmap.RefCOCOEvalMapper(), jmap.RefCOCOEvalMapper()),
                              tds.load_refcoco(*args))):
        for rec in records:
            got, want = mappers[0](rec), mappers[1](rec)
            assert got.keys() == want.keys()
            for k in want:
                if isinstance(want[k], np.ndarray):
                    assert got[k].dtype == want[k].dtype, k
                    np.testing.assert_array_equal(got[k], want[k])
                elif isinstance(want[k], dict):
                    for kk in want[k]:
                        np.testing.assert_array_equal(got[k][kk], want[k][kk])
                else:
                    assert got[k] == want[k], k


def _bulk_root(root):
    """A tiny file tree of every family of the bulk table."""
    def png(path, arr):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        png_io.write_png(path, arr)

    def text(path, body):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(body)

    img, lab = np.zeros((4, 6, 3), np.uint8), np.zeros((4, 6), np.uint8)
    pan = json.dumps({"annotations": [{"image_id": 7, "file_name": "im7.png", "segments_info": [
        {"id": 1, "category_id": 3, "iscrowd": 0}]}],
        "categories": [{"id": 3, "name": "road", "isthing": 0}]})
    s = os.path.join(root, "scannet_frames_25k")
    text(os.path.join(s, "meta", "val.txt"), "scene0/color/000000.jpg\nscene0/color/000100.jpg\n")
    text(os.path.join(s, "scannet_panoptic.json"), pan)
    for d in ("sun_rgbd/image/val", "bdd100k/images/10k/val", "coco/coco_stuff_10k/"
              "images_detectron2/train", "coco/coco_stuff_10k/images_detectron2/test",
              "ADE20K_2021_17_01/images_detectron2/val"):
        png(os.path.join(root, d, "a.jpg"), img)
    for d in ("sun_rgbd/label37/val", "bdd100k/labels/sem_seg/masks/val",
              "coco/coco_stuff_10k/annotations_detectron2/train",
              "coco/coco_stuff_10k/annotations_detectron2/test"):
        png(os.path.join(root, d, "a.png"), lab)
    png(os.path.join(root, "ADE20K_2021_17_01/annotations_detectron2/val/a.tif"), lab)
    text(os.path.join(root, "bdd100k/labels/pan_seg/meta_pan.json"), pan)
    ade = os.path.join(root, "ADEChallengeData2016")
    text(os.path.join(ade, "ade20k_panoptic_val.json"), pan)
    text(os.path.join(ade, "ade20k_instance_val.json"), json.dumps({
        "images": [{"id": 1, "file_name": "x.jpg", "height": 4, "width": 6}],
        "annotations": [{"image_id": 1, "bbox": [0, 0, 2, 2], "category_id": 5,
                         "segmentation": [[0, 0, 2, 0, 2, 2]], "iscrowd": 0}],
        "categories": [{"id": 5}, {"id": 2}]}))
    text(os.path.join(root, "PascalVOC/ImageSets/Segmentation/val.txt"), "2007_000032\n")


def test_bulk_registration_records_match_jax(tmp_path, capsys):
    root = str(tmp_path / "root")
    _bulk_root(root)
    names = tds.register_all_segmentation(root)
    jds.register_all_segmentation(root)
    assert sorted(names) == sorted(jreg._DATASETS) and len(names) == 13
    for name in names:
        assert treg.get_dataset(name) == jreg.get_dataset(name), name
        md = treg.get_metadata(name)
        if "class_names_key" in md:   # the JAX table names a key it lacks for ScanNet-20
            assert tentry._resolve_class_names(name, md)
    assert tds.register_all_segmentation(root) == []   # a second call leaves them
    # an absent family is skipped with one line; a present, incomplete one raises
    monkey_root = str(tmp_path / "partial")
    os.makedirs(os.path.join(monkey_root, "PascalVOC"))
    treg._DATASETS.clear()
    with pytest.raises(FileNotFoundError, match="pascalvoc_interactive"):
        tds.register_all_segmentation(monkey_root)
    os.makedirs(os.path.join(monkey_root, "PascalVOC/ImageSets/Segmentation"))
    with open(os.path.join(monkey_root, "PascalVOC/ImageSets/Segmentation/val.txt"), "w") as f:
        f.write("x\n")
    capsys.readouterr()
    assert tds.register_all_segmentation(monkey_root) == ["pascalvoc_val_Point"]
    assert capsys.readouterr().err.count("not registered") == 9
    # a vlp directory registers the VLP Arrow splits (read when first asked for)
    os.makedirs(os.path.join(monkey_root, "vlp"))
    treg._DATASETS.clear()
    treg._METADATA.clear()
    assert tds.register_all_segmentation(monkey_root) == ["pascalvoc_val_Point"] + list(
        tvlp.PREDEFINED_SPLITS)
    assert treg.get_metadata("vlp_captioning_val")["evaluator_type"] == "captioning"


# ---------------------------------------------------------------------------
# the entry point end to end
# ---------------------------------------------------------------------------

def _argv(overrides: dict, *pairs):
    return ["eval", "--conf_files", os.path.join(REPO, "configs/xdecoder_test.yaml"),
            "--config_overrides", json.dumps(overrides), "--overrides", *pairs]


def _check_results(got: dict, want: dict):
    assert set(got) == set(want)
    for name in want:
        for key in set(want[name]) - {"timing"}:
            if isinstance(want[name][key], dict):
                _close_metrics(got[name][key], want[name][key], 1e-6)
            else:
                assert got[name][key] == pytest.approx(want[name][key], abs=1e-6), (name, key)


def test_entry_eval_from_a_checkpoint_matches_jax(tiny, vocab, data_root, tmp_path, capsys,
                                                  monkeypatch):
    """``RESUME_FROM`` a ``.pt``: every dataset's metrics equal JAX's; an
    ``.npz`` and a store directory of the same weights load them bit-equal
    and give the ``.pt`` run's metrics on one dataset each."""
    monkeypatch.delenv("DETECTRON2_DATASETS", raising=False)
    monkeypatch.delenv("DATASET", raising=False)
    pt, npz = str(tmp_path / "xdecoder.pt"), str(tmp_path / "xdecoder.npz")
    torch.save({"model": tiny.state}, pt)
    np.savez(npz, **{k: v.numpy() for k, v in tiny.state.items()})
    store = str(tmp_path / "store")
    save_checkpoint(store, 1, {"params": tiny.tp})
    over = {**TINY, "MODEL": {**TINY["MODEL"], "TEXT": {**TINY["MODEL"]["TEXT"],
                                                         "TOKENIZER": vocab}},
            "DATASETS": {"TEST": list(data_root), "REGISTER": data_root}}
    jcfg, _ = jconfig.load_opt_command(_argv(over, "RESUME_FROM", pt))
    want = jentry.evaluate(jcfg)
    assert want["xeval_refcoco"]["cIoU"] >= 0 and "panoptic" in want["xeval_coco_panoptic"]
    got = tentry.main(_argv(over, "RESUME_FROM", pt, "SAVE_DIR", str(tmp_path / "out")),
                      device="cpu")
    _check_results(got, want)
    assert os.path.exists(tmp_path / "out" / "ref_coco.csv")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == set(want)
    cpu = torch.device("cpu")
    for path, name in ((npz, "xeval_refcoco"), (store, "xeval_semseg")):
        _assert_trees_equal(tentry._load_xdecoder_params({"RESUME_FROM": path}, tiny.tcfg, cpu),
                            tiny.tp)
        treg._DATASETS.clear()
        one = tentry.main(_argv({**over, "DATASETS": {"TEST": [name], "REGISTER": data_root}},
                                "RESUME_FROM", path), device="cpu")
        _check_results(one, {name: got[name]})


def test_entry_eval_refusals(tiny, data_root, tmp_path):
    cfg = {**TINY, "NAME": "xdecoder_test", "PIPELINE": "XDecoderPipeline"}
    assert tentry.evaluate({**cfg, "DATASETS": {"TEST": None}}, device="cpu") == {}
    spec = dict(data_root["xeval_semseg"], CLASS_NAMES=[])
    with pytest.raises(ValueError, match="no class names"):
        tentry.evaluate({**cfg, "DATASETS": {"TEST": ["plain_set"],
                                             "REGISTER": {"plain_set": spec}}}, device="cpu")
    # a retrieval dataset with no Arrow loader and rows without a file_name
    treg.register_dataset("vlp_val", lambda: [{"image_id": 1, "captions": ["a"]}],
                          {"evaluator_type": "retrieval"})
    with pytest.raises(ValueError, match="vlp_val: no image loader"):
        tentry.evaluate({**cfg, "DATASETS": {"TEST": ["vlp_val"]}}, device="cpu")
    with pytest.raises(NotImplementedError, match="ImageNet"):
        tentry.register_datasets_from_cfg({"DATASETS": {"REGISTER": {"i": {"KIND": "imagenet"}}}})
    with pytest.raises(ValueError, match="DTYPE"):
        tentry._load_xdecoder_params({"DTYPE": "float16"}, tiny.tcfg, torch.device("cpu"))
    bf16 = tentry._load_xdecoder_params({"DTYPE": "bfloat16"}, tiny.tcfg, torch.device("cpu"))
    assert all(t.dtype == torch.bfloat16 for t in _flat(bf16).values())
    # a checkpoint of other widths raises, naming the leaves
    wide = {**TINY["MODEL"], "BACKBONE": {"FOCAL": {**TINY["MODEL"]["BACKBONE"]["FOCAL"],
                                                    "EMBED_DIM": 24}}}
    pt = str(tmp_path / "tiny.pt")
    torch.save(tiny.state, pt)
    with pytest.raises(ValueError, match="stem"):
        tentry._load_xdecoder_params({"RESUME_FROM": pt}, tfc.xdecoder_model_config_from(
            {"MODEL": wide}), torch.device("cpu"))
