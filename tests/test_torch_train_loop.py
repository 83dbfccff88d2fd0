"""The port's training loop, its data path and its checkpoints against the
JAX package on the CPU: the PNG reader (the card's machine has no PIL)
against PIL, COCO-panoptic records and ``PanopticMapper`` against JAX's on
the same files, the npz checkpoint store and the reference ``epoch{N}``
layout written and read across the packages, ``train_loop``'s meters,
checkpoint cadence and profiler window, and ``entry.train`` over a
registered ``coco_panoptic`` dataset, loss for loss with JAX's, with
``RESUME_FROM``.

Files and states come from a numpy seed and go to both packages.  The
entry runs on both packages with JAX's tiny config, JAX's smoke weights
(bridged to the port), the byte tokenizer, LoRA dropout 0 (JAX's dropout
bits cannot be reproduced in torch) and f32 compute (the pipelines' bf16
compute rounds at other places in XLA and torch; the bf16 step is held by
``tests/test_torch_train.py``).
"""
import dataclasses
import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from cullavo_tpu import entry as j_entry
from cullavo_tpu.checkpoint import reference_layout as j_ref
from cullavo_tpu.checkpoint import store as j_store
from cullavo_tpu.data import coco_panoptic as j_pan
from cullavo_tpu.data import registry as j_registry
from cullavo_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from cullavo_tpu.models.llava import lora as jl
from cullavo_tpu.models.llava import modeling as jm
from cullavo_tpu.models.llava.config import tiny_llava_config as j_tiny
from cullavo_tpu.pipelines import cullavo_pipeline as j_pipe
from cullavo_tpu.trainer import loop as j_loop
from cullavo_tpu_torch import entry as t_entry
from cullavo_tpu_torch.checkpoint import from_jax as bridge
from cullavo_tpu_torch.checkpoint import reference_layout as t_ref
from cullavo_tpu_torch.checkpoint import store as t_store
from cullavo_tpu_torch.checkpoint.safetensors_io import read_safetensors
from cullavo_tpu_torch.data import coco_panoptic as t_pan
from cullavo_tpu_torch.data import png_io
from cullavo_tpu_torch.data import registry as t_registry
from cullavo_tpu_torch.data.tokenizer import ByteTokenizer as TByteTokenizer
from cullavo_tpu_torch.models.llava import lora as tl
from cullavo_tpu_torch.models.llava.config import tiny_llava_config as t_tiny
from cullavo_tpu_torch.pipelines import cullavo_pipeline as t_pipe
from cullavo_tpu_torch.trainer import loop as t_loop
from cullavo_tpu_torch.trainer.step import TrainState
from cullavo_tpu_torch.utils.tree import tree_map


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _paths(tree, prefix=""):
    """(path, leaf) pairs of a nested dict in key order, None leaves skipped."""
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        elif v is not None:
            yield prefix + k, v


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ---------------------------------------------------------------------------
# PNG files
# ---------------------------------------------------------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode_png(img: np.ndarray, filters) -> bytes:
    """A PNG of ``img`` (uint8 [H, W] or [H, W, C]) whose row y carries the
    scanline filter ``filters[y % len(filters)]``: an encoder written from
    the PNG specification, independent of the reader under test."""
    color = 0 if img.ndim == 2 else {3: 2, 4: 6}[img.shape[2]]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(img.shape[0], -1).astype(np.int64)
    raw, prior = bytearray(), np.zeros(rows.shape[1], np.int64)
    for y, cur in enumerate(rows):
        kind = filters[y % len(filters)]
        out = []
        for i, x in enumerate(cur):
            a = int(cur[i - bpp]) if i >= bpp else 0
            b, c = int(prior[i]), (int(prior[i - bpp]) if i >= bpp else 0)
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
            out.append((int(x) - pred) % 256)
        raw += bytes([kind] + out)
        prior = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    return (png_io.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", img.shape[1], img.shape[0], 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


def _test_image(shape, seed):
    """Smooth gradients (so that every filter has something to predict) with
    a band of noise."""
    rng = np.random.default_rng(seed)
    H, W = shape[:2]
    base = np.add.outer(np.arange(H) * 3, np.arange(W) * 5)
    img = (base[..., None] * np.arange(1, 1 + (shape[2] if len(shape) == 3 else 1))) % 256
    img = img.reshape(shape).astype(np.uint8)
    img[H // 3:H // 2] = rng.integers(0, 256, img[H // 3:H // 2].shape, dtype=np.uint8)
    return img


def _pil_rgb(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


SHAPES = [(13, 17), (13, 17, 3), (11, 19, 4)]


@pytest.mark.parametrize("shape", SHAPES, ids=["gray", "rgb", "rgba"])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_png_reader_matches_pil_on_every_filter(tmp_path, shape, filters):
    img = _test_image(shape, seed=len(filters) + sum(filters))
    path = tmp_path / "f.png"
    path.write_bytes(_encode_png(img, filters))
    got = png_io.read_png(str(path))
    assert got.dtype == np.uint8 and got.shape == shape[:2] + (3,)
    assert np.array_equal(got, _pil_rgb(path))


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_png_reader_matches_pil_on_pil_written_files(tmp_path, mode):
    shape = {"L": (40, 50), "RGB": (40, 50, 3), "RGBA": (40, 50, 4)}[mode]
    img = _test_image(shape, seed=7)
    path = tmp_path / "pil.png"
    Image.fromarray(img, mode).save(path)
    assert np.array_equal(png_io.read_png(str(path)), _pil_rgb(path))


@pytest.mark.parametrize("shape", SHAPES, ids=["gray", "rgb", "rgba"])
def test_png_writer_round_trips_through_both_readers(tmp_path, shape):
    img = _test_image(shape, seed=3)
    path = tmp_path / "w.png"
    png_io.write_png(str(path), img)
    rgb = np.repeat(img[..., None], 3, axis=2) if img.ndim == 2 else img[..., :3]
    assert np.array_equal(png_io.read_png(str(path)), rgb)
    assert np.array_equal(_pil_rgb(path), rgb)
    with Image.open(path) as im:
        assert np.array_equal(np.asarray(im), img)


def test_png_reader_refuses_what_it_does_not_read(tmp_path):
    pal = tmp_path / "p.png"
    Image.fromarray(_test_image((8, 8, 3), 1)).convert("P").save(pal)
    deep = tmp_path / "d.png"
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000).save(deep)
    for path in (pal, deep):
        with pytest.raises(NotImplementedError, match="only 8-bit"):
            png_io.read_png(str(path))
    jpg = tmp_path / "x.jpg"
    Image.fromarray(_test_image((8, 8, 3), 1)).save(jpg, format="JPEG")
    with pytest.raises(ValueError, match="not a PNG"):
        png_io.read_png(str(jpg))
    # the mapper's loader sends a non-PNG file to PIL, a PNG to png_io
    assert np.array_equal(t_pan.load_image_file(str(jpg)), _pil_rgb(jpg))
    with pytest.raises(ValueError, match="uint8"):
        png_io.write_png(str(tmp_path / "bad.png"), np.zeros((4, 4), np.float32))


# ---------------------------------------------------------------------------
# COCO panoptic records and the mapper
# ---------------------------------------------------------------------------

# a COCO-style category table: ids not contiguous, things and stuff
CATEGORIES = ([{"id": i, "name": f"thing{i}", "isthing": 1} for i in (1, 2, 3, 5, 8)]
              + [{"id": i, "name": f"stuff{i}", "isthing": 0} for i in (92, 130, 200)])


def write_panoptic_tree(root, n, sizes=((40, 48), (36, 52), (48, 40)), seed=0):
    """``n`` images (PNG bytes under ``.jpg`` names, as COCO's loader meets a
    PNG the reference's datasets hold), panopticapi PNGs and the JSON: per
    image two stuff halves, two or three thing boxes and, in image 0, one
    crowd segment."""
    rng = np.random.default_rng(seed)
    img_dir, pan_dir = root / "images", root / "panoptic"
    img_dir.mkdir(parents=True)
    pan_dir.mkdir()
    anns = []
    for i in range(n):
        H, W = sizes[i % len(sizes)]
        png_io.write_png(str(img_dir / f"{i:012d}.jpg"),
                         rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        ids = np.full((H, W), 1, np.int64)
        ids[H // 2:] = 2
        segs = [{"id": 1, "category_id": 92 if i % 2 else 130, "iscrowd": 0},
                {"id": 2, "category_id": 200, "iscrowd": 0}]
        for j in range(2 + i % 2):
            y0, x0 = rng.integers(0, H - 12), rng.integers(0, W - 12)
            h, w = rng.integers(4, 12, size=2)
            ids[y0:y0 + h, x0:x0 + w] = 10 + j
            segs.append({"id": 10 + j, "category_id": (1, 2, 3, 5, 8)[(i + j) % 5],
                         "iscrowd": 0})
        if i == 0:
            ids[:3, :3] = 99
            segs.append({"id": 99, "category_id": 1, "iscrowd": 1})
        segs.append({"id": 77, "category_id": 3, "iscrowd": 0})    # absent from the map
        png_io.write_png(str(pan_dir / f"{i:012d}.png"), t_pan.id2rgb(ids))
        anns.append({"image_id": 100 + i, "file_name": f"{i:012d}.png", "segments_info": segs})
    path = root / "panoptic.json"
    path.write_text(json.dumps({"images": [], "annotations": anns, "categories": CATEGORIES}))
    return str(path), str(img_dir), str(pan_dir)


def test_rgb2id_and_records_equal_jax(tmp_path):
    ids = np.array([[0, 1], [256, 70000]], np.int64)
    assert np.array_equal(t_pan.rgb2id(t_pan.id2rgb(ids)), ids)
    assert np.array_equal(t_pan.id2rgb(ids), j_pan.id2rgb(ids))
    tree = write_panoptic_tree(tmp_path, 3)
    for md in ({}, {"thing_dataset_ids": {1, 2}, "dataset_id_to_contiguous_id": {1: 7}}):
        got = t_pan.load_coco_panoptic_json(*tree, md)
        assert got == j_pan.load_coco_panoptic_json(*tree, md)
    assert got[0]["file_name"].endswith("000000000000.jpg")
    assert got[0]["segments_info"][0]["category_id"] == 130


@pytest.mark.parametrize("size", [28, 64])
def test_panoptic_mapper_equals_jax_on_the_same_files(tmp_path, size):
    tree = write_panoptic_tree(tmp_path, 3)
    recs = t_pan.load_coco_panoptic_json(*tree, {})
    tm, jm_ = t_pan.PanopticMapper(image_size=size), j_pan.PanopticMapper(image_size=size)
    for rec in recs:
        a, b = tm(rec), jm_(rec)
        assert a["image_id"] == b["image_id"]
        for key in ("classes", "boxes", "is_thing", "masks"):
            assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key
        assert a["image"].dtype == np.uint8 and a["image"].shape == (size, size, 3)
        # the bicubic resize sums in another order: truncation may land one level off
        assert np.abs(a["image"].astype(int) - b["image"].astype(int)).max() <= 1
    # two stuff halves and two or three things: the crowd and the absent segment dropped
    assert [len(tm(r)["classes"]) for r in recs] == [4, 5, 4]
    empty = dict(recs[0], segments_info=[s for s in recs[0]["segments_info"] if s["iscrowd"]])
    assert tm(empty) is None and jm_(empty) is None


# ---------------------------------------------------------------------------
# the npz store
# ---------------------------------------------------------------------------

def _toy_train_state():
    g = torch.Generator().manual_seed(0)
    trainable = {"lora": {"language_model": {"q": {"a": torch.randn(2, 4, 3, generator=g),
                                                   "b": torch.randn(2, 3, 5, generator=g)}}},
                 "embed_tokens": torch.randn(6, 4, generator=g), "lm_head": None}
    opt = {"count": 3, "mu": tree_map(torch.ones_like, trainable),
           "nu": tree_map(torch.zeros_like, trainable)}
    return TrainState(trainable, opt, 4)


def test_store_round_trips_a_train_state(tmp_path):
    state = _toy_train_state()
    path = t_store.save_checkpoint(str(tmp_path), 4, state)
    assert path.endswith("step_4") and t_store.latest_step(str(tmp_path)) == 4
    keys = json.load(open(os.path.join(path, "manifest.json")))["keys"]
    assert ".trainable['lora']['language_model']['q']['a']" in keys
    assert ".opt_state['count']" in keys and ".step" in keys
    assert not any("lm_head" in k for k in keys)            # None: an empty subtree
    template = TrainState(tree_map(torch.zeros_like, state.trainable),
                          {"count": 0, "mu": tree_map(torch.zeros_like, state.trainable),
                           "nu": tree_map(torch.zeros_like, state.trainable)}, 0)
    back = t_store.load_checkpoint(str(tmp_path), template=template)
    assert isinstance(back, TrainState) and back.step == 4 and back.opt_state["count"] == 3
    assert back.trainable["lm_head"] is None
    for (p, a), (_, b) in zip(_paths({"t": back.trainable, "o": back.opt_state}),
                              _paths({"t": state.trainable, "o": state.opt_state})):
        if torch.is_tensor(b):
            assert torch.equal(a, b), p
    plain = t_store.load_checkpoint(str(tmp_path))          # no template: plain dicts
    assert np.array_equal(plain["trainable"]["embed_tokens"], _np(state.trainable["embed_tokens"]))
    t_store.save_checkpoint(str(tmp_path), 12, state)
    assert t_store.latest_step(str(tmp_path)) == 12
    with pytest.raises(KeyError, match="missing"):
        t_store.load_checkpoint(str(tmp_path), 4,
                                template=dataclasses.replace(template, step={"extra": 0, "s": 1}))
    with pytest.raises(FileNotFoundError):
        t_store.load_checkpoint(str(tmp_path / "none"))


@pytest.mark.parametrize("leaf", [torch.zeros(2, dtype=torch.bfloat16), "text", object()],
                         ids=["bf16", "str", "object"])
def test_store_raises_on_a_leaf_numpy_cannot_hold(tmp_path, leaf):
    with pytest.raises(TypeError, match="numpy cannot hold"):
        t_store.save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(2), "bad": leaf})


def test_store_params_checkpoints_cross_the_packages(tmp_path):
    rng = np.random.default_rng(4)
    params = {"w": rng.normal(size=(2, 3)).astype(np.float32),
              "lst": [np.ones(2, np.float32), np.arange(3, dtype=np.int32)],
              "opt": {"count": np.int32(5), "nothing": None}, "step": np.int32(7)}
    j_store.save_checkpoint(str(tmp_path / "j"), 7, jax.tree.map(jnp.asarray, params))
    got = t_store.load_checkpoint(str(tmp_path / "j"))
    assert isinstance(got["lst"], list) and "nothing" not in got["opt"]
    for (p, a), (_, b) in zip(_paths({k: v for k, v in got.items() if k != "lst"}),
                              _paths({k: v for k, v in params.items() if k != "lst"})):
        assert np.array_equal(a, b), p
    assert all(np.array_equal(a, b) for a, b in zip(got["lst"], params["lst"]))
    tparams = tree_map(torch.as_tensor, {k: v for k, v in params.items() if k != "step"})
    tparams["step"] = 7
    t_store.save_checkpoint(str(tmp_path / "t"), 7, tparams)
    back = j_store.load_checkpoint(str(tmp_path / "t"))
    assert int(back["step"]) == 7 and int(back["opt"]["count"]) == 5
    assert np.array_equal(back["w"], params["w"]) and np.array_equal(back["lst"][1], params["lst"][1])
    with_tpl = j_store.load_checkpoint(str(tmp_path / "t"), template=params)
    assert with_tpl["opt"]["nothing"] is None


# ---------------------------------------------------------------------------
# the reference epoch{N} layout
# ---------------------------------------------------------------------------

LORA = dict(r=4, alpha=8.0, dropout=0.0, vision_layer_start=1, vision_layer_stop=2)


@pytest.fixture(scope="module")
def jax_trainable():
    """JAX's tiny trainable partition (adapters on the LLM and on vision
    layer 1, projector, embeddings, an untied head) as numpy."""
    cfg = j_tiny(260)
    jp = jm.init_llava_params(cfg, jax.random.PRNGKey(0))
    lora = jl.init_lora_params(jp, cfg, jl.LoraConfig(**LORA), jax.random.PRNGKey(1))
    rng = np.random.default_rng(5)
    lora = jax.tree_util.tree_map_with_path(
        lambda path, a: (jnp.asarray(rng.normal(size=a.shape).astype(np.float32))
                         if path[-1].key == "b" else a), lora)
    return jax.tree.map(np.asarray, jl.trainable_partition(jp, lora))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_reference_layout_equals_jax_and_reads_both_ways(tmp_path, jax_trainable):
    ttrain = bridge.trainable_from_numpy(jax_trainable, "cpu")
    jdir = j_ref.save_reference_layout(str(tmp_path / "j"), 2, jax_trainable,
                                       jl.LoraConfig(**LORA))
    tdir = t_ref.save_reference_layout(str(tmp_path / "t"), 2, ttrain, tl.LoraConfig(**LORA))
    assert os.path.basename(tdir) == "epoch2" and _files(tdir) == _files(jdir)
    assert "cullavo/lm_head.pt" in _files(tdir)
    for rel in _files(tdir):
        a, b = os.path.join(tdir, rel), os.path.join(jdir, rel)
        if rel.endswith(".json"):
            assert json.load(open(a)) == json.load(open(b)), rel
        elif rel.endswith(".safetensors"):
            ta, tb = read_safetensors(a), read_safetensors(b)
            assert list(ta) and sorted(ta) == sorted(tb), rel
            assert all(torch.equal(ta[k], tb[k]) for k in ta), rel
        else:
            ta, tb = (torch.load(p, map_location="cpu", weights_only=True) for p in (a, b))
            assert sorted(ta) == sorted(tb) and all(torch.equal(ta[k], tb[k]) for k in ta), rel
    vis = json.load(open(os.path.join(tdir, "cullavo/vision_tower/adapter_config.json")))
    assert vis["layers_to_transform"] == [1]
    assert all(".layers.1." in k for k in read_safetensors(
        os.path.join(tdir, "cullavo/vision_tower/adapter_model.safetensors")))
    # each package reads the other's tree (RESUME_FROM names CuLLaVO.pt)
    tback = t_ref.load_reference_layout(os.path.join(jdir, "CuLLaVO.pt"), ttrain)
    jback = j_ref.load_reference_layout(tdir, jax_trainable)
    mask = jax_trainable["lora"]["vision_tower"]["q"]["mask"].reshape(-1)
    for (p, a), (_, b), (_, c) in zip(_paths(tback), _paths(jback), _paths(jax_trainable)):
        if p.startswith("lora/vision_tower/") and not p.endswith("mask"):
            c = c * (mask != 0).reshape(-1, *([1] * (c.ndim - 1)))   # layers not written read 0
        assert np.array_equal(_np(a), c) and np.array_equal(b, c), p


def test_reference_layout_missing_and_untransformed_modules(tmp_path, jax_trainable):
    ttrain = bridge.trainable_from_numpy(jax_trainable, "cpu")
    ep = t_ref.save_reference_layout(str(tmp_path), 0, ttrain, tl.LoraConfig(**LORA))
    cfg_path = os.path.join(ep, "cullavo/language_model/adapter_config.json")
    cfg = json.load(open(cfg_path))
    st = os.path.join(ep, "cullavo/language_model/adapter_model.safetensors")
    # copies: the reader maps the file, which is written over next
    flat = {k: v.clone() for k, v in read_safetensors(st).items() if "down_proj" not in k}
    from cullavo_tpu_torch.checkpoint.safetensors_io import write_safetensors

    write_safetensors(flat, st)
    with pytest.raises(KeyError, match="down_proj"):
        t_ref.load_reference_layout(ep, ttrain)
    cfg["target_modules"] = [m for m in cfg["target_modules"] if m != "down_proj"]
    json.dump(cfg, open(cfg_path, "w"))
    got = t_ref.load_reference_layout(ep, ttrain)
    down = got["lora"]["language_model"]["down"]
    assert not down["a"].any() and not down["b"].any()     # an identity adapter
    assert torch.equal(got["lora"]["language_model"]["q"]["a"],
                       ttrain["lora"]["language_model"]["q"]["a"])
    with pytest.raises(FileNotFoundError, match="cullavo"):
        t_ref.load_reference_layout(str(tmp_path / "nowhere"), ttrain)


# ---------------------------------------------------------------------------
# train_loop
# ---------------------------------------------------------------------------

def _toy_state():
    return TrainState(trainable={"w": torch.ones(2, 2)}, opt_state={}, step=0)


def _step_fn(state, frozen, batch, rng):
    loss = batch["x"].sum() * 0.0 + 1.0 / (1.0 + state.step)
    return (TrainState(state.trainable, state.opt_state, state.step + 1),
            {"loss_llm": loss, "grad_norm": torch.tensor(2.0)})


def _data(n):
    return lambda epoch: ({"x": torch.ones(2)} for _ in range(n))


def test_train_loop_history_meters_and_logging():
    logs = []
    state, history = t_loop.train_loop(_toy_state(), None, _step_fn, _data(4), 4,
                                       t_loop.LoopConfig(max_epochs=2, log_every=3),
                                       rng=None, log_fn=logs.append)
    assert len(history) == 8 and state.step == 8
    assert history[0]["loss"] > history[-1]["loss"] == pytest.approx(1 / 8)
    assert history[0] == {"epoch": 0, "step": 1, "loss": 1.0, "loss_llm": 1.0, "grad_norm": 2.0}
    assert [d["step"] for d in logs] == [3, 6]
    assert logs[0]["loss_avg"] == pytest.approx((1 + 1 / 2 + 1 / 3) / 3)
    m = t_loop.AverageMeter()
    m.update(1.0)
    m.update(3.0, n=3)
    assert m.avg == pytest.approx(2.5)
    m.reset()
    assert m.avg == 0.0


@pytest.mark.parametrize("metrics,want", [({"loss_total": 2.0, "loss_a": 1.5}, 2.0),
                                          ({"loss_a": 1.0, "loss_b": 0.5, "x": 9.0}, 1.5)],
                         ids=["loss_total", "sum_of_losses"])
def test_train_loop_headline_loss(metrics, want):
    def step(state, frozen, batch, rng):
        return state, {k: torch.tensor(v) for k, v in metrics.items()}

    _, history = t_loop.train_loop(_toy_state(), None, step, _data(1), 1,
                                   t_loop.LoopConfig(log_every=0), rng=None)
    assert history[0]["loss"] == pytest.approx(want)


def test_train_loop_checkpoint_period_is_rederived_from_the_real_epoch(tmp_path):
    """The estimate says 16 steps per epoch (PERIOD 2 -> every 8): epoch 0
    really yields 4 (no periodic save fires), so epoch 1 saves every 2."""
    saves = []
    cfg = t_loop.LoopConfig(max_epochs=2, checkpoint_period=2, log_every=0,
                            save_dir=str(tmp_path))
    t_loop.train_loop(_toy_state(), None, _step_fn, _data(4), 16, cfg, rng=None,
                      save_fn=lambda d, s, st, e: saves.append((s, e)))
    assert saves == [(4, 0), (6, 1), (8, 1), (8, 1)]
    # the default save writes the npz store
    t_loop.train_loop(_toy_state(), None, _step_fn, _data(2), 2,
                      t_loop.LoopConfig(log_every=0, save_dir=str(tmp_path / "npz")), rng=None)
    assert t_store.latest_step(str(tmp_path / "npz")) == 2
    back = t_store.load_checkpoint(str(tmp_path / "npz"), template=_toy_state())
    assert back.step == 2 and torch.equal(back.trainable["w"], torch.ones(2, 2))


def test_train_loop_profiler_window_and_wandb(tmp_path, monkeypatch):
    trace_dir = tmp_path / "trace"
    cfg = t_loop.LoopConfig(max_epochs=1, log_every=0, profile_steps=2, profile_start=1,
                            profile_dir=str(trace_dir))
    t_loop.train_loop(_toy_state(), None, _step_fn, _data(4), 4, cfg, rng=None)
    assert [f for f in os.listdir(trace_dir) if "trace" in f] == ["trace_steps_1_3.json"]
    # a window still open when the loop ends is written too
    cfg = dataclasses.replace(cfg, profile_steps=10, profile_dir=str(tmp_path / "open"))
    t_loop.train_loop(_toy_state(), None, _step_fn, _data(4), 4, cfg, rng=None)
    assert os.listdir(tmp_path / "open") == ["trace_steps_1_4.json"]
    with pytest.raises(ValueError, match="profile_dir"):
        t_loop.train_loop(_toy_state(), None, _step_fn, _data(1), 1,
                          t_loop.LoopConfig(profile_steps=1), rng=None)
    # wandb: imported when asked for; where it is missing that raises (JAX's
    # loop swallows the error and trains without it)
    monkeypatch.setitem(__import__("sys").modules, "wandb", None)
    with pytest.raises(ImportError):
        t_loop.train_loop(_toy_state(), None, _step_fn, _data(1), 1,
                          t_loop.LoopConfig(wandb=True), rng=None)


# ---------------------------------------------------------------------------
# entry.train on a registered coco_panoptic dataset, against JAX's
# ---------------------------------------------------------------------------

def _entry_cfg(name, tree, out, **kw):
    json_file, img_dir, pan_dir = tree
    cfg = {"NAME": "cullavo_step1", "PIPELINE": "CuLLaVOPipeline", "WORKLOAD": "step1",
           "BATCH_SIZE": 4, "LR": 2e-5, "LAST_LR": 0.0, "GRAD_MAX": 10.0, "GRAD_CUM": 1,
           "EPOCHS": 1, "PERIOD": 0, "LOG_EVERY": 1, "SEED": 0, "SAVE_DIR": out,
           "MODEL": {"LLM": {"BITS": 4, "LORA_R": 4, "LORA_ALPHA": 8,
                             "LORA_VISION_START": 1, "LORA_VISION_STOP": 2}},
           "DATASETS": {"TRAIN": name, "REGISTER": {name: {
               "KIND": "coco_panoptic", "JSON": json_file, "IMAGE_DIR": img_dir,
               "PANOPTIC_DIR": pan_dir, "NUM_CLASSES": 8}}}}
    cfg.update(kw)
    return cfg


@pytest.fixture
def both_entries(monkeypatch):
    """Both entries on JAX's tiny config (the model merging at the byte
    tokenizer's <image> id) and JAX's smoke weights, dropout 0, f32
    compute; each package's ``train_loop`` wrapped to record the state it
    starts from and what it returns."""
    jcfg = dataclasses.replace(j_tiny(260), image_token_id=JByteTokenizer.image_token_id)
    tcfg = dataclasses.replace(t_tiny(260), image_token_id=TByteTokenizer.image_token_id)
    weights = jax.tree.map(np.asarray, jm.init_llava_params(jcfg, jax.random.PRNGKey(0)))
    # a fresh tree per build: the port's base quantization takes the dense
    # targets out of the tree it is given
    monkeypatch.setattr(j_entry, "_build_llava", lambda cfg: (
        jcfg, jax.tree.map(jnp.asarray, weights), JByteTokenizer()))
    monkeypatch.setattr(j_entry, "_build_mesh", lambda cfg: None)
    monkeypatch.setattr(t_entry, "_build_llava", lambda cfg, device, parallel=None: (
        tcfg, bridge.llava_params_from_numpy(weights, device), TByteTokenizer()))
    runs = {"jax": [], "torch": []}
    for pipe_mod, loop_mod, key in ((j_pipe, j_loop, "jax"), (t_pipe, t_entry, "torch")):
        lora_cls, make_step, loop = pipe_mod.LoraConfig, pipe_mod.make_train_step, \
            loop_mod.train_loop
        monkeypatch.setattr(pipe_mod, "LoraConfig",
                            lambda _c=lora_cls, **kw: _c(**{**kw, "dropout": 0.0}))
        monkeypatch.setattr(pipe_mod, "make_train_step",
                            lambda *a, _m=make_step, **kw: _m(*a, **{**kw, "compute_dtype": None}))

        def wrapped(state, *a, _loop=loop, _key=key, **kw):
            out = _loop(state, *a, **kw)
            runs[_key].append((state, out))
            return out

        monkeypatch.setattr(loop_mod, "train_loop", wrapped)
    yield runs
    for reg in (j_registry._DATASETS, t_registry._DATASETS):
        for name in [n for n in reg if n.startswith("torch_loop_")]:
            reg.pop(name)


def test_entry_train_on_coco_panoptic_matches_jax_loss_for_loss(tmp_path, both_entries):
    """12 images, batch 4, one epoch at configs/cullavo_step1.yaml's LR
    2e-5: three Adam steps; each step's loss_llm within rtol 1e-4 of JAX's
    (one step agrees to ~1e-7; Adam's first steps move every parameter by
    about the LR whatever its gradient's size, so rounding noise compounds
    with the LR: at 1e-3 the third loss differs by 1.2e-3); both write
    step_3 and epoch0; the port's result holds the final state and the
    history; RESUME_FROM reads the port's epoch0 into both packages'
    trainable partitions bit for bit."""
    tree = write_panoptic_tree(tmp_path / "coco", 12)
    jout, tout = str(tmp_path / "jax_out"), str(tmp_path / "torch_out")
    j_entry.train(_entry_cfg("torch_loop_jax", tree, jout))
    res = t_entry.train(_entry_cfg("torch_loop_torch", tree, tout), device="cpu")
    (_, (jstate, jhist)), = both_entries["jax"]
    (_, (tstate, thist)), = both_entries["torch"]
    assert res["state"] is tstate and res["history"] is thist
    jl_, tl_ = [h["loss_llm"] for h in jhist], [h["loss_llm"] for h in thist]
    assert len(tl_) == 3 and all(np.isfinite(tl_))
    np.testing.assert_allclose(tl_, jl_, rtol=1e-4)
    assert tstate.step == 3 and int(jstate.step) == 3
    for out in (jout, tout):
        assert sorted(os.listdir(out)) == ["epoch0", "step_3"]
    ckpt = t_store.load_checkpoint(tout, template=tstate)
    for (p, a), (_, b) in zip(_paths({"t": ckpt.trainable, "o": ckpt.opt_state}),
                              _paths({"t": tstate.trainable, "o": tstate.opt_state})):
        if torch.is_tensor(b):
            assert torch.equal(a, b), p

    # RESUME_FROM (the reference names epoch{N}/CuLLaVO.pt): no epoch runs
    resume = os.path.join(tout, "epoch0", "CuLLaVO.pt")
    j_entry.train(_entry_cfg("torch_loop_jax2", tree, None, RESUME_FROM=resume, EPOCHS=0))
    t_entry.train(_entry_cfg("torch_loop_torch2", tree, None, RESUME_FROM=resume, EPOCHS=0),
                  device="cpu")
    jstart, tstart = both_entries["jax"][1][0], both_entries["torch"][1][0]
    assert tstart.step == 0 and tstart.opt_state["count"] == 0     # a fresh optimizer
    for (p, a), (_, b), (_, c) in zip(_paths(tstart.trainable),
                                      _paths(jax.tree.map(np.asarray, jstart.trainable)),
                                      _paths(tstate.trainable)):
        assert np.array_equal(_np(a), b) and torch.equal(a, c), p
