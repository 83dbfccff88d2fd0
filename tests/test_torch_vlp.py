"""The X-Decoder's VLP eval, port against the JAX package on the CPU: the
port's Arrow IPC reader against pyarrow (and pyarrow on the port writer's
files), the karpathy / instruction / instp records and their images, the
retrieval / classification / caption evaluators, ``evaluate_retrieval_
embedding`` and ``evaluate_classification``, greedy ``forward_captioning``
(both vocabulary tables, with and without a captioning mask), and
``entry.main`` (``eval --conf_files configs/xdecoder_test.yaml`` at a tiny
width) on ``vlp_val`` and ``vlp_captioning_val`` registered from a bulk
``DETECTRON2_DATASETS`` root, ``RESUME_FROM`` a written ``.pt`` and a CLIP
vocabulary of CLIP's size, against JAX's ``entry.evaluate``.

Tolerances: module outputs in f32 within 1e-4 of the largest entry;
caption ids and metric dicts exactly (the evaluators run the same numpy
code on the same inputs).
"""
import dataclasses
import io
import json
import mmap
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import pyarrow as pa
from PIL import Image

import cullavo_tpu.config as jconfig
import cullavo_tpu.data.evaluation.evaluators as jev
import cullavo_tpu.data.registry as jreg
import cullavo_tpu.data.vlp_datasets as jvlp
import cullavo_tpu.entry as jentry
import cullavo_tpu.models.xdecoder.decoder as jdec
import cullavo_tpu.models.xdecoder.model as jmodel
import cullavo_tpu.models.xdecoder.text_encoder as jte
import cullavo_tpu.pipelines.vlp_pipeline as jpipe
import cullavo_tpu_torch.checkpoint.xdecoder_import as timp
import cullavo_tpu_torch.data.datasets as tds
import cullavo_tpu_torch.data.evaluation.evaluators as tev
import cullavo_tpu_torch.data.registry as treg
import cullavo_tpu_torch.data.vlp_datasets as tvlp
import cullavo_tpu_torch.entry as tentry
import cullavo_tpu_torch.models.from_config as tfc
import cullavo_tpu_torch.models.xdecoder.decoder as tdec
import cullavo_tpu_torch.models.xdecoder.model as tmodel
import cullavo_tpu_torch.pipelines.vlp_pipeline as tpipe
from cullavo_tpu_torch.checkpoint.from_jax import (xdecoder_params_from_numpy,
                                                   xdecoder_params_to_numpy)
from cullavo_tpu_torch.data import arrow_ipc, png_io
from test_torch_joint_data import chip_smoke
from test_torch_xdecoder import _noisy_numpy, port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDE = 64                     # VLP_IMAGE_SIZE of every test here
WORDS = ("a man dog cat rides sits on the red blue car horse park street two with "
         "table plate of food near water boat").split()


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_registries(monkeypatch):
    for reg in (jreg, treg):
        monkeypatch.setattr(reg, "_DATASETS", {})
        monkeypatch.setattr(reg, "_METADATA", {})


def _py(v):
    """A reader value as pyarrow's ``as_py`` gives it (bytes for binary)."""
    if isinstance(v, memoryview):
        return bytes(v)
    if isinstance(v, list):
        return [_py(x) for x in v]
    return v


def _column(f, name):
    col = f.column(name)
    return [_py(col[i]) for i in range(len(col))]


# ---------------------------------------------------------------------------
# the Arrow IPC reader and writer
# ---------------------------------------------------------------------------

def _pa_table():
    rng = np.random.default_rng(0)
    blobs = [bytes(rng.integers(0, 256, n, dtype=np.uint8)) for n in (5, 0, 17, 3, 9, 1, 64)]
    return pa.table({
        "image": pa.array([blobs[0], None, blobs[2], b"", blobs[4], blobs[5], blobs[6]]),
        "blob": pa.array(blobs[:6] + [None], pa.large_binary()),
        "caption": pa.array([["a dog", "two dogs"], None, [], ["x", None, "é ü"], ["one"],
                             ["b"] * 7, ["c", "d"]], pa.list_(pa.string())),
        "text": pa.array(["q", None, "", "long " * 30, "w", "é", "z"], pa.large_string()),
        "nested": pa.array([[b"1"], [], None, [b"2", b"3"], [None], [b""], [b"4"]],
                           pa.large_list(pa.binary())),
        "image_id": ["COCO_val2014_000000000139.jpg", "x_2", None, "y_3.jpg", "4", "5", "6"],
        "i8": pa.array([-128, 127, 0, None, 1, -1, 5], pa.int8()),
        "u16": pa.array([0, 65535, 7, 8, None, 9, 10], pa.uint16()),
        "i32": pa.array([-2 ** 31, 2 ** 31 - 1, 0, 1, 2, None, 3], pa.int32()),
        "u64": pa.array([2 ** 64 - 1, 0, 1, 2, 3, 4, None], pa.uint64()),
        "i64": pa.array([-2 ** 63, 2 ** 40, None, 0, 1, 2, 3], pa.int64()),
    })


def _pa_write(path, table, **kw):
    chunk = kw.pop("max_chunksize", None)
    with pa.OSFile(str(path), "wb") as sink:
        with pa.ipc.new_file(sink, table.schema, options=pa.ipc.IpcWriteOptions(**kw)) as w:
            w.write_table(table, max_chunksize=chunk)


def test_arrow_reader_equals_pyarrow(tmp_path):
    """Files pyarrow writes (binary, large binary, strings, a list of
    strings, a large list of binary, every Int width signed and unsigned,
    nulls everywhere) as one record batch, in batches of 2 rows, and with
    the length-only message prefix: every value equals ``as_py()``, and a
    binary value is a slice of the file's map."""
    table = _pa_table()
    for kw, batches in (({}, 1), ({"max_chunksize": 2}, 4),
                        ({"use_legacy_format": True, "max_chunksize": 3}, 3)):
        path = tmp_path / f"t{batches}.arrow"
        _pa_write(path, table, **kw)
        f = arrow_ipc.ArrowFile(str(path))
        assert f.names == table.column_names and len(f) == table.num_rows
        assert f.num_batches == batches
        for name in table.column_names:
            assert _column(f, name) == table[name].to_pylist(), (kw, name)
        value = f.column("image")[6]
        assert isinstance(value, memoryview) and isinstance(value.obj, mmap.mmap)
        assert f.column("i64")[-1] == 3
    with pytest.raises(IndexError):
        f.column("i64")[7]
    with pytest.raises(KeyError, match="nope"):
        f.column("nope")


def test_arrow_writer_is_read_by_pyarrow_and_refusals(tmp_path):
    """The port's writer: pyarrow reads its files equal (and validates
    them), in several record batches; the port reads them back.  A
    compressed body, a dictionary-encoded column, a float column and a file
    without the magic raise."""
    rng = np.random.default_rng(1)
    imgs = [png_io.encode_png(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            for h, w in ((8, 6), (5, 9), (4, 4), (7, 3), (2, 2))]
    columns = {
        "image": ("binary", imgs),
        "blob": ("large_binary", [b"x", None, b"", b"yy", b"z"]),
        "caption": ("list<utf8>", [["a", "b"], None, [], ["é", None], ["c"] * 7]),
        "ll": ("large_list<large_utf8>", [["x"], [], None, ["y", "z"], [""]]),
        "image_id": ("utf8", ["COCO_val2014_000000000001.jpg", None, "a_2", "", "b"]),
        "ids": ("int64", [1, None, -3, 2 ** 40, 0]),
        "u8": ("uint8", [0, 255, 1, 2, None]),
    }
    path = str(tmp_path / "w.arrow")
    arrow_ipc.write_arrow(path, columns, batch_rows=2)
    reader = pa.ipc.open_file(path)
    assert reader.num_record_batches == 3
    got = reader.read_all()
    got.validate(full=True)
    f = arrow_ipc.ArrowFile(path)
    for name, (_, values) in columns.items():
        assert got[name].to_pylist() == values, name
        assert _column(f, name) == values, name
    assert png_io.decode_png_rgb(bytes(f.column("image")[1])).shape == (5, 9, 3)
    with pytest.raises(ValueError, match="write_arrow: type 'float32'"):
        arrow_ipc.write_arrow(path, {"x": ("float32", [1.0])})

    plain = pa.table({"a": ["word " * 20] * 30})
    _pa_write(tmp_path / "z.arrow", plain, compression="zstd")
    with pytest.raises(ValueError, match="compressed"):
        arrow_ipc.ArrowFile(str(tmp_path / "z.arrow"))
    _pa_write(tmp_path / "d.arrow", pa.table({"a": pa.array(["x", "y", "x"]).dictionary_encode()}))
    with pytest.raises(ValueError, match="dictionary"):
        arrow_ipc.ArrowFile(str(tmp_path / "d.arrow"))
    _pa_write(tmp_path / "f.arrow", pa.table({"a": pa.array([1.5])}))
    with pytest.raises(ValueError, match="FloatingPoint"):
        arrow_ipc.ArrowFile(str(tmp_path / "f.arrow"))
    with open(tmp_path / "bad.arrow", "wb") as fh:
        fh.write(b"ARROW1\0\0" + bytes(32))
    with pytest.raises(ValueError, match="magic"):
        arrow_ipc.ArrowFile(str(tmp_path / "bad.arrow"))


# ---------------------------------------------------------------------------
# records and images
# ---------------------------------------------------------------------------

def _image_bytes(rng, h, w, fmt):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, format=fmt)
    return buf.getvalue()


def _karpathy(rng, n, ids):
    """n rows: PNG images (one JPEG), 5 captions each (6 or 7 for two)."""
    images = [_image_bytes(rng, 24 + 4 * i, 32 - 2 * i, "JPEG" if i == 1 else "PNG")
              for i in range(n)]
    captions = [[" ".join(rng.choice(WORDS, 6)) for _ in range(5 + (i % 3 == 2) + (i == 0))]
                for i in range(n)]
    return pa.table({"image": images, "caption": captions, "image_id": ids})


def test_vlp_records_and_images_match_jax(tmp_path, capsys):
    """A bulk root with ``vlp/pretrain_arrows_code224`` (string ids) and
    ``vlp/llava_dataset`` (int ids; the instruction and instp train arrows
    with path-style ids) written by pyarrow: the records of the vlp,
    instruction and instp splits equal JAX's, the exploding vlp train rule
    included; every image of ``vlp_val`` equals JAX's (PNG through png_io,
    the JPEG through PIL); a second bulk registration leaves them."""
    rng = np.random.default_rng(2)
    root = tmp_path / "bulk"
    pre, llava = root / "vlp" / "pretrain_arrows_code224", root / "vlp" / "llava_dataset"
    os.makedirs(pre)
    os.makedirs(llava)
    _pa_write(pre / "coco_caption_karpathy_test.arrow",
              _karpathy(rng, 5, [f"COCO_val2014_{i:012d}.jpg" for i in (139, 285, 632, 724, 776)]),
              max_chunksize=2)
    _pa_write(llava / "coco_caption_karpathy_test.arrow", _karpathy(rng, 3, [11, 12, 13]))
    for k, stem in enumerate(("instruction_pretrain_558k", "instruction_coco2017",
                              "instruction_gqa", "instruction_ocr_vqa", "instruction_textvqa",
                              "instruction_vg")):
        _pa_write(llava / f"{stem}.arrow", pa.table({
            "image": [b"\x00", b"\x01"],
            "caption": [[f"human: what is {k}? gpt: a {w}"] for w in ("dog", "cat")],
            "image_id": [f"coco/train2017/{k:06d}{j}.jpg" for j in (1, 2)]}))
    jvlp.register_all_vlp(str(root / "vlp"))
    done = tds.register_all_segmentation(str(root))
    assert done == list(tvlp.PREDEFINED_SPLITS) and "not registered" in capsys.readouterr().err
    assert tds.register_all_segmentation(str(root)) == []
    for name in ("vlp_val", "vlp_captioning_val", "instruction_val", "instruction_train",
                 "instp_train", "instp_captioning_val"):
        want, got = jreg.get_dataset(name), treg.get_dataset(name)
        assert got == want and len(got) > 1, name
        assert treg.get_metadata(name)["evaluator_type"] == jreg.get_metadata(name)[
            "evaluator_type"]
    # the vlp train rule (no registered split reaches it): one row a caption
    paths = ["coco_caption_karpathy_test.arrow"]
    jt, tt = jvlp.load_vlp_arrows(str(pre), paths), tvlp.load_vlp_arrows(str(pre), paths)
    want = jvlp.load_vlp_records(jt, "vlp_train")
    assert tvlp.load_vlp_records(tt, "vlp_train") == want and len(want) == 5 * 5 + 2
    rows = treg.get_dataset("vlp_val")
    jload = jreg.get_metadata("vlp_val")["image_loader"]["loader"]
    tload = treg.get_metadata("vlp_val")["image_loader"]["loader"]
    for r in rows:
        np.testing.assert_array_equal(tload(r), jload(r))


# ---------------------------------------------------------------------------
# evaluators
# ---------------------------------------------------------------------------

def test_evaluators_match_jax(tmp_path):
    """Retrieval with and without the backbone ensemble (duplicate
    embeddings: argsort's ties), classification, and the caption metrics
    with their results file: equal to JAX's."""
    rng = np.random.default_rng(3)
    n_img, D = 9, 16
    img, img2 = rng.normal(size=(n_img, D)), rng.normal(size=(n_img, D))
    img[3] = img[2]
    texts = [rng.normal(size=(5 + (i % 3 == 0), D)) for i in range(n_img)]
    for with2 in (False, True):
        evs = [jev.RetrievalEvaluator(), tev.RetrievalEvaluator()]
        for ev in evs:
            for i in range(n_img):
                ev.add(img[i], texts[i], image_id=100 + i // 2 * 2,
                       image_emb2=img2[i] if with2 else None)
        assert evs[1].results() == evs[0].results()
    cls = [jev.ClassificationEvaluator(), tev.ClassificationEvaluator()]
    for _ in range(20):
        logits, label = rng.normal(size=12), int(rng.integers(0, 12))
        for ev in cls:
            ev.add(logits, label)
    assert cls[1].results() == cls[0].results()
    caps = [jev.CaptioningEvaluator(), tev.CaptioningEvaluator()]
    for i in range(12):
        refs = [" ".join(rng.choice(WORDS, int(rng.integers(4, 11)))) for _ in range(5)]
        cand = " ".join(rng.choice(WORDS, int(rng.integers(0, 10)))).capitalize()
        for ev in caps:
            ev.add(i, cand if i else refs[0].upper(), refs if i != 5 else [])
    assert caps[1].results() == caps[0].results()
    for ev, name in zip(caps, ("j.json", "t.json")):
        ev.dump_results(str(tmp_path / name))
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()


# ---------------------------------------------------------------------------
# the model: retrieval and classification embeddings, greedy captioning
# ---------------------------------------------------------------------------

def _tf_logits_jax(p, cfg, images, ids, cm):
    """JAX: every caption slot's vocabulary logits in one decoder pass over
    ``ids`` (the caption slots attend causally: slot t's logits are step t's)."""
    mask_features, pyramid = jmodel.backbone_and_pixel_decoder(p, cfg, images)
    tp = p["text"]
    vocab = tp["token_embedding"]
    if vocab.shape[-1] != cfg.decoder.dim_proj:
        vocab = vocab @ tp["lang_proj"]
    tok, _ = jte.forward_language_token(tp, cfg.text, ids, jnp.ones(ids.shape, jnp.int32))
    out = jdec.xdecoder_forward(p["decoder"], cfg.decoder, pyramid, mask_features,
                                caption_tokens=tok, captioning_spatial_mask=cm, task="vlp",
                                is_train=True)
    return out["pred_captionings"] @ vocab.T


def _tf_logits_port(pipe, images, ids, cm):
    with torch.inference_mode():
        mask_features, pyramid = tmodel.backbone_and_pixel_decoder(pipe.params, pipe.model_cfg,
                                                                   images)
        out = tdec.xdecoder_forward(pipe.params["decoder"], pipe.model_cfg.decoder, pyramid,
                                    mask_features, caption_tokens=pipe.token_embeddings(ids),
                                    captioning_spatial_mask=cm, task="vlp", is_train=True)
        return (out["pred_captionings"] @ pipe.vocab_table().t()).numpy()


class VModel:
    """A tiny model in both packages (the port's initializer plus seeded
    noise), its captioning pipelines and a batch of two images."""

    def __init__(self, jcfg, seed):
        self.jcfg, self.tcfg = jcfg, port_config(jcfg)
        init = tmodel.init_xdecoder_model_params(self.tcfg, torch.Generator().manual_seed(seed),
                                                 "cpu")
        self.np = _noisy_numpy(xdecoder_params_to_numpy(init), seed)
        self.jp = jax.tree.map(jnp.asarray, self.np)
        self.tp = xdecoder_params_from_numpy(self.np, "cpu")
        start = jcfg.text.vocab_size - 2
        self.jpipe = jpipe.VLPCaptioningPipeline(None, jcfg, self.jp, None, None, start, SIDE)
        self.tpipe = tpipe.VLPCaptioningPipeline(None, self.tcfg, self.tp, None, None, start,
                                                 SIDE)
        rng = np.random.default_rng(seed)
        self.x = rng.normal(size=(2, SIDE, SIDE, 3)).astype(np.float32)
        self.cm = np.zeros((2, SIDE, SIDE), bool)
        self.cm[0, 8:40, 4:50] = True
        self.tf = jax.jit(lambda p, im, ids, cm: _tf_logits_jax(p, jcfg, im, ids, cm))


@pytest.fixture(scope="module")
def models():
    base = jmodel.tiny_xdecoder_config()
    raw = dataclasses.replace(base, text=dataclasses.replace(base.text, width=64))
    return {"projected": VModel(base, 7), "raw": VModel(raw, 8)}


def test_retrieval_and_classification_match_jax(models):
    """``evaluate_retrieval_embedding`` (both embeddings) and
    ``evaluate_classification`` within 1e-4 of the largest entry;
    ``evaluate_dispatch`` routes to them and refuses "captioning"."""
    m = models["projected"]
    x = torch.from_numpy(m.x)
    emb, emb2 = jax.jit(lambda p, im: jmodel.evaluate_retrieval_embedding(p, m.jcfg, im))(
        m.jp, m.x)
    with torch.inference_mode():
        got = tmodel.evaluate_dispatch(m.tp, m.tcfg, x, "retrieval")
        no_ens = tmodel.evaluate_retrieval_embedding(m.tp, m.tcfg, x, ensemble=False)
    for g, w in zip(got, (emb, emb2)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)
    assert no_ens[1] is None and torch.equal(no_ens[0], got[0])
    t_emb = np.random.default_rng(9).normal(size=(5, m.jcfg.decoder.dim_proj)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, im, t: jmodel.evaluate_classification(
        p, m.jcfg, im, t))(m.jp, m.x, t_emb))
    with torch.inference_mode():
        got = tmodel.evaluate_dispatch(m.tp, m.tcfg, x, "classification",
                                       text_class_embeds=torch.from_numpy(t_emb)).numpy()
    assert got.shape == (2, 5)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)
    with pytest.raises(ValueError, match="forward_captioning"):
        tmodel.evaluate_dispatch(m.tp, m.tcfg, x, "captioning")


@pytest.mark.parametrize("table,masked", [("projected", True), ("raw", False)])
def test_forward_captioning_matches_jax(models, table, masked):
    """Greedy captioning token for token equal to JAX's pipeline program,
    for the projected table (text width 32, dim_proj 64) with a captioning
    mask and the raw one (64 = 64) without (the entry test below runs the
    projected table without a mask); every step's logits, replayed
    teacher-forced on the port's ids, within 1e-4 of the largest of JAX's,
    and each id the argmax of its step's logits."""
    m = models[table]
    assert (m.tpipe.vocab_table().shape[-1] == m.tcfg.text.width) == (table == "raw")
    cm = m.cm if masked else None
    want = np.asarray(m.jpipe._decode_masked(m.jp, m.x, m.cm) if masked
                      else m.jpipe._decode(m.jp, m.x))
    got, _, _ = m.tpipe.decode(m.x, cm)
    steps = min(m.tcfg.decoder.captioning_step, m.tcfg.decoder.contxt_len - 1)
    assert got.dtype == np.int32 and got.shape == want.shape == (2, steps + 1)
    np.testing.assert_array_equal(got, want)
    tf_want = np.asarray(m.tf(m.jp, m.x, got, cm))[:, :steps]
    tf_got = _tf_logits_port(m.tpipe, torch.from_numpy(m.x), torch.from_numpy(got),
                             None if cm is None else torch.from_numpy(cm))[:, :steps]
    np.testing.assert_allclose(tf_got, tf_want, atol=1e-4 * np.abs(tf_want).max(), rtol=0)
    np.testing.assert_array_equal(tf_got.argmax(-1), got[:, 1:])


# ---------------------------------------------------------------------------
# the entry point end to end
# ---------------------------------------------------------------------------

# configs/xdecoder_test.yaml at a tiny width (the FocalNet keys under
# MODEL.BACKBONE.FOCAL, where both readers take them)
TINY = {"MODEL": {"BACKBONE": {"FOCAL": {"EMBED_DIM": 16, "DEPTHS": [1, 1, 1, 1],
                                         "FOCAL_LEVELS": [2, 2, 2, 2],
                                         "FOCAL_WINDOWS": [3, 3, 3, 3]}},
                  "ENCODER": {"CONVS_DIM": 64, "MASK_DIM": 32, "TRANSFORMER_ENC_LAYERS": 1},
                  "DECODER": {"HIDDEN_DIM": 64, "NUM_OBJECT_QUERIES": 9, "NHEADS": 4,
                              "DIM_FEEDFORWARD": 128, "DEC_LAYERS": 3},
                  "TEXT": {"WIDTH": 32, "HEADS": 4, "LAYERS": 2, "CONTEXT_LENGTH": 16},
                  "DIM_PROJ": 64},
        "BATCH_SIZE": 4, "VLP_IMAGE_SIZE": SIDE}
# two batches of 4, 21 captions each (one JAX program a stage)
IMAGE_HW = [(48, 64), (64, 40), (56, 56), (40, 72), (64, 64), (30, 50), (64, 48), (50, 50)]


def _argv(overrides: dict, *pairs):
    return ["eval", "--conf_files", os.path.join(REPO, "configs/xdecoder_test.yaml"),
            "--config_overrides", json.dumps(overrides), "--overrides", *pairs]


def test_entry_eval_vlp_matches_jax(tmp_path, monkeypatch, capsys):
    """``entry.main`` on ``vlp_val`` and ``vlp_captioning_val`` registered
    from a bulk root (the karpathy arrow written by the port's writer: PNG
    bytes, 5 or 6 captions an image, two record batches), ``RESUME_FROM`` a
    ``.pt``, a CLIP vocabulary of 49408 ids: the metric dicts equal JAX's
    ``entry.evaluate``'s and the captions file equals JAX's; without a
    tokenizer the captions are the ids as numbers, as in JAX."""
    rng = np.random.default_rng(11)
    root = tmp_path / "bulk"
    arrows = root / "vlp" / "pretrain_arrows_code224"
    os.makedirs(arrows)
    arrow_ipc.write_arrow(str(arrows / "coco_caption_karpathy_test.arrow"), {
        "image": ("binary", [png_io.encode_png(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
                             for h, w in IMAGE_HW]),
        "caption": ("list<utf8>", [[" ".join(rng.choice(WORDS, 7))
                                    for _ in range(5 + (i % 4 == 0))]
                                   for i in range(len(IMAGE_HW))]),
        "image_id": ("utf8", [f"COCO_val2014_{42 + 7 * i:012d}.jpg"
                              for i in range(len(IMAGE_HW))])}, batch_rows=4)
    vocab = str(tmp_path / "clip")
    chip_smoke().write_clip_tokenizer(vocab, list(WORDS), learn=50)
    jcfg_model = tfc.xdecoder_model_config_from(TINY)
    init = tmodel.init_xdecoder_model_params(jcfg_model, torch.Generator().manual_seed(12), "cpu")
    params = xdecoder_params_from_numpy(_noisy_numpy(xdecoder_params_to_numpy(init), 12), "cpu")
    pt = str(tmp_path / "xdecoder.pt")
    torch.save({"model": timp.reference_state_from_params(params, jcfg_model)}, pt)
    monkeypatch.setenv("DETECTRON2_DATASETS", str(root))
    monkeypatch.delenv("DATASET", raising=False)
    over = {**TINY, "MODEL": {**TINY["MODEL"], "TEXT": {**TINY["MODEL"]["TEXT"],
                                                         "TOKENIZER": vocab}},
            "DATASETS": {"TEST": ["vlp_val", "vlp_captioning_val"]}}
    jdir, tdir = str(tmp_path / "jax_out"), str(tmp_path / "port_out")
    os.makedirs(jdir)
    jcfg, _ = jconfig.load_opt_command(_argv(over, "RESUME_FROM", pt, "SAVE_DIR", jdir))
    want = jentry.evaluate(jcfg)
    got = tentry.main(_argv(over, "RESUME_FROM", pt, "SAVE_DIR", tdir), device="cpu")
    assert set(got) == set(want) == {"vlp_val", "vlp_captioning_val"}
    for name in want:
        timing = got[name].pop("timing")
        assert got[name] == want[name], name
        assert timing["eval_batch"] == 4 and timing["compute_s"] > 0
    assert set(want["vlp_val"]) == {f"{d}@{k}" for d in ("ir", "tr") for k in (1, 5, 10)}
    assert want["vlp_captioning_val"]["n"] == len(IMAGE_HW)
    with open(os.path.join(tdir, "vlp_captioning_val_captions.json")) as f:
        captions = json.load(f)
    with open(os.path.join(jdir, "vlp_captioning_val_captions.json")) as f:
        assert captions == json.load(f)
    assert [c["image_id"] for c in captions] == [42 + 7 * i for i in range(len(IMAGE_HW))]
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == set(want)
    ids = [49406, 7, 300, 49407, 5]
    assert tentry._make_text_decode({})(ids) == jentry._make_text_decode({})(ids)
    assert tentry._make_text_decode({"MODEL": {"TEXT": {"TOKENIZER": vocab}}})(ids) == \
        jentry._make_text_decode({"MODEL": {"TEXT": {"TOKENIZER": vocab}}})(ids)
