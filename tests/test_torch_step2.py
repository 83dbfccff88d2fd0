"""The torch port's step-2 data path and step2_pre generation against the JAX
package: the conversation reader, the step-2 synthesis (colour
augmentation on the same numpy rng) and batches, the integrity check,
``CuLLaVOPipeline.generate_step2_rows`` after the generation (on fixed
texts: parsing, drawing, PNGs, rows, chunking and per-chunk seeds), and
``entry.main(["eval", ...])`` on configs/cullavo_step2_pre.yaml from a
tiny f32 snapshot against JAX's ``entry.main``, token for token (JAX's
noise replayed through ``modeling.gumbel_noise``, keyed by each chunk's
seed)."""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cullavo_tpu import entry as j_entry
from cullavo_tpu.data import instruction_data as jid
from cullavo_tpu.data import integrity as jint
from cullavo_tpu.data.tokenizer import ByteTokenizer as JByte
from cullavo_tpu.models.llava import modeling as jm
from cullavo_tpu.models.llava.config import tiny_llava_config as j_tiny
from cullavo_tpu.pipelines import cullavo_pipeline as jpipe
from cullavo_tpu_torch import entry as t_entry
from cullavo_tpu_torch.checkpoint.from_jax import llava_params_from_numpy
from cullavo_tpu_torch.data import instruction_data as tid
from cullavo_tpu_torch.data import integrity as tint
from cullavo_tpu_torch.data import png_io
from cullavo_tpu_torch.data.text_format import classesboxes2string
from cullavo_tpu_torch.data.tokenizer import ByteTokenizer as TByte
from cullavo_tpu_torch.models.llava import modeling as tm
from cullavo_tpu_torch.models.llava.config import tiny_llava_config as t_tiny
from cullavo_tpu_torch.pipelines import cullavo_pipeline as tpipe
from test_torch_generate import JaxNoise
from test_torch_vl_eval import _hf_config, write_tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TURNS = [{"from": "human", "value": "<image>\nWhat is in the picture?"},
         {"from": "gpt", "value": "A dog and a cat."},
         {"from": "human", "value": "Where is the dog?"},
         {"from": "gpt", "value": " On the left. "}]


def _rows():
    """Conversation rows: boxed, plain, text-only, out-of-order turns, an
    odd trailing turn, a missing image file."""
    return [
        {"image": "a.png", "conversations": TURNS, "boxes": [[0.1, 0.2, 0.5, 0.6],
                                                              [0.3, 0.3, 0.9, 0.8]],
         "classes": ["dog", "cat"]},
        {"image": "b.png", "conversations": TURNS[:2]},
        {"image": None, "conversations": TURNS[2:]},
        {"image": "c.png", "conversations": [TURNS[1], TURNS[0], TURNS[2]],
         "boxes": [[0.0, 0.0, 1.0, 1.0]]},
        {"image": "gone.png", "conversations": TURNS},
        {"image": "b.png", "conversations": TURNS[:3], "boxes": [[0.5, 0.5, 0.6, 0.7]] * 3},
    ]


@pytest.fixture(scope="module")
def conv_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("conv")
    rng = np.random.default_rng(4)
    for name, hw in (("a.png", (40, 52)), ("b.png", (30, 30)), ("c.png", (64, 28))):
        png_io.write_png(str(d / name), rng.integers(0, 256, hw + (3,), dtype=np.uint8))
    with open(d / "rows.json", "w") as f:
        json.dump(_rows(), f)
    return d


@pytest.mark.parametrize("root,require", [(True, False), (False, False), (False, True),
                                          (True, True)])
def test_load_conversation_json_matches_jax(conv_dir, root, require):
    args = (str(conv_dir / "rows.json"), str(conv_dir) if root else None, require)
    assert tid.load_conversation_json(*args) == jid.load_conversation_json(*args)


def test_check_instruction_json_matches_jax(conv_dir):
    got = tint.check_instruction_json(str(conv_dir / "rows.json"), str(conv_dir))
    assert got == jint.check_instruction_json(str(conv_dir / "rows.json"), str(conv_dir))
    assert got["total"] == 6 and got["text_only"] == 1 and len(got["missing"]) == 1


@pytest.mark.parametrize("augment", [True, False])
def test_synthesize_step2_matches_jax(conv_dir, augment):
    """ids, labels and the (boxed) image bit-equal, and the rng where JAX
    leaves it, row after row on one rng."""
    rows = tid.load_conversation_json(str(conv_dir / "rows.json"), str(conv_dir))
    jr, tr = np.random.default_rng(3), np.random.default_rng(3)
    drawn = 0
    for _ in range(3):
        for row in rows:
            img = png_io.read_png(row["image_path"]) if row.get("image_path") else None
            want = jid.synthesize_step2(row, JByte(), jr, img, image_size=20,
                                        box_color_augment=augment)
            got = tid.synthesize_step2(row, TByte(), tr, img, image_size=20,
                                       box_color_augment=augment)
            assert sorted(got) == sorted(want)
            for key in want:
                assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key])
            drawn += img is not None and not np.array_equal(got["image"], img)
    assert jr.integers(1 << 30) == tr.integers(1 << 30)
    assert (drawn > 0) == augment


def test_iter_step2_batches_matches_jax(conv_dir):
    rows = tid.load_conversation_json(str(conv_dir / "rows.json"), str(conv_dir))
    jr, tr = np.random.default_rng(8), np.random.default_rng(8)
    kw = dict(num_image_tokens=4, batch_size=2, image_loader=png_io.read_png, image_size=28)
    want = list(jid.iter_step2_batches(rows, JByte(), rng=jr, **kw))
    got = list(tid.iter_step2_batches(rows, TByte(), rng=tr, **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in ("input_ids", "attention_mask", "labels", "weights"):
            assert g[key].dtype == w[key].dtype and np.array_equal(g[key], w[key]), key
        # JAX resizes through its native C++ core where it is built, the port
        # through F.interpolate: 5.4e-6 apart at most here
        np.testing.assert_allclose(g["pixel_values"], w["pixel_values"], atol=1e-5, rtol=0)
    assert jr.integers(1 << 30) == tr.integers(1 << 30)


BOXES = [[0.1, 0.2, 0.5, 0.6], [0.3, 0.3, 0.9, 0.8], [0.0, 0.05, 1.0, 0.95]]
TEXTS = [
    f"Sure, it is {classesboxes2string(['dog', 'cat'], BOXES[:2])}.",
    "Sure, it is (#1 dog [0.1, 0.2, 0.5, 0.6].",                           # unbalanced
    "nothing to see here",
    f"Sure, it is {classesboxes2string(['dog', 'dog', 'person'], BOXES)}.",
    "(#1 a) [0.1, 0.2, 0.3], (#1 b) [0.2, 0.2, 0.7, 0.9]",                  # a 3-number box
    f"{classesboxes2string(['bus'], BOXES[2:])}",
    f"It is {classesboxes2string(['tree', 'sky'], BOXES[1:])}.",
]


def _fake_generates(jax_seeds, port_seeds, calls, new):
    """Stand-ins for both pipelines' ``generate``: row ``i`` (its prompt's
    first id) "generates" ``TEXTS[i]`` (byte tokens, eos-padded)."""
    tok = JByte()

    def tokens(prompts):
        out = np.full((len(prompts), new), tok.eos_token_id, np.int32)
        for r, p in enumerate(np.asarray(prompts)):
            ids = tok.encode(TEXTS[int(p[0])], add_special_tokens=False)
            out[r, :len(ids)] = ids
        return out

    def jax_generate(params, cfg, ids, pix, mask, gen, max_len, rng):
        assert gen.do_sample and (gen.temperature, gen.top_k, gen.top_p) == (0.9, 50, 0.95)
        jax_seeds.append(int(np.asarray(rng)[1]))
        calls.append(("jax", np.asarray(ids)[:, 0].tolist(), tuple(np.asarray(pix).shape)))
        return jnp.asarray(tokens(ids))

    def port_generate(params, cfg, ids, pix, mask, gen, max_len, rng, compute_dtype):
        assert gen.do_sample and (gen.temperature, gen.top_k, gen.top_p) == (0.9, 50, 0.95)
        assert compute_dtype == torch.float32 and max_len == ids.shape[1] + new
        port_seeds.append(rng.initial_seed())
        calls.append(("port", ids[:, 0].tolist(), tuple(pix.shape)))
        return torch.from_numpy(tokens(ids))

    return jax_generate, port_generate


def test_generate_step2_rows_after_the_generation_matches_jax(tmp_path, monkeypatch):
    """On fixed texts: the same rows and lbk_new_version.json, PNG pixels
    equal to JAX's PIL-written ones, chunks of 3 with the last padded by
    repetition, and each chunk's seed the integer JAX seeds its key with."""
    from PIL import Image

    new = 160
    jax_seeds, port_seeds, calls = [], [], []
    jgen, tgen = _fake_generates(jax_seeds, port_seeds, calls, new)
    monkeypatch.setattr(jpipe, "generate", jgen)
    monkeypatch.setattr(tpipe, "generate", tgen)
    cfg = {"BATCH_SIZE": 3, "SEED": 5}
    jcfg, tcfg = j_tiny(128), t_tiny(128)
    tparams = tm.init_llava_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jp = jpipe.CuLLaVOPipeline(cfg, jcfg, JByte(), params=None)
    tp = tpipe.CuLLaVOPipeline(cfg, tcfg, TByte(), params=tparams)
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
              for hw in ((40, 52), (30, 30), (64, 28), (33, 47), (20, 20), (50, 40), (28, 28))]
    ids = np.zeros((len(TEXTS), 9), np.int32) + np.arange(len(TEXTS), dtype=np.int32)[:, None]
    mask = np.ones_like(ids)
    out = {}
    out = {"jax": jp.generate_step2_rows(images, ids, mask, str(tmp_path / "jax"), None,
                                         max_new_tokens=new),
           "port": tp.generate_step2_rows(images, ids, mask, str(tmp_path / "port"),
                                          max_new_tokens=new)}
    assert out["port"] == out["jax"]
    assert [r["image"] for r in out["port"]] == ["step2_0.png", "step2_3.png", "step2_4.png",
                                                 "step2_5.png", "step2_6.png"]
    assert out["port"][1]["classes"] == ["dog", "dog", "person"]
    with open(tmp_path / "jax" / "lbk_new_version.json") as f, \
            open(tmp_path / "port" / "lbk_new_version.json") as g:
        assert json.load(g) == json.load(f)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for row in out["port"]:
        want = np.array(Image.open(tmp_path / "jax" / row["image"]).convert("RGB"))
        got = png_io.read_png(str(tmp_path / "port" / row["image"]))
        assert np.array_equal(got, want) and np.array_equal(
            np.array(Image.open(tmp_path / "port" / row["image"])), want)
        assert not np.array_equal(got, images[int(row["image"][6:-4])])   # boxes drawn
    assert port_seeds == jax_seeds and len(set(port_seeds)) == 3
    chunks = {name: [c[1:] for c in calls if c[0] == name] for name in ("jax", "port")}
    assert chunks["port"] == chunks["jax"] == [
        ([0, 1, 2], (3, 3, 28, 28)), ([3, 4, 5], (3, 3, 28, 28)), ([6, 6, 6], (3, 3, 28, 28))]


# ---------------------------------------------------------------------------
# entry.main on cullavo_step2_pre from a snapshot
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A tiny f32 LLaVA snapshot in the HF layout that both packages read."""
    from safetensors.numpy import save_file

    from cullavo_tpu.checkpoint import hf_import as j_hf

    path = str(tmp_path_factory.mktemp("snapshot"))
    _, pad_id = write_tokenizer(path, vocab_size=500)
    cfg = j_tiny(pad_id + 1)
    params = jm.init_llava_params(cfg, jax.random.PRNGKey(2))
    state = {k: np.ascontiguousarray(np.asarray(v, np.float32))
             for k, v in j_hf.to_hf_state_dict(jax.tree.map(np.asarray, params), cfg).items()}
    save_file(state, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(_hf_config(cfg), f)
    return path


def _argv(snapshot, conv_dir, name, out, new=6):
    over = {"DATASETS.TEST": [name], "DATASETS.REGISTER": {name: {
        "KIND": "conversations", "JSON": str(conv_dir / "rows.json"), "IMAGE_ROOT": str(conv_dir)}}}
    return ["eval", "--conf_files", os.path.join(REPO, "configs/cullavo_step2_pre.yaml"),
            "--config_overrides", json.dumps(over),
            "--overrides", "MODEL.LLM.LOAD_PATH", snapshot, "SAVE_DIR", str(out),
            "MAX_NEW_TOKENS", str(new), "BATCH_SIZE", "2"]


def test_step2_pre_main_matches_jax(tmp_path, monkeypatch, snapshot, conv_dir):
    """Both command lines on one snapshot and one conversations dataset (four
    rows with an image: two chunks of 2): the same token streams, chunk for
    chunk, and the same lbk_new_version.json."""
    streams = {"jax": [], "port": []}
    for name, mod, to_np in (("jax", jpipe, np.asarray), ("port", tpipe, lambda t: t.numpy())):
        def recording(*a, _gen=mod.generate, _name=name, _np=to_np, **kw):
            out = _gen(*a, **kw)
            streams[_name].append(_np(out))
            return out
        monkeypatch.setattr(mod, "generate", recording)
    monkeypatch.setattr(tm, "gumbel_noise", JaxNoise())
    j_entry.main(_argv(snapshot, conv_dir, "conv_main_jax", tmp_path / "jax"))   # returns None
    res = t_entry.main(_argv(snapshot, conv_dir, "conv_main_port", tmp_path / "port"),
                       device="cpu")
    assert len(streams["port"]) == len(streams["jax"]) == 2
    for got, want in zip(streams["port"], streams["jax"]):
        assert got.shape == want.shape == (2, 6)
        np.testing.assert_array_equal(got, want)
    with open(tmp_path / "jax" / "lbk_new_version.json") as f, \
            open(tmp_path / "port" / "lbk_new_version.json") as g:
        rows = json.load(g)
        assert rows == json.load(f)
    assert res == {"rows": len(rows), "out_dir": str(tmp_path / "port")}


def test_step2_pre_runs_on_the_smoke_model_and_skips_rows_without_images(tmp_path, monkeypatch,
                                                                         conv_dir):
    """No LOAD_PATH: the tiny smoke model and the byte tokenizer; rows
    without an image file are not generated for."""
    calls = []
    generate = tpipe.generate

    def counting(params, cfg, ids, *a, **kw):
        calls.append(ids.shape)
        return generate(params, cfg, ids, *a, **kw)

    monkeypatch.setattr(tpipe, "generate", counting)
    argv = _argv("", conv_dir, "conv_smoke", tmp_path, new=3)
    argv[argv.index("MODEL.LLM.LOAD_PATH"):argv.index("SAVE_DIR")] = []
    res = t_entry.main(argv, device="cpu")
    assert res["out_dir"] == str(tmp_path) and [s[0] for s in calls] == [2, 2]
    with open(tmp_path / "lbk_new_version.json") as f:
        assert isinstance(json.load(f), list)


def test_conversations_data_in_datasets_train_raises(conv_dir):
    cfg = {"MODEL": {"LLM": {"LOAD_PATH": None, "BITS": 4}}, "LR": 2e-5,
           "DATASETS": {"TRAIN": "conv_train", "REGISTER": {"conv_train": {
               "KIND": "conversations", "JSON": str(conv_dir / "rows.json"),
               "IMAGE_ROOT": str(conv_dir)}}}}
    with pytest.raises(ValueError, match="conversations dataset"):
        t_entry.train(cfg, device="cpu")
