"""The vl_test eval of the torch port against the JAX package, from a local
HF snapshot: the port's safetensors reader and writer against the
``safetensors`` package, its snapshot loader against JAX's, its
``tokenizer.json`` reader against transformers' ``AutoTokenizer``, and
``entry.evaluate`` on vl_test (dataset registry, VQA mapper, both VQA
pipelines) against the JAX entry on the same tiny snapshot, token for token.

The snapshot is written from the JAX initializer's tiny LLaVA through JAX's
``to_hf_state_dict`` (f32: JAX's numpy reader cannot read bf16); the
tokenizer is a LLaMA-style BPE (3 specials, 256 byte-fallback tokens, merges
learned on a small corpus) built with the ``tokenizers`` library; images are
PNG files written with PIL, as ``tests/test_entry_eval.py`` writes them.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax

from cullavo_tpu import entry as j_entry
from cullavo_tpu.checkpoint import hf_import as j_hf
from cullavo_tpu.data.tokenizer import HFTokenizer as JHFTokenizer
from cullavo_tpu.models.llava import modeling as jm
from cullavo_tpu.models.llava.config import tiny_llava_config as j_tiny
from cullavo_tpu.serving.io import load_pixels as j_load_pixels
from cullavo_tpu_torch import entry as t_entry
from cullavo_tpu_torch.checkpoint import hf_import as t_hf
from cullavo_tpu_torch.checkpoint.from_jax import llava_params_to_numpy
from cullavo_tpu_torch.checkpoint.safetensors_io import read_safetensors, write_safetensors
from cullavo_tpu_torch.data.tokenizer import HFTokenizer
from cullavo_tpu_torch.serving.io import load_pixels as t_load_pixels


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CORPUS = ["A chat between a curious human and an artificial intelligence assistant.",
          "The assistant gives helpful, detailed, and polite answers to the human's questions.",
          "USER: What color is the car? ASSISTANT: red", "How many dogs are in the picture? two",
          "Is there a person riding the bicycle? yes no", "what is the man holding in his hand",
          "USER: ASSISTANT: what is it? how many? where is the cat"] * 20
BYTES = [f"<0x{i:02X}>" for i in range(256)]


def write_tokenizer(path, form="legacy", image_token=True, vocab_size=600, config=None):
    """A LLaMA-style tokenizer.json (BPE, byte fallback, the legacy
    Prepend + Replace normalizer or a Metaspace pre-tokenizer, the
    Replace/ByteFallback/Fuse/Strip decoder) and its tokenizer_config.json.
    Returns the ids of <image> (None without it) and <pad>."""
    from tokenizers import AddedToken, Tokenizer, decoders, models, normalizers
    from tokenizers import pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True, fuse_unk=True))
    if form == "legacy":
        tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                               normalizers.Replace(" ", "▁")])
    else:
        tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="first",
                                                     split=False)
    tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                     decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    trainer = trainers.BpeTrainer(vocab_size=vocab_size, special_tokens=["<unk>", "<s>", "</s>"]
                                  + BYTES, show_progress=False, limit_alphabet=60)
    tok.train_from_iterator(CORPUS, trainer)
    added = ([AddedToken("<image>", special=True, normalized=False)] if image_token else [])
    tok.add_special_tokens(added + [AddedToken("<pad>", special=True, normalized=False)])
    os.makedirs(path, exist_ok=True)
    tok.save(os.path.join(path, "tokenizer.json"))
    cfg = {"tokenizer_class": "LlamaTokenizer", "bos_token": "<s>", "eos_token": "</s>",
           "unk_token": "<unk>", "pad_token": "<pad>", "add_bos_token": True,
           "add_eos_token": False, "legacy": False, "clean_up_tokenization_spaces": False}
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({**cfg, **(config or {})}, f)
    return tok.token_to_id("<image>"), tok.token_to_id("<pad>")


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

def _sample(dtype, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        return (torch.randn((3, 5), generator=g) * 3).to(dtype)
    if dtype == torch.bool:
        return torch.rand((4, 3), generator=g) > 0.5
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -1000), min(info.max, 1000), (7,), generator=g,
                         dtype=dtype)


DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int8, torch.uint8,
          torch.int32, torch.int64, torch.bool]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).removeprefix("torch."))
def test_safetensors_round_trips_against_the_library(tmp_path, dtype):
    from safetensors.torch import load_file, save_file

    ts = {"w": _sample(dtype, 0), "b.x": _sample(dtype, 1).reshape(-1)[:1],
          "s": _sample(dtype, 2).reshape(-1)[0], "empty": torch.empty((0, 4), dtype=dtype),
          "f32": _sample(torch.float32, 3)}
    write_safetensors(ts, tmp_path / "port.safetensors", {"format": "pt"})
    back = load_file(tmp_path / "port.safetensors")
    save_file(ts, tmp_path / "lib.safetensors")
    mine = read_safetensors(tmp_path / "lib.safetensors")
    for got in (back, mine):
        assert sorted(got) == sorted(ts)
        for k, v in ts.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape and torch.equal(got[k], v)


def test_safetensors_reader_raises_on_other_dtypes(tmp_path):
    from safetensors.torch import save_file

    save_file({"d": torch.zeros(3, dtype=torch.float64)}, tmp_path / "f64.safetensors")
    with pytest.raises(NotImplementedError, match="F64"):
        read_safetensors(tmp_path / "f64.safetensors")
    with pytest.raises(NotImplementedError, match="float64"):
        write_safetensors({"d": torch.zeros(3, dtype=torch.float64)}, tmp_path / "x.safetensors")


# ---------------------------------------------------------------------------
# the snapshot
# ---------------------------------------------------------------------------

def _hf_config(cfg):
    t, v = cfg.text, cfg.vision
    return {"model_type": "llava", "image_token_index": cfg.image_token_id,
            "pad_token_id": cfg.pad_token_id, "projector_hidden_act": "gelu",
            "vision_feature_layer": -2, "vision_feature_select_strategy": "default",
            "text_config": {"vocab_size": t.vocab_size, "hidden_size": t.hidden_size,
                            "intermediate_size": t.intermediate_size,
                            "num_hidden_layers": t.num_hidden_layers,
                            "num_attention_heads": t.num_attention_heads,
                            "num_key_value_heads": t.num_key_value_heads,
                            "max_position_embeddings": t.max_position_embeddings,
                            "rms_norm_eps": t.rms_norm_eps, "model_type": "llama"},
            "vision_config": {"hidden_size": v.hidden_size,
                              "intermediate_size": v.intermediate_size,
                              "num_hidden_layers": v.num_hidden_layers,
                              "num_attention_heads": v.num_attention_heads,
                              "image_size": v.image_size, "patch_size": v.patch_size,
                              "model_type": "clip_vision_model"}}


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A tiny LLaVA snapshot in the HF layout: config.json, two f32
    safetensors shards of the JAX initializer's weights, tokenizer files."""
    from safetensors.numpy import save_file

    path = str(tmp_path_factory.mktemp("snapshot"))
    image_id, pad_id = write_tokenizer(path, vocab_size=500)
    assert image_id == pad_id - 1
    cfg = j_tiny(pad_id + 1)           # <image> and <pad> are the model's last two ids
    params = jm.init_llava_params(cfg, jax.random.PRNGKey(0))
    state = {k: np.ascontiguousarray(np.asarray(v, np.float32))
             for k, v in j_hf.to_hf_state_dict(jax.tree.map(np.asarray, params), cfg).items()}
    names = sorted(state)
    half = len(names) // 2
    for i, part in enumerate((names[:half], names[half:])):
        save_file({k: state[k] for k in part},
                  os.path.join(path, f"model-{i + 1:05d}-of-00002.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(_hf_config(cfg), f)
    return path, cfg, params


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix: np.asarray(tree)}


def test_snapshot_loads_equal_through_both_packages(snapshot):
    path, cfg, params = snapshot
    tcfg = t_hf.llava_config_from_json(path)
    jcfg = j_hf.llava_config_from_json(path)
    assert tcfg.text.__dict__ == jcfg.text.__dict__ and tcfg.vision.__dict__ == jcfg.vision.__dict__
    assert (tcfg.image_token_id, tcfg.pad_token_id) == (cfg.image_token_id, cfg.pad_token_id)
    mine = _leaves(llava_params_to_numpy(t_hf.load_llava_safetensors(path, tcfg)))
    ref = _leaves(j_hf.load_llava_safetensors(path, jcfg))
    orig = _leaves(jax.tree.map(np.asarray, params))
    assert sorted(mine) == sorted(ref) == sorted(orig)
    for k in ref:
        assert mine[k].dtype == np.float32 and np.array_equal(mine[k], ref[k]), k
        assert np.array_equal(mine[k], orig[k]), k


def test_snapshot_loader_keeps_bf16_and_reads_the_old_naming_era(tmp_path, snapshot):
    """bf16 shards load as bf16 (JAX's numpy reader cannot read them); the
    old era's names (``language_model.model.*``, ``vision_tower.vision_model.*``)
    give the same tree; the port's export is the inverse of its import."""
    path, cfg, params = snapshot
    tcfg = t_hf.llava_config_from_json(path)
    loaded = t_hf.load_llava_safetensors(path, tcfg)
    new = t_hf.to_hf_state_dict(loaded, tcfg)
    old = {}
    for k, v in new.items():
        k = (k.replace("model.language_model.", "language_model.model.")
             .replace("model.vision_tower.", "vision_tower.")
             .replace("model.multi_modal_projector.", "multi_modal_projector.")
             .replace("lm_head.", "language_model.lm_head."))
        old[k] = v.to(torch.bfloat16)
    write_safetensors(old, tmp_path / "model.safetensors")
    for name in ("config.json", "tokenizer.json", "tokenizer_config.json"):
        with open(os.path.join(path, name)) as src, open(tmp_path / name, "w") as dst:
            dst.write(src.read())
    bf = _leaves(llava_params_to_numpy(t_hf.load_llava_safetensors(str(tmp_path), tcfg)))
    f32 = _leaves(llava_params_to_numpy(loaded))
    assert sorted(bf) == sorted(f32)
    for k, v in bf.items():
        assert v.dtype.name == "bfloat16", k
        assert np.array_equal(v.astype(np.float32),
                              torch.from_numpy(f32[k]).to(torch.bfloat16).float().numpy()), k


@pytest.mark.parametrize("tied", [False, True])
def test_causal_lm_state_dict_matches_jax(snapshot, tied):
    """A text-only LlamaForCausalLM state dict (``model.*`` names, its own
    ``lm_head`` or a tied embedding) imports to the same language-model
    tree in both packages."""
    path, cfg, _ = snapshot
    state = {}
    for shard in sorted(os.listdir(path)):
        if shard.endswith(".safetensors"):
            state.update({k: v.numpy() for k, v in read_safetensors(os.path.join(path, shard)).items()})
    lm = {k.replace("model.language_model.", "model."): v for k, v in state.items()
          if k.startswith("model.language_model.") or (k == "lm_head.weight" and not tied)}
    mine = _leaves(llava_params_to_numpy(t_hf.llama_from_causal_lm_state_dict(lm, cfg.text)))
    ref = _leaves(j_hf.llama_from_causal_lm_state_dict(lm, cfg.text))
    assert sorted(mine) == sorted(ref)
    for k in ref:
        assert np.array_equal(mine[k], ref[k]), k


def test_missing_snapshot_files_raise(tmp_path, snapshot):
    path, _, _ = snapshot
    with pytest.raises(FileNotFoundError, match="config.json"):
        t_hf.llava_config_from_json(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no safetensors"):
        t_hf.load_llava_safetensors(str(tmp_path), t_hf.llava_config_from_json(path))
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        HFTokenizer(str(tmp_path))
    # the entry: a snapshot without config.json, then one without a tokenizer
    cfg = {"NAME": "vl_test", "MODEL": {"LLM": {"LOAD_PATH": str(tmp_path), "BITS": 0}}}
    with pytest.raises(FileNotFoundError, match="config.json"):
        t_entry.evaluate(cfg, device="cpu")
    with open(tmp_path / "config.json", "w") as f, open(os.path.join(path, "config.json")) as g:
        f.write(g.read())
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        t_entry.evaluate(cfg, device="cpu")


# ---------------------------------------------------------------------------
# tokenizer.json
# ---------------------------------------------------------------------------

STRINGS = ["", " ", "  ", "hello", " hello", "hello ", "a  b", "What color is the car?",
           "A chat between a curious human <image> USER: what? ASSISTANT:",
           "<image>\nWhat is this?", "<image>", "<image><image>", "x<image>y", "<image> \n ",
           "café crème brûlée", "日本語のテキスト", "emoji 🙂 and 🚗!", "tab\tnew\nline", "</s>",
           "a</s>b", "<s>hi</s>", "<pad> pad", "ASSISTANT: red</s>", "Ünïcödé ÅÄÖ", "zzzz qqqq",
           "1,000 dollars", "don't stop", "  leading spaces", "trailing spaces   ", "<unk>",
           "\x00\x01", "mixed <image>\n<image> end"]


@pytest.mark.parametrize("form,image_token", [("legacy", True), ("legacy", False),
                                              ("metaspace", True), ("metaspace", False)])
def test_tokenizer_matches_transformers(tmp_path, form, image_token):
    """Ids and strings equal to JAX's ``HFTokenizer`` (transformers'
    ``AutoTokenizer``) on each string, decoded with and without special
    tokens; ``<image>`` is added where the snapshot lacks it."""
    write_tokenizer(str(tmp_path), form, image_token)
    ref, mine = JHFTokenizer(str(tmp_path)), HFTokenizer(str(tmp_path))
    for name in ("bos_token_id", "eos_token_id", "pad_token_id", "image_token_id"):
        assert getattr(mine, name) == getattr(ref, name), name
    for s in STRINGS:
        for special in (True, False):
            ids = ref.encode(s, add_special_tokens=special)
            assert mine.encode(s, add_special_tokens=special) == ids, (s, special)
        for skip in (True, False):
            assert mine.decode(ids, skip_special_tokens=skip) == ref.decode(ids, skip), (s, skip)
    # an id the vocabulary does not hold decodes to nothing, as in transformers
    far = [ref.bos_token_id, 5000, *ref.encode("hello", add_special_tokens=False)]
    assert mine.decode(far) == ref.decode(far)


def test_tokenizer_config_options_match_transformers(tmp_path):
    """add_eos_token, no bos, no pad token (pad = eos), and the clean-up of
    tokenization spaces."""
    write_tokenizer(str(tmp_path), config={"add_bos_token": False, "add_eos_token": True,
                                           "pad_token": None,
                                           "clean_up_tokenization_spaces": True})
    ref, mine = JHFTokenizer(str(tmp_path)), HFTokenizer(str(tmp_path))
    assert mine.pad_token_id == ref.pad_token_id == ref.eos_token_id
    for s in ("what is it ?", "a , b . c ! don 't", "<image>\nhi"):
        ids = ref.encode(s)
        assert mine.encode(s) == ids and mine.decode(ids) == ref.decode(ids), s


@pytest.mark.parametrize("edit,match", [
    (lambda t: t["model"].update(type="WordPiece"), "WordPiece"),
    (lambda t: t.update(normalizer={"type": "NFKC"}), "normalizer"),
    (lambda t: t.update(pre_tokenizer={"type": "ByteLevel"}), "ByteLevel"),
    (lambda t: t.update(decoder={"type": "ByteLevel"}), "decoder"),
    (lambda t: t["added_tokens"][-1].update(lstrip=True), "lstrip"),
])
def test_tokenizer_raises_on_what_it_does_not_implement(tmp_path, edit, match):
    write_tokenizer(str(tmp_path))
    with open(tmp_path / "tokenizer.json") as f:
        spec = json.load(f)
    edit(spec)
    with open(tmp_path / "tokenizer.json", "w") as f:
        json.dump(spec, f)
    with pytest.raises(NotImplementedError, match=match):
        HFTokenizer(str(tmp_path))


# ---------------------------------------------------------------------------
# entry.evaluate on vl_test
# ---------------------------------------------------------------------------

QUESTIONS = ["what is it?", "how many dogs are in the picture?", "What color is the car?",
             "Is there a person riding the bicycle?", "where is the cat"]


@pytest.fixture(scope="module")
def vqa_files(tmp_path_factory):
    """Five questions on three PNG images (two sizes), annotations for val."""
    from PIL import Image

    d = tmp_path_factory.mktemp("vqa")
    rng = np.random.default_rng(3)
    for image_id, hw in ((1, (40, 40)), (2, (30, 50)), (3, (56, 44))):
        Image.fromarray(rng.integers(0, 255, hw + (3,), dtype=np.uint8)).save(
            d / f"COCO_val2014_{image_id:012d}.jpg", format="PNG")
    qs = [{"question_id": 100 + i, "question": q, "image_id": 1 + i % 3}
          for i, q in enumerate(QUESTIONS)]
    with open(d / "q.json", "w") as f:
        json.dump({"questions": qs}, f)
    with open(d / "a.json", "w") as f:
        json.dump({"annotations": [{"question_id": q["question_id"], "question_type": "what",
                                    "answer_type": "other",
                                    "answers": [{"answer": a} for a in ["yes"] * 6 + ["two"] * 4]}
                                   for q in qs]}, f)
    return d


def _vl_cfg(snapshot_path, files, name, out_dir, **over):
    cfg = {"NAME": "vl_test", "PIPELINE": "LLaVAVQAVALPipeline", "BATCH_SIZE": 2,
           "MAX_NEW_TOKENS": 5, "LIMIT": 0, "SAVE_DIR": str(out_dir),
           "MODEL": {"LLM": {"LOAD_PATH": snapshot_path, "BITS": 0}},
           "DATASETS": {"TEST": [name], "REGISTER": {name: {
               "KIND": "vqa", "QUESTIONS_JSON": str(files / "q.json"),
               "ANNOTATIONS_JSON": str(files / "a.json"), "IMAGE_DIR": str(files)}}}}
    for k, v in over.items():
        if k == "BITS":
            cfg["MODEL"]["LLM"]["BITS"] = v
        else:
            cfg[k] = v
    return cfg


@pytest.mark.parametrize("case", [
    {"BITS": 0}, {"BITS": 4}, {"BITS": 0, "KV_QUANT": "int8"},
    {"BITS": 0, "PIPELINE": "LLaVAVQATESTPipeline"}], ids=["bits0", "bits4", "kv_int8", "testdev"])
def test_evaluate_vl_test_matches_jax(tmp_path, snapshot, vqa_files, case):
    """Both entries on one snapshot and one registered dataset: the same
    metrics dict and the same answers file (the val results, or the test-dev
    submission)."""
    path = snapshot[0]
    name = "vqa_" + "_".join(f"{k}{v}" for k, v in case.items()).lower()
    out = {}
    for pkg, run in (("jax", j_entry.evaluate), ("port", t_entry.evaluate)):
        cfg = _vl_cfg(path, vqa_files, f"{name}_{pkg}", tmp_path / pkg, **case)
        res = run(cfg) if pkg == "jax" else run(cfg, device="cpu")
        out[pkg] = res[f"{name}_{pkg}"]
    assert out["port"] == out["jax"]
    fname = ("vqa_submission.json" if case.get("PIPELINE") == "LLaVAVQATESTPipeline"
             else "vqa_results.json")
    with open(tmp_path / "jax" / fname) as f, open(tmp_path / "port" / fname) as g:
        ref, mine = json.load(f), json.load(g)
    assert mine == ref and len(mine) == len(QUESTIONS)
    assert any(r["answer"] for r in mine)        # the answers are not all empty strings


def test_bits4_quantizes_the_tiny_snapshot_as_jax(snapshot):
    """BITS 4 on the tiny snapshot: k and v ([64, 32]) take the byte-packed
    q4 layout (the path ``_mm`` reaches), the other targets planar NF4."""
    path = snapshot[0]
    _, params, _ = t_entry._build_llava({"MODEL": {"LLM": {"LOAD_PATH": path, "BITS": 4}}},
                                        torch.device("cpu"))
    layers = params["language_model"]["layers"]
    assert {t for t in layers if isinstance(layers[t], dict) and "q4" in layers[t]} == {"k", "v"}
    assert all("q4p" in layers[t] for t in ("q", "o", "gate", "up", "down"))


def test_evaluate_vl_test_keeps_raising_for_the_zoo_and_topics():
    """What the zoo and the topic classifier refuse (every tower runs, from
    a snapshot too: tests/test_torch_zoo*.py, test_torch_instructblip.py,
    test_torch_kosmos2.py): BakLLaVA without ``MODEL.ZOO_PATH`` (as JAX's
    entry), a ``ZOO_PATH`` without its files, and a topic classifier the
    entry does not know (``tiny`` and snapshots run:
    tests/test_torch_topic.py)."""
    with pytest.raises(SystemExit, match="bakllava needs MODEL.ZOO_PATH"):
        t_entry.evaluate({"NAME": "vl_test", "MODEL": {"ZOO": "bakllava"}}, device="cpu")
    with pytest.raises(FileNotFoundError, match="config.json"):
        t_entry.evaluate({"NAME": "vl_test", "MODEL": {"ZOO": "instructblip", "ZOO_PATH": "/x"}},
                         device="cpu")
    with pytest.raises(ValueError, match="MODEL.TOPIC"):
        t_entry.evaluate({"NAME": "vl_test", "MODEL": {"TOPIC": "small"}}, device="cpu")
    with pytest.raises(ValueError, match="ROOT"):
        t_entry.evaluate({"NAME": "vl_test", "DATASETS": {"REGISTER": {
            "x": {"KIND": "imagenet"}}}}, device="cpu")


# ---------------------------------------------------------------------------
# serving/io
# ---------------------------------------------------------------------------

def test_serving_io_decodes_an_image_path(tmp_path):
    """An image file in a request row is decoded and CLIP-preprocessed as
    the JAX package's ``load_pixels`` does it: the bicubic resizes of the two
    libraries agree to ~4e-6 on [0, 1] pixels, ~1.5e-5 after the division by
    the CLIP std (~0.27), hence 3e-5."""
    from PIL import Image

    rng = np.random.default_rng(7)
    Image.fromarray(rng.integers(0, 255, (37, 52, 3), dtype=np.uint8)).save(tmp_path / "a.png")
    for side in (28, 336):
        mine = t_load_pixels(str(tmp_path / "a.png"), side)
        ref = np.asarray(j_load_pixels(str(tmp_path / "a.png"), side))
        assert mine.shape == ref.shape == (3, side, side) and mine.dtype == np.float32
        np.testing.assert_allclose(mine, ref, atol=3e-5, rtol=0)
