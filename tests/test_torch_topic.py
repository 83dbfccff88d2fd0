"""The question-topic classifier (``MODEL.TOPIC``) of the torch port against
the JAX package: ``topic_prompt`` and the byte tokenizers, the text-only
LLaMA snapshot reader (``config.json`` and safetensors against JAX's
``llama_from_causal_lm_state_dict``), the tokenizer wrappers against
``AutoTokenizer`` (LLaMA's bos) and ``CLIPTokenizerFast(padding=True)``,
``make_tiny_topic_fn`` on JAX's tiny weights and ``make_reference_topic_fn``
from tiny ``LlamaForCausalLM`` / ``CLIPTextModelWithProjection`` snapshots
written here by transformers, and ``entry.evaluate`` on vl_test with
``MODEL.TOPIC: tiny`` (the per-class CSV).

The two packages draw their samples from different generators, so JAX's
noise is replayed through ``modeling.gumbel_noise``: the port gives each
question a generator seeded from one CPU generator, and the replay maps
that seed to the key JAX splits off ``PRNGKey(seed)`` for the same
question, then follows JAX's chain per token.  The classes must be equal.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cullavo_tpu import entry as j_entry
from cullavo_tpu.checkpoint import hf_import as j_hf
from cullavo_tpu.models.llava import modeling as j_llava
from cullavo_tpu.models.llava.config import LlamaConfig as JLlamaConfig
from cullavo_tpu.models.llava.config import tiny_llava_config as j_tiny_llava
from cullavo_tpu.models.xdecoder import text_encoder as j_text
from cullavo_tpu.pipelines import vqa_pipeline as j_vqa
from cullavo_tpu_torch import entry as t_entry
from cullavo_tpu_torch.checkpoint import hf_import as t_hf
from cullavo_tpu_torch.checkpoint.from_jax import llava_params_from_numpy, topic_params_from_numpy
from cullavo_tpu_torch.data.tokenizer import ByteTokenizer
from cullavo_tpu_torch.models.llava import modeling as t_llava
from cullavo_tpu_torch.models.llava.config import tiny_llava_config as t_tiny_llava
from cullavo_tpu_torch.models.xdecoder.text_encoder import TextEncoderConfig
from cullavo_tpu_torch.pipelines import vqa_pipeline as t_vqa
from test_torch_joint_data import chip_smoke
from test_torch_vl_eval import write_tokenizer


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# short and long: the byte prompts land in the 256 and the 320 buckets
QUESTIONS = ["what is it?", "how many dogs are there?",
             "is the woman on the left holding a red umbrella in her hand while she waits?",
             "where is the cat sleeping?"]
CLASSES = ["car", "dog", "person", "umbrella", "cat", "bed", "tree"]
SEED = 3


class TopicNoise:
    """``modeling.gumbel_noise`` with JAX's draws: the port's question i
    samples from a generator seeded ``subs[i]`` (from ``torch.Generator()
    .manual_seed(seed)``, one draw a question), JAX's from the i-th key
    split off ``PRNGKey(seed)``; each token then takes the next split of
    that key, as JAX's ``generate`` does."""

    def __init__(self, seed, n):
        master = torch.Generator().manual_seed(seed)
        subs = [int(torch.randint(0, 2 ** 62, (1,), generator=master)) for _ in range(n)]
        key, self.keys = jax.random.PRNGKey(seed), {}
        for s in subs:
            key, sub = jax.random.split(key)
            self.keys[s] = sub
        self.calls = 0

    def __call__(self, shape, generator, device):
        rng, sub = jax.random.split(self.keys[generator.initial_seed()])
        self.keys[generator.initial_seed()] = rng
        self.calls += 1
        return torch.from_numpy(np.array(jax.random.gumbel(sub, tuple(shape), jnp.float32)))


def test_topic_prompt_and_byte_tokenizers_match_jax():
    for q in QUESTIONS:
        assert t_vqa.topic_prompt(q) == j_vqa.topic_prompt(q)
    buckets = {t_vqa._bucket(len(ByteTokenizer().encode(t_vqa.topic_prompt(q))))
               for q in QUESTIONS}
    assert buckets == {256, 320}
    texts = ["a photo of a dog", "x" * 200, ""]
    for kw in ({}, {"max_len": 64, "eot_is_max": True}):
        mine, ref = t_vqa._ByteHFTok(260, **kw), j_vqa._ByteHFTok(260, **kw)
        for a, b in zip(mine(texts).values(), ref(texts).values()):
            np.testing.assert_array_equal(a, b)
        assert mine.decode([40, 41, 2, 300]) == ref.decode([40, 41, 2])
        assert mine.eos_token_id == ref.eos_token_id


@pytest.fixture(scope="module")
def tiny_towers():
    """JAX's tiny towers as ``make_tiny_topic_fn`` builds them (seed
    ``SEED``): the LLaMA of ``tiny_llava_config(260)`` and the 2-layer CLIP
    text tower, as numpy."""
    lcfg = j_tiny_llava(260)
    lm = jax.tree.map(np.asarray, jax.jit(lambda k: j_llava.init_llava_params(lcfg, k))(
        jax.random.PRNGKey(SEED))["language_model"])
    ccfg = j_text.TextEncoderConfig(width=32, heads=4, layers=2, dim_lang=32, vocab_size=260,
                                    context_length=64)
    clip = jax.tree.map(np.asarray, j_text.init_text_encoder_params(
        ccfg, jax.random.PRNGKey(SEED + 1)))
    return {"language_model": lm}, clip


def _port_tiny(monkeypatch, towers):
    """The port's tiny classifier built on JAX's configs and weights."""
    lparams, cparams = topic_params_from_numpy(*towers, "cpu")
    monkeypatch.setattr(t_vqa, "tiny_topic_configs", lambda: (
        t_tiny_llava(260), TextEncoderConfig(width=32, heads=4, layers=2, dim_lang=32,
                                             vocab_size=260, context_length=64)))
    monkeypatch.setattr(t_vqa, "init_llama_params",
                        lambda cfg, gen, dev, dtype: lparams["language_model"])
    monkeypatch.setattr(t_vqa, "init_text_encoder_params", lambda cfg, gen, dev: cparams)


def test_tiny_topic_fn_matches_jax_with_its_noise(monkeypatch, tiny_towers):
    _port_tiny(monkeypatch, tiny_towers)
    noise = TopicNoise(SEED, len(QUESTIONS))
    monkeypatch.setattr(t_llava, "gumbel_noise", noise)
    ref_fn = j_vqa.make_tiny_topic_fn(class_names=CLASSES, seed=SEED, max_new_tokens=6)
    mine = t_vqa.make_tiny_topic_fn(class_names=CLASSES, seed=SEED, max_new_tokens=6,
                                    device="cpu")
    got = [mine(q) for q in QUESTIONS]
    assert got == [ref_fn(q) for q in QUESTIONS]
    assert 0 < noise.calls <= 6 * len(QUESTIONS)
    # the default classes are COCO's 91 semantic names
    default = t_vqa.make_tiny_topic_fn(seed=SEED, max_new_tokens=2, device="cpu")
    assert default(QUESTIONS[0]) in t_vqa.constants.COCO_SEMANTIC_CLASSES


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """A text-only LlamaForCausalLM (GQA, untied head, f32 safetensors) with a
    dense LLaMA-style tokenizer.json, and a CLIPTextModelWithProjection with
    a CLIP vocab.json + merges.txt whose <|endoftext|> is the highest id,
    both written by transformers."""
    import transformers

    root = tmp_path_factory.mktemp("topic_snapshots")
    llama_dir, clip_dir = str(root / "llama"), str(root / "clip")
    _, pad_id = write_tokenizer(llama_dir, image_token=False, vocab_size=500)
    torch.manual_seed(0)
    lm = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=pad_id + 1, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512,
        rms_norm_eps=1e-5, bos_token_id=1, eos_token_id=2, pad_token_id=pad_id))
    lm.save_pretrained(llama_dir, safe_serialization=True)
    n_ids = 2048
    clip = transformers.CLIPTextModelWithProjection(transformers.CLIPTextConfig(
        vocab_size=n_ids, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, projection_dim=24, max_position_embeddings=77))
    clip.save_pretrained(clip_dir, safe_serialization=True)
    corpus = [f"a photo of {c}" for c in t_vqa.constants.COCO_SEMANTIC_CLASSES] * 3
    chip_smoke().write_clip_tokenizer(clip_dir, corpus, n_ids=n_ids)
    with open(os.path.join(clip_dir, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "CLIPTokenizer", "model_max_length": 77}, f)
    return llama_dir, clip_dir


def test_llama_snapshot_reads_as_jax(snapshots):
    """``llama_config_from_json`` has the fields JAX's classifier reads, and
    the snapshot's weights equal JAX's import of transformers' state dict."""
    import transformers

    llama_dir, _ = snapshots
    hf = transformers.AutoModelForCausalLM.from_pretrained(llama_dir)
    hc = hf.config
    cfg = t_hf.llama_config_from_json(llama_dir)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JLlamaConfig(
        vocab_size=hc.vocab_size, hidden_size=hc.hidden_size,
        intermediate_size=hc.intermediate_size, num_hidden_layers=hc.num_hidden_layers,
        num_attention_heads=hc.num_attention_heads, num_key_value_heads=hc.num_key_value_heads,
        max_position_embeddings=hc.max_position_embeddings, rms_norm_eps=hc.rms_norm_eps,
        rope_theta=getattr(hc, "rope_theta", 10000.0), sliding_window=None))
    want = j_hf.llama_from_causal_lm_state_dict(
        {k: v.detach().numpy() for k, v in hf.state_dict().items()}, cfg)
    got = t_hf.load_llama_causal_lm_safetensors(llama_dir, cfg)
    assert jax.tree.structure(want) == jax.tree.structure(
        jax.tree.map(lambda t: 0, got, is_leaf=torch.is_tensor))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got, is_leaf=torch.is_tensor)):
        assert b.dtype == torch.float32 and np.array_equal(b.numpy(), a)


def test_tokenizer_wrappers_match_transformers(snapshots):
    """LLaMA: bos first, as ``AutoTokenizer(prompt)``; CLIP: bos, ids, eos,
    rows padded with <|endoftext|> to the longest, as
    ``CLIPTokenizerFast(texts, padding=True)``, whose pad is the highest id."""
    import transformers

    from cullavo_tpu_torch.data.clip_tokenizer import CLIPTokenizer
    from cullavo_tpu_torch.data.tokenizer import HFTokenizer

    llama_dir, clip_dir = snapshots
    lt = t_vqa._LlamaTokCall(HFTokenizer(llama_dir))
    hf_lt = transformers.AutoTokenizer.from_pretrained(llama_dir)
    for q in QUESTIONS:
        ids = lt(t_vqa.topic_prompt(q), return_tensors="np")["input_ids"]
        np.testing.assert_array_equal(ids, hf_lt(t_vqa.topic_prompt(q),
                                                 return_tensors="np")["input_ids"])
        assert ids[0, 0] == hf_lt.bos_token_id
    assert lt.eos_token_id == hf_lt.eos_token_id
    ct = t_vqa._ClipTokCall(CLIPTokenizer.from_dir(clip_dir))
    hf_ct = transformers.AutoTokenizer.from_pretrained(clip_dir)
    texts = [f"a photo of {c}" for c in CLASSES] + ["a photo of ", "a photo of traffic light"]
    got, want = ct(texts, padding=True), hf_ct(texts, padding=True, return_tensors="np")
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[key], want[key])
    assert hf_ct.pad_token_id == got["input_ids"].max() == len(hf_ct) - 1


def test_reference_topic_fn_matches_jax_with_its_noise(monkeypatch, snapshots):
    llama_dir, clip_dir = snapshots
    noise = TopicNoise(SEED, len(QUESTIONS))
    monkeypatch.setattr(t_llava, "gumbel_noise", noise)
    ref_fn = j_vqa.make_reference_topic_fn(llama_dir, clip_dir, class_names=CLASSES, seed=SEED,
                                           max_new_tokens=6)
    mine = t_vqa.make_reference_topic_fn(llama_dir, clip_dir, class_names=CLASSES, seed=SEED,
                                         max_new_tokens=6, device="cpu")
    assert [mine(q) for q in QUESTIONS] == [ref_fn(q) for q in QUESTIONS]
    assert noise.calls > 0


@pytest.fixture(scope="module")
def vqa_files(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("vqa_topic")
    rng = np.random.default_rng(5)
    for image_id, hw in ((1, (40, 40)), (2, (30, 50))):
        Image.fromarray(rng.integers(0, 255, hw + (3,), dtype=np.uint8)).save(
            d / f"COCO_val2014_{image_id:012d}.jpg", format="PNG")
    qs = [{"question_id": 300 + i, "question": q, "image_id": 1 + i % 2}
          for i, q in enumerate(QUESTIONS)]
    with open(d / "q.json", "w") as f:
        json.dump({"questions": qs}, f)
    with open(d / "a.json", "w") as f:
        json.dump({"annotations": [{"question_id": q["question_id"], "question_type": "what",
                                    "answer_type": "other",
                                    "answers": [{"answer": a} for a in ["yes"] * 6 + ["two"] * 4]}
                                   for q in qs]}, f)
    return d


def test_evaluate_vl_test_with_tiny_topics_matches_jax(tmp_path, monkeypatch, vqa_files):
    """``entry.evaluate`` on vl_test with ``MODEL.TOPIC: tiny`` and
    ``SAVE_DIR`` in both packages: the port's smoke LLaVA and topic towers
    made JAX's (seed 0), JAX's noise replayed; the metrics, the answers
    file and the per-class CSV equal.  Another ``MODEL.TOPIC`` raises."""
    lcfg = j_tiny_llava(260)
    jparams = jax.tree.map(np.asarray, jax.jit(lambda k: j_llava.init_llava_params(lcfg, k))(
        jax.random.PRNGKey(0)))
    ccfg = j_text.TextEncoderConfig(width=32, heads=4, layers=2, dim_lang=32, vocab_size=260,
                                    context_length=64)
    clip = jax.tree.map(np.asarray, j_text.init_text_encoder_params(ccfg, jax.random.PRNGKey(1)))
    _port_tiny(monkeypatch, ({"language_model": jparams["language_model"]}, clip))
    monkeypatch.setattr(t_entry, "_build_llava", lambda cfg, dev: (
        t_tiny_llava(260), llava_params_from_numpy(jparams, dev), ByteTokenizer()))
    monkeypatch.setattr(t_llava, "gumbel_noise", TopicNoise(0, len(QUESTIONS)))
    out = {}
    for pkg, run in (("jax", j_entry.evaluate), ("port", t_entry.evaluate)):
        name = f"vl_topic_{pkg}"
        cfg = {"NAME": "vl_test", "BATCH_SIZE": 4, "MAX_NEW_TOKENS": 4,
               "SAVE_DIR": str(tmp_path / pkg), "MODEL": {"TOPIC": "tiny"},
               "DATASETS": {"TEST": [name], "REGISTER": {name: {
                   "KIND": "vqa", "QUESTIONS_JSON": str(vqa_files / "q.json"),
                   "ANNOTATIONS_JSON": str(vqa_files / "a.json"), "IMAGE_DIR": str(vqa_files)}}}}
        res = run(cfg) if pkg == "jax" else run(cfg, device="cpu")
        out[pkg] = res[name]
    assert out["port"] == out["jax"] and out["port"]["n"] == len(QUESTIONS)
    for fname in ("vqa_results.json", "vqa_per_class.csv"):
        with open(os.path.join(tmp_path, "jax", fname)) as f, \
                open(os.path.join(tmp_path, "port", fname)) as g:
            assert g.read() == f.read(), fname
    with pytest.raises(ValueError, match="MODEL.TOPIC"):
        t_entry.evaluate({"NAME": "vl_test", "MODEL": {"TOPIC": "huge"}}, device="cpu")
