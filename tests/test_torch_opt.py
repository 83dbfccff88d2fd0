"""BLIP-2 OPT in the torch port against the JAX package and the HF
libraries, on the CPU at tiny widths: the OPT decoder's prefill and stale
one-token step (f32, atol 1e-4), greedy and beam decoding on
``tiny_blip2_config("opt")`` token for token from JAX's weights, a tiny
blip2-opt snapshot (transformers' ``save_pretrained``) read bit for bit as
JAX's ``import_blip2_torch`` reads the live module, plus the EVA-ViT-g
biases JAX drops, and written back by the port's exporter; the byte-level
BPE tokenizer against ``tokenizers`` and transformers; the snapshot
answerer against JAX's; and the checkpoint-free answerer, which builds an
OPT tower where JAX's builds the tiny T5 one.

JAX's decoders are jitted for the file (``test_torch_zoo.jit_decode``).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import tokenizers
import transformers

from cullavo_tpu.models.blip2 import config as j_cfg
from cullavo_tpu.models.blip2 import import_blip2_torch
from cullavo_tpu.models.blip2 import modeling as j_mod
from cullavo_tpu.models.blip2 import opt as j_opt
from cullavo_tpu.pipelines import vl_zoo_pipeline as j_zoo
from cullavo_tpu_torch.checkpoint import zoo_import as zi
from cullavo_tpu_torch.checkpoint.from_jax import blip2_params_from_numpy
from cullavo_tpu_torch.data import tokenizer_json as tj
from cullavo_tpu_torch.models.blip2 import config as t_cfg
from cullavo_tpu_torch.models.blip2 import modeling as t_mod
from cullavo_tpu_torch.models.blip2 import opt as t_opt
from cullavo_tpu_torch.pipelines import vl_zoo_pipeline as t_zoo
from test_torch_joint_data import chip_smoke
from test_torch_zoo import jit_decode
from test_torch_zoo_snapshots import _hf_vision, _image_config, _rewrite, _same_as_files, _same_tree

OPT_VOCAB = 400          # the byte-level tokenizer written here: 4 specials, 256 bytes, merges
QUESTIONS = ["What is the color of the car?", "How many dogs are there?",
             "Is the man riding a bicycle?"]
NEW = 4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _jitted_jax_decoders():
    saved = [(j_mod, "blip2_beam_generate"), (j_mod, "blip2_generate"),
             (j_mod, "init_blip2_params")]
    originals = [getattr(m, n) for m, n in saved]
    j_mod.blip2_beam_generate = jit_decode(j_mod.blip2_beam_generate, (
        "cfg", "max_new_tokens", "num_beams", "length_penalty", "eos_token_id", "pad_token_id",
        "compute_dtype"))
    j_mod.blip2_generate = jit_decode(j_mod.blip2_generate, (
        "cfg", "max_new_tokens", "eos_token_id", "compute_dtype"))
    j_mod.init_blip2_params = jit_decode(j_mod.init_blip2_params, ("cfg", "dtype"))
    yield
    for (m, n), f in zip(saved, originals):
        setattr(m, n, f)


def tiny_opt(cfg_mod, vocab=None):
    cfg = cfg_mod.tiny_blip2_config("opt")
    if vocab is None:
        return cfg
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, vocab_size=vocab))


@pytest.fixture(scope="module")
def weights():
    """JAX's tiny BLIP-2 OPT weights (nonzero biases drawn in, so that every
    bias leaf is exercised), as numpy and as the port's tree."""
    cfg = tiny_opt(j_cfg)
    params = jax.tree.map(np.asarray, j_mod.init_blip2_params(cfg, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(4)
    lm = params["language_model"]
    for k in list(lm["layers"]):
        if k.endswith("_b"):
            lm["layers"][k] = (rng.normal(size=lm["layers"][k].shape) * 0.1).astype(np.float32)
    lm["final_ln_b"] = (rng.normal(size=lm["final_ln_b"].shape) * 0.1).astype(np.float32)
    return params, blip2_params_from_numpy(params, "cpu")


def test_opt_forward_prefill_and_stale_step_match_jax(weights):
    """A right-padded prefill into a cache (slot 0), then one stale step per
    row at its next slot, and a forward without a cache: hidden states and
    caches within 1e-4 of JAX's (f32)."""
    params, tparams = weights
    jc, tc = tiny_opt(j_cfg).text, tiny_opt(t_cfg).text
    jlm, tlm = params["language_model"], tparams["language_model"]
    rng = np.random.default_rng(0)
    B, T, S, D = 2, 6, 9, jc.hidden_size
    emb = rng.normal(size=(B, T, D)).astype(np.float32)
    mask0 = np.ones((B, T), np.int32)
    mask0[1, 4:] = 0
    pos0 = np.array(j_opt.opt_position_ids(jnp.asarray(mask0)))
    assert np.array_equal(t_opt.opt_position_ids(torch.from_numpy(mask0)).numpy(), pos0)
    full = np.concatenate([mask0, np.zeros((B, S - T), np.int32)], 1)
    kpos = np.concatenate([pos0, np.zeros((B, S - T), pos0.dtype)], 1)

    jh, jcache = j_opt.opt_forward(jlm, jc, jnp.asarray(emb), jnp.asarray(full),
                                   jnp.asarray(pos0), j_opt.opt_init_cache(jc, B, S), 0,
                                   jnp.asarray(kpos))
    tcache = t_opt.opt_init_cache(tc, B, S)
    th, tcache = t_opt.opt_forward(tlm, tc, torch.from_numpy(emb), torch.from_numpy(full),
                                   torch.from_numpy(pos0), tcache, 0, torch.from_numpy(kpos))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4)
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]), atol=1e-4)

    step = rng.normal(size=(B, 1, D)).astype(np.float32)
    new_pos = (pos0[np.arange(B), mask0.sum(1) - 1] + 1)[:, None]
    jh, jcache = j_opt.opt_forward(jlm, jc, jnp.asarray(step), jnp.asarray(full),
                                   jnp.asarray(new_pos), jcache, T, jnp.asarray(kpos),
                                   stale_cache=True)
    th, tcache = t_opt.opt_forward(tlm, tc, torch.from_numpy(step), torch.from_numpy(full),
                                   torch.from_numpy(new_pos), tcache, T, torch.from_numpy(kpos),
                                   stale_cache=True)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4)
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]), atol=1e-4)

    jh, _ = j_opt.opt_forward(jlm, jc, jnp.asarray(emb), jnp.asarray(mask0), jnp.asarray(pos0))
    th, none = t_opt.opt_forward(tlm, tc, torch.from_numpy(emb), torch.from_numpy(mask0),
                                 torch.from_numpy(pos0))
    assert none is None
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4)


def test_blip2_opt_generate_and_beam_match_jax(weights):
    """The logits of [queries; prompt], greedy and beam 5 (length penalty
    -1) decoding over right-padded prompts: token for token."""
    params, tparams = weights
    jc, tc = tiny_opt(j_cfg), tiny_opt(t_cfg)
    rng = np.random.default_rng(1)
    pix = rng.normal(size=(2, 3, 28, 28)).astype(np.float32)
    ids = rng.integers(4, jc.text.vocab_size, size=(2, 7)).astype(np.int32)
    mask = np.ones((2, 7), np.int32)
    mask[1, 5:] = 0
    jp = jax.tree.map(jnp.asarray, params)
    targs = (torch.from_numpy(pix), torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    want = j_mod.blip2_forward(jp, jc, pix, ids, mask)
    np.testing.assert_allclose(t_mod.blip2_forward(tparams, tc, *targs).numpy(),
                               np.asarray(want), atol=1e-4)
    for eos in (-1, 5):
        want = j_mod.blip2_generate(jp, jc, pix, ids, mask, 6, eos_token_id=eos)
        got = t_mod.blip2_generate(tparams, tc, *targs, 6, eos_token_id=eos)
        assert np.array_equal(got.numpy(), np.asarray(want)), (got, want)
    want = j_mod.blip2_beam_generate(jp, jc, pix, ids, mask, 5, num_beams=5,
                                     length_penalty=-1.0, eos_token_id=7, pad_token_id=1)
    got = t_mod.blip2_beam_generate(tparams, tc, *targs, 5, num_beams=5, length_penalty=-1.0,
                                    eos_token_id=7, pad_token_id=1)
    assert np.array_equal(got.numpy(), np.asarray(want)), (got, want)


def hf_blip2_opt(seed, vision_biases=False):
    """A tiny Blip2ForConditionalGeneration over OPT of ``tiny_opt``'s widths
    (the tokenizer's vocabulary); ``vision_biases``: nonzero patch and q / v
    biases, as an EVA-ViT-g checkpoint has."""
    cfg = tiny_opt(j_cfg, OPT_VOCAB)
    q, t = cfg.qformer, cfg.text
    qf = dict(hidden_size=q.hidden_size, num_hidden_layers=q.num_hidden_layers,
              num_attention_heads=q.num_attention_heads, intermediate_size=q.intermediate_size,
              cross_attention_frequency=q.cross_attention_frequency,
              encoder_hidden_size=q.encoder_hidden_size, vocab_size=q.vocab_size,
              max_position_embeddings=q.max_position_embeddings, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
    text = transformers.OPTConfig(
        vocab_size=t.vocab_size, hidden_size=t.hidden_size, ffn_dim=t.ffn_dim,
        num_hidden_layers=t.num_hidden_layers, num_attention_heads=t.num_attention_heads,
        max_position_embeddings=t.max_position_embeddings, word_embed_proj_dim=t.hidden_size,
        do_layer_norm_before=True, activation_function="relu", dropout=0.0,
        attention_dropout=0.0, activation_dropout=0.0, layerdrop=0.0, pad_token_id=1,
        bos_token_id=2, eos_token_id=2)
    hf_cfg = transformers.Blip2Config(
        vision_config=_hf_vision(transformers.Blip2VisionConfig, cfg.vision),
        qformer_config=qf, text_config=text.to_dict(), num_query_tokens=cfg.num_query_tokens)
    torch.manual_seed(seed)
    model = transformers.Blip2ForConditionalGeneration(hf_cfg).eval()
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        dec = model.language_model.model.decoder
        for layer in dec.layers:         # transformers zeroes the biases at init
            for lin in (layer.self_attn.q_proj, layer.self_attn.k_proj, layer.self_attn.v_proj,
                        layer.self_attn.out_proj, layer.fc1, layer.fc2):
                lin.bias.copy_(torch.randn(lin.bias.shape, generator=g) * 0.1)
        if vision_biases:
            D = cfg.vision.hidden_size
            emb = model.vision_model.embeddings.patch_embedding
            emb.bias.copy_(torch.randn(emb.bias.shape, generator=g) * 0.5)
            for layer in model.vision_model.encoder.layers:
                b = torch.randn(3 * D, generator=g) * 0.5
                b[D:2 * D] = 0.0
                layer.self_attn.qkv.bias.copy_(b)
    return model


def write_opt_snapshot(path, seed=0, vision_biases=False, quiet_specials=False):
    """The tiny blip2-opt snapshot: ``save_pretrained`` weights, the
    byte-level tokenizer of ``chip_smoke.write_bytelevel_tokenizer``, the
    BLIP image processor's config.  ``quiet_specials``: the tied head's rows
    of the special ids zeroed (a random tower's answers are then not empty).
    Returns the HF module."""
    path = str(path)
    chip_smoke().write_bytelevel_tokenizer(path, OPT_VOCAB)
    _image_config(path, "blip")
    model = hf_blip2_opt(seed, vision_biases)
    if quiet_specials:
        with torch.no_grad():
            model.get_output_embeddings().weight[:4] = 0.0
    model.save_pretrained(path, safe_serialization=True)
    return model


def test_opt_snapshot_matches_jax_import(tmp_path):
    """The port's tree equals ``import_blip2_torch``'s on the live module,
    plus the two vision biases JAX drops; the exporter writes the files'
    tensors back; the tied head read under either name (a copy that
    differs raises); config.json held to the config both ways."""
    hf = write_opt_snapshot(tmp_path, seed=5, vision_biases=True)
    jcfg, tcfg = tiny_opt(j_cfg, OPT_VOCAB), tiny_opt(t_cfg, OPT_VOCAB)
    ref = import_blip2_torch(hf, jcfg)
    zi.check_blip2_config(str(tmp_path), tcfg)
    mine = zi.load_blip2_safetensors(str(tmp_path), tcfg)
    assert _same_tree(mine, ref) == ["/vision/layers/qkv_b", "/vision/patch_b"]
    _same_as_files(str(tmp_path), zi.blip2_to_hf_state_dict(mine, tcfg))

    embed = "language_model.model.decoder.embed_tokens.weight"
    head = "language_model.lm_head.weight"
    _rewrite(tmp_path, lambda t: t.__setitem__(head, t.pop(embed)))
    again = zi.load_blip2_safetensors(str(tmp_path), tcfg)
    assert _same_tree(again, ref) == ["/vision/layers/qkv_b", "/vision/patch_b"]
    _rewrite(tmp_path, lambda t: t.__setitem__(embed, t[head] + 1.0))
    with pytest.raises(ValueError, match="differs.*tied in OPT"):
        zi.load_blip2_safetensors(str(tmp_path), tcfg)

    with open(tmp_path / "config.json") as f:
        hf_cfg = json.load(f)
    for path, value in (("ffn_dim", 128), ("word_embed_proj_dim", 16), ("vocab_size", 50272)):
        bad = json.loads(json.dumps(hf_cfg))
        bad["text_config"][path] = value
        with open(tmp_path / "config.json", "w") as f:
            json.dump(bad, f)
        with pytest.raises(ValueError, match=f"text_config.{path}"):
            zi.check_blip2_config(str(tmp_path), tcfg)
    with pytest.raises(ValueError, match="runs only the published configuration"):
        zi.check_blip2_config(str(tmp_path), t_cfg.Blip2Config())


@pytest.mark.parametrize("n_vocab", [OPT_VOCAB, 50265], ids=["tiny", "published"])
def test_bytelevel_bpe_matches_tokenizers(tmp_path, n_vocab):
    """Ids against ``tokenizers`` and transformers' GPT2TokenizerFast on
    Unicode letters, digits, runs of spaces, tabs and newlines, contractions
    and a trailing space; decode against transformers'; GPT-2's split
    against the ``regex`` package on the same texts; other fields refused."""
    import regex

    ids = chip_smoke().write_bytelevel_tokenizer(str(tmp_path), n_vocab)
    ref = tokenizers.Tokenizer.from_file(str(tmp_path / "tokenizer.json"))
    hf = transformers.AutoTokenizer.from_pretrained(str(tmp_path))
    mine = tj.TokenizerJSON(str(tmp_path))
    assert len(hf) == n_vocab and mine.eos_token_id == hf.eos_token_id == ids["</s>"]
    assert mine.pad_token_id == hf.pad_token_id == ids["<pad>"]
    pat = regex.compile(r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"""
                        r"""| ?[^\s\p{L}\p{N}]+"""
                        r"""|\s+(?!\S)|\s+""")
    texts = ["Question: What is the color of the car? Answer:",
             "  two   spaces and\ttabs\n\nnewlines ", "it's the dog's; we'll they've I'm 'tis",
             "Ünïcödé lettérs 日本語 ١٢٣ 4567 x²", "trailing space ", "", "caf́e　 </s>",
             "a b   c"]
    for s in texts:
        assert tj.gpt2_split(s) == pat.findall(s), s
        want = ref.encode(s).ids
        assert mine.encode(s) == want == hf(s)["input_ids"], s
        assert mine.encode(s)[0] == ids["</s>"]
        assert mine.decode(want) == hf.decode(want, skip_special_tokens=True), s
        assert mine.decode(want, skip_special_tokens=False) == hf.decode(want), s
    spec = json.loads((tmp_path / "tokenizer.json").read_text(encoding="utf-8"))
    for field, change in (("pre_tokenizer", {"use_regex": False}), ("model", {"dropout": 0.1}),
                          ("decoder", {"type": "BPEDecoder"})):
        bad = json.loads(json.dumps(spec))
        bad[field].update(change)
        (tmp_path / "tokenizer.json").write_text(json.dumps(bad), encoding="utf-8")
        with pytest.raises(NotImplementedError, match="not read by the port"):
            tj.TokenizerJSON(str(tmp_path))


def _images():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 256, (28, 28, 3), dtype=np.uint8) for _ in range(2)]


def test_opt_snapshot_answerer_matches_jax(tmp_path, monkeypatch):
    """``_hf_blip2_answer_fn(kind="opt")`` (beam 5, length penalty -1) on the
    tiny snapshot, both packages' published config monkeypatched to the
    tiny one: the same answers, string for string."""
    write_opt_snapshot(tmp_path, seed=11, quiet_specials=True)
    for mod, cfg_mod in ((j_zoo, j_cfg), (t_zoo, t_cfg)):
        monkeypatch.setattr(mod, "_blip2_cfg_cls", lambda kind, cm=cfg_mod: (
            tiny_opt(cm, OPT_VOCAB), "Blip2ForConditionalGeneration"))
    j_fn = j_zoo.native_blip2_answer_fn(hf_model_dir=str(tmp_path), max_new_tokens=NEW,
                                        kind="opt")
    t_fn = t_zoo.native_blip2_answer_fn(hf_model_dir=str(tmp_path), max_new_tokens=NEW,
                                        kind="opt", device="cpu")
    got, want = [], []
    for q, im in zip(QUESTIONS, _images() * 2):
        want.append(j_fn(q, im))
        got.append(t_fn(q, im))
    assert got == want and all(want), (got, want)


def test_checkpoint_free_opt_answerer(weights, monkeypatch):
    """Without a checkpoint: given JAX's tiny OPT weights, the answers equal
    JAX's; with no ``model_cfg`` the port builds ``tiny_blip2_config("opt")``
    (JAX builds the tiny T5 tower for kind="opt", ROADMAP.md queue 3) and
    answers through it as through that config handed in."""
    params, tparams = weights
    jc, tc = tiny_opt(j_cfg), tiny_opt(t_cfg)
    j_fn = j_zoo.native_blip2_answer_fn(jc, jax.tree.map(jnp.asarray, params), kind="opt",
                                        max_new_tokens=NEW)
    t_fn = t_zoo.native_blip2_answer_fn(tc, tparams, kind="opt", max_new_tokens=NEW,
                                        device="cpu")
    ims = _images()
    for q, im in zip(QUESTIONS, ims * 2):
        assert t_fn(q, im) == j_fn(q, im), q

    built = []
    real = t_zoo.init_blip2_params
    monkeypatch.setattr(t_zoo, "init_blip2_params",
                        lambda cfg, *a, **k: built.append(cfg) or real(cfg, *a, **k))
    smoke = t_zoo.native_blip2_answer_fn(kind="opt", max_new_tokens=NEW, device="cpu")
    assert [c.text_is_opt for c in built] == [True] and built[0] == tc
    same = t_zoo.native_blip2_answer_fn(tc, real(tc, torch.Generator().manual_seed(0), "cpu"),
                                        kind="opt", max_new_tokens=NEW, device="cpu")
    assert [smoke(q, ims[0]) for q in QUESTIONS] == [same(q, ims[0]) for q in QUESTIONS]
