"""The VL zoo's BLIP-2 Flan-T5 path of the torch port against the JAX
package, at the JAX package's tiny configs on the same numpy inputs and on
weights from JAX's initializer carried across by the bridge
(``checkpoint/from_jax.py``): the EVA-ViT-g tower, the Q-Former,
``encode_image``, T5's relative-position buckets (exactly), its encoder,
forward and decode steps, greedy and beam decoding (token for token), the
shared beam search (ties included), ``native_blip2_answer_fn`` and
``entry.evaluate`` with ``MODEL.ZOO: blip2``; and the branches that raise.

f32 values agree within 1e-5 (sums in other orders); decoding is
token-exact.  JAX stages are jitted once per file, the JAX decoders too:
``jit_decode`` replaces them in their modules for the file (op by op, one
BLIP-2 answer took ~10-29 s of JAX dispatch on the CPU, jitted ~5 s).
"""
import inspect
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cullavo_tpu import entry as j_entry
from cullavo_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from cullavo_tpu.models import beam as j_beam
from cullavo_tpu.models.blip2 import config as j_cfg
from cullavo_tpu.models.blip2 import modeling as j_mod
from cullavo_tpu.models.blip2 import qformer as j_qf
from cullavo_tpu.models.blip2 import t5 as j_t5
from cullavo_tpu.models.blip2 import vision as j_vis
from cullavo_tpu.pipelines import vl_zoo_pipeline as j_zoo
from cullavo_tpu_torch import entry as t_entry
from cullavo_tpu_torch.checkpoint.from_jax import blip2_params_from_numpy, blip2_params_to_numpy
from cullavo_tpu_torch.data.tokenizer import ByteTokenizer
from cullavo_tpu_torch.models import beam as t_beam
from cullavo_tpu_torch.models.blip2 import config as t_cfg
from cullavo_tpu_torch.models.blip2 import modeling as t_mod
from cullavo_tpu_torch.models.blip2 import qformer as t_qf
from cullavo_tpu_torch.models.blip2 import t5 as t_t5
from cullavo_tpu_torch.models.blip2 import vision as t_vis
from cullavo_tpu_torch.ops import flash_attention as fa
from cullavo_tpu_torch.pipelines import vl_zoo_pipeline as t_zoo


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CFG = j_cfg.tiny_blip2_config("t5")
T5 = CFG.text


def jit_decode(fn, static):
    """``fn`` under ``jax.jit``, its arguments bound by name, with ``static``
    (the config and the decode settings) as static arguments: one compiled
    program per input shape and setting, shared by every caller."""
    sig = inspect.signature(fn)
    jitted = jax.jit(fn, static_argnames=static)

    def call(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        return jitted(**bound.arguments)

    return call


@pytest.fixture(autouse=True, scope="module")
def _jitted_jax_decoders():
    """The JAX package's T5 / BLIP-2 decoders and its BLIP-2 initializer
    jitted for this file (the answerers and the zoo entry import them from
    their modules at call time); the originals back afterwards."""
    saved = [(j_t5, "t5_generate"), (j_t5, "t5_beam_generate"), (j_mod, "blip2_beam_generate"),
             (j_mod, "init_blip2_params")]
    originals = [getattr(m, n) for m, n in saved]
    # the smoke weights of the fixture and of JAX's zoo entry come from this one program
    j_mod.init_blip2_params = jit_decode(j_mod.init_blip2_params, ("cfg", "dtype"))
    j_t5.t5_generate = jit_decode(j_t5.t5_generate, ("cfg", "max_new_tokens", "eos_token_id"))
    j_t5.t5_beam_generate = jit_decode(j_t5.t5_beam_generate, (
        "cfg", "max_new_tokens", "num_beams", "length_penalty", "eos_token_id"))
    j_mod.blip2_beam_generate = jit_decode(j_mod.blip2_beam_generate, (
        "cfg", "max_new_tokens", "num_beams", "length_penalty", "eos_token_id", "pad_token_id",
        "compute_dtype"))
    yield
    for (m, n), f in zip(saved, originals):
        setattr(m, n, f)


@pytest.fixture(scope="module")
def weights():
    """JAX's smoke weights (``PRNGKey(0)``, what JAX's zoo entry builds) as
    numpy, and the port's copy on the CPU."""
    tree = jax.tree.map(np.asarray, j_mod.init_blip2_params(CFG, jax.random.PRNGKey(0)))
    return tree, blip2_params_from_numpy(tree, "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _pixels(B, seed):
    s = CFG.vision.image_size
    return np.random.default_rng(seed).normal(size=(B, 3, s, s)).astype(np.float32)


def _prompt(B, T, seed, pad=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, T5.vocab_size, size=(B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    if pad:
        mask[-1, -pad:] = 0
    return ids, mask


def test_configs_match_jax():
    for name in ("opt", "t5", "llama_text"):
        mine, ref = t_cfg.tiny_blip2_config(name), j_cfg.tiny_blip2_config(name)
        assert dataclasses_dict(mine) == dataclasses_dict(ref)
    assert dataclasses_dict(t_cfg.blip2_flant5xl_config()) == dataclasses_dict(
        j_cfg.blip2_flant5xl_config())
    assert t_cfg.blip2_flant5xl_config().text_is_t5


def dataclasses_dict(cfg):
    import dataclasses

    return {f.name: (dataclasses_dict(getattr(cfg, f.name))
                     if dataclasses.is_dataclass(getattr(cfg, f.name)) else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


def test_bridge_round_trips_and_init_matches_the_tree(weights):
    tree, params = weights
    back = blip2_params_to_numpy(params)
    flat_ref = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    for path, a in flat_ref:
        assert np.array_equal(flat_back[path], a) and flat_back[path].dtype == a.dtype
    # the port's initializer gives the same tree: keys, shapes and dtypes
    mine = blip2_params_to_numpy(t_mod.init_blip2_params(CFG, torch.Generator().manual_seed(0),
                                                         "cpu"))
    assert jax.tree.structure(mine) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(tree)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_vision_qformer_and_encode_image_match_jax(weights):
    tree, params = weights
    pix = _pixels(2, seed=1)
    jp = jax.tree.map(jnp.asarray, tree)
    ref = np.asarray(jax.jit(lambda p, x: j_vis.blip2_vision_forward(p, CFG.vision, x))(
        jp["vision"], pix))
    got = t_vis.blip2_vision_forward(params["vision"], CFG.vision, _t(pix))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)

    queries = np.broadcast_to(tree["query_tokens"], (2,) + tree["query_tokens"].shape)
    ref_q = np.asarray(jax.jit(lambda p, q, x: j_qf.qformer_forward(p, CFG.qformer, q, x))(
        jp["qformer"], queries, ref))
    got_q = t_qf.qformer_forward(params["qformer"], CFG.qformer, _t(queries.copy()), _t(ref))
    np.testing.assert_allclose(got_q.numpy(), ref_q, atol=1e-5, rtol=0)

    ref_e = np.asarray(jax.jit(lambda p, x: j_mod.encode_image(p, CFG, x))(jp, pix))
    got_e = t_mod.encode_image(params, CFG, _t(pix))
    assert got_e.shape == (2, CFG.num_query_tokens, T5.d_model)
    np.testing.assert_allclose(got_e.numpy(), ref_e, atol=1e-5, rtol=0)


@pytest.mark.parametrize("num_buckets,max_distance", [(8, 16), (32, 128)],
                         ids=["tiny", "flan_t5_xl"])
@pytest.mark.parametrize("bidirectional", [True, False], ids=["encoder", "decoder"])
def test_relative_position_bucket_matches_jax_exactly(num_buckets, max_distance, bidirectional):
    rel = np.arange(-3 * max_distance, 3 * max_distance + 1, dtype=np.int32)
    ref = np.asarray(j_t5._relative_position_bucket(jnp.asarray(rel), bidirectional,
                                                    num_buckets, max_distance))
    got = t_t5._relative_position_bucket(_t(rel), bidirectional, num_buckets, max_distance)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.max() == num_buckets - 1          # the range reaches past max_distance


@pytest.fixture(scope="module")
def encoded(weights):
    """Encoder inputs ([queries; prompt], one row right-padded) and JAX's
    encoder output."""
    tree, params = weights
    lm = tree["language_model"]
    ids, mask = _prompt(2, 9, seed=2, pad=3)
    q = np.random.default_rng(3).normal(size=(2, 4, T5.d_model)).astype(np.float32)
    embeds = np.concatenate([q, lm["embed_tokens"][ids]], axis=1)
    mask = np.concatenate([np.ones((2, 4), np.int32), mask], axis=1)
    enc = np.asarray(jax.jit(lambda p, e, m: j_t5.t5_encode(p, T5, e, m))(lm, embeds, mask))
    return embeds, mask, enc


def test_t5_encode_and_forward_match_jax(weights, encoded):
    tree, params = weights
    embeds, mask, enc = encoded
    lm = params["language_model"]
    got = t_t5.t5_encode(lm, T5, _t(embeds), _t(mask))
    np.testing.assert_allclose(got.numpy(), enc, atol=1e-5, rtol=0)
    dec = np.random.default_rng(4).integers(0, T5.vocab_size, size=(2, 6)).astype(np.int32)
    ref = np.asarray(jax.jit(lambda p, e, m, d: j_t5.t5_forward(p, T5, e, m, d))(
        tree["language_model"], embeds, mask, dec))
    logits = t_t5.t5_forward(lm, T5, _t(embeds), _t(mask), _t(dec).long())
    np.testing.assert_allclose(logits.numpy(), ref, atol=1e-5, rtol=0)


def test_t5_stale_decode_steps_match_the_uncached_pass(weights, encoded):
    """Six one-token steps over the cache (K12's plain version on the CPU)
    give the hidden states of one causal pass over the six tokens, in the
    port and in JAX."""
    tree, params = weights
    embeds, mask, enc = encoded
    lm = params["language_model"]
    dec = np.random.default_rng(5).integers(0, T5.vocab_size, size=(2, 6)).astype(np.int32)
    emb = lm["embed_tokens"][_t(dec).long()]
    full, _ = t_t5.t5_decode_step(lm, T5, emb, _t(enc), _t(mask), torch.arange(6))
    ref, _ = jax.jit(lambda p, e, h, m: j_t5.t5_decode_step(p, T5, e, h, m, jnp.arange(6)))(
        tree["language_model"], np.asarray(emb), enc, mask)
    np.testing.assert_allclose(full.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    cache = t_t5.t5_init_cache(T5, 2, 6)
    before = fa.decode_partials.launches
    for i in range(6):
        h, cache = t_t5.t5_decode_step(lm, T5, emb[:, i:i + 1], _t(enc), _t(mask),
                                       torch.tensor([i]), cache, i, stale_cache=True)
        np.testing.assert_allclose(h[:, 0].numpy(), full[:, i].numpy(), atol=1e-5, rtol=0)
    assert fa.decode_partials.launches == before
    with pytest.raises(NotImplementedError, match="stale_cache"):
        t_t5.t5_decode_step(lm, T5, emb[:, :1], _t(enc), _t(mask), torch.tensor([0]), cache, 0)


def test_t5_generate_matches_jax(weights, encoded):
    tree, params = weights
    embeds, mask, _ = encoded
    ref = np.asarray(j_t5.t5_generate(jax.tree.map(jnp.asarray, tree["language_model"]), T5,
                                      jnp.asarray(embeds), jnp.asarray(mask), 7))
    got = t_t5.t5_generate(params["language_model"], T5, _t(embeds), _t(mask), 7)
    np.testing.assert_array_equal(got.numpy(), ref)
    # an eos that every row emits at once stops both loops early
    eos = int(ref[0, 0]) if ref[0, 0] == ref[1, 0] else None
    if eos is not None:
        ref_e = np.asarray(j_t5.t5_generate(jax.tree.map(jnp.asarray, tree["language_model"]),
                                            T5, jnp.asarray(embeds), jnp.asarray(mask), 7, eos))
        got_e = t_t5.t5_generate(params["language_model"], T5, _t(embeds), _t(mask), 7, eos)
        np.testing.assert_array_equal(got_e.numpy(), ref_e)


def _beam_model(V, seed, levels):
    """A deterministic toy language model for the scorer: the logits of the
    next token depend on the fed token and the step, quantised to ``levels``
    values so that candidate scores tie."""
    rng = np.random.default_rng(seed)
    table = np.round(rng.normal(size=(V, 12, V)) * levels) / levels
    return table.astype(np.float32)


@pytest.mark.parametrize("levels,eos,lp", [(2, 1, -1.0), (2, 3, 1.0), (1000, 1, -1.0),
                                           (1, 0, 0.5)],
                         ids=["ties_lp-1", "ties_lp1", "no_ties", "coarse_ties"])
def test_beam_search_matches_jax(levels, eos, lp):
    """The shared scorer on a toy model, ties in the top-k selections
    included (broken toward the lower index in both packages)."""
    B, nb, V, T = 2, 5, 11, 8
    table = _beam_model(V, seed=levels, levels=levels)
    init = np.random.default_rng(7).normal(size=(B * nb, V)).astype(np.float32)
    init = np.round(init * levels) / levels
    init = np.repeat(init[::nb], nb, axis=0)         # every beam of a row starts alike

    def j_step(tok, state, i):
        return jnp.asarray(table)[tok, i], state + 1

    ref = np.asarray(j_beam.beam_search(j_step, lambda s, p: s, jnp.asarray(init),
                                        jnp.int32(0), B, nb, T, eos, pad_token_id=0,
                                        length_penalty=lp))
    tt = torch.from_numpy(table)
    got = t_beam.beam_search(lambda tok, s, i: (tt[tok.long(), i], s + 1), lambda s, p: s,
                             torch.from_numpy(init), 0, B, nb, T, eos, pad_token_id=0,
                             length_penalty=lp)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("lp", [-1.0, 1.0])
def test_t5_and_blip2_beam_generate_match_jax(weights, encoded, lp):
    tree, params = weights
    embeds, mask, _ = encoded
    jlm = jax.tree.map(jnp.asarray, tree["language_model"])
    ref = np.asarray(j_t5.t5_beam_generate(jlm, T5, jnp.asarray(embeds), jnp.asarray(mask), 6,
                                           num_beams=5, length_penalty=lp, eos_token_id=1))
    got = t_t5.t5_beam_generate(params["language_model"], T5, _t(embeds), _t(mask), 6,
                                num_beams=5, length_penalty=lp, eos_token_id=1)
    np.testing.assert_array_equal(got.numpy(), ref)

    pix = _pixels(2, seed=8)
    ids, pmask = _prompt(2, 7, seed=9, pad=2)
    ref_b = np.asarray(j_mod.blip2_beam_generate(jax.tree.map(jnp.asarray, tree), CFG, pix, ids,
                                                 pmask, 6, num_beams=5, length_penalty=lp,
                                                 eos_token_id=1))
    got_b = t_mod.blip2_beam_generate(params, CFG, _t(pix), _t(ids).long(), _t(pmask), 6,
                                      num_beams=5, length_penalty=lp, eos_token_id=1)
    np.testing.assert_array_equal(got_b.numpy(), ref_b)
    logits = t_mod.blip2_forward(params, CFG, _t(pix), _t(ids).long(), _t(pmask),
                                 decoder_input_ids=_t(ref_b).long())
    ref_l = np.asarray(j_mod.blip2_forward(jax.tree.map(jnp.asarray, tree), CFG, pix, ids,
                                           pmask, decoder_input_ids=ref_b))
    np.testing.assert_allclose(logits.numpy(), ref_l, atol=1e-5, rtol=0)


QUESTIONS = ["what is it?", "how many dogs are in the picture?", "What color is the car?",
             "Is there a person riding the bicycle?", "where is the cat"]


def test_native_blip2_answer_fn_matches_jax(weights):
    """The answerer at the reference's settings on JAX's smoke weights, the
    byte tokenizer and CLIP-preprocessed images (one of another size, which
    both resample to the tower's side)."""
    tree, params = weights
    ref_fn = j_zoo.native_blip2_answer_fn(CFG, jax.tree.map(jnp.asarray, tree), JByteTokenizer(),
                                          max_new_tokens=5)
    mine = t_zoo.native_blip2_answer_fn(CFG, params, ByteTokenizer(), max_new_tokens=5)
    rng = np.random.default_rng(10)
    for i, q in enumerate(QUESTIONS[:3]):
        side = 28 if i < 2 else 40
        img = rng.normal(size=(3, side, side)).astype(np.float32)
        assert mine(q, img) == ref_fn(q, img)


@pytest.fixture(scope="module")
def vqa_files(tmp_path_factory):
    """Five questions on three PNG images (two sizes), annotations for val."""
    from PIL import Image

    d = tmp_path_factory.mktemp("vqa_zoo")
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


def zoo_cfg(zoo, files, name, out_dir, max_new=4):
    return {"NAME": "vl_test", "MAX_NEW_TOKENS": max_new, "LIMIT": 0, "SAVE_DIR": str(out_dir),
            "MODEL": {"ZOO": zoo},
            "DATASETS": {"TEST": [name], "REGISTER": {name: {
                "KIND": "vqa", "QUESTIONS_JSON": str(files / "q.json"),
                "ANNOTATIONS_JSON": str(files / "a.json"), "IMAGE_DIR": str(files)}}}}


def test_evaluate_zoo_blip2_matches_jax(tmp_path, vqa_files, weights, monkeypatch):
    """``entry.evaluate`` with ``MODEL.ZOO: blip2`` in both packages: the
    port's smoke weights are made JAX's (the two initializers draw other
    numbers from seed 0), then the metrics dict and the answers file must
    be equal."""
    _, params = weights
    monkeypatch.setattr(t_zoo, "init_blip2_params", lambda cfg, gen, dev: params)
    out = {}
    for pkg, run in (("jax", j_entry.evaluate), ("port", t_entry.evaluate)):
        # 5 new tokens, as test_native_blip2_answer_fn: JAX's jitted
        # answers to the questions both ask are compiled once
        cfg = zoo_cfg("blip2", vqa_files, f"zoo_blip2_{pkg}", tmp_path / pkg, max_new=5)
        res = run(cfg) if pkg == "jax" else run(cfg, device="cpu")
        out[pkg] = res[f"zoo_blip2_{pkg}"]
    assert out["port"] == out["jax"] and out["port"]["n"] == len(QUESTIONS)
    with open(tmp_path / "jax" / "vqa_results.json") as f, \
            open(tmp_path / "port" / "vqa_results.json") as g:
        ref, mine = json.load(f), json.load(g)
    assert mine == ref and len(mine) == len(QUESTIONS)
    assert any(r["answer"] for r in mine)


@pytest.mark.parametrize("model,exc,match", [
    ({"ZOO": "blip2", "ZOO_PATH": "/nonexistent"}, FileNotFoundError, "config.json"),
    ({"ZOO": "kosmos2", "ZOO_TORCH": True}, NotImplementedError, "transformers"),
    ({"ZOO": "instructblip", "ZOO_PATH": "/nonexistent"}, FileNotFoundError, "config.json"),
    ({"ZOO": "bakllava"}, SystemExit, "needs MODEL.ZOO_PATH"),
    ({"ZOO": "flamingo"}, SystemExit, None),
    ({"TOPIC": {"LLAMA_PATH": "/nonexistent"}}, ValueError, "MODEL.TOPIC"),
], ids=["zoo_path", "zoo_torch", "instructblip", "bakllava", "unknown", "topic"])
def test_evaluate_zoo_raises_where_it_waits(model, exc, match):
    with pytest.raises(exc, match=match):
        t_entry.evaluate({"NAME": "vl_test", "MODEL": model}, device="cpu")


def test_what_waits_for_later_slices_raises(weights):
    """What still waits raises and names its item: the OPT tower (item
    2.6).  InstructBLIP, ImageNet, the text input of the Q-Former and the
    zoo snapshots run (tests/test_torch_instructblip.py,
    test_torch_imagenet.py, test_torch_zoo_path.py); a snapshot directory
    without its files raises naming config.json."""
    _, params = weights
    with pytest.raises(FileNotFoundError, match="config.json"):
        t_entry.evaluate({"NAME": "imagenet_test", "MODEL": {"ZOO_PATH": "/x"},
                          "DATASETS": {"TEST": ["none"]}}, device="cpu")
    opt_cfg = t_cfg.tiny_blip2_config("opt")
    for fn in (lambda: t_mod.init_blip2_params(opt_cfg, torch.Generator(), "cpu"),
               lambda: t_mod.blip2_forward(params, opt_cfg, None, None, None),
               lambda: t_mod.blip2_generate(params, opt_cfg, None, None, None, 2)):
        with pytest.raises(NotImplementedError, match="OPT.*item 2.6"):
            fn()
    with pytest.raises(FileNotFoundError, match="config.json"):
        t_zoo.native_blip2_answer_fn(hf_model_dir="/x", device="cpu")
    with pytest.raises(NotImplementedError, match="OPT"):
        t_zoo.native_blip2_answer_fn(kind="opt", device="cpu")
    with pytest.raises(NotImplementedError, match="answer_fn"):
        t_zoo.VLZooVQAPipeline(None, "blip2").answer("q", None)
