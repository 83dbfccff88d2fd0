"""InstructBLIP in the torch port against the JAX package, at the JAX
package's tiny "llama_text" config (the text-input Q-Former and a tiny
LLaMA tower with GQA) on the same numpy inputs and on weights from JAX's
initializer carried across by the bridge (``checkpoint/from_jax.py``): the
text-input Q-Former and ``qformer_encode_text``, the decoder's cached
forward without ``stale_cache`` (JAX's ``sdpa_smajor`` branch, f32 and
bf16), the tower's forward, greedy and beam decoding (beam 5, length
penalty -1: token for token), the answerer's strings and ``entry.evaluate``
with ``MODEL.ZOO: instructblip``.

f32 values agree within 1e-4 (sums in other orders); decoding is
token-exact.  JAX's stages are jitted once for the file.
"""
import dataclasses
import inspect
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cullavo_tpu import entry as j_entry
from cullavo_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from cullavo_tpu.models.blip2 import config as j_cfg
from cullavo_tpu.models.blip2 import modeling as j_mod
from cullavo_tpu.models.blip2 import qformer as j_qf
from cullavo_tpu.models.llava import llama as j_llama
from cullavo_tpu.pipelines import vl_zoo_pipeline as j_zoo
from cullavo_tpu_torch import entry as t_entry
from cullavo_tpu_torch.checkpoint.from_jax import blip2_params_from_numpy, blip2_params_to_numpy
from cullavo_tpu_torch.data.tokenizer import ByteTokenizer
from cullavo_tpu_torch.models import beam as t_beam
from cullavo_tpu_torch.models.blip2 import config as t_cfg
from cullavo_tpu_torch.models.blip2 import modeling as t_mod
from cullavo_tpu_torch.models.blip2 import qformer as t_qf
from cullavo_tpu_torch.models.llava import llama as t_llama
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


CFG = j_cfg.tiny_blip2_config("llama_text")
LM = CFG.text
QUESTIONS = ["what is it?", "how many dogs are in the picture?", "What color is the car?",
             "Is there a person riding the bicycle?", "where is the cat"]


def jit_decode(fn, static):
    """``fn`` under ``jax.jit`` with its arguments bound by name and
    ``static`` as static arguments."""
    sig = inspect.signature(fn)
    jitted = jax.jit(fn, static_argnames=static)

    def call(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        return jitted(**bound.arguments)

    return call


@pytest.fixture(autouse=True, scope="module")
def _jitted_jax_decoders():
    """JAX's BLIP-2 decoders and initializer jitted for this file (the
    answerer and the zoo entry import them from their module at call
    time); the originals back afterwards."""
    saved = [(j_mod, "blip2_beam_generate"), (j_mod, "blip2_generate"),
             (j_mod, "init_blip2_params")]
    originals = [getattr(m, n) for m, n in saved]
    j_mod.init_blip2_params = jit_decode(j_mod.init_blip2_params, ("cfg", "dtype"))
    j_mod.blip2_beam_generate = jit_decode(j_mod.blip2_beam_generate, (
        "cfg", "max_new_tokens", "num_beams", "length_penalty", "eos_token_id", "pad_token_id",
        "compute_dtype"))
    j_mod.blip2_generate = jit_decode(j_mod.blip2_generate, (
        "cfg", "max_new_tokens", "eos_token_id", "compute_dtype"))
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


def _inputs(seed):
    """Two right-padded rows: pixels, prompt ids / mask, Q-Former text ids / mask."""
    rng = np.random.default_rng(seed)
    s = CFG.vision.image_size
    pix = rng.normal(size=(2, 3, s, s)).astype(np.float32)
    ids = rng.integers(3, LM.vocab_size, size=(2, 7)).astype(np.int32)
    mask = np.ones((2, 7), np.int32)
    mask[1, -2:] = 0
    qids = rng.integers(3, CFG.qformer.vocab_size, size=(2, 6)).astype(np.int32)
    qmask = np.ones((2, 6), np.int32)
    qmask[0, -2:] = 0
    return pix, ids, mask, qids, qmask


def _fields(cfg):
    return {f.name: (_fields(getattr(cfg, f.name)) if dataclasses.is_dataclass(getattr(cfg, f.name))
                     else getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}


def test_configs_and_init_tree_match_jax(weights):
    assert _fields(t_cfg.instructblip_vicuna7b_config()) == _fields(
        j_cfg.instructblip_vicuna7b_config())
    assert _fields(t_cfg.tiny_blip2_config("llama_text")) == _fields(CFG)
    tree, params = weights
    back = blip2_params_to_numpy(params)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                            jax.tree.leaves(back)):
        assert np.array_equal(a, b) and a.dtype == b.dtype, path
    # the port's initializer builds the same tree: the text FFNs, the word
    # and position tables and the LLaMA tower included
    mine = blip2_params_to_numpy(t_mod.init_blip2_params(
        t_cfg.tiny_blip2_config("llama_text"), torch.Generator().manual_seed(0), "cpu"))
    assert jax.tree.structure(mine) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(tree)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert {"ffn_t", "ffn_q", "att"} <= set(mine["qformer"]["layers"][0])
    assert mine["qformer"]["word_emb"].shape == (99, 24)


def test_text_qformer_and_encode_text_match_jax(weights):
    """The Q-Former with the instruction (queries and text attend jointly
    under the text's key mask, only queries cross-attend, the FFN split by
    position), without it, and the text alone (first-token state)."""
    tree, params = weights
    jp = jax.tree.map(jnp.asarray, tree)
    pix, _, _, qids, qmask = _inputs(1)
    img = np.random.default_rng(2).normal(size=(2, 5, CFG.qformer.encoder_hidden_size)).astype(
        np.float32)
    queries = np.broadcast_to(tree["query_tokens"], (2,) + tree["query_tokens"].shape).copy()
    fwd = jax.jit(lambda p, q, x, t, m: j_qf.qformer_forward(p, CFG.qformer, q, x, t, m))
    ref = np.asarray(fwd(jp["qformer"], queries, img, qids, qmask))
    got = t_qf.qformer_forward(params["qformer"], CFG.qformer, _t(queries), _t(img), _t(qids),
                               _t(qmask))
    assert got.shape == (2, CFG.num_query_tokens, CFG.qformer.hidden_size)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)
    ref_nt = np.asarray(jax.jit(lambda p, q, x: j_qf.qformer_forward(p, CFG.qformer, q, x))(
        jp["qformer"], queries, img))
    got_nt = t_qf.qformer_forward(params["qformer"], CFG.qformer, _t(queries), _t(img))
    np.testing.assert_allclose(got_nt.numpy(), ref_nt, atol=1e-4, rtol=0)
    assert np.abs(ref_nt - ref).max() > 1e-3      # the instruction changes the queries
    enc = jax.jit(lambda p, t, m: j_qf.qformer_encode_text(p, CFG.qformer, t, m))
    np.testing.assert_allclose(
        t_qf.qformer_encode_text(params["qformer"], CFG.qformer, _t(qids), _t(qmask)).numpy(),
        np.asarray(enc(jp["qformer"], qids, qmask)), atol=1e-4, rtol=0)
    ref_e = np.asarray(jax.jit(lambda p, x, t, m: j_mod.encode_image(p, CFG, x, t, m))(
        jp, pix, qids, qmask))
    got_e = t_mod.encode_image(params, CFG, _t(pix), _t(qids), _t(qmask))
    np.testing.assert_allclose(got_e.numpy(), ref_e, atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="text-input"):
        t_qf.qformer_encode_text(params["qformer"], dataclasses.replace(
            CFG.qformer, use_text_input=False), _t(qids), _t(qmask))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cached_forward_without_stale_cache_matches_jax(weights, dtype):
    """JAX's ``sdpa_smajor`` branch: a right-padded prompt written at slot 0
    of a zeroed cache (future slots masked), then a second window of two
    tokens at slot 7 over it; hidden states and the cache as JAX returns
    them (f32 within 1e-4, bf16 within 2e-2), no kernel counted.  Over an
    int8 cache it raises, naming the queue item."""
    tree, params = weights
    jlm = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree["language_model"])
    tlm = {k: (v.to(getattr(torch, dtype)) if torch.is_tensor(v) else
               {n: a.to(getattr(torch, dtype)) for n, a in v.items()})
           for k, v in params["language_model"].items()}
    rng = np.random.default_rng(3)
    B, T, S, D = 2, 7, 12, LM.hidden_size
    emb = rng.normal(size=(B, T, D)).astype(np.float32)
    mask = np.zeros((B, S), np.int32)
    mask[0, :T] = 1
    mask[1, :T - 2] = 1
    pos = np.maximum(np.cumsum(mask[:, :T], 1) * mask[:, :T] - 1, 0).astype(np.int32)
    key_pos = np.zeros((B, S), np.int32)
    key_pos[:, :T] = pos
    emb2 = rng.normal(size=(B, 2, D)).astype(np.float32)
    last = pos[np.arange(B), mask[:, :T].sum(1) - 1]
    pos2 = (last[:, None] + 1 + np.arange(2)[None]).astype(np.int32)
    mask2, key_pos2 = mask.copy(), key_pos.copy()
    mask2[:, T:T + 2] = 1
    key_pos2[:, T:T + 2] = pos2

    def j_run(lm, e, m, p, cache, idx, kp):
        return j_llama.llama_forward(lm, LM, e, m, p, cache, jnp.int32(idx), kp)

    j_fwd = jax.jit(j_run, static_argnums=(5,))
    cache = j_llama.init_kv_cache(LM, B, S, getattr(jnp, dtype))
    h1, cache = j_fwd(jlm, jnp.asarray(emb, dtype), mask, pos, cache, 0, key_pos)
    h2, cache = j_fwd(jlm, jnp.asarray(emb2, dtype), mask2, pos2, cache, T, key_pos2)
    tdt = getattr(torch, dtype)
    tcache = t_llama.init_kv_cache(t_cfg.tiny_blip2_config("llama_text").text, B, S, tdt)
    n0 = fa.decode_partials.launches
    g1, tcache = t_llama.llama_forward(tlm, LM, _t(emb).to(tdt), _t(mask), _t(pos), tcache, 0,
                                       _t(key_pos))
    g2, tcache = t_llama.llama_forward(tlm, LM, _t(emb2).to(tdt), _t(mask2), _t(pos2), tcache,
                                       T, _t(key_pos2))
    assert fa.decode_partials.launches == n0
    tol = 1e-4 if dtype == "float32" else 2e-2
    for got, want in ((g1, h1), (g2, h2), (tcache["k"], cache["k"]), (tcache["v"], cache["v"])):
        want = np.asarray(jnp.asarray(want, jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    q8 = t_llama.init_kv_cache(LM, B, S, kv_quant="int8")
    with pytest.raises(NotImplementedError, match="sdpa_smajor_q8.*queue 1 item 4"):
        t_llama.llama_forward(tlm, LM, _t(emb).to(tdt), _t(mask), _t(pos), q8, 0, _t(key_pos))


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_tower_decoding_matches_jax(weights, mode):
    """The Vicuna tower with the instruction into the Q-Former: the forward's
    logits (within 1e-4), greedy decoding with an eos one row meets early,
    and beam search (beam 5, length penalty -1): tokens equal."""
    tree, params = weights
    jp = jax.tree.map(jnp.asarray, tree)
    pix, ids, mask, qids, qmask = _inputs(4)
    kw_j = dict(qformer_text_ids=qids, qformer_text_mask=qmask)
    kw_t = dict(qformer_text_ids=_t(qids), qformer_text_mask=_t(qmask))
    if mode == "greedy":
        ref_l = np.asarray(jax.jit(lambda p, x, i, m, t, tm: j_mod.blip2_forward(
            p, CFG, x, i, m, t, tm))(jp, pix, ids, mask, qids, qmask))
        got_l = t_mod.blip2_forward(params, CFG, _t(pix), _t(ids), _t(mask), **kw_t)
        valid = np.concatenate([np.ones((2, CFG.num_query_tokens), bool), mask != 0], axis=1)
        np.testing.assert_allclose(got_l.numpy()[valid], ref_l[valid], atol=1e-4, rtol=0)
        free = np.asarray(j_mod.blip2_generate(jp, CFG, pix, ids, mask, 6, **kw_j))
        eos = int(free[0, 2])                      # row 0 meets it at step 3
        for e in (-1, eos):
            ref = np.asarray(j_mod.blip2_generate(jp, CFG, pix, ids, mask, 6, eos_token_id=e,
                                                  **kw_j))
            got = t_mod.blip2_generate(params, CFG, _t(pix), _t(ids), _t(mask), 6,
                                       eos_token_id=e, **kw_t)
            np.testing.assert_array_equal(got.numpy(), ref)
        return
    ref = np.asarray(j_mod.blip2_beam_generate(jp, CFG, pix, ids, mask, 6, num_beams=5,
                                               length_penalty=-1.0, eos_token_id=1, **kw_j))
    got = t_mod.blip2_beam_generate(params, CFG, _t(pix), _t(ids), _t(mask), 6, num_beams=5,
                                    length_penalty=-1.0, eos_token_id=1, **kw_t)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_beam_search_carries_a_tuple_state_and_gathers_only_the_cache():
    """The scorer hands ``step_fn`` and ``reorder_fn`` the state as the
    caller built it: a tuple (cache, full mask, key positions) whose masks
    are never gathered; the reorder sees each step's flat parents."""
    B, nb, V, T = 1, 3, 7, 4
    init = torch.log_softmax(torch.arange(B * nb * V, dtype=torch.float32).reshape(
        B * nb, V).sin(), dim=-1)
    full_mask = torch.zeros((B * nb, 5), dtype=torch.int32)
    key_pos = torch.zeros_like(full_mask)
    seen = []

    def step_fn(tok, state, i):
        cache, m, kp = state
        assert m is full_mask and kp is key_pos
        m[:, i] = 1
        return init.roll(i, dims=-1), (cache + 1, m, kp)

    def reorder_fn(state, parent):
        cache, m, kp = state
        seen.append(parent.clone())
        return cache[parent], m, kp

    out = t_beam.beam_search(step_fn, reorder_fn, init, (torch.arange(B * nb), full_mask,
                                                        key_pos), B, nb, T, eos_token_id=-1)
    assert out.shape == (B, T) and len(seen) == T - 1
    assert all(p.shape == (B * nb,) for p in seen)
    assert full_mask[:, 1:T].eq(1).all() and key_pos.eq(0).all()


def test_native_answerer_matches_jax(weights):
    """``native_blip2_answer_fn(kind="instructblip")`` on JAX's smoke
    weights with the byte tokenizer: the prompt '{q} Answer briefly.' into
    the tower and (folded into its vocabulary) into the Q-Former, eos 1 and
    the ``> 1`` filter; images of the tower's side and another."""
    tree, params = weights
    ref_fn = j_zoo.native_blip2_answer_fn(CFG, jax.tree.map(jnp.asarray, tree), JByteTokenizer(),
                                          max_new_tokens=5, kind="instructblip")
    mine = t_zoo.native_blip2_answer_fn(CFG, params, ByteTokenizer(), max_new_tokens=5,
                                        kind="instructblip")
    rng = np.random.default_rng(10)
    answers = []
    for i, q in enumerate(QUESTIONS[:3]):
        side = 28 if i < 2 else 40
        img = rng.normal(size=(3, side, side)).astype(np.float32)
        answers.append(mine(q, img))
        assert answers[-1] == ref_fn(q, img)
    assert any(answers)


@pytest.fixture(scope="module")
def vqa_files(tmp_path_factory):
    """Five questions on three PNG images (two sizes), annotations for val."""
    from PIL import Image

    d = tmp_path_factory.mktemp("vqa_instructblip")
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


def test_evaluate_instructblip_matches_jax(tmp_path, vqa_files, weights, monkeypatch):
    """``entry.evaluate`` with ``MODEL.ZOO: instructblip`` in both packages,
    the port's smoke weights made JAX's: the metrics dict and the answers
    file equal.  ``ZOO_PATH`` without a snapshot there raises naming
    config.json (tests/test_torch_zoo_path.py runs a snapshot)."""
    _, params = weights
    monkeypatch.setattr(t_zoo, "init_blip2_params", lambda cfg, gen, dev: params)
    out = {}
    for pkg, run in (("jax", j_entry.evaluate), ("port", t_entry.evaluate)):
        name = f"zoo_instructblip_{pkg}"
        cfg = {"NAME": "vl_test", "MAX_NEW_TOKENS": 5, "SAVE_DIR": str(tmp_path / pkg),
               "MODEL": {"ZOO": "instructblip"},
               "DATASETS": {"TEST": [name], "REGISTER": {name: {
                   "KIND": "vqa", "QUESTIONS_JSON": str(vqa_files / "q.json"),
                   "ANNOTATIONS_JSON": str(vqa_files / "a.json"), "IMAGE_DIR": str(vqa_files)}}}}
        res = run(cfg) if pkg == "jax" else run(cfg, device="cpu")
        out[pkg] = res[name]
    assert out["port"] == out["jax"] and out["port"]["n"] == len(QUESTIONS)
    with open(tmp_path / "jax" / "vqa_results.json") as f, \
            open(tmp_path / "port" / "vqa_results.json") as g:
        assert json.load(g) == json.load(f)
    with pytest.raises(FileNotFoundError, match="config.json"):
        t_entry.evaluate({"NAME": "vl_test", "MODEL": {"ZOO": "instructblip",
                                                       "ZOO_PATH": "/x"}}, device="cpu")
