"""The torch port's LLaVA path against the JAX package, at the tiny config.

Weights are the JAX initializer's, moved into the port through the weight
bridge (``cullavo_tpu_torch.checkpoint.from_jax``); inputs are numpy arrays
from a seed.  f32 comparisons use ``atol=1e-4``; generation is compared
token for token.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cullavo_tpu.models.llava import modeling as jm
from cullavo_tpu.models.llava.clip_vit import clip_vision_forward as j_clip
from cullavo_tpu.models.llava.config import tiny_llava_config as j_tiny
from cullavo_tpu.models.llava.lora import quantize_llm_weights as j_quantize
from cullavo_tpu_torch.checkpoint.from_jax import (llava_params_from_numpy,
                                                   llava_params_to_numpy)
from cullavo_tpu_torch.models.llava import modeling as tm
from cullavo_tpu_torch.models.llava.clip_vit import clip_vision_forward as t_clip
from cullavo_tpu_torch.models.llava.config import tiny_llava_config as t_tiny
from cullavo_tpu_torch.models.llava.lora import quantize_llm_weights as t_quantize


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


VOCAB = 128


def _models(seed=0, vocab=VOCAB):
    jcfg, tcfg = j_tiny(vocab), t_tiny(vocab)
    jp = jm.init_llava_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, llava_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _inputs(cfg, B, T, seed, pad_rows=()):
    """Right-padded prompts with the image run at positions 1..N."""
    rng = np.random.default_rng(seed)
    n_img = cfg.num_image_tokens
    ids = rng.integers(4, cfg.text.vocab_size - 2, size=(B, T)).astype(np.int32)
    ids[:, 1:1 + n_img] = cfg.image_token_id
    mask = np.ones((B, T), np.int32)
    for r, n in pad_rows:
        mask[r, n:] = 0
    S = cfg.vision.image_size
    pix = rng.normal(size=(B, 3, S, S)).astype(np.float32)
    return ids, mask, pix


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def test_clip_vision_forward_matches_jax():
    jcfg, tcfg, jp, tp = _models()
    pix = np.random.default_rng(1).normal(size=(2, 3, 28, 28)).astype(np.float32)
    j = np.asarray(j_clip(jp["vision_tower"], jcfg.vision, jnp.asarray(pix)))
    t = t_clip(tp["vision_tower"], tcfg.vision, torch.from_numpy(pix)).numpy()
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, atol=1e-4, rtol=0)


@pytest.mark.parametrize("use_flash", [None, False])
@pytest.mark.parametrize("padded", [False, True])
def test_llava_forward_logits_match_jax(padded, use_flash):
    """No-cache logits.  JAX on the CPU runs sdpa with the key-padding bias.
    The port's default is the flash kernel's bias-free causal contract, so
    the valid positions of a right-padded batch must agree; with
    ``use_flash=False`` it runs sdpa with the bias too, and every position
    must agree."""
    jcfg, tcfg, jp, tp = _models()
    ids, mask, pix = _inputs(jcfg, 2, 13, seed=2, pad_rows=((1, 9),) if padded else ())
    jl, _ = jm.llava_forward(jp, jcfg, *map(jnp.asarray, (ids, pix, mask)))
    tl, _ = tm.llava_forward(tp, tcfg, *_t(ids, pix, mask), use_flash=use_flash)
    rows = mask.astype(bool) if use_flash is None else np.ones_like(mask, bool)
    np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows], atol=1e-4, rtol=0)


def test_prefill_state_matches_jax():
    """Cache-building prefill: logits, masks and positions equal; the cache
    equal on valid slots (pad slots differ between the flash and sdpa
    paths at layers >= 1 and are never read)."""
    jcfg, tcfg, jp, tp = _models()
    ids, mask, pix = _inputs(jcfg, 3, 14, seed=3, pad_rows=((0, 10), (2, 12)))
    js = jm.generate_prefill(jp, jcfg, *map(jnp.asarray, (ids, pix, mask)), 20,
                             compute_dtype=jnp.float32)
    ts = tm.generate_prefill(tp, tcfg, *_t(ids, pix, mask), 20, compute_dtype=torch.float32)
    assert sorted(js) == sorted(ts)
    np.testing.assert_allclose(ts["logits"].numpy(), np.asarray(js["logits"]), atol=1e-4)
    for key in ("full_mask", "key_pos", "cur_pos", "adapter_ids"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]), err_msg=key)
    assert ts["write_idx"] == int(js["write_idx"])
    for name in ("k", "v"):
        jc, tc = np.asarray(js["cache"][name]), ts["cache"][name].numpy()
        assert tc.shape == jc.shape
        for b, n in enumerate(mask.sum(1)):
            np.testing.assert_allclose(tc[:, :n, b], jc[:, :n, b], atol=1e-4, rtol=0)


def _int8_params(jp, tp, K):
    """SmoothQuant int8 LLM weights, one shared scale per input group:
    JAX-quantized (bridged) and port-quantized must be bit-equal."""
    rng = np.random.default_rng(7)
    s_in, s_o, s_mlp = (np.exp(rng.normal(0, 0.3, K)).astype(np.float32) for _ in range(3))
    s_down = np.exp(rng.normal(0, 0.3, 2 * K)).astype(np.float32)
    sm = {"q": s_in, "k": s_in, "v": s_in, "o": s_o, "gate": s_mlp, "up": s_mlp,
          "down": s_down}
    jq = j_quantize(jp, bits=8, smooth_scales=sm)
    tq = llava_params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    own = t_quantize(tp, bits=8, smooth_scales=sm)
    for t, w in tq["language_model"]["layers"].items():
        if isinstance(w, dict):
            for key in w:
                assert torch.equal(own["language_model"]["layers"][t][key], w[key]), (t, key)
    return jq, tq


@pytest.mark.parametrize("mode", ["f32-dense", "int8-smoothquant"])
def test_greedy_stream_matches_jax(mode, monkeypatch):
    """generate_prefill_chunked (chunk 2 < B = 3) + generate_decode, token
    for token.  int8 mode: T = 512, so the first chunk's prefill M = 1024
    takes the s8s8 path (shared quant pass, int8 GEMM) and the second chunk
    and decode the weight-only linear.  Every logit row that picked a token
    must have a top-2 gap above 1e-4 (far above the f32 differences), so a
    near-tie cannot make the comparison pass or fail by chance."""
    jcfg, tcfg, jp, tp = _models(seed=1)
    T, new = (24, 8) if mode == "f32-dense" else (512, 6)
    ids, mask, pix = _inputs(jcfg, 3, T, seed=4, pad_rows=((1, T - 5),))
    if mode == "int8-smoothquant":
        jp, tp = _int8_params(jp, tp, jcfg.text.hidden_size)
    max_len = T + new
    jgen = jm.GenerationConfig(max_new_tokens=new, eos_token_id=-1)
    tgen = tm.GenerationConfig(max_new_tokens=new, eos_token_id=-1)
    js = jm.generate_prefill_chunked(jp, jcfg, *map(jnp.asarray, (ids, pix, mask)), max_len, 2,
                                     compute_dtype=jnp.float32)
    jt = np.asarray(jm.generate_decode(jp, jcfg, js, jgen, compute_dtype=jnp.float32))

    seen = []
    sample = tm._sample_token

    def recording(logits, gen, *generator):
        seen.append(logits.clone())
        return sample(logits, gen, *generator)

    monkeypatch.setattr(tm, "_sample_token", recording)
    ts = tm.generate_prefill_chunked(tp, tcfg, *_t(ids, pix, mask), max_len, 2,
                                     compute_dtype=torch.float32)
    tt = tm.generate_decode(tp, tcfg, ts, tgen, compute_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(tt, jt)
    top2 = torch.topk(torch.cat(seen), 2, dim=-1).values
    assert (top2[:, 0] - top2[:, 1]).min().item() > 1e-4


def test_chunked_prefill_equals_unchunked():
    """In f64: in f32 the GEMMs over 2 rows (a chunk) and over 3 rows sum in
    other orders, and 18 of the 384 logits differed by up to 1.79e-6."""
    jcfg, tcfg, jp, tp = _models()
    ids, mask, pix = _inputs(tcfg, 3, 16, seed=5, pad_rows=((2, 11),))
    a = tm.generate_prefill(tp, tcfg, *_t(ids, pix, mask), 22, compute_dtype=torch.float64)
    b = tm.generate_prefill_chunked(tp, tcfg, *_t(ids, pix, mask), 22, 2,
                                    compute_dtype=torch.float64)
    assert sorted(a) == sorted(b) and a["write_idx"] == b["write_idx"]
    for key in ("full_mask", "key_pos", "cur_pos", "adapter_ids"):
        assert torch.equal(a[key], b[key]), key
    torch.testing.assert_close(b["logits"], a["logits"], atol=1e-6, rtol=0)
    for name in ("k", "v"):
        torch.testing.assert_close(b["cache"][name], a["cache"][name], atol=1e-6, rtol=0)


def test_vqa_pipeline_answers_match_jax():
    """answer_batch (bf16, chunked prefill) on the byte tokenizer."""
    from cullavo_tpu.config import Config
    from cullavo_tpu.data.tokenizer import ByteTokenizer
    from cullavo_tpu.pipelines.vqa_pipeline import VQAPipeline as JPipe
    from cullavo_tpu_torch.pipelines.vqa_pipeline import VQAPipeline as TPipe

    jcfg, tcfg, jp, tp = _models(seed=0, vocab=260)
    tk = ByteTokenizer()
    qs = [f"what is {i}?" for i in range(3)]
    pix = np.random.default_rng(0).normal(size=(3, 3, 28, 28)).astype(np.float32)
    ja = JPipe(Config({}), jcfg, tk, jp, batch_size=3, max_new_tokens=6,
               prefill_chunk=2).answer_batch(qs, pix)
    ta = TPipe(None, tcfg, tk, tp, batch_size=3, max_new_tokens=6,
               prefill_chunk=2).answer_batch(qs, pix)
    assert ta == ja


def test_weight_bridge_round_trip_is_exact():
    """f32, bf16 and int8-dict leaves survive numpy -> port -> numpy
    bit for bit, dtypes and stacked shapes included."""
    jcfg, _, jp, _ = _models()
    jp = {**jp, "vision_tower": jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                                             jp["vision_tower"])}
    s = np.exp(np.random.default_rng(8).normal(0, 0.3, 64)).astype(np.float32)
    jp = j_quantize(jp, bits=8, smooth_scales={"q": s, "k": s, "v": s})
    tree = jax.tree.map(np.asarray, jp)
    back = llava_params_to_numpy(llava_params_from_numpy(tree, "cpu"))
    flat_a, tdef_a = jax.tree.flatten(tree)
    flat_b, tdef_b = jax.tree.flatten(back)
    assert tdef_a == tdef_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
