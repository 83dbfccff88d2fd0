"""The torch port's int8-KV and speculative decode against the JAX package,
at the tiny config in f32.

Weights are the JAX initializer's, moved into the port through the bridge
(``cullavo_tpu_torch.checkpoint.from_jax``); prompts are numpy arrays from a
seed.  Streams are compared token for token, with the JAX package and with
the port's own plain greedy stream; quantized cache codes bit for bit; float
leaves with ``atol=1e-4``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cullavo_tpu.models.llava import modeling as jm
from cullavo_tpu.models.llava.config import tiny_llava_config as j_tiny
from cullavo_tpu_torch.checkpoint.from_jax import (decode_state_from_numpy,
                                                   llava_params_from_numpy)
from cullavo_tpu_torch.models.llava import modeling as tm
from cullavo_tpu_torch.models.llava.config import tiny_llava_config as t_tiny

VOCAB = 128


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = j_tiny(VOCAB), t_tiny(VOCAB)
    jp = jm.init_llava_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, llava_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _batch(cfg, seed, text_lens, bucket):
    """Right-padded multimodal prompts with per-row valid lengths."""
    rng = np.random.default_rng(seed)
    n_img = cfg.num_image_tokens
    B = len(text_lens)
    ids = np.zeros((B, bucket), np.int32)
    mask = np.zeros((B, bucket), np.int32)
    for b, tl in enumerate(text_lens):
        T = 1 + n_img + tl
        row = rng.integers(3, VOCAB - 2, size=(T,)).astype(np.int32)
        row[1:1 + n_img] = cfg.image_token_id
        ids[b, :T] = row
        mask[b, :T] = 1
    pix = rng.normal(size=(B, 3, cfg.vision.image_size, cfg.vision.image_size)).astype(np.float32)
    return ids, pix, mask


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j_greedy(jcfg, jp, batch, gen, max_len, kv_quant=None):
    st = jm.generate_prefill(jp, jcfg, *map(jnp.asarray, batch), max_len,
                             compute_dtype=jnp.float32, kv_quant=kv_quant)
    return np.asarray(jm.generate_decode(jp, jcfg, st, gen, compute_dtype=jnp.float32))


def _j_spec(jcfg, jp, batch, gen, max_len, spec_k, kv_quant=None, extra_hist=None):
    ids, pix, mask = map(jnp.asarray, batch)
    st = jm.generate_prefill(jp, jcfg, ids, pix, mask, max_len, compute_dtype=jnp.float32,
                             kv_quant=kv_quant)
    toks, stats = jm.generate_decode_spec(
        jp, jcfg, st, gen, spec_k, ids, jnp.sum(mask, axis=1), compute_dtype=jnp.float32,
        extra_hist=None if extra_hist is None else jnp.asarray(extra_hist))
    return np.asarray(toks), {k: int(v) for k, v in jax.device_get(stats).items()}


def _t_greedy(tcfg, tp, batch, gen, max_len, kv_quant=None):
    st = tm.generate_prefill(tp, tcfg, *_t(*batch), max_len, compute_dtype=torch.float32,
                             kv_quant=kv_quant)
    return tm.generate_decode(tp, tcfg, st, gen, compute_dtype=torch.float32).numpy()


def _t_spec(tcfg, tp, batch, gen, max_len, spec_k, kv_quant=None, extra_hist=None, **kw):
    ids, pix, mask = _t(*batch)
    st = tm.generate_prefill(tp, tcfg, ids, pix, mask, max_len, compute_dtype=torch.float32,
                             kv_quant=kv_quant)
    out = tm.generate_decode_spec(
        tp, tcfg, st, gen, spec_k, ids, mask.sum(dim=1), compute_dtype=torch.float32,
        extra_hist=None if extra_hist is None else torch.from_numpy(extra_hist), **kw)
    return (out[0].numpy(), *out[1:])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ngram_draft_matches_jax(seed):
    """Random histories over a small alphabet (bigram hits and unigram
    fallbacks), a long-alphabet row (no hit) and a one-token history."""
    rng = np.random.default_rng(seed)
    B, S, k = 6, 40, 4
    hist = rng.integers(0, 5, size=(B, S)).astype(np.int32)
    hist[4] = np.arange(100, 100 + S)                      # all distinct: no hit
    hist_len = rng.integers(2, S - 5, size=(B,)).astype(np.int32)
    hist_len[5] = 1                                         # only cur_tok
    cur = hist[np.arange(B), hist_len - 1].copy()
    # row 3: the bigram (prev, cur) never occurred before, the unigram did
    hist[3, :10] = [1, 2, 3, 2, 5, 6, 7, 4, 0, 2]
    hist_len[3], cur[3] = 10, 2
    ref = np.asarray(jm._ngram_draft(jnp.asarray(hist), jnp.asarray(hist_len),
                                     jnp.asarray(cur), k))
    out = tm._ngram_draft(*_t(hist, hist_len, cur), k)
    assert out.dtype == torch.int32 and out.shape == (B, k - 1)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (out[4] == int(cur[4])).all() and (out[5] == int(cur[5])).all()
    np.testing.assert_array_equal(out[3].numpy(), [5, 6, 7])   # follows the unigram at index 3


def test_prefill_int8_state_matches_jax(models):
    """``generate_prefill(kv_quant="int8")``: equal logits, masks and
    positions; on the valid slots codes and scales equal (the two packages'
    k/v differ by f32 rounding, which may flip a code that sits on a rounding
    boundary: at most one in a thousand, by one step), and bit-equal when the
    port quantizes JAX's own k/v."""
    jcfg, tcfg, jp, tp = models
    batch = _batch(jcfg, 3, [4, 9, 1], bucket=1 + jcfg.num_image_tokens + 10)
    max_len = batch[0].shape[1] + 6
    js = jm.generate_prefill(jp, jcfg, *map(jnp.asarray, batch), max_len,
                             compute_dtype=jnp.float32, kv_quant="int8")
    ts = tm.generate_prefill(tp, tcfg, *_t(*batch), max_len, compute_dtype=torch.float32,
                             kv_quant="int8")
    assert sorted(js) == sorted(ts) and sorted(js["cache"]) == sorted(ts["cache"])
    np.testing.assert_allclose(ts["logits"].numpy(), np.asarray(js["logits"]), atol=1e-4)
    for key in ("full_mask", "key_pos", "cur_pos", "adapter_ids"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]), err_msg=key)
    assert ts["write_idx"] == int(js["write_idx"])
    lens = batch[2].sum(1)
    for name, plane in (("k", "k_s"), ("v", "v_s")):
        jc, tc = np.asarray(js["cache"][name]), ts["cache"][name].numpy()
        jsc = np.asarray(js["cache"][plane]).astype(np.float32)
        tsc = ts["cache"][plane].float().numpy()
        assert tc.shape == jc.shape and tc.dtype == np.int8 and tsc.shape == jsc.shape
        for b, n in enumerate(lens):
            diff = np.abs(tc[:, :n, b].astype(int) - jc[:, :n, b].astype(int))
            assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3
            np.testing.assert_allclose(tsc[:, :n, b], jsc[:, :n, b], rtol=2 ** -7)
        assert not tc[:, batch[0].shape[1]:].any()

    # the same k/v through both quantizers: bit-equal codes and scales
    from cullavo_tpu.models.llava.llama import quantize_kv as j_quantize_kv
    from cullavo_tpu_torch.models.llava.llama import quantize_kv as t_quantize_kv

    jb = jm.generate_prefill(jp, jcfg, *map(jnp.asarray, batch), max_len,
                             compute_dtype=jnp.float32)
    k = np.asarray(jb["cache"]["k"])
    jq, jsq = j_quantize_kv(jnp.asarray(k))
    tq, tsq = t_quantize_kv(torch.from_numpy(k))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tsq.view(torch.int16).numpy(), np.asarray(jsq).view(np.int16))
    np.testing.assert_array_equal(np.asarray(jq)[:, :, 0], np.asarray(js["cache"]["k"])[:, :, 0])


def test_greedy_stream_int8_cache_matches_jax(models):
    jcfg, tcfg, jp, tp = models
    batch = _batch(jcfg, 2, [6, 3, 8], bucket=1 + jcfg.num_image_tokens + 8)
    max_len = batch[0].shape[1] + 10
    jt = _j_greedy(jcfg, jp, batch, jm.GenerationConfig(max_new_tokens=9, eos_token_id=-1),
                   max_len, kv_quant="int8")
    tt = _t_greedy(tcfg, tp, batch, tm.GenerationConfig(max_new_tokens=9, eos_token_id=-1),
                   max_len, kv_quant="int8")
    np.testing.assert_array_equal(tt, jt)


def test_decode_continues_from_a_bridged_jax_state(models):
    """``decode_state_from_numpy``: both packages decode from ONE prefilled
    int8 state (JAX's, carried over bit for bit) to the same tokens."""
    jcfg, tcfg, jp, tp = models
    batch = _batch(jcfg, 5, [5, 2], bucket=1 + jcfg.num_image_tokens + 6)
    max_len = batch[0].shape[1] + 8
    js = jm.generate_prefill(jp, jcfg, *map(jnp.asarray, batch), max_len,
                             compute_dtype=jnp.float32, kv_quant="int8")
    ts = decode_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    assert ts["write_idx"] == batch[0].shape[1] and ts["cache"]["k"].dtype == torch.int8
    assert ts["cache"]["k_s"].dtype == torch.bfloat16
    np.testing.assert_array_equal(ts["cache"]["k"].numpy(), np.asarray(js["cache"]["k"]))
    jt = np.asarray(jm.generate_decode(jp, jcfg, js, jm.GenerationConfig(
        max_new_tokens=7, eos_token_id=-1), compute_dtype=jnp.float32))
    tt = tm.generate_decode(tp, tcfg, ts, tm.GenerationConfig(max_new_tokens=7, eos_token_id=-1),
                            compute_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("spec_k", [2, 4])
def test_spec_stream_matches_jax_and_own_greedy(models, spec_k, kv_quant, monkeypatch):
    """Speculative streams equal JAX's and the port's own plain greedy
    stream, with equal ``windows`` and ``emitted``.  The spec_k = 4 cases run
    the JAX side through its Pallas window kernels (``CULLAVO_WWIN=1``,
    interpret mode; the cache length 128 meets their block contract)."""
    jcfg, tcfg, jp, tp = models
    through_pallas = spec_k == 4
    calls = {"n": 0}
    if through_pallas:
        from cullavo_tpu.ops import wwin_decode as ww

        monkeypatch.setenv("CULLAVO_WWIN", "1")
        name = "wwin_decode_smajor" if kv_quant is None else "wwin_decode_smajor_q8"
        orig = getattr(ww, name)

        def counted(*a, **k):
            calls["n"] += 1
            return orig(*a, **k)

        monkeypatch.setattr(ww, name, counted)
    batch = _batch(jcfg, 21, [5, 8, 2], bucket=1 + jcfg.num_image_tokens + 10)
    max_len = 128 if through_pallas else batch[0].shape[1] + 16
    jgen = jm.GenerationConfig(max_new_tokens=9, do_sample=False, eos_token_id=-1)
    tgen = tm.GenerationConfig(max_new_tokens=9, do_sample=False, eos_token_id=-1)
    jt, jstats = _j_spec(jcfg, jp, batch, jgen, max_len, spec_k, kv_quant)
    assert calls["n"] > 0 or not through_pallas
    tt, tstats = _t_spec(tcfg, tp, batch, tgen, max_len, spec_k, kv_quant)
    np.testing.assert_array_equal(tt, jt)
    assert tstats == jstats
    np.testing.assert_array_equal(tt, _t_greedy(tcfg, tp, batch, tgen, max_len, kv_quant))
    B = len(batch[0])
    assert B <= tstats["emitted"] <= 9 * B and tstats["windows"] >= -(-8 // spec_k)


def test_spec_eos_early_stop_matches_jax(models):
    """A token the greedy stream produces is declared eos: the speculative
    stream stops there and pads with eos, as ``generate_decode`` does."""
    jcfg, tcfg, jp, tp = models
    batch = _batch(jcfg, 1, [5, 7], bucket=1 + jcfg.num_image_tokens + 8)
    max_len = batch[0].shape[1] + 12
    free = _t_greedy(tcfg, tp, batch, tm.GenerationConfig(max_new_tokens=8, eos_token_id=-1),
                     max_len)
    eos = int(free[0, 3])
    tgen = tm.GenerationConfig(max_new_tokens=8, do_sample=False, eos_token_id=eos)
    ref = _t_greedy(tcfg, tp, batch, tgen, max_len)
    assert (ref[0, 3:] == eos).all()
    tt, tstats = _t_spec(tcfg, tp, batch, tgen, max_len, 3)
    np.testing.assert_array_equal(tt, ref)
    jt, jstats = _j_spec(jcfg, jp, batch, jm.GenerationConfig(
        max_new_tokens=8, do_sample=False, eos_token_id=eos), max_len, 3)
    np.testing.assert_array_equal(tt, jt)
    assert tstats == jstats


def test_spec_extra_hist_oracle_and_return_state(models):
    """``extra_hist`` seeded with the true continuation: near-every draft is
    accepted, the stream is still the greedy one and the window count equals
    JAX's.  ``return_state`` hands back the per-row write positions, and a
    cache that is too short only drops the overhanging writes."""
    jcfg, tcfg, jp, tp = models
    bucket = 1 + jcfg.num_image_tokens + 6
    batch = _batch(jcfg, 3, [6], bucket=bucket)
    max_new, spec_k = 12, 4
    max_len = bucket + max_new + spec_k
    tgen = tm.GenerationConfig(max_new_tokens=max_new, do_sample=False, eos_token_id=-1)
    ref = _t_greedy(tcfg, tp, batch, tgen, max_len)
    last_prompt = batch[0][0, int(batch[2][0].sum()) - 1]
    extra = np.concatenate([[last_prompt], ref[0]]).astype(np.int32)[None]
    tt, tstats, fin = _t_spec(tcfg, tp, batch, tgen, max_len, spec_k, extra_hist=extra,
                              return_state=True)
    np.testing.assert_array_equal(tt, ref)
    assert tstats["windows"] <= 4, tstats
    jt, jstats = _j_spec(jcfg, jp, batch, jm.GenerationConfig(
        max_new_tokens=max_new, do_sample=False, eos_token_id=-1), max_len, spec_k,
        extra_hist=extra)
    np.testing.assert_array_equal(tt, jt)
    assert tstats == jstats
    assert fin["write_idx"].dtype == torch.int32 and fin["write_idx"].shape == (1,)
    # every verified token but the last has its k/v in the cache (the last
    # window may verify past max_new; ``emitted`` is capped there)
    written = int(fin["write_idx"][0]) - bucket
    assert tstats["emitted"] - 1 <= written < tstats["emitted"] - 1 + spec_k
    assert int(fin["full_mask"].sum()) == int(batch[2].sum()) + written
    # the tightest cache generate_decode accepts: window writes past its end drop
    tight, _ = _t_spec(tcfg, tp, batch, tgen, bucket + max_new, spec_k, extra_hist=extra)
    np.testing.assert_array_equal(tight, ref)


def test_spec_rejects_sampling_and_narrow_windows(models):
    jcfg, tcfg, jp, tp = models
    batch = _batch(jcfg, 4, [2], bucket=1 + jcfg.num_image_tokens + 4)
    ids, pix, mask = _t(*batch)
    st = tm.generate_prefill(tp, tcfg, ids, pix, mask, ids.shape[1] + 4,
                             compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="greedy-only"):
        tm.generate_decode_spec(tp, tcfg, st, tm.GenerationConfig(do_sample=True), 2, ids,
                                mask.sum(dim=1), compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="spec_k"):
        tm.generate_decode_spec(tp, tcfg, st, tm.GenerationConfig(), 1, ids, mask.sum(dim=1),
                                compute_dtype=torch.float32)


def test_vqa_pipeline_spec_int8_answers_match_jax():
    """``VQAPipeline(spec_k=4, kv_quant="int8").answer_batch`` (bf16,
    chunked prefill, cache rounded to 128 slots) on the byte tokenizer."""
    from cullavo_tpu.config import Config
    from cullavo_tpu.data.tokenizer import ByteTokenizer
    from cullavo_tpu.pipelines.vqa_pipeline import VQAPipeline as JPipe
    from cullavo_tpu_torch.pipelines.vqa_pipeline import VQAPipeline as TPipe

    jcfg, tcfg = j_tiny(260), t_tiny(260)
    jp = jm.init_llava_params(jcfg, jax.random.PRNGKey(0))
    tp = llava_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tk = ByteTokenizer()
    qs = [f"what is {i}?" for i in range(3)]
    pix = np.random.default_rng(0).normal(size=(3, 3, 28, 28)).astype(np.float32)
    kw = dict(batch_size=3, max_new_tokens=6, prefill_chunk=2, kv_quant="int8", spec_k=4)
    ja = JPipe(Config({}), jcfg, tk, jp, **kw).answer_batch(qs, pix)
    ta = TPipe(None, tcfg, tk, tp, **kw).answer_batch(qs, pix)
    assert ta == ja
    plain = TPipe(None, tcfg, tk, tp, batch_size=3, max_new_tokens=6, prefill_chunk=2,
                  kv_quant="int8").answer_batch(qs, pix)
    assert ta == plain
