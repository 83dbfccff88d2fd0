"""The torch port's serving engine against the JAX engine, on the CPU.

Both engines get the same requests (numpy, from a seed) and the same weights
(the JAX initializer's, moved through the bridge; int8 and NF4 bases are
quantized by JAX and bridged).  Everything runs at f32 at the tiny config,
where the port must give the JAX engine's tokens and counters: f32, int8 and
NF4 bases, bf16-typed (here f32) and int8 KV cache, plain and speculative
quanta, prefix reuse on and off.  Float leaves are compared with
``atol=1e-4``.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cullavo_tpu.models.llava import modeling as jm
from cullavo_tpu.models.llava.config import tiny_llava_config as j_tiny
from cullavo_tpu.models.llava.lora import quantize_llm_weights as j_quantize
from cullavo_tpu.serving import Request as JRequest
from cullavo_tpu.serving import ServingEngine as JEngine
from cullavo_tpu_torch import entry as t_entry
from cullavo_tpu_torch.checkpoint.from_jax import llava_params_from_numpy
from cullavo_tpu_torch.models.llava import modeling as tm
from cullavo_tpu_torch.models.llava.config import tiny_llava_config as t_tiny
from cullavo_tpu_torch.serving import Request as TRequest
from cullavo_tpu_torch.serving import ServingEngine as TEngine
from cullavo_tpu_torch.serving import engine as tengine_mod
from cullavo_tpu_torch.serving.io import load_pixels, request_from_row

VOCAB = 128
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JGEN = jm.GenerationConfig(do_sample=False, eos_token_id=-1)
TGEN = tm.GenerationConfig(do_sample=False, eos_token_id=-1)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bridge(jp):
    return llava_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def bases():
    """base name -> (JAX config, port config, JAX params, port params)."""
    jcfg, tcfg = j_tiny(VOCAB), t_tiny(VOCAB)
    jp = jm.init_llava_params(jcfg, jax.random.PRNGKey(0))
    j8 = j_quantize(jp, bits=8)
    # four kv heads of 16: every LLM target is planar NF4 (see test_torch_nf4)
    jcfg4 = dataclasses.replace(jcfg, text=dataclasses.replace(jcfg.text, num_key_value_heads=4))
    tcfg4 = dataclasses.replace(tcfg, text=dataclasses.replace(tcfg.text, num_key_value_heads=4))
    j4 = j_quantize(jm.init_llava_params(jcfg4, jax.random.PRNGKey(1)), bits=4)
    assert "q4p" in j4["language_model"]["layers"]["k"]
    return {"f32": (jcfg, tcfg, jp, _bridge(jp)), "int8": (jcfg, tcfg, j8, _bridge(j8)),
            "nf4": (jcfg4, tcfg4, j4, _bridge(j4))}


def _spec(cfg, rng, req_id, text_len, max_new, head=None, pix="new", extra_hist=None):
    """A request as plain data: image prompt (bos + image run + text) unless
    ``head`` gives the prompt's first tokens."""
    n_img = cfg.num_image_tokens
    if head is None:
        ids = rng.integers(3, VOCAB - 2, size=(1 + n_img + text_len,)).astype(np.int32)
        ids[1:1 + n_img] = cfg.image_token_id
    else:
        ids = np.asarray(list(head) + rng.integers(4, VOCAB - 2, size=(text_len,)).tolist(),
                         np.int32)
    if isinstance(pix, str):
        side = cfg.vision.image_size
        pix = rng.normal(size=(3, side, side)).astype(np.float32)
    return dict(req_id=req_id, input_ids=ids, pixel_values=pix, max_new_tokens=max_new,
                extra_hist=extra_hist)


def _image(cfg, rng):
    side = cfg.vision.image_size
    return rng.normal(size=(3, side, side)).astype(np.float32)


def _buckets(cfg):
    base = 1 + cfg.num_image_tokens
    return (base + 8, base + 16)


def _run_both(base, specs, **kw):
    """Run the same requests through both engines; tokens and the counters
    both engines keep must be equal.  A speculative port engine is held to
    the JAX engine with PLAIN quanta, the stream both packages promise for
    spec_k (the JAX speculative quantum loses the tokens of a window that
    crosses the quantum's end; the scheduler counters do not depend on
    spec_k).  Returns (results, port engine, JAX engine)."""
    jcfg, tcfg, jp, tp = base
    gens = kw.pop("gen", (JGEN, TGEN))
    jeng = JEngine(jp, jcfg, gens[0], compute_dtype=jnp.float32, **{**kw, "spec_k": None})
    teng = TEngine(tp, tcfg, gens[1], compute_dtype=torch.float32, **kw)
    for s in specs:
        jeng.submit(JRequest(**s))
        teng.submit(TRequest(**s))
    jres, tres = jeng.run(), teng.run()
    assert set(tres) == {s["req_id"] for s in specs}
    for s in specs:
        assert tres[s["req_id"]] == jres[s["req_id"]], (
            f"req {s['req_id']}: port {tres[s['req_id']]} != JAX {jres[s['req_id']]}")
    for key, n in jeng.counters.items():
        assert teng.counters[key] == n, (key, teng.counters, jeng.counters)
    assert teng.num_slots == jeng.num_slots
    assert teng.max_len == (jeng.max_len if not kw.get("spec_k") else
                            -(-(jeng.max_len + kw["spec_k"]) // 128) * 128)
    return tres, teng, jeng


def _offline(cfg, params, spec, bucket, max_len, gen=TGEN):
    """The port's own reference stream: the request alone, padded to its
    bucket, prefilled and decoded at the engine's cache length."""
    T = len(spec["input_ids"])
    ids = np.zeros((1, bucket), np.int32)
    mask = np.zeros((1, bucket), np.int32)
    ids[0, :T] = spec["input_ids"]
    mask[0, :T] = 1
    pix = spec["pixel_values"]
    state = tm.generate_prefill(params, cfg, torch.from_numpy(ids),
                                None if pix is None else torch.from_numpy(pix[None]),
                                torch.from_numpy(mask), max_len, compute_dtype=torch.float32)
    g = dataclasses.replace(gen, max_new_tokens=spec["max_new_tokens"])
    out = tm.generate_decode(params, cfg, state, g, compute_dtype=torch.float32)[0].tolist()
    toks = []
    for t in out:
        toks.append(int(t))
        if int(t) == gen.eos_token_id:
            break
    return toks[:spec["max_new_tokens"]]


MIX = [(3, 6), (8, 10), (14, 4), (5, 12), (15, 7), (2, 1)]   # the last finishes at admission


@pytest.mark.parametrize("base,kv_quant,spec_k", [
    ("f32", None, None), ("f32", "int8", 3), ("int8", "int8", None), ("int8", None, 3),
    ("nf4", None, None), ("nf4", "int8", 3)])
def test_serving_matches_jax_engine(bases, base, kv_quant, spec_k):
    """Mixed prompt lengths and budgets, fewer slots than requests, a small
    quantum: tokens and counters of the JAX engine; on the dense base with
    the plain cache also the port's own offline stream of each request (the
    engine is a pure scheduling layer)."""
    jcfg, tcfg, _, tp = bases[base]
    rng = np.random.default_rng(0)
    buckets = _buckets(tcfg)
    max_len = buckets[-1] + 14
    specs = [_spec(tcfg, rng, i, tl, mn) for i, (tl, mn) in enumerate(MIX)]
    res, teng, _ = _run_both(bases[base], specs, num_slots=3, max_len=max_len,
                             prompt_buckets=buckets, prefill_chunk=2, quantum=3,
                             kv_quant=kv_quant, spec_k=spec_k)
    assert [len(res[i]) for i in range(len(MIX))] == [mn for _, mn in MIX]
    assert teng.counters["prefix_misses"] == len(MIX) and teng.counters["suffix_wide_windows"] == 0
    if (base, kv_quant, spec_k) == ("f32", None, None):
        for s in specs:
            bucket = next(b for b in buckets if len(s["input_ids"]) <= b)
            assert res[s["req_id"]] == _offline(tcfg, tp, s, bucket, max_len)


def test_serving_eos_retires_early(bases):
    """A request whose stream hits EOS mid-quantum is trimmed there and its
    slot is reused, as in the JAX engine."""
    jcfg, tcfg, _, tp = bases["f32"]
    rng = np.random.default_rng(1)
    buckets = _buckets(tcfg)
    max_len = buckets[-1] + 14
    probe = _spec(tcfg, rng, 0, 4, 10)
    eos = _offline(tcfg, tp, probe, buckets[0], max_len)[2]
    gens = (dataclasses.replace(JGEN, eos_token_id=eos), dataclasses.replace(TGEN, eos_token_id=eos))
    specs = [probe, _spec(tcfg, rng, 1, 9, 8)]
    res, _, _ = _run_both(bases["f32"], specs, gen=gens, num_slots=3, max_len=max_len,
                          prompt_buckets=buckets, prefill_chunk=2, quantum=3)
    assert res[0][-1] == eos and len(res[0]) <= 10
    for s in specs:
        bucket = next(b for b in buckets if len(s["input_ids"]) <= b)
        assert res[s["req_id"]] == _offline(tcfg, tp, s, bucket, max_len, gens[1])


def _uniform_pool(bases, seed, n_new, spec_k):
    """Two rows of equal length, prefilled by both packages and dressed as a
    slot pool (per-row write positions), with the lookup history a spec_k
    engine would have filled at admission."""
    jcfg, tcfg, jp, tp = bases["f32"]
    rng = np.random.default_rng(seed)
    n_img = tcfg.num_image_tokens
    T, max_len = 1 + n_img + 6, 128
    ids = rng.integers(3, VOCAB - 2, size=(2, T)).astype(np.int32)
    ids[:, 1:1 + n_img] = tcfg.image_token_id
    pix = rng.normal(size=(2, 3, 28, 28)).astype(np.float32)
    mask = np.ones((2, T), np.int32)

    def fresh():
        return tm.generate_prefill(tp, tcfg, torch.from_numpy(ids), torch.from_numpy(pix),
                                   torch.from_numpy(mask), max_len, compute_dtype=torch.float32)

    gen = dataclasses.replace(TGEN, max_new_tokens=n_new)
    ref = tm.generate_decode(tp, tcfg, fresh(), gen, compute_dtype=torch.float32).numpy()
    state = fresh()
    first = state["logits"].argmax(-1).to(torch.int32)
    np.testing.assert_array_equal(first.numpy(), ref[:, 0])
    state.update(write_idx=torch.full((2,), T, dtype=torch.int32), cur_tok=first,
                 done=torch.zeros((2,), dtype=torch.bool))
    jstate = jm.generate_prefill(jp, jcfg, jnp.asarray(ids), jnp.asarray(pix), jnp.asarray(mask),
                                 max_len, compute_dtype=jnp.float32)
    jstate.update(write_idx=jnp.full((2,), T, jnp.int32), cur_tok=jnp.asarray(first.numpy()),
                  done=jnp.zeros((2,), jnp.bool_))
    hist = np.zeros((2, max_len + 8 + (spec_k or 0)), np.int32)
    hist[:, :T], hist[:, T] = ids, first.numpy()
    hlen = np.full((2,), T + 1, np.int32)
    return T, gen, ref, state, jstate, hist, hlen


def test_decode_quantum_uniform_matches_generate_decode(bases):
    """The per-row write path must equal the contiguous-slab path when all
    rows are uniform: a quantum on a fresh prefill gives generate_decode's
    tokens 2..9, and the JAX quantum's; the pool is updated in place."""
    jcfg, tcfg, jp, tp = bases["f32"]
    T, gen, ref, state, jstate, _, _ = _uniform_pool(bases, 2, 9, None)
    toks, new = tm.decode_quantum(tp, tcfg, state, gen, 8, compute_dtype=torch.float32)
    jtoks, _ = jm.decode_quantum(jp, jcfg, jstate, dataclasses.replace(JGEN, max_new_tokens=9), 8,
                                 compute_dtype=jnp.float32)
    np.testing.assert_array_equal(toks.numpy(), ref[:, 1:9])
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    assert new["cache"]["k"] is state["cache"]["k"] and new["full_mask"] is state["full_mask"]
    np.testing.assert_array_equal(new["write_idx"].numpy(), [T + 8, T + 8])
    np.testing.assert_array_equal(new["full_mask"][:, :T + 9].numpy(),
                                  np.concatenate([np.ones((2, T + 8)), np.zeros((2, 1))], 1))


def test_decode_quantum_spec_matches_jax_and_generate_decode(bases):
    """A speculative quantum in which no window crosses the quantum's end:
    tokens, emitted counts, forwards, history and write positions are the JAX
    function's, and the tokens generate_decode's."""
    jcfg, tcfg, jp, tp = bases["f32"]
    spec_k = 3
    T, gen, ref, state, jstate, hist, hlen = _uniform_pool(bases, 5, 9, spec_k)
    toks, n_emit, new, hs = tm.decode_quantum_spec(
        tp, tcfg, state, {"hist": torch.from_numpy(hist.copy()),
                          "hist_len": torch.from_numpy(hlen.copy())},
        gen, 8, spec_k, compute_dtype=torch.float32)
    jtoks, jn, jnew, jhs = jm.decode_quantum_spec(
        jp, jcfg, jstate, {"hist": jnp.asarray(hist), "hist_len": jnp.asarray(hlen)},
        dataclasses.replace(JGEN, max_new_tokens=9), 8, spec_k, compute_dtype=jnp.float32)
    np.testing.assert_array_equal(np.asarray(jnew["write_idx"]), [T + 8, T + 8])   # no crossing
    np.testing.assert_array_equal(n_emit.numpy(), [8, 8])
    np.testing.assert_array_equal(n_emit.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(toks.numpy(), ref[:, 1:9])
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    assert hs["n_fwd"] == int(jhs["n_fwd"]) < 8
    for key, a, b in (("hist_len", hs["hist_len"], jhs["hist_len"]), ("hist", hs["hist"], jhs["hist"]),
                      ("write_idx", new["write_idx"], jnew["write_idx"]),
                      ("cur_pos", new["cur_pos"], jnew["cur_pos"]),
                      ("cur_tok", new["cur_tok"], jnew["cur_tok"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=key)
    valid = np.asarray(jnew["full_mask"]) > 0
    np.testing.assert_array_equal(new["full_mask"].numpy() > 0, valid)
    np.testing.assert_array_equal(new["key_pos"].numpy()[valid], np.asarray(jnew["key_pos"])[valid])
    with pytest.raises(ValueError, match="spec_k < 2"):
        tm.decode_quantum_spec(tp, tcfg, state, hs, gen, 8, 1)


def test_decode_quantum_spec_never_crosses_the_quantum(bases):
    """Here a verified window reaches past the quantum's end (the JAX function
    advances the row over those tokens and returns only the first 8, so they
    are lost to the stream).  The port stops the row at the quantum's end:
    two quanta in a row give generate_decode's tokens 2..17."""
    jcfg, tcfg, jp, tp = bases["f32"]
    spec_k = 3
    T, gen, ref, state, jstate, hist, hlen = _uniform_pool(bases, 4, 17, spec_k)
    _, _, jnew, _ = jm.decode_quantum_spec(
        jp, jcfg, jstate, {"hist": jnp.asarray(hist), "hist_len": jnp.asarray(hlen)},
        dataclasses.replace(JGEN, max_new_tokens=17), 8, spec_k, compute_dtype=jnp.float32)
    assert int(np.asarray(jnew["write_idx"]).max()) > T + 8          # a window crosses here
    hs = {"hist": torch.from_numpy(hist.copy()), "hist_len": torch.from_numpy(hlen.copy())}
    out = []
    for _ in range(2):
        toks, n_emit, state, hs = tm.decode_quantum_spec(tp, tcfg, state, hs, gen, 8, spec_k,
                                                         compute_dtype=torch.float32)
        np.testing.assert_array_equal(n_emit.numpy(), [8, 8])
        out.append(toks.numpy())
    np.testing.assert_array_equal(np.concatenate(out, axis=1), ref[:, 1:17])
    np.testing.assert_array_equal(state["write_idx"].numpy(), [T + 16, T + 16])
    np.testing.assert_array_equal(hs["hist_len"].numpy(), [T + 17, T + 17])
    assert hs["n_fwd"] < 16


def test_serving_rejects_bad_submissions(bases):
    jcfg, tcfg, _, tp = bases["f32"]
    rng = np.random.default_rng(4)
    buckets = _buckets(tcfg)
    eng = TEngine(tp, tcfg, TGEN, num_slots=2, max_len=buckets[-1] + 8, prompt_buckets=buckets,
                  compute_dtype=torch.float32)
    eng.submit(TRequest(**_spec(tcfg, rng, 7, 3, 4)))
    with pytest.raises(ValueError, match="duplicate req_id 7"):
        eng.submit(TRequest(**_spec(tcfg, rng, 7, 5, 4)))
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(TRequest(**_spec(tcfg, rng, 8, 5, 40)))
    with pytest.raises(ValueError, match="largest bucket"):
        eng.submit(TRequest(**_spec(tcfg, rng, 9, 30, 2)))
    # without adapters, or with one set, only adapter 0 is served; a multi
    # stack of two serves 0 and 1
    with pytest.raises(ValueError, match="adapter_id 1 out of range"):
        eng.submit(TRequest(**{**_spec(tcfg, rng, 10, 3, 4), "adapter_id": 1}))
    from cullavo_tpu_torch.models.llava import lora as tl

    one = tl.init_lora_params(tp, tcfg, tl.LoraConfig(r=4), torch.Generator().manual_seed(1))
    kw = dict(max_len=buckets[-1] + 8, prompt_buckets=buckets, compute_dtype=torch.float32)
    assert TEngine(tp, tcfg, TGEN, lora=one, lora_scaling=0.25, **kw)._num_adapters == 1
    two = TEngine(tp, tcfg, TGEN, lora={"language_model": tl.stack_adapter_sets(
        [one["language_model"]] * 2)}, lora_scaling=0.25, **kw)
    assert two._num_adapters == 2
    two.submit(TRequest(**{**_spec(tcfg, rng, 11, 3, 4), "adapter_id": 1}))
    with pytest.raises(ValueError, match="adapter_id 2 out of range"):
        two.submit(TRequest(**{**_spec(tcfg, rng, 12, 3, 4), "adapter_id": 2}))


def test_serving_batched_admission_and_latency(bases, monkeypatch):
    """write_slots (a chunk-wide slot vector, slot -1 = dropped) admits as
    the engine's per-request write_slot does, and the engine keeps TTFT/E2E
    times for every request."""
    jcfg, tcfg, jp, tp = bases["f32"]
    rng = np.random.default_rng(5)
    buckets = _buckets(tcfg)
    max_len = buckets[-1] + 14
    specs = [_spec(tcfg, rng, i, tl, mn) for i, (tl, mn) in enumerate([(3, 6), (7, 1), (5, 8), (2, 5)])]
    ref, _, _ = _run_both(bases["f32"], specs, num_slots=2, max_len=max_len,
                          prompt_buckets=buckets, prefill_chunk=3, quantum=3)
    eng = TEngine(tp, tcfg, TGEN, num_slots=2, max_len=max_len, prompt_buckets=buckets,
                  prefill_chunk=3, quantum=3, compute_dtype=torch.float32)

    def admit_group(pool, chunk, row, slot, first_tok, done0):
        # the engine's per-request call, answered by one write_slots over a
        # chunk-wide vector whose other rows are -1 (not admitted)
        n = chunk["logits"].shape[0]
        slots, toks = np.full((n,), -1, np.int32), np.zeros((n,), np.int32)
        slots[row], toks[row] = slot, first_tok
        return tm.write_slots(pool, chunk, slots, toks, np.full((n,), done0))

    monkeypatch.setattr(tengine_mod, "write_slot", admit_group)
    for s in specs:
        eng.submit(TRequest(**s))
    assert eng.run() == ref
    lat = eng.latency()
    assert lat["ttft"]["p50"] > 0 and lat["e2e"]["p95"] >= lat["ttft"]["p50"]
    assert all("done" in t for t in eng.times.values())


def test_write_slots_drops_rows_without_wrapping(bases):
    """Slot -1 means "not admitted": it must not wrap onto the last pool row,
    which here holds a live request; slots past the pool are dropped too."""
    jcfg, tcfg, _, tp = bases["f32"]
    rng = np.random.default_rng(6)
    T = 1 + tcfg.num_image_tokens + 4
    ids = rng.integers(3, VOCAB - 2, size=(3, T)).astype(np.int32)
    chunk = tm.generate_prefill(tp, tcfg, torch.from_numpy(ids), None,
                                torch.ones((3, T), dtype=torch.int32), 24,
                                compute_dtype=torch.float32, kv_quant="int8")
    pool = tm.alloc_decode_state(chunk, 4)
    pool.update(write_idx=torch.zeros(4, dtype=torch.int32), cur_tok=torch.zeros(4, dtype=torch.int32),
                done=torch.ones(4, dtype=torch.bool))
    pool = tm.write_slot(pool, chunk, 2, 3, 55, False)          # a live request in the last row
    before = {k: v.clone() for k, v in pool["cache"].items()}
    pool = tm.write_slots(pool, chunk, np.array([-1, 1, 7]), np.array([11, 12, 13]),
                          np.zeros(3, bool))
    for name, a in pool["cache"].items():
        assert torch.equal(a[:, :, 3], before[name][:, :, 3]) and torch.equal(a[:, :, 3], chunk["cache"][name][:, :, 2])
        assert torch.equal(a[:, :, 1], chunk["cache"][name][:, :, 1])
        assert not a[:, :, 0].any() and not a[:, :, 2].any()
    assert pool["cur_tok"].tolist() == [0, 12, 0, 55] and pool["done"].tolist() == [True, False, True, False]
    assert pool["write_idx"].tolist() == [0, T, 0, T]
    assert torch.equal(pool["key_pos"][1], chunk["key_pos"][1])
    with pytest.raises(ValueError, match="duplicate target"):
        tm.write_slots(pool, chunk, [1, 1, -1], [1, 2, 3], [False] * 3)
    with pytest.raises(IndexError):
        tm.write_slot(pool, chunk, 0, -1, 1, False)


def test_serving_spec_k_matches_plain_engine(bases):
    """spec_k streams are token-exact vs the plain engine: prompt-lookup
    windows change only how many forwards a quantum takes.  An oracle
    ``extra_hist`` row (every draft lands) included."""
    jcfg, tcfg, _, tp = bases["f32"]
    rng = np.random.default_rng(11)
    buckets = _buckets(tcfg)
    max_len = buckets[-1] + 14
    specs = [_spec(tcfg, rng, i, tl, mn)
             for i, (tl, mn) in enumerate([(4, 9), (12, 6), (7, 12), (2, 4), (15, 10)])]
    kw = dict(num_slots=3, max_len=max_len, prompt_buckets=buckets, prefill_chunk=2, quantum=3)
    plain, _, _ = _run_both(bases["f32"], specs, **kw)
    spec, teng, _ = _run_both(bases["f32"], specs, spec_k=3, **kw)
    assert spec == plain
    s = specs[2]
    oracle = {**s, "req_id": 99,
              "extra_hist": np.concatenate([[int(s["input_ids"][-1])],
                                            np.asarray(plain[2], np.int32)]).astype(np.int32)}
    out, oeng, _ = _run_both(bases["f32"], [oracle], spec_k=4, **kw)
    assert out[99] == plain[2]
    # 11 tokens after the first in quanta of 3, every draft accepted: 4 forwards
    assert oeng.hist["n_fwd"] == 4 < teng.hist["n_fwd"]


def test_spec_auto_disabled_under_sampling(bases, capsys):
    """serve.yaml ships SPEC_K 4, so a config that merely flips DO_SAMPLE
    must not fail at engine init: spec is disabled with a warning, as in
    JAX, and the sampled engine serves with plain quanta (its draws against
    JAX's: tests/test_torch_multi_lora.py)."""
    jcfg, tcfg, _, tp = bases["f32"]
    rng = np.random.default_rng(7)
    buckets = _buckets(tcfg)
    gen = tm.GenerationConfig(do_sample=True, temperature=1.0, eos_token_id=-1)
    eng = TEngine(tp, tcfg, gen, num_slots=2, max_len=buckets[-1] + 8, prompt_buckets=buckets,
                  prefill_chunk=1, quantum=2, compute_dtype=torch.float32, spec_k=4)
    assert eng.spec_k is None and eng.max_len == buckets[-1] + 8
    assert "disables speculative decoding" in capsys.readouterr().err
    eng.submit(TRequest(**_spec(tcfg, rng, 0, 3, 4)))
    out = eng.run()[0]
    assert len(out) == 4 and all(0 <= t < VOCAB for t in out) and eng.hist is None


def test_engine_derates_slots_to_memory_budget(bases, monkeypatch):
    """A pool that cannot fit next to the weights derates num_slots with a
    warning; a budget too small for one slot fails fast with the numbers.
    The per-slot bytes are JAX's."""
    jcfg, tcfg, jp, tp = bases["f32"]
    rng = np.random.default_rng(9)
    buckets = _buckets(tcfg)
    kw = dict(num_slots=4, max_len=buckets[-1] + 8, prompt_buckets=buckets, prefill_chunk=1,
              quantum=2)
    probe = TEngine(tp, tcfg, TGEN, compute_dtype=torch.float32, **kw)
    per_slot = probe._pool_bytes_per_slot()
    assert per_slot == JEngine(jp, jcfg, JGEN, compute_dtype=jnp.float32, **kw)._pool_bytes_per_slot()
    for kv_quant in (None, "int8"):
        a = TEngine(tp, tcfg, TGEN, kv_quant=kv_quant, spec_k=4, **kw)
        b = JEngine(jp, jcfg, JGEN, kv_quant=kv_quant, spec_k=4, **kw)
        assert a._pool_bytes_per_slot() == b._pool_bytes_per_slot() and a.max_len == b.max_len == 128
    weights = sum(getattr(v, "nbytes", 0) for v in jax.tree.leaves(jp))
    # budget sized for exactly 2 slots after the 8% margin
    monkeypatch.setenv("CULLAVO_SERVE_HBM_GB", str((weights + 2.5 * per_slot) / 0.92 / 1e9))
    eng = TEngine(tp, tcfg, TGEN, compute_dtype=torch.float32, prefix_cache=False, **kw)
    jeng = JEngine(jp, jcfg, JGEN, compute_dtype=jnp.float32, prefix_cache=False, **kw)
    assert eng.num_slots == jeng.num_slots == 2 and len(eng.free) == 2
    for i in range(3):
        eng.submit(TRequest(**_spec(tcfg, rng, i, 3, 4)))
    results = eng.run()
    assert sorted(results) == [0, 1, 2] and all(len(v) == 4 for v in results.values())
    monkeypatch.setenv("CULLAVO_SERVE_HBM_GB", str(weights / 0.92 / 1e9))
    with pytest.raises(ValueError, match="decode pool cannot fit"):
        TEngine(tp, tcfg, TGEN, compute_dtype=torch.float32, prefix_cache=False, **kw)


# ---------------------------------------------------------------------------
# prefix reuse: the modeling functions
# ---------------------------------------------------------------------------

def _full_states(base, rows, pix, max_len, kv_quant=None):
    jcfg, tcfg, jp, tp = base
    B, T = len(rows), max(len(r) for r in rows)
    ids = np.zeros((B, T), np.int32)
    mask = np.zeros((B, T), np.int32)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
        mask[i, :len(r)] = 1
    js = jm.generate_prefill(jp, jcfg, jnp.asarray(ids), None if pix is None else jnp.asarray(pix),
                             jnp.asarray(mask), max_len, compute_dtype=jnp.float32,
                             kv_quant=kv_quant)
    ts = tm.generate_prefill(tp, tcfg, torch.from_numpy(ids),
                             None if pix is None else torch.from_numpy(pix),
                             torch.from_numpy(mask), max_len, compute_dtype=torch.float32,
                             kv_quant=kv_quant)
    return js, ts


def _decode(base, ts, n=8):
    _, tcfg, _, tp = base
    return tm.generate_decode(tp, tcfg, ts, dataclasses.replace(TGEN, max_new_tokens=n),
                              compute_dtype=torch.float32).numpy()


def _suffix_states(base, jprefix, tprefix, sfx, pix, smask, P):
    jcfg, tcfg, jp, tp = base
    js = jm.generate_prefill_prefix(jp, jcfg, jprefix, jnp.asarray(sfx),
                                    None if pix is None else jnp.asarray(pix),
                                    jnp.asarray(smask), P, compute_dtype=jnp.float32)
    ts = tm.generate_prefill_prefix(tp, tcfg, tprefix, torch.from_numpy(sfx),
                                    None if pix is None else torch.from_numpy(pix),
                                    torch.from_numpy(smask), P, compute_dtype=torch.float32)
    assert int(ts["write_idx"]) == int(js["write_idx"]) == P + sfx.shape[1]
    for key in ("cur_pos", "full_mask", "key_pos"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]), err_msg=key)
    np.testing.assert_allclose(ts["logits"].numpy(), np.asarray(js["logits"]), atol=1e-4, rtol=0)
    return js, ts


@pytest.mark.parametrize("base,kv_quant", [("f32", None), ("f32", "int8"), ("nf4", "int8")])
def test_prefix_suffix_matches_full_prefill_text(bases, base, kv_quant):
    """Text-only: two requests sharing a 12-token head.  The suffix state
    equals JAX's leaf for leaf, and its decode stream the full prefill's."""
    rng = np.random.default_rng(0)
    head = rng.integers(4, VOCAB - 2, size=(12,)).tolist()
    tails = [rng.integers(4, VOCAB - 2, size=(n,)).tolist() for n in (5, 3)]
    rows = [head + t for t in tails]
    P, W = 12, 5
    max_len = P + W + 10
    _, ref = _full_states(bases[base], rows, None, max_len, kv_quant)
    ref_toks = _decode(bases[base], ref)
    jpfx, tpfx = _full_states(bases[base], [head], None, max_len, kv_quant)
    jprefix, tprefix = jm.extract_prefix_state(jpfx, 0), tm.extract_prefix_state(tpfx, 0)
    stored = {k: v.clone() for k, v in tprefix["cache"].items()}
    sfx = np.zeros((2, W), np.int32)
    smask = np.zeros((2, W), np.int32)
    for i, t in enumerate(tails):
        sfx[i, :len(t)] = t
        smask[i, :len(t)] = 1
    _, state = _suffix_states(bases[base], jprefix, tprefix, sfx, None, smask, P)
    np.testing.assert_array_equal(state["cur_pos"].numpy(), [len(r) for r in rows])
    np.testing.assert_array_equal(_decode(bases[base], state), ref_toks)
    # the stored prefix row is a copy and is not written by the suffix forward
    for name, a in tprefix["cache"].items():
        assert torch.equal(a, stored[name]) and a.shape[2] == 1
        assert a.untyped_storage().data_ptr() != tpfx["cache"][name].untyped_storage().data_ptr()
        assert set(state["cache"]) == set(tprefix["cache"])


def test_prefix_suffix_matches_full_prefill_image_in_suffix(bases):
    """The image run rides in the suffix: the pixel merge works through the
    stale-cache window path."""
    base = bases["f32"]
    tcfg = base[1]
    rng = np.random.default_rng(1)
    n_img = tcfg.num_image_tokens
    head = rng.integers(4, VOCAB - 2, size=(6,)).tolist()
    img_run = [tcfg.image_token_id] * n_img
    tails = [rng.integers(4, VOCAB - 2, size=(n,)).tolist() for n in (4, 2)]
    rows = [head + img_run + t for t in tails]
    pix = rng.normal(size=(2, 3, 28, 28)).astype(np.float32)
    P, W = 6, n_img + 4
    max_len = P + W + 10
    _, ref = _full_states(base, rows, pix, max_len)
    ref_toks = _decode(base, ref)
    jpfx, tpfx = _full_states(base, [head], None, max_len)
    sfx = np.zeros((2, W), np.int32)
    smask = np.zeros((2, W), np.int32)
    for i, t in enumerate(tails):
        row = img_run + t
        sfx[i, :len(row)] = row
        smask[i, :len(row)] = 1
    _, state = _suffix_states(base, jm.extract_prefix_state(jpfx, 0),
                              tm.extract_prefix_state(tpfx, 0), sfx, pix, smask, P)
    np.testing.assert_array_equal(_decode(base, state), ref_toks)


def test_prefix_reused_at_shorter_split(bases):
    """A stored prefix longer than the reuse point: slots past prefix_len
    stay masked, so a 9-token stored prefix serves a P = 6 split exactly."""
    base = bases["f32"]
    rng = np.random.default_rng(2)
    stored = rng.integers(4, VOCAB - 2, size=(9,)).tolist()
    P = 6
    tail = rng.integers(4, VOCAB - 2, size=(7,)).tolist()
    max_len = 24
    _, ref = _full_states(base, [stored[:P] + tail], None, max_len)
    jpfx, tpfx = _full_states(base, [stored], None, max_len)
    sfx = np.asarray([tail], np.int32)
    _, state = _suffix_states(base, jm.extract_prefix_state(jpfx, 0),
                              tm.extract_prefix_state(tpfx, 0), sfx, None, np.ones_like(sfx), P)
    np.testing.assert_array_equal(_decode(base, state), _decode(base, ref))


def test_wide_suffix_window_takes_the_plain_attention(bases):
    """A suffix wider than the 128 rows the decode-attention kernels take is
    one plain stale-cache window (on either device), equal to JAX's."""
    base = bases["f32"]
    rng = np.random.default_rng(3)
    head = rng.integers(4, VOCAB - 2, size=(40,)).tolist()
    tail = rng.integers(4, VOCAB - 2, size=(134,)).tolist()
    P, W, max_len = 40, 136, 192
    _, ref = _full_states(base, [head + tail], None, max_len)
    jpfx, tpfx = _full_states(base, [head], None, max_len)
    sfx = np.zeros((1, W), np.int32)
    smask = np.zeros((1, W), np.int32)
    sfx[0, :134], smask[0, :134] = tail, 1
    _, state = _suffix_states(base, jm.extract_prefix_state(jpfx, 0),
                              tm.extract_prefix_state(tpfx, 0), sfx, None, smask, P)
    np.testing.assert_array_equal(_decode(base, state), _decode(base, ref))


# ---------------------------------------------------------------------------
# prefix reuse: the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("base,kv_quant,spec_k", [("f32", None, None), ("f32", "int8", 3),
                                                  ("nf4", "int8", 3)])
def test_engine_prefix_reuse_same_image(bases, base, kv_quant, spec_k):
    """2 images x 3 and 2 questions sharing a SYSTEM + <image> head per
    image: later questions prefill only their suffix; tokens and counters are
    the JAX engine's, and on the dense base the offline full-prefill
    streams."""
    jcfg, tcfg, _, tp = bases[base]
    rng = np.random.default_rng(11)
    n_img = tcfg.num_image_tokens
    sys_head = rng.integers(4, VOCAB - 2, size=(6,)).tolist()
    head = sys_head + [tcfg.image_token_id] * n_img
    pixA, pixB = _image(tcfg, rng), _image(tcfg, rng)
    specs = [_spec(tcfg, rng, i, tl, mn, head=head, pix=p)
             for i, (tl, mn, p) in enumerate([(4, 6, pixA), (6, 5, pixA), (3, 6, pixA),
                                              (5, 4, pixB), (2, 6, pixB)])]
    bucket = len(head) + 8
    max_len = bucket + 16
    res, teng, _ = _run_both(bases[base], specs, num_slots=3, max_len=max_len,
                             prompt_buckets=(bucket,), prefill_chunk=2, quantum=3,
                             kv_quant=kv_quant, spec_k=spec_k, prefix_cache=True, prefix_min=8,
                             suffix_buckets=(8, 16), max_prefixes=2)
    assert teng.counters["prefix_hits"] == 3 and teng.counters["prefix_misses"] == 2
    assert teng.counters["prefix_tokens_saved"] == 3 * len(head)
    if base == "f32" and kv_quant is None:
        for s in specs:
            assert res[s["req_id"]] == _offline(tcfg, tp, s, bucket, max_len), s["req_id"]
    # registry rows are copies of one cache row, not views of a prefill chunk
    for e in teng._prefix_reg.values():
        k = e["state"]["cache"]["k"]
        assert k.shape[2] == 1 and k.untyped_storage().nbytes() == k.numel() * k.element_size()


def test_engine_prefix_reuse_text_corpus_and_eviction(bases):
    """A text corpus sharing a 16-token system head; max_prefixes=1 with an
    interleaved image request forces LRU eviction."""
    jcfg, tcfg, _, tp = bases["f32"]
    rng = np.random.default_rng(12)
    head = rng.integers(4, VOCAB - 2, size=(16,)).tolist()
    pix = _image(tcfg, rng)
    img_head = [tcfg.image_token_id] * tcfg.num_image_tokens
    specs = [_spec(tcfg, rng, 0, 4, 5, head=head, pix=None),
             _spec(tcfg, rng, 1, 6, 5, head=head, pix=None),
             _spec(tcfg, rng, 2, 5, 4, head=img_head, pix=pix),   # evicts the text prefix
             _spec(tcfg, rng, 3, 3, 5, head=head, pix=None),      # re-registers
             _spec(tcfg, rng, 4, 5, 5, head=head, pix=None)]      # hits again
    buckets = (tcfg.num_image_tokens + 8, len(head) + 8)
    max_len = max(buckets) + 16
    res, teng, _ = _run_both(bases["f32"], specs, num_slots=2, max_len=max_len,
                             prompt_buckets=buckets, prefill_chunk=1, quantum=2,
                             prefix_cache=True, prefix_min=8, suffix_buckets=(8, 16),
                             max_prefixes=1)
    for s in specs:
        b = next(x for x in sorted(buckets) if len(s["input_ids"]) <= x)
        assert res[s["req_id"]] == _offline(tcfg, tp, s, b, max_len), s["req_id"]
    assert len(teng._prefix_reg) == 1 and teng.counters["prefix_hits"] >= 2


def test_engine_prefix_off_and_pacing(bases):
    """prefix_cache=False: no registry, no counters; admit_groups=1 with
    more pending groups than one step admits still answers every request."""
    jcfg, tcfg, _, tp = bases["f32"]
    rng = np.random.default_rng(13)
    head = rng.integers(4, VOCAB - 2, size=(12,)).tolist()
    specs = [_spec(tcfg, rng, i, 2 + i, 4, head=head, pix=None) for i in range(5)]
    bucket = len(head) + 8
    max_len = bucket + 12
    res, teng, _ = _run_both(bases["f32"], specs, num_slots=4, max_len=max_len,
                             prompt_buckets=(bucket,), prefill_chunk=1, quantum=2,
                             prefix_cache=False, admit_groups=1)
    for s in specs:
        assert res[s["req_id"]] == _offline(tcfg, tp, s, bucket, max_len), s["req_id"]
    assert len(teng._prefix_reg) == 0
    assert teng.counters["prefix_hits"] == teng.counters["prefix_misses"] == 0


def test_engine_prefix_never_splits_image_run(bases):
    """A tight pool cache forces the reuse point BELOW the LCP, into the
    image-token run; the plan clamps it to the run's start, as in JAX."""
    jcfg, tcfg, _, tp = bases["f32"]
    rng = np.random.default_rng(21)
    n_img = tcfg.num_image_tokens
    head = rng.integers(4, VOCAB - 2, size=(6,)).tolist() + [tcfg.image_token_id] * n_img
    pix = _image(tcfg, rng)
    max_new, wb = 4, 16
    specs = [_spec(tcfg, rng, 0, 5, max_new, head=head, pix=pix),
             _spec(tcfg, rng, 1, 3, max_new, head=head, pix=pix)]
    bucket = len(head) + 8
    max_len = wb + max_new + 6 + n_img // 2
    assert 6 < max_len - wb - max_new < 6 + n_img
    res, teng, _ = _run_both(bases["f32"], specs, num_slots=2, max_len=max_len,
                             prompt_buckets=(bucket,), prefill_chunk=1, quantum=2,
                             prefix_cache=True, prefix_min=4, suffix_buckets=(wb,),
                             max_prefixes=2)
    for s in specs:
        assert res[s["req_id"]] == _offline(tcfg, tp, s, bucket, max_len), s["req_id"]
    assert teng.counters["prefix_hits"] == 1 and teng.counters["prefix_tokens_saved"] == 6


def test_engine_split_rounded_into_image_run_is_settled_again():
    """An image run of 64 tokens at [5, 69) and a shared head of 70 tokens:
    the reuse point 70 lies outside the run, but its 32-multiple, 64, lies
    inside it, where the suffix forward would rank its five image tokens from
    0 and merge the wrong features.  The port settles the point again after
    rounding (here to the run's start) and so equals its own full prefill."""
    tcfg = t_tiny(VOCAB)
    tcfg = dataclasses.replace(tcfg, vision=dataclasses.replace(tcfg.vision, image_size=112))
    assert tcfg.num_image_tokens == 64
    tp = tm.init_llava_params(tcfg, torch.Generator().manual_seed(3), "cpu")
    rng = np.random.default_rng(31)
    head = ([1] + rng.integers(4, VOCAB - 2, size=(4,)).tolist()
            + [tcfg.image_token_id] * 64 + rng.integers(4, VOCAB - 2, size=(1,)).tolist())
    pix = _image(tcfg, rng)
    specs = [_spec(tcfg, rng, i, tl, 6, head=head, pix=pix) for i, tl in enumerate((6, 9, 4))]
    bucket, max_len = 80, 240

    def run(prefix_cache):
        eng = TEngine(tp, tcfg, TGEN, num_slots=3, max_len=max_len, prompt_buckets=(bucket,),
                      prefill_chunk=1, quantum=3, compute_dtype=torch.float32,
                      prefix_cache=prefix_cache, prefix_min=4, suffix_buckets=(16, 144))
        for s in specs:
            eng.submit(TRequest(**s))
        return eng.run(), eng

    res, eng = run(True)
    want, _ = run(False)
    assert res == want
    for s in specs:
        assert res[s["req_id"]] == _offline(tcfg, tp, s, bucket, max_len), s["req_id"]
    # reused, from the run's start: the whole run rides in the suffix
    assert eng.counters["prefix_hits"] == 2 and eng.counters["prefix_tokens_saved"] == 2 * 5
    assert eng.counters["suffix_wide_windows"] == 2
    assert eng._split(np.asarray(head + [7] * 9, np.int32), TRequest(**specs[0])) == (5, 144)


def test_engine_text_only_requests_do_not_serialize_admission(bases):
    """All text-only requests share the (None, adapter) registry key; the
    same-key deferral must not push unrelated prompts out of a full-prefill
    group."""
    jcfg, tcfg, _, tp = bases["f32"]
    rng = np.random.default_rng(22)
    specs = [_spec(tcfg, rng, i, 3, 4, head=rng.integers(4, VOCAB - 2, size=(40,)).tolist(),
                   pix=None) for i in range(4)]
    bucket = 48
    res, teng, _ = _run_both(bases["f32"], specs, num_slots=4, max_len=bucket + 8,
                             prompt_buckets=(bucket,), prefill_chunk=4, quantum=2,
                             prefix_cache=True, prefix_min=32)
    assert teng.counters["prefill_rows"] == 4 and teng.counters["prefix_hits"] == 0


def test_engine_defers_only_when_the_rest_fits_a_suffix_bucket(bases):
    """Two same-key requests sharing a long head whose rests fit no suffix
    bucket: deferring the second out of the first's prefill group would buy
    no prefix hit, so the port keeps them in one group."""
    jcfg, tcfg, _, tp = bases["f32"]
    rng = np.random.default_rng(23)
    head = rng.integers(4, VOCAB - 2, size=(34,)).tolist()
    specs = [_spec(tcfg, rng, i, 12, 4, head=head, pix=None) for i in range(2)]
    eng = TEngine(tp, tcfg, TGEN, num_slots=2, max_len=56, prompt_buckets=(48,), prefill_chunk=2,
                  quantum=2, compute_dtype=torch.float32, prefix_cache=True, prefix_min=32,
                  suffix_buckets=(8,))
    for s in specs:
        eng.submit(TRequest(**s))
    res = eng.run()
    assert eng.counters["prefill_rows"] == 2 and eng.counters["prefix_misses"] == 2
    for s in specs:
        assert res[s["req_id"]] == _offline(tcfg, tp, s, 48, 56)


# ---------------------------------------------------------------------------
# wire format, entry point, smoke configuration
# ---------------------------------------------------------------------------

def test_request_from_row(tmp_path):
    cfg = t_tiny(VOCAB)
    n_img, side = cfg.num_image_tokens, cfg.vision.image_size
    pix = np.random.default_rng(0).normal(size=(3, side, side)).astype(np.float32)
    np.save(tmp_path / "img.npy", pix)
    r = request_from_row({"id": 3, "input_ids": [1, cfg.image_token_id, 9, 8],
                          "image": str(tmp_path / "img.npy"), "max_new_tokens": 5}, cfg, None)
    assert r.req_id == 3 and r.max_new_tokens == 5 and r.input_ids.dtype == np.int32
    assert r.input_ids.tolist() == [1] + [cfg.image_token_id] * n_img + [9, 8]
    np.testing.assert_array_equal(r.pixel_values, pix)
    np.testing.assert_array_equal(load_pixels(str(tmp_path / "img.npy"), side), pix)
    r2 = request_from_row({"id": 4, "input_ids": r.input_ids.tolist(), "image": pix.tolist()},
                          cfg, None)
    assert r2.max_new_tokens == 32 and r2.input_ids.tolist() == r.input_ids.tolist()
    assert request_from_row({"id": 5, "input_ids": [1, 2, 3]}, cfg, None).pixel_values is None
    with pytest.raises(FileNotFoundError, match="cat.jpg"):
        request_from_row({"id": 6, "input_ids": [1, 5], "image": "cat.jpg"}, cfg, None)
    with pytest.raises(ValueError, match="no tokenizer"):
        request_from_row({"id": 7, "prompt": "hi"}, cfg, None)
    with pytest.raises(ValueError, match="holds 0 image tokens"):
        request_from_row({"id": 8, "input_ids": [1, 5], "image": pix.tolist()}, cfg, None)
    with pytest.raises(ValueError, match="image shape"):
        request_from_row({"id": 9, "input_ids": [1, 5], "image": pix[:, :4].tolist()}, cfg, None)
    with pytest.raises(ValueError, match="needs 'input_ids' or 'prompt'"):
        request_from_row({"id": 10}, cfg, None)
    tok = t_entry.ByteTokenizer()
    r3 = request_from_row({"id": 11, "prompt": "a<image>b", "image": pix.tolist()},
                          dataclasses.replace(cfg, image_token_id=3), tok)
    assert r3.input_ids.tolist() == [1, ord("a") + 4] + [3] * n_img + [ord("b") + 4]
    assert tok.decode(tok.encode("héllo</s>")) == "héllo"


@pytest.mark.parametrize("bits", [0, 4])
def test_entry_serve_smoke_mode_on_cpu(tmp_path, capsys, bits):
    """``serve`` with a literal config dict: no LOAD_PATH builds the tiny
    random model, no REQUESTS synthesizes four; the JSONL mode reads and
    writes files."""
    out = tmp_path / "results.jsonl"
    cfg = {"NAME": "serve", "MODEL": {"LLM": {"LOAD_PATH": None, "BITS": bits}},
           "SERVE": {"REQUESTS": None, "RESULTS": str(out), "SLOTS": 4, "QUANTUM": 4,
                     "PREFILL_CHUNK": 4, "KV_QUANT": "int8", "SPEC_K": 4, "EOS_TOKEN_ID": 2,
                     "DTYPE": "float32"}}
    summary = t_entry.serve(cfg, device="cpu")
    assert summary["requests"] == 4 and summary["results"] == str(out)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["id"] for r in rows] == [0, 1, 2, 3]
    for r in rows:
        assert len(r["tokens"]) == 4 + 2 * r["id"] or r["tokens"][-1] == 2
    assert summary["tokens"] == sum(len(r["tokens"]) for r in rows)
    if bits:
        return
    # the JSONL mode on the same model: the same streams from a request file
    mcfg = t_entry.smoke_llava_config()
    rng = np.random.default_rng(0)
    reqs = tmp_path / "requests.jsonl"
    with open(reqs, "w") as f:
        for i in range(4):
            ids = rng.integers(3, mcfg.text.vocab_size - 2,
                               size=(1 + mcfg.num_image_tokens + 4 + i,)).astype(np.int32)
            ids[1:1 + mcfg.num_image_tokens] = mcfg.image_token_id
            pix = rng.normal(size=(3, 28, 28)).astype(np.float32)
            f.write(json.dumps({"id": i, "input_ids": ids.tolist(), "image": pix.tolist(),
                                "max_new_tokens": 4 + 2 * i}) + "\n")
    cfg["SERVE"]["REQUESTS"] = str(reqs)
    t_entry.serve(cfg, device="cpu")
    assert [json.loads(line) for line in out.read_text().splitlines()] == rows
    with pytest.raises(FileNotFoundError, match="config.json"):
        t_entry.serve({"MODEL": {"LLM": {"LOAD_PATH": "/some/snapshot"}}}, device="cpu")
    # SERVE.PORT builds its engine, adapters included, before it binds
    # (the HTTP mode itself: tests/test_torch_serving_http.py)
    with pytest.raises(FileNotFoundError, match="adapter_model.safetensors"):
        t_entry.serve({"SERVE": {"PORT": 0, "ADAPTERS": [str(tmp_path / "none")]}},
                      device="cpu")


def test_entry_serve_needs_a_gpu_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_entry.serve({})


def test_chip_smoke_serving_config_is_serve_yaml():
    """``chip_smoke.py`` drives the engine from a literal dict (the GPU
    machine has no yaml): it must stay configs/serve.yaml's SERVE block,
    apart from the prompt bucket of its own traffic, beside BITS: 4."""
    yaml = pytest.importorskip("yaml")
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with open(os.path.join(REPO, "configs", "serve.yaml")) as f:
        conf = yaml.safe_load(f)
    assert conf["SERVE"]["PROMPT_BUCKETS"] is None and smoke.SERVE_CFG["PROMPT_BUCKETS"] == [648]
    assert {**smoke.SERVE_CFG, "PROMPT_BUCKETS": None} == conf["SERVE"]
    assert smoke.SERVE_MODEL_CFG == {"LLM": {**conf["MODEL"]["LLM"], "BITS": 4}}
    assert smoke.SERVE_DECODE_M == conf["SERVE"]["SLOTS"] * conf["SERVE"]["SPEC_K"] == 64
