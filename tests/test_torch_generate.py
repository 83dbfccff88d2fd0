"""The torch port's sampled decoding and fused ``generate`` against the JAX
package, at the tiny config (the JAX initializer's weights through the
bridge; f32).

The port draws its noise from a ``torch.Generator``, JAX from its PRNG, so
the draws are held by replaying JAX's noise: the port looks its Gumbel
noise up in ``modeling.gumbel_noise`` at every draw, and the tests put
there a function that follows JAX's key chain (``rng, sub =
jax.random.split(rng)`` per token, ``jax.random.gumbel(sub, [B, V])``, as
``jax.random.categorical`` draws it).  The filtered logits are compared
directly: kept sets exact, except where a token's preceding mass lies
within 1e-6 of ``top_p`` (the port sums that mass in f64, JAX in f32); the
tests count such tokens and say how many there were.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cullavo_tpu.models.llava import modeling as jm
from cullavo_tpu.models.llava.config import tiny_llava_config as j_tiny
from cullavo_tpu_torch.checkpoint.from_jax import llava_params_from_numpy
from cullavo_tpu_torch.models.llava import modeling as tm
from cullavo_tpu_torch.models.llava.config import tiny_llava_config as t_tiny
from cullavo_tpu_torch.models.llava.llama import NEG_INF


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


VOCAB = 128
BATCH, PROMPT, NEW = 3, 14, 7
SAMPLED = dict(do_sample=True, temperature=0.9, top_k=50, top_p=0.95)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = j_tiny(VOCAB), t_tiny(VOCAB)
    jp = jm.init_llava_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, llava_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _inputs(cfg, seed):
    """Right-padded prompts (one row 4 tokens short) with the image run at
    positions 1..N."""
    rng = np.random.default_rng(seed)
    n_img = cfg.num_image_tokens
    ids = rng.integers(4, cfg.text.vocab_size - 2, size=(BATCH, PROMPT)).astype(np.int32)
    ids[:, 1:1 + n_img] = cfg.image_token_id
    mask = np.ones((BATCH, PROMPT), np.int32)
    mask[1, PROMPT - 4:] = 0
    S = cfg.vision.image_size
    return ids, mask, rng.normal(size=(BATCH, 3, S, S)).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


class JaxNoise:
    """A stand-in for ``modeling.gumbel_noise`` that replays JAX's noise:
    per generator (by its seed), the key chain of ``PRNGKey(seed)``."""

    def __init__(self):
        self.keys, self.calls = {}, 0

    def __call__(self, shape, generator, device):
        seed = generator.initial_seed()
        rng = self.keys.get(seed, jax.random.PRNGKey(seed))
        rng, sub = jax.random.split(rng)
        self.keys[seed] = rng
        self.calls += 1
        return torch.from_numpy(np.array(jax.random.gumbel(sub, tuple(shape), jnp.float32)))


def _jax_filtered(logits, gen, monkeypatch):
    """JAX's filtered logits: what ``_sample_token`` hands
    ``jax.random.categorical`` (caught on its way there)."""
    seen = []

    def catch(key, filtered, axis=-1):
        seen.append(np.asarray(filtered))
        return jnp.argmax(filtered, axis=axis)

    with monkeypatch.context() as m:
        m.setattr(jax.random, "categorical", catch)
        jm._sample_token(jnp.asarray(logits), gen, jax.random.PRNGKey(0))
    return seen[0]


def _logits_with_ties(seed, B=6, V=VOCAB):
    """Logits on a coarse grid (many exact ties, at the k-th value too)."""
    rng = np.random.default_rng(seed)
    return (np.round(rng.normal(size=(B, V)) * 4) / 2).astype(np.float32)


def _logits_smooth(seed, B=6, V=VOCAB):
    return (np.random.default_rng(seed).normal(size=(B, V)) * 3).astype(np.float32)


@pytest.mark.parametrize("top_k,top_p", [(50, 1.0), (50, 0.95), (0, 0.95), (7, 0.5), (0, 1.0),
                                         (1, 0.95)])
@pytest.mark.parametrize("make", [_logits_with_ties, _logits_smooth], ids=["ties", "smooth"])
def test_filtered_logits_match_jax(monkeypatch, make, top_k, top_p):
    """Kept sets equal token for token, kept values bit-equal, the rest at
    NEG_INF; a disagreement is allowed only on a token whose preceding mass
    lies within 1e-6 of top_p (none in these cases)."""
    logits = make(top_k * 31 + int(top_p * 100))
    jgen = jm.GenerationConfig(do_sample=True, temperature=0.9, top_k=top_k, top_p=top_p)
    tgen = tm.GenerationConfig(do_sample=True, temperature=0.9, top_k=top_k, top_p=top_p)
    ref = _jax_filtered(logits, jgen, monkeypatch)
    got = tm._filter_logits(torch.from_numpy(logits), tgen).numpy()
    keep_ref, keep_got = ref > NEG_INF / 2, got > NEG_INF / 2
    # the port's own view of each token's preceding mass, in f64
    scaled = np.float32(logits) / np.float32(0.9)
    order = np.argsort(-scaled, axis=-1, kind="stable")
    srt = np.take_along_axis(scaled, order, -1).astype(np.float64)
    p = np.exp(srt - srt.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    before = np.empty_like(p)
    np.put_along_axis(before, order, np.cumsum(p, -1) - p, -1)
    near = np.abs(before - np.float32(top_p)) < 1e-6 if top_p < 1.0 else np.zeros_like(keep_ref)
    differ = keep_ref != keep_got
    assert not (differ & ~near).any(), np.argwhere(differ & ~near)
    assert differ.sum() == 0 and near.sum() == 0, (differ.sum(), near.sum())
    np.testing.assert_array_equal(got[keep_got], ref[keep_ref])
    assert (got[~keep_got] == np.float32(NEG_INF)).all()
    if top_k:
        kth = np.sort(scaled, -1)[:, -top_k][:, None]
        assert (keep_got <= (scaled >= kth)).all()       # ties at the k-th value all stay
        if make is _logits_with_ties and top_p == 1.0:
            assert (keep_got.sum(-1) > top_k).any()      # ... and these logits have such ties


def test_draw_with_jax_noise_equals_jax_categorical():
    """``argmax(filtered + gumbel)`` with JAX's noise for the key is
    ``jax.random.categorical(key, filtered)``, row for row."""
    logits = torch.from_numpy(_logits_smooth(5, B=8))
    gen = tm.GenerationConfig(**SAMPLED)
    filtered = tm._filter_logits(logits, gen)
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.categorical(key, jnp.asarray(filtered.numpy()), axis=-1))
        noise = torch.from_numpy(np.array(jax.random.gumbel(key, (8, VOCAB), jnp.float32)))
        got = torch.argmax(filtered + noise, dim=-1).numpy()
        np.testing.assert_array_equal(got, want)


def test_sample_token_replays_jax_through_gumbel_noise(monkeypatch):
    """``_sample_token`` takes its noise from ``gumbel_noise`` at every
    draw: with JAX's noise it is JAX's ``_sample_token`` token for token."""
    noise = JaxNoise()
    monkeypatch.setattr(tm, "gumbel_noise", noise)
    logits = _logits_smooth(9, B=5)
    g = torch.Generator().manual_seed(11)
    rng = jax.random.PRNGKey(11)
    for _ in range(4):
        rng, sub = jax.random.split(rng)
        want = np.asarray(jm._sample_token(jnp.asarray(logits), jm.GenerationConfig(**SAMPLED),
                                           sub))
        got = tm._sample_token(torch.from_numpy(logits), tm.GenerationConfig(**SAMPLED), g)
        np.testing.assert_array_equal(got.numpy(), want)
    assert noise.calls == 4


def test_gumbel_noise_is_standard_gumbel_from_the_generator():
    a = tm.gumbel_noise((4000, 64), torch.Generator().manual_seed(3), "cpu")
    b = tm.gumbel_noise((4000, 64), torch.Generator().manual_seed(3), "cpu")
    assert a.dtype == torch.float32 and torch.equal(a, b) and torch.isfinite(a).all()
    # mean = Euler's gamma, variance = pi^2 / 6
    assert abs(a.mean().item() - 0.5772) < 0.01 and abs(a.var().item() - 1.6449) < 0.03


def test_sampling_without_a_generator_raises():
    with pytest.raises(NotImplementedError, match="sampled decoding needs an explicit"):
        tm._sample_token(torch.zeros(2, 4), tm.GenerationConfig(do_sample=True))


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_fused_generate_matches_jax(monkeypatch, models, sampled):
    """The fused ``generate`` at f32, token for token against JAX's, over
    right-padded rows, greedy and sampled (JAX's key chain replayed)."""
    jcfg, tcfg, jp, tp = models
    ids, mask, pix = _inputs(jcfg, seed=1)
    kw = SAMPLED if sampled else {}
    jgen = jm.GenerationConfig(max_new_tokens=NEW, eos_token_id=-1, **kw)
    tgen = tm.GenerationConfig(max_new_tokens=NEW, eos_token_id=-1, **kw)
    max_len = PROMPT + NEW
    want = np.asarray(jm.generate(jp, jcfg, *map(jnp.asarray, (ids, pix, mask)), jgen, max_len,
                                  rng=jax.random.PRNGKey(7)))
    noise = JaxNoise()
    monkeypatch.setattr(tm, "gumbel_noise", noise)
    got = tm.generate(tp, tcfg, *_t(ids, pix, mask), tgen, max_len,
                      rng=torch.Generator().manual_seed(7))
    assert got.dtype == torch.int32 and got.shape == (BATCH, NEW)
    np.testing.assert_array_equal(got.numpy(), want)
    assert noise.calls == (NEW if sampled else 0)
    if sampled:   # the draws are not the greedy stream
        greedy = tm.generate(tp, tcfg, *_t(ids, pix, mask),
                             dataclasses.replace(tgen, do_sample=False), max_len)
        assert not torch.equal(greedy, got)


def test_sampled_generate_is_reproducible_from_one_seed(models):
    _, tcfg, _, tp = models
    ids, mask, pix = _t(*_inputs(tcfg, seed=2))
    gen = tm.GenerationConfig(max_new_tokens=NEW, eos_token_id=-1, **SAMPLED)
    runs = [tm.generate(tp, tcfg, ids, pix, mask, gen, PROMPT + NEW,
                        rng=torch.Generator().manual_seed(s)) for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


def test_greedy_fused_equals_two_phase(models):
    _, tcfg, _, tp = models
    ids, mask, pix = _t(*_inputs(tcfg, seed=3))
    gen = tm.GenerationConfig(max_new_tokens=NEW, eos_token_id=-1)
    fused = tm.generate(tp, tcfg, ids, pix, mask, gen, PROMPT + NEW)
    state = tm.generate_prefill(tp, tcfg, ids, pix, mask, PROMPT + NEW,
                                compute_dtype=torch.float32)
    two = tm.generate_decode(tp, tcfg, state, gen, compute_dtype=torch.float32)
    assert torch.equal(fused, two)


def test_early_stop_runs_fewer_forwards_with_the_same_output(monkeypatch, models):
    """With an eos that every row emits before the end, the fused loop stops
    once all rows are done: fewer forwards, and the tokens of the two-phase
    decode, which runs every step."""
    _, tcfg, _, tp = models
    ids, mask, pix = _t(*_inputs(tcfg, seed=21))   # its rows share a token by step 5
    new = 12
    free = tm.generate(tp, tcfg, ids, pix, mask,
                       tm.GenerationConfig(max_new_tokens=new, eos_token_id=-1), PROMPT + new)
    rows = [r.tolist() for r in free]
    first = {t: max(r.index(t) if t in r else new for r in rows)
             for t in set(sum(rows, []))}
    eos, last = min(first.items(), key=lambda kv: (kv[1], kv[0]))
    assert last < new - 2, (rows, first)          # every row emits eos, early enough
    gen = tm.GenerationConfig(max_new_tokens=new, eos_token_id=eos)
    calls = []
    forward = tm.llava_forward

    def counting(*a, **kw):
        calls.append(1)
        return forward(*a, **kw)

    monkeypatch.setattr(tm, "llava_forward", counting)
    fused = tm.generate(tp, tcfg, ids, pix, mask, gen, PROMPT + new)
    n_fused = len(calls)
    state = tm.generate_prefill(tp, tcfg, ids, pix, mask, PROMPT + new,
                                compute_dtype=torch.float32)
    two = tm.generate_decode(tp, tcfg, state, gen, compute_dtype=torch.float32)
    assert torch.equal(fused, two)
    assert n_fused == 1 + last < len(calls) - n_fused == new
    for r, row in zip(fused.tolist(), rows):
        k = row.index(eos)
        assert r[:k + 1] == row[:k + 1] and set(r[k:]) == {eos}


def test_f32_compute_casts_bf16_leaves(models):
    """``from_bf16=True`` (the fused generate) casts bf16 leaves, the
    default mode leaves them; quantization scales stay as they are in both."""
    tree = {"w": torch.ones(2, dtype=torch.bfloat16), "h": torch.ones(2, dtype=torch.float16),
            "n": {"scale": torch.ones(2), "absmax": torch.ones(2, dtype=torch.bfloat16),
                  "q": torch.ones(2, dtype=torch.int8)}}
    up = tm._cast_params(tree, torch.float32, from_bf16=True)
    kept = tm._cast_params(tree, torch.float32)
    assert up["w"].dtype == up["h"].dtype == torch.float32 and kept["w"].dtype == torch.bfloat16
    assert kept["h"].dtype == torch.float32
    for t in (up, kept):
        assert t["n"]["scale"] is tree["n"]["scale"] and t["n"]["absmax"] is tree["n"]["absmax"]
        assert t["n"]["q"] is tree["n"]["q"]
    _, tcfg, _, tp = models
    half = tm._cast_params(tp, torch.bfloat16, from_bf16=True)
    assert half["language_model"]["embed_tokens"].dtype == torch.bfloat16
    ids, mask, pix = _t(*_inputs(tcfg, seed=5))
    gen = tm.GenerationConfig(max_new_tokens=4, eos_token_id=-1)
    want = tm.generate(tm._cast_params(half, torch.float32, from_bf16=True), tcfg, ids, pix,
                       mask, gen, PROMPT + 4)
    got = tm.generate(half, tcfg, ids, pix, mask, gen, PROMPT + 4)
    assert torch.equal(got, want)
