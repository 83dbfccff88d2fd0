"""The torch port's runtime LoRA serving and sampled serving against the JAX
package, on the CPU at the tiny config in f32.

Weights come from the port's initializer and cross the bridge to JAX;
adapter sets are the port's ``init_lora_params`` with a random ``b`` (PEFT's
zero ``b`` would make every adapter a no-op).  Covered: the adapter
directory (``save_adapters`` / ``load_adapters``) across the packages, bf16
included; ``stack_adapter_sets``; the multi-stacked forward; the engine with
one set and with a stack picked per request; ``_load_serving_adapters`` and
the two JAX faults it does not copy (vision adapters dropped from a stack,
one scaling for sets trained with others); sampled decoding in the engine,
``decode_quantum`` and ``generate_decode``.  Sampled draws are held by
replaying JAX's key chain through ``modeling.gumbel_noise``.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cullavo_tpu import entry as j_entry
from cullavo_tpu.checkpoint import store as j_store
from cullavo_tpu.models.llava import lora as j_lora
from cullavo_tpu.models.llava import modeling as jm
from cullavo_tpu.models.llava.config import tiny_llava_config as j_tiny
from cullavo_tpu.serving import Request as JRequest
from cullavo_tpu.serving import ServingEngine as JEngine
from cullavo_tpu_torch import entry as t_entry
from cullavo_tpu_torch.checkpoint import store as t_store
from cullavo_tpu_torch.checkpoint.from_jax import llava_params_to_numpy, lora_to_numpy
from cullavo_tpu_torch.models.llava import lora as t_lora
from cullavo_tpu_torch.models.llava import modeling as tm
from cullavo_tpu_torch.models.llava.config import tiny_llava_config as t_tiny
from cullavo_tpu_torch.serving import Request as TRequest
from cullavo_tpu_torch.serving import ServingEngine as TEngine
from cullavo_tpu_torch.serving import engine as t_engine_mod
from cullavo_tpu_torch.utils.tree import tree_map

VOCAB, SCALING = 128, 0.25
LORA = dict(r=4, alpha=1.0)                     # scaling 0.25
SAMPLED = dict(do_sample=True, temperature=0.9, top_k=50, top_p=0.95)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _adapter_set(tp, cfg, k, vision=False):
    """One adapter set: A as initialized, B random (scaled to move the
    logits without swamping them); with ``vision`` also vision adapters on
    the tower's first layer."""
    lcfg = t_lora.LoraConfig(**LORA, vision_layer_start=0 if vision else 12,
                             vision_layer_stop=1 if vision else 23)
    full = t_lora.init_lora_params(tp, cfg, lcfg, torch.Generator().manual_seed(10 + k))
    g = torch.Generator().manual_seed(100 + k)
    for tower in full.values():
        for ab in tower.values():
            ab["b"] = torch.randn(ab["b"].shape, generator=g) * 0.05
    return full


@pytest.fixture(scope="module")
def model():
    """(JAX config, port config, JAX params, port params, port sets, JAX
    sets): three LLM adapter sets."""
    jcfg, tcfg = j_tiny(VOCAB), t_tiny(VOCAB)
    tp = tm.init_llava_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jp = _jax(llava_params_to_numpy(tp))
    tsets = [_adapter_set(tp, tcfg, k)["language_model"] for k in range(3)]
    jsets = [_jax(lora_to_numpy(s)) for s in tsets]
    return jcfg, tcfg, jp, tp, tsets, jsets


def _inputs(cfg, rng, B, text_len):
    n_img = cfg.num_image_tokens
    T = 1 + n_img + text_len
    ids = rng.integers(3, VOCAB - 2, size=(B, T)).astype(np.int32)
    ids[:, 1:1 + n_img] = cfg.image_token_id
    pix = rng.normal(size=(B, 3, cfg.vision.image_size, cfg.vision.image_size)).astype(np.float32)
    return ids, pix, np.ones((B, T), np.int32)


def _requests(cfg, seed, n_images=2, per_image=3, adapters=2):
    """Requests as plain data: ``per_image`` questions sharing a system +
    image head per image (prefix reuse, keyed by image AND adapter), adapter
    ids cycling through ``adapters``."""
    rng = np.random.default_rng(seed)
    n_img = cfg.num_image_tokens
    head = rng.integers(4, VOCAB - 2, size=(6,)).tolist() + [cfg.image_token_id] * n_img
    side = cfg.vision.image_size
    specs = []
    for _ in range(n_images):
        pix = rng.normal(size=(3, side, side)).astype(np.float32)
        for _ in range(per_image):
            i = len(specs)
            own = rng.integers(4, VOCAB - 2, size=(int(rng.integers(2, 7)),)).tolist()
            specs.append(dict(req_id=i, input_ids=np.asarray(head + own, np.int32),
                              pixel_values=pix, max_new_tokens=4 + i % 3,
                              adapter_id=i % adapters))
    return specs, len(head)


def _engines(model, specs, bucket, gen_kw=None, lora_t=None, lora_j=None, **kw):
    """The same requests through the JAX and the port engine; returns both
    results and the port engine."""
    jcfg, tcfg, jp, tp, _, _ = model
    gen_kw = gen_kw or {}
    common = dict(num_slots=3, max_len=bucket + 12, prompt_buckets=(bucket,), prefill_chunk=2,
                  quantum=3, prefix_cache=True, prefix_min=8, suffix_buckets=(8, 16), **kw)
    jeng = JEngine(jp, jcfg, jm.GenerationConfig(eos_token_id=-1, **gen_kw),
                   compute_dtype=jnp.float32, lora=lora_j, lora_scaling=SCALING, **common)
    teng = TEngine(tp, tcfg, tm.GenerationConfig(eos_token_id=-1, **gen_kw),
                   compute_dtype=torch.float32, lora=lora_t, lora_scaling=SCALING, **common)
    for s in specs:
        jeng.submit(JRequest(**s))
        teng.submit(TRequest(**s))
    return jeng.run(), teng.run(), teng, jeng


def test_adapter_directories_cross_the_packages(model, tmp_path):
    """save_adapters / load_adapters: a port directory reads bit-equal in
    JAX and a JAX directory in the port (keys, dtypes, adapter_config.json);
    a bf16 directory reads back bf16 in the port (its own reader; the card's
    machine has no safetensors) with JAX's values; the template restores
    structure and device."""
    _, tcfg, _, tp, tsets, jsets = model
    tree = {"language_model": tsets[0], "vision_tower": {}}
    cfg = {"r": 4, "alpha": 1.0, "targets": ["q", "k"]}
    t_store.save_adapters(str(tmp_path / "port"), tree, cfg)
    j_tree, j_cfg = j_store.load_adapters(str(tmp_path / "port"))
    assert j_cfg == cfg and sorted(j_tree) == ["language_model"]
    for t, ab in tsets[0].items():
        for k, a in ab.items():
            np.testing.assert_array_equal(j_tree["language_model"][t][k], a.numpy())
    j_store.save_adapters(str(tmp_path / "jax"), {"language_model": jsets[1]}, cfg)
    back, t_cfg = t_store.load_adapters(str(tmp_path / "jax"))
    assert t_cfg == cfg
    for t, ab in tsets[1].items():
        for k, a in ab.items():
            got = back["language_model"][t][k]
            assert got.dtype == torch.float32 and torch.equal(got, a)
    half = tree_map(lambda a: a.to(torch.bfloat16), {"language_model": tsets[2]})
    t_store.save_adapters(str(tmp_path / "bf16"), half, cfg)
    got, _ = t_store.load_adapters(str(tmp_path / "bf16"), template=half)
    for t, ab in half["language_model"].items():
        for k, a in ab.items():
            g = got["language_model"][t][k]
            assert g.dtype == torch.bfloat16 and torch.equal(g, a)
    # JAX reads through safetensors' numpy reader (no bf16 before ml_dtypes
    # support); where it reads the file, the values are the port's
    j_half, _ = j_store.load_adapters(str(tmp_path / "bf16"))
    for t, ab in half["language_model"].items():
        for k, a in ab.items():
            np.testing.assert_array_equal(np.asarray(j_half["language_model"][t][k], np.float32),
                                          a.float().numpy())
    with pytest.raises(KeyError, match="missing"):
        t_store.load_adapters(str(tmp_path / "bf16"), template={"vision_tower": {"x": tp[
            "projector"]["linear_1"]["bias"]}})
    assert sorted(os.listdir(tmp_path / "port")) == ["adapter_config.json",
                                                     "adapter_model.safetensors"]
    assert json.loads((tmp_path / "port" / "adapter_config.json").read_text()) == cfg


def test_stack_adapter_sets_matches_jax_and_refuses(model):
    _, _, _, _, tsets, jsets = model
    stacked = t_lora.stack_adapter_sets(tsets)
    want = j_lora.stack_adapter_sets(jsets)
    for t, ab in stacked.items():
        for k, a in ab.items():
            assert a.shape[1] == 3
            np.testing.assert_array_equal(a.numpy(), np.asarray(want[t][k]))
    with pytest.raises(ValueError, match="at least one"):
        t_lora.stack_adapter_sets([])
    missing = {t: ab for t, ab in tsets[1].items() if t != "q"}
    with pytest.raises(ValueError, match="structure"):
        t_lora.stack_adapter_sets([tsets[0], missing])
    with pytest.raises(ValueError, match="structure"):
        j_lora.stack_adapter_sets([jsets[0], {t: ab for t, ab in jsets[1].items() if t != "q"}])
    narrow = {t: {k: a[..., :2] if k == "a" else a for k, a in ab.items()}
              for t, ab in tsets[1].items()}
    with pytest.raises(ValueError, match="shapes differ"):
        t_lora.stack_adapter_sets([tsets[0], narrow])
    mixed = t_lora.stack_adapter_sets([tsets[0], tree_map(lambda a: a.to(torch.bfloat16),
                                                          tsets[1])])
    assert mixed["q"]["a"].dtype == torch.float32


def test_multi_stack_forward_matches_jax_and_single_sets(model):
    """The stacked forward with mixed adapter_ids within 1e-4 of JAX's in
    f32; each row equals the single-set forward with its set; ids are
    required; a stack with per-layer masks raises, as in JAX."""
    jcfg, tcfg, jp, tp, tsets, jsets = model
    ids, pix, mask = _inputs(tcfg, np.random.default_rng(0), 3, 5)
    t_in = [torch.from_numpy(a) for a in (ids, pix, mask)]
    j_in = [jnp.asarray(a) for a in (ids, pix, mask)]
    stack_t = {"language_model": t_lora.stack_adapter_sets(tsets)}
    stack_j = {"language_model": j_lora.stack_adapter_sets(jsets)}
    aids = np.asarray([2, 0, 1], np.int32)
    got, _ = tm.llava_forward(tp, tcfg, *t_in, lora=stack_t, lora_scaling=SCALING,
                              adapter_ids=torch.from_numpy(aids))
    want, _ = jm.llava_forward(jp, jcfg, *j_in, lora=stack_j, lora_scaling=SCALING,
                               adapter_ids=jnp.asarray(aids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    singles = [tm.llava_forward(tp, tcfg, *t_in, lora={"language_model": s},
                                lora_scaling=SCALING)[0] for s in tsets]
    assert (singles[0] - singles[1]).abs().max() > 1e-2          # the sets act
    for row, k in enumerate(aids):
        torch.testing.assert_close(got[row], singles[k][row], rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="adapter_ids"):
        tm.llava_forward(tp, tcfg, *t_in, lora=stack_t, lora_scaling=SCALING)
    masked = {t: {**ab, "mask": torch.ones(ab["a"].shape[0], 1, 1)} for t, ab in
              stack_t["language_model"].items()}
    with pytest.raises(NotImplementedError, match="per-layer masks"):
        tm.llava_forward(tp, tcfg, *t_in, lora={"language_model": masked},
                         lora_scaling=SCALING, adapter_ids=torch.from_numpy(aids))


def test_engine_with_a_stack_matches_jax_and_single_set_engines(model):
    """Two sets served per request (adapter ids alternating, prefix reuse
    keyed by image and adapter): token-exact against JAX's engine, and each
    request's stream equal to the port engine with its set alone; the
    prefix counters split by adapter; an id past the stack is refused."""
    _, tcfg, _, _, tsets, jsets = model
    specs, head = _requests(tcfg, seed=1)
    bucket = head + 8
    stack_t = {"language_model": t_lora.stack_adapter_sets(tsets[:2])}
    stack_j = {"language_model": j_lora.stack_adapter_sets(jsets[:2])}
    jres, tres, teng, jeng = _engines(model, specs, bucket, lora_t=stack_t, lora_j=stack_j)
    assert tres == jres and teng.counters == {**jeng.counters, "suffix_wide_windows": 0}
    # 2 images x 2 adapters: 4 keys, 4 full prefills, 2 suffix prefills
    assert teng.counters["prefix_misses"] == 4 and teng.counters["prefix_hits"] == 2
    for k in range(2):
        mine = [s for s in specs if s["adapter_id"] == k]
        _, alone, _, _ = _engines(model, [{**s, "adapter_id": 0} for s in mine], bucket,
                                  lora_t={"language_model": tsets[k]},
                                  lora_j={"language_model": jsets[k]})
        assert {s["req_id"]: tres[s["req_id"]] for s in mine} == alone
    base_t = TEngine(model[3], tcfg, tm.GenerationConfig(eos_token_id=-1), num_slots=3,
                     max_len=bucket + 12, prompt_buckets=(bucket,), compute_dtype=torch.float32)
    for s in specs:
        base_t.submit(TRequest(**{**s, "adapter_id": 0}))
    assert base_t.run() != tres                                  # the adapters act
    with pytest.raises(ValueError, match="adapter_id 2 out of range"):
        teng.submit(TRequest(**{**specs[0], "req_id": 99, "adapter_id": 2}))


def test_load_serving_adapters_matches_jax_and_refuses(model, tmp_path, capsys):
    """SERVE.ADAPTERS: one directory (its vision adapters kept) and two (a
    stack), equal to JAX's loader with the adapter_config scaling;
    LORA_SCALING overrides it.  Where JAX carries on, the port raises: a
    stack whose sets hold vision adapters (JAX drops them with a print) and
    sets whose scalings differ (JAX serves all at the last one's)."""
    jcfg, tcfg, jp, tp, tsets, _ = model
    with_vision = _adapter_set(tp, tcfg, 5, vision=True)
    assert with_vision["vision_tower"]
    dirs = []
    for k, (tree, cfg) in enumerate([({"language_model": tsets[0], "vision_tower": {}}, LORA),
                                     ({"language_model": tsets[1]}, LORA),
                                     (with_vision, LORA),
                                     ({"language_model": tsets[2]}, {"r": 4, "alpha": 2.0})]):
        dirs.append(t_store.save_adapters(str(tmp_path / f"a{k}"), tree, cfg))
    for scfg in ({"ADAPTERS": dirs[:1]}, {"ADAPTERS": dirs[:2]}, {"ADAPTERS": dirs[2:3]},
                 {"ADAPTERS": [dirs[0], dirs[3]], "LORA_SCALING": 0.3}):
        got, scale = t_entry._load_serving_adapters(scfg, tcfg, tp)
        want, j_scale = j_entry._load_serving_adapters(scfg, jcfg, jp)
        assert scale == pytest.approx(j_scale) and sorted(got) == sorted(want)
        flat_t = t_store._flatten(got)
        flat_j = {k: np.asarray(v) for k, v in j_store._flatten(want).items()}
        assert sorted(flat_t) == sorted(flat_j)
        for k, v in flat_t.items():
            np.testing.assert_array_equal(v.numpy(), flat_j[k])
    assert t_entry._load_serving_adapters({}, tcfg, tp) == (None, 0.0)
    # fault 2: JAX drops the vision adapters of a stack with a print
    want, _ = j_entry._load_serving_adapters({"ADAPTERS": dirs[1:3]}, jcfg, jp)
    assert "vision_tower" not in want and "ignoring" in capsys.readouterr().err
    with pytest.raises(ValueError, match="a2"):
        t_entry._load_serving_adapters({"ADAPTERS": dirs[1:3]}, tcfg, tp)
    # fault 3: JAX serves both sets at the last one's scaling
    _, j_scale = j_entry._load_serving_adapters({"ADAPTERS": [dirs[0], dirs[3]]}, jcfg, jp)
    assert j_scale == 0.5
    with pytest.raises(ValueError, match="LORA_SCALING"):
        t_entry._load_serving_adapters({"ADAPTERS": [dirs[0], dirs[3]]}, tcfg, tp)


class EngineNoise:
    """JAX's engine key chain, replayed through ``modeling.gumbel_noise``: an
    admission group's draw splits the engine key once; a quantum splits it
    once and each of its steps splits that key (``decode_quantum``)."""

    def __init__(self, seed):
        self.key, self.qkey, self.left, self.calls = jax.random.PRNGKey(seed), None, 0, 0

    def quantum(self, n):
        self.key, self.qkey = jax.random.split(self.key)
        self.left = n

    def __call__(self, shape, generator, device):
        if self.left:
            self.qkey, sub = jax.random.split(self.qkey)
            self.left -= 1
        else:
            self.key, sub = jax.random.split(self.key)
        self.calls += 1
        return torch.from_numpy(np.array(jax.random.gumbel(sub, tuple(shape), jnp.float32)))


def test_sampled_engine_matches_jax(model, monkeypatch, capsys):
    """DO_SAMPLE in the engine (the stack and prefix reuse on): token-exact
    against JAX's engine with JAX's key chain replayed; SPEC_K is switched
    off with a warning; the same seed gives the same tokens, another seed
    others, and the draws are not the greedy stream."""
    _, tcfg, _, _, tsets, jsets = model
    specs, head = _requests(tcfg, seed=2)
    bucket = head + 8
    stack_t = {"language_model": t_lora.stack_adapter_sets(tsets[:2])}
    stack_j = {"language_model": j_lora.stack_adapter_sets(jsets[:2])}
    noise = EngineNoise(seed=5)
    quantum = t_engine_mod.decode_quantum

    def replayed_quantum(*a, **kw):
        noise.quantum(a[4])
        return quantum(*a, **kw)

    monkeypatch.setattr(tm, "gumbel_noise", noise)
    monkeypatch.setattr(t_engine_mod, "decode_quantum", replayed_quantum)
    jres, tres, teng, _ = _engines(model, specs, bucket, gen_kw=SAMPLED, lora_t=stack_t,
                                   lora_j=stack_j, seed=5, spec_k=3)
    assert teng.spec_k is None and "disables speculative decoding" in capsys.readouterr().err
    assert tres == jres and noise.calls > len(specs)
    monkeypatch.undo()

    def port(seed, **gen_kw):
        eng = TEngine(model[3], tcfg, tm.GenerationConfig(eos_token_id=-1, **gen_kw),
                      num_slots=3, max_len=bucket + 12, prompt_buckets=(bucket,),
                      compute_dtype=torch.float32, lora=stack_t, lora_scaling=SCALING, seed=seed)
        for s in specs:
            eng.submit(TRequest(**s))
        return eng.run()

    a, b, c = port(5, **SAMPLED), port(5, **SAMPLED), port(6, **SAMPLED)
    assert a == b and a != c and a != port(5)


def test_decode_quantum_and_generate_decode_sampled_match_jax(model, monkeypatch):
    """``decode_quantum`` (over a pool with per-row adapters) and
    ``generate_decode`` (with a single set) sampled from a generator, token
    for token against JAX's with its key chains replayed; without a
    generator a sampled draw raises."""
    jcfg, tcfg, jp, tp, tsets, jsets = model
    ids, pix, mask = _inputs(tcfg, np.random.default_rng(3), 3, 5)
    mask[1, -2:] = 0
    T, new = ids.shape[1], 6
    aids = np.asarray([1, 0, 1], np.int32)
    stack_t = {"language_model": t_lora.stack_adapter_sets(tsets[:2])}
    stack_j = {"language_model": j_lora.stack_adapter_sets(jsets[:2])}
    jgen = jm.GenerationConfig(max_new_tokens=new, eos_token_id=-1, **SAMPLED)
    tgen = tm.GenerationConfig(max_new_tokens=new, eos_token_id=-1, **SAMPLED)
    noise = EngineNoise(seed=0)
    monkeypatch.setattr(tm, "gumbel_noise", noise)

    def states(lora_t, lora_j, a):
        js = jm.generate_prefill(jp, jcfg, jnp.asarray(ids), jnp.asarray(pix), jnp.asarray(mask),
                                 T + new, compute_dtype=jnp.float32, lora=lora_j,
                                 lora_scaling=SCALING, adapter_ids=jnp.asarray(a))
        ts = tm.generate_prefill(tp, tcfg, *(torch.from_numpy(x) for x in (ids, pix, mask)),
                                 T + new, compute_dtype=torch.float32, lora=lora_t,
                                 lora_scaling=SCALING, adapter_ids=torch.from_numpy(a))
        return js, ts

    # the pool: every row admitted with its first (greedy) token
    js, ts = states(stack_t, stack_j, aids)
    first = np.array(jnp.argmax(js["logits"], axis=-1), np.int32)
    B = len(aids)
    jpool = dict(js, write_idx=jnp.full((B,), T, jnp.int32), cur_tok=jnp.asarray(first),
                 done=jnp.zeros((B,), bool))
    tpool = dict(ts, write_idx=torch.full((B,), T, dtype=torch.int32),
                 cur_tok=torch.from_numpy(first), done=torch.zeros(B, dtype=torch.bool))
    want, _ = jm.decode_quantum(jp, jcfg, jpool, jgen, new - 1, rng=jax.random.PRNGKey(4),
                                compute_dtype=jnp.float32, lora=stack_j, lora_scaling=SCALING)
    noise.key, noise.qkey, noise.left = None, jax.random.PRNGKey(4), new - 1
    got, _ = tm.decode_quantum(tp, tcfg, tpool, tgen, new - 1, rng=torch.Generator(),
                               compute_dtype=torch.float32, lora=stack_t, lora_scaling=SCALING)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # generate_decode: JAX splits its key before the first draw and each step
    single_t, single_j = {"language_model": tsets[2]}, {"language_model": jsets[2]}
    js, ts = states(single_t, single_j, np.zeros(B, np.int32))
    want = jm.generate_decode(jp, jcfg, js, jgen, rng=jax.random.PRNGKey(9),
                              compute_dtype=jnp.float32, lora=single_j, lora_scaling=SCALING)
    noise.key, noise.left = jax.random.PRNGKey(9), 0
    got = tm.generate_decode(tp, tcfg, ts, tgen, rng=torch.Generator(),
                             compute_dtype=torch.float32, lora=single_t, lora_scaling=SCALING)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(NotImplementedError, match="explicit torch.Generator"):
        tm.generate_decode(tp, tcfg, states(single_t, single_j, np.zeros(B, np.int32))[1],
                           tgen, compute_dtype=torch.float32, lora=single_t,
                           lora_scaling=SCALING)
