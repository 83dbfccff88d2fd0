"""The port's Q-LoRA training path against the JAX package on the CPU, at
the tiny config: adapters, the forward with adapters and remat, the losses,
the optimizer against optax, the whole train step from one converted state
on a dense and on a planar-NF4 base, the data copies and the entry point.

Inputs and states are numpy arrays from a seed, handed to both packages.
Parity runs without dropout (JAX's dropout bits cannot be reproduced in
torch); the port's dropout is held by its own tests.  A vision adapter's
``mask`` is left out of the comparisons: the JAX train step differentiates
it as if it were a parameter, the port keeps it constant.
"""
import dataclasses
import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from cullavo_tpu.data import step1_synthesis as j_syn
from cullavo_tpu.data import text_format as j_text
from cullavo_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from cullavo_tpu.models.llava import lora as jl
from cullavo_tpu.models.llava import modeling as jm
from cullavo_tpu.models.llava.config import tiny_llava_config as j_tiny
from cullavo_tpu.trainer import optimizer as j_opt
from cullavo_tpu.trainer import step as j_step
from cullavo_tpu.utils import constants as j_constants
from cullavo_tpu_torch import entry as t_entry
from cullavo_tpu_torch.checkpoint import from_jax as bridge
from cullavo_tpu_torch.data import step1_synthesis as t_syn
from cullavo_tpu_torch.data import text_format as t_text
from cullavo_tpu_torch.data.tokenizer import ByteTokenizer as TByteTokenizer
from cullavo_tpu_torch.models.llava import llama as t_llama
from cullavo_tpu_torch.models.llava import lora as tl
from cullavo_tpu_torch.models.llava import modeling as tm
from cullavo_tpu_torch.models.llava.config import tiny_llava_config as t_tiny
from cullavo_tpu_torch.pipelines.base import build_pipeline, list_pipelines
from cullavo_tpu_torch.trainer import optimizer as t_opt
from cullavo_tpu_torch.trainer import step as t_step
from cullavo_tpu_torch.utils import constants as t_constants
from cullavo_tpu_torch.utils.tree import tree_leaves, tree_map


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


VOCAB, B, T, R = 128, 2, 24, 4
LORA = dict(r=R, alpha=8.0, dropout=0.0, vision_layer_start=0, vision_layer_stop=1)
LR = 2e-3


def _planar_cfg(tiny):
    """Four kv heads of 16: every LLM target of the tiny model is planar."""
    cfg = tiny(VOCAB)
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_key_value_heads=4))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _paths(tree, prefix=""):
    """(path, leaf) pairs of a nested dict in key order (JAX's tree functions
    sort dict keys), None leaves skipped."""
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        elif v is not None:
            yield prefix + k, v


@pytest.fixture(scope="module")
def models():
    """JAX params, a JAX adapter set with random non-zero ``b`` (so every
    gradient is non-zero at step 1), and a batch with one right-padded row
    and sample weights 1.0 and 0.5."""
    jcfg, tcfg = _planar_cfg(j_tiny), _planar_cfg(t_tiny)
    jp = jm.init_llava_params(jcfg, jax.random.PRNGKey(0))
    jlora = jl.init_lora_params(jp, jcfg, jl.LoraConfig(**LORA), jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    jlora = jax.tree_util.tree_map_with_path(
        lambda path, a: (jnp.asarray(rng.normal(size=a.shape).astype(np.float32) * 0.05)
                         if path[-1].key == "b" else a), jlora)
    n_img = jcfg.num_image_tokens
    ids = rng.integers(4, VOCAB - 2, size=(B, T)).astype(np.int32)
    ids[:, 1:1 + n_img] = jcfg.image_token_id
    mask = np.ones((B, T), np.int32)
    mask[1, T - 6:] = 0
    labels = np.where(mask != 0, ids, -100).astype(np.int32)
    labels[:, :1 + n_img + 3] = -100
    batch = {"input_ids": ids, "attention_mask": mask, "labels": labels,
             "pixel_values": rng.normal(size=(B, 3, 28, 28)).astype(np.float32),
             "weights": np.asarray([1.0, 0.5], np.float32)}
    return jcfg, tcfg, jp, jlora, batch


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# adapters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [0, 4, 8])
def test_init_lora_params_shapes_match_jax(models, bits):
    jcfg, tcfg, jp, _, _ = models
    tp = bridge.llava_params_from_numpy(_np(jp), "cpu")
    if bits:
        jp = jl.quantize_llm_weights(jp, bits=bits)
        tp = tl.quantize_llm_weights(tp, bits=bits)
    jlo = jl.init_lora_params(jp, jcfg, jl.LoraConfig(**LORA), jax.random.PRNGKey(3))
    tlo = tl.init_lora_params(tp, tcfg, tl.LoraConfig(**LORA), torch.Generator().manual_seed(3))
    jshapes = {p: (a.shape, str(a.dtype)) for p, a in _paths(_np(jlo))}
    tshapes = {p: (tuple(a.shape), str(a.dtype).split(".")[1]) for p, a in _paths(tlo)}
    assert tshapes == jshapes and len(tshapes) == 7 * 2 + 6 * 3
    for t, ab in tlo["language_model"].items():
        d_in = ab["a"].shape[1]
        assert not ab["b"].any()
        assert 0.5 * d_in ** -0.5 < ab["a"].std() < 1.5 * d_in ** -0.5
    for ab in tlo["vision_tower"].values():     # layer 0 targeted, layer 1 masked out
        assert ab["mask"].flatten().tolist() == [1.0, 0.0] and not ab["a"][1].any()
    assert tl.LoraConfig().scaling == jl.LoraConfig().scaling == 0.25
    assert tl.LLM_TARGETS == jl.LLM_TARGETS and tl.VISION_TARGETS == jl.VISION_TARGETS


def test_default_vision_range_gives_the_tiny_tower_no_adapters(models):
    _, tcfg, jp, _, _ = models
    tp = bridge.llava_params_from_numpy(_np(jp), "cpu")
    lo = tl.init_lora_params(tp, tcfg, tl.LoraConfig(r=R), torch.Generator().manual_seed(0))
    assert lo["vision_tower"] == {} and len(lo["language_model"]) == 7


def test_merge_lora_matches_jax_and_the_runtime_path(models):
    jcfg, tcfg, jp, jlora, batch = models
    tp = bridge.llava_params_from_numpy(_np(jp), "cpu")
    tlora = bridge.lora_from_numpy(_np(jlora), "cpu")
    jmerged = _np(jl.merge_lora(jp, jlora, jl.LoraConfig(**LORA)))
    tmerged = tl.merge_lora(tp, tlora, tl.LoraConfig(**LORA))
    for (path, a), (_, b) in zip(_paths(tmerged), _paths(jmerged)):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6, rtol=0, err_msg=path)
    assert tp["language_model"]["layers"]["q"] is not tmerged["language_model"]["layers"]["q"]
    tb = _tbatch(batch)
    args = (tcfg, tb["input_ids"], tb["pixel_values"], tb["attention_mask"])
    runtime, _ = tm.llava_forward(tp, *args, lora=tlora, lora_scaling=2.0)
    merged, _ = tm.llava_forward(tmerged, *args)
    np.testing.assert_allclose(runtime.numpy(), merged.numpy(), atol=2e-4, rtol=0)


def test_zero_b_adapters_are_the_identity(models):
    _, tcfg, jp, _, batch = models
    tp = bridge.llava_params_from_numpy(_np(jp), "cpu")
    lo = tl.init_lora_params(tp, tcfg, tl.LoraConfig(**LORA), torch.Generator().manual_seed(4))
    tb = _tbatch(batch)
    args = (tp, tcfg, tb["input_ids"], tb["pixel_values"], tb["attention_mask"])
    with_ad, _ = tm.llava_forward(*args, lora=lo, lora_scaling=2.0, lora_dropout=0.05,
                                  dropout_rng=torch.Generator().manual_seed(0))
    without, _ = tm.llava_forward(*args)
    assert torch.equal(with_ad, without)


def test_lora_matmul_and_vision_mask(models):
    rng = np.random.default_rng(5)
    x, w = (rng.normal(size=s).astype(np.float32) for s in ((3, 8), (8, 6)))
    ad = {"a": rng.normal(size=(8, 2)).astype(np.float32),
          "b": rng.normal(size=(2, 6)).astype(np.float32)}
    for mask in (None, 1.0, 0.0):
        jad = {k: jnp.asarray(v) for k, v in ad.items()}
        tad = {k: torch.from_numpy(v) for k, v in ad.items()}
        if mask is not None:
            jad["mask"], tad["mask"] = jnp.full((1, 1), mask), torch.full((1, 1), mask)
        want = np.asarray(jl.lora_matmul(jnp.asarray(x), jnp.asarray(w), jad, 0.5))
        got = tl.lora_matmul(torch.from_numpy(x), torch.from_numpy(w), tad, 0.5).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        if mask == 0.0:
            np.testing.assert_allclose(got, x @ w, atol=1e-5, rtol=0)
    assert torch.equal(tl.lora_matmul(torch.from_numpy(x), torch.from_numpy(w), None, 0.5),
                       torch.from_numpy(x) @ torch.from_numpy(w))


def test_partition_strip_apply_and_step2_adapters(models):
    _, tcfg, jp, jlora, _ = models
    tp = bridge.llava_params_from_numpy(_np(jp), "cpu")
    tlora = bridge.lora_from_numpy(_np(jlora), "cpu")
    trainable = tl.trainable_partition(tp, tlora)
    assert sorted(trainable) == sorted(jl.trainable_partition(jp, jlora))
    assert trainable["lm_head"] is tp["language_model"]["lm_head"]
    frozen = tl.strip_trainable(tp)
    assert "projector" not in frozen and "projector" in tp
    assert set(tp["language_model"]) - set(frozen["language_model"]) == {"lm_head", "embed_tokens"}
    full, lo = tl.apply_trainable(frozen, trainable)
    assert lo is tlora and full["language_model"]["embed_tokens"] is trainable["embed_tokens"]
    assert full["projector"] is tp["projector"]
    base, step2 = tl.add_step2_adapters(tp, tlora, tcfg, tl.LoraConfig(**LORA),
                                        torch.Generator().manual_seed(6), merge_step1=True)
    assert not step2["language_model"]["q"]["b"].any()
    assert not torch.equal(base["language_model"]["layers"]["q"],
                           tp["language_model"]["layers"]["q"])
    base2, _ = tl.add_step2_adapters(tp, tlora, tcfg, tl.LoraConfig(**LORA),
                                     torch.Generator().manual_seed(6))
    assert base2 is tp


def test_multi_stacked_adapters_raise(models):
    """A multi stack (the set and its negated-B twin) with per-row
    ``adapter_ids`` gives JAX's stacked forward on every valid position;
    without the ids it raises, as in JAX."""
    jcfg, tcfg, jp, jlora, batch = models
    tp = bridge.llava_params_from_numpy(_np(jp), "cpu")
    lo = bridge.lora_from_numpy(_np(jlora), "cpu")["language_model"]
    twin = {t: {"a": ab["a"], "b": -ab["b"]} for t, ab in lo.items()}
    stacked = {"language_model": tl.stack_adapter_sets([lo, twin])}
    jstacked = {"language_model": jl.stack_adapter_sets(
        [jlora["language_model"], {t: {"a": ab["a"], "b": -ab["b"]}
                                   for t, ab in jlora["language_model"].items()}])}
    ids = np.arange(B, dtype=np.int32) % 2
    jb, tb = _jbatch(batch), _tbatch(batch)
    want, _ = jm.llava_forward(jp, jcfg, jb["input_ids"], None, jb["attention_mask"],
                               lora=jstacked, lora_scaling=1.0, adapter_ids=jnp.asarray(ids))
    got, _ = tm.llava_forward(tp, tcfg, tb["input_ids"], None, tb["attention_mask"],
                              lora=stacked, lora_scaling=1.0, adapter_ids=torch.from_numpy(ids))
    valid = batch["attention_mask"].astype(bool)         # padded rows differ by contract
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], atol=2e-4, rtol=0)
    with pytest.raises(ValueError, match="multi-stacked"):
        tm.llava_forward(tp, tcfg, tb["input_ids"], None, tb["attention_mask"],
                         lora=stacked, lora_scaling=1.0)


# ---------------------------------------------------------------------------
# the forward with adapters, remat, losses
# ---------------------------------------------------------------------------

def test_llava_forward_with_adapters_matches_jax(models):
    jcfg, tcfg, jp, jlora, batch = models
    tp = bridge.llava_params_from_numpy(_np(jp), "cpu")
    tlora = bridge.lora_from_numpy(_np(jlora), "cpu")
    jb, tb = _jbatch(batch), _tbatch(batch)
    for hidden in (False, True):
        want, _ = jm.llava_forward(jp, jcfg, jb["input_ids"], jb["pixel_values"],
                                   jb["attention_mask"], lora=jlora, lora_scaling=2.0,
                                   return_hidden=hidden)
        got, _ = tm.llava_forward(tp, tcfg, tb["input_ids"], tb["pixel_values"],
                                  tb["attention_mask"], lora=tlora, lora_scaling=2.0,
                                  return_hidden=hidden)
        valid = batch["attention_mask"].astype(bool)     # padded rows differ by contract
        np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], atol=2e-4, rtol=0)
    want, _ = jm.llava_forward(jp, jcfg, jb["input_ids"], jb["pixel_values"],
                               jb["attention_mask"], lora=jlora, lora_scaling=2.0,
                               last_logit_only=True)
    got, _ = tm.llava_forward(tp, tcfg, tb["input_ids"], tb["pixel_values"],
                              tb["attention_mask"], lora=tlora, lora_scaling=2.0,
                              last_logit_only=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)
    jloss, jn = jm.causal_lm_loss(want.repeat(T, axis=1), jb["labels"], jb["attention_mask"])
    tloss, tn = tm.causal_lm_loss(got.repeat(1, T, 1), tb["labels"], tb["attention_mask"])
    assert int(tn) == int(jn)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


def _grads_of_forward(tp, tcfg, tlora, tb, **kw):
    leaves = tree_map(lambda t: t.clone().requires_grad_(t.dim() == 3 and t.shape[-1] != 1),
                      tlora)
    embed = tp["language_model"]["embed_tokens"].clone().requires_grad_(True)
    proj = tree_map(lambda t: t.clone().requires_grad_(True), tp["projector"])
    full = {**tp, "projector": proj,
            "language_model": {**tp["language_model"], "embed_tokens": embed}}
    logits, _ = tm.llava_forward(full, tcfg, tb["input_ids"], tb["pixel_values"],
                                 tb["attention_mask"], lora=leaves, lora_scaling=2.0, **kw)
    loss, _ = tm.causal_lm_loss(logits, tb["labels"], tb["attention_mask"])
    wanted = [t for t in tree_leaves(leaves) if t.requires_grad] + [embed] + tree_leaves(proj)
    return loss.detach(), torch.autograd.grad(loss, wanted)


def test_remat_gives_equal_gradients_also_under_dropout(models):
    _, tcfg, jp, jlora, batch = models
    tp = bridge.llava_params_from_numpy(_np(jp), "cpu")
    tlora = bridge.lora_from_numpy(_np(jlora), "cpu")
    tb = _tbatch(batch)
    for drop in ({}, {"lora_dropout": 0.3}):
        rngs = [torch.Generator().manual_seed(11) if drop else None for _ in range(2)]
        loss_a, g_a = _grads_of_forward(tp, tcfg, tlora, tb, remat=False, dropout_rng=rngs[0],
                                        **drop)
        loss_b, g_b = _grads_of_forward(tp, tcfg, tlora, tb, remat=True, dropout_rng=rngs[1],
                                        **drop)
        assert torch.equal(loss_a, loss_b)
        assert len(g_a) == 7 * 2 + 6 * 2 + 1 + 4
        for a, b in zip(g_a, g_b):
            assert a.abs().max() > 0
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)
    # the projector and the embedding table got their gradient through
    # merge_image_features and the gather
    assert g_a[-5].shape == tp["language_model"]["embed_tokens"].shape


def test_dropout_is_seeded_scaled_and_advances_the_generator(models):
    _, tcfg, jp, jlora, batch = models
    tp = bridge.llava_params_from_numpy(_np(jp), "cpu")
    tlora = bridge.lora_from_numpy(_np(jlora), "cpu")
    tb = _tbatch(batch)

    def run(gen):
        out, _ = tm.llava_forward(tp, tcfg, tb["input_ids"], None, tb["attention_mask"],
                                  lora=tlora, lora_scaling=2.0, lora_dropout=0.5,
                                  dropout_rng=gen)
        return out

    a, b = run(torch.Generator().manual_seed(7)), run(torch.Generator().manual_seed(7))
    c = run(torch.Generator().manual_seed(8))
    gen = torch.Generator().manual_seed(7)
    d, e = run(gen), run(gen)
    plain = run(None)
    assert torch.equal(a, b) and torch.equal(a, d)
    assert not torch.equal(a, c) and not torch.equal(d, e) and not torch.equal(a, plain)
    x = torch.ones(64, 64)
    keep = tl.dropout_mask(x, 0.25, seed=3)
    assert torch.equal(keep, tl.dropout_mask(x, 0.25, seed=3))
    assert 0.70 < keep.float().mean() < 0.80
    ad = {"a": torch.eye(64), "b": torch.eye(64)}
    upd = tl.lora_update(x, ad, 1.0, torch.float32, dropout=0.25, seed=3)
    assert torch.equal(upd, torch.where(keep, x / 0.75, torch.zeros_like(x)))


def test_padded_keys_get_exactly_no_gradient_through_the_stack(models):
    """The bias-free training contract: padded query rows see padded keys,
    but the loss weights them 0, so nothing flows back into a padded
    position of the decoder's input."""
    _, tcfg, jp, jlora, batch = models
    tp = bridge.llava_params_from_numpy(_np(jp), "cpu")
    tlora = bridge.lora_from_numpy(_np(jlora), "cpu")
    tb = _tbatch(batch)
    lm = tp["language_model"]
    embeds = lm["embed_tokens"][tb["input_ids"].long()].clone().requires_grad_(True)
    hidden, _ = t_llama.llama_forward(lm, tcfg.text, embeds, tb["attention_mask"],
                                      tm._positions(tb["attention_mask"]),
                                      lora=tlora["language_model"], lora_scaling=2.0, remat=True)
    loss = t_step.chunked_weighted_causal_lm_loss(hidden, lm["lm_head"], tb["labels"],
                                                  tb["attention_mask"], tb["weights"], chunk=8)
    grad, = torch.autograd.grad(loss, embeds)
    padded = tb["attention_mask"] == 0
    assert padded.any() and not grad[padded].any() and grad[~padded].abs().max() > 0


@pytest.mark.parametrize("chunk", [5, 8, 23, 64])
def test_chunked_loss_equals_unchunked_and_jax(models, chunk):
    jcfg, tcfg, jp, _, batch = models
    rng = np.random.default_rng(9)
    hidden = rng.normal(size=(B, T, jcfg.text.hidden_size)).astype(np.float32)
    head = np.array(jp["language_model"]["lm_head"])
    jb, tb = _jbatch(batch), _tbatch(batch)
    want = float(j_step.chunked_weighted_causal_lm_loss(
        jnp.asarray(hidden), jnp.asarray(head), jb["labels"], jb["attention_mask"],
        jb["weights"], chunk=chunk))
    th = torch.from_numpy(hidden).requires_grad_(True)
    thead = torch.from_numpy(head).requires_grad_(True)
    got = t_step.chunked_weighted_causal_lm_loss(th, thead, tb["labels"], tb["attention_mask"],
                                                 tb["weights"], chunk=chunk)
    full = t_step.weighted_causal_lm_loss(tm.lm_logits({"lm_head": thead}, tcfg.text, th),
                                          tb["labels"], tb["attention_mask"], tb["weights"])
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    np.testing.assert_allclose(full.item(), want, rtol=1e-5)
    for a, b in zip(torch.autograd.grad(got, (th, thead)), torch.autograd.grad(full, (th, thead))):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7)
    zero = t_step.weighted_causal_lm_loss(torch.zeros(B, T, VOCAB), tb["labels"],
                                          tb["attention_mask"], torch.zeros(B))
    assert float(zero) == 0.0


# ---------------------------------------------------------------------------
# the optimizer against optax
# ---------------------------------------------------------------------------

def _random_tree(rng, scale):
    return {"lora": {"q": {"a": rng.normal(size=(2, 8, 3)).astype(np.float32) * scale,
                           "b": rng.normal(size=(2, 3, 8)).astype(np.float32) * scale}},
            "lm_head": None,
            "embed_tokens": rng.normal(size=(16, 8)).astype(np.float32) * scale}


@pytest.mark.parametrize("grad_accum,weight_decay,grad_clip", [(1, 0.0, 0.5), (1, 0.01, 100.0),
                                                               (2, 0.0, 0.5)])
def test_optimizer_matches_optax(grad_accum, weight_decay, grad_clip):
    """The same numpy gradients into both optimizers: updates and parameters
    equal within 1e-7 over 5 (6 with accumulation) steps, clipping active in
    the 0.5 cases (norms 2-4).  Midway the optax state is converted into
    the port's and both go on from it."""
    rng = np.random.default_rng(10)
    params = _random_tree(rng, 0.1)
    n_steps = 6 if grad_accum > 1 else 5
    grads = [_random_tree(rng, 0.25 * (1 + i % 3)) for i in range(n_steps)]
    grads[1]["embed_tokens"][:4] = 0.0            # near-zero second moments
    kw = dict(eta_min=1e-5, weight_decay=weight_decay, grad_clip=grad_clip, grad_accum=grad_accum)
    jtx, ttx = j_opt.cullavo_optimizer(LR, 4, **kw), t_opt.cullavo_optimizer(LR, 4, **kw)
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = bridge.trainable_from_numpy(params, "cpu")
    jstate, tstate = jtx.init(jparams), ttx.init(tparams)
    clipped = 0
    for i, g in enumerate(grads):
        clipped += float(t_opt.global_norm(bridge.trainable_from_numpy(g, "cpu"))) > grad_clip
        jupd, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, jupd)
        if i == 2:
            tstate_conv = bridge.opt_state_from_numpy(_np(jstate_prev), "cpu")
            for (path, a), (_, b) in zip(_paths({k: v for k, v in tstate.items()
                                                 if isinstance(v, dict)}),
                                         _paths({k: v for k, v in tstate_conv.items()
                                                 if isinstance(v, dict)})):
                np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-7, rtol=1e-5,
                                           err_msg=path)
            tstate = tstate_conv
        jstate_prev = jstate
        tupd, tstate = ttx.update(bridge.trainable_from_numpy(g, "cpu"), tstate, tparams)
        tparams = t_opt.apply_updates(tparams, tupd)
        for (path, a), (_, b) in zip(_paths(tupd), _paths(_np(jupd))):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-7, rtol=0, err_msg=f"{i} {path}")
        if grad_accum > 1 and i % 2 == 0:
            assert not any(a.any() for _, a in _paths(tupd))
    assert tparams["lm_head"] is None
    for (path, a), (_, b) in zip(_paths(tparams), _paths(_np(jparams))):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-7, rtol=0, err_msg=path)
    assert clipped == (n_steps if grad_clip < 1 else 0)
    # the port's state back into optax's structure: leaf for leaf
    back = bridge.opt_state_to_numpy(tstate, _np(jstate))
    assert jax.tree.structure(back) == jax.tree.structure(_np(jstate))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_np(jstate))):
        np.testing.assert_allclose(a, b, atol=1e-7, rtol=1e-5)


def test_cosine_annealing_and_global_norm_match():
    j, t = j_opt.cosine_annealing(2e-5, 10, 1e-6), t_opt.cosine_annealing(2e-5, 10, 1e-6)
    for step in (0, 1, 5, 10, 11, 1000):
        np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-6)
    tree = _random_tree(np.random.default_rng(11), 1.0)
    np.testing.assert_allclose(float(t_opt.global_norm(bridge.trainable_from_numpy(tree, "cpu"))),
                               float(optax.global_norm(jax.tree.map(jnp.asarray, tree))),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# the whole train step
# ---------------------------------------------------------------------------

def _capture_tx(lib):
    """An optimizer that moves nothing and returns the gradients as its new
    state: the step's gradient tree, exactly."""
    if lib == "jax":
        return optax.GradientTransformation(
            lambda p: jax.tree.map(jnp.zeros_like, p),
            lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    return t_opt.GradientTransformation(
        lambda p: tree_map(torch.zeros_like, p),
        lambda g, s, p: (tree_map(torch.zeros_like, g), g))


@pytest.mark.parametrize("bits", [0, 4], ids=["dense", "nf4"])
def test_train_step_matches_jax_from_one_converted_state(models, bits):
    """f32 compute, remat and the chunked loss on, dropout 0.  Step 1: loss
    and every gradient (rtol 1e-4, atol 1e-6 of the leaf's scale).  Then 3 real steps with
    clipping active: losses (rtol 1e-4), and every parameter within 3 x lr
    of JAX's (at the first steps Adam turns rounding noise in a near-zero
    gradient into an update of up to lr)."""
    jcfg, tcfg, jp, jlora, batch = models
    if bits:
        jp = jl.quantize_llm_weights(jp, bits=bits)
    jlc, tlc = jl.LoraConfig(**LORA), tl.LoraConfig(**LORA)
    jtrain, jfrozen = jl.trainable_partition(jp, jlora), jl.strip_trainable(jp)
    tfrozen = bridge.llava_params_from_numpy(_np(jfrozen), "cpu")
    ttrain = bridge.trainable_from_numpy(_np(jtrain), "cpu")
    jb, tb = _jbatch(batch), _tbatch(batch)
    kw = dict(remat=True, compute_dtype=None, loss_chunk=8)

    jstep = jax.jit(j_step.make_train_step(jcfg, jlc, _capture_tx("jax"), **kw))
    tstep = t_step.make_train_step(tcfg, tlc, _capture_tx("torch"), **kw)
    jst, jm1 = jstep(j_step.TrainState(jtrain, None, jnp.zeros((), jnp.int32)), jfrozen, jb, None)
    tst, tm1 = tstep(t_step.TrainState(ttrain, None, 0), tfrozen, tb, None)
    np.testing.assert_allclose(float(tm1["loss_llm"]), float(jm1["loss_llm"]), rtol=1e-4)
    n = 0
    for (path, a), (_, b) in zip(_paths(tst.opt_state), _paths(_np(jst.opt_state))):
        if path.endswith("mask"):
            assert not a.any()
            continue
        assert np.abs(b).max() > 0, path
        # atol 1e-6, taken relative to the leaf's largest entry where that
        # exceeds 1 (the embedding rows of frequent tokens): f32 sums in
        # another order
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, err_msg=path,
                                   atol=1e-6 * max(1.0, np.abs(b).max()))
        n += 1
    assert n == 7 * 2 + 6 * 2 + 4 + 2
    # grad_norm is the unclipped norm of all gradients (JAX's includes the mask's)
    want = np.sqrt(sum(float((a.double() ** 2).sum()) for _, a in _paths(tst.opt_state)))
    np.testing.assert_allclose(float(tm1["grad_norm"]), want, rtol=1e-5)

    clip = 0.5 * want
    jtx = j_opt.cullavo_optimizer(LR, 10, grad_clip=clip)
    ttx = t_opt.cullavo_optimizer(LR, 10, grad_clip=clip)
    jstep = jax.jit(j_step.make_train_step(jcfg, jlc, jtx, **kw))
    tstep = t_step.make_train_step(tcfg, tlc, ttx, **kw)
    jst = j_step.TrainState(jtrain, jtx.init(jtrain), jnp.zeros((), jnp.int32))
    tst = t_step.TrainState(ttrain, bridge.opt_state_from_numpy(_np(jst.opt_state), "cpu"), 0)
    jlosses, tlosses = [], []
    for _ in range(3):
        jst, jmet = jstep(jst, jfrozen, jb, None)
        tst, tmet = tstep(tst, tfrozen, tb, None)
        jlosses.append(float(jmet["loss_llm"]))
        tlosses.append(float(tmet["loss_llm"]))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[2] < tlosses[0] and tst.step == 3 and tst.opt_state["count"] == 3
    for (path, a), (_, b) in zip(_paths(tst.trainable), _paths(_np(jst.trainable))):
        if not path.endswith("mask"):
            assert np.abs(a.numpy() - b).max() <= 3 * LR, path
    for (path, a), (_, b) in zip(_paths(tst.trainable), _paths(ttrain)):
        if path.endswith("mask"):
            assert torch.equal(a, b)                 # a constant
        else:
            assert not torch.equal(a, b), path       # new tensors; the input state is intact
    for (path, a), (_, b) in zip(_paths(tfrozen), _paths(_np(jfrozen))):
        assert np.array_equal(a.numpy(), b), path    # the frozen base, bit-unchanged


def test_train_step_in_bf16_over_f32_masters_is_close_to_f32(models):
    """``compute_dtype=bf16``: the masters stay f32, the gradients arrive in
    f32, the NF4 scales keep f32, and the loss is the f32 loss within bf16
    rounding (2e-2 relative)."""
    _, tcfg, jp, jlora, batch = models
    jq = jl.quantize_llm_weights(jp, bits=4)
    tfrozen = bridge.llava_params_from_numpy(_np(jl.strip_trainable(jq)), "cpu")
    ttrain = bridge.trainable_from_numpy(_np(jl.trainable_partition(jq, jlora)), "cpu")
    tb = _tbatch(batch)
    out = {}
    for dt in (None, torch.bfloat16):
        step = t_step.make_train_step(tcfg, tl.LoraConfig(**LORA), _capture_tx("torch"),
                                      remat=True, compute_dtype=dt, loss_chunk=8)
        st, met = step(t_step.TrainState(ttrain, None, 0), tfrozen, tb, None)
        assert all(g.dtype == torch.float32 for g in tree_leaves(st.opt_state))
        out[dt] = float(met["loss_llm"]), float(met["grad_norm"])
    assert abs(out[torch.bfloat16][0] - out[None][0]) <= 2e-2 * out[None][0]
    assert abs(out[torch.bfloat16][1] - out[None][1]) <= 0.1 * out[None][1]
    assert tfrozen["language_model"]["layers"]["q"]["scale"].dtype == torch.float32


# ---------------------------------------------------------------------------
# data copies, pipeline, entry point
# ---------------------------------------------------------------------------

def _records(n, seed):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        k = 1 + i % 3
        x0, y0 = rng.integers(0, 20, size=(2, k))
        recs.append({"image": rng.integers(0, 255, (48 + 8 * i, 64, 3), dtype=np.uint8),
                     "classes": rng.integers(0, 80, size=(k,)),
                     "boxes": np.stack([x0, y0, x0 + 20, y0 + 25], axis=1).astype(np.float32),
                     "is_thing": np.ones((k,), bool) if i != 1 else np.zeros((k,), bool)})
    return recs


def test_data_copies_match_the_originals():
    assert t_constants.COCO_PANOPTIC_CLASSES == j_constants.COCO_PANOPTIC_CLASSES
    assert t_text.COLOR_LIST == j_text.COLOR_LIST and t_text.COLOR_RGB == j_text.COLOR_RGB
    boxes = np.asarray([[0.1234, 0.5, 0.25, 1.0], [0.0, 0.33333, 0.9, 0.75]])
    classes = ["cat", "dog"]
    for fn, args in (("box2string", (boxes[0],)), ("boxes2string", (boxes,)),
                     ("classesboxes2string", (classes, boxes)),
                     ("classescolors2string", (classes, ["red", "blue"])),
                     ("classes2string", (["cat", "cat"],)), ("list2string", ([1, "a"],))):
        assert getattr(t_text, fn)(*args) == getattr(j_text, fn)(*args)
    text = "Sure, it is (#1 cat) [0.1, 0.2, 0.3, 0.4], (#1 dog) [0.5, 0.5, 0.9]."
    tb_, tc_, te_ = t_text.parse_boxes_and_classes(text)
    jb_, jc_, je_ = j_text.parse_boxes_and_classes(text)
    assert np.array_equal(tb_, jb_) and tc_ == jc_ and te_ == je_ is False
    assert t_text.parse_boxes_and_classes("[1, 2")[2] is True
    recs = _records(4, 12)
    ttok, jtok = TByteTokenizer(), JByteTokenizer()
    tsamples = [t_syn.synthesize_step1(r, ttok, np.random.default_rng(3)) for r in recs]
    jsamples = [j_syn.synthesize_step1(r, jtok, np.random.default_rng(3)) for r in recs]
    assert tsamples[1] is None and jsamples[1] is None        # no thing instance
    for a, b in zip(tsamples, jsamples):
        if a is not None:
            assert all(np.array_equal(a[k], b[k]) for k in ("image", "input_ids", "labels"))
    tbatch = t_syn.collate_step1(tsamples, ttok, 4, pad_to=None, image_size=28)
    jbatch = j_syn.collate_step1(jsamples, jtok, 4, pad_to=None, image_size=28)
    for k in ("input_ids", "attention_mask", "labels", "weights"):
        assert np.array_equal(tbatch[k], jbatch[k]), k
    assert tbatch["weights"].tolist() == [1.0, 0.0, 1.0, 1.0]
    # bicubic antialiased resize: two implementations of one kernel
    np.testing.assert_allclose(tbatch["pixel_values"], jbatch["pixel_values"], atol=1e-4)
    with pytest.raises(ValueError, match="exceeds pad_to"):
        t_syn.collate_step1(tsamples, ttok, 4, pad_to=16, image_size=28)


def test_pipeline_builds_state_and_batches_and_trains(models, tmp_path):
    _, tcfg, jp, _, _ = models
    # the X-Decoder's, the VLP eval's, the VQA eval's, the VL zoo's and the
    # ImageNet eval's pipelines register when their module is imported (by
    # entry, or by another test file in this worker)
    assert "CuLLaVOPipeline" in list_pipelines()
    assert set(list_pipelines()) <= {"CuLLaVOPipeline", "XDecoderPipeline", "RefCOCOPipeline",
                                     "VLPRetrievalPipeline", "COCOCaptionXDecPipeline",
                                     "LLaVAVQAVALPipeline", "LLaVAVQATESTPipeline",
                                     "VLZooVQAPipeline", "LLaVAImageNetPipeline"}
    with pytest.raises(KeyError, match="not registered"):
        build_pipeline("NoSuchPipeline", {})
    tp = bridge.llava_params_from_numpy(_np(jp), "cpu")
    tok = TByteTokenizer()
    cfg = {"MODEL": {"LLM": {"BITS": 4, "LORA_R": R, "LORA_ALPHA": 8}}, "LR": 1e-3,
           "GRAD_MAX": 10, "TOTAL_STEPS": 5, "SEED": 3,
           "OPTIMIZER": {"LORA_VISION_START": 0, "LORA_VISION_STOP": 1}}
    tcfg = dataclasses.replace(tcfg, image_token_id=tok.image_token_id)
    pipe = build_pipeline("CuLLaVOPipeline", cfg, model_cfg=tcfg, tokenizer=tok, params=tp)
    state = pipe.initialize_model()
    assert pipe.lora_cfg == tl.LoraConfig(r=R, alpha=8.0, dropout=0.05, vision_layer_start=0,
                                          vision_layer_stop=1)
    assert "q4p" in pipe.frozen["language_model"]["layers"]["q"]
    assert "embed_tokens" not in pipe.frozen["language_model"]
    assert state.step == 0 and state.opt_state["count"] == 0
    assert state.trainable["lora"]["language_model"]["q"]["a"].shape == (2, 64, R)
    ids = np.full((140,), 65, np.int32)
    ids[1] = tok.image_token_id
    batch = pipe.make_batch(_records(2, 13), pad_to=None)
    assert batch["input_ids"].shape[0] == 2 and batch["pixel_values"].shape == (2, 3, 28, 28)
    assert int((batch["input_ids"] == tok.image_token_id).sum()) == 2 * tcfg.num_image_tokens
    losses = []
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        state, metrics = pipe.forward_step(state, batch, gen)
        losses.append(float(metrics["loss_llm"]))
    assert all(np.isfinite(losses)) and losses[2] < losses[0] and state.step == 3
    assert state.trainable["embed_tokens"].dtype == torch.float32
    # the same pipeline generates step-2 rows (sampled, through the fused
    # generate) over its quantized base; evaluate_model still points there
    row, _, _ = tm.expand_image_token(ids[:20], None, None, tok.image_token_id,
                                      tcfg.num_image_tokens)
    prompts = np.tile(row[None], (3, 1))
    rows = pipe.generate_step2_rows([np.zeros((30, 40, 3), np.uint8)] * 3, prompts,
                                    np.ones_like(prompts), str(tmp_path), max_new_tokens=3,
                                    batch_size=2)
    with open(tmp_path / "lbk_new_version.json") as f:
        assert json.load(f) == rows
    with pytest.raises(NotImplementedError, match="step2"):
        pipe.evaluate_model()


def test_entry_train_smoke_mode_on_the_cpu(capsys):
    cfg = {"MODEL": {"LLM": {"LOAD_PATH": None, "BITS": 4, "LORA_R": 8, "LORA_ALPHA": 16}},
           "LR": 2e-5, "GRAD_MAX": 10, "BATCH_SIZE": 8}
    metrics = t_entry.train(cfg, device="cpu")
    assert sorted(metrics) == ["grad_norm", "loss_llm"]
    assert np.isfinite(metrics["loss_llm"]) and metrics["grad_norm"] > 0
    assert 4.0 < metrics["loss_llm"] < 7.0          # ~log(260) on random weights
    assert "loss_llm" in capsys.readouterr().out
    again = t_entry.train(cfg, device="cpu")
    assert again == metrics                          # seeded end to end
    # an X-Decoder NAME goes to the joint trainer (tests/test_torch_xdecoder_train.py):
    # without DATASETS.TRAIN it builds the model and returns None; a mesh raises
    xdec = {**cfg, "NAME": "xdecoder_step", "MODEL": {**cfg["MODEL"], "TINY": True}}
    assert t_entry.train(xdec, device="cpu") is None
    with pytest.raises(NotImplementedError, match="MESH"):
        t_entry.train({**xdec, "MESH_DATA": 2}, device="cpu")
    # RESUME_FROM and DATASETS.TRAIN run now: a path without the reference
    # layout and a dataset nobody registered raise
    with pytest.raises(FileNotFoundError, match="cullavo"):
        t_entry.train({**cfg, "RESUME_FROM": "x"}, device="cpu")
    with pytest.raises(KeyError, match="not registered"):
        t_entry.train({**cfg, "DATASETS": {"TRAIN": "coco"}}, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_entry.train(cfg)


def test_trainable_bridge_round_trips(models):
    _, _, jp, jlora, _ = models
    tree = _np(jl.trainable_partition(jp, jlora))
    tree["lm_head"] = None
    t = bridge.trainable_from_numpy(tree, "cpu")
    assert t["lm_head"] is None
    back = bridge.trainable_to_numpy(t)
    for (path, a), (_, b) in zip(_paths(back), _paths(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    with pytest.raises(TypeError, match="ScaleByAdamState"):
        bridge.opt_state_from_numpy((), "cpu")
