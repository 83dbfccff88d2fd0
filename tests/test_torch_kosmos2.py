"""KOSMOS-2 in the torch port against the JAX package, at the tiny config
on the same numpy inputs and on JAX's initializer's weights carried across
by the bridge: the latent-query image features, the forward's logits,
greedy decoding over the cache (one row and a right-padded batch; the
one-token steps take K12's plain version on the CPU), the answerer and
``entry.evaluate`` with ``MODEL.ZOO: kosmos2``.

f32 values agree within 1e-5 (sums in other orders); decoding is
token-exact.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cullavo_tpu import entry as j_entry
from cullavo_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from cullavo_tpu.models import kosmos2 as jk
from cullavo_tpu.pipelines import vl_zoo_pipeline as j_zoo
from cullavo_tpu_torch import entry as t_entry
from cullavo_tpu_torch.checkpoint.from_jax import (kosmos2_params_from_numpy,
                                                   kosmos2_params_to_numpy)
from cullavo_tpu_torch.data.tokenizer import ByteTokenizer
from cullavo_tpu_torch.models import kosmos2 as tk
from cullavo_tpu_torch.ops import flash_attention as fa
from cullavo_tpu_torch.pipelines import vl_zoo_pipeline as t_zoo
from test_torch_zoo import QUESTIONS, jit_decode, vqa_files, zoo_cfg  # noqa: F401 (fixture)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CFG = jk.tiny_kosmos2_config()
N_IMG = CFG.latent_query_num


@pytest.fixture(autouse=True, scope="module")
def _jitted_jax_decoder():
    """JAX's KOSMOS-2 greedy decode and initializer jitted for this file
    (``test_torch_zoo.jit_decode``; the answerer and the zoo entry import
    them from their module at call time); the originals back afterwards."""
    gen, init = jk.kosmos2_generate, jk.init_kosmos2_params
    jk.kosmos2_generate = jit_decode(gen, ("cfg", "max_new_tokens", "eos_token_id",
                                           "compute_dtype"))
    jk.init_kosmos2_params = jit_decode(init, ("cfg", "dtype"))
    yield
    jk.kosmos2_generate, jk.init_kosmos2_params = gen, init


@pytest.fixture(scope="module")
def weights():
    """JAX's smoke weights (``PRNGKey(0)``) as numpy, and the port's copy."""
    tree = jax.tree.map(np.asarray, jk.init_kosmos2_params(CFG, jax.random.PRNGKey(0)))
    return tree, kosmos2_params_from_numpy(tree, "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(B, T, seed, pad=0):
    """[bos, <image> x N, text...] ids, the image mask, a right-padded key
    mask for the last row, and pixels."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, CFG.text.vocab_size, size=(B, T)).astype(np.int32)
    ids[:, 0] = 1
    ids[:, 1:1 + N_IMG] = 3
    img_mask = np.zeros((B, T), np.int32)
    img_mask[:, 1:1 + N_IMG] = 1
    mask = np.ones((B, T), np.int32)
    if pad:
        mask[-1, -pad:] = 0
    s = CFG.vision.image_size
    return ids, img_mask, mask, rng.normal(size=(B, 3, s, s)).astype(np.float32)


def test_bridge_and_init_match_the_jax_tree(weights):
    tree, params = weights
    back = kosmos2_params_to_numpy(params)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(tree)[0], jax.tree.leaves(back)):
        assert np.array_equal(a, b), path
    mine = kosmos2_params_to_numpy(tk.init_kosmos2_params(CFG, torch.Generator().manual_seed(0),
                                                          "cpu"))
    assert jax.tree.structure(mine) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(tree)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_positions_match_jax():
    mask = np.asarray([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]], np.int32)
    ref = np.asarray(jk.kosmos2_position_ids(jnp.asarray(mask), 1))
    got = tk.kosmos2_position_ids(_t(mask), 1)
    np.testing.assert_array_equal(got.numpy(), ref)
    for dim in (32, 33, 2048):
        ref_s = np.asarray(jk.sinusoid_positions(jnp.asarray(ref), dim, 1))
        got_s = tk.sinusoid_positions(_t(ref), dim, 1)
        np.testing.assert_allclose(got_s.numpy(), ref_s, atol=2e-6, rtol=0)
        assert np.all(got_s.numpy()[0, 4:] == 0)          # the padding rows


def test_image_features_and_forward_match_jax(weights):
    tree, params = weights
    jp = jax.tree.map(jnp.asarray, tree)
    ids, img_mask, mask, pix = _inputs(2, N_IMG + 8, seed=1, pad=3)
    ref_f = np.asarray(jax.jit(lambda p, x: jk.kosmos2_image_features(p, CFG, x))(jp, pix))
    got_f = tk.kosmos2_image_features(params, CFG, _t(pix))
    assert got_f.shape == (2, N_IMG, CFG.text.embed_dim)
    np.testing.assert_allclose(got_f.numpy(), ref_f, atol=1e-5, rtol=0)
    ref = np.asarray(jax.jit(lambda p, x, i, im, m: jk.kosmos2_forward(p, CFG, x, i, im, m))(
        jp, pix, ids, img_mask, mask))
    got = tk.kosmos2_forward(params, CFG, _t(pix), _t(ids).long(), _t(img_mask), _t(mask))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("B,pad,eos", [(1, 0, -1), (2, 3, -1), (2, 2, "first")],
                         ids=["one_row", "padded_batch", "early_eos"])
def test_generate_matches_jax(weights, B, pad, eos):
    tree, params = weights
    jp = jax.tree.map(jnp.asarray, tree)
    ids, img_mask, mask, pix = _inputs(B, N_IMG + 7, seed=2 + B + pad, pad=pad)
    args = (pix, ids, img_mask, mask)
    if eos == "first":   # an eos the first row emits: it stops there, the batch runs on
        eos = int(np.asarray(jk.kosmos2_generate(jp, CFG, *args, 6))[0, 2])
    ref = np.asarray(jk.kosmos2_generate(jp, CFG, *args, 6, eos_token_id=eos))
    before = fa.decode_partials.launches
    got = tk.kosmos2_generate(params, CFG, *(_t(a) for a in args[:1]), _t(ids).long(),
                              _t(img_mask), _t(mask), 6, eos_token_id=eos)
    assert fa.decode_partials.launches == before          # CPU tensors launch nothing
    np.testing.assert_array_equal(got.numpy(), ref)


def test_native_kosmos2_answer_fn_matches_jax(weights):
    tree, params = weights
    ref_fn = j_zoo.native_kosmos2_answer_fn(CFG, jax.tree.map(jnp.asarray, tree),
                                            JByteTokenizer(), max_new_tokens=5)
    mine = t_zoo.native_kosmos2_answer_fn(CFG, params, ByteTokenizer(), max_new_tokens=5)
    rng = np.random.default_rng(4)
    for i, q in enumerate(QUESTIONS[:3]):
        side = 28 if i else 36
        img = rng.normal(size=(3, side, side)).astype(np.float32)
        assert mine(q, img) == ref_fn(q, img)


def test_evaluate_zoo_kosmos2_matches_jax(tmp_path, vqa_files, weights, monkeypatch):
    """``entry.evaluate`` with ``MODEL.ZOO: kosmos2`` in both packages on
    JAX's smoke weights: the same metrics dict and answers file."""
    _, params = weights
    monkeypatch.setattr(t_zoo, "init_kosmos2_params", lambda cfg, gen, dev: params)
    out = {}
    for pkg, run in (("jax", j_entry.evaluate), ("port", t_entry.evaluate)):
        cfg = zoo_cfg("kosmos2", vqa_files, f"zoo_kosmos2_{pkg}", tmp_path / pkg, max_new=5)
        res = run(cfg) if pkg == "jax" else run(cfg, device="cpu")
        out[pkg] = res[f"zoo_kosmos2_{pkg}"]
    assert out["port"] == out["jax"] and out["port"]["n"] == len(QUESTIONS)
    with open(tmp_path / "jax" / "vqa_results.json") as f, \
            open(tmp_path / "port" / "vqa_results.json") as g:
        assert json.load(g) == json.load(f)


def test_kosmos2_answerer_raises_for_snapshots():
    """A snapshot directory without its files raises naming config.json
    (snapshots run: tests/test_torch_zoo_path.py)."""
    with pytest.raises(FileNotFoundError, match="config.json"):
        t_zoo.native_kosmos2_answer_fn(hf_model_dir="/x", device="cpu")
