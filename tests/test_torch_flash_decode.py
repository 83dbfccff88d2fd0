"""The one-token decode attention of the torch port against the JAX package:
``flash_decode`` (Pallas row 5, run in interpret mode on the CPU as
``tests/test_ops.py`` runs it) and the VL zoo's ``sdpa_decode_stale`` (the
plain form, and T5's with ``self_bias`` and unscaled scores), on the same
numpy inputs.  On CPU tensors the port takes K12's plain version; the
kernel itself is held to that version on the card
(``tests/test_torch_package.py``, ``chip_smoke.py`` phase 3).

Tolerances: f32 within 1e-5 (the two packages sum the dots and the softmax
in other orders); bf16 outputs within one bf16 ulp of values below 4
(1e-2 + 1e-2 |ref|: JAX rounds its f32 result once, the port too, from
sums taken in another order)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cullavo_tpu.models.llava.llama import sdpa_decode_stale as j_stale
from cullavo_tpu.ops.flash_attention import flash_decode as j_flash_decode
from cullavo_tpu_torch.models.llava.llama import sdpa_decode_stale, sdpa_decode_stale_plain
from cullavo_tpu_torch.ops import flash_attention as fa


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _decode_case(B, H, KV, S, d, positions, valid_len, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, 1, d)).astype(np.float32)
    k = rng.normal(size=(B, KV, S, d)).astype(np.float32)
    v = rng.normal(size=(B, KV, S, d)).astype(np.float32)
    kv_valid = np.zeros((B, S), np.int32)
    for b, n in enumerate(valid_len):
        kv_valid[b, :n] = 1
    return q, k, v, np.asarray(positions, np.int32), kv_valid


@pytest.mark.parametrize("B,H,KV,S,d,positions,valid_len", [
    (2, 8, 4, 256, 32, [30, 200], [31, 256]),       # GQA, S a multiple of 128
    (3, 4, 4, 100, 64, [99, 50, 7], [100, 60, 8]),   # S not a multiple of 128, valid keys
    (2, 4, 2, 128, 16, [-1, 60], [128, 61]),         # row 0 wholly masked (mean of v)
    (2, 4, 1, 300, 32, [299, 150], [280, 151]),      # one kv head for all, padding at 280
], ids=["gqa", "ragged_s", "masked_row", "mqa_padded"])
def test_flash_decode_matches_jax(B, H, KV, S, d, positions, valid_len):
    q, k, v, pos, valid = _decode_case(B, H, KV, S, d, positions, valid_len, seed=S + d)
    ref = np.asarray(j_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(pos), jnp.asarray(valid)))
    got = fa.flash_decode(*(torch.from_numpy(a) for a in (q, k, v, pos, valid)))
    assert got.shape == (B, H, 1, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    if -1 in positions:                       # the wholly masked row is v's mean
        b = positions.index(-1)
        mean = v[b].mean(axis=1)[np.arange(H) // (H // KV)]
        np.testing.assert_allclose(got[b, :, 0].numpy(), mean, atol=1e-5, rtol=0)


def test_flash_decode_matches_jax_in_bf16():
    q, k, v, pos, valid = _decode_case(2, 8, 2, 256, 64, [255, 100], [256, 101], seed=5)
    as_bf16 = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    ref = np.asarray(j_flash_decode(*as_bf16, jnp.asarray(pos), jnp.asarray(valid))
                     .astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = fa.flash_decode(tq, tk, tv, torch.from_numpy(pos), torch.from_numpy(valid))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-2, rtol=1e-2)


def test_decode_partials_carry_the_row_max_and_sum():
    """o, m and l of the plain version: the softmax of the scaled scores
    plus bias, its max and sum; a row of -inf keys gives o = 0, l = 0."""
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.normal(size=(2, 4, 1, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, 2, 9, 16)).astype(np.float32))
            for _ in range(2))
    bias = torch.from_numpy(rng.normal(size=(2, 4, 9)).astype(np.float32))
    bias[1, 3] = -torch.inf
    o, m, l = fa.decode_partials(q, k, v, bias, 0.3)
    kr, vr = (t.repeat_interleave(2, dim=1) for t in (k, v))
    s = (q @ kr.transpose(-1, -2))[:, :, 0] * 0.3 + bias
    ref = torch.softmax(s, dim=-1)[:, :, None] @ vr
    torch.testing.assert_close(o[:2, :3], ref[:2, :3, 0], atol=1e-6, rtol=0)
    torch.testing.assert_close(o[0], ref[0, :, 0], atol=1e-6, rtol=0)
    torch.testing.assert_close(m[0], s[0].amax(-1), atol=0, rtol=0)
    torch.testing.assert_close(torch.log(l[0]) + m[0], torch.logsumexp(s[0], -1),
                               atol=1e-6, rtol=0)
    assert float(l[1, 3]) == 0.0 and float(m[1, 3]) == -float("inf")
    assert torch.all(o[1, 3] == 0)


def _stale_case(B, H, S, d, n_valid, seed, t5):
    rng = np.random.default_rng(seed)
    q, k_cur, v_cur = (rng.normal(size=(B, H, 1, d)).astype(np.float32) for _ in range(3))
    k_cache, v_cache = (rng.normal(size=(B, H, S, d)).astype(np.float32) for _ in range(2))
    valid = np.arange(S)[None, :] < np.asarray(n_valid)[:, None]              # [B, S]
    if t5:   # the decoder's relative bias over the cache + causal mask, [1, H, 1, S]
        bias = rng.normal(size=(1, H, 1, S)).astype(np.float32)
        bias = bias + np.where(valid[:1, None, None, :], 0.0, -1e9).astype(np.float32)
        self_bias = rng.normal(size=(1, H, 1, 1)).astype(np.float32)
    else:    # KOSMOS-2: key validity per row, [B, 1, 1, S]
        bias = np.where(valid[:, None, None, :], 0.0, -1e9).astype(np.float32)
        self_bias = None
    return q, k_cache, v_cache, k_cur, v_cur, bias, self_bias


@pytest.mark.parametrize("form,n_valid", [
    ("plain", [5, 17]), ("plain", [0, 0]), ("t5", [7, 7]), ("t5", [0, 0])],
    ids=["scaled", "scaled_empty_cache", "t5", "t5_first_step"])
def test_sdpa_decode_stale_matches_jax(form, n_valid):
    t5 = form == "t5"
    args = _stale_case(2, 4, 17, 32, n_valid, seed=3 + sum(n_valid), t5=t5)
    scale = 1.0 if t5 else None
    ja = [None if a is None else jnp.asarray(a) for a in args]
    ref = np.asarray(j_stale(*ja[:6], self_bias=ja[6], scale=scale))
    ta = [None if a is None else torch.from_numpy(a) for a in args]
    before = fa.decode_partials.launches
    got = sdpa_decode_stale(*ta[:6], self_bias=ta[6], scale=scale)
    plain = sdpa_decode_stale_plain(*ta[:6], self_bias=ta[6], scale=scale)
    assert fa.decode_partials.launches == before          # CPU tensors launch nothing
    assert got.shape == (2, 4, 1, 32)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(plain.numpy(), ref, atol=1e-5, rtol=0)
    if sum(n_valid) == 0:          # nothing written yet: the current token's value
        np.testing.assert_allclose(got.numpy(), args[4], atol=1e-6, rtol=0)
