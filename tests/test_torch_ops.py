"""Torch port ops (``cullavo_tpu_torch.ops``) against the JAX package.

Inputs are made with numpy from a seed and fed to both; JAX runs on the CPU
as its own tests run it (Pallas kernels in interpret mode).  On the CPU the
port's kernel wrappers take their plain PyTorch versions; the CUDA kernels
are compared with those plain versions on a card in
``tests/test_torch_package.py`` (marked ``cuda``; that file imports no JAX,
so it also runs on a machine with a card and without JAX).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cullavo_tpu.ops import flash_attention as jfa
from cullavo_tpu.ops import nf4 as jnf4
from cullavo_tpu_torch.ops import flash_attention as tfa
from cullavo_tpu_torch.ops import nf4 as tnf4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bits(a):
    """Raw bits of a bf16/f32 array (numpy or torch) for bit-equality."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a.view(torch.int32) if a.dtype == torch.float32 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else (
        a.view(np.int32) if a.dtype == np.float32 else a)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("smooth", [True, False])
def test_quantize_linear_int8_bit_equal(seed, smooth):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(2, 96, 80)) * 0.1).astype(np.float32)   # stacked [L, K, N]
    w[0, :, 3] = 0.0                                                # a zero column
    sm = np.exp(rng.normal(0.0, 0.3, 96)).astype(np.float32) if smooth else None
    jq = jnf4.quantize_linear_int8(jnp.asarray(w), smooth_scale=sm)
    tq = tnf4.quantize_linear_int8(torch.from_numpy(w), smooth_scale=sm)
    assert sorted(jq) == sorted(tq)
    for key in jq:
        assert tq[key].shape == jq[key].shape, key
        np.testing.assert_array_equal(_bits(tq[key]), _bits(jq[key]), err_msg=key)


@pytest.mark.parametrize("with_mult", [True, False])
def test_quantize_rows_plain_matches_pallas(with_mult):
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(64, 256)) * 2.0, jnp.bfloat16)
    mult = (jnp.asarray(np.exp(rng.normal(0, 0.3, (1, 256))), jnp.bfloat16)
            if with_mult else None)
    jxi, jsx = jnf4.quantize_rows_pallas(x, mult)
    xt = torch.from_numpy(np.asarray(x).view(np.int16)).view(torch.bfloat16)
    mt = (None if mult is None
          else torch.from_numpy(np.asarray(mult).view(np.int16)).view(torch.bfloat16))
    txi, tsx = tnf4.quantize_rows(xt, mt)
    np.testing.assert_array_equal(txi.numpy(), np.asarray(jxi))
    np.testing.assert_allclose(tsx.numpy(), np.asarray(jsx), rtol=2e-7, atol=0)


def _smooth_int8_pair(rng, K, Ns, sm):
    out = []
    for N in Ns:
        w = (rng.normal(size=(K, N)) * K ** -0.5).astype(np.float32)
        jq = jnf4.quantize_linear_int8(jnp.asarray(w), smooth_scale=sm)
        tq = {k: torch.from_numpy(np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                                             else v)).to(torch.bfloat16 if v.dtype == jnp.bfloat16
                                                         else None)
              for k, v in jq.items()}
        out.append((jq, tq))
    return out


@pytest.mark.parametrize("K", [64, 128])
def test_int8_s8s8_group_and_auto_match_jax(K):
    """Grouped s8s8 at prefill M (1024 rows; K=128 runs the JAX Pallas
    quantizer in interpret mode, K=64 its XLA chain), and the phase-aware
    auto dispatch on both sides of the 1024-row threshold."""
    rng = np.random.default_rng(4)
    sm = np.exp(rng.normal(0, 0.3, K)).astype(np.float32)
    pairs = _smooth_int8_pair(rng, K, (48, 32), sm)
    x = rng.normal(size=(2, 512, K)).astype(np.float32)
    jys = jnf4.int8_linear_s8s8_group(jnp.asarray(x), tuple(p[0] for p in pairs))
    tys = tnf4.int8_linear_s8s8_group(torch.from_numpy(x), tuple(p[1] for p in pairs))
    for jy, ty in zip(jys, tys):
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4, rtol=0)
    for rows in (512, 1024):
        xa = x.reshape(-1, K)[:rows]
        jy = jnf4.int8_linear_s8s8_auto(jnp.asarray(xa), pairs[0][0])
        ty = tnf4.int8_linear_s8s8_auto(torch.from_numpy(xa), pairs[0][1])
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4, rtol=0)
    assert tnf4.s8s8_group_enabled([p[1] for p in pairs], torch.zeros(1024, K))
    assert not tnf4.s8s8_group_enabled([p[1] for p in pairs], torch.zeros(1023, K))


@pytest.mark.parametrize("M", [1, 14, 64, 300])
def test_int8_linear_plain_matches_jax(M):
    """The K3 plain version against nf4.int8_linear (with sq_inv) and the
    TPU kernel int8_linear_pallas (interpret mode).  Activations are bf16
    values and the column scales powers of two, so the Pallas kernel's bf16
    dequantized weight is exact and all three agree to f32 rounding."""
    rng = np.random.default_rng(5 + M)
    K, N = 128, 256
    x = np.asarray(jnp.asarray(rng.normal(size=(M, K)), jnp.bfloat16).astype(jnp.float32))
    q8 = rng.integers(-127, 128, size=(K, N)).astype(np.int8)
    scale8 = (2.0 ** rng.integers(-9, -5, size=(1, N))).astype(np.float32)
    jq = {"q8": jnp.asarray(q8), "scale8": jnp.asarray(scale8)}
    tq = {"q8": torch.from_numpy(q8), "scale8": torch.from_numpy(scale8)}
    ty = tnf4.int8_linear(torch.from_numpy(x), tq).numpy()
    np.testing.assert_allclose(ty, np.asarray(jnf4.int8_linear(jnp.asarray(x), jq)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ty, np.asarray(jnf4.int8_linear_pallas(jnp.asarray(x), jq)),
                               rtol=1e-5, atol=1e-5)
    sq = np.exp(rng.normal(0, 0.3, (1, K))).astype(np.float32)
    jq["sq_inv"], tq["sq_inv"] = jnp.asarray(sq), torch.from_numpy(sq)
    np.testing.assert_allclose(tnf4.int8_linear(torch.from_numpy(x), tq).numpy(),
                               np.asarray(jnf4.int8_linear(jnp.asarray(x), jq)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("smooth", [False, True], ids=["no_sq_inv", "sq_inv"])
@pytest.mark.parametrize("M", [1, 8, 14, 56, 300])
def test_int8_linear_plain_matches_jax_in_bf16(M, smooth):
    """K3's plain version in the kernel's working type (bf16 x and output,
    bf16 sq_inv) against JAX's int8_linear and the TPU kernel
    int8_linear_pallas (interpret mode) on the same bf16 inputs, at the paths'
    decode M and beyond one 256-token tile, with and without the SmoothQuant
    prologue.  x * sq_inv rounds once to bf16 in all three; the column scales
    are powers of two, so the Pallas kernel's scale before the dot is exact;
    each sums exact products in f32 in its own order and rounds once to
    bf16, so they agree within one bf16 ulp (rtol 2^-7) + 1e-6."""
    rng = np.random.default_rng(50 + M + smooth)
    K, N = 320, 272
    x = jnp.asarray(rng.normal(size=(M, K)), jnp.bfloat16)
    q8 = rng.integers(-127, 128, size=(K, N)).astype(np.int8)
    scale8 = (2.0 ** rng.integers(-9, -5, size=(1, N))).astype(np.float32)
    jq = {"q8": jnp.asarray(q8), "scale8": jnp.asarray(scale8)}
    tq = {"q8": torch.from_numpy(q8), "scale8": torch.from_numpy(scale8)}
    if smooth:
        sq = jnp.asarray(np.exp(rng.normal(0, 0.3, (1, K))), jnp.bfloat16)
        jq["sq_inv"] = sq
        tq["sq_inv"] = torch.from_numpy(np.asarray(sq.astype(jnp.float32))).to(torch.bfloat16)
    tx = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    ty = tnf4.int8_linear(tx, tq)
    assert ty.dtype == torch.bfloat16 and ty.shape == (M, N)
    ty = ty.float().numpy()
    for jy in (jnf4.int8_linear(x, jq), jnf4.int8_linear_pallas(x, jq)):
        np.testing.assert_allclose(ty, np.asarray(jy.astype(jnp.float32)), rtol=2.0 ** -7,
                                   atol=1e-6)


def test_flash_attention_plain_matches_jax():
    """Causal, right-padded contract at an unaligned T (37): the port's
    flash_attention (its plain version on the CPU) against the JAX Pallas
    kernel in interpret mode and against mha_reference."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.normal(size=(2, 3, 37, 16)).astype(np.float32) for _ in range(3))
    out = tfa.flash_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(out, np.asarray(jfa.flash_attention(jq, jk, jv)), atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(jfa.mha_reference(jq, jk, jv)), atol=1e-5)


def test_out_of_slice_modes_raise():
    # key masks and non-causal attention run since the training slice; what
    # the function cannot take still raises
    x = torch.randn(2, 3, 8, 16, generator=torch.Generator().manual_seed(0))
    valid = torch.ones(2, 8, dtype=torch.int32)
    valid[1, 5:] = 0
    assert torch.equal(tfa.flash_attention(x, x, x, kv_valid=valid),
                       tfa.mha_reference(x, x, x, kv_valid=valid))
    assert torch.equal(tfa.flash_attention(x, x, x, causal=False),
                       tfa.mha_reference(x, x, x, causal=False))
    with pytest.raises(ValueError, match="kv_valid must be"):
        tfa.flash_attention(x, x, x, kv_valid=torch.ones(2, 7))
    with pytest.raises(ValueError, match="are not"):
        tfa.flash_attention(x, x[:, :2], x[:, :2])
    q = {"q8": torch.zeros(4, 8, dtype=torch.int8), "scale8": torch.ones(1, 8),
         "o_w": torch.zeros(1, 8)}
    with pytest.raises(NotImplementedError, match="slice 4"):
        tnf4.int8_linear(torch.zeros(2, 4), q)
    with pytest.raises(NotImplementedError, match="later slice"):
        tnf4.int8_linear(torch.zeros(2, 4), {"q8t": q["q8"].T, "scale8": q["scale8"]})
    # the decoder: speculative windows, the int8 cache, per-row write
    # positions and prefix-reuse windows run now; the cached forward of the
    # fused generate, sliding windows and sampling wait
    import dataclasses

    from cullavo_tpu_torch.models.llava import llama as tllama
    from cullavo_tpu_torch.models.llava import modeling as tmod
    from cullavo_tpu_torch.models.llava.config import tiny_llava_config

    cfg = tiny_llava_config(64)
    params = tmod.init_llava_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lm, tc = params["language_model"], cfg.text
    emb, pos = torch.ones(1, 2, tc.hidden_size), torch.arange(2)[None]
    cache = tllama.init_kv_cache(tc, 1, 8, torch.float32)
    with pytest.raises(NotImplementedError, match="fused generate"):
        tllama.llama_forward(lm, tc, emb, torch.ones(1, 8), pos, cache, 0)
    with pytest.raises(NotImplementedError, match="sliding-window"):
        tllama.llama_forward(lm, dataclasses.replace(tc, sliding_window=4), emb,
                             torch.ones(1, 2), pos)
    with pytest.raises(NotImplementedError, match="sampled decoding"):
        tmod._sample_token(torch.zeros(1, 4), tmod.GenerationConfig(do_sample=True))
    for kv_quant in (None, "int8"):
        cache = tllama.init_kv_cache(tc, 1, 8, torch.float32, kv_quant)
        hidden, new = tllama.llama_forward(lm, tc, emb, torch.zeros(1, 8), pos, cache,
                                           torch.tensor([3], dtype=torch.int32),
                                           stale_cache=True)
        assert hidden.shape == emb.shape and new["k"][:, 3:5].any() and not new["k"][:, 5:].any()
