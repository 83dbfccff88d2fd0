"""The port's packed-heads causal attention (``flash_attention_packed``, the
counterpart of Pallas rows 3 and 4) against the JAX package on the CPU, and
the ``CULLAVO_FLASH_PACKED`` switch of the port's LLaMA forward.

The same numpy inputs from a seed go through both packages: the JAX side
through its Pallas kernel in interpret mode with its custom VJP (as
``tests/test_ops.py`` runs it), the port through its plain version (the
heads as views plus ``mha_reference``) and its autograd function (the
standard forward for o and lse, then the chunked backward).  f32 inputs;
o within atol 1e-5, the gradients within atol 1e-4 (the two backwards sum
in other orders).  K13 itself runs only on a card (``chip_smoke.py`` phase
3 and the ``cuda`` cases of ``tests/test_torch_package.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cullavo_tpu.ops import flash_attention as jfa
from cullavo_tpu_torch import entry as t_entry
from cullavo_tpu_torch.models.llava import llama as t_llama
from cullavo_tpu_torch.models.llava.lora import LoraConfig, init_lora_params
from cullavo_tpu_torch.models.llava.modeling import init_llava_params
from cullavo_tpu_torch.ops import flash_attention as tfa


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


B, H, D = 2, 2, 128


def _packed_inputs(T, S, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, H * D)).astype(np.float32),
            rng.normal(size=(B, S, H * D)).astype(np.float32),
            rng.normal(size=(B, S, H * D)).astype(np.float32),
            rng.normal(size=(B, T, H * D)).astype(np.float32))      # the cotangent


# an aligned T = S and a ragged T (not a multiple of 8) with S > T
CASES = [(40, 40), (37, 45)]


@pytest.mark.parametrize("T,S", CASES, ids=["aligned", "ragged_S_gt_T"])
def test_packed_forward_matches_jax_interpret(T, S):
    q, k, v, _ = _packed_inputs(T, S, seed=T)
    want = np.asarray(jfa.flash_attention_packed(jnp.asarray(q), jnp.asarray(k),
                                                 jnp.asarray(v), H))
    got = tfa.flash_attention_packed(*(torch.from_numpy(a) for a in (q, k, v)), H)
    assert got.shape == (B, T, H * D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # the plain version is the unpacked standard attention on head views
    heads = [tfa._packed_to_heads(torch.from_numpy(a), H) for a in (q, k, v)]
    std = tfa._heads_to_packed(tfa.mha_reference(*heads))
    assert torch.equal(got, std)


@pytest.mark.parametrize("T,S", CASES, ids=["aligned", "ragged_S_gt_T"])
def test_packed_gradients_match_jax_vjp(T, S):
    q, k, v, do = _packed_inputs(T, S, seed=100 + T)
    out, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention_packed(a, b, c, H),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = tfa.flash_attention_packed(tq, tk, tv, H)
    o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out), atol=1e-5)
    for name, t, w in zip("qkv", (tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4, err_msg=name)
    if S > T:   # keys past T are invisible to every query: no gradient reaches them
        assert not tk.grad[:, T:].any() and not tv.grad[:, T:].any()


def test_packed_raises_where_jax_raises():
    x = torch.zeros(1, 8, 2 * 128)
    for bad, match in (((torch.zeros(1, 8, 2 * 64),) * 3 + (2,), "multiple of 128"),
                       ((torch.zeros(1, 8, 3 * 128),) * 3 + (2,), "multiple of 128"),
                       ((x, torch.zeros(1, 7, 256), torch.zeros(1, 7, 256), 2), "S >= T")):
        with pytest.raises(ValueError, match=match):
            tfa.flash_attention_packed(*bad)
        with pytest.raises(ValueError, match=match.split()[0]):
            jfa.flash_attention_packed(*(jnp.asarray(t.numpy()) if torch.is_tensor(t) else t
                                         for t in bad))
    with pytest.raises(ValueError, match="causal=True"):
        tfa.flash_attention_packed(x, x, x, 2, causal=False)
    with pytest.raises(ValueError, match="not \\[B, T, H\\*d\\]"):
        tfa.flash_attention_packed(x, x[0], x[0], 2)
    meta = torch.zeros(1, 8, 256, device="meta")
    n0 = tfa.flash_attention_packed.launches
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention_packed(meta, meta, meta, 2)
    tfa.flash_attention_packed(x, x, x, 2)
    assert tfa.flash_attention_packed.launches == n0      # CPU tensors never count


# ---------------------------------------------------------------------------
# the switch in the LLaMA forward
# ---------------------------------------------------------------------------

LT = 24


@pytest.fixture(scope="module")
def tiny():
    """The smoke model's text tower (hidden 256, two heads of 128, MHA),
    cut to two layers, with r = 4 adapters whose ``b`` is non-zero."""
    cfg = t_entry.smoke_llava_config()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_hidden_layers=2))
    params = init_llava_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lora = init_lora_params(params, cfg, LoraConfig(r=4, alpha=8.0, dropout=0.0),
                            torch.Generator().manual_seed(1))["language_model"]
    g = torch.Generator().manual_seed(2)
    for ab in lora.values():
        ab["b"] = torch.randn(ab["b"].shape, generator=g) * 0.05
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, LT, cfg.text.hidden_size)).astype(np.float32))
    mask = torch.ones((2, LT), dtype=torch.int32)
    mask[1, LT - 5:] = 0
    pos = torch.arange(LT, dtype=torch.int32)[None].expand(2, LT)
    return cfg.text, params["language_model"], lora, x, mask, pos


def _forward(tiny, monkeypatch, packed, **kw):
    cfg, params, lora, x, mask, pos = tiny
    monkeypatch.setenv("CULLAVO_FLASH_PACKED", "1" if packed else "0")
    calls = []
    real = tfa.flash_attention_packed

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(t_llama, "flash_attention_packed", spy)
    out = t_llama.llama_forward(params, cfg, x, mask, pos, **kw)
    return out, calls


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_llama_prefill_packed_equals_unpacked(tiny, monkeypatch, kv_quant):
    """Outputs and the caches a prefill writes are those of the unpacked run."""
    (h0, c0), calls0 = _forward(tiny, monkeypatch, False, prefill_pad_len=32, kv_quant=kv_quant)
    (h1, c1), calls1 = _forward(tiny, monkeypatch, True, prefill_pad_len=32, kv_quant=kv_quant)
    assert calls0 == [] and calls1 == [(2, LT, 256)] * 2          # one per layer
    valid = tiny[4].bool()
    np.testing.assert_allclose(h1[valid].numpy(), h0[valid].numpy(), atol=1e-6)
    assert sorted(c1) == sorted(c0)
    for name in c0:
        assert torch.equal(c1[name], c0[name]), name


def test_llama_training_forward_packed_gradients_equal_unpacked(tiny, monkeypatch):
    """The remat training forward with adapters: loss on the valid rows and
    every gradient (inputs and adapters) within 1e-5 of the unpacked run."""
    cfg, params, lora, x, mask, pos = tiny
    grads = {}
    for packed in (False, True):
        xi = x.clone().requires_grad_(True)
        ad = {t: {k: v.clone().requires_grad_(True) for k, v in ab.items()}
              for t, ab in lora.items()}
        monkeypatch.setenv("CULLAVO_FLASH_PACKED", "1" if packed else "0")
        h, _ = t_llama.llama_forward(params, cfg, xi, mask, pos, lora=ad, lora_scaling=2.0,
                                     remat=True)
        loss = (h[mask.bool()] ** 2).mean()
        leaves = [xi] + [ab[k] for ab in ad.values() for k in ("a", "b")]
        grads[packed] = [loss.detach()] + list(torch.autograd.grad(loss, leaves))
    for a, b in zip(grads[True], grads[False]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_llama_switch_gate_follows_jax(tiny, monkeypatch):
    """GQA (H != KV) and a head dim that is not a multiple of 128 keep the
    standard path under the switch, as JAX's gate does; a cached decode
    never takes it."""
    cfg, params, lora, x, mask, pos = tiny
    monkeypatch.setenv("CULLAVO_FLASH_PACKED", "1")
    calls = []
    monkeypatch.setattr(t_llama, "flash_attention_packed",
                        lambda *a, **k: calls.append(1) or tfa.flash_attention_packed(*a, **k))
    gqa = dataclasses.replace(cfg, num_key_value_heads=1)
    gp = {**params, "layers": {**params["layers"],
                               "k": params["layers"]["k"][..., :128],
                               "v": params["layers"]["v"][..., :128]}}
    t_llama.llama_forward(gp, gqa, x, mask, pos)
    assert calls == []
    t_llama.llama_forward(params, cfg, x, mask, pos, use_flash=False)
    assert calls == []
    t_llama.llama_forward(params, cfg, x, mask, pos)
    assert calls == [1, 1]


@pytest.mark.parametrize("T", [521, 1929, 40])
def test_chunked_backward_takes_jax_chunks_at_a_ragged_T(monkeypatch, T):
    """The backward that the packed gradient (and the standard one) runs
    chunks the query rows as JAX does on its 8-padded T, a ragged T ending in
    a shorter chunk: a prime T no longer falls to chunks of its largest
    divisor (1 row at T = 521, 3 rows at 1929, the first batch of the
    training loop on the card: 643 chunks per layer).  Gradients equal to
    autograd through the plain version within 1e-5."""
    rng = np.random.default_rng(T)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(1, 1, T, 8)).astype(np.float32))
                   for _ in range(4))
    o, lse = tfa.mha_reference(q, k, v, need_lse=True)
    calls = []
    real = tfa._mm_f32
    monkeypatch.setattr(tfa, "_mm_f32", lambda a, b: calls.append(a.shape[2]) or real(a, b))
    got = tfa._flash_bwd(q, k, v, None, None, True, o, lse, do)
    chunks = calls[::5]                         # five products per chunk
    assert sum(chunks) == T and len(chunks) == -(-T // tfa._fit_block(512, -(-T // 8) * 8, 8))
    assert min(chunks[:-1] or chunks) >= 8    # JAX's chunks: 264 rows at 521, 176 at 1929
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(tfa.mha_reference(*leaves), leaves, do)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, err_msg=name)
