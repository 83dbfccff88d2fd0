"""The port's differentiable attention and NF4 linear against the JAX
package on the CPU.

The same numpy inputs from a seed go through ``flash_attention`` of both
packages, value and gradients: the JAX side through its Pallas kernels in
interpret mode with its custom VJP (as ``tests/test_ops.py`` runs them), the
port through ``mha_reference`` and its chunked backward.  f32 inputs,
``atol=1e-5`` for o, dq, dk and dv; the lse against the JAX forward's own
(``_flash_fwd_expanded``).  Shapes are shared between cases so that JAX
compiles few programs.
"""
import numpy as np
import pytest
import torch

import jax
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


B, H, D = 2, 2, 16
ATOL = 1e-5


def _qkv(T, S, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, T, D)).astype(np.float32),
            rng.normal(size=(B, H, S, D)).astype(np.float32),
            rng.normal(size=(B, H, S, D)).astype(np.float32),
            rng.normal(size=(B, H, T, D)).astype(np.float32))      # the cotangent


def _masks(T, S, kind):
    """(q_positions, kv_valid) of a case: None/None for the bias-free
    contract; right padding (row 1 loses its last 5 keys) or left padding
    (row 1 loses its first 5 keys, and its padded queries see no key) with
    positions that continue each row's valid run."""
    if kind == "biasfree":
        return None, None
    valid = np.ones((B, S), np.int32)
    if kind == "right":
        valid[1, S - 5:] = 0
    elif kind == "left":
        valid[1, :5] = 0
    pos = np.maximum(np.cumsum(valid, axis=1) - 1, 0)[:, S - T:].astype(np.int32)
    if kind == "left":
        # key j sits at index j: a query of the valid run sees indices <= its own
        pos = np.where(valid[:, S - T:] != 0, np.arange(S - T, S)[None], -1).astype(np.int32)
    return pos, valid


CASES = [
    # name, T, S, mask kind, causal
    ("biasfree", 128, 128, "biasfree", True),
    ("right_padded", 128, 128, "right", True),
    ("left_padded", 128, 128, "left", True),
    ("s_gt_t", 128, 256, "right", True),
    ("s_gt_t_implicit", 128, 256, "biasfree", True),
    ("noncausal", 128, 128, "right", False),
    ("noncausal_unmasked", 128, 128, "biasfree", False),
]


def _both(T, S, kind, causal, seed=0):
    q, k, v, do = _qkv(T, S, seed)
    pos, valid = _masks(T, S, kind)
    jargs = [None if a is None else jnp.asarray(a) for a in (pos, valid)]

    def jf(q, k, v):
        return jfa.flash_attention(q, k, v, *jargs, causal=causal, block_q=64, block_k=64)

    @jax.jit
    def jax_ref(q, k, v, do):
        """Value, vjp and lse in one compile (the Pallas kernels in interpret
        mode, without their op-by-op dispatch)."""
        jo, vjp = jax.vjp(jf, q, k, v)
        _, jlse, _, _ = jfa._flash_fwd_expanded(q, k, v, *jargs, causal, 64, 64,
                                                need_lse=True)
        return jo, vjp(do), jlse

    jo, jg, jlse = jax_ref(*map(jnp.asarray, (q, k, v, do)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    targs = [None if a is None else torch.from_numpy(a) for a in (pos, valid)]
    to = tfa.flash_attention(tq, tk, tv, *targs, causal=causal)
    tg = torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(do))
    _, tlse = tfa.mha_reference(tq.detach(), tk.detach(), tv.detach(), causal, *targs,
                                need_lse=True)
    return (np.asarray(jo), [np.asarray(g) for g in jg], np.asarray(jlse),
            to.detach().numpy(), [g.numpy() for g in tg], tlse.numpy(), (pos, valid))


@pytest.mark.parametrize("name,T,S,kind,causal", CASES, ids=[c[0] for c in CASES])
def test_flash_attention_value_lse_and_gradients_match_jax(name, T, S, kind, causal):
    jo, jg, jlse, to, tg, tlse, (pos, valid) = _both(T, S, kind, causal)
    np.testing.assert_allclose(to, jo, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tlse, jlse, atol=ATOL, rtol=1e-6)
    for g_t, g_j, which in zip(tg, jg, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g_t, g_j, atol=ATOL, rtol=0, err_msg=which)
    if kind == "left" and causal:
        # the wholly masked rows: p = 1 on every key, so the mean of v and
        # lse = NEG_INF + log S; no gradient from or to them
        rows = np.nonzero(pos[1] < 0)[0]
        assert len(rows) == 5
        _, _, v, _ = _qkv(T, S, 0)
        np.testing.assert_allclose(to[1][:, rows], np.broadcast_to(
            v[1].mean(axis=1, keepdims=True), to[1][:, rows].shape), atol=ATOL)
        assert (tlse[1][:, rows] <= -1e29).all() and (jlse[1][:, rows] <= -1e29).all()
        assert not tg[0][1][:, rows].any()
    if valid is not None:
        # masked keys get exactly no gradient
        dead = valid[1] == 0
        assert not tg[1][1][:, dead].any() and not tg[2][1][:, dead].any()


def test_flash_attention_ragged_lengths_match_jax():
    """T and S that are no multiple of any tile: the JAX function pads to
    128 internally, the port takes them as they are."""
    jo, jg, _, to, tg, _, _ = _both(40, 72, "right", True, seed=3)
    np.testing.assert_allclose(to, jo, atol=ATOL, rtol=0)
    for g_t, g_j in zip(tg, jg):
        np.testing.assert_allclose(g_t, g_j, atol=ATOL, rtol=0)


def test_flash_attention_bf16_operands_backward_is_close_to_f32():
    """bf16 inputs: the backward's dots take bf16 operands with f32 sums (P
    and dS rounded to bf16); against the f32 gradients within 3e-2 of the
    largest entry."""
    q, k, v, do = _qkv(64, 64, 5)
    grads = []
    for dt in (torch.float32, torch.bfloat16):
        leaves = [torch.from_numpy(a).to(dt).requires_grad_(True) for a in (q, k, v)]
        out = tfa.flash_attention(*leaves)
        assert out.dtype == dt
        grads.append([g.float() for g in torch.autograd.grad(out, leaves,
                                                             torch.from_numpy(do).to(dt))])
    for a, b in zip(*grads):
        assert (a - b).abs().max() <= 3e-2 * a.abs().max()


def test_flash_attention_without_grad_saves_nothing_and_checks_shapes():
    q, k, v, _ = _qkv(8, 8, 6)
    out = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)))
    assert out.grad_fn is None and not out.requires_grad
    with pytest.raises(ValueError, match="q_positions must be"):
        tfa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                            q_positions=torch.zeros(B, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention(*(torch.from_numpy(a).to("meta") for a in (q, k, v)))
    with pytest.raises(ValueError, match="are not"):
        tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)[:, :1])


def test_fit_block_matches_jax():
    for pref, T, step in ((512, 1024, 8), (512, 648, 8), (512, 2000, 8), (384, 1024, 128),
                          (512, 7, 8), (512, 40, 8), (16, 37, 8)):
        assert tfa._fit_block(pref, T, step) == jfa._fit_block(pref, T, step)


@pytest.mark.parametrize("M", [6, 520])
def test_nf4_linear_planar_vjp_value_and_dx_match_jax(M):
    """Both sides of the M = 512 threshold.  f32 x: off the TPU the JAX
    function's backward is ``dy @ dequant(q).T`` in dy's dtype, and the
    model's forward off the TPU is the dense dequantized matmul, which is
    what the port runs on CPU tensors."""
    K, N = 64, 128
    rng = np.random.default_rng(7)
    w = (rng.normal(size=(K, N)) * K ** -0.5).astype(np.float32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    dy = rng.normal(size=(M, N)).astype(np.float32)
    jq = jnf4.quantize_linear_planar(jnp.asarray(w))
    tq = {k: torch.from_numpy(np.array(a)) for k, a in jq.items()}
    _, vjp = jax.vjp(lambda x: jnf4.nf4_linear_planar_vjp(x, jq, K, N), jnp.asarray(x))
    jdx = np.asarray(vjp(jnp.asarray(dy))[0])
    jy = np.asarray(jnp.asarray(x) @ jnf4.dequant_linear_planar(jq, K, N, dtype=jnp.float32))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tnf4.nf4_linear_planar_vjp(tx, tq)
    tdx, = torch.autograd.grad(ty, tx, torch.from_numpy(dy))
    np.testing.assert_allclose(ty.detach().numpy(), jy, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tdx.numpy(), jdx, atol=1e-5, rtol=1e-5)
    assert not any(t.requires_grad for t in tq.values())
