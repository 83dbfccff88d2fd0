"""The torch port's int8 KV quantizer and W-window decode attention against
the JAX package.

Inputs are made with numpy from a seed and fed to both; JAX runs on the CPU
as its own tests run it (the Pallas cache kernels of ``ops/wwin_decode.py``
in interpret mode).  On the CPU the port's wrappers take the plain versions
of their CUDA kernels; the kernels themselves are compared with those plain
versions on a card in ``tests/test_torch_package.py`` (marked ``cuda``).
Float comparisons are at f32 with ``atol = rtol = 3e-5``: same math, another
association of the sums (per-slice softmax, flash partials merged later).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cullavo_tpu.models.llava import llama as jl
from cullavo_tpu.ops import wwin_decode as jw
from cullavo_tpu_torch.models.llava import llama as tl
from cullavo_tpu_torch.ops import wwin_decode as tw

TOL = dict(atol=3e-5, rtol=3e-5)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jit_ref(fn, *args, **kw):
    """One jitted call of a JAX reference: the array arguments traced, the
    rest (layer index, keywords) fixed; one compile of the interpret-mode
    kernel instead of its op-by-op dispatch (the same values)."""
    where = [i for i, a in enumerate(args) if isinstance(a, (np.ndarray, jax.Array))]

    def call(*traced):
        full = list(args)
        for i, t in zip(where, traced):
            full[i] = t
        return fn(*full, **kw)

    return jax.jit(call)(*(args[i] for i in where))


def _t(a):
    """numpy / JAX array -> torch tensor (bf16 through its raw bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _setup(W, B=2, L=3, S=256, KV=2, n_rep=1, hd=128, seed=0):
    """Stacked cache, fresh window and a per-row key-validity bias."""
    rng = np.random.default_rng(seed)
    H = KV * n_rep

    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)

    kc, vc = f32(L, S, B, KV, hd), f32(L, S, B, KV, hd)
    q, k_cur, v_cur = f32(B, H, W, hd), f32(B, H, W, hd), f32(B, H, W, hd)
    n_valid = np.array([S - 7, S // 2] * (B // 2 + 1))[:B]
    bias = np.zeros((B, 1, W, S), np.float32)
    for b in range(B):
        bias[b, :, :, n_valid[b]:] = jl.NEG_INF
    return kc, vc, q, k_cur, v_cur, bias


def _win_q8(k_cur, v_cur, n_rep):
    """The window's quantized k/v [W, B, KV, hd] (before the head repeat)."""
    k_w = np.ascontiguousarray(k_cur[:, ::n_rep].transpose(2, 0, 1, 3))
    v_w = np.ascontiguousarray(v_cur[:, ::n_rep].transpose(2, 0, 1, 3))
    return k_w, v_w


@pytest.mark.parametrize("seed,shape", [(0, (5, 3, 2, 128)), (1, (7, 2, 4, 8)), (2, (3, 64))])
def test_quantize_kv_bit_equal(seed, shape):
    rng = np.random.default_rng(seed)
    spread = rng.uniform(0.01, 30.0, size=shape[:-1] + (1,))
    x = (rng.normal(size=shape) * spread).astype(np.float32)
    x[0, 0] = 0.0                                  # an all-zero vector: the 1e-8 floor
    x.reshape(-1)[5] = 2.5 * np.abs(x).max()       # a clear row maximum
    jq, js = jl.quantize_kv(jnp.asarray(x))
    tq, ts = tl.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.view(torch.int16).numpy(), np.asarray(js).view(np.int16))
    # bf16 input, as the decode path feeds it
    xb = jnp.asarray(x, jnp.bfloat16)
    jq, js = jl.quantize_kv(xb)
    tq, ts = tl.quantize_kv(_t(xb))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.view(torch.int16).numpy(), np.asarray(js).view(np.int16))


def test_round_cache_len_and_init_kv_cache_match_jax():
    from cullavo_tpu.models.llava.config import tiny_llava_config as j_tiny
    from cullavo_tpu_torch.models.llava.config import tiny_llava_config as t_tiny

    for n in (1, 127, 128, 129, 668, 768):
        assert tl.round_cache_len(n) == jl.round_cache_len(n)
    for kv_quant in (None, "int8"):
        jc = jl.init_kv_cache(j_tiny(64).text, 3, 10, jnp.float32, kv_quant)
        tc = tl.init_kv_cache(t_tiny(64).text, 3, 10, torch.float32, kv_quant)
        assert sorted(jc) == sorted(tc)
        for name in jc:
            assert tuple(tc[name].shape) == jc[name].shape, name
            assert str(tc[name].dtype).split(".")[1] == jc[name].dtype.name, name
            assert not tc[name].any()
    with pytest.raises(ValueError, match="kv_quant"):
        tl.init_kv_cache(t_tiny(64).text, 1, 4, kv_quant="fp8")


@pytest.mark.parametrize("n_rep", [1, 2])
@pytest.mark.parametrize("W", [1, 2, 4, 8])
def test_plain_stale_attention_matches_jax(W, n_rep):
    """``sdpa_decode_stale_smajor`` on a per-layer cache slice."""
    kc, vc, q, k_cur, v_cur, bias = _setup(W, n_rep=n_rep, S=96, hd=16, seed=W)
    ref = _jit_ref(jl.sdpa_decode_stale_smajor,
                   *map(jnp.asarray, (q, kc[1], vc[1], k_cur, v_cur, bias)), n_rep=n_rep)
    out = tl.sdpa_decode_stale_smajor(*map(_t, (q, kc[1], vc[1], k_cur, v_cur, bias)),
                                      n_rep=n_rep)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("with_win_q8", [False, True])
@pytest.mark.parametrize("n_rep", [1, 2])
@pytest.mark.parametrize("W", [1, 2, 4, 8])
def test_plain_stale_attention_q8_matches_jax(W, n_rep, with_win_q8):
    """``sdpa_decode_stale_smajor_q8`` on a per-layer int8 slice, with and
    without the window's quantized k/v."""
    kc, vc, q, k_cur, v_cur, bias = _setup(W, n_rep=n_rep, S=96, hd=16, seed=10 + W)
    # the fresh k/v arrive repeated to H heads: make the repeats identical
    k_cur, v_cur = (np.repeat(x[:, ::n_rep], n_rep, axis=1) for x in (k_cur, v_cur))
    kq, ks = jl.quantize_kv(jnp.asarray(kc[0]))
    vq, vs = jl.quantize_kv(jnp.asarray(vc[0]))
    jwin = twin = None
    if with_win_q8:
        k_w, v_w = _win_q8(k_cur, v_cur, n_rep)
        jwin = (*jl.quantize_kv(jnp.asarray(k_w)), *jl.quantize_kv(jnp.asarray(v_w)))
        twin = tuple(_t(a) for a in jwin)
    ref = _jit_ref(jl.sdpa_decode_stale_smajor_q8, jnp.asarray(q), kq, ks, vq, vs,
                   jnp.asarray(k_cur), jnp.asarray(v_cur), jnp.asarray(bias), n_rep=n_rep,
                   win_q8=jwin)
    out = tl.sdpa_decode_stale_smajor_q8(_t(q), *map(_t, (kq, ks, vq, vs)), _t(k_cur), _t(v_cur),
                                         _t(bias), n_rep=n_rep, win_q8=twin)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("W,n_rep", [(1, 1), (2, 1), (4, 1), (8, 1), (3, 2), (4, 4)])
def test_wwin_bf16_cache_matches_jax_pallas(W, n_rep):
    """The port's ``wwin_decode_smajor`` (plain cache part + merge) against
    the JAX function through its Pallas kernel (interpret mode) and against
    the port's own per-slice plain attention."""
    kc, vc, q, k_cur, v_cur, bias = _setup(W, n_rep=n_rep)
    for li in (0, kc.shape[0] - 1):
        ref = _jit_ref(jw.wwin_decode_smajor, *map(jnp.asarray, (q, kc, vc)), li,
                       *map(jnp.asarray, (k_cur, v_cur, bias)), n_rep=n_rep)
        out = tw.wwin_decode_smajor(_t(q), _t(kc), _t(vc), li, _t(k_cur), _t(v_cur), _t(bias),
                                    n_rep=n_rep)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL, err_msg=f"li={li}")
        own = tl.sdpa_decode_stale_smajor(_t(q), _t(kc[li]), _t(vc[li]), _t(k_cur), _t(v_cur),
                                          _t(bias), n_rep=n_rep)
        np.testing.assert_allclose(out.numpy(), own.numpy(), **TOL, err_msg=f"li={li}")


@pytest.mark.parametrize("W,n_rep,S", [(32, 1, 256), (64, 2, 256), (128, 1, 128), (1, 1, 40),
                                       (8, 1, 200), (1, 4, 200)],
                         ids=["two_row_tiles", "wide_gqa", "widest", "below_one_stage",
                              "ragged_s", "greedy_gqa"])
def test_wwin_bf16_cache_at_the_kernel_edges_matches_jax_pallas(W, n_rep, S):
    """The shapes that reach K4's other bodies and edges
    (``csrc/wwin_decode_sm90.cu``): the suffix prefills' wide windows (R =
    32 and 128 rows on the mma body's 2- and 4-tile blocks, W = 128 its
    widest), S below one 64-slot stage, a ragged S, GQA at W = 1; the port
    against the JAX function through its Pallas kernel (interpret mode, one
    block of S where S is not a multiple of 128)."""
    kc, vc, q, k_cur, v_cur, bias = _setup(W, n_rep=n_rep, S=S, L=2, seed=W + S)
    block_s = 128 if S % 128 == 0 else S
    ref = _jit_ref(jw.wwin_decode_smajor, *map(jnp.asarray, (q, kc, vc)), 1,
                   *map(jnp.asarray, (k_cur, v_cur, bias)), n_rep=n_rep, block_s=block_s)
    out = tw.wwin_decode_smajor(_t(q), _t(kc), _t(vc), 1, _t(k_cur), _t(v_cur), _t(bias),
                                n_rep=n_rep)
    assert out.shape == (2, n_rep * 2, W, 128)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("W,n_rep,S", [(32, 1, 256), (64, 2, 256), (128, 1, 128), (1, 1, 40),
                                       (8, 1, 200), (1, 4, 200)],
                         ids=["two_row_tiles", "wide_gqa", "widest", "below_one_stage",
                              "ragged_s", "greedy_gqa"])
def test_wwin_q8_cache_at_the_kernel_edges_matches_jax_pallas(W, n_rep, S):
    """K5 now runs on K4's two bodies (``csrc/wwin_decode_sm90.cu``), so it
    meets their edges: the int8 cache at K4's edge shapes, the port against
    the JAX function through ``_cache_kernel_q8`` (interpret mode, one block
    of S where S is not a multiple of 128)."""
    kc, vc, q, k_cur, v_cur, bias = _setup(W, n_rep=n_rep, S=S, L=2, seed=W + S + 1)
    kq, ks = jl.quantize_kv(jnp.asarray(kc))
    vq, vs = jl.quantize_kv(jnp.asarray(vc))
    block_s = 128 if S % 128 == 0 else S
    ref = _jit_ref(jw.wwin_decode_smajor_q8, jnp.asarray(q), kq, ks, vq, vs, 1,
                   jnp.asarray(k_cur), jnp.asarray(v_cur), jnp.asarray(bias), n_rep=n_rep,
                   block_s=block_s)
    out = tw.wwin_decode_smajor_q8(_t(q), *map(_t, (kq, ks, vq, vs)), 1, _t(k_cur), _t(v_cur),
                                   _t(bias), n_rep=n_rep)
    assert out.shape == (2, n_rep * 2, W, 128)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_wwin_fully_masked_cache_row_matches_jax_pallas():
    """A row whose cache is wholly invalid takes everything from the self
    window (a masked block must not count exp(0) = 1 per slot), and the
    cache part reports it as m = NEG_INF, l = 0, acc = 0."""
    kc, vc, q, k_cur, v_cur, bias = _setup(4)
    bias[1] = jl.NEG_INF
    ref = _jit_ref(jw.wwin_decode_smajor, *map(jnp.asarray, (q, kc, vc)), 1,
                   *map(jnp.asarray, (k_cur, v_cur, bias)))
    out = tw.wwin_decode_smajor(_t(q), _t(kc), _t(vc), 1, _t(k_cur), _t(v_cur), _t(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert torch.isfinite(out).all()
    acc, m, l = tw._cache_part_plain(_t(q), _t(kc), _t(vc), 1, _t(bias)[:, 0], 1, 128 ** -0.5)
    assert not acc[1].any() and not l[1].any()
    assert (m[1] == torch.tensor(tw.NEG_INF, dtype=torch.float32)).all()
    assert (l[0] > 0).all()


@pytest.mark.parametrize("with_win_q8", [False, True])
@pytest.mark.parametrize("W,n_rep", [(1, 1), (4, 1), (4, 2)])
def test_wwin_q8_cache_matches_jax_pallas(W, n_rep, with_win_q8):
    """``wwin_decode_smajor_q8`` against the JAX function through
    ``_cache_kernel_q8`` (interpret mode), GQA and ``win_q8`` included."""
    kc, vc, q, k_cur, v_cur, bias = _setup(W, n_rep=n_rep, seed=3)
    k_cur, v_cur = (np.repeat(x[:, ::n_rep], n_rep, axis=1) for x in (k_cur, v_cur))
    kq, ks = jl.quantize_kv(jnp.asarray(kc))
    vq, vs = jl.quantize_kv(jnp.asarray(vc))
    jwin = twin = None
    if with_win_q8:
        k_w, v_w = _win_q8(k_cur, v_cur, n_rep)
        jwin = (*jl.quantize_kv(jnp.asarray(k_w)), *jl.quantize_kv(jnp.asarray(v_w)))
        twin = tuple(_t(a) for a in jwin)
    li = 2
    ref = _jit_ref(jw.wwin_decode_smajor_q8, jnp.asarray(q), kq, ks, vq, vs, li,
                   jnp.asarray(k_cur), jnp.asarray(v_cur), jnp.asarray(bias), n_rep=n_rep,
                   win_q8=jwin)
    out = tw.wwin_decode_smajor_q8(_t(q), *map(_t, (kq, ks, vq, vs)), li, _t(k_cur), _t(v_cur),
                                   _t(bias), n_rep=n_rep, win_q8=twin)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    own = tl.sdpa_decode_stale_smajor_q8(_t(q), *(_t(a[li]) for a in (kq, ks, vq, vs)),
                                         _t(k_cur), _t(v_cur), _t(bias), n_rep=n_rep,
                                         win_q8=twin)
    np.testing.assert_allclose(out.numpy(), own.numpy(), **TOL)


def test_window_attention_matches_sequential_int8_cache():
    """The ``win_q8`` contract in the port: query i of a verification window
    over an int8 cache must see draft keys/values j < i exactly as a
    sequential step reads them back from the cache (int8 + folded scale),
    its own k/v at full precision."""
    rng = np.random.default_rng(7)
    B, H, KV, hd, S0, W = 2, 4, 2, 8, 6, 3
    S, n_rep = S0 + W, H // KV

    def f32(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    kq0, ks0 = tl.quantize_kv(f32(S0, B, KV, hd))
    vq0, vs0 = tl.quantize_kv(f32(S0, B, KV, hd))
    q, k_w, v_w = f32(B, H, W, hd), f32(W, B, KV, hd), f32(W, B, KV, hd)
    kwq, kws = tl.quantize_kv(k_w)
    vwq, vws = tl.quantize_kv(v_w)

    def pad(kq, ks, vq, vs):
        z = torch.zeros((S - kq.shape[0], B, KV, hd), dtype=torch.int8)
        zs = torch.zeros((S - ks.shape[0], B, KV), dtype=torch.bfloat16)
        return torch.cat([kq, z]), torch.cat([ks, zs]), torch.cat([vq, z]), torch.cat([vs, zs])

    def rep(x):
        return torch.repeat_interleave(x.permute(1, 2, 0, 3), n_rep, dim=1)   # [B, H, W, hd]

    def bias_upto(n):
        return torch.where(torch.arange(S)[None, None, None, :] < n, 0.0, tl.NEG_INF)

    out_win = tl.sdpa_decode_stale_smajor_q8(q, *pad(kq0, ks0, vq0, vs0), rep(k_w), rep(v_w),
                                             bias_upto(S0), n_rep=n_rep,
                                             win_q8=(kwq, kws, vwq, vws))
    for i in range(W):
        cache_i = pad(torch.cat([kq0, kwq[:i]]), torch.cat([ks0, kws[:i]]),
                      torch.cat([vq0, vwq[:i]]), torch.cat([vs0, vws[:i]]))
        out_i = tl.sdpa_decode_stale_smajor_q8(q[:, :, i:i + 1], *cache_i, rep(k_w[i:i + 1]),
                                               rep(v_w[i:i + 1]), bias_upto(S0 + i), n_rep=n_rep)
        np.testing.assert_allclose(out_win[:, :, i].numpy(), out_i[:, :, 0].numpy(),
                                   atol=2e-5, rtol=0)


def test_write_window_drops_out_of_range_rows():
    """Per-row cache writes: a slot past the end is skipped, never clamped
    into a live slot; in-range rows land where the scalar form puts them."""
    rng = np.random.default_rng(8)
    L, S, B, KV, hd, T = 2, 10, 4, 2, 4, 3
    base = torch.from_numpy(rng.normal(size=(L, S, B, KV, hd)).astype(np.float32))
    new = torch.from_numpy(rng.normal(size=(T, B, KV, hd)).astype(np.float32))
    idx = torch.tensor([2, 8, 10, 7], dtype=torch.int32)      # row 1: one slot dropped; row 2: all
    buf = base.clone()
    tl._write_window(buf, 1, idx, new)
    want = base.clone()
    for b, i in enumerate(idx.tolist()):
        for j in range(T):
            if i + j < S:
                want[1, i + j, b] = new[j, b]
    assert torch.equal(buf, want)
    slab = base.clone()
    tl._write_window(slab, 0, 4, new)
    assert torch.equal(slab[0, 4:7], new) and torch.equal(slab[1], base[1])
    planes = torch.zeros((L, S, B, KV), dtype=torch.bfloat16)
    tl._write_window(planes, 0, idx, torch.ones((T, B, KV), dtype=torch.bfloat16))
    assert planes[0].sum().item() == KV * (3 + 2 + 0 + 3)
