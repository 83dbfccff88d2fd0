"""The torch port's planar NF4 half against the JAX package, on the CPU.

Weights and activations are numpy arrays from a seed, handed to both
packages.  The quantizer's codes and scales and the dequantized bf16 weight
are compared bit for bit; the plain version of the fused kernel against the
JAX Pallas kernel in interpret mode (``atol=1e-4`` at f32 inputs: f32 sums in
another order; one bf16 ulp at bf16 inputs); NF4 greedy and speculative
streams of the tiny model token for token.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cullavo_tpu.models.llava import modeling as jm
from cullavo_tpu.models.llava.config import tiny_llava_config as j_tiny
from cullavo_tpu.models.llava.lora import maybe_quantize_base as j_maybe_quantize
from cullavo_tpu.models.llava.lora import quantize_llm_weights as j_quantize
from cullavo_tpu.ops import nf4 as jnf4
from cullavo_tpu_torch.checkpoint.from_jax import (llava_params_from_numpy,
                                                   llava_params_to_numpy)
from cullavo_tpu_torch.models.llava import llama as tllama
from cullavo_tpu_torch.models.llava import modeling as tm
from cullavo_tpu_torch.models.llava.config import tiny_llava_config as t_tiny
from cullavo_tpu_torch.models.llava.lora import maybe_quantize_base as t_maybe_quantize
from cullavo_tpu_torch.models.llava.lora import quantize_llm_weights as t_quantize
from cullavo_tpu_torch.ops import nf4 as tnf4

VOCAB = 128
SHAPES = [(128, 192), (11008, 64)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _weight(K, N, seed, lead=()):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=lead + (K, N)) * K ** -0.5).astype(np.float32)
    w[..., :3, :64] = 0.0          # an all-zero absmax block
    return w


def _planar(K, N, seed):
    w = _weight(K, N, seed)
    return w, jnf4.quantize_linear_planar(jnp.asarray(w)), tnf4.quantize_linear_planar(
        torch.from_numpy(w))


def test_nf4_constants_match_jax():
    np.testing.assert_array_equal(tnf4.NF4_CODE, jnf4.NF4_CODE)
    np.testing.assert_array_equal(tnf4.NF4_MIDPOINTS, jnf4.NF4_MIDPOINTS)
    assert tnf4.BLOCK == jnf4.BLOCK == 64
    assert tnf4._NF4_DEQ_M_THRESHOLD == jnf4._NF4_DEQ_M_THRESHOLD == 512


@pytest.mark.parametrize("K,N", SHAPES)
def test_quantize_linear_planar_bit_equal(K, N):
    """Stacked [2, K, N]: codes and scales equal JAX's device quantizer and
    its numpy one, bit for bit (plane 7 reaches the sign bit of the word)."""
    w = _weight(K, N, 0, lead=(2,))
    tq = tnf4.quantize_linear_planar(torch.from_numpy(w))
    jq = jnf4.quantize_linear_planar(jnp.asarray(w))
    nq = jnf4.quantize_linear_planar_numpy(w)
    assert tq["q4p"].dtype == torch.int32 and tq["scale"].dtype == torch.float32
    assert tuple(tq["q4p"].shape) == (2, K // 8, N) and tuple(tq["scale"].shape) == (2, K, N // 64)
    assert (tq["q4p"] < 0).any()
    for key in ("q4p", "scale"):
        np.testing.assert_array_equal(tq[key].numpy(), np.asarray(jq[key]))
        np.testing.assert_array_equal(tq[key].numpy(), nq[key])
    assert tnf4.is_quantized_planar(tq) and not tnf4.is_quantized_planar(torch.zeros(2))
    with pytest.raises(ValueError, match="planar NF4 needs"):
        tnf4.quantize_linear_planar(torch.zeros(12, 64))
    with pytest.raises(ValueError, match="planar NF4 needs"):
        tnf4.quantize_linear_planar(torch.zeros(16, 32))


@pytest.mark.parametrize("K,N", SHAPES)
def test_dequant_linear_planar_bit_equal(K, N):
    _, jq, tq = _planar(K, N, 1)
    want = np.asarray(jnf4.dequant_linear_planar(jq, K, N, jnp.bfloat16).astype(jnp.float32))
    got = tnf4.dequant_linear_planar(tq)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the wrapper of the dequant kernel takes the plain version on the CPU
    np.testing.assert_array_equal(tnf4.nf4_dequant_planar(tq).float().numpy(), want)
    want32 = np.asarray(jnf4.dequant_linear_planar(jq, K, N, jnp.float32))
    np.testing.assert_array_equal(
        tnf4.dequant_linear_planar(tq, K, N, dtype=torch.float32).numpy(), want32)
    with pytest.raises(ValueError, match="planar NF4 dict is"):
        tnf4.dequant_linear_planar(tq, K + 8, N)


@pytest.mark.parametrize("M", [1, 8, 40])
@pytest.mark.parametrize("K,N", SHAPES)
def test_nf4_linear_planar_plain_matches_pallas_interpret(K, N, M):
    """``_nf4_linear_planar_plain`` (the arithmetic the CUDA kernel follows)
    against the JAX fused kernel in interpret mode, as the JAX package's own
    tests run it on the CPU."""
    _, jq, tq = _planar(K, N, 2)
    x = np.random.default_rng(3 + M).normal(size=(M, K)).astype(np.float32)
    # jitted: one compile of the interpret-mode kernel, not its op-by-op dispatch
    jax_ref = jax.jit(lambda x, q: jnf4.nf4_linear_planar(x, q, K, N))
    want = np.asarray(jax_ref(jnp.asarray(x), jq))
    got = tnf4.nf4_linear_planar(torch.from_numpy(x), tq)       # CPU tensor -> plain version
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want_b = np.asarray(jax_ref(xb, jq).astype(jnp.float32))
    got_b = tnf4._nf4_linear_planar_plain(torch.from_numpy(x).to(torch.bfloat16), tq)
    assert got_b.dtype == torch.bfloat16
    # one bf16 ulp: 2^-8 relative to the larger neighbour, i.e. 2^-7 of the value
    np.testing.assert_allclose(got_b.float().numpy(), want_b, rtol=2.0 ** -7, atol=1e-6)


SHAPES_7B = [(4096, 4096), (4096, 11008), (11008, 4096)]
H100_SMS = 132


@pytest.mark.parametrize("M", [1, 14, 64, 511])
@pytest.mark.parametrize("K,N", SHAPES_7B)
def test_nf4_gemv_plan_covers_k_once_and_fills_one_wave(K, N, M):
    """The launch planner of the fused kernels (K6, K11): every k row in
    exactly one split, at most 8 splits (the kernel's limit) forming the
    grid's first axis, tiles that cover M and N, a workspace of one partial
    tile per CTA, and one wave of CTAs (one per SM) where the shape allows
    it (at M = 511 the 64-token tiles of the widest weight need more); at
    the decode M of the main paths at least 7/8 of the card."""
    plan = tnf4.nf4_gemv_plan(M, K, N, H100_SMS)
    S = plan["splits"]
    assert 1 <= S <= 8 and plan["grid"][0] == S
    assert plan["workspace"] == (plan["ctas"] * 64 * plan["g"] * plan["nt"] if S > 1 else 0)
    rows = np.zeros(K, dtype=int)
    for a, b in plan["k_ranges"]:
        assert 0 <= a < b <= K and a % 64 == 0
        rows[a:b] += 1
    assert len(plan["k_ranges"]) == S and (rows == 1).all()
    nt, g = plan["nt"], plan["g"]
    assert nt in (16, 32, 64) and (nt == 64 or M <= nt) and g in (1, 2, 4)
    assert plan["grid"] == (S, -(-(N // 64) // g), -(-M // nt))
    assert plan["ctas"] == S * plan["grid"][1] * plan["grid"][2]
    fewest = -(-(N // 64) // 4) * -(-M // nt)
    if fewest <= H100_SMS:
        assert plan["ctas"] <= H100_SMS
    else:
        assert plan["ctas"] == fewest
    if M in (14, 64):
        assert plan["ctas"] >= 7 * H100_SMS // 8


@pytest.mark.parametrize("M,K,N,sms", [(0, 4096, 4096, 132), (14, 0, 4096, 132),
                                       (14, 1092, 4096, 132), (14, 4096, 32, 132),
                                       (14, 4096, 4100, 132), (14, 4096, 4096, 0)])
def test_nf4_gemv_plan_refuses_degenerate_shapes(M, K, N, sms):
    with pytest.raises(ValueError, match="no plan"):
        tnf4.nf4_gemv_plan(M, K, N, sms)


@pytest.mark.parametrize("M", [1, 7, 1296, 4536, 4537])
@pytest.mark.parametrize("K", [16, 4096, 11008, 24576])
@pytest.mark.parametrize("resident", [None, 1, 3])
def test_quant_rows_plan_covers_every_row_and_column_once(M, K, resident):
    """K2's planner: every row in exactly one block's walk (block b takes
    rows b, b + blocks, ...), every 16-byte vector of a row in exactly one
    thread's slots (vector t + j * threads), blocks of whole warps within
    the kernel's 512 threads, one instantiation's vectors a thread, and no
    more blocks than rows or than the SMs hold at once; at the greedy
    batch's K = 4096, 2 vectors a thread in 256 threads."""
    plan = tnf4.quant_rows_plan(M, K, H100_SMS, resident)
    vpt, threads, blocks = plan["vpt"], plan["threads"], plan["blocks"]
    assert vpt in tnf4.QUANT_VPT and threads % 32 == 0 and 32 <= threads <= 512
    held = H100_SMS * (resident if resident is not None else 2048 // threads)
    assert blocks == min(M, held)
    rows = np.zeros(M, dtype=int)
    for b in range(blocks):
        rows[b::blocks] += 1
    assert (rows == 1).all()
    nvec = K // 8
    slots = (np.arange(threads)[:, None] + np.arange(vpt)[None, :] * threads).ravel()
    cols = np.bincount(slots[slots < nvec], minlength=nvec)
    assert (cols == 1).all() and threads * vpt < nvec + 32 * vpt
    if K == 4096:
        assert (vpt, threads) == (2, 256)


@pytest.mark.parametrize("M,K", [(0, 4096), (7, 12), (7, 0), (7, 24584)])
def test_quant_rows_plan_refuses_what_the_kernel_cannot_take(M, K):
    with pytest.raises(ValueError, match="quant_rows_plan"):
        tnf4.quant_rows_plan(M, K, H100_SMS)


@pytest.mark.parametrize("M,K,N", [(1, 8, 64), (9, 1096, 320), (700, 4096, 192)])
def test_nf4_gemv_plan_small_and_ragged_shapes(M, K, N):
    """A K of one ring stage takes no split; a width of a few blocks gets
    no more warpgroups than blocks; many token tiles still cover M."""
    plan = tnf4.nf4_gemv_plan(M, K, N, H100_SMS)
    assert plan["splits"] <= plan["n_kst"] == -(-K // 64)
    assert plan["g"] <= N // 64 and plan["nt"] * plan["grid"][2] >= M
    assert plan["ctas"] <= H100_SMS


@pytest.mark.parametrize("M", [1, 8, 14, 56, 64, 511, 5632])
@pytest.mark.parametrize("K,N", SHAPES_7B)
def test_int8_gemv_plan_tiles_and_waves(K, N, M):
    """K3's launch planner (the int8 instantiation of the fused template):
    token tiles of at most 256 that cover M (the smallest that holds M, 256
    beyond), at most 2 blocks per CTA, no split at the prefill M (the grid
    is many waves: no workspace), the split ranges tiling K in 64-k stages,
    and the grid within one wave wherever it splits, at least 7/8 of the
    card there; no split only where a second one would pass a wave."""
    plan = tnf4.int8_gemv_plan(M, K, N, H100_SMS)
    nt, g, S = plan["nt"], plan["g"], plan["splits"]
    assert nt in (16, 32, 64, 128, 256) and nt * plan["grid"][2] >= M
    assert nt == 256 or (M <= nt and (nt == 16 or M > nt // 2))
    assert g == min(2, -(-N // 64))
    assert plan["grid"] == (S, -(-(-(-N // 64)) // g), -(-M // nt))
    rows = np.zeros(K, dtype=int)
    for a, b in plan["k_ranges"]:
        assert 0 <= a < b <= K and a % 64 == 0
        rows[a:b] += 1
    assert len(plan["k_ranges"]) == S and (rows == 1).all()
    if S > 1:
        assert 7 * H100_SMS // 8 <= plan["ctas"] <= H100_SMS
        assert plan["workspace"] == plan["ctas"] * 64 * g * nt
    else:
        assert plan["workspace"] == 0
        assert plan["ctas"] > H100_SMS // 2 or plan["n_kst"] == 1
    if M == 5632:
        assert (nt, g, S) == (256, 2, 1) and plan["ctas"] > H100_SMS


@pytest.mark.parametrize("M,K,N", [(14, 324, 272), (14, 320, 264), (0, 320, 272),
                                   (14, 4, 272)])
def test_int8_gemv_plan_refuses_what_the_kernel_does_not_take(M, K, N):
    """K3 takes K % 8 == 0 (x's rows are a tensor map's 16-byte strides) and
    N % 16 == 0 (any N beyond: the last 64-column block may be ragged)."""
    with pytest.raises(ValueError, match="no plan"):
        tnf4.int8_gemv_plan(M, K, N, H100_SMS)
    assert tnf4.int8_gemv_plan(14, 320, 272, H100_SMS)["grid"][1] == 3   # 5 blocks, 2 a CTA


@pytest.mark.parametrize("M", [1, 8, 13, 64, 600])
@pytest.mark.parametrize("K,N", [(4096, 11008), (1024, 4100), (11008, 4096), (32, 16)])
def test_p32_gemv_plan_covers_k_once_and_fills_at_most_one_wave(K, N, M):
    """K14's launch planner (the packed format of the fused template): the
    word rows K/4 in stages of 64, every word row (so every k = j K/4 + kk)
    in exactly one split, token tiles that cover M, and the grid within one
    wave wherever the token tiles allow (always where it splits), with the
    narrowest blocks a CTA that fit it; at the probe's M = 1, 8 and 64 over
    [4096, 11008] 2 blocks a CTA, no split, 86 CTAs."""
    plan = tnf4.p32_gemv_plan(M, K, N, H100_SMS)
    nt, g, S = plan["nt"], plan["g"], plan["splits"]
    kq = K // 4
    assert plan["n_kst"] == -(-kq // 64) and 1 <= S <= min(8, plan["n_kst"])
    rows = np.zeros(kq, dtype=int)
    for a, b in plan["kq_ranges"]:
        assert 0 <= a < b <= kq and a % 64 == 0
        rows[a:b] += 1
    assert len(plan["kq_ranges"]) == S and (rows == 1).all()
    covered = np.zeros(K, dtype=int)
    for a, b in plan["kq_ranges"]:
        for j in range(4):
            covered[j * kq + a:j * kq + b] += 1
    assert (covered == 1).all()
    assert nt in (16, 32, 64) and nt * plan["grid"][2] >= M and g <= -(-N // 64)
    assert plan["grid"] == (S, -(-(-(-N // 64)) // g), -(-M // nt))
    if S > 1 or -(-M // nt) * -(-N // 256) <= H100_SMS:
        assert plan["ctas"] <= H100_SMS
    assert plan["workspace"] == (plan["ctas"] * 64 * g * nt if S > 1 else 0)
    nb, ntok = -(-N // 64), plan["grid"][2]
    fits = [w for w in (1, 2, 4) if w <= nb and -(-nb // w) * ntok <= H100_SMS]
    assert g == (fits[0] if fits else min(4, nb))
    if (K, N) == (4096, 11008) and M <= 64:
        assert (g, S, plan["ctas"]) == (2, 1, 86)


@pytest.mark.parametrize("M,K,N", [(8, 4100, 11008), (8, 4096, 11006), (8, 4096, 11010),
                                   (0, 4096, 11008), (8, 4, 16), (8, 4096, 0)])
def test_p32_gemv_plan_refuses_what_the_kernel_does_not_take(M, K, N):
    """K14 takes K % 8 == 0 (x's rows are a tensor map's 16-byte strides) and
    N % 4 == 0 (a word row of the weight a multiple of 16 bytes)."""
    with pytest.raises(ValueError, match="no plan"):
        tnf4.p32_gemv_plan(M, K, N, H100_SMS)


def test_nf4_gemv_decode_tables_are_the_bf16_codebook():
    """K6 decodes a nibble by byte permutes against immediates in
    csrc/nf4_gemv_sm90.cu: their bytes are the low and high bytes of
    bf16(NF4_CODE), entry 4 i + q in byte q of word i."""
    import re
    from pathlib import Path

    src = (Path(tnf4.__file__).resolve().parents[1] / "csrc" / "nf4_gemv_sm90.cu").read_text()
    consts = dict(re.findall(r"k(Lo\d|Hi\d) = (0x[0-9a-f]+)u", src))
    bits = torch.from_numpy(tnf4.NF4_CODE).to(torch.bfloat16).view(torch.int16).numpy()
    bits = bits.astype(np.uint16).astype(np.int64)
    for i in range(4):
        for q in range(4):
            lo = (int(consts[f"Lo{i}"], 16) >> (8 * q)) & 0xFF
            hi = (int(consts[f"Hi{i}"], 16) >> (8 * q)) & 0xFF
            assert lo | hi << 8 == bits[4 * i + q]


def test_nf4_linear_planar_auto_both_sides_of_threshold():
    """M = 511 takes the fused kernel's arithmetic, M = 512 the dequant-once
    weight and a bf16 matmul, as in JAX; leading dims fold into M."""
    K, N = 128, 192
    _, jq, tq = _planar(K, N, 4)
    rng = np.random.default_rng(5)
    for M, lead in ((511, (511,)), (512, (2, 256))):
        x = rng.normal(size=lead + (K,)).astype(np.float32)
        got = tnf4.nf4_linear_planar_auto(torch.from_numpy(x), tq)
        want = np.asarray(jnf4.nf4_linear_planar_auto(jnp.asarray(x), jq, K, N))
        assert tuple(got.shape) == lead + (N,) and got.dtype == torch.float32
        if M < 512:
            ref = tnf4._nf4_linear_planar_plain(torch.from_numpy(x), tq)
            np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
        else:
            ref = (torch.from_numpy(x).to(torch.bfloat16)
                   @ tnf4.dequant_linear_planar(tq)).to(torch.float32)
            # a bf16 x bf16 matmul rounded to bf16: one ulp between the two libraries
            np.testing.assert_allclose(got.numpy(), want, rtol=2.0 ** -7, atol=1e-3)
        assert torch.equal(got, ref)


# ---------------------------------------------------------------------------
# the NF4 base of the tiny model
# ---------------------------------------------------------------------------

def _planar_cfg(tiny):
    """Four kv heads of 16: every LLM target of the tiny model is planar
    (with two, k and v have 32 output columns)."""
    cfg = tiny(VOCAB)
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_key_value_heads=4))


@pytest.fixture(scope="module")
def nf4_models():
    jcfg, tcfg = _planar_cfg(j_tiny), _planar_cfg(t_tiny)
    jp = jm.init_llava_params(jcfg, jax.random.PRNGKey(0))
    dense = llava_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jq = j_quantize(jp, bits=4)
    return jcfg, tcfg, jq, dense


def test_quantize_llm_weights_nf4_and_bridge(nf4_models):
    """``quantize_llm_weights(bits=4)`` equals JAX's leaf for leaf, the bridge
    carries planar dicts both ways unchanged, and ``maybe_quantize_base``
    releases each dense target of the tree it is given."""
    jcfg, tcfg, jq, dense = nf4_models
    own = t_quantize(dense, bits=4)
    bridged = llava_params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    for t in ("q", "k", "v", "o", "gate", "up", "down"):
        a, b = own["language_model"]["layers"][t], bridged["language_model"]["layers"][t]
        assert set(a) == set(b) == {"q4p", "scale"}
        assert b["q4p"].dtype == torch.int32 and b["scale"].dtype == torch.float32
        for key in a:
            assert torch.equal(a[key], b[key]), (t, key)
    back = llava_params_to_numpy(bridged)
    for t in ("q", "down"):
        for key in ("q4p", "scale"):
            np.testing.assert_array_equal(back["language_model"]["layers"][t][key],
                                          np.asarray(jq["language_model"]["layers"][t][key]))
    assert torch.equal(own["language_model"]["norm"], dense["language_model"]["norm"])

    lm = dict(dense["language_model"])
    tree = {**dense, "language_model": {**lm, "layers": dict(lm["layers"])}}
    out = t_maybe_quantize(tree, 4)
    assert "q" not in tree["language_model"]["layers"]          # taken out, as JAX donates
    assert torch.equal(out["language_model"]["layers"]["q"]["q4p"],
                       own["language_model"]["layers"]["q"]["q4p"])
    assert t_maybe_quantize(out, 4) is out and t_maybe_quantize(dense, 0) is dense
    jout = j_maybe_quantize(jax.tree.map(jnp.asarray, jax.tree.map(np.asarray, nf4_models[2])), 4)
    assert "q4p" in jout["language_model"]["layers"]["q"]        # JAX: already quantized, no-op


def test_non_planar_target_raises_and_q4_stays_out():
    """The tiny config's k and v are [64, 32]: not planar.  They take the
    byte-packed q4 layout (as the JAX quantizer picks it) instead of staying
    dense; the dict kinds still outside the port raise; so do bits other
    than 4 and 8."""
    cfg = t_tiny(VOCAB)
    params = tm.init_llava_params(cfg, torch.Generator().manual_seed(0), "cpu")
    layers = t_quantize(params, bits=4)["language_model"]["layers"]
    assert sorted(layers["k"]) == sorted(layers["v"]) == ["q4", "scale"]
    assert "q4p" in layers["q"] and "q4p" in layers["down"]
    tnf4.check_slice_kind({"q4": torch.zeros(4, dtype=torch.uint8)})
    with pytest.raises(NotImplementedError, match="q8t"):
        tnf4.check_slice_kind({"q8t": torch.zeros(4, dtype=torch.int8)})
    with pytest.raises(ValueError, match="bits must be"):
        t_quantize(params, bits=3)


def _prompts(cfg, seed, text_lens, bucket):
    rng = np.random.default_rng(seed)
    n_img = cfg.num_image_tokens
    B = len(text_lens)
    ids = np.zeros((B, bucket), np.int32)
    mask = np.zeros((B, bucket), np.int32)
    for b, tl in enumerate(text_lens):
        T = 1 + n_img + tl
        row = rng.integers(3, VOCAB - 2, size=(T,)).astype(np.int32)
        row[1:1 + n_img] = cfg.image_token_id
        ids[b, :T] = row
        mask[b, :T] = 1
    pix = rng.normal(size=(B, 3, cfg.vision.image_size, cfg.vision.image_size)).astype(np.float32)
    return ids, pix, mask


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_nf4_greedy_and_speculative_streams_match_jax(nf4_models, kv_quant):
    """The NF4 base at f32 on the CPU (a dense matmul against the
    dequantized weight, the JAX package's own non-TPU branch): greedy and
    speculative (spec_k 3) streams token-equal to JAX's and to each other."""
    jcfg, tcfg, jq, dense = nf4_models
    tq = t_quantize(dense, bits=4)
    ids, pix, mask = _prompts(tcfg, 7, (3, 9, 6), 1 + tcfg.num_image_tokens + 10)
    n_new, spec_k = 8, 3
    max_len = tllama.round_cache_len(ids.shape[1] + n_new + spec_k)
    jgen = jm.GenerationConfig(max_new_tokens=n_new, do_sample=False, eos_token_id=-1)
    tgen = tm.GenerationConfig(max_new_tokens=n_new, do_sample=False, eos_token_id=-1)

    def j_state():
        return jm.generate_prefill(jq, jcfg, jnp.asarray(ids), jnp.asarray(pix),
                                   jnp.asarray(mask), max_len, compute_dtype=jnp.float32,
                                   kv_quant=kv_quant)

    def t_state():
        return tm.generate_prefill(tq, tcfg, torch.from_numpy(ids), torch.from_numpy(pix),
                                   torch.from_numpy(mask), max_len,
                                   compute_dtype=torch.float32, kv_quant=kv_quant)

    np.testing.assert_allclose(t_state()["logits"].numpy(), np.asarray(j_state()["logits"]),
                               atol=1e-4, rtol=0)
    want = np.asarray(jm.generate_decode(jq, jcfg, j_state(), jgen, compute_dtype=jnp.float32))
    got = tm.generate_decode(tq, tcfg, t_state(), tgen, compute_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(got, want)
    want_s, _ = jm.generate_decode_spec(jq, jcfg, j_state(), jgen, spec_k, jnp.asarray(ids),
                                        jnp.asarray(mask.sum(1)), compute_dtype=jnp.float32)
    got_s, stats = tm.generate_decode_spec(tq, tcfg, t_state(), tgen, spec_k,
                                           torch.from_numpy(ids), torch.from_numpy(mask.sum(1)),
                                           compute_dtype=torch.float32)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_s.numpy(), got)
    assert stats["windows"] >= -(-(n_new - 1) // spec_k)
