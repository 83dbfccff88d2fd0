"""The torch port's byte-packed NF4 formats against the JAX package, on the CPU:
``quantize_linear`` dicts (``q4``, Pallas row 9) and ``NF4Tensor`` (row 8).

Weights and activations are numpy arrays from a seed, handed to both
packages.  Codes and scales are compared bit for bit, and so are the
dequantized weights; the double quantization's offset is an f32 mean, whose
summation order differs between torch and XLA, so it is held within 1e-6
relative and the rest of the double quantization is compared bit for bit from JAX's
offset.  The plain versions of K11 (the port's ``nf4_linear_q4`` and
``nf4_matmul_fused`` on CPU tensors) are held to the JAX Pallas kernels in
interpret mode at f32, within 1e-5 of the output's largest entry (f32 sums
in another order).  The ``cuda`` cases of K11 live in
``tests/test_torch_package.py``, which imports no JAX.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cullavo_tpu.models.llava import modeling as jm
from cullavo_tpu.models.llava.config import tiny_llava_config as j_tiny
from cullavo_tpu.models.llava.lora import LoraConfig as JLoraConfig
from cullavo_tpu.models.llava.lora import init_lora_params as j_init_lora
from cullavo_tpu.models.llava.lora import quantize_llm_weights as j_quantize
from cullavo_tpu.ops import nf4 as jnf4
from cullavo_tpu.ops import nf4_oracle
from cullavo_tpu_torch.checkpoint.from_jax import (llava_params_from_numpy,
                                                   nf4_tensor_from_numpy, nf4_tensor_to_numpy)
from cullavo_tpu_torch.models.llava import modeling as tm
from cullavo_tpu_torch.models.llava.config import tiny_llava_config as t_tiny
from cullavo_tpu_torch.models.llava.lora import LoraConfig as TLoraConfig
from cullavo_tpu_torch.models.llava.lora import init_lora_params as t_init_lora
from cullavo_tpu_torch.models.llava.lora import quantize_llm_weights as t_quantize
from cullavo_tpu_torch.ops import nf4 as tnf4

VOCAB = 128


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _weight(shape, seed, scale=None):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=shape) * (scale or shape[-2] ** -0.5)).astype(np.float32)
    w.reshape(-1)[:64] = 0.0                        # an all-zero absmax block
    w.reshape(-1)[64:128] = np.resize(tnf4.NF4_MIDPOINTS, 64)   # values on the midpoints
    return w


def _close(a, b, rel=1e-5):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    err = np.abs(a - b).max()
    assert err <= rel * max(np.abs(b).max(), 1e-30), (err, np.abs(b).max())


def test_dynamic_map_and_constants_match_jax():
    np.testing.assert_array_equal(tnf4.DYNAMIC_MAP, nf4_oracle.DYNAMIC_MAP)
    np.testing.assert_array_equal(tnf4.DYNAMIC_MIDPOINTS, jnf4.DYNAMIC_MIDPOINTS)
    assert tnf4.ABSMAX_BLOCK == jnf4.ABSMAX_BLOCK == 256


@pytest.mark.parametrize("shape", [(64, 32), (2, 64, 128), (3, 40, 96), (1, 11008, 64)])
def test_quantize_linear_bit_equal(shape):
    """Stacked or not, N a multiple of 64 or not (a block then spans rows):
    the packed bytes and the f32 absmax equal JAX's, bit for bit."""
    w = _weight(shape, 0)
    tq, jq = tnf4.quantize_linear(torch.from_numpy(w)), jnf4.quantize_linear(jnp.asarray(w))
    n = shape[-2] * shape[-1]
    assert tq["q4"].dtype == torch.uint8 and tq["scale"].dtype == torch.float32
    assert tuple(tq["q4"].shape) == shape[:-2] + (n // 2,)
    assert tuple(tq["scale"].shape) == shape[:-2] + (n // 64,)
    for key in ("q4", "scale"):
        np.testing.assert_array_equal(tq[key].numpy(), np.asarray(jq[key]))
    assert tnf4.is_quantized(tq) and not tnf4.is_quantized({"q4p": 0}) and not tnf4.is_quantized(w)


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_dequant_linear_and_nf4_linear_match_jax(dtype):
    """One layer of a stacked q4 dict: the dequantized weight bit-equal, the
    XLA form ``nf4_linear`` (dequant in x's dtype, then the product) equal."""
    w = _weight((2, 96, 64), 1)
    jq = jnf4.quantize_linear(jnp.asarray(w))
    tq = {k: torch.from_numpy(np.array(v)) for k, v in jq.items()}
    j1, t1 = {k: v[1] for k, v in jq.items()}, {k: v[1] for k, v in tq.items()}
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    ref = np.asarray(jnf4.dequant_linear(j1, 96, 64, dtype)).astype(np.float32)
    np.testing.assert_array_equal(tnf4.dequant_linear(t1, 96, 64, tdt).float().numpy(), ref)
    np.testing.assert_array_equal(tnf4.nf4_dequant_q4(t1, 96).float().numpy(),
                                  np.asarray(jnf4.dequant_linear(j1, 96, 64)).astype(np.float32))
    x = np.random.default_rng(2).normal(size=(5, 96)).astype(np.float32)
    jy = np.asarray(jnf4.nf4_linear(jnp.asarray(x, dtype), j1, 96, 64)).astype(np.float32)
    ty = tnf4.nf4_linear(torch.from_numpy(x).to(tdt), t1, 96, 64).float().numpy()
    if dtype == jnp.float32:
        _close(ty, jy)
    else:                           # bf16 products and one bf16 rounding on each side
        np.testing.assert_allclose(ty, jy, rtol=2 ** -7, atol=2 ** -7 * np.abs(jy).max())


@pytest.mark.parametrize("M,K,N", [(1, 64, 64), (14, 128, 256), (37, 96, 320), (600, 64, 128)])
def test_nf4_linear_q4_plain_matches_the_pallas_kernel(M, K, N):
    """Row 9: the port's ``nf4_linear_q4`` on CPU tensors against JAX's
    ``nf4_linear_pallas`` in interpret mode (f32 x), and its ``_auto`` and
    vjp forms."""
    w = _weight((K, N), 3)
    jq = jnf4.quantize_linear(jnp.asarray(w))
    tq = {k: torch.from_numpy(np.array(v)) for k, v in jq.items()}
    x = np.random.default_rng(4).normal(size=(M, K)).astype(np.float32)
    ref = np.asarray(jnf4.nf4_linear_pallas(jnp.asarray(x), jq, K, N))
    xt = torch.from_numpy(x)
    _close(tnf4.nf4_linear_q4(xt, tq, K).numpy(), ref)
    _close(tnf4.nf4_linear_q4(xt, tq, K, N).numpy(), ref)
    _close(tnf4.nf4_linear_fused_vjp(xt, tq, K).detach().numpy(), ref)
    auto = tnf4.nf4_linear_q4_auto(xt, tq, K).numpy()
    if M < 512:
        _close(auto, ref)
    else:       # the card's prefill arithmetic: bf16 weight, bf16 x, one bf16 rounding
        np.testing.assert_allclose(auto, ref, rtol=2 ** -7, atol=2 ** -7 * np.abs(ref).max())
    with pytest.raises(ValueError, match="not \\["):
        tnf4.nf4_linear_q4(xt, tq, K, N + 64)


def test_nf4_linear_fused_vjp_dx_matches_jax():
    """dx = dy @ dequant(q).T, as JAX's custom vjp; no gradient for the
    packed weight (its leaves are integers and frozen scales)."""
    K, N, M = 128, 192, 9
    w = _weight((K, N), 5)
    jq = jnf4.quantize_linear(jnp.asarray(w))
    tq = {k: torch.from_numpy(np.array(v)) for k, v in jq.items()}
    rng = np.random.default_rng(6)
    x, dy = rng.normal(size=(M, K)).astype(np.float32), rng.normal(size=(M, N)).astype(np.float32)
    y, vjp = jax.vjp(lambda a: jnf4.nf4_linear_fused_vjp(a, jq, K, N), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = tnf4.nf4_linear_fused_vjp(xt, tq, K)
    _close(yt.detach().numpy(), np.asarray(y))
    yt.backward(torch.from_numpy(dy))
    _close(xt.grad.numpy(), np.asarray(jdx))


@pytest.mark.parametrize("shape,scale", [((256, 128), None), ((300, 64), 3.0), ((64, 1024), 0.02)])
def test_quantize_nf4_matches_jax(shape, scale):
    """Packed codes and the absmax codes bit-equal; the double-quant offset,
    an f32 mean of a few hundred positive terms that torch and XLA sum in
    other orders, within 1e-6 relative (a few ulps); from JAX's offset, the
    dynamic-map codes and the 256-block scales bit-equal."""
    w = _weight(shape, 7, scale)
    jt, tt = jnf4.quantize_nf4(jnp.asarray(w)), tnf4.quantize_nf4(torch.from_numpy(w))
    np.testing.assert_array_equal(tt.packed.numpy(), np.asarray(jt.packed))
    assert tt.shape == shape and tt.dtype == torch.float32 and tt.absmax.dtype == torch.uint8
    j_off, t_off = np.float32(jt.absmax_offset), np.float32(tt.absmax_offset.item())
    assert abs(j_off - t_off) <= 1e-6 * j_off, (j_off, t_off)
    nd_j = jnf4.quantize_nf4(jnp.asarray(w), double_quant=False)
    nd_t = tnf4.quantize_nf4(torch.from_numpy(w), double_quant=False)
    np.testing.assert_array_equal(nd_t.absmax.numpy(), np.asarray(nd_j.absmax))
    q, ab_scale = tnf4._quantize_absmax(nd_t.absmax, torch.tensor(j_off))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jt.absmax))
    np.testing.assert_array_equal(ab_scale.numpy(), np.asarray(jt.absmax_scale))


@pytest.mark.parametrize("double_quant", [True, False])
def test_dequantize_nf4_and_decode_absmax_match_jax(double_quant):
    """The same NF4Tensor (JAX's, carried across by the bridge) decodes to
    the same absmax and the same dense array in both packages."""
    w = _weight((192, 128), 8)
    jt = jnf4.quantize_nf4(jnp.asarray(w), double_quant=double_quant)
    tt = nf4_tensor_from_numpy(jax.tree.map(np.asarray, jt), "cpu")
    np.testing.assert_array_equal(tnf4._decode_absmax(tt).numpy(),
                                  np.asarray(jnf4._decode_absmax(jt)))
    for jd, td in ((None, None), (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(tnf4.dequantize_nf4(tt, td).float().numpy(),
                                      np.asarray(jnf4.dequantize_nf4(jt, jd)).astype(np.float32))
    x = np.random.default_rng(9).normal(size=(3, 192)).astype(np.float32)
    _close(tnf4.nf4_matmul(torch.from_numpy(x), tt).numpy(),
           np.asarray(jnf4.nf4_matmul(jnp.asarray(x), jt)))
    back = nf4_tensor_to_numpy(tt)
    assert back["shape"] == (192, 128) and back["dtype"] == "float32"
    for key in ("packed", "absmax", "absmax_scale", "absmax_offset"):
        ref = getattr(jt, key)
        assert (back[key] is None) == (ref is None)
        if ref is not None:
            np.testing.assert_array_equal(back[key], np.asarray(ref))


@pytest.mark.parametrize("M,K,N", [(1, 128, 64), (14, 256, 384), (33, 64, 128)])
def test_nf4_matmul_fused_plain_matches_the_pallas_kernel(M, K, N):
    """Row 8: the port's ``nf4_matmul_fused`` on CPU tensors (absmax decoded
    first, f32 product) against JAX's in interpret mode, double-quantized."""
    w = _weight((K, N), 10)
    jt = jnf4.quantize_nf4(jnp.asarray(w))
    tt = nf4_tensor_from_numpy(jax.tree.map(np.asarray, jt), "cpu")
    x = np.random.default_rng(11).normal(size=(M, K)).astype(np.float32)
    # jitted: one compile of the interpret-mode kernel, not its op-by-op dispatch
    ref = np.asarray(jax.jit(jnf4.nf4_matmul_fused)(jnp.asarray(x), jt))
    _close(tnf4.nf4_matmul_fused(torch.from_numpy(x), tt).numpy(), ref)
    with pytest.raises(ValueError, match="must be \\[M"):
        tnf4.nf4_matmul_fused(torch.from_numpy(x[:, :-1]), tt)


def test_quantize_llm_weights_bits4_picks_the_layouts_of_jax():
    """The tiny config's k and v ([64, 32]) take the byte-packed q4 layout,
    the other targets planar NF4: the layouts, codes and scales JAX's
    quantizer gives; the bridge carries the JAX tree across unchanged; LoRA
    adapters take the config's dims for the q4 targets."""
    jcfg, tcfg = j_tiny(VOCAB), t_tiny(VOCAB)
    jp = jm.init_llava_params(jcfg, jax.random.PRNGKey(0))
    jq = jax.tree.map(np.asarray, j_quantize(jp, bits=4))
    tp = llava_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tq = t_quantize(tp, bits=4)
    bridged = llava_params_from_numpy(jq, "cpu")
    for t in ("q", "k", "v", "o", "gate", "up", "down"):
        ref, mine = jq["language_model"]["layers"][t], tq["language_model"]["layers"][t]
        assert sorted(mine) == sorted(ref) == (["q4", "scale"] if t in ("k", "v")
                                               else ["q4p", "scale"]), t
        for key in ref:
            np.testing.assert_array_equal(mine[key].numpy(), ref[key])
            assert torch.equal(bridged["language_model"]["layers"][t][key], mine[key])
    ja = j_init_lora(jq, jcfg, JLoraConfig(r=4), jax.random.PRNGKey(1))
    ta = t_init_lora(tq, tcfg, TLoraConfig(r=4), torch.Generator().manual_seed(1))
    for t, ab in ja["language_model"].items():
        for key in ("a", "b"):
            assert tuple(ta["language_model"][t][key].shape) == ab[key].shape, (t, key)


def test_q4_base_forward_matches_jax():
    """The tiny model over the NF4 base (q4 k/v): prefill logits of the
    port's plain path (``_mm``: dequant in x's dtype, then the product, as
    JAX's ``mm`` on q4 dicts) against JAX's, f32 and bf16 compute."""
    jcfg, tcfg = j_tiny(VOCAB), t_tiny(VOCAB)
    jp = j_quantize(jm.init_llava_params(jcfg, jax.random.PRNGKey(2)), bits=4)
    tp = llava_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(12)
    n_img, T = tcfg.num_image_tokens, 24
    ids = rng.integers(4, VOCAB - 2, size=(2, T)).astype(np.int32)
    ids[:, 1:1 + n_img] = tcfg.image_token_id
    mask = np.ones((2, T), np.int32)
    mask[1, 19:] = 0
    pix = rng.normal(size=(2, 3, 28, 28)).astype(np.float32)
    for jd, td, tol in ((jnp.float32, torch.float32, 1e-4), (jnp.bfloat16, torch.bfloat16, 0.05)):
        st_j = jm.generate_prefill(jp, jcfg, jnp.asarray(ids), jnp.asarray(pix),
                                   jnp.asarray(mask), 32, compute_dtype=jd)
        st_t = tm.generate_prefill(tp, tcfg, torch.from_numpy(ids), torch.from_numpy(pix),
                                   torch.from_numpy(mask), 32, compute_dtype=td)
        a = st_t["logits"].float().numpy()
        b = np.asarray(st_j["logits"], np.float32)
        assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max()), np.abs(a - b).max()
        assert (a.argmax(-1) == b.argmax(-1)).all()


def test_k11_wrappers_take_the_plain_version_only_for_cpu_tensors():
    """On a tensor that is neither on the CPU nor on a card (meta) the
    wrappers raise rather than step down; no launch is counted."""
    w = _weight((64, 128), 13)
    tq = tnf4.quantize_linear(torch.from_numpy(w))
    meta = {k: v.to("meta") for k, v in tq.items()}
    tt = tnf4.quantize_nf4(torch.from_numpy(w))
    tt_meta = tnf4.NF4Tensor(tt.packed.to("meta"), tt.absmax.to("meta"), tt.shape, tt.dtype,
                             tt.absmax_scale.to("meta"), tt.absmax_offset.to("meta"))
    before = (tnf4.nf4_linear_q4.launches, tnf4.nf4_dequant_q4.launches)
    x = torch.randn(3, 64, device="meta")
    for call in (lambda: tnf4.nf4_linear_q4(x, meta, 64), lambda: tnf4.nf4_dequant_q4(meta, 64),
                 lambda: tnf4.nf4_linear_q4_auto(torch.randn(600, 64, device="meta"), meta, 64),
                 lambda: tnf4.nf4_linear_fused_vjp(x, meta, 64),
                 lambda: tnf4.nf4_matmul_fused(x, tt_meta)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    assert (tnf4.nf4_linear_q4.launches, tnf4.nf4_dequant_q4.launches) == before
