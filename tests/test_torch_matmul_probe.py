"""The port's decode-shaped matmul probe (``cullavo_tpu_torch/scripts/
matmul_probe.py``, the counterpart of ``scripts/matmul_probe.py``) on the
CPU: the int32 packing of Pallas row 16 bit for bit, the plain p32 product
against the dense product on the unpacked weight, and the probe's run.

JAX's ``conv_p32`` and ``p32_kernel`` are closures inside the script's
``main()``, which also times every variant on whatever JAX backend it
finds: they cannot be imported on their own.  So the test restates the
script's packing in numpy (its lines 131-134) and holds the port to that;
K14 itself runs only on a card (``chip_smoke.py`` phases 3 and 13 and the
``cuda`` cases of ``tests/test_torch_package.py``).
"""
import json

import numpy as np
import pytest
import torch

from cullavo_tpu_torch.scripts import matmul_probe as mp

K, N = 4096, 11008


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_pack(w8: np.ndarray) -> np.ndarray:
    """The JAX script's packing: int32 bytes, word row i byte j = row j*K/4 + i."""
    kq = w8.shape[-2] // 4
    b = np.asarray(w8, dtype=np.int32) & 0xFF
    return (b[..., 0 * kq:1 * kq, :] | (b[..., 1 * kq:2 * kq, :] << 8)
            | (b[..., 2 * kq:3 * kq, :] << 16) | (b[..., 3 * kq:4 * kq, :] << 24)).astype(np.int32)


@pytest.fixture(scope="module")
def weight():
    rng = np.random.default_rng(0)
    w8 = rng.integers(-127, 128, size=(K, N), dtype=np.int8)
    w8[:4, :4] = np.array([[-128, -1, 0, 127]], np.int8)   # the extremes of the byte
    return w8


@pytest.mark.parametrize("shape", [(K, N), (2, 64, 24)], ids=["7b_mlp", "stacked_small"])
def test_pack_p32_is_the_scripts_packing_bit_for_bit(weight, shape):
    w8 = weight if shape == (K, N) else np.random.default_rng(1).integers(
        -128, 128, size=shape, dtype=np.int8)
    got = mp.pack_p32(torch.from_numpy(w8))
    assert got.dtype == torch.int32 and got.shape == shape[:-2] + (shape[-2] // 4, shape[-1])
    assert np.array_equal(got.numpy(), _np_pack(w8))
    # each byte restores the weight: (b ^ 0x80) - 0x80
    kq = shape[-2] // 4
    for j in range(4):
        b = (got >> (8 * j)) & 0xFF
        assert torch.equal(((b ^ 0x80) - 0x80).to(torch.int8),
                           torch.from_numpy(w8[..., j * kq:(j + 1) * kq, :]))


@pytest.mark.parametrize("M", [1, 8])
def test_plain_p32_is_the_dense_product_within_bf16_rounding(weight, M):
    rng = np.random.default_rng(2 + M)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(torch.bfloat16)
    scale = torch.from_numpy(rng.random(N).astype(np.float32) * 0.01)
    w32 = mp.pack_p32(torch.from_numpy(weight))
    got = mp.p32_linear_plain(x, w32, scale)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    dense = (x.double() @ torch.from_numpy(weight).double()) * scale.double()
    # one bf16 rounding of the result (2^-8 relative) over f32 sums
    np.testing.assert_allclose(got.double().numpy(), dense.numpy(),
                               rtol=2 ** -8, atol=1e-6 * dense.abs().max().item())
    n0 = mp.p32_linear.launches
    assert torch.equal(mp.p32_linear(x, w32, scale), got)     # the wrapper on a CPU tensor
    assert mp.p32_linear.launches == n0


def test_probe_runs_every_variant_on_the_cpu(capsys):
    rows = mp.main(device="cpu", L=2, p32=True)
    names = ["conv", "conv_pre", "conv_t", "s8s8", "conv_p32_xla", "p32_pallas", "bf16"]
    assert [r["variant"] for r in rows] == names
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["variant"] for r in printed] == names
    for r in rows:
        assert r["M"] == 8 and r["layers"] == 2 and r["ms_per_dot"] > 0 and r["gb_per_s"] > 0
        assert {"variant", "ms_per_dot", "gb_per_s", "M", "layers"} <= set(r)
        assert r["parity_rel_err"] <= mp.PARITY_TOL
    assert [r["variant"] for r in mp.main(device="cpu", M=3, L=1, p32=False)] == [
        "conv", "conv_pre", "conv_t", "s8s8", "bf16"]


def test_probe_raises_on_a_parity_fault_and_without_a_card(monkeypatch):
    wrapper = mp.p32_linear
    meta = torch.zeros(2, 16, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(meta, meta, meta)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mp.main()
    monkeypatch.setattr(mp, "p32_linear", lambda x, w, s: mp.p32_linear_plain(x, w, s) * 2)
    with pytest.raises(RuntimeError, match="p32_pallas differs from conv"):
        mp.main(device="cpu", L=1, p32=True)
