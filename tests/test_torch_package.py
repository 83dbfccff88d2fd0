"""Guards on the torch port as a package: it imports neither JAX nor the JAX
package, its kernel wrappers never launch (or count) on CPU tensors, it
carries no library or compiled stand-in for its kernels, and the chip smoke
script refuses to run without a CUDA device.  The tests marked ``cuda``
compare each CUDA kernel with its plain version on a card; this file
imports no JAX, so on the machine with the card they run with
``python -m pytest tests/test_torch_package.py -m cuda --noconftest``."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "cullavo_tpu_torch"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SLICE_MODULES = (
    "cullavo_tpu_torch._build",
    "cullavo_tpu_torch.ops.nf4",
    "cullavo_tpu_torch.ops.flash_attention",
    "cullavo_tpu_torch.models.llava.config",
    "cullavo_tpu_torch.models.llava.llama",
    "cullavo_tpu_torch.models.llava.clip_vit",
    "cullavo_tpu_torch.models.llava.lora",
    "cullavo_tpu_torch.models.llava.modeling",
    "cullavo_tpu_torch.checkpoint.from_jax",
    "cullavo_tpu_torch.pipelines.vqa_pipeline",
)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in SLICE_MODULES)
            + "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
              " or m == 'cullavo_tpu' or m.startswith('cullavo_tpu.')]\n"
              "print(bad)\n"
              "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_fails_without_cuda_before_building():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    build = PORT / "_build"
    before = sorted(build.glob("*")) if build.exists() else []
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout
    assert "cuda" in (res.stdout + res.stderr).lower()
    after = sorted(build.glob("*")) if build.exists() else []
    assert after == before


def test_kernel_counters_stay_zero_on_cpu_tensors():
    from cullavo_tpu_torch.ops import flash_attention as fa
    from cullavo_tpu_torch.ops import nf4

    wrappers = (fa.flash_attention, nf4.quantize_rows, nf4.int8_linear)
    before = [w.launches for w in wrappers]
    x = torch.randn(1, 2, 5, 8)
    fa.flash_attention(x, x, x)
    nf4.quantize_rows(torch.randn(4, 16).to(torch.bfloat16), torch.ones(1, 16))
    q = nf4.quantize_linear_int8(torch.randn(16, 8), smooth_scale=torch.ones(16))
    nf4.int8_linear(torch.randn(3, 16), q)
    assert [w.launches for w in wrappers] == before


def test_port_has_no_library_stand_ins_for_its_kernels():
    """No fused-attention library call, torch.compile, CPU fallback after a
    failed launch, or import of JAX anywhere in the port's sources."""
    banned = (r"scaled_dot_product_attention", r"torch\.compile", r"^\s*import jax",
              r"^\s*from jax", r"^\s*try\s*:")
    for path in sorted(PORT.rglob("*.py")):
        text = path.read_text()
        for pat in banned:
            assert not re.search(pat, text, re.M), f"{path.name}: {pat}"


# ---------------------------------------------------------------------------
# CUDA kernels against their plain versions (need a card; skip elsewhere)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_flash_attention_matches_plain(cuda_device):
    from cullavo_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=cuda_device).manual_seed(0)
    B, T, H, d = 2, 200, 4, 128
    q, k, v = (torch.randn((B, T, H, d), generator=g, device=cuda_device)
               .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
    n0 = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v)
    assert fa.flash_attention.launches == n0 + 1
    ref = fa.mha_reference(q, k, v)
    assert torch.allclose(out.float(), ref.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K", [(40, 4096), (24, 11008)])
def test_cuda_quantize_rows_bit_equal(cuda_device, M, K):
    from cullavo_tpu_torch.ops import nf4

    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = (torch.randn((M, K), generator=g, device=cuda_device) * 3).to(torch.bfloat16)
    mult = torch.exp(torch.randn((1, K), generator=g, device=cuda_device) * 0.3).to(torch.bfloat16)
    xi, sx = nf4.quantize_rows(x, mult)
    xr, sr = nf4._quantize_rows_plain(x, mult)
    assert torch.equal(xi, xr)
    assert torch.equal(sx, sr)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 14, 33])
def test_cuda_int8_linear_matches_plain(cuda_device, M):
    from cullavo_tpu_torch.ops import nf4

    g = torch.Generator(device=cuda_device).manual_seed(2)
    K, N = 320, 272
    x = torch.randn((M, K), generator=g, device=cuda_device).to(torch.bfloat16)
    w = torch.randn((K, N), generator=g, device=cuda_device) * K ** -0.5
    q = nf4.quantize_linear_int8(w, smooth_scale=torch.exp(
        torch.randn((K,), generator=g, device=cuda_device) * 0.3))
    y = nf4.int8_linear(x, q)
    ref = nf4._int8_linear_plain(x, q)
    assert torch.allclose(y.float(), ref.float(), rtol=2 ** -7,
                          atol=1e-3 * ref.float().abs().max().item())
