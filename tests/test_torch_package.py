"""Guards on the torch port as a package: it imports neither JAX nor the JAX
package (at import time or inside any function), its kernel wrappers never
launch (or count) on CPU tensors, it carries no library or compiled
stand-in for its kernels, its copy of the VQA scorer agrees with the
original, and the chip smoke script refuses to run without a CUDA device.  The tests marked ``cuda``
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
    "cullavo_tpu_torch.ops.wwin_decode",
    "cullavo_tpu_torch.ops.msdeform",
    "cullavo_tpu_torch.ops.focal",
    "cullavo_tpu_torch.data.evaluation.vqa_eval",
    "cullavo_tpu_torch.models.llava.config",
    "cullavo_tpu_torch.models.llava.llama",
    "cullavo_tpu_torch.models.llava.clip_vit",
    "cullavo_tpu_torch.models.llava.lora",
    "cullavo_tpu_torch.models.llava.modeling",
    "cullavo_tpu_torch.checkpoint.from_jax",
    "cullavo_tpu_torch.pipelines.vqa_pipeline",
    "cullavo_tpu_torch.data.tokenizer",
    "cullavo_tpu_torch.serving",
    "cullavo_tpu_torch.serving.engine",
    "cullavo_tpu_torch.serving.io",
    "cullavo_tpu_torch.entry",
    "cullavo_tpu_torch.utils.tree",
    "cullavo_tpu_torch.utils.constants",
    "cullavo_tpu_torch.trainer.optimizer",
    "cullavo_tpu_torch.trainer.step",
    "cullavo_tpu_torch.pipelines.base",
    "cullavo_tpu_torch.pipelines.cullavo_pipeline",
    "cullavo_tpu_torch.data.text_format",
    "cullavo_tpu_torch.data.step1_synthesis",
    "cullavo_tpu_torch.data.image_processing",
    "cullavo_tpu_torch.scripts.attn_probe",
    "cullavo_tpu_torch.data.evaluation.evaluators",
    "cullavo_tpu_torch.models.from_config",
    "cullavo_tpu_torch.models.xdecoder.text_encoder",
    "cullavo_tpu_torch.models.xdecoder.focalnet",
    "cullavo_tpu_torch.models.xdecoder.fpn",
    "cullavo_tpu_torch.models.xdecoder.sam_vit",
    "cullavo_tpu_torch.models.xdecoder.deform_encoder",
    "cullavo_tpu_torch.models.xdecoder.decoder",
    "cullavo_tpu_torch.models.xdecoder.model",
    "cullavo_tpu_torch.pipelines.xdecoder_pipeline",
    "cullavo_tpu_torch.checkpoint.safetensors_io",
    "cullavo_tpu_torch.checkpoint.hf_import",
    "cullavo_tpu_torch.data.registry",
    "cullavo_tpu_torch.data.datasets",
    "cullavo_tpu_torch.data.mappers.eval_mappers",
    "cullavo_tpu_torch.models.beam",
    "cullavo_tpu_torch.models.blip2",
    "cullavo_tpu_torch.models.blip2.config",
    "cullavo_tpu_torch.models.blip2.vision",
    "cullavo_tpu_torch.models.blip2.qformer",
    "cullavo_tpu_torch.models.blip2.t5",
    "cullavo_tpu_torch.models.blip2.modeling",
    "cullavo_tpu_torch.models.kosmos2",
    "cullavo_tpu_torch.pipelines.vl_zoo_pipeline",
)


def test_every_module_of_the_port_is_in_the_import_guard():
    found = {".".join(p.relative_to(REPO).with_suffix("").parts)
             for p in PORT.rglob("*.py") if p.name != "__init__.py"}
    assert found <= set(SLICE_MODULES), sorted(found - set(SLICE_MODULES))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in SLICE_MODULES)
            + "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'cullavo_tpu', 'yaml',"
              " 'optax', 'transformers', 'tokenizers', 'safetensors', 'PIL')]\n"
              "print(bad)\n"
              "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_source_names_jax_or_the_jax_package_in_an_import():
    """Every import statement of the port's sources and of ``chip_smoke.py``,
    function-level ones included (which an import-time check cannot see)."""
    banned = re.compile(r"^\s*(import|from)\s+(jax|cullavo_tpu|yaml|optax)(\.|\s|$)", re.M)
    paths = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(paths) > 20
    assert {PORT / "entry.py", PORT / "serving" / "engine.py", PORT / "serving" / "io.py",
            PORT / "trainer" / "step.py", PORT / "trainer" / "optimizer.py",
            PORT / "pipelines" / "cullavo_pipeline.py", PORT / "scripts" / "attn_probe.py",
            PORT / "data" / "step1_synthesis.py"} <= set(paths)
    for path in paths:
        hit = banned.search(path.read_text())
        assert hit is None, f"{path.relative_to(REPO)}: {hit.group(0).strip()!r}"
    assert banned.search("    from cullavo_tpu.data import x") and banned.search("import jax")
    assert banned.search("    import yaml") and banned.search("import optax")
    assert not banned.search("from cullavo_tpu_torch.ops import nf4")


def test_port_reads_snapshots_without_the_hf_libraries():
    """No import of transformers, tokenizers or safetensors anywhere in the
    port or in ``chip_smoke.py`` (the machine with the card has none of
    them: the port reads safetensors and tokenizer.json itself); PIL only
    inside ``load_image_rgb``."""
    hf = re.compile(r"^\s*(import|from)\s+(transformers|tokenizers|safetensors)(\.|\s|$)", re.M)
    pil = re.compile(r"^(\s*)(import|from)\s+PIL(\.|\s|$)", re.M)
    paths = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in paths:
        text = path.read_text()
        hit = hf.search(text)
        assert hit is None, f"{path.relative_to(REPO)}: {hit.group(0).strip()!r}"
        for m in pil.finditer(text):
            fn = text[:m.start()].rsplit("\ndef ", 1)[-1].split("(", 1)[0]
            assert (path.name, fn, m.group(1)) == ("eval_mappers.py", "load_image_rgb", "    "), (
                f"{path.relative_to(REPO)}: PIL imported in {fn!r}")
    assert hf.search("from safetensors import safe_open") and hf.search("    import tokenizers")
    assert not hf.search("from cullavo_tpu_torch.checkpoint import safetensors_io")


def test_evaluate_model_runs_without_the_jax_package():
    """``VQAPipeline.evaluate_model`` scores with the port's own copy of the
    VQA evaluator: ``cullavo_tpu`` and ``jax`` stay out of ``sys.modules``."""
    code = (
        "import sys, numpy as np, torch\n"
        "from cullavo_tpu_torch.models.llava.config import tiny_llava_config\n"
        "from cullavo_tpu_torch.models.llava.modeling import init_llava_params\n"
        "from cullavo_tpu_torch.pipelines.vqa_pipeline import VQAPipeline\n"
        "class Tok:\n"
        "    image_token_id, pad_token_id, eos_token_id = 258, 0, 2\n"
        "    def encode(self, text):\n"
        "        head, tail = text.split('<image>')\n"
        "        return [1] + list(head.encode()[-8:]) + [258] + list(tail.encode())\n"
        "    def decode(self, toks):\n"
        "        return bytes(t for t in toks if 0 < t < 256).decode('latin-1')\n"
        "cfg = tiny_llava_config(260)\n"
        "params = init_llava_params(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
        "rows = [{'question_id': i, 'question': f'what is {i}?', 'answers': ['yes'] * 10,\n"
        "         'pixel_values': np.zeros((3, 28, 28), np.float32)} for i in range(3)]\n"
        "pipe = VQAPipeline(None, cfg, Tok(), params, batch_size=2, max_new_tokens=3,\n"
        "                   kv_quant='int8', spec_k=2)\n"
        "res = pipe.evaluate_model(rows)\n"
        "assert res['n'] == 3 and 0.0 <= res['overall'] <= 100.0, res\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'cullavo_tpu')]\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


VQA_ROWS = [
    ("Yes.", ["yes"] * 10),
    ("two dogs", ["2 dogs"] * 4 + ["two dogs"] * 3 + ["dogs"] * 3),
    ("a red, car", ["red car"] * 2 + ["car"] * 8),
    ("dont know", ["don't know"] * 3 + ["unknown"] * 7),
    ("1,000", ["1000"] * 9 + ["1,000"]),
    ("", ["nothing"] * 10),
]


@pytest.mark.parametrize("answer,truths", VQA_ROWS)
def test_vqa_eval_copy_matches_the_original(answer, truths):
    from cullavo_tpu.data.evaluation import vqa_eval as orig
    from cullavo_tpu_torch.data.evaluation import vqa_eval as copy

    a, b = orig.VQAEvaluator(), copy.VQAEvaluator()
    for ev in (a, b):
        ev.process(7, answer, truths, "what", "other")
    assert b.evaluate() == a.evaluate()


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
    from cullavo_tpu_torch.ops import focal, msdeform, nf4
    from cullavo_tpu_torch.ops import wwin_decode as ww

    from cullavo_tpu_torch.models.llava.llama import sdpa_decode_stale

    wrappers = (fa.flash_attention, fa.flash_lse, fa.flash_rows, nf4.quantize_rows,
                nf4.int8_linear, ww.wwin_decode_smajor, ww.wwin_decode_smajor_q8,
                nf4.nf4_linear_planar, nf4.nf4_dequant_planar,
                msdeform.ms_deform_attn_kernel, focal.focal_ctx_kernel,
                nf4.nf4_linear_q4, nf4.nf4_dequant_q4, fa.decode_partials)
    before = [w.launches for w in wrappers]
    x = torch.randn(1, 2, 5, 8)
    fa.flash_attention(x, x, x)
    xg = x.clone().requires_grad_(True)
    fa.flash_attention(xg, xg, xg).sum().backward()                  # the lse form
    fa.flash_attention(xg, x, x, kv_valid=torch.ones(1, 5, dtype=torch.int32),
                       causal=False).sum().backward()                # the masked form
    nf4.quantize_rows(torch.randn(4, 16).to(torch.bfloat16), torch.ones(1, 16))
    q = nf4.quantize_linear_int8(torch.randn(16, 8), smooth_scale=torch.ones(16))
    nf4.int8_linear(torch.randn(3, 16), q)
    qw, kv = torch.randn(2, 2, 3, 8), torch.randn(2, 6, 2, 2, 8)      # [B,H,W,hd], [L,S,B,KV,hd]
    bias = torch.zeros(2, 1, 3, 6)
    ww.wwin_decode_smajor(qw, kv, kv, 1, qw, qw, bias)
    codes, planes = kv.to(torch.int8), torch.ones(2, 6, 2, 2, dtype=torch.bfloat16)
    ww.wwin_decode_smajor_q8(qw, codes, planes, codes, planes, 0, qw, qw, bias)
    q4 = nf4.quantize_linear_planar(torch.randn(16, 64))
    nf4.nf4_linear_planar(torch.randn(3, 16), q4)
    nf4.nf4_dequant_planar(q4)
    nf4.nf4_linear_planar_auto(torch.randn(600, 16), q4)
    xq = torch.randn(600, 16, requires_grad=True)
    nf4.nf4_linear_planar_vjp(xq, q4).sum().backward()
    qb = nf4.quantize_linear(torch.randn(16, 64))
    nf4.nf4_linear_q4(torch.randn(3, 16), qb, 16)
    nf4.nf4_dequant_q4(qb, 16)
    nf4.nf4_linear_q4_auto(torch.randn(600, 16), qb, 16)
    nf4.nf4_linear_fused_vjp(xq, qb, 16).sum().backward()
    nf4.nf4_matmul_fused(torch.randn(3, 16), nf4.quantize_nf4(torch.randn(16, 64)))
    msdeform.ms_deform_attn_kernel(torch.randn(1, 20, 2, 32), ((4, 5),),
                                   torch.rand(1, 3, 2, 1, 4, 2), torch.rand(1, 3, 2, 1, 4))
    focal.focal_ctx_kernel(torch.randn(1, 4, 30), torch.randn(1, 3, 30),
                           torch.randn(4, 9 + 25), 5, 6, (3, 5), True, True)
    qd, cache = torch.randn(2, 4, 1, 16), torch.randn(2, 2, 7, 16)
    fa.flash_decode(qd, cache, cache, torch.tensor([3, 6]), torch.ones(2, 7))
    fa.decode_partials(qd, cache, cache, torch.zeros(1, 4, 7), 1.0)
    full = torch.randn(2, 4, 7, 16)
    sdpa_decode_stale(qd, full, full, qd, qd, torch.zeros(2, 1, 1, 7),
                      self_bias=torch.zeros(1, 4, 1, 1), scale=1.0)
    assert [w.launches for w in wrappers] == before


def test_nf4_wrappers_take_the_plain_version_only_for_cpu_tensors():
    """A tensor on any other device goes to the kernel or raises: no quiet
    step down to the plain version (a meta tensor stands for "not the CPU"
    where there is no card)."""
    from cullavo_tpu_torch.ops import nf4

    q4 = nf4.quantize_linear_planar(torch.randn(16, 64))
    meta = {k: v.to("meta") for k, v in q4.items()}
    before = (nf4.nf4_linear_planar.launches, nf4.nf4_dequant_planar.launches)
    with pytest.raises(ValueError, match="unsupported device"):
        nf4.nf4_linear_planar(torch.randn(3, 16, device="meta"), meta)
    with pytest.raises(ValueError, match="unsupported device"):
        nf4.nf4_dequant_planar(meta)
    with pytest.raises(ValueError, match="unsupported device"):
        nf4.nf4_linear_planar_auto(torch.randn(600, 16, device="meta"), meta)
    with pytest.raises(ValueError, match="unsupported device"):
        nf4.nf4_linear_planar_vjp(torch.randn(3, 16, device="meta"), meta)
    assert (nf4.nf4_linear_planar.launches, nf4.nf4_dequant_planar.launches) == before
    src = (PORT / "ops" / "nf4.py").read_text()
    cuda_half = src[src.index("def _nf4_linear_planar_cuda"):src.index("def nf4_linear_planar_auto")]
    for banned in ("matmul", " @ ", "_plain(", "dequant_linear_planar(q", "einsum"):
        assert banned not in cuda_half.replace("return dequant_linear_planar(q, dtype=dtype)", ""), banned


def test_flash_attention_takes_the_plain_version_only_for_cpu_tensors():
    """The forward on a tensor that is not on the CPU goes to a kernel or
    raises; the part of the module that serves CUDA tensors holds no matmul,
    softmax or plain-version call."""
    from cullavo_tpu_torch.ops import flash_attention as fa

    x = torch.randn(1, 1, 4, 128, device="meta", dtype=torch.bfloat16)
    before = (fa.flash_attention.launches, fa.flash_lse.launches, fa.flash_rows.launches)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(x, x, x, kv_valid=torch.ones(1, 4, device="meta"), causal=False)
    assert (fa.flash_attention.launches, fa.flash_lse.launches, fa.flash_rows.launches) == before
    src = (PORT / "ops" / "flash_attention.py").read_text()
    cuda_half = src[src.index("def _flash_cuda"):]
    for banned in ("matmul", " @ ", "mha_reference", "softmax", "einsum", "bmm"):
        assert banned not in cuda_half, banned
    fwd = src[src.index("class _FlashAttention"):src.index("    def backward")]
    assert fwd.count("mha_reference") == 1 and 'if q.device.type == "cpu":' in fwd
    # K12 (one-token decode): the same rule
    qd, cache = (torch.randn(1, 2, 1, 16, device="meta"), torch.randn(1, 2, 5, 16, device="meta"))
    n0 = fa.decode_partials.launches
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_decode(qd, cache, cache, torch.zeros(1, device="meta"),
                        torch.ones(1, 5, device="meta"))
    assert fa.decode_partials.launches == n0
    entry = src[src.index("def decode_partials"):src.index("def flash_decode")]
    assert entry.count("_decode_partials_plain(") == 1 and 'if q.device.type == "cpu":' in entry
    assert "def _decode_cuda" in cuda_half


def test_port_has_no_library_stand_ins_for_its_kernels():
    """No fused-attention or grid-sampling library call, torch.compile, CPU
    fallback after a failed launch, or import of JAX anywhere in the port's
    sources; the CUDA routes of K9 and K10 hold no gather and no
    (depthwise) convolution."""
    banned = (r"scaled_dot_product_attention", r"grid_sample\s*\(", r"torch\.compile",
              r"^\s*import jax", r"^\s*from jax", r"^\s*try\s*:")
    for path in sorted(PORT.rglob("*.py")):
        text = path.read_text()
        for pat in banned:
            assert not re.search(pat, text, re.M), f"{path.name}: {pat}"
    for name, start, end in (("msdeform.py", "def _ms_deform_attn_cuda",
                              "def msdeform_attn_module_forward"),
                             ("focal.py", "def _focal_ctx_cuda", None)):
        src = (PORT / "ops" / name).read_text()
        cuda_half = src[src.index(start):src.index(end) if end else None]
        for word in ("conv2d", "conv(", "gather", "_plain(", "ms_deform_attn(", "einsum", "@"):
            assert word not in cuda_half, (name, word)


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


def _wwin_case(dev, W, n_rep, S, strided, seed):
    """A stacked bf16 cache (optionally a strided view of a wider buffer),
    a fresh window and per-row valid lengths with one wholly masked row."""
    from cullavo_tpu_torch.ops import wwin_decode as ww

    g = torch.Generator(device=dev).manual_seed(seed)
    L, B, KV, hd = 3, 3, 2, 128
    H = KV * n_rep

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    if strided:   # batch rows 1..B of a [L, S, B + 2, KV, hd] pool
        kc, vc = rnd(L, S, B + 2, KV, hd)[:, :, 1:B + 1], rnd(L, S, B + 2, KV, hd)[:, :, 1:B + 1]
    else:
        kc, vc = rnd(L, S, B, KV, hd), rnd(L, S, B, KV, hd)
    q = rnd(B, W, H, hd).transpose(1, 2)                  # heads as a strided view
    k_cur, v_cur = rnd(B, H, W, hd), rnd(B, H, W, hd)
    bias = torch.zeros((B, 1, W, S), device=dev)
    bias[0, :, :, S - 7:] = ww.NEG_INF
    bias[1] = ww.NEG_INF                                   # no valid cache slot
    bias[2, :, :, S // 2:] = ww.NEG_INF
    return q, kc, vc, k_cur, v_cur, bias


def _assert_partials_close(got, want):
    """acc, m, l of a kernel against the plain version.  m and l: f32 sums
    in another order over bf16 products (rtol 2e-3).  acc: the kernel rounds
    each probability to bf16 relative to its warp's running maximum, the
    plain version relative to the final one, so every term p * v carries an
    independent bf16 rounding (2^-9 relative) on both sides: a row may
    differ by 2^-8 * sum(p) = 2^-8 * l for |v| ~ 1."""
    acc, m, l = got
    acc_ref, m_ref, l_ref = want
    assert torch.allclose(m, m_ref, rtol=2e-3, atol=1e-3), (m - m_ref).abs().max().item()
    assert torch.allclose(l, l_ref, rtol=2e-3, atol=1e-3), (l - l_ref).abs().max().item()
    excess = (acc - acc_ref).abs() - 2e-3 * acc_ref.abs() - 2.0 ** -8 * l_ref[..., None]
    assert (excess <= 0).all(), excess.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("W,n_rep,S,strided", [
    (1, 1, 768, False), (3, 2, 200, False), (4, 1, 664, True), (4, 4, 130, False),
    (64, 1, 257, False), (64, 4, 96, True), (128, 1, 257, False), (128, 2, 96, True)])
def test_cuda_wwin_decode_matches_plain(cuda_device, W, n_rep, S, strided):
    from cullavo_tpu_torch.ops import wwin_decode as ww

    q, kc, vc, k_cur, v_cur, bias = _wwin_case(cuda_device, W, n_rep, S, strided, seed=3)
    n0 = ww.wwin_decode_smajor.launches
    for li in (0, 2):
        got = ww._run_cache_part(q, kc, vc, li, bias[:, 0], n_rep, 128 ** -0.5)
        want = ww._cache_part_plain(q, kc, vc, li, bias[:, 0], n_rep, 128 ** -0.5)
        _assert_partials_close(got, want)
        assert not got[0][1].any() and not got[2][1].any()          # the masked row
    assert ww.wwin_decode_smajor.launches == n0 + 2
    out = ww.wwin_decode_smajor(q, kc, vc, 1, k_cur, v_cur, bias, n_rep=n_rep)
    acc, m, l = ww._cache_part_plain(q, kc, vc, 1, bias[:, 0], n_rep, 128 ** -0.5)
    ref = ww._merge_self_window(q, k_cur, v_cur, acc, m, l, 128 ** -0.5)
    assert torch.isfinite(out).all()
    assert torch.allclose(out.float(), ref.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("W,n_rep,S,strided", [
    (1, 1, 768, False), (3, 2, 200, True), (4, 1, 664, False), (4, 4, 130, False),
    (64, 2, 257, False), (128, 1, 200, True), (128, 2, 257, False)])
def test_cuda_wwin_decode_q8_matches_plain(cuda_device, W, n_rep, S, strided):
    from cullavo_tpu_torch.models.llava.llama import quantize_kv
    from cullavo_tpu_torch.ops import wwin_decode as ww

    q, kc, vc, k_cur, v_cur, bias = _wwin_case(cuda_device, W, n_rep, S, strided, seed=4)
    (kq, ks), (vq, vs) = quantize_kv(kc), quantize_kv(vc)
    if strided:   # the quantizer returns dense tensors: view them out of a wider pool
        def widen(t):
            pool = torch.zeros((*t.shape[:2], t.shape[2] + 2, *t.shape[3:]), dtype=t.dtype,
                               device=t.device)
            pool[:, :, 1:-1] = t
            return pool[:, :, 1:-1]
        kq, ks, vq, vs = map(widen, (kq, ks, vq, vs))
    win = (*quantize_kv(k_cur[:, ::n_rep].permute(2, 0, 1, 3)),
           *quantize_kv(v_cur[:, ::n_rep].permute(2, 0, 1, 3)))
    k_cur, v_cur = (torch.repeat_interleave(x[:, ::n_rep], n_rep, dim=1) for x in (k_cur, v_cur))
    n0 = ww.wwin_decode_smajor_q8.launches
    got = ww._run_cache_part_q8(q, kq, ks, vq, vs, 2, bias[:, 0], n_rep, 128 ** -0.5)
    want = ww._cache_part_q8_plain(q, kq, ks, vq, vs, 2, bias[:, 0], n_rep, 128 ** -0.5)
    assert ww.wwin_decode_smajor_q8.launches == n0 + 1
    _assert_partials_close(got, want)
    out = ww.wwin_decode_smajor_q8(q, kq, ks, vq, vs, 0, k_cur, v_cur, bias, n_rep=n_rep,
                                   win_q8=win)
    acc, m, l = ww._cache_part_q8_plain(q, kq, ks, vq, vs, 0, bias[:, 0], n_rep, 128 ** -0.5)
    ref = ww._merge_self_window(q, k_cur, v_cur, acc, m, l, 128 ** -0.5, win_q8=win, n_rep=n_rep)
    assert torch.isfinite(out).all()
    assert torch.allclose(out.float(), ref.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
def test_cuda_wwin_decode_refuses_what_the_kernel_does_not_take(cuda_device):
    from cullavo_tpu_torch.ops import wwin_decode as ww

    q, kc, vc, k_cur, v_cur, bias = _wwin_case(cuda_device, 2, 1, 64, False, seed=5)
    with pytest.raises(ValueError, match="bf16 queries"):
        ww.wwin_decode_smajor(q.float(), kc, vc, 0, k_cur, v_cur, bias)
    with pytest.raises(ValueError, match="kc must be"):
        ww.wwin_decode_smajor(q, kc.float(), vc.float(), 0, k_cur, v_cur, bias)
    wide = torch.zeros((3, 129, 2, 128), dtype=torch.bfloat16, device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="W <= 128"):
        ww.wwin_decode_smajor(wide, kc, vc, 0, wide, wide, torch.zeros(3, 1, 129, 64,
                                                                      device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(128, 192), (1096, 64), (4096, 256)])
def test_cuda_nf4_dequant_planar_bit_equal(cuda_device, K, N):
    from cullavo_tpu_torch.ops import nf4

    g = torch.Generator(device=cuda_device).manual_seed(6)
    q = nf4.quantize_linear_planar(torch.randn((K, N), generator=g, device=cuda_device) * K ** -0.5)
    n0 = nf4.nf4_dequant_planar.launches
    got = nf4.nf4_dequant_planar(q)
    assert nf4.nf4_dequant_planar.launches == n0 + 1
    assert torch.equal(got.view(torch.int16), nf4.dequant_linear_planar(q).view(torch.int16))
    with pytest.raises(ValueError, match="writes bf16"):
        nf4.nf4_dequant_planar(q, dtype=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 17, 129, 300, 511, 700])
@pytest.mark.parametrize("K,N", [(128, 192), (1096, 64)])
def test_cuda_nf4_linear_planar_matches_plain(cuda_device, M, K, N):
    """K = 1096 gives K/8 = 137 word rows: a ragged last chunk of the
    kernel's 16-row chunks; M = 700 takes two row blocks."""
    from cullavo_tpu_torch.ops import nf4

    g = torch.Generator(device=cuda_device).manual_seed(7)
    q = nf4.quantize_linear_planar(torch.randn((K, N), generator=g, device=cuda_device) * K ** -0.5)
    x = torch.randn((M, K), generator=g, device=cuda_device).to(torch.bfloat16)
    n0 = nf4.nf4_linear_planar.launches
    y = nf4.nf4_linear_planar(x, q)
    assert nf4.nf4_linear_planar.launches == n0 + 1
    ref = nf4._nf4_linear_planar_plain(x, q)
    assert torch.isfinite(y).all()
    assert torch.allclose(y.float(), ref.float(), rtol=1e-2, atol=1e-2)
    y3 = nf4.nf4_linear_planar(x.reshape(1, M, K), q)
    assert y3.shape == (1, M, N) and torch.equal(y3[0], y)        # deterministic split-K


@pytest.mark.cuda
def test_cuda_nf4_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    from cullavo_tpu_torch.ops import nf4

    q = nf4.quantize_linear_planar(torch.randn((128, 192), device=cuda_device))
    x = torch.randn((4, 128), device=cuda_device)
    with pytest.raises(ValueError, match="x must be bf16"):
        nf4.nf4_linear_planar(x, q)
    with pytest.raises(ValueError, match="different devices"):
        nf4.nf4_linear_planar(x.to(torch.bfloat16), {k: v.cpu() for k, v in q.items()})
    with pytest.raises(ValueError, match="one \\[K/8, N\\] matrix"):
        nf4.nf4_dequant_planar({k: v[None] for k, v in q.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(128, 192), (1096, 64), (4096, 256)])
def test_cuda_nf4_dequant_q4_bit_equal(cuda_device, K, N):
    """K11's dequant entry against ``dequant_linear``, bit for bit."""
    from cullavo_tpu_torch.ops import nf4

    g = torch.Generator(device=cuda_device).manual_seed(16)
    q = nf4.quantize_linear(torch.randn((K, N), generator=g, device=cuda_device) * K ** -0.5)
    n0 = nf4.nf4_dequant_q4.launches
    got = nf4.nf4_dequant_q4(q, K)
    assert nf4.nf4_dequant_q4.launches == n0 + 1
    assert torch.equal(got.view(torch.int16), nf4.dequant_linear(q, K, N).view(torch.int16))
    with pytest.raises(ValueError, match="writes bf16"):
        nf4.nf4_dequant_q4(q, K, dtype=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 14, 64, 129, 300, 511, 700])
@pytest.mark.parametrize("K,N", [(128, 192), (1096, 64), (4096, 256)])
def test_cuda_nf4_linear_q4_matches_plain(cuda_device, M, K, N):
    """K11 against its f32 plain version within 1e-2 + 1e-2 |ref| (the f32
    weight as two bf16 terms, f32 sums in another order, one bf16 rounding
    on each side).  K = 1096: a
    ragged last chunk of the kernel's 128-row chunks; M = 700: two row
    blocks.  Row 8: the same kernel fed an NF4Tensor's decoded absmax."""
    from cullavo_tpu_torch.ops import nf4

    g = torch.Generator(device=cuda_device).manual_seed(17)
    w = torch.randn((K, N), generator=g, device=cuda_device) * K ** -0.5
    q = nf4.quantize_linear(w)
    x = torch.randn((M, K), generator=g, device=cuda_device).to(torch.bfloat16)
    n0 = nf4.nf4_linear_q4.launches
    y = nf4.nf4_linear_q4(x, q, K)
    assert nf4.nf4_linear_q4.launches == n0 + 1
    ref = nf4._nf4_linear_q4_plain(x, q, K, N)
    assert torch.isfinite(y).all()
    assert torch.allclose(y.float(), ref.float(), rtol=1e-2, atol=1e-2)
    y3 = nf4.nf4_linear_q4(x.reshape(1, M, K), q, K)
    assert y3.shape == (1, M, N) and torch.equal(y3[0], y)        # deterministic split-K
    t = nf4.quantize_nf4(w)
    y8 = nf4.nf4_matmul_fused(x, t)
    ref8 = (x.float() @ nf4.dequantize_nf4(t, torch.float32)).to(torch.bfloat16)
    assert torch.allclose(y8.float(), ref8.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
def test_cuda_nf4_q4_vjp_and_refusals(cuda_device):
    """dx = dy @ K11-dequant(q).T; a dtype, a device or a width the kernel
    does not take raises instead of stepping down to the plain version."""
    from cullavo_tpu_torch.ops import nf4

    g = torch.Generator(device=cuda_device).manual_seed(18)
    K, N = 256, 320
    q = nf4.quantize_linear(torch.randn((K, N), generator=g, device=cuda_device) * K ** -0.5)
    x = torch.randn((9, K), generator=g, device=cuda_device).to(torch.bfloat16).requires_grad_(True)
    dy = torch.randn((9, N), generator=g, device=cuda_device).to(torch.bfloat16)
    nf4.nf4_linear_fused_vjp(x, q, K).backward(dy)
    ref = dy.float() @ nf4.dequant_linear(q, K, N).float().T
    assert torch.allclose(x.grad.float(), ref, rtol=1e-2, atol=1e-2)
    with pytest.raises(ValueError, match="x must be bf16"):
        nf4.nf4_linear_q4(x.detach().float(), q, K)
    with pytest.raises(ValueError, match="different devices"):
        nf4.nf4_linear_q4(x.detach(), {k: v.cpu() for k, v in q.items()}, K)
    qn = nf4.quantize_linear(torch.randn((64, 32), device=cuda_device))
    with pytest.raises(ValueError, match="N % 64 == 0"):
        nf4.nf4_linear_q4(torch.randn((3, 64), device=cuda_device).to(torch.bfloat16), qn, 64)


def _flash_case(dev, B, H, T, S, seed, left_pad=False):
    """bf16 q/k/v as strided head views, positions continuing each row's
    valid run, and a key mask: right padding, or left padding (whose padded
    query rows see no key at all)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, T, H, 128), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
    k, v = (torch.randn((B, S, H, 128), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
            for _ in range(2))
    n_pad = torch.arange(B, device=dev) * 5 % 11
    idx = torch.arange(S, device=dev)[None, :]
    valid = (idx >= n_pad[:, None]) if left_pad else (idx < S - n_pad[:, None])
    pos = (torch.cumsum(valid[:, S - T:].int(), dim=1) - 1).clamp_min(0) + (S - T)
    if left_pad:   # padded query rows sit before every valid key
        pos = torch.where(valid[:, S - T:], pos, torch.full_like(pos, -1))
    return q, k, v, pos.int(), valid.int()


def _assert_attention_close(got, want, what):
    """bf16 outputs within one bf16 ulp of |ref| plus 1e-2 (P and O are
    rounded to bf16 at other places); the f32 lse within 2e-3."""
    (o, lse), (o_ref, lse_ref) = got, want
    assert torch.isfinite(o).all() and torch.isfinite(lse).all(), what
    assert torch.allclose(o.float(), o_ref.float(), rtol=1e-2, atol=1e-2), \
        (what, (o.float() - o_ref.float()).abs().max().item())
    assert torch.allclose(lse, lse_ref, rtol=1e-5, atol=2e-3), \
        (what, (lse - lse_ref).abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("T", [200, 1024])
def test_cuda_flash_attention_lse_matches_plain(cuda_device, T):
    from cullavo_tpu_torch.ops import flash_attention as fa

    q, k, v, _, _ = _flash_case(cuda_device, 2, 4, T, T, seed=8)
    n0, n1 = fa.flash_lse.launches, fa.flash_attention.launches
    got = fa._flash_cuda(q, k, v, None, None, True, True)
    assert (fa.flash_lse.launches, fa.flash_attention.launches) == (n0 + 1, n1)
    _assert_attention_close(got, fa.mha_reference(q, k, v, need_lse=True), f"K1-lse T={T}")
    assert torch.equal(got[0], fa.flash_attention(q, k, v))      # the inference launch's o


@pytest.mark.cuda
@pytest.mark.parametrize("T,S,causal,left_pad", [
    (648, 648, True, False), (648, 648, True, True), (100, 333, True, False),
    (130, 64, True, False), (200, 200, False, False), (77, 201, False, True)])
def test_cuda_flash_rows_matches_plain(cuda_device, T, S, causal, left_pad):
    from cullavo_tpu_torch.ops import flash_attention as fa

    q, k, v, pos, valid = _flash_case(cuda_device, 3, 2, T, S, seed=9, left_pad=left_pad)
    if S < T:
        pos = torch.arange(T, device=cuda_device, dtype=torch.int32)[None].expand(3, T)
    n0 = fa.flash_rows.launches
    got = fa._flash_cuda(q, k, v, pos, valid, causal, True)
    assert fa.flash_rows.launches == n0 + 1
    want = fa.mha_reference(q, k, v, causal, pos, valid, need_lse=True)
    _assert_attention_close(got, want, f"K8 T={T} S={S}")
    if left_pad and causal:     # a wholly masked row: the mean of v, lse = NEG_INF + log S
        assert (got[1][1, :, 0] <= -1e29).all()
        assert torch.allclose(got[0][1, :, 0].float(), v[1].float().mean(dim=1), atol=2e-2)
    o_only = fa._flash_cuda(q, k, v, pos, valid, causal, False)
    assert torch.equal(o_only, got[0])
    # the implicit forms: no positions, no key mask
    got = fa._flash_cuda(q, k, v, None, None if S != T or not causal else valid, causal, True)
    want = fa.mha_reference(q, k, v, causal, None, None if S != T or not causal else valid,
                            need_lse=True)
    _assert_attention_close(got, want, f"K8 implicit T={T} S={S}")


@pytest.mark.cuda
@pytest.mark.parametrize("T,S,causal,masked", [(256, 256, True, False), (648, 648, True, True),
                                               (96, 160, False, True)])
def test_cuda_flash_attention_gradients_match_plain(cuda_device, T, S, causal, masked):
    """dq, dk, dv of the autograd function (kernel forward + chunked
    backward with bf16 operands) against autograd through the plain version:
    within 2e-2 of the largest gradient entry (bf16 rounding of P, dS, dO)."""
    from cullavo_tpu_torch.ops import flash_attention as fa

    q, k, v, pos, valid = _flash_case(cuda_device, 2, 2, T, S, seed=10, left_pad=masked)
    if not masked:
        pos = valid = None
    g = torch.Generator(device=cuda_device).manual_seed(11)
    do = torch.randn((2, 2, T, 128), generator=g, device=cuda_device).to(torch.bfloat16)
    grads = []
    for fn in (fa.flash_attention, fa.mha_reference):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        out = (fn(*leaves, pos, valid, causal) if fn is fa.flash_attention
               else fn(*leaves, causal, pos, valid))
        grads.append(torch.autograd.grad(out, leaves, do))
    for name, a, b in zip(("dq", "dk", "dv"), *grads):
        tol = 2e-2 * b.float().abs().max().item()
        assert torch.isfinite(a).all()
        assert (a.float() - b.float()).abs().max().item() <= tol, name
    if masked and causal:       # the wholly masked row gives no gradient
        assert not grads[0][0][1, :, 0].any()


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_what_the_kernels_do_not_take(cuda_device):
    from cullavo_tpu_torch.ops import flash_attention as fa

    q, k, v, pos, valid = _flash_case(cuda_device, 1, 1, 16, 16, seed=12)
    with pytest.raises(ValueError, match="must be bf16"):
        fa.flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="head dim 128"):
        fa.flash_attention(q[..., :64], k[..., :64], v[..., :64])
    with pytest.raises(ValueError, match="kv_valid must be"):
        fa.flash_attention(q, k, v, kv_valid=valid[:, :8])
    with pytest.raises(ValueError, match="integer or boolean"):
        fa.flash_attention(q, k, v, q_positions=pos.float())


def _msdeform_case(dev, dtype, shapes, B, Q, Hh, hd, P, seed):
    """Value, locations (about a tenth outside [0, 1]) and softmaxed weights."""
    g = torch.Generator(device=dev).manual_seed(seed)
    S = sum(h * w for h, w in shapes)
    L = len(shapes)
    value = torch.randn((B, S, Hh, hd), generator=g, device=dev).to(dtype)
    loc = torch.rand((B, Q, Hh, L, P, 2), generator=g, device=dev) * 1.2 - 0.1
    att = torch.softmax(torch.randn((B, Q, Hh, L * P), generator=g, device=dev), -1)
    return value, loc, att.reshape(B, Q, Hh, L, P)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes,Q,Hh,hd,P", [
    (((64, 64), (32, 32), (16, 16)), 5376, 8, 64, 4),       # the deform encoder at 512^2
    (((40, 48), (20, 24), (10, 12)), 3001, 8, 64, 4),       # non-square, Q ragged
    (((9, 13), (5, 7)), 77, 2, 32, 3), (((6, 4),), 50, 1, 128, 2)])
def test_cuda_ms_deform_attn_matches_plain(cuda_device, dtype, shapes, Q, Hh, hd, P):
    """K9 against the plain version: within 1e-5 in f32 (sums in another
    order), within 1e-2 + 1e-2 |ref| in bf16 (one rounding of the output)."""
    from cullavo_tpu_torch.ops import msdeform

    value, loc, att = _msdeform_case(cuda_device, dtype, shapes, 2, Q, Hh, hd, P, seed=13)
    n0 = msdeform.ms_deform_attn_kernel.launches
    got = msdeform.ms_deform_attn_kernel(value, shapes, loc, att)
    assert msdeform.ms_deform_attn_kernel.launches == n0 + 1
    ref = msdeform.ms_deform_attn(value, shapes, loc, att)
    assert got.dtype == dtype and got.shape == ref.shape
    tol = (1e-5, 0.0) if dtype == torch.float32 else (1e-2, 1e-2)
    assert torch.allclose(got.float(), ref.float(), atol=tol[0], rtol=tol[1]), \
        (got.float() - ref.float()).abs().max().item()


def _focal_case(dev, dtype, B, C, H, W, kernels, seed, strided):
    """ctx and gates as slices of one projection output [B, 2C + L + 1, HW]
    (the layout focal_modulation hands over), or contiguous."""
    g = torch.Generator(device=dev).manual_seed(seed)
    L = len(kernels)
    fx = torch.randn((B, 2 * C + L + 1, H * W), generator=g, device=dev).to(dtype)
    # taps of std 0.6 / k: every level's output stays of order one
    taps = torch.cat([torch.randn((C, k * k), generator=g, device=dev) * (0.6 / k)
                      for k in kernels], dim=1)
    if strided:
        return fx[:, C:2 * C], fx[:, 2 * C:], taps
    return fx[:, C:2 * C].contiguous(), fx[:, 2 * C:].contiguous(), taps


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("approximate", [True, False])
@pytest.mark.parametrize("B,C,H,W,kernels,strided", [
    (2, 192, 128, 128, (3, 5, 7, 9), True), (2, 1536, 16, 16, (3, 5, 7, 9), True),
    (1, 96, 100, 75, (3, 5, 7), False), (3, 8, 5, 3, (3, 5, 7, 9), False),
    (1, 16, 70, 130, (3, 5, 7, 9, 11, 13, 15, 17), False), (1, 4, 33, 17, (1,), False)])
def test_cuda_focal_ctx_matches_plain(cuda_device, dtype, approximate, B, C, H, W, kernels,
                                      strided):
    """K10 against the plain version (cuDNN's depthwise conv in f32): within
    1e-5 + 1e-5 |ref| in f32 (the chain sums in another order than cuDNN),
    1e-2 + 1e-2 |ref| in bf16; any map size (tiles of 64, a map smaller than
    the widest kernel), any level count."""
    from cullavo_tpu_torch.ops import focal

    torch.backends.cudnn.allow_tf32 = False
    ctx, gates, taps = _focal_case(cuda_device, dtype, B, C, H, W, kernels, 14, strided)
    for scaling in (True, False):
        n0 = focal.focal_ctx_kernel.launches
        got = focal.focal_ctx_kernel(ctx, gates, taps, H, W, kernels, scaling, approximate)
        assert focal.focal_ctx_kernel.launches == n0 + 1
        ref = focal.focal_ctx_plain(ctx, gates, taps, H, W, kernels, scaling, approximate)
        assert got.dtype == dtype and got.shape == ref.shape
        tol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-2, 1e-2)
        assert torch.allclose(got.float(), ref.float(), atol=tol[0], rtol=tol[1]), \
            (got.float() - ref.float()).abs().max().item()


def _decode_case(dev, dtype, B, H, KV, S, d, seed, stacked=False):
    """q [B, H, 1, d]; caches [B, KV, S, d], or layer 1 of a stacked
    [3, B, KV, S + 5, d] cache sliced to S slots (read in place through its
    strides); a key-validity bias [B, 1, S] (about a fifth masked at -1e9)
    plus a per-head bias [1, H, S] (T5's form)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, 1, d), generator=g, device=dev).to(dtype)
    if stacked:
        kc, vc = (torch.randn((3, B, KV, S + 5, d), generator=g, device=dev).to(dtype)
                  for _ in range(2))
        k, v = kc[1, :, :, :S], vc[1, :, :, :S]
    else:
        k, v = (torch.randn((B, KV, S, d), generator=g, device=dev).to(dtype) for _ in range(2))
    valid = torch.rand((B, 1, S), generator=g, device=dev) > 0.2
    bias = torch.where(valid, 0.0, -1e9) + torch.randn((1, H, S), generator=g, device=dev)
    return q, k, v, bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,S,d,stacked", [
    (14, 32, 32, 768, 128, False), (3, 32, 8, 300, 128, False), (5, 32, 32, 11, 64, True),
    (1, 32, 32, 84, 64, True), (2, 4, 1, 1, 16, False), (2, 6, 2, 97, 80, True),
    (10, 4, 4, 11, 8, True)])
def test_cuda_decode_partials_match_plain(cuda_device, dtype, B, H, KV, S, d, stacked):
    """K12 against its plain version: o within 1e-5 + 1e-5 |ref| in f32 and
    1e-2 + 1e-2 |ref| in bf16 (the plain version widens the same bf16
    inputs; sums in another order), m equal up to the dot's rounding, l
    within 1e-5 relative."""
    from cullavo_tpu_torch.ops import flash_attention as fa

    q, k, v, bias = _decode_case(cuda_device, dtype, B, H, KV, S, d, seed=S + d, stacked=stacked)
    for scale in (d ** -0.5, 1.0):
        n0 = fa.decode_partials.launches
        o, m, l = fa.decode_partials(q, k, v, bias, scale)
        assert fa.decode_partials.launches == n0 + 1
        ro, rm, rl = fa._decode_partials_plain(q, k, v, bias.expand(B, H, S), scale)
        tol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-2, 1e-2)
        assert torch.allclose(o, ro, atol=tol[0], rtol=tol[1]), (o - ro).abs().max().item()
        assert torch.allclose(m, rm, atol=1e-4, rtol=1e-5)
        assert torch.allclose(l, rl, atol=0, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_flash_decode_masked_rows_and_refusals(cuda_device):
    """Row 5's entry: a wholly masked row averages v over the S keys; a row
    of -inf keys gives o = 0, l = 0; what the kernel does not take raises."""
    from cullavo_tpu_torch.ops import flash_attention as fa

    q, k, v, _ = _decode_case(cuda_device, torch.bfloat16, 2, 8, 2, 768, 128, seed=21)
    pos = torch.tensor([-1, 500], device=cuda_device)
    valid = torch.ones((2, 768), dtype=torch.int32, device=cuda_device)
    got = fa.flash_decode(q, k, v, pos, valid)
    mean = v[0].float().mean(dim=1).repeat_interleave(4, dim=0)
    assert torch.allclose(got[0, :, 0].float(), mean, atol=1e-2, rtol=1e-2)
    bias = torch.zeros((2, 8, 768), device=cuda_device)
    bias[1, 3] = -torch.inf
    o, m, l = fa.decode_partials(q, k, v, bias, 1.0)
    assert float(l[1, 3]) == 0.0 and not o[1, 3].any() and torch.isfinite(o).all()
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.decode_partials(q[..., :12], k[..., :12], v[..., :12], bias, 1.0)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.decode_partials(q.half(), k.half(), v.half(), bias, 1.0)
    with pytest.raises(ValueError, match="must be torch.bfloat16"):
        fa.decode_partials(q, k.float(), v.float(), bias, 1.0)
    with pytest.raises(ValueError, match="are not"):
        fa.decode_partials(q, k[:, :, :, :64], v, bias, 1.0)
