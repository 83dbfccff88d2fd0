"""Guards on the torch port as a package: it imports neither JAX nor the JAX
package (at import time or inside any function), its kernel wrappers never
launch (or count) on CPU tensors, it carries no library or compiled
stand-in for its kernels, its copy of the VQA scorer agrees with the
original, and the chip smoke script refuses to run without a CUDA device.  The tests marked ``cuda``
compare each CUDA kernel with its plain version on a card; this file
imports no JAX, so on the machine with the card they run with
``python -m pytest tests/test_torch_package.py -m cuda --noconftest``."""
import ctypes
import os
import re
import subprocess
import sys
import types
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
    "cullavo_tpu_torch.data.tokenizer_json",
    "cullavo_tpu_torch.data.kosmos2_processor",
    "cullavo_tpu_torch.checkpoint.zoo_import",
    "cullavo_tpu_torch.serving",
    "cullavo_tpu_torch.serving.engine",
    "cullavo_tpu_torch.serving.io",
    "cullavo_tpu_torch.serving.server",
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
    "cullavo_tpu_torch.data.png_io",
    "cullavo_tpu_torch.data.coco_panoptic",
    "cullavo_tpu_torch.checkpoint.store",
    "cullavo_tpu_torch.checkpoint.reference_layout",
    "cullavo_tpu_torch.trainer.loop",
    "cullavo_tpu_torch.scripts.matmul_probe",
    "cullavo_tpu_torch.scripts.flash_bench",
    "cullavo_tpu_torch.scripts.focal_phases",
    "cullavo_tpu_torch.config",
    "cullavo_tpu_torch.__main__",
    "cullavo_tpu_torch.data.instruction_data",
    "cullavo_tpu_torch.data.integrity",
    "cullavo_tpu_torch.utils.box_ops",
    "cullavo_tpu_torch.ops.point_sample",
    "cullavo_tpu_torch.models.xdecoder.matcher",
    "cullavo_tpu_torch.models.xdecoder.language_loss",
    "cullavo_tpu_torch.models.xdecoder.criterion",
    "cullavo_tpu_torch.data.coco_caption_grounding",
    "cullavo_tpu_torch.trainer.xdecoder_step",
    "cullavo_tpu_torch.data.clip_tokenizer",
    "cullavo_tpu_torch.checkpoint.xdecoder_import",
    "cullavo_tpu_torch.data.arrow_ipc",
    "cullavo_tpu_torch.data.vlp_datasets",
    "cullavo_tpu_torch.models.xdecoder.davit",
    "cullavo_tpu_torch.pipelines.vlp_pipeline",
    "cullavo_tpu_torch.pipelines.imagenet_pipeline",
    "cullavo_tpu_torch.models.blip2.opt",
    "cullavo_tpu_torch.parallel",
    "cullavo_tpu_torch.parallel.mesh",
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
              " 'optax', 'transformers', 'tokenizers', 'safetensors', 'PIL', 'pyarrow',"
              " 'sentencepiece')]\n"
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
            PORT / "data" / "step1_synthesis.py", PORT / "trainer" / "loop.py",
            PORT / "checkpoint" / "store.py", PORT / "checkpoint" / "reference_layout.py",
            PORT / "data" / "coco_panoptic.py", PORT / "data" / "png_io.py",
            PORT / "scripts" / "matmul_probe.py"} <= set(paths)
    for path in paths:
        hit = banned.search(path.read_text())
        assert hit is None, f"{path.relative_to(REPO)}: {hit.group(0).strip()!r}"
    assert banned.search("    from cullavo_tpu.data import x") and banned.search("import jax")
    assert banned.search("    import yaml") and banned.search("import optax")
    assert not banned.search("from cullavo_tpu_torch.ops import nf4")


def test_port_reads_snapshots_without_the_hf_libraries():
    """No import of transformers, tokenizers, sentencepiece or safetensors
    anywhere in the port or in ``chip_smoke.py`` (the machine with the card
    has none of them: the port reads safetensors, tokenizer.json and
    SentencePiece's charsmap itself); PIL only inside ``load_image_rgb``."""
    hf = re.compile(r"^\s*(import|from)\s+(transformers|tokenizers|sentencepiece|safetensors)"
                    r"(\.|\s|$)", re.M)
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
    assert hf.search("import sentencepiece as spm")
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
    from cullavo_tpu_torch.scripts import matmul_probe as mp

    wrappers = (fa.flash_attention, fa.flash_lse, fa.flash_rows, nf4.quantize_rows,
                nf4.int8_linear, ww.wwin_decode_smajor, ww.wwin_decode_smajor_q8,
                nf4.nf4_linear_planar, nf4.nf4_dequant_planar,
                msdeform.ms_deform_attn_kernel, focal.focal_ctx_kernel,
                nf4.nf4_linear_q4, nf4.nf4_dequant_q4, fa.decode_partials,
                fa.flash_attention_packed, mp.p32_linear)
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
    xp = torch.randn(1, 5, 256, requires_grad=True)
    fa.flash_attention_packed(xp, xp, xp, 2).sum().backward()          # K13's form + its vjp
    w8 = torch.randint(-127, 128, (32, 16), dtype=torch.int8)
    mp.p32_linear(torch.randn(3, 32).to(torch.bfloat16), mp.pack_p32(w8), torch.ones(16))
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
    # K1, K1-lse and K8 (csrc/flash_fwd_sm90.cu) take tensor maps laid out on
    # the host by one _tma_layout call ahead of the choice of form; K13's
    # entry encodes its own, from no strides
    flash = cuda_half[:cuda_half.index("def _packed_cuda")]
    assert flash.count("_tma_layout(") == 1
    assert flash.index("_tma_layout(") < flash.index("if causal and q_positions is None")
    for entry in ("cullavo_flash_fwd(", "cullavo_flash_fwd_lse(", "cullavo_flash_rows("):
        call = flash[flash.index(entry):]
        assert "layout, d ** -0.5, stream)" in call[:call.index(")\n") + 2], entry
    packed_cuda = cuda_half[cuda_half.index("def _packed_cuda"):cuda_half.index("def _decode_cuda")]
    assert "_tma_layout" not in packed_cuda and "stride(" not in packed_cuda
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
    # K13 (packed heads): the same rule, forward and backward
    xp = torch.randn(1, 4, 256, device="meta", dtype=torch.bfloat16)
    n0 = fa.flash_attention_packed.launches
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_packed(xp, xp, xp, 2)
    assert fa.flash_attention_packed.launches == n0
    packed = src[src.index("class _FlashPacked"):src.index("def flash_attention_packed")]
    assert packed.count("_packed_plain(") == 1 and packed.count("mha_reference(") == 1
    assert packed.count('if q.device.type == "cpu":') == 2
    assert "def _packed_cuda" in cuda_half


# K1, K1-lse and K8 read q, k, v and write o through TMA tensor maps whose
# extents and byte strides the wrapper computes from the views on the host
_B, _T, _H, _D = 3, 648, 32, 128


@pytest.mark.parametrize("case,make,want", [
    ("strided head views of [B, T, H, d]",
     lambda: torch.empty(_B, _T, _H, _D).transpose(1, 2),
     [_H, _T, _B, 2 * _D, 2 * _H * _D, 2 * _T * _H * _D]),
    ("contiguous [B, H, T, d]",
     lambda: torch.empty(_B, _H, _T, _D),
     [_H, _T, _B, 2 * _T * _D, 2 * _D, 2 * _H * _T * _D]),
    ("heads expanded (stride 0): extent 1, read at head 0",
     lambda: torch.empty(_B, 1, _T, _D).expand(_B, _H, _T, _D),
     [1, _T, _B, 2 * _D, 2 * _D, 2 * _T * _D]),
    ("batch expanded (stride 0): extent 1, read at batch row 0",
     lambda: torch.empty(1, _H, _T, _D).expand(_B, _H, _T, _D),
     [_H, _T, 1, 2 * _T * _D, 2 * _D, 2 * _D]),
    ("a single row: its axis is never stepped",
     lambda: torch.empty(_B, 1, _H, _D).transpose(1, 2),
     [_H, 1, _B, 2 * _D, 2 * _D, 2 * _H * _D]),
])
def test_tma_layout_of_k1_operands(case, make, want):
    from cullavo_tpu_torch.ops import flash_attention as fa

    t = make()
    assert fa._tma_layout(t.shape, t.stride()) == want, case


@pytest.mark.parametrize("case,shape,stride,match", [
    ("rows expanded (stride 0)", (2, 4, 8, 128), (4 * 128, 128, 0, 1), "rows with stride 0"),
    ("a head stride of 260 bytes", (2, 4, 8, 128), (8 * 4 * 130, 130, 4 * 130, 1),
     "multiples of 16 bytes"),
    ("a batch stride of 2**40 bytes", (2, 4, 8, 128), (2 ** 39, 1024, 128, 1),
     "multiples of 16 bytes below 2\\*\\*40"),
    ("a head dim with stride 2", (2, 4, 8, 128), (8192, 2048, 256, 2), "contiguous head dim"),
])
def test_tma_layout_refuses_what_tma_cannot_take(case, shape, stride, match):
    """Raised on the host, before a tensor map is encoded or a kernel
    launched (the wrapper computes every layout first)."""
    from cullavo_tpu_torch.ops import flash_attention as fa

    with pytest.raises(ValueError, match=match):
        fa._tma_layout(shape, stride)


def _packed_layout_of_the_c_entry(B, H, rows, d=128):
    """``packed_layout`` of csrc/flash_fwd_sm90.cu, which K13's entry point
    encodes for q/o (rows = T) and k/v (rows = S): dims (d, H, rows, B),
    byte strides (2d, 2Hd, 2 rows Hd), an axis of extent 1 stepped by 2d."""
    n, st = (H, rows, B), (2 * d, 2 * H * d, 2 * rows * H * d)
    return list(n) + [2 * d if n_ == 1 else s for n_, s in zip(n, st)]


def test_packed_layout_of_the_c_entry_is_the_transcribed_one():
    """The transcription above is the C helper's rule, line for line."""
    src = (PORT / "csrc" / "flash_fwd_sm90.cu").read_text()
    helper = src[src.index("void packed_layout("):src.index("template <bool kLse, bool kMasked>\nint launch(")]
    assert "const long long n[3] = {H, rows, B};" in helper
    assert "const long long st[3] = {2LL * D, 2LL * H * D, 2LL * rows * H * D};" in helper
    assert "layout[3 + i] = n[i] == 1 ? 2LL * D : st[i];" in helper
    entry = src[src.index('extern "C" int cullavo_flash_packed('):]
    for rows, off in (("T", ""), ("S", " + 6"), ("S", " + 12"), ("T", " + 18")):
        assert f"packed_layout(layout{off}, B, H, {rows});" in entry


@pytest.mark.parametrize("B,T,S,H", [(3, 648, 648, 32), (8, 1024, 1024, 32), (3, 601, 648, 32),
                                     (2, 37, 45, 2), (1, 1, 1, 1), (1, 200, 333, 1),
                                     (2, 1, 130, 4)])
def test_packed_head_views_take_the_layout_k13_encodes(B, T, S, H):
    """K13's entry encodes, without strides from Python, the maps that
    ``_tma_layout`` gives the [B, H, T|S, d] head views of the packed
    tensors (so K13 runs K1's kernel on K1's own layouts); both equal the
    byte strides numpy gives the same views of a 2-byte array."""
    import numpy as np

    from cullavo_tpu_torch.ops import flash_attention as fa

    d = 128
    for rows in (T, S):
        view = fa._packed_to_heads(torch.empty(B, rows, H * d, dtype=torch.bfloat16), H)
        got = fa._tma_layout(view.shape, view.stride())
        a = np.empty((B, rows, H * d), np.float16).reshape(B, rows, H, d).transpose(0, 2, 1, 3)
        want = [H, rows, B] + [2 * d if n == 1 else int(a.strides[ax])
                               for n, ax in ((H, 1), (rows, 2), (B, 0))]
        assert got == want == _packed_layout_of_the_c_entry(B, H, rows), (rows, got, want)


class _FakeKernels:
    """Stands in for ``_build.lib()``: records each entry point's call (the
    layout array and the int32 masks read through their pointers while the
    call lasts) and returns 0."""

    def __init__(self):
        self.calls = []

    def _record(self, name, args, masks=()):
        import numpy as np

        rec = {"name": name, "args": args}
        for key, ptr, n in masks:
            rec[key] = None if ptr is None else np.ctypeslib.as_array(
                (ctypes.c_int32 * n).from_address(ptr)).copy()
        self.calls.append(rec)
        return 0

    def cullavo_flash_fwd(self, q, k, v, o, B, H, T, d, layout, scale, stream):
        return self._record("fwd", dict(B=B, H=H, T=T, d=d, layout=list(layout), scale=scale,
                                        stream=stream, ptrs=(q, k, v, o)))

    def cullavo_flash_fwd_lse(self, q, k, v, o, lse, B, H, T, d, layout, scale, stream):
        return self._record("fwd_lse", dict(B=B, H=H, T=T, d=d, layout=list(layout),
                                            scale=scale, stream=stream, ptrs=(q, k, v, o, lse)))

    def cullavo_flash_rows(self, q, k, v, o, lse, qpos, kvalid, causal, B, H, T, S, d, layout,
                           scale, stream):
        return self._record("rows", dict(B=B, H=H, T=T, S=S, d=d, causal=causal,
                                         layout=list(layout), scale=scale, stream=stream,
                                         ptrs=(q, k, v, o, lse)),
                            (("qpos", qpos, B * T), ("kvalid", kvalid, B * S)))

    def cullavo_flash_packed(self, q, k, v, o, B, H, T, S, d, scale, stream):
        return self._record("packed", dict(B=B, H=H, T=T, S=S, d=d, scale=scale, stream=stream,
                                           ptrs=(q, k, v, o)))


@pytest.mark.parametrize("smooth", [True, False], ids=["sq_inv", "no_sq_inv"])
@pytest.mark.parametrize("M", [8, 14, 56, 5632])
def test_int8_linear_reaches_its_entry_with_the_plan(monkeypatch, M, smooth):
    """With a fake kernel library (no card here): K3's wrapper makes one call
    of ``cullavo_int8_linear`` at every M, the prefill's too, with the plan
    of ``int8_gemv_plan`` on a 132-SM card, the bf16 scratch for bf16(x *
    sq_inv) only for a dict with sq_inv, the split-K workspace and counters
    only where the plan splits, and counts one launch."""
    from cullavo_tpu_torch import _build
    from cullavo_tpu_torch.ops import nf4

    calls = []

    class Fake:
        def cullavo_int8_linear(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(_build, "lib", lambda: Fake())
    monkeypatch.setattr(nf4, "_sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=77))
    K, N = 4096, 11008
    q = nf4.quantize_linear_int8(torch.randn(K, N), smooth_scale=torch.rand(K) + 0.5
                                 if smooth else None)
    x = torch.randn(M, K).to(torch.bfloat16)
    n0 = nf4.int8_linear.launches
    out = nf4._int8_linear_cuda(x, q)
    assert out.shape == (M, N) and out.dtype == torch.bfloat16
    assert nf4.int8_linear.launches == n0 + 1
    (args,) = calls
    xp, sq, q8, s8, xs, o, ws, ctr, m, k, n, nt, g, S, stream = args
    plan = nf4.int8_gemv_plan(M, K, N, 132)
    assert (m, k, n, nt, g, S, stream) == (M, K, N, plan["nt"], plan["g"], plan["splits"], 77)
    assert (xp, q8, s8, o) == (x.data_ptr(), q["q8"].data_ptr(), q["scale8"].data_ptr(),
                               out.data_ptr())
    assert (sq is None, xs is None) == (not smooth, not smooth)
    assert (ws is None, ctr is None) == (S == 1, S == 1)
    if M == 5632:
        assert (nt, S) == (256, 1)


@pytest.mark.parametrize("mode", ["K1", "K1-lse", "K8 positions", "K8-lse kv_valid, non-causal",
                                  "K8 S > T", "K8-lse both masks", "K13", "K13 S > T"])
def test_forward_forms_reach_their_entry_points(monkeypatch, mode):
    """With a fake kernel library and stream (no card here): each mode of
    ``_flash_cuda`` / ``_packed_cuda`` reaches its C entry with the layouts
    ``_tma_layout`` gives q, k, v and the output, the masks as int32 rows,
    the scale d^-0.5 and the caller's stream, and counts one launch on its
    own counter only."""
    import numpy as np

    from cullavo_tpu_torch import _build
    from cullavo_tpu_torch.ops import flash_attention as fa

    fake = _FakeKernels()
    monkeypatch.setattr(_build, "lib", lambda: fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=4242))
    counters = {"K1": fa.flash_attention, "K1-lse": fa.flash_lse, "K8": fa.flash_rows,
                "K13": fa.flash_attention_packed}
    before = {n: c.launches for n, c in counters.items()}
    rng = np.random.default_rng(7)
    B, H, d = 2, 3, 128
    T, S = (5, 9) if "S > T" in mode else (6, 6)

    def bf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)

    if mode.startswith("K13"):
        q, k, v = bf(B, T, H * d), bf(B, S, H * d), bf(B, S, H * d)
        out = fa._packed_cuda(q, k, v, H)
        (call,) = fake.calls
        assert call["name"] == "packed" and out.shape == q.shape
        assert {k_: call["args"][k_] for k_ in ("B", "H", "T", "S", "d")} == \
            dict(B=B, H=H, T=T, S=S, d=d)
        assert call["args"]["ptrs"] == tuple(t.data_ptr() for t in (q, k, v, out))
        assert call["args"]["stream"] == 4242 and call["args"]["scale"] == d ** -0.5
        name = "K13"
    else:
        q = bf(B, T, H, d).transpose(1, 2)                  # head views of [B, T, H, d]
        k, v = bf(B, H, S, d), bf(B, 1, S, d).expand(B, H, S, d)
        pos = valid = None
        causal = "non-causal" not in mode
        if "positions" in mode or "both" in mode:
            pos = torch.from_numpy(rng.integers(-1, S + 2, (B, T))).to(torch.int64)
        if "kv_valid" in mode or "both" in mode:
            valid = torch.from_numpy(rng.random((B, S)) < 0.7)   # bool
        need_lse = "-lse" in mode
        res = fa._flash_cuda(q, k, v, pos, valid, causal, need_lse)
        out, lse = res if need_lse else (res, None)
        (call,) = fake.calls
        args = call["args"]
        want = [x for t in (q, k, v, out) for x in fa._tma_layout(t.shape, t.stride())]
        assert args["layout"] == want and len(want) == 24
        assert want[12:15] == [1, S, B]                      # v's heads: extent 1, read at 0
        assert out.shape == (B, H, T, d) and out.stride() == (T * H * d, d, H * d, 1)
        assert args["stream"] == 4242 and args["scale"] == d ** -0.5
        assert args["ptrs"][:4] == tuple(t.data_ptr() for t in (q, k, v, out))
        assert (args["B"], args["H"], args["T"], args["d"]) == (B, H, T, d)
        name = mode.split()[0].split("-")[0]
        if name == "K1":
            assert call["name"] == ("fwd_lse" if need_lse else "fwd")
            if need_lse:
                assert lse.shape == (B, H, T) and args["ptrs"][4] == lse.data_ptr()
            name = "K1-lse" if need_lse else "K1"
        else:
            assert call["name"] == "rows"
            assert (args["S"], args["causal"]) == (S, int(causal))
            assert args["ptrs"][4] == (lse.data_ptr() if need_lse else None)
            for key, m in (("qpos", pos), ("kvalid", valid)):
                if m is None:
                    assert call[key] is None, key
                else:
                    np.testing.assert_array_equal(call[key], m.to(torch.int32).numpy().ravel())
    after = {n: c.launches for n, c in counters.items()}
    assert after == {n: before[n] + (n == name) for n in counters}, (mode, before, after)


def test_p32_wrapper_takes_the_plain_version_only_for_cpu_tensors():
    """K14's wrapper: a tensor that is not on the CPU goes to the kernel or
    raises; its CUDA half holds no product of its own."""
    from cullavo_tpu_torch.scripts import matmul_probe as mp

    meta = torch.zeros(2, 16, device="meta", dtype=torch.bfloat16)
    n0 = mp.p32_linear.launches
    with pytest.raises(ValueError, match="unsupported device"):
        mp.p32_linear(meta, meta, meta)
    assert mp.p32_linear.launches == n0
    src = (PORT / "scripts" / "matmul_probe.py").read_text()
    cuda_half = src[src.index("def _p32_cuda"):src.index("def _s8s8")]
    for banned in ("matmul", " @ ", "_plain(", "einsum", "_int_mm"):
        assert banned not in cuda_half, banned


# every ``try`` of the port: (file, enclosing function, caught exceptions,
# has a finally).  The HTTP front end turns a bad request into a 400, a
# deadline into a 504 (a stream's into its timeout line) and a failed
# scheduler into a 500 / 503; the scheduler thread keeps its error for the
# waiters and re-raises; ``_serve_http`` stops the runner and closes the
# socket on SIGINT.  No try wraps an engine step that carries on, or a launch.
def test_the_raises_that_remain_name_their_items():
    """What the port still refuses names its item of ROADMAP.md's queue 1:
    the cached forward without stale_cache over an int8 cache (4).  The zoo
    snapshots (2.4), BakLLaVA (2.5) and the OPT tower (2.6) run now: a
    snapshot directory without its files raises naming the file, and
    BakLLaVA without ``MODEL.ZOO_PATH`` exits as JAX's entry does; the fsdp
    / tensor axes (3) run on several processes, and one process with one of
    them raises JAX's ``ValueError``."""
    from cullavo_tpu_torch import entry
    from cullavo_tpu_torch.checkpoint import zoo_import
    from cullavo_tpu_torch.models.blip2 import config as bcfg
    from cullavo_tpu_torch.models.blip2 import modeling as bmod
    from cullavo_tpu_torch.models.llava import llama
    from cullavo_tpu_torch.pipelines import vl_zoo_pipeline as zoo

    for zoo_name in ("blip2", "instructblip", "kosmos2", "bakllava"):
        with pytest.raises(FileNotFoundError, match="config.json"):
            entry.evaluate({"NAME": "vl_test", "MODEL": {"ZOO": zoo_name, "ZOO_PATH": "/x"}},
                           device="cpu")
    with pytest.raises(SystemExit, match="bakllava needs MODEL.ZOO_PATH"):
        entry.evaluate({"NAME": "vl_test", "MODEL": {"ZOO": "bakllava"}}, device="cpu")
    for fn in (lambda: zoo.native_blip2_imagenet_fns(hf_model_dir="/x", device="cpu"),
               lambda: zoo.native_blip2_answer_fn(hf_model_dir="/x", device="cpu"),
               lambda: zoo.native_kosmos2_answer_fn(hf_model_dir="/x", device="cpu"),
               lambda: zoo.native_bakllava_answer_fn("/x", device="cpu")):
        with pytest.raises(FileNotFoundError, match="config.json"):
            fn()
    opt = bcfg.tiny_blip2_config("opt")
    assert bmod.init_blip2_params(opt, torch.Generator(), "cpu")["language_model"]["layers"]
    for fn in (lambda: zoo.native_blip2_answer_fn(hf_model_dir="/x", kind="opt", device="cpu"),
               lambda: zoo_import.check_blip2_config("/x", opt)):
        with pytest.raises(FileNotFoundError, match="config.json"):
            fn()
    for over, msg in (({"MESH_FSDP": 2}, "mesh 0x2x1 != 1 devices"),
                      ({"MESH_TENSOR": 4}, "mesh 0x1x4 != 1 devices")):
        with pytest.raises(ValueError, match=msg):
            entry.train({"NAME": "xdecoder_train", "MODEL": {"TINY": True}, **over},
                        device="cpu")
    tc = bcfg.tiny_blip2_config("llama_text").text
    lm = llama.init_llama_params(tc, torch.Generator().manual_seed(0), "cpu")
    cache = llama.init_kv_cache(tc, 1, 4, kv_quant="int8")
    with pytest.raises(NotImplementedError, match="sdpa_smajor_q8.*item 4"):
        llama.llama_forward(lm, tc, torch.zeros(1, 2, tc.hidden_size), torch.ones(1, 4),
                            torch.arange(2)[None], cache, 0)


ALLOWED_TRY = sorted([
    ("serving/server.py", "_Handler.do_POST", ("ValueError", "json.JSONDecodeError"), False),
    ("serving/server.py", "_Handler.do_POST", ("KeyError", "SchedulerFailed", "ValueError"),
     False),
    ("serving/server.py", "_Handler.do_POST", ("SchedulerFailed", "TimeoutError"), False),
    ("serving/server.py", "_Handler._stream_reply", ("queue.Empty",), False),
    ("serving/server.py", "EngineRunner._loop", ("BaseException",), False),
    ("entry.py", "_serve_http", ("KeyboardInterrupt",), True),
])


def _try_sites():
    import ast

    found = []

    def walk(node, scope, rel):
        for child in ast.iter_child_nodes(node):
            inner = scope
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                inner = f"{scope}.{child.name}" if scope else child.name
            if isinstance(child, (ast.Try, getattr(ast, "TryStar", ast.Try))):
                names = []
                for h in child.handlers:
                    types = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
                    names += ["<bare>" if t is None else ast.unparse(t) for t in types]
                    if names[-1] == "BaseException":   # the scheduler guard re-raises
                        assert isinstance(h.body[-1], ast.Raise) and h.body[-1].exc is None
                found.append((rel, scope, tuple(sorted(names)), bool(child.finalbody)))
            walk(child, inner, rel)

    for path in sorted(PORT.rglob("*.py")):
        walk(ast.parse(path.read_text()), "", path.relative_to(PORT).as_posix())
    return sorted(found)


def test_try_statements_only_at_the_http_sites():
    """The port's ``try`` statements sit only at the HTTP front end's
    sites and catch only the exceptions listed there."""
    assert _try_sites() == ALLOWED_TRY


def test_port_has_no_library_stand_ins_for_its_kernels():
    """No fused-attention or grid-sampling library call, torch.compile, or
    import of JAX anywhere in the port's sources (a CPU fallback after a
    failed launch would need a ``try``: test_try_statements_only_at_the_http_sites);
    the CUDA routes of K9 and K10 hold no gather and no (depthwise)
    convolution."""
    banned = (r"scaled_dot_product_attention", r"grid_sample\s*\(", r"torch\.compile",
              r"^\s*import jax", r"^\s*from jax")
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
@pytest.mark.parametrize("mult", [None, "bf16", "f32"])
@pytest.mark.parametrize("K", [16, 4096, 11008, 24576])
@pytest.mark.parametrize("M", [1, 7, 1296, 4536, 4537])
def test_cuda_quantize_rows_edges_bit_equal(cuda_device, M, K, mult):
    """K2 at the greedy batch's M (7 x 648 = 4536) and around it, one row,
    a row of 16 and of the kernel's widest 24576: codes and sx bit-equal to
    the plain version, with no multiplier, the bf16 ``sq_inv`` [1, K] of a
    SmoothQuant dict or an f32 one, and one launch a call."""
    from cullavo_tpu_torch.ops import nf4

    g = torch.Generator(device=cuda_device).manual_seed(M + K)
    x = (torch.randn((M, K), generator=g, device=cuda_device) * 3).to(torch.bfloat16)
    x[0, K // 3] = 40.0                   # one outlier sets row 0's scale
    m = None if mult is None else torch.exp(
        torch.randn((1, K), generator=g, device=cuda_device) * 0.3)
    if mult == "bf16":
        m = m.to(torch.bfloat16)
    n0 = nf4.quantize_rows.launches
    xi, sx = nf4.quantize_rows(x, m)
    assert nf4.quantize_rows.launches == n0 + 1
    xr, sr = nf4._quantize_rows_plain(x, m)
    assert xi.dtype == torch.int8 and sx.shape == (M, 1)
    assert torch.equal(xi, xr)
    assert torch.equal(sx, sr)


def _int8_case(dev, M, K, N, smooth, seed=2):
    from cullavo_tpu_torch.ops import nf4

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((K, N), generator=g, device=dev) * K ** -0.5
    s = torch.exp(torch.randn((K,), generator=g, device=dev) * 0.3) if smooth else None
    return x, nf4.quantize_linear_int8(w, smooth_scale=s)


@pytest.mark.cuda
@pytest.mark.parametrize("smooth", [True, False], ids=["sq_inv", "no_sq_inv"])
@pytest.mark.parametrize("M", [1, 8, 14, 33, 56, 64, 300, 1100])
def test_cuda_int8_linear_matches_plain(cuda_device, M, smooth):
    """K3 at the decode M of the paths (1-64: token tiles of 16-64, split-K)
    and beyond one 256-token tile (300, 1100: the prefill tiles), with and
    without the SmoothQuant prologue, N = 272 (a ragged last 64-column
    block) and K = 320 (five 64-k stages): one bf16 ulp (the one rounding,
    after an f32 sum in another order) + 1e-3 of the largest |y|."""
    from cullavo_tpu_torch.ops import nf4

    x, q = _int8_case(cuda_device, M, 320, 272, smooth)
    n0 = nf4.int8_linear.launches
    y = nf4.int8_linear(x, q)
    assert nf4.int8_linear.launches == n0 + 1
    ref = nf4._int8_linear_plain(x, q)
    assert torch.allclose(y.float(), ref.float(), rtol=2 ** -7,
                          atol=1e-3 * ref.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("M", [14, 56, 600])
def test_cuda_int8_linear_bit_equal_and_refusals(cuda_device, M):
    """Two calls of K3 are bit-equal (split-K sums its partials in split
    order; M = 600 takes no split) at a 7B weight shape; a K that is not a
    multiple of 8 (x's rows feed a tensor map of 16-byte strides) and an N
    that is not a multiple of 16 are refused."""
    from cullavo_tpu_torch.ops import nf4

    x, q = _int8_case(cuda_device, M, 4096, 11008, True, seed=3)
    assert torch.equal(nf4.int8_linear(x, q), nf4.int8_linear(x, q))
    xk, qk = _int8_case(cuda_device, 4, 324, 272, True)
    with pytest.raises(ValueError, match="K % 8 == 0"):
        nf4.int8_linear(xk, qk)
    xn, qn = _int8_case(cuda_device, 4, 320, 264, False)
    with pytest.raises(ValueError, match="N % 16 == 0"):
        nf4.int8_linear(xn, qn)


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
@pytest.mark.parametrize("W", [1, 4, 40])
def test_cuda_wwin_decode_q8_odd_plane_strides(cuda_device, W):
    """K5 reads each bf16 scale as the aligned 4-byte word holding it and
    picks the half by the element's parity: with B = 3 rows of one kv head
    the planes' slot stride is 3 elements, so the parity alternates from
    slot to slot, on the lane-group body (W = 1), the mma body widening in
    its fragments (W = 4) and widening each stage once (W = 40)."""
    from cullavo_tpu_torch.models.llava.llama import quantize_kv
    from cullavo_tpu_torch.ops import wwin_decode as ww

    g = torch.Generator(device=cuda_device).manual_seed(60 + W)
    B, KV, S, hd = 3, 1, 150, 128
    kc, vc = (torch.randn((2, S, B, KV, hd), generator=g, device=cuda_device) * 2
              for _ in range(2))
    (kq, ks), (vq, vs) = quantize_kv(kc), quantize_kv(vc)
    assert ks.stride(1) == 3
    q = torch.randn((B, W, KV, hd), generator=g, device=cuda_device).to(torch.bfloat16)
    q = q.transpose(1, 2)
    bias = torch.zeros((B, W, S), device=cuda_device)
    bias[1, :, S - 5:] = ww.NEG_INF
    got = ww._run_cache_part_q8(q, kq, ks, vq, vs, 1, bias, 1, 128 ** -0.5)
    _assert_partials_close(got, ww._cache_part_q8_plain(q, kq, ks, vq, vs, 1, bias, 1,
                                                        128 ** -0.5))


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


# the fused kernels' tile edges (csrc/nf4_gemv_sm90.cu): token tiles of 16,
# 32 and 64 (M = 65 and up take several), 4 blocks of 64 columns per CTA
# (N = 320: a CTA with one live block), 64 k per ring stage (K = 1096:
# K/8 = 137 word rows, not a multiple of 8, and a ragged last stage), split-K
# in clusters of up to 8 CTAs (K = 4096)
NF4_GEMV_M = [1, 8, 9, 14, 16, 17, 63, 64, 65, 129, 255, 256, 257, 300, 511, 700]
NF4_GEMV_KN = [(128, 192), (1096, 64), (1096, 320), (4096, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("M", NF4_GEMV_M)
@pytest.mark.parametrize("K,N", NF4_GEMV_KN)
def test_cuda_nf4_linear_planar_matches_plain(cuda_device, M, K, N):
    """K6 against its plain version within 1e-2 + 1e-2 |ref| at the tile
    edges; two calls bit-identical (split-K is summed in a fixed order)."""
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
@pytest.mark.parametrize("M", NF4_GEMV_M)
@pytest.mark.parametrize("K,N", NF4_GEMV_KN)
def test_cuda_nf4_linear_q4_matches_plain(cuda_device, M, K, N):
    """K11 against its f32 plain version within 1e-2 + 1e-2 |ref| (the f32
    weight as two bf16 terms, f32 sums in another order, one bf16 rounding
    on each side) at the tile edges of K6's test; two calls bit-identical.
    Row 8: the same kernel fed an NF4Tensor's decoded absmax."""
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
@pytest.mark.parametrize("T", [1, 64, 127, 128, 129, 200, 648])
@pytest.mark.parametrize("strided", [True, False])
def test_cuda_flash_sm90_k1_and_lse_match_plain(cuda_device, T, strided):
    """K1 and K1-lse (csrc/flash_fwd_sm90.cu) against mha_reference at the
    edge values of T, on strided head views and contiguous tensors: o within
    1e-2 + 1e-2 |ref|, the f32 lse within 2e-3; K1-lse's o bit-equal to
    K1's, a second launch bit-equal to the first, each launch counted."""
    from cullavo_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=cuda_device).manual_seed(13 + T)
    shape = (2, T, 4, 128) if strided else (2, 4, T, 128)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).to(torch.bfloat16)
               for _ in range(3))
    if strided:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    n0, n1 = fa.flash_attention.launches, fa.flash_lse.launches
    o1 = fa.flash_attention(q, k, v)
    got = fa._flash_cuda(q, k, v, None, None, True, True)
    again = fa._flash_cuda(q, k, v, None, None, True, True)
    assert (fa.flash_attention.launches, fa.flash_lse.launches) == (n0 + 1, n1 + 2)
    _assert_attention_close(got, fa.mha_reference(q, k, v, need_lse=True), f"K1 T={T}")
    assert torch.equal(got[0], o1)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.cuda
def test_cuda_flash_sm90_broadcast_heads_and_refusals(cuda_device):
    """k/v expanded over heads (a stride-0 axis read at coordinate 0) match
    the plain version; rows expanded with stride 0 raise before any launch."""
    from cullavo_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=cuda_device).manual_seed(14)
    q = torch.randn((2, 4, 300, 128), generator=g, device=cuda_device).to(torch.bfloat16)
    k, v = (torch.randn((2, 1, 300, 128), generator=g, device=cuda_device)
            .to(torch.bfloat16).expand(2, 4, 300, 128) for _ in range(2))
    _assert_attention_close(fa._flash_cuda(q, k, v, None, None, True, True),
                            fa.mha_reference(q, k, v, need_lse=True), "K1 expanded k/v")
    rows = q[:, :, :1].expand(2, 4, 300, 128)
    n0 = fa.flash_attention.launches
    with pytest.raises(ValueError, match="rows with stride 0"):
        fa.flash_attention(q, rows, rows)
    assert fa.flash_attention.launches == n0


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
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 127, 128, 129, 648])
@pytest.mark.parametrize("T", [1, 127, 128, 129, 648])
def test_cuda_flash_rows_sm90_edges_match_plain(cuda_device, T, S, causal):
    """K8 on the Hopper kernel (csrc/flash_fwd_sm90.cu) at the edge values of
    T and S (one row or key, the ragged tiles either side of 128, the
    probe's 648), S < T, S == T and S > T, causal or not: positions drawn
    from [-2, S + 2) (rows with no visible key, positions past S) and 80%
    of the keys valid; o within 1e-2 + 1e-2 |ref|, the lse within 2e-3 (rtol
    1e-5 for the masked rows' -1e30); the o-only form bit-equal to the lse
    form, a second launch bit-equal to the first."""
    from cullavo_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=cuda_device).manual_seed(100 + 7 * T + S)
    q = torch.randn((2, T, 2, 128), generator=g, device=cuda_device).to(torch.bfloat16)
    k, v = (torch.randn((2, S, 2, 128), generator=g, device=cuda_device).to(torch.bfloat16)
            for _ in range(2))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    pos = torch.randint(-2, S + 2, (2, T), generator=g, device=cuda_device, dtype=torch.int32)
    valid = (torch.rand((2, S), generator=g, device=cuda_device) < 0.8).int()
    n0 = fa.flash_rows.launches
    got = fa._flash_cuda(q, k, v, pos, valid, causal, True)
    again = fa._flash_cuda(q, k, v, pos, valid, causal, True)
    o_only = fa._flash_cuda(q, k, v, pos, valid, causal, False)
    assert fa.flash_rows.launches == n0 + 3
    _assert_attention_close(got, fa.mha_reference(q, k, v, causal, pos, valid, need_lse=True),
                            f"K8 T={T} S={S} causal={causal}")
    assert torch.equal(o_only, got[0])
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("T,S", [(150, 200), (64, 300), (300, 77)])
def test_cuda_flash_rows_wholly_masked_rows_average_v(cuda_device, T, S):
    """Rows with no visible key (batch row 1: every key invalid; batch row
    0: its first rows at position -1), S not a multiple of 128: o is the mean
    of v over the S keys (keys past S excluded), the lse <= -1e29."""
    from cullavo_tpu_torch.ops import flash_attention as fa

    q, k, v, _, _ = _flash_case(cuda_device, 2, 2, T, S, seed=40 + S)
    pos = torch.arange(T, device=cuda_device, dtype=torch.int32)[None].repeat(2, 1)
    pos[0, :5] = -1
    valid = torch.ones((2, S), device=cuda_device, dtype=torch.int32)
    valid[1] = 0
    o, lse = fa._flash_cuda(q, k, v, pos, valid, True, True)
    _assert_attention_close((o, lse), fa.mha_reference(q, k, v, True, pos, valid, need_lse=True),
                            f"K8 masked rows T={T} S={S}")
    mean = v.float().mean(dim=2)                        # [B, H, d]
    for bi, rows in ((0, slice(0, 5)), (1, slice(0, T))):
        assert (lse[bi, :, rows] <= -1e29).all()
        assert torch.allclose(o[bi, :, rows].float(), mean[bi][:, None].expand_as(
            o[bi, :, rows]), atol=2e-2), (bi, (o[bi, :, rows].float() - mean[bi][:, None]).abs().max())


@pytest.mark.cuda
def test_cuda_flash_rows_expanded_kv_heads(cuda_device):
    """K8 with k/v expanded over heads (stride 0, one map extent, read at
    head 0) and over the batch, against the plain version."""
    from cullavo_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=cuda_device).manual_seed(41)
    q = torch.randn((2, 4, 300, 128), generator=g, device=cuda_device).to(torch.bfloat16)
    k, v = (torch.randn((1, 1, 333, 128), generator=g, device=cuda_device)
            .to(torch.bfloat16).expand(2, 4, 333, 128) for _ in range(2))
    pos = torch.arange(300, device=cuda_device, dtype=torch.int32)[None].repeat(2, 1) + 20
    valid = (torch.arange(333, device=cuda_device) % 7 != 3).int()[None].repeat(2, 1)
    for causal in (True, False):
        _assert_attention_close(fa._flash_cuda(q, k, v, pos, valid, causal, True),
                                fa.mha_reference(q, k, v, causal, pos, valid, need_lse=True),
                                f"K8 expanded k/v causal={causal}")


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes,Q,Hh,hd,P", [
    (((64, 64), (32, 32), (16, 16)), 3001, 8, 64, 4),   # the encoder's levels, Q ragged
    (((12, 10), (6, 5), (3, 3)), 130, 2, 128, 4),        # the 3 x 4 body at hd 128
    (((12, 10), (6, 5), (3, 3)), 64, 3, 32, 4),          # the 3 x 4 body at hd 32, one tile
    (((9, 13), (5, 7)), 77, 2, 32, 3),                   # the generic body at hd 32
    (((5, 6), (3, 3), (2, 2), (1, 1)), 41, 3, 64, 5),    # 20 points: two chunks
    (((6, 4),), 1, 1, 128, 1)])                          # one query, one point
def test_cuda_ms_deform_attn_edges(cuda_device, dtype, shapes, Q, Hh, hd, P):
    """K9 at its edges against the plain version: both bodies, every head
    dim, Q that fills no tile of 64, points outside the maps (about a
    tenth, and some at +-1e30) that contribute nothing, points that are not
    finite and are skipped (the plain version, which would give NaN, is fed
    weight 0 there), weights in the value's dtype; within 1e-5 in f32,
    1e-2 + 1e-2 |ref| in bf16."""
    from cullavo_tpu_torch.ops import msdeform

    B = 2
    value, loc, att = _msdeform_case(cuda_device, dtype, shapes, B, Q, Hh, hd, P, seed=Q + hd)
    att = att.to(dtype)
    loc[0, :5, 0, 0, 0] = float("nan")
    loc[1, -3:, -1, -1, -1, 1] = float("inf")
    loc[1, Q // 2, 0] = float("-inf")
    loc[0, Q // 3, :, :, -1, 0] = 1e30
    loc[0, Q // 4, :, :, 0, 1] = -1e30
    skip = ~torch.isfinite(loc).all(-1)
    n0 = msdeform.ms_deform_attn_kernel.launches
    got = msdeform.ms_deform_attn_kernel(value, shapes, loc, att)
    assert msdeform.ms_deform_attn_kernel.launches == n0 + 1
    ref = msdeform.ms_deform_attn(value, shapes, torch.where(skip[..., None], 0.5, loc),
                                  torch.where(skip, 0.0, att.float()).to(dtype))
    assert got.dtype == dtype and got.shape == ref.shape and torch.isfinite(got).all()
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
    (1, 16, 70, 130, (3, 5, 7, 9, 11, 13, 15, 17), False), (1, 4, 33, 17, (1,), False),
    (1, 192, 128, 160, (3, 5, 7, 9), True),      # the 512 x 640 bucket's stage 1
    (8, 1536, 7, 7, (3, 5, 7, 9), True),         # stage 4 at 224^2: a map under the 9 x 9 kernel
    (1, 8, 154, 154, (3, 5, 7, 9), False),       # just past one pass: tiles of 128
    (2, 3, 300, 200, (3, 5, 7, 9), True)])
def test_cuda_focal_ctx_matches_plain(cuda_device, dtype, approximate, B, C, H, W, kernels,
                                      strided):
    """K10 against the plain version (cuDNN's depthwise conv in f32): within
    1e-5 + 1e-5 |ref| in f32 (the chain sums in another order than cuDNN),
    1e-2 + 1e-2 |ref| in bf16; any map size (whole planes, several a block
    for small maps, tiles with a halo past the one-pass limit, a map smaller
    than the widest kernel), any level count."""
    from cullavo_tpu_torch.ops import focal

    torch.backends.cudnn.allow_tf32 = False
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = focal.focal_plan(H, W, C, kernels, focal.FOCAL_SMEM, B, sms)
    # one pass while a plane's 16-row strips fit the block's 512 x 3 slots
    assert plan["path"] == ("tiled" if -(-H // 16) * W > 1536 else "one_pass")
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


def _grads_match(kernel_out, plain_out, k_inputs, p_inputs, up):
    """Gradients through the kernel's Function against autograd through the
    plain version, within 1e-3 of each one's largest entry."""
    assert kernel_out.grad_fn is not None
    got = torch.autograd.grad((kernel_out.float() * up).sum(), k_inputs)
    want = torch.autograd.grad((plain_out.float() * up).sum(), p_inputs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 1e-3 * w.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,H,W,kernels", [(2, 192, 128, 128, (3, 5, 7, 9)),
                                             (1, 8, 154, 154, (3, 5, 7, 9))])
def test_cuda_focal_ctx_gradients_match_plain(cuda_device, dtype, B, C, H, W, kernels):
    """K10's Function under autograd: ctx, gates and taps gradients equal
    autograd through the plain version (its backward), one launch."""
    from cullavo_tpu_torch.ops import focal

    torch.backends.cudnn.allow_tf32 = False
    ctx, gates, taps = _focal_case(cuda_device, dtype, B, C, H, W, kernels, 15, True)
    leaves = [[t.detach().clone().requires_grad_(True) for t in (ctx, gates, taps)]
              for _ in range(2)]
    n0 = focal.focal_ctx_kernel.launches
    out = focal.focal_ctx_kernel(*leaves[0], H, W, kernels, True, dtype == torch.bfloat16)
    assert focal.focal_ctx_kernel.launches == n0 + 1
    ref = focal.focal_ctx_plain(*leaves[1], H, W, kernels, True, dtype == torch.bfloat16)
    up = torch.randn(out.shape, generator=torch.Generator(device=cuda_device).manual_seed(3),
                     device=cuda_device)
    _grads_match(out, ref, leaves[0], leaves[1], up)
    with pytest.raises(RuntimeError, match="no gradient"):
        focal._focal_ctx_cuda(*leaves[0], H, W, kernels, True, True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ms_deform_attn_gradients_match_plain(cuda_device, dtype):
    """K9's Function under autograd at the deformable encoder's shape:
    value, location and weight gradients equal autograd through the plain
    version within 1e-3 of their largest entry, one launch; the value
    gradient sums by atomic adds in value's dtype, so in bf16 it may stray
    by twice the plain version's own run-to-run spread."""
    from cullavo_tpu_torch.ops import msdeform

    shapes = ((64, 64), (32, 32), (16, 16))
    value, loc, att = _msdeform_case(cuda_device, dtype, shapes, 2, 5376, 8, 64, 4, seed=16)
    leaves = [[t.detach().clone().requires_grad_(True) for t in (value, loc, att)]
              for _ in range(3)]
    n0 = msdeform.ms_deform_attn_kernel.launches
    out = msdeform.ms_deform_attn_kernel(leaves[0][0], shapes, leaves[0][1], leaves[0][2])
    assert msdeform.ms_deform_attn_kernel.launches == n0 + 1 and out.grad_fn is not None
    up = torch.randn(out.shape, generator=torch.Generator(device=cuda_device).manual_seed(4),
                     device=cuda_device)

    def rel(a, b):
        return [((x.float() - y.float()).abs().max() / y.float().abs().max()).item()
                for x, y in zip(a, b)]

    got = torch.autograd.grad((out.float() * up).sum(), leaves[0])
    want, again = (torch.autograd.grad((msdeform.ms_deform_attn(
        ls[0], shapes, ls[1], ls[2]).float() * up).sum(), ls) for ls in leaves[1:])
    errs, spread = rel(got, want), rel(again, want)
    assert max(errs[1:]) <= 1e-3 and errs[0] <= max(1e-3, 2 * spread[0]), (errs, spread)
    with pytest.raises(RuntimeError, match="no gradient"):
        msdeform._ms_deform_attn_cuda(leaves[0][0], shapes, leaves[0][1], leaves[0][2])


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
    (10, 4, 4, 11, 8, True), (5, 32, 32, 104, 80, True)])
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
@pytest.mark.parametrize("B,H,KV,S,d", [(5, 32, 32, 88, 128), (5, 8, 2, 37, 64),
                                        (2, 4, 4, 11, 16)])
def test_cuda_decode_partials_read_an_smajor_f32_slice(cuda_device, B, H, KV, S, d):
    """K12 over one layer of the S-major cache ``[L, S, B, KV, d]`` through
    the ``[B, KV, S, d]`` view ``permute(1, 2, 0, 3)`` (strides ``(KV d, d,
    B KV d, 1)``, read in place) with the stale decode's ``[B, 1, S]`` bias
    (expanded over heads with stride 0): equal to the plain version on
    contiguous copies within 1e-5 + 1e-5 |ref|, one launch."""
    from cullavo_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=cuda_device).manual_seed(S + d)
    k_all, v_all = (torch.randn((3, S, B, KV, d), generator=g, device=cuda_device)
                    for _ in range(2))
    k, v = k_all[1].permute(1, 2, 0, 3), v_all[1].permute(1, 2, 0, 3)
    assert k.stride() == (KV * d, d, B * KV * d, 1)
    q = torch.randn((B, H, 1, d), generator=g, device=cuda_device)
    valid = torch.rand((B, 1, S), generator=g, device=cuda_device) > 0.2
    bias = torch.where(valid, 0.0, -1e9)
    n0 = fa.decode_partials.launches
    o, m, l = fa.decode_partials(q, k, v, bias, d ** -0.5)
    assert fa.decode_partials.launches == n0 + 1
    ro, rm, rl = fa._decode_partials_plain(q, k.contiguous(), v.contiguous(),
                                           bias.expand(B, H, S), d ** -0.5)
    assert torch.allclose(o, ro, atol=1e-5, rtol=1e-5), (o - ro).abs().max().item()
    assert torch.allclose(m, rm, atol=1e-4, rtol=1e-5)
    assert torch.allclose(l, rl, atol=0, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_f32_stale_decode_takes_k12(cuda_device):
    """``llama_forward``'s one-token stale decode over an f32 cache on the
    card (the zoo's Vicuna tower): K12 once a layer over the layer's
    S-major slice, the current token merged in f32; the hidden states and
    the written slot against the CPU's plain path within 1e-4 (TF32 off).
    A bf16 cache keeps K4; an f32 window of two tokens on the card raises."""
    from cullavo_tpu_torch.models.llava import llama
    from cullavo_tpu_torch.models.llava.config import LlamaConfig
    from cullavo_tpu_torch.ops import flash_attention as fa
    from cullavo_tpu_torch.ops import wwin_decode as ww

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig(vocab_size=64, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2)
    lm = llama.init_llama_params(cfg, torch.Generator().manual_seed(0), "cpu")
    B, S, n = 5, 24, 10
    g = torch.Generator().manual_seed(1)
    cache = {k: torch.randn((2, S, B, 2, 128), generator=g) for k in "kv"}
    mask = torch.zeros((B, S), dtype=torch.int64)
    mask[:, :n] = 1
    key_pos = torch.arange(S)[None].expand(B, S).contiguous()
    emb = torch.randn((B, 1, 256), generator=g)
    pos = torch.full((B, 1), n)

    def run(dev, dtype, T=1):
        p = {k: (v.to(dev, dtype) if torch.is_tensor(v) else
                 {a: b.to(dev, dtype) for a, b in v.items()}) for k, v in lm.items()}
        c = {k: a.to(dev, dtype) for k, a in cache.items()}
        e = torch.cat([emb] * T, 1).to(dev, dtype)
        h, c = llama.llama_forward(p, cfg, e, mask.to(dev), (pos + torch.arange(T)).to(dev),
                                   c, n, key_pos.to(dev), stale_cache=True)
        return h, c

    want, wc = run("cpu", torch.float32)
    n0, w0 = fa.decode_partials.launches, ww.wwin_decode_smajor.launches
    got, gc = run(cuda_device, torch.float32)
    assert fa.decode_partials.launches == n0 + 2 and ww.wwin_decode_smajor.launches == w0
    assert torch.allclose(got.cpu(), want, atol=1e-4, rtol=1e-4), (got.cpu() - want).abs().max()
    for k in "kv":
        assert torch.allclose(gc[k].cpu(), wc[k], atol=1e-5, rtol=1e-5)
    run(cuda_device, torch.bfloat16)
    assert fa.decode_partials.launches == n0 + 2 and ww.wwin_decode_smajor.launches == w0 + 2
    with pytest.raises(NotImplementedError, match="f32 stale-cache window"):
        run(cuda_device, torch.float32, T=2)


@pytest.mark.cuda
@pytest.mark.parametrize("W,S", [(1, 700), (4, 700), (1, 300)])
def test_cuda_wwin_decode_with_a_binding_sliding_window(cuda_device, W, S):
    """K4 on BakLLaVA's decode: 32 query heads over 8 kv heads (n_rep = 4),
    the additive bias of ``llama._attention_bias`` with Mistral's window of
    256 (keys 0 .. S - 257 masked where S > 256) and a padded row: equal to
    the plain version within 1e-2 (bf16), and the window's keys matter."""
    from cullavo_tpu_torch.models.llava import llama
    from cullavo_tpu_torch.ops import wwin_decode as ww

    g = torch.Generator(device=cuda_device).manual_seed(70 + W + S)
    L, B, KV, hd, n_rep, window = 2, 2, 8, 128, 4, 256

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(torch.bfloat16)

    kc, vc = rnd(L, S, B, KV, hd), rnd(L, S, B, KV, hd)
    q = rnd(B, W, KV * n_rep, hd).transpose(1, 2)
    k_cur, v_cur = rnd(B, KV * n_rep, W, hd), rnd(B, KV * n_rep, W, hd)
    mask = torch.ones((B, S), dtype=torch.int32, device=cuda_device)
    mask[1, S - 40:] = 0
    key_pos = torch.arange(S, device=cuda_device)[None].expand(B, S)
    pos = (mask.sum(1, keepdim=True) + torch.arange(W, device=cuda_device)[None]).to(torch.int64)
    bias = llama._attention_bias(mask, pos, key_pos, window)
    n0 = ww.wwin_decode_smajor.launches
    out = ww.wwin_decode_smajor(q, kc, vc, 1, k_cur, v_cur, bias, n_rep=n_rep)
    assert ww.wwin_decode_smajor.launches == n0 + 1
    acc, m, l = ww._cache_part_plain(q, kc, vc, 1, bias[:, 0], n_rep, hd ** -0.5)
    ref = ww._merge_self_window(q, k_cur, v_cur, acc, m, l, hd ** -0.5)
    assert torch.isfinite(out).all()
    assert torch.allclose(out.float(), ref.float(), rtol=1e-2, atol=1e-2)
    free = ww.wwin_decode_smajor(q, kc, vc, 1, k_cur, v_cur,
                                 llama._attention_bias(mask, pos, key_pos), n_rep=n_rep)
    assert ((free.float() - out.float()).abs().max() > 0.05) == (S > window)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,d", [(5, 32, 10, 64), (5, 32, 46, 64), (1, 32, 84, 64),
                                     (5, 32, 30, 128)])
def test_cuda_decode_partials_on_the_zoo_snapshot_shapes(cuda_device, B, H, S, d):
    """K12 at the decode shapes of the zoo snapshots' paths, f32: Flan-T5-XL's
    beams over the decoder's own cache and over the encoder (32 queries and
    a prompt), KOSMOS-2's greedy step past its 64 image tokens, Vicuna's
    beams over InstructBLIP's prompt; against the plain version within
    1e-5 + 1e-5 |ref|, one launch each."""
    from cullavo_tpu_torch.ops import flash_attention as fa

    q, k, v, bias = _decode_case(cuda_device, torch.float32, B, H, H, S, d, seed=S + d + 7,
                                 stacked=False)
    n0 = fa.decode_partials.launches
    o, m, l = fa.decode_partials(q, k, v, bias, d ** -0.5)
    assert fa.decode_partials.launches == n0 + 1
    ro, rm, rl = fa._decode_partials_plain(q, k, v, bias.expand(B, H, S), d ** -0.5)
    assert torch.allclose(o, ro, atol=1e-5, rtol=1e-5), (o - ro).abs().max().item()
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,H,KV,S,d", [
    (torch.bfloat16, 1, 32, 32, 4096, 128), (torch.bfloat16, 1, 32, 8, 4096, 128),
    (torch.float32, 1, 32, 32, 2048, 64), (torch.bfloat16, 1, 32, 4, 100, 64),
    (torch.bfloat16, 2, 24, 8, 5, 80), (torch.float32, 3, 6, 6, 1, 8)],
    ids=["long", "long_gqa", "long_f32", "gqa8_short", "below_one_stage_d80_gqa3", "one_key_d8"])
def test_cuda_decode_partials_edges_match_plain(cuda_device, dtype, B, H, KV, S, d):
    """K12's lane-group body at its edges against its plain version: one
    block walking 4096 keys at batch 1 (a third of them at -inf for half
    the heads and at the finite mask for the rest), GQA of 4 and 8 heads per
    kv head (two blocks of 4), f32, S below one 16-key stage with 3 heads
    per kv head at d = 80, a single key at d = 8; a second launch
    bit-equal."""
    from cullavo_tpu_torch.ops import flash_attention as fa

    scale = d ** -0.5
    g = torch.Generator(device=cuda_device).manual_seed(S + d)
    q = torch.randn((B, H, 1, d), generator=g, device=cuda_device).to(dtype)
    k, v = (torch.randn((B, KV, S, d), generator=g, device=cuda_device).to(dtype)
            for _ in range(2))
    bias = torch.randn((B, H, S), generator=g, device=cuda_device)
    if S >= 100:
        bias[:, : H // 2, S // 3:2 * S // 3] = -torch.inf
        bias[:, H // 2:, S // 3:2 * S // 3] = fa.NEG_INF
    n0 = fa.decode_partials.launches
    o, m, l = fa.decode_partials(q, k, v, bias, scale)
    again = fa.decode_partials(q, k, v, bias, scale)
    assert fa.decode_partials.launches == n0 + 2
    ro, rm, rl = fa._decode_partials_plain(q, k, v, bias, scale)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert torch.allclose(o, ro, atol=tol, rtol=tol), (o - ro).abs().max().item()
    assert torch.allclose(m, rm, atol=1e-4, rtol=1e-5)
    assert torch.allclose(l, rl, atol=0, rtol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip((o, m, l), again))


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("W,n_rep,S,B", [
    (1, 1, 4096, 1), (8, 1, 4096, 1), (8, 1, 40, 1), (1, 1, 700, 3), (4, 1, 777, 3),
    (1, 4, 664, 3), (64, 2, 300, 2), (128, 1, 1000, 1)],
    ids=["long_greedy", "long_mma", "below_one_stage", "ragged_greedy", "ragged_window",
         "gqa", "wide_gqa", "widest"])
def test_cuda_wwin_decode_edges_match_plain(cuda_device, W, n_rep, S, B, cache):
    """K4's two bodies (bf16 cache) and K5 on the same bodies (int8 codes
    with bf16 scale planes) at their edges against the plain versions: one
    block walking 4096 slots at batch 1, S below one 64-slot stage, S ragged
    against both bodies' stages, GQA (n_rep = 4), the suffix widths with
    two and one row blocks; two whole 64-slot stages masked where S allows,
    the last 3 slots masked too; a second launch bit-equal."""
    from cullavo_tpu_torch.models.llava.llama import quantize_kv
    from cullavo_tpu_torch.ops import wwin_decode as ww

    H, hd, scale = 32, 128, 128 ** -0.5
    KV = H // n_rep
    g = torch.Generator(device=cuda_device).manual_seed(S + W)
    kc, vc = (torch.randn((2, S, B, KV, hd), generator=g, device=cuda_device).to(torch.bfloat16)
              for _ in range(2))
    q = torch.randn((B, W, H, hd), generator=g, device=cuda_device).to(torch.bfloat16)
    q = q.transpose(1, 2)
    bias = torch.zeros((B, W, S), device=cuda_device)
    bias[:, :, S - 3:] = ww.NEG_INF
    if S >= 256:
        bias[:, :, 64:192] = ww.NEG_INF
    if cache == "bf16":
        counter, run, plain, ops = (ww.wwin_decode_smajor, ww._run_cache_part,
                                    ww._cache_part_plain, (kc, vc))
    else:
        (kq, ks), (vq, vs) = quantize_kv(kc), quantize_kv(vc)
        counter, run, plain, ops = (ww.wwin_decode_smajor_q8, ww._run_cache_part_q8,
                                    ww._cache_part_q8_plain, (kq, ks, vq, vs))
    n0 = counter.launches
    got = run(q, *ops, 1, bias, n_rep, scale)
    again = run(q, *ops, 1, bias, n_rep, scale)
    assert counter.launches == n0 + 2
    _assert_partials_close(got, plain(q, *ops, 1, bias, n_rep, scale))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _packed_case(dev, B, T, S, H, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((B, T, H * 128), generator=g, device=dev).to(torch.bfloat16),
            *(torch.randn((B, S, H * 128), generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2)))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,S,H", [(2, 648, 648, 4), (1, 1024, 1024, 2), (3, 37, 45, 2),
                                     (2, 200, 333, 3), (1, 1, 1, 1)])
def test_cuda_flash_attention_packed_matches_plain(cuda_device, B, T, S, H):
    """K13 against its plain version: o within 1e-2 + 1e-2 |ref| (P and O
    round to bf16 at other places), the packed layout written in place of
    the transposes; one launch counted; ragged T and S > T."""
    from cullavo_tpu_torch.ops import flash_attention as fa

    q, k, v = _packed_case(cuda_device, B, T, S, H, seed=T + S)
    n0, n1 = fa.flash_attention_packed.launches, fa.flash_attention.launches
    got = fa.flash_attention_packed(q, k, v, H)
    assert (fa.flash_attention_packed.launches, fa.flash_attention.launches) == (n0 + 1, n1)
    ref = fa._packed_plain(q, k, v, H)
    assert got.shape == (B, T, H * 128) and got.dtype == torch.bfloat16
    assert torch.allclose(got.float(), ref.float(), rtol=1e-2, atol=1e-2), \
        (got.float() - ref.float()).abs().max().item()
    if S == T:   # K1's kernel on K1's layouts: bit-equal to K1 on the head views
        std = fa._heads_to_packed(
            fa.flash_attention(*(fa._packed_to_heads(t, H) for t in (q, k, v))))
        assert torch.equal(got, std), (got.float() - std.float()).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("T,S", [(256, 256), (100, 160)])
def test_cuda_flash_attention_packed_gradients_match_plain(cuda_device, T, S):
    """dq, dk, dv of the packed autograd function (K13 forward; the K1-lse or
    K8 forward and the chunked backward) against autograd through the plain
    version: within 2e-2 of the largest entry."""
    from cullavo_tpu_torch.ops import flash_attention as fa

    q, k, v = _packed_case(cuda_device, 2, T, S, 2, seed=31)
    do = torch.randn((2, T, 256), device=cuda_device).to(torch.bfloat16)
    grads = []
    for fn in (lambda a, b, c: fa.flash_attention_packed(a, b, c, 2),
               lambda a, b, c: fa._packed_plain(a, b, c, 2)):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*leaves), leaves, do))
    for name, a, b in zip(("dq", "dk", "dv"), *grads):
        assert torch.isfinite(a).all()
        assert (a.float() - b.float()).abs().max().item() <= 2e-2 * b.float().abs().max().item(), name


@pytest.mark.cuda
def test_cuda_flash_attention_packed_refusals(cuda_device):
    from cullavo_tpu_torch.ops import flash_attention as fa

    q, k, v = _packed_case(cuda_device, 1, 16, 16, 2, seed=32)
    with pytest.raises(ValueError, match="contiguous, 16-byte aligned bf16"):
        fa.flash_attention_packed(q.float(), k.float(), v.float(), 2)
    with pytest.raises(ValueError, match="contiguous, 16-byte aligned bf16"):
        fa.flash_attention_packed(torch.cat([q, q], dim=-1)[..., :256], k, v, 2)   # strided
    with pytest.raises(ValueError, match="head dim 128"):
        fa.flash_attention_packed(*(torch.cat([t, t], dim=-1) for t in (q, k, v)), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(1, 4096, 11008), (8, 4096, 11008), (64, 4096, 11008),
                                   (13, 1024, 4100), (3, 11008, 4096)])
def test_cuda_p32_linear_matches_plain(cuda_device, M, K, N):
    """K14 against the f32 plain version: within 1e-2 + 1e-2 |ref| (one bf16
    rounding of the output; f32 sums in another order)."""
    from cullavo_tpu_torch.scripts import matmul_probe as mp

    g = torch.Generator(device=cuda_device).manual_seed(M + K)
    w8 = torch.randint(-128, 128, (K, N), generator=g, device=cuda_device, dtype=torch.int8)
    w32 = mp.pack_p32(w8)
    x = torch.randn((M, K), generator=g, device=cuda_device).to(torch.bfloat16)
    scale = torch.rand((N,), generator=g, device=cuda_device) * 0.01
    n0 = mp.p32_linear.launches
    got = mp.p32_linear(x, w32, scale)
    assert mp.p32_linear.launches == n0 + 1
    ref = mp.p32_linear_plain(x, w32, scale)
    assert got.shape == (M, N) and got.dtype == torch.bfloat16
    assert torch.allclose(got.float(), ref.float(), rtol=1e-2, atol=1e-2), \
        (got.float() - ref.float()).abs().max().item()
    with pytest.raises(ValueError, match="x must be bf16"):
        mp.p32_linear(x.float(), w32, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,splits", [(8, 4096, 11008, 1), (3, 11008, 4096, 2)])
def test_cuda_p32_linear_two_calls_are_bit_identical(cuda_device, M, K, N, splits):
    """K14 at the probe's M = 8 (no split) and where its plan splits K across
    CTAs (the splits added in a fixed order): two calls agree bit for bit."""
    from cullavo_tpu_torch.ops import nf4
    from cullavo_tpu_torch.scripts import matmul_probe as mp

    g = torch.Generator(device=cuda_device).manual_seed(M + K)
    w8 = torch.randint(-128, 128, (K, N), generator=g, device=cuda_device, dtype=torch.int8)
    w32 = mp.pack_p32(w8)
    x = torch.randn((M, K), generator=g, device=cuda_device).to(torch.bfloat16)
    scale = torch.rand((N,), generator=g, device=cuda_device) * 0.01
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert nf4.p32_gemv_plan(M, K, N, sms)["splits"] == splits
    assert torch.equal(mp.p32_linear(x, w32, scale), mp.p32_linear(x, w32, scale))


# ---------------------------------------------------------------------------
# sampled decoding, the fused generate and step2_pre on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_sampled_generate_is_reproducible_from_one_seed(cuda_device):
    """The fused generate on the smoke model (head dim 128) in bf16 on the
    card: one seed gives one stream, another seed another; K1 and K4 ran."""
    from cullavo_tpu_torch.entry import smoke_llava_config
    from cullavo_tpu_torch.models.llava import modeling as tm
    from cullavo_tpu_torch.ops import flash_attention as fa
    from cullavo_tpu_torch.ops import wwin_decode as ww

    cfg = smoke_llava_config()
    params = tm.init_llava_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                                  cuda_device, dtype=torch.bfloat16)
    B, T, n_img = 4, 40, cfg.num_image_tokens
    g = torch.Generator(device=cuda_device).manual_seed(1)
    ids = torch.randint(4, cfg.text.vocab_size - 2, (B, T), generator=g, device=cuda_device)
    ids[:, 1:1 + n_img] = cfg.image_token_id
    mask = torch.ones((B, T), dtype=torch.int32, device=cuda_device)
    S = cfg.vision.image_size
    pix = torch.randn((B, 3, S, S), generator=g, device=cuda_device).to(torch.bfloat16)
    gen = tm.GenerationConfig(max_new_tokens=12, do_sample=True, eos_token_id=-1)
    k1, k4 = fa.flash_attention.launches, ww.wwin_decode_smajor.launches

    def run(seed):
        return tm.generate(params, cfg, ids, pix, mask, gen, T + 12,
                           rng=torch.Generator(device=cuda_device).manual_seed(seed),
                           compute_dtype=torch.bfloat16)

    a, b, c = run(5), run(5), run(6)
    assert a.shape == (B, 12) and torch.equal(a, b) and not torch.equal(a, c)
    assert fa.flash_attention.launches > k1 and ww.wwin_decode_smajor.launches > k4


@pytest.mark.cuda
@pytest.mark.parametrize("top_k,top_p", [(50, 0.95), (0, 0.95), (50, 1.0)])
def test_cuda_filtered_logits_equal_the_cpu(cuda_device, top_k, top_p):
    """Kept sets and kept values of ``_filter_logits`` on the card equal the
    CPU's on the same logits (the top-p mass is summed in f64)."""
    from cullavo_tpu_torch.models.llava import modeling as tm

    g = torch.Generator().manual_seed(top_k + 3)
    logits = torch.randn((8, 32000), generator=g) * 3
    logits[:, :40] = torch.round(logits[:, :40])                 # ties
    gen = tm.GenerationConfig(do_sample=True, top_k=top_k, top_p=top_p)
    cpu = tm._filter_logits(logits, gen)
    card = tm._filter_logits(logits.to(cuda_device), gen).cpu()
    assert torch.equal(card, cpu)


@pytest.mark.cuda
def test_cuda_step2_rows_refuse_an_f32_base_on_the_card(cuda_device):
    from cullavo_tpu_torch.entry import smoke_llava_config
    from cullavo_tpu_torch.data.tokenizer import ByteTokenizer
    from cullavo_tpu_torch.models.llava.modeling import init_llava_params
    from cullavo_tpu_torch.pipelines.cullavo_pipeline import CuLLaVOPipeline

    cfg = smoke_llava_config()
    params = init_llava_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                               cuda_device)
    pipe = CuLLaVOPipeline({}, cfg, ByteTokenizer(), params)
    ids = torch.zeros((1, 8), dtype=torch.int32).numpy()
    with pytest.raises(ValueError, match="take bf16 only"):
        pipe.generate_step2_rows([], ids, ids, "unused")


@pytest.mark.cuda
def test_cuda_split_k_launch_on_a_second_stream_raises(cuda_device):
    """The split-K tile counters belong to the stream of their first launch:
    a split launch on another stream raises, and the first stream goes on."""
    from cullavo_tpu_torch.ops import nf4

    M, K, N = 1, 11008, 4096
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert nf4.nf4_gemv_plan(M, K, N, sms)["splits"] > 1
    g = torch.Generator(device=cuda_device).manual_seed(2)
    q = nf4.quantize_linear_planar(torch.randn((K, N), generator=g, device=cuda_device) * K ** -0.5)
    x = torch.randn((M, K), generator=g, device=cuda_device).to(torch.bfloat16)
    y = nf4.nf4_linear_planar(x, q)
    other = torch.cuda.Stream(device=cuda_device)
    with torch.cuda.stream(other):
        with pytest.raises(RuntimeError, match="belong to stream"):
            nf4.nf4_linear_planar(x, q)
    assert torch.equal(nf4.nf4_linear_planar(x, q), y)


@pytest.mark.cuda
def test_cuda_evaluate_grounding_matches_cpu(cuda_device):
    """``evaluate_grounding`` on the tiny X-Decoder in f32: the card (K10 in
    every FocalNet block) against the CPU (the plain versions), mask logits
    within 1e-3 of their largest entry; a reference-layout round trip of
    its weights is bit-equal."""
    from cullavo_tpu_torch.checkpoint import xdecoder_import as xi
    from cullavo_tpu_torch.models.xdecoder import model as xm
    from cullavo_tpu_torch.ops import focal

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = xm.tiny_xdecoder_config()
    params = xm.init_xdecoder_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = {k: v.numpy() for k, v in xi.reference_state_from_params(params, cfg).items()}
    on_card = xi.align_and_update(
        xm.init_xdecoder_model_params(cfg, torch.Generator(device=cuda_device).manual_seed(1),
                                      cuda_device),
        xi.import_xdecoder_checkpoint(state, cfg))
    g = torch.Generator().manual_seed(2)
    images = torch.randn((2, 96, 128, 3), generator=g)
    ids = torch.randint(2, cfg.text.vocab_size - 1, (2, cfg.text.context_length), generator=g)
    ids[:, -1] = cfg.text.vocab_size - 1
    mask = torch.ones_like(ids)
    with torch.inference_mode():
        want = xm.evaluate_grounding(params, cfg, images, ids, mask, out_size=(96, 128))
        n0 = focal.focal_ctx_kernel.launches
        got = xm.evaluate_grounding(on_card, cfg, images.to(cuda_device), ids, mask,
                                    out_size=(96, 128))
    assert focal.focal_ctx_kernel.launches == n0 + sum(cfg.backbone.depths)
    err = (got.cpu() - want).abs().max().item()
    assert err <= 1e-3 * want.abs().max().item(), err


GLOO_RANK = """
import os, sys
import torch
sys.path.insert(0, sys.argv[2])
from cullavo_tpu_torch.parallel import all_reduce_tree, initialize_distributed, parallel_context
rank = int(os.environ["CULLAVO_PROC_ID"])
assert initialize_distributed(os.environ["CULLAVO_COORDINATOR"], 2, rank)
dev = torch.device("cuda", torch.cuda.current_device())
par = parallel_context({})
g = torch.Generator(device=dev).manual_seed(0)
x_all = torch.randn(5, 3, generator=g, device=dev)
w = torch.randn(3, 4, generator=g, device=dev)
x = x_all[par.rows(5)].clone().requires_grad_(True)
part = par.part(5)
loss = (torch.softmax(part.gather(x) @ w, dim=0) * torch.arange(20., device=dev).reshape(5, 4))
part.share(loss.sum()).backward()
big = torch.full((3 << 20,), rank + 1.0, device=dev)
tree = all_reduce_tree([big, torch.full((7,), rank + 1, dtype=torch.bfloat16, device=dev)])
torch.save({"grad": x.grad.cpu(), "tree": [t.cpu() for t in tree],
            "objs": par.allgather_objects(rank), "backend": torch.distributed.get_backend()},
           os.path.join(sys.argv[1], f"rank{rank}.pt"))
torch.distributed.destroy_process_group()
"""


@pytest.mark.cuda
def test_cuda_gloo_collectives_on_two_ranks(cuda_device, tmp_path):
    """Two ranks on the one card over Gloo (``CULLAVO_DIST_BACKEND=gloo``:
    NCCL takes one rank a device): the gather with gradient, the flat
    all-reduce of CUDA tensors (12 MB of f32 and a bf16 leaf) and the object
    gather; the gradient equals the one-process gradient."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    script = tmp_path / "rank.py"
    script.write_text(GLOO_RANK)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(tmp_path), str(REPO)],
        env=dict(os.environ, CULLAVO_NUM_PROCS="2", CULLAVO_PROC_ID=str(r),
                 CULLAVO_COORDINATOR=f"127.0.0.1:{port}", CULLAVO_DIST_BACKEND="gloo"),
        stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], errs
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x_all = torch.randn(5, 3, generator=g, device=cuda_device).requires_grad_(True)
    w = torch.randn(3, 4, generator=g, device=cuda_device)
    (torch.softmax(x_all @ w, dim=0)
     * torch.arange(20., device=cuda_device).reshape(5, 4)).sum().backward()
    torch.testing.assert_close(torch.cat([r["grad"] for r in got]), x_all.grad.cpu(),
                               rtol=1e-5, atol=1e-6)
    for r in got:
        assert r["backend"] == "gloo" and r["objs"] == [0, 1]
        assert bool((r["tree"][0] == 3.0).all()) and r["tree"][1].tolist() == [3.0] * 7
