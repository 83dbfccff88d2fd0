"""The VL zoo from local HF snapshots (``MODEL.ZOO_PATH``) in the torch port
against the JAX package, on tiny snapshots that ``test_torch_zoo_snapshots``
writes (transformers' ``save_pretrained`` weights, tokenizer files of
``chip_smoke``'s writers): JAX's ``_hf_blip2_answer_fn`` (Flan-T5, and
InstructBLIP with its Q-Former tokenizer), ``_hf_kosmos2_answer_fn`` and
``native_bakllava_answer_fn`` (Mistral's sliding window binding in its
prefill and decode, GQA) against the port's, answers string-exact;
``entry.evaluate`` with ``MODEL.ZOO_PATH`` for each kind against JAX's
entry (the metrics and the answers file equal); ``imagenet_test`` with
``ZOO_PATH`` on the InstructBLIP snapshot (class predictions exact), and a
BLIP-2 snapshot refused with a ``ValueError`` that names the Q-Former text
weights (JAX's import dies on a bare ``KeyError``).

JAX hard-codes the published configs, so both packages' config factories
are monkeypatched to the tiny ones (``_blip2_cfg_cls``, ``Kosmos2Config``,
``bakllava_config``); nothing in the JAX package changes.  JAX's entry
CLIP-preprocesses each image before its snapshot answerers preprocess it
again (and KOSMOS-2's processor cannot take those floats at all); the
reference hands each answerer the image, as the port's entry does, so JAX's
mapper is monkeypatched to pass the decoded image through.  Images are at
the towers' 28 x 28, which no resize touches.  JAX's BLIP-2 and KOSMOS-2
decoders are jitted for the file.
"""
import json

import numpy as np
import pytest
import torch

import cullavo_tpu.data.mappers as j_mappers
from cullavo_tpu import entry as j_entry
from cullavo_tpu.data.mappers.eval_mappers import load_image_rgb
from cullavo_tpu.models import kosmos2 as j_k2
from cullavo_tpu.models.blip2 import config as j_cfg
from cullavo_tpu.models.blip2 import modeling as j_mod
from cullavo_tpu.models.llava import config as j_lcfg
from cullavo_tpu.pipelines import vl_zoo_pipeline as j_zoo
from cullavo_tpu_torch import entry as t_entry
from cullavo_tpu_torch.models import kosmos2 as t_k2
from cullavo_tpu_torch.models.blip2 import config as t_cfg
from cullavo_tpu_torch.models.llava import config as t_lcfg
from cullavo_tpu_torch.models.llava import llama as t_llama
from cullavo_tpu_torch.pipelines import vl_zoo_pipeline as t_zoo
from test_torch_zoo import jit_decode
from test_torch_zoo_snapshots import (tiny_bakllava, tiny_blip2, tiny_kosmos2, write_snapshot)

KINDS = ("flant5", "instructblip", "kosmos2", "bakllava")
ZOO = {"flant5": "blip2", "instructblip": "instructblip", "kosmos2": "kosmos2",
       "bakllava": "bakllava"}
QUESTIONS = ["What is the color of the car?", "How many dogs are there?",
             "Is the man riding a bicycle?"]
NEW = 4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _jitted_jax_decoders():
    """JAX's BLIP-2 and KOSMOS-2 decoders jitted for this file (the
    answerers import them from their modules at call time)."""
    saved = [(j_mod, "blip2_beam_generate"), (j_mod, "blip2_generate"),
             (j_k2, "kosmos2_generate")]
    originals = [getattr(m, n) for m, n in saved]
    j_mod.blip2_beam_generate = jit_decode(j_mod.blip2_beam_generate, (
        "cfg", "max_new_tokens", "num_beams", "length_penalty", "eos_token_id", "pad_token_id",
        "compute_dtype"))
    j_mod.blip2_generate = jit_decode(j_mod.blip2_generate, (
        "cfg", "max_new_tokens", "eos_token_id", "compute_dtype"))
    j_k2.kosmos2_generate = jit_decode(j_k2.kosmos2_generate, (
        "cfg", "max_new_tokens", "eos_token_id", "compute_dtype"))
    yield
    for (m, n), f in zip(saved, originals):
        setattr(m, n, f)


@pytest.fixture
def tiny_configs(monkeypatch):
    """Both packages' published-config factories -> the tiny snapshots'."""
    def cls_of(cfg_mod, hf_names):
        def pick(kind):
            if kind not in ("flant5", "instructblip"):
                raise ValueError(kind)
            return tiny_blip2(kind, cfg_mod), hf_names[kind]
        return pick

    names = {"flant5": "Blip2ForConditionalGeneration",
             "instructblip": "InstructBlipForConditionalGeneration"}
    monkeypatch.setattr(j_zoo, "_blip2_cfg_cls", cls_of(j_cfg, names))
    monkeypatch.setattr(t_zoo, "_blip2_cfg_cls", cls_of(t_cfg, names))
    for mod, name, cfg in ((j_k2, "Kosmos2Config", tiny_kosmos2(j_k2)),
                           (t_zoo, "Kosmos2Config", tiny_kosmos2(t_k2)),
                           (j_lcfg, "bakllava_config", tiny_bakllava(j_lcfg)),
                           (t_zoo, "bakllava_config", tiny_bakllava(t_lcfg))):
        monkeypatch.setattr(mod, name, lambda cfg=cfg: cfg)


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo_snapshots")
    for kind in KINDS:
        write_snapshot(root / kind, kind, seed=KINDS.index(kind) + 11, quiet_specials=True)
    return root


def _images():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 256, (28, 28, 3), dtype=np.uint8) for _ in range(2)]


def _answerers(kind, path):
    path = str(path)
    if kind in ("flant5", "instructblip"):
        return (j_zoo.native_blip2_answer_fn(hf_model_dir=path, max_new_tokens=NEW, kind=kind),
                t_zoo.native_blip2_answer_fn(hf_model_dir=path, max_new_tokens=NEW, kind=kind,
                                             device="cpu"))
    if kind == "kosmos2":
        return (j_zoo.native_kosmos2_answer_fn(hf_model_dir=path, max_new_tokens=NEW),
                t_zoo.native_kosmos2_answer_fn(hf_model_dir=path, max_new_tokens=NEW,
                                               device="cpu"))
    return (j_zoo.native_bakllava_answer_fn(path, max_new_tokens=NEW),
            t_zoo.native_bakllava_answer_fn(path, max_new_tokens=NEW, device="cpu"))


@pytest.mark.parametrize("kind", KINDS)
def test_snapshot_answerer_matches_jax(snapshots, tiny_configs, kind):
    """The same answers, string for string, from the same snapshot; for
    BakLLaVA the prompt (4 image patches + ~15 text tokens) is past the
    window of 8, so the prefill runs the windowed plain attention."""
    j_fn, t_fn = _answerers(kind, snapshots / kind)
    n0 = t_llama.llama_forward.window_prefills
    got, want = [], []
    for q, im in zip(QUESTIONS, _images() * 2):
        want.append(j_fn(q, im))
        got.append(t_fn(q, im))
    assert got == want and all(want)
    if kind == "bakllava":
        assert t_llama.llama_forward.window_prefills - n0 == len(QUESTIONS)


def _write_vqa(root):
    """Three questions on two 28 x 28 PNG images, annotations for val."""
    from PIL import Image

    root.mkdir(exist_ok=True)
    for image_id, im in enumerate(_images(), 1):
        Image.fromarray(im).save(root / f"COCO_val2014_{image_id:012d}.jpg", format="PNG")
    qs = [{"question_id": 100 + i, "question": q, "image_id": 1 + i % 2}
          for i, q in enumerate(QUESTIONS)]
    with open(root / "q.json", "w") as f:
        json.dump({"questions": qs}, f)
    with open(root / "a.json", "w") as f:
        json.dump({"annotations": [{"question_id": q["question_id"], "question_type": "what",
                                    "answer_type": "other",
                                    "answers": [{"answer": a} for a in ["yes"] * 6 + ["two"] * 4]}
                                   for q in qs]}, f)


class _PassImage:
    """JAX's VQAEvalMapper with the decoded image passed on as
    ``pixel_values`` (what the reference hands its zoo processors)."""

    def __init__(self, image_size=None, load_image=load_image_rgb):
        self.load_image = load_image

    def __call__(self, rec):
        img = rec.get("image")
        return {"question_id": rec["question_id"], "question": rec["question"],
                "pixel_values": np.asarray(self.load_image(rec["file_name"]) if img is None
                                           else img),
                "answers": rec.get("answers"), "question_type": rec.get("question_type"),
                "answer_type": rec.get("answer_type")}


@pytest.mark.parametrize("kind", KINDS)
def test_evaluate_zoo_path_matches_jax(snapshots, tiny_configs, tmp_path, monkeypatch, kind):
    _write_vqa(tmp_path / "vqa")
    monkeypatch.setattr(j_mappers, "VQAEvalMapper", _PassImage)
    out = {}
    for pkg, run in (("jax", j_entry.evaluate), ("port", t_entry.evaluate)):
        name = f"zoo_path_{kind}_{pkg}"
        cfg = {"NAME": "vl_test", "MAX_NEW_TOKENS": NEW, "LIMIT": 0,
               "SAVE_DIR": str(tmp_path / pkg),
               "MODEL": {"ZOO": ZOO[kind], "ZOO_PATH": str(snapshots / kind)},
               "DATASETS": {"TEST": [name], "REGISTER": {name: {
                   "KIND": "vqa", "QUESTIONS_JSON": str(tmp_path / "vqa" / "q.json"),
                   "ANNOTATIONS_JSON": str(tmp_path / "vqa" / "a.json"),
                   "IMAGE_DIR": str(tmp_path / "vqa")}}}}
        res = run(cfg) if pkg == "jax" else run(cfg, device="cpu")
        out[pkg] = res[name]
    assert out["port"] == out["jax"] and out["port"]["n"] == len(QUESTIONS)
    with open(tmp_path / "jax" / "vqa_results.json") as f, \
            open(tmp_path / "port" / "vqa_results.json") as g:
        assert json.load(g) == json.load(f)


def test_imagenet_zoo_path_matches_jax(snapshots, tiny_configs, tmp_path):
    """``imagenet_test`` from the InstructBLIP snapshot: 'This is {class}'
    through its WordPiece Q-Former tokenizer (padded to the longest row),
    top-1 / top-5 and the per-class CSV equal to JAX's entry; a BLIP-2
    snapshot has no Q-Former text weights and is refused by name."""
    from PIL import Image

    root = tmp_path / "val"
    rng = np.random.default_rng(8)
    folders = ["n01440764", "n01443537", "n01484850"]
    for i, folder in enumerate(folders):
        (root / folder).mkdir(parents=True)
        for j in range(2):
            Image.fromarray(rng.integers(0, 256, (28, 28, 3), dtype=np.uint8)).save(
                root / folder / f"img_{i}_{j}.png")
    out = {}
    for pkg, run in (("jax", j_entry.evaluate), ("port", t_entry.evaluate)):
        name = f"imagenet_zoo_path_{pkg}"
        cfg = {"NAME": "imagenet_test", "LIMIT": 0, "SAVE_DIR": str(tmp_path / pkg),
               "MODEL": {"ZOO": "instructblip", "ZOO_PATH": str(snapshots / "instructblip")},
               "DATASETS": {"TEST": [name], "REGISTER": {name: {
                   "KIND": "imagenet", "ROOT": str(root), "FOLDERS": folders,
                   "CLASS_NAMES": ["tench", "goldfish", "great white shark"]}}}}
        res = run(cfg) if pkg == "jax" else run(cfg, device="cpu")
        out[pkg] = res[name]
    assert out["port"] == out["jax"]
    jcsv = sorted((tmp_path / "jax").rglob("*.csv"))
    tcsv = sorted((tmp_path / "port").rglob("*.csv"))
    assert [p.name for p in tcsv] == [p.name for p in jcsv] and jcsv
    for a, b in zip(tcsv, jcsv):
        assert a.read_text() == b.read_text()
    with pytest.raises(KeyError):
        j_zoo.native_blip2_imagenet_fns(hf_model_dir=str(snapshots / "flant5"),
                                        class_names=["tench"], kind="flant5")
    with pytest.raises(ValueError, match="word_embeddings.*Blip2ForConditionalGeneration"):
        t_zoo.native_blip2_imagenet_fns(hf_model_dir=str(snapshots / "flant5"),
                                        class_names=["tench"], kind="flant5", device="cpu")
