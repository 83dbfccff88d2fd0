"""The zero-shot ImageNet eval of the torch port against the JAX package:
the synset and COCO tables, the class-folder scan and its registration,
``blip2_image_embed`` / ``blip2_text_embed`` and
``native_blip2_imagenet_fns`` on JAX's tiny "llama_text" weights carried
across by the bridge (within 1e-4), ``ImageNetPipeline``'s top-1 / top-5
and per-class CSV (ties in the top-k to the lower class index, as
``jax.lax.top_k``), and ``entry.evaluate`` on ``imagenet_test`` over PNG
class folders against JAX's entry.
"""
import csv
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cullavo_tpu import entry as j_entry
from cullavo_tpu.data import datasets as j_ds
from cullavo_tpu.data import registry as j_reg
from cullavo_tpu.models.blip2 import config as j_cfg
from cullavo_tpu.models.blip2 import modeling as j_mod
from cullavo_tpu.pipelines import imagenet_pipeline as j_inp
from cullavo_tpu.pipelines import vl_zoo_pipeline as j_zoo
from cullavo_tpu.utils import constants as j_const
from cullavo_tpu_torch import entry as t_entry
from cullavo_tpu_torch.checkpoint.from_jax import blip2_params_from_numpy
from cullavo_tpu_torch.data import datasets as t_ds
from cullavo_tpu_torch.data import registry as t_reg
from cullavo_tpu_torch.models import beam as t_beam
from cullavo_tpu_torch.models.blip2 import modeling as t_mod
from cullavo_tpu_torch.pipelines import imagenet_pipeline as t_inp
from cullavo_tpu_torch.pipelines import vl_zoo_pipeline as t_zoo
from cullavo_tpu_torch.utils import constants as t_const


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CFG = j_cfg.tiny_blip2_config("llama_text")


@pytest.fixture(autouse=True, scope="module")
def _jitted_jax_initializer():
    """JAX's BLIP-2 initializer jitted for this file (its ImageNet functions
    import it from the module at call time); the original back afterwards."""
    original = j_mod.init_blip2_params
    jitted = jax.jit(original, static_argnames=("cfg", "dtype"))
    sig = inspect.signature(original)

    def call(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        return jitted(**bound.arguments)

    j_mod.init_blip2_params = call
    yield
    j_mod.init_blip2_params = original


@pytest.fixture(scope="module")
def weights():
    tree = jax.tree.map(np.asarray, j_mod.init_blip2_params(CFG, jax.random.PRNGKey(0)))
    return tree, blip2_params_from_numpy(tree, "cpu")


SYNSETS = [j_const.IMAGENET_FOLDER_NAMES[i] for i in (7, 0, 999, 412)]


@pytest.fixture(scope="module")
def class_root(tmp_path_factory):
    """Four synset folders of PNG images (three sizes) and a folder outside
    the table."""
    from PIL import Image

    root = tmp_path_factory.mktemp("imagenet")
    rng = np.random.default_rng(0)
    for k, folder in enumerate(SYNSETS + ["not_a_synset"]):
        (root / folder).mkdir()
        for j, hw in enumerate(((40, 40), (30, 50), (56, 44))[:2 + (k % 2)]):
            Image.fromarray(rng.integers(0, 255, hw + (3,), dtype=np.uint8)).save(
                root / folder / f"img_{j}.png")
    return root


def test_tables_folder_scan_and_registration_match_jax(class_root):
    assert t_const.IMAGENET_FOLDER_NAMES == list(j_const.IMAGENET_FOLDER_NAMES)
    assert t_const.COCO_SEMANTIC_CLASSES == list(j_const.COCO_SEMANTIC_CLASSES)
    for folders in (None, SYNSETS[::-1][:3]):
        want = j_ds.load_imagenet_folder(str(class_root), folders)
        assert t_ds.load_imagenet_folder(str(class_root), folders) == want and want
    for i, (folders, names) in enumerate(((None, None), (SYNSETS[:3], None),
                                          (SYNSETS[:2], ["a", "b"]))):
        name = f"inet_scan_{i}"
        j_ds.register_imagenet(name, str(class_root), folders, names)
        t_ds.register_imagenet(name, str(class_root), folders, names)
        assert t_reg.get_metadata(name) == j_reg.get_metadata(name)
        assert t_reg.get_dataset(name) == j_reg.get_dataset(name)


def test_embeddings_and_imagenet_fns_match_jax(weights, monkeypatch):
    """The pooled, L2-normalised image queries and Q-Former text states, and
    ``native_blip2_imagenet_fns`` ('This is {class}' folded into the
    Q-Former's vocabulary) on JAX's smoke weights: within 1e-4."""
    tree, params = weights
    jp = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(1)
    pix = rng.normal(size=(3, 3, 28, 28)).astype(np.float32)
    ids = rng.integers(3, 99, size=(3, 5)).astype(np.int32)
    mask = np.ones((3, 5), np.int32)
    mask[1:, 3:] = 0
    ref = np.asarray(jax.jit(lambda p, x: j_mod.blip2_image_embed(p, CFG, x))(jp, pix))
    got = t_mod.blip2_image_embed(params, CFG, torch.from_numpy(pix))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(ref, axis=-1), 1.0, atol=1e-5)
    ref_t = np.asarray(jax.jit(lambda p, i, m: j_mod.blip2_text_embed(p, CFG, i, m))(
        jp, ids, mask))
    got_t = t_mod.blip2_text_embed(params, CFG, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got_t.numpy(), ref_t, atol=1e-4, rtol=0)

    names = ["tench", "great white shark", "toilet tissue, toilet paper, bathroom tissue"]
    monkeypatch.setattr(t_zoo, "init_blip2_params", lambda cfg, gen, dev: params)
    j_fn, j_cls = j_zoo.native_blip2_imagenet_fns(class_names=names, kind="instructblip")
    t_fn, t_cls = t_zoo.native_blip2_imagenet_fns(class_names=names, kind="instructblip",
                                                  device="cpu")
    assert t_fn.image_size == j_fn.image_size == CFG.vision.image_size
    np.testing.assert_allclose(t_cls.numpy(), np.asarray(j_cls), atol=1e-4, rtol=0)
    np.testing.assert_allclose(t_fn(torch.from_numpy(pix)).numpy(), np.asarray(j_fn(pix)),
                               atol=1e-4, rtol=0)


def test_top_k_breaks_ties_to_the_lower_index():
    scores = np.random.default_rng(2).integers(0, 4, size=(64, 9)).astype(np.float32)
    for k in (1, 5, 9):
        want = np.asarray(jax.lax.top_k(jnp.asarray(scores), k)[1])
        got = t_beam.top_k(torch.from_numpy(scores), k)[1].numpy()
        np.testing.assert_array_equal(got, want)


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("batch_size", [3, 64])
def test_pipeline_scores_and_csv_match_jax(tmp_path, batch_size):
    """Embeddings chosen so that rows tie (duplicate classes, an image equal
    to two classes): top-1, top-5, n and the per-class CSV equal JAX's, over
    batches of 3 and one of 64; a second run starts from zero."""
    rng = np.random.default_rng(3)
    classes = rng.integers(-2, 3, size=(8, 4)).astype(np.float32)
    classes[5] = classes[2]
    classes[7] = classes[0]
    imgs = np.concatenate([classes[[2, 0, 5, 7, 1]], rng.integers(-2, 3, size=(6, 4))]).astype(
        np.float32)
    labels = [5, 7, 2, 0, 1, 3, 4, 6, 6, 3, 2]
    names = [f"class {i}" for i in range(8)]
    rows = [{"pixel_values": imgs[i], "label": labels[i]} for i in range(len(labels))]
    j_pipe = j_inp.ImageNetPipeline(None, lambda x: x, jnp.asarray(classes), names,
                                    batch_size=batch_size)
    ref = j_pipe.evaluate_model(rows, out_dir=str(tmp_path / "jax"))
    t_pipe = t_inp.ImageNetPipeline(None, lambda x: x, torch.from_numpy(classes), names,
                                    batch_size=batch_size)
    for _ in range(2):
        got = t_pipe.evaluate_model(rows, out_dir=str(tmp_path / "port"))
        assert got == ref and got["n"] == len(rows)
    assert 0 < ref["top1"] < ref["top5"] < 100
    assert _read_csv(tmp_path / "port" / "imagenet_per_class.csv") == _read_csv(
        tmp_path / "jax" / "imagenet_per_class.csv")


def test_evaluate_imagenet_matches_jax(tmp_path, class_root, weights, monkeypatch):
    """``entry.evaluate`` on ``imagenet_test`` over a registered ``imagenet``
    root (four synset folders, one outside the table skipped) in both
    packages, the port's smoke weights made JAX's: results and the
    per-class CSV equal.  ``MODEL.ZOO_PATH`` without a snapshot there raises
    naming config.json (tests/test_torch_zoo_path.py runs a snapshot); a
    root-less registration raises; no ``DATASETS.TEST`` gives {}."""
    _, params = weights
    monkeypatch.setattr(t_zoo, "init_blip2_params", lambda cfg, gen, dev: params)
    out = {}
    for pkg, run in (("jax", j_entry.evaluate), ("port", t_entry.evaluate)):
        name = f"imagenet_val_{pkg}"
        cfg = {"NAME": "imagenet_test", "BATCH_SIZE": 4, "SAVE_DIR": str(tmp_path / pkg),
               "MODEL": {"ZOO": "instructblip"},
               "DATASETS": {"TEST": [name], "REGISTER": {name: {
                   "KIND": "imagenet", "ROOT": str(class_root)}}}}
        res = run(cfg) if pkg == "jax" else run(cfg, device="cpu")
        out[pkg] = res[name]
    assert out["port"] == out["jax"] and out["port"]["n"] == 10
    assert _read_csv(tmp_path / "port" / "imagenet_per_class.csv") == _read_csv(
        tmp_path / "jax" / "imagenet_per_class.csv")
    with pytest.raises(FileNotFoundError, match="config.json"):
        t_entry.evaluate({"NAME": "imagenet_test", "MODEL": {"ZOO_PATH": "/x"},
                          "DATASETS": {"TEST": ["imagenet_val_port"]}}, device="cpu")
    with pytest.raises(ValueError, match="ROOT"):
        t_entry.register_datasets_from_cfg({"DATASETS": {"REGISTER": {"i": {
            "KIND": "imagenet"}}}})
    assert t_entry.evaluate({"NAME": "imagenet_test"}, device="cpu") == {}
