"""The DaViT backbone, port against the JAX package on the CPU: the
port's initializer tree against JAX's, ``davit_forward`` at a size whose
stages pad to whole windows, the reference-layout import (``import_davit``
bit for bit against JAX's through ``checkpoint.from_jax``, and the inverse
table's round trip), and ``entry.evaluate`` on a tiny DaViT X-Decoder
(``RESUME_FROM`` a written ``.pt``, a ``semseg`` dataset of PNGs) against
JAX's.  Tolerances: res2-res5 in f32 within 1e-4 of each map's largest
entry; metric dicts within 1e-6 (they agree exactly on this data)."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cullavo_tpu.checkpoint.xdecoder_import as jimp
import cullavo_tpu.config as jconfig
import cullavo_tpu.data.registry as jreg
import cullavo_tpu.entry as jentry
import cullavo_tpu.models.from_config as jfc
import cullavo_tpu.models.xdecoder.davit as jdavit
import cullavo_tpu_torch.checkpoint.xdecoder_import as timp
import cullavo_tpu_torch.data.registry as treg
import cullavo_tpu_torch.entry as tentry
import cullavo_tpu_torch.models.from_config as tfc
import cullavo_tpu_torch.models.xdecoder.davit as tdavit
import cullavo_tpu_torch.models.xdecoder.model as tmodel
from cullavo_tpu_torch.checkpoint.from_jax import (xdecoder_params_from_numpy,
                                                   xdecoder_params_to_numpy)
from test_torch_joint_data import chip_smoke
from test_torch_xdecoder import _noisy_numpy
from test_xdecoder_import import _davit_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# window 4: stage 1 of a 72 x 88 image is 18 x 22, padded to 20 x 24
SMALL = dict(embed_dims=(8, 16, 32, 64), num_heads=(2, 2, 4, 4), num_groups=(2, 2, 4, 4),
             depths=(1, 1, 2, 1), window_size=4)
CLASSES = ["person", "car", "dog", "wall", "sky", "grass"]
# configs/xdecoder/davitd3_unicl_lang.yaml at a tiny width
TINY_DAVIT = {"MODEL": {"BACKBONE": {"NAME": "davit", "DAVIT": {
                  "DIM_EMBED": [8, 16, 32, 64], "NUM_HEADS": [2, 2, 4, 4],
                  "NUM_GROUPS": [2, 2, 4, 4], "DEPTHS": [1, 1, 2, 1], "WINDOW_SIZE": 4}},
                        "ENCODER": {"CONVS_DIM": 64, "MASK_DIM": 32, "NUM_CLASSES": len(CLASSES),
                                    "TRANSFORMER_ENC_LAYERS": 1},
                        "DECODER": {"HIDDEN_DIM": 64, "NUM_OBJECT_QUERIES": 9, "NHEADS": 4,
                                    "DIM_FEEDFORWARD": 128, "DEC_LAYERS": 3},
                        "TEXT": {"WIDTH": 32, "HEADS": 4, "LAYERS": 2, "CONTEXT_LENGTH": 16},
                        "DIM_PROJ": 64},
              "EVAL_BATCH": 2}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_registries(monkeypatch):
    for reg in (jreg, treg):
        monkeypatch.setattr(reg, "_DATASETS", {})
        monkeypatch.setattr(reg, "_METADATA", {})


def _assert_trees_equal(got, want):
    fg, fw = timp._flatten(got), timp._flatten(want)
    assert fg.keys() == fw.keys(), sorted(set(fg) ^ set(fw))[:6]
    for k in fw:
        a, b = torch.as_tensor(np.array(fg[k])), torch.as_tensor(np.array(fw[k]))
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b), k


def test_davit_forward_matches_jax():
    """The port's initializer tree has JAX's leaves and shapes (through the
    bridge); res2-res5 within 1e-4 of JAX's at a size that pads every
    stage's map to whole windows (stage 1: 18 x 22 under windows of 4), in
    f32 (erf GELU) and with the tanh GELU forced."""
    jcfg, tcfg = jdavit.DaViTConfig(**SMALL), tdavit.DaViTConfig(**SMALL)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    init = tdavit.init_davit_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tree = _noisy_numpy(xdecoder_params_to_numpy(init), 0)
    shapes = {jax.tree_util.keystr(k): np.shape(v) for k, v in
              jax.tree_util.tree_leaves_with_path(jdavit.init_davit_params(
                  jcfg, jax.random.PRNGKey(0)))}
    assert {jax.tree_util.keystr(k): np.shape(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)} == shapes
    x = np.random.default_rng(1).normal(size=(2, 72, 88, 3)).astype(np.float32)
    for exact in (None, False):
        jc, tc = (dataclasses.replace(c, exact_gelu=exact) for c in (jcfg, tcfg))
        want = jax.jit(lambda p, im: jdavit.davit_forward(p, jc, im))(
            jax.tree.map(jnp.asarray, tree), x)
        got = tdavit.davit_forward(xdecoder_params_from_numpy(tree, "cpu"), tc,
                                   torch.from_numpy(x).permute(0, 3, 1, 2))
        assert [tuple(got[k].shape[2:]) for k in sorted(got)] == [(18, 22), (9, 11), (4, 5),
                                                                  (2, 2)]
        for k in want:
            w = np.asarray(want[k])
            np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(), w,
                                       atol=1e-4 * np.abs(w).max(), rtol=0, err_msg=k)


def test_import_davit_matches_jax_and_round_trips():
    """``import_davit`` on the JAX tests' synthetic reference state equals
    JAX's import through the bridge, bit for bit; a whole DaViT X-Decoder
    written by the inverse table holds every key and reads back bit-equal
    through both packages' importers; a missing key raises."""
    jcfg, tcfg = jdavit.DaViTConfig(**SMALL), tdavit.DaViTConfig(**SMALL)
    sd = _davit_state(jcfg)
    want = xdecoder_params_from_numpy(jax.tree.map(np.asarray, jimp.import_davit(sd, jcfg)),
                                      "cpu")
    _assert_trees_equal(timp.import_davit(sd, tcfg), want)
    with pytest.raises(KeyError, match=r"blocks\.2\.1\.channel_block\.ffn\.fn\.net\.fc2\.bias"):
        timp.import_davit({k: v for k, v in sd.items()
                           if not k.endswith("blocks.2.1.channel_block.ffn.fn.net.fc2.bias")},
                          tcfg)
    mcfg, jm = tfc.xdecoder_model_config_from(TINY_DAVIT), jfc.xdecoder_model_config_from(
        TINY_DAVIT)
    init = tmodel.init_xdecoder_model_params(mcfg, torch.Generator().manual_seed(3), "cpu")
    params = xdecoder_params_from_numpy(_noisy_numpy(xdecoder_params_to_numpy(init), 3), "cpu")
    state = {k: v.numpy() for k, v in timp.reference_state_from_params(params, mcfg).items()}
    assert set(state) == {e.key for e in timp.reference_table(mcfg)}
    assert timp.unused_keys(state, mcfg) == []
    _assert_trees_equal(timp.align_and_update(init, timp.import_xdecoder_checkpoint(state, mcfg)),
                        params)
    jback = jimp.import_xdecoder_checkpoint(state, jm)
    _assert_trees_equal(xdecoder_params_from_numpy(jax.tree.map(np.asarray, jback), "cpu"),
                        params)


def test_entry_eval_davit_matches_jax(tmp_path, monkeypatch):
    """``entry.main`` on configs/xdecoder/davitd3_unicl_lang.yaml at a tiny
    width, ``RESUME_FROM`` a ``.pt`` of the port's weights, over a
    registered ``semseg`` dataset (semantic, panoptic and instance): every
    metric equals JAX's ``entry.evaluate``'s."""
    monkeypatch.delenv("DETECTRON2_DATASETS", raising=False)
    monkeypatch.delenv("DATASET", raising=False)
    mcfg = tfc.xdecoder_model_config_from(TINY_DAVIT)
    init = tmodel.init_xdecoder_model_params(mcfg, torch.Generator().manual_seed(4), "cpu")
    params = xdecoder_params_from_numpy(_noisy_numpy(xdecoder_params_to_numpy(init), 4), "cpu")
    pt = str(tmp_path / "davit.pt")
    torch.save({"model": timp.reference_state_from_params(params, mcfg)}, pt)
    spec = dict(chip_smoke().write_semseg_dataset(
        str(tmp_path / "semseg"), [(96, 128), (128, 112), (120, 100)], CLASSES, seed=5),
        TASKS=["semantic", "panoptic", "instance"])
    over = {**TINY_DAVIT, "DATASETS": {"TEST": ["davit_semseg"],
                                       "REGISTER": {"davit_semseg": spec}}}
    argv = ["eval", "--conf_files", os.path.join(REPO, "configs/xdecoder/davitd3_unicl_lang.yaml"),
            "--config_overrides", json.dumps(over), "--overrides", "RESUME_FROM", pt]
    want = jentry.evaluate(jconfig.load_opt_command(argv)[0])
    got = tentry.main(argv, device="cpu")
    assert set(got) == set(want) == {"davit_semseg"}
    assert "sem_seg" in want["davit_semseg"]
    for key, w in want["davit_semseg"].items():
        if key in ("timing", "panoptic_outputs", "instance_outputs"):
            continue
        g = got["davit_semseg"][key]
        assert set(g) == set(w), key
        for name in w:
            assert g[name] == pytest.approx(w[name], abs=1e-6), (key, name)
