"""The port's X-Decoder joint training against the JAX package, on the CPU:
``forward_joint_train`` (remat off and on), one step of
``make_xdecoder_joint_train_step`` (every gradient leaf, the parameters
after the AdamW step) and ``entry.train`` on an X-Decoder config over a
registered ``coco_panoptic_caption_grounding`` dataset; and the K10 / K9
autograd Functions, whose CPU gradients must equal the plain versions'.

One tiny model (``tiny_xdecoder_config()`` in both packages, f32): the
port's initializer plus seeded noise, as numpy, to both packages (through
``checkpoint.from_jax``).  Every random point is pinned: JAX's
``jax.random.uniform`` and importance sampler and the port's point draws
are replaced by one seeded numpy sequence consumed in call order (JAX's
traced once, so its jitted step replays the same points every step; the
port's sequence restarts at every step).  JAX's loss and gradient program
is compiled once (remat off; remat changes no forward value) and serves the
forward, step and entry tests: JAX's entry runs with its step factory and
``jax.jit`` swapped for that program and a jitted ``xdecoder_optimizer``.
Tolerances: losses 1e-4 relative, gradients 1e-4 of each leaf's largest
entry (at least 1e-9 of the largest entry of all), parameters 1e-6.
"""
import ast

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import cullavo_tpu.entry as jentry
import cullavo_tpu.models.from_config as jfc
import cullavo_tpu.trainer.optimizer as jopt
import cullavo_tpu.trainer.xdecoder_step as jstep
from cullavo_tpu.checkpoint import store as jstore
from cullavo_tpu.data import coco_caption_grounding as jcg
from cullavo_tpu.data import registry as jreg
from cullavo_tpu.models.xdecoder import model as jmodel
from cullavo_tpu.trainer.step import TrainState as JTrainState
import cullavo_tpu_torch.entry as tentry
import cullavo_tpu_torch.trainer.xdecoder_step as tstep
from cullavo_tpu_torch.checkpoint import store as tstore
from cullavo_tpu_torch.checkpoint.from_jax import (xdecoder_params_from_numpy,
                                                   xdecoder_params_to_numpy)
from cullavo_tpu_torch.data import coco_caption_grounding as tcg
from cullavo_tpu_torch.data import registry as treg
from cullavo_tpu_torch.data.mappers.eval_mappers import normalize_np
from cullavo_tpu_torch.models.xdecoder import model as tmodel
from cullavo_tpu_torch.ops import focal, msdeform
from cullavo_tpu_torch.trainer import optimizer as topt
from cullavo_tpu_torch.trainer.step import TrainState
from test_torch_joint_data import CLASS_NAMES, N_THINGS, Draws, chip_smoke

SEED_POINTS = 11
B, S, MAX_INSTANCES = 2, 64, 4
SOLVER = {"BASE_LR": 1e-4, "MAX_ITER": 20, "CLIP_VALUE": 0.01}
# XLA:CPU options for the two big JAX programs: a quarter less compile time,
# the same f32 arithmetic
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _noisy(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a, np.float32) + rng.normal(
        0, 0.02, np.shape(a)).astype(np.float32)), tree)


class Slice:
    """The tiny model in both packages, one batch as the entry builds it,
    and JAX's loss / gradient program and optimizer, compiled once."""

    def __init__(self, root):
        self.jcfg, self.tcfg = jmodel.tiny_xdecoder_config(), tmodel.tiny_xdecoder_config()
        init = tmodel.init_xdecoder_model_params(self.tcfg, torch.Generator().manual_seed(0),
                                                 "cpu")
        self.np = _noisy(xdecoder_params_to_numpy(init), 0)
        self.jp = jax.tree.map(jnp.asarray, self.np)
        self.spec = chip_smoke().write_joint_dataset(
            root, [(64, 64), (48, 80), (64, 64), (80, 48)], CLASS_NAMES, N_THINGS, seed=2,
            captions=3)
        self.tokenize = tentry._make_text_tokenize({}, self.tcfg.text)
        recs = jcg.load_coco_panoptic_caption_grounding_json(
            self.spec["JSON"], self.spec["IMAGE_DIR"], self.spec["PANOPTIC_DIR"],
            self.spec["CAPTION_JSON"], self.spec["GROUNDING_JSON"], {})
        # the port's mapper (held to JAX's by test_torch_joint_data.py) spares
        # JAX's op-by-op resizes
        mapper = tcg.JointTrainMapper(image_size=S, class_names=CLASS_NAMES)
        mapped = [mapper(r) for r in recs[:B]]
        batch = tcg.collate_joint(mapped, self.tokenize, CLASS_NAMES, np.random.default_rng(3),
                                  max_instances=MAX_INSTANCES)
        batch["image"] = np.stack([normalize_np(m["image"]) for m in mapped])
        batch["class_ids"], batch["class_mask"] = self.tokenize(
            [f"a photo of a {c}." for c in CLASS_NAMES] + ["A background in coco."])
        self.batch = batch
        self.jtx = jopt.xdecoder_optimizer(base_lr=SOLVER["BASE_LR"],
                                           total_steps=SOLVER["MAX_ITER"],
                                           grad_clip=SOLVER["CLIP_VALUE"])
        jtx = self.jtx

        def loss(p, b):
            losses = jmodel.forward_joint_train(p, self.jcfg, b, jax.random.PRNGKey(1))
            return sum(losses.values()), losses

        def grad_fn(p, b):
            (total, losses), grads = jax.value_and_grad(loss, has_aux=True)(p, b)
            return total, losses, grads, optax.global_norm(grads)

        def update(grads, opt, params):
            updates, opt = jtx.update(grads, opt, params)
            return optax.apply_updates(params, updates), opt

        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        with pytest.MonkeyPatch.context() as mp:
            Draws(SEED_POINTS).pin_jax(mp)
            self.grad_fn = jax.jit(grad_fn).lower(self.jp, jb).compile(FAST_COMPILE)
        self.total, self.losses, self.grads, self.gnorm = self.grad_fn(self.jp, jb)
        self.init_fn = jax.jit(jtx.init)
        opt = self.init_fn(self.jp)
        self.update_fn = jax.jit(update).lower(self.grads, opt, self.jp).compile(FAST_COMPILE)
        self.new_params, _ = self.update_fn(self.grads, opt, self.jp)

    def port_params(self):
        return xdecoder_params_from_numpy(self.np, "cpu")

    def jax_step(self, state, batch, rng):
        """JAX's joint step on the compiled program (the entry's swap)."""
        total, losses, grads, gnorm = self.grad_fn(state.trainable, batch)
        params, opt = self.update_fn(grads, state.opt_state, state.trainable)
        return (JTrainState(params, opt, state.step + 1),
                {"loss_total": total, "grad_norm": gnorm, **losses})


@pytest.fixture(scope="module")
def sl(tmp_path_factory):
    return Slice(str(tmp_path_factory.mktemp("xdec_train")))


def _pin_port(monkeypatch):
    draws = Draws(SEED_POINTS)
    draws.pin_port(monkeypatch)
    return draws


def _rel(got, want, tol=1e-4):
    got, want = float(got), float(want)
    assert abs(got - want) <= tol * max(abs(want), 1e-6), (got, want)


@pytest.mark.parametrize("remat", [False, True])
def test_forward_joint_train_matches_jax(sl, monkeypatch, remat):
    _pin_port(monkeypatch)
    got = tmodel.forward_joint_train(sl.port_params(), sl.tcfg, sl.batch, None, remat=remat)
    assert set(got) == set(sl.losses) and len(got) == 39
    for k, want in sl.losses.items():
        _rel(got[k], want)


def test_joint_step_gradients_and_params_match_jax(sl, monkeypatch):
    _pin_port(monkeypatch)
    seen = {}
    finish = tstep._finish

    def capture(tx, state, total, losses, grads):
        seen["grads"] = grads
        return finish(tx, state, total, losses, grads)

    monkeypatch.setattr(tstep, "_finish", capture)
    tx = topt.xdecoder_optimizer(base_lr=SOLVER["BASE_LR"], total_steps=SOLVER["MAX_ITER"],
                                 grad_clip=SOLVER["CLIP_VALUE"])
    params = sl.port_params()
    step = tstep.make_xdecoder_joint_train_step(sl.tcfg, tx, remat=True)
    state, metrics = step(TrainState(params, tx.init(params), 0), sl.batch, None)
    _rel(metrics["loss_total"], sl.total)
    _rel(metrics["grad_norm"], sl.gnorm)
    grads = xdecoder_params_to_numpy(seen["grads"])
    new = xdecoder_params_to_numpy(state.trainable)
    flat_g = jax.tree_util.tree_leaves_with_path(grads)
    assert len(flat_g) == len(jax.tree.leaves(sl.grads))
    # a leaf whose gradient is zero in exact arithmetic (the attention's key
    # biases) holds rounding noise on both sides: 1e-9 of the largest
    # gradient entry is the floor
    floor = 1e-9 * max(float(np.abs(np.asarray(g)).max()) for g in jax.tree.leaves(sl.grads))
    for (path, got), want, got_p, want_p in zip(flat_g, jax.tree.leaves(sl.grads),
                                                jax.tree.leaves(new),
                                                jax.tree.leaves(sl.new_params)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=max(1e-4 * np.abs(want).max(), floor),
                                   err_msg=jax.tree_util.keystr(path))
        np.testing.assert_allclose(got_p, np.asarray(want_p), rtol=0, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    assert state.step == 1 and state.opt_state["count"] == 1


def test_entry_train_matches_jax(sl, monkeypatch, tmp_path, capsys):
    """``entry.train`` on an xdecoder config over the registered fixture,
    2 steps in both packages (JAX's config reader, weights, optimizer and
    step swapped as the module says); losses and gradient norms per step,
    and the port's checkpoint read back bit-equal (and within 1e-6 of
    JAX's)."""
    name = "xdecoder_train_fixture_entry"
    cfg = {"NAME": "xdecoder_train", "BATCH_SIZE": B, "EPOCHS": 1, "SEED": 0,
           "MAX_INSTANCES": MAX_INSTANCES, "REMAT": True, "FP32_TRAIN": True,
           "INPUT": {"IMAGE_SIZE": S}, "SOLVER": dict(SOLVER),
           "DATASETS": {"TRAIN": [name], "REGISTER": {name: dict(sl.spec)}}}
    for reg in (jreg, treg):
        monkeypatch.setattr(reg, "_DATASETS", dict(reg._DATASETS))
        monkeypatch.setattr(reg, "_METADATA", dict(reg._METADATA))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfc, "xdecoder_model_config_from", lambda c: sl.jcfg)
        mp.setattr(jentry, "_load_xdecoder_params", lambda c, m: sl.jp)
        mp.setattr(jopt, "xdecoder_optimizer",
                   lambda **kw: optax.GradientTransformation(sl.init_fn, None))
        mp.setattr(jstep, "make_xdecoder_joint_train_step", lambda *a, **k: sl.jax_step)
        mp.setattr(jax, "jit", lambda fn, **kw: fn)
        capsys.readouterr()
        jentry.train(dict(cfg, SAVE_DIR=str(tmp_path / "jax")))
        logged = [ast.literal_eval(line) for line in capsys.readouterr().err.splitlines()
                  if line.startswith("{'step'")]
    assert [d["step"] for d in logged] == [1, 2]

    draws = _pin_port(monkeypatch)
    fwd = tstep.forward_joint_train

    def fresh_points(*a, **k):
        draws.reset()
        return fwd(*a, **k)

    monkeypatch.setattr(tstep, "forward_joint_train", fresh_points)
    monkeypatch.setattr(tentry, "xdecoder_model_config_from", lambda c: sl.tcfg)
    monkeypatch.setattr(tentry, "_load_xdecoder_params", lambda c, m, d: sl.port_params())
    res = tentry.train(dict(cfg, SAVE_DIR=str(tmp_path / "port")), device="cpu")
    assert len(res["history"]) == 2
    for got, want in zip(res["history"], logged):
        _rel(got["loss_total"], want["loss_total"])
        _rel(got["grad_norm"], want["grad_norm"])
    saved = tstore.load_checkpoint(str(tmp_path / "port"))["params"]
    final = {k: v for k, v in res["state"].trainable.items()}
    for (path, got), want in zip(jax.tree_util.tree_leaves_with_path(saved),
                                 jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), final))):
        np.testing.assert_array_equal(got, want, err_msg=jax.tree_util.keystr(path))
    jax_saved = jstore.load_checkpoint(str(tmp_path / "jax"))["params"]
    for got, want in zip(jax.tree.leaves(xdecoder_params_to_numpy(final)),
                         jax.tree.leaves(jax_saved)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)


def test_entry_train_without_datasets_returns_none():
    cfg = {"NAME": "xdecoder_train", "MODEL": {"TINY": True}, "DATASETS": {"TRAIN": None}}
    assert tentry.train(cfg, device="cpu") is None
    with pytest.raises(ValueError, match="mesh 0x1x2 != 1 devices"):
        tentry.train(dict(cfg, MESH_TENSOR=2), device="cpu")


# ---------------------------------------------------------------------------
# the kernels' autograd Functions (the plain version on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("approximate", [True, False])
def test_focal_function_gradients_equal_the_plain_versions(approximate):
    rng = np.random.default_rng(0)
    B, C, H, W, kernels = 2, 8, 9, 11, (3, 5, 7)
    ctx = torch.tensor(rng.normal(size=(B, C, H * W)), dtype=torch.float32)
    gates = torch.tensor(rng.normal(size=(B, len(kernels) + 1, H * W)), dtype=torch.float32)
    taps = [torch.tensor(rng.normal(size=(C, 1, k, k)) * 0.2, dtype=torch.float32)
            for k in kernels]
    up = torch.tensor(rng.normal(size=(B, C, H * W)), dtype=torch.float32)
    grads = []
    for fn in (focal.focal_ctx_kernel, focal.focal_ctx_plain):
        leaves = [t.clone().requires_grad_(True) for t in [ctx, gates] + taps]
        lw = focal.pack_level_weights(leaves[2:])
        out = fn(leaves[0], leaves[1], lw, H, W, kernels, True, approximate)
        assert out.grad_fn is not None
        grads.append(torch.autograd.grad((out * up).sum(), leaves))
    for got, want in zip(*grads):
        assert torch.equal(got, want)


def test_msdeform_function_gradients_equal_the_plain_versions():
    rng = np.random.default_rng(1)
    shapes = ((6, 8), (3, 4))
    Bq, Q, Hh, hd, L, P = 2, 10, 2, 8, 2, 3
    value = torch.tensor(rng.normal(size=(Bq, sum(h * w for h, w in shapes), Hh, hd)),
                         dtype=torch.float32)
    loc = torch.tensor(rng.uniform(-0.1, 1.1, (Bq, Q, Hh, L, P, 2)), dtype=torch.float32)
    att = torch.tensor(rng.random((Bq, Q, Hh, L, P)), dtype=torch.float32)
    up = torch.tensor(rng.normal(size=(Bq, Q, Hh * hd)), dtype=torch.float32)
    grads = []
    for fn in (msdeform.ms_deform_attn_kernel, msdeform.ms_deform_attn):
        leaves = [t.clone().requires_grad_(True) for t in (value, loc, att)]
        out = fn(leaves[0], shapes, leaves[1], leaves[2])
        assert out.grad_fn is not None
        grads.append(torch.autograd.grad((out * up).sum(), leaves))
    for got, want in zip(*grads):
        assert torch.equal(got, want)
