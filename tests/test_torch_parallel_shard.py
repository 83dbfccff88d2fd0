"""The fsdp and tensor axes of the torch port's grid (``parallel/mesh.py``), on
the CPU over Gloo, against the JAX package: ``shard_spec`` against JAX's
``_fsdp_spec`` on every leaf of the tiny LLaVA tree (dense and planar NF4),
its trainable tree, its Adam state and the tiny X-Decoder tree on six
meshes, the rank -> coordinates map against ``make_mesh`` and ``rows``
against ``batch_sharding``; the gather with gradient along each axis, the
layout's reduction and its global norm on 2 and 4 ranks; the Q-LoRA step under ``MESH_FSDP: 2`` and ``MESH_TENSOR: 2``
against JAX's ``shard_train_step`` and the port's one process, each rank's
shards the slices of the one-process result; one 4-rank run of a (2,2,1)
and a (1,2,2) grid; the X-Decoder joint step under both axes; ``entry.main``
under ``CULLAVO_NUM_PROCS=2`` with ``MESH_FSDP: 2`` from a tiny snapshot:
only rank 0 writes, its checkpoints equal one process's, ``RESUME_FROM``
continues as one process does, and a rank holds half of the NF4 base.

Each rank is a subprocess of a script written to ``tmp_path``
(``test_torch_parallel.spawn_ranks``: two torch threads, a free port).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cullavo_tpu.models.llava import lora as jl
from cullavo_tpu.parallel import mesh as j_mesh
from cullavo_tpu.trainer import optimizer as j_opt
from cullavo_tpu.trainer import step as j_step
from cullavo_tpu_torch import entry as t_entry
from cullavo_tpu_torch.checkpoint import from_jax as bridge
from cullavo_tpu_torch.checkpoint.store import load_checkpoint
from cullavo_tpu_torch.data.registry import _DATASETS
from cullavo_tpu_torch.models.llava import lora as tl
from cullavo_tpu_torch.models.llava.config import tiny_llava_config
from cullavo_tpu_torch.models.llava.modeling import init_llava_params
from cullavo_tpu_torch.models.xdecoder import model as tmodel
from cullavo_tpu_torch.parallel import mesh as t_mesh
from cullavo_tpu_torch.trainer import optimizer as t_opt
from cullavo_tpu_torch.trainer import step as t_step
from cullavo_tpu_torch.trainer import xdecoder_step as t_xstep
from cullavo_tpu_torch.utils.tree import tree_leaves
from test_torch_parallel import (REPO, _two_threads, qlora, spawn_ranks,  # noqa: F401
                                 xdecoder_inputs)
from test_torch_joint_data import chip_smoke
from test_torch_train import LORA, LR, _np, _paths
from test_torch_zoo_snapshots import _flat

MESHES = [(1, 2, 1), (1, 1, 2), (2, 2, 2), (1, 4, 1), (1, 1, 4), (2, 1, 2)]
JOIN = """
from cullavo_tpu_torch.parallel import mesh as M
N = int(os.environ["CULLAVO_NUM_PROCS"])
assert M.initialize_distributed(os.environ["CULLAVO_COORDINATOR"], N, RANK, device="cpu")
GRIDS = json.load(open(os.path.join(WORK, f"grids{N}.json")))
def grid_context(d, f, t):
    return M.parallel_context({"MESH_DATA": d, "MESH_FSDP": f, "MESH_TENSOR": t})
"""


def _spec(p):
    """A JAX PartitionSpec -> (dim, axis) or None."""
    return next(((i, a) for i, a in enumerate(p) if a is not None), None)


def _own(x, spec, coords):
    """The slice of the whole ``x`` a rank at ``coords`` (i_d, i_f, i_t, F, T)
    holds."""
    if spec is None:
        return x
    dim, axis = spec
    n = {"fsdp": 1, "tensor": 2}[axis]
    k = x.shape[dim] // coords[2 + n]
    return x.narrow(dim, coords[n] * k, k)


def _grids(tmp_path, n, grids):
    with open(tmp_path / f"grids{n}.json", "w") as f:
        json.dump(grids, f)


def test_shard_spec_rows_and_grid_match_jax(qlora, monkeypatch):
    """On each of six meshes built by JAX's ``make_mesh`` on the conftest's
    CPU devices: ``shard_spec`` equals ``_fsdp_spec`` on every leaf of the
    five trees; the port's rank -> (i_d, i_f, i_t) names the device at that
    place of ``make_mesh(...).devices``, its ``rows`` equal that device's
    slice of ``batch_sharding``, and ``grid_groups`` puts each rank at its
    coordinate of every axis.  One process with an fsdp or tensor axis
    raises JAX's ``ValueError``."""
    _, tcfg, jtrain, jfrozen, _ = qlora
    dense = init_llava_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    trees = {"dense": dense, "nf4": jfrozen, "trainable": jtrain,
             "adam": j_opt.cullavo_optimizer(LR, 10).init(jtrain),
             "xdecoder": tmodel.init_xdecoder_model_params(
                 tmodel.tiny_xdecoder_config(), torch.Generator().manual_seed(0), "cpu")}
    B, sharded = 8, 0
    for d, f, t in MESHES:
        n = d * f * t
        mesh = j_mesh.make_mesh(j_mesh.MeshConfig(d, f, t), devices=jax.devices()[:n])
        for tree in trees.values():
            for leaf in jax.tree.leaves(tree):
                want = _spec(j_mesh._fsdp_spec((), leaf, mesh))
                assert t_mesh.shard_spec(tuple(leaf.shape), (f, t)) == want, leaf.shape
                sharded += want is not None
        index = j_mesh.batch_sharding(mesh).devices_indices_map((B,))
        groups = t_mesh.grid_groups(d, f, t)
        for r in range(n):
            monkeypatch.setattr(t_mesh, "process_index", lambda r=r: r)
            monkeypatch.setattr(t_mesh, "process_count", lambda n=n: n)
            ctx = t_mesh.ParallelContext(fsdp=f, tensor=t)
            i_d, i_f, i_t = ctx.coords
            assert mesh.devices[i_d, i_f, i_t] == jax.devices()[r]
            got, want = ctx.rows(B), index[jax.devices()[r]][0]
            assert (got.start, got.stop) == (want.start or 0, B if want.stop is None else want.stop)
            for axis, lines in groups.items():
                (mine,) = [ranks for ranks in lines if r in ranks]
                assert mine.index(r) == ctx.axis_index(axis) and len(mine) == ctx.axis_size(axis)
    assert sharded > 500
    monkeypatch.undo()
    for cfg, msg in (({"MESH_FSDP": 2}, "mesh 0x2x1 != 1 devices"),
                     ({"MESH_TENSOR": 2}, "mesh 0x1x2 != 1 devices"),
                     ({"MESH_DATA": 1, "MESH_FSDP": 4}, "mesh 1x4x1 != 1 devices")):
        with pytest.raises(ValueError, match=msg):
            t_mesh.parallel_context(cfg)


GATHER_BODY = JOIN + """
out = {}
for d, f, t in GRIDS:
    par = grid_context(d, f, t)
    g = torch.Generator().manual_seed(0)
    whole = {"w": torch.randn(3, 8, 12, generator=g, dtype=torch.float64),
             "v": torch.randn(8, generator=g, dtype=torch.float64),
             "m": torch.randn(5, 7, generator=g, dtype=torch.float64)}
    x_all = torch.randn(8, 8, generator=g, dtype=torch.float64)
    layout = M.Layout(par, whole)
    local = {k: v.requires_grad_(True) for k, v in layout.shard(whole).items()}
    par.begin_step()
    full = layout.gather(local, stacked=(("w",),))
    x = x_all[par.rows(8)]
    h = x
    for li in range(3):
        h = torch.tanh(h @ full["w"][li][:, :8])
    loss = (h.sum(0) * full["v"]).sum() + (full["m"] ** 2).sum() * x.shape[0] / 8
    grads = layout.reduce(dict(zip(local, torch.autograd.grad(loss, list(local.values())))))
    par.end_step()
    out[f"{d}{f}{t}"] = {
        "loss": par.sum_rows(loss.detach().clone()), "grads": grads,
        "norm": layout.global_norm(grads), "specs": layout.specs,
        "coords": par.coords + (par.fsdp, par.tensor), "timed": len(par.timings),
        "unshard": layout.unshard({k: v.detach() for k, v in local.items()})}
torch.save(out, os.path.join(WORK, f"gather{N}_{RANK}.pt"))
M.dist.destroy_process_group()
"""


def test_gather_backward_reduction_and_norm_on_two_and_four_ranks(tmp_path):
    """A stacked leaf gathered a layer at a time (``Shard``), a 1-D leaf and a
    replicated one, through a loss over each rank's rows, on every grid of
    2 and 4 ranks with an fsdp or tensor axis: the summed loss and the
    global norm equal the one-process values, every reduced gradient shard
    is the slice of the one-process gradient, ``unshard`` gives the whole
    leaves back, and the step's collectives were timed."""
    grids = {2: [(1, 2, 1), (1, 1, 2)], 4: [(1, 4, 1), (1, 1, 4), (2, 2, 1), (1, 2, 2),
                                            (2, 1, 2)]}
    for n, gs in grids.items():
        _grids(tmp_path, n, gs)
        spawn_ranks(tmp_path, f"gather{n}", GATHER_BODY, n=n)
    g = torch.Generator().manual_seed(0)
    whole = {"w": torch.randn(3, 8, 12, generator=g, dtype=torch.float64),
             "v": torch.randn(8, generator=g, dtype=torch.float64),
             "m": torch.randn(5, 7, generator=g, dtype=torch.float64)}
    x = torch.randn(8, 8, generator=g, dtype=torch.float64)
    leaves = {k: v.clone().requires_grad_(True) for k, v in whole.items()}
    h = x
    for li in range(3):
        h = torch.tanh(h @ leaves["w"][li][:, :8])
    loss = (h.sum(0) * leaves["v"]).sum() + (leaves["m"] ** 2).sum()
    want = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    norm = t_opt.global_norm(want)
    seen = set()
    for n, gs in grids.items():
        ranks = [torch.load(tmp_path / f"gather{n}_{r}.pt") for r in range(n)]
        for d, f, t in gs:
            for r in ranks:
                got = r[f"{d}{f}{t}"]
                torch.testing.assert_close(got["loss"], loss.detach(), rtol=1e-12, atol=0)
                torch.testing.assert_close(got["norm"], norm, rtol=1e-6, atol=0)
                for k, spec in zip(whole, got["specs"]):
                    seen.add(spec and spec[1])
                    torch.testing.assert_close(got["grads"][k],
                                               _own(want[k], spec, got["coords"]),
                                               rtol=1e-12, atol=1e-14)
                    assert torch.equal(got["unshard"][k], whole[k])
                assert got["timed"] >= 3
    assert seen == {None, "fsdp", "tensor"}


QLORA_BODY = JOIN + """
from cullavo_tpu_torch.models.llava.lora import LoraConfig
from cullavo_tpu_torch.trainer import optimizer as t_opt
from cullavo_tpu_torch.trainer import step as t_step
d = torch.load(os.path.join(WORK, "qlora_in.pt"), weights_only=False)
out = {}
for grid in GRIDS:
    par = grid_context(*grid)
    layout = M.Layout(par, d["train"])
    frozen = par.shard_tree(d["frozen"])
    for name, dropout, seed in (("plain", 0.0, None), ("dropout", 0.3, 7)):
        if name == "plain" and not d["plain"]:
            continue
        train = layout.shard(d["train"])
        tx = t_opt.cullavo_optimizer(d["lr"], 10, grad_clip=d["clip"], norm_fn=layout.global_norm)
        step = t_step.make_train_step(d["cfg"], LoraConfig(**{**d["lora"], "dropout": dropout}),
                                      tx, remat=True, compute_dtype=None, loss_chunk=8,
                                      layout=layout)
        rng = None if seed is None else torch.Generator().manual_seed(seed)
        st, m = step(t_step.TrainState(train, tx.init(train), 0), frozen, d["batch"], rng)
        out[f"{grid}{name}"] = {"loss": float(m["loss_llm"]), "gnorm": float(m["grad_norm"]),
                                "shards": st.trainable, "specs": layout.specs,
                                "coords": par.coords + (par.fsdp, par.tensor),
                                "train": layout.unshard(st.trainable)}
torch.save(out, os.path.join(WORK, f"qlora{N}_{RANK}.pt"))
M.dist.destroy_process_group()
"""


def _qlora_inputs(qlora, tmp_path, plain):
    jcfg, tcfg, jtrain, jfrozen, batch = qlora
    tfrozen = bridge.llava_params_from_numpy(_np(jfrozen), "cpu")
    ttrain = bridge.trainable_from_numpy(_np(jtrain), "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    torch.save({"cfg": tcfg, "lora": LORA, "frozen": tfrozen, "train": ttrain, "batch": tbatch,
                "lr": LR, "clip": 10.0, "plain": plain}, tmp_path / "qlora_in.pt")
    return tcfg, ttrain, tfrozen, tbatch


def _one_process_dropout(tcfg, ttrain, tfrozen, tbatch):
    step = t_step.make_train_step(tcfg, tl.LoraConfig(**{**LORA, "dropout": 0.3}),
                                  t_opt.cullavo_optimizer(LR, 10, grad_clip=10.0), remat=True,
                                  compute_dtype=None, loss_chunk=8)
    tx = t_opt.cullavo_optimizer(LR, 10, grad_clip=10.0)
    return step(t_step.TrainState(ttrain, tx.init(ttrain), 0), tfrozen, tbatch,
                torch.Generator().manual_seed(7))


def _held_to_one_process(ranks, key, one):
    """Every rank: the metrics of the one-process step (rtol 1e-5), its
    shards the slices of the one-process trainable (atol 1e-6)."""
    st, m = one
    flat_one = dict(_paths(st.trainable))
    for r in ranks:
        got = r[key]
        np.testing.assert_allclose(got["loss"], float(m["loss_llm"]), rtol=1e-5)
        np.testing.assert_allclose(got["gnorm"], float(m["grad_norm"]), rtol=1e-5)
        for shard, whole, spec in zip(tree_leaves(got["shards"]), tree_leaves(st.trainable),
                                      got["specs"]):
            np.testing.assert_allclose(shard.numpy(), _own(whole, spec, got["coords"]).numpy(),
                                       rtol=0, atol=1e-6)
        for path, a in _paths(got["train"]):
            np.testing.assert_allclose(a.numpy(), flat_one[path].numpy(), rtol=0, atol=1e-6,
                                       err_msg=path)
        assert got["loss"] == ranks[0][key]["loss"] and got["gnorm"] == ranks[0][key]["gnorm"]


def test_qlora_step_under_fsdp_and_tensor_matches_jax_and_one_process(tmp_path, qlora):
    """Two ranks under ``MESH_FSDP: 2``, then ``MESH_TENSOR: 2``: without
    dropout, ``loss_llm`` and ``grad_norm`` within test_train_step.py's
    tolerances (rtol 2e-5, 2e-4) of JAX's ``shard_train_step`` on the
    matching two-device mesh and the updated trainable within 3 x lr of
    JAX's; with dropout (0.3), the port's one-process step (rtol 1e-5, atol
    1e-6), each rank's shards the slices of its result; both ranks equal."""
    jcfg, tcfg, jtrain, jfrozen, batch = qlora
    tcfg, ttrain, tfrozen, tbatch = _qlora_inputs(qlora, tmp_path, plain=True)
    grids = [(1, 2, 1), (1, 1, 2)]
    _grids(tmp_path, 2, grids)
    spawn_ranks(tmp_path, "qlora", QLORA_BODY)
    ranks = [torch.load(tmp_path / f"qlora2_{r}.pt", weights_only=False) for r in range(2)]
    jtx = j_opt.cullavo_optimizer(LR, 10, grad_clip=10.0)
    one = _one_process_dropout(tcfg, ttrain, tfrozen, tbatch)
    for grid in grids:
        jstate = j_step.TrainState(jtrain, jtx.init(jtrain), jnp.zeros((), jnp.int32))
        mesh = j_mesh.make_mesh(j_mesh.MeshConfig(*grid), devices=jax.devices()[:2])
        jstep = j_step.shard_train_step(
            j_step.make_train_step(jcfg, jl.LoraConfig(**LORA), jtx, remat=True,
                                   compute_dtype=None, loss_chunk=8), mesh, jstate, jfrozen)
        jst, jmet = jstep(jstate, jfrozen, {k: jnp.asarray(v) for k, v in batch.items()}, None)
        for r in ranks:
            plain = r[f"{list(grid)}plain"]
            np.testing.assert_allclose(plain["loss"], float(jmet["loss_llm"]), rtol=2e-5)
            np.testing.assert_allclose(plain["gnorm"], float(jmet["grad_norm"]), rtol=2e-4)
            n = 0
            for (path, a), (_, b) in zip(_paths(plain["train"]), _paths(_np(jst.trainable))):
                if not path.endswith("mask"):
                    assert np.abs(a.numpy() - b).max() <= 3 * LR, path
                    n += 1
            assert n == 7 * 2 + 6 * 2 + 4 + 2
        drop = f"{list(grid)}dropout"
        assert abs(ranks[0][drop]["loss"] - ranks[0][f"{list(grid)}plain"]["loss"]) > 1e-4
        _held_to_one_process(ranks, drop, one)


def test_four_ranks_take_grids_221_and_122_as_one_process(tmp_path, qlora):
    """Four ranks, a (2, 2, 1) grid (two data parts of two fsdp ranks: the
    fsdp-sharded gradients summed over the data group) and a (1, 2, 2)
    grid (each fsdp part's rows on two tensor ranks): the dropout step of the
    port's one process on the global batch (rtol 1e-5, atol 1e-6)."""
    tcfg, ttrain, tfrozen, tbatch = _qlora_inputs(qlora, tmp_path, plain=False)
    grids = [(2, 2, 1), (1, 2, 2)]
    _grids(tmp_path, 4, grids)
    spawn_ranks(tmp_path, "qlora4", QLORA_BODY, n=4)
    ranks = [torch.load(tmp_path / f"qlora4_{r}.pt", weights_only=False) for r in range(4)]
    one = _one_process_dropout(tcfg, ttrain, tfrozen, tbatch)
    for grid in grids:
        _held_to_one_process(ranks, f"{list(grid)}dropout", one)
    assert {r[f"{list(grids[0])}dropout"]["coords"][:3] for r in ranks} == {
        (0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)}


XDEC_BODY = JOIN + """
from cullavo_tpu_torch.trainer import optimizer as topt
from cullavo_tpu_torch.trainer import xdecoder_step as tstep
from cullavo_tpu_torch.trainer.step import TrainState
d = torch.load(os.path.join(WORK, "xdec_in.pt"), weights_only=False)
out = {}
for grid in GRIDS:
    par = grid_context(*grid)
    layout = M.Layout(par, d["params"])
    local = layout.shard(d["params"])
    tx = topt.xdecoder_optimizer(base_lr=1e-4, total_steps=20, grad_clip=0.01,
                                 norm_fn=layout.global_norm)
    step = tstep.make_xdecoder_joint_train_step(d["cfg"], tx, remat=False, layout=layout)
    st, m = step(TrainState(local, tx.init(local), 0), d["batch"], torch.Generator().manual_seed(5))
    out[str(tuple(grid))] = {"metrics": {k: float(v) for k, v in m.items()},
                      "params": layout.unshard(st.trainable)}
torch.save(out, os.path.join(WORK, f"xdec{RANK}.pt"))
M.dist.destroy_process_group()
"""


def test_xdecoder_joint_step_under_fsdp_and_tensor_matches_one_process(tmp_path):
    """The tiny X-Decoder in f32, a global batch of 4 images, on two ranks
    under ``MESH_FSDP: 2`` and under ``MESH_TENSOR: 2`` (its rows on both
    ranks): every loss, the total and the gradient norm within 1e-5
    relative of the port's one-process step, the gathered parameters after
    the step within 1e-6; both ranks equal."""
    cfg, params, batch = xdecoder_inputs(tmp_path)
    torch.save({"cfg": cfg, "params": params, "batch": batch}, tmp_path / "xdec_in.pt")
    grids = [(1, 2, 1), (1, 1, 2)]
    _grids(tmp_path, 2, grids)
    spawn_ranks(tmp_path, "xdec", XDEC_BODY)
    ranks = [torch.load(tmp_path / f"xdec{r}.pt", weights_only=False) for r in range(2)]
    tx = t_opt.xdecoder_optimizer(base_lr=1e-4, total_steps=20, grad_clip=0.01)
    step = t_xstep.make_xdecoder_joint_train_step(cfg, tx, remat=False)
    st, m = step(t_step.TrainState(params, tx.init(params), 0), batch,
                 torch.Generator().manual_seed(5))
    want = {k: float(v) for k, v in m.items()}
    one = _flat(st.trainable)
    for grid in grids:
        got = ranks[0][str(grid)]
        assert sorted(got["metrics"]) == sorted(want) and len(want) > 20
        for k in want:
            np.testing.assert_allclose(got["metrics"][k], want[k], rtol=1e-5, atol=1e-7,
                                       err_msg=f"{grid} {k}")
        assert ranks[1][str(grid)]["metrics"] == got["metrics"]
        mine, other = _flat(got["params"]), _flat(ranks[1][str(grid)]["params"])
        assert sorted(mine) == sorted(one) and len(one) > 100
        for path, a in mine.items():
            assert np.array_equal(a, other[path]), path
            np.testing.assert_allclose(a, one[path], rtol=0, atol=1e-6, err_msg=path)


ENTRY_BODY = """
from cullavo_tpu_torch import entry
from cullavo_tpu_torch.pipelines import cullavo_pipeline as tpipe
make = tpipe.make_train_step
tpipe.make_train_step = lambda *a, **kw: make(*a, **{**kw, "compute_dtype": None})
entry.main(json.load(open(os.path.join(WORK, "entry_argv.json")))[RANK], device="cpu")
"""


def test_entry_main_under_fsdp_from_a_snapshot(tmp_path, monkeypatch):
    """``entry.main`` on configs/cullavo_step1.yaml from a tiny f32 snapshot
    (``BITS: 4``, f32 compute, LoRA dropout on, 8 images, batch 4, 2 steps)
    under ``CULLAVO_NUM_PROCS=2`` and ``MESH_FSDP: 2``, then ``RESUME_FROM``
    its epoch0 for 2 steps: both ranks print the one-process losses and
    norms (rtol 1e-5); rank 0 alone writes, and its step_2 (the whole state,
    Adam moments included) equals the one-process run's (atol 1e-6) beside
    the same epoch0 files; each rank's NF4 base bytes are half of the
    whole."""
    cs = chip_smoke()
    snap = tmp_path / "snapshot"
    snap.mkdir()
    cfg = dataclasses.replace(tiny_llava_config(602), image_token_id=600, pad_token_id=601)
    cs.write_snapshot(init_llava_params(cfg, torch.Generator().manual_seed(0), "cpu"), cfg,
                      str(snap))
    cs.write_tokenizer(str(snap), added=((600, "<image>"), (601, "<pad>")))
    json_file, img_dir, pan_dir = cs.write_panoptic_dataset(str(tmp_path / "coco"), n=8,
                                                            hw=(160, 200))
    dataset = {"KIND": "coco_panoptic", "JSON": json_file, "IMAGE_DIR": img_dir,
               "PANOPTIC_DIR": pan_dir, "NUM_CLASSES": 133}

    def argv(name, save_dir, grid, resume=None):
        over = {"DATASETS.TRAIN": name, "DATASETS.REGISTER": {name: dataset}, **grid}
        return (["train", "--conf_files", os.path.join(REPO, "configs/cullavo_step1.yaml"),
                 "--config_overrides", json.dumps(over), "--overrides", "SAVE_DIR",
                 str(save_dir), "BATCH_SIZE", "4", "PERIOD", "0", "LOG_EVERY", "1",
                 "MODEL.LLM.LOAD_PATH", str(snap), "MODEL.LLM.LORA_R", "4",
                 "MODEL.LLM.LORA_VISION_START", "1", "MODEL.LLM.LORA_VISION_STOP", "2"]
                + (["RESUME_FROM", str(resume)] if resume else []))

    lines = []
    for save, resume in (("rank", None), ("resumed", tmp_path / "rank0" / "epoch0")):
        with open(tmp_path / "entry_argv.json", "w") as f:
            json.dump([argv("coco_fsdp", tmp_path / f"{save}{r}", {"MESH_FSDP": 2}, resume)
                       for r in range(2)], f)
        outs = spawn_ranks(tmp_path, "entry", ENTRY_BODY)
        lines.append([json.loads([ln for ln in o.splitlines() if ln.startswith('{"rank"')][-1])
                      for o in outs])
    for run in lines:
        assert [(ln["rank"], ln["world"], ln["grid"]) for ln in run] == [(0, 2, [1, 2, 1]),
                                                                          (1, 2, [1, 2, 1])]
        assert (run[0]["loss_llm"], run[0]["grad_norm"]) == (run[1]["loss_llm"],
                                                             run[1]["grad_norm"])
    assert sorted(os.listdir(tmp_path / "rank0")) == ["epoch0", "step_2"]
    assert not any((tmp_path / f"{d}1").exists() for d in ("rank", "resumed"))

    make = t_entry.cullavo_pipeline.make_train_step
    monkeypatch.setattr(t_entry.cullavo_pipeline, "make_train_step",
                        lambda *a, **kw: make(*a, **{**kw, "compute_dtype": None}))
    for run, (save, resume) in zip(lines, (("one", None),
                                           ("one_resumed", tmp_path / "one" / "epoch0"))):
        hist = t_entry.main(argv(f"coco_{save}", tmp_path / save, {}, resume),
                            device="cpu")["history"]
        np.testing.assert_allclose(run[0]["loss_llm"], [h["loss_llm"] for h in hist], rtol=1e-5)
        np.testing.assert_allclose(run[0]["grad_norm"], [h["grad_norm"] for h in hist],
                                   rtol=1e-5)
    mine, one = (_flat(load_checkpoint(str(tmp_path / d), 2)) for d in ("rank0", "one"))
    assert sorted(mine) == sorted(one) and len(one) > 50
    for k, a in one.items():
        np.testing.assert_allclose(mine[k], a, rtol=0, atol=1e-6, err_msg=k)
    for dirpath, _, files in os.walk(tmp_path / "one" / "epoch0"):
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), tmp_path / "one")
            assert os.path.exists(tmp_path / "rank0" / rel), rel
    whole = tl.maybe_quantize_base(init_llava_params(cfg, torch.Generator().manual_seed(0),
                                                     "cpu"), 4)
    assert [ln["base_bytes"] for run in lines for ln in run] == [
        t_entry._base_bytes(whole) // 2] * 4
    for name in ("coco_one", "coco_one_resumed"):
        _DATASETS.pop(name, None)
