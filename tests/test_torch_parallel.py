"""Several processes in the torch port (``parallel/mesh.py``, the data axis),
on the CPU over Gloo: ``MeshConfig.resolve`` against JAX's, an fsdp /
tensor axis in one process; the collectives two ranks use (the gather with gradient,
the flat gradient all-reduce, ``all_gather_object``); the Q-LoRA step on
two ranks (a global batch of 8 split 4 + 4 with different token counts)
against JAX's ``shard_train_step`` on a two-device data mesh without
dropout, and against the port's one-process step with dropout; the
X-Decoder joint step on two ranks against the port's one-process step
(which ``test_torch_xdecoder_train.py`` holds to JAX); step2_pre on two
ranks against one-process runs of each rank's shard, its JSON written once;
``entry.main`` under ``CULLAVO_NUM_PROCS=2`` training with only rank 0
writing.

Each rank is a subprocess of a script written to ``tmp_path`` (a spawned
child cannot import a test file), two torch threads, a free port, joined
with a timeout; the ranks hand their results back through ``torch.save``.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cullavo_tpu.models.llava import lora as jl
from cullavo_tpu.models.llava import modeling as jm
from cullavo_tpu.models.llava.config import tiny_llava_config as j_tiny
from cullavo_tpu.parallel import mesh as j_mesh
from cullavo_tpu.trainer import optimizer as j_opt
from cullavo_tpu.trainer import step as j_step
from cullavo_tpu_torch import entry as t_entry
from cullavo_tpu_torch.checkpoint import from_jax as bridge
from cullavo_tpu_torch.data.coco_caption_grounding import JointTrainMapper, collate_joint
from cullavo_tpu_torch.data.mappers.eval_mappers import normalize_np
from cullavo_tpu_torch.data.registry import _DATASETS
from cullavo_tpu_torch.models.llava import lora as tl
from cullavo_tpu_torch.models.llava.config import tiny_llava_config as t_tiny
from cullavo_tpu_torch.models.xdecoder import model as tmodel
from cullavo_tpu_torch.parallel import mesh as t_mesh
from cullavo_tpu_torch.pipelines import cullavo_pipeline as tpipe
from cullavo_tpu_torch.trainer import optimizer as t_opt
from cullavo_tpu_torch.trainer import step as t_step
from cullavo_tpu_torch.trainer import xdecoder_step as t_xstep
from test_torch_joint_data import CLASS_NAMES, N_THINGS, chip_smoke
from test_torch_train import LORA, LR, _np, _paths, _planar_cfg
from test_torch_zoo_snapshots import _flat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


PRELUDE = f"""
import json, os, sys
sys.path.insert(0, {REPO!r})
import torch
torch.set_num_threads(2)
RANK = int(os.environ["CULLAVO_PROC_ID"])
WORK = sys.argv[1]
"""
# the ranks join the group themselves (the entry test goes through entry.main)
JOIN = """
from cullavo_tpu_torch.parallel import initialize_distributed, parallel_context
assert initialize_distributed(os.environ["CULLAVO_COORDINATOR"], 2, RANK, device="cpu")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(tmp_path, name, body, n=2, timeout=300):
    """Run ``PRELUDE + body`` as ``n`` ranks (the launcher's env contract,
    Gloo); every rank must exit 0.  Returns each rank's stdout."""
    script = tmp_path / f"{name}.py"
    script.write_text(PRELUDE + body)
    port = _free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2", CULLAVO_NUM_PROCS=str(n),
                   CULLAVO_PROC_ID=str(r), CULLAVO_COORDINATOR=f"127.0.0.1:{port}")
        env.pop("CULLAVO_DIST_BACKEND", None)
        procs.append(subprocess.Popen([sys.executable, str(script), str(tmp_path)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            p.kill()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{err[-4000:]}"
    return [out for out, _ in outs]


def test_mesh_config_and_what_waits():
    """``resolve`` gives JAX's axes and raises where JAX's does; without a
    process group there is no context; one process with an fsdp or tensor
    axis above 1 raises JAX's ``ValueError`` (several ranks run them:
    test_torch_parallel_shard.py); ``rows`` is ``np.array_split``'s; the
    launcher's contract is checked before a group is joined."""
    cases = [(-1, 1, 1, 8), (2, 2, 2, 8), (-1, 2, 1, 8), (-1, 1, 4, 8), (2, 1, 1, 2),
             (-1, 1, 1, 1), (1, 1, 1, 1), (4, 1, 1, 8), (3, 1, 1, 2), (-1, 3, 1, 8)]
    for d, f, t, n in cases:
        jcfg, tcfg = j_mesh.MeshConfig(d, f, t), t_mesh.MeshConfig(d, f, t)
        try:
            want = jcfg.resolve(n)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                tcfg.resolve(n)
            continue
        assert tcfg.resolve(n) == want
    assert t_mesh.parallel_context({"MESH_DATA": -1}) is None
    assert t_mesh.parallel_context({}) is None
    for cfg, msg in (({"MESH_FSDP": 2}, "mesh 0x2x1 != 1 devices"),
                     ({"MESH_TENSOR": 2}, "mesh 0x1x2 != 1 devices"),
                     ({"MESH_DATA": 1, "MESH_FSDP": 4}, "mesh 1x4x1 != 1 devices")):
        with pytest.raises(ValueError, match=msg):
            t_mesh.parallel_context(cfg)
    with pytest.raises(ValueError, match="mesh 2x1x1 != 1"):
        t_mesh.parallel_context({"MESH_DATA": 2})
    ctx = t_mesh.ParallelContext()
    for n in (7, 8, 2):
        parts = np.array_split(np.arange(n), 3)
        for r in range(3):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(t_mesh, "process_index", lambda r=r: r)
                mp.setattr(t_mesh, "process_count", lambda: 3)
                assert list(range(n))[ctx.rows(n)] == list(parts[r])
    assert not t_mesh.initialize_distributed(None, 1, 0)
    with pytest.raises(ValueError, match="CULLAVO_COORDINATOR"):
        t_mesh.initialize_distributed("", 2, 0, device="cpu")
    with pytest.raises(ValueError, match="CULLAVO_PROC_ID=2"):
        t_mesh.initialize_distributed("127.0.0.1:1", 2, 2, device="cpu")


def test_collectives_on_two_ranks(tmp_path):
    """The gather with gradient (rows 3 + 2 of a batch of 5) against the
    one-process gradient of a loss over the whole batch, each rank's loss
    its share (divided by 2); the gather without gradient of integer rows,
    a part's draw rows and its summed denominator; ``all_reduce_tree`` over
    mixed dtypes; the object gather and the barrier."""
    body = JOIN + """
from cullavo_tpu_torch.parallel import all_reduce_tree
par = parallel_context({})
g = torch.Generator().manual_seed(0)
x_all = torch.randn(5, 3, generator=g, dtype=torch.float64).float()
w = torch.randn(3, 4, generator=g)
sl = par.rows(5)
part = par.part(5)
x = x_all[sl].clone().requires_grad_(True)
full = part.gather(x)
loss = part.share((torch.softmax(full @ w, dim=0) * torch.arange(20.).reshape(5, 4)).sum())
loss.backward()
ids = part.gather(torch.arange(5, dtype=torch.int64)[sl] * 7)
denom = part.sum(torch.tensor(float(part.n)))
tree = all_reduce_tree([torch.full((2, 2), RANK + 1.0),
                        torch.tensor([RANK + 1], dtype=torch.int64),
                        torch.ones(3, dtype=torch.bfloat16) * (RANK + 1)])
par.barrier()
torch.save({"full": full.detach(), "grad": x.grad, "rows": (sl.start, sl.stop), "tree": tree,
            "ids": ids, "denom": denom, "draw_rows": part.rows(4),
            "objs": par.allgather_objects({"rank": RANK, "s": "x" * (RANK + 3)})},
           os.path.join(WORK, f"coll{RANK}.pt"))
"""
    spawn_ranks(tmp_path, "collectives", body)
    g = torch.Generator().manual_seed(0)
    x_all = torch.randn(5, 3, generator=g, dtype=torch.float64).float().requires_grad_(True)
    w = torch.randn(3, 4, generator=g)
    (torch.softmax(x_all @ w, dim=0) * torch.arange(20.).reshape(5, 4)).sum().backward()
    got = [torch.load(tmp_path / f"coll{r}.pt") for r in range(2)]
    assert [r["rows"] for r in got] == [(0, 3), (3, 5)]
    assert [r["draw_rows"] for r in got] == [(0, 12, 20), (12, 20, 20)]
    for r in got:
        assert r["ids"].tolist() == [0, 7, 14, 21, 28] and r["denom"].item() == 5.0
        assert torch.equal(r["full"], x_all.detach())
        assert r["objs"] == [{"rank": 0, "s": "xxx"}, {"rank": 1, "s": "xxxx"}]
        assert torch.equal(r["tree"][0], torch.full((2, 2), 3.0))
        assert r["tree"][1].tolist() == [3] and r["tree"][2].dtype == torch.bfloat16
        assert r["tree"][2].tolist() == [3.0] * 3
    grad = torch.cat([got[0]["grad"], got[1]["grad"]])
    torch.testing.assert_close(grad, x_all.grad, rtol=1e-6, atol=1e-7)


QLORA_B, QLORA_T = 8, 24


@pytest.fixture(scope="module")
def qlora():
    """JAX's tiny planar config over an NF4 base, adapters with random ``b``,
    a global batch of 8: rows 0-3 full, rows 4-7 right-padded to other
    lengths (so the halves' token counts differ), weights 1.0 / 0.5."""
    jcfg, tcfg = _planar_cfg(j_tiny), _planar_cfg(t_tiny)
    jp = jm.init_llava_params(jcfg, jax.random.PRNGKey(0))
    jlora = jl.init_lora_params(jp, jcfg, jl.LoraConfig(**LORA), jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    jlora = jax.tree_util.tree_map_with_path(
        lambda path, a: (jnp.asarray(rng.normal(size=a.shape).astype(np.float32) * 0.05)
                         if path[-1].key == "b" else a), jlora)
    jp = jl.quantize_llm_weights(jp, bits=4)
    n_img = jcfg.num_image_tokens
    ids = rng.integers(4, 126, size=(QLORA_B, QLORA_T)).astype(np.int32)
    ids[:, 1:1 + n_img] = jcfg.image_token_id
    mask = np.ones((QLORA_B, QLORA_T), np.int32)
    for i, cut in zip(range(4, 8), (3, 9, 5, 12)):
        mask[i, QLORA_T - cut:] = 0
    labels = np.where(mask != 0, ids, -100).astype(np.int32)
    labels[:, :1 + n_img + 2] = -100
    batch = {"input_ids": ids, "attention_mask": mask, "labels": labels,
             "pixel_values": rng.normal(size=(QLORA_B, 3, 28, 28)).astype(np.float32),
             "weights": np.asarray([1.0, 0.5] * 4, np.float32)}
    return jcfg, tcfg, jl.trainable_partition(jp, jlora), jl.strip_trainable(jp), batch


QLORA_BODY = JOIN + """
from cullavo_tpu_torch.models.llava.lora import LoraConfig
from cullavo_tpu_torch.trainer import optimizer as t_opt
from cullavo_tpu_torch.parallel import Layout
from cullavo_tpu_torch.trainer import step as t_step
d = torch.load(os.path.join(WORK, "qlora_in.pt"), weights_only=False)
layout = Layout(parallel_context({"MESH_DATA": 2}), d["train"])
out = {}
for name, dropout, seed in (("plain", 0.0, None), ("dropout", 0.3, 7)):
    tx = t_opt.cullavo_optimizer(d["lr"], 10, grad_clip=d["clip"])
    step = t_step.make_train_step(d["cfg"], LoraConfig(**{**d["lora"], "dropout": dropout}), tx,
                                  remat=True, compute_dtype=None, loss_chunk=8, layout=layout)
    rng = None if seed is None else torch.Generator().manual_seed(seed)
    st, m = step(t_step.TrainState(d["train"], d["opt"], 0), d["frozen"], d["batch"], rng)
    out[name] = {"loss": float(m["loss_llm"]), "gnorm": float(m["grad_norm"]),
                 "train": st.trainable}
torch.save(out, os.path.join(WORK, f"qlora{RANK}.pt"))
"""


def test_qlora_step_on_two_ranks_matches_jax_and_one_process(tmp_path, qlora):
    """Without dropout: ``loss_llm`` and ``grad_norm`` within test_train_step.py's
    tolerances (rtol 2e-5, 2e-4) of JAX's ``shard_train_step`` on a
    two-device data mesh, the updated trainable within 3 x lr of JAX's (as
    test_torch_train.py holds the one-process step: Adam turns rounding
    noise of near-zero gradients into steps of up to lr).  With dropout
    (0.3): equal to the port's one-process step on the global batch (loss
    and norm rtol 1e-5, parameters atol 1e-6).  Both ranks' results equal."""
    jcfg, tcfg, jtrain, jfrozen, batch = qlora
    clip = 10.0
    jtx = j_opt.cullavo_optimizer(LR, 10, grad_clip=clip)
    kw = dict(remat=True, compute_dtype=None, loss_chunk=8)
    jstate = j_step.TrainState(jtrain, jtx.init(jtrain), jnp.zeros((), jnp.int32))
    topt_state = bridge.opt_state_from_numpy(_np(jstate.opt_state), "cpu")
    tfrozen = bridge.llava_params_from_numpy(_np(jfrozen), "cpu")
    ttrain = bridge.trainable_from_numpy(_np(jtrain), "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    torch.save({"cfg": tcfg, "lora": LORA, "frozen": tfrozen, "train": ttrain,
                "opt": topt_state, "batch": tbatch, "lr": LR, "clip": clip},
               tmp_path / "qlora_in.pt")
    spawn_ranks(tmp_path, "qlora", QLORA_BODY)
    ranks = [torch.load(tmp_path / f"qlora{r}.pt", weights_only=False) for r in range(2)]

    mesh = j_mesh.make_mesh(j_mesh.MeshConfig(data=2), devices=jax.devices()[:2])
    jstep = j_step.shard_train_step(j_step.make_train_step(jcfg, jl.LoraConfig(**LORA), jtx, **kw),
                                    mesh, jstate, jfrozen)
    jst, jmet = jstep(jstate, jfrozen, {k: jnp.asarray(v) for k, v in batch.items()}, None)
    plain = ranks[0]["plain"]
    np.testing.assert_allclose(plain["loss"], float(jmet["loss_llm"]), rtol=2e-5)
    np.testing.assert_allclose(plain["gnorm"], float(jmet["grad_norm"]), rtol=2e-4)
    n = 0
    for (path, a), (_, b) in zip(_paths(plain["train"]), _paths(_np(jst.trainable))):
        if not path.endswith("mask"):
            assert np.abs(a.numpy() - b).max() <= 3 * LR, path
            n += 1
    assert n == 7 * 2 + 6 * 2 + 4 + 2

    lc = tl.LoraConfig(**{**LORA, "dropout": 0.3})
    step = t_step.make_train_step(tcfg, lc, t_opt.cullavo_optimizer(LR, 10, grad_clip=clip), **kw)
    st, m = step(t_step.TrainState(ttrain, topt_state, 0), tfrozen, tbatch,
                 torch.Generator().manual_seed(7))
    drop = ranks[0]["dropout"]
    assert abs(drop["loss"] - plain["loss"]) > 1e-4           # the masks drop something
    np.testing.assert_allclose(drop["loss"], float(m["loss_llm"]), rtol=1e-5)
    np.testing.assert_allclose(drop["gnorm"], float(m["grad_norm"]), rtol=1e-5)
    for (path, a), (_, b) in zip(_paths(drop["train"]), _paths(st.trainable)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6, err_msg=path)
    for name in ("plain", "dropout"):
        assert ranks[0][name]["loss"] == ranks[1][name]["loss"]
        assert ranks[0][name]["gnorm"] == ranks[1][name]["gnorm"]
        for (path, a), (_, b) in zip(_paths(ranks[0][name]["train"]),
                                     _paths(ranks[1][name]["train"])):
            assert torch.equal(a, b), path


XDEC_BODY = JOIN + """
from cullavo_tpu_torch.trainer import optimizer as topt
from cullavo_tpu_torch.trainer import xdecoder_step as tstep
from cullavo_tpu_torch.parallel import Layout
from cullavo_tpu_torch.trainer.step import TrainState
d = torch.load(os.path.join(WORK, "xdec_in.pt"), weights_only=False)
layout = Layout(parallel_context({"MESH_DATA": 2}), d["params"])
tx = topt.xdecoder_optimizer(base_lr=1e-4, total_steps=20, grad_clip=0.01)
step = tstep.make_xdecoder_joint_train_step(d["cfg"], tx, remat=False, layout=layout)
st, m = step(TrainState(d["params"], tx.init(d["params"]), 0), d["batch"],
             torch.Generator().manual_seed(5))
torch.save({"metrics": {k: float(v) for k, v in m.items()}, "params": st.trainable},
           os.path.join(WORK, f"xdec{RANK}.pt"))
"""


def xdecoder_inputs(tmp_path):
    """The tiny X-Decoder's config and weights (seed 0) and a global batch of
    4 images (64 x 64 and others) from a caption-grounding dataset written
    under ``tmp_path``."""
    cfg = tmodel.tiny_xdecoder_config()
    params = tmodel.init_xdecoder_model_params(cfg, torch.Generator().manual_seed(0), "cpu")
    spec = chip_smoke().write_joint_dataset(str(tmp_path / "joint"), [(64, 64), (48, 80),
                                                                       (64, 64), (80, 48)],
                                            CLASS_NAMES, N_THINGS, seed=2, captions=3)
    from cullavo_tpu_torch.data.coco_caption_grounding import \
        load_coco_panoptic_caption_grounding_json
    recs = load_coco_panoptic_caption_grounding_json(
        spec["JSON"], spec["IMAGE_DIR"], spec["PANOPTIC_DIR"], spec["CAPTION_JSON"],
        spec["GROUNDING_JSON"], {})
    tokenize = t_entry._make_text_tokenize({}, cfg.text)
    mapped = [JointTrainMapper(image_size=64, class_names=CLASS_NAMES)(r) for r in recs[:4]]
    batch = collate_joint(mapped, tokenize, CLASS_NAMES, np.random.default_rng(3),
                          max_instances=4)
    batch["image"] = np.stack([normalize_np(m["image"]) for m in mapped])
    batch["class_ids"], batch["class_mask"] = tokenize(
        [f"a photo of a {c}." for c in CLASS_NAMES] + ["A background in coco."])
    return cfg, params, batch


def test_xdecoder_joint_step_on_two_ranks_matches_one_process(tmp_path):
    """The tiny X-Decoder, f32, a global batch of 4 images split 2 + 2: every
    loss, the total and the gradient norm within 1e-5 relative of the
    port's one-process step on the whole batch (the same generator: the
    point draws are the global batch's), the parameters after the AdamW step
    within 1e-6; both ranks' results equal."""
    cfg, params, batch = xdecoder_inputs(tmp_path)
    torch.save({"cfg": cfg, "params": params, "batch": batch}, tmp_path / "xdec_in.pt")
    spawn_ranks(tmp_path, "xdec", XDEC_BODY)
    ranks = [torch.load(tmp_path / f"xdec{r}.pt", weights_only=False) for r in range(2)]

    tx = t_opt.xdecoder_optimizer(base_lr=1e-4, total_steps=20, grad_clip=0.01)
    step = t_xstep.make_xdecoder_joint_train_step(cfg, tx, remat=False)
    st, m = step(t_step.TrainState(params, tx.init(params), 0), batch,
                 torch.Generator().manual_seed(5))
    want = {k: float(v) for k, v in m.items()}
    got = ranks[0]["metrics"]
    assert sorted(got) == sorted(want) and len(want) > 20
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert ranks[1]["metrics"] == got
    mine, other, one = (_flat(t) for t in (ranks[0]["params"], ranks[1]["params"],
                                           st.trainable))
    assert sorted(mine) == sorted(one) and len(one) > 100
    for path, a in mine.items():
        assert np.array_equal(a, other[path]), path
        np.testing.assert_allclose(a, one[path], rtol=0, atol=1e-6, err_msg=path)


def _fake_parse(text):
    """One box and class a pure function of the sampled text (a random
    model's text rarely parses)."""
    h = sum(map(ord, text)) % 97
    return np.asarray([[h / 200, 0.1, 0.5 + h / 400, 0.9]], np.float32), [f"obj{h}"], None


def _conversations(root, names):
    rng = np.random.default_rng(4)
    from cullavo_tpu_torch.data import png_io
    rows = []
    for i, name in enumerate(names):
        png_io.write_png(str(root / name), rng.integers(0, 256, (32 + 4 * i, 40, 3),
                                                          dtype=np.uint8))
        rows.append({"image": name, "conversations": [
            {"from": "human", "value": "<image>\nWhat is in the picture?"},
            {"from": "gpt", "value": "A dog."}]})
    return rows


def _step2_argv(name, rows_json, root, out):
    over = {"DATASETS.TEST": [name], "DATASETS.REGISTER": {name: {
        "KIND": "conversations", "JSON": str(rows_json), "IMAGE_ROOT": str(root)}}}
    return ["eval", "--conf_files", os.path.join(REPO, "configs/cullavo_step2_pre.yaml"),
            "--config_overrides", json.dumps(over), "--overrides", "SAVE_DIR", str(out),
            "MAX_NEW_TOKENS", "4", "BATCH_SIZE", "2"]


STEP2_BODY = """
import numpy as np
from cullavo_tpu_torch import entry
from cullavo_tpu_torch.pipelines import cullavo_pipeline as tpipe
argv = json.load(open(os.path.join(WORK, "step2_argv.json")))
def fake_parse(text):
    h = sum(map(ord, text)) % 97
    return np.asarray([[h / 200, 0.1, 0.5 + h / 400, 0.9]], np.float32), [f"obj{h}"], None
tpipe.parse_boxes_and_classes = fake_parse
dumps = []
real_dump = json.dump
json.dump = lambda *a, **k: (dumps.append(1), real_dump(*a, **k))[1]
res = entry.main(argv, device="cpu")
print(json.dumps({"rank": RANK, "res": res, "dumps": len(dumps)}))
"""


def test_step2_pre_on_two_ranks_merges_the_shards(tmp_path, monkeypatch):
    """``python``-level ``entry.main`` on configs/cullavo_step2_pre.yaml (the
    smoke model, 5 rows: shards of 3 and 2) under two ranks: the merged
    rows equal one-process runs over each shard (the second's image names
    shifted by its offset), every image is written, and only rank 0 writes
    the JSON (once)."""
    root = tmp_path / "conv"
    root.mkdir()
    rows = _conversations(root, [f"im{i}.png" for i in range(5)])
    for name, part in (("all", rows), ("s0", rows[:3]), ("s1", rows[3:])):
        with open(root / f"{name}.json", "w") as f:
            json.dump(part, f)
    with open(tmp_path / "step2_argv.json", "w") as f:
        json.dump(_step2_argv("conv_two_ranks", root / "all.json", root, tmp_path / "out"), f)
    outs = spawn_ranks(tmp_path, "step2", STEP2_BODY)
    reports = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert [r["dumps"] for r in reports] == [1, 0]
    with open(tmp_path / "out" / "lbk_new_version.json") as f:
        merged = json.load(f)
    assert reports[0]["res"]["rows"] == reports[1]["res"]["rows"] == len(merged) == 5

    monkeypatch.setattr(tpipe, "parse_boxes_and_classes", _fake_parse)
    want = []
    for shard, offset in (("s0", 0), ("s1", 3)):
        out = tmp_path / f"one_{shard}"
        t_entry.main(_step2_argv(f"conv_one_{shard}", root / f"{shard}.json", root, out),
                     device="cpu")
        with open(out / "lbk_new_version.json") as f:
            for r in json.load(f):
                b = int(r["image"][len("step2_"):-len(".png")])
                want.append(dict(r, image=f"step2_{offset + b}.png"))
    assert merged == want
    assert sorted(os.listdir(tmp_path / "out")) == sorted(
        [f"step2_{i}.png" for i in range(5)] + ["lbk_new_version.json"])
    for name in ("conv_one_s0", "conv_one_s1"):
        _DATASETS.pop(name, None)


ENTRY_BODY = """
import dataclasses
from cullavo_tpu_torch import entry
from cullavo_tpu_torch.data.tokenizer import ByteTokenizer
from cullavo_tpu_torch.models.llava.config import tiny_llava_config
from cullavo_tpu_torch.models.llava.modeling import init_llava_params
from cullavo_tpu_torch.pipelines import cullavo_pipeline as tpipe
argv = json.load(open(os.path.join(WORK, "entry_argv.json")))[RANK]
cfg = dataclasses.replace(tiny_llava_config(260), image_token_id=ByteTokenizer.image_token_id)
entry._build_llava = lambda c, device, parallel=None: (
    cfg, init_llava_params(cfg, torch.Generator().manual_seed(0), device), ByteTokenizer())
make = tpipe.make_train_step
tpipe.make_train_step = lambda *a, **kw: make(*a, **{**kw, "compute_dtype": None})
entry.main(argv, device="cpu")
"""


def test_entry_main_trains_on_two_ranks_and_only_rank0_writes(tmp_path, monkeypatch):
    """``entry.main`` on configs/cullavo_step1.yaml (the tiny model over an NF4
    base, f32 compute, LoRA dropout on, a registered coco_panoptic dataset
    of 8 images, batch 4, 2 steps, a save each epoch) in two processes under
    ``CULLAVO_NUM_PROCS=2``: both ranks print the same losses and gradient
    norms, which equal one process's (rtol 1e-5); rank 0 writes step_2 and
    epoch0, rank 1 (its own SAVE_DIR) nothing."""
    cs = chip_smoke()
    json_file, img_dir, pan_dir = cs.write_panoptic_dataset(str(tmp_path / "coco"), n=8,
                                                            hw=(160, 200))
    over = {"DATASETS.TRAIN": "coco_two_ranks", "DATASETS.REGISTER": {"coco_two_ranks": {
        "KIND": "coco_panoptic", "JSON": json_file, "IMAGE_DIR": img_dir,
        "PANOPTIC_DIR": pan_dir, "NUM_CLASSES": 133}}}

    def argv(save_dir, name="coco_two_ranks"):
        o = dict(over, **{"DATASETS.TRAIN": name})
        o["DATASETS.REGISTER"] = {name: over["DATASETS.REGISTER"]["coco_two_ranks"]}
        return ["train", "--conf_files", os.path.join(REPO, "configs/cullavo_step1.yaml"),
                "--config_overrides", json.dumps(o), "--overrides", "SAVE_DIR", str(save_dir),
                "BATCH_SIZE", "4", "PERIOD", "0", "LOG_EVERY", "1",
                "MODEL.LLM.LORA_R", "4", "MODEL.LLM.LORA_VISION_START", "1",
                "MODEL.LLM.LORA_VISION_STOP", "2"]

    with open(tmp_path / "entry_argv.json", "w") as f:
        json.dump([argv(tmp_path / f"rank{r}") for r in range(2)], f)
    outs = spawn_ranks(tmp_path, "entry", ENTRY_BODY)
    lines = [json.loads([ln for ln in o.splitlines() if ln.startswith('{"rank"')][-1])
             for o in outs]
    assert [(ln["rank"], ln["world"]) for ln in lines] == [(0, 2), (1, 2)]
    assert lines[0]["loss_llm"] == lines[1]["loss_llm"] and len(lines[0]["loss_llm"]) == 2
    assert lines[0]["grad_norm"] == lines[1]["grad_norm"]
    assert sorted(os.listdir(tmp_path / "rank0")) == ["epoch0", "step_2"]
    assert not (tmp_path / "rank1").exists()

    from cullavo_tpu_torch.data.tokenizer import ByteTokenizer
    from cullavo_tpu_torch.models.llava.modeling import init_llava_params
    cfg = dataclasses.replace(t_tiny(260), image_token_id=ByteTokenizer.image_token_id)
    monkeypatch.setattr(t_entry, "_build_llava", lambda c, device, parallel=None: (
        cfg, init_llava_params(cfg, torch.Generator().manual_seed(0), device), ByteTokenizer()))
    make = tpipe.make_train_step
    monkeypatch.setattr(tpipe, "make_train_step",
                        lambda *a, **kw: make(*a, **{**kw, "compute_dtype": None}))
    res = t_entry.main(argv(tmp_path / "one", "coco_one_process"), device="cpu")
    hist = res["history"]
    np.testing.assert_allclose(lines[0]["loss_llm"], [h["loss_llm"] for h in hist], rtol=1e-5)
    np.testing.assert_allclose(lines[0]["grad_norm"], [h["grad_norm"] for h in hist], rtol=1e-5)
    _DATASETS.pop("coco_one_process", None)
