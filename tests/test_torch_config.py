"""The torch port's command line against the JAX package: its own reader of
the YAML subset the repo's configs use against PyYAML (through JAX's
``load_config``) on every file under ``configs/``, value types included
(PyYAML's YAML 1.1 float rule keeps ``2e-5`` a string); the overrides, the
JSON overrides and the dotted merge against JAX's functions; the reader's
refusals; ``entry.main``'s dispatch; and ``python -m cullavo_tpu_torch``
failing without a card (no CPU fallback)."""
import copy
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cullavo_tpu import config as jc
from cullavo_tpu_torch import config as tc
from cullavo_tpu_torch import entry as t_entry

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(p.relative_to(REPO)) for p in (REPO / "configs").rglob("*.yaml"))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _same(a, b, path="") -> None:
    """Equal values of equal types, all the way down (NaN equals NaN)."""
    assert type(a) is type(b), (path, a, b)
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and math.isnan(a):
        assert math.isnan(b), path
    else:
        assert a == b, (path, a, b)


def test_the_repo_has_its_fourteen_config_files():
    assert len(CONFIGS) == 14, CONFIGS


@pytest.mark.parametrize("path", CONFIGS)
def test_every_config_file_reads_as_pyyaml_reads_it(path):
    mine = tc.load_config([str(REPO / path)])
    ref = jc.load_config([str(REPO / path)])
    _same(mine.to_dict(), ref.to_dict())


def test_yaml_1_1_floats_stay_strings_as_in_pyyaml():
    pre = tc.load_config([str(REPO / "configs/cullavo_step2_pre.yaml")]).to_dict()
    assert pre["OPTIMIZER"]["LR"] == "2e-5" and pre["OPTIMIZER"]["LAST_LR"] == "1e-6"
    assert float(pre["OPTIMIZER"]["LR"]) == 2e-5
    train = tc.load_config([str(REPO / "configs/xdecoder_train.yaml")]).to_dict()
    assert train["SOLVER"]["BASE_LR"] == "1e-4"
    step1 = tc.load_config([str(REPO / "configs/cullavo_step1.yaml")]).to_dict()
    assert step1["LR"] == 2e-5 and type(step1["LR"]) is float


SCALARS = ["2e-5", "1.0e+5", "1.0e5", "2.0e-5", "09", "1_000", "1._", ".5", "1.", "+1", "-0",
           "+1.5", "-2_0", "0:30", "._5", "yes", "No", "ON", "off",
           "y", "n", "true", "False", "~", "null", "NULL", "Null", "", "'it''s'",
           '"q\\n\\t\\"x\\""', "x 'y'", "it's", "'x # y'", "http://a.b/c?d=1", "a:b", "-x",
           "[1, 'b', \"c\", [d, [2.5]], ~, yes]", "[]", "[a, b,]", "[ 1 ,2 ]", "0o17", "1e3"]


@pytest.mark.parametrize("scalar", SCALARS)
def test_plain_and_quoted_scalars_resolve_as_in_pyyaml(scalar):
    import yaml

    text = f"K: {scalar}   # trailing comment\n"
    _same(tc.parse_yaml(text), yaml.safe_load(text))


DOCUMENTS = [
    "a:\n  b:\n    c: 1\n  d: 2\ne: 3\n",
    "a:\nb: 1\n",
    "yes: 1\n1: 2\nnull: 3\n1.5: 4\n",
    "  a: 1\n  b:\n    c: [x]\n",
    "---\na: 1\n",
    "# only a comment\n",
    "",
    "5\n",
    "a: 1\na: 2\n",
    "a:   # a comment after the key\n  b: 1\n\n\n  c: 2   # and here\n# full line\n"
    "d: 'q # not a comment'\n",
    "# braces in comments: {\"id\": 0, 'x': [1, 2]}\nS:\n  P: 1   # a \"quoted\" {note}\n",
]


@pytest.mark.parametrize("text", DOCUMENTS)
def test_documents_read_as_in_pyyaml(text):
    import yaml

    _same(tc.parse_yaml(text), yaml.safe_load(text))


@pytest.mark.parametrize("text,match", [
    ("a: &anchor 1\n", "anchors"),
    ("a: *alias\n", "anchors"),
    ("a: |\n  block\n", "block scalars"),
    ("a: >\n  folded\n", "block scalars"),
    ("a:\n  - 1\n  - 2\n", "block sequences"),
    ("- 1\n", "block sequences"),
    ("a: 1\n---\nb: 2\n", "several documents"),
    ("a:\t1\n", "tabs"),
    ("a: !!str 1\n", "tags"),
    ("a: {b: 1}\n", "flow mappings"),
    ("a: [{b: 1}]\n", "flow mappings"),
    ("a: 2001-12-14\n", "timestamps"),
    ("<<: 1\n", "merge keys"),
    ("a: b: c\n", "mapping inside"),
    ("a: [1,\n  2]\n", "multi-line flow"),
    ("a: 'open\n", "unterminated"),
    ("a: 017\n", "octal"),
    ("a: 0x1F\n", "hex"),
    ("a: 0b101\n", "binary"),
    ("a: 1:30\n", "base 60"),
    ("a: 1:20.5\n", "base 60"),
    ("a: -.inf\n", "inf"),
    ("a: .NaN\n", "nan"),
    ("a: [1, .inf]\n", "inf"),
    ('a: "\\u00e9"\n', "escape"),
    ("a: 1\n  b: 2\n", "indentation"),
    ("a:\n    b: 1\n  c: 2\n", "indentation"),
])
def test_reader_raises_outside_the_subset(text, match):
    with pytest.raises(tc.YamlSubsetError, match=match):
        tc.parse_yaml(text)


OVERRIDES = [
    ["BATCH_SIZE", "4"],
    ["LR", "3e-4"],
    ["MODEL.LLM.GRAD_CKPT", "false"],
    ["MODEL.LLM.GRAD_CKPT", "False"],
    ["MODEL.LLM.GRAD_CKPT", "0"],
    ["MODEL.LLM.GRAD_CKPT", "1"],
    ["MODEL.LLM.GRAD_CKPT", "no"],
    ["MODEL.LLM.LOAD_PATH", "/some/snapshot"],
    ["SAVE_DIR", "[1, 2]"],
    ["SAVE_DIR", '{"a": [1, {"b": null}], "c": "x"}'],
    ["SAVE_DIR", "NaN"],
    ["SAVE_DIR", "-Infinity"],
    ["SAVE_DIR", "1e5"],
    ["SAVE_DIR", "true"],
    ["SAVE_DIR", '"quoted"'],
    ["SAVE_DIR", "None"],
    ["SAVE_DIR", "[1, 2"],
    ["SAVE_DIR", "{'a': 1}"],
    ["SAVE_DIR", "01"],
    ["SAVE_DIR", "  7  "],
    ["NEW.DEEP.KEY", "12"],
    ["NAME", "other"],
    ["PERIOD", "12", "SEED", "3", "MODEL.LLM.BITS", "8"],
]


@pytest.mark.parametrize("pairs", OVERRIDES, ids=lambda p: " ".join(p))
def test_overrides_coerce_as_jax_does(pairs):
    base = tc.load_config([str(REPO / "configs/cullavo_step1.yaml")]).to_dict()
    mine = tc.apply_overrides(copy.deepcopy(base), pairs)
    ref = jc.apply_overrides(copy.deepcopy(base), pairs)
    _same(mine, ref)


def test_odd_overrides_raise_in_both():
    for mod in (tc, jc):
        with pytest.raises(ValueError, match="odd count"):
            mod.apply_overrides({}, ["A"])


@pytest.mark.parametrize("updates", [
    {"MODEL.BACKBONE.NAME": "focal"},
    {"MODEL": {"LLM": {"BITS": 8}, "NEW": [1, 2]}},
    {"MODEL.LLM": {"LORA_R": 16}, "DATASETS.TEST": ["a", "b"]},
    {"LR": {"nested": 1}},
    {"MODEL.LLM.LOAD_PATH.DEEPER": 3},
], ids=["dotted", "nested", "dotted_dict", "scalar_to_dict", "through_a_leaf"])
def test_merge_dotted_as_jax_does(updates):
    base = tc.load_config([str(REPO / "configs/cullavo_step1.yaml")]).to_dict()
    mine = tc.merge_dotted(copy.deepcopy(base), copy.deepcopy(updates))
    ref = jc.merge_dotted(copy.deepcopy(base), copy.deepcopy(updates))
    _same(mine, ref)


def test_load_opt_command_merges_files_json_and_pairs_as_jax_does():
    argv = ["train", "--conf_files", str(REPO / "configs/cullavo_step1.yaml"),
            str(REPO / "configs/cullavo_step2.yaml"),
            "--config_overrides", json.dumps({"MODEL.LLM.LORA_ALPHA": 32, "DATASETS": {
                "TRAIN": "t", "REGISTER": {"t": {"KIND": "coco_panoptic"}}}}),
            "--overrides", "BATCH_SIZE", "2", "MODEL.LLM.BITS", "8", "SAVE_DIR", "out"]
    mine, margs = tc.load_opt_command(argv)
    ref, rargs = jc.load_opt_command(argv)
    _same(mine.to_dict(), ref.to_dict())
    assert vars(margs) == vars(rargs)
    assert mine["NAME"] == "cullavo_step2" and mine.MODEL.LLM.BITS == 8
    with pytest.raises(SystemExit):
        tc.load_opt_command(["predict", "--conf_files", "x.yaml"])


def test_config_is_a_frozen_view_as_in_jax():
    data = {"A": {"B": 1}, "C": [1]}
    mine, ref = tc.Config(copy.deepcopy(data)), jc.Config(copy.deepcopy(data))
    assert isinstance(mine["A"], tc.Config) and mine.A.B == ref.A.B == 1
    assert mine.get("A") == ref.get("A").to_dict() and mine.get("Z", 5) == 5
    assert list(mine) == list(ref) and "A" in mine and dict(mine.items())["C"] == [1]
    assert mine == data and mine == tc.Config(data)
    with pytest.raises(AttributeError):
        mine.Z
    for bad in (lambda: setattr(mine, "A", 1), lambda: mine.__setitem__("A", 1)):
        with pytest.raises(TypeError, match="immutable"):
            bad()
    copied = mine.to_dict()
    copied["A"]["B"] = 2
    assert mine.A.B == 1


def test_the_package_exports_the_command_line_parser():
    import cullavo_tpu_torch

    assert cullavo_tpu_torch.load_opt_command is tc.load_opt_command
    assert cullavo_tpu_torch.load_config is tc.load_config


@pytest.mark.parametrize("command,target", [("train", "train"), ("eval", "evaluate"),
                                            ("serve", "serve")])
def test_main_dispatches_each_command_with_the_config_dict(monkeypatch, command, target):
    seen = []
    for name in ("train", "evaluate", "serve"):
        monkeypatch.setattr(t_entry, name, lambda cfg, device=None, _n=name:
                            seen.append((_n, cfg, device)) or _n)
    path = str(REPO / "configs/serve.yaml")
    out = t_entry.main([command, "--conf_files", path, "--overrides", "SERVE.SLOTS", "4"],
                       device="cpu")
    assert out == target and len(seen) == 1
    name, cfg, device = seen[0]
    want = jc.load_config([path], ["SERVE.SLOTS", "4"]).to_dict()
    assert name == target and device == "cpu" and type(cfg) is dict
    _same(cfg, want)


def test_main_refuses_several_processes(monkeypatch):
    """Several processes run (tests/test_torch_parallel.py); without the
    launcher's rendezvous address, or with a rank outside the group, main
    refuses before it joins a group."""
    monkeypatch.setenv("CULLAVO_NUM_PROCS", "2")
    monkeypatch.delenv("CULLAVO_COORDINATOR", raising=False)
    with pytest.raises(ValueError, match="CULLAVO_COORDINATOR"):
        t_entry.main(["eval", "--conf_files", str(REPO / "configs/vl_test.yaml")], device="cpu")
    monkeypatch.setenv("CULLAVO_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("CULLAVO_PROC_ID", "2")
    with pytest.raises(ValueError, match="CULLAVO_PROC_ID=2 is not a rank of 2"):
        t_entry.main(["eval", "--conf_files", str(REPO / "configs/vl_test.yaml")], device="cpu")


def test_python_m_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-m", "cullavo_tpu_torch", "eval", "--conf_files",
                          "configs/vl_test.yaml"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr, res.stderr[-2000:]
    assert res.stdout.strip() == ""
