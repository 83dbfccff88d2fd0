"""The VL zoo's HF snapshots (``*.safetensors`` shards, read by the port's
own reader) into the port's parameter trees: BLIP-2 Flan-T5, BLIP-2 OPT and
InstructBLIP-Vicuna (counterparts of JAX's ``import_blip2_torch`` and
``import_t5_torch``, which take a live transformers module) and KOSMOS-2
(``import_kosmos2_torch``).

One key table per model maps every leaf to its HF name (``{}`` stands for
the layer index; a ``T`` marks a Linear weight, transposed from HF's [out,
in] to [in, out]).  The alignment is strict: a leaf whose key is missing
raises, and so does a key of the files that no leaf reads, naming the key
and its shard.  ``save_pretrained`` drops tied duplicates, so a tied
weight may be stored under any one of its names: T5's shared embedding
(``shared``, ``encoder.embed_tokens``, ``decoder.embed_tokens``) and OPT's
(``model.decoder.embed_tokens``, ``lm_head``) are taken from whichever is
present, and KOSMOS-2's ``lm_head`` (tied to its embedding, as JAX reads
it) is read only to be dropped.

Where the JAX importer differs, the port does not copy it: JAX reads
neither the EVA-ViT-g patch embedding's bias nor the attention's fused
``qkv`` bias (HF composes it from ``q_bias``, zeros and ``v_bias``; older
files store those two), so a checkpoint's nonzero biases would silently
drop out of JAX's vision tower.  The port keeps them as the leaves
``vision.patch_b`` and ``vision.layers.qkv_b``, which the vision forward
adds.  Every other leaf equals JAX's.

``blip2_to_hf_state_dict`` and ``kosmos2_to_hf_state_dict`` write a tree
back to the HF names and layouts (``chip_smoke.py`` writes its snapshots
with them).  ``check_blip2_config`` and ``check_kosmos2_config`` hold a snapshot's
``config.json`` to the published config the caller builds (as JAX
hard-codes it) and refuse a mismatch; the port builds no model of another
size from ``config.json``.
"""
from __future__ import annotations

import glob
import json
import os

import torch

from cullavo_tpu_torch.checkpoint.safetensors_io import read_safetensors
from cullavo_tpu_torch.models.blip2.config import Blip2Config

__all__ = ["read_shards", "load_blip2_safetensors", "load_kosmos2_safetensors",
           "blip2_to_hf_state_dict", "kosmos2_to_hf_state_dict", "check_blip2_config",
           "check_kosmos2_config", "compare_config"]


def read_shards(model_dir: str) -> tuple:
    """(name -> tensor, name -> shard file) over every ``*.safetensors``
    under ``model_dir``; a name in two shards raises."""
    files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no safetensors under {model_dir}")
    state, where = {}, {}
    for path in files:
        for name, t in read_safetensors(path).items():
            if name in where:
                raise ValueError(f"{name} is in both {where[name]} and {path}")
            state[name], where[name] = t, path
    return state, where


class _Reader:
    """Leaves from the shards' tensors, each name marked read; ``finish``
    refuses the names nothing read."""

    def __init__(self, model_dir: str, dtype, device):
        self.state, self.where = read_shards(model_dir)
        self.dir, self.dtype, self.device = model_dir, dtype, device
        self.read: set = set()

    def has(self, name: str) -> bool:
        return name in self.state

    def get(self, name: str, transpose: bool = False) -> torch.Tensor:
        if name not in self.state:
            raise KeyError(f"{self.dir}: the snapshot has no tensor {name!r}")
        self.read.add(name)
        t = self.state[name]
        t = t.to(device=self.device, dtype=self.dtype or t.dtype)
        return t.T.contiguous() if transpose else t

    def stack(self, fmt: str, n: int, transpose: bool = False) -> torch.Tensor:
        return torch.stack([self.get(fmt.format(i), transpose) for i in range(n)])

    def tree(self, table: dict, prefix: str, n: int = 0) -> dict:
        """``table``: leaf -> HF suffix (a leading "T " transposes; "{}" takes
        the layer index and stacks ``n`` layers), or a nested table."""
        out = {}
        for leaf, spec in table.items():
            if isinstance(spec, dict):
                out[leaf] = self.tree(spec, prefix, n)
                continue
            tr = spec.startswith("T ")
            name = prefix + spec.removeprefix("T ")
            out[leaf] = self.stack(name, n, tr) if "{}" in name else self.get(name, tr)
        return out

    def drop(self, name: str):
        """Mark a tied duplicate read (it is not a leaf)."""
        if name in self.state:
            self.read.add(name)

    def finish(self):
        unread = sorted(set(self.state) - self.read)
        if unread:
            raise ValueError(f"{self.dir}: the port reads no leaf from "
                             + ", ".join(f"{k} ({os.path.basename(self.where[k])})"
                                         for k in unread[:8])
                             + (f" and {len(unread) - 8} more" if len(unread) > 8 else ""))


# -- BLIP-2 / InstructBLIP ----------------------------------------------------

_VISION = {"qkv": "T encoder.layers.{}.self_attn.qkv.weight",
           "proj": "T encoder.layers.{}.self_attn.projection.weight",
           "proj_b": "encoder.layers.{}.self_attn.projection.bias",
           "ln1": "encoder.layers.{}.layer_norm1.weight",
           "ln1_b": "encoder.layers.{}.layer_norm1.bias",
           "ln2": "encoder.layers.{}.layer_norm2.weight",
           "ln2_b": "encoder.layers.{}.layer_norm2.bias",
           "fc1": "T encoder.layers.{}.mlp.fc1.weight",
           "fc1_b": "encoder.layers.{}.mlp.fc1.bias",
           "fc2": "T encoder.layers.{}.mlp.fc2.weight",
           "fc2_b": "encoder.layers.{}.mlp.fc2.bias"}


def _dense(prefix: str) -> dict:
    return {"w": f"T {prefix}.weight", "b": f"{prefix}.bias"}


def _ln(prefix: str) -> dict:
    return {"g": f"{prefix}.weight", "b": f"{prefix}.bias"}


def _attention(prefix: str) -> dict:
    return {"q": _dense(f"{prefix}.attention.query"), "k": _dense(f"{prefix}.attention.key"),
            "v": _dense(f"{prefix}.attention.value"), "o": _dense(f"{prefix}.output.dense"),
            "ln": _ln(f"{prefix}.output.LayerNorm")}


def _t5_block(part: str, cross: bool) -> dict:
    b = f"{part}.block.{{}}.layer"
    table = {"q": f"T {b}.0.SelfAttention.q.weight", "k": f"T {b}.0.SelfAttention.k.weight",
             "v": f"T {b}.0.SelfAttention.v.weight", "o": f"T {b}.0.SelfAttention.o.weight",
             "ln1": f"{b}.0.layer_norm.weight"}
    ff = 2 if cross else 1
    if cross:
        table.update({"cq": f"T {b}.1.EncDecAttention.q.weight",
                      "ck": f"T {b}.1.EncDecAttention.k.weight",
                      "cv": f"T {b}.1.EncDecAttention.v.weight",
                      "co": f"T {b}.1.EncDecAttention.o.weight",
                      "ln_cross": f"{b}.1.layer_norm.weight"})
    table.update({"wi0": f"T {b}.{ff}.DenseReluDense.wi_0.weight",
                  "wi1": f"T {b}.{ff}.DenseReluDense.wi_1.weight",
                  "wo": f"T {b}.{ff}.DenseReluDense.wo.weight",
                  "ln_ff": f"{b}.{ff}.layer_norm.weight"})
    return table


_LLAMA_LAYER = {"q": "T layers.{}.self_attn.q_proj.weight",
                "k": "T layers.{}.self_attn.k_proj.weight",
                "v": "T layers.{}.self_attn.v_proj.weight",
                "o": "T layers.{}.self_attn.o_proj.weight",
                "gate": "T layers.{}.mlp.gate_proj.weight",
                "up": "T layers.{}.mlp.up_proj.weight",
                "down": "T layers.{}.mlp.down_proj.weight",
                "input_ln": "layers.{}.input_layernorm.weight",
                "post_ln": "layers.{}.post_attention_layernorm.weight"}


_OPT_LAYER = {"attn_ln": "layers.{}.self_attn_layer_norm.weight",
              "attn_ln_b": "layers.{}.self_attn_layer_norm.bias",
              "final_ln": "layers.{}.final_layer_norm.weight",
              "final_ln_b": "layers.{}.final_layer_norm.bias"}
for _leaf, _hf in (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                   ("v", "self_attn.v_proj"), ("o", "self_attn.out_proj"), ("fc1", "fc1"),
                   ("fc2", "fc2")):
    _OPT_LAYER[_leaf] = f"T layers.{{}}.{_hf}.weight"
    _OPT_LAYER[_leaf + "_b"] = f"layers.{{}}.{_hf}.bias"
_OPT = "language_model.model.decoder."
_OPT_TIED = (_OPT + "embed_tokens.weight", "language_model.lm_head.weight")


def _blip2_vision(r: _Reader, cfg: Blip2Config) -> dict:
    vc, L = cfg.vision, cfg.vision.num_hidden_layers
    p = "vision_model."
    pk = r.get(p + "embeddings.patch_embedding.weight")          # [D, 3, P, P]
    vision = {
        "class_emb": r.get(p + "embeddings.class_embedding").reshape(-1),
        "patch_kernel": pk.reshape(vc.hidden_size, -1).T.contiguous(),
        "pos_emb": r.get(p + "embeddings.position_embedding").reshape(-1, vc.hidden_size),
        "layers": r.tree(_VISION, p, L),
        "post_ln": r.get(p + "post_layernorm.weight"),
        "post_ln_b": r.get(p + "post_layernorm.bias"),
    }
    if r.has(p + "embeddings.patch_embedding.bias"):
        vision["patch_b"] = r.get(p + "embeddings.patch_embedding.bias")
    qkv_b = p + "encoder.layers.{}.self_attn.qkv.bias"
    if r.has(qkv_b.format(0)):
        vision["layers"]["qkv_b"] = r.stack(qkv_b, L)
    elif r.has(p + "encoder.layers.0.self_attn.q_bias"):
        q = r.stack(p + "encoder.layers.{}.self_attn.q_bias", L)
        v = r.stack(p + "encoder.layers.{}.self_attn.v_bias", L)
        vision["layers"]["qkv_b"] = torch.cat([q, torch.zeros_like(q), v], dim=-1)
    return vision


def _qformer_layer(i: int, qc) -> dict:
    p = f"qformer.encoder.layer.{i}"
    table = {"att": _attention(f"{p}.attention"),
             "ffn_q": {"fc1": _dense(f"{p}.intermediate_query.dense"),
                       "fc2": _dense(f"{p}.output_query.dense"),
                       "ln": _ln(f"{p}.output_query.LayerNorm")}}
    if i % qc.cross_attention_frequency == 0:
        table["cross"] = _attention(f"{p}.crossattention")
    if qc.use_text_input:
        table["ffn_t"] = {"fc1": _dense(f"{p}.intermediate.dense"),
                          "fc2": _dense(f"{p}.output.dense"),
                          "ln": _ln(f"{p}.output.LayerNorm")}
    return table


def _blip2_qformer(r: _Reader, cfg: Blip2Config) -> dict:
    qc = cfg.qformer
    text_keys = ("qformer.embeddings.word_embeddings.weight",
                 "qformer.embeddings.position_embeddings.weight")
    if qc.use_text_input and not all(r.has(k) for k in text_keys):
        raise ValueError(f"{r.dir}: the text-input Q-Former needs {' and '.join(text_keys)}, "
                         "which the snapshot lacks (Blip2ForConditionalGeneration's Q-Former "
                         "keeps no text weights; InstructBLIP's does)")
    layers = [r.tree(_qformer_layer(i, qc), "") for i in range(qc.num_hidden_layers)]
    # BLIP-2 keeps the embedding LayerNorm at qformer.layernorm, InstructBLIP
    # at qformer.embeddings.layernorm
    ln = ("qformer.layernorm" if r.has("qformer.layernorm.weight")
          else "qformer.embeddings.layernorm")
    out = {"layernorm": r.tree(_ln(ln), ""), "layers": layers}
    if qc.use_text_input:
        out["word_emb"], out["pos_emb"] = (r.get(k) for k in text_keys)
    return out


def _tied(r: _Reader, names, what: str) -> torch.Tensor:
    """A tied table stored under any of ``names`` (every copy present must
    be equal)."""
    present = [n for n in names if r.has(n)]
    if not present:
        raise KeyError(f"{r.dir}: the snapshot has none of the tied {what} tables {list(names)}")
    embed = r.get(present[0])
    for n in present[1:]:
        if not torch.equal(r.get(n), embed):
            raise ValueError(f"{r.dir}: {n} differs from {present[0]}; they are tied in {what}")
    return embed


def _t5_tower(r: _Reader, cfg) -> dict:
    p = "language_model."
    embed = _tied(r, [p + n for n in ("shared.weight", "encoder.embed_tokens.weight",
                                      "decoder.embed_tokens.weight")], "T5")
    t = cfg.text
    return {
        "embed_tokens": embed,
        "enc_rel_bias": r.get(p + "encoder.block.0.layer.0.SelfAttention"
                              ".relative_attention_bias.weight"),
        "dec_rel_bias": r.get(p + "decoder.block.0.layer.0.SelfAttention"
                              ".relative_attention_bias.weight"),
        "encoder": r.tree(_t5_block("encoder", False), p, t.num_layers),
        "enc_final_ln": r.get(p + "encoder.final_layer_norm.weight"),
        "decoder": r.tree(_t5_block("decoder", True), p, t.num_decoder_layers),
        "dec_final_ln": r.get(p + "decoder.final_layer_norm.weight"),
        "lm_head": r.get(p + "lm_head.weight", transpose=True),
    }


def _llama_tower(r: _Reader, cfg) -> dict:
    p = "language_model.model."
    embed = r.get(p + "embed_tokens.weight")
    head = "language_model.lm_head.weight"
    return {"embed_tokens": embed,
            "lm_head": r.get(head, True) if r.has(head) else embed.T.contiguous(),
            "norm": r.get(p + "norm.weight"),
            "layers": r.tree(_LLAMA_LAYER, p, cfg.text.num_hidden_layers)}


def _opt_tower(r: _Reader, cfg) -> dict:
    return {"embed_tokens": _tied(r, _OPT_TIED, "OPT"),
            "embed_positions": r.get(_OPT + "embed_positions.weight"),
            "final_ln": r.get(_OPT + "final_layer_norm.weight"),
            "final_ln_b": r.get(_OPT + "final_layer_norm.bias"),
            "layers": r.tree(_OPT_LAYER, _OPT, cfg.text.num_hidden_layers)}


def load_blip2_safetensors(model_dir: str, cfg: Blip2Config, dtype=None, device="cpu") -> dict:
    """A Blip2ForConditionalGeneration (Flan-T5 or OPT tower) or
    InstructBlipForConditionalGeneration (Vicuna tower) snapshot -> the
    port's BLIP-2 tree on ``device`` (``dtype``: None keeps the files')."""
    r = _Reader(model_dir, dtype, device)
    params = {"vision": _blip2_vision(r, cfg), "qformer": _blip2_qformer(r, cfg),
              "query_tokens": r.get("query_tokens").reshape(cfg.num_query_tokens,
                                                            cfg.qformer.hidden_size),
              "projection": r.tree(_dense("language_projection"), "")}
    params["language_model"] = (_opt_tower if cfg.text_is_opt else
                                _t5_tower if cfg.text_is_t5 else _llama_tower)(r, cfg)
    r.finish()
    return params


# -- KOSMOS-2 -----------------------------------------------------------------

def _kosmos2_tables(cfg) -> tuple:
    vl = "vision_model.model.encoder.layers.{}."
    vision_layers = {}
    for leaf, hf in (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                     ("v", "self_attn.v_proj"), ("o", "self_attn.out_proj"),
                     ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
        vision_layers[leaf] = f"T {vl}{hf}.weight"
        vision_layers[leaf + "_b"] = f"{vl}{hf}.bias"
    for leaf, hf in (("ln1", "layer_norm1"), ("ln2", "layer_norm2")):
        vision_layers[leaf + "_scale"] = f"{vl}{hf}.weight"
        vision_layers[leaf + "_bias"] = f"{vl}{hf}.bias"
    tl = "text_model.model.layers.{}."
    text_layers = {}
    for leaf, hf in (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                     ("v", "self_attn.v_proj"), ("o", "self_attn.out_proj"),
                     ("fc1", "ffn.fc1"), ("fc2", "ffn.fc2")):
        text_layers[leaf] = f"T {tl}{hf}.weight"
        text_layers[leaf + "_b"] = f"{tl}{hf}.bias"
    for leaf, hf in (("inner_ln", "self_attn.inner_attn_ln"), ("attn_ln", "self_attn_layer_norm"),
                     ("final_ln", "final_layer_norm"), ("ffn_ln", "ffn.ffn_layernorm")):
        text_layers[leaf] = f"{tl}{hf}.weight"
        text_layers[leaf + "_b"] = f"{tl}{hf}.bias"
    return vision_layers, text_layers


def load_kosmos2_safetensors(model_dir: str, cfg, dtype=None, device="cpu") -> dict:
    """A Kosmos2ForConditionalGeneration snapshot -> the port's KOSMOS-2
    tree on ``device`` (``dtype``: None keeps the files')."""
    r = _Reader(model_dir, dtype, device)
    vision_layers, text_layers = _kosmos2_tables(cfg)
    vb = "vision_model.model."
    pk = r.get(vb + "embeddings.patch_embedding.weight")         # [D, 3, P, P]
    vision = {
        "class_embedding": r.get(vb + "embeddings.class_embedding").reshape(-1),
        "patch_embedding": pk.reshape(cfg.vision.hidden_size, -1).T.contiguous(),
        "position_embedding": r.get(vb + "embeddings.position_embedding.weight"),
        "pre_ln": {"scale": r.get(vb + "pre_layrnorm.weight"),
                   "bias": r.get(vb + "pre_layrnorm.bias")},
        "post_ln": {"scale": r.get(vb + "post_layernorm.weight"),
                    "bias": r.get(vb + "post_layernorm.bias")},
        "layers": r.tree(vision_layers, "", cfg.vision.num_hidden_layers),
    }
    pj = "image_to_text_projection."
    projection = {"dense": r.tree(_dense("dense"), pj),
                  "latent_query": r.get(pj + "latent_query"),
                  "x_attn": {k: r.tree(_dense(f"x_attn.{hf}"), pj)
                             for k, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                                           ("o", "out_proj"))}}
    tb = "text_model.model."
    params = {"vision": vision, "projection": projection,
              "embed_tokens": r.get(tb + "embed_tokens.weight"),
              "final_ln": r.get(tb + "layer_norm.weight"),
              "final_ln_b": r.get(tb + "layer_norm.bias"),
              "layers": r.tree(text_layers, "", cfg.text.layers)}
    head = "text_model.lm_head.weight"
    if r.has(head) and not torch.equal(r.state[head], r.state[tb + "embed_tokens.weight"]):
        raise ValueError(f"{model_dir}: {head} differs from the embedding it is tied to "
                         "(KOSMOS-2 ties them; the port reads the embedding)")
    r.drop(head)
    r.finish()
    return params


# -- the inverse: a tree in the HF layout (snapshots for tests and the card) --

def _put(out: dict, table: dict, prefix: str, node: dict, n: int = 0):
    """Write ``node``'s leaves under the HF names of ``table`` (``_Reader.tree``
    read backwards)."""
    for leaf, spec in table.items():
        if isinstance(spec, dict):
            _put(out, spec, prefix, node[leaf], n)
            continue
        tr = spec.startswith("T ")
        name = prefix + spec.removeprefix("T ")
        a = node[leaf]
        if "{}" in name:
            for i in range(n):
                out[name.format(i)] = (a[i].T if tr else a[i]).contiguous()
        else:
            out[name] = (a.T if tr else a).contiguous()


def blip2_to_hf_state_dict(params: dict, cfg: Blip2Config) -> dict:
    """The port's BLIP-2 tree -> HF names and layouts, as
    Blip2ForConditionalGeneration (Flan-T5 or OPT tower) or, with a
    text-input Q-Former, InstructBlipForConditionalGeneration (Vicuna tower)
    saves them: the inverse of ``load_blip2_safetensors`` (T5's tied
    embedding as ``shared`` alone, OPT's as ``model.decoder.embed_tokens``
    alone)."""
    out: dict = {}
    vc, v = cfg.vision, params["vision"]
    p = "vision_model."
    P = vc.patch_size
    out[p + "embeddings.class_embedding"] = v["class_emb"].reshape(1, 1, -1).contiguous()
    out[p + "embeddings.patch_embedding.weight"] = (
        v["patch_kernel"].T.reshape(vc.hidden_size, 3, P, P).contiguous())
    out[p + "embeddings.position_embedding"] = v["pos_emb"].reshape(
        1, -1, vc.hidden_size).contiguous()
    _put(out, _VISION, p, v["layers"], vc.num_hidden_layers)
    out[p + "post_layernorm.weight"], out[p + "post_layernorm.bias"] = v["post_ln"], v["post_ln_b"]
    if "patch_b" in v:
        out[p + "embeddings.patch_embedding.bias"] = v["patch_b"]
    if "qkv_b" in v["layers"]:
        _put(out, {"qkv_b": "encoder.layers.{}.self_attn.qkv.bias"}, p, v["layers"],
             vc.num_hidden_layers)
    qc, q = cfg.qformer, params["qformer"]
    for i in range(qc.num_hidden_layers):
        _put(out, _qformer_layer(i, qc), "", q["layers"][i])
    ln = "qformer.embeddings.layernorm" if qc.use_text_input else "qformer.layernorm"
    _put(out, _ln(ln), "", q["layernorm"])
    if qc.use_text_input:
        out["qformer.embeddings.word_embeddings.weight"] = q["word_emb"]
        out["qformer.embeddings.position_embeddings.weight"] = q["pos_emb"]
    out["query_tokens"] = params["query_tokens"].reshape(1, cfg.num_query_tokens, -1).contiguous()
    _put(out, _dense("language_projection"), "", params["projection"])
    lm, t = params["language_model"], cfg.text
    if cfg.text_is_t5:
        p = "language_model."
        out[p + "shared.weight"] = lm["embed_tokens"]
        for part, rel in (("encoder", "enc_rel_bias"), ("decoder", "dec_rel_bias")):
            out[f"{p}{part}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = lm[rel]
        _put(out, _t5_block("encoder", False), p, lm["encoder"], t.num_layers)
        _put(out, _t5_block("decoder", True), p, lm["decoder"], t.num_decoder_layers)
        out[p + "encoder.final_layer_norm.weight"] = lm["enc_final_ln"]
        out[p + "decoder.final_layer_norm.weight"] = lm["dec_final_ln"]
        out[p + "lm_head.weight"] = lm["lm_head"].T.contiguous()
    elif cfg.text_is_opt:
        out[_OPT_TIED[0]] = lm["embed_tokens"]
        out[_OPT + "embed_positions.weight"] = lm["embed_positions"]
        out[_OPT + "final_layer_norm.weight"] = lm["final_ln"]
        out[_OPT + "final_layer_norm.bias"] = lm["final_ln_b"]
        _put(out, _OPT_LAYER, _OPT, lm["layers"], t.num_hidden_layers)
    else:
        p = "language_model.model."
        out[p + "embed_tokens.weight"] = lm["embed_tokens"]
        out[p + "norm.weight"] = lm["norm"]
        out["language_model.lm_head.weight"] = lm["lm_head"].T.contiguous()
        _put(out, _LLAMA_LAYER, p, lm["layers"], t.num_hidden_layers)
    return out


def kosmos2_to_hf_state_dict(params: dict, cfg) -> dict:
    """The port's KOSMOS-2 tree -> HF names and layouts (the tied lm_head
    left out, as ``save_pretrained`` leaves it): the inverse of
    ``load_kosmos2_safetensors``."""
    out: dict = {}
    vision_layers, text_layers = _kosmos2_tables(cfg)
    v, vb = params["vision"], "vision_model.model."
    P = cfg.vision.patch_size
    out[vb + "embeddings.class_embedding"] = v["class_embedding"]
    out[vb + "embeddings.patch_embedding.weight"] = (
        v["patch_embedding"].T.reshape(cfg.vision.hidden_size, 3, P, P).contiguous())
    out[vb + "embeddings.position_embedding.weight"] = v["position_embedding"]
    for name, ln in (("pre_layrnorm", "pre_ln"), ("post_layernorm", "post_ln")):
        out[f"{vb}{name}.weight"], out[f"{vb}{name}.bias"] = v[ln]["scale"], v[ln]["bias"]
    _put(out, vision_layers, "", v["layers"], cfg.vision.num_hidden_layers)
    pj, proj = "image_to_text_projection.", params["projection"]
    _put(out, _dense("dense"), pj, proj["dense"])
    out[pj + "latent_query"] = proj["latent_query"]
    for k, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
        _put(out, _dense(f"x_attn.{hf}"), pj, proj["x_attn"][k])
    tb = "text_model.model."
    out[tb + "embed_tokens.weight"] = params["embed_tokens"]
    out[tb + "layer_norm.weight"], out[tb + "layer_norm.bias"] = (params["final_ln"],
                                                                 params["final_ln_b"])
    _put(out, text_layers, "", params["layers"], cfg.text.layers)
    return out


# -- config.json against the published configs --------------------------------

def compare_config(model_dir: str, hf: dict, want: dict):
    """Refuse a config.json whose value at a dotted path of ``want``
    differs from it (a path config.json leaves out takes its default)."""
    for path, value in want.items():
        node = hf
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                node = None
                break
            node = node[part]
        if node is not None and node != value:
            raise ValueError(f"{model_dir}/config.json: {path} is {node!r}, the port's config "
                             f"has {value!r}; the port runs only the published configuration")


def _read_config(model_dir: str) -> dict:
    path = os.path.join(model_dir, "config.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no config.json under {model_dir}")
    with open(path) as f:
        return json.load(f)


def check_blip2_config(model_dir: str, cfg: Blip2Config):
    """Refuse a snapshot whose config.json disagrees with ``cfg`` on a width,
    a depth, a head count or a vocabulary."""
    hf = _read_config(model_dir)
    v, q, t = cfg.vision, cfg.qformer, cfg.text
    want = {"num_query_tokens": cfg.num_query_tokens,
            "vision_config.hidden_size": v.hidden_size,
            "vision_config.intermediate_size": v.intermediate_size,
            "vision_config.num_hidden_layers": v.num_hidden_layers,
            "vision_config.num_attention_heads": v.num_attention_heads,
            "vision_config.image_size": v.image_size, "vision_config.patch_size": v.patch_size,
            "qformer_config.hidden_size": q.hidden_size,
            "qformer_config.num_hidden_layers": q.num_hidden_layers,
            "qformer_config.num_attention_heads": q.num_attention_heads,
            "qformer_config.intermediate_size": q.intermediate_size,
            "qformer_config.cross_attention_frequency": q.cross_attention_frequency,
            "qformer_config.encoder_hidden_size": q.encoder_hidden_size}
    # not the Q-Former's vocabulary: InstructBLIP's table holds [DEC] past
    # the 30522 rows its published config (and JAX's) names
    if cfg.text_is_t5:
        want.update({f"text_config.{k}": getattr(t, k) for k in (
            "vocab_size", "d_model", "d_kv", "num_heads", "d_ff", "num_layers",
            "num_decoder_layers", "relative_attention_num_buckets",
            "relative_attention_max_distance")})
    elif cfg.text_is_opt:
        want.update({f"text_config.{k}": getattr(t, k) for k in (
            "vocab_size", "hidden_size", "ffn_dim", "num_hidden_layers", "num_attention_heads",
            "max_position_embeddings", "do_layer_norm_before", "activation_function")})
        # the 350m checkpoint projects its embeddings (project_in / _out): not this tower
        want["text_config.word_embed_proj_dim"] = t.hidden_size
    else:
        want.update({f"text_config.{k}": getattr(t, k) for k in (
            "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
            "num_attention_heads", "num_key_value_heads")})
    compare_config(model_dir, hf, want)


def check_kosmos2_config(model_dir: str, cfg):
    """As ``check_blip2_config``, for KOSMOS-2."""
    hf = _read_config(model_dir)
    v, t = cfg.vision, cfg.text
    want = {"latent_query_num": cfg.latent_query_num}
    want.update({f"vision_config.{k}": getattr(v, k) for k in (
        "hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
        "image_size", "patch_size")})
    want.update({f"text_config.{k}": getattr(t, k) for k in (
        "vocab_size", "embed_dim", "layers", "ffn_dim", "attention_heads")})
    compare_config(model_dir, hf, want)
