"""Reference X-Decoder checkpoints in the port's parameter layout
(counterpart of ``cullavo_tpu/checkpoint/xdecoder_import.py``).

The reference's state dict (``backbone.*``: FocalNet, DaViT or SAM-ViT;
``sem_seg_head.pixel_decoder.*``: the FPN or the deformable encoder;
``sem_seg_head.predictor.*``: the X-Decoder; ``sem_seg_head.predictor.
lang_encoder.*``: the text tower; ``backbone_proj``) maps onto the port's
tree through one table, ``reference_table(cfg)``: each entry names a
reference key, the port leaf it fills (a path of dict keys and list
indices), the transform (``id``; ``t``, a linear weight ``[out, in]`` ->
``[in, out]``; ``1x1t``, a 1x1 convolution ``[out, in, 1, 1]`` -> ``[in,
out]``; ``pos``, SAM's ``[1, g, g, D]`` position table -> ``[g, g, D]``),
the layer it takes in a stacked ``[depth, ...]`` leaf, the rows it takes
of a packed ``in_proj`` weight, and, for the few leaves the reference may
lack, the exact value its model has then: zero biases of the GroupNorm
convolutions (detectron2 builds them without bias), the identity input
projections of the decoder when its input width equals its own, ones for
FocalNet's layer scale when the config has none, and a zero
``backbone_proj`` (a checkpoint trained without the backbone retrieval
loss).  Convolution kernels are PyTorch's in both layouts, so they map as
they are.

``import_xdecoder_checkpoint(state, cfg)`` reads a state dict of numpy
arrays through the table into the port's tree (numpy leaves); a key the
table needs and the state lacks raises ``KeyError`` naming every such key.
``reference_state_from_params(params, cfg)`` is its inverse (tensors in,
CPU tensors out), so a test or a smoke run can write a checkpoint in the
reference's key names.  ``align_and_update(target, loaded)`` puts the
loaded leaves into the target tree's dtype and device and raises
``ValueError`` on any leaf that is missing, extra or of another shape (the
JAX function keeps the random initial value of such a leaf and only logs).
``unused_keys(state, cfg)`` lists the state's keys the table does not read.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

_FOCAL = ("focal", "focal_dw")


class Entry(NamedTuple):
    key: str                          # reference state-dict key
    path: tuple                       # port leaf: dict keys (str) and list indices (int)
    op: str = "id"                    # "id", "t", "1x1t" or "pos"
    index: Optional[int] = None       # layer of a stacked [depth, ...] leaf
    rows: Optional[tuple] = None      # (start, stop) of a packed in_proj tensor
    default: Optional[np.ndarray] = None   # the reference model's value when the key is absent


_TO_PORT = {
    "id": lambda a: a,
    "t": lambda a: np.ascontiguousarray(a.T),
    "1x1t": lambda a: np.ascontiguousarray(a[:, :, 0, 0].T),
    "pos": lambda a: a.reshape(a.shape[1:]) if a.ndim == 4 else a,
}
_TO_REFERENCE = {
    "id": lambda t: t,
    "t": lambda t: t.t().contiguous(),
    "1x1t": lambda t: t.t().contiguous()[:, :, None, None],
    "pos": lambda t: t[None],
}


def _zeros(n):
    return np.zeros((n,), np.float32)


def _pair(key, path, names, op="id", index=None):
    """``key.weight`` / ``key.bias`` -> ``path + (names[0],)`` / ``(names[1],)``."""
    return [Entry(key + ".weight", path + (names[0],), op, index),
            Entry(key + ".bias", path + (names[1],), "id", index)]


def _in_proj(key, path, D, names=("q_w", "q_b", "k_w", "k_b", "v_w", "v_b")):
    """A packed MultiheadAttention in_proj: rows [0, D), [D, 2D), [2D, 3D)."""
    out = []
    for j in range(3):
        rows = (j * D, (j + 1) * D)
        out.append(Entry(key + "_weight", path + (names[2 * j],), "t", rows=rows))
        out.append(Entry(key + "_bias", path + (names[2 * j + 1],), "id", rows=rows))
    return out


def _conv_gn(key, path, D):
    """A detectron2 Conv2d with GroupNorm: kernel, bias (absent in a
    reference model built without one: zero), norm."""
    return [Entry(key + ".weight", path + ("kernel",)),
            Entry(key + ".bias", path + ("bias",), default=_zeros(D)),
            *_pair(key + ".norm", path + ("norm",), ("scale", "bias"))]


def focalnet_table(cfg, prefix: str = "backbone.") -> list:
    p = prefix
    out = [Entry(p + "patch_embed.proj.weight", ("stem", "kernel")),
           Entry(p + "patch_embed.proj.bias", ("stem", "bias")),
           *_pair(p + "patch_embed.norm", ("stem", "norm"), ("scale", "bias"))]
    for i, depth in enumerate(cfg.depths):
        C = cfg.num_features[i]
        blk = ("stages", i, "blocks")
        for d in range(depth):
            b = f"{p}layers.{i}.blocks.{d}."
            out += [*_pair(b + "norm1", blk, ("norm1_s", "norm1_b"), index=d),
                    *_pair(b + "modulation.f", blk, ("f_w", "f_b"), "t", d),
                    *_pair(b + "modulation.h", blk, ("h_w", "h_b"), "1x1t", d),
                    *_pair(b + "modulation.proj", blk, ("proj_w", "proj_b"), "t", d),
                    *_pair(b + "norm2", blk, ("norm2_s", "norm2_b"), index=d),
                    *_pair(b + "mlp.fc1", blk, ("fc1_w", "fc1_b"), "t", d),
                    *_pair(b + "mlp.fc2", blk, ("fc2_w", "fc2_b"), "t", d)]
            if cfg.use_dw:
                out += [*_pair(b + "dw1", blk, ("dw1_w", "dw1_b"), index=d),
                        *_pair(b + "dw2", blk, ("dw2_w", "dw2_b"), index=d)]
            ones = None if cfg.use_layerscale else np.ones((C,), np.float32)
            out += [Entry(b + "gamma_1", blk + ("gamma1",), index=d, default=ones),
                    Entry(b + "gamma_2", blk + ("gamma2",), index=d, default=ones)]
            out += [Entry(b + f"modulation.focal_layers.{lvl}.0.weight", blk + (f"focal{lvl}_w",),
                          index=d) for lvl in range(cfg.focal_levels[i])]
        if i < len(cfg.depths) - 1:
            ds = f"{p}layers.{i}.downsample."
            out += [Entry(ds + "proj.weight", ("stages", i, "downsample", "kernel")),
                    Entry(ds + "proj.bias", ("stages", i, "downsample", "bias")),
                    *_pair(ds + "norm", ("stages", i, "downsample", "norm"), ("scale", "bias"))]
    for i in cfg.out_indices:
        out += _pair(f"{p}norm{i}", ("out_norms", str(i)), ("scale", "bias"))
    return out


def sam_vit_table(cfg, prefix: str = "backbone.") -> list:
    p = prefix
    out = [Entry(p + "patch_embed.proj.weight", ("patch_embed", "kernel")),
           Entry(p + "patch_embed.proj.bias", ("patch_embed", "bias")),
           Entry(p + "pos_embed", ("pos_embed",), "pos")]
    for i in range(cfg.depth):
        b, blk = f"{p}blocks.{i}.", ("blocks", i)
        out += [*_pair(b + "norm1", blk, ("ln1_s", "ln1_b")),
                *_pair(b + "attn.qkv", blk, ("qkv_w", "qkv_b"), "t"),
                *_pair(b + "attn.proj", blk, ("proj_w", "proj_b"), "t"),
                Entry(b + "attn.rel_pos_h", blk + ("rel_h",)),
                Entry(b + "attn.rel_pos_w", blk + ("rel_w",)),
                *_pair(b + "norm2", blk, ("ln2_s", "ln2_b")),
                *_pair(b + "mlp.lin1", blk, ("fc1_w", "fc1_b"), "t"),
                *_pair(b + "mlp.lin2", blk, ("fc2_w", "fc2_b"), "t")]
    neck = {"down4": ("down_4", ("up1", "gn1", None, "up2", "gn2", "conv", "gn3")),
            "down8": ("down_8", ("up1", "gn1", "conv", "gn2")),
            "down16": ("down_16", ("conv", "gn")),
            "down32": ("down_32", ("conv1", "gn1", "conv2", "gn2"))}
    for name, (ref, parts) in neck.items():
        for j, part in enumerate(parts):
            if part is not None:   # down_4.2 is the GELU between the upsamples
                names = ("scale", "bias") if part.startswith("gn") else ("kernel", "bias")
                out += _pair(f"{p}neck.{ref}.{j}", ("neck", name, part), names)
    return out


def fpn_table(cfg, prefix: str = "sem_seg_head.pixel_decoder.") -> list:
    p, D = prefix, cfg.conv_dim
    out = _pair(p + "input_proj", ("input_proj",), ("kernel", "bias"))
    for i in range(cfg.enc_layers):
        b, lay = f"{p}transformer.encoder.layers.{i}.", ("encoder_layers", i)
        out += [*_in_proj(b + "self_attn.in_proj", lay, D),
                *_pair(b + "self_attn.out_proj", lay, ("o_w", "o_b"), "t"),
                *_pair(b + "norm1", lay, ("ln1_s", "ln1_b")),
                *_pair(b + "linear1", lay, ("fc1_w", "fc1_b"), "t"),
                *_pair(b + "linear2", lay, ("fc2_w", "fc2_b"), "t"),
                *_pair(b + "norm2", lay, ("ln2_s", "ln2_b"))]
    # reference names: layer_4 = res5's output conv, adapter_3 / layer_3 =
    # res4, adapter_2 / layer_2 = res3, adapter_1 / layer_1 = res2
    for j, name in enumerate(("layer_4", "layer_3", "layer_2", "layer_1")):
        out += _conv_gn(p + name, ("output_convs", j), D)
    for j, name in enumerate(("adapter_3", "adapter_2", "adapter_1")):
        out += _conv_gn(p + name, ("lateral_convs", j), D)
    return out + _pair(p + "mask_features", ("mask_features",), ("kernel", "bias"))


def deform_encoder_table(cfg, prefix: str = "sem_seg_head.pixel_decoder.") -> list:
    p, D = prefix, cfg.conv_dim
    out = []
    for j, i in enumerate((2, 1, 0)):   # the reference's input_proj runs res5 -> res3
        out += [*_pair(f"{p}input_proj.{i}.0", ("input_proj", j), ("kernel", "bias")),
                *_pair(f"{p}input_proj.{i}.1", ("input_proj", j, "norm"), ("scale", "bias"))]
    out.append(Entry(p + "transformer.level_embed", ("level_embed",)))
    for i in range(cfg.num_layers):
        b, lay = f"{p}transformer.encoder.layers.{i}.", ("layers", i)
        for ref, name in (("value_proj", "value_proj"), ("sampling_offsets", "offset"),
                          ("attention_weights", "weight"), ("output_proj", "output")):
            out += _pair(f"{b}self_attn.{ref}", lay + ("attn", name), ("w", "b"), "t")
        out += [*_pair(b + "norm1", lay, ("ln1_s", "ln1_b")),
                *_pair(b + "linear1", lay, ("fc1_w", "fc1_b"), "t"),
                *_pair(b + "linear2", lay, ("fc2_w", "fc2_b"), "t"),
                *_pair(b + "norm2", lay, ("ln2_s", "ln2_b"))]
    return (out + _conv_gn(p + "adapter_1", ("lateral",), D)
            + _conv_gn(p + "layer_1", ("output",), D)
            + _pair(p + "mask_features", ("mask_features",), ("kernel", "bias")))


def predictor_table(cfg, prefix: str = "sem_seg_head.predictor.") -> list:
    p, H = prefix, cfg.hidden_dim
    out = []
    for i in range(cfg.dec_layers):
        for kind, sub, name in (("transformer_cross_attention_layers", "multihead_attn", "cross"),
                                ("transformer_self_attention_layers", "self_attn", "self")):
            b, lay = f"{p}{kind}.{i}.", ("layers", i, name)
            out += [*_in_proj(b + sub + ".in_proj", lay, H),
                    *_pair(b + sub + ".out_proj", lay, ("o_w", "o_b"), "t"),
                    *_pair(b + "norm", lay, ("ln_s", "ln_b"))]
        b, lay = f"{p}transformer_ffn_layers.{i}.", ("layers", i, "ffn")
        out += [*_pair(b + "linear1", lay, ("fc1_w", "fc1_b"), "t"),
                *_pair(b + "linear2", lay, ("fc2_w", "fc2_b"), "t"),
                *_pair(b + "norm", lay, ("ln_s", "ln_b"))]
    out += [*_pair(p + "decoder_norm", ("decoder_norm",), ("scale", "bias")),
            Entry(p + "query_feat.weight", ("query_feat",)),
            Entry(p + "query_embed.weight", ("query_embed",)),
            Entry(p + "level_embed.weight", ("level_embed",)),
            Entry(p + "class_embed", ("class_embed",)),
            Entry(p + "caping_embed", ("caping_embed",)),
            Entry(p + "pos_embed_caping.weight", ("pos_embed_caping",))]
    for head in ("mask_embed", "bbox_embed"):
        for j in range(3):
            out += _pair(f"{p}{head}.layers.{j}", (head,), (f"w{j}", f"b{j}"), "t")
    # an input width equal to hidden_dim makes the reference's projection an
    # empty nn.Sequential: no keys, the identity
    same = cfg.in_channels == H
    for i in range(cfg.num_feature_levels):
        out += [Entry(f"{p}input_proj.{i}.weight", ("input_proj", i, "w"), "1x1t",
                      default=np.eye(H, dtype=np.float32) if same else None),
                Entry(f"{p}input_proj.{i}.bias", ("input_proj", i, "b"),
                      default=_zeros(H) if same else None)]
    return out


def text_encoder_table(cfg, prefix: str = "sem_seg_head.predictor.lang_encoder.") -> list:
    p = prefix + "lang_encoder."
    out = [Entry(p + "token_embedding.weight", ("token_embedding",)),
           Entry(p + "positional_embedding", ("positional_embedding",))]
    for i in range(cfg.layers):
        b, lay = f"{p}resblocks.{i}.", ("layers",)
        out += [*_pair(b + "ln_1", lay, ("ln1_s", "ln1_b"), index=i),
                Entry(b + "attn.in_proj_weight", lay + ("qkv_w",), "t", i),
                Entry(b + "attn.in_proj_bias", lay + ("qkv_b",), "id", i),
                *_pair(b + "attn.out_proj", lay, ("o_w", "o_b"), "t", i),
                *_pair(b + "ln_2", lay, ("ln2_s", "ln2_b"), index=i),
                *_pair(b + "mlp.c_fc", lay, ("fc_w", "fc_b"), "t", i),
                *_pair(b + "mlp.c_proj", lay, ("proj_w", "proj_b"), "t", i)]
    return out + [*_pair(p + "ln_final", ("ln_final",), ("scale", "bias")),
                  Entry(prefix + "lang_proj", ("lang_proj",)),
                  Entry(prefix + "logit_scale", ("logit_scale",))]


def davit_table(cfg, prefix: str = "backbone.") -> list:
    """The reference's DaViT: ``convs.{i}`` patch embeds; per dual block
    ``blocks.{i}.{j}.{spatial,channel}_block`` with ``conv1`` / ``conv2``
    (``.fn.dw``), the attention's pre-norm and ``.fn.qkv`` / ``.fn.proj``,
    and the MLP's pre-norm and ``.fn.net.fc1`` / ``fc2``."""
    p = prefix
    out = []
    for i, depth in enumerate(cfg.depths):
        pe = ("patch_embeds", i)
        out += [*_pair(f"{p}convs.{i}.proj", pe, ("kernel", "bias")),
                *_pair(f"{p}convs.{i}.norm", pe + ("norm",), ("scale", "bias"))]
        for j in range(depth):
            for kind, attn in (("spatial", "window_attn"), ("channel", "channel_attn")):
                b, blk = f"{p}blocks.{i}.{j}.{kind}_block.", ("stages", i, j, kind)
                out += [*_pair(b + "conv1.fn.dw", blk, ("conv1", "conv1_b")),
                        *_pair(b + attn + ".norm", blk, ("ln_attn_s", "ln_attn_b")),
                        *_pair(b + attn + ".fn.qkv", blk, ("qkv_w", "qkv_b"), "t"),
                        *_pair(b + attn + ".fn.proj", blk, ("proj_w", "proj_b"), "t"),
                        *_pair(b + "conv2.fn.dw", blk, ("conv2", "conv2_b")),
                        *_pair(b + "ffn.norm", blk, ("ln_ffn_s", "ln_ffn_b")),
                        *_pair(b + "ffn.fn.net.fc1", blk, ("fc1_w", "fc1_b"), "t"),
                        *_pair(b + "ffn.fn.net.fc2", blk, ("fc2_w", "fc2_b"), "t")]
    return out


def backbone_table(cfg, prefix: str = "backbone.") -> list:
    if cfg.backbone_name in _FOCAL:
        return focalnet_table(cfg.backbone, prefix)
    if cfg.backbone_name == "davit":
        return davit_table(cfg.backbone, prefix)
    if cfg.backbone_name == "vit":
        return sam_vit_table(cfg.backbone, prefix)
    raise KeyError(f"backbone {cfg.backbone_name!r}")


def pixel_decoder_table(cfg, prefix: str = "sem_seg_head.pixel_decoder.") -> list:
    if cfg.encoder_name == "transformer_encoder_deform":
        return deform_encoder_table(cfg.fpn, prefix)
    return fpn_table(cfg.fpn, prefix)


def reference_table(cfg) -> list:
    """Every entry of the whole model, the port paths rooted at the model's
    tree (``backbone``, ``fpn``, ``decoder``, ``text``, ``backbone_proj``)."""
    from cullavo_tpu_torch.models.xdecoder.model import _backbone_last_channels

    def under(root, entries):
        return [e._replace(path=(root,) + e.path) for e in entries]

    return (under("backbone", backbone_table(cfg)) + under("fpn", pixel_decoder_table(cfg))
            + under("decoder", predictor_table(cfg.decoder))
            + under("text", text_encoder_table(cfg.text))
            + [Entry("backbone_proj", ("backbone_proj",), default=np.zeros(
                (_backbone_last_channels(cfg), cfg.text.dim_lang), np.float32))])


def _nest(flat: dict):
    """{path: leaf} -> nested dicts, with lists where the keys are 0..n-1."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        out = {k: lists(v) for k, v in node.items()}
        if out and all(isinstance(k, int) for k in out):
            return [out[i] for i in range(len(out))]
        return out

    return lists(root)


def import_from_table(state: Mapping, entries: list) -> dict:
    """The port's tree (numpy leaves) of the entries' leaves read from
    ``state``; every absent key without a default raises, all named."""
    parts: dict = {}
    missing = []
    for e in entries:
        if e.key in state:
            a = np.asarray(state[e.key])
            if e.rows is not None:
                a = a[e.rows[0]:e.rows[1]]
            a = _TO_PORT[e.op](a)
        elif e.default is not None:
            a = e.default
        else:
            missing.append(e.key)
            continue
        if e.index is None:
            parts[e.path] = a
        else:
            parts.setdefault(e.path, {})[e.index] = a
    if missing:
        raise KeyError(f"the checkpoint lacks {len(missing)} keys the model needs: "
                       f"{missing[:8]}{' ...' if len(missing) > 8 else ''}")
    flat = {}
    for path, v in parts.items():
        if isinstance(v, dict):
            shapes = {a.shape for a in v.values()}
            if len(shapes) != 1:
                raise ValueError(f"layers of {path} differ in shape: {sorted(shapes)}")
            v = np.stack([v[i] for i in range(len(v))])
        flat[path] = v
    return _nest(flat)


def import_focalnet(state, cfg, prefix="backbone."):
    return import_from_table(state, focalnet_table(cfg, prefix))


def import_sam_vit(state, cfg, prefix="backbone."):
    return import_from_table(state, sam_vit_table(cfg, prefix))


def import_fpn(state, cfg, prefix="sem_seg_head.pixel_decoder."):
    return import_from_table(state, fpn_table(cfg, prefix))


def import_deform_encoder(state, cfg, prefix="sem_seg_head.pixel_decoder."):
    return import_from_table(state, deform_encoder_table(cfg, prefix))


def import_xdecoder_predictor(state, cfg, prefix="sem_seg_head.predictor."):
    return import_from_table(state, predictor_table(cfg, prefix))


def import_text_encoder(state, cfg, prefix="sem_seg_head.predictor.lang_encoder."):
    return import_from_table(state, text_encoder_table(cfg, prefix))


def import_davit(state, cfg, prefix="backbone."):
    return import_from_table(state, davit_table(cfg, prefix))


def import_backbone(state, cfg, prefix="backbone."):
    return import_from_table(state, backbone_table(cfg, prefix))


def import_pixel_decoder(state, cfg, prefix="sem_seg_head.pixel_decoder."):
    return import_from_table(state, pixel_decoder_table(cfg, prefix))


def import_xdecoder_checkpoint(state: Mapping, cfg) -> dict:
    """The whole model's tree (numpy leaves) from a reference state dict."""
    return import_from_table(state, reference_table(cfg))


def unused_keys(state: Mapping, cfg) -> list:
    """The state's keys that no entry of the table reads, sorted."""
    return sorted(set(state) - {e.key for e in reference_table(cfg)})


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def reference_state_from_params(params: dict, cfg) -> dict:
    """The inverse of ``import_xdecoder_checkpoint``: the port's parameters
    (tensors) -> {reference key: CPU tensor}, every entry of the table
    written (defaults included)."""
    out: dict = {}
    packed: dict = {}
    for e in reference_table(cfg):
        t = _leaf(params, e.path).detach().cpu()
        if e.index is not None:
            t = t[e.index]
        t = _TO_REFERENCE[e.op](t)
        if e.rows is None:
            out[e.key] = t.contiguous()
        else:
            packed.setdefault(e.key, []).append((e.rows[0], t))
    for key, rows in packed.items():
        out[key] = torch.cat([t for _, t in sorted(rows, key=lambda r: r[0])]).contiguous()
    return out


def _flatten(node, path=()):
    if isinstance(node, dict):
        items = node.items()
    elif isinstance(node, (list, tuple)):
        items = enumerate(node)
    else:
        return {path: node}
    out = {}
    for k, v in items:
        out.update(_flatten(v, path + (k,)))
    return out


def align_and_update(target: dict, loaded: dict) -> dict:
    """``loaded`` (numpy or tensor leaves) in ``target``'s structure, dtype
    and device; a leaf missing from ``loaded``, one ``target`` lacks, or one
    whose shape differs raises ``ValueError`` naming the leaves."""
    flat_t, flat_l = _flatten(target), _flatten(loaded)
    missing = [p for p in flat_t if p not in flat_l]
    extra = [p for p in flat_l if p not in flat_t]
    wrong = [(p, tuple(flat_l[p].shape), tuple(flat_t[p].shape)) for p in flat_t
             if p in flat_l and tuple(flat_l[p].shape) != tuple(flat_t[p].shape)]
    if missing or extra or wrong:
        def show(items):
            return f"{len(items)} {items[:6]}{' ...' if len(items) > 6 else ''}"

        raise ValueError(f"the checkpoint does not fit the model: missing {show(missing)}; "
                         f"not in the model {show(extra)}; shape (checkpoint, model) "
                         f"{show(wrong)}")
    def rebuild(node, path):
        if isinstance(node, dict):
            return {k: rebuild(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rebuild(v, path + (i,)) for i, v in enumerate(node)]
        a = flat_l[path]
        a = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
        return a.to(device=node.device, dtype=node.dtype)

    return rebuild(target, ())
