"""Model configs from the YAML config tree, X-Decoder half (counterpart of
``cullavo_tpu/models/from_config.py``): the reference's key names
(``MODEL.BACKBONE.*``, ``MODEL.ENCODER.*``, ``MODEL.DECODER.*``,
``MODEL.TEXT.*``) read exactly as the JAX package reads them, so one config
dict builds the same model in both packages.  That includes the JAX
reader's FocalNet keys under ``MODEL.BACKBONE.FOCAL.*``: the repo's focal
configs put them directly under ``MODEL.BACKBONE``, so those load with the
defaults (FocalNet-L) in both packages.
"""
from __future__ import annotations

from typing import Any

from cullavo_tpu_torch.models.xdecoder.davit import DaViTConfig
from cullavo_tpu_torch.models.xdecoder.decoder import XDecoderConfig
from cullavo_tpu_torch.models.xdecoder.deform_encoder import DeformEncoderConfig
from cullavo_tpu_torch.models.xdecoder.focalnet import FocalNetConfig
from cullavo_tpu_torch.models.xdecoder.fpn import FPNConfig
from cullavo_tpu_torch.models.xdecoder.model import (CriterionConfig, XDecoderModelConfig,
                                                     tiny_xdecoder_config)
from cullavo_tpu_torch.models.xdecoder.sam_vit import SamVitConfig
from cullavo_tpu_torch.models.xdecoder.text_encoder import TextEncoderConfig


def _get(cfg: Any, key: str, default=None):
    node = cfg
    for part in key.split("."):
        if node is None or part not in node:
            return default
        node = node[part]
    return node


def focalnet_config_from(cfg) -> FocalNetConfig:
    f = "MODEL.BACKBONE.FOCAL"
    return FocalNetConfig(
        embed_dim=int(_get(cfg, f + ".EMBED_DIM", 192)),
        depths=tuple(_get(cfg, f + ".DEPTHS", (2, 2, 18, 2))),
        focal_levels=tuple(_get(cfg, f + ".FOCAL_LEVELS", (4, 4, 4, 4))),
        focal_windows=tuple(_get(cfg, f + ".FOCAL_WINDOWS", (3, 3, 3, 3))),
        use_conv_embed=bool(_get(cfg, f + ".USE_CONV_EMBED", True)),
        use_postln=bool(_get(cfg, f + ".USE_POSTLN", True)),
        use_postln_in_modulation=bool(_get(cfg, f + ".USE_POSTLN_IN_MODULATION", False)),
        use_layerscale=bool(_get(cfg, f + ".USE_LAYERSCALE", True)),
        scaling_modulator=bool(_get(cfg, f + ".SCALING_MODULATOR", True)),
        use_dw=_get(cfg, "MODEL.BACKBONE.NAME", "focal") == "focal_dw",
    )


def davit_config_from(cfg) -> DaViTConfig:
    d = "MODEL.BACKBONE.DAVIT"
    return DaViTConfig(
        embed_dims=tuple(_get(cfg, d + ".DIM_EMBED", (128, 256, 512, 1024))),
        num_heads=tuple(_get(cfg, d + ".NUM_HEADS", (4, 8, 16, 32))),
        num_groups=tuple(_get(cfg, d + ".NUM_GROUPS", (4, 8, 16, 32))),
        depths=tuple(_get(cfg, d + ".DEPTHS", (1, 1, 9, 1))),
        window_size=int(_get(cfg, d + ".WINDOW_SIZE", 12)),
    )


def sam_vit_config_from(cfg) -> SamVitConfig:
    v = "MODEL.BACKBONE.VIT"
    return SamVitConfig(
        embed_dim=int(_get(cfg, v + ".EMBED_DIM", 768)),
        depth=int(_get(cfg, v + ".DEPTH", 12)),
        num_heads=int(_get(cfg, v + ".NUM_HEADS", 12)),
    )


def backbone_config_from(cfg):
    name = _get(cfg, "MODEL.BACKBONE.NAME", "focal")
    if name in ("focal", "focal_dw"):
        return name, focalnet_config_from(cfg)
    if name == "davit":
        return name, davit_config_from(cfg)
    if name == "vit":
        return name, sam_vit_config_from(cfg)
    raise KeyError(f"MODEL.BACKBONE.NAME {name!r}")


def _backbone_channels(backbone) -> tuple:
    if isinstance(backbone, FocalNetConfig):
        return tuple(backbone.num_features)
    if isinstance(backbone, DaViTConfig):
        return tuple(backbone.embed_dims)
    return tuple(backbone.out_dims)   # SAM-ViT: the simple-FPN neck's widths


def fpn_config_from(cfg, backbone) -> FPNConfig:
    e = "MODEL.ENCODER"
    return FPNConfig(
        in_channels=_backbone_channels(backbone),
        conv_dim=int(_get(cfg, e + ".CONVS_DIM", 512)),
        mask_dim=int(_get(cfg, e + ".MASK_DIM", 512)),
        enc_layers=int(_get(cfg, e + ".TRANSFORMER_ENC_LAYERS", 6)),
    )


def encoder_config_from(cfg, backbone):
    name = _get(cfg, "MODEL.ENCODER.NAME", "transformer_encoder_fpn")
    if name == "transformer_encoder_fpn":
        return name, fpn_config_from(cfg, backbone)
    if name == "transformer_encoder_deform":
        e = "MODEL.ENCODER"
        return name, DeformEncoderConfig(
            in_channels=_backbone_channels(backbone),
            conv_dim=int(_get(cfg, e + ".CONVS_DIM", 512)),
            mask_dim=int(_get(cfg, e + ".MASK_DIM", 512)),
            num_layers=int(_get(cfg, e + ".TRANSFORMER_ENC_LAYERS", 6)))
    raise KeyError(f"MODEL.ENCODER.NAME {name!r}")


def decoder_config_from(cfg) -> XDecoderConfig:
    d = "MODEL.DECODER"
    return XDecoderConfig(
        hidden_dim=int(_get(cfg, d + ".HIDDEN_DIM", 512)),
        num_queries=int(_get(cfg, d + ".NUM_OBJECT_QUERIES", 201)),
        nheads=int(_get(cfg, d + ".NHEADS", 8)),
        dim_feedforward=int(_get(cfg, d + ".DIM_FEEDFORWARD", 2048)),
        dec_layers=int(_get(cfg, d + ".DEC_LAYERS", 10)) - 1,
        mask_dim=int(_get(cfg, "MODEL.ENCODER.MASK_DIM", 512)),
        dim_proj=int(_get(cfg, "MODEL.DIM_PROJ", 512)),
        contxt_len=int(_get(cfg, "MODEL.TEXT.CONTEXT_LENGTH", 77)),
        in_channels=int(_get(cfg, "MODEL.ENCODER.CONVS_DIM", 512)),
        captioning_step=int(_get(cfg, d + ".CAPTIONING.STEP", 50)),
        task_mask=bool(_get(cfg, d + ".MASK", True)),
        task_bbox=bool(_get(cfg, d + ".DETECTION", True)),
        task_grounding=bool(_get(cfg, d + ".GROUNDING.ENABLED", True)),
        task_captioning=bool(_get(cfg, d + ".CAPTIONING.ENABLED", True)),
    )


def text_config_from(cfg) -> TextEncoderConfig:
    t = "MODEL.TEXT"
    return TextEncoderConfig(
        width=int(_get(cfg, t + ".WIDTH", 512)),
        heads=int(_get(cfg, t + ".HEADS", 8)),
        layers=int(_get(cfg, t + ".LAYERS", 12)),
        context_length=int(_get(cfg, t + ".CONTEXT_LENGTH", 77)),
        autoregressive=bool(_get(cfg, t + ".AUTOGRESSIVE", True)),
        dim_lang=int(_get(cfg, "MODEL.DIM_PROJ", 512)),
    )


def criterion_config_from(cfg) -> CriterionConfig:
    d = "MODEL.DECODER"
    return CriterionConfig(
        num_classes=int(_get(cfg, "MODEL.ENCODER.NUM_CLASSES", 133)),
        num_points=int(_get(cfg, d + ".TRAIN_NUM_POINTS", 12544)),
        oversample_ratio=float(_get(cfg, d + ".OVERSAMPLE_RATIO", 3.0)),
        importance_sample_ratio=float(_get(cfg, d + ".IMPORTANCE_SAMPLE_RATIO", 0.75)),
        weight_ce=float(_get(cfg, d + ".CLASS_WEIGHT", 2.0)),
        weight_mask=float(_get(cfg, d + ".MASK_WEIGHT", 5.0)),
        weight_dice=float(_get(cfg, d + ".DICE_WEIGHT", 5.0)),
        weight_bbox=float(_get(cfg, d + ".BBOX_WEIGHT", 5.0)),
        weight_giou=float(_get(cfg, d + ".GIOU_WEIGHT", 2.0)),
        weight_caption=float(_get(cfg, d + ".CAPTION_WEIGHT", 1.0)),
        weight_captioning=float(_get(cfg, d + ".CAPTIONING_WEIGHT", 2.0)),
        weight_retrieval_decoder=float(_get(cfg, d + ".RETRIEVAL_WEIGHT", 2.0)),
        weight_retrieval_backbone=float(_get(cfg, d + ".BACKBONER_WEIGHT", 8.0)),
        weight_grounding_ce=float(_get(cfg, d + ".GCLASS_WEIGHT", 0.4)),
        weight_grounding_bce=float(_get(cfg, d + ".GMASK_WEIGHT", 1.0)),
        weight_grounding_dice=float(_get(cfg, d + ".GDICE_WEIGHT", 1.0)),
        top_x_layers_mask=int(_get(cfg, d + ".TOP_MASK_LAYERS", 10)),
        top_x_layers_class=int(_get(cfg, d + ".TOP_MASK_LAYERS", 10)),
        top_x_layers_box=int(_get(cfg, d + ".TOP_MASK_LAYERS", 10)),
        top_x_layers_caption=int(_get(cfg, d + ".TOP_CAPTION_LAYERS", 3)),
        top_x_layers_captioning=int(_get(cfg, d + ".TOP_CAPTIONING_LAYERS", 3)),
        top_x_layers_retrieval=int(_get(cfg, d + ".TOP_RETRIEVAL_LAYERS", 3)),
        top_x_layers_grounding=int(_get(cfg, d + ".TOP_GROUNDING_LAYERS", 3)),
    )


def xdecoder_model_config_from(cfg) -> XDecoderModelConfig:
    if _get(cfg, "MODEL.TINY", False):
        return tiny_xdecoder_config()   # the fixture/smoke model
    backbone_name, backbone = backbone_config_from(cfg)
    encoder_name, encoder = encoder_config_from(cfg, backbone)
    return XDecoderModelConfig(
        backbone=backbone, backbone_name=backbone_name, fpn=encoder, encoder_name=encoder_name,
        decoder=decoder_config_from(cfg), text=text_config_from(cfg),
        criterion=criterion_config_from(cfg),
        num_classes=int(_get(cfg, "MODEL.ENCODER.NUM_CLASSES", 133)),
        object_mask_threshold=float(_get(cfg, "MODEL.TEST.OBJECT_MASK_THRESHOLD", 0.8)),
        overlap_threshold=float(_get(cfg, "MODEL.TEST.OVERLAP_THRESHOLD", 0.8)),
        test_topk_per_image=int(_get(cfg, "MODEL.TEST.DETECTIONS_PER_IMAGE", 100)),
    )
