"""Model hyperparameter configs for the LLaVA-1.5 stack (torch port).

Same dataclasses, fields and defaults as ``cullavo_tpu/models/llava/config.py``
(which imports ``jax.numpy`` and so cannot be imported here).  Defaults
reproduce LLaVA-1.5-7B: CLIP-ViT-L/14-336, 2-layer GELU projector,
LLaMA-2-7B decoder.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_positions(self) -> int:
        return self.num_patches + 1  # + CLS

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32064
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    # Mistral-style local attention (None = full causal)
    sliding_window: Optional[int] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclasses.dataclass(frozen=True)
class LlavaConfig:
    vision: ClipVisionConfig = dataclasses.field(default_factory=ClipVisionConfig)
    text: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    projector_hidden_act: str = "gelu"
    vision_feature_layer: int = -2
    vision_feature_select_strategy: str = "default"  # "default" drops CLS
    image_token_id: int = 32000
    pad_token_id: int = 32001
    ignore_index: int = -100

    @property
    def num_image_tokens(self) -> int:
        n = self.vision.num_patches
        if self.vision_feature_select_strategy == "full":
            n += 1
        return n


def tiny_llava_config(vocab_size: int = 128) -> LlavaConfig:
    """A small config for tests."""
    return LlavaConfig(
        vision=ClipVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, image_size=28, patch_size=14),
        text=LlamaConfig(
            vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=256),
        image_token_id=vocab_size - 2,
        pad_token_id=vocab_size - 1,
    )
