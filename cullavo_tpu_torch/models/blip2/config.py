"""Configs of the BLIP-2 family (counterpart of
``cullavo_tpu/models/blip2/config.py``, whose package imports JAX): the same
frozen dataclasses, fields and defaults, field names as in the HF configs.

Defaults: BLIP-2 OPT-2.7b (Salesforce/blip2-opt-2.7b): EVA-ViT-g (39
layers, width 1408), Q-Former (12 layers, width 768, cross-attention every
2), OPT-2.7b.  ``blip2_flant5xl_config`` is the reference's headline
checkpoint, Salesforce/blip2-flan-t5-xl; ``instructblip_vicuna7b_config``
is Salesforce/instructblip-vicuna-7b (the text-input Q-Former and Vicuna-7B).
"""
from __future__ import annotations

import dataclasses
from typing import Union

from cullavo_tpu_torch.models.blip2.t5 import T5Config, tiny_t5_config
from cullavo_tpu_torch.models.llava.config import LlamaConfig


@dataclasses.dataclass(frozen=True)
class Blip2VisionConfig:
    hidden_size: int = 1408
    intermediate_size: int = 6144
    num_hidden_layers: int = 39
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    hidden_act: str = "gelu"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclasses.dataclass(frozen=True)
class QFormerConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    cross_attention_frequency: int = 2
    encoder_hidden_size: int = 1408
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu"
    # InstructBLIP feeds the instruction text into the Q-Former
    use_text_input: bool = False
    vocab_size: int = 30522            # BERT vocab (InstructBLIP tokenizer)
    max_position_embeddings: int = 512

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclasses.dataclass(frozen=True)
class OptConfig:
    vocab_size: int = 50272
    hidden_size: int = 2560
    ffn_dim: int = 10240
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    max_position_embeddings: int = 2048
    do_layer_norm_before: bool = True
    activation_function: str = "relu"
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclasses.dataclass(frozen=True)
class Blip2Config:
    vision: Blip2VisionConfig = dataclasses.field(default_factory=Blip2VisionConfig)
    qformer: QFormerConfig = dataclasses.field(default_factory=QFormerConfig)
    # OPT (blip2-opt-*), LLaMA/Vicuna (instructblip-vicuna-*) or Flan-T5
    # (blip2-flan-t5-*); the T5 and LLaMA towers are ported
    text: Union[OptConfig, LlamaConfig, T5Config] = dataclasses.field(
        default_factory=OptConfig)
    num_query_tokens: int = 32

    @property
    def text_is_opt(self) -> bool:
        return isinstance(self.text, OptConfig)

    @property
    def text_is_t5(self) -> bool:
        return isinstance(self.text, T5Config)

    @property
    def lm_hidden_size(self) -> int:
        return self.text.d_model if self.text_is_t5 else self.text.hidden_size


def blip2_flant5xl_config() -> Blip2Config:
    """Salesforce/blip2-flan-t5-xl, the checkpoint the reference evaluates
    (its BLIP2VQAVALPipeline)."""
    return Blip2Config(text=T5Config())


def instructblip_vicuna7b_config() -> Blip2Config:
    """Salesforce/instructblip-vicuna-7b: the instruction-aware Q-Former and
    the Vicuna-7B (LLaMA) decoder (the reference's InstructBLIPVQAVALPipeline)."""
    return Blip2Config(
        qformer=QFormerConfig(use_text_input=True),
        text=LlamaConfig(vocab_size=32001, hidden_size=4096, intermediate_size=11008,
                         num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
                         max_position_embeddings=2048),
    )


def tiny_blip2_config(text: str = "opt") -> Blip2Config:
    vis = Blip2VisionConfig(hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=4,
                            image_size=28, patch_size=14)
    qf = QFormerConfig(hidden_size=24, num_hidden_layers=3,
                       num_attention_heads=4, intermediate_size=48,
                       encoder_hidden_size=32, vocab_size=99,
                       use_text_input=(text == "llama_text"))
    if text == "opt":
        txt = OptConfig(vocab_size=120, hidden_size=32, ffn_dim=64,
                        num_hidden_layers=2, num_attention_heads=4,
                        max_position_embeddings=128)
    elif text == "t5":
        txt = tiny_t5_config()
    else:
        txt = LlamaConfig(vocab_size=120, hidden_size=32, intermediate_size=64,
                          num_hidden_layers=2, num_attention_heads=4,
                          num_key_value_heads=2, max_position_embeddings=128)
    return Blip2Config(vision=vis, qformer=qf, text=txt, num_query_tokens=4)
