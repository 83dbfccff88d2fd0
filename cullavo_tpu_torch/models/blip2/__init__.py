"""The BLIP-2 family in PyTorch (counterpart of ``cullavo_tpu/models/blip2``)."""
from cullavo_tpu_torch.models.blip2.config import (Blip2Config, Blip2VisionConfig, OptConfig,
                                                   QFormerConfig, blip2_flant5xl_config,
                                                   instructblip_vicuna7b_config,
                                                   tiny_blip2_config)
from cullavo_tpu_torch.models.blip2.modeling import (blip2_beam_generate, blip2_forward,
                                                     blip2_generate, blip2_image_embed,
                                                     blip2_text_embed, encode_image,
                                                     init_blip2_params)
