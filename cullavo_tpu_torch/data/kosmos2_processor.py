"""KOSMOS-2's processor from a snapshot, by the port's own code (counterpart
of ``transformers``' ``Kosmos2Processor``, which JAX's zoo answerer calls as
``proc(images=..., text=...)``).

Text: the processor makes KOSMOS-2's 11 tag tokens (``<image>``,
``</image>``, ``<grounding>``, ...) and ``num_patch_index_tokens``
``<patch_index_NNNN>`` tokens added tokens with ``lstrip`` (not normalized,
not special), which ``tokenizer.json`` must already hold; a prompt becomes
``<s><image> <image> x N </image> {text.strip()}`` tokenized without the
template, then the N fake ``<image>`` ids are replaced by ``unk_id + 1 ..
unk_id + N`` and ``image_embeds_position_mask`` marks them (0 for ``<s>``,
``<image>``, ``</image>`` and the text).  N is the processor's default, 64.

Pixels: ``preprocessor_config.json``'s CLIP image processing, shortest edge
to ``size.shortest_edge`` (the long edge ``int(edge * long / short)``, as
transformers computes it), bicubic, center crop, rescale, normalize.
transformers resizes with PIL: a horizontal then a vertical pass of its
bicubic filter (a = -0.5, widened by the scale when shrinking), each
rounded to uint8.  The port runs the same two passes with
``torch.nn.functional.interpolate`` (bicubic, antialiased) and rounds after
each; PIL's fixed-point weights still move a pixel by one uint8 step here
and there (``tests/test_torch_zoo_snapshots.py`` holds the pixels to PIL's
within one step over the std); an image at the crop size is exact.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from cullavo_tpu_torch.data.tokenizer_json import TokenizerJSON

TAG_TOKENS = ("</doc>", "<image>", "</image>", "</chunk>", "</line>", "<phrase>", "</phrase>",
              "<object>", "</object>", "</delimiter_of_multi_objects/>", "<grounding>")
NUM_IMAGE_TOKENS = 64      # Kosmos2Processor's default num_image_tokens


def _read(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


class Kosmos2Processor:
    """``processor(image, text)`` -> (input_ids, attention_mask,
    image_embeds_position_mask, pixel_values) as int64 [1, T] x 3 and f32
    [1, 3, S, S] numpy arrays; ``tokenizer`` is the snapshot's
    ``TokenizerJSON``."""

    def __init__(self, model_dir: str):
        self.tokenizer = TokenizerJSON(model_dir)
        tok = self.tokenizer
        if tok.tokenizer_class != "XLMRobertaTokenizer":
            raise ValueError(f"{model_dir}: KOSMOS-2's tokenizer is XLMRobertaTokenizer, not "
                             f"{tok.tokenizer_class}")
        proc = _read(os.path.join(model_dir, "processor_config.json"))
        extra = set(proc) - {"processor_class", "num_patch_index_tokens"}
        if extra:
            raise NotImplementedError(f"{model_dir}/processor_config.json: {sorted(extra)} "
                                      "are not read by the port")
        n_patch = int(proc.get("num_patch_index_tokens", 1024))
        for t in TAG_TOKENS + tuple(f"<patch_index_{i:04d}>" for i in range(n_patch)):
            if t not in tok.added:
                raise ValueError(f"{model_dir}/tokenizer.json: KOSMOS-2's token {t!r} is not an "
                                 "added token (transformers would add it at a new id)")
            tok.set_added(t, tok.added[t][0], normalized=False, special=False, lstrip=True)
        self._read_image_config(model_dir)

    def _read_image_config(self, model_dir: str):
        path = os.path.join(model_dir, "preprocessor_config.json")
        cfg = _read(path)
        if not cfg:
            raise FileNotFoundError(f"no preprocessor_config.json under {model_dir}")
        known = {"image_processor_type", "processor_class", "do_resize", "size", "resample",
                 "do_center_crop", "crop_size", "do_rescale", "rescale_factor", "do_normalize",
                 "image_mean", "image_std", "do_convert_rgb"}
        if set(cfg) - known:
            raise NotImplementedError(f"{path}: {sorted(set(cfg) - known)} are not read")
        if cfg.get("image_processor_type", "CLIPImageProcessor") not in (
                "CLIPImageProcessor", "CLIPImageProcessorFast"):
            raise NotImplementedError(f"{path}: image_processor_type "
                                      f"{cfg['image_processor_type']!r}")
        size, crop = cfg.get("size", {}), cfg.get("crop_size", {})
        if not (cfg.get("do_resize", True) and cfg.get("do_center_crop", True)
                and cfg.get("do_rescale", True) and cfg.get("do_normalize", True)
                and cfg.get("resample", 3) == 3 and set(size) == {"shortest_edge"}
                and set(crop) == {"height", "width"}):
            raise NotImplementedError(f"{path}: only a bicubic shortest-edge resize, a center "
                                      "crop, a rescale and a normalization are read")
        self.edge = int(size["shortest_edge"])
        self.crop = (int(crop["height"]), int(crop["width"]))
        self.scale = float(cfg.get("rescale_factor", 1 / 255))
        self.mean = np.asarray(cfg["image_mean"], np.float32)
        self.std = np.asarray(cfg["image_std"], np.float32)

    def pixels(self, image) -> np.ndarray:
        """[H, W, 3] (or gray [H, W], or RGBA) uint8 -> [1, 3, ch, cw] f32."""
        im = np.asarray(image)
        if im.ndim == 2:
            im = np.stack([im] * 3, axis=-1)
        im = im[..., :3]
        if im.dtype != np.uint8:
            raise ValueError(f"KOSMOS-2 pixels: a uint8 [H, W, 3] image, not {im.dtype}")
        h, w = im.shape[:2]
        short, long = (h, w) if h <= w else (w, h)
        new_long = int(self.edge * long / short)
        nh, nw = (self.edge, new_long) if h <= w else (new_long, self.edge)
        x = torch.from_numpy(im.copy()).permute(2, 0, 1)[None].float()
        # PIL's order: the horizontal pass, rounded to uint8, then the vertical
        for size in ((h, nw), (nh, nw)):
            if size != tuple(x.shape[-2:]):
                x = F.interpolate(x, size=size, mode="bicubic", antialias=True,
                                  align_corners=False).round().clamp(0, 255)
        ch, cw = self.crop
        top, left = (nh - ch) // 2, (nw - cw) // 2
        if top < 0 or left < 0:
            raise NotImplementedError(f"KOSMOS-2 pixels: a crop of {self.crop} larger than the "
                                      f"resized {nh} x {nw} image (transformers pads)")
        x = x[0, :, top:top + ch, left:left + cw].numpy()
        # transformers rescales in f64, then normalizes in f32
        x = (x.astype(np.float64) * self.scale).astype(np.float32)
        x = (x - self.mean[:, None, None]) / self.std[:, None, None]
        return x[None].astype(np.float32)

    def text(self, text: str):
        tok, n = self.tokenizer, NUM_IMAGE_TOKENS
        img = " ".join(["<image>"] * (n + 1) + ["</image>"])
        ids = tok.encode(f"<s>{img} {text.strip()}", add_special_tokens=False)
        first = tok.unk_token_id + 1
        ids = ids[:2] + list(range(first, first + n)) + ids[2 + n:]
        mask = [0, 0] + [1] * n + [0] * (len(ids) - 2 - n)
        return (np.asarray([ids], np.int64), np.ones((1, len(ids)), np.int64),
                np.asarray([mask], np.int64))

    def __call__(self, image, text: str):
        return (*self.text(text), self.pixels(image))
