"""The VL zoo's HF snapshots in the torch port against the JAX package:
tiny BLIP-2 Flan-T5, InstructBLIP and KOSMOS-2 models built with
transformers as ``tests/test_blip2.py`` and ``tests/test_kosmos2.py`` build
them, saved with ``save_pretrained(safe_serialization=True)``; the port's
readers of the files (``checkpoint/zoo_import.py``) give JAX's
``import_*_torch`` trees of the live modules bit for bit at f32, plus the
EVA-ViT-g biases that JAX's import drops (the port's vision tower then
matches transformers' within 1e-5), and the exporters write the files'
tensors back; tied weights stored under any of their names, a missing or
an unread key, a config.json of other widths.  The port's
KOSMOS-2 processor against transformers' (ids and the image mask exact,
pixels exact at the crop size and within one uint8 step of PIL's resize
elsewhere), Mistral's sliding window in ``llama_forward`` (GQA; prefill
where the window binds and where it cannot, cached decode) against JAX's
within 1e-4 at f32, and ``bakllava_config``.

The snapshot writers here also write those of ``test_torch_zoo_path.py``.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import transformers

from cullavo_tpu.models import kosmos2 as j_k2
from cullavo_tpu.models.blip2 import config as j_cfg
from cullavo_tpu.models.blip2 import import_blip2_torch
from cullavo_tpu.models.llava import config as j_lcfg
from cullavo_tpu.models.llava import llama as j_llama
from cullavo_tpu_torch.checkpoint import zoo_import as zi
from cullavo_tpu_torch.checkpoint.from_jax import blip2_params_from_numpy
from cullavo_tpu_torch.checkpoint.safetensors_io import read_safetensors, write_safetensors
from cullavo_tpu_torch.data.kosmos2_processor import Kosmos2Processor
from cullavo_tpu_torch.models import kosmos2 as t_k2
from cullavo_tpu_torch.models.blip2 import config as t_cfg
from cullavo_tpu_torch.models.blip2.vision import blip2_vision_forward
from cullavo_tpu_torch.models.llava import config as t_lcfg
from cullavo_tpu_torch.models.llava import llama as t_llama
from test_torch_joint_data import chip_smoke
from test_torch_vl_eval import write_tokenizer as write_llama_tokenizer


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Tier-1 runs 6 xdist workers: 2 torch threads in this file, and the
    worker's own setting back for the files that follow."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# the tiny stand-ins for the published configs: the JAX package's tiny
# towers with the vocabularies of the tokenizers written here (BPE: 300
# pieces + <image> + <pad>), KOSMOS-2 with the processor's 64 image tokens
T5_VOCAB, LLAMA_VOCAB, BPE_VOCAB, K2_VOCAB, K2_PATCHES = 160, 302, 300, 300, 4
WINDOW = 8
CLIP_MEAN = [0.48145466, 0.4578275, 0.40821073]
CLIP_STD = [0.26862954, 0.26130258, 0.27577711]


def tiny_blip2(kind, cfg_mod):
    """``cfg_mod`` (either package's blip2 config module): kind "flant5" or
    "instructblip"."""
    cfg = cfg_mod.tiny_blip2_config("t5" if kind == "flant5" else "llama_text")
    vocab = T5_VOCAB if kind == "flant5" else LLAMA_VOCAB
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, vocab_size=vocab))


def tiny_kosmos2(k2_mod):
    cfg = k2_mod.tiny_kosmos2_config()
    return dataclasses.replace(cfg, latent_query_num=64,
                               text=dataclasses.replace(cfg.text, vocab_size=K2_VOCAB))


def tiny_bakllava(lcfg_mod):
    """LLaVA's tiny config over a Mistral tower (GQA 4 heads over 2, sliding
    window ``WINDOW``), <image> and <pad> where the BPE tokenizer puts them."""
    cfg = lcfg_mod.tiny_llava_config(LLAMA_VOCAB)
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, sliding_window=WINDOW),
                               image_token_id=BPE_VOCAB, pad_token_id=BPE_VOCAB + 1)


def _hf_vision(cls, v):
    return cls(hidden_size=v.hidden_size, intermediate_size=v.intermediate_size,
               num_hidden_layers=v.num_hidden_layers, num_attention_heads=v.num_attention_heads,
               image_size=v.image_size, patch_size=v.patch_size,
               layer_norm_eps=v.layer_norm_eps, hidden_act="gelu",
               attention_dropout=0.0).to_dict()


def hf_blip2(kind, seed, vision_biases=False):
    """A tiny Blip2ForConditionalGeneration (Flan-T5) or
    InstructBlipForConditionalGeneration (Vicuna) of ``tiny_blip2``'s
    widths; ``vision_biases``: nonzero patch and q / v biases, as an
    EVA-ViT-g checkpoint has (transformers initializes them to zero)."""
    cfg = tiny_blip2(kind, j_cfg)
    q = cfg.qformer
    qf = dict(hidden_size=q.hidden_size, num_hidden_layers=q.num_hidden_layers,
              num_attention_heads=q.num_attention_heads, intermediate_size=q.intermediate_size,
              cross_attention_frequency=q.cross_attention_frequency,
              encoder_hidden_size=q.encoder_hidden_size, vocab_size=q.vocab_size,
              max_position_embeddings=q.max_position_embeddings, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
    t = cfg.text
    if kind == "flant5":
        text = transformers.T5Config(
            vocab_size=t.vocab_size, d_model=t.d_model, d_kv=t.d_kv, num_heads=t.num_heads,
            d_ff=t.d_ff, num_layers=t.num_layers, num_decoder_layers=t.num_decoder_layers,
            relative_attention_num_buckets=t.relative_attention_num_buckets,
            relative_attention_max_distance=t.relative_attention_max_distance,
            feed_forward_proj="gated-gelu", tie_word_embeddings=False, dropout_rate=0.0,
            decoder_start_token_id=0)
        hf_cfg = transformers.Blip2Config(
            vision_config=_hf_vision(transformers.Blip2VisionConfig, cfg.vision),
            qformer_config=qf, text_config=text.to_dict(), num_query_tokens=cfg.num_query_tokens)
        cls = transformers.Blip2ForConditionalGeneration
    else:
        text = transformers.LlamaConfig(
            vocab_size=t.vocab_size, hidden_size=t.hidden_size,
            intermediate_size=t.intermediate_size, num_hidden_layers=t.num_hidden_layers,
            num_attention_heads=t.num_attention_heads,
            num_key_value_heads=t.num_key_value_heads,
            max_position_embeddings=t.max_position_embeddings, rms_norm_eps=t.rms_norm_eps)
        hf_cfg = transformers.InstructBlipConfig(
            vision_config=_hf_vision(transformers.InstructBlipVisionConfig, cfg.vision),
            qformer_config=qf, text_config=text.to_dict(), num_query_tokens=cfg.num_query_tokens)
        cls = transformers.InstructBlipForConditionalGeneration
    torch.manual_seed(seed)
    model = cls(hf_cfg).eval()
    if vision_biases:
        g = torch.Generator().manual_seed(seed + 1)
        D = cfg.vision.hidden_size
        with torch.no_grad():
            emb = model.vision_model.embeddings.patch_embedding
            emb.bias.copy_(torch.randn(emb.bias.shape, generator=g) * 0.5)
            for layer in model.vision_model.encoder.layers:
                b = torch.randn(3 * D, generator=g) * 0.5
                b[D:2 * D] = 0.0
                layer.self_attn.qkv.bias.copy_(b)
    return model


def hf_kosmos2(seed):
    cfg = tiny_kosmos2(j_k2)
    t = cfg.text
    text = transformers.models.kosmos2.configuration_kosmos2.Kosmos2TextConfig(
        vocab_size=t.vocab_size, embed_dim=t.embed_dim, layers=t.layers, ffn_dim=t.ffn_dim,
        attention_heads=t.attention_heads, max_position_embeddings=t.max_position_embeddings,
        dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, layerdrop=0.0)
    v = cfg.vision
    hf_cfg = transformers.Kosmos2Config(
        text_config=text.to_dict(),
        vision_config=dict(hidden_size=v.hidden_size, intermediate_size=v.intermediate_size,
                           num_hidden_layers=v.num_hidden_layers,
                           num_attention_heads=v.num_attention_heads, image_size=v.image_size,
                           patch_size=v.patch_size, attention_dropout=0.0),
        latent_query_num=cfg.latent_query_num)
    torch.manual_seed(seed)
    return transformers.Kosmos2ForConditionalGeneration(hf_cfg).eval()


def hf_bakllava(seed):
    cfg = tiny_bakllava(j_lcfg)
    t, v = cfg.text, cfg.vision
    text = transformers.MistralConfig(
        vocab_size=t.vocab_size, hidden_size=t.hidden_size, intermediate_size=t.intermediate_size,
        num_hidden_layers=t.num_hidden_layers, num_attention_heads=t.num_attention_heads,
        num_key_value_heads=t.num_key_value_heads,
        max_position_embeddings=t.max_position_embeddings, rms_norm_eps=t.rms_norm_eps,
        rope_theta=t.rope_theta, sliding_window=t.sliding_window)
    vision = transformers.CLIPVisionConfig(
        hidden_size=v.hidden_size, intermediate_size=v.intermediate_size,
        num_hidden_layers=v.num_hidden_layers, num_attention_heads=v.num_attention_heads,
        image_size=v.image_size, patch_size=v.patch_size, projection_dim=v.hidden_size)
    hf_cfg = transformers.LlavaConfig(vision_config=vision.to_dict(), text_config=text.to_dict(),
                                      image_token_index=cfg.image_token_id,
                                      pad_token_id=cfg.pad_token_id,
                                      vision_feature_layer=cfg.vision_feature_layer,
                                      vision_feature_select_strategy="default",
                                      projector_hidden_act="gelu")
    torch.manual_seed(seed)
    return transformers.LlavaForConditionalGeneration(hf_cfg).eval()


def _image_config(path, kind):
    side = 28
    common = {"do_resize": True, "resample": 3, "do_rescale": True, "rescale_factor": 1 / 255,
              "do_normalize": True, "image_mean": CLIP_MEAN, "image_std": CLIP_STD,
              "do_convert_rgb": True}
    if kind == "clip":
        spec = {"image_processor_type": "CLIPImageProcessor", "processor_class": "Kosmos2Processor",
                "size": {"shortest_edge": side}, "do_center_crop": True,
                "crop_size": {"height": side, "width": side}, **common}
    else:
        spec = {"image_processor_type": "BlipImageProcessor",
                "size": {"height": side, "width": side}, **common}
    with open(os.path.join(path, "preprocessor_config.json"), "w") as f:
        json.dump(spec, f)


def write_snapshot(path, kind, seed=0, vision_biases=False, quiet_specials=False):
    """A tiny snapshot of ``kind`` ("flant5", "instructblip", "kosmos2",
    "bakllava") in the HF layout: the weights by ``save_pretrained``, the
    tokenizer files of ``chip_smoke``'s writers (and ``test_torch_vl_eval``'s
    BPE one), the image processor's config.  ``quiet_specials``: the output
    head's rows of the tokenizer's special ids (the BPE one's byte tokens
    among them) zeroed, so that a random tower's answers are not empty.  Returns the HF module."""
    cs = chip_smoke()
    path = str(path)
    model = {"flant5": lambda: hf_blip2("flant5", seed, vision_biases),
             "instructblip": lambda: hf_blip2("instructblip", seed, vision_biases),
             "kosmos2": lambda: hf_kosmos2(seed), "bakllava": lambda: hf_bakllava(seed)}[kind]()
    if kind == "flant5":
        cs.write_unigram_tokenizer(path, "t5", T5_VOCAB, n_extra=3)
        _image_config(path, "blip")
    elif kind == "instructblip":
        image_id, pad_id = write_llama_tokenizer(path, vocab_size=BPE_VOCAB)
        assert (image_id, pad_id) == (BPE_VOCAB, BPE_VOCAB + 1)
        cs.write_wordpiece_tokenizer(os.path.join(path, "qformer_tokenizer"),
                                     j_cfg.tiny_blip2_config("llama_text").qformer.vocab_size - 1)
        _image_config(path, "blip")
    elif kind == "kosmos2":
        cs.write_unigram_tokenizer(path, "xlmr", K2_VOCAB, n_patch=K2_PATCHES)
        with open(os.path.join(path, "processor_config.json"), "w") as f:
            json.dump({"processor_class": "Kosmos2Processor",
                       "num_patch_index_tokens": K2_PATCHES}, f)
        _image_config(path, "clip")
    else:
        image_id, pad_id = write_llama_tokenizer(path, vocab_size=BPE_VOCAB)
        assert (image_id, pad_id) == (BPE_VOCAB, BPE_VOCAB + 1)
    if quiet_specials:
        tok = transformers.AutoTokenizer.from_pretrained(path)
        with torch.no_grad():
            special = {i for i, t in tok.added_tokens_decoder.items() if t.special}
            model.get_output_embeddings().weight[sorted(special | set(tok.all_special_ids))] = 0.0
    model.save_pretrained(path, safe_serialization=True)
    return model


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree.numpy() if torch.is_tensor(tree) else np.asarray(tree)}


def _same_tree(mine, ref):
    """Every leaf of JAX's tree equal, bit for bit and in dtype, in the port's."""
    m, r = _flat(mine), _flat(ref)
    assert set(r) <= set(m), sorted(set(r) - set(m))
    for k, a in r.items():
        assert m[k].dtype == a.dtype and m[k].shape == a.shape and np.array_equal(m[k], a), k
    return sorted(set(m) - set(r))


def _same_as_files(path, state):
    """``state`` (an exporter's) holds exactly the snapshot's tensors."""
    files = read_safetensors(os.path.join(path, "model.safetensors"))
    assert sorted(state) == sorted(files)
    for k, v in files.items():
        assert state[k].dtype == v.dtype and torch.equal(state[k], v), k


def _rewrite(path, change):
    """Rewrite the snapshot's one shard through ``change(tensors)``, as a
    new file (the port's reader maps the old one, and trees read from it
    may still view its pages)."""
    f = os.path.join(path, "model.safetensors")
    tensors = {k: v.clone() for k, v in read_safetensors(f).items()}
    change(tensors)
    write_safetensors(tensors, f + ".new", {"format": "pt"})
    os.replace(f + ".new", f)


def test_blip2_flant5_snapshot_matches_jax_import(tmp_path):
    """The port's tree equals ``import_blip2_torch``'s on the live module,
    plus the vision biases JAX drops; with them the port's vision tower
    matches transformers' (JAX's tree cannot).  The tied T5 embedding read
    from whichever name holds it; a missing key and an unread key raise."""
    hf = write_snapshot(tmp_path, "flant5", seed=1, vision_biases=True)
    jcfg, tcfg = tiny_blip2("flant5", j_cfg), tiny_blip2("flant5", t_cfg)
    ref = import_blip2_torch(hf, jcfg)
    zi.check_blip2_config(str(tmp_path), tcfg)
    mine = zi.load_blip2_safetensors(str(tmp_path), tcfg)
    assert _same_tree(mine, ref) == ["/vision/layers/qkv_b", "/vision/patch_b"]
    _same_as_files(str(tmp_path), zi.blip2_to_hf_state_dict(mine, tcfg))
    sd = hf.state_dict()
    assert torch.equal(mine["vision"]["patch_b"],
                       sd["vision_model.embeddings.patch_embedding.bias"])
    assert mine["vision"]["layers"]["qkv_b"].abs().max() > 0
    pix = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 3, 28, 28)).astype(np.float32))
    with torch.no_grad():
        want = hf.vision_model(pixel_values=pix).last_hidden_state
    got = blip2_vision_forward(mine["vision"], tcfg.vision, pix)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    jax_tree = blip2_params_from_numpy(ref, "cpu")
    off = (blip2_vision_forward(jax_tree["vision"], tcfg.vision, pix) - want).abs().max()
    assert off > 1e-2     # JAX's tree without the biases misses transformers' tower

    # the tied embedding under the encoder's name instead of shared's
    def rename(t):
        t["language_model.encoder.embed_tokens.weight"] = t.pop("language_model.shared.weight")
    _rewrite(str(tmp_path), rename)
    again = zi.load_blip2_safetensors(str(tmp_path), tcfg)
    assert torch.equal(again["language_model"]["embed_tokens"],
                       mine["language_model"]["embed_tokens"])
    _rewrite(str(tmp_path), lambda t: t.update(stray=torch.zeros(2)))
    with pytest.raises(ValueError, match="stray.*model.safetensors"):
        zi.load_blip2_safetensors(str(tmp_path), tcfg)
    _rewrite(str(tmp_path), lambda t: (t.pop("stray"), t.pop("language_projection.bias")))
    with pytest.raises(KeyError, match="language_projection.bias"):
        zi.load_blip2_safetensors(str(tmp_path), tcfg)
    # a Q-Former without text weights cannot serve the text-input config
    text_in = dataclasses.replace(tcfg, qformer=dataclasses.replace(tcfg.qformer,
                                                                    use_text_input=True))
    with pytest.raises(ValueError, match="word_embeddings.*Blip2ForConditionalGeneration"):
        zi.load_blip2_safetensors(str(tmp_path), text_in)


def test_instructblip_snapshot_matches_jax_import(tmp_path):
    """InstructBLIP: the text-input Q-Former's embeddings, the Vicuna tower;
    q / v biases stored the older way (``q_bias``, ``v_bias``) read alike;
    an lm_head left out of the files re-tied to the embedding."""
    hf = write_snapshot(tmp_path, "instructblip", seed=2, vision_biases=True)
    jcfg, tcfg = tiny_blip2("instructblip", j_cfg), tiny_blip2("instructblip", t_cfg)
    ref = import_blip2_torch(hf, jcfg)
    zi.check_blip2_config(str(tmp_path), tcfg)
    mine = zi.load_blip2_safetensors(str(tmp_path), tcfg)
    assert _same_tree(mine, ref) == ["/vision/layers/qkv_b", "/vision/patch_b"]
    _same_as_files(str(tmp_path), zi.blip2_to_hf_state_dict(mine, tcfg))
    D = tcfg.vision.hidden_size

    def older(t):
        for i in range(tcfg.vision.num_hidden_layers):
            b = t.pop(f"vision_model.encoder.layers.{i}.self_attn.qkv.bias")
            t[f"vision_model.encoder.layers.{i}.self_attn.q_bias"] = b[:D].clone()
            t[f"vision_model.encoder.layers.{i}.self_attn.v_bias"] = b[2 * D:].clone()
        t.pop("language_model.lm_head.weight")
    _rewrite(str(tmp_path), older)
    again = zi.load_blip2_safetensors(str(tmp_path), tcfg)
    assert torch.equal(again["vision"]["layers"]["qkv_b"], mine["vision"]["layers"]["qkv_b"])
    lm = again["language_model"]
    assert torch.equal(lm["lm_head"], lm["embed_tokens"].T)


def test_kosmos2_snapshot_matches_jax_import(tmp_path):
    """KOSMOS-2 bit for bit; its tied lm_head (absent from the files) is
    the embedding; an lm_head stored apart with other values raises."""
    hf = write_snapshot(tmp_path, "kosmos2", seed=3)
    ref = j_k2.import_kosmos2_torch(hf, tiny_kosmos2(j_k2))
    tcfg = tiny_kosmos2(t_k2)
    zi.check_kosmos2_config(str(tmp_path), tcfg)
    mine = zi.load_kosmos2_safetensors(str(tmp_path), tcfg)
    assert _same_tree(mine, ref) == []
    _same_as_files(str(tmp_path), zi.kosmos2_to_hf_state_dict(mine, tcfg))
    emb = mine["embed_tokens"]
    _rewrite(str(tmp_path), lambda t: t.update({"text_model.lm_head.weight": emb.clone()}))
    zi.load_kosmos2_safetensors(str(tmp_path), tcfg)
    _rewrite(str(tmp_path), lambda t: t.update({"text_model.lm_head.weight": emb + 1.0}))
    with pytest.raises(ValueError, match="lm_head"):
        zi.load_kosmos2_safetensors(str(tmp_path), tcfg)


def test_config_json_is_held_to_the_published_config(tmp_path):
    """The port builds the published configuration, as JAX hard-codes it,
    and refuses a snapshot whose config.json disagrees (a field left out
    takes its default)."""
    write_snapshot(tmp_path / "b", "flant5")
    write_snapshot(tmp_path / "k", "kosmos2")
    tiny = tiny_blip2("flant5", t_cfg)
    with pytest.raises(ValueError, match="num_query_tokens is 4, the port's config has 32"):
        zi.check_blip2_config(str(tmp_path / "b"), t_cfg.blip2_flant5xl_config())
    with pytest.raises(ValueError, match="vision_config.hidden_size"):
        zi.check_blip2_config(str(tmp_path / "b"), dataclasses.replace(
            tiny, vision=dataclasses.replace(tiny.vision, hidden_size=64)))
    with pytest.raises(ValueError, match="text_config.d_model"):
        zi.check_blip2_config(str(tmp_path / "b"), dataclasses.replace(
            tiny, text=dataclasses.replace(tiny.text, d_model=64)))
    with pytest.raises(ValueError, match="latent_query_num"):
        zi.check_kosmos2_config(str(tmp_path / "k"), t_k2.tiny_kosmos2_config())
    with open(tmp_path / "k" / "config.json") as f:
        hf = json.load(f)
    del hf["text_config"]["embed_dim"]
    with open(tmp_path / "k" / "config.json", "w") as f:
        json.dump(hf, f)
    zi.check_kosmos2_config(str(tmp_path / "k"), tiny_kosmos2(t_k2))


def test_kosmos2_processor_matches_transformers(tmp_path):
    """Input ids and ``image_embeds_position_mask`` exact; pixels exact for
    an image at the crop size and within one uint8 step (1 / 255 over the
    smallest std) of PIL's resize at sizes that need one."""
    from PIL import Image

    write_snapshot(tmp_path, "kosmos2")
    proc = transformers.AutoProcessor.from_pretrained(str(tmp_path))
    mine = Kosmos2Processor(str(tmp_path))
    rng = np.random.default_rng(4)
    step = 1.0 / 255.0 / min(CLIP_STD) + 1e-6
    worst = 0.0
    for hw, q in (((28, 28), "What is the color of the car?"),
                  ((40, 40), "  How many dogs are there?  "),
                  ((30, 50), "Is the man riding a bicycle? <grounding>x"),
                  ((56, 44), "ｗｈａｔ ﬁ café…"), ((100, 37), "")):
        im = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
        text = f"Question: {q} Answer:"
        enc = proc(images=Image.fromarray(im), text=text, return_tensors="np")
        ids, attn, img_mask, pix = mine(im, text)
        np.testing.assert_array_equal(ids, enc["input_ids"])
        np.testing.assert_array_equal(attn, enc["attention_mask"])
        np.testing.assert_array_equal(img_mask, enc["image_embeds_position_mask"])
        err = float(np.abs(pix - enc["pixel_values"]).max())
        assert err == 0.0 if hw == (28, 28) else err <= step, (hw, err)
        worst = max(worst, err)
    assert worst > 0.0      # a resize does move a pixel: the bound is not vacuous
    assert mine.tokenizer.decode(ids[0], skip_special_tokens=True) == proc.tokenizer.decode(
        enc["input_ids"][0], skip_special_tokens=True)


def _mistral(window):
    j = dataclasses.replace(j_lcfg.tiny_llava_config(64).text, sliding_window=window)
    t = dataclasses.replace(t_lcfg.tiny_llava_config(64).text, sliding_window=window)
    assert (j.num_attention_heads, j.num_key_value_heads) == (4, 2)     # GQA
    return j, t


@pytest.mark.parametrize("window", [5, 30], ids=["binding", "wider"])
def test_sliding_window_matches_jax(window):
    """``llama_forward`` with Mistral's window (4 heads over 2 kv heads):
    a right-padded 12-token prefill that builds a 20-slot cache (the window
    binds at W = 5: plain attention with the bias, counted in
    ``window_prefills``; at W = 30 it cannot: the flash path), then three
    stale-cache decode steps, against JAX's within 1e-4 at f32; at W = 5
    the result differs from a run without the window."""
    jc, tc = _mistral(window)
    tree = jax.tree.map(np.asarray, j_llama.init_llama_params(jc, jax.random.PRNGKey(5)))
    tparams = blip2_params_from_numpy(tree, "cpu")
    rng = np.random.default_rng(6)
    B, T, S, D = 2, 12, 20, jc.hidden_size
    emb = rng.normal(size=(B, T, D)).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[1, -3:] = 0
    pos = np.maximum(np.cumsum(mask, 1) - 1, 0).astype(np.int32)
    n0 = t_llama.llama_forward.window_prefills
    jh, jcache = j_llama.llama_forward(tree, jc, jnp.asarray(emb), jnp.asarray(mask),
                                       jnp.asarray(pos), prefill_pad_len=S)
    th, tcache = t_llama.llama_forward(tparams, tc, torch.from_numpy(emb), torch.from_numpy(mask),
                                       torch.from_numpy(pos), prefill_pad_len=S)
    assert t_llama.llama_forward.window_prefills - n0 == (1 if window < T else 0)
    valid = mask.astype(bool)
    np.testing.assert_allclose(th.numpy()[valid], np.asarray(jh)[valid], atol=1e-4, rtol=1e-4)
    if window < T:
        _, free = _mistral(None)
        plain, _ = t_llama.llama_forward(tparams, free, torch.from_numpy(emb),
                                         torch.from_numpy(mask), torch.from_numpy(pos))
        assert (plain - th).abs().max() > 1e-3
    full_mask = np.zeros((B, S), np.int32)
    full_mask[:, :T] = mask
    key_pos = np.zeros((B, S), np.int32)
    key_pos[:, :T] = pos
    cur = mask.sum(1).astype(np.int32)
    for step in range(3):
        x = rng.normal(size=(B, 1, D)).astype(np.float32)
        p = cur[:, None].copy()
        jh, jcache = j_llama.llama_forward(tree, jc, jnp.asarray(x), jnp.asarray(full_mask),
                                           jnp.asarray(p), jcache, jnp.int32(T + step),
                                           jnp.asarray(key_pos), stale_cache=True)
        th, tcache = t_llama.llama_forward(tparams, tc, torch.from_numpy(x),
                                           torch.from_numpy(full_mask), torch.from_numpy(p),
                                           tcache, T + step, torch.from_numpy(key_pos),
                                           stale_cache=True)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=1e-4)
        full_mask[:, T + step] = 1
        key_pos[:, T + step] = cur
        cur = cur + 1
    # the slots the decode reads (the flash prefill's padded rows attend
    # padded keys, which the bias hides from JAX's; no later step reads them)
    slots = full_mask.T.astype(bool)                      # [S, B]
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy()[:, slots],
                                   np.asarray(jcache[name])[:, slots], atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="flash kernel takes no window"):
        t_llama.llama_forward(tparams, _mistral(5)[1], torch.from_numpy(emb),
                              torch.from_numpy(mask), torch.from_numpy(pos), use_flash=True)


def test_bakllava_config_matches_jax():
    j, t = j_lcfg.bakllava_config(), t_lcfg.bakllava_config()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (t.text.num_attention_heads // t.text.num_key_value_heads, t.text.sliding_window,
            t.text.intermediate_size, t.text.vocab_size) == (4, 4096, 14336, 32064)
