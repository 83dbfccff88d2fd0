"""The port's CLIP BPE tokenizer (``cullavo_tpu_torch/data/clip_tokenizer.py``)
against ``transformers.CLIPTokenizerFast`` on a vocabulary and merges this
file writes with ``chip_smoke.write_clip_tokenizer``: ids and attention
masks equal id for id (non-Latin letters, digits, contractions,
punctuation and white-space runs, a text past the context length, the
special tokens in the text), the ``tokenizer.json`` form read the same,
``decode`` equal, and the entry's ``MODEL.TEXT.TOKENIZER`` path equal to
the JAX entry's (which goes through ``CLIPTokenizerFast``)."""
import json
import os

import numpy as np
import pytest
from transformers import CLIPTokenizerFast

import cullavo_tpu.entry as jentry
import cullavo_tpu_torch.entry as tentry
from cullavo_tpu.models.xdecoder.text_encoder import TextEncoderConfig
from cullavo_tpu_torch.data import clip_tokenizer as ct
from cullavo_tpu_torch.utils import constants
from test_torch_joint_data import chip_smoke

N_IDS = 4096   # a smaller vocabulary than CLIP's 49408: transformers converts it in < 1 s
TEXTS = [
    "a photo of a dog.",
    "A PHOTO of the  cat's   toy!!",
    "Ünïcödé café naïve — résumé",
    "日本語のテキスト 東京 2024年",
    "Ελληνικά ΟΔΟΣ σοφία and русский текст",
    "we'll they're I'm you've he'd it's don't 'S",
    "'s 's' ''s ''' x'y",
    "x1y2z3 123456 ½ ² Ⅻ ٣",
    "tabs\tand\nnewlines\r\n and nbsp em ideographic　space",
    "   leading and trailing   ",
    "",
    "!!!...,,,;;;??? (((]]] -- __ ~~",
    "<|endoftext|>the <|startoftext|>a",
    "emoji 😀🐶 and ZWJ 👨‍👩‍👧",
    "İstanbul ǅ ß ﬁ",
    "a photo of " * 40 + "the end",
    "\x1c\x1d separators \u0085next",
    "combining é vs é",
]


def _corpus():
    names = constants.COCO_PANOPTIC_CLASSES + constants.ADE_PANOPTIC_CLASSES[:40]
    return ([t.format(n) for n in names for t in constants.get_prompt_templates()[:2]]
            + constants.get_prompt_templates())


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clip_vocab"))
    learned = chip_smoke().write_clip_tokenizer(path, _corpus(), n_ids=N_IDS)
    assert learned > 100
    return path


@pytest.fixture(scope="module")
def hf(vocab_dir):
    return CLIPTokenizerFast.from_pretrained(vocab_dir)


@pytest.mark.parametrize("context", [77, 16])
def test_ids_and_masks_equal_clip_tokenizer_fast(vocab_dir, hf, context):
    mine = ct.CLIPTokenizer.from_dir(vocab_dir)
    want = hf(TEXTS, padding="max_length", truncation=True, max_length=context,
              return_tensors="np")
    ids, mask = mine(TEXTS, context)
    assert ids.dtype == mask.dtype == np.int32 and ids.shape == (len(TEXTS), context)
    for i, text in enumerate(TEXTS):
        assert ids[i].tolist() == want["input_ids"][i].tolist(), text
        assert mask[i].tolist() == want["attention_mask"][i].tolist(), text
    assert mine.bos_token_id == hf.bos_token_id and mine.pad_token_id == hf.pad_token_id
    # the long text keeps its end token after truncation
    assert ids[TEXTS.index("a photo of " * 40 + "the end"), -1] == hf.eos_token_id


def test_tokenizer_json_reads_the_same_and_unknown_options_raise(vocab_dir, hf, tmp_path):
    hf.backend_tokenizer.save(str(tmp_path / "tokenizer.json"))
    mine = ct.CLIPTokenizer.from_dir(str(tmp_path))
    ids, mask = mine(TEXTS, 77)
    want = hf(TEXTS, padding="max_length", truncation=True, max_length=77, return_tensors="np")
    np.testing.assert_array_equal(ids, want["input_ids"])
    np.testing.assert_array_equal(mask, want["attention_mask"])
    spec = json.loads((tmp_path / "tokenizer.json").read_text())
    for edit in (lambda s: s["normalizer"]["normalizers"].pop(0),
                 lambda s: s["model"].update(end_of_word_suffix=None),
                 lambda s: s["model"].update(dropout=0.1),
                 lambda s: s["pre_tokenizer"]["pretokenizers"][0].update(behavior="Isolated"),
                 lambda s: s["decoder"].update(type="BPEDecoder"),
                 lambda s: s["added_tokens"].append(dict(s["added_tokens"][0], lstrip=True))):
        bad = json.loads(json.dumps(spec))
        edit(bad)
        (tmp_path / "tokenizer.json").write_text(json.dumps(bad))
        with pytest.raises(NotImplementedError, match="tokenizer.json"):
            ct.CLIPTokenizer.from_dir(str(tmp_path))


def test_decode_equals_clip_tokenizer_fast(vocab_dir, hf):
    mine = ct.CLIPTokenizer.from_dir(vocab_dir)
    for text in TEXTS:
        ids = hf(text)["input_ids"]
        assert mine.encode(text) == ids[1:-1], text
        for skip in (True, False):
            assert mine.decode(ids, skip_special_tokens=skip) == hf.decode(
                ids, skip_special_tokens=skip), text
    # a cut multi-byte character decodes to U+FFFD, as the fast tokenizer does
    ids = hf("😀")["input_ids"][1:-1]
    if len(ids) > 1:
        assert mine.decode(ids[:1]) == hf.decode(ids[:1])


def test_full_size_layout_and_merges_file_checks(tmp_path):
    """CLIP's size: 49408 ids, <|startoftext|> 49406, <|endoftext|> 49407,
    48894 merges; a merges file without its version header, or with more
    merges than the reference's reader takes, raises."""
    learned = chip_smoke().write_clip_tokenizer(str(tmp_path), _corpus()[:200])
    assert learned > 50
    with open(tmp_path / "vocab.json", encoding="utf-8") as f:
        vocab = json.load(f)
    assert len(vocab) == 49408 and vocab[ct.BOS] == 49406 and vocab[ct.EOS] == 49407
    tk = ct.CLIPTokenizer.from_dir(str(tmp_path))
    assert len(tk.ranks) == ct.MAX_MERGES == 48894
    ids, mask = tk(["a photo of a person."], 77)
    assert ids[0, 0] == 49406 and ids[0, mask[0].sum() - 1] == 49407 and ids[0, -1] == 49407
    lines = (tmp_path / "merges.txt").read_text(encoding="utf-8").splitlines()
    (tmp_path / "merges.txt").write_text("\n".join(lines[1:]) + "\n", encoding="utf-8")
    with pytest.raises(ValueError, match="version"):
        ct.CLIPTokenizer.from_dir(str(tmp_path))
    (tmp_path / "merges.txt").write_text("\n".join(lines + [lines[1]]) + "\n", encoding="utf-8")
    with pytest.raises(ValueError, match="48894"):
        ct.CLIPTokenizer.from_dir(str(tmp_path))
    os.remove(tmp_path / "merges.txt")
    with pytest.raises(FileNotFoundError, match="merges.txt"):
        ct.CLIPTokenizer.from_dir(str(tmp_path))


def test_entry_tokenize_matches_the_jax_entry(vocab_dir):
    """``MODEL.TEXT.TOKENIZER`` set: the port's tokenize equals the JAX
    entry's (``CLIPTokenizerFast``); unset: both use the md5 word hash."""
    text_cfg = TextEncoderConfig(context_length=77)
    texts = [t.format("traffic light") for t in constants.get_prompt_templates()] + TEXTS
    for model in ({"TEXT": {"TOKENIZER": vocab_dir}}, {}):
        cfg = {"MODEL": model}
        got = tentry._make_text_tokenize(cfg, text_cfg)(texts)
        want = jentry._make_text_tokenize(cfg, text_cfg)(texts)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    small = TextEncoderConfig(vocab_size=N_IDS - 1)
    with pytest.raises(ValueError, match="tokens for a text encoder"):
        tentry._make_text_tokenize({"MODEL": {"TEXT": {"TOKENIZER": vocab_dir}}}, small)
