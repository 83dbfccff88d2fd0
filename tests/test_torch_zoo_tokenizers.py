"""The port's readers of the VL zoo's tokenizers (``data/tokenizer_json.py``)
against the ``tokenizers`` library and transformers' fast tokenizers, on
``tokenizer.json`` files written here by ``chip_smoke``'s writers: Flan-T5's
Unigram (the Precompiled normalizer, WhitespaceSplit + Metaspace, "$A
</s>"), KOSMOS-2's XLM-R Unigram (its added tag tokens, Precompiled +
Replace(Regex), "<s> $A </s>"), InstructBLIP's BERT-uncased WordPiece with
``[DEC]``; each at a tiny size and at the published size (32128, 65037,
30522 + [DEC]).  Ids are token-exact and ``decode`` equal on a fixed list of
strings (empty, whitespace runs, unknown characters, accents, full-width
letters, ligatures, combining marks, the added tokens); the charsmap writer's
blobs are held against ``tokenizers.normalizers.Precompiled``; what the
readers do not read raises.
"""
import base64
import json
import os

import numpy as np
import pytest

import transformers
from tokenizers import Tokenizer, normalizers

from cullavo_tpu_torch.data import tokenizer_json as tj
from test_torch_joint_data import chip_smoke

STRINGS = ["", " ", "   ", "\t\n", "Question: What is the color of the car? Short answer:",
           "What  is\tthe\n\ncolor?", "Ｗｈａｔ ｉｓ ｔｈｉｓ？", "ﬁne ﬂowers ﬃ…",
           "café naïve", "crème brûlée Ångström", "café naïve ñ",
           "☃ snowman ☃☃ x", "日本語のテキスト", "Á̂ stacked marks", "é́",
           "<image> <image></image> Question: what? Answer:", "<grounding>An image of",
           "  leading and trailing  ", "don't you're it's", "UPPER lower MiXeD",
           "1234 5678", "hello world　x y", "<s>hi</s>", "[CLS] x [SEP] [DEC] [dec]",
           "tm™ <mask> a<mask>b", "Is the man riding a bicycle?"]


@pytest.fixture(scope="module")
def cs():
    return chip_smoke()


def _agree(path, strings=STRINGS):
    """The port's ids and decodes against transformers' and the library's."""
    mine = tj.TokenizerJSON(path)
    lib = Tokenizer.from_file(os.path.join(path, "tokenizer.json"))
    hf = transformers.AutoTokenizer.from_pretrained(path)
    assert hf.is_fast
    for s in strings:
        ids = mine.encode(s)
        assert ids == hf(s)["input_ids"] == lib.encode(s).ids, s
        assert mine.encode(s, add_special_tokens=False) == hf(
            s, add_special_tokens=False)["input_ids"], s
        for skip in (True, False):
            assert mine.decode(ids, skip_special_tokens=skip) == hf.decode(
                ids, skip_special_tokens=skip), (s, skip)
    return mine, hf


@pytest.mark.parametrize("n_vocab,n_extra", [(160, 3), (32128, 100)], ids=["tiny", "published"])
def test_unigram_t5_matches_the_library(cs, tmp_path, n_vocab, n_extra):
    ids = cs.write_unigram_tokenizer(str(tmp_path), "t5", n_vocab, n_extra=n_extra)
    mine, hf = _agree(str(tmp_path))
    assert len(hf) == n_vocab and len(mine.model.pieces) == n_vocab - n_extra
    assert (mine.eos_token_id, mine.pad_token_id, mine.unk_token_id) == (
        hf.eos_token_id, hf.pad_token_id, hf.unk_token_id) == (ids["</s>"], 0, 2)
    # a random id sequence over the whole vocabulary decodes alike
    rng = np.random.default_rng(0)
    seq = rng.integers(0, n_vocab, 40).tolist()
    assert mine.decode(seq) == hf.decode(seq, skip_special_tokens=True)


@pytest.mark.parametrize("n_vocab,n_patch", [(300, 4), (65037, 1024)], ids=["tiny", "published"])
def test_unigram_xlmr_with_kosmos2_tokens(cs, tmp_path, n_vocab, n_patch):
    cs.write_unigram_tokenizer(str(tmp_path), "xlmr", n_vocab, n_patch=n_patch)
    extra = ["<patch_index_0000> <object><phrase>a dog</phrase></object>",
             f"<patch_index_{n_patch - 1:04d}>x"]
    mine, hf = _agree(str(tmp_path), STRINGS + extra)
    assert len(hf) == n_vocab
    assert hf.convert_tokens_to_ids("<mask>") == mine.token_to_id("<mask>")


def test_wordpiece_bert_with_dec(cs, tmp_path):
    for n in (98, 30522):
        path = str(tmp_path / str(n))
        ids = cs.write_wordpiece_tokenizer(path, n)
        mine, hf = _agree(path, STRINGS + ["x" * 120, "supercalifragilistic giraffes"])
        assert len(hf) == n + 1 and ids["[DEC]"] == n == hf.convert_tokens_to_ids("[DEC]")
        texts = [f"This is {c}" for c in ("a cat", "a giraffe", "the kite", "x")]
        got_ids, got_mask = mine(texts)
        enc = hf(texts, padding=True, return_tensors="np")
        np.testing.assert_array_equal(got_ids, enc["input_ids"])
        np.testing.assert_array_equal(got_mask, enc["attention_mask"])


def test_charsmap_writer_against_the_library(cs):
    """Blobs of the port's writer read by the library and by the port alike:
    full-width, ligature and combining-mark pairs, keys that prefix other
    keys (the library takes the shortest match within a grapheme cluster),
    clusters of six bytes or more (character by character), CR LF,
    Hangul and regional indicators."""
    pairs = dict(cs.charsmap_pairs())
    pairs.update({"ab": "Q", "a": "R", "\uff21\u0301": "X", "e\u0301\u0301": "Z",
                  "\r\n": "N", "\U0001F1EB\U0001F1F7": "FR", "\uac00": "GA"})
    blob = tj.write_charsmap(pairs)
    lib = normalizers.Precompiled(blob)
    mine = tj.Charsmap(blob)
    tests = list(pairs) + STRINGS + [
        "ab", "abc", "\uff21\u0301", "\uff21\u0301\u0302\u0303", "e\u0301\u0301",
        "x\r\ny", "\r\r\n", "\U0001F1EB\U0001F1F7\U0001F1EB", "\uac01",
        "\u1100\u1161\u11a8", "\U0001F468\u200d\U0001F469 family",
        "\uff46\uff55\uff4c\uff4c\u0301", "a\u0300\u0327"]
    for s in tests:
        assert mine.normalize(s) == lib.normalize_str(s), s
    # the published layout: a u32 size, the units, the pool
    size = int.from_bytes(blob[:4], "little")
    assert size % 1024 == 0 and blob[4 + size:].endswith(b"\0")
    # the tokenizer.json form is base64 of the same bytes
    spec = {"type": "Precompiled", "precompiled_charsmap": base64.b64encode(blob).decode()}
    fn = tj._normalizer(spec, "test")
    assert fn("Ｗｈａｔ ﬁ") == lib.normalize_str("Ｗｈａｔ ﬁ") == "What fi"


def test_what_the_readers_do_not_read_raises(cs, tmp_path):
    path = str(tmp_path)
    cs.write_unigram_tokenizer(path, "t5", 160, n_extra=3)
    tok_path = os.path.join(path, "tokenizer.json")
    with open(tok_path) as f:
        spec = json.load(f)

    def rewrite(change, match, config=None):
        s = json.loads(json.dumps(spec))
        change(s)
        with open(tok_path, "w") as f:
            json.dump(s, f)
        if config is not None:
            with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
                json.dump(config, f)
        with pytest.raises((NotImplementedError, ValueError), match=match):
            tj.TokenizerJSON(path)

    rewrite(lambda s: s["model"].update(byte_fallback=True), "byte_fallback")
    rewrite(lambda s: s["pre_tokenizer"]["pretokenizers"][1].update(prepend_scheme="first"),
            "Metaspace")
    rewrite(lambda s: s.update(normalizer={"type": "NFKC"}), "NFKC")
    rewrite(lambda s: s.update(decoder={"type": "ByteLevel"}), "ByteLevel")
    rewrite(lambda s: s["added_tokens"][0].update(single_word=True), "single_word")
    rewrite(lambda s: s.update(post_processor={"type": "RobertaProcessing"}),
            "RobertaProcessing")
    rewrite(lambda s: s["model"].update(type="BPE"), "BPE")
    rewrite(lambda s: None, "pad_token", {"tokenizer_class": "T5Tokenizer",
                                          "pad_token": "<nothere>", "extra_ids": 0})
    rewrite(lambda s: None, "tokenizer_class", {"tokenizer_class": "GPT2Tokenizer"})
    with pytest.raises(FileNotFoundError):
        tj.TokenizerJSON(str(tmp_path / "missing"))
