"""The CLIP BPE tokenizer of the X-Decoder's text encoder (``MODEL.TEXT.
TOKENIZER``), read by the port's own code where the JAX package goes
through ``transformers.CLIPTokenizerFast.from_pretrained`` (the machine
with the card has neither transformers nor tokenizers).

``CLIPTokenizer.from_dir(path)`` reads HF's CLIP layout: ``tokenizer.json``
when the directory has one, else ``vocab.json`` + ``merges.txt`` (the first
line of ``merges.txt`` is its ``#version`` header; at most 48894 merges, as
transformers' slow CLIP tokenizer reads them).  Encoding follows the
``tokenizers`` pipeline that transformers builds for CLIP:

* the special tokens ``<|startoftext|>`` / ``<|endoftext|>`` are split out of
  the normalized text (leftmost, longest) and keep their ids;
* normalizer: NFC, each run of Unicode white space to one space, lowercase;
* pre-tokenizer: CLIP's pattern ``'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|
  [^\\s\\p{L}\\p{N}]+`` (white space dropped), scanned here with the
  character classes of ``unicodedata`` (Python's ``re`` has no ``\\p{..}``);
  then GPT-2's byte-to-character map of each piece's UTF-8 bytes;
* model BPE: the piece's characters, the last one with the ``</w>``
  suffix, a character without a token as the unk id, then merges by rank,
  the leftmost pair first;
* ``<|startoftext|>`` before and ``<|endoftext|>`` after the text.

``__call__(texts, context_length)`` gives ``(ids, mask)`` int32 ``[N,
context_length]`` as ``tokenizer(texts, padding="max_length",
truncation=True, max_length=context_length)`` does: the text truncated to
``context_length - 2`` tokens (the end token kept), padded with the pad
token (``<|endoftext|>``), the mask 1 over the tokens.  ``decode`` is the
fast tokenizer's: tokens joined, mapped back to bytes (invalid UTF-8 as
U+FFFD), ``</w>`` as a space, stripped.

A ``tokenizer.json`` option this reader does not implement raises
``NotImplementedError`` naming it: nothing falls back quietly.
"""
from __future__ import annotations

import functools
import json
import os
import unicodedata

import numpy as np

BOS, EOS = "<|startoftext|>", "<|endoftext|>"
SUFFIX = "</w>"
MAX_MERGES = 49152 - 256 - 2      # the merges transformers' slow CLIP tokenizer reads
CLIP_PATTERN = r"""'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# the Unicode White_Space property, the set \s names in the tokenizers library
WHITE_SPACE = frozenset([*range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
                         0x2028, 0x2029, 0x202F, 0x205F, 0x3000])


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict:
    """GPT-2's byte -> printable character map of byte-level BPE."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _is_space(ch: str) -> bool:
    return ord(ch) in WHITE_SPACE


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "L"


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "N"


def normalize(text: str) -> str:
    """NFC, each run of white space to one space, lowercase."""
    text = unicodedata.normalize("NFC", text)
    out, in_space = [], False
    for ch in text:
        if _is_space(ch):
            if not in_space:
                out.append(" ")
            in_space = True
        else:
            out.append(ch)
            in_space = False
    # character by character, as the tokenizers library lowercases (no
    # final-sigma rule)
    return "".join(ch.lower() for ch in out)


def split_pieces(text: str) -> list:
    """The matches of ``CLIP_PATTERN`` in ``text``, left to right."""
    out, i, n = [], 0, len(text)
    while i < n:
        ch = text[i]
        hit = next((c for c in CONTRACTIONS if text.startswith(c, i)), None) if ch == "'" else None
        if hit is not None:
            j = i + len(hit)
        elif _is_letter(ch):
            j = i + 1
            while j < n and _is_letter(text[j]):
                j += 1
        elif _is_number(ch):
            j = i + 1
        elif not _is_space(ch):
            j = i + 1
            while j < n and not (_is_space(text[j]) or _is_letter(text[j])
                                 or _is_number(text[j])):
                j += 1
        else:
            i += 1
            continue
        out.append(text[i:j])
        i = j
    return out


def _expect(cond: bool, what: str):
    if not cond:
        raise NotImplementedError(f"tokenizer.json: {what} (only HF's CLIP layout)")


class CLIPTokenizer:
    """A CLIP BPE vocabulary and its merges (see the module docstring)."""

    def __init__(self, vocab: dict, merges: list):
        self.vocab = dict(vocab)
        for tok in (BOS, EOS):
            if tok not in self.vocab:
                raise ValueError(f"the vocabulary has no {tok}")
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.ranks = {}
        for rank, (a, b) in enumerate(merges):
            if a + b not in self.vocab or a not in self.vocab or b not in self.vocab:
                raise ValueError(f"merge {a!r} {b!r}: a part or the result has no token")
            self.ranks.setdefault((a, b), rank)
        self.bos_token_id = self.vocab[BOS]
        self.eos_token_id = self.pad_token_id = self.unk_token_id = self.vocab[EOS]
        self.special = {BOS: self.bos_token_id, EOS: self.eos_token_id}
        self._byte_char = bytes_to_unicode()
        self._char_byte = {c: b for b, c in self._byte_char.items()}
        self._cache: dict = {}

    @classmethod
    def from_dir(cls, path: str) -> "CLIPTokenizer":
        tok_json = os.path.join(path, "tokenizer.json")
        if os.path.exists(tok_json):
            with open(tok_json, encoding="utf-8") as f:
                return cls._from_tokenizer_json(json.load(f))
        vocab_path, merges_path = (os.path.join(path, n) for n in ("vocab.json", "merges.txt"))
        for p in (vocab_path, merges_path):
            if not os.path.exists(p):
                raise FileNotFoundError(f"no tokenizer.json and no {os.path.basename(p)} under "
                                        f"{path}: MODEL.TEXT.TOKENIZER names HF's CLIP layout")
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_path, encoding="utf-8") as f:
            lines = f.read().strip().split("\n")
        if not lines[0].startswith("#version"):
            raise ValueError(f"{merges_path}: the first line is not a '#version' header (the "
                             "reference's reader skips it as one)")
        if len(lines) - 1 > MAX_MERGES:
            raise ValueError(f"{merges_path}: {len(lines) - 1} merges, more than the "
                             f"{MAX_MERGES} the reference's reader takes")
        return cls(vocab, [tuple(line.split()) for line in lines[1:]])

    @classmethod
    def _from_tokenizer_json(cls, spec: dict) -> "CLIPTokenizer":
        norm = spec.get("normalizer") or {}
        steps = [(s.get("type"), s.get("pattern"), s.get("content"))
                 for s in norm.get("normalizers", [])] if norm.get("type") == "Sequence" else []
        _expect(steps == [("NFC", None, None), ("Replace", {"Regex": r"\s+"}, " "),
                          ("Lowercase", None, None)], f"normalizer {norm!r}")
        pre = spec.get("pre_tokenizer") or {}
        pres = pre.get("pretokenizers", []) if pre.get("type") == "Sequence" else []
        _expect(len(pres) == 2 and pres[0].get("type") == "Split"
                and pres[0].get("pattern") == {"Regex": CLIP_PATTERN}
                and pres[0].get("behavior") == "Removed" and pres[0].get("invert") is True,
                f"pre_tokenizer {pre!r}")
        _expect(pres[1].get("type") == "ByteLevel" and not pres[1].get("add_prefix_space")
                and pres[1].get("use_regex", True), f"pre_tokenizer {pres[1]!r}")
        model = spec.get("model") or {}
        _expect(model.get("type") == "BPE" and model.get("end_of_word_suffix") == SUFFIX
                and not model.get("continuing_subword_prefix") and model.get("dropout") is None
                and not model.get("fuse_unk") and not model.get("byte_fallback")
                and not model.get("ignore_merges") and model.get("unk_token") == EOS,
                f"model {({k: v for k, v in model.items() if k not in ('vocab', 'merges')})!r}")
        post = spec.get("post_processor") or {}
        vocab = model["vocab"]
        _expect(post.get("type") == "RobertaProcessing"
                and list(post.get("cls", [])) == [BOS, vocab.get(BOS)]
                and list(post.get("sep", [])) == [EOS, vocab.get(EOS)],
                f"post_processor {post!r}")
        _expect((spec.get("decoder") or {}).get("type") == "ByteLevel",
                f"decoder {spec.get('decoder')!r}")
        for t in spec.get("added_tokens", []):
            _expect(t.get("content") in (BOS, EOS) and vocab.get(t["content"]) == t.get("id")
                    and not (t.get("lstrip") or t.get("rstrip") or t.get("single_word")),
                    f"added token {t!r}")
        merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
                  for m in model["merges"]]
        return cls(vocab, merges)

    def _bpe(self, word: str) -> list:
        """One pre-token's ids (``word`` already in byte characters)."""
        if word in self._cache:
            return self._cache[word]
        syms = list(word)
        syms[-1] += SUFFIX
        while len(syms) > 1:
            best, at = None, -1
            for j in range(len(syms) - 1):
                rank = self.ranks.get((syms[j], syms[j + 1]))
                if rank is not None and (best is None or rank < best):
                    best, at = rank, j
            if best is None:
                break
            syms[at:at + 2] = [syms[at] + syms[at + 1]]
        ids = [self.vocab.get(s, self.unk_token_id) for s in syms]
        self._cache[word] = ids
        return ids

    def _split_special(self, text: str) -> list:
        """[(piece, special id or None)], the special tokens matched leftmost, longest."""
        out, start, i = [], 0, 0
        while i < len(text):
            hit = next((t for t in (BOS, EOS) if text.startswith(t, i)), None)
            if hit is None:
                i += 1
                continue
            if i > start:
                out.append((text[start:i], None))
            out.append((hit, self.special[hit]))
            i = start = i + len(hit)
        if start < len(text):
            out.append((text[start:], None))
        return out

    def encode(self, text: str) -> list:
        """The text's ids, without the start and end tokens."""
        ids = []
        for piece, special in self._split_special(normalize(text)):
            if special is not None:
                ids.append(special)
                continue
            for word in split_pieces(piece):
                ids.extend(self._bpe("".join(self._byte_char[b] for b in word.encode("utf-8"))))
        return ids

    def __call__(self, texts, context_length: int = 77):
        """(ids, mask) int32 [len(texts), context_length]; see the module docstring."""
        ids = np.full((len(texts), context_length), self.pad_token_id, np.int32)
        mask = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            row = [self.bos_token_id] + self.encode(text)[:context_length - 2] + [
                self.eos_token_id]
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return ids, mask

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        special = set(self.special.values())
        toks = [self.id_to_token[int(i)] for i in np.asarray(ids).reshape(-1).tolist()
                if not (skip_special_tokens and int(i) in special)]
        out = bytearray()
        for tok in toks:
            if tok in self.special:
                out.extend(tok.encode("utf-8"))
            else:
                out.extend(self._char_byte[c] for c in tok)
        return out.decode("utf-8", errors="replace").replace(SUFFIX, " ").strip()
