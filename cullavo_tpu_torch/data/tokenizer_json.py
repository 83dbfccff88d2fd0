r"""The Unigram, WordPiece and byte-level BPE ``tokenizer.json`` families,
read by the port's own code (the machine with the card has neither
``tokenizers`` nor ``transformers`` nor ``sentencepiece`` nor ``regex``).

Scope: what the VL zoo's snapshots ship, with the semantics of the
``tokenizers`` library under transformers' fast tokenizers:

* ``T5TokenizerFast`` (Flan-T5: a Unigram model over SentencePiece pieces),
  ``XLMRobertaTokenizerFast`` (KOSMOS-2's text, the same model) and
  ``BertTokenizerFast`` (InstructBLIP's Q-Former, a WordPiece model; its
  ``[DEC]`` token is an added token) and ``GPT2TokenizerFast`` (BLIP-2
  OPT's, a byte-level BPE model);
* added tokens are split out of the raw text first (leftmost, longest; an
  ``lstrip`` / ``rstrip`` token takes the whitespace beside it), those
  marked ``normalized`` out of each normalized piece after, in their own
  normalized form;
* normalizers ``Precompiled`` (SentencePiece's charsmap, below), ``Replace``
  (a string, or a ``Regex`` run under Python's ``re``), ``Strip``,
  ``BertNormalizer`` and a ``Sequence`` of them;
* pre-tokenizers ``WhitespaceSplit``, ``Metaspace`` (replacement "▁",
  ``prepend_scheme`` "always" or "never", split or not; the legacy
  ``add_prefix_space`` form too), ``BertPreTokenizer``, ``ByteLevel`` (GPT-2's
  split, below, then each piece's UTF-8 bytes through GPT-2's byte-to-unicode
  map; ``add_prefix_space`` either way) and a ``Sequence``;
* models ``Unigram`` (Viterbi over the pieces' scores; an unknown character
  scores the lowest piece's score less 10; runs of unknown characters fuse
  into one ``unk_id``; no byte fallback) and ``WordPiece`` (greedy longest
  match, ``##`` continuations, ``max_input_chars_per_word``) and ``BPE``
  (GPT-2's merge loop: the adjacent pair of lowest merge rank, every
  occurrence left to right, until none merges; no dropout, prefixes or
  suffixes);
* post-processors ``TemplateProcessing`` (a single sequence: ``$A </s>``,
  ``<s> $A </s>``, ``[CLS] $A [SEP]``, OPT's ``</s> $A``), ``ByteLevel``
  (no ids of its own) and a ``Sequence`` of them;
* decoders ``Metaspace``, ``WordPiece`` and ``ByteLevel`` (the bytes back,
  invalid UTF-8 replaced); transformers' clean-up of tokenization spaces
  when ``tokenizer_config.json`` asks for it;
* ``padding=True``: right-padded to the longest row with the pad id.

Anything else in the files raises ``NotImplementedError`` naming the file
and the field; nothing falls back quietly.

The ``Precompiled`` normalizer: ``precompiled_charsmap`` (base64) is a
little-endian u32 byte size of a darts-clone double array, its u32 units,
then a pool of NUL-terminated normalized strings.  A unit holds a label
(bits 0-7; a value unit sets bit 31), a leaf flag (bit 8) and the offset
to its children (bits 10-30, shifted left by 8 when bit 9 is set); a child
for byte c of the node at ``p`` sits at ``p ^ offset ^ c``, and a key's
value unit (the pool offset) at ``p ^ offset`` of its last node.  The
library normalizes each grapheme cluster shorter than six bytes by the
normalized string of the SHORTEST key that prefixes it (the rest of the
cluster dropped), and otherwise each character of the cluster by a key
that prefixes it; ``write_charsmap`` builds such a blob from a table of
pairs (the tests and ``chip_smoke.py`` make their charsmaps with it).
Grapheme clusters follow UAX #29's rules for CR LF, controls, extending
and spacing marks, zero-width joiners, Hangul syllables and regional
indicator pairs.

GPT-2's split is the pattern ``'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|
?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+``, scanned by hand over ``unicodedata``
classes (``\s`` is Unicode's White_Space): a run of whitespace before a
non-space gives up its last character, which a following letter, digit or
other run takes when it is a plain space.
"""
from __future__ import annotations

import base64
import json
import os
import re
import struct
import unicodedata

import numpy as np

_SPACE = "\u2581"   # "▁", sentencepiece's word-boundary mark

# Unicode White_Space (what Rust's char::is_whitespace tests)
_WHITESPACE = frozenset("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005"
                        "\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000")


def _is_ws(c: str) -> bool:
    return c in _WHITESPACE


# -- grapheme clusters --------------------------------------------------------

def _gcb(c: str) -> str:
    """A character's grapheme-break class (the subset of UAX #29 above)."""
    cp = ord(c)
    if c == "\r":
        return "CR"
    if c == "\n":
        return "LF"
    if c == "\u200d":
        return "ZWJ"
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return "RI"
    if 0x1F3FB <= cp <= 0x1F3FF or c == "\u200c":
        return "Extend"
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return "L"
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return "V"
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return "T"
    if 0xAC00 <= cp <= 0xD7A3:
        return "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    cat = unicodedata.category(c)
    if cat in ("Mn", "Me"):
        return "Extend"
    if cat == "Mc":
        return "SpacingMark"
    if cat in ("Cc", "Zl", "Zp", "Cf"):
        return "Control"
    if cat == "So":
        return "Pict"
    return "Other"


def graphemes(text: str) -> list:
    """``text`` cut into extended grapheme clusters."""
    out: list = []
    prev, ri_run, pict_zwj = None, 0, False
    for c in text:
        cls = _gcb(c)
        join = False
        if prev is not None:
            if prev == "CR" and cls == "LF":
                join = True
            elif prev in ("CR", "LF", "Control") or cls in ("CR", "LF", "Control"):
                join = False
            elif prev == "L" and cls in ("L", "V", "LV", "LVT"):
                join = True
            elif prev in ("LV", "V") and cls in ("V", "T"):
                join = True
            elif prev in ("LVT", "T") and cls == "T":
                join = True
            elif cls in ("Extend", "ZWJ", "SpacingMark"):
                join = True
            elif prev == "ZWJ" and cls == "Pict" and pict_zwj:
                join = True
            elif prev == "RI" and cls == "RI" and ri_run % 2 == 1:
                join = True
        if join:
            out[-1] += c
        else:
            out.append(c)
        ri_run = ri_run + 1 if cls == "RI" else 0
        if cls == "Pict":
            pict_zwj = True
        elif cls not in ("Extend", "ZWJ"):
            pict_zwj = False
        prev = cls
    return out


# -- SentencePiece's precompiled charsmap -------------------------------------

class Charsmap:
    """A ``precompiled_charsmap`` blob (bytes), read: ``normalize(text)``."""

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("precompiled_charsmap: shorter than its 4-byte trie size")
        size = struct.unpack_from("<I", blob, 0)[0]
        if size % 4 or 4 + size > len(blob):
            raise ValueError(f"precompiled_charsmap: a trie of {size} bytes in a blob of "
                             f"{len(blob)}")
        self.units = struct.unpack_from(f"<{size // 4}I", blob, 4)
        self.pool = blob[4 + size:]

    def _prefix_values(self, key: bytes) -> list:
        """Pool offsets of every key that prefixes ``key``, shortest first."""
        units, out = self.units, []
        pos = (units[0] >> 10) << ((units[0] & (1 << 9)) >> 6)
        for c in key:
            if c == 0:
                break
            pos ^= c
            if pos >= len(units):
                break
            unit = units[pos]
            if (unit & ((1 << 31) | 0xFF)) != c:
                break
            pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
            if (unit >> 8) & 1:
                out.append(units[pos] & 0x7FFFFFFF)
        return out

    def transform(self, chunk: str):
        """The normalized string of the shortest key prefixing ``chunk``, or None."""
        hits = self._prefix_values(chunk.encode("utf-8"))
        if not hits:
            return None
        end = self.pool.index(b"\0", hits[0]) if b"\0" in self.pool[hits[0]:] else len(self.pool)
        return self.pool[hits[0]:end].decode("utf-8")

    def normalize(self, text: str) -> str:
        out = []
        for g in graphemes(text):
            if len(g.encode("utf-8")) < 6:
                norm = self.transform(g)
                if norm is not None:
                    out.append(norm)
                    continue
            for c in g:
                norm = self.transform(c)
                out.append(c if norm is None else norm)
        return "".join(out)


def write_charsmap(pairs: dict) -> bytes:
    """A ``precompiled_charsmap`` blob mapping each source string of
    ``pairs`` to its normalized string (sources without NUL bytes)."""
    pool, offsets = bytearray(), {}
    for src, dst in sorted(pairs.items()):
        offsets[src] = len(pool)
        pool += dst.encode("utf-8") + b"\0"
    root: dict = {}
    for src in pairs:
        key = src.encode("utf-8")
        if not key or 0 in key:
            raise ValueError(f"charsmap key {src!r}: empty or holds a NUL byte")
        node = root
        for b in key:
            node = node.setdefault(b, {})
        node[0] = offsets[src]
    units = [0] * 256
    taken = {0}

    def place(node: dict, pos: int):
        labels = sorted(node)
        base = 1
        while any((base ^ c) in taken for c in labels):
            base += 1
        for c in labels:
            taken.add(base ^ c)
        need = (base // 256 + 1) * 256
        units.extend([0] * (need - len(units)))
        offset = pos ^ base
        if offset >= 1 << 21:
            raise ValueError("charsmap: the double array outgrew 21-bit offsets")
        units[pos] = (units[pos] & ((1 << 31) | (1 << 8) | 0xFF)) | (offset << 10)
        if 0 in node:
            units[pos] |= 1 << 8
            units[base] = node[0] | (1 << 31)
        for c in labels:
            if c:
                units[base ^ c] = (units[base ^ c] & ~0xFF) | c
        for c in labels:
            if c:
                place(node[c], base ^ c)

    place(root, 0)
    return struct.pack(f"<I{len(units)}I", 4 * len(units), *units) + bytes(pool)


# -- the pipeline's steps -----------------------------------------------------

def _refuse(where: str, what) -> NotImplementedError:
    return NotImplementedError(f"{where}: {what!r} is not read by the port")


_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def _bert_normalize(text: str, clean: bool, cjk: bool, strip_accents: bool,
                    lower: bool) -> str:
    if clean:
        text = "".join(" " if _is_ws(c) else c for c in text
                       if not (c in "\0\ufffd" or (c not in "\t\n\r"
                                                   and unicodedata.category(c)[0] == "C")))
    if cjk:
        text = "".join(f" {c} " if any(a <= ord(c) <= b for a, b in _CJK) else c for c in text)
    if strip_accents:
        text = "".join(c for c in unicodedata.normalize("NFD", text)
                       if unicodedata.category(c) != "Mn")
    return "".join(c.lower() for c in text) if lower else text


def _bytes_to_unicode() -> dict:
    """GPT-2's byte -> printable character map."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_BYTE_ENC = _bytes_to_unicode()
_BYTE_DEC = {c: b for b, c in _BYTE_ENC.items()}
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def _gpt2_class(c: str) -> str:
    """"S" whitespace, "L" letter, "N" number, "O" anything else."""
    if _is_ws(c):
        return "S"
    cat = unicodedata.category(c)[0]
    return cat if cat in "LN" else "O"


def gpt2_split(text: str) -> list:
    """GPT-2's pre-tokenizer pattern over ``text`` (module docstring)."""
    out, i, n = [], 0, len(text)
    cls = [_gpt2_class(c) for c in text]

    def run(j, kind):
        while j < n and cls[j] == kind:
            j += 1
        return j

    while i < n:
        if text[i] == "'":
            suf = next((x for x in _CONTRACTIONS if text.startswith(x, i + 1)), None)
            if suf is not None:
                out.append(text[i:i + 1 + len(suf)])
                i += 1 + len(suf)
                continue
        start = i + 1 if text[i] == " " and i + 1 < n and cls[i + 1] != "S" else i
        if cls[start] != "S":
            end = run(start, cls[start])
        else:
            end = run(i, "S")
            if end < n and end - i > 1:     # \s+(?!\S): leave the last one
                end -= 1
        out.append(text[i:end])
        i = end
    return out


def _pattern(step: dict, where: str):
    pat = step.get("pattern") or {}
    if set(pat) == {"String"}:
        return re.compile(re.escape(pat["String"]))
    if set(pat) == {"Regex"}:
        return re.compile(pat["Regex"])
    raise _refuse(where, pat)


def _normalizer(spec, where: str):
    """tokenizer.json's ``normalizer`` -> a function str -> str (None: identity)."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_normalizer(s, where) for s in spec["normalizers"]]

        def seq(text):
            for fn in steps:
                text = fn(text)
            return text
        return seq
    if kind == "Precompiled":
        cmap = Charsmap(base64.b64decode(spec["precompiled_charsmap"]))
        return cmap.normalize
    if kind == "Replace":
        pat, content = _pattern(spec, f"{where} Replace"), spec["content"]
        return lambda text: pat.sub(lambda m: content, text)
    if kind == "Strip":
        left, right = spec.get("strip_left", True), spec.get("strip_right", True)

        def strip(text):
            if left:
                text = text.lstrip("".join(_WHITESPACE))
            if right:
                text = text.rstrip("".join(_WHITESPACE))
            return text
        return strip
    if kind == "BertNormalizer":
        lower = bool(spec.get("lowercase", True))
        sa = spec.get("strip_accents")
        flags = (bool(spec.get("clean_text", True)), bool(spec.get("handle_chinese_chars", True)),
                 lower if sa is None else bool(sa), lower)
        return lambda text: _bert_normalize(text, *flags)
    raise _refuse(f"{where} normalizer", kind)


def _is_bert_punct(c: str) -> bool:
    return (c.isascii() and not c.isalnum() and 33 <= ord(c) <= 126) or \
        unicodedata.category(c).startswith("P")


def _pre_tokenizer(spec, where: str):
    """tokenizer.json's ``pre_tokenizer`` -> a function str -> [pieces]."""
    if spec is None:
        return lambda text: [text]
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_pre_tokenizer(s, where) for s in spec["pretokenizers"]]

        def seq(text):
            pieces = [text]
            for fn in steps:
                pieces = [p for piece in pieces for p in fn(piece)]
            return pieces
        return seq
    if kind == "WhitespaceSplit":
        return lambda text: [w for w in re.split(f"[{''.join(_WHITESPACE)}]+", text) if w]
    if kind == "Metaspace":
        rep = spec.get("replacement", _SPACE)
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        if rep != _SPACE or scheme not in ("always", "never"):
            raise _refuse(f"{where} Metaspace pre_tokenizer", spec)
        split = spec.get("split", True)

        def metaspace(text):
            text = text.replace(" ", rep)
            if scheme == "always" and not text.startswith(rep):
                text = rep + text
            if not split:
                return [text]
            # the delimiter merged with the piece after it
            cuts = [i for i, c in enumerate(text) if c == rep and i > 0]
            bounds = [0] + cuts + [len(text)]
            return [text[a:b] for a, b in zip(bounds, bounds[1:]) if b > a]
        return metaspace
    if kind == "BertPreTokenizer":
        def bert(text):
            out, cur = [], []
            for c in text:
                if _is_ws(c):
                    if cur:
                        out.append("".join(cur))
                    cur = []
                elif _is_bert_punct(c):
                    if cur:
                        out.append("".join(cur))
                    out.append(c)
                    cur = []
                else:
                    cur.append(c)
            if cur:
                out.append("".join(cur))
            return out
        return bert
    if kind == "ByteLevel":
        if not spec.get("use_regex", True):
            raise _refuse(f"{where} ByteLevel pre_tokenizer", "use_regex false")
        prefix = bool(spec.get("add_prefix_space", True))

        def bytelevel(text):
            if prefix and not text.startswith(" "):
                text = " " + text
            return ["".join(_BYTE_ENC[b] for b in piece.encode("utf-8"))
                    for piece in gpt2_split(text)]
        return bytelevel
    raise _refuse(f"{where} pre_tokenizer", kind)


class _Unigram:
    def __init__(self, spec: dict, where: str):
        if spec.get("byte_fallback"):
            raise _refuse(f"{where} Unigram", "byte_fallback")
        self.pieces = [(p, float(s)) for p, s in spec["vocab"]]
        self.unk_id = spec.get("unk_id")
        self.ids = {}
        for i, (p, _) in enumerate(self.pieces):
            self.ids.setdefault(p, i)
        self.max_len = max(len(p) for p, _ in self.pieces)
        self.unk_score = min(s for _, s in self.pieces) - 10.0

    def id_to_token(self, i):
        return self.pieces[i][0] if 0 <= i < len(self.pieces) else None

    def token_to_id(self, tok):
        return self.ids.get(tok)

    def tokenize(self, text: str) -> list:
        n = len(text)
        if n == 0:
            return []
        score = [0.0] * (n + 1)
        start = [None] * (n + 1)
        node_id = [0] * (n + 1)
        for s in range(n):
            base = score[s]
            single = False
            for ln in range(1, min(self.max_len, n - s) + 1):
                i = self.ids.get(text[s:s + ln])
                if i is None:
                    continue
                cand = self.pieces[i][1] + base
                e = s + ln
                if start[e] is None or cand > score[e]:
                    score[e], start[e], node_id[e] = cand, s, i
                if ln == 1:
                    single = True
            if not single:
                if self.unk_id is None:
                    raise ValueError(f"character {text[s]!r} has no piece and the model no "
                                     "unk_id")
                cand = self.unk_score + base
                if start[s + 1] is None or cand > score[s + 1]:
                    score[s + 1], start[s + 1], node_id[s + 1] = cand, s, self.unk_id
        ids, e = [], n
        while e > 0:
            i, s = node_id[e], start[e]
            if not (i == self.unk_id and ids and ids[-1] == self.unk_id):   # fuse unk runs
                ids.append(i)
            e = s
        return ids[::-1]


class _WordPiece:
    def __init__(self, spec: dict, where: str):
        self.vocab = dict(spec["vocab"])
        self.inv = {i: t for t, i in self.vocab.items()}
        self.unk = spec.get("unk_token", "[UNK]")
        self.prefix = spec.get("continuing_subword_prefix", "##")
        self.max_chars = int(spec.get("max_input_chars_per_word", 100))
        if self.unk not in self.vocab:
            raise ValueError(f"{where} WordPiece: unk_token {self.unk!r} is not in the vocab")

    def id_to_token(self, i):
        return self.inv.get(i)

    def token_to_id(self, tok):
        return self.vocab.get(tok)

    def tokenize(self, word: str) -> list:
        if len(word) > self.max_chars:
            return [self.vocab[self.unk]]
        out, start = [], 0
        while start < len(word):
            end = len(word)
            hit = None
            while start < end:
                sub = word[start:end] if start == 0 else self.prefix + word[start:end]
                if sub in self.vocab:
                    hit = self.vocab[sub]
                    break
                end -= 1
            if hit is None:
                return [self.vocab[self.unk]]
            out.append(hit)
            start = end
        return out


class _BPE:
    def __init__(self, spec: dict, where: str):
        for key in ("dropout", "continuing_subword_prefix", "end_of_word_suffix"):
            if spec.get(key):
                raise _refuse(f"{where} BPE", key)
        for key in ("byte_fallback", "ignore_merges"):
            if spec.get(key):
                raise _refuse(f"{where} BPE", key)
        self.vocab = dict(spec["vocab"])
        self.inv = {i: t for t, i in self.vocab.items()}
        self.unk = spec.get("unk_token")
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                  for m in spec.get("merges") or []]
        self.ranks = {pair: r for r, pair in enumerate(merges)}
        self.cache: dict = {}

    def id_to_token(self, i):
        return self.inv.get(i)

    def token_to_id(self, tok):
        return self.vocab.get(tok)

    def _merge(self, word: str) -> list:
        parts = list(word)
        while len(parts) > 1:
            pairs = {(a, b) for a, b in zip(parts, parts[1:])}
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, j = [], 0
            while j < len(parts):
                if j + 1 < len(parts) and (parts[j], parts[j + 1]) == best:
                    merged.append(parts[j] + parts[j + 1])
                    j += 2
                else:
                    merged.append(parts[j])
                    j += 1
            parts = merged
        return parts

    def tokenize(self, word: str) -> list:
        ids = self.cache.get(word)
        if ids is None:
            ids = []
            for p in self._merge(word):
                i = self.vocab.get(p)
                if i is None:
                    if self.unk is None or self.unk not in self.vocab:
                        raise ValueError(f"BPE piece {p!r} is not in the vocab and the model "
                                         "has no unk_token")
                    i = self.vocab[self.unk]
                ids.append(i)
            self.cache[word] = ids
        return list(ids)


# transformers' clean_up_tokenization, and the WordPiece decoder's own
_CLEAN_UP = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
             (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re"))
_WP_CLEAN_UP = _CLEAN_UP[:6] + ((" 'm", "'m"), (" do not", " don't")) + _CLEAN_UP[7:]


def _clean_up(text: str, table) -> str:
    for a, b in table:
        text = text.replace(a, b)
    return text


def _decoder(spec, where: str):
    """tokenizer.json's ``decoder`` -> a function [token strings] -> str."""
    kind = (spec or {}).get("type")
    if kind == "Metaspace":
        rep = spec.get("replacement", _SPACE)
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        if rep != _SPACE or scheme not in ("always", "never"):
            raise _refuse(f"{where} Metaspace decoder", spec)

        def metaspace(tokens):
            return "".join(t.replace(rep, "" if i == 0 and scheme != "never" else " ")
                           for i, t in enumerate(tokens))
        return metaspace
    if kind == "WordPiece":
        prefix, cleanup = spec.get("prefix", "##"), spec.get("cleanup", True)

        def wordpiece(tokens):
            out = []
            for i, t in enumerate(tokens):
                if i:
                    t = t[len(prefix):] if t.startswith(prefix) else " " + t
                out.append(_clean_up(t, _WP_CLEAN_UP) if cleanup else t)
            return "".join(out)
        return wordpiece
    if kind == "ByteLevel":
        def bytelevel(tokens):
            raw = b"".join(bytes([_BYTE_DEC[c]]) if c in _BYTE_DEC else c.encode("utf-8")
                           for t in tokens for c in t)
            return raw.decode("utf-8", errors="replace")
        return bytelevel
    raise _refuse(f"{where} decoder", kind)


def _template(spec, where: str):
    """``TemplateProcessing`` (single sequence) -> (ids before $A, ids after);
    ``ByteLevel`` adds none, a ``Sequence`` their concatenation."""
    if spec is None or spec.get("type") == "ByteLevel":
        return [], []
    if spec.get("type") == "Sequence":
        before, after = [], []
        for step in spec["processors"]:
            b, a = _template(step, where)
            before, after = before + b, after + a
        return before, after
    if spec.get("type") != "TemplateProcessing":
        raise _refuse(f"{where} post_processor", spec.get("type"))
    specials = spec.get("special_tokens") or {}
    before, after, seen = [], [], False
    for item in spec["single"]:
        if "Sequence" in item:
            if item["Sequence"]["id"] != "A" or seen:
                raise _refuse(f"{where} TemplateProcessing single", spec["single"])
            seen = True
        elif "SpecialToken" in item:
            name = item["SpecialToken"]["id"]
            ids = specials.get(name, {}).get("ids")
            if ids is None:
                raise ValueError(f"{where} TemplateProcessing: no ids for {name!r}")
            (after if seen else before).extend(int(i) for i in ids)
        else:
            raise _refuse(f"{where} TemplateProcessing single", item)
    if not seen:
        raise _refuse(f"{where} TemplateProcessing single", spec["single"])
    return before, after


def _read_json(path: str):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _content(tok):
    return tok.get("content") if isinstance(tok, dict) else tok


_CLASSES = {"T5Tokenizer": ("Unigram", ("eos_token", "unk_token", "pad_token")),
            "XLMRobertaTokenizer": ("Unigram", ("bos_token", "eos_token", "sep_token",
                                                "cls_token", "unk_token", "pad_token",
                                                "mask_token")),
            "BertTokenizer": ("WordPiece", ("unk_token", "sep_token", "pad_token", "cls_token",
                                            "mask_token")),
            "GPT2Tokenizer": ("BPE", ("bos_token", "eos_token", "unk_token", "pad_token"))}
_DEFAULTS = {"eos_token": "</s>", "unk_token": "<unk>", "pad_token": "<pad>",
             "bos_token": "<s>", "sep_token": "</s>", "cls_token": "<s>",
             "mask_token": "<mask>"}
_GPT2_DEFAULTS = {"bos_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
                  "unk_token": "<|endoftext|>"}
_BERT_DEFAULTS = {"unk_token": "[UNK]", "sep_token": "[SEP]", "pad_token": "[PAD]",
                  "cls_token": "[CLS]", "mask_token": "[MASK]"}


class TokenizerJSON:
    """A T5 / XLM-RoBERTa (Unigram), BERT (WordPiece) or GPT-2 / OPT
    (byte-level BPE) tokenizer from a snapshot directory: ``tokenizer.json``
    plus ``tokenizer_config.json`` and ``special_tokens_map.json`` (the
    class, the special tokens, the clean-up switch, BERT's normalizer
    switches)."""

    def __init__(self, path: str):
        tok_path = os.path.join(path, "tokenizer.json")
        if not os.path.exists(tok_path):
            raise FileNotFoundError(f"no tokenizer.json under {path}")
        spec = _read_json(tok_path)
        config: dict = {}
        for name in ("special_tokens_map.json", "tokenizer_config.json"):
            p = os.path.join(path, name)
            if os.path.exists(p):
                config.update(_read_json(p))
        cls = (config.get("tokenizer_class") or "").removesuffix("Fast")
        if cls not in _CLASSES:
            raise _refuse(f"{path}/tokenizer_config.json tokenizer_class",
                          config.get("tokenizer_class"))
        model_kind, special_names = _CLASSES[cls]
        self.tokenizer_class = cls
        where = tok_path
        model = spec.get("model") or {}
        if model.get("type") != model_kind:
            raise _refuse(f"{where} model (for {cls})", model.get("type"))
        self.model = {"Unigram": _Unigram, "WordPiece": _WordPiece, "BPE": _BPE}[model_kind](
            model, where)
        self.normalize = _normalizer(spec.get("normalizer"), where)
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"), where)
        self.decode_tokens = _decoder(spec.get("decoder"), where)
        for key in ("truncation", "padding"):
            if spec.get(key):
                raise _refuse(f"{where} {key}", spec[key])
        self.added: dict = {}      # content -> [id, normalized, special, lstrip, rstrip]
        self.added_ids: dict = {}  # id -> content
        self.special: set = set()  # contents skipped by decode(skip_special_tokens=True)
        for t in spec.get("added_tokens") or []:
            if t.get("single_word"):
                raise _refuse(f"{where} added token {t['content']!r}", "single_word")
            self.set_added(t["content"], int(t["id"]), normalized=bool(t.get("normalized")),
                           special=bool(t.get("special")), lstrip=bool(t.get("lstrip")),
                           rstrip=bool(t.get("rstrip")))
        defaults = {"BertTokenizer": _BERT_DEFAULTS, "GPT2Tokenizer": _GPT2_DEFAULTS}.get(
            cls, _DEFAULTS)
        names = list(special_names) + (["bos_token"] if "bos_token" in config else [])
        extra = [_content(t) for t in config.get("additional_special_tokens") or []]
        if cls == "T5Tokenizer" and not config.get("additional_special_tokens"):
            extra = [f"<extra_id_{i}>" for i in range(int(config.get("extra_ids", 100)))]
        self.ids_of: dict = {}
        for name in names:
            content = _content(config.get(name, defaults.get(name)))
            if content is not None:
                self.ids_of[name] = self._special_id(content, path, name)
        for content in extra:
            self._special_id(content, path, "additional_special_tokens")
        if cls == "BertTokenizer":
            self._check_bert(spec.get("normalizer") or {}, config, path)
        pre = spec.get("pre_tokenizer") or {}
        if (cls == "GPT2Tokenizer" and "add_prefix_space" in config
                and bool(config["add_prefix_space"]) != bool(pre.get("add_prefix_space", True))):
            # transformers rebuilds the pre-tokenizer to the config's switch
            raise _refuse(f"{path}: tokenizer_config.json add_prefix_space against the "
                          "pre_tokenizer", pre)
        self.unk_token_id = self.ids_of.get("unk_token")
        self.eos_token_id = self.ids_of.get("eos_token")
        self.bos_token_id = self.ids_of.get("bos_token")
        self.pad_token_id = self.ids_of.get("pad_token")
        self.clean_up = bool(config.get("clean_up_tokenization_spaces", False))
        if config.get("padding_side", "right") != "right":
            raise _refuse(f"{path}/tokenizer_config.json padding_side", config["padding_side"])
        self.before, self.after = _template(spec.get("post_processor"), where)

    def _special_id(self, content: str, path: str, name: str) -> int:
        """A configured special token: an added token of tokenizer.json, now special."""
        if content not in self.added:
            raise ValueError(f"{path}: {name} {content!r} is not an added token of "
                             "tokenizer.json")
        self.special.add(content)
        return self.added[content][0]

    @staticmethod
    def _check_bert(norm: dict, config: dict, path: str):
        """transformers rebuilds a BertNormalizer that disagrees with the
        config's switches; the port refuses the disagreement instead."""
        want = {"lowercase": config.get("do_lower_case", True),
                "strip_accents": config.get("strip_accents"),
                "handle_chinese_chars": config.get("tokenize_chinese_chars", True)}
        if norm.get("type") != "BertNormalizer" or any(norm.get(k, v) != v
                                                       for k, v in want.items()):
            raise _refuse(f"{path}: tokenizer_config.json {want} against the normalizer", norm)

    def set_added(self, content: str, idx: int, normalized: bool, special: bool,
                  lstrip: bool = False, rstrip: bool = False):
        """Add (or re-flag) an added token, as the library's ``add_tokens``
        does: the flags are replaced, and a token already special stays so."""
        self.added[content] = [idx, normalized, special, lstrip, rstrip]
        self.added_ids[idx] = content
        if special:
            self.special.add(content)

    def token_to_id(self, token: str):
        if token in self.added:
            return self.added[token][0]
        return self.model.token_to_id(token)

    # -- encoding --------------------------------------------------------

    def _split_added(self, text: str, normalized: bool):
        """[(piece, added id or None)]: leftmost-longest matches of the added
        tokens whose ``normalized`` flag is ``normalized``; lstrip / rstrip
        tokens take the whitespace beside them."""
        pats = {}
        for c, (idx, n, _, ls, rs) in self.added.items():
            if n == normalized and c:
                key = self.normalize(c) if (normalized and self.normalize) else c
                pats[key] = (idx, ls, rs)
        toks = sorted(pats, key=len, reverse=True)
        out, start, i = [], 0, 0
        while i < len(text):
            hit = next((c for c in toks if text.startswith(c, i)), None)
            if hit is None:
                i += 1
                continue
            idx, ls, rs = pats[hit]
            a, b = i, i + len(hit)
            if ls:
                while a > start and _is_ws(text[a - 1]):
                    a -= 1
            if rs:
                while b < len(text) and _is_ws(text[b]):
                    b += 1
            if a > start:
                out.append((text[start:a], None))
            out.append((text[a:b], idx))
            i = start = b
        if start < len(text):
            out.append((text[start:], None))
        return out

    def encode(self, text: str, add_special_tokens: bool = True) -> list:
        ids: list = []
        for piece, idx in self._split_added(text, normalized=False):
            if idx is not None:
                ids.append(idx)
                continue
            norm = self.normalize(piece) if self.normalize else piece
            for sub, sidx in self._split_added(norm, normalized=True):
                if sidx is not None:
                    ids.append(sidx)
                    continue
                for word in self.pre_tokenize(sub):
                    ids.extend(self.model.tokenize(word))
        if add_special_tokens:
            ids = self.before + ids + self.after
        return ids

    def __call__(self, texts):
        """A batch of strings -> (ids, attention_mask), int64 [N, W],
        right-padded with the pad id to the longest row (transformers'
        ``padding=True``)."""
        rows = [self.encode(t) for t in texts]
        width = max(len(r) for r in rows)
        ids = np.full((len(rows), width), self.pad_token_id or 0, np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = r
            mask[i, :len(r)] = 1
        return ids, mask

    # -- decoding --------------------------------------------------------

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        tokens = []
        for i in np.asarray(ids).reshape(-1).tolist():
            tok = self.added_ids.get(i)
            if tok is None:
                tok = self.model.id_to_token(i)
            if tok is not None and not (skip_special_tokens and tok in self.special):
                tokens.append(tok)
        text = self.decode_tokens(tokens)
        return _clean_up(text, _CLEAN_UP) if self.clean_up else text
