"""Tokenizers of the port (counterpart of ``cullavo_tpu/data/tokenizer.py``).

``ByteTokenizer``: the byte-level tokenizer of the smoke modes (the port's
own copy of the JAX package's).

``HFTokenizer``: a local snapshot's ``tokenizer.json`` (plus
``tokenizer_config.json`` / ``special_tokens_map.json`` for bos, eos and
pad), read by the port's own code where the JAX package goes through
``transformers.AutoTokenizer`` (which the machine with the card lacks).
Scope: the LLaMA / sentencepiece-converted BPE family that
``llava-hf/llava-1.5-7b-hf`` ships, with the semantics of the ``tokenizers``
library under transformers' ``LlamaTokenizerFast``:

* ``added_tokens`` are split out of the raw text first (leftmost, longest),
  those marked ``normalized`` out of each normalized piece after, in their
  own normalized form;
* normalizer ``Prepend("▁")`` + ``Replace(" ", "▁")`` on each piece (the
  legacy form), or none and a ``Metaspace`` pre-tokenizer (replacement
  "▁", ``prepend_scheme`` "first", no split): spaces become "▁" and "▁"
  is prepended to the piece that starts the text unless it starts with one;
* model ``BPE``: characters of the vocabulary, the UTF-8 bytes of the others
  as ``<0xXX>`` tokens (``byte_fallback``), ``<unk>`` where neither exists,
  then merges by rank, the leftmost pair first;
* bos before the text when ``add_bos_token`` (default on), eos after it when
  ``add_eos_token`` (default off), as ``LlamaTokenizerFast`` rebuilds its
  post-processor;
* decoder ``Replace("▁", " ")``, ``ByteFallback`` (invalid UTF-8 gives one
  U+FFFD per byte), ``Fuse``, ``Strip(" ", 1, 0)``; special added tokens
  are dropped with ``skip_special_tokens``; transformers' clean-up of
  tokenization spaces when the config asks for it.

Any other model type, normalizer, pre-tokenizer, decoder or added-token
flag raises ``NotImplementedError`` naming it: nothing falls back quietly.
``<image>`` is added when absent, as the JAX wrapper does (a normalized,
non-special added token after the last id).
"""
from __future__ import annotations

import json
import os

import numpy as np

_SPACE = "▁"   # "▁", sentencepiece's word-boundary mark


class ByteTokenizer:
    """Deterministic byte-level tokenizer.

    ids: 0=pad, 1=bos, 2=eos, 3=<image>, byte b -> b + 4.  ``decode``
    skips ids past the byte range (a model with a larger vocabulary may
    emit them; the JAX package's decode raises on them).
    """

    pad_token_id = 0
    bos_token_id = 1
    eos_token_id = 2
    image_token_id = 3
    vocab_size = 260

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        ids: list[int] = [self.bos_token_id] if add_special_tokens else []
        i = 0
        while i < len(text):
            if text.startswith("<image>", i):
                ids.append(self.image_token_id)
                i += len("<image>")
            elif text.startswith("</s>", i):
                ids.append(self.eos_token_id)
                i += len("</s>")
            else:
                ids.extend(b + 4 for b in text[i].encode("utf-8"))
                i += 1
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        out = bytearray()
        for t in np.asarray(ids).tolist():
            if t == self.image_token_id and not skip_special_tokens:
                out.extend(b"<image>")
            elif 4 <= t < self.vocab_size:
                out.append(t - 4)
            elif t == self.eos_token_id and not skip_special_tokens:
                out.extend(b"</s>")
        return out.decode("utf-8", errors="replace")


def _read_json(path: str):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _token_content(tok):
    """A special token of a tokenizer config: a string or an AddedToken dict."""
    return tok.get("content") if isinstance(tok, dict) else tok


def _pattern_string(step: dict, what: str) -> str:
    pattern = step.get("pattern") or {}
    if set(pattern) != {"String"}:
        raise NotImplementedError(f"{what} with pattern {pattern!r} (only a plain String)")
    return pattern["String"]


# transformers' clean_up_tokenization
_CLEAN_UP = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
             (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re"))


class HFTokenizer:
    """A LLaMA-family ``tokenizer.json`` from a local snapshot directory,
    with the ``<image>`` token id (see the module docstring for the scope)."""

    def __init__(self, path: str, image_token: str = "<image>"):
        tok_path = os.path.join(path, "tokenizer.json")
        if not os.path.exists(tok_path):
            raise FileNotFoundError(f"no tokenizer.json under {path}: the port reads only "
                                    "tokenizer.json (no sentencepiece model, no fallback)")
        spec = _read_json(tok_path)
        config = {}
        for name in ("special_tokens_map.json", "tokenizer_config.json"):
            p = os.path.join(path, name)
            if os.path.exists(p):
                config.update(_read_json(p))
        cls = config.get("tokenizer_class")
        if cls not in (None, "LlamaTokenizer", "LlamaTokenizerFast"):
            raise NotImplementedError(f"tokenizer_class {cls!r}: only the LLaMA tokenizer")
        if config.get("add_prefix_space") is not None:
            raise NotImplementedError("add_prefix_space (transformers rebuilds the tokenizer "
                                      "from a sentencepiece model)")
        self._read_model(spec.get("model") or {})
        self._read_normalizer(spec.get("normalizer"))
        self._read_pre_tokenizer(spec.get("pre_tokenizer"))
        self._read_decoder(spec.get("decoder"))
        self._read_added(spec.get("added_tokens") or [], config)

        def token_id(name, default):
            content = _token_content(config.get(name, default))
            return None if content is None else self.token_to_id(content)

        self.unk_token_id = token_id("unk_token", "<unk>")
        self.bos_token_id = token_id("bos_token", "<s>")
        self.eos_token_id = token_id("eos_token", "</s>")
        pad = token_id("pad_token", None)
        self.pad_token_id = pad or self.eos_token_id
        self.config_pad_token_id = pad     # the config's own pad token (None: none)
        self.add_bos = bool(config.get("add_bos_token", True))
        self.add_eos = bool(config.get("add_eos_token", False))
        if (self.add_bos and self.bos_token_id is None) or (self.add_eos and self.eos_token_id is None):
            raise ValueError(f"{path}: add_bos_token/add_eos_token set without the token")
        self.clean_up = bool(config.get("clean_up_tokenization_spaces", False))
        image_id = self.token_to_id(image_token)
        if image_id is None or image_id == self.unk_token_id:
            image_id = max(max(self.vocab.values()), max(self.added_ids, default=-1)) + 1
            self._add(image_token, image_id, normalized=True, special=False)
        self.image_token_id = image_id

    # -- reading tokenizer.json ------------------------------------------

    def _read_model(self, model: dict):
        if model.get("type") != "BPE":
            raise NotImplementedError(f"tokenizer model {model.get('type')!r} (only BPE)")
        for key in ("dropout", "continuing_subword_prefix", "end_of_word_suffix",
                    "ignore_merges"):
            if model.get(key):
                raise NotImplementedError(f"BPE option {key}={model[key]!r}")
        self.vocab = dict(model["vocab"])
        self.id_to_vocab = {i: t for t, i in self.vocab.items()}
        self.byte_fallback = bool(model.get("byte_fallback", False))
        self.fuse_unk = bool(model.get("fuse_unk", False))
        self.unk_token = model.get("unk_token")
        self.merges = {}
        for rank, m in enumerate(model.get("merges") or []):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self.merges[(a, b)] = rank

    def _read_normalizer(self, norm):
        """None, or exactly Prepend("▁") + Replace(" ", "▁") (in a Sequence)."""
        self.norm_prepend = False
        if norm is None:
            return
        steps = norm["normalizers"] if norm.get("type") == "Sequence" else [norm]
        kinds = [s.get("type") for s in steps]
        if (kinds != ["Prepend", "Replace"] or steps[0].get("prepend") != _SPACE
                or _pattern_string(steps[1], "Replace normalizer") != " "
                or steps[1].get("content") != _SPACE):
            raise NotImplementedError(f"normalizer {norm!r} (only Prepend('▁') + "
                                      "Replace(' ', '▁'))")
        self.norm_prepend = True

    def _read_pre_tokenizer(self, pre):
        """None, or a Metaspace that prepends to the first piece only and does
        not split."""
        self.metaspace = False
        if pre is None:
            return
        if pre.get("type") != "Metaspace":
            raise NotImplementedError(f"pre_tokenizer {pre.get('type')!r} (only Metaspace)")
        if (pre.get("replacement") != _SPACE or pre.get("split", True)
                or pre.get("prepend_scheme") != "first"):
            raise NotImplementedError(f"Metaspace pre_tokenizer {pre!r} (only replacement '▁', "
                                      "split false, prepend_scheme first)")
        if self.norm_prepend:
            raise NotImplementedError("a Prepend normalizer together with a Metaspace "
                                      "pre_tokenizer")
        self.metaspace = True

    def _read_decoder(self, dec):
        steps = (dec or {}).get("decoders") if (dec or {}).get("type") == "Sequence" else [dec]
        kinds = [(s or {}).get("type") for s in steps]
        if kinds != ["Replace", "ByteFallback", "Fuse", "Strip"]:
            raise NotImplementedError(f"decoder {dec!r} (only Replace, ByteFallback, Fuse, "
                                      "Strip)")
        rep, strip = steps[0], steps[3]
        if (_pattern_string(rep, "Replace decoder") != _SPACE or rep.get("content") != " "
                or strip.get("content") != " " or strip.get("start") != 1
                or strip.get("stop") != 0):
            raise NotImplementedError(f"decoder {dec!r} (only Replace('▁', ' ') and "
                                      "Strip(' ', 1, 0))")

    def _read_added(self, added: list, config: dict):
        self.added = {}          # content -> (id, normalized, special)
        self.added_ids = {}      # id -> content
        for t in added:
            for flag in ("single_word", "lstrip", "rstrip"):
                if t.get(flag):
                    raise NotImplementedError(f"added token {t['content']!r} with {flag}")
            self._add(t["content"], int(t["id"]), bool(t.get("normalized", not t.get("special"))),
                      bool(t.get("special", False)))
        for i, t in (config.get("added_tokens_decoder") or {}).items():
            if self.added_ids.get(int(i)) != t.get("content"):
                raise NotImplementedError(f"added token {t.get('content')!r} (id {i}) of "
                                          "tokenizer_config.json is not in tokenizer.json")

    def _add(self, content, idx, normalized, special):
        self.added[content] = (idx, normalized, special)
        self.added_ids[idx] = content

    def token_to_id(self, token: str):
        if token in self.added:
            return self.added[token][0]
        return self.vocab.get(token)

    # -- encoding ----------------------------------------------------------

    def _normalize(self, text: str) -> str:
        if self.norm_prepend and text:
            return _SPACE + text.replace(" ", _SPACE)
        return text

    def _split_added(self, text: str, normalized: bool):
        """[(piece, added id or None)]: leftmost-longest matches of the added
        tokens whose ``normalized`` flag is ``normalized`` (those are matched
        in their normalized form, "▁<image>" under the Prepend normalizer)."""
        patterns = {(self._normalize(c) if normalized else c): idx
                    for c, (idx, n, _) in self.added.items() if n == normalized and c}
        tokens = sorted(patterns, key=len, reverse=True)
        out, start, i = [], 0, 0
        while i < len(text):
            hit = next((c for c in tokens if text.startswith(c, i)), None)
            if hit is None:
                i += 1
                continue
            if i > start:
                out.append((text[start:i], None))
            out.append((hit, patterns[hit]))
            i = start = i + len(hit)
        if start < len(text):
            out.append((text[start:], None))
        return out

    def _bpe(self, word: str) -> list[int]:
        syms: list[str] = []
        ids: list[int] = []
        unk = None                  # (pending unk id) while fusing
        for ch in word:
            if ch in self.vocab:
                if unk is not None:
                    syms.append(None)
                    ids.append(unk)
                    unk = None
                syms.append(ch)
                ids.append(self.vocab[ch])
                continue
            codes = [f"<0x{b:02X}>" for b in ch.encode("utf-8")]
            if self.byte_fallback and all(c in self.vocab for c in codes):
                for c in codes:
                    syms.append(c)
                    ids.append(self.vocab[c])
                continue
            if self.unk_token is None or self.unk_token not in self.vocab:
                raise ValueError(f"character {ch!r} has no token and the model no <unk>")
            if unk is not None and not self.fuse_unk:
                syms.append(None)
                ids.append(unk)
            unk = self.vocab[self.unk_token]
        if unk is not None:
            syms.append(None)
            ids.append(unk)
        # merges by rank, the leftmost pair first
        while len(syms) > 1:
            best, at = None, -1
            for j in range(len(syms) - 1):
                if syms[j] is None or syms[j + 1] is None:
                    continue
                rank = self.merges.get((syms[j], syms[j + 1]))
                if rank is not None and (best is None or rank < best):
                    best, at = rank, j
            if best is None:
                break
            merged = syms[at] + syms[at + 1]
            syms[at:at + 2] = [merged]
            ids[at:at + 2] = [self.vocab[merged]]
        return ids

    def _encode_piece(self, piece: str, starts_text: bool) -> list[int]:
        """One piece of text between raw added tokens."""
        piece = self._normalize(piece)
        out = []
        for k, (sub, added_id) in enumerate(self._split_added(piece, normalized=True)):
            if added_id is not None:
                out.append(added_id)
                continue
            if self.metaspace:
                sub = sub.replace(" ", _SPACE)
                # "first": only the sub-piece that starts the text
                if starts_text and k == 0 and not sub.startswith(_SPACE):
                    sub = _SPACE + sub
            out.extend(self._bpe(sub))
        return out

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        ids = []
        pos = 0
        for piece, added_id in self._split_added(text, normalized=False):
            if added_id is not None:
                ids.append(added_id)
            else:
                ids.extend(self._encode_piece(piece, starts_text=pos == 0))
            pos += len(piece)
        if add_special_tokens:
            ids = (([self.bos_token_id] if self.add_bos else []) + ids
                   + ([self.eos_token_id] if self.add_eos else []))
        return ids

    # -- decoding ----------------------------------------------------------

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        tokens = []
        for i in np.asarray(ids).reshape(-1).tolist():
            if i in self.added_ids:
                content = self.added_ids[i]
                if skip_special_tokens and self.added[content][2]:
                    continue
                tokens.append(content)
            elif i in self.id_to_vocab:
                tokens.append(self.id_to_vocab[i])
        text, pending = [], bytearray()

        def flush():
            if pending:
                try_text = bytes(pending).decode("utf-8", errors="strict") if _valid_utf8(
                    pending) else "�" * len(pending)
                text.append(try_text)
                pending.clear()

        for t in tokens:
            t = t.replace(_SPACE, " ")
            if len(t) == 6 and t.startswith("<0x") and t.endswith(">") and _is_hex(t[3:5]):
                pending.append(int(t[3:5], 16))
                continue
            flush()
            text.append(t)
        flush()
        out = "".join(text)
        if out.startswith(" "):
            out = out[1:]
        if self.clean_up:
            for a, b in _CLEAN_UP:
                out = out.replace(a, b)
        return out


def _is_hex(s: str) -> bool:
    return all(c in "0123456789ABCDEFabcdef" for c in s)


def _valid_utf8(b: bytearray) -> bool:
    return bytes(b).decode("utf-8", errors="ignore").encode("utf-8") == bytes(b)
