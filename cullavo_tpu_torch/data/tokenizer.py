"""The byte-level tokenizer of the smoke modes (the port's own copy of
``cullavo_tpu/data/tokenizer.py::ByteTokenizer``)."""
from __future__ import annotations

import numpy as np


class ByteTokenizer:
    """Deterministic byte-level tokenizer.

    ids: 0=pad, 1=bos, 2=eos, 3=<image>, byte b -> b + 4.
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
            elif t >= 4:
                out.append(t - 4)
            elif t == self.eos_token_id and not skip_special_tokens:
                out.extend(b"</s>")
        return out.decode("utf-8", errors="replace")
