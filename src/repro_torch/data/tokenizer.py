"""Byte-level tokenizer (no external vocab files; offline-friendly)."""

from __future__ import annotations

from typing import List


class ByteTokenizer:
    """256 byte tokens + BOS/EOS/PAD."""

    PAD = 256
    BOS = 257
    EOS = 258

    @property
    def vocab_size(self) -> int:
        return 259

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.BOS] if add_bos else []) + ids

    def decode(self, ids) -> str:
        return bytes(t for t in ids if t < 256).decode("utf-8", "replace")
