"""Byte-level tokenizer — the port's own copy of
``torchbooster_tpu/data/tokenizer.py``: UTF-8 bytes are the token stream
(vocab 256, no files to download, lossless round trip). It backs the
``text_file`` dataset source (``data/sources.py``) and the readable
decode of the GPT recipe's samples."""
from __future__ import annotations

import numpy as np


class ByteTokenizer:
    """UTF-8 byte-level tokenizer: 256-way vocab, exact round trip."""

    vocab_size = 256

    def encode(self, text: str | bytes) -> np.ndarray:
        data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
        return np.frombuffer(data, np.uint8).astype(np.int32)

    def decode(self, ids) -> str:
        arr = np.asarray(ids).astype(np.uint8)
        # model samples may split multi-byte codepoints; never raise
        return arr.tobytes().decode("utf-8", errors="replace")


__all__ = ["ByteTokenizer"]
