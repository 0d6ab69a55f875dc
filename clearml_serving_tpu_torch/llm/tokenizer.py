"""Byte-level tokenizer (zero-dependency, fits any vocab >= 259).

Copied from ``clearml_serving_tpu/llm/tokenizer.py`` so the port imports
nothing of the JAX package; it must stay identical to the reference's, since
chat content is compared byte for byte. The HuggingFace tokenizer wrapper
arrives with bundle loading.
"""

from __future__ import annotations

from typing import Iterable, List


class ByteTokenizer:
    """Bytes 0..255 as tokens + bos/eos/pad specials. Deterministic and
    dependency-free: the test tokenizer, and the fallback when a bundle has
    no tokenizer files."""

    def __init__(self, vocab_size: int = 512):
        if vocab_size < 259:
            raise ValueError("byte tokenizer needs vocab >= 259")
        self.vocab_size = vocab_size
        self.bos_token_id = 256
        self.eos_token_id = 257
        self.pad_token_id = 258

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_token_id] if add_bos else []) + ids

    def encode_chat(self, templated: str) -> List[int]:
        """Encode apply_chat_template output. The byte-level template carries
        no special tokens, so BOS is prepended here."""
        return self.encode(templated, add_bos=True)

    def decode(self, ids: Iterable[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")

    def apply_chat_template(self, messages: List[dict]) -> str:
        parts = []
        for m in messages:
            parts.append("<|{}|>\n{}\n".format(m.get("role", "user"), m.get("content", "")))
        parts.append("<|assistant|>\n")
        return "".join(parts)
