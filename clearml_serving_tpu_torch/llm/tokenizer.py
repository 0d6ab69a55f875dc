"""Byte-level tokenizer (zero-dependency, fits any vocab >= 259).

Copied from ``clearml_serving_tpu/llm/tokenizer.py`` so the port imports
nothing of the JAX package; it must stay identical to the reference's, since
chat content is compared byte for byte. The HuggingFace tokenizer wrapper
arrives with bundle loading. ``token_str`` and ``token_repr`` are the
reference route's token strings of logprob entries.
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


def token_str(tokenizer, tid: int) -> str:
    """One token's decoded text (a logprob entry's ``token``)."""
    return tokenizer.decode([int(tid)])


def token_repr(tokenizer, tid: int, as_ids: bool) -> str:
    """vLLM ``return_tokens_as_token_ids``: ``"token_id:<id>"`` instead of
    the decoded piece (tokens that decode alike stay apart)."""
    return "token_id:{}".format(int(tid)) if as_ids else token_str(tokenizer, tid)
