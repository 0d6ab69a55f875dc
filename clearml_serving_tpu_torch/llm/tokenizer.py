"""Tokenizers: HuggingFace's when a model bundle ships tokenizer files,
byte-level otherwise (zero-dependency, fits any vocab >= 259).

Copied from ``clearml_serving_tpu/llm/tokenizer.py`` so the port imports
nothing of the JAX package; it must stay identical to the reference's, since
chat content is compared byte for byte. ``transformers`` is imported only
when a bundle has tokenizer files; where it is missing or fails (the card's
machine has no ``transformers``), ``load_tokenizer`` falls back to
``ByteTokenizer`` exactly as the reference does. ``token_str`` and
``token_repr`` are the reference route's token strings of logprob entries.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, List, Optional


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


class HFTokenizer:
    """transformers AutoTokenizer adapter (same surface as ByteTokenizer)."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.vocab_size = int(self._tok.vocab_size)
        self.bos_token_id = self._tok.bos_token_id
        self.eos_token_id = self._tok.eos_token_id
        # explicit None check: a valid pad_token_id of 0 must not be
        # silently replaced by eos
        self.pad_token_id = (
            self._tok.pad_token_id
            if self._tok.pad_token_id is not None
            else self._tok.eos_token_id
        )

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        return self._tok.encode(text, add_special_tokens=add_bos)

    def encode_chat(self, templated: str) -> List[int]:
        """Encode apply_chat_template output WITHOUT re-adding special
        tokens: HF chat templates (Llama family included) already emit BOS
        in the template text, so a second one would degrade generation."""
        return self._tok.encode(templated, add_special_tokens=False)

    def decode(self, ids: Iterable[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)

    def apply_chat_template(self, messages: List[dict], tools=None) -> str:
        """``tools``: OpenAI-shape tool definitions forwarded to the HF
        template. Templates without a ``tools`` variable silently ignore
        them; llm/tools.py detects that by comparing against the tool-less
        render and falls back to a system preamble."""
        if tools:
            try:
                return self._tok.apply_chat_template(
                    messages, tokenize=False, add_generation_prompt=True,
                    tools=list(tools),
                )
            except Exception:
                # a failed tools= render falls back to the TOOL-LESS render,
                # not the byte-level text, so the native-support probe reads
                # "template ignored tools"
                return self.apply_chat_template(messages)
        try:
            return self._tok.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True
            )
        except Exception:
            # no chat template: the fallback text carries no specials, so
            # prepend the BOS literal to keep encode_chat() (which never adds
            # special tokens) correct for both paths
            text = ByteTokenizer.apply_chat_template(self, messages)  # type: ignore
            if self._tok.bos_token:
                text = self._tok.bos_token + text
            return text


def load_tokenizer(model_path: Optional[str], vocab_size: int):
    """HF tokenizer if the bundle directory carries tokenizer files and
    ``transformers`` loads them, else the byte-level fallback."""
    if model_path:
        p = Path(model_path)
        base = p if p.is_dir() else p.parent
        if (base / "tokenizer.json").exists() or (base / "tokenizer_config.json").exists():
            try:
                return HFTokenizer(str(base))
            except Exception:
                pass
    return ByteTokenizer(vocab_size=max(vocab_size, 259))


def token_str(tokenizer, tid: int) -> str:
    """One token's decoded text (a logprob entry's ``token``)."""
    return tokenizer.decode([int(tid)])


def token_repr(tokenizer, tid: int, as_ids: bool) -> str:
    """vLLM ``return_tokens_as_token_ids``: ``"token_id:<id>"`` instead of
    the decoded piece (tokens that decode alike stay apart)."""
    return "token_id:{}".format(int(tid)) if as_ids else token_str(tokenizer, tid)
