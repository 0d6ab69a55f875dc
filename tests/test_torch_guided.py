"""The port's grammar compiler (clearml_serving_tpu_torch/llm/guided.py)
and its device-side mask and walk (llm/sampling.py ``guided_mask``,
``guided_advance``) against the reference's:

- every regex, JSON schema and ``json_object`` of the reference's
  ``tests/test_guided.py`` compiles to the same ``mask_bits``,
  ``byte_trans``, ``start`` and ``terminal``, bit for bit, over the byte
  tokenizer and over fake SentencePiece and byte-level-BPE tokenizers (the
  reference tests' ``_tok`` stubs); the byte DFAs accept and reject the
  same strings, the lowered regexes are the same text, and the same
  patterns raise ``RegexError``;
- ``token_byte_table`` and ``build_token_byte_arrays`` equal per
  convention;
- ``guided_mask`` and ``guided_advance`` equal the reference engine's
  ``_guided_mask`` and ``_guided_advance`` (``llm/engine.py:1599-1632``,
  transcribed here in jnp since they are closures of the engine), over
  unguided rows, dead walks, zero-length tokens, an all-masked row and
  states past the table (which JAX's gathers clamp)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearml_serving_tpu.llm import guided as ref
from clearml_serving_tpu.llm.tokenizer import ByteTokenizer as RefByteTokenizer
from clearml_serving_tpu_torch.llm import guided as port
from clearml_serving_tpu_torch.llm.sampling import GUIDED_FILL, guided_advance, guided_mask
from clearml_serving_tpu_torch.llm.tokenizer import ByteTokenizer

REGEXES = [
    "(yes|no|maybe)", r"-?(0|[1-9][0-9]*)", r"[a-c]{2,3}x", r"a+b*c?", r"\d\d:\d\d",
    r"[^0-9]+", r"^\d+$", r"\D+", r"[\S]+", r"\W", "cat|dog", "ab", "north", r"^north$",
    "(north|south|east|west)", r"[a-z ]{0,12}\.", r"(\(|\))+", "é+",
]
BAD_REGEXES = ["(a", "a)", "[a", "*a", "a{2", r"\bword\b", r"a\Z", r"\Aa", r"(a)\1", "a$b",
               "a^b", r"[\b]", r"\p{L}"]
SCHEMAS = {
    "absent_required": {"type": "object",
                        "properties": {"x": {"type": "integer"}, "y": {"type": "integer"}}},
    "roundtrip": {"type": "object", "properties": {
        "name": {"type": "string"}, "age": {"type": "integer"},
        "tags": {"type": "array", "items": {"type": "string"}, "maxItems": 3},
        "kind": {"enum": ["cat", "dog"]}}, "required": ["name", "age", "kind"]},
    "optional_commas": {"type": "object", "properties": {
        "a": {"type": "integer"}, "b": {"type": "integer"}, "c": {"type": "integer"},
        "d": {"type": "integer"}}, "required": ["b"]},
    "all_optional": {"type": "object", "properties": {
        "x": {"type": "integer"}, "y": {"type": "integer"}, "z": {"type": "integer"}},
        "required": []},
    "enum_int_bool": {"type": "object", "properties": {
        "dir": {"enum": ["north", "south"]}, "n": {"type": "integer"},
        "ok": {"type": "boolean"}}, "required": ["dir", "n", "ok"]},
    "tool_call": {"anyOf": [
        {"type": "object", "properties": {
            "name": {"const": "get_weather"},
            "arguments": {"type": "object", "properties": {"unit": {"enum": ["c", "f"]}},
                          "required": ["unit"], "additionalProperties": False}},
         "required": ["name", "arguments"]},
        {"type": "object", "properties": {
            "name": {"const": "lights"},
            "arguments": {"type": "object", "properties": {"on": {"type": "boolean"}},
                          "required": ["on"], "additionalProperties": False}},
         "required": ["name", "arguments"]}]},
    "number_and_null": {"type": "object", "properties": {
        "v": {"type": "number"}, "z": {"type": "null"}}, "required": ["v", "z"]},
}
# (kind, payload) of every compiled grammar held bit for bit
SPECS = ([("regex", p) for p in REGEXES]
         + [("json_schema", json.dumps(s)) for s in SCHEMAS.values()]
         + [("json_object", "")])
SPEC_IDS = (["regex:" + p for p in REGEXES] + ["schema:" + k for k in SCHEMAS]
            + ["json_object"])


class _StubHF:
    """The transformers surface ``token_byte_table`` touches (the reference
    tests' stub)."""

    def __init__(self, pieces, special_ids):
        self._pieces = pieces
        self.all_special_ids = special_ids

    def convert_ids_to_tokens(self, ids):
        return [self._pieces[i] for i in ids]


class _StubTokenizer:
    def __init__(self, pieces, special_ids):
        self._tok = _StubHF(pieces, special_ids)
        self.bos_token_id = 0
        self.eos_token_id = 1
        self.pad_token_id = None


def _spm_pieces():
    """A SentencePiece-convention vocab: specials, word-start pieces, raw
    byte pieces and plain pieces."""
    words = ["north", "south", "cat", "dog", "yes", "no", "maybe", "true", "false", "a", "b"]
    pieces = ["<s>", "</s>"] + ["▁" + w for w in words] + words + ["▁"]
    pieces += ["<0x{:02X}>".format(b) for b in range(256)]
    pieces += ["{", "}", "\"", ":", ",", "[", "]", "▁{", "\":", "0", "12", "-", "."]
    return pieces


def _bpe_pieces():
    """A byte-level-BPE (GPT-2 alphabet) vocab: 'Ġ' is the space byte."""
    decoder = ref._gpt2_byte_decoder()
    alphabet = sorted(decoder, key=decoder.get)
    pieces = ["<s>", "</s>"] + alphabet
    pieces += ["Ġnorth", "north", "Ġcat", "cat", "Ġdog", "{\"", "\":", "true", "false", "Ġ1",
               "12", "Ċ"]
    return pieces


TOKENIZERS = {
    "byte": (lambda: RefByteTokenizer(512), lambda: ByteTokenizer(512), 512, 257),
    "spm": (lambda: _StubTokenizer(_spm_pieces(), [0, 1]),
            lambda: _StubTokenizer(_spm_pieces(), [0, 1]), len(_spm_pieces()), 1),
    "bpe": (lambda: _StubTokenizer(_bpe_pieces(), [0, 1]),
            lambda: _StubTokenizer(_bpe_pieces(), [0, 1]), len(_bpe_pieces()), 1),
}


@pytest.mark.parametrize("tok_name", sorted(TOKENIZERS))
@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_compile_guided_is_bitwise_the_reference(spec, tok_name):
    make_ref, make_port, vocab, eos = TOKENIZERS[tok_name]
    want = ref.compile_guided(ref.GuidedSpec(*spec), make_ref(), vocab, eos)
    got = port.compile_guided(port.GuidedSpec(*spec), make_port(), vocab, eos)
    assert got.mask_bits.dtype == want.mask_bits.dtype == np.uint8
    assert got.byte_trans.dtype == want.byte_trans.dtype == np.int16
    np.testing.assert_array_equal(got.mask_bits, want.mask_bits)
    np.testing.assert_array_equal(got.byte_trans, want.byte_trans)
    assert (got.start, got.terminal, got.n_states) == (want.start, want.terminal,
                                                         want.n_states)
    assert port.GuidedSpec(*spec).cache_key() == ref.GuidedSpec(*spec).cache_key()


@pytest.mark.parametrize("tok_name", sorted(TOKENIZERS))
def test_token_byte_tables_equal_the_reference(tok_name):
    make_ref, make_port, vocab, _eos = TOKENIZERS[tok_name]
    want = ref.token_byte_table(make_ref(), vocab)
    got = port.token_byte_table(make_port(), vocab)
    assert got == want
    for a, b in zip(port.build_token_byte_arrays(got), ref.build_token_byte_arrays(want)):
        np.testing.assert_array_equal(a, b)
    assert (port._is_spm_tokenizer(make_port(), vocab)
            == ref._is_spm_tokenizer(make_ref(), vocab) == (tok_name == "spm"))


PROBES = ["", "yes", "no", "nope", "ye", "maybe", "0", "-7", "142", "01", "-", "+1", "abx",
          "cabx", "ax", "abcax", "abX", "a", "aab", "abc", "ac", "b", "cc", "09:30", "9:30",
          "x!", "a1", "7", "42", "42$", "^42", "ab!", "x.y", "cat", "dog", "north", " north",
          "west", "hello world.", "()(", "éé", "\n"]


@pytest.mark.parametrize("pattern", REGEXES)
def test_byte_dfa_is_the_reference(pattern):
    want = ref.ByteDFA.from_regex(pattern)
    got = port.ByteDFA.from_regex(pattern)
    np.testing.assert_array_equal(got.trans, want.trans)
    np.testing.assert_array_equal(got.accepting, want.accepting)
    for probe in PROBES:
        data = probe.encode()
        assert got.matches(data) == want.matches(data), (pattern, probe)


@pytest.mark.parametrize("pattern", BAD_REGEXES)
def test_regex_errors_are_the_reference(pattern):
    with pytest.raises(ref.RegexError) as want:
        ref.ByteDFA.from_regex(pattern)
    with pytest.raises(port.RegexError) as got:
        port.ByteDFA.from_regex(pattern)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_schema_lowering_is_the_reference(name):
    schema = SCHEMAS[name]
    assert port.json_schema_to_regex(schema) == ref.json_schema_to_regex(schema)


def test_value_and_object_regexes_are_the_reference():
    for depth in (1, 2, 3):
        assert port.json_value_regex(depth) == ref.json_value_regex(depth)
        assert port.json_object_regex(depth) == ref.json_object_regex(depth)
    n = 24
    wide = {"type": "object",
            "properties": {"p{}".format(i): {"type": "integer"} for i in range(n)}}
    assert port.json_schema_to_regex(wide) == ref.json_schema_to_regex(wide)


def test_unknown_kind_raises_as_the_reference():
    tok = ByteTokenizer(512)
    with pytest.raises(port.RegexError, match="unknown guided kind"):
        port.compile_guided(port.GuidedSpec("yaml", ""), tok, 512, 257)


# -- the device-side mask and walk --------------------------------------------

def _ref_mask(logits, gstate, mask_bits):
    """The reference engine's ``_guided_mask`` (llm/engine.py:1599-1613)."""
    nb = logits.shape[0]
    guided_on = gstate >= 0
    rows = mask_bits[jnp.clip(gstate, 0)]
    bits = (rows[:, :, None] >> jnp.arange(8, dtype=jnp.uint8)) & 1
    allowed = bits.reshape(nb, -1)[:, : logits.shape[-1]] > 0
    allowed = jnp.where(guided_on[:, None], allowed, True)
    any_ok = jnp.any(allowed, axis=-1, keepdims=True)
    allowed = allowed | ~any_ok
    return jnp.where(allowed, logits, jnp.float32(-1e30))


def _ref_advance(gstate, sampled, ok, byte_trans, tok_bytes, tok_len):
    """The reference engine's ``_guided_advance`` (llm/engine.py:1615-1632),
    its fori_loop unrolled."""
    tb = tok_bytes[sampled]
    tl = tok_len[sampled]
    s = jnp.clip(gstate, 0)
    for i in range(tok_bytes.shape[1]):
        nxt = byte_trans[jnp.clip(s, 0), tb[:, i].astype(jnp.int32)].astype(jnp.int32)
        s = jnp.where(i < tl, nxt, s)
    return jnp.where((gstate >= 0) & ok, s, gstate)


def _combined_tables():
    """Two grammars over the byte tokenizer in one combined table (the
    engine's layout: the second at its offset), padded with an all-masked
    row, and the token byte arrays."""
    tok = ByteTokenizer(512)
    grams = [port.compile_guided(port.GuidedSpec("regex", "(north|south)"), tok, 512, 257),
             port.compile_guided(port.GuidedSpec("json_object"), tok, 512, 257)]
    masks, bytes_, offset = [], [], 0
    for g in grams:
        bt = g.byte_trans.astype(np.int32)
        bytes_.append(np.where(bt == port.DEAD, port.DEAD, bt + offset).astype(np.int16))
        masks.append(g.mask_bits)
        offset += g.n_states
    masks.append(np.zeros((1, masks[0].shape[1]), np.uint8))
    bytes_.append(np.full((1, 256), -1, np.int16))
    tb, tl = port.build_token_byte_arrays(port.token_byte_table(tok, 512))
    # a long token: one over 16 bytes stays unwalkable (length 0)
    return np.vstack(masks), np.vstack(bytes_), tb, tl, grams[0].n_states


def test_guided_mask_equals_the_reference():
    mask_bits, _bt, _tb, _tl, off = _combined_tables()
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((7, 512)).astype(np.float32)
    # unguided, start of each grammar, mid-grammar, a terminal, the
    # all-masked padding row (degrades to unconstrained), and a state past
    # the table (a stale one of a larger bucket: both clamp it)
    gstate = np.array([-1, 0, off, 3, off - 1, mask_bits.shape[0] - 1, mask_bits.shape[0] + 7],
                      np.int32)
    want = np.asarray(_ref_mask(jnp.asarray(logits), jnp.asarray(gstate),
                                jnp.asarray(mask_bits)))
    got = guided_mask(torch.from_numpy(logits), torch.from_numpy(gstate),
                      torch.from_numpy(mask_bits)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == GUIDED_FILL).any() and (got[0] == logits[0]).all()
    assert (got[5] == logits[5]).all()


def test_guided_advance_equals_the_reference():
    _mb, byte_trans, tb, tl, off = _combined_tables()
    rng = np.random.default_rng(1)
    for trial in range(20):
        # states past the table too (a stale one of a larger bucket)
        gstate = rng.integers(-1, byte_trans.shape[0] + 5, size=8).astype(np.int32)
        sampled = rng.integers(0, 512, size=8).astype(np.int32)
        if trial % 2:
            # tokens of the grammar's own bytes, EOS and specials
            sampled[:4] = [ord("n"), ord("{"), 257, 256]
        ok = rng.random(8) < 0.8
        want = np.asarray(_ref_advance(jnp.asarray(gstate), jnp.asarray(sampled),
                                       jnp.asarray(ok), jnp.asarray(byte_trans),
                                       jnp.asarray(tb), jnp.asarray(tl)))
        got = guided_advance(torch.from_numpy(gstate), torch.from_numpy(sampled),
                             torch.from_numpy(ok), torch.from_numpy(byte_trans),
                             torch.from_numpy(tb), torch.from_numpy(tl)).numpy()
        np.testing.assert_array_equal(got, want)
