"""The port's Whisper model (``models/whisper.py``) and HF converter
(``engines/importers/convert_hf_whisper.py``) against the reference's.

- The model: the reference's whisper-test tree (every bias and LayerNorm
  leaf perturbed, float32) carried over by ``convert_params``; ``encode``,
  ``decoder_forward``, ``decode`` step by step (against the reference's
  ``decoder_forward`` and against its own ``decode``, past the cache's end
  where JAX clamps) and ``cross_attention_alignment`` with and without
  ``n_frames``, within 1e-4 of the reference's.
- Against ``transformers`` (these tests only skip without it), at the
  reference's own tolerances in ``tests/test_whisper.py``: the encoder at
  2e-4, ``decoder_forward`` at 2e-3, the alignment probabilities at 2e-3.
- The converter: ``convert_state_dict`` and ``config_from_hf`` equal the
  reference's on a random-init HF model, ``prompt_ids_from_tokenizer`` on a
  stand-in tokenizer, and the converted tree's bundle read back by the
  port's ``load_bundle``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearml_serving_tpu import models as jax_models
from clearml_serving_tpu.engines.importers import convert_hf_whisper as ref_convert
from clearml_serving_tpu_torch import models
from clearml_serving_tpu_torch.engines.importers import convert_hf_whisper as port_convert

TOL = 1e-4
CFG = {"preset": "whisper-test"}
PROMPT = [300, 301, 302, 11, 23, 42, 7]


def _perturbed(tree, seed):
    """The reference's tree as numpy, its zero-initialised biases and
    LayerNorm offsets (and scales) perturbed."""
    rng = np.random.default_rng(seed)

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, key) for v in node]
        a = np.asarray(node)
        if key in ("b", "bias", "scale"):
            return (a + 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return walk(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def pair():
    """(reference bundle, its tree, port bundle, port params) on the same
    perturbed weights."""
    ref = jax_models.build_model("whisper", dict(CFG))
    tree = _perturbed(ref.init(jax.random.PRNGKey(0)), 0)
    port = models.build_model("whisper", dict(CFG))
    return ref, tree, port, port.convert_params(tree, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _mel(seed, batch=2, frames=100):
    return np.random.default_rng(seed).random((batch, 16, frames)).astype(np.float32)


def test_perturbation_reaches_every_constant_leaf(pair):
    """Biases and LayerNorm leaves are no longer their init constants, so a
    dropped leaf would show in the comparisons below."""
    _ref, tree, _port, _params = pair
    assert not np.all(tree["conv1"]["b"] == 0) and not np.all(tree["enc_final_norm"]["scale"] == 1)
    for layer in tree["dec_layers"]:
        assert not np.all(layer["cross"]["q"]["b"] == 0) and "b" not in layer["cross"]["k"]
        assert not np.all(layer["ffn_norm"]["bias"] == 0)


@pytest.mark.parametrize("frames", [100, 128, 37])
def test_encode_equals_the_reference(pair, frames):
    """The convolutions (stride 1 then 2, padding 1: ceil(frames / 2)
    positions), the stored positions and the layers."""
    ref, tree, port, params = pair
    mel = _mel(frames, frames=frames)
    want = np.asarray(ref.encode(tree, mel))
    got = port.encode(params, _t(mel))
    assert tuple(got.shape) == want.shape == (2, (frames + 1) // 2, 32)
    _close(got, want)


def test_stored_encoder_positions_are_carried_not_recomputed(pair):
    """A bundle's ``enc_pos`` leaf is what the encoder adds, whatever it
    holds."""
    ref, tree, port, _params = pair
    tree = dict(tree, enc_pos=np.random.default_rng(3).standard_normal(
        tree["enc_pos"].shape).astype(np.float32))
    mel = _mel(4)
    _close(port.encode(port.convert_params(tree, "cpu"), _t(mel)), ref.encode(tree, mel))


def test_decoder_forward_and_apply_equal_the_reference(pair):
    ref, tree, port, params = pair
    enc = np.asarray(ref.encode(tree, _mel(5)))
    toks = np.array([PROMPT, [300, 303, 302, 5, 6, 399, 8]], np.int32)
    want = np.asarray(ref.decoder_forward(tree, toks, enc))
    got = port.decoder_forward(params, _t(toks), _t(enc))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 7, 400)
    _close(got, want)
    _close(port.apply(params, _t(toks), _t(enc)), want)


def test_decode_step_by_step_equals_decoder_forward(pair):
    """The serving decode (self-K/V cache written in place, the cross K/V
    made once) against the reference's teacher-forced pass."""
    ref, tree, port, params = pair
    enc = np.asarray(ref.encode(tree, _mel(6)))
    toks = np.array([PROMPT, [300, 303, 302, 5, 6, 399, 8]], np.int32)
    want = np.asarray(ref.decoder_forward(tree, toks, enc))
    cache = port.init_cache(params, _t(enc), 16)
    steps = []
    for i in range(toks.shape[1]):
        logits, cache = port.decode(params, _t(toks[:, i]), cache)
        steps.append(logits.numpy())
    _close(np.stack(steps, axis=1), want)
    assert cache["length"].tolist() == [7, 7]


def test_decode_past_the_cache_end_clamps_as_jax_does(pair):
    """A loop that reaches its budget steps past ``max_len`` (and past
    ``max_target_positions``): JAX clamps the ``dec_pos`` gather and the
    K/V write to the last row; the port does the same, logits and cache
    within 1e-4 of the reference's at every step. The reference's decode
    runs jitted, as its serving loop runs it (inside ``lax.scan``)."""
    ref, tree, port, params = pair
    enc = np.asarray(ref.encode(tree, _mel(7)))
    jcache = ref.init_cache(tree, enc, 5)
    pcache = port.init_cache(params, _t(enc), 5)
    toks = np.array([PROMPT * 6, list(reversed(PROMPT)) * 6], np.int32)
    decode = jax.jit(ref.decode)
    for i in range(36):   # 36 > 32 target positions > 5 cache rows
        jl, jcache = decode(tree, jnp.asarray(toks[:, i]), jcache)
        pl, pcache = port.decode(params, _t(toks[:, i]), pcache)
        _close(pl, jl)
        for key in ("k", "v"):   # the port's cache is heads-major
            _close(pcache[key].transpose(2, 3), jcache[key])
    assert pcache["length"].tolist() == np.asarray(jcache["length"]).tolist() == [36, 36]


def test_init_cache_refills_in_place(pair):
    """``init_cache(out=...)`` zeroes the self-K/V and length and writes
    the cross K/V into the given buffers: the same values as a new cache."""
    ref, tree, port, params = pair
    enc = _t(np.asarray(ref.encode(tree, _mel(8))))
    cache = port.init_cache(params, enc, 8)
    port.decode(params, _t(np.array([300, 301], np.int32)), cache)
    ids = {k: v.data_ptr() for k, v in cache.items()}
    again = port.init_cache(params, enc * 0.5, 8, out=cache)
    fresh = port.init_cache(params, enc * 0.5, 8)
    assert again is cache and {k: v.data_ptr() for k, v in again.items()} == ids
    for key in fresh:
        assert torch.equal(again[key], fresh[key]), key
    want = ref.init_cache(tree, np.asarray(enc * 0.5), 8)
    for key in ("cross_k", "cross_v", "k"):   # the port's cache is heads-major
        _close(again[key].transpose(2, 3), want[key])
    assert again["k"].dtype == again["cross_k"].dtype == torch.float32


@pytest.mark.parametrize("n_frames", [None, 20, 1])
def test_cross_attention_alignment_equals_the_reference(pair, n_frames):
    """The alignment heads' probabilities, masked past ``n_frames`` before
    the softmax (an int or a 0-d tensor, as the reference's dynamic
    scalar)."""
    ref, tree, port, params = pair
    enc = np.asarray(ref.encode(tree, _mel(9)))
    toks = np.array([PROMPT, [300, 303, 302, 5, 6, 399, 8]], np.int32)
    heads = ((0, 0), (1, 1), (1, 0))
    jnf = None if n_frames is None else jnp.asarray(n_frames, jnp.int32)
    want = np.asarray(ref.cross_attention_alignment(tree, toks, enc, heads, jnf))
    pnf = None if n_frames is None else torch.tensor(n_frames, dtype=torch.int32)
    got = port.cross_attention_alignment(params, _t(toks), _t(enc), heads, pnf)
    assert tuple(got.shape) == want.shape == (3, 2, 7, 50)
    _close(got, want)
    if n_frames is not None:
        assert float(got[..., n_frames:].abs().max()) == 0.0
        _close(got.sum(-1), np.ones((3, 2, 7)), 1e-5)


def test_mel_filters_leaf_stays_on_the_host(pair):
    _ref, tree, port, _params = pair
    filters = np.random.default_rng(1).random((201, 16)).astype(np.float32)
    params = port.convert_params(dict(tree, mel_filters=filters), "cpu")
    assert isinstance(params["mel_filters"], np.ndarray)
    np.testing.assert_array_equal(params["mel_filters"], filters)
    assert tuple(params["conv1"]["w"].shape) == (32, 16, 3)   # [out, in, k]


def test_init_matches_the_reference_layout():
    """``init`` gives the reference's leaves, shapes and dtypes (the layout
    a bundle holds), the sinusoids equal to the reference's."""
    ref = jax_models.build_model("whisper", {"preset": "whisper-test", "dtype": "bfloat16"})
    port = models.build_model("whisper", {"preset": "whisper-test", "dtype": "bfloat16"})
    ref_tree = ref.init(jax.random.PRNGKey(0))
    port_tree = port.init(torch.Generator().manual_seed(0))
    want = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    got = jax.tree_util.tree_flatten_with_path(port_tree)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_p, w) in zip(got, want):
        assert tuple(g.shape) == w.shape and str(g.dtype) == "torch." + str(w.dtype), path
    np.testing.assert_array_equal(port_tree["enc_pos"].float().numpy(),
                                  np.asarray(ref_tree["enc_pos"]).astype(np.float32))


# -- against transformers ---------------------------------------------------------

@pytest.fixture(scope="module")
def hf_whisper():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.WhisperConfig(
        vocab_size=51200, d_model=32, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=2, decoder_attention_heads=2,
        encoder_ffn_dim=64, decoder_ffn_dim=64, num_mel_bins=16,
        max_source_positions=64, max_target_positions=32,
    )
    torch.manual_seed(0)
    hf = transformers.WhisperForConditionalGeneration(cfg)
    hf.eval()
    ours = port_convert.config_from_hf(cfg)
    ours["dtype"] = "float32"
    bundle = models.build_model("whisper", ours)
    tree = port_convert.convert_state_dict(hf.state_dict(), ours)
    return transformers, hf, bundle, bundle.convert_params(tree, "cpu")


def test_encoder_matches_hf(hf_whisper):
    _tr, hf, bundle, params = hf_whisper
    mel = np.random.RandomState(0).rand(1, 16, 128).astype(np.float32)
    with torch.no_grad():
        theirs = hf.model.encoder(torch.from_numpy(mel)).last_hidden_state
    _close(bundle.encode(params, _t(mel)), theirs.numpy(), 2e-4)


def test_decoder_forward_matches_hf(hf_whisper):
    _tr, hf, bundle, params = hf_whisper
    mel = np.random.RandomState(1).rand(1, 16, 128).astype(np.float32)
    tokens = np.array([[50258, 50359, 50363, 11, 23, 42]], np.int64)
    enc = bundle.encode(params, _t(mel))
    with torch.no_grad():
        theirs = hf(input_features=torch.from_numpy(mel),
                    decoder_input_ids=torch.from_numpy(tokens)).logits
    _close(bundle.decoder_forward(params, _t(tokens.astype(np.int32)), enc), theirs.numpy(),
           2e-3)


def test_cross_attention_alignment_matches_hf(hf_whisper):
    transformers, hf, bundle, params = hf_whisper
    mel = np.random.RandomState(2).rand(1, 16, 128).astype(np.float32)
    tokens = np.array([[50258, 50359, 50363, 11, 23, 42]], np.int64)
    enc = bundle.encode(params, _t(mel))
    heads = ((0, 0), (0, 1), (1, 0), (1, 1))
    ours = bundle.cross_attention_alignment(params, _t(tokens.astype(np.int32)), enc, heads)
    eager = transformers.WhisperForConditionalGeneration._from_config(
        hf.config, attn_implementation="eager")
    eager.load_state_dict(hf.state_dict())
    eager.eval()
    with torch.no_grad():
        out = eager(input_features=torch.from_numpy(mel),
                    decoder_input_ids=torch.from_numpy(tokens), output_attentions=True)
    for n, (layer, head) in enumerate(heads):
        _close(ours[n, 0], out.cross_attentions[layer][0, head].numpy(), 2e-3)


# -- the converter ------------------------------------------------------------------

def test_convert_state_dict_and_config_equal_the_reference(hf_whisper):
    _tr, hf, _bundle, _params = hf_whisper
    want_cfg = ref_convert.config_from_hf(hf.config)
    assert port_convert.config_from_hf(hf.config) == want_cfg
    sd = hf.state_dict()
    want = jax.tree_util.tree_flatten_with_path(ref_convert.convert_state_dict(sd, want_cfg))[0]
    got = jax.tree_util.tree_flatten_with_path(port_convert.convert_state_dict(sd, want_cfg))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_p, w) in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    # a numpy mapping (no .detach) converts the same, with HF's "model." prefix gone
    bare = {k[len("model."):] if k.startswith("model.") else k: v.numpy() for k, v in sd.items()}
    again = jax.tree_util.tree_flatten_with_path(port_convert.convert_state_dict(bare, want_cfg))[0]
    for (path, g), (_p, w) in zip(again, want):
        np.testing.assert_array_equal(g, w, err_msg=str(path))


def test_converted_bundle_serves_through_load_bundle(hf_whisper, tmp_path):
    """The converted tree, written as a bundle with its mel filters, reads
    back through the port's ``load_bundle`` to the same encoder states."""
    from clearml_serving_tpu_torch.engines.jax_engine import load_bundle, save_bundle

    _tr, hf, bundle, params = hf_whisper
    cfg = dict(port_convert.config_from_hf(hf.config), dtype="float32")
    tree = port_convert.convert_state_dict(hf.state_dict(), cfg)
    tree["mel_filters"] = np.random.default_rng(0).random((201, 16)).astype(np.float32)
    save_bundle(tmp_path / "w", "whisper", cfg, tree)
    loaded, lparams = load_bundle(tmp_path / "w", device="cpu")
    assert isinstance(lparams["mel_filters"], np.ndarray)
    mel = _t(np.random.RandomState(4).rand(1, 16, 64).astype(np.float32))
    assert torch.equal(loaded.encode(lparams, mel), bundle.encode(params, mel))


class _StandInTokenizer:
    """The two methods ``prompt_ids_from_tokenizer`` reads, over large-v3's
    special ids (``<|de|>`` missing, as a language the vocabulary lacks)."""

    eos_token_id = 50257
    IDS = {"<|startoftranscript|>": 50258, "<|en|>": 50259, "<|translate|>": 50359,
           "<|transcribe|>": 50360, "<|notimestamps|>": 50364}

    def __init__(self, ids=None):
        self.ids = dict(self.IDS if ids is None else ids)

    def convert_tokens_to_ids(self, token):
        return self.ids.get(token, -1)


@pytest.mark.parametrize("language,ids", [
    (None, None), ("en", None), ("de", None),
    ("en", {k: v for k, v in _StandInTokenizer.IDS.items() if k != "<|notimestamps|>"}),
])
def test_prompt_ids_from_tokenizer_equal_the_reference(language, ids):
    tok = _StandInTokenizer(ids)
    got = port_convert.prompt_ids_from_tokenizer(tok, language=language)
    assert got == ref_convert.prompt_ids_from_tokenizer(tok, language=language)
    if ids is None:
        assert got["timestamp_begin"] == 50365 and got["time_precision"] == 0.02
        assert got["transcribe_prompt_ids"][-1] == 50364
    else:
        assert "timestamp_begin" not in got
    if language == "en":
        assert got["translate_prompt_ids"][:3] == [50258, 50259, 50359]
