"""An ``llm`` endpoint on a model bundle, behind each package's processor.

The JAX package's ``save_bundle`` writes a ``llama-tiny`` bundle (float32,
seed-0 weights) and a Qwen2-shaped one (QKV biases, norms and biases
perturbed from their constant init); both are registered in each
processor's model registry and served with no ``preset``. Greedy chat
content must be byte-identical on the two apps under ``two_dispatch`` and
``ragged``, with and without ``kv_quant: int8``, and on the loaded weights
quantized to int4. ``replicas: 2`` shares the one loaded model; a process
fleet is refused with the reference's words (its workers rebuild from the
preset)."""

import asyncio
import shutil

import jax
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from clearml_serving_tpu import models as jax_models
from clearml_serving_tpu.engines.jax_engine import save_bundle as jax_save_bundle
from clearml_serving_tpu.serving.endpoints import ModelEndpoint as JaxEndpoint
from clearml_serving_tpu.serving.main import build_app as jax_build_app
from clearml_serving_tpu.serving.model_request_processor import (
    ModelRequestProcessor as JaxProcessor,
)
from clearml_serving_tpu_torch.engines.base import EndpointModelError
from clearml_serving_tpu_torch.serving.endpoints import ModelEndpoint
from clearml_serving_tpu_torch.serving.main import build_app
from clearml_serving_tpu_torch.serving.model_request_processor import ModelRequestProcessor

URL = "chat"
CHAT = "/serve/openai/v1/chat/completions"
BASE = {"max_batch": 2, "max_seq_len": 128, "prefill_buckets": [32, 64], "cache": "paged",
        "pipeline_depth": 1, "seed": 0}
ARMS = {
    "two_dispatch": {"scheduler": "two_dispatch"},
    "two_dispatch_int8": {"scheduler": "two_dispatch", "kv_quant": "int8"},
    "ragged": {"scheduler": "ragged", "step_token_budget": 12, "ragged_decode_steps": 2},
    "ragged_int8": {"scheduler": "ragged", "step_token_budget": 12, "ragged_decode_steps": 2,
                    "kv_quant": "int8"},
    "int4": {"scheduler": "two_dispatch", "weight_quant": "int4"},
}
BODIES = [
    {"model": URL, "messages": [{"role": "user", "content": "name three colours of the sea"}],
     "max_tokens": 12},
    {"model": URL, "max_tokens": 10, "messages": [
        {"role": "system", "content": "be brief"}, {"role": "user", "content": "hello"}]},
]
QWEN2 = {"preset": "llama-tiny", "dtype": "float32", "attn_bias": True,
         "rope_theta": 1000000.0, "norm_eps": 1e-6}


def _perturbed(params, seed=0):
    """Seeded values on the leaves the reference initializes to a constant
    (norms, QKV biases), so a dropped leaf shows in the stream."""
    rng = np.random.default_rng(seed)

    def fix(key, a):
        if key.endswith("norm"):
            return (np.asarray(a) + 0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
        if key in ("bq", "bk", "bv"):
            return (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    out = {k: fix(k, v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: fix(k, v) for k, v in layer.items()} for layer in params["layers"]]
    return out


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """{name: bundle dir} written by the JAX package's save_bundle."""
    root = tmp_path_factory.mktemp("bundles")
    out = {}
    for name, cfg, perturb in (("llama", {"preset": "llama-tiny", "dtype": "float32"}, False),
                               ("qwen2", QWEN2, True)):
        bundle = jax_models.build_model("llama", cfg)
        params = jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0)))
        if perturb:
            params = _perturbed(params)
        jax_save_bundle(root / name, "llama", cfg, params)
        out[name] = root / name
    return out


def _processor(cls, endpoint_cls, root, bundle_dir, engine_cfg, **kw):
    mrp = cls(state_root=str(root), force_create=True, name="bundle", **kw)
    rec = mrp.registry.register("tiny llama", path=bundle_dir, framework="jax")
    mrp.add_endpoint(endpoint_cls(engine_type="llm", serving_url=URL, model_id=rec.id,
                                  auxiliary_cfg={"engine": dict(engine_cfg)}))
    mrp.serialize()
    mrp.deserialize(skip_sync=True)
    return mrp


def _contents(app):
    async def runner():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            out = []
            for body in BODIES:
                r = await client.post(CHAT, json=body)
                assert r.status == 200, await r.text()
                choice = (await r.json())["choices"][0]
                out.append((choice["message"]["content"], choice["finish_reason"]))
            return out
        finally:
            await client.close()

    return asyncio.run(runner())


def _both(tmp_path, bundle_dir, engine_cfg):
    jax_mrp = _processor(JaxProcessor, JaxEndpoint, tmp_path / "ref", bundle_dir, engine_cfg)
    port_mrp = _processor(ModelRequestProcessor, ModelEndpoint, tmp_path / "port", bundle_dir,
                          engine_cfg, device="cpu")
    want = _contents(jax_build_app(jax_mrp))
    got = _contents(build_app(port_mrp))
    return want, got, port_mrp


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_llama_bundle_greedy_content_equals_the_reference(bundles, tmp_path, arm):
    want, got, port_mrp = _both(tmp_path, bundles["llama"], dict(BASE, **ARMS[arm]))
    assert got == want
    assert all(text for text, _finish in got)
    if "weight_quant" in ARMS[arm]:
        engine = port_mrp._engine_processor_lookup[URL].engine
        assert engine.health()["weights"]["quant"] == ARMS[arm]["weight_quant"]


def test_qwen2_bundle_with_biases_equals_the_reference(bundles, tmp_path):
    want, got, port_mrp = _both(tmp_path, bundles["qwen2"], dict(BASE, **ARMS["ragged"]))
    assert got == want
    model = port_mrp._engine_processor_lookup[URL].engine.model
    assert model.config["attn_bias"] is True


def test_replicas_share_the_loaded_model(bundles, tmp_path):
    cfg = dict(BASE, replicas=2)
    port_mrp = _processor(ModelRequestProcessor, ModelEndpoint, tmp_path / "port",
                          bundles["llama"], cfg, device="cpu")
    got = _contents(build_app(port_mrp))
    group = port_mrp._engine_processor_lookup[URL].engine
    first, second = group.replicas
    assert first.engine.model is second.engine.model
    want = _contents(jax_build_app(_processor(JaxProcessor, JaxEndpoint, tmp_path / "ref",
                                              bundles["llama"], BASE)))
    assert got == want


def test_process_fleet_on_a_bundle_is_refused_as_the_reference_refuses(bundles, tmp_path):
    cfg = dict(BASE, replicas=2, replica_backend="process")
    port_mrp = _processor(ModelRequestProcessor, ModelEndpoint, tmp_path / "port",
                          bundles["llama"], cfg, device="cpu")
    with pytest.raises(EndpointModelError, match="rebuild the model from the preset spec"):
        port_mrp._get_processor(URL)
    jax_mrp = _processor(JaxProcessor, JaxEndpoint, tmp_path / "ref", bundles["llama"], cfg)
    from clearml_serving_tpu.engines.base import EndpointModelError as JaxModelError

    with pytest.raises(JaxModelError, match="rebuild the model from the preset spec"):
        jax_mrp._get_processor(URL)


def _hf_tokenizer_files(path):
    """A word-level fast tokenizer written in process (no download): the
    files a bundle ships beside params.msgpack."""
    pytest.importorskip("transformers")
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    words = ["[UNK]", "<s>", "</s>", "name", "three", "colours", "of", "the", "sea", "hello",
             "be", "brief"] + [chr(c) for c in range(ord("a"), ord("z") + 1)]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>", eos_token="</s>",
                            unk_token="[UNK]").save_pretrained(str(path))


def test_bundle_tokenizer_files_serve_as_the_reference(bundles, tmp_path):
    """A bundle with tokenizer files: both apps load HuggingFace's tokenizer
    through ``load_tokenizer`` and answer the same content; broken files
    fall back to the byte tokenizer on both."""
    from clearml_serving_tpu.llm.tokenizer import load_tokenizer as ref_load_tokenizer
    from clearml_serving_tpu_torch.llm.tokenizer import load_tokenizer

    bundle = tmp_path / "with_tok"
    shutil.copytree(bundles["llama"], bundle)
    _hf_tokenizer_files(bundle)
    port_tok, ref_tok = load_tokenizer(str(bundle), 512), ref_load_tokenizer(str(bundle), 512)
    assert type(port_tok).__name__ == type(ref_tok).__name__ == "HFTokenizer"
    text = "name three colours of the sea"
    assert port_tok.encode(text) == ref_tok.encode(text)
    assert port_tok.apply_chat_template(BODIES[0]["messages"]) == ref_tok.apply_chat_template(
        BODIES[0]["messages"])
    want, got, port_mrp = _both(tmp_path, bundle, dict(BASE, **ARMS["two_dispatch"]))
    assert got == want
    assert type(port_mrp._engine_processor_lookup[URL].tokenizer).__name__ == "HFTokenizer"
    broken = tmp_path / "broken"
    broken.mkdir()
    (broken / "tokenizer_config.json").write_text("{not json")
    port_tok, ref_tok = load_tokenizer(str(broken), 300), ref_load_tokenizer(str(broken), 300)
    assert type(port_tok).__name__ == type(ref_tok).__name__ == "ByteTokenizer"
    assert port_tok.vocab_size == ref_tok.vocab_size == 300
