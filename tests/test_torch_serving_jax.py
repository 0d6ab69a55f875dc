"""``jax`` endpoints through ``/serve/{tail}``: a port processor against the
reference processor, over the same payload and the same example code.

- The MNIST endpoint of examples/jax_mnist/readme.md (image float32
  ``[28, 28]``, buckets ``[1, 4, 16, 64]``, the example's preprocess.py),
  over a ``cnn`` bundle the JAX package's ``save_bundle`` writes from the
  example's config (biases perturbed).
- The BERT ONNX endpoint of examples/bert/readme.md (``input_ids`` /
  ``attention_mask`` int64 ``[128]``, the example's preprocess.py, which
  falls back to its whitespace ids without tokenizer files) over a stock
  HuggingFace token-classification export at bert-tiny width, and the same
  endpoint on a native ``bert-tiny`` bundle (int32 ids).
- Statuses and bodies are equal (probabilities within 1e-4), and the
  engines' outputs on the same preprocessed batch hold within 1e-4.
- A ``jax_grpc`` endpoint (the BERT example's topology) answers through each
  package's in-process engine server as the reference's does.
"""

import asyncio

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
from clearml_serving_tpu_torch.serving.endpoints import ModelEndpoint
from clearml_serving_tpu_torch.serving.main import build_app
from clearml_serving_tpu_torch.serving.model_request_processor import ModelRequestProcessor

TOL = 1e-4
MNIST_CONFIG = {"in_hw": [28, 28], "in_ch": 1, "channels": [32, 64], "dense": 128,
                "out_dim": 10}
BERT_ENDPOINT = dict(input_name=["input_ids", "attention_mask"], input_size=[[128], [128]],
                     output_name="logits", output_type="float32",
                     preprocess_code="examples/bert/preprocess.py")
TEXTS = ["George lives in Seattle", "the quick brown fox jumps over the lazy dog again"]


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, key) for v in node]
        a = np.asarray(node)
        if key.startswith("b") or key in ("scale", "bias"):
            return (a.astype(np.float32) + 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return walk(jax.tree.map(np.asarray, tree))


def _write_bundle(path, arch, cfg, seed):
    bundle = jax_models.build_model(arch, cfg)
    jax_save_bundle(path, arch, cfg, _perturbed(bundle.init(jax.random.PRNGKey(seed)), seed))
    return path


def _processors(tmp_path, payload, framework, url, preprocess_code=None, **spec):
    """(reference, port) processors serving ``payload`` as ``url``."""
    out = []
    for name, cls, ep_cls, kw in (("ref", JaxProcessor, JaxEndpoint, {}),
                                  ("port", ModelRequestProcessor, ModelEndpoint,
                                   {"device": "cpu"})):
        mrp = cls(state_root=str(tmp_path / name), force_create=True, name="jx", **kw)
        rec = mrp.registry.register("model", path=payload, framework=framework)
        mrp.add_endpoint(ep_cls(engine_type="jax", serving_url=url, model_id=rec.id, **spec),
                         preprocess_code=preprocess_code)
        mrp.serialize()
        mrp.deserialize(skip_sync=True)
        out.append(mrp)
    return out


def _post_all(app, url, bodies):
    async def runner():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            out = []
            for body in bodies:
                r = await client.post("/serve/" + url, json=body)
                out.append((r.status, await r.json()))
            return out
        finally:
            await client.close()

    return asyncio.run(runner())


def _same(got, want, path="$"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            _same(got[k], want[k], "{}.{}".format(path, k))
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, "{}[{}]".format(path, i))
    elif isinstance(want, float):
        assert abs(got - want) <= TOL + TOL * abs(want), (path, got, want)
    else:
        assert got == want, (path, got, want)


def _held(ref, port, url, bodies):
    want = _post_all(jax_build_app(ref), url, bodies)
    got = _post_all(build_app(port), url, bodies)
    for (gs, gb), (ws, wb) in zip(got, want):
        assert gs == ws == 200, (gs, ws, gb, wb)
        _same(gb, wb)
    return got


def test_mnist_endpoint_equals_the_reference(tmp_path):
    bundle = _write_bundle(tmp_path / "mnist-bundle", "cnn", MNIST_CONFIG, seed=0)
    ref, port = _processors(
        tmp_path, bundle, "jax", "test_model_mnist", input_name="image",
        input_type="float32", input_size=[28, 28], auxiliary_cfg={"batching": {
            "buckets": [1, 4, 16, 64]}},
        preprocess_code="examples/jax_mnist/preprocess.py")
    rng = np.random.default_rng(0)
    images = [rng.random((28, 28)).astype(np.float32) for _ in range(3)]
    got = _held(ref, port, "test_model_mnist", [{"image": im.tolist()} for im in images])
    assert all(set(body) == {"digit", "probs"} and len(body["probs"]) == 10
               for _status, body in got)
    engine = port._engine_processor_lookup["test_model_mnist"]
    assert engine._buckets == [1, 4, 16, 64]
    # a batch of 5 pads to the bucket of 16; the engines agree on its rows
    batch = {"image": np.stack([rng.random((28, 28)) for _ in range(5)]).astype(
        np.float32)}
    want = ref._engine_processor_lookup["test_model_mnist"].process(batch, {})
    out = engine.process(batch, {})
    assert out.shape == want.shape == (5, 10)
    np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)


def _hf_token_classifier_onnx(path):
    transformers = pytest.importorskip("transformers")
    import torch

    from clearml_serving_tpu.engines.importers.torchscript_import import (
        export_torch_to_onnx_bytes,
    )

    cfg = transformers.BertConfig(vocab_size=30522, hidden_size=64, num_hidden_layers=2,
                                  num_attention_heads=2, intermediate_size=128,
                                  max_position_embeddings=128, num_labels=9)
    torch.manual_seed(0)

    class Logits(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = transformers.BertForTokenClassification(cfg)

        def forward(self, input_ids, attention_mask):
            return self.model(input_ids=input_ids, attention_mask=attention_mask).logits

    m = Logits()
    m.eval()
    path.write_bytes(export_torch_to_onnx_bytes(m, [[1, 128], [1, 128]], ["int64", "int64"]))
    return path


@pytest.mark.parametrize("payload", ["onnx", "native"])
def test_bert_endpoint_equals_the_reference(tmp_path, payload):
    if payload == "onnx":
        path = _hf_token_classifier_onnx(tmp_path / "model.onnx")
        spec = dict(BERT_ENDPOINT, input_type=["int64", "int64"])
    else:
        path = _write_bundle(tmp_path / "bert-bundle", "bert",
                             {"preset": "bert-tiny", "dtype": "float32", "vocab_size": 30522},
                             seed=1)
        spec = dict(BERT_ENDPOINT, input_type=["int32", "int32"])
    ref, port = _processors(tmp_path, path, "onnx" if payload == "onnx" else "jax",
                            "transformer_model", **spec)
    got = _held(ref, port, "transformer_model", [{"text": t} for t in TEXTS])
    assert [len(body["labels"]) for _s, body in got] == [len(t.split()) for t in TEXTS]
    # the engines' logits on one preprocessed batch
    proc = port._engine_processor_lookup["transformer_model"]
    data = proc.preprocess({"text": TEXTS[1]}, {})
    want = ref._engine_processor_lookup["transformer_model"].process(data, {})
    out = proc.process(data, {})
    assert out.shape == want.shape == (1, 128, 9)
    np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)


def test_jax_grpc_endpoint_serves_through_an_in_process_engine_server(tmp_path):
    """The BERT example's topology (examples/bert/readme.md): a ``jax_grpc``
    endpoint over a native bert-tiny bundle, the example's I/O spec,
    preprocess.py and batching knobs. Each package's router reaches its own
    engine server, in process, over loopback gRPC; the bodies are equal and
    the port's engine server ran the model, not its router."""
    from clearml_serving_tpu.engine_server.repo import EngineModelRepo as JaxRepo
    from clearml_serving_tpu.engine_server.server import make_server as jax_make_server
    from clearml_serving_tpu_torch.engine_server.repo import EngineModelRepo
    from clearml_serving_tpu_torch.engine_server.server import make_server

    path = _write_bundle(tmp_path / "bert-bundle", "bert",
                         {"preset": "bert-tiny", "dtype": "float32", "vocab_size": 30522},
                         seed=2)
    spec = dict(BERT_ENDPOINT, input_type=["int32", "int32"], auxiliary_cfg={
        "batching": {"preferred_batch_size": 16, "max_queue_delay_us": 5000}})
    preprocess = spec.pop("preprocess_code")
    bodies = [{"text": t} for t in TEXTS]
    out = {}
    for name, cls, ep_cls, repo_cls, serve, app, kw in (
            ("ref", JaxProcessor, JaxEndpoint, JaxRepo, jax_make_server, jax_build_app, {}),
            ("port", ModelRequestProcessor, ModelEndpoint, EngineModelRepo, make_server,
             build_app, {"device": "cpu"})):
        mrp = cls(state_root=str(tmp_path / name), force_create=True, name="g", **kw)
        rec = mrp.registry.register("bert ner", path=path, framework="jax")
        mrp.add_endpoint(ep_cls(engine_type="jax_grpc", serving_url="transformer_model",
                                model_id=rec.id, **spec),
                         preprocess_code=preprocess)
        mrp.serialize()

        async def run():
            repo = repo_cls(cls(service_id=mrp.get_id(), state_root=str(tmp_path / name),
                                **kw), **kw)
            assert repo.sync() == 1
            server, port = serve(repo, 0)
            await server.start()
            try:
                mrp.configure(external_engine_grpc_address="127.0.0.1:{}".format(port))
                mrp.deserialize(skip_sync=True)
                client = TestClient(TestServer(app(mrp)))
                await client.start_server()
                try:
                    got = []
                    for body in bodies:
                        r = await client.post("/serve/transformer_model", json=body)
                        got.append((r.status, await r.json()))
                    return got, repo.list_models()["transformer_model"]
                finally:
                    await client.close()
            finally:
                await server.stop(None)

        out[name] = asyncio.run(run())
    (got, port_info), (want, _ref_info) = out["port"], out["ref"]
    for (gs, gb), (ws, wb) in zip(got, want):
        assert gs == ws == 200, (gs, ws, gb, wb)
        _same(gb, wb)
    assert [len(body["labels"]) for _s, body in got] == [len(t.split()) for t in TEXTS]
    assert port_info["requests_served"] == len(TEXTS) and port_info["buckets"][0] == 1


USER_CODE = """
import numpy as np


class Preprocess:
    def load(self, local_file_name):
        return lambda x: x * 2 + 1

    def postprocess(self, data, state, collect_fn=None):
        return {"y": np.asarray(data).tolist(), "rows": int(np.asarray(data).shape[0])}
"""


def test_user_load_callable_replaces_the_loader(tmp_path):
    """A user ``load()`` returning a callable: the engine pads the batch to
    its bucket, calls it (eagerly, on device tensors in the port; jitted
    in the reference), slices the rows back; the user's postprocess
    answers. Bodies equal."""
    code = tmp_path / "user.py"
    code.write_text(USER_CODE)
    ref, port = _processors(tmp_path, code, "custom", "doubler", preprocess_code=str(code),
                            input_type="float32", input_size=[3])
    bodies = [[[1.0, 2.0, 3.0]], [[0.5, 0.25, 0.0]] * 3]
    got = _held(ref, port, "doubler", bodies)
    assert got[1][1] == {"y": [[2.0, 1.5, 1.0]] * 3, "rows": 3}
    assert port._engine_processor_lookup["doubler"].engine.health()["eager_runs"] == 2
