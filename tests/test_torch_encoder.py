"""The encoder routes of the ``llm`` engine type: the port's ``EncoderCore``
(llm/encoder.py) against the reference's on the same bert-tiny weights, and
the encoder cases of the reference's ``tests/test_llm_openai.py`` over HTTP
on both packages' apps.

- ``EncoderCore``: the reference's tree (bias and norm leaves perturbed,
  f32), carried over by ``models/bert.py::convert_params``; embed (mean and
  CLS, normalized or not), token states, classify, cross-encoder (one
  label) and bi-encoder ``score_pairs``, rerank, inputs past the largest
  batch bucket (chunks in different seq buckets) and at ``max_seq_len``,
  all within 1e-5 of the reference's.
- HTTP: one bundle the reference's ``save_bundle`` wrote, served as an
  ``llm`` endpoint with ``task: embed`` by each package's processor; every
  encoder route's JSON equal apart from ids (values within 1e-5), the
  generation routes' refusal, a plain POST (embeddings), an unknown task.
- The port's own: the ``arch: bert`` preset on seed weights, the audio
  tasks refused on a BERT model with ``AudioCore``'s words, the encoder's
  thread and its release on eviction.
"""

import asyncio
import base64

import jax
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from clearml_serving_tpu import models as jax_models
from clearml_serving_tpu.engines.jax_engine import save_bundle as jax_save_bundle
from clearml_serving_tpu.llm.encoder import EncoderCore as RefEncoder
from clearml_serving_tpu.serving.endpoints import ModelEndpoint as JaxEndpoint
from clearml_serving_tpu.serving.main import build_app as jax_build_app
from clearml_serving_tpu.serving.model_request_processor import (
    ModelRequestProcessor as JaxProcessor,
)
from clearml_serving_tpu_torch import models
from clearml_serving_tpu_torch.llm.encoder import EncoderCore
from clearml_serving_tpu_torch.serving.endpoints import ModelEndpoint
from clearml_serving_tpu_torch.serving.main import build_app
from clearml_serving_tpu_torch.serving.model_request_processor import ModelRequestProcessor

TOL = 1e-5
BERT = {"preset": "bert-tiny", "dtype": "float32", "num_labels": 3}
SEQ_BUCKETS = [16, 32]
BATCH_BUCKETS = [1, 2, 4]


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


def _pair(cfg=BERT, seed=0, **kw):
    """(reference core, port core) over the same weights."""
    ref_bundle = jax_models.build_model("bert", cfg)
    tree = _perturbed(ref_bundle.init(jax.random.PRNGKey(seed)), seed)
    port_bundle = models.build_model("bert", cfg)
    kw.setdefault("seq_buckets", SEQ_BUCKETS)
    kw.setdefault("batch_buckets", BATCH_BUCKETS)
    ref = RefEncoder(ref_bundle, jax.tree.map(jax.numpy.asarray, tree), **kw)
    port = EncoderCore(port_bundle, port_bundle.convert_params(tree, device="cpu"),
                       device="cpu", **kw)
    return ref, port


def _ids(rng, n, lo=3, hi=40, vocab=512):
    return [rng.integers(0, vocab, int(rng.integers(lo, hi + 1))).tolist() for _ in range(n)]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL)


# -- EncoderCore ---------------------------------------------------------------

@pytest.mark.parametrize("pooling,normalize", [("mean", True), ("mean", False),
                                               ("cls", True), ("cls", False)])
def test_embed_equals_the_reference(pooling, normalize):
    ref, port = _pair(pooling=pooling, normalize=normalize)
    ids = _ids(np.random.default_rng(1), 3)
    got, want = port.embed(ids), ref.embed(ids)
    assert got.shape == want.shape == (3, 64) and got.dtype == np.float32
    _close(got, want)
    if normalize:
        _close(np.linalg.norm(got, axis=-1), np.ones(3))


def test_token_states_and_classify_equal_the_reference():
    ref, port = _pair()
    ids = _ids(np.random.default_rng(2), 4, lo=1, hi=30)
    states, want = port.token_states(ids), ref.token_states(ids)
    assert [s.shape for s in states] == [(len(i), 64) for i in ids]
    for g, w in zip(states, want):
        _close(g, w)
    logits = port.classify(ids)
    assert logits.shape == (4, 3)
    _close(logits, ref.classify(ids))


def test_chunks_past_the_largest_batch_bucket_and_inputs_at_max_seq_len():
    """Six inputs straddle two chunks of the largest batch bucket (4) in
    different seq buckets; inputs of max_seq_len (128, the terminal bucket,
    beyond the configured 16 and 32) serve; one past it is refused."""
    ref, port = _pair()
    rng = np.random.default_rng(3)
    long_ids = rng.integers(0, 512, 128).tolist()
    mixed = [[1, 2, 3]] * 4 + [long_ids[:59], [7] * 20]
    states = port.token_states(mixed)
    assert [s.shape[0] for s in states] == [3, 3, 3, 3, 59, 20]
    for g, w in zip(states, ref.token_states(mixed)):
        _close(g, w)
    _close(port.embed(mixed), ref.embed(mixed))
    _close(port.embed([long_ids] * 5), ref.embed([long_ids] * 5))
    _close(port.classify([long_ids]), ref.classify([long_ids]))
    keys = port.health()["graph_keys"]
    assert port.health()["seq_buckets"] == [16, 32, 128] and keys == {}
    with pytest.raises(ValueError, match="exceeds model max_seq_len 128"):
        port.embed([long_ids + [1]])


def test_bi_encoder_score_pairs_and_rerank_equal_the_reference():
    ref, port = _pair()
    rng = np.random.default_rng(4)
    a, b, c = _ids(rng, 3)
    pairs = [(a, a), (a, b), (b, c)]
    got = port.score_pairs(pairs)
    assert got[0] == pytest.approx(1.0, rel=1e-5)
    _close(got, ref.score_pairs(pairs))
    _close(port.rerank(a, [c, a, b]), ref.rerank(a, [c, a, b]))
    assert not port.is_cross_encoder


def test_cross_encoder_pair_assembly_and_scores_equal_the_reference():
    """num_labels == 1: [CLS] a [SEP] b [SEP] of bare segments, the final SEP
    kept under truncation, sigmoid of the logit; and without cls/sep ids (the
    byte tokenizer) the bare segments are joined, as the reference does."""
    cfg = {"preset": "bert-tiny", "dtype": "float32", "num_labels": 1, "max_seq_len": 16}
    ref, port = _pair(cfg, seed=5, cls_token_id=101, sep_token_id=102,
                      seq_buckets=None, batch_buckets=None)
    assert port.is_cross_encoder
    assert port._join_pair([5, 6], [7, 8]) == [101, 5, 6, 102, 7, 8, 102]
    truncated = port._join_pair(list(range(1, 10)), list(range(10, 20)))
    assert truncated == ref._join_pair(list(range(1, 10)), list(range(10, 20)))
    assert len(truncated) == 16 and truncated[0] == 101 and truncated[-1] == 102
    pairs = [([5, 6], [7, 8]), ([5, 6], [9, 9]), (list(range(1, 10)), list(range(10, 20)))]
    scores = port.score_pairs(pairs)
    assert all(0.0 <= s <= 1.0 for s in scores)
    _close(scores, ref.score_pairs(pairs))
    _close(port.rerank([5, 6], [[7, 8], [9, 9]]), ref.rerank([5, 6], [[7, 8], [9, 9]]))
    bare_ref, bare_port = _pair(cfg, seed=5, seq_buckets=None, batch_buckets=None)
    assert bare_port._join_pair([5, 6], [7, 8]) == bare_ref._join_pair([5, 6], [7, 8]) == \
        [5, 6, 7, 8]
    _close(bare_port.score_pairs(pairs[:2]), bare_ref.score_pairs(pairs[:2]))


def test_refusals_equal_the_reference():
    ref, port = _pair(dict(BERT, num_labels=0))
    for core in (ref, port):
        with pytest.raises(ValueError, match="no classifier head"):
            core.classify([[1, 2]])
    mlp = models.build_model("mlp", {"in_dim": 4, "hidden": [8], "out_dim": 3})
    with pytest.raises(ValueError, match=r"\.hidden\(\) surface"):
        EncoderCore(mlp, None, device="cpu")
    bundle = models.build_model("bert", BERT)
    with pytest.raises(ValueError, match="pooling must be 'mean' or 'cls'"):
        EncoderCore(bundle, None, pooling="max", device="cpu")


def test_retire_releases_after_the_queued_calls():
    """retire() queues the release behind the calls already on the core's
    thread: they finish, then the graphs, weights and pool go and the
    thread returns to its stream's pool."""
    from clearml_serving_tpu_torch import device

    _ref, port = _pair()
    ids = [[1, 2, 3]]
    worker = port.worker
    queued = [worker.submit(port.embed, ids) for _ in range(3)]
    port.retire()
    assert all(f.result().shape == (1, 64) for f in queued)
    worker.submit(lambda: None).result()
    assert port.health() == {"ready": False, "released": True} and port.params is None
    assert worker in device._FREE_STEP_WORKERS[None]
    with pytest.raises(RuntimeError, match="retired"):
        port.embed(ids)


# -- HTTP: both apps --------------------------------------------------------------

ENGINE = {"task": "embed", "labels": ["neg", "neu", "pos"], "seq_buckets": SEQ_BUCKETS,
          "batch_buckets": BATCH_BUCKETS}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(reference processor, port processor) serving one bert-tiny bundle as
    the llm endpoint ``tiny_bert`` (task embed)."""
    tmp = tmp_path_factory.mktemp("enc")
    bundle = jax_models.build_model("bert", BERT)
    jax_save_bundle(tmp / "bundle", "bert", BERT, _perturbed(bundle.init(jax.random.PRNGKey(6)), 6))
    return tuple(_processors(tmp, tmp / "bundle", "tiny_bert", ENGINE))


def _processors(tmp, path, url, engine, name="enc"):
    out = []
    for label, cls, ep_cls, kw in (("ref", JaxProcessor, JaxEndpoint, {}),
                                   ("port", ModelRequestProcessor, ModelEndpoint,
                                    {"device": "cpu"})):
        mrp = cls(state_root=str(tmp / (label + name)), force_create=True, name=name, **kw)
        model_id = None
        if path is not None:
            model_id = mrp.registry.register("bert", path=path, framework="jax").id
        mrp.add_endpoint(ep_cls(engine_type="llm", serving_url=url, model_id=model_id,
                                auxiliary_cfg={"engine": dict(engine)}))
        mrp.serialize()
        mrp.deserialize(skip_sync=True)
        out.append(mrp)
    return out


def _post(mrp, app_fn, calls):
    async def runner():
        client = TestClient(TestServer(app_fn(mrp)))
        await client.start_server()
        try:
            out = []
            for path, body in calls:
                r = await client.post(path, json=body)
                out.append((r.status, await r.json()))
            return out
        finally:
            await client.close()

    return asyncio.run(runner())


def _same(got, want, path="$"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            if k in ("id", "instance"):
                assert str(got[k]).split("-")[0][:5] == str(want[k]).split("-")[0][:5], (
                    path, k)
                continue
            if k == "embedding" and isinstance(want[k], str):
                # base64 float32: the values, within the tolerance
                _same(np.frombuffer(base64.b64decode(got[k]), np.float32).tolist(),
                      np.frombuffer(base64.b64decode(want[k]), np.float32).tolist(),
                      "{}.{}".format(path, k))
                continue
            if k == "detail":
                # the router's words (the reference names its exception's
                # module path)
                assert got[k].split(": ", 1)[0] == want[k].split(": ", 1)[0], (path, k)
                assert got[k].rsplit(" ", 20)[1:] == want[k].rsplit(" ", 20)[1:], (path, k)
                continue
            _same(got[k], want[k], "{}.{}".format(path, k))
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, "{}[{}]".format(path, i))
    elif isinstance(want, float):
        assert abs(got - want) <= TOL + TOL * abs(want), (path, got, want)
    else:
        assert got == want, (path, got, want)


def _both(served, calls):
    ref, port = served
    want = _post(ref, jax_build_app, calls)
    got = _post(port, build_app, calls)
    for (gs, gb), (ws, wb) in zip(got, want):
        assert gs == ws, (gs, ws, gb, wb)
        _same(gb, wb)
    return got


OPENAI = "/serve/openai/v1/"


def test_embeddings_route(served):
    (status, out), = _both(served, [(OPENAI + "embeddings", {
        "model": "tiny_bert", "input": ["hello world", "hello world", "bye"]})])
    assert status == 200 and out["object"] == "list" and len(out["data"]) == 3
    v0, v1, v2 = (np.array(d["embedding"]) for d in out["data"])
    np.testing.assert_allclose(v0, v1, rtol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(v0), 1.0, rtol=1e-5)
    assert not np.allclose(v0, v2)
    assert out["usage"]["prompt_tokens"] > 0


def test_embeddings_token_id_inputs(served):
    got = _both(served, [(OPENAI + "embeddings", {"model": "tiny_bert", "input": [5, 6, 7]}),
                         (OPENAI + "embeddings", {"model": "tiny_bert",
                                                  "input": [[5, 6], [300, 2, 9]]}),
                         (OPENAI + "embeddings", {"model": "tiny_bert", "input": [[5, 9999]]})])
    assert [s for s, _ in got] == [200, 200, 422]


def test_embeddings_base64(served):
    """The OpenAI SDK's default format: base64-packed float32."""
    (status, out), = _both(served, [(OPENAI + "embeddings", {
        "model": "tiny_bert", "input": "hi", "encoding_format": "base64"})])
    vec = np.frombuffer(base64.b64decode(out["data"][0]["embedding"]), np.float32)
    assert status == 200 and vec.shape[0] == 64
    np.testing.assert_allclose(np.linalg.norm(vec), 1.0, rtol=1e-5)


def test_embeddings_dimensions(served):
    """``dimensions``: the leading dims, renormalized; out of range 422."""
    got = _both(served, [
        (OPENAI + "embeddings", {"model": "tiny_bert", "input": "hi"}),
        (OPENAI + "embeddings", {"model": "tiny_bert", "input": "hi", "dimensions": 16}),
        (OPENAI + "embeddings", {"model": "tiny_bert", "input": "hi", "dimensions": 9999}),
        (OPENAI + "embeddings", {"model": "tiny_bert", "input": "hi", "dimensions": 0}),
        (OPENAI + "embeddings", {"model": "tiny_bert", "input": "hi",
                                 "encoding_format": "int8"})])
    assert [s for s, _ in got] == [200, 200, 422, 422, 422]
    v_full = np.array(got[0][1]["data"][0]["embedding"])
    v_cut = np.array(got[1][1]["data"][0]["embedding"])
    assert v_cut.shape[0] == 16
    np.testing.assert_allclose(v_cut, v_full[:16] / np.linalg.norm(v_full[:16]), rtol=1e-5)


def test_pooling_route(served):
    got = _both(served, [
        (OPENAI + "pooling", {"model": "tiny_bert", "input": ["hi there", "bye"]}),
        (OPENAI + "pooling", {"model": "tiny_bert", "input": ["hi there", "bye"],
                              "return_token_states": True})])
    pooled, states = got[0][1], got[1][1]
    assert [len(d["data"]) for d in pooled["data"]] == [64, 64]
    # the byte tokenizer: BOS + the bytes
    assert [len(d["data"]) for d in states["data"]] == [9, 4]
    assert all(len(row) == 64 for row in states["data"][0]["data"])


def test_score_and_rerank_routes(served):
    got = _both(served, [
        (OPENAI + "score", {"model": "tiny_bert", "text_1": "aaaa",
                            "text_2": ["aaaa", "zzzz zz z"]}),
        (OPENAI + "rerank", {"model": "tiny_bert", "query": "aaaa",
                             "documents": ["zzzz zz z", "aaaa", {"text": "bbbb"}],
                             "top_n": 2}),
        (OPENAI + "score", {"model": "tiny_bert", "text_1": ["a", "b"],
                            "text_2": ["c", "d", "e"]}),
        (OPENAI + "rerank", {"model": "tiny_bert", "query": "aaaa", "documents": []})])
    assert [s for s, _ in got] == [200, 200, 422, 422]
    scores = [d["score"] for d in got[0][1]["data"]]
    assert scores[0] > scores[1] and scores[0] == pytest.approx(1.0, rel=1e-4)
    results = got[1][1]["results"]
    assert len(results) == 2 and results[0]["document"]["text"] == "aaaa"
    assert results[0]["relevance_score"] >= results[1]["relevance_score"]


def test_classify_route(served):
    (status, out), = _both(served, [(OPENAI + "classify", {
        "model": "tiny_bert", "input": ["hello", "world"]})])
    assert status == 200 and len(out["data"]) == 2
    for d in out["data"]:
        assert d["num_classes"] == 3 and d["label"] in ("neg", "neu", "pos")
        assert sum(d["probs"]) == pytest.approx(1.0, rel=1e-5)


def test_generation_routes_gated_on_encoder(served):
    got = _both(served, [
        (OPENAI + "chat/completions", {"model": "tiny_bert",
                                       "messages": [{"role": "user", "content": "x"}]}),
        (OPENAI + "completions", {"model": "tiny_bert", "prompt": "x"}),
        (OPENAI + "tokenize", {"model": "tiny_bert", "prompt": "hey"})])
    assert [s for s, _ in got] == [422, 422, 200]
    assert "does not support v1/chat/completions" in got[0][1]["detail"]
    assert "does not support v1/completions" in got[1][1]["detail"]
    assert got[2][1] == {"tokens": [256, 104, 101, 121], "count": 4, "max_model_len": 128}


def test_plain_post_is_an_embeddings_call(served):
    (status, out), = _both(served, [("/serve/tiny_bert", {"input": ["plain post"]})])
    assert status == 200 and out["data"][0]["object"] == "embedding"


def test_encoder_long_input_and_many_inputs(served):
    """Inputs longer than the largest configured seq bucket (within
    max_seq_len) and more inputs than the largest batch bucket serve."""
    _ref, port = served
    enc = port._get_processor("tiny_bert").encoder
    long_ids = list(range(1, 60))
    assert enc.embed([long_ids]).shape == (1, 64)
    mixed = [[1, 2, 3]] * 4 + [long_ids, [7] * 20]
    assert [s.shape[0] for s in enc.token_states(mixed)] == [3, 3, 3, 3, 59, 20]
    assert enc.embed(mixed).shape == (6, 64)
    texts = ["x" * n for n in (3, 40, 120, 7, 9)]
    got = _both(served, [(OPENAI + "embeddings", {"model": "tiny_bert", "input": texts})])
    assert len(got[0][1]["data"]) == 5


def test_unknown_task_rejected(tmp_path):
    ref, port = _processors(tmp_path, None, "bad_task_ep",
                            {"arch": "bert", "preset": "bert-tiny", "task": "nonsense"},
                            name="badtask")
    want = _post(ref, jax_build_app, [(OPENAI + "embeddings",
                                       {"model": "bad_task_ep", "input": "x"})])
    got = _post(port, build_app, [(OPENAI + "embeddings",
                                   {"model": "bad_task_ep", "input": "x"})])
    for (status, body) in got + want:
        assert status == 422 and "unknown engine task 'nonsense' for endpoint " \
            "'bad_task_ep'" in body["detail"]


def test_decoder_endpoint_refuses_the_encoder_routes(tmp_path):
    ref, port = _processors(tmp_path, None, "tiny_llm", {
        "preset": "llama-tiny", "config": {"dtype": "float32"}, "cache": "paged",
        "max_batch": 2, "max_seq_len": 64, "prefill_buckets": [32]}, name="dec")
    calls = [(OPENAI + route, {"model": "tiny_llm", "input": "x", "text_1": "a",
                               "text_2": "b", "query": "q", "documents": ["d"]})
             for route in ("embeddings", "pooling", "classify", "score", "rerank")]
    want = _post(ref, jax_build_app, calls)
    got = _post(port, build_app, calls)
    for (gs, gb), (ws, wb), (path, _b) in zip(got, want, calls):
        assert gs == ws == 422
        route = path[len("/serve/openai/"):]
        assert "does not support {} (decoder-only LLM endpoint".format(route) in gb["detail"]
        assert "does not support {} (decoder-only LLM endpoint".format(route) in wb["detail"]


# -- the port's own -------------------------------------------------------------------

def _port_only(tmp_path, engine, url="enc"):
    mrp = ModelRequestProcessor(state_root=str(tmp_path / "port"), force_create=True,
                                name="p", device="cpu")
    mrp.add_endpoint(ModelEndpoint(engine_type="llm", serving_url=url,
                                   auxiliary_cfg={"engine": engine}))
    mrp.serialize()
    mrp.deserialize(skip_sync=True)
    return mrp


def test_bert_preset_serves_on_seed_weights(tmp_path):
    """``engine.arch: bert`` with a preset, no bundle: weights drawn from
    ``seed``; the same seed gives the same vectors, another seed others.
    ``replicas`` is ignored on an encoder endpoint, as the reference
    ignores it."""
    engine = {"arch": "bert", "preset": "bert-tiny", "config": {"dtype": "float32"},
              "pooling": "cls", "normalize": False, "replicas": 2}
    outs = []
    for seed in (0, 0, 1):
        mrp = _port_only(tmp_path / str(len(outs)), dict(engine, seed=seed))
        (status, out), = _post(mrp, build_app, [(OPENAI + "embeddings",
                                                 {"model": "enc", "input": "same text"})])
        assert status == 200
        outs.append(np.array(out["data"][0]["embedding"]))
        enc = mrp._get_processor("enc").encoder
        assert enc.pooling == "cls" and not enc.normalize and enc.num_labels == 9
    np.testing.assert_array_equal(outs[0], outs[1])
    assert not np.allclose(outs[0], outs[2]) and abs(np.linalg.norm(outs[0]) - 1) > 1e-3


@pytest.mark.parametrize("task", ["transcribe", "translate", "audio"])
def test_audio_tasks_refused_by_name(tmp_path, task):
    """An audio task on a BERT model is refused with the reference's
    ``AudioCore`` words, before any weight is made."""
    mrp = _port_only(tmp_path, {"arch": "bert", "preset": "bert-tiny", "task": task})
    (status, out), = _post(mrp, build_app, [(OPENAI + "embeddings",
                                             {"model": "enc", "input": "x"})])
    assert status == 422
    assert "audio tasks need a speech encoder-decoder bundle (arch 'whisper')" in \
        out["detail"]


def test_encoder_task_on_a_decoder_preset_is_refused_before_weights(tmp_path):
    mrp = _port_only(tmp_path, {"preset": "llama3-8b", "task": "embed"})
    (status, out), = _post(mrp, build_app, [(OPENAI + "embeddings",
                                             {"model": "enc", "input": "x"})])
    assert status == 422 and "encoder tasks need a model bundle with a .hidden() surface" \
        in out["detail"]


def test_eviction_releases_the_encoder(tmp_path):
    """Removing the endpoint retires its core: its release runs on the
    core's own thread, after the calls queued there."""
    mrp = _port_only(tmp_path, {"arch": "bert", "preset": "bert-tiny",
                                "config": {"dtype": "float32"}})
    proc = mrp._get_processor("enc")
    enc = proc.encoder
    (status, out), = _post(mrp, build_app, [("/serve/enc", {"input": "x"})])
    assert status == 200 and mrp._engine_processor_lookup.get("enc") is proc
    mrp.remove_endpoint("enc")
    mrp.serialize()
    mrp.deserialize()
    enc.worker.submit(lambda: None).result()
    assert enc.health()["released"] and enc.params is None
