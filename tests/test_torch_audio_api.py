"""The audio routes of the ``llm`` engine type over HTTP: the reference's app
and the port's (``serving/main.py``'s ``build_app`` over each package's
processor) serving one whisper-test bundle the reference's ``save_bundle``
wrote (float32, 1 s windows, ``decode_steps`` 4), as the reference's
``tests/test_whisper.py`` serves it.

Every body is compared whole: ``json``, ``text`` (``text/plain``) and
``verbose_json`` (segments; the DTW's words with ``timestamp_granularities``
``["segment", "word"]``, ``["word"]`` or a bare string) on
``audio/transcriptions`` and ``audio/translations``, multipart uploads and
base64 JSON, long audio in windows, concurrent requests batched, a bad
upload's status and words, an audio route on a chat endpoint (422), a chat
route and a plain POST on the audio endpoint (422), ``tokenize``, the
per-request stats, ``/ready``'s health and the eviction's release.
"""

import asyncio
import base64
import io
import wave

import aiohttp
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
from clearml_serving_tpu_torch.llm.audio import AudioCore
from clearml_serving_tpu_torch.serving.endpoints import ModelEndpoint
from clearml_serving_tpu_torch.serving.main import build_app
from clearml_serving_tpu_torch.serving.model_request_processor import ModelRequestProcessor

CFG = dict(
    preset="whisper-test",
    transcribe_prompt_ids=[300, 301, 302, 349],   # ends with <|notimestamps|>
    translate_prompt_ids=[300, 303, 302, 349],
    eos_token_id=340,
    notimestamps_token_id=349,
    timestamp_begin=350,                           # ids 350..399 = 0..0.98 s
    time_precision=0.02,
    sampling_rate=16000,
    chunk_length=1,
)
ENGINE = {"decode_steps": 4, "max_tokens": 12}
URL = "tiny_whisper"
AUDIO = "/serve/openai/v1/audio/"


def _tree(seed=3):
    bundle = jax_models.build_model("whisper", dict(CFG))
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

    return bundle, walk(jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(seed))))


def _processors(tmp, path, url, engine, name="audio"):
    out = []
    for label, cls, ep_cls, kw in (("ref", JaxProcessor, JaxEndpoint, {}),
                                   ("port", ModelRequestProcessor, ModelEndpoint,
                                    {"device": "cpu"})):
        mrp = cls(state_root=str(tmp / (label + name)), force_create=True, name=name, **kw)
        model_id = None
        if path is not None:
            model_id = mrp.registry.register("whisper-test", path=path, framework="jax").id
        mrp.add_endpoint(ep_cls(engine_type="llm", serving_url=url, model_id=model_id,
                                auxiliary_cfg={"engine": dict(engine)}))
        mrp.serialize()
        mrp.deserialize(skip_sync=True)
        out.append(mrp)
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(reference processor, port processor) serving one whisper-test
    bundle as the ``llm`` endpoint ``tiny_whisper`` (its task from the
    bundle's arch)."""
    tmp = tmp_path_factory.mktemp("audio")
    bundle, tree = _tree()
    jax_save_bundle(tmp / "whisper", "whisper", dict(bundle.config), tree)
    return tuple(_processors(tmp, tmp / "whisper", URL, ENGINE))


def _wav(seconds=0.6, rate=16000, seed=0, channels=1) -> bytes:
    t = np.arange(int(rate * seconds)) / rate
    sig = 0.3 * np.sin(2 * np.pi * 300 * t) + 0.05 * np.random.default_rng(seed).standard_normal(
        len(t))
    frames = np.stack([sig] * channels, axis=1)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((frames * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def _form(wav: bytes, **fields):
    form = aiohttp.FormData()
    form.add_field("file", wav, filename="a.wav", content_type="audio/wav")
    for k, v in fields.items():
        form.add_field(k, v)
    return form


async def _send(client, call):
    """One call: (path, kind, payload); kind json, form (a dict of fields
    with ``file`` bytes), or raw (bytes, headers)."""
    path, kind, payload = call
    if kind == "json":
        r = await client.post(path, json=payload)
    elif kind == "form":
        fields = dict(payload)
        r = await client.post(path, data=_form(fields.pop("file"), **fields))
    else:
        data, headers = payload
        r = await client.post(path, data=data, headers=headers)
    ctype = r.headers.get("Content-Type", "")
    body = await r.json() if ctype.startswith("application/json") else await r.text()
    return r.status, ctype.split(";")[0], body


def _post(mrp, app_fn, calls, concurrent=False):
    async def runner():
        client = TestClient(TestServer(app_fn(mrp)))
        await client.start_server()
        try:
            if concurrent:
                return list(await asyncio.gather(*[_send(client, c) for c in calls]))
            return [await _send(client, c) for c in calls]
        finally:
            await client.close()

    return asyncio.run(runner())


def _same_detail(got, want):
    """The router's words: the reference names its exception's module path."""
    assert got.split(": ", 1)[0] == want.split(": ", 1)[0]
    assert got.rsplit(" ", 30)[1:] == want.rsplit(" ", 30)[1:]


def _both(served, calls, concurrent=False):
    ref, port = served
    want = _post(ref, jax_build_app, calls, concurrent)
    got = _post(port, build_app, calls, concurrent)
    for (gs, gt, gb), (ws, wt, wb), call in zip(got, want, calls):
        assert (gs, gt) == (ws, wt), (call[0], gs, ws, gb, wb)
        if isinstance(wb, dict) and "detail" in wb:
            assert set(gb) == set(wb)
            _same_detail(gb["detail"], wb["detail"])
            assert {k: v for k, v in gb.items() if k not in ("detail", "instance")} == \
                {k: v for k, v in wb.items() if k not in ("detail", "instance")}
        else:
            assert gb == wb, (call[0], gb, wb)
    return got


def _b64(wav):
    return base64.b64encode(wav).decode()


def test_transcription_json_multipart_and_base64(served):
    got = _both(served, [
        (AUDIO + "transcriptions", "form", {"file": _wav(), "model": URL}),
        (AUDIO + "transcriptions", "json", {"file": _b64(_wav()), "model": URL}),
        (AUDIO + "translations", "form", {"file": _wav(0.4, seed=1), "model": URL}),
    ])
    assert [s for s, _, _ in got] == [200, 200, 200]
    assert got[0][2] == got[1][2] and set(got[0][2]) == {"text"}


def test_text_response_is_plain_text(served):
    (status, ctype, body), = _both(served, [
        (AUDIO + "transcriptions", "form", {"file": _wav(0.3), "model": URL,
                                            "response_format": "text"})])
    assert status == 200 and ctype == "text/plain" and not body.startswith('"')


@pytest.mark.parametrize("granularities", [None, ["segment", "word"], ["word"], "word"],
                         ids=["default", "segment_word", "word", "bare_string"])
def test_verbose_json_segments_and_words(served, granularities):
    body = {"file": _b64(_wav(0.6, seed=2)), "model": URL, "response_format": "verbose_json",
            "language": "en"}
    if granularities is not None:
        body["timestamp_granularities"] = granularities
    (status, _ct, out), = _both(served, [(AUDIO + "transcriptions", "json", body)])
    assert status == 200 and out["task"] == "transcribe" and out["language"] == "en"
    assert out["duration"] == pytest.approx(0.6, abs=0.01)
    want_segments = granularities is None or "segment" in granularities
    assert ("segments" in out) == want_segments
    assert ("words" in out) == (granularities is not None)
    for seg in out.get("segments", []):
        assert 0.0 <= seg["start"] <= seg["end"] <= out["duration"] + 1e-6
    for w in out.get("words", []):
        assert set(w) == {"word", "start", "end"} and w["word"].strip() == w["word"] != ""


def test_verbose_json_words_are_the_dtw_words(served):
    """The route's words are ``words_dtw``'s on the same windows, not the
    proportional fallback."""
    _ref, port = served
    wav = _wav(0.8, seed=3)
    body = {"file": _b64(wav), "model": URL, "response_format": "verbose_json",
            "timestamp_granularities": ["segment", "word"]}
    (status, _ct, out), = _both(served, [(AUDIO + "translations", "json", body)])
    proc = port._get_processor(URL)
    core = proc.audio
    from clearml_serving_tpu_torch.ops.audio import decode_wav

    pcm = decode_wav(wav)

    async def windows():
        return await core.transcribe_windows_async(pcm, "translate", timestamps=True)

    direct = core.words_dtw(pcm, asyncio.run(windows()), proc.tokenizer, "translate")
    assert status == 200 and direct and out["words"] == direct
    assert direct != AudioCore.words_from_segments(out["segments"])


def test_long_audio_and_verbose_segments_across_windows(served):
    """2.5 s: three windows; the segments' times offset by each window."""
    got = _both(served, [
        (AUDIO + "transcriptions", "form", {"file": _wav(2.5, seed=4), "model": URL}),
        (AUDIO + "transcriptions", "form", {"file": _wav(2.5, seed=4), "model": URL,
                                            "response_format": "verbose_json"}),
    ])
    out = got[1][2]
    assert out["duration"] == pytest.approx(2.5, abs=0.01)
    assert any(seg["start"] >= 1.0 for seg in out["segments"])


def test_concurrent_requests_batch_and_equal_the_reference(served):
    """Six requests at once, transcriptions and translations mixed: the
    micro-batcher batches and carries; each answer equals the reference's."""
    calls = [(AUDIO + ("transcriptions" if i % 3 else "translations"), "json",
              {"file": _b64(_wav(0.5, seed=10 + i)), "model": URL}) for i in range(6)]
    got = _both(served, calls, concurrent=True)
    assert all(s == 200 for s, _, _ in got)
    sequential = _both(served, calls)
    assert [b for _, _, b in got] == [b for _, _, b in sequential]


@pytest.mark.parametrize("kind,payload", [
    ("json", {"file": _b64(b"garbage bytes"), "model": URL}),
    ("json", {"file": "%%% not base64 %%%", "model": URL}),
    ("json", {"model": URL}),
    ("json", {"file": 12, "model": URL}),
    ("raw", (b"garbage", {"Content-Type": "multipart/form-data"})),
], ids=["not_a_wav", "bad_base64", "no_file", "file_not_bytes", "no_boundary"])
def test_bad_uploads_answer_the_reference_status_and_words(served, kind, payload):
    (status, ctype, out), = _both(served, [(AUDIO + "transcriptions", kind, payload)])
    assert status == 422 and ctype == "application/json" and "detail" in out


def test_chat_routes_and_plain_post_on_the_audio_endpoint_are_refused(served):
    got = _both(served, [
        ("/serve/openai/v1/chat/completions", "json",
         {"model": URL, "messages": [{"role": "user", "content": "x"}]}),
        ("/serve/openai/v1/embeddings", "json", {"model": URL, "input": "x"}),
        ("/serve/" + URL, "json", {"messages": [{"role": "user", "content": "x"}]}),
        ("/serve/openai/v1/tokenize", "json", {"model": URL, "prompt": "hey"}),
    ])
    assert [s for s, _, _ in got] == [422, 422, 422, 200]
    assert "does not support v1/chat/completions" in got[0][2]["detail"]
    assert got[3][2]["max_model_len"] == 0


def test_audio_route_on_a_chat_endpoint_is_refused(tmp_path):
    engine = {"preset": "llama-tiny", "config": {"dtype": "float32"}, "cache": "paged",
              "max_batch": 2, "max_seq_len": 64, "prefill_buckets": [32]}
    served = _processors(tmp_path, None, "text_llm", engine, name="chat")
    got = _both(served, [(AUDIO + "transcriptions", "json", {"file": "x", "model": "text_llm"}),
                         (AUDIO + "translations", "form", {"file": _wav(), "model": "text_llm"})])
    for status, _ct, out in got:
        assert status == 422 and "does not support v1/audio/" in out["detail"]


def test_collect_fn_stats_equal_the_reference(served):
    ref, port = served
    body = {"file": _b64(_wav(0.7, seed=5)), "model": URL, "response_format": "verbose_json"}
    stats = []
    for mrp in (ref, port):
        got = {}
        asyncio.run(mrp._get_processor(URL).v1_audio_transcriptions(dict(body), {}, got.update))
        stats.append(got)
    assert stats[0] == stats[1] and set(stats[1]) == {"gen_tokens", "audio_seconds"}
    assert stats[1]["audio_seconds"] == pytest.approx(0.7, abs=0.01)


def test_whisper_preset_on_seed_weights_and_ready_health(tmp_path):
    """``engine.arch: whisper`` with a preset, no bundle: the task defaults
    to transcribe, weights drawn from ``seed``; ``/ready`` carries the
    core's health."""
    engine = {"arch": "whisper", "preset": "whisper-test", "seed": 1, "decode_steps": 4,
              "max_tokens": 6, "config": {k: v for k, v in CFG.items() if k != "preset"}}
    mrp = ModelRequestProcessor(state_root=str(tmp_path / "p"), force_create=True, name="p",
                                device="cpu")
    mrp.add_endpoint(ModelEndpoint(engine_type="llm", serving_url="w",
                                   auxiliary_cfg={"engine": engine}))
    mrp.serialize()
    mrp.deserialize(skip_sync=True)

    async def run():
        client = TestClient(TestServer(build_app(mrp)))
        await client.start_server()
        try:
            r = await client.post(AUDIO + "transcriptions", data=_form(_wav(0.5), model="w"))
            out = await r.json()
            ready = await (await client.get("/ready")).json()
            return r.status, out, ready
        finally:
            await client.close()

    status, out, ready = asyncio.run(run())
    core = mrp._get_processor("w").audio
    assert status == 200 and isinstance(out["text"], str)
    assert core.max_new_tokens == 6 and core.decode_steps == 4
    health = ready["engines"]["w"]
    assert health["ready"] and health["batch_rows"] == {"1": 1} and health["graph_keys"] == {}


def test_eviction_releases_the_audio_core(served, tmp_path):
    """Removing the endpoint retires its core: the release runs on the
    core's own thread, after the calls queued there."""
    _bundle, _tree_ = _tree()
    ref, port = _processors(tmp_path, None, "evict",
                            {"arch": "whisper", "preset": "whisper-test", "decode_steps": 4,
                             "max_tokens": 4,
                             "config": {k: v for k, v in CFG.items() if k != "preset"}},
                            name="evict")
    proc = port._get_processor("evict")
    core = proc.audio
    (status, _ct, _out), = _post(port, build_app, [
        (AUDIO + "transcriptions", "json", {"file": _b64(_wav(0.3)), "model": "evict"})])
    assert status == 200
    port.remove_endpoint("evict")
    port.serialize()
    port.deserialize()
    core.worker.submit(lambda: None).result()
    assert core.health() == {"ready": False, "released": True} and core.params is None
