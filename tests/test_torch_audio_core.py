"""The port's ``AudioCore`` (``llm/audio.py``) against the reference's on
the same whisper-test weights (float32, 1 s windows, ``decode_steps`` 4):
token lists equal, not close.

- plain and timestamp windows for both tasks, on prompts chosen so that a
  window reaches its budget at the cache's end (the loop then steps past
  ``max_target_positions``, where JAX clamps the position gather and the
  K/V write), and under a ``max_new_tokens`` cap;
- the micro-batcher: concurrent utterances batched against the sequential
  path, long audio in windows, and a mixed-task batch through ``_carry``;
- the host parts: ``parse_segments``, ``words_from_segments`` and
  ``words_dtw`` (the reference's stand-in tokenizers: a space-led token,
  byte-level codepoints split across tokens, segment boundaries), and the
  refusals;
- the port's own: its thread, ``health()`` and ``retire()``.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clearml_serving_tpu import models as jax_models
from clearml_serving_tpu.llm.audio import AudioCore as RefCore
from clearml_serving_tpu_torch import models
from clearml_serving_tpu_torch.llm.audio import AudioCore

# the transcribe prompt (5 ids) runs the plain loop past the cache's end,
# the translate prompt (7 ids; 6 without <|notimestamps|>) the timestamp one
CFG = dict(
    preset="whisper-test",
    transcribe_prompt_ids=[300, 301, 302, 304, 349],
    translate_prompt_ids=[300, 303, 302, 305, 306, 307, 349],
    eos_token_id=340,
    notimestamps_token_id=349,
    timestamp_begin=350,                           # ids 350..399 = 0..0.98 s
    time_precision=0.02,
    sampling_rate=16000,
    chunk_length=1,
)
STEPS = 4


def _perturbed(tree, seed):
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


def _cores(cfg=CFG, seed=3, **kw):
    ref_bundle = jax_models.build_model("whisper", dict(cfg))
    tree = _perturbed(ref_bundle.init(jax.random.PRNGKey(seed)), seed)
    port_bundle = models.build_model("whisper", dict(cfg))
    kw.setdefault("decode_steps", STEPS)
    ref = RefCore(ref_bundle, jax.tree.map(jnp.asarray, tree), **kw)
    port = AudioCore(port_bundle, port_bundle.convert_params(tree, "cpu"), device="cpu", **kw)
    return ref, port


@pytest.fixture(scope="module")
def cores():
    """(reference, port) with a budget as large as the cache allows."""
    return _cores(max_new_tokens=64)


def _pcms(n, seconds=1.0, seed=0):
    rng = np.random.RandomState(seed)
    return [(0.1 * rng.randn(int(16000 * seconds))).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("task", ["transcribe", "translate"])
@pytest.mark.parametrize("timestamps", [False, True], ids=["plain", "ts"])
@pytest.mark.parametrize("rows", [1, 3])
def test_windows_equal_the_reference(cores, task, timestamps, rows):
    ref, port = cores
    prompt = ref.prompt_ids(task, timestamps)
    assert port.prompt_ids(task, timestamps) == prompt
    fn = "_transcribe_batch_ts" if timestamps else "_transcribe_batch"
    pcms = _pcms(rows, seed=rows)
    want = getattr(ref, fn)(pcms, prompt)
    got = getattr(port, fn)(pcms, prompt)
    assert got == want
    assert all(len(ids) > 0 for ids in got)
    if timestamps:
        assert all(ids[0] >= 350 for ids in got)


@pytest.mark.parametrize("task,timestamps", [("transcribe", False), ("translate", True)])
def test_a_window_reaching_its_budget_steps_past_the_cache_end(cores, task, timestamps):
    """The loop of a window that reaches its budget runs its last chunk past
    ``max_target_positions`` (32): the cache's ``length`` ends above it,
    and the tokens still equal the reference's (JAX clamps there)."""
    ref, port = cores
    prompt = ref.prompt_ids(task, timestamps)
    fn = "_transcribe_batch_ts" if timestamps else "_transcribe_batch"
    pcms = _pcms(2, seed=11)
    got = getattr(port, fn)(pcms, prompt)
    assert got == getattr(ref, fn)(pcms, prompt)
    budget = min(port.max_new_tokens, port.max_target - len(prompt) - 1)
    assert [len(ids) for ids in got] == [budget, budget]      # random weights: no EOS
    lengths = port._buckets[2]["cache"]["length"].tolist()
    assert min(lengths) > port.max_target, lengths


def test_the_max_new_tokens_cap_equals_the_reference():
    ref, port = _cores(max_new_tokens=6)
    for task, ts in (("transcribe", False), ("transcribe", True)):
        prompt = ref.prompt_ids(task, ts)
        fn = "_transcribe_batch_ts" if ts else "_transcribe_batch"
        pcms = _pcms(2, seed=5)
        got = getattr(port, fn)(pcms, prompt)
        assert got == getattr(ref, fn)(pcms, prompt)
        assert [len(ids) for ids in got] == [6, 6]


def test_long_audio_in_windows_equals_the_reference(cores):
    """2.4 s: two full 1 s windows and a 0.4 s tail, concatenated."""
    ref, port = cores
    pcm = _pcms(1, seconds=2.4, seed=7)[0]
    want = ref.transcribe_ids(pcm, "transcribe")
    assert port.transcribe_ids(pcm, "transcribe") == want
    assert port.transcribe_ids(np.zeros(0, np.float32)) == []

    async def windows(core):
        return await core.transcribe_windows_async(pcm, "translate", timestamps=True)

    got = asyncio.run(windows(port))
    assert len(got) == 3 and got == asyncio.run(windows(ref))


def test_batched_equals_sequential_and_the_reference(cores):
    """Three concurrent utterances share one bucket-4 batch; each equals its
    own sequential run, and the reference's batch."""
    ref, port = cores
    pcms = _pcms(3, seed=8)
    sequential = [port.transcribe_ids(p, "transcribe") for p in pcms]

    async def run(core):
        return await asyncio.gather(*[core.transcribe_ids_async(p, "transcribe") for p in pcms])

    before = dict(port.batch_rows)
    batched = asyncio.run(run(port))
    assert batched == sequential == asyncio.run(run(ref))
    assert port.batch_rows.get(3, 0) == before.get(3, 0) + 1


def test_a_mixed_task_batch_goes_through_the_carry(cores):
    """transcribe, translate, transcribe at once: the translate item breaks
    the first batch and is carried to the front of the next round; every
    result equals its sequential run and the reference's."""
    ref, port = cores
    pcms = _pcms(3, seed=9)
    tasks = [("transcribe", False), ("translate", False), ("transcribe", False)]

    async def run(core):
        return await asyncio.gather(*[core.transcribe_windows_async(p, t, timestamps=ts)
                                      for p, (t, ts) in zip(pcms, tasks)])

    before = dict(port.batch_rows)
    got = asyncio.run(run(port))
    assert got == asyncio.run(run(ref))
    for p, (t, ts), windows in zip(pcms, tasks, got):
        assert windows == [port._transcribe_batch([p], port.prompt_ids(t, ts))[0]]
    grew = {n: port.batch_rows.get(n, 0) - before.get(n, 0) for n in port.batch_rows}
    assert grew.get(1, 0) >= 2 and sum(n * c for n, c in grew.items()) == 3 + 3


def test_parse_segments_and_words_from_segments_equal_the_reference(cores):
    ref, port = cores
    w0 = [355, 341, 342, 365, 365, 343, 375]
    w1 = [352, 344, 345]
    for duration in (1.7, 2.0, 0.5):
        assert port.parse_segments([w0, w1], duration) == ref.parse_segments([w0, w1], duration)
    segs = [{"text": "ab cdef", "start": 1.0, "end": 4.0}, {"text": "", "start": 4.0, "end": 5.0},
            {"text": "x", "start": 5.0, "end": 5.5}]
    assert AudioCore.words_from_segments(segs) == RefCore.words_from_segments(segs)


class _StubTok:
    """The reference's stand-in: text ids as letters; 341 decodes with a
    leading space."""

    def decode(self, ids):
        return "".join(" b" if t == 341 else chr(ord("a") + (t - 330) % 26) for t in ids)


class _ByteStubTok:
    """Byte-level BPE stand-in: 'ü' (0xC3 0xBC) split across two tokens."""

    TABLE = {334: b"\xc3", 335: b"\xbc", 336: b"ber", 337: b" x"}

    def decode(self, ids):
        return b"".join(self.TABLE.get(t, b"") for t in ids).decode("utf-8", errors="replace")


@pytest.mark.parametrize("tok,windows", [
    (_StubTok(), [[355, 334, 341, 335, 370]]),
    (_ByteStubTok(), [[355, 334, 335, 336, 337, 370]]),
    (_ByteStubTok(), [[355, 336, 365, 365, 336, 375]]),
    (_ByteStubTok(), [[355, 334, 365, 365, 336, 375, 334]]),
    (_StubTok(), [[355, 334, 341, 335, 370], [351, 340], [352, 336, 341, 338, 360]]),
], ids=["space", "utf8_units", "segment_breaks", "forced_flush", "three_windows"])
def test_words_dtw_equals_the_reference(cores, tok, windows):
    ref, port = cores
    pcm = _pcms(1, seconds=len(windows) - 0.3, seed=4)[0]
    want = ref.words_dtw(pcm, windows, tok)
    got = port.words_dtw(pcm, windows, tok)
    assert got == want and got


def test_words_dtw_on_a_decoded_window_equals_the_reference(cores):
    """The alignment pass over a window the timestamp loop produced."""
    ref, port = cores
    pcm = _pcms(1, seconds=0.8, seed=12)[0]
    prompt = port.prompt_ids("transcribe", True)
    windows = port._transcribe_batch_ts([pcm], prompt)
    assert windows == ref._transcribe_batch_ts([pcm], prompt)
    assert port.words_dtw(pcm, windows, _StubTok()) == ref.words_dtw(pcm, windows, _StubTok())
    health = port.health()
    assert health["host_ms"]["dtw_windows"] >= 1 and health["host_ms"]["mel_windows"] >= 1


def test_refusals_equal_the_reference():
    bert = models.build_model("bert", {"preset": "bert-tiny"})
    with pytest.raises(ValueError, match=r"audio tasks need a speech encoder-decoder bundle "
                                         r"\(arch 'whisper'\)"):
        AudioCore(bert, None, device="cpu")
    bare = {k: v for k, v in CFG.items() if not k.startswith(("transcribe", "translate",
                                                               "timestamp", "notimestamps"))}
    ref, port = _cores(bare)
    for core in (ref, port):
        with pytest.raises(ValueError, match="bundle carries no decoder prompt ids"):
            core.prompt_ids("transcribe")
    ref, port = _cores({k: v for k, v in CFG.items() if k != "timestamp_begin"})
    for core in (ref, port):
        with pytest.raises(ValueError, match="bundle carries no timestamp vocabulary"):
            core.prompt_ids("transcribe", timestamps=True)
        assert core.words_dtw(np.zeros(100, np.float32), [[1]], _StubTok()) is None
    assert "chunk_ts" not in str(port.health()["graph_keys"])


def test_mel_filters_leaf_is_stripped_and_used():
    """A bundle's ``mel_filters`` rides beside the weights: the core takes
    it as its filters and keeps it out of the weights."""
    ref_bundle = jax_models.build_model("whisper", dict(CFG))
    tree = _perturbed(ref_bundle.init(jax.random.PRNGKey(1)), 1)
    tree["mel_filters"] = np.random.default_rng(2).random((201, 16)).astype(np.float32)
    port_bundle = models.build_model("whisper", dict(CFG))
    port = AudioCore(port_bundle, port_bundle.convert_params(tree, "cpu"), device="cpu",
                     decode_steps=STEPS)
    ref = RefCore(ref_bundle, jax.tree.map(jnp.asarray, tree), decode_steps=STEPS)
    assert "mel_filters" not in port.params
    np.testing.assert_array_equal(port.mel_filters, tree["mel_filters"])
    pcms = _pcms(1, seed=13)
    prompt = port.prompt_ids("transcribe")
    assert port._transcribe_batch(pcms, prompt) == ref._transcribe_batch(pcms, prompt)


def test_health_and_retire_after_the_queued_calls():
    """retire() queues the release behind the calls already on the core's
    thread; then the weights and buffers are gone and the thread is back in
    its stream's pool."""
    from clearml_serving_tpu_torch import device

    _ref, port = _cores(max_new_tokens=4)
    health = port.health()
    assert health["ready"] and not health["cuda_graphs"] and health["graph_keys"] == {}
    pcm = _pcms(1, seed=14)[0]
    prompt = port.prompt_ids("transcribe")
    worker = port.worker
    queued = [worker.submit(port._transcribe_batch, [pcm], prompt) for _ in range(3)]
    port.retire()
    assert len({tuple(f.result()[0]) for f in queued}) == 1
    worker.submit(lambda: None).result()
    assert port.health() == {"ready": False, "released": True} and port.params is None
    assert worker in device._FREE_STEP_WORKERS[None]
    with pytest.raises(RuntimeError, match="retired"):
        port._transcribe_batch([pcm], prompt)
