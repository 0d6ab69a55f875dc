"""Speech-to-text serving core (``v1/audio/transcriptions`` and
``v1/audio/translations``).

The port's counterpart of ``clearml_serving_tpu/llm/audio.py``
(``AudioCore``), behind the audio routes of the ``llm`` engine type
(``llm/openai_api.py``), over a whisper bundle (``models/whisper.py``):

- **the host parts, as the reference has them**: the mel frontend
  (``ops/audio.py``), the prompt ids, the 30 s windows, the greedy loops
  (``_transcribe_batch``: ``chunk[:-1]`` emitted and ``chunk[-1]`` fed
  back, finished rows stepping on, the budget checks where the reference
  has them; ``_transcribe_batch_ts``), the segment parser, the word
  grouping and openai-whisper's timing pipeline (``_median_filter_time``,
  ``_dtw_path``);
- **CUDA graphs in place of ``jax.jit``**: per batch bucket (1, 2, 4 up to
  ``max_batch``) the bucket's static buffers (the mel batch, the model's
  cache: self-K/V over ``max_target`` positions and cross-K/V over the
  window's T, heads-major with K in f32, and ``length``; the encoder states,
  the token chain and the timestamp state)
  and four graphs over them, each captured at the first batch that needs
  it (or by ``warmup()``), before that batch writes the buffers, since a
  capture's warm-up run moves them:

  * ``encode``: ``_encode_jit`` and the cross-K/V half of ``init_cache``
    (the self-K/V and ``length`` zeroed);
  * ``prime``: one decode step (``_prime_jit``), replayed once per prompt
    token, its argmax written into the chain;
  * ``chunk``: ``decode_steps`` greedy steps (``_decode_chunk_batch``);
    its tokens ``[steps, B]`` are read once per chunk and the last one
    chains on the device;
  * ``chunk_ts``: the same with the timestamp rules of ``_ts_body``
    inside (the pair, monotonic and initial-timestamp masks, the
    log-softmax mass test, ``neg = -1e30``); ``pen_is_ts``, ``max_ts``
    and the step counter are device tensors, so one graph serves every
    chunk.

  The alignment pass of ``words_dtw`` (``cross_attention_alignment`` at
  batch 1 over bucket 1's encoder states) is a ``BucketRunner`` keyed by
  the token bucket (powers of two up to ``max_target``). Every graph of the
  core shares one pool: one run at a time, each output read (or copied
  into a static buffer) before the next. A failed capture raises; nothing
  falls back;
- **one thread**: the batch loop runs the device work on ``worker``, a
  step thread leased from ``device.lease_step_worker``, where the
  reference uses ``asyncio.to_thread`` under its lock; the DTW stays off
  it, as the reference keeps it outside its lock;
- the micro-batcher (``transcribe_windows_async``, ``_batch_loop``): the
  10 ms batch delay, the ``(task, timestamps)`` key, the ``_carry`` item
  that goes first in the next round, the queue rebound when the event loop
  changes.

``cuda_graphs=False`` runs every step eagerly: the arm the card tests hold
the replays against. On the CPU everything runs eagerly. ``health()``
reports the captures, replays, capture ms and pool bytes per key, the
captures made outside ``warmup()`` (``serve_captures``), the batches by
rows, and the host's mel and DTW ms. ``retire()`` queues the release of the
graphs, pool and weights behind the calls already on ``worker``; the
release holds ``CAPTURE_LOCK``.
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import CAPTURE_LOCK, lease_step_worker, resolve_device, return_step_worker
from ..engines.bucket_graph import BucketRunner
from .decode_graph import _on_capture_thread, capture_graph

GRAPHS = ("encode", "prime", "chunk", "chunk_ts")


def _median_filter_time(x: np.ndarray, width: int = 7) -> np.ndarray:
    """Median filter along the LAST axis (edge-padded), openai-whisper's
    timing smoothing (medfilt_width=7)."""
    if width <= 1 or x.shape[-1] == 0:
        return x
    pad = width // 2
    padded = np.concatenate(
        [np.repeat(x[..., :1], pad, axis=-1), x,
         np.repeat(x[..., -1:], pad, axis=-1)],
        axis=-1,
    )
    windows = np.lib.stride_tricks.sliding_window_view(padded, width, axis=-1)
    return np.median(windows, axis=-1)


def _dtw_path(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Monotonic alignment through a [N_tokens, M_frames] cost matrix
    (openai-whisper's dtw over -attention): returns (token_idx, frame_idx)
    index arrays of the optimal path.

    The DP runs over ANTI-DIAGONALS: every predecessor of a cell on
    diagonal d (match d-2, deletion d-1, insertion d-1) lies on an earlier
    diagonal, so each diagonal is one vectorized numpy step."""
    n, m = cost.shape
    trace = np.zeros((n + 1, m + 1), np.int8)
    # diag arrays indexed by i: entry i holds acc[i, d - i] (inf off-band)
    prev2 = np.full(n + 1, np.inf)   # diagonal d-2
    prev1 = np.full(n + 1, np.inf)   # diagonal d-1
    prev2[0] = 0.0                   # acc[0, 0]
    for d in range(2, n + m + 1):
        lo = max(1, d - m)   # never > hi for 2 <= d <= n+m with n,m >= 1
        hi = min(n, d - 1)
        i_arr = np.arange(lo, hi + 1)
        j_arr = d - i_arr
        c0 = prev2[i_arr - 1]        # match: acc[i-1, j-1]
        c1 = prev1[i_arr - 1]        # token advances: acc[i-1, j]
        c2 = prev1[i_arr]            # frame advances: acc[i, j-1]
        # tie-break priority matches the scalar formulation: 0, then 1
        choice = np.where(
            (c0 <= c1) & (c0 <= c2), 0, np.where(c1 <= c2, 1, 2)
        ).astype(np.int8)
        best = np.where(choice == 0, c0, np.where(choice == 1, c1, c2))
        cur = np.full(n + 1, np.inf)
        cur[i_arr] = best + cost[i_arr - 1, j_arr - 1]
        trace[i_arr, j_arr] = choice
        prev2, prev1 = prev1, cur
    i, j = n, m
    ti: List[int] = []
    fi: List[int] = []
    while i > 0 and j > 0:
        ti.append(i - 1)
        fi.append(j - 1)
        step = trace[i, j]
        if step == 0:
            i, j = i - 1, j - 1
        elif step == 1:
            i -= 1
        else:
            j -= 1
    return np.array(ti[::-1]), np.array(fi[::-1])


class AudioCore:
    """Whisper serving over per-bucket CUDA graphs (module docstring)."""

    def __init__(
        self,
        bundle,
        params,
        *,
        decode_steps: int = 16,
        max_new_tokens: Optional[int] = None,
        max_batch: int = 4,
        max_batch_delay_ms: float = 10.0,
        device="cuda",
        cuda_graphs: bool = True,
    ):
        from ..ops.audio import mel_filter_bank

        self.check_bundle(bundle)
        self.bundle = bundle
        cfg = bundle.config
        self.params = params
        self.sampling_rate = int(cfg.get("sampling_rate", 16000))
        self.hop_length = int(cfg.get("hop_length", 160))
        self.n_fft = int(cfg.get("n_fft", 400))
        self.chunk_length = int(cfg.get("chunk_length", 30))
        self.n_samples = self.sampling_rate * self.chunk_length
        self.n_mels = int(cfg["n_mels"])
        self.max_target = int(cfg["max_target_positions"])
        self.max_new_tokens = int(max_new_tokens or self.max_target - 8)
        self.decode_steps = max(1, int(decode_steps))
        self.eos_token_id = int(cfg.get("eos_token_id", 50257))
        self._prompts = {
            "transcribe": list(cfg.get("transcribe_prompt_ids") or []),
            "translate": list(cfg.get("translate_prompt_ids") or []),
        }
        # converted bundles carry the checkpoint's own filters in the tree
        filters = None
        if isinstance(params, dict) and "mel_filters" in params:
            filters = np.asarray(params["mel_filters"], np.float32)
            self.params = {k: v for k, v in params.items() if k != "mel_filters"}
        if filters is None:
            filters = mel_filter_bank(self.n_mels, self.n_fft, self.sampling_rate)
        self.mel_filters = filters
        # mel frames per chunk, bounded by the encoder's position table
        self._frames = min(
            self.n_samples // self.hop_length, 2 * int(cfg["max_source_positions"])
        )
        self._lock = threading.Lock()
        # cross-request micro-batching: concurrent utterances with the same
        # task batch into one encode + one greedy loop per batch bucket
        self.max_batch = max(1, int(max_batch))
        self._batch_delay = max(0.0, float(max_batch_delay_ms)) / 1000.0
        self._pending: Optional[asyncio.Queue] = None
        self._loop = None
        self._batch_task = None
        self._carry = None  # deferred different-task item (runs first next round)

        # -- timestamp-conditioned decoding (verbose_json segments) ----------
        self.timestamp_begin = (
            int(cfg["timestamp_begin"]) if cfg.get("timestamp_begin") else None
        )
        self.notimestamps_id = (
            int(cfg["notimestamps_token_id"])
            if cfg.get("notimestamps_token_id") is not None
            else None
        )
        self.time_precision = float(cfg.get("time_precision", 0.02))
        self._max_initial = int(cfg.get("max_initial_timestamp_index", 50))

        dev = resolve_device(device)
        self.device = dev
        self.graphs = dev.type == "cuda" and bool(cuda_graphs)
        self._stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        self._pool = torch.cuda.graph_pool_handle() if self.graphs else None
        with torch.inference_mode():
            self._vocab_ids = torch.arange(int(cfg["vocab_size"]), device=dev)
        self._buckets: Optional[Dict[int, Dict[str, Any]]] = {}
        # (graph name, bucket) -> (graph, static output)
        self._entries: Dict[Tuple[str, int], tuple] = {}
        self.graph_keys: Dict[str, Dict[str, float]] = {}
        self.captures = 0
        self.serve_captures = 0
        self.replays = 0
        self.eager_runs = 0
        self._warming = False
        self.batch_rows: Dict[int, int] = {}
        self.host_ms = {"mel": 0.0, "mel_windows": 0, "dtw": 0.0, "dtw_windows": 0}
        self._align = BucketRunner(self._align_fn, dev, cuda_graphs=self.graphs, pool=self._pool)
        self._heads = self._alignment_heads()
        self.worker = lease_step_worker(self._stream)
        self._retired = False

    @staticmethod
    def check_bundle(bundle) -> None:
        """Refuse, with the reference's words, a bundle with no speech
        encoder-decoder surface."""
        if not hasattr(bundle, "encode") or not hasattr(bundle, "init_cache"):
            raise ValueError(
                "audio tasks need a speech encoder-decoder bundle (arch 'whisper')"
            )

    def prompt_ids(self, task: str, timestamps: bool = False) -> List[int]:
        ids = self._prompts.get(task) or self._prompts.get("transcribe") or []
        if not ids:
            raise ValueError(
                "bundle carries no decoder prompt ids for task {!r} (convert "
                "with engines/importers/convert_hf_whisper.py)".format(task)
            )
        if timestamps:
            if self.timestamp_begin is None:
                raise ValueError(
                    "bundle carries no timestamp vocabulary (re-convert with "
                    "a tokenizer that has <|notimestamps|> to enable "
                    "verbose_json segments)"
                )
            # timestamps flow when the prompt OMITS <|notimestamps|>
            ids = [i for i in ids if i != self.notimestamps_id]
        return ids

    # -- the device side: static buffers and graphs per batch bucket -----------

    def _bucket_state(self, bucket: int, graphs=()) -> Dict[str, Any]:
        """Bucket ``bucket``'s static buffers, made at its first use, with
        the graphs ``graphs`` of it captured (with graphs on) where they
        are not yet: before the caller writes the buffers."""
        if self._buckets is None:
            raise RuntimeError("this audio core was retired")
        st = self._buckets.get(bucket)
        if st is None:
            st = self._buffers(bucket)
            self._buckets[bucket] = st
        for name in graphs if self.graphs else ():
            if (name, bucket) not in self._entries:
                self._capture(name, st)
        return st

    def _buffers(self, bucket: int) -> Dict[str, Any]:
        cfg, dev = self.bundle.config, self.device
        dtype = self.params["embed"].dtype
        d = int(cfg["d_model"])
        t = self._frames // 2
        with torch.inference_mode():
            enc = torch.zeros((bucket, t, d), dtype=dtype, device=dev)
            st = {
                "bucket": bucket,
                "mel": torch.zeros((bucket, self.n_mels, self._frames), dtype=torch.float32,
                                   device=dev),
                "enc": enc,
                # the model's cache layout, made once (its cross K/V of
                # zeros until the bucket's first encode)
                "cache": self.bundle.init_cache(self.params, enc, self.max_target),
                "token": torch.zeros((bucket,), dtype=torch.int32, device=dev),
                "pen_is_ts": torch.ones((bucket,), dtype=torch.bool, device=dev),
                "max_ts": torch.zeros((bucket,), dtype=torch.int32, device=dev),
                "step": torch.zeros((), dtype=torch.int32, device=dev),
            }
        return st

    def _graph_fn(self, name: str):
        return {"encode": self._encode_step, "prime": self._prime_step,
                "chunk": self._chunk_step, "chunk_ts": self._chunk_ts_step}[name]

    def _encode_step(self, st) -> None:
        enc = self.bundle.encode(self.params, st["mel"])
        st["enc"].copy_(enc)
        self.bundle.init_cache(self.params, enc, self.max_target, out=st["cache"])

    def _prime_step(self, st) -> None:
        logits, _ = self.bundle.decode(self.params, st["token"], st["cache"])
        st["token"].copy_(torch.argmax(logits, dim=-1))

    def _chunk_step(self, st) -> torch.Tensor:
        token, toks = st["token"], []
        for _ in range(self.decode_steps):
            logits, _ = self.bundle.decode(self.params, token, st["cache"])
            token = torch.argmax(logits, dim=-1).to(torch.int32)
            toks.append(token)
        st["token"].copy_(token)
        return torch.stack(toks)                                  # [steps, B]

    def _chunk_ts_step(self, st) -> torch.Tensor:
        """``decode_steps`` steps under the reference's timestamp rules
        (``_ts_body``), from the device's step counter."""
        ts_begin, eos = self.timestamp_begin, self.eos_token_id
        ids = self._vocab_ids
        is_ts = ids >= ts_begin
        text_not_eos = (~is_ts) & (ids != eos)
        neg = -1e30
        token, pen_is_ts, max_ts = st["token"], st["pen_is_ts"], st["max_ts"]
        toks = []
        for s in range(self.decode_steps):
            step = st["step"] + s
            logits, _ = self.bundle.decode(self.params, token, st["cache"])
            lg = logits.float()
            last_was = (token >= ts_begin)[:, None]
            pen_was = pen_is_ts[:, None]
            # a completed <|t|><|t|> pair -> next must be text
            lg = torch.where(last_was & pen_was & is_ts[None, :], neg, lg)
            # a single open timestamp -> next must be its pair or EOS
            lg = torch.where(last_was & (~pen_was) & text_not_eos[None, :], neg, lg)
            # monotonic: the pair's second element may repeat the value,
            # otherwise timestamps strictly increase
            bound = torch.where((token >= ts_begin) & ~pen_is_ts, max_ts, max_ts + 1)
            lg = torch.where(is_ts[None, :] & (ids[None, :] < bound[:, None]), neg, lg)
            # first sampled token is a timestamp near the window start
            first = step == 0
            lg = torch.where(first & (~is_ts)[None, :], neg, lg)
            lg = torch.where(first & (ids > ts_begin + self._max_initial)[None, :], neg, lg)
            # if total timestamp mass beats every text token, force a
            # timestamp (after the structural masks)
            lp = torch.log_softmax(lg, dim=-1)
            ts_lse = torch.logsumexp(torch.where(is_ts[None, :], lp, neg), dim=-1)
            max_text = torch.where(is_ts[None, :], neg, lp).amax(dim=-1)
            force = (ts_lse > max_text)[:, None]
            lg = torch.where(force & (~is_ts)[None, :], neg, lg)
            nxt = torch.argmax(lg, dim=-1).to(torch.int32)
            max_ts = torch.where(nxt >= ts_begin, nxt, max_ts)
            pen_is_ts = torch.where(step == 0, True, token >= ts_begin)
            token = nxt
            toks.append(nxt)
        st["token"].copy_(token)
        st["pen_is_ts"].copy_(pen_is_ts)
        st["max_ts"].copy_(max_ts)
        st["step"] += self.decode_steps
        return torch.stack(toks)                                  # [steps, B]

    def _capture(self, name: str, st: Dict[str, Any]) -> None:
        t0 = time.perf_counter()
        fn = self._graph_fn(name)

        def run():
            with torch.inference_mode():
                return fn(st)

        def on_capture_thread():
            with torch.cuda.stream(self._stream):
                return capture_graph(run, self._stream, (), "thread_local", pool=self._pool)

        label = "{}:b{}".format(name, st["bucket"])
        try:
            graph, out, _per_replay, grown = _on_capture_thread(on_capture_thread)
        except Exception as ex:
            raise RuntimeError("CUDA graph capture of {} failed: {}".format(label, ex)) from ex
        self.captures += 1
        if not self._warming:
            self.serve_captures += 1
        self.graph_keys[label] = {"capture_ms": round((time.perf_counter() - t0) * 1e3, 3),
                                  "pool_bytes": int(grown), "replays": 0}
        self._entries[(name, st["bucket"])] = (graph, out)

    def _run(self, name: str, st: Dict[str, Any]):
        """Graph ``name`` of ``st``'s bucket: replayed, or run eagerly."""
        entry = self._entries.get((name, st["bucket"]))
        if entry is None:
            self.eager_runs += 1
            return self._graph_fn(name)(st)
        entry[0].replay()
        self.replays += 1
        self.graph_keys["{}:b{}".format(name, st["bucket"])]["replays"] += 1
        return entry[1]

    def _device(self):
        """The context of a device section: inference mode, and on the card
        the core's stream."""
        stack = contextlib.ExitStack()
        stack.enter_context(torch.inference_mode())
        if self._stream is not None:
            stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def warmup(self, buckets: Optional[List[int]] = None) -> None:
        """Capture every graph of ``buckets`` (default: all of 1, 2, 4 ...
        up to ``max_batch``) now; captures made later count as
        ``serve_captures``. Runs on ``worker``."""
        if buckets is None:
            buckets = sorted({self._batch_bucket(n) for n in range(1, self.max_batch + 1)})
        names = [n for n in GRAPHS if n != "chunk_ts" or self.timestamp_begin is not None]

        def run():
            with self._lock:
                self._warming = True
                try:
                    for b in buckets:
                        self._bucket_state(b, names)
                finally:
                    self._warming = False

        self.worker.submit(run).result()

    def graph(self, name: str, bucket: int):
        """The CUDA graph of ``name`` at ``bucket`` (None before its capture
        or without graphs): what a timing harness replays."""
        entry = self._entries.get((name, bucket))
        return entry[0] if entry is not None else None

    # -- host loops ------------------------------------------------------------

    def _transcribe_chunk(self, pcm: np.ndarray, prompt: List[int]) -> List[int]:
        return self._transcribe_batch([pcm], prompt)[0]

    def transcribe_ids(self, pcm: np.ndarray, task: str = "transcribe") -> List[int]:
        """Full utterance -> generated token ids (30s windows, concatenated)."""
        prompt = self.prompt_ids(task)
        pcm = np.asarray(pcm, np.float32).reshape(-1)
        if len(pcm) == 0:
            return []
        ids: List[int] = []
        for start in range(0, len(pcm), self.n_samples):
            ids.extend(self._transcribe_chunk(pcm[start : start + self.n_samples], prompt))
        return ids

    def parse_segments(
        self, window_ids: List[List[int]], duration: float
    ) -> List[dict]:
        """Timestamp-token streams (one per fixed window) -> verbose_json
        segments. A segment is text bracketed by <|t0|> ... <|t1|>; the
        closing/opening pair between segments shares the value. Windows
        advance by the fixed chunk length."""
        ts_begin = self.timestamp_begin
        precision = self.time_precision
        window_s = float(self.chunk_length)
        segments: List[dict] = []
        for w, ids in enumerate(window_ids):
            offset = w * window_s
            window_end = min(duration, offset + window_s)
            cur_start: Optional[float] = None
            cur_tokens: List[int] = []
            for t in ids:
                if ts_begin is not None and t >= ts_begin:
                    # markers emitted in the window's zero-padded region must
                    # not place segments past the end of the actual audio
                    mark = min((t - ts_begin) * precision + offset, window_end)
                    if cur_tokens:
                        segments.append(
                            {"start": cur_start, "end": mark, "tokens": cur_tokens}
                        )
                        cur_tokens = []
                    cur_start = mark
                else:
                    if cur_start is None:
                        cur_start = offset  # malformed head: anchor to window
                    cur_tokens.append(t)
            if cur_tokens:  # unterminated tail: close at the window edge
                segments.append(
                    {"start": cur_start, "end": window_end, "tokens": cur_tokens}
                )
        out = []
        for i, seg in enumerate(segments):
            out.append(
                {
                    "id": i,
                    "seek": int(seg["start"] // window_s * window_s * 100),
                    "start": round(float(seg["start"]), 2),
                    "end": round(float(seg["end"]), 2),
                    "tokens": seg["tokens"],
                }
            )
        return out

    @staticmethod
    def words_from_segments(segments: List[dict]) -> List[dict]:
        """OpenAI ``timestamp_granularities=["word"]`` payload from decoded
        segments (each must carry "text"/"start"/"end"): word times
        interpolate each segment's span proportionally to character length
        (the fallback when the DTW pass fails)."""
        words: List[dict] = []
        for seg in segments:
            text = seg.get("text") or ""
            tokens = text.split()
            if not tokens:
                continue
            span = max(float(seg["end"]) - float(seg["start"]), 0.0)
            total_chars = sum(len(w) for w in tokens) or 1
            cursor = float(seg["start"])
            for w in tokens:
                dur = span * (len(w) / total_chars)
                words.append(
                    {
                        "word": w,
                        "start": round(cursor, 2),
                        "end": round(min(cursor + dur, float(seg["end"])), 2),
                    }
                )
                cursor += dur
        return words

    # -- word timestamps: cross-attention DTW ------------------------------

    def _alignment_heads(self) -> tuple:
        """Per-model alignment heads (config "alignment_heads" as [layer,
        head] pairs, recorded by the HF converter when the checkpoint ships
        them), else openai-whisper's generic fallback: every head of the
        top half of the decoder."""
        cfg = self.bundle.config
        heads = cfg.get("alignment_heads")
        if heads:
            return tuple((int(l), int(h)) for l, h in heads)
        n_layers = int(cfg["n_text_layers"])
        n_heads = int(cfg["n_heads"])
        return tuple(
            (l, h) for l in range(n_layers // 2, n_layers)
            for h in range(n_heads)
        )

    def _align_fn(self, tokens: torch.Tensor, n_frames: torch.Tensor) -> torch.Tensor:
        """The alignment heads' probabilities over bucket 1's encoder
        states (the window ``_align_windows`` just encoded)."""
        return self.bundle.cross_attention_alignment(
            self.params, tokens, self._buckets[1]["enc"], self._heads, n_frames)

    def _log_mel(self, pcm: np.ndarray) -> np.ndarray:
        from ..ops.audio import log_mel_spectrogram

        t0 = time.perf_counter()
        mel = log_mel_spectrogram(
            pcm, self.mel_filters, n_fft=self.n_fft,
            hop_length=self.hop_length, n_samples=self.n_samples,
        )[:, : self._frames]
        self.host_ms["mel"] += (time.perf_counter() - t0) * 1e3
        self.host_ms["mel_windows"] += 1
        return mel

    def _align_windows(self, pcm: np.ndarray, windows: List[List[int]], prompt: List[int]):
        """The device passes of ``words_dtw`` (on ``worker``): per window
        with text, its encode at bucket 1 and the alignment pass. Returns
        (w, ids, text_pos, mat [N, S_text, T], dur_w) per window."""
        ts_begin = self.timestamp_begin
        frame_s = 2.0 * self.hop_length / self.sampling_rate  # enc position
        pending = []
        with self._lock, self._device():
            for w, ids in enumerate(windows):
                text_pos = [
                    k for k, t in enumerate(ids)
                    if t < ts_begin and t != self.eos_token_id
                ]
                if not text_pos:
                    continue
                chunk = pcm[w * self.n_samples : (w + 1) * self.n_samples]
                dur_w = len(chunk) / self.sampling_rate
                st = self._bucket_state(1, ("encode",))
                st["mel"].copy_(torch.from_numpy(self._log_mel(chunk)[None]))
                self._run("encode", st)
                seq = prompt + list(ids) + [self.eos_token_id]
                bucket = 1
                while bucket < len(seq):
                    bucket *= 2
                bucket = min(bucket, self.max_target)
                toks = np.full((1, bucket), self.eos_token_id, np.int32)
                toks[0, : len(seq)] = seq[:bucket]
                n_frames = max(
                    1,
                    min(self._frames // 2, int(round(dur_w / frame_s))),
                )
                attn = np.asarray(
                    self._align.run([toks, np.asarray(n_frames, np.int32)]), np.float64
                )                                       # [N, 1, S, T]
                n_frames = min(n_frames, attn.shape[-1])
                text_pos = [
                    k for k in text_pos if len(prompt) + k < bucket
                ]
                if not text_pos:
                    continue
                rows = [len(prompt) + k for k in text_pos]
                pending.append(
                    (w, ids, text_pos, attn[:, 0, rows, :n_frames], dur_w)
                )
        return pending

    def words_dtw(
        self, pcm: np.ndarray, windows: List[List[int]], tokenizer,
        task: str = "transcribe",
    ) -> Optional[List[dict]]:
        """Whisper-faithful word timestamps: one teacher-forced decoder pass
        per window emitting the alignment heads' cross-attention maps
        (padding frames masked before the softmax), on ``worker``; then, on
        the calling thread, openai-whisper's timing pipeline (per-head
        z-norm over tokens, median filter over time, head average, DTW over
        the negative map) and the token -> word grouping: consecutive tokens
        accumulate until they decode without a trailing replacement char,
        and words break at whitespace and at timestamp markers. Returns
        None when the bundle has no alignment surface or no timestamps."""
        align_fn = getattr(self.bundle, "cross_attention_alignment", None)
        if align_fn is None or self.timestamp_begin is None:
            return None
        prompt = self.prompt_ids(task, timestamps=True)
        ts_begin = self.timestamp_begin
        frame_s = 2.0 * self.hop_length / self.sampling_rate  # enc position
        pcm = np.asarray(pcm, np.float32).reshape(-1)
        # phase 1: device passes only, on the core's thread
        pending = self.worker.submit(self._align_windows, pcm, windows, prompt).result()
        # phase 2: host-only timing + word grouping
        words: List[dict] = []
        for w, ids, text_pos, mat, dur_w in pending:
            t0 = time.perf_counter()
            offset = w * float(self.chunk_length)
            std = mat.std(axis=-2, keepdims=True)
            mean = mat.mean(axis=-2, keepdims=True)
            mat = (mat - mean) / np.maximum(std, 1e-8)
            mat = _median_filter_time(mat)
            mat = mat.mean(axis=0)                      # [S_text, T]
            ti, fi = _dtw_path(-mat)
            self.host_ms["dtw"] += (time.perf_counter() - t0) * 1e3
            self.host_ms["dtw_windows"] += 1
            # first frame of each token's run on the path = its onset
            jumps = np.diff(ti, prepend=-1) > 0
            starts = fi[jumps] * frame_s
            bounds = np.concatenate([starts, [dur_w]])
            span = {
                k: (float(bounds[i]), float(min(bounds[i + 1], dur_w)))
                for i, k in enumerate(text_pos)
            }
            cur_text, cur_start, cur_end = "", None, None
            unit: List[int] = []  # token positions of a pending decode unit

            def flush_word():
                nonlocal cur_text, cur_start, cur_end
                if cur_text.strip():
                    words.append({
                        "word": cur_text.strip(),
                        "start": round(cur_start, 2),
                        "end": round(cur_end, 2),
                    })
                cur_text, cur_start, cur_end = "", None, None

            def emit_unit(text: str, toks: List[int]):
                nonlocal cur_text, cur_start, cur_end
                st = span[toks[0]][0] + offset
                en = span[toks[-1]][1] + offset
                if text[:1].isspace() and cur_text.strip():
                    flush_word()
                if not text.strip():
                    if cur_text.strip():
                        flush_word()
                    return
                if cur_start is None:
                    cur_start = st
                cur_text += text
                cur_end = en

            def force_unit(toks: List[int]):
                # a unit cut off mid-codepoint (segment boundary / window
                # end): drop the incomplete bytes' replacement chars rather
                # than hand clients mojibake
                text = tokenizer.decode([ids[i] for i in toks])
                text = text.replace("�", "")
                if text:
                    emit_unit(text, toks)

            for k, t in enumerate(ids):
                if t >= ts_begin or t == self.eos_token_id:
                    # segment boundary: close the open unit and word
                    if unit:
                        force_unit(unit)
                        unit = []
                    flush_word()
                    continue
                if k not in span:
                    continue
                unit.append(k)
                text = tokenizer.decode([ids[i] for i in unit])
                if text.endswith("�"):
                    continue  # split codepoint: extend the unit
                if not text:
                    unit = []  # special token: contributes no text or break
                    continue
                emit_unit(text, unit)
                unit = []
            if unit:
                force_unit(unit)
            flush_word()
        return words

    def _encode_and_prime(self, pcms: List[np.ndarray], prompt: List[int],
                          chunk: str = "chunk") -> Dict[str, Any]:
        """Shared admission preamble (the caller holds ``self._lock`` and
        ``_device()``): the bucket's graphs for a loop of ``chunk`` ready,
        then mel batch -> encoder -> cache primed with all but the LAST
        prompt token, which is left in the bucket's token chain. Returns
        the bucket's state."""
        st = self._bucket_state(self._batch_bucket(len(pcms)), ("encode", "prime", chunk))
        mels = np.zeros((st["bucket"], self.n_mels, self._frames), np.float32)
        for i, pcm in enumerate(pcms):
            mels[i] = self._log_mel(pcm)
        st["mel"].copy_(torch.from_numpy(mels))
        self._run("encode", st)
        st["token"].fill_(prompt[0])
        for tok in prompt[1:]:
            self._run("prime", st)
            st["token"].fill_(tok)
        return st

    def _reset_ts(self, st: Dict[str, Any]) -> None:
        """The timestamp chunk's device state before a window's first
        chunk: the sampled sequence's pairing state True (the len < 2
        default), no timestamp yet, step 0."""
        st["pen_is_ts"].fill_(True)
        st["max_ts"].fill_(self.timestamp_begin - 1)
        st["step"].zero_()

    def _transcribe_batch_ts(
        self, pcms: List[np.ndarray], prompt: List[int]
    ) -> List[List[int]]:
        """Timestamp-conditioned variant of _transcribe_batch: the final
        prompt token feeds the rules-constrained chunk directly (its very
        first sample must already obey the initial-timestamp rule), and the
        outputs KEEP timestamp tokens for the segment parser."""
        n = len(pcms)
        with self._lock, self._device():
            st = self._encode_and_prime(pcms, prompt, "chunk_ts")
            bucket = st["bucket"]
            self._reset_ts(st)
            outs: List[List[int]] = [[] for _ in range(bucket)]
            done = [False] * bucket
            budget = min(self.max_new_tokens, self.max_target - len(prompt) - 1)
            step = 0
            while not all(done[:n]) and step < budget:
                chunk_np = self._run("chunk_ts", st).cpu().numpy()  # [steps, B]
                for s_i in range(chunk_np.shape[0]):
                    if step + s_i >= budget:
                        break
                    for i in range(n):
                        if done[i]:
                            continue
                        t = int(chunk_np[s_i, i])
                        if t == self.eos_token_id:
                            done[i] = True
                        else:
                            outs[i].append(t)
                step += chunk_np.shape[0]
            self._count_batch(n)
        return outs[:n]

    # -- cross-request batching ------------------------------------------------

    def _batch_bucket(self, n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_batch)

    def _count_batch(self, n: int) -> None:
        self.batch_rows[n] = self.batch_rows.get(n, 0) + 1

    def _transcribe_batch(
        self, pcms: List[np.ndarray], prompt: List[int]
    ) -> List[List[int]]:
        """N <= max_batch single-window utterances, one shared prompt ->
        per-utterance token ids. One encode + one greedy loop over the batch;
        finished sequences keep stepping (masked host-side) until all hit
        eos or the budget."""
        n = len(pcms)
        with self._lock, self._device():
            st = self._encode_and_prime(pcms, prompt)
            bucket = st["bucket"]
            self._run("prime", st)
            outs: List[List[int]] = [[] for _ in range(bucket)]
            done = [False] * bucket
            budget = min(self.max_new_tokens, self.max_target - len(prompt) - 1)
            step = st["token"].cpu().numpy()
            while not all(done[:n]):
                for i in range(n):
                    if not done[i]:
                        if int(step[i]) == self.eos_token_id or len(outs[i]) >= budget:
                            done[i] = True
                        else:
                            outs[i].append(int(step[i]))
                if all(done[:n]):
                    break
                # the chunk reads the chain from the device; its last token
                # chains there too
                chunk_np = self._run("chunk", st).cpu().numpy()  # [steps, B]
                for s_i in range(chunk_np.shape[0] - 1):
                    for i in range(n):
                        if done[i]:
                            continue
                        t = int(chunk_np[s_i, i])
                        if t == self.eos_token_id or len(outs[i]) >= budget:
                            done[i] = True
                        else:
                            outs[i].append(t)
                step = chunk_np[-1]
            self._count_batch(n)
        return outs[:n]

    async def transcribe_windows_async(
        self, pcm: np.ndarray, task: str = "transcribe", timestamps: bool = False
    ) -> List[List[int]]:
        """Batching front door: concurrent utterances with the same
        (task, timestamps) key share one encode/decode pass. Long audio
        submits each 30s window in order; returns PER-WINDOW token lists
        (the segment parser needs window boundaries for time offsets)."""
        self.prompt_ids(task, timestamps)  # surface config errors early
        loop = asyncio.get_running_loop()
        if self._pending is None or getattr(self, "_loop", None) is not loop:
            # an asyncio.Queue is bound to its creating loop: rebind when the
            # serving loop changes (tests, process-model restarts) or a put
            # into the dead loop's queue would hang forever
            self._pending = asyncio.Queue()
            self._loop = loop
            self._batch_task = None
        pcm = np.asarray(pcm, np.float32).reshape(-1)
        if len(pcm) == 0:
            return []
        key: Tuple[str, bool] = (task, bool(timestamps))
        windows: List[List[int]] = []
        for start in range(0, len(pcm), self.n_samples):
            fut = loop.create_future()
            await self._pending.put((pcm[start : start + self.n_samples], key, fut))
            self._ensure_batch_loop()
            windows.append(await fut)
        return windows

    async def transcribe_ids_async(
        self, pcm: np.ndarray, task: str = "transcribe"
    ) -> List[int]:
        """Flattened-token front door (plain text responses)."""
        windows = await self.transcribe_windows_async(pcm, task)
        return [t for w in windows for t in w]

    def _ensure_batch_loop(self) -> None:
        if self._batch_task is None or self._batch_task.done():
            self._batch_task = asyncio.get_running_loop().create_task(
                self._batch_loop()
            )

    async def _batch_loop(self) -> None:
        while True:
            if self._carry is not None:
                first, self._carry = self._carry, None
            else:
                try:
                    first = await asyncio.wait_for(self._pending.get(), timeout=5.0)
                except asyncio.TimeoutError:
                    if self._pending.empty():
                        return  # idle; a new submit restarts the loop
                    continue
            batch = [first]
            deadline = (
                asyncio.get_running_loop().time() + self._batch_delay
            )
            while len(batch) < self.max_batch:
                remaining = deadline - asyncio.get_running_loop().time()
                if remaining <= 0:
                    break
                try:
                    item = await asyncio.wait_for(self._pending.get(), timeout=remaining)
                except asyncio.TimeoutError:
                    break
                if item[1] != batch[0][1]:
                    # different task (prompt ids differ): carry it to the
                    # FRONT of the next round; re-queueing at the tail could
                    # starve it under sustained same-task load
                    self._carry = item
                    break
                batch.append(item)
            pcms = [b[0] for b in batch]
            futures = [b[2] for b in batch]
            task, with_ts = batch[0][1]
            try:
                prompt = self.prompt_ids(task, with_ts)
                fn = self._transcribe_batch_ts if with_ts else self._transcribe_batch
                outs = await asyncio.get_running_loop().run_in_executor(
                    self.worker, fn, pcms, prompt)
                for fut, out in zip(futures, outs):
                    if not fut.done():
                        fut.set_result(out)
            except Exception as ex:
                for fut in futures:
                    if not fut.done():
                        fut.set_exception(ex)

    # -- observability and retirement -------------------------------------------

    def health(self) -> Dict[str, Any]:
        if self._buckets is None:
            return {"ready": False, "released": True}
        align = self._align.health()
        keys = {label: dict(key) for label, key in self.graph_keys.items()}
        keys.update({"align:" + label: dict(key)
                     for label, key in align["graph_keys"].items()})
        return {
            "ready": True,
            "device": str(self.device),
            "cuda_graphs": self.graphs,
            "graph_captures": self.captures + align["graph_captures"],
            "serve_captures": self.serve_captures + align["graph_captures"],
            "graph_replays": self.replays + align["graph_replays"],
            "eager_runs": self.eager_runs + align["eager_runs"],
            # the one pool the core's keys share: the rise of the card's
            # reserved memory inside each capture, summed
            "graph_pool_bytes": sum(int(k["pool_bytes"]) for k in keys.values()),
            "graph_keys": keys,
            "buckets": sorted(self._buckets),
            "batch_rows": dict(sorted(self.batch_rows.items())),
            "host_ms": dict(self.host_ms),
        }

    def retire(self) -> None:
        """Release the graphs, pool and weights once the calls already
        queued on ``worker`` have run (it runs one call at a time, in
        order)."""
        if self._retired:
            return
        self._retired = True
        self.worker.submit(self._release)

    def _release(self) -> None:
        with CAPTURE_LOCK:
            with self._lock:
                self._entries.clear()
                self._buckets = None
                self._align.release()
            self.params = None
            self.bundle = None
            gc.collect()
        return_step_worker(self._stream, self.worker)
