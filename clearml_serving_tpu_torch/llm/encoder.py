"""Encoder-model core: embeddings / pooling / classification / scoring.

The port's counterpart of ``clearml_serving_tpu/llm/encoder.py``
(``EncoderCore``), behind the encoder routes of the ``llm`` engine type
(``v1/embeddings``, ``v1/pooling``, ``v1/classify``, ``v1/score``,
``v1/rerank``; ``llm/openai_api.py``), over an encoder bundle
(``models/bert.py``'s ``hidden``):

- **bucketed static shapes**: inputs pad to (batch bucket, seq bucket);
  the terminal seq bucket is always ``max_seq_len``, and more inputs than
  the largest batch bucket run in chunks;
- **graphs in place of ``jax.jit``**: the reference's three jitted
  functions (``_embed``, ``_tokens``, ``_classify``) are three
  ``BucketRunner``s (``engines/bucket_graph.py``): on the card each
  (function, batch bucket, seq bucket) key is one CUDA graph, captured at
  its first use (6 x 5 x 3 keys exist at the default buckets, too many to
  capture up front at BERT-base width), all in one pool per endpoint. Runs
  are serial (one lock) and each one's output is read before the next, so
  the keys share the pool as one runner's keys do; ``health()`` reports
  the pool's bytes and each key's capture;
- **f32 pooling over the model-dtype encode**: masked mean (or CLS) pooling
  accumulates in float32, then the optional L2 normalization;
- **pair scoring**: a cross-encoder when the classifier head has one label
  (``[CLS] a [SEP] b [SEP]`` -> sigmoid(logit)), the bi-encoder cosine of the
  two pooled embeddings otherwise; a tokenizer without ``cls``/``sep`` ids
  (the byte tokenizer) joins the bare segments, as the reference does.

The routes run the core on ``worker``, a step thread of its own leased from
``device.lease_step_worker`` (cuBLAS keeps a workspace per thread for the
life of the process). ``retire()`` queues the release of the graphs, pool
and weights behind the calls already on that thread; the release holds
``CAPTURE_LOCK``.
"""

from __future__ import annotations

import gc
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import CAPTURE_LOCK, lease_step_worker, resolve_device, return_step_worker
from ..engines.bucket_graph import BucketRunner

_DEFAULT_SEQ_BUCKETS = [32, 64, 128, 256, 512]
_DEFAULT_BATCH_BUCKETS = [1, 2, 4, 8, 16, 32]
FUNCTIONS = ("embed", "tokens", "classify")


class EncoderCore:
    """Bucketed graphs over an encoder bundle (models/bert.py).
    ``cuda_graphs=False`` runs every key eagerly: the arm the card tests
    hold the replays against."""

    def __init__(
        self,
        bundle,
        params,
        *,
        pooling: str = "mean",
        normalize: bool = True,
        seq_buckets: Optional[List[int]] = None,
        batch_buckets: Optional[List[int]] = None,
        sep_token_id: Optional[int] = None,
        cls_token_id: Optional[int] = None,
        device="cuda",
        cuda_graphs: bool = True,
    ):
        self.check_bundle(bundle)
        self.bundle = bundle
        self.params = params
        if pooling not in ("mean", "cls"):
            raise ValueError("pooling must be 'mean' or 'cls'")
        self.pooling = pooling
        self.normalize = bool(normalize)
        self.max_seq_len = int(bundle.config.get("max_seq_len", 512))
        self.dim = int(bundle.config.get("dim"))
        self.num_labels = int(bundle.config.get("num_labels", 0))
        self.vocab_size = int(bundle.config.get("vocab_size", 0))
        self.sep_token_id = sep_token_id
        self.cls_token_id = cls_token_id
        self._seq_buckets = sorted(
            b for b in (seq_buckets or _DEFAULT_SEQ_BUCKETS) if b <= self.max_seq_len
        )
        # the terminal bucket is always max_seq_len, so any admissible length
        # (<= max_seq_len) has a bucket to land in
        if not self._seq_buckets or self._seq_buckets[-1] != self.max_seq_len:
            self._seq_buckets.append(self.max_seq_len)
        self._batch_buckets = sorted(batch_buckets or _DEFAULT_BATCH_BUCKETS)
        self._lock = threading.Lock()

        hidden = bundle.hidden
        pooling, normalize = self.pooling, self.normalize

        def _embed(input_ids, attention_mask):
            x32 = hidden(params, input_ids, attention_mask).float()  # [B, S, D]
            if pooling == "cls":
                pooled = x32[:, 0]
            else:
                mask = attention_mask.float()[:, :, None]
                pooled = (x32 * mask).sum(dim=1) / mask.sum(dim=1).clamp_min(1.0)
            if normalize:
                pooled = pooled / torch.linalg.vector_norm(
                    pooled, dim=-1, keepdim=True).clamp_min(1e-12)
            return pooled  # [B, D] fp32

        def _tokens(input_ids, attention_mask):
            return hidden(params, input_ids, attention_mask).float()

        def _classify(input_ids, attention_mask):
            cls = hidden(params, input_ids, attention_mask)[:, 0].float()
            w = params["classifier"]["w"].float()
            b = params["classifier"]["b"].float()
            return cls @ w + b  # [B, num_labels]

        dev = resolve_device(device)
        graphs = dev.type == "cuda" and bool(cuda_graphs)
        pool = torch.cuda.graph_pool_handle() if graphs else None
        self._runners: Optional[Dict[str, BucketRunner]] = {
            name: BucketRunner(fn, dev, cuda_graphs=graphs, pool=pool)
            for name, fn in zip(FUNCTIONS, (_embed, _tokens, _classify))
        }
        self.device = dev
        self._stream = self._runners["embed"]._stream
        self.worker = lease_step_worker(self._stream)
        self._retired = False

    @staticmethod
    def check_bundle(bundle) -> None:
        """Refuse, with the reference's words, a bundle with no encoder
        surface."""
        if not hasattr(bundle, "hidden"):
            raise ValueError(
                "encoder tasks need a model bundle with a .hidden() surface "
                "(e.g. arch 'bert'); arch {!r} is decoder-only".format(
                    bundle.config.get("arch", "?")
                )
            )

    # -- batching helpers ----------------------------------------------------

    def _bucket(self, n: int, buckets: List[int]) -> int:
        for b in buckets:
            if n <= b:
                return b
        return buckets[-1]

    def _pad_batch(self, id_lists: List[List[int]]) -> Tuple[np.ndarray, np.ndarray]:
        """Pad token-id lists to (batch-bucket, seq-bucket) static shapes."""
        longest = max(len(ids) for ids in id_lists)
        if longest > self.max_seq_len:
            raise ValueError(
                "input length {} exceeds model max_seq_len {}".format(
                    longest, self.max_seq_len
                )
            )
        s = self._bucket(longest, self._seq_buckets)
        b = self._bucket(len(id_lists), self._batch_buckets)
        input_ids = np.zeros((b, s), np.int32)
        mask = np.zeros((b, s), np.int32)
        for i, ids in enumerate(id_lists):
            input_ids[i, : len(ids)] = ids
            mask[i, : len(ids)] = 1
        return input_ids, mask

    def _run_chunks(self, name: str, id_lists: List[List[int]]):
        """Yield (chunk_id_lists, result) per batch-bucket chunk; chunks may
        land in different seq buckets, so results are not concatenated
        here."""
        max_b = self._batch_buckets[-1]
        for start in range(0, len(id_lists), max_b):
            chunk = id_lists[start : start + max_b]
            input_ids, mask = self._pad_batch(chunk)
            with self._lock:  # one run at a time: the keys share one pool
                if self._runners is None:
                    raise RuntimeError("this encoder was retired")
                result = self._runners[name].run([input_ids, mask])
            yield chunk, np.asarray(result)[: len(chunk)]

    def _run_batched(self, name: str, id_lists: List[List[int]]) -> np.ndarray:
        """Run ``name`` over any number of inputs; valid only for outputs
        with no seq axis ([B, ...] the same in every seq bucket)."""
        return np.concatenate(
            [out for _, out in self._run_chunks(name, id_lists)], axis=0
        )

    # -- public surface ------------------------------------------------------

    def embed(self, id_lists: List[List[int]]) -> np.ndarray:
        """[N] token-id lists -> [N, dim] fp32 (L2-normalized if configured)."""
        return self._run_batched("embed", id_lists)

    def token_states(self, id_lists: List[List[int]]) -> List[np.ndarray]:
        """Per-input final hidden states (unpadded): list of [len_i, dim]."""
        out: List[np.ndarray] = []
        for chunk, states in self._run_chunks("tokens", id_lists):
            out.extend(states[i, : len(ids)] for i, ids in enumerate(chunk))
        return out

    def classify(self, id_lists: List[List[int]]) -> np.ndarray:
        """[N] inputs -> [N, num_labels] fp32 logits (CLS head)."""
        if self.num_labels <= 0:
            raise ValueError("model bundle has no classifier head")
        return self._run_batched("classify", id_lists)

    @property
    def is_cross_encoder(self) -> bool:
        return self.num_labels == 1

    def _join_pair(self, a: List[int], b: List[int]) -> List[int]:
        """BERT text-pair assembly: [CLS] a [SEP] b [SEP]. ``a``/``b`` must
        be encoded WITHOUT special tokens; truncation keeps the final SEP."""
        cls = [self.cls_token_id] if self.cls_token_id is not None else []
        sep = [self.sep_token_id] if self.sep_token_id is not None else []
        ids = cls + list(a) + sep + list(b) + sep
        if len(ids) > self.max_seq_len:
            ids = ids[: self.max_seq_len]
            if sep:
                ids[-1] = sep[0]
        return ids

    def score_pairs(
        self,
        pairs: List[Tuple[List[int], List[int]]],
        *,
        with_specials: Optional[bool] = None,
    ) -> List[float]:
        """Relevance score per (text_1, text_2) token-id pair.

        Cross-encoder bundles (num_labels == 1): joint [CLS] a [SEP] b [SEP]
        encode -> sigmoid(logit); pairs must then be encoded WITHOUT special
        tokens. Otherwise: the bi-encoder cosine similarity of the two
        pooled embeddings (pairs encoded with specials, as for embed())."""
        if self.is_cross_encoder:
            joined = [self._join_pair(a, b) for a, b in pairs]
            logits = self.classify(joined)[:, 0]
            return [float(s) for s in 1.0 / (1.0 + np.exp(-logits))]
        flat: List[List[int]] = []
        for a, b in pairs:
            flat.append(list(a))
            flat.append(list(b))
        vecs = self.embed(flat)
        return [
            self._cosine(vecs[2 * i], vecs[2 * i + 1]) for i in range(len(pairs))
        ]

    @staticmethod
    def _cosine(a: np.ndarray, b: np.ndarray) -> float:
        denom = float(np.linalg.norm(a) * np.linalg.norm(b)) or 1e-12
        return float(np.dot(a, b) / denom)

    def rerank(self, query_ids: List[int], doc_id_lists: List[List[int]]) -> List[float]:
        """Score each document against the query. The bi-encoder path
        embeds the query once and takes its cosine with each document's
        embedding; the cross-encoder path joint-encodes each (query, doc)
        pair."""
        if self.is_cross_encoder:
            return self.score_pairs([(query_ids, d) for d in doc_id_lists])
        vecs = self.embed([list(query_ids)] + [list(d) for d in doc_id_lists])
        q = vecs[0]
        return [self._cosine(q, v) for v in vecs[1:]]

    # -- observability and retirement -------------------------------------------

    def health(self) -> Dict[str, Any]:
        runners = self._runners
        if runners is None:
            return {"ready": False, "released": True}
        per = {name: r.health() for name, r in runners.items()}
        return {
            "ready": True,
            "device": str(self.device),
            "cuda_graphs": per["embed"]["cuda_graphs"],
            "graph_captures": sum(h["graph_captures"] for h in per.values()),
            "graph_replays": sum(h["graph_replays"] for h in per.values()),
            "eager_runs": sum(h["eager_runs"] for h in per.values()),
            # the one pool the endpoint's keys share: the rise of the card's
            # reserved memory inside each capture, summed
            "graph_pool_bytes": sum(h["graph_pool_bytes"] for h in per.values()),
            "graph_keys": {"{}:{}".format(name, label): key
                           for name, h in per.items()
                           for label, key in h["graph_keys"].items()},
            "seq_buckets": list(self._seq_buckets),
            "batch_buckets": list(self._batch_buckets),
        }

    def runner(self, name: str) -> BucketRunner:
        """The ``BucketRunner`` of ``name`` (embed, tokens or classify): what
        a timing harness replays."""
        return self._runners[name]

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
                runners, self._runners = self._runners, None
            for r in (runners or {}).values():
                r.release()
            del runners
            self.params = None
            self.bundle = None
            gc.collect()
        return_step_worker(self._stream, self.worker)
