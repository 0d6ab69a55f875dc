"""Draft proposers for speculative verify rows.

Counterpart of ``clearml_serving_tpu/llm/spec_proposer.py``, copied so the
port imports nothing of the JAX package (the module is numpy only; its
drafts equal the reference's bit for bit). A :class:`SpecProposer` turns
each eligible slot's token history into a :class:`DraftForest`: a
fixed-budget draft tree of exactly ``k+1`` nodes (node 0 is the committed
root token, nodes 1..k are drafts) laid out parent-before-child, so the
row's flat token order is a valid topological order. The engine consumes
only the forest arrays.

Topology contract (shared with ``ops.paged_attention.tree_ancestors`` and
``sampling.speculative_sample_tree``):

- ``tokens[s, 0]`` is ignored by proposers (the engine writes the slot's
  committed next token there); ``tokens[s, 1:n]`` are draft tokens.
- ``parents[s, j] < j`` for every live node ``j >= 1`` and
  ``parents[s, 0] == -1``; nodes ``>= n_nodes[s]`` are dead padding
  (parent -1, token 0).
- A chain is the degenerate forest ``parents = [-1, 0, 1, .., k-1]``: the
  acceptance rule and the causal mask then collapse to chain semantics
  byte for byte.

The n-gram forest proposer generalizes the chain proposer's history
matching: instead of continuing only from the last match of the history's
n-token tail, it branches the root across up to ``branch`` distinct
continuations found at different match sites (most recent first, deduped
by first token), then spends the remaining node budget deepening the
primary (most recent) branch.

Proposers run on the engine's loop thread (drafts are ragged row content:
they must exist before the launch is laid out), at batch-of-slots scale.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np


@dataclass
class DraftForest:
    """Fixed-budget draft trees for a batch of spec-eligible slots.

    ``tokens``/``parents``/``depths`` are ``[S, k+1]`` int32 (node-major,
    parent-before-child); ``n_nodes`` [S] counts live nodes (>= 1: the
    root always exists). ``hits`` [S] marks slots whose drafts came from a
    real history match rather than the repeat-last fallback."""

    tokens: np.ndarray
    parents: np.ndarray
    depths: np.ndarray
    n_nodes: np.ndarray
    hits: np.ndarray

    @property
    def budget(self) -> int:
        return int(self.tokens.shape[1])


def chain_parents(k: int) -> np.ndarray:
    """The degenerate single-branch topology: node j hangs off node j-1."""
    return np.concatenate([[-1], np.arange(k, dtype=np.int32)]).astype(np.int32)


def validate_forest(forest: DraftForest) -> None:
    """Raise ValueError on a topology the mask/acceptance contract cannot
    represent (parent-after-child, dead-node parents, depth lies)."""
    s, n = forest.tokens.shape
    for arr, name in ((forest.parents, "parents"), (forest.depths, "depths")):
        if arr.shape != (s, n):
            raise ValueError("forest {} shape {} != {}".format(
                name, arr.shape, (s, n)))
    for b in range(s):
        live = int(forest.n_nodes[b])
        if not (1 <= live <= n):
            raise ValueError("forest row {}: n_nodes {} outside [1, {}]"
                             .format(b, live, n))
        if forest.parents[b, 0] != -1 or forest.depths[b, 0] != 0:
            raise ValueError("forest row {}: node 0 must be the root".format(b))
        for j in range(1, live):
            p = int(forest.parents[b, j])
            if not (0 <= p < j):
                raise ValueError(
                    "forest row {}: node {} parent {} not before it"
                    .format(b, j, p))
            if forest.depths[b, j] != forest.depths[b, p] + 1:
                raise ValueError(
                    "forest row {}: node {} depth {} != parent depth + 1"
                    .format(b, j, int(forest.depths[b, j])))


class SpecProposer:
    """Draft-source interface: history in, :class:`DraftForest` out.

    ``propose(slots, hists, tokbuf, k)`` receives the eligible slot ids,
    their history lengths, and the engine's host token buffer (read-only),
    and returns a forest with budget ``k+1``. Implementations are host-side
    and deterministic given the buffer."""

    name = "base"

    def propose(self, slots: Sequence[int], hists: Sequence[int],
                tokbuf: np.ndarray, k: int) -> DraftForest:
        raise NotImplementedError

    def stats(self) -> Dict[str, int]:
        return {}


def _ngram_matches(buf: np.ndarray, hist: int, n: int, limit_matches: int):
    """(tail, positions): positions (most recent first) where the history's
    n-token tail re-occurs strictly before itself; the continuation after
    each match is a draft branch candidate."""
    buf_len = buf.shape[0]
    tail_pos = np.clip(hist - n + np.arange(n), 0, buf_len - 1)
    tail = buf[tail_pos]
    limit = hist - 2 * n + 1
    if limit <= 0:
        return tail, []
    match = np.ones(limit, bool)
    for j in range(n):
        match &= buf[j: limit + j] == tail[j]
    idx = np.nonzero(match)[0]
    return tail, list(idx[::-1][:limit_matches])


class NgramChainProposer(SpecProposer):
    """Continue from the last match as a single chain (repeat-last-token
    fallback on no match)."""

    name = "ngram-chain"

    def __init__(self, ngram: int = 2):
        self.ngram = int(ngram)
        self.proposed = 0
        self.hit = 0

    def propose(self, slots, hists, tokbuf, k):
        s = len(slots)
        buf_len = tokbuf.shape[1]
        tokens = np.zeros((s, k + 1), np.int32)
        parents = np.broadcast_to(chain_parents(k), (s, k + 1)).copy()
        depths = np.broadcast_to(
            np.arange(k + 1, dtype=np.int32), (s, k + 1)).copy()
        n_nodes = np.full(s, k + 1, np.int32)
        hits = np.zeros(s, bool)
        for i, (slot, hist) in enumerate(zip(slots, hists)):
            buf = tokbuf[slot]
            tail, matches = _ngram_matches(buf, int(hist), self.ngram, 1)
            if matches:
                pos = np.clip(matches[0] + self.ngram + np.arange(k),
                              0, buf_len - 1)
                tokens[i, 1:] = buf[pos]
                hits[i] = True
            else:
                tokens[i, 1:] = tail[-1]
        self.proposed += s
        self.hit += int(hits.sum())
        return DraftForest(tokens, parents, depths, n_nodes, hits)

    def stats(self):
        return {"proposed": self.proposed, "hit": self.hit}


class NgramForestProposer(SpecProposer):
    """N-gram forest drafting: the verify row's k draft nodes split across
    up to ``branch`` sibling continuations of the root.

    Budget layout (k nodes, depth counted from the root):

    - The primary branch (most recent match) takes a chain of depth
      ``k - (extra siblings)``.
    - Each additional distinct match (older, first token different from
      every earlier sibling) contributes one depth-1 sibling node, up to
      ``branch - 1`` of them.
    - No match at all falls back to the chain proposer's repeat-last
      fallback (hits[i] stays False).
    """

    name = "ngram-forest"

    def __init__(self, ngram: int = 2, branch: int = 2,
                 scan_matches: int = 8):
        if branch < 1:
            raise ValueError("forest proposer needs branch >= 1")
        self.ngram = int(ngram)
        self.branch = int(branch)
        self.scan_matches = max(int(scan_matches), int(branch))
        self.proposed = 0
        self.hit = 0
        self.branched = 0       # slots that got more than one root child

    def propose(self, slots, hists, tokbuf, k):
        s = len(slots)
        buf_len = tokbuf.shape[1]
        tokens = np.zeros((s, k + 1), np.int32)
        parents = np.full((s, k + 1), -1, np.int32)
        depths = np.zeros((s, k + 1), np.int32)
        n_nodes = np.ones(s, np.int32)
        hits = np.zeros(s, bool)
        for i, (slot, hist) in enumerate(zip(slots, hists)):
            buf = tokbuf[slot]
            tail, matches = _ngram_matches(
                buf, int(hist), self.ngram, self.scan_matches)
            if not matches:
                # repeat-last fallback chain, as the chain proposer drafts
                tokens[i, 1:] = tail[-1]
                parents[i] = chain_parents(k)
                depths[i] = np.arange(k + 1)
                n_nodes[i] = k + 1
                continue
            hits[i] = True

            def first(m):
                return int(buf[min(m + self.ngram, buf_len - 1)])

            # sibling candidates: distinct first tokens, most recent first
            siblings = [matches[0]]
            for m in matches[1:]:
                if len(siblings) >= self.branch:
                    break
                if first(m) not in {first(x) for x in siblings}:
                    siblings.append(m)
            extra = min(len(siblings) - 1, max(0, k - 1))
            primary_depth = k - extra
            node = 1
            # primary branch: a chain of primary_depth continuations
            pos = np.clip(matches[0] + self.ngram + np.arange(primary_depth),
                          0, buf_len - 1)
            prev = 0
            for t in buf[pos]:
                tokens[i, node] = t
                parents[i, node] = prev
                depths[i, node] = depths[i, prev] + 1
                prev = node
                node += 1
            # depth-1 siblings off the root from the older matches
            for m in siblings[1:1 + extra]:
                tokens[i, node] = first(m)
                parents[i, node] = 0
                depths[i, node] = 1
                node += 1
            n_nodes[i] = node
            if extra > 0:
                self.branched += 1
        self.proposed += s
        self.hit += int(hits.sum())
        return DraftForest(tokens, parents, depths, n_nodes, hits)

    def stats(self):
        return {"proposed": self.proposed, "hit": self.hit,
                "branched": self.branched}


PROPOSERS = {
    "ngram-chain": NgramChainProposer,
    "ngram-forest": NgramForestProposer,
}


def make_proposer(name: str, **kwargs) -> SpecProposer:
    try:
        cls = PROPOSERS[name]
    except KeyError:
        raise ValueError(
            "unknown spec proposer {!r} (have: {})".format(
                name, ", ".join(sorted(PROPOSERS)))) from None
    return cls(**kwargs)
