"""Batched token sampling for the decode batch.

Counterpart of ``clearml_serving_tpu/llm/sampling.py`` (``SamplingParams``,
``make_sampling_params``, ``warp_logits``, ``sample_tokens``, and the
speculative acceptance rules ``greedy_tree_walk``,
``speculative_sample_tree``, ``speculative_sample_chain``): per-slot
temperature / top-k / top-p as tensors over the batch, greedy where the
temperature is 0. A categorical draw is ``argmax(scaled + gumbel)``, which
is how ``jax.random.categorical`` samples too, so a caller (a test) that
passes the reference's Gumbel draws as ``noise`` (and, for the speculative
samplers, its uniform draws as ``uniform``) gets the reference's tokens.
Without them the draws come from the given ``torch.Generator``. The engine's
decode chunk draws all its steps' noise at once (``gumbel_noise`` of
``[steps, B, V]``, outside the chunk's CUDA graph, whose own draws would
repeat at every replay) and passes each step's slice as ``noise``.

The reference's extras (``SamplingExtras``, ``penalize_logits``): logit
bias, presence/frequency penalties over the generated-token histogram
(``counts``), the repetition penalty over generated and prompt tokens
(``prompt_mask``), and the ``min_tokens`` floor over each row's stop set,
applied before temperature to greedy and sampled rows alike. A row with a
per-request seed draws its Gumbel row from ``fold_in(PRNGKey(seed),
counter)`` (``llm/prng.py``, bitwise ``jax.random``), inside the chunk's
graph, so a seeded request gives the JAX server's tokens whatever the
batch around it; unseeded rows keep the engine generator's draws.
``logprobs_of`` gives the chosen token's logprob and the top-k over the
penalized, unwarped logits (the reference's ``_lp_of``).

Guided decoding (the reference engine's ``_guided_mask`` and
``_guided_advance``): ``guided_mask`` keeps the token ids a slot's grammar
state allows (a packed bit row of ``llm/guided.py``'s combined table) and
fills the rest with -1e30, before the extras; ``guided_advance`` walks each
sampled token's bytes through the byte DFA. Both are plain tensor ops, so
the decode chunk's graph holds them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .prng import seeded_gumbel

# stop tokens the min_tokens floor suppresses per request (the reference's
# engine-level _STOP_SLOTS)
STOP_SLOTS = 8


class SamplingParams(NamedTuple):
    temperature: torch.Tensor  # [B] float32; 0 => greedy
    top_k: torch.Tensor        # [B] int32; 0 => disabled
    top_p: torch.Tensor        # [B] float32; 1.0 => disabled


class SamplingExtras(NamedTuple):
    """Per-row penalty, bias, seed and min_tokens state (the reference's
    ``SamplingExtras``)."""

    presence: torch.Tensor    # [B] f32; 0 disables
    frequency: torch.Tensor   # [B] f32; 0 disables
    repetition: torch.Tensor  # [B] f32; 1.0 disables
    bias: torch.Tensor        # [B, V] f32 dense additive bias
    # [B] int32, < 0 unseeded; None: no row of the batch is seeded (the
    # seeded draw is skipped)
    seeds: Optional[torch.Tensor]
    counters: torch.Tensor    # [B] int32 tokens generated before this one
    min_new: Optional[torch.Tensor] = None  # [B] int32; 0 disables
    stop: Optional[torch.Tensor] = None     # [B, STOP_SLOTS] int32, -1-padded


def make_sampling_params(batch, temperature=0.0, top_k=0, top_p=1.0,
                         device="cuda") -> SamplingParams:
    return SamplingParams(
        temperature=torch.full((batch,), float(temperature), dtype=torch.float32, device=device),
        top_k=torch.full((batch,), int(top_k), dtype=torch.int32, device=device),
        top_p=torch.full((batch,), float(top_p), dtype=torch.float32, device=device),
    )


def warp_logits(logits, temperature, top_k, top_p):
    """Temperature-scale + top-k + top-p mask: [N, V] logits with per-row
    params [N] -> masked scaled logits (softmax of the result is the
    sampling distribution)."""
    _n, v = logits.shape
    scaled = logits / temperature.clamp(min=1e-6)[:, None]

    # top-k mask (k == 0 disables)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k, v).long()
    kth = sorted_desc.gather(-1, (k - 1).clamp(max=v - 1)[:, None])   # [N, 1]
    scaled = scaled.masked_fill(scaled < kth, float("-inf"))

    # top-p (nucleus) mask over the sorted distribution: keep tokens while
    # the cumulative probability before them is below top_p
    sorted_scaled = torch.sort(scaled, dim=-1, descending=True).values
    probs_sorted = torch.softmax(sorted_scaled, dim=-1)
    cumulative = torch.cumsum(probs_sorted, dim=-1)
    keep_sorted = (cumulative - probs_sorted) < top_p[:, None]
    cutoff = torch.where(keep_sorted, sorted_scaled, float("inf")).amin(
        dim=-1, keepdim=True
    )                                                                  # lowest kept logit
    return scaled.masked_fill(scaled < cutoff, float("-inf"))


def penalize_logits(logits: torch.Tensor, extras: SamplingExtras,
                    counts: Optional[torch.Tensor],
                    prompt_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Bias and penalties on raw logits [B, V], before temperature, in the
    reference's order: bias; frequency (by count) and presence (flat) over
    the generated-token histogram ``counts`` [B, V] int32; the repetition
    penalty (divide positive logits, multiply negative ones) over every
    token generated or in the prompt (``prompt_mask`` [B, V] bool); then
    the min_tokens floor: a row below ``min_new`` loses its stop tokens,
    unless they are all it has left (a row is never blanked)."""
    logits = logits + extras.bias
    seen = None
    if counts is not None:
        counts_f = counts.float()
        logits = logits - extras.frequency[:, None] * counts_f
        logits = logits - extras.presence[:, None] * (counts_f > 0)
        seen = counts > 0
    if prompt_mask is not None:
        seen = prompt_mask if seen is None else (seen | prompt_mask)
    if seen is not None:
        rp = extras.repetition[:, None]
        logits = torch.where(seen, torch.where(logits > 0, logits / rp, logits * rp), logits)
    if extras.min_new is not None and extras.stop is not None:
        v_idx = torch.arange(logits.shape[-1], dtype=torch.int32, device=logits.device)
        is_stop = (v_idx[None, None, :] == extras.stop[:, :, None]).any(dim=1)   # [B, V]
        others_alive = (logits.masked_fill(is_stop, float("-inf")) > -1e29).any(
            dim=-1, keepdim=True)
        blocked = (extras.counters < extras.min_new)[:, None] & is_stop & others_alive
        logits = logits.masked_fill(blocked, -1e30)
    return logits


def logprobs_of(logits: torch.Tensor, chosen: torch.Tensor, k: int):
    """(chosen logprob [B], top ids [B, k] int32, top logprobs [B, k]) of
    ``log_softmax(logits)``; callers pass the penalized logits where extras
    apply (reported logprobs reflect what was sampled from)."""
    lp_full = torch.log_softmax(logits.float(), dim=-1)
    chosen_lp = lp_full.gather(-1, chosen.long()[:, None])[:, 0]
    top_lp, top_id = top_k(lp_full, k)
    return chosen_lp, top_id, top_lp


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: (values, int32 indices), equal
    values in index order (a stable sort; ``torch.topk`` leaves ties
    unordered)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k].to(torch.int32)


def gumbel_noise(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def sample_tokens(logits: torch.Tensor, params: SamplingParams, *,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None,
                  all_greedy: bool = False,
                  extras: Optional[SamplingExtras] = None,
                  counts: Optional[torch.Tensor] = None,
                  prompt_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits [B, V] float32 -> token ids [B] int32. Rows with temperature
    <= 0 take the argmax; others sample from the temperature-scaled,
    top-k/top-p-filtered distribution. ``extras`` (with ``counts`` and
    ``prompt_mask``) penalize both paths first, and seed the rows that
    carry a seed. ``all_greedy`` (known host-side) skips the sampling work
    when no row samples."""
    if extras is not None:
        logits = penalize_logits(logits, extras, counts, prompt_mask)
    return sample_penalized(logits, params, generator=generator, noise=noise,
                            all_greedy=all_greedy, extras=extras)


def sample_penalized(logits: torch.Tensor, params: SamplingParams, *,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None,
                     all_greedy: bool = False,
                     extras: Optional[SamplingExtras] = None) -> torch.Tensor:
    """``sample_tokens`` over logits the caller already penalized: a seeded
    row of ``extras`` draws its Gumbel row from its seed and counter, the
    other rows from ``noise`` (or ``generator``)."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if all_greedy:
        return greedy
    scaled = warp_logits(logits, params.temperature, params.top_k, params.top_p)
    if noise is None:
        noise = gumbel_noise(scaled.shape, generator, scaled.device)
    if extras is not None and extras.seeds is not None:
        seeded = seeded_gumbel(extras.seeds, extras.counters, scaled.shape[-1])
        noise = torch.where((extras.seeds >= 0)[:, None], seeded, noise)
    sampled = torch.argmax(scaled + noise, dim=-1).to(torch.int32)
    return torch.where(params.temperature <= 0.0, greedy, sampled)


def _warped_probs(logits, params):
    """Per-node warped logits [B, N, V] and their softmax: each node of row
    b sampled under row b's temperature / top-k / top-p."""
    b, n, v = logits.shape

    def rep(x):
        return x.repeat_interleave(n)

    warped = warp_logits(logits.reshape(b * n, v), rep(params.temperature),
                         rep(params.top_k), rep(params.top_p)).reshape(b, n, v)
    return warped, torch.softmax(warped, dim=-1)


def _draws(b, n, v, generator, device, uniform, noise):
    """The two random draws of a speculative sampler: uniforms [B, N-1]
    for the accept tests, Gumbel noise [B, N, V] for the fallback token."""
    if uniform is None:
        uniform = torch.rand((b, n - 1), generator=generator, device=device,
                             dtype=torch.float32)
    if noise is None:
        noise = gumbel_noise((b, n, v), generator, device)
    return uniform, noise


def greedy_tree_walk(greedy, tokens, parents, n_nodes):
    """Longest accepted root-to-leaf path under greedy acceptance: walking
    from the root in node order (a topological order), a child is accepted
    iff its draft token equals the argmax at its parent. ``greedy``,
    ``tokens``, ``parents`` [B, N] int, ``n_nodes`` [B]. Returns (path [B,
    N], acc [B], nodes [B, N]): path[b, :acc] the accepted drafts in path
    order, path[b, acc] the bonus token (argmax at the last accepted node);
    nodes[b, i] the tree node whose K/V belongs at row position i after
    acceptance (identity at 0 and past acc), the KV compaction map. On a
    chain this is acc = sum(cumprod(drafts == argmax[:, :k]))."""
    b, n = tokens.shape
    dev = tokens.device
    rows = torch.arange(b, device=dev)
    col = torch.arange(n, device=dev)[None, :]
    cur = torch.zeros(b, dtype=torch.long, device=dev)
    acc = torch.zeros(b, dtype=torch.long, device=dev)
    path = torch.zeros((b, n), dtype=torch.int32, device=dev)
    nodes = col.expand(b, n).to(torch.int32)
    for j in range(1, n):
        tok = tokens[:, j].to(torch.int32)
        ok = (j < n_nodes) & (parents[:, j] == cur) & (tok == greedy[rows, cur])
        path = torch.where((col == acc[:, None]) & ok[:, None], tok[:, None], path)
        nodes = torch.where((col == acc[:, None] + 1) & ok[:, None], j, nodes)
        cur = torch.where(ok, j, cur)
        acc = acc + ok.long()
    bonus = greedy[rows, cur].to(torch.int32)
    path = torch.where(col == acc[:, None], bonus[:, None], path)
    return path, acc.to(torch.int32), nodes


def speculative_sample_tree(logits, tokens, parents, n_nodes, params: SamplingParams, *,
                            generator: Optional[torch.Generator] = None,
                            uniform: Optional[torch.Tensor] = None,
                            noise: Optional[torch.Tensor] = None):
    """Multi-draft rejection sampling over a draft tree with point-mass
    proposers (the reference's ``speculative_sample_tree``).

    Walking from the root in node order, each frontier child with draft d
    is accepted with probability P_cur(d) / (1 - R), P_cur the warped
    distribution at the current node and R the mass of its already
    rejected sibling drafts; an accepted child advances the walk and resets
    R. The last token is drawn from the last accepted node's residual (its
    rejected children masked out), or its plain warped distribution when a
    child was accepted at every step. ``logits`` [B, N, V] f32; ``uniform``
    [B, N-1] and ``noise`` [B, N, V] are the draws (taken from
    ``generator`` when absent); their shapes are the chain sampler's, so a
    chain topology gives :func:`speculative_sample_chain`'s tokens byte for
    byte. Returns (path [B, N], acc [B], nodes [B, N]) as
    :func:`greedy_tree_walk`."""
    b, n, v = logits.shape
    dev = logits.device
    warped, probs = _warped_probs(logits, params)
    u, noise = _draws(b, n, v, generator, dev, uniform, noise)
    rows = torch.arange(b, device=dev)
    col = torch.arange(n, device=dev)[None, :]
    cur = torch.zeros(b, dtype=torch.long, device=dev)
    acc = torch.zeros(b, dtype=torch.long, device=dev)
    path = torch.zeros((b, n), dtype=torch.int32, device=dev)
    nodes = col.expand(b, n).to(torch.int32)
    rej_mass = torch.zeros(b, dtype=torch.float32, device=dev)
    rejected = torch.zeros((b, n), dtype=torch.bool, device=dev)
    for j in range(1, n):
        tok = tokens[:, j].long()
        test = (j < n_nodes) & (parents[:, j] == cur)
        p_tok = probs[rows, cur, tok]
        p_adj = p_tok / torch.clamp(1.0 - rej_mass, min=1e-9)
        ok = test & (u[:, j - 1] < p_adj)
        rej = test & ~ok
        path = torch.where((col == acc[:, None]) & ok[:, None],
                           tok.to(torch.int32)[:, None], path)
        nodes = torch.where((col == acc[:, None] + 1) & ok[:, None], j, nodes)
        rejected[:, j] = rej
        rej_mass = torch.where(ok, 0.0, torch.where(rej, rej_mass + p_tok, rej_mass))
        cur = torch.where(ok, j, cur)
        acc = acc + ok.long()
    # residual per node: its rejected children's draft tokens masked out
    # (drawn over every node, so the Gumbel draw keeps the chain's shape)
    par_oh = (parents[:, 1:, None] == torch.arange(n, device=dev)).float()  # [B, N-1, N]
    tok_oh = torch.nn.functional.one_hot(tokens[:, 1:].long(), v).float()   # [B, N-1, V]
    rej_w = rejected[:, 1:].float()[..., None] * par_oh
    rej_tokens = torch.einsum("bjn,bjv->bnv", rej_w, tok_oh) > 0.0
    w_all = warped.masked_fill(rej_tokens, float("-inf"))
    fallback = torch.argmax(w_all + noise, dim=-1).to(torch.int32)          # [B, N]
    f_at = fallback.gather(1, cur[:, None])[:, 0]
    path = torch.where(col == acc[:, None], f_at[:, None], path)
    return path, acc.to(torch.int32), nodes


def speculative_sample_chain(logits, drafts, params: SamplingParams, *,
                             generator: Optional[torch.Generator] = None,
                             uniform: Optional[torch.Tensor] = None,
                             noise: Optional[torch.Tensor] = None):
    """Rejection-based speculative sampling over a deterministic draft
    chain (the reference's ``speculative_sample_chain``). Draft d_i is
    accepted with probability P_i(d_i); at the first rejection one token is
    drawn from the residual (P_i without the draft); if all K drafts pass, a
    bonus token from P_K. The emitted prefix has exactly the law of
    autoregressive sampling from the warped distributions. ``logits`` [B,
    K+1, V] f32, ``drafts`` [B, K]; ``uniform`` [B, K] and ``noise`` [B,
    K+1, V] as in :func:`speculative_sample_tree`. Returns (tokens [B,
    K+1], acc [B]): tokens[b, :acc] the accepted drafts, tokens[b, acc] the
    residual or bonus token."""
    b, k1, v = logits.shape
    k = k1 - 1
    dev = logits.device
    warped, probs = _warped_probs(logits, params)
    u, noise = _draws(b, k1, v, generator, dev, uniform, noise)
    drafts = drafts.long()
    p_draft = probs[:, :k].gather(-1, drafts[..., None])[..., 0]          # [B, K]
    acc = torch.cumprod((u < p_draft).long(), dim=1).sum(dim=1)
    # fallback per position: the residual (draft masked out) at the K
    # draft positions, the plain bonus at position K
    draft_hot = torch.nn.functional.one_hot(drafts, v).bool()              # [B, K, V]
    w_resid = warped[:, :k].masked_fill(draft_hot, float("-inf"))
    w_all = torch.cat([w_resid, warped[:, k:]], dim=1)                     # [B, K+1, V]
    fallback = torch.argmax(w_all + noise, dim=-1).to(torch.int32)
    f_at = fallback.gather(1, acc[:, None])[:, 0]
    tokens = torch.cat([drafts.to(torch.int32), fallback[:, k:]], dim=1)
    tokens[torch.arange(b, device=dev), acc] = f_at
    return tokens, acc.to(torch.int32)


# the fill of a token the grammar forbids: finite, as the reference's, so a
# masked id's logprob entry is the reference's value, not -inf
GUIDED_FILL = -1e30


def guided_mask(logits: torch.Tensor, gstate: torch.Tensor,
                mask_bits: torch.Tensor) -> torch.Tensor:
    """Constrain logits [B, V] to the slots' grammar states (the
    reference's ``_guided_mask``). ``gstate`` [B] int32 indexes the rows of
    ``mask_bits`` [S, ceil(V/8)] uint8 (token v is bit v % 8 of byte v // 8),
    clamped into them as JAX's gather clamps (a stale state of a larger
    table reads a row, never past the buffer); a row with ``gstate < 0`` is
    unguided. A row whose state allows nothing degrades to
    unconstrained."""
    b, v = logits.shape
    rows = mask_bits[gstate.clamp(0, mask_bits.shape[0] - 1).long()]     # [B, Vb]
    shifts = torch.arange(8, dtype=torch.uint8, device=logits.device)
    bits = (rows[:, :, None] >> shifts) & 1
    allowed = bits.reshape(b, -1)[:, :v] > 0
    allowed = allowed | (gstate < 0)[:, None]
    allowed = allowed | ~allowed.any(dim=-1, keepdim=True)
    return torch.where(allowed, logits, torch.full_like(logits, GUIDED_FILL))


def guided_advance(gstate: torch.Tensor, sampled: torch.Tensor, ok: torch.Tensor,
                   byte_trans: torch.Tensor, tok_bytes: torch.Tensor,
                   tok_len: torch.Tensor) -> torch.Tensor:
    """The slots' next grammar states (the reference's ``_guided_advance``):
    each sampled token's bytes ``tok_bytes`` [V, L] uint8 (``tok_len`` [V]
    of them) walk ``byte_trans`` [S, 256] int16 in a fixed loop of L
    gathers (states clamped into the table, as JAX's gather clamps);
    zero-length tokens (EOS, specials) leave the state in place. Rows that
    are unguided (``gstate < 0``) or not ``ok`` keep theirs."""
    s = sampled.long()
    tb = tok_bytes[s].long()                                            # [B, L]
    tl = tok_len[s]                                                     # [B]
    last = byte_trans.shape[0] - 1
    cur = gstate.clamp(min=0)
    for i in range(tok_bytes.shape[1]):
        nxt = byte_trans[cur.clamp(0, last).long(), tb[:, i]].to(torch.int32)
        cur = torch.where(tl > i, nxt, cur)
    return torch.where((gstate >= 0) & ok, cur, gstate)
