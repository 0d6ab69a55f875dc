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
Penalties, logit bias and per-request seeds arrive with a later slice of
the port.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SamplingParams(NamedTuple):
    temperature: torch.Tensor  # [B] float32; 0 => greedy
    top_k: torch.Tensor        # [B] int32; 0 => disabled
    top_p: torch.Tensor        # [B] float32; 1.0 => disabled


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


def gumbel_noise(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def sample_tokens(logits: torch.Tensor, params: SamplingParams, *,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None,
                  all_greedy: bool = False) -> torch.Tensor:
    """logits [B, V] float32 -> token ids [B] int32. Rows with temperature
    <= 0 take the argmax; others sample from the temperature-scaled,
    top-k/top-p-filtered distribution. ``all_greedy`` (known host-side)
    skips the sampling work when no row samples."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if all_greedy:
        return greedy
    scaled = warp_logits(logits, params.temperature, params.top_k, params.top_p)
    if noise is None:
        noise = gumbel_noise(scaled.shape, generator, scaled.device)
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
        nodes = torch.where((col == acc[:, None] + 1) & ok[:, None],
                            torch.tensor(j, dtype=torch.int32, device=dev), nodes)
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
        nodes = torch.where((col == acc[:, None] + 1) & ok[:, None],
                            torch.tensor(j, dtype=torch.int32, device=dev), nodes)
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
