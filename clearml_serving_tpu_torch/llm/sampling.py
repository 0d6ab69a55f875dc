"""Batched token sampling for the decode batch.

Counterpart of ``clearml_serving_tpu/llm/sampling.py`` (``SamplingParams``,
``make_sampling_params``, ``warp_logits``, ``sample_tokens``): per-slot
temperature / top-k / top-p as tensors over the batch, greedy where the
temperature is 0. A categorical draw is ``argmax(scaled + gumbel)``, which
is how ``jax.random.categorical`` samples too, so a caller (a test) that
passes the reference's Gumbel draws as ``noise`` gets the reference's
tokens. Without ``noise`` the draws come from the given ``torch.Generator``.
Penalties, logit bias, per-request seeds and the speculative samplers arrive
with later slices of the port.
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
