"""The port's sampler (clearml_serving_tpu_torch/llm/sampling.py) against the
reference's ``sample_tokens``: identical greedy tokens, and identical sampled
tokens once the reference's own Gumbel draws are passed in as the noise
(``jax.random.categorical(key, l) == argmax(l + gumbel(key, l.shape))``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearml_serving_tpu.llm.sampling import (
    SamplingParams as JaxSamplingParams,
    sample_tokens as jax_sample_tokens,
    warp_logits as jax_warp_logits,
)
from clearml_serving_tpu_torch.llm.sampling import (
    SamplingParams,
    make_sampling_params,
    sample_tokens,
    warp_logits,
)

B, V = 6, 512


def _logits(seed):
    return (np.random.default_rng(seed).standard_normal((B, V)) * 3).astype(np.float32)


def _params(temperature, top_k, top_p):
    t = np.broadcast_to(np.asarray(temperature, np.float32), (B,)).copy()
    k = np.broadcast_to(np.asarray(top_k, np.int32), (B,)).copy()
    p = np.broadcast_to(np.asarray(top_p, np.float32), (B,)).copy()
    return (
        JaxSamplingParams(jnp.asarray(t), jnp.asarray(k), jnp.asarray(p)),
        SamplingParams(torch.from_numpy(t), torch.from_numpy(k), torch.from_numpy(p)),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_equals_reference(seed):
    logits = _logits(seed)
    jp, tp = _params(0.0, 0, 1.0)
    want = np.asarray(jax_sample_tokens(jnp.asarray(logits), jp, jax.random.PRNGKey(seed)))
    got = sample_tokens(torch.from_numpy(logits), tp)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        sample_tokens(torch.from_numpy(logits), tp, all_greedy=True).numpy(), want)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0),
    (0.7, 40, 1.0),
    (1.3, 0, 0.9),
    (0.8, 20, 0.5),
    ([0.0, 1.0, 0.5, 2.0, 0.0, 0.9], [0, 5, 0, 50, 3, 1], [1.0, 0.8, 0.3, 1.0, 0.5, 1.0]),
], ids=["temp", "topk", "topp", "topk_topp", "mixed_rows"])
def test_sampled_equals_reference_given_its_gumbel_draws(temperature, top_k, top_p):
    logits = _logits(7)
    jp, tp = _params(temperature, top_k, top_p)
    for step in range(4):
        key = jax.random.PRNGKey(100 + step)
        want = np.asarray(jax_sample_tokens(jnp.asarray(logits), jp, key))
        noise = np.array(jax.random.gumbel(key, (B, V), jnp.float32))
        got = sample_tokens(torch.from_numpy(logits), tp, noise=torch.from_numpy(noise))
        np.testing.assert_array_equal(got.numpy(), want)


def test_warp_logits_matches_reference():
    logits = _logits(3)
    jp, tp = _params([1.0, 0.5, 2.0, 1.0, 0.7, 1.0], [0, 10, 0, 3, 100, 1],
                     [1.0, 1.0, 0.7, 0.9, 0.2, 1.0])
    want = np.asarray(jax_warp_logits(jnp.asarray(logits), jp.temperature, jp.top_k,
                                      jp.top_p))
    got = warp_logits(torch.from_numpy(logits), tp.temperature, tp.top_k, tp.top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    live = ~np.isinf(want)
    np.testing.assert_allclose(got[live], want[live], rtol=1e-6, atol=1e-6)


def test_generator_draws_stay_inside_the_nucleus():
    logits = torch.from_numpy(_logits(4))
    params = make_sampling_params(B, temperature=1.0, top_k=5, device="cpu")
    allowed = torch.topk(logits, 5, dim=-1).indices
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = sample_tokens(logits, params, generator=gen).long()
        assert (allowed == tok[:, None]).any(dim=-1).all()
