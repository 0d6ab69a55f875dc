"""The port's speculative acceptance rules (clearml_serving_tpu_torch/llm/
sampling.py ``greedy_tree_walk``, ``speculative_sample_tree``,
``speculative_sample_chain``) against the reference's on the same numpy
inputs. The samplers take the reference's own random draws for one key,
``r_acc, r_gum = split(key)``: ``uniform(r_acc, (B, N-1))`` and
``gumbel(r_gum, (B, N, V))`` (``jax.random.categorical`` is the argmax of
the logits plus that Gumbel draw), so every output must be equal, exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearml_serving_tpu.llm.sampling import (
    SamplingParams as JaxSamplingParams,
    greedy_tree_walk as jax_greedy_tree_walk,
    speculative_sample_chain as jax_speculative_sample_chain,
    speculative_sample_tree as jax_speculative_sample_tree,
)
from clearml_serving_tpu_torch.llm.sampling import (
    SamplingParams,
    greedy_tree_walk,
    speculative_sample_chain,
    speculative_sample_tree,
)

B, N, V = 6, 5, 24


def _trees(seed, b=B, n=N, v=V):
    """Random valid draft trees (parent before child, some dead nodes) with
    draft tokens from a small vocabulary, so drafts often hit."""
    rng = np.random.default_rng(seed)
    parents = np.full((b, n), -1, np.int32)
    for j in range(1, n):
        parents[:, j] = rng.integers(0, j, b)
    n_nodes = rng.integers(1, n + 1, b).astype(np.int32)
    n_nodes[0] = n
    parents[np.arange(n)[None, :] >= n_nodes[:, None]] = -1
    tokens = rng.integers(0, min(v, 4), (b, n)).astype(np.int32)
    return tokens, parents, n_nodes


def _logits(seed, b=B, n=N, v=V):
    """Peaked logits whose top tokens are the low ids the drafts use."""
    rng = np.random.default_rng(100 + seed)
    logits = rng.standard_normal((b, n, v)).astype(np.float32)
    logits[..., :4] += 2.5
    return logits


def _params(temperature, top_k, top_p, b=B):
    t = np.broadcast_to(np.asarray(temperature, np.float32), (b,)).copy()
    k = np.broadcast_to(np.asarray(top_k, np.int32), (b,)).copy()
    p = np.broadcast_to(np.asarray(top_p, np.float32), (b,)).copy()
    return (JaxSamplingParams(jnp.asarray(t), jnp.asarray(k), jnp.asarray(p)),
            SamplingParams(torch.from_numpy(t), torch.from_numpy(k), torch.from_numpy(p)))


def _jax_draws(key, b, n, v):
    r_acc, r_gum = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.uniform(r_acc, (b, n - 1)))),
            torch.from_numpy(np.array(jax.random.gumbel(r_gum, (b, n, v), jnp.float32))))


PARAMS = [
    (1.0, 0, 1.0),
    (0.7, 0, 1.0),
    (1.3, 5, 1.0),
    (0.8, 0, 0.7),
    ([0.5, 1.0, 2.0, 0.7, 1.0, 0.9], [0, 3, 0, 8, 2, 0], [1.0, 0.9, 0.5, 1.0, 1.0, 0.8]),
]
PARAM_IDS = ["temp1", "temp07", "topk", "topp", "mixed_rows"]


@pytest.mark.parametrize("seed", range(4))
def test_greedy_tree_walk_equals_reference(seed):
    tokens, parents, n_nodes = _trees(seed)
    greedy = np.random.default_rng(seed).integers(0, 4, (B, N)).astype(np.int32)
    want = jax_greedy_tree_walk(*(jnp.asarray(a) for a in (greedy, tokens, parents, n_nodes)))
    got = greedy_tree_walk(*(torch.from_numpy(a) for a in (greedy, tokens, parents, n_nodes)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.asarray(want[1]).max() >= 1          # some path was accepted


def test_greedy_tree_walk_on_a_chain_is_the_cumprod_rule():
    rng = np.random.default_rng(5)
    greedy = rng.integers(0, 3, (B, N)).astype(np.int32)
    drafts = rng.integers(0, 3, (B, N - 1)).astype(np.int32)
    tokens = np.concatenate([np.zeros((B, 1), np.int32), drafts], 1)
    parents = np.broadcast_to(np.arange(-1, N - 1, dtype=np.int32), (B, N)).copy()
    path, acc, nodes = greedy_tree_walk(torch.from_numpy(greedy), torch.from_numpy(tokens),
                                        torch.from_numpy(parents), torch.full((B,), N))
    want_acc = np.cumprod(drafts == greedy[:, :-1], axis=1).sum(1)
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    np.testing.assert_array_equal(nodes.numpy(), np.broadcast_to(np.arange(N), (B, N)))


@pytest.mark.parametrize("temperature,top_k,top_p", PARAMS, ids=PARAM_IDS)
@pytest.mark.parametrize("seed", range(3))
def test_speculative_sample_tree_equals_reference(seed, temperature, top_k, top_p):
    tokens, parents, n_nodes = _trees(seed)
    logits = _logits(seed)
    jp, tp = _params(temperature, top_k, top_p)
    key = jax.random.PRNGKey(seed)
    want = jax_speculative_sample_tree(jnp.asarray(logits), *(jnp.asarray(a) for a in
                                                               (tokens, parents, n_nodes)),
                                       jp, key)
    u, noise = _jax_draws(key, B, N, V)
    got = speculative_sample_tree(torch.from_numpy(logits),
                                  *(torch.from_numpy(a) for a in (tokens, parents, n_nodes)),
                                  tp, uniform=u, noise=noise)
    for g, w, name in zip(got, want, ("path", "acc", "nodes")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("temperature,top_k,top_p", PARAMS, ids=PARAM_IDS)
@pytest.mark.parametrize("seed", range(3))
def test_speculative_sample_chain_equals_reference(seed, temperature, top_k, top_p):
    logits = _logits(seed)
    drafts = np.random.default_rng(seed).integers(0, 4, (B, N - 1)).astype(np.int32)
    jp, tp = _params(temperature, top_k, top_p)
    key = jax.random.PRNGKey(10 + seed)
    want = jax_speculative_sample_chain(jnp.asarray(logits), jnp.asarray(drafts), jp, key)
    u, noise = _jax_draws(key, B, N, V)
    got = speculative_sample_chain(torch.from_numpy(logits), torch.from_numpy(drafts), tp,
                                   uniform=u, noise=noise)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("temperature,top_k,top_p", PARAMS, ids=PARAM_IDS)
@pytest.mark.parametrize("seed", range(3))
def test_chain_topology_tree_sampler_is_the_chain_sampler(seed, temperature, top_k, top_p):
    """On a chain topology the tree sampler's emitted tokens equal the
    chain sampler's byte for byte under the same draws."""
    logits = torch.from_numpy(_logits(seed))
    drafts = torch.from_numpy(
        np.random.default_rng(seed).integers(0, 4, (B, N - 1)).astype(np.int32))
    tokens = torch.cat([torch.zeros(B, 1, dtype=torch.int32), drafts], 1)
    parents = torch.arange(-1, N - 1, dtype=torch.int32).expand(B, N)
    _jp, tp = _params(temperature, top_k, top_p)
    u, noise = _jax_draws(jax.random.PRNGKey(20 + seed), B, N, V)
    chain, acc_c = speculative_sample_chain(logits, drafts, tp, uniform=u, noise=noise)
    path, acc_t, nodes = speculative_sample_tree(logits, tokens, parents, torch.full((B,), N),
                                                 tp, uniform=u, noise=noise)
    assert torch.equal(acc_t, acc_c)
    keep = torch.arange(N)[None, :] <= acc_c[:, None]
    assert torch.equal(path[keep], chain[keep])
    assert torch.equal(nodes, torch.arange(N, dtype=torch.int32).expand(B, N))


def test_generator_draws_run_and_stay_in_range():
    tokens, parents, n_nodes = _trees(9)
    logits = torch.from_numpy(_logits(9))
    _jp, tp = _params(1.0, 3, 1.0)
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):
        path, acc, nodes = speculative_sample_tree(
            logits, *(torch.from_numpy(a) for a in (tokens, parents, n_nodes)), tp,
            generator=gen)
        assert path.dtype == acc.dtype == nodes.dtype == torch.int32
        assert ((0 <= acc) & (acc < torch.from_numpy(n_nodes))).all()
        toks, acc_c = speculative_sample_chain(logits, torch.from_numpy(tokens[:, 1:]), tp,
                                               generator=gen)
        # the residual / bonus token lies inside each row's top 3
        top3 = torch.topk(logits.gather(1, acc_c.long()[:, None, None].expand(B, 1, V))[:, 0],
                          3, dim=-1).indices
        bonus = toks.gather(1, acc_c.long()[:, None])
        assert (top3 == bonus).any(dim=-1).all()
