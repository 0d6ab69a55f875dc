"""The port's sampling extras (clearml_serving_tpu_torch/llm/sampling.py and
llm/prng.py) against the reference's ``penalize_logits``, ``sample_tokens``
with ``SamplingExtras``, and ``jax.random``, on seeded numpy inputs.

- ``penalize_logits`` (bias, frequency/presence over the histogram,
  repetition over generated and prompt tokens, the min_tokens floor over
  custom stop rows, a row whose only live tokens are stops left alone)
  within 1e-6;
- ``prng``: keys, ``fold_in``, raw bits and uniforms bitwise ``jax.random``'s
  over seeds 0, 1 and 2**31-1 and counters 0-1000, at shapes (V,) and
  [steps, B, V]; Gumbel draws within 1e-6 (relative, and absolute near the
  draw's zero, where an ulp of the inner ``log`` is all the difference);
  the partitionable layout pinned by reading jax's flag;
- ``sample_tokens`` with extras, seeded rows, equal token for token, and a
  seeded row's token independent of the rows beside it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearml_serving_tpu.llm.sampling import (
    SamplingExtras as JaxExtras,
    SamplingParams as JaxParams,
    penalize_logits as jax_penalize,
    sample_tokens as jax_sample,
)
from clearml_serving_tpu_torch.llm import prng
from clearml_serving_tpu_torch.llm.sampling import (
    STOP_SLOTS,
    SamplingExtras,
    SamplingParams,
    logprobs_of,
    penalize_logits,
    sample_tokens,
)

B, V = 6, 512
SEEDS = (0, 1, 2 ** 31 - 1)
TINY = float(np.finfo(np.float32).tiny)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    counts = rng.integers(0, 3, (B, V)).astype(np.int32) * (rng.random((B, V)) < 0.05)
    pmask = rng.random((B, V)) < 0.03
    bias = np.zeros((B, V), np.float32)
    bias[np.arange(B), rng.integers(0, V, B)] = rng.uniform(-5, 5, B)
    stop = np.full((B, STOP_SLOTS), -1, np.int32)
    stop[:, 0] = 257
    stop[1, 1:3] = [5, 9]  # custom stop ids
    rows = dict(
        presence=rng.uniform(0, 1, B).astype(np.float32),
        frequency=rng.uniform(0, 1, B).astype(np.float32),
        repetition=rng.uniform(0.8, 1.5, B).astype(np.float32),
        bias=bias,
        seeds=np.array([3, -1, 7, 2 ** 31 - 1, 0, 11], np.int32),
        counters=np.array([0, 4, 9, 1, 6, 2], np.int32),
        min_new=np.array([5, 8, 0, 3, 7, 1], np.int32),
        stop=stop,
    )
    # row 4: only stop tokens are alive (the floor must not blank it)
    logits[4, :] = -1e30
    logits[4, 257] = 1.0
    return logits, counts.astype(np.int32), pmask, rows


def _both(rows):
    jax_ex = JaxExtras(**{k: jnp.asarray(v) for k, v in rows.items()})
    port_ex = SamplingExtras(**{k: torch.from_numpy(np.ascontiguousarray(v))
                                for k, v in rows.items()})
    return jax_ex, port_ex


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_counts,with_pmask", [(True, True), (True, False), (False, True)],
                         ids=["counts_and_prompt", "counts_only", "prompt_only"])
def test_penalize_logits_equals_reference(seed, with_counts, with_pmask):
    logits, counts, pmask, rows = _inputs(seed)
    jax_ex, port_ex = _both(rows)
    want = np.asarray(jax_penalize(jnp.asarray(logits), jax_ex,
                                   jnp.asarray(counts) if with_counts else None,
                                   jnp.asarray(pmask) if with_pmask else None))
    got = penalize_logits(torch.from_numpy(logits), port_ex,
                          torch.from_numpy(counts) if with_counts else None,
                          torch.from_numpy(pmask) if with_pmask else None).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the floor: rows under min_new lose their stop ids (custom ones too),
    # except the row whose stops are all it has left
    assert got[1, 5] == got[1, 9] == got[1, 257] == np.float32(-1e30)
    assert got[4, 257] > -1e29
    assert got[2, 257] > -1e29  # min_new 0: no floor


def test_threefry_partitionable_layout_is_jax_default():
    # the port reproduces the partitionable bit layout; a change of jax's
    # default would show here first
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_keys_and_bits_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    k1, k2 = prng.prng_key(torch.tensor(seed))
    assert [int(k1), int(k2)] == np.asarray(key).tolist()
    counters = list(range(0, 1001, 37)) + [1000]
    for c in counters:
        jk = jax.random.fold_in(key, c)
        f1, f2 = prng.fold_in(k1, k2, torch.tensor(c))
        assert [int(f1), int(f2)] == np.asarray(jk).tolist()
        for shape in ((V,), (4, B, V)):
            want = np.asarray(jax.random.bits(jk, shape))
            got = prng.random_bits(f1, f2, shape).numpy().astype(np.uint32)
            np.testing.assert_array_equal(got, want)
        want_u = np.asarray(jax.random.uniform(jk, (4, B, V), minval=TINY, maxval=1.0))
        got_u = prng.uniform(prng.random_bits(f1, f2, (4, B, V)), TINY, 1.0).numpy()
        np.testing.assert_array_equal(got_u.view(np.uint32), want_u.view(np.uint32))
        want_g = np.asarray(jax.random.gumbel(jk, (V,)))
        got_g = prng.gumbel(prng.random_bits(f1, f2, (V,))).numpy()
        np.testing.assert_allclose(got_g, want_g, rtol=1e-6, atol=1e-6)


def test_seeded_rows_equal_the_references_row_keys():
    """A batch of seeded rows over counters 0-1000: ``row_bits`` of each
    row's folded key equals ``jax.random.bits`` of the reference's
    ``_row_keys`` key; ``seeded_gumbel`` its Gumbel row."""
    seeds = np.array([0, 1, 2 ** 31 - 1, 5], np.int32)
    for counters in (np.array([0, 1, 500, 1000], np.int32), np.array([999, 7, 0, 3], np.int32)):
        keys = jax.vmap(lambda s, c: jax.random.fold_in(jax.random.PRNGKey(s), c))(
            jnp.asarray(seeds), jnp.asarray(counters))
        want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (V,)))(keys))
        k1, k2 = prng.fold_in(*prng.prng_key(torch.from_numpy(seeds)),
                              torch.from_numpy(counters))
        np.testing.assert_array_equal(prng.row_bits(k1, k2, V).numpy().astype(np.uint32), want)
        want_g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(keys))
        got_g = prng.seeded_gumbel(torch.from_numpy(seeds), torch.from_numpy(counters), V)
        np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-6, atol=1e-6)


def _params(temperature, top_k, top_p):
    t = np.asarray(temperature, np.float32)
    k = np.asarray(top_k, np.int32)
    p = np.asarray(top_p, np.float32)
    return (JaxParams(jnp.asarray(t), jnp.asarray(k), jnp.asarray(p)),
            SamplingParams(torch.from_numpy(t), torch.from_numpy(k), torch.from_numpy(p)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_sample_tokens_with_extras_equals_reference(seed):
    """Every row seeded (an unseeded row draws from a shared stream the
    port does not reproduce): temperature 0.8 with top-p, top-k and greedy
    rows, penalties, bias and the floor."""
    logits, counts, pmask, rows = _inputs(seed)
    rows["seeds"] = np.array([3, 1, 7, 2 ** 31 - 1, 0, 11], np.int32) + seed
    jax_ex, port_ex = _both(rows)
    jp, tp = _params([0.8, 0.8, 1.2, 0.0, 0.8, 0.5], [0, 40, 0, 0, 5, 0],
                     [0.9, 1.0, 0.95, 1.0, 1.0, 0.8])
    want = np.asarray(jax_sample(jnp.asarray(logits), jp, jax.random.PRNGKey(99), jax_ex,
                                 jnp.asarray(counts), jnp.asarray(pmask)))
    got = sample_tokens(torch.from_numpy(logits), tp, extras=port_ex,
                        counts=torch.from_numpy(counts), prompt_mask=torch.from_numpy(pmask),
                        generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got.numpy(), want)
    # a seeded row's draw depends on its own seed and counter only: the
    # row alone, beside other rows, gives the same token
    for row in range(B):
        sl = slice(row, row + 1)
        one = SamplingExtras(*[None if t is None else t[sl] for t in port_ex])
        alone = sample_tokens(torch.from_numpy(logits[sl]),
                              SamplingParams(*[t[sl] for t in tp]), extras=one,
                              counts=torch.from_numpy(counts[sl]),
                              prompt_mask=torch.from_numpy(pmask[sl]))
        assert int(alone[0]) == int(got[row])


@pytest.mark.parametrize("seed", [0, 1])
def test_logprobs_of_equals_the_references_lp(seed):
    """The chosen logprob and the top-k over log_softmax (the reference's
    ``_lp_of``) within 1e-6, top ids equal."""
    logits, counts, pmask, rows = _inputs(seed)
    jax_ex, port_ex = _both(rows)
    pen_j = jax_penalize(jnp.asarray(logits), jax_ex, jnp.asarray(counts), jnp.asarray(pmask))
    chosen = np.array([1, 2, 3, 4, 257, 6], np.int32)
    lp = jax.nn.log_softmax(pen_j)
    want_top_lp, want_top_id = jax.lax.top_k(lp, 7)
    pen_t = penalize_logits(torch.from_numpy(logits), port_ex, torch.from_numpy(counts),
                            torch.from_numpy(pmask))
    got_chosen, got_id, got_lp = logprobs_of(pen_t, torch.from_numpy(chosen), 7)
    np.testing.assert_allclose(got_chosen.numpy(), np.asarray(lp)[np.arange(B), chosen],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got_id.numpy(), np.asarray(want_top_id))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_top_lp), rtol=1e-6, atol=1e-6)
