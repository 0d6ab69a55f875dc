"""The port's draft proposers (clearml_serving_tpu_torch/llm/spec_proposer.py)
and ``tree_ancestors`` (ops/paged_attention.py) against the reference's on
the same seeded numpy inputs: drafts, topologies, hit counts and errors
must be equal, exactly."""

import numpy as np
import pytest

from clearml_serving_tpu.llm import spec_proposer as ref
from clearml_serving_tpu.ops.paged_attention import tree_ancestors as ref_tree_ancestors
from clearml_serving_tpu_torch.llm import spec_proposer as port
from clearml_serving_tpu_torch.ops.paged_attention import tree_ancestors


def _buffers(seed, vocab, slots=6, buf_len=48, k=4):
    """A token buffer over a small vocab (many n-gram matches, some
    ambiguous) and per-slot history lengths, short ones included (no
    possible match)."""
    rng = np.random.default_rng(seed)
    tokbuf = rng.integers(0, vocab, (slots, buf_len)).astype(np.int32)
    hists = list(rng.integers(1, buf_len - k, slots))
    hists[0] = 1                     # too short for any match: fallback
    return tokbuf, hists


def _assert_forest_equal(got, want):
    for name in ("tokens", "parents", "depths", "n_nodes", "hits"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert got.budget == want.budget


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("ngram,k", [(1, 3), (2, 4), (3, 6)])
def test_chain_drafts_equal_reference(seed, ngram, k):
    tokbuf, hists = _buffers(seed, vocab=5, k=k)
    slots = list(range(tokbuf.shape[0]))
    got_p, want_p = port.NgramChainProposer(ngram), ref.NgramChainProposer(ngram)
    for _ in range(2):                       # stats accumulate across calls
        got = got_p.propose(slots, hists, tokbuf, k)
        want = want_p.propose(slots, hists, tokbuf, k)
        _assert_forest_equal(got, want)
    assert got_p.stats() == want_p.stats()
    assert not got.hits[0]                   # the short history fell back


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("branch", [1, 2, 3])
@pytest.mark.parametrize("vocab", [3, 6, 50])
def test_forest_drafts_equal_reference(seed, branch, vocab):
    tokbuf, hists = _buffers(seed, vocab=vocab)
    slots = [5, 1, 3, 0]                     # any slot order
    sub_hists = [hists[s] for s in slots]
    got_p = port.NgramForestProposer(ngram=2, branch=branch)
    want_p = ref.NgramForestProposer(ngram=2, branch=branch)
    got = got_p.propose(slots, sub_hists, tokbuf, 4)
    want = want_p.propose(slots, sub_hists, tokbuf, 4)
    _assert_forest_equal(got, want)
    assert got_p.stats() == want_p.stats()
    port.validate_forest(got)


def test_forest_branches_on_ambiguous_history():
    """Two earlier occurrences of the tail with different continuations:
    the forest gives the root a second child, equal to the reference's."""
    tokbuf = np.zeros((1, 32), np.int32)
    hist_tokens = [5, 9, 2, 17, 5, 9, 7, 17, 5, 9]
    tokbuf[0, :len(hist_tokens)] = hist_tokens
    got_p, want_p = port.NgramForestProposer(2, 2), ref.NgramForestProposer(2, 2)
    got = got_p.propose([0], [len(hist_tokens)], tokbuf, 4)
    want = want_p.propose([0], [len(hist_tokens)], tokbuf, 4)
    _assert_forest_equal(got, want)
    assert got_p.branched == want_p.branched == 1
    assert list(got.parents[0]) == [-1, 0, 1, 2, 0]


@pytest.mark.parametrize("k", [1, 4, 7])
def test_chain_parents_equal_reference(k):
    np.testing.assert_array_equal(port.chain_parents(k), ref.chain_parents(k))
    assert port.chain_parents(k).dtype == np.int32


def _forest(mod, tokens, parents, depths, n_nodes):
    arr = [np.asarray(a, np.int32) for a in (tokens, parents, depths, n_nodes)]
    return mod.DraftForest(*arr, hits=np.zeros(len(n_nodes), bool))


@pytest.mark.parametrize("case", [
    dict(parents=[[-1, 0, 0, 0]], depths=[[0, 1, 1, 1]], n_nodes=[5]),
    dict(parents=[[0, 0, 0, 0]], depths=[[0, 1, 1, 1]], n_nodes=[4]),
    dict(parents=[[-1, 0, 3, 1]], depths=[[0, 1, 2, 2]], n_nodes=[4]),
    dict(parents=[[-1, 0, 1, 1]], depths=[[0, 1, 2, 3]], n_nodes=[4]),
    dict(parents=[[-1, 0, 1]], depths=[[0, 1, 2]], n_nodes=[3]),
], ids=["n_nodes_past_budget", "root_parent", "parent_after_child", "depth_lie",
        "shape"])
def test_validate_forest_errors_equal_reference(case):
    tokens = [[0, 1, 2, 3]]
    errs = []
    for mod in (port, ref):
        with pytest.raises(ValueError) as err:
            mod.validate_forest(_forest(mod, tokens, case["parents"], case["depths"],
                                        case["n_nodes"]))
        errs.append(str(err.value))
    assert errs[0] == errs[1]


def test_registry_equals_reference():
    assert sorted(port.PROPOSERS) == sorted(ref.PROPOSERS)
    for name in port.PROPOSERS:
        got, want = port.make_proposer(name, ngram=3), ref.make_proposer(name, ngram=3)
        assert (got.name, got.ngram, got.stats()) == (want.name, want.ngram, want.stats())
    with pytest.raises(ValueError) as got:
        port.make_proposer("medusa")
    with pytest.raises(ValueError) as want:
        ref.make_proposer("medusa")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="branch >= 1"):
        port.make_proposer("ngram-forest", branch=0)


@pytest.mark.parametrize("parents,n_nodes,width", [
    ([-1, 0, 1, 2, 3], None, None),
    ([-1, 0, 1, 0, 0], None, 5),
    ([-1, 0, 0, 1, 2, 4, 4], 5, 6),
    ([-1, 0, 1], 1, 1),
    ([-1] + list(range(63)), None, 64),
])
def test_tree_ancestors_equal_reference(parents, n_nodes, width):
    got = tree_ancestors(parents, n_nodes, width=width)
    want = ref_tree_ancestors(parents, n_nodes, width=width)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_tree_ancestors_depth_past_width_raises_like_reference():
    with pytest.raises(ValueError) as got:
        tree_ancestors([-1, 0, 1, 2], width=3)
    with pytest.raises(ValueError) as want:
        ref_tree_ancestors([-1, 0, 1, 2], width=3)
    assert str(got.value) == str(want.value)
