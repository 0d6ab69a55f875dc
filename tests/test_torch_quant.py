"""The port's weight quantizers (clearml_serving_tpu_torch/ops/quant.py)
against the reference's (clearml_serving_tpu/ops/quant.py) on the same f32
inputs, made from a numpy seed: codes and scales bitwise equal, for plain
[K, N] and scan-stacked [L, K, N] weights, group sizes that divide K and K
that no group divides (the one-group fallback); dequantization bitwise
equal; whole llama trees quantize to the same leaves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearml_serving_tpu import models
from clearml_serving_tpu.ops import quant as ref
from clearml_serving_tpu_torch.ops import quant

SHAPES = [
    # (shape, group): two groups, a stacked tree, groups of 64, K % 128 != 0
    # (one per-channel group), a single group, N not a multiple of 16
    ((256, 384), 128),
    ((3, 256, 128), 128),
    ((512, 96), 64),
    ((96, 40), 128),
    ((128, 64), 128),
    ((2, 64, 130), 128),
]


def _weight(shape, seed):
    """Normal weights at the dense init's scale, with an all-zero column
    (scale 1.0, level 0) and values on exact rounding ties."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=shape) * shape[-2] ** -0.5).astype(np.float32)
    w[..., 1] = 0.0
    w.reshape(-1)[:4] = [0.5, -0.5, 1.5, 2.5]
    return w


def _same(t, a):
    a = np.asarray(a)
    assert t.dtype == getattr(torch, a.dtype.name) and tuple(t.shape) == a.shape
    np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("shape,group", SHAPES)
def test_int4_codes_and_scales_are_bitwise_the_reference(shape, group):
    w = _weight(shape, seed=sum(shape))
    q_ref, s_ref = ref.quantize_int4(jnp.asarray(w), group=group)
    q, s = quant.quantize_int4(torch.from_numpy(w), group=group)
    _same(q, q_ref)
    _same(s, s_ref)
    _same(quant.dequantize_int4(q, s, torch.float32),
          ref.dequantize_int4(q_ref, s_ref, jnp.float32))


@pytest.mark.parametrize("shape,group", SHAPES)
def test_int8_codes_and_scales_are_bitwise_the_reference(shape, group):
    w = _weight(shape, seed=sum(shape) + 1)
    q_ref, s_ref = ref.quantize_int8(jnp.asarray(w), axis=-2)
    q, s = quant.quantize_int8(torch.from_numpy(w), axis=-2)
    _same(q, q_ref)
    _same(s, s_ref)
    _same(quant.dequantize(q, s, torch.float32), ref.dequantize(q_ref, s_ref, jnp.float32))


def test_int8_default_axis_and_matmul():
    w = _weight((64, 48), seed=5)
    x = np.random.default_rng(6).normal(size=(3, 48)).astype(np.float32)
    q_ref, s_ref = ref.quantize_int8(jnp.asarray(w))
    q, s = quant.quantize_int8(torch.from_numpy(w))
    _same(q, q_ref)
    _same(s, s_ref)
    wq = _weight((48, 32), seed=7)
    q_ref, s_ref = ref.quantize_int8(jnp.asarray(wq), axis=0)
    q, s = quant.quantize_int8(torch.from_numpy(wq), axis=0)
    out = quant.int8_matmul(torch.from_numpy(x), q, s)
    want = ref.int8_matmul(jnp.asarray(x), q_ref, s_ref)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_nibble_layout():
    """Row 2i in the low nibble of byte row i, row 2i+1 in the high one,
    each level stored as level + 8."""
    w = np.array([[-8.0, 7.0], [7.0, 0.0], [0.0, -8.0], [1.0, 2.0]], np.float32)
    q, s = quant.quantize_int4(torch.from_numpy(w), group=4)
    np.testing.assert_array_equal(s.numpy(), np.full((1, 2), np.float32(8) / np.float32(7)))
    levels = np.clip(np.round(w / s.numpy()), -8, 7).astype(np.int32) + 8
    np.testing.assert_array_equal(q.numpy(), levels[0::2] | (levels[1::2] << 4))


@pytest.mark.parametrize("k,group,want", [(256, 128, 2), (96, 128, 1), (512, 64, 8),
                                          (128, 0, 1)])
def test_int4_groups_rule(k, group, want):
    assert quant.int4_groups(k, group) == ref.int4_groups(k, group) == want


def test_errors_match_the_reference():
    odd = np.zeros((5, 4), np.float32)
    with pytest.raises(ValueError) as want:
        ref.quantize_int4(jnp.asarray(odd))
    with pytest.raises(ValueError) as got:
        quant.quantize_int4(torch.from_numpy(odd))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        ref.quantize_llama_params({}, bits=3)
    with pytest.raises(ValueError) as got:
        quant.quantize_llama_params({}, bits=3)
    assert str(got.value) == str(want.value)


WIDE = {"preset": "llama-tiny", "dtype": "float32", "dim": 256, "n_heads": 4,
        "n_kv_heads": 2, "ffn_dim": 512}


@pytest.fixture(scope="module")
def wide_np():
    bundle = models.build_model("llama", WIDE)
    return jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0)))


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _assert_trees_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for key in want:
            _assert_trees_equal(got[key], want[key])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_trees_equal(g, w)
    else:
        _same(got, want)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("layout", ["per_layer", "stacked"])
def test_llama_trees_quantize_to_the_reference_leaves(wide_np, bits, layout):
    tree = dict(wide_np)
    if layout == "stacked":
        tree["layers"] = {k: np.stack([layer[k] for layer in wide_np["layers"]])
                          for k in wide_np["layers"][0]}
    want = jax.tree.map(np.asarray, ref.quantize_llama_params(
        jax.tree.map(jnp.asarray, tree), bits=bits))
    got = quant.quantize_llama_params(_torch_tree(tree), bits=bits)
    _assert_trees_equal(got, want)
    fmt = "int4" if bits == 4 else "int8"
    assert quant.detect_weight_quant(got) == ref.detect_weight_quant(want) == fmt
    # norms and the embedding keep their dtype; the source tree is untouched
    assert got["embed"].dtype == torch.float32
    assert not quant.detect_weight_quant(_torch_tree(tree))


@pytest.mark.parametrize("tree,want", [
    ({}, ""), ([], ""), ({"a": [{"b": 1}]}, ""),
    ({"a": [{"w": {"_q4": 0, "_scale4": 0}}]}, "int4"),
    ([{"_q8": 0, "_scale": 0}], "int8"),
    ((None, {"x": {"_q8": 0}}), "int8"),
], ids=["empty_dict", "empty_list", "plain", "nested_int4", "list_int8", "tuple"])
def test_detect_weight_quant_matches_reference(tree, want):
    assert quant.detect_weight_quant(tree) == ref.detect_weight_quant(tree) == want
