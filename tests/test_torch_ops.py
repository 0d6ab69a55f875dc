"""The port's paged attention (clearml_serving_tpu_torch/ops/paged_attention.py)
held against the reference's XLA version and its Pallas kernel in interpret
mode, on the same numpy inputs, in float32 with atol = rtol = 1e-5 (the
three differ only in summation order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clearml_serving_tpu.ops.paged_attention import (
    paged_attention as jax_paged_attention,
    paged_attention_xla,
)
from clearml_serving_tpu_torch.ops.paged_attention import (
    check_kernel_gates,
    paged_attention,
    paged_attention_ref,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _bf16_values(x):
    return torch.from_numpy(x).bfloat16().float().numpy()


def _quantize(pool):
    """Per-(token, head) symmetric int8, as models/llama._kv_store."""
    absmax = np.abs(pool).max(-1)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(pool / scale[..., None]), -127, 127).astype(np.int8)
    return q, scale


def _setup(seed, *, g=4, quant=False, b=4, hkv=2, d=32, page_size=8, pp=5):
    """bf16-valued f32 operands; lengths: a full table, a partial last page,
    1 and 0; page-table entries past each length hold random page ids."""
    rng = np.random.default_rng(seed)
    n = b * pp + 1
    q = _bf16_values(rng.standard_normal((b, hkv, g, d)).astype(np.float32))
    k = _bf16_values(rng.standard_normal((hkv, n, page_size, d)).astype(np.float32))
    v = _bf16_values(rng.standard_normal((hkv, n, page_size, d)).astype(np.float32))
    lengths = np.array([pp * page_size, 13, 1, 0], np.int32)[:b]
    table = rng.permutation(np.arange(1, n, dtype=np.int32)).reshape(b, pp)
    for i, length in enumerate(lengths):
        live = -(-int(length) // page_size)
        table[i, live:] = rng.integers(0, n, pp - live)
    ops = dict(q=q, k=k, v=v, table=table, lengths=lengths, ks=None, vs=None)
    if quant:
        ops["k"], ops["ks"] = _quantize(k)
        ops["v"], ops["vs"] = _quantize(v)
    return ops


def _torch_args(ops):
    t = {k: (None if v is None else torch.from_numpy(np.ascontiguousarray(v)))
         for k, v in ops.items()}
    return (t["q"], t["k"], t["v"], t["table"], t["lengths"]), dict(
        k_scale=t["ks"], v_scale=t["vs"])


def _jax_args(ops):
    j = {k: (None if v is None else jnp.asarray(v)) for k, v in ops.items()}
    return (j["q"], j["k"], j["v"], j["table"], j["lengths"]), dict(
        k_scale=j["ks"], v_scale=j["vs"])


@pytest.mark.parametrize("quant", [False, True], ids=["bf16_values", "int8"])
@pytest.mark.parametrize("g", [1, 4])
def test_ref_matches_xla_reference(quant, g):
    ops = _setup(10 + g, g=g, quant=quant)
    args, kw = _torch_args(ops)
    jargs, jkw = _jax_args(ops)
    out = paged_attention_ref(*args, **kw).numpy()
    ref = np.asarray(paged_attention_xla(*jargs, jkw["k_scale"], jkw["v_scale"]))
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16_values", "int8"])
@pytest.mark.parametrize("g", [1, 4])
def test_ref_matches_pallas_interpret(quant, g):
    ops = _setup(20 + g, g=g, quant=quant)
    args, kw = _torch_args(ops)
    jargs, jkw = _jax_args(ops)
    out = paged_attention_ref(*args, **kw).numpy()
    ref = np.asarray(jax_paged_attention(*jargs, **jkw, pages_per_block=2,
                                         interpret=True))
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16_values", "int8"])
def test_zero_length_row_is_zeros_and_garbage_past_length_is_ignored(quant):
    ops = _setup(3, quant=quant)
    args, kw = _torch_args(ops)
    out = paged_attention_ref(*args, **kw)
    assert torch.isfinite(out).all()
    assert torch.equal(out[3], torch.zeros_like(out[3]))
    # other garbage past the lengths: same output
    table = args[3].clone()
    table[1, 2:] = 0
    table[2, 1:] = table[0, :4]
    out2 = paged_attention_ref(args[0], args[1], args[2], table, args[4], **kw)
    assert torch.equal(out, out2)


def test_wrapper_on_cpu_is_the_plain_version():
    ops = _setup(4, quant=True)
    args, kw = _torch_args(ops)
    before = paged_attention.launches
    out = paged_attention(*args, **kw)
    assert torch.equal(out, paged_attention_ref(*args, **kw))
    assert paged_attention.launches == before  # no kernel launch on the CPU


def test_int8_pools_need_scales():
    ops = _setup(5, quant=True)
    args, _ = _torch_args(ops)
    with pytest.raises(ValueError, match="k_scale"):
        paged_attention(*args)


def _main_path_operands(**over):
    """CPU tensors shaped like the main path's call (gates read no values)."""
    b, hkv, g, d, n, p, pp = 8, 8, 4, 128, 33, 16, 4
    ops = dict(
        q=torch.zeros(b, hkv, g, d, dtype=torch.bfloat16),
        k_pool=torch.zeros(hkv, n, p, d, dtype=torch.bfloat16),
        v_pool=torch.zeros(hkv, n, p, d, dtype=torch.bfloat16),
        page_table=torch.zeros(b, pp, dtype=torch.int32),
        lengths=torch.zeros(b, dtype=torch.int32),
        k_scale=None, v_scale=None,
    )
    ops.update(over)
    return ops


_I8 = dict(k_pool=torch.zeros(8, 33, 16, 128, dtype=torch.int8),
           v_pool=torch.zeros(8, 33, 16, 128, dtype=torch.int8))


@pytest.mark.parametrize("over,gate", [
    (dict(q=torch.zeros(8, 8, 4, 128)), "q.dtype"),
    (dict(q=torch.zeros(8, 8, 4, 16, dtype=torch.bfloat16),
          k_pool=torch.zeros(8, 33, 16, 16, dtype=torch.bfloat16),
          v_pool=torch.zeros(8, 33, 16, 16, dtype=torch.bfloat16)), "head_dim"),
    (dict(q=torch.zeros(8, 8, 16, 128, dtype=torch.bfloat16)), "group"),
    (dict(k_pool=torch.zeros(8, 33, 8, 128, dtype=torch.bfloat16),
          v_pool=torch.zeros(8, 33, 8, 128, dtype=torch.bfloat16)), "page_size"),
    (dict(v_pool=torch.zeros(8, 33, 16, 128, dtype=torch.float32)), "pool.dtype"),
    (_I8, "scales"),
    (dict(_I8, k_scale=torch.zeros(8, 33, 16, dtype=torch.float64),
          v_scale=torch.zeros(8, 33, 16)), "scales"),
    (dict(page_table=torch.zeros(8, 4, dtype=torch.int64)), "page_table"),
    (dict(lengths=torch.zeros(8, dtype=torch.int64)), "lengths"),
    (dict(q=torch.zeros(8, 4, 8, 128, dtype=torch.bfloat16).transpose(1, 2)),
     "contiguous"),
], ids=["q_f32", "d16", "g16", "p8", "mixed_pool_dtypes", "int8_no_scales",
        "f64_scales", "table_i64", "lengths_i64", "strided_q"])
def test_kernel_gates_raise_naming_the_gate(over, gate):
    with pytest.raises(ValueError, match="gate {}".format(gate.replace(".", r"\."))):
        check_kernel_gates(**_main_path_operands(**over))


@pytest.mark.parametrize("over", [{}, dict(_I8, k_scale=torch.zeros(8, 33, 16),
                                           v_scale=torch.zeros(8, 33, 16))],
                         ids=["bf16", "int8"])
def test_kernel_gates_accept_the_main_path(over):
    check_kernel_gates(**_main_path_operands(**over))

