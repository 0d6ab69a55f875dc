"""The port's ragged paged attention (clearml_serving_tpu_torch/ops/
paged_attention.py) held against the reference's XLA version and its Pallas
kernel in interpret mode, on the same numpy inputs, in float32 with
atol = rtol = 1e-5 (they differ only in summation order), plus the layout
helper, the bitwise decode-row identity with the decode plain version, and
the CUDA gates (checked on CPU tensors: the gates read no values)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearml_serving_tpu.ops.paged_attention import (
    ragged_layout as jax_ragged_layout,
    ragged_paged_attention as jax_ragged_paged_attention,
    ragged_paged_attention_xla,
    tree_ancestors,
)
from clearml_serving_tpu_torch.ops.paged_attention import (
    RAGGED_QB,
    check_ragged_gates,
    paged_attention_ref,
    ragged_layout,
    ragged_paged_attention,
    ragged_paged_attention_ref,
)
from torch_fp_env import fp_environment

TOL = dict(rtol=1e-5, atol=1e-5)


def _bf16_values(x):
    return torch.from_numpy(x).bfloat16().float().numpy()


def _quantize(pool):
    """Per-(token, head) symmetric int8, as models/llama._kv_store."""
    absmax = np.abs(pool).max(-1)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(pool / scale[..., None]), -127, 127).astype(np.int8)
    return q, scale


# a mixed batch: decode rows, a prefill row at history 0, one mid-history
# whose chunk crosses page boundaries, an idle row, another decode row
ROW_LENS = (1, 11, 9, 0, 1)
HISTORY = (13, 0, 21, 0, 0)


def _setup(seed, *, row_lens=ROW_LENS, history=HISTORY, q_block=RAGGED_QB, quant=False,
           g=2, hkv=2, d=32, page_size=8, pp=5, total=None):
    """bf16-valued f32 operands and the numpy row map; page-table entries
    past each row's kv_len hold random page ids."""
    rng = np.random.default_rng(seed)
    r = len(row_lens)
    n = r * pp + 1
    row_lens = np.asarray(row_lens, np.int32)
    kv_lens = row_lens + np.asarray(history, np.int32)
    assert kv_lens.max() <= pp * page_size
    starts, block_rows, block_q0, t_pad = ragged_layout(row_lens, q_block, total=total)
    q = _bf16_values(rng.standard_normal((t_pad, hkv, g, d)).astype(np.float32))
    k = _bf16_values(rng.standard_normal((hkv, n, page_size, d)).astype(np.float32))
    v = _bf16_values(rng.standard_normal((hkv, n, page_size, d)).astype(np.float32))
    table = rng.permutation(np.arange(1, n, dtype=np.int32)).reshape(r, pp)
    for i, length in enumerate(kv_lens):
        live = -(-int(length) // page_size)
        table[i, live:] = rng.integers(0, n, pp - live)
    ops = dict(q=q, k=k, v=v, table=table, kv_lens=kv_lens, starts=starts,
               row_lens=row_lens, ks=None, vs=None, block_rows=block_rows,
               block_q0=block_q0)
    if quant:
        ops["k"], ops["ks"] = _quantize(k)
        ops["v"], ops["vs"] = _quantize(v)
    return ops


_ARGS = ("q", "k", "v", "table", "kv_lens", "starts", "row_lens")


def _torch(ops, tree=None):
    t = {k: (None if v is None else torch.from_numpy(np.ascontiguousarray(v)))
         for k, v in ops.items()}
    kw = dict(k_scale=t["ks"], v_scale=t["vs"])
    if tree is not None:
        kw["tree_anc"] = torch.from_numpy(tree)
    return tuple(t[k] for k in _ARGS), kw


def _jax(ops, tree=None):
    j = {k: (None if v is None else jnp.asarray(v)) for k, v in ops.items()}
    return tuple(j[k] for k in _ARGS), dict(
        k_scale=j["ks"], v_scale=j["vs"],
        tree_anc=None if tree is None else jnp.asarray(tree))


def _tree_anc(ops):
    """Row 2 (9 tokens) as a draft-tree verify row; every other token
    keeps the plain-causal sentinel."""
    t = ops["q"].shape[0]
    width = int(ops["row_lens"][2])
    anc = np.full((t, width), -1, np.int32)
    anc[:, 0] = -2
    parents = np.array([-1, 0, 0, 1, 2, 2, 3, 4, 6], np.int32)
    s = int(ops["starts"][2])
    anc[s:s + width] = tree_ancestors(parents, width, width=width)
    return anc


@pytest.mark.parametrize("row_lens,q_block,total", [
    ((1, 5, 0, 12), 8, None),
    ((1, 5, 0, 12), 8, 48),
    ((3, 1, 1, 17, 0, 2), 8, 64),
    ((3, 1, 1, 17, 0, 2), 1, 24),
    ((0, 0), 8, None),
], ids=["aligned", "padded_total", "mixed_padded", "dense", "all_idle"])
def test_ragged_layout_matches_reference(row_lens, q_block, total):
    got = ragged_layout(row_lens, q_block, total=total)
    want = jax_ragged_layout(row_lens, q_block, total=total)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[3] == want[3]


def test_ragged_layout_refuses_a_short_total():
    with pytest.raises(ValueError, match="total"):
        ragged_layout([64], 8, total=32)


HEAD_DIMS = pytest.mark.parametrize("d", [32, 256], ids=["d32", "d256"])


@HEAD_DIMS
@pytest.mark.parametrize("tree", [False, True], ids=["causal", "tree_anc"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16_values", "int8"])
def test_ref_matches_xla_reference(quant, tree, d):
    ops = _setup(10 + 2 * quant + tree, quant=quant, d=d)
    anc = _tree_anc(ops) if tree else None
    args, kw = _torch(ops, anc)
    jargs, jkw = _jax(ops, anc)
    out = ragged_paged_attention_ref(*args, **kw).numpy()
    ref = np.asarray(ragged_paged_attention_xla(*jargs, jkw["k_scale"], jkw["v_scale"],
                                                jkw["tree_anc"]))
    np.testing.assert_allclose(out, ref, **TOL, err_msg=fp_environment())
    if tree:
        # the tree mask changes the verify row and nothing else
        plain = ragged_paged_attention_ref(*args, k_scale=kw["k_scale"],
                                           v_scale=kw["v_scale"]).numpy()
        s, n = int(ops["starts"][2]), int(ops["row_lens"][2])
        assert not np.allclose(out[s + 2:s + n], plain[s + 2:s + n])
        np.testing.assert_array_equal(np.delete(out, np.s_[s:s + n], 0),
                                      np.delete(plain, np.s_[s:s + n], 0))


@HEAD_DIMS
@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16_values", "int8"])
def test_ref_matches_pallas_interpret(quant, page_size, d):
    ops = _setup(20 + quant, quant=quant, page_size=page_size, pp=5 if page_size == 8 else 3,
                 d=d)
    args, kw = _torch(ops)
    jargs, jkw = _jax(ops)
    out = ragged_paged_attention_ref(*args, **kw).numpy()
    ref = np.asarray(jax_ragged_paged_attention(
        *jargs, block_rows=jnp.asarray(ops["block_rows"]),
        block_q0=jnp.asarray(ops["block_q0"]), k_scale=jkw["k_scale"],
        v_scale=jkw["v_scale"], pages_per_block=2, q_block=8, interpret=True))
    np.testing.assert_allclose(out, ref, **TOL)


@HEAD_DIMS
@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16_values", "int8"])
def test_ref_with_tree_anc_matches_pallas_interpret(quant, page_size, d):
    """The plain version's draft-tree mask against the TPU kernel's own
    ``tree`` branch (interpret mode) on the same operands."""
    ops = _setup(24 + quant, quant=quant, page_size=page_size,
                 pp=5 if page_size == 8 else 3, d=d)
    anc = _tree_anc(ops)
    args, kw = _torch(ops, anc)
    jargs, jkw = _jax(ops, anc)
    out = ragged_paged_attention_ref(*args, **kw).numpy()
    ref = np.asarray(jax_ragged_paged_attention(
        *jargs, block_rows=jnp.asarray(ops["block_rows"]),
        block_q0=jnp.asarray(ops["block_q0"]), k_scale=jkw["k_scale"],
        v_scale=jkw["v_scale"], tree_anc=jkw["tree_anc"], pages_per_block=2, q_block=8,
        interpret=True))
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16_values", "int8"])
def test_decode_rows_bitwise_equal_decode_plain_version(quant):
    """An all-decode batch through the ragged plain version equals the
    decode plain version bit for bit (the engine's ragged and two-dispatch
    arms agree because of it)."""
    ops = _setup(30 + quant, row_lens=(1, 1, 1, 1), history=(13, 0, 39, 22), quant=quant)
    args, kw = _torch(ops)
    out = ragged_paged_attention_ref(*args, **kw)
    q, k, v, table, kv_lens, starts, _ = args
    want = paged_attention_ref(q[starts.long()], k, v, table, kv_lens, **kw)
    assert torch.equal(out[starts.long()], want)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16_values", "int8"])
def test_dense_and_aligned_layouts_agree(quant):
    """The same rows packed densely (q block 1, the CPU engine's layout) and
    aligned to RAGGED_QB (the kernel's) give the same per-token output;
    aligned padding tokens are zeros."""
    aligned = _setup(40 + quant, quant=quant)
    starts, _, _, t_pad = ragged_layout(aligned["row_lens"], 1)
    # the same pools, and the same query per (row, in-row index)
    dense = dict(aligned, starts=starts,
                 q=np.zeros((t_pad,) + aligned["q"].shape[1:], np.float32))
    for s_a, s_d, n in zip(aligned["starts"], dense["starts"], aligned["row_lens"]):
        dense["q"][s_d:s_d + n] = aligned["q"][s_a:s_a + n]
    args_a, kw_a = _torch(aligned)
    args_d, kw_d = _torch(dense)
    out_a = ragged_paged_attention_ref(*args_a, **kw_a)
    out_d = ragged_paged_attention_ref(*args_d, **kw_d)
    owned = np.zeros(out_a.shape[0], bool)
    for s_a, s_d, n in zip(aligned["starts"], dense["starts"], aligned["row_lens"]):
        np.testing.assert_allclose(out_a[s_a:s_a + n].numpy(), out_d[s_d:s_d + n].numpy(), **TOL)
        owned[s_a:s_a + n] = True
    assert torch.equal(out_a[torch.from_numpy(~owned)],
                       torch.zeros_like(out_a[torch.from_numpy(~owned)]))


def test_multi_step_pads_and_unowned_tokens_are_zeros():
    """A decode row reserving a 4-token window has row_len 1 in the mixed
    pass: its positions 1..3, the alignment pads and the blocks past the
    last row own no query and come out as finite zeros."""
    ops = _setup(50, row_lens=(1, 6), history=(20, 3), total=32)
    spans, _, _, _ = ragged_layout([4, 6], RAGGED_QB, total=32)
    np.testing.assert_array_equal(spans, ops["starts"])   # spans fit the same blocks
    args, kw = _torch(ops)
    out = ragged_paged_attention_ref(*args, **kw)
    assert torch.isfinite(out).all()
    live = torch.zeros(out.shape[0], dtype=torch.bool)
    live[0] = True
    live[8:14] = True
    assert torch.equal(out[~live], torch.zeros_like(out[~live]))
    assert out[live].abs().amax() > 0


def test_wrapper_on_cpu_is_the_plain_version():
    ops = _setup(60, quant=True)
    args, kw = _torch(ops)
    before = ragged_paged_attention.launches
    out = ragged_paged_attention(*args, block_rows=torch.from_numpy(ops["block_rows"]),
                                 block_q0=torch.from_numpy(ops["block_q0"]), **kw)
    assert torch.equal(out, ragged_paged_attention_ref(*args, **kw))
    assert ragged_paged_attention.launches == before  # no kernel launch on the CPU


def test_int8_pools_need_scales():
    ops = _setup(61, quant=True)
    args, _ = _torch(ops)
    with pytest.raises(ValueError, match="k_scale"):
        ragged_paged_attention(*args)


def _main_path_operands(**over):
    """CPU tensors shaped like the main path's call: T = 256 + 8*7 = 312
    flat tokens, 8 rows, Llama-3-8B heads, page 16."""
    t, r, hkv, g, d, n, p, pp = 312, 8, 8, 4, 128, 33, 16, 4
    i32 = dict(dtype=torch.int32)
    ops = dict(
        q=torch.zeros(t, hkv, g, d, dtype=torch.bfloat16),
        k_pool=torch.zeros(hkv, n, p, d, dtype=torch.bfloat16),
        v_pool=torch.zeros(hkv, n, p, d, dtype=torch.bfloat16),
        page_table=torch.zeros(r, pp, **i32),
        kv_lens=torch.zeros(r, **i32), row_starts=torch.zeros(r, **i32),
        row_lens=torch.zeros(r, **i32),
        block_rows=torch.zeros(t // 8, **i32), block_q0=torch.zeros(t // 8, **i32),
        k_scale=None, v_scale=None, tree_anc=None,
    )
    ops.update(over)
    return ops


_I8 = dict(k_pool=torch.zeros(8, 33, 16, 128, dtype=torch.int8),
           v_pool=torch.zeros(8, 33, 16, 128, dtype=torch.int8))


@pytest.mark.parametrize("over,gate", [
    (dict(tree_anc=torch.zeros(312, 4, dtype=torch.int64)), "tree_anc"),
    (dict(tree_anc=torch.zeros(304, 4, dtype=torch.int32)), "tree_anc"),
    (dict(tree_anc=torch.zeros(312, 65, dtype=torch.int32)), "tree_anc"),
    (dict(tree_anc=torch.zeros(312, 0, dtype=torch.int32)), "tree_anc"),
    (dict(tree_anc=torch.zeros(5, 312, dtype=torch.int32).t()), "contiguous"),
    (dict(block_rows=None), "block_map"),
    (dict(block_q0=torch.zeros(39, dtype=torch.int64)), "block_map"),
    (dict(q=torch.zeros(300, 8, 4, 128, dtype=torch.bfloat16)), "q_block"),
    (dict(q=torch.zeros(312, 8, 4, 128)), "q.dtype"),
    (dict(q=torch.zeros(312, 8, 4, 96, dtype=torch.bfloat16),
          k_pool=torch.zeros(8, 33, 16, 96, dtype=torch.bfloat16),
          v_pool=torch.zeros(8, 33, 16, 96, dtype=torch.bfloat16)), "head_dim"),
    (dict(q=torch.zeros(312, 8, 16, 128, dtype=torch.bfloat16)), "group"),
    (dict(k_pool=torch.zeros(8, 33, 64, 128, dtype=torch.bfloat16),
          v_pool=torch.zeros(8, 33, 64, 128, dtype=torch.bfloat16)), "page_size"),
    (dict(v_pool=torch.zeros(8, 33, 16, 128, dtype=torch.float16)), "pool.dtype"),
    (_I8, "scales"),
    (dict(page_table=torch.zeros(8, 4, dtype=torch.int64)), "page_table"),
    (dict(kv_lens=torch.zeros(7, dtype=torch.int32)), "kv_lens"),
    (dict(row_lens=torch.zeros(8, dtype=torch.int64)), "row_lens"),
    (dict(q=torch.zeros(312, 4, 8, 128, dtype=torch.bfloat16).transpose(1, 2)),
     "contiguous"),
], ids=["tree_anc", "tree_anc_rows", "tree_anc_dmax65", "tree_anc_dmax0",
        "tree_anc_strided", "no_block_map", "block_q0_i64", "t_not_aligned", "q_f32", "d96",
        "g16", "p64", "f16_pool", "int8_no_scales", "table_i64", "kv_lens_short",
        "row_lens_i64", "strided_q"])
def test_ragged_gates_raise_naming_the_gate(over, gate):
    with pytest.raises(ValueError, match="ragged_paged_attention gate {}".format(
            gate.replace(".", r"\."))):
        check_ragged_gates(**_main_path_operands(**over))


_D256 = dict(q=torch.zeros(312, 8, 8, 256, dtype=torch.bfloat16),
             k_pool=torch.zeros(8, 33, 16, 256, dtype=torch.bfloat16),
             v_pool=torch.zeros(8, 33, 16, 256, dtype=torch.bfloat16))


@pytest.mark.parametrize("over", [
    {}, dict(_I8, k_scale=torch.zeros(8, 33, 16), v_scale=torch.zeros(8, 33, 16)),
    dict(tree_anc=torch.full((312, 5), -2, dtype=torch.int32)),
    dict(tree_anc=torch.full((312, 1), -2, dtype=torch.int32)),
    dict(tree_anc=torch.full((312, 64), -2, dtype=torch.int32)),
    _D256, dict(_D256, tree_anc=torch.full((312, 5), -2, dtype=torch.int32)),
    dict(_D256, k_pool=torch.zeros(8, 33, 16, 256, dtype=torch.int8),
         v_pool=torch.zeros(8, 33, 16, 256, dtype=torch.int8),
         k_scale=torch.zeros(8, 33, 16), v_scale=torch.zeros(8, 33, 16)),
], ids=["bf16", "int8", "tree_k4", "tree_dmax1", "tree_dmax64", "d256_g8", "d256_g8_tree",
        "d256_g8_int8"])
def test_ragged_gates_accept_the_main_path(over):
    check_ragged_gates(**_main_path_operands(**over))
