"""The port's w4a16 matmul (clearml_serving_tpu_torch/ops/fused_matmul.py)
and its int4/int8 model path against the reference on the CPU.

- ``int4_matmul_plain`` against the reference's Pallas kernel in interpret
  mode (``fused_int4_matmul(..., interpret=True)``) and its XLA reference
  ``int4_matmul_xla``, over the reference's parity grid
  (tests/test_fused_matmul.py), at 1e-5 in f32; the same packed weights
  (JAX's quantizer) and inputs from a numpy seed on both sides.
- The wrapper's CPU route at any row count and the CUDA kernel's gates
  (read from shapes, no card needed).
- ``Llama.prefill``, ``decode_paged`` and ``forward_ragged`` logits on JAX
  int4 and int8 trees carried over by ``convert_params`` (per-layer and
  scan-stacked), within 1e-4 in f32: llama-tiny widened to dim 256 / ffn 512
  (projections of 2 and 4 scale groups), and llama-tiny itself (one group).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearml_serving_tpu import models
from clearml_serving_tpu.llm.kv_cache import PagedKVCache as JaxPagedKVCache
from clearml_serving_tpu.ops.fused_matmul import fused_int4_matmul as ref_fused
from clearml_serving_tpu.ops.fused_matmul import int4_matmul_xla
from clearml_serving_tpu.ops.quant import dequantize_int4 as ref_dequantize_int4
from clearml_serving_tpu.ops.quant import quantize_int4 as ref_quantize_int4
from clearml_serving_tpu.ops.quant import quantize_llama_params as ref_quantize_llama
from clearml_serving_tpu_torch.llm.kv_cache import PagedKVCache
from clearml_serving_tpu_torch.models.llama import Llama, QuantWeight, convert_params
from clearml_serving_tpu_torch.ops.fused_matmul import (
    KERNEL_MAX_COLS,
    KERNEL_MAX_ROWS,
    fused_int4_matmul,
    int4_kernel_unsupported_reason,
    int4_matmul_plain,
)
from clearml_serving_tpu_torch.ops.paged_attention import ragged_layout

ATOL_OP = 1e-5
ATOL = 1e-4

# the reference's parity grid: (m, k, n, group)
PARITY_GRID = [
    (1, 128, 128, 128),
    (2, 256, 256, 128),
    (3, 256, 384, 64),
    (8, 512, 1024, 128),
    (4, 96, 128, 128),     # K % group != 0 -> one per-channel group
    (5, 64, 130, 64),      # N not a multiple of 16
    (16, 384, 512, 192),
]


def _rand_wx(m, k, n, seed):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(k, n)) * k ** -0.5).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    return x, w


def _packed(w, group):
    q, s = ref_quantize_int4(jnp.asarray(w), group=group)
    return q, s, torch.from_numpy(np.array(q)), torch.from_numpy(np.array(s))


@pytest.mark.parametrize("m,k,n,group", PARITY_GRID)
def test_plain_version_matches_pallas_interpret_and_xla(m, k, n, group):
    x, w = _rand_wx(m, k, n, seed=m + k + n)
    q, s, qt, st = _packed(w, group)
    out = int4_matmul_plain(torch.from_numpy(x), qt, st, torch.float32)
    assert out.dtype == torch.float32 and tuple(out.shape) == (m, n)
    kernel = ref_fused(jnp.asarray(x), q, s, dtype=jnp.float32, interpret=True)
    xla = int4_matmul_xla(jnp.asarray(x), q, s, jnp.float32)
    assert float(np.abs(out.numpy() - np.asarray(kernel)).max()) <= ATOL_OP
    assert float(np.abs(out.numpy() - np.asarray(xla)).max()) <= ATOL_OP


def test_plain_version_takes_3d_activations():
    x, w = _rand_wx(6, 256, 256, seed=7)
    q, s, qt, st = _packed(w, 128)
    x3 = x.reshape(2, 3, 256)
    out = fused_int4_matmul(torch.from_numpy(x3), qt, st, dtype=torch.float32)
    kernel = ref_fused(jnp.asarray(x3), q, s, dtype=jnp.float32, interpret=True)
    assert tuple(out.shape) == (2, 3, 256)
    assert float(np.abs(out.numpy() - np.asarray(kernel)).max()) <= ATOL_OP


def test_plain_version_bf16_activations():
    """bf16 activations: both sides dequantize to bf16 and sum in f32;
    operand rounding differs, so the reference's own bf16 bound (0.05)."""
    x, w = _rand_wx(4, 256, 256, seed=11)
    q, s, qt, st = _packed(w, 128)
    xb = torch.from_numpy(x).bfloat16()
    out = int4_matmul_plain(xb, qt, st, torch.bfloat16)
    want = int4_matmul_xla(jnp.asarray(x).astype(jnp.bfloat16), q, s, jnp.bfloat16)
    assert out.dtype == torch.bfloat16
    assert float(np.abs(out.float().numpy() - np.asarray(want, np.float32)).max()) <= 0.05


@pytest.mark.parametrize("rows", [1, 8, 312, 2048])
def test_cpu_wrapper_is_the_plain_version_and_counts_nothing(rows):
    """Decode, the ragged flat axis and the longest prefill bucket: the CPU
    route is the plain version at every row count and launches nothing."""
    x, w = _rand_wx(rows, 128, 64, seed=3)
    _q, _s, qt, st = _packed(w, 128)
    launches = fused_int4_matmul.launches
    xt = torch.from_numpy(x)
    out = fused_int4_matmul(xt, qt, st, dtype=torch.float32)
    assert torch.equal(out, int4_matmul_plain(xt, qt, st, torch.float32))
    assert fused_int4_matmul.launches == launches


def test_wrapper_refuses_other_devices():
    x, q, s = (t.to("meta") for t in _ok_operands())
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        fused_int4_matmul(x, q, s)


def _ok_operands(m=4, k=256, n=128, group=128):
    x = torch.zeros(m, k, dtype=torch.bfloat16)
    q = torch.zeros(k // 2, n, dtype=torch.uint8)
    s = torch.ones(k // group, n, dtype=torch.float32)
    return x, q, s


@pytest.mark.parametrize("case,gate", [
    ("stacked", "2-D"), ("packed_int8", "packed.dtype"), ("scale_bf16", "scale.dtype"),
    ("x_f32", "x.dtype"), ("k_mismatch", "K"), ("k_odd", "K"), ("scale_cols", "scale.shape"),
    ("groups", "groups"), ("group_24", "group"), ("n_8", "N"), ("empty", "rows"),
    ("grid_rows", "rows"), ("grid_cols", "N"), ("strided", "contiguous"),
    ("misaligned", "alignment"),
])
def test_kernel_gates_name_themselves(case, gate):
    x, q, s = _ok_operands()
    assert int4_kernel_unsupported_reason(x, q, s) is None
    if case == "stacked":
        q, s = q[None], s[None]
    elif case == "packed_int8":
        q = q.to(torch.int8)
    elif case == "scale_bf16":
        s = s.bfloat16()
    elif case == "x_f32":
        x = x.float()
    elif case == "k_mismatch":
        x = torch.zeros(4, 128, dtype=torch.bfloat16)
    elif case == "k_odd":
        x = torch.zeros(4, 255, dtype=torch.bfloat16)
    elif case == "scale_cols":
        s = torch.ones(2, 64)
    elif case == "groups":
        s = torch.ones(3, 128)
    elif case == "group_24":
        x, q, s = _ok_operands(k=48, group=24)
    elif case == "n_8":
        x, q, s = _ok_operands(n=136)
    elif case == "empty":
        x = torch.zeros(0, 256, dtype=torch.bfloat16)
    elif case == "grid_rows":
        x = torch.empty(KERNEL_MAX_ROWS + 1, 256, dtype=torch.bfloat16, device="meta")
    elif case == "grid_cols":
        q = torch.empty(128, KERNEL_MAX_COLS + 16, dtype=torch.uint8, device="meta")
        s = torch.empty(2, KERNEL_MAX_COLS + 16, dtype=torch.float32, device="meta")
    elif case == "strided":
        q = torch.zeros(128, 256, dtype=torch.uint8)[:, ::2]
    elif case == "misaligned":
        x = torch.zeros(4 * 256 + 1, dtype=torch.bfloat16)[1:].reshape(4, 256)
    reason = int4_kernel_unsupported_reason(x, q, s)
    assert reason is not None and reason.startswith(gate + ":"), reason


def test_grid_gates_state_the_kernels_limits():
    """The row count is the C entry point's 32-bit int; the columns are the
    block tiling's grid y of 65535 tiles of 128. Each limit itself passes."""

    def reason(m, n):
        return int4_kernel_unsupported_reason(
            torch.empty(m, 256, dtype=torch.bfloat16, device="meta"),
            torch.empty(128, n, dtype=torch.uint8, device="meta"),
            torch.empty(2, n, dtype=torch.float32, device="meta"))

    assert reason(KERNEL_MAX_ROWS, 128) is None
    assert reason(4, KERNEL_MAX_COLS) is None
    assert reason(KERNEL_MAX_ROWS + 1, 128) == (
        "rows: 2147483648 rows exceed the kernel's 32-bit row count (2147483647)")
    assert reason(4, KERNEL_MAX_COLS + 16) == (
        "N: N=8388496 exceeds the grid's 65535 column tiles of 128")


def test_kernel_takes_every_llama3_8b_projection_shape():
    dim, kv, ffn, vocab = 4096, 1024, 14336, 128256
    for k, n in ((dim, dim), (dim, kv), (dim, ffn), (ffn, dim), (dim, vocab)):
        q = torch.empty(k // 2, n, dtype=torch.uint8, device="meta")
        s = torch.empty(k // 128, n, dtype=torch.float32, device="meta")
        for m in (1, 8, 312, 1024, 2048):
            x = torch.empty(m, k, dtype=torch.bfloat16, device="meta")
            assert int4_kernel_unsupported_reason(x, q, s) is None, (m, k, n)


# -- the model on quantized trees --------------------------------------------------

CONFIGS = {
    # projections of 2 (K = 256) and 4 (K = 512) scale groups
    "wide": {"preset": "llama-tiny", "dtype": "float32", "dim": 256, "n_heads": 4,
             "n_kv_heads": 2, "ffn_dim": 512},
    # K = 64 (the one-group fallback) and K = 128 (one group)
    "tiny": {"preset": "llama-tiny", "dtype": "float32"},
}
CASES = [("wide", "per_layer"), ("wide", "stacked"), ("tiny", "per_layer")]


@pytest.fixture(scope="module")
def trees():
    """config name -> (f32 per-layer numpy tree)."""
    return {name: jax.tree.map(np.asarray,
                               models.build_model("llama", cfg).init(jax.random.PRNGKey(0)))
            for name, cfg in CONFIGS.items()}


def _pair(trees, name, layout, bits):
    """(JAX bundle, JAX quantized tree, the port's Llama on the same
    quantized tree carried over by convert_params)."""
    cfg = CONFIGS[name]
    np_tree = trees[name]
    jq = ref_quantize_llama(jax.tree.map(jnp.asarray, np_tree), bits=bits)
    if layout == "stacked":
        stacked = dict(np_tree)
        stacked["layers"] = {k: np.stack([layer[k] for layer in np_tree["layers"]])
                             for k in np_tree["layers"][0]}
        carried = ref_quantize_llama(jax.tree.map(jnp.asarray, stacked), bits=bits)
    else:
        carried = jq
    model = Llama(cfg, convert_params(jax.tree.map(np.asarray, carried), device="cpu"))
    want = "int4" if bits == 4 else "int8"
    assert model.weight_quant == want
    assert isinstance(model.layers[0].w_down, QuantWeight) and model.lm_head.quant == want
    return models.build_model("llama", cfg), jq, model


@pytest.mark.parametrize("bits", [4, 8], ids=["int4", "int8"])
@pytest.mark.parametrize("name,layout", CASES)
def test_prefill_logits_match_reference(trees, name, layout, bits):
    bundle, jq, model = _pair(trees, name, layout, bits)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 512, (2, 16)).astype(np.int32)
    seq_lens = np.array([16, 9], np.int32)
    last_j, cache_j = bundle.prefill(jq, jnp.asarray(tokens), jnp.asarray(seq_lens),
                                     bundle.init_cache(2, 16))
    last_t, cache_t = model.prefill(torch.from_numpy(tokens).long(),
                                    torch.from_numpy(seq_lens))
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j), atol=ATOL, rtol=ATOL)
    for b, n in enumerate(seq_lens):
        np.testing.assert_allclose(cache_t["k"][:, b, :n].numpy(),
                                   np.asarray(cache_j["k"])[:, b, :n], atol=ATOL, rtol=ATOL)


def _history(bundle, jq, jcache, tcache, rows, rng):
    """The same prefilled history K/V (the reference's prefill) in both
    caches; rows: (history, ...) per slot."""
    for slot, (hist, *_rest) in enumerate(rows):
        if not hist:
            continue
        ids = rng.integers(0, 512, hist).astype(np.int32)
        _last, mini = bundle.prefill(jq, jnp.asarray(ids[None]), jnp.asarray([hist], jnp.int32),
                                     bundle.init_cache(1, hist))
        k, v = (np.array(mini[key])[:, 0, :hist] for key in ("k", "v"))
        jcache.write_prompt(slot, k, v, hist)
        tcache.write_prompt(slot, torch.from_numpy(k), torch.from_numpy(v), hist)


def _caches(bundle, model, slots):
    geo = dict(num_pages=32, page_size=4, max_slots=slots)
    jcache = JaxPagedKVCache(bundle.n_layers, bundle.n_kv_heads, bundle.head_dim,
                             dtype="float32", **geo)
    tcache = PagedKVCache(model.n_layers, model.n_kv_heads, model.head_dim,
                          dtype=torch.float32, device="cpu", **geo)
    return jcache, tcache


@pytest.mark.parametrize("bits", [4, 8], ids=["int4", "int8"])
@pytest.mark.parametrize("name,layout", CASES)
def test_decode_paged_logits_match_reference(trees, name, layout, bits):
    bundle, jq, model = _pair(trees, name, layout, bits)
    jcache, tcache = _caches(bundle, model, 2)
    rng = np.random.default_rng(2)
    _history(bundle, jq, jcache, tcache, [(11,), (6,)], rng)
    next_tokens = rng.integers(0, 512, 2).astype(np.int32)
    for _step in range(2):
        lengths0 = jcache.pool.lengths().copy()
        wp, wo = np.zeros(2, np.int32), np.zeros(2, np.int32)
        for slot in (0, 1):
            start = jcache.pool.slot_length(slot)
            jcache.pool.extend(slot, 1)
            tcache.pool.extend(slot, 1)
            ((wp[slot], wo[slot]),) = jcache.pool.token_coords(slot, start, 1)
        table = jcache.pool.page_table(6)
        logits_j, jcache.k, jcache.v = bundle.decode_paged(
            jq, jnp.asarray(next_tokens), jcache.k, jcache.v, jnp.asarray(table),
            jnp.asarray(lengths0), jnp.asarray(wp), jnp.asarray(wo))
        logits_t = model.decode_paged(
            torch.from_numpy(next_tokens).long(), tcache.k, tcache.v, torch.from_numpy(table),
            torch.from_numpy(lengths0), torch.from_numpy(wp), torch.from_numpy(wo))
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=ATOL, rtol=ATOL)
        next_tokens = np.asarray(jnp.argmax(logits_j, -1)).astype(np.int32)


# (history, query tokens) per row: a decode row, chunks at history 0 and
# mid-history, an idle row
ROWS = [(11, 1), (0, 7), (6, 9), (0, 0)]


@pytest.mark.parametrize("bits", [4, 8], ids=["int4", "int8"])
@pytest.mark.parametrize("name,layout", CASES)
def test_forward_ragged_logits_match_reference(trees, name, layout, bits):
    bundle, jq, model = _pair(trees, name, layout, bits)
    jcache, tcache = _caches(bundle, model, len(ROWS))
    rng = np.random.default_rng(7)
    _history(bundle, jq, jcache, tcache, ROWS, rng)
    row_lens = np.array([n for _h, n in ROWS], np.int32)
    starts, _br, _bq, t = ragged_layout(row_lens, 1, total=int(row_lens.sum()) + 3)
    flat = {key: np.zeros(t, np.int32) for key in
            ("tokens", "tok_pos", "tok_row", "write_page", "write_offset")}
    tok_valid = np.zeros(t, bool)
    row_last = np.zeros(len(ROWS), np.int32)
    kv_lens = np.zeros(len(ROWS), np.int32)
    for slot, (hist, n) in enumerate(ROWS):
        if not n:
            continue
        s = int(starts[slot])
        jcache.pool.extend(slot, n)
        tcache.pool.extend(slot, n)
        coords = jcache.pool.token_coords(slot, hist, n)
        flat["tokens"][s:s + n] = rng.integers(0, 512, n)
        flat["tok_pos"][s:s + n] = hist + np.arange(n)
        flat["tok_row"][s:s + n] = slot
        flat["write_page"][s:s + n] = [p for p, _ in coords]
        flat["write_offset"][s:s + n] = [o for _, o in coords]
        tok_valid[s:s + n] = True
        row_last[slot] = s + n - 1
        kv_lens[slot] = hist + n
    table = jcache.pool.page_table(8)
    head = (flat["tokens"], flat["tok_pos"], flat["tok_row"], tok_valid, row_last)
    rows = (table, kv_lens, starts, row_lens, flat["write_page"], flat["write_offset"])
    out = bundle.forward_ragged(jq, *(jnp.asarray(a) for a in head), jcache.k, jcache.v,
                                *(jnp.asarray(a) for a in rows))
    logits = model.forward_ragged(
        torch.from_numpy(head[0]).long(), *(torch.from_numpy(a) for a in head[1:]),
        tcache.k, tcache.v, *(torch.from_numpy(a) for a in rows))
    live = row_lens > 0
    np.testing.assert_allclose(logits.numpy()[live], np.asarray(out[0])[live],
                               atol=ATOL, rtol=ATOL)


def test_quantized_leaf_shapes_are_checked(trees):
    np_tree = jax.tree.map(np.asarray, ref_quantize_llama(
        jax.tree.map(jnp.asarray, trees["wide"]), bits=4))
    tree = convert_params(np_tree, device="cpu")
    model = Llama(CONFIGS["wide"], tree)
    # the weight accessor dequantizes in the model dtype, as the reference's _w
    np.testing.assert_array_equal(
        model._w(model.layers[0].wq).numpy(),
        np.asarray(ref_dequantize_int4(np_tree["layers"][0]["wq"]["_q4"],
                                       np_tree["layers"][0]["wq"]["_scale4"], jnp.float32)))
    bad = dict(tree, layers=[dict(layer) for layer in tree["layers"]])
    bad["layers"][0]["wq"] = {"_q4": tree["layers"][0]["wq"]["_q4"][:64],
                              "_scale4": tree["layers"][0]["wq"]["_scale4"]}
    with pytest.raises(ValueError, match="wq has shape"):
        Llama(CONFIGS["wide"], bad)
    bad["layers"][0]["wq"] = {"_q4": tree["layers"][0]["wq"]["_q4"],
                              "_scale4": torch.ones(3, 256)}
    with pytest.raises(ValueError, match="int4 leaf"):
        Llama(CONFIGS["wide"], bad)
    with pytest.raises(ValueError, match="unknown quantized leaf"):
        convert_params(dict(np_tree, lm_head={"_q4": np.zeros((2, 2), np.uint8)}),
                       device="cpu")


def test_int4_fused_false_raises_naming_itself(trees):
    with pytest.raises(NotImplementedError, match="int4_fused"):
        Llama(dict(CONFIGS["tiny"], int4_fused=False),
              convert_params(trees["tiny"], device="cpu"))
