"""The decode kernel's key-range split (csrc/paged_attention.cu) on the CPU.

``split_plan`` is held to what the kernel's C entry point accepts and shown
to depend on shapes alone. An f32 mirror of the kernel's arithmetic (spans
of the row per CTA, each CTA's four warps taking every fourth 16-token
tile with their own online softmax in log2 units, the warps merged in
order, then the splits merged in order, empty spans as m = -inf, l = 0) is
held against the port's plain version, the reference's XLA version and its
Pallas kernel in interpret mode, on llama-tiny-sized operands (Hkv 2, D 16,
16-token pages, a 256-token table) from a numpy seed, at atol = rtol = 1e-5
(the tolerance of test_torch_ops.py: the versions differ only in
summation order)."""

import inspect
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clearml_serving_tpu.ops.paged_attention import (
    paged_attention as jax_paged_attention,
    paged_attention_xla,
)
from clearml_serving_tpu_torch.ops.paged_attention import (
    SPLIT_MIN_SPAN,
    SPLIT_QUANTUM,
    paged_attention_ref,
    split_plan,
)

TOL = dict(rtol=1e-5, atol=1e-5)
WARPS, TILE = 4, 16          # kWarps, kTile of csrc/paged_attention.cu
HKV, D, P, PP = 2, 16, 16, 32  # llama-tiny's 2 KV heads of 16; a 512-token table


def _plan_ok(splits, span, pages_per_seq, page_size):
    """The C entry point's checks of (splits, span)."""
    capacity = pages_per_seq * page_size
    return (span > 0 and span % SPLIT_QUANTUM == 0 and 1 <= splits <= 65535
            and splits * span >= capacity
            and (splits - 1) * span < max(capacity, 1))


@pytest.mark.parametrize("batch,hkv,pages_per_seq,page_size", [
    (8, 8, 129, 16),    # the engine's table at max_seq_len 2048 (llm/engine.py)
    (1, 8, 129, 16),
    (8, 8, 65, 32),
    (64, 8, 129, 16),
    (8, 2, 32, 16),
    (8, 2, 16, 16),
    (3, 1, 1, 32),
    (2, 4, 0, 16),
    (256, 8, 513, 16),
])
def test_split_plan_is_what_the_kernel_takes(batch, hkv, pages_per_seq, page_size):
    splits, span = split_plan(batch, hkv, pages_per_seq, page_size)
    assert _plan_ok(splits, span, pages_per_seq, page_size)
    capacity = pages_per_seq * page_size
    assert span >= min(SPLIT_MIN_SPAN, -(-capacity // SPLIT_QUANTUM) * SPLIT_QUANTUM)


def test_split_plan_depends_on_shapes_alone():
    # no lengths among its inputs: the wrapper never reads a device value
    assert list(inspect.signature(split_plan).parameters) == [
        "batch", "hkv", "pages_per_seq", "page_size"]
    rng = np.random.default_rng(0)
    plans = set()
    for _ in range(4):
        ops = _operands(rng, g=4, quant=False, lengths=rng.integers(0, PP * P + 1, 8))
        b, hkv, _g, _d = ops["q"].shape
        plans.add(split_plan(b, hkv, ops["table"].shape[1], ops["k"].shape[2]))
    assert len(plans) == 1
    # the main path's table: 9 spans of 256 tokens, 576 CTAs at B = 8 (and
    # at B = 1: no span is shorter than SPLIT_MIN_SPAN); 2 of 2048 at B = 64
    assert split_plan(8, 8, 129, 16) == (9, 256)
    assert split_plan(1, 8, 129, 16) == (9, 256)
    assert split_plan(64, 8, 129, 16) == (2, 2048)


def _bf16_values(x):
    return torch.from_numpy(x).bfloat16().float().numpy()


def _quantize(pool):
    """Per-(token, head) symmetric int8, as models/llama.kv_store."""
    absmax = np.abs(pool).max(-1)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(pool / scale[..., None]), -127, 127).astype(np.int8)
    return q, scale


def _operands(rng, *, g, quant, lengths):
    """bf16-valued f32 operands; table entries past each length hold random
    page ids."""
    b = len(lengths)
    n = b * PP + 1
    q = _bf16_values(rng.standard_normal((b, HKV, g, D)).astype(np.float32))
    k = _bf16_values(rng.standard_normal((HKV, n, P, D)).astype(np.float32))
    v = _bf16_values(rng.standard_normal((HKV, n, P, D)).astype(np.float32))
    lengths = np.asarray(lengths, np.int32)
    table = rng.permutation(np.arange(1, n, dtype=np.int32)).reshape(b, PP)
    for i, length in enumerate(lengths):
        live = -(-int(length) // P)
        table[i, live:] = rng.integers(0, n, PP - live)
    ops = dict(q=q, k=k, v=v, table=table, lengths=lengths, ks=None, vs=None)
    if quant:
        ops["k"], ops["ks"] = _quantize(k)
        ops["v"], ops["vs"] = _quantize(v)
    return ops


def _merge(states):
    """Merge (m, l, acc) states in order, as the kernel's warp merge and
    combine do: weights 2^(m - M) over the states with l > 0; an empty
    span's state (acc None) is never read."""
    live = [(m, l, a) for m, l, a in states if a is not None]
    if not live:
        return None
    mx = torch.stack([m for m, _, _ in live]).amax(0)
    l_sum, acc = 0.0, 0.0
    for m, l, a in live:
        w = torch.where(l > 0, torch.exp2(m - mx), 0.0)
        l_sum = l_sum + w * l
        acc = acc + w[..., None] * a
    return mx, l_sum, acc


def split_combine_mirror(ops, splits, span):
    """f32 mirror of the kernel's split-then-combine arithmetic; returns the
    output [B, Hkv, G, D] and the number of empty spans (m = -inf, l = 0)."""
    q = torch.from_numpy(ops["q"])
    k, v = torch.from_numpy(ops["k"]).float(), torch.from_numpy(ops["v"]).float()
    quant = ops["ks"] is not None
    b_n, hkv, g, d = q.shape
    capacity = ops["table"].shape[1] * P
    score_scale = d ** -0.5 * math.log2(math.e)
    out = torch.zeros(b_n, hkv, g, d)
    empty = 0
    for b in range(b_n):
        length = min(int(ops["lengths"][b]), capacity)
        pages = torch.from_numpy(ops["table"][b, : -(-length // P)]).long()  # live pages only
        kr = k[:, pages].reshape(hkv, -1, d)
        vr = v[:, pages].reshape(hkv, -1, d)
        if quant:
            ks = torch.from_numpy(ops["ks"])[:, pages].reshape(hkv, -1)
            vs = torch.from_numpy(ops["vs"])[:, pages].reshape(hkv, -1)
        parts = []
        for s in range(splits):
            t0, t1 = s * span, min(s * span + span, length)
            if t0 >= length:
                empty += 1
                parts.append((torch.full((hkv, g), -math.inf), torch.zeros(hkv, g), None))
                continue
            n_tiles = -(-(t1 - t0) // TILE)
            warps = []
            for w in range(WARPS):
                m = torch.full((hkv, g), -math.inf)
                l = torch.zeros(hkv, g)
                acc = torch.zeros(hkv, g, d)
                for j in range(w, n_tiles, WARPS):
                    a, e = t0 + j * TILE, min(t0 + (j + 1) * TILE, t1)
                    sc = torch.einsum("kgd,ktd->kgt", q[b], kr[:, a:e]) * score_scale
                    if quant:
                        sc = sc * ks[:, None, a:e]
                    m_new = torch.maximum(m, sc.amax(-1))
                    corr = torch.exp2(m - m_new)
                    p = torch.exp2(sc - m_new[..., None])
                    l = l * corr + p.sum(-1)
                    pv = p * vs[:, None, a:e] if quant else p
                    acc = acc * corr[..., None] + torch.einsum("kgt,ktd->kgd", pv, vr[:, a:e])
                    m = m_new
                warps.append((m, l, acc))
            parts.append(_merge(warps))
        merged = _merge(parts)
        if merged is not None:
            _m, l_sum, acc = merged
            out[b] = torch.where(l_sum[..., None] > 0,
                                 acc / torch.where(l_sum > 0, l_sum, 1.0)[..., None], 0.0)
    return out, empty


def _case(g, quant, seed):
    splits, span = split_plan(8, HKV, PP, P)
    capacity = PP * P
    lengths = [0, 1, P - 1, P, span - 1, span, span + 1, capacity]
    ops = _operands(np.random.default_rng(seed), g=g, quant=quant, lengths=lengths)
    return ops, splits, span


@pytest.mark.parametrize("reference", ["plain", "xla", "pallas_interpret"])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16_values", "int8"])
def test_split_combine_mirror_matches_references(quant, g, reference):
    ops, splits, span = _case(g, quant, seed=30 + g + 10 * quant)
    assert splits > 1
    out, empty = split_combine_mirror(ops, splits, span)
    assert empty > 0  # the zero-length row's spans at least
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    if reference == "plain":
        t = {k: (None if x is None else torch.from_numpy(np.ascontiguousarray(x)))
             for k, x in ops.items()}
        ref = paged_attention_ref(t["q"], t["k"], t["v"], t["table"], t["lengths"],
                                  t["ks"], t["vs"]).numpy()
    else:
        j = {k: (None if x is None else jnp.asarray(x)) for k, x in ops.items()}
        if reference == "xla":
            ref = paged_attention_xla(j["q"], j["k"], j["v"], j["table"], j["lengths"],
                                      j["ks"], j["vs"])
        else:
            ref = jax_paged_attention(j["q"], j["k"], j["v"], j["table"], j["lengths"],
                                      k_scale=j["ks"], v_scale=j["vs"], pages_per_block=2,
                                      interpret=True)
        ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
