"""The ragged kernel's key-range split (csrc/ragged_paged_attention.cu) on the
CPU.

``ragged_split_plan`` is held to what the kernel's C entry point accepts and
shown to depend on shapes alone. An f32 mirror of the kernel's arithmetic is
held against the port's plain version, the reference's XLA version and its
Pallas kernel in interpret mode, on llama-tiny-sized operands (Hkv 2, D 16,
16-token pages, a 1040-token table: 5 slots of 256 tokens) from a numpy
seed, at atol = rtol = 1e-5 (the versions differ only in summation order).
The mirror follows the kernel: a row of at most RAGGED_QB queries whose
block ``row_starts`` names, and whose keys exceed 3 spans and a span past
the launch's longest prefill chunk, is cut into spans of equal width (at
most max(2, 128 / (long rows * Hkv)) of them), each span (or a chunk row's
q block whole) walked by two key groups that take every other 32-token
step with their own online softmax in log2 units, the groups merged in
order, then a split row's spans merged in order; a (query, head) with no
visible key in a span is the empty state (l = 0), and dead queries give
zeros. The rows cover kv lengths 1, P - 1, P, span - 1, span, span + 1, 3
span (the longest that does not split), 3 span + 1 (the shortest that
does, its last span one key), 4 span, 4 span + 1 and the capacity, verify
rows of 5 with draft-tree masks (one with its queries 0-3 wholly before
its last span), a multi-step decode row, an 8-query row (the last that
splits), a 9-query row (the first that does not), a chunk, an idle row and
unowned blocks; a launch of 16 rows at the capacity takes 4 spans of 320
tokens, not 5 of 256."""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearml_serving_tpu.ops.paged_attention import (
    ragged_paged_attention as jax_ragged_paged_attention,
    ragged_paged_attention_xla,
)
from clearml_serving_tpu_torch.ops.paged_attention import (
    RAGGED_QB,
    SPLIT_MIN_SPAN,
    SPLIT_QUANTUM,
    ragged_layout,
    ragged_paged_attention_ref,
    ragged_partial_sizes,
    ragged_split_plan,
    split_plan,
    tree_ancestors,
)
from torch_fp_env import fp_environment

TOL = dict(rtol=1e-5, atol=1e-5)
STEP, KEY_GROUPS = 32, 2       # kChunk, kKG of csrc/ragged_paged_attention.cu
HKV, D, P, PP = 2, 16, 16, 65  # llama-tiny's 2 KV heads of 16; a 1040-token table
CAPACITY = PP * P
SPAN = 256
SPLIT_MIN_SPANS, SPLIT_CTAS = 3, 128  # kSplitMinSpans, kSplitCtas
# (span on the flat axis, query tokens, history before them)
ROWS = [
    (1, 1, 0),      # kv 1
    (1, 1, P - 2),  # kv P - 1
    (1, 1, P - 1),  # kv P
    (1, 1, SPAN - 2),  # kv span - 1
    (1, 1, SPAN - 1),  # kv span
    (1, 1, SPAN),      # kv span + 1
    (1, 1, 3 * SPAN - 1),  # kv 3 span: the longest that does not split
    (1, 1, 3 * SPAN),      # kv 3 span + 1: 4 spans, the last of one key
    (1, 1, 4 * SPAN - 1),  # kv 4 span
    (1, 1, 4 * SPAN),      # kv 4 span + 1
    (1, 1, CAPACITY - 1),  # kv capacity
    (5, 5, 3 * SPAN - 4),  # verify row at kv 3 span + 1: queries 0-3 see nothing in span 3
    (5, 5, CAPACITY - 5),  # verify row at the capacity
    (4, 1, 900),    # multi-step decode row: positions 1-3 are pads
    (8, 8, 900),    # the longest row that splits
    (9, 9, 0),      # the shortest row that does not
    (19, 19, 77),   # a prefill chunk: the launch's longest, 96 keys
    (0, 0, 0),      # idle
]
VERIFY = (11, 12)        # rows that may carry a draft tree
# 16 rows at the capacity: the CTA cap, max(2, 128 / (16 * Hkv)) = 4 spans of 320
LONG_ROWS = [(1, 1, CAPACITY - 1)] * 16
UNOWNED_BLOCKS = 2
TOPOLOGIES = {
    "forest": ([-1, 0, 1, 2, 0], 5),
    "dead_nodes": ([-1, 0, 0, -1, -1], 3),
    "chain": ([-1, 0, 1, 2, 3], 5),
}


def _plan_ok(splits, span, pages_per_seq, page_size):
    """The C entry point's checks of (splits, span)."""
    capacity = pages_per_seq * page_size
    return (span > 0 and span % SPLIT_QUANTUM == 0 and splits >= 1
            and splits * span >= capacity
            and (splits - 1) * span < max(capacity, 1))


@pytest.mark.parametrize("t,n_rows,hkv,pages_per_seq,page_size", [
    (312, 8, 8, 129, 16),   # the engine's flat axis and table at max_seq_len 2048
    (184, 8, 8, 65, 16),    # chip_smoke.py's mixed shape
    (512, 1, 8, 129, 16),   # one prefill chunk
    (312, 8, 8, 65, 32),
    (8, 64, 8, 129, 16),
    (2048, 256, 8, 513, 16),
    (176, 18, 2, 65, 16),   # this file's operands
    (8, 1, 1, 1, 32),
    (16, 2, 4, 0, 16),
])
def test_ragged_split_plan_is_what_the_kernel_takes(t, n_rows, hkv, pages_per_seq, page_size):
    splits, span = ragged_split_plan(t, n_rows, hkv, pages_per_seq, page_size)
    assert _plan_ok(splits, span, pages_per_seq, page_size)
    capacity = pages_per_seq * page_size
    assert span >= min(SPLIT_MIN_SPAN, -(-capacity // SPLIT_QUANTUM) * SPLIT_QUANTUM)
    # at most min(T / RAGGED_QB, R) rows split: the decode kernel's plan for that many
    assert (splits, span) == split_plan(max(1, min(t // RAGGED_QB, n_rows)), hkv,
                                        pages_per_seq, page_size)


def test_ragged_split_plan_depends_on_shapes_alone():
    # no lengths or row map among its inputs: the wrapper never reads a device value
    assert list(inspect.signature(ragged_split_plan).parameters) == [
        "t", "n_rows", "hkv", "pages_per_seq", "page_size"]
    rng = np.random.default_rng(0)
    plans = set()
    for _ in range(4):
        ops = _operands(rng, g=4, quant=False,
                        history=[int(h) for h in rng.integers(0, CAPACITY - 32, len(ROWS))])
        t = ops["q"].shape[0]
        plans.add(ragged_split_plan(t, ops["table"].shape[0], HKV, PP, P))
    assert plans == {(5, SPAN)}
    # the engine's launch: 9 spans of 256 tokens; 9.4 MB of partials at G 4, D 128
    assert ragged_split_plan(312, 8, 8, 129, 16) == (9, 256)
    n_acc, n_ml = ragged_partial_sizes(8, 8, 9, 4, 128)
    assert 4 * (n_acc + 2 * n_ml) == 9_584_640
    assert ragged_partial_sizes(8, 8, 1, 4, 128) == (0, 0)


def _bf16_values(x):
    return torch.from_numpy(x).bfloat16().float().numpy()


def _quantize(pool):
    """Per-(token, head) symmetric int8, as models/llama.kv_store."""
    absmax = np.abs(pool).max(-1)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(pool / scale[..., None]), -127, 127).astype(np.int8)
    return q, scale


def _operands(rng, *, g, quant, rows=ROWS, history=None, topology=None):
    """bf16-valued f32 operands of ``rows`` (with ``history`` replacing
    their histories), q-block aligned with unowned blocks at the end; table
    entries past each row's kv_len hold random page ids; ``topology`` puts
    a draft tree on the VERIFY rows (every other token -2)."""
    spans = [s for s, _, _ in rows]
    row_lens = np.array([n for _, n, _ in rows], np.int32)
    hist = np.array(history if history is not None else [h for _, _, h in rows], np.int32)
    kv_lens = np.minimum(row_lens + hist, CAPACITY).astype(np.int32)
    starts, block_rows, block_q0, t_pad = ragged_layout(spans, RAGGED_QB)
    block_rows = np.concatenate([block_rows, np.full(UNOWNED_BLOCKS, -1, np.int32)])
    block_q0 = np.concatenate([block_q0, np.zeros(UNOWNED_BLOCKS, np.int32)])
    t_pad += UNOWNED_BLOCKS * RAGGED_QB
    r = len(rows)
    n = r * PP + 1
    q = _bf16_values(rng.standard_normal((t_pad, HKV, g, D)).astype(np.float32))
    k = _bf16_values(rng.standard_normal((HKV, n, P, D)).astype(np.float32))
    v = _bf16_values(rng.standard_normal((HKV, n, P, D)).astype(np.float32))
    table = rng.permutation(np.arange(1, n, dtype=np.int32)).reshape(r, PP)
    for i, length in enumerate(kv_lens):
        live = -(-int(length) // P)
        table[i, live:] = rng.integers(0, n, PP - live)
    ops = dict(q=q, k=k, v=v, table=table, kv_lens=kv_lens, starts=starts, row_lens=row_lens,
               block_rows=block_rows, block_q0=block_q0, ks=None, vs=None, tree=None)
    if quant:
        ops["k"], ops["ks"] = _quantize(k)
        ops["v"], ops["vs"] = _quantize(v)
    if topology is not None:
        parents, n_nodes = TOPOLOGIES[topology]
        anc = np.full((t_pad, len(parents)), -1, np.int32)
        anc[:, 0] = -2
        for i in VERIFY:
            s = int(starts[i])
            anc[s:s + len(parents)] = tree_ancestors(parents, n_nodes, width=len(parents))
        ops["tree"] = anc
    return ops


def _row_split(ops, r, blk, splits, span):
    """The kernel's row_split for row r at block blk: (spans, width), (1, 0)
    when it does not split. A short row splits when its keys exceed 3 spans
    and a span past the launch's longest prefill chunk, into at most
    max(2, 128 / (long rows * Hkv)) spans of equal width."""
    row_len, kv_len = int(ops["row_lens"][r]), int(ops["kv_lens"][r])
    start = int(ops["starts"][r])
    if (splits == 1 or not 1 <= row_len <= RAGGED_QB or start != blk * RAGGED_QB
            or int(ops["block_rows"][blk]) != r or int(ops["block_q0"][blk]) != 0):
        return 1, 0
    bounds = [max(0, min(int(kv), CAPACITY)) for kv in ops["kv_lens"]]
    chunk = max([b for n, b in zip(ops["row_lens"], bounds) if n > RAGGED_QB] or [0])
    long_rows = sum(1 for n, b in zip(ops["row_lens"], bounds)
                    if 1 <= n <= RAGGED_QB and b > SPLIT_MIN_SPANS * span)
    bound = bounds[r]
    if bound <= max(chunk + span, SPLIT_MIN_SPANS * span):
        return 1, 0
    n = min(-(-bound // span), max(2, SPLIT_CTAS // max(1, long_rows * HKV)))
    width = -(-(-(-bound // n)) // SPLIT_QUANTUM) * SPLIT_QUANTUM
    return -(-bound // width), width


def _merge(states):
    """Merge (m, l, acc) states in order, as the kernel's key-group merge
    does: weights 2^(m - M) over the states with l > 0."""
    mx = torch.stack([torch.where(l > 0, m, -math.inf) for m, l, _ in states]).amax(0)
    l_sum = torch.zeros_like(mx)
    acc = torch.zeros_like(states[0][2])
    for m, l, a in states:
        w = torch.where(l > 0, torch.exp2(m - mx), 0.0)
        l_sum = l_sum + w * l
        acc = acc + w[..., None] * a
    return mx, l_sum, acc


def _merge_online(states):
    """Merge (m, l, acc) states in order in one pass that rescales as it
    goes, as the kernel's combine does; a state with l = 0 is skipped."""
    mx = torch.full_like(states[0][0], -math.inf)
    l_sum = torch.zeros_like(mx)
    acc = torch.zeros_like(states[0][2])
    for m, l, a in states:
        live = l > 0
        mn = torch.where(live, torch.maximum(mx, m), mx)
        c_old = torch.where(live, torch.exp2(mx - mn), 1.0)
        c_new = torch.where(live, torch.exp2(m - mn), 0.0)
        l_sum = l_sum * c_old + l * c_new
        acc = acc * c_old[..., None] + a * c_new[..., None]
        mx = mn
    return mx, l_sum, acc


def _visible(ops, blk, base, q0, keys, lim):
    """[QB, keys] causal (and draft-tree) visibility of the block's queries."""
    vis = keys[None, :] < lim[:, None]
    if ops["tree"] is None:
        return vis
    anc = torch.from_numpy(ops["tree"][blk * RAGGED_QB:(blk + 1) * RAGGED_QB]).long()
    off = keys[None, :] - base
    listed = (off[:, :, None] == anc[:, None, :]).any(-1)
    plain = (anc[:, 0] == -2)[:, None]
    return vis & (plain | (off < 0) | listed)


def _cta_state(ops, blk, r, t_begin, t_end, key_bound):
    """One CTA: its key groups' online softmaxes over their steps of
    [t_begin, t_end), merged in group order: (m, l, acc) per (Hkv, query,
    head) of the block."""
    q = torch.from_numpy(ops["q"][blk * RAGGED_QB:(blk + 1) * RAGGED_QB])  # [QB, Hkv, G, D]
    g = q.shape[2]
    k, v = torch.from_numpy(ops["k"]).float(), torch.from_numpy(ops["v"]).float()
    quant = ops["ks"] is not None
    q0 = int(ops["block_q0"][blk])
    row_len, kv_len = int(ops["row_lens"][r]), int(ops["kv_lens"][r])
    base = kv_len - row_len
    pages = torch.from_numpy(ops["table"][r, : -(-t_end // P)]).long()  # live pages only
    kr = k[:, pages].reshape(HKV, -1, D)
    vr = v[:, pages].reshape(HKV, -1, D)
    if quant:
        ks = torch.from_numpy(ops["ks"])[:, pages].reshape(HKV, -1)
        vs = torch.from_numpy(ops["vs"])[:, pages].reshape(HKV, -1)
    qi = torch.arange(RAGGED_QB)
    lim = torch.where(q0 + qi < row_len, torch.clamp(base + q0 + qi + 1, max=key_bound), 0)
    score_scale = D ** -0.5 * math.log2(math.e)
    n_steps = -(-(t_end - t_begin) // STEP)
    states = []
    for kg in range(KEY_GROUPS):
        m = torch.full((HKV, RAGGED_QB, g), -math.inf)
        l = torch.zeros(HKV, RAGGED_QB, g)
        acc = torch.zeros(HKV, RAGGED_QB, g, D)
        for j in range(kg, n_steps, KEY_GROUPS):
            a, e = t_begin + j * STEP, min(t_begin + (j + 1) * STEP, t_end)
            vis = _visible(ops, blk, base, q0, torch.arange(a, e), lim)[None, :, None, :]
            sc = torch.einsum("qhgd,htd->hqgt", q, kr[:, a:e]) * score_scale
            if quant:
                sc = sc * ks[:, None, None, a:e]
            sc = torch.where(vis, sc, -math.inf)
            m_new = torch.maximum(m, sc.amax(-1).clamp(min=-1e30))
            corr = torch.exp2(m - m_new)
            p = torch.where(vis, torch.exp2(sc - m_new[..., None]), 0.0)
            l = l * corr + p.sum(-1)
            pv = p * vs[:, None, None, a:e] if quant else p
            acc = acc * corr[..., None] + torch.einsum("hqgt,htd->hqgd", pv, vr[:, a:e])
            m = m_new
        states.append((m, l, acc))
    return _merge(states)


def ragged_split_mirror(ops, splits, span):
    """f32 mirror of the kernel's attention-then-combine arithmetic; returns
    the output [T, Hkv, G, D], the rows that split as (row, spans, width),
    and the count of empty (span, live query, head) states (l = 0)."""
    t, _hkv, g, _d = ops["q"].shape
    out = torch.zeros(t, HKV, g, D)
    split_rows, empty = [], 0
    for blk in range(t // RAGGED_QB):
        r = int(ops["block_rows"][blk])
        if r < 0:
            continue
        q0 = int(ops["block_q0"][blk])
        row_len, kv_len = int(ops["row_lens"][r]), int(ops["kv_lens"][r])
        n_spans, width = _row_split(ops, r, blk, splits, span)
        if n_spans > 1:
            bound = min(kv_len, CAPACITY)
            states = [_cta_state(ops, blk, r, s * width, min(s * width + width, bound), bound)
                      for s in range(n_spans)]
            split_rows.append((r, n_spans, width))
            live = q0 + torch.arange(RAGGED_QB) < row_len
            empty += sum(int((l[:, live] == 0).sum()) for _m, l, _a in states)
        elif q0 < row_len:
            bound = max(0, min(kv_len, kv_len - row_len + q0 + RAGGED_QB, CAPACITY))
            states = [_cta_state(ops, blk, r, 0, bound, bound)]
        else:
            continue
        _m, l_sum, acc = _merge_online(states) if n_spans > 1 else states[0]
        o = torch.where(l_sum[..., None] > 0,
                        acc / torch.where(l_sum > 0, l_sum, 1.0)[..., None], 0.0)
        out[blk * RAGGED_QB:(blk + 1) * RAGGED_QB] = o.permute(1, 0, 2, 3)
    return out, split_rows, empty


_ARGS = ("q", "k", "v", "table", "kv_lens", "starts", "row_lens")


def _reference(ops, reference):
    if reference == "plain":
        t = {k: (None if x is None else torch.from_numpy(np.ascontiguousarray(x)))
             for k, x in ops.items()}
        return ragged_paged_attention_ref(*(t[k] for k in _ARGS), k_scale=t["ks"],
                                          v_scale=t["vs"], tree_anc=t["tree"]).numpy()
    j = {k: (None if x is None else jnp.asarray(x)) for k, x in ops.items()}
    if reference == "xla":
        ref = ragged_paged_attention_xla(*(j[k] for k in _ARGS), j["ks"], j["vs"], j["tree"])
    else:
        ref = jax_ragged_paged_attention(
            *(j[k] for k in _ARGS), block_rows=j["block_rows"], block_q0=j["block_q0"],
            k_scale=j["ks"], v_scale=j["vs"], tree_anc=j["tree"], pages_per_block=2,
            q_block=RAGGED_QB, interpret=True)
    return np.asarray(ref)


@pytest.mark.parametrize("reference", ["plain", "xla", "pallas_interpret"])
@pytest.mark.parametrize("g,topology", [(1, None), (4, "forest"), (4, None), (8, "dead_nodes")])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16_values", "int8"])
def test_split_combine_mirror_matches_references(quant, g, topology, reference):
    ops = _operands(np.random.default_rng(40 + g + 10 * quant), g=g, quant=quant,
                    topology=topology)
    t = ops["q"].shape[0]
    splits, span = ragged_split_plan(t, len(ROWS), HKV, PP, P)
    assert (splits, span) == (5, SPAN)
    out, split_rows, empty = ragged_split_mirror(ops, splits, span)
    # every row of 1..8 queries whose keys exceed 3 spans (the chunk's 96
    # keys are fewer) splits into spans of 256; shorter ones, the 9-query
    # row and the chunk do not
    assert [r for r, _n, _w in split_rows] == [7, 8, 9, 10, 11, 12, 13, 14]
    assert {w for _r, _n, w in split_rows} == {SPAN}
    assert empty > 0  # the verify row at kv 3 span + 1: queries 0-3 in span 3
    owned = np.zeros(t, bool)
    for s, n in zip(ops["starts"], ops["row_lens"]):
        owned[s:s + n] = True
    assert torch.equal(out[~owned], torch.zeros_like(out[~owned]))  # dead queries, pads
    np.testing.assert_allclose(out.numpy(), _reference(ops, reference), **TOL,
                               err_msg=fp_environment())


@pytest.mark.parametrize("quant", [False, True], ids=["bf16_values", "int8"])
def test_chain_tree_leaves_the_mirror_bitwise_unchanged(quant):
    """A chain topology masks nothing the causal bound does not: the split
    plan and every sum's order are the plain launch's, so its output is the
    plain launch's bit for bit (as the card's chain check requires)."""
    plain = _operands(np.random.default_rng(7), g=4, quant=quant)
    chain = _operands(np.random.default_rng(7), g=4, quant=quant, topology="chain")
    t = plain["q"].shape[0]
    splits, span = ragged_split_plan(t, len(ROWS), HKV, PP, P)
    assert torch.equal(ragged_split_mirror(chain, splits, span)[0],
                       ragged_split_mirror(plain, splits, span)[0])


@pytest.mark.parametrize("reference", ["plain", "xla"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16_values", "int8"])
def test_many_long_rows_take_fewer_wider_spans(quant, reference):
    """16 rows at the capacity: the CTA cap gives each 4 spans of 320 tokens
    (the last 80), not 5 of 256; the mirror still matches the references."""
    ops = _operands(np.random.default_rng(5 + quant), g=4, quant=quant, rows=LONG_ROWS)
    t = ops["q"].shape[0]
    splits, span = ragged_split_plan(t, len(LONG_ROWS), HKV, PP, P)
    out, split_rows, _empty = ragged_split_mirror(ops, splits, span)
    assert split_rows == [(r, 4, 320) for r in range(len(LONG_ROWS))]
    np.testing.assert_allclose(out.numpy(), _reference(ops, reference), **TOL)
