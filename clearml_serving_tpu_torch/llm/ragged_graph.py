"""One ragged launch: the plain function over staged buffers, and its CUDA graphs.

Counterpart of the reference's ragged program (``_ragged_paged_step``,
``clearml_serving_tpu/llm/engine.py:2278``, jitted at ``:2426``) and of
its warmup (``warm_ragged_variants``, ``clearml_serving_tpu/llm/warmup.py:197``).
A ragged step is one function of fixed shapes (``run_ragged``):

- ``forward_ragged`` over the flat token axis of ``_ragged_tpad`` tokens
  (the ragged attention kernel once per layer; verify rows gather their
  per-position logits, tree rows masked by ``tree_anc``);
- the verify rows' acceptance and the tree rows' KV path compaction, over
  all ``B`` rows (a row that does not verify keeps its identity map, and
  every non-move writes the null page 0, the reference's fixed-shape form);
- the plain decode rows' sampling (grammar mask, penalties, histogram,
  DFA advance, logprobs, as the decode chunk's body);
- ``S - 1`` chained ``decode_paged`` steps of the rows whose window is
  still open (the paged attention kernel once per layer each).

It writes its results into tensors of fixed shapes: the sampled tokens
``[S, B]``, the rows' last-token logits ``[B, V]``, the verify rows'
tokens and acceptance, the logprobs and the DFA states. The eager path
(the CPU, ``cuda_graphs`` off) and the capture run this same function, so
a graph replay and an eager step compute the same launches on the same
values.

A step's host inputs travel in two packed buffers, one int32 and one
float32 (``RaggedLayout``), filled on the host after the page allocation
and uploaded in one copy each, as the decode chunk's ``ChunkLayout``.
The random draws (the plain rows' Gumbel noise ``[S, B, V]``, the verify
rows' acceptance uniforms ``[B, K]`` and fallback noise ``[B, K+1, V]``)
are drawn outside, from the engine's generator, by ``ragged_draws``, for
the graphed and the eager step alike: draws made inside a graph would
repeat at every replay. A seeded row draws inside, from its seed and
counter.

``RaggedGraphs`` keys its graphs by ``RaggedVariant``: the window
``steps``, the verify kind (none, chain or tree), whether a verify row
samples, whether every plain row is greedy, the extras (and a seeded
row), the logprobs and the guided state bucket. The plain keys (no
extras, logprobs or grammar) are the ones ``warmup: full`` captures; the
others are captured at their first use. All the variants of an engine
share one private memory pool: they replay one after another on the
engine's step thread, and each replay's outputs are read before the next
one runs, so a later capture may reuse the temporaries of an earlier one.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..ops.fused_matmul import fused_int4_matmul
from ..ops.paged_attention import paged_attention, ragged_paged_attention
from .decode_graph import _extras_fields, _on_capture_thread, add_replay_counts, capture_graph
from .sampling import (
    SamplingExtras,
    SamplingParams,
    greedy_tree_walk,
    guided_advance,
    guided_mask,
    gumbel_noise,
    logprobs_of,
    penalize_logits,
    sample_penalized,
    speculative_sample_chain,
    speculative_sample_tree,
)

# (wrapper, count) pairs a ragged launch adds to, each replay by what its
# capture recorded
COUNTED = ((ragged_paged_attention, "launches"), (ragged_paged_attention, "tree_launches"),
           (paged_attention, "launches"), (fused_int4_matmul, "launches"))


class RaggedVariant(NamedTuple):
    """One compiled shape of the ragged launch: the window ``steps`` (a
    power of two), the ``verify`` rows' kind ("", "chain" or "tree"),
    whether a verify row samples (``sampled_verify``), whether every plain
    row is greedy, the extras (``seeded``: a sampled plain row carries a
    seed), the logprobs and the guided state bucket (0: no guided row)."""

    steps: int = 1
    verify: str = ""
    sampled_verify: bool = False
    greedy: bool = True
    extras: bool = False
    seeded: bool = False
    lp: bool = False
    guided: int = 0

    def label(self) -> str:
        parts = ["ragged", "q{}".format(self.steps), "greedy" if self.greedy else "sampled"]
        if self.verify:
            parts.append(self.verify + ("-sampled" if self.sampled_verify else ""))
        parts += [name for name, on in (("extras", self.extras), ("seeded", self.seeded),
                                        ("logprobs", self.lp)) if on]
        if self.guided:
            parts.append("guided{}".format(self.guided))
        return "+".join(parts)


def plain_variants(steps_cap: int, verify: str):
    """The keys ``warmup: full`` captures: every window up to ``steps_cap``
    × no verify row or the engine's verify kind with greedy or sampled
    verify rows × every plain row greedy or not (the reference's
    ``warm_ragged_variants`` sweep of windows × spec rows)."""
    windows = []
    p = 1
    while p <= steps_cap:
        windows.append(p)
        p *= 2
    kinds = [("", False)] + ([(verify, False), (verify, True)] if verify else [])
    return [RaggedVariant(steps=s, verify=kind, sampled_verify=sv, greedy=greedy)
            for s in windows for kind, sv in kinds for greedy in (True, False)]


class RaggedLayout:
    """Where each host input of a ragged launch sits in the packed int32
    and float32 buffers (``views`` cuts a numpy array or a tensor), for an
    engine of ``batch`` rows, a flat axis of ``tpad`` tokens in q blocks of
    ``qb``, ``pages_per_seq`` table pages, windows up to ``steps_cap`` and
    ``spec_k`` drafts. Booleans travel as int32."""

    def __init__(self, batch: int, tpad: int, qb: int, pages_per_seq: int, steps_cap: int,
                 spec_k: int):
        b, t, k1, c = batch, tpad, spec_k + 1, max(0, steps_cap - 1)
        self.batch, self.tpad, self.spec_k, self.steps_cap = b, t, spec_k, steps_cap
        ex_i32, ex_f32 = _extras_fields(b)
        self.i32 = (
            # the flat token axis
            ("tokens", (t,)), ("tok_pos", (t,)), ("tok_row", (t,)), ("tok_valid", (t,)),
            ("write_page", (t,)), ("write_offset", (t,)),
            ("block_rows", (t // qb,)), ("block_q0", (t // qb,)),
            # the rows
            ("row_last", (b,)), ("row_starts", (b,)), ("row_lens", (b,)), ("kv_lens", (b,)),
            ("page_table", (b, pages_per_seq)),
            # the chained steps' write coordinates and window mask
            ("chain_wp", (c, b)), ("chain_wo", (c, b)), ("chain_mask", (c, b)),
            # verify rows
            ("spec_mask", (b,)), ("sspec_mask", (b,)), ("drafts", (b, spec_k)),
            ("row_logit_idx", (b, k1)), ("tree_tokens", (b, k1)), ("tree_parents", (b, k1)),
            ("tree_n", (b,)), ("tree_anc", (t, k1)),
            # sampling and grammar
            ("top_k", (b,)), ("gstate", (b,)),
        ) + ex_i32
        self.f32 = (("temperature", (b,)), ("top_p", (b,))) + ex_f32
        self.size_i32 = sum(int(np.prod(shape)) for _, shape in self.i32)
        self.size_f32 = sum(int(np.prod(shape)) for _, shape in self.f32)

    def views(self, buf_i32, buf_f32) -> Dict[str, object]:
        out = {}
        for fields, buf in ((self.i32, buf_i32), (self.f32, buf_f32)):
            off = 0
            for name, shape in fields:
                size = int(np.prod(shape))
                out[name] = buf[off:off + size].reshape(shape)
                off += size
        return out

    def fill_null(self, v: Dict[str, object]) -> None:
        """A launch with no row: every write at the null page 0, no q
        block owned, tree tokens plain causal, unit sampling parameters,
        no seed, no grammar state."""
        for name, _shape in self.i32 + self.f32:
            v[name][...] = 0
        v["block_rows"][...] = -1
        v["tree_anc"][...] = -1
        v["tree_anc"][:, 0] = -2
        v["tree_parents"][...] = np.arange(-1, self.spec_k)
        v["tree_n"][...] = self.spec_k + 1
        for name in ("top_p", "repetition"):
            v[name][...] = 1
        for name in ("seeds", "gstate", "stop"):
            v[name][...] = -1

    def stage(self, arrays: Dict[str, Optional[np.ndarray]], pin: bool):
        """Fresh host buffers (``pin``: page-locked, so the uploads are
        asynchronous) holding ``arrays`` by name over the null launch; an
        absent or None entry keeps its null value, and the chained fields
        take the leading rows of a window below the cap. Returns
        ``(host_i32, host_f32)``."""
        host_i32 = torch.empty(self.size_i32, dtype=torch.int32, pin_memory=pin)
        host_f32 = torch.empty(self.size_f32, dtype=torch.float32, pin_memory=pin)
        v = self.views(host_i32.numpy(), host_f32.numpy())
        self.fill_null(v)
        for name, value in arrays.items():
            if value is None or name not in v:
                continue
            value = np.asarray(value)
            if value.size == 0:
                continue
            dst = v[name]
            if value.shape != dst.shape:
                dst = dst[tuple(slice(0, n) for n in value.shape)]
            dst[...] = value
        return host_i32, host_f32


def ragged_draws(variant: RaggedVariant, batch: int, vocab: int, spec_k: int,
                 generator: Optional[torch.Generator], device) -> dict:
    """The random draws of one launch, in this order: the verify rows'
    acceptance uniforms [B, K] and fallback noise [B, K+1, V] (a sampled
    verify row), then the plain rows' Gumbel noise [S, B, V] (a sampled
    plain row). Keys without sampled rows draw nothing."""
    shapes = {}
    if variant.sampled_verify:
        shapes["spec_uniform"] = (batch, spec_k)
        shapes["spec_noise"] = (batch, spec_k + 1, vocab)
    if not variant.greedy:
        shapes["noise"] = (variant.steps, batch, vocab)
    out = {}
    for name, shape in shapes.items():
        out[name] = (torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
                     if name == "spec_uniform" else gumbel_noise(shape, generator, device))
    return out


def _sample(logits, sampling, variant, extras, counts, pmask, mask, step: int, noise, lp_k,
            guided, gstate):
    """One sampling step of the plain rows (the chunk body's order): the
    grammar mask of the DFA states ``gstate``, the penalized sample with the
    seed counters offset by ``step``, the histogram and the states advanced
    for ``mask``'s rows, the step's logprobs. Returns (tokens, logprobs or
    None, states)."""
    logits = logits.float()
    if guided is not None:
        logits = guided_mask(logits, gstate, guided[0])
    lp_src = logits
    if extras is not None:
        ex = extras._replace(counters=extras.counters + step)
        lp_src = penalize_logits(logits, ex, counts, pmask)
        tok = sample_penalized(lp_src, sampling, noise=noise, all_greedy=variant.greedy,
                               extras=ex)
        counts.scatter_add_(1, tok.long()[:, None], mask.to(torch.int32)[:, None])
    else:
        tok = sample_penalized(logits, sampling, noise=noise, all_greedy=variant.greedy)
    if guided is not None:
        gstate = guided_advance(gstate, tok, mask, *guided[1:])
    return tok, (logprobs_of(lp_src, tok, lp_k) if variant.lp else None), gstate


def spec_accept(variant: RaggedVariant, views, spec_logits, sampling, draws):
    """Draft acceptance of the verify rows over their per-position logits
    [B, K+1, V] (the reference's ``_spec_accept``): greedy rows the
    argmax-match chain (or the longest greedy tree path), sampled rows the
    rejection-sampled chain (or tree) from ``draws``. Returns (g [B, K+1],
    acc [B], nodes [B, K+1] or None on chain engines); rows that do not
    verify accept nothing and keep the identity node map."""
    spec_sel, sspec_sel = views["spec_mask"] != 0, views["sspec_mask"] != 0
    sl = spec_logits.float()
    zeros = torch.zeros(sl.shape[0], dtype=torch.int32, device=sl.device)
    sampled = ({"uniform": draws["spec_uniform"], "noise": draws["spec_noise"]}
               if variant.sampled_verify else None)
    if variant.verify == "tree":
        t_tok, t_par, t_n = views["tree_tokens"], views["tree_parents"], views["tree_n"]
        g, acc_g, nodes = greedy_tree_walk(torch.argmax(sl, dim=-1).to(torch.int32),
                                           t_tok, t_par, t_n)
        acc = torch.where(spec_sel, acc_g, zeros)
        if sampled is not None:
            g_s, acc_s, nodes_s = speculative_sample_tree(sl, t_tok, t_par, t_n, sampling,
                                                          **sampled)
            g = torch.where(sspec_sel[:, None], g_s, g)
            acc = torch.where(sspec_sel, acc_s, acc)
            nodes = torch.where(sspec_sel[:, None], nodes_s, nodes)
        ident = torch.arange(nodes.shape[1], dtype=torch.int32, device=sl.device)
        nodes = torch.where((spec_sel | sspec_sel)[:, None], nodes, ident)
        return g, acc, nodes
    drafts = views["drafts"]
    k_ = drafts.shape[1]
    g = torch.argmax(sl, dim=-1).to(torch.int32)                       # [B, K+1]
    acc_g = torch.cumprod((drafts == g[:, :k_]).to(torch.int32), dim=1).sum(dim=1)
    acc = torch.where(spec_sel, acc_g.to(torch.int32), zeros)
    if sampled is not None:
        g_s, acc_s = speculative_sample_chain(sl, drafts, sampling, **sampled)
        g = torch.where(sspec_sel[:, None], g_s, g)
        acc = torch.where(sspec_sel, acc_s, acc)
    return g, acc, None


def compact_tree_kv(cache, views, nodes: torch.Tensor) -> None:
    """KV path compaction of the tree verify rows over all B rows (the
    reference's fixed-shape form): each accepted node's just-written K/V
    (and int8 scales) is rewritten at its path depth, so the retire's
    truncation to pre + 1 + acc keeps a contiguous prefix, as a chain
    row's. Non-moves, and every row that does not verify, write the null
    page 0. The flat indices clamp into the axis, as JAX's gather does;
    the sources are gathered into a new tensor before the scatter."""
    wp, wo = views["write_page"].long(), views["write_offset"].long()
    t = wp.shape[0]
    n = nodes.shape[1]
    pos = torch.arange(1, n, device=nodes.device)[None, :]
    starts = views["row_starts"].long()[:, None]
    src = (starts + nodes[:, 1:].long()).reshape(-1).clamp(0, t - 1)
    dst = (starts + pos).reshape(-1).clamp(0, t - 1)
    spec_any = (views["spec_mask"] != 0) | (views["sspec_mask"] != 0)
    move = (spec_any[:, None] & (nodes[:, 1:].long() != pos)).reshape(-1)
    sp, so = wp[src], wo[src]
    dp = torch.where(move, wp[dst], 0)
    do = torch.where(move, wo[dst], 0)
    pools = [cache.k, cache.v]
    if cache.kv_quant:
        pools += [cache.k_scale, cache.v_scale]
    for p in pools:
        p[:, :, dp, do] = p[:, :, sp, so]


def run_ragged(model, cache, views, variant: RaggedVariant, draws: dict, *,
               block_map: bool, state=None, tables: Optional[tuple] = None, lp_k: int = 1):
    """One ragged launch over the staged ``views`` (``RaggedLayout``):
    ``forward_ragged`` (with the q-block map where ``block_map``), the
    verify rows' acceptance and tree compaction, the plain rows' sampling
    and ``variant.steps - 1`` chained ``decode_paged`` steps at ``kv_lens
    + step``, each row's token held where its window is closed. ``draws``
    as ``ragged_draws`` gives them (zeros in a capture's warm-up run).
    ``state``: the extras' device rows (``ExtrasState``); ``tables``: the
    guided bucket's grammar tables. Returns a dict of tensors: ``sampled``
    [S, B] int32, ``logits`` [B, V] (the rows' last tokens), and as the
    variant has them ``spec_g`` [B, K+1] and ``spec_acc`` [B], ``lp``
    (chosen [S, B], top ids [S, B, k], top logprobs [S, B, k]) and
    ``gstate`` [B]."""
    scale_kw = ({"k_scales": cache.k_scale, "v_scales": cache.v_scale}
                if cache.kv_quant else {})
    kw = dict(scale_kw)
    if block_map:
        kw.update(block_rows=views["block_rows"], block_q0=views["block_q0"])
    if variant.verify:
        kw["row_logit_idx"] = views["row_logit_idx"]
    if variant.verify == "tree":
        kw["tree_anc"] = views["tree_anc"]
    page_table, kv_lens = views["page_table"], views["kv_lens"]
    out = model.forward_ragged(
        views["tokens"].long(), views["tok_pos"], views["tok_row"], views["tok_valid"],
        views["row_last"], cache.k, cache.v, page_table, kv_lens, views["row_starts"],
        views["row_lens"], views["write_page"], views["write_offset"], **kw)
    sampling = SamplingParams(temperature=views["temperature"], top_k=views["top_k"],
                              top_p=views["top_p"])
    result = {}
    if variant.verify:
        logits, spec_logits = out
        result["spec_g"], result["spec_acc"], nodes = spec_accept(
            variant, views, spec_logits, sampling, draws)
        if nodes is not None:
            compact_tree_kv(cache, views, nodes)
    else:
        logits = out
    extras = counts = pmask = None
    if variant.extras:
        extras = SamplingExtras(
            presence=views["presence"], frequency=views["frequency"],
            repetition=views["repetition"], bias=state.bias,
            seeds=views["seeds"] if variant.seeded else None, counters=views["counters"],
            min_new=views["min_new"], stop=views["stop"])
        counts, pmask = state.counts, state.pmask
    guided = tables if variant.guided else None
    gstate = views["gstate"] if variant.guided else None
    # the plain rows of the launch: the histogram and the DFA states
    # advance for them alone
    active = views["active"] != 0
    noise = draws.get("noise")

    def sample(step_logits, mask, step, gstate):
        return _sample(step_logits, sampling, variant, extras, counts, pmask, mask, step,
                       None if noise is None else noise[step], lp_k, guided, gstate)

    tok, lp, gstate = sample(logits, active, 0, gstate)
    toks, lps = [tok], [lp]
    for step in range(variant.steps - 1):
        mask = views["chain_mask"][step] != 0
        step_logits = model.decode_paged(
            tok.long(), cache.k, cache.v, page_table, kv_lens + step, views["chain_wp"][step],
            views["chain_wo"][step], **scale_kw)
        sampled, lp, gstate = sample(step_logits, mask, step + 1, gstate)
        tok = torch.where(mask, sampled, tok)
        toks.append(tok)
        lps.append(lp)
    result["sampled"] = torch.stack(toks)                             # [S, B]
    result["logits"] = logits
    if variant.lp:
        result["lp"] = tuple(torch.stack(part) for part in zip(*lps))
    if variant.guided:
        result["gstate"] = gstate
    return result


class RaggedGraphs:
    """The ragged launch captured as one CUDA graph per ``RaggedVariant``,
    all in one private memory pool, over the static input buffers of
    ``layout`` and static draw buffers, each captured by
    ``decode_graph.capture_graph`` as the decode chunk's: a replay adds the
    counts of ``COUNTED`` its capture recorded."""

    def __init__(self, model, cache, layout: RaggedLayout, *, block_map: bool, spec: bool,
                 state_fn=None, lp_k: int = 1, tables_fn=None):
        dev = model.device
        self.model, self.cache, self.layout = model, cache, layout
        self.block_map = block_map
        self._state_fn, self._tables_fn, self.lp_k = state_fn, tables_fn, int(lp_k)
        self._i32 = torch.zeros(layout.size_i32, dtype=torch.int32, device=dev)
        self._f32 = torch.zeros(layout.size_f32, dtype=torch.float32, device=dev)
        self.views = layout.views(self._i32, self._f32)
        b, v, k = layout.batch, model.vocab_size, layout.spec_k
        # the draws' static buffers (a window's noise is the leading rows)
        self.draws = {"noise": torch.zeros((layout.steps_cap, b, v), dtype=torch.float32,
                                           device=dev)}
        if spec:
            self.draws["spec_uniform"] = torch.zeros((b, k), dtype=torch.float32, device=dev)
            self.draws["spec_noise"] = torch.zeros((b, k + 1, v), dtype=torch.float32,
                                                   device=dev)
        self._pool = None
        # variant -> (graph, static outputs, counts per replay)
        self._graphs: Dict[RaggedVariant, tuple] = {}
        # variant -> the rise of the card's reserved memory inside its
        # capture: the segments the shared pool took for it
        self.pool_growth: Dict[RaggedVariant, int] = {}

    def captured(self, variant: RaggedVariant) -> bool:
        return variant in self._graphs

    def drop_guided(self, bucket: int) -> None:
        """Free the graphs of the guided variants of a grammar-table bucket
        no launch reads any more (their outputs go back to the pool)."""
        for variant in [v for v in self._graphs if v.guided == bucket]:
            del self._graphs[variant]
            self.pool_growth.pop(variant, None)

    def _draw_views(self, variant: RaggedVariant) -> dict:
        return {name: t[:variant.steps] if name == "noise" else t
                for name, t in self.draws.items()}

    def _run(self, variant: RaggedVariant):
        return run_ragged(self.model, self.cache, self.views, variant, self._draw_views(variant),
                          block_map=self.block_map,
                          state=self._state_fn() if variant.extras else None,
                          tables=self._tables_fn(variant.guided) if variant.guided else None,
                          lp_k=self.lp_k)

    def capture(self, variant: RaggedVariant, capture_error_mode: str = "global") -> None:
        """Capture one variant, on the capture thread, ordered after the
        caller's current stream (the engine's); ``"thread_local"`` lets other
        threads keep using the card meanwhile (a capture while serving)."""
        stream = torch.cuda.current_stream(self.model.device)
        _on_capture_thread(self._capture_on, variant, stream, capture_error_mode)

    def _capture_on(self, variant: RaggedVariant, stream: "torch.cuda.Stream",
                    capture_error_mode: str) -> None:
        with torch.cuda.stream(stream):
            # the null launch: the warm-up run writes only the null page
            # and adds nothing to the extras' histogram
            host_i32, host_f32 = self.layout.stage({}, pin=True)
            self._i32.copy_(host_i32, non_blocking=True)
            self._f32.copy_(host_f32, non_blocking=True)
            for t in self.draws.values():
                t.zero_()
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph, out, per_replay, grown = capture_graph(
                lambda: self._run(variant), stream, COUNTED, capture_error_mode,
                pool=self._pool)
            self.pool_growth[variant] = grown
            self._graphs[variant] = (graph, out, per_replay)

    def replay(self, variant: RaggedVariant, host_i32: torch.Tensor, host_f32: torch.Tensor,
               draws: dict) -> dict:
        """Upload a launch's packed host inputs (pinned: asynchronous
        copies) and its draws, replay the variant on the current stream and
        return its static outputs: the next replay of any variant may
        overwrite them, so the caller reads them on this stream first."""
        graph, out, per_replay = self._graphs[variant]
        self._i32.copy_(host_i32, non_blocking=True)
        self._f32.copy_(host_f32, non_blocking=True)
        dst = self._draw_views(variant)
        for name, value in draws.items():
            dst[name].copy_(value)
        graph.replay()
        add_replay_counts(COUNTED, per_replay)
        return out
