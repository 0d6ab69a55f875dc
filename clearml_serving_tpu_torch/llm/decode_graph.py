"""One fused decode chunk: the plain function, and its CUDA graphs.

Counterpart of the reference's ``_decode_paged_chunk_jit``
(``clearml_serving_tpu/llm/engine.py:2121-2128``): ``decode_steps`` times
``decode_paged`` (the paged attention kernel once per layer) and sampling,
over the whole slot batch, each step feeding its sampled tokens to the next.
The JAX engine runs it as one compiled program; on the card the port
captures it once per variant into a ``torch.cuda.CUDAGraph`` and replays
it, so a chunk costs one launch from Python instead of ~1000.

A chunk's host inputs travel in two packed buffers, one int32 and one
float32 (``ChunkLayout``), so one upload per dtype fills them all:

- the page table, the lengths before the chunk, each step's write page and
  offset (the host allocates the chunk's pages ahead);
- the per-slot sampling parameters;
- the chain merge: the token input is the previous chunk's last token,
  kept on the device (``chain``), except where the host overrides it with
  a fresh admission's first token (the reference's ``_merge_rows``).

The Gumbel noise of a sampled chunk is drawn outside, from the engine's
generator, and passed in: draws made inside a graph would repeat on every
replay. A greedy chunk draws nothing (``noise`` None).

Graphs read their inputs from static buffers and write the KV pools (and
the int8 scale pools) by address: ``PagedKVCache`` allocates them once and
never reallocates them. A graph's own allocations (activations, the
kernels' workspaces, the output tokens) live in its private memory pool for
the graph's lifetime.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..ops.fused_matmul import fused_int4_matmul
from ..ops.paged_attention import paged_attention
from .sampling import SamplingParams, sample_tokens

# the kernels a chunk launches, whose ``launches`` counts a replay adds to
COUNTED_KERNELS = (paged_attention, fused_int4_matmul)


def decode_chunk(model, cache, tokens, page_table, lengths0, write_pages, write_offsets,
                 sampling: SamplingParams, noise: Optional[torch.Tensor],
                 steps: int) -> torch.Tensor:
    """``steps`` fused decode steps over the slot batch: tokens [B] ->
    sampled tokens [B, steps] int32. Step i attends over ``lengths0 + i``
    tokens and writes its K/V at ``write_pages[:, i]``/``write_offsets[:,
    i]`` (rows the chunk skips write the null page 0). ``noise`` [steps, B,
    V] holds each step's Gumbel draws; None means every row is greedy."""
    scale_kw = ({"k_scales": cache.k_scale, "v_scales": cache.v_scale}
                if cache.kv_quant else {})
    tokens = tokens.long()
    out = []
    for step in range(steps):
        logits = model.decode_paged(
            tokens, cache.k, cache.v, page_table, lengths0 + step,
            write_pages[:, step], write_offsets[:, step], **scale_kw,
        )
        sampled = sample_tokens(logits, sampling,
                                noise=None if noise is None else noise[step],
                                all_greedy=noise is None)
        out.append(sampled)
        tokens = sampled.long()
    return torch.stack(out, dim=1)


class ChunkLayout:
    """Where each host input of a chunk sits in the packed int32 and
    float32 buffers. ``views`` cuts either a numpy array or a tensor."""

    def __init__(self, batch: int, pages_per_seq: int, steps: int):
        b, n = batch, steps
        self.i32 = (("page_table", (b, pages_per_seq)), ("lengths0", (b,)),
                    ("write_pages", (b, n)), ("write_offsets", (b, n)), ("top_k", (b,)),
                    ("override_tokens", (b,)), ("override_mask", (b,)))
        self.f32 = (("temperature", (b,)), ("top_p", (b,)))
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


def run_chunk(model, cache, views, chain: torch.Tensor, noise: Optional[torch.Tensor],
              steps: int) -> torch.Tensor:
    """``decode_chunk`` over the inputs of ``ChunkLayout.views``: the token
    input is ``chain`` where the host does not override it."""
    tokens = torch.where(views["override_mask"] != 0, views["override_tokens"], chain)
    sampling = SamplingParams(temperature=views["temperature"], top_k=views["top_k"],
                              top_p=views["top_p"])
    return decode_chunk(model, cache, tokens, views["page_table"], views["lengths0"],
                        views["write_pages"], views["write_offsets"], sampling, noise, steps)


def _launch_counts():
    return [fn.launches for fn in COUNTED_KERNELS]


class DecodeGraphs:
    """The decode chunk captured as one CUDA graph per variant: greedy
    (every row argmax, no noise read) and sampled. The reference's chunk
    always runs all ``max_batch`` rows under an active mask, so there are
    no batch buckets.

    The kernels' ``launches`` counts keep meaning kernels run on the card:
    a capture launches nothing, so its calls (and the warm-up run before
    it, set-up work) are taken back out, and each replay adds the counts
    its capture recorded."""

    def __init__(self, model, cache, layout: ChunkLayout, steps: int):
        dev = model.device
        self.model, self.cache, self.layout, self.steps = model, cache, layout, steps
        self._i32 = torch.zeros(layout.size_i32, dtype=torch.int32, device=dev)
        self._f32 = torch.zeros(layout.size_f32, dtype=torch.float32, device=dev)
        self.views = layout.views(self._i32, self._f32)
        b = self.views["lengths0"].shape[0]
        # the device-resident token chain: the last sampled token of the
        # newest chunk, written by each replay's epilogue
        self.chain = torch.zeros(b, dtype=torch.int32, device=dev)
        self.noise = torch.zeros((steps, b, model.vocab_size), dtype=torch.float32, device=dev)
        # greedy -> (graph, static output [B, steps], launches per replay)
        self._graphs: Dict[bool, tuple] = {}

    def captured(self, greedy: bool) -> bool:
        return greedy in self._graphs

    def _run(self, greedy: bool) -> torch.Tensor:
        return run_chunk(self.model, self.cache, self.views, self.chain,
                         None if greedy else self.noise, self.steps)

    def capture(self, greedy: bool, capture_error_mode: str = "global") -> None:
        """Capture one variant. Called on the engine's stream with no chunk
        of this engine in flight on another; ``"thread_local"`` lets other
        threads keep using the card meanwhile (a capture while serving)."""
        dev = self.model.device
        stream = torch.cuda.current_stream(dev)
        # null coordinates: the warm-up run writes only the null page
        for name in ("page_table", "lengths0", "write_pages", "write_offsets"):
            self.views[name].zero_()
        before = _launch_counts()
        # one eager run first, on a side stream: kernel loads, library
        # handles and workspaces are set up outside the capture
        side = torch.cuda.Stream(dev)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self._run(greedy)
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        start = _launch_counts()
        with torch.cuda.graph(graph, capture_error_mode=capture_error_mode):
            out = self._run(greedy)
        per_replay = [a - b for a, b in zip(_launch_counts(), start)]
        for fn, count in zip(COUNTED_KERNELS, before):
            fn.launches = count
        self._graphs[greedy] = (graph, out, per_replay)

    def replay(self, greedy: bool, host_i32: torch.Tensor, host_f32: torch.Tensor,
               noise: Optional[torch.Tensor]) -> torch.Tensor:
        """Upload a chunk's packed host inputs (pinned, so the copies are
        asynchronous; the caching host allocator keeps each buffer until
        its copy has run), replay the variant on the current stream and
        advance the chain. Returns the static output [B, steps]: the next
        replay overwrites it, so the caller copies it out on this stream
        first."""
        graph, out, per_replay = self._graphs[greedy]
        self._i32.copy_(host_i32, non_blocking=True)
        self._f32.copy_(host_f32, non_blocking=True)
        if not greedy:
            self.noise.copy_(noise)
        graph.replay()
        for fn, count in zip(COUNTED_KERNELS, per_replay):
            fn.launches += count
        self.chain.copy_(out[:, -1])
        return out
