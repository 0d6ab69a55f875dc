#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (an H100 SXM).

    python3 chip_smoke.py

Drives the port (``clearml_serving_tpu_torch``) phase by phase; any failure
exits non-zero before the result lines are printed:

1. the card's name and power limit, torch / CUDA / nvcc versions;
2. builds the CUDA kernels from ``clearml_serving_tpu_torch/csrc`` (set-up
   time, printed with the compiler's register report);
3. holds the paged decode kernel (the key-range split and its combine)
   against its plain PyTorch version on the card at the main path's shapes
   (bf16 and int8 pools), and times it in CUDA-graph replays and eagerly
   at 8 rows x 1024 and x 2048 tokens and at mixed lengths, beside its
   bound, the plain version (at 8 x 1024) and, as a yardstick that reads no
   page table, SDPA over the same K/V gathered contiguous; at head_dim 256
   (Gemma-7B's heads, Hkv 16 and G 1, and Gemma-2B's, Hkv 1 and G 8; rows
   of one span and split rows), timed at 8 x 1024 on Gemma-7B's heads;
3b. the same for the ragged kernel over mixed rows (decode, prefill chunks
   at history 0 and mid-history, idle rows, multi-step pads, page-crossing
   tails; P 16/32, G 4/8, D 64/128, bf16/int8; and D 256 at both Gemmas'
   heads, with chain and forest tree rows beside them, split and not),
   timed at a mixed shape and a prefill shape, at D 128 and at Gemma-7B's
   heads;
   Then the ragged kernel's draft-tree mask (``tree_anc``): chain, forest
   and dead-node verify rows of k+1 = 5 tokens beside decode rows and a
   chunk, at phase 5d's verify launch (no chunk, no row long enough to
   split) and at the same launch with longer rows (every row's keys
   split), bf16 and int8, against the plain version (a chain must give the
   unmasked launch's bits), timed beside the same launch without the mask
   and, at the verify launches, beside it with its key-range split off;
3c. the w4a16 matmul kernel against its plain version at every Llama-3-8B
   projection shape, M 1 and 8 (the decode tiling), 64, 256 (a chunked
   prefill's segment, phase 12; not the lm_head), 312 (the ragged flat
   axis) and 2048 (the longest prefill bucket; not the lm_head, which a
   prefill runs on the last row only; all through the block tiling), two
   calls giving the same bits, timed beside its bound, the plain version, a
   bf16 ``torch.matmul`` on the dequantized weight and PyTorch's
   ``_weight_int4pack_mm``; then summed over one decode step's 225 calls
   at M = 8 and one ragged step's 224 projection calls at M = 312;
4. a small model on the card against the same weights in float32 on the CPU
   (prefill + paged decode logits, bf16 and int8 KV);
4b. the same model's ``forward_ragged`` over mixed batches;
4c. 4 and 4b again on int4 weights (the same packed codes on both sides);
4d. the same model's ``forward_ragged`` with chain and forest verify rows
   (last-token and per-position verify logits);
4e. 4 and 4b for a small model of each family of ``SMALL_FAMILIES``:
   Llama-3.1's scaled RoPE, yarn, longrope (prompts crossing its original
   window), Qwen2's QKV biases at G 7, Gemma's deltas (tied, offset norms,
   GeGLU, embed scale) at head_dim 256 with G 1 and G 8, their constant
   leaves perturbed;
5. the main path: Llama-3-8B at full width (32 layers, dim 4096, bf16,
   random weights from a seed) behind the port's HTTP server, a paged KV
   cache (max_batch 8, max_seq_len 2048, page_size 16, decode_steps 4),
   four concurrent chat completions (two streaming) with bf16 KV, then again
   with int8 KV on the same weights; every kernel of the path must have
   launched (paged attention: once per layer per decode step);
5b. the ragged main path: the same server under ``scheduler: ragged``
   (step_token_budget 256), four staggered chats with 600-1500-token
   prompts, bf16 then int8 KV: mixed launches must have run, the ragged
   kernel once per layer per ragged step, the decode kernel once per layer
   per decode step and chained ragged window step;
5c. the w4a16 main path: the same weights quantized to group-int4 on the
   card (``weight_quant: int4``, bf16 KV) under phase 5's traffic with two
   of its prompts swapped for long ones (prefill buckets 1024 and 2048),
   then phase 5b's: the int4 kernel once per projection per forward call (7
   per layer and the lm_head) and ``health()["weights"]``; then a short
   two-dispatch run on int8 weights;
5d. speculative verify rows: the same server under ``scheduler: ragged``
   with ``speculation: ngram``, ``spec_k`` 4, four staggered repetitive
   chats (one at temperature 0.7): a plain ragged arm, a chain arm, a tree
   arm (``spec_branch`` 2) on bf16 KV, a plain and a tree arm on int8 KV; verify
   rows and tree depths must show, the ragged kernel once per layer per
   ragged step, its tree variant once per layer per verify step; decode
   tokens per launch, TTFT and tokens/s per arm, and whether the greedy
   streams equal the plain arm's (reported, not asserted; where a greedy
   stream leaves the plain arm's, the top-2 logit margin at that token);
5e. pipelined decode: one decode chunk (8 rows at 0-1500 tokens, 4 steps)
   captured into a CUDA graph and replayed must equal the eager chunk on a
   clone of its pools bit for bit, tokens and pages, for bf16 and int8 KV
   and int4 weights, greedy and sampled (a replay counts n_layers x 4
   decode-attention and 225 x 4 int4 launches, a capture none); then phase
   5's traffic and a steadier one (eight chats of 64 tokens) at depth 1
   (serial, eager) and depth 2 (graphs captured by the endpoint's
   ``warmup``): equal greedy contents, no capture while serving, and each
   arm's wall ms per decode step, dispatch and retire ms and tok/s;
5f. the ragged launch as CUDA graphs, at Llama-3-8B's widths and
   ``GRAPH_LAYERS`` (8) of its 32 layers: phase 5b's traffic (bf16 and int8
   KV) and phase 5d's tree arm, each with aux ``warmup: full`` (every plain
   launch key captured before traffic) and each graphed and eager
   (``cuda_graphs: false``), then 5b's on int4 weights graphed: content
   byte-identical graphed and eager, no capture after the warmup, every
   ragged step one replay, the launch identities of 5b and 5d; ms a ragged
   step, the replays' device share of it, the host split of a step
   (``scripts/ragged_step_split.py``), capture ms and pool MiB per key;
6. where the time goes, at Llama-3-8B's widths and 8 of its 32 layers
   (``PROFILE_LAYERS``): one profiled pass of each scheduler (bf16 KV; the
   two-dispatch path at depth 2 and at depth 1; the ragged one graphed,
   its keys captured by ``warmup: full`` first), each of 5e's arms on the
   steady traffic at 64 tokens a chat, one of phase 5d's tree arm (graphed
   likewise), the ragged and tree passes again with their ragged steps
   eager beside graphed decode chunks, and one of the two-dispatch path on
   int4 weights; the graphed passes' traces must hold as many
   decode-attention, ragged-attention and int4 grids as counted;
7. the request lifecycle of the default route: Llama-3-8B at full width
   and ``LIFECYCLE_LAYERS`` (8) of its 32 layers behind the HTTP app (bf16 KV, depth 2 with graphs, max_batch 8) with the
   reference's default lifecycle knobs (max_pending 32, a 30 s watchdog,
   preemption, brownout). 8 batch-class chats at 384 tokens alone, then with
   an interactive arrival (a preemption; every batch content must equal its
   unpreempted run), then on an engine with preemption off (the
   interactive TTFT with and without preemption); 48 concurrent chats at 16
   tokens (200s and 429s, each 429 with Retry-After and ``code:
   overloaded``, beside the observed admission drain rate); a 1 ms TTFT
   budget on a 2048-bucket prompt (408) and a 1 s ``timeout`` that cuts a
   stream (an SSE error event); the drain with 4 streams in flight (new
   chats 503 ``draining``, the streams finish, every page back); on an
   engine with a 2 s watchdog, a 6 s retire stall injected while 4 chats
   have chunks in flight (503 ``engine_stalled``, /ready 503 then 200, free
   pages and the next chat's content as before the trip). The decode kernel
   once per layer per decode step of the default engine's traffic.

8. the radix prefix cache over shared, refcounted KV pages: Llama-3-8B at
   full width and ``PREFIX_LAYERS`` (8) of its 32 layers (max_batch 8, max_seq_len 2048, page_size 16) with
   ``prefix_cache`` 64, ``prefix_block`` 64, ``prefix_cache_pages`` 256 and
   the KV sanitizer armed, two-dispatch at depth 2 with graphs and ragged
   at budget 256, each on bf16 and int8 KV, and the eager two-dispatch
   bf16 arm: a 1024-token shared head with 8 tails of 40-200 tokens (the
   first chat alone, the 7 others concurrently, the first again). Hits,
   misses and hit tokens as the tree's rule gives them; every live slot of
   the concurrent wave maps the head's 64 page ids, 448 pages saved; the
   head's K/V (and scale) rows unchanged bit for bit after the wave;
   graphed = eager contents; the kernels' launches per step; every page
   back after full eviction with 0 sanitizer failures; the hit path's last
   logits (gathered pages + ``prefill_chunk``) within 5% of the cold
   prefill's. Prints TTFT and prefill time cold and hit, ragged steps per
   hit admission, pages saved and ``cow_events``.
9. the prefix cache's host-RAM tier and the ownership ledger: Llama-3-8B at
   full width (max_batch 8, max_seq_len 2048, page_size 16, ``prefix_cache``
   256, ``prefix_block`` 64), the KV sanitizer and ``TPUSERVE_LEDGER=strict``
   armed, each engine warmed up: six 1024-token heads, one chat each (a
   40-200-token tail, 16 tokens, greedy), twice. Arms: A two-dispatch at
   depth 2 with graphs, bf16 KV, ``prefix_cache_pages`` 512, no tier; B the
   same with ``prefix_cache_pages`` 128 over ``prefix_cache_host_pages``
   512 (round 1 demotes, round 2 promotes every head from host RAM); C0 and
   C the pair on int8 KV; D0 and D the pair under ``scheduler: ragged``
   (budget 256). Each tiered arm's contents equal its tierless twin's;
   every promoted page's K/V and scale rows equal a clone taken before its
   demotion; the lookups' tiers and lengths, demotions and promotions equal
   ``TIER_EXPECTED`` (the reference's cache over the same sequence, held by
   ``tests/test_torch_kv_tiering.py``); every promotion reaped by drain, 0
   sanitizer failures, no drain-zero ledger entry outstanding, no capture
   while serving, the kernels' launches per step. Prints TTFT and prefill
   time of cold admissions, HBM hits and host hits, the promotions' total
   time and overlap, a 64-page demotion and promotion (bf16, int8) beside
   a pinned-to-device and a device-to-pinned ``copy_`` of the same bytes,
   the tier's pinned allocation time and the page count ``"auto"`` picks on
   the machine.

10. the sampling surface of the OpenAI routes: Llama-3-8B at full width
   and 8 of its 32 layers (``SURFACE_LAYERS``, 16 since phase 16 joined
   the script, 8 since phase 18 did; seed-0 weights, max_batch 8, max_seq_len 2048). 10a, two-dispatch at
   depth 2 with graphs, bf16 KV: 8 concurrent ~100-token chats of 64
   tokens (four seeded sampled with penalties and ``top_logprobs`` 5, two
   greedy with ``logit_bias`` and logprobs, two plain); the four seeded
   chats again alone, at depth 1 and eager (``cuda_graphs=False``), each
   bitwise the first contents; a +100 bias forces its token at every step;
   ``min_tokens`` 16 with EOS biased to the top gives 16 tokens, then EOS;
   greedy rows' chosen logprob equals their ``top_logprobs[0]``; ``n: 4``
   with seed s equals four single requests with seeds s..s+3; ``echo`` +
   ``logprobs`` 5 + ``max_tokens: 0`` on a 2047-token prompt (its time and
   the rise of ``torch.cuda.max_memory_allocated``), and a greedy
   completion scored back within 2e-2 of the decode path's entries.
   Prints ms per decode step on 8 x 64-token chats for plain sampled,
   extras without seeds, extras with seeds and extras with seeds +
   logprobs, and each new graph variant's first-use capture time. 10b,
   ragged (budget 256), int8 KV, ``speculation: ngram`` with ``spec_tree``:
   the four seeded chats beside two repetitive greedy chats, twice, bitwise
   equal; the extras rows never ride as verify rows (one token per decode
   step) while the greedy ones do. The kernels' launches per step in both.

11. guided decoding and tool calling on the OpenAI routes, under the
   ownership ledger: Llama-3-8B at full width (seed-0 weights, the byte
   tokenizer at vocab 128256). 11a, two-dispatch at depth 2 with graphs,
   bf16 KV: 8 concurrent ~100-token chats of up to 64 tokens (two
   ``guided_regex`` compass headings, a ``guided_choice``, two
   ``json_schema`` objects with an enum, an integer and a boolean, one of
   them seeded with penalties, a ``json_object``, two plain), every one
   greedy or seeded, again at depth 1 and eager: the same tokens. Every
   guided output that stopped is a whole match of its grammar (a schema's
   object has its keys and types); one cut at ``max_tokens`` walks its
   byte DFA without dying. 11b, the same engine: ``tool_choice``
   required, forced by name (streamed and not, the same call) and auto over
   two tools with an enum and a boolean parameter; a required or forced
   call answers ``finish_reason: "tool_calls"`` with schema-valid
   arguments. Prints the host ms to compile each kind at the vocab, the
   tables' bucket and bytes, each guided variant's first-use capture time
   and ms per decode step on 8 x 64-token chats, plain sampled against
   guided in turns. 11c, ragged (budget 256), int8 KV, tree speculation,
   profiled: 11a's six guided chats beside two repetitive greedy chats; no
   guided row is ever a verify row, and the kernels' launches equal the
   counters and the trace's grids. Every grammar reference returns and
   the ledger has no drain-zero entry left at each drain.

12. the two-dispatch admission as the reference runs it: each admission
   prefills in a worker beside the decode chunks, its first token and mini
   cache committed at the next chunk boundary, the prefill gate pacing its
   dispatches. Llama-3-8B at full width and ``ADMIT_LAYERS`` (16) of its 32
   layers (seed-0 weights), two-dispatch at
   depth 2 with graphs, max_batch 8. 12a, bf16 KV, on one engine: seven
   ~100-token chats decode 256 tokens each; once all decode, a
   1536-token prompt (bucket 2048) is admitted, in three arms: the gate
   off, the default gate (2 segments per decode chunk) and the gate with
   ``chunked_prefill`` 256. Per arm: the live rows' worst and median
   emission gap inside the admission window, the admitted prompt's TTFT,
   the live rows' tok/s, the pipeline's dispatch and retire ms and the
   prefill dispatches between decode chunks (at most the budget in the
   paced arms). The live rows' greedy streams are equal in every arm; the
   chunked first-token logits within 5% of the one-dispatch prefill's.
   Then a serve-time CUDA-graph capture (a seeded chat's variant) while
   the admitted prompt prefills in 128-token segments: the capture holds,
   and the live and seeded streams are as without it. 12b, int4 weights
   with ``chunked_prefill`` 256 under 12a's traffic: every int4 launch is
   a one-dispatch prefill's 225, a segment's 224 plus one lm_head, or a
   replayed step's 225. 12c, the strict ledger and the KV sanitizer with
   the prefix cache: the admitted prompt hits a stored 1024-token head and
   prefills its 512-token tail in 8 paced segments; the drain audits are
   clean. Prints the peak of ``max_memory_allocated``. The parent's serial
   admission under 12a's traffic is measured by
   ``scripts/admission_ab.py --baseline DIR`` in the same call.

13. the control plane in front of the LLM route: the port's CLI, run in
   process on a fresh state root, creates a service, sets the file stats
   broker at metric frequency 1, adds the ``llm`` endpoint ``chat``
   (Llama-3-8B's widths at 8 of its 32 layers, ``CP_LAYERS``, as in phase
   14; bf16 weights made by the endpoint from seed
   0, paged cache with int8 KV, ``warmup: startup``, max_batch 8) and a
   ``custom`` endpoint whose preprocess code runs one torch op on the card.
   ``setup_processor()`` builds both at its launch, before the app's loop
   runs; its sync daemon polls every second. 13a: 8 concurrent ~100-token
   chats of 64 tokens (half streaming) through
   ``/serve/openai/v1/chat/completions`` and one through ``/serve/chat``:
   token ids and contents equal a directly built engine's on the same
   seed-0 weights (the direct app, timed the same way: TTFT and ms a
   decode step beside the processor's), ``paged_attention`` launches 32
   per decode step, ``serve_captures`` 0, and one broker packet per request
   with ``gen_tokens``, ``prompt_tokens`` and ``ttft``. 13b: while 4 streams
   decode on ``chat``, the CLI adds a Llama-3.2-1B-shaped endpoint
   ``chat2``; the daemon picks it up, ``chat2`` answers, and the streams end
   unbroken with the direct engine's tokens. The CLI removes ``chat2``:
   after the sync, once its requests end, its engine is stopped, and it is
   gone where the eviction's release returns (the endpoint's request still
   held, nothing collected by the script). ``torch.cuda.memory_allocated()``
   comes back within 64 MiB of its value before ``chat2``; a second
   add/remove cycle of ``chat2`` leaves it no higher than the first removal
   did (all three printed). Then a seeded chat on ``chat``
   captures its graph variant at serve time while the CLI removes the
   ``custom`` endpoint and the sync evicts it: the eviction's release waits
   for the capture (``CAPTURE_LOCK``), and the seeded stream is the direct
   engine's.

14. the replica fleet, through the CLI, the processor and its router: a
   processor launched with the single-engine endpoint ``single`` (phase
   13's Llama-3-8B block, 8 of its 32 layers, with ``prefix_cache`` 64,
   ``prefix_block`` 64);
   the CLI then adds ``fleet`` (the same block with ``replicas: 2`` and a
   2 s watchdog: one set of seed-0 weights, two ``LLMEngineCore`` replicas
   on streams of their own, each with its pool and graphs), which the
   daemon builds and warms. 14a: 4 conversations x 3 turns (each turn the
   last one's messages plus ~100 characters; 300-700 tokens; 32 tokens
   greedy), two conversations per replica by the router's math: every
   turn of a conversation runs on one replica (route ``affine``), turns 2-3
   hit that replica's cache (2 hits per conversation there, none
   elsewhere), token ids and contents equal ``single``'s on the same
   messages, ``paged_attention`` once per layer per decode step of the two
   replicas, no capture while serving; the second replica's rise in
   ``memory_allocated`` (the fleet's rise less the single endpoint's) under
   8 GB; ``/ready`` shows both ring members; ``generate_latest`` in the
   process shows the lifecycle families with ``replica="r0"`` and
   ``"r1"``, ``router_replicas`` 2 and ``tpu_hbm_bytes_in_use{device="0"}``.
   14b: 4 greedy streams of 128 tokens, two per replica; a 5 s retire stall
   (``engine.decode.stall``) on r1 mid-stream trips its watchdog; both its
   streams resume on r0: every status 200, no error event, each stream
   ends at 128 tokens, the tokens before the trip kept and none repeated,
   each continuation a fresh request's on r0 with the history as its
   prompt; r1 re-warms through its gate and rejoins the ring (the seconds
   to resume and to rejoin printed). The CLI removes ``fleet``: its group
   and both engines are gone where the release returns, the registry
   holds no entry for them, ``memory_allocated`` is back within 64 MiB;
   added, warmed and removed a second time, it leaves ``memory_allocated``
   where the first removal did (+0 B).
   14c: ``replica_roles: [prefill, decode]``, under ``two_dispatch`` and
   under ``ragged`` at budget 256 (endpoints added and removed in turn):
   2 chats with ~1024-token prompts x 32 tokens, one after the other (a
   ragged launch's rows depend on what else rides it): the prefill replica ships
   both prefixes (draft-ahead partial frames under ``ragged``), no drop,
   the decode replica hits both; the shipped rows, the prefill replica's
   pages and the decode replica's imported pages hold the same bits; the
   decode replica's streams equal a hit on the prefill replica at the
   same prefix length. The prefill replica is then given the same two
   chats directly, at once, and where that differs from one after the
   other is printed (what rides beside a row, on a monolithic engine).
   Two new chats at once through the fleet: every status 200 and 32
   tokens, both ship and hit, bitwise pages, nothing dropped. Prints ship
   ms (the prefill replica's loop stall), receive ms, TTFT beside
   ``single``'s cold TTFT and where the stream first differs from the cold
   monolithic one. The two-dispatch arm's removal leaves no more
   ``memory_allocated`` than the fleet's did (the same streams and
   threads); the ragged arm is added, warmed and removed a second time,
   +0 B against its first removal.

15. the process fleet, through the CLI, the processor and its router: a
   processor launched with ``single`` (phase 14's block, 8 of Llama-3-8B's
   32 layers since phase 16 joined the script; all 32 before); the CLI adds
   ``fleet``, the same block with ``replicas: 2`` and ``replica_backend:
   process``: two worker processes (``serving/process_replica.py``), each
   drawing the seed-0 weights on its own CUDA context, with its own pool
   and graphs, booting at once and warming at once; this process holds no
   weight of theirs (its ``memory_allocated`` rises by less than 64 MiB).
   15a: 4 conversations x 2 turns (32 tokens greedy, half streamed), two
   per worker: each conversation on one worker, its second turn a hit
   there, token ids and contents equal ``single``'s; each worker's kernel
   launches (read from it) once per layer per decode step; ``nvidia-smi``
   lists two compute processes more (on the card's machine a row per
   process, each with pid 1 and the container's summed memory) and the
   card's bytes in use (``mem_get_info``) rise by at least what the
   workers reserved; ``/ready`` and
   ``/health`` carry both ring members with their ``process`` blocks;
   ``generate_latest`` the lifecycle families of ``r0`` and ``r1`` and the
   ``process`` backend; no restart without a fault; ms a decode step per
   worker and the longest heartbeat. 15b: 4 greedy streams x 128 tokens,
   two per worker; ``replica.proc.crash`` SIGKILLs worker r1 mid-stream:
   every status 200, each stream at 128 tokens, the tokens before the kill
   kept and none repeated, each continuation a fresh request's (the
   history as its prompt) on the restarted r1; r1 comes back as a new
   process (as many ``nvidia-smi`` rows and bytes in use as before the
   kill: the old process and its memory are gone), re-warms through its gate
   and rejoins the ring (the seconds to resume, respawn, warm and rejoin).
   The CLI removes ``fleet``: the group and its proxies gone where the
   release returns, no registry entry, every worker gone within 30 s,
   ``nvidia-smi``'s rows back to their count before the fleet and the
   bytes in use within 2 GiB of theirs, the fleet's directory removed.
   15c: ``replica_roles:
   [prefill, decode]`` over the socket KV wire, two-dispatch then ragged at
   budget 256: 2 chats of ~1024-token prompts x 32 tokens one after the
   other: both ship (partial frames under ragged) and hit, no drop, no wire
   error; the decode worker's streams equal a hit on the prefill worker;
   ship ms, frame bytes, the send's round trip, receive ms and TTFT beside
   ``single``'s cold TTFT; each arm removed as ``fleet`` was.

16. the model families of the paged path behind the HTTP server, through
   the processor, random weights from seed 0: Llama-3.1-8B (phase 5's
   weights with its published ``rope_scaling``, llama3 factor 8) at all 32
   layers, two-dispatch on bf16 and int8 KV, ragged, and int4 weights;
   Qwen2.5-7B (QKV biases, G 7) at full width and ``FAMILY_LAYERS`` (8) of
   its 28 layers on bf16 and int4 weights; Gemma-7B (head_dim 256, tied,
   offset norms, GeGLU, embed scale) at full width and 8 of 28 layers on
   both schedulers with bf16 and int8 KV. Phase 5's and 5b's traffic; each
   arm's counts zeroed before it and read after: the decode kernel once per
   layer per decode step, the ragged kernel once per layer per ragged step,
   the int4 kernel once per projection per forward call (no lm_head when
   tied); TTFT and ms a decode step beside the weights' byte bound.
17. the ``jax`` engine type behind the processor, every payload written on
   the card from seed-0 weights into the processor's registry: the iris MLP
   (in 4, hidden [64, 64], out 3; the default buckets), the MNIST CNN at
   the example's endpoint spec, buckets [1, 4, 16, 64] and preprocess.py
   as a bundle, a GraphDef and a TorchScript file, BERT-base at full width
   (bf16, 9 labels, sequence 128, int32 ids, the default buckets) and the
   same module exported to ONNX on the card (float32, int64 ids) through
   the ONNX importer. Each bucket POSTed through the router once (one
   capture per key, no fallback), then per key: the replay's and the eager
   run's ms, bitwise equal; capture ms and pool MiB; the bound (2 x the
   multiplying parameters x tokens, BERT's attention products beside them,
   over the dtype's peak; or the weights' bytes); the largest gap to the
   CPU float32 model relative to its largest logit (5% for bf16 BERT at
   buckets 1 and 2, 1e-3 for the float32 models, TF32 off); the ONNX
   logits within 5% of the native bundle's. Then a Llama-3-8B bundle at
   full width (its embedding and lm_head chunked) cut to 8 of 32 layers,
   written into a registry and served on an ``llm`` endpoint under both
   schedulers: greedy content and token ids byte-identical to the same
   seed's preset engine; its bytes and the seconds to write and to load.
18. BERT's two routes, BERT-base at full width (bf16, 9 labels) on seed
   weights. 18a: the BERT example's topology: two bundles written (seeds 0
   and 1), registered by the port's CLI (``model upload --framework jax``,
   ``model add --engine jax_grpc`` with ``input_ids``/``attention_mask``
   int32 ``[128]`` and ``batching.preferred_batch_size=16``,
   ``batching.max_queue_delay_us=5000``); ``tpu-serving-torch-engine``
   started as its own process on the card, this process the router
   (``build_app``) over loopback gRPC; 256 one-row requests (real lengths
   16-128 from a seed) at concurrency 1, 8, 32 and 64: requests a second,
   p50 and p99, batches, rows a batch and padded rows from ``Status`` and
   the sidecar's ``engine_batch_rows_total``, the queue-delay histogram; a
   capture only at a key's first batch, no eager batch; every answer
   within 2e-2 of the port's ``jax`` endpoint on the same bundle, bitwise
   at concurrency 1 (bucket 1 on both). 18b: the CLI repoints the endpoint
   at the second bundle under concurrency-32 traffic; no request fails,
   the seconds to the first answer of the new version, the server's
   ``memory_allocated`` back within 64 MiB of its level before the swap
   once the old model is released. 18c: SIGKILL of the server under
   traffic: only 200s and 503s (after the client's retries), the seconds
   from the restart to the first answer. 18d: an ``llm`` endpoint with
   ``task: embed`` over the same preset: the five encoder routes on texts
   of 16-512 byte-tokenizer ids, a chat refused with 422; per (function,
   batch, seq) key the replay and eager ms, capture ms and pool; the
   embeddings and classify logits within 5% of the CPU float32 port on the
   same weights.
19. Whisper's audio routes, Whisper-large-v3 at full width (openai's
   published config: d_model 1280, 32 + 32 layers, 20 heads, ffn 5120, 128
   mels, vocab 51866, 1500 and 448 positions; bf16, seed-0 weights with the
   embedding's rows from 256 to EOS zeroed so the byte tokenizer renders the
   text), its prompt and timestamp ids in large-v3's layout, written with
   the port's ``save_bundle`` and served as an ``llm`` endpoint
   (``decode_steps`` 16, ``max_tokens`` 224) through the processor and
   ``build_app``. 19a: at 2 + 2 layers of the same widths, the card's
   float32 model gives encoder states and teacher-forced decode logits
   within 1e-3 of the CPU's float32 model (TF32 off) and the bf16 model
   within 5%, on the same mel input and filters. 19b: the endpoint's core
   captures its 12 graphs (encode with the cross K/V, prime, plain chunk,
   timestamp chunk; buckets 1, 2 and 4) at ``warmup()``; per bucket the
   encode graph's encoder states and cross K/V are bitwise an eager core's
   and a plain and a timestamp chunk give its tokens; capture ms and
   pool MiB per key. 19c: seeded 30 s WAVs (tones and noise) at
   concurrency 1, 4 and 8 (rows a batch at most 4), two transcriptions
   and two translations at once (the carried item), a 75 s file (three
   windows), ``text``, ``json``, ``verbose_json`` and, on a 2 s clip,
   ``verbose_json`` with ``["segment", "word"]``: the words equal a direct
   ``words_dtw`` call (not the proportional fallback); no capture after that
   first request; an endpoint on the same weights without ``max_tokens``,
   whose windows step past the cache's end (the clamp), raises no device
   assert. Prints wall s a request and the real-time factor, encode ms per
   bucket beside its operations bound and ms a decode step beside its byte
   bound (graph replays, CUDA events), host mel and DTW ms a window, rows a
   batch. 19d: both endpoints removed (their cores released under
   ``CAPTURE_LOCK``): ``memory_allocated`` back within 64 MiB.

The last three lines of standard output are the card line, the ``kernels``
JSON line (every kernel, its head_dim 256 entries and the ragged kernel's
tree variant) and
``{"ok": true, "device": {...}}``. Timings are CUDA-event
times on the card; ``bound_ms`` is computed from this run's operands.
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import weakref

import torch

CARD_BW = 3.35e12          # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
CARD_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core FLOP/s
TOL = 2e-2                 # bf16 output rounding + another summation order
# the card; the phases take it from here, so a rehearsal can set "cpu"
DEV = "cuda"


def log(*parts) -> None:
    print(*parts, flush=True)


def sync() -> None:
    if torch.device(DEV).type == "cuda":
        torch.cuda.synchronize()


# seconds between the last synchronize and a profiler's stop: kineto drops
# as out of range the GPU records it places after the stop, and a stop
# right after the synchronize lost the last replay's kernels (traces 10-68
# grids short of the counts, "Out-of-range = 560" and 858 records)
PROFILE_TAIL_S = 0.1


def stop_profiler(profiler) -> None:
    """Stop a profiler once the card has run everything enqueued, with
    ``PROFILE_TAIL_S`` of margin so its last kernels stay in the trace."""
    sync()
    time.sleep(PROFILE_TAIL_S)
    profiler.stop()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# -- phase 3: kernel vs plain version ------------------------------------------


def paged_operands(gen, *, lengths, hkv=8, g=4, d=128, page_size=16, pp=129,
                   quant=False, layers=1):
    """Random operands shaped like one decode step of the main path: pools
    of ``layers`` layers (so timing can rotate through more than L2 holds),
    a page table whose entries past each length are random page ids."""
    from clearml_serving_tpu_torch.models.llama import kv_store

    dev = torch.device(DEV)
    b = len(lengths)
    n = b * pp + 1
    q = torch.randn(b, hkv, g, d, generator=gen, device=dev).bfloat16()
    k = torch.randn(layers, hkv, n, page_size, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(layers, hkv, n, page_size, d, generator=gen, device=dev).bfloat16()
    ks = vs = None
    if quant:
        k, ks = kv_store(k, "int8", torch.bfloat16)
        v, vs = kv_store(v, "int8", torch.bfloat16)
    perm = torch.randperm(n - 1, generator=gen, device=dev).int() + 1
    table = perm.reshape(b, pp).clone()
    for i, length in enumerate(lengths):
        live = -(-int(length) // page_size)
        table[i, live:] = torch.randint(0, n, (pp - live,), generator=gen,
                                        device=dev, dtype=torch.int32)
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, table=table,
                lengths=torch.tensor(lengths, dtype=torch.int32, device=dev))


def layer_args(ops, li=0):
    kw = {}
    if ops["ks"] is not None:
        kw = {"k_scale": ops["ks"][li], "v_scale": ops["vs"][li]}
    return (ops["q"], ops["k"][li], ops["v"][li], ops["table"], ops["lengths"]), kw


def check_kernel(ops, label) -> float:
    """Kernel vs the plain version in f32 on the same operands; a second
    launch with every table entry past the lengths poisoned (out of range)
    must give the same bits, so those entries are never read."""
    from clearml_serving_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_ref,
    )

    (q, k, v, table, lengths), kw = layer_args(ops)
    out = paged_attention(q, k, v, table, lengths, **kw)
    quant = ops["ks"] is not None
    ref = paged_attention_ref(q.float(), k if quant else k.float(),
                              v if quant else v.float(), table, lengths, **kw)
    out2 = out
    if q.is_cuda:  # the plain version gathers every entry; the kernel must not
        poisoned = table.clone()
        page_size = k.shape[2]
        for i, length in enumerate(lengths.tolist()):
            poisoned[i, -(-length // page_size):] = 2 ** 30
        out2 = paged_attention(q, k, v, poisoned, lengths, **kw)
    sync()
    err = float((out.float() - ref).abs().max())
    ok = torch.allclose(out.float(), ref, rtol=TOL, atol=TOL)
    zero_rows = [i for i, n in enumerate(lengths.tolist()) if n == 0]
    log("  {:<44} max_abs_err {:.3e}  {}".format(label, err, "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("paged_attention disagrees with its plain version: " + label)
    if not torch.equal(out, out2):
        raise AssertionError("paged_attention read page-table entries past a length")
    if zero_rows and not torch.equal(out[zero_rows], torch.zeros_like(out[zero_rows])):
        raise AssertionError("zero-length rows are not zeros")
    return err


def time_launches(fn, n_layers, iters) -> float:
    """Mean ms per call, rotating through the layers' pools (the previous
    calls' reads evict most of a layer from L2, as in a decode step)."""
    for li in range(n_layers):
        fn(li)
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_layers)
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def time_graph(fn, n_layers, iters) -> float:
    """Mean ms per call of ``iters`` calls captured in one CUDA graph and
    replayed: device time without the host's per-call cost (an int4 decode
    call is shorter than its wrapper's Python work, so ``time_launches``
    would time the host). Rotates through the layers' operands as
    ``time_launches`` does."""
    for li in range(n_layers):
        fn(li)
    sync()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i % n_layers)
    graph.replay()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    sync()
    del graph
    return start.elapsed_time(end) / iters


def bound(ops):
    """(ms, "bytes" | "operations"): least time for the function on these
    operands: each input byte the function needs read once (q, the live
    tokens' K/V rows and scales, their page-table entries, the lengths), the
    output written once, over the card's memory rate; or its FLOPs (QK and
    PV, 4*G*D per live token and head) over the bf16 peak; whichever is
    larger."""
    q, k = ops["q"], ops["k"]
    b, hkv, g, d = q.shape
    page_size = k.shape[3]
    live = int(ops["lengths"].sum())
    pages = sum(-(-n // page_size) for n in ops["lengths"].tolist())
    kv = 2 * live * hkv * d * k.element_size()
    scales = 2 * live * hkv * 4 if ops["ks"] is not None else 0
    io = 2 * q.numel() * q.element_size() + pages * 4 + b * 4
    nbytes = kv + scales + io
    flops = 4 * g * d * live * hkv
    t_bytes, t_ops = nbytes / CARD_BW, flops / CARD_BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_kernels(gen) -> dict:
    from clearml_serving_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_ref,
    )

    log("phase 3: paged_attention kernel vs plain version (atol=rtol={})".format(TOL))
    mixed = [0, 1, 17, 1024, 2048, 700, 1500, 64]
    err_bf16 = max(
        check_kernel(paged_operands(gen, lengths=mixed), "bf16 B8 Hkv8 G4 D128 P16 mixed"),
        check_kernel(paged_operands(gen, lengths=mixed, d=64),
                     "bf16 B8 Hkv8 G4 D64 P16 mixed"),
        check_kernel(paged_operands(gen, lengths=[1024] * 8),
                     "bf16 B8 Hkv8 G4 D128 P16 8x1024"),
        check_kernel(paged_operands(gen, lengths=[2048] * 8),
                     "bf16 B8 Hkv8 G4 D128 P16 8x2048"),
    )
    err_int8 = max(
        check_kernel(paged_operands(gen, lengths=mixed, quant=True),
                     "int8 B8 Hkv8 G4 D128 P16 mixed"),
        check_kernel(paged_operands(gen, lengths=mixed, page_size=32, pp=65, g=8,
                                    quant=True), "int8 B8 Hkv8 G8 D128 P32 mixed"),
        check_kernel(paged_operands(gen, lengths=[1024] * 8, quant=True),
                     "int8 B8 Hkv8 G4 D128 P16 8x1024"),
        check_kernel(paged_operands(gen, lengths=[2048] * 8, quant=True),
                     "int8 B8 Hkv8 G4 D128 P16 8x2048"),
    )
    # head_dim 256: Gemma-7B's heads (Hkv 16, G 1) and Gemma-2B's (Hkv 1,
    # G 8); short rows take one span, long ones split
    err_d256 = {"bf16": 0.0, "int8": 0.0}
    for quant in (False, True):
        name = "int8" if quant else "bf16"
        for label, kw in (("B8 Hkv16 G1 D256 P16 mixed", dict(hkv=16, g=1)),
                          ("B8 Hkv1 G8 D256 P32 mixed", dict(hkv=1, g=8, page_size=32, pp=65)),
                          ("B8 Hkv16 G1 D256 P16 8x96", dict(hkv=16, g=1, lengths=[96] * 8))):
            kw = dict(dict(lengths=mixed), **kw)
            err_d256[name] = max(err_d256[name], check_kernel(
                paged_operands(gen, d=256, quant=quant, **kw), "{} {}".format(name, label)))
    timings = {}
    layers = 4
    cases = [(quant, case, lengths, {}) for quant in (False, True)
             for case, lengths in PAGED_CASES.items()]
    cases += [(quant, "8x1024_d256", [1024] * 8, GEMMA_HEADS) for quant in (False, True)]
    for quant, case, lengths, heads in cases:
        ops = paged_operands(gen, lengths=lengths, quant=quant, layers=layers, **heads)

        def kernel(li, ops=ops):
            args, kw = layer_args(ops, li)
            paged_attention(*args, **kw)

        def plain(li, ops=ops):
            args, kw = layer_args(ops, li)
            paged_attention_ref(*args, **kw)

        before = paged_attention.launches
        graph_ms = time_graph(kernel, layers, 200)
        eager_ms = time_launches(kernel, layers, 200)
        plain_ms = time_launches(plain, layers, 10) if case.startswith("8x1024") else None
        paged_attention.launches = before   # timing launches are not the main path's
        name = "{}_{}".format("int8" if quant else "bf16", case)
        b_ms, b_by = bound(ops)
        timings[name] = dict(ms=graph_ms, eager_ms=eager_ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by, share=b_ms / graph_ms,
                             sdpa_gathered_ms=sdpa_yardstick(ops, layers))
        log("  {}: graph_ms {:.4f}  eager_ms {:.4f}  plain_ms {}  bound_ms {:.5f} "
            "({:.1f}% of bound)  sdpa over gathered K/V {}".format(
                name, graph_ms, eager_ms,
                "{:.4f}".format(plain_ms) if plain_ms is not None else "-", b_ms,
                100 * b_ms / graph_ms, timings[name]["sdpa_gathered_ms"]))
        del ops
        torch.cuda.empty_cache()
    return dict(err_bf16=err_bf16, err_int8=err_int8, err_d256=err_d256, timings=timings)


# phase 3's timed batches: every row at 1024 and at 2048 tokens, and mixed lengths
PAGED_CASES = {"8x1024": [1024] * 8, "8x2048": [2048] * 8,
               "mixed": [0, 1, 17, 1024, 2048, 700, 1500, 64]}
# Gemma-7B's attention heads: 16 KV heads of 256 dims, one query head each
GEMMA_HEADS = dict(hkv=16, g=1, d=256)


def sdpa_yardstick(ops, n_layers):
    """A yardstick, not the same function: ms of one
    ``scaled_dot_product_attention`` call over the same K/V already gathered
    contiguous (dequantized to bf16 for int8 pools), so it reads no page
    table; the port never calls it. Timed in a CUDA graph over the layers.
    None for batches of unequal lengths (they would need a mask)."""
    lengths = ops["lengths"].tolist()
    if len(set(lengths)) != 1:
        return None
    q = ops["q"]
    b, hkv, g, d = q.shape
    page_size = ops["k"].shape[3]
    pages = ops["table"][:, : -(-lengths[0] // page_size)].long()
    qq = q.reshape(b, hkv * g, 1, d)
    kv = []
    for li in range(n_layers):
        pair = []
        for pool, scale in ((ops["k"][li], ops["ks"]), (ops["v"][li], ops["vs"])):
            rows = pool[:, pages].reshape(hkv, b, -1, d)
            if scale is not None:
                rows = (rows.float() * scale[li][:, pages].reshape(hkv, b, -1, 1)).bfloat16()
            pair.append(rows.transpose(0, 1)[:, :, : lengths[0]].contiguous())
        kv.append(pair)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = time_graph(lambda li: sdpa(qq, kv[li][0], kv[li][1], enable_gqa=True), n_layers, 200)
    del kv
    return ms


# -- phase 3b: ragged kernel vs plain version -------------------------------------


def ragged_operands(gen, rows, *, hkv=8, g=4, d=128, page_size=16, quant=False, layers=1,
                    unowned_blocks=0, flat=None, pages_per_seq=None):
    """Random operands of one ragged launch. ``rows``: (span on the flat
    axis, query tokens, history before them) per row; a span longer than
    its queries is a multi-step decode row whose positions 1.. are pads.
    ``unowned_blocks`` q blocks no row owns close the flat axis, or q
    blocks no row owns pad it to ``flat`` tokens. The page table has
    ``pages_per_seq`` columns (default: one more than the longest row
    needs); entries past each row's kv_len are random page ids."""
    from clearml_serving_tpu_torch.models.llama import kv_store
    from clearml_serving_tpu_torch.ops.paged_attention import RAGGED_QB, ragged_layout

    dev = torch.device(DEV)
    r = len(rows)
    spans = [s for s, _, _ in rows]
    starts, block_rows, block_q0, t_pad = ragged_layout(spans, RAGGED_QB, total=flat)
    block_rows = list(block_rows) + [-1] * unowned_blocks
    block_q0 = list(block_q0) + [0] * unowned_blocks
    t_pad += unowned_blocks * RAGGED_QB
    row_lens = [n for _, n, _ in rows]
    kv_lens = [n + h for _, n, h in rows]
    pp = pages_per_seq or -(-max(kv_lens) // page_size) + 1
    n_pages = r * pp + 1
    q = torch.randn(t_pad, hkv, g, d, generator=gen, device=dev).bfloat16()
    k = torch.randn(layers, hkv, n_pages, page_size, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(layers, hkv, n_pages, page_size, d, generator=gen, device=dev).bfloat16()
    ks = vs = None
    if quant:
        k, ks = kv_store(k, "int8", torch.bfloat16)
        v, vs = kv_store(v, "int8", torch.bfloat16)
    table = (torch.randperm(n_pages - 1, generator=gen, device=dev).int() + 1).reshape(r, pp)
    for i, length in enumerate(kv_lens):
        live = -(-length // page_size)
        table[i, live:] = torch.randint(0, n_pages, (pp - live,), generator=gen, device=dev,
                                        dtype=torch.int32)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    return dict(q=q, k=k, v=v, ks=ks, vs=vs, table=table.contiguous(), kv_lens=i32(kv_lens),
                starts=i32(starts), row_lens=i32(row_lens), block_rows=i32(block_rows),
                block_q0=i32(block_q0))


def ragged_args(ops, li=0, table=None):
    kw = {"block_rows": ops["block_rows"], "block_q0": ops["block_q0"]}
    if ops["ks"] is not None:
        kw.update(k_scale=ops["ks"][li], v_scale=ops["vs"][li])
    return (ops["q"], ops["k"][li], ops["v"][li],
            ops["table"] if table is None else table, ops["kv_lens"], ops["starts"],
            ops["row_lens"]), kw


def check_ragged(ops, label, tree_anc=None) -> float:
    """Ragged kernel vs the plain version in f32 on the same operands (with
    ``tree_anc``, both masked by it); tokens no row owns (multi-step pads,
    alignment pads, unowned blocks) must be exact zeros, and a second
    launch with every table entry past each row's kv_len poisoned must
    give the same bits."""
    from clearml_serving_tpu_torch.ops.paged_attention import (
        ragged_paged_attention, ragged_paged_attention_ref,
    )

    args, kw = ragged_args(ops)
    q, k, v = args[:3]
    out = ragged_paged_attention(*args, **kw, tree_anc=tree_anc)
    quant = ops["ks"] is not None
    scales = {key: kw[key] for key in ("k_scale", "v_scale") if key in kw}
    ref = ragged_paged_attention_ref(q.float(), k if quant else k.float(),
                                     v if quant else v.float(), *args[3:], **scales,
                                     tree_anc=tree_anc)
    poisoned = ops["table"].clone()
    page_size = k.shape[2]
    for i, length in enumerate(ops["kv_lens"].tolist()):
        poisoned[i, -(-length // page_size):] = 2 ** 30
    args2, kw2 = ragged_args(ops, table=poisoned)
    out2 = ragged_paged_attention(*args2, **kw2, tree_anc=tree_anc)
    sync()
    owned = torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
    for s, n in zip(ops["starts"].tolist(), ops["row_lens"].tolist()):
        owned[s:s + n] = True
    err = float((out.float() - ref).abs().max())
    ok = torch.allclose(out.float(), ref, rtol=TOL, atol=TOL)
    log("  {:<52} max_abs_err {:.3e}  {}".format(label, err, "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("ragged_paged_attention disagrees with its plain version: " + label)
    if not torch.equal(out, out2):
        raise AssertionError("ragged_paged_attention read page-table entries past a kv_len")
    if not torch.equal(out[~owned], torch.zeros_like(out[~owned])):
        raise AssertionError("tokens no row owns are not exact zeros: " + label)
    return err


def ragged_bound(ops, tree_anc=None):
    """(ms, "bytes" | "operations"): least time for the launch on these
    operands: each live row's K/V (and scales) up to its kv_len read once,
    q and out once, the live rows' table entries (and ``tree_anc``), over
    the memory rate; or 4*G*D*Hkv FLOPs per visible (query, key) pair (the
    causal pairs, a tree query's in-row pairs only its listed ancestors)
    over the bf16 peak; whichever is larger."""
    q, k = ops["q"], ops["k"]
    t, hkv, g, d = q.shape
    page_size = k.shape[3]
    rows = [(kv, n, s) for kv, n, s in zip(ops["kv_lens"].tolist(), ops["row_lens"].tolist(),
                                           ops["starts"].tolist()) if n]
    live = sum(kv for kv, _, _ in rows)
    kv_bytes = 2 * live * hkv * d * k.element_size()
    scales = 2 * live * hkv * 4 if ops["ks"] is not None else 0
    io = 2 * q.numel() * q.element_size() + 4 * sum(-(-kv // page_size) for kv, _, _ in rows)
    causal = sum((kv - n) * n + n * (n + 1) // 2 for kv, n, _ in rows)
    if tree_anc is not None:
        io += tree_anc.numel() * 4
        anc = tree_anc.cpu()
        for _kv, n, s in rows:
            for i in range(n):
                if int(anc[s + i, 0]) != -2:
                    causal -= (i + 1) - int((anc[s + i] >= 0).sum())
    flops = 4 * g * d * hkv * causal
    t_bytes, t_ops = (kv_bytes + scales + io) / CARD_BW, flops / CARD_BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# seven decode rows at kv_len 1024 and one 128-token chunk ending at 1024
RAGGED_MIXED = [(1, 1, 1023)] * 7 + [(128, 128, 896)]
# one 512-token chunk ending at 2048
RAGGED_PREFILL = [(512, 512, 1536)]


def phase_ragged_kernel(gen) -> dict:
    from clearml_serving_tpu_torch.ops.paged_attention import (
        ragged_paged_attention, ragged_paged_attention_ref,
    )

    log("phase 3b: ragged_paged_attention kernel vs plain version (atol=rtol={})".format(TOL))
    # decode rows, a 4-token multi-step span (3 pads), chunks at history 0
    # and mid-history whose tails cross page boundaries, an idle row, a
    # chunk longer than two q blocks, two unowned blocks at the end
    mix = [(1, 1, 1023), (4, 1, 300), (37, 37, 0), (0, 0, 0), (19, 19, 77), (1, 1, 0),
           (130, 130, 517), (1, 1, 64)]
    cases = [
        ("bf16 G4 D128 P16", {}),
        ("bf16 G8 D128 P32", dict(g=8, page_size=32)),
        ("bf16 G4 D64 P32", dict(d=64, page_size=32)),
        ("bf16 G8 D64 P16", dict(g=8, d=64)),
        ("int8 G4 D128 P16", dict(quant=True)),
        ("int8 G8 D128 P32", dict(g=8, page_size=32, quant=True)),
        ("int8 G4 D64 P16", dict(d=64, quant=True)),
        ("int8 G8 D64 P32", dict(g=8, d=64, page_size=32, quant=True)),
    ]
    # head_dim 256: Gemma-7B's heads (Hkv 16, G 1), Gemma-2B's (Hkv 1, G 8)
    cases_d256 = [
        ("bf16 Hkv16 G1 D256 P16", dict(GEMMA_HEADS)),
        ("bf16 Hkv1 G8 D256 P32", dict(hkv=1, g=8, d=256, page_size=32)),
        ("int8 Hkv16 G1 D256 P16", dict(GEMMA_HEADS, quant=True)),
        ("int8 Hkv1 G8 D256 P32", dict(hkv=1, g=8, d=256, page_size=32, quant=True)),
    ]
    errs = {"bf16": 0.0, "int8": 0.0, "bf16_d256": 0.0, "int8_d256": 0.0}
    for label, kw in cases + cases_d256:
        ops = ragged_operands(gen, mix, unowned_blocks=2, **kw)
        err = check_ragged(ops, "mixed rows " + label)
        name = ("int8" if kw.get("quant") else "bf16") + ("_d256" if kw.get("d") == 256 else "")
        errs[name] = max(errs[name], err)
    # head_dim 256 with the draft-tree mask, causal beside it, and every
    # verify row's keys split (the long verify launch)
    for shape, rows, layout in (("tree", RAGGED_TREE, {}),
                                ("verify_long", RAGGED_VERIFY_LONG, VERIFY_LAYOUT)):
        for quant in (False, True):
            name = "int8" if quant else "bf16"
            for topo in ("chain", "forest"):
                ops = ragged_operands(gen, rows, quant=quant, **GEMMA_HEADS, **layout)
                anc = tree_anc_for(ops, TREE_TOPOLOGIES[topo])
                errs[name + "_d256"] = max(errs[name + "_d256"], check_ragged(
                    ops, "{} shape {} {} Hkv16 G1 D256 P16".format(shape, topo, name),
                    tree_anc=anc))
                if topo == "chain":
                    args, kw = ragged_args(ops)
                    same = torch.equal(ragged_paged_attention(*args, **kw, tree_anc=anc),
                                       ragged_paged_attention(*args, **kw))
                    sync()
                    if not same:
                        raise AssertionError("a chain topology changed the D256 kernel's "
                                             "bits: " + shape)
    for label, rows in (("mixed shape", RAGGED_MIXED), ("prefill shape", RAGGED_PREFILL)):
        for quant in (False, True):
            ops = ragged_operands(gen, rows, quant=quant)
            err = check_ragged(ops, "{} {} G4 D128 P16".format(label, "int8" if quant else "bf16"))
            name = "int8" if quant else "bf16"
            errs[name] = max(errs[name], err)
    timings = {}
    layers = 4
    for shape, rows, quants, heads in (("mixed", RAGGED_MIXED, (False, True), {}),
                                       ("prefill", RAGGED_PREFILL, (False,), {}),
                                       ("mixed_d256", RAGGED_MIXED, (False, True), GEMMA_HEADS),
                                       ("prefill_d256", RAGGED_PREFILL, (False,), GEMMA_HEADS)):
        for quant in quants:
            ops = ragged_operands(gen, rows, quant=quant, layers=layers, **heads)

            def kernel(li, ops=ops):
                args, kw = ragged_args(ops, li)
                ragged_paged_attention(*args, **kw)

            def plain(li, ops=ops):
                args, kw = ragged_args(ops, li)
                kw.pop("block_rows")
                kw.pop("block_q0")
                ragged_paged_attention_ref(*args, **kw)

            before = ragged_paged_attention.launches
            args, kw = ragged_args(ops)
            once, again = ragged_paged_attention(*args, **kw), ragged_paged_attention(*args, **kw)
            sync()
            if not torch.equal(once, again):
                raise AssertionError("two ragged calls on the same inputs differ")
            graph_ms = time_graph(kernel, layers, 200)
            eager_ms = time_launches(kernel, layers, 100)
            plain_ms = time_launches(plain, layers, 4)
            ragged_paged_attention.launches = before  # not the main path's launches
            b_ms, b_by = ragged_bound(ops)
            key = "{}_{}".format(shape, "int8" if quant else "bf16")
            timings[key] = dict(ms=graph_ms, eager_ms=eager_ms, plain_ms=plain_ms,
                                bound_ms=b_ms, bound_by=b_by, share=b_ms / graph_ms)
            if shape.startswith("prefill"):
                timings[key]["sdpa_gathered_ms"] = sdpa_causal_yardstick(ops, layers)
            log("  {} shape {}: graph_ms {:.4f}  eager_ms {:.4f}  plain_ms {:.4f}  bound_ms "
                "{:.4f} ({})  ({:.1f}% of bound){}".format(
                    shape, "int8" if quant else "bf16", graph_ms, eager_ms, plain_ms, b_ms, b_by,
                    100 * b_ms / graph_ms,
                    "  sdpa over gathered K/V {}".format(timings[key]["sdpa_gathered_ms"])
                    if shape.startswith("prefill") else ""))
            del ops
            torch.cuda.empty_cache()
    return dict(err_bf16=errs["bf16"], err_int8=errs["int8"], err_bf16_d256=errs["bf16_d256"],
                err_int8_d256=errs["int8_d256"], timings=timings)


def sdpa_causal_yardstick(ops, n_layers):
    """A yardstick, not the same function: ms of one
    ``scaled_dot_product_attention`` call with a lower-right causal mask
    (``torch.nn.attention.bias.causal_lower_right``) over one chunk row's
    K/V already gathered contiguous (bf16 pools only), so it reads no page
    table; the port never calls it. Timed in a CUDA graph over the layers;
    None (with the error) where the call is refused."""
    from torch.nn.attention.bias import causal_lower_right

    (kv_len,) = ops["kv_lens"].tolist()
    q = ops["q"]
    t, hkv, g, d = q.shape
    page_size = ops["k"].shape[3]
    pages = ops["table"][0, : -(-kv_len // page_size)].long()
    qq = q.reshape(1, t, hkv * g, d).transpose(1, 2)
    kv = [[pool[:, pages].reshape(hkv, -1, d)[None, :, :kv_len].contiguous()
           for pool in (ops["k"][li], ops["v"][li])] for li in range(n_layers)]
    mask = causal_lower_right(t, kv_len)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        return time_graph(lambda li: sdpa(qq, kv[li][0], kv[li][1], attn_mask=mask,
                                          enable_gqa=True), n_layers, 50)
    except Exception as exc:  # a yardstick only: record why it is missing
        log("  sdpa yardstick refused: {}".format(str(exc).splitlines()[0][:200]))
        return None


# a draft-tree launch with a chunk: four verify rows of k+1 = 5 tokens at
# 1024 history, three decode rows at 1024, one 128-token chunk ending at
# 1024 (no row's keys reach a span past the chunk's, so none splits)
RAGGED_TREE = [(5, 5, 1024)] * 4 + [(1, 1, 1023)] * 3 + [(128, 128, 896)]
# the verify launch of phase 5d's tree arm (its chats hold 300 to 550
# tokens): four verify rows of 5 and two decode rows, no chunk row, two idle
# rows (R 8), on the engine's table (129 pages of 16) and flat axis (312
# tokens): no row holds more than 3 spans' keys, so none splits
RAGGED_VERIFY = ([(5, 5, 300), (5, 5, 380), (5, 5, 460), (5, 5, 550), (1, 1, 420), (1, 1, 500)]
                 + [(0, 0, 0)] * 2)
# the same launch later in longer chats: every row splits, 6 long rows of 8
# heads into 2 spans each (of 512 to 768 keys)
RAGGED_VERIFY_LONG = ([(5, 5, 900), (5, 5, 1100), (5, 5, 1300), (5, 5, 1500), (1, 1, 1000),
                       (1, 1, 1400)] + [(0, 0, 0)] * 2)
VERIFY_LAYOUT = dict(flat=312, pages_per_seq=129)
# a verify row's topology as (parents, live nodes): a chain, the n-gram
# forest at spec_branch 2 (a depth-3 primary branch and one root sibling),
# and a tree whose last two nodes are dead (past its live nodes)
TREE_TOPOLOGIES = {"chain": ([-1, 0, 1, 2, 3], 5), "forest": ([-1, 0, 1, 2, 0], 5),
                   "dead_nodes": ([-1, 0, 0, -1, -1], 3)}
# (shape, rows, layout, topologies timed)
TREE_SHAPES = [("tree", RAGGED_TREE, {}, ("chain", "forest")),
               ("verify", RAGGED_VERIFY, VERIFY_LAYOUT, ("chain", "forest")),
               ("verify_long", RAGGED_VERIFY_LONG, VERIFY_LAYOUT, ("forest",))]


def tree_anc_for(ops, topology):
    """[T, k+1] ancestor lists: each verify row (5 query tokens) takes
    ``topology`` (parents, live nodes); decode and chunk tokens keep the -2
    plain-causal sentinel."""
    from clearml_serving_tpu_torch.ops.paged_attention import tree_ancestors

    parents, n_nodes = topology
    anc = torch.full((ops["q"].shape[0], len(parents)), -1, dtype=torch.int32)
    anc[:, 0] = -2
    row_anc = torch.from_numpy(tree_ancestors(parents, n_nodes, width=len(parents)))
    for s, n in zip(ops["starts"].tolist(), ops["row_lens"].tolist()):
        if n == len(parents):
            anc[s:s + n] = row_anc
    return anc.to(ops["q"].device)


@contextlib.contextmanager
def fixed_span(span=None):
    """Calls made inside run the ragged kernel with spans of ``span``
    tokens (a multiple of 64), or with its key-range split off (None: one
    span covering the whole table): a timing comparison only; the port
    always takes ``ragged_split_plan``."""
    from clearml_serving_tpu_torch.ops import paged_attention as pa

    plan = pa.ragged_split_plan

    def fixed(t, n_rows, hkv, pages_per_seq, page_size):
        capacity = pages_per_seq * page_size
        whole = -(-capacity // pa.SPLIT_QUANTUM) * pa.SPLIT_QUANTUM
        width = min(span or whole, whole)
        return max(1, -(-capacity // width)), width

    pa.ragged_split_plan = fixed
    try:
        yield
    finally:
        pa.ragged_split_plan = plan


TREE_PAIRS = 10  # alternating (masked, unmasked) graph replays per case


def graph_turns(fns, n_layers, iters, turns):
    """ms per call of each of ``fns``, each captured once in a CUDA graph
    of ``iters`` calls (rotating through the layers) and replayed in turns
    a, b, ..., a, b, ...: one list of ``turns`` times per function."""
    graphs = []
    for fn in fns:
        for li in range(n_layers):
            fn(li)
        sync()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(iters):
                fn(i % n_layers)
        graph.replay()
        graphs.append(graph)
    sync()
    times = tuple([] for _ in fns)
    for _ in range(turns):
        for graph, out in zip(graphs, times):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            graph.replay()
            end.record()
            sync()
            out.append(start.elapsed_time(end) / iters)
    del graphs
    return times


def phase_tree_kernel(gen) -> dict:
    """The ragged kernel's draft-tree mask at TREE_SHAPES: verify rows of
    every topology beside decode rows (and a chunk), bf16 and int8, against
    the plain version; a chain topology must give the plain-causal launch's
    bits. Then each timed launch is timed beside the same launch without
    the mask, the plain version and the bound, and at the verify shapes
    beside the same launch with its key-range split off."""
    from clearml_serving_tpu_torch.ops.paged_attention import (
        ragged_paged_attention, ragged_paged_attention_ref,
    )

    log("phase 3b (tree_anc): ragged kernel's draft-tree mask vs plain version "
        "(atol=rtol={})".format(TOL))
    errs = {"bf16": 0.0, "int8": 0.0}
    timings = {}
    layers = 4
    for shape, rows, layout, timed in TREE_SHAPES:
        for quant in (False, True):
            name = "int8" if quant else "bf16"
            for topo, topology in TREE_TOPOLOGIES.items():
                ops = ragged_operands(gen, rows, quant=quant, layers=layers, **layout)
                anc = tree_anc_for(ops, topology)
                errs[name] = max(errs[name], check_ragged(
                    ops, "{} shape {} {} G4 D128 P16".format(shape, topo, name), tree_anc=anc))
                args, kw = ragged_args(ops)
                if topo == "chain":
                    same = torch.equal(ragged_paged_attention(*args, **kw, tree_anc=anc),
                                       ragged_paged_attention(*args, **kw))
                    sync()
                    if not same:
                        raise AssertionError("a chain topology changed the kernel's bits: "
                                             + shape)
                if topo not in timed:
                    continue

                def kernel(li, ops=ops, anc=anc):
                    args, kw = ragged_args(ops, li)
                    ragged_paged_attention(*args, **kw, tree_anc=anc)

                def untree(li, ops=ops):
                    args, kw = ragged_args(ops, li)
                    ragged_paged_attention(*args, **kw)

                def unsplit(li):
                    with fixed_span():
                        kernel(li)

                def plain(li, ops=ops, anc=anc):
                    args, kw = ragged_args(ops, li)
                    kw.pop("block_rows")
                    kw.pop("block_q0")
                    ragged_paged_attention_ref(*args, **kw, tree_anc=anc)

                before = (ragged_paged_attention.launches, ragged_paged_attention.tree_launches)
                # the mask's cost: graph replays of the masked and the unmasked
                # launch in alternating pairs (their difference is smaller than
                # the spread of back-to-back timings)
                masked, unmasked = graph_turns((kernel, untree), layers, 100, TREE_PAIRS)
                kernel_ms, untree_ms = min(masked), min(unmasked)
                diffs = sorted(a - b for a, b in zip(masked, unmasked))
                row = dict(ms=kernel_ms, untree_ms=untree_ms,
                           mask_cost_ms=diffs[len(diffs) // 2],
                           mask_cost_spread_ms=[diffs[0], diffs[-1]])
                split_note = ""
                if shape.startswith("verify"):
                    # the split's worth on the verify launches: the same tree
                    # launch with one span, in alternating pairs
                    split, whole = graph_turns((kernel, unsplit), layers, 100, TREE_PAIRS)
                    gains = sorted(b - a for a, b in zip(split, whole))
                    row.update(one_span_ms=min(whole), split_gain_ms=gains[len(gains) // 2],
                               split_gain_spread_ms=[gains[0], gains[-1]])
                    split_note = ("; with one span {:.4f}, one span - split median {:.5f}, "
                                  "range {:.5f} .. {:.5f}".format(
                                      min(whole), gains[len(gains) // 2], gains[0], gains[-1]))
                eager_ms = time_launches(kernel, layers, 100)
                plain_ms = time_launches(plain, layers, 4)
                # not the main path's launches
                ragged_paged_attention.launches, ragged_paged_attention.tree_launches = before
                b_ms, b_by = ragged_bound(ops, anc)
                row.update(eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                           share=b_ms / kernel_ms)
                timings["{}_{}_{}".format(shape, topo, name)] = row
                log("  {} shape {} {}: graph_ms {:.4f} (same launch without the mask {:.4f}; "
                    "masked - unmasked over {} alternating pairs: median {:.5f}, range {:.5f} "
                    ".. {:.5f}{})  eager_ms {:.4f}  plain_ms {:.4f}  bound_ms {:.4f} ({})  "
                    "({:.1f}% of bound)".format(
                        shape, topo, name, kernel_ms, untree_ms, len(diffs),
                        diffs[len(diffs) // 2], diffs[0], diffs[-1], split_note, eager_ms,
                        plain_ms, b_ms, b_by, 100 * b_ms / kernel_ms))
                del ops
                torch.cuda.empty_cache()
    return dict(err_bf16=errs["bf16"], err_int8=errs["int8"], timings=timings)


# -- phase 3c: the w4a16 matmul kernel vs plain version ---------------------------

# Llama-3-8B's projections as (K, N), with their calls per decode step (one
# forward over 32 layers: 7 projections per layer and the lm_head)
INT4_SHAPES = {
    "wq/wo": ((4096, 4096), 64),
    "wk/wv": ((4096, 1024), 64),
    "w_gate/w_up": ((4096, 14336), 64),
    "w_down": ((14336, 4096), 32),
    "lm_head": ((4096, 128256), 1),
}
INT4_PRIMARY = ("w_gate/w_up", 8)   # the kernels line's headline call
# one decode row; a decode batch; the shortest prefill bucket (the block
# tiling's 64-token instance); a chunked-prefill segment (phase 12's
# chunked_prefill 256); the ragged flat axis; the longest prefill bucket
INT4_ROWS = (1, 8, 64, 256, 312, 2048)
INT4_SEGMENT_ROWS = 256


def int4_rows(name, rows=INT4_ROWS):
    """The row counts the main path gives a projection: a prefill, and a
    chunked prefill's segment, takes the lm_head on its last row only."""
    return [m for m in rows if name != "lm_head" or (m <= 312 and m != INT4_SEGMENT_ROWS)]


def int4_bound(m, k, n, groups):
    """(ms, "bytes" | "operations"): least time for x [m, k] @ dequant(W
    [k, n]): the packed codes, the scales, x and the output each moved once
    over the memory rate, or 2*m*k*n operations over the bf16 peak."""
    nbytes = k * n // 2 + groups * n * 4 + m * k * 2 + m * n * 2
    t_bytes, t_ops = nbytes / CARD_BW, 2.0 * m * k * n / CARD_BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def library_int4(x, qs):
    """PyTorch's own w4a16 product on the same function, or the error that
    refused it: ``_weight_int4pack_mm`` on the codes repacked by
    ``_convert_weight_to_int4pack`` ([N, K/2] uint8, even K in the high
    nibble) with zero offsets (it dequantizes (code - 8) * scale + zero).
    Returns (call(i) on copy i of the weights, None) or (None, error).
    Timed only; the port never calls it."""
    try:
        packed = []
        for q, s in qs:
            repacked = (((q & 0xF) << 4) | (q >> 4)).t().contiguous()
            sz = torch.stack([s, torch.zeros_like(s)], dim=-1).bfloat16().contiguous()
            packed.append((torch.ops.aten._convert_weight_to_int4pack(repacked, 8), sz,
                           2 * q.shape[0] // s.shape[0]))

        def call(i):
            w, sz, group = packed[i]
            return torch.ops.aten._weight_int4pack_mm(x, w, group, sz)

        call(0)
        return call, None
    except Exception as ex:  # the yardstick only: a refusal is recorded, not fatal
        return None, "{}: {}".format(type(ex).__name__, str(ex).splitlines()[0][:200])


def phase_int4_kernel(gen) -> dict:
    """Kernel vs the plain version computed in f32 on the same bf16 inputs
    at every projection shape and each of INT4_ROWS; then times at each:
    the kernel, the plain version as the card would run it (bf16 dequant,
    then torch.matmul), a bf16 torch.matmul on the dequantized weight and
    the library's int4 product, rotating through copies of the weights that
    together exceed the 50 MB L2. Device times come from CUDA-graph
    replays; ``eager_ms`` is the kernel called through its Python wrapper
    one call after another, the per-call cost the host-bound main path
    pays."""
    from clearml_serving_tpu_torch.ops.fused_matmul import (
        fused_int4_matmul, int4_matmul_plain,
    )
    from clearml_serving_tpu_torch.ops.quant import dequantize_int4, quantize_int4

    log("phase 3c: fused_int4_matmul kernel vs plain version (atol=rtol={})".format(TOL))
    dev = torch.device(DEV)
    err = 0.0
    timings = {}
    for name, ((k, n), _calls) in INT4_SHAPES.items():
        w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
        q, s = quantize_int4(w)
        del w
        groups = s.shape[0]
        copies = max(2, -(-120_000_000 // (q.numel() + s.numel() * 4)))
        qs = [(q, s)] + [(q.clone(), s.clone()) for _ in range(copies - 1)]
        w_bf16 = dequantize_int4(q, s, torch.bfloat16)
        copies_bf16 = max(2, -(-120_000_000 // (w_bf16.numel() * 2)))
        ws = [w_bf16] + [w_bf16.clone() for _ in range(copies_bf16 - 1)]
        for m in int4_rows(name):
            x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
            out = fused_int4_matmul(x, q, s)
            again = fused_int4_matmul(x, q, s)
            ref = int4_matmul_plain(x.float(), q, s, torch.float32)
            sync()
            if not torch.equal(out, again):
                raise AssertionError("fused_int4_matmul gave other bits on a second call: "
                                     "{} M={}".format(name, m))
            e = float((out.float() - ref).abs().max())
            ok = bool(torch.isfinite(out).all()) and torch.allclose(out.float(), ref,
                                                                    rtol=TOL, atol=TOL)
            log("  {:<12} x[{}, {}] @ W[{}, {}]  max_abs_err {:.3e}  {}".format(
                name, m, k, k, n, e, "ok" if ok else "FAIL"))
            if not ok:
                raise AssertionError("fused_int4_matmul disagrees with its plain version: "
                                     "{} M={}".format(name, m))
            err = max(err, e)
            del out, again, ref
            before = fused_int4_matmul.launches

            def kernel(i, x=x):
                fused_int4_matmul(x, *qs[i])

            def plain(i, x=x):
                int4_matmul_plain(x, *qs[i], torch.bfloat16)

            def bf16(i, x=x):
                torch.matmul(x, ws[i])

            iters = 400 if m <= 16 else 100 if m <= 512 else 20
            row = dict(ms=time_graph(kernel, copies, iters),
                       eager_ms=time_launches(kernel, copies, iters),
                       plain_ms=time_graph(plain, copies, max(4, copies)),
                       bf16_ms=time_graph(bf16, copies_bf16, iters))
            lib_call, lib_err = library_int4(x, qs)
            row["library_ms"] = None
            row["library_error"] = lib_err
            if lib_call is not None:
                got = lib_call(0).float()
                want = int4_matmul_plain(x.float(), q, s, torch.float32)
                lib_diff = float((got - want).abs().max())
                if torch.allclose(got, want, rtol=TOL, atol=TOL):
                    row["library_ms"] = time_graph(lib_call, copies, iters)
                else:
                    row["library_error"] = "disagrees with the plain version: max_abs_err " \
                                           "{:.3e}".format(lib_diff)
                del got, want
            fused_int4_matmul.launches = before
            row["bound_ms"], row["bound_by"] = int4_bound(m, k, n, groups)
            row["max_abs_err"] = e
            timings[(name, m)] = row
            log("    kernel_ms {ms:.4f} (eager {eager_ms:.4f})  plain_ms {plain_ms:.4f}  bf16_ms "
                "{bf16_ms:.4f}  library_ms {lib}  bound_ms {bound_ms:.4f} ({bound_by}, "
                "{share:.1f}% of bound){note}".format(
                    lib="{:.4f}".format(row["library_ms"]) if row["library_ms"] else "null",
                    share=100 * row["bound_ms"] / row["ms"],
                    note="  [library: {}]".format(lib_err or row["library_error"])
                    if row["library_error"] else "", **row))
            del x
        del qs, ws, q, s, w_bf16
        torch.cuda.empty_cache()
    # the 225 calls of one decode step at M = 8, from the per-shape times
    step = {key: sum(timings[(name, 8)][key] * calls
                     for name, (_shape, calls) in INT4_SHAPES.items())
            for key in ("ms", "eager_ms", "plain_ms", "bf16_ms", "bound_ms")}
    libs = [timings[(name, 8)]["library_ms"] for name in INT4_SHAPES]
    step["library_ms"] = (sum(t * calls for t, (_s, calls) in zip(libs, INT4_SHAPES.values()))
                          if all(t is not None for t in libs) else None)
    log("  one decode step's 225 calls at M=8: kernel {ms:.4f} ms (eager {eager_ms:.4f}; "
        "{share:.1f}% of bound), bound {bound_ms:.4f} ms, library {lib} ms, bf16 matmul "
        "{bf16_ms:.4f} ms, plain {plain_ms:.4f} ms".format(
            lib="{:.4f}".format(step["library_ms"]) if step["library_ms"] is not None
            else "null", share=100 * step["bound_ms"] / step["ms"], **step))
    # the 224 projection calls of one ragged step on the 312-token flat axis
    # (its lm_head runs on the rows' last tokens only)
    projections = [(name, calls) for name, (_shape, calls) in INT4_SHAPES.items()
                   if name != "lm_head"]
    ragged = {key: sum(timings[(name, 312)][key] * calls for name, calls in projections)
              for key in ("ms", "eager_ms", "plain_ms", "bf16_ms", "bound_ms")}
    libs = [timings[(name, 312)]["library_ms"] for name, _calls in projections]
    ragged["library_ms"] = (sum(t * calls for t, (_n, calls) in zip(libs, projections))
                            if all(t is not None for t in libs) else None)
    log("  one ragged step's 224 projection calls at M=312: kernel {ms:.4f} ms (eager "
        "{eager_ms:.4f}; {share:.1f}% of bound), bound {bound_ms:.4f} ms, library {lib} ms, "
        "bf16 matmul {bf16_ms:.4f} ms, plain {plain_ms:.4f} ms".format(
            lib="{:.4f}".format(ragged["library_ms"]) if ragged["library_ms"] is not None
            else "null", share=100 * ragged["bound_ms"] / ragged["ms"], **ragged))
    return dict(err=err, timings=timings, decode_step=step, ragged_step=ragged)


# -- phase 4: small model on the card vs float32 on the CPU ----------------------


SMALL_MODEL = {"vocab_size": 512, "dim": 512, "n_layers": 2, "n_heads": 8,
               "n_kv_heads": 4, "head_dim": 128, "ffn_dim": 1024, "rope_theta": 500000.0}


def _to(tree, device, dtype=None):
    """A parameter tree on ``device``; floating leaves cast to ``dtype``
    when given, quantized codes and scales moved as they are."""
    if isinstance(tree, dict):
        return {k: _to(v, device, None if k in ("_q4", "_scale4", "_q8", "_scale") else dtype)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device, dtype) for v in tree]
    return tree.to(device=device, dtype=dtype) if dtype is not None else tree.to(device)


# phase 4e: a small model of each family the paged path serves beside
# Llama-3, at phase 4's widths where the family allows: Llama-3.1's scaled
# RoPE, yarn and longrope (original windows of 32 and 16 tokens, so the
# prompts cross them), Qwen2's biases at G = 7, Gemma's deltas at head_dim
# 256 with G = 1 and G = 8
SMALL_FAMILIES = {
    "llama3.1": dict(SMALL_MODEL, rope_scaling={
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
        "original_max_position_embeddings": 32}),
    "yarn": dict(SMALL_MODEL, rope_scaling={"rope_type": "yarn", "factor": 4.0,
                                            "original_max_position_embeddings": 32}),
    "longrope": dict(SMALL_MODEL, max_seq_len=1024, rope_scaling={
        "rope_type": "longrope", "original_max_position_embeddings": 16,
        "short_factor": [1.0 + i / 64 for i in range(64)],
        "long_factor": [2.0 + i / 16 for i in range(64)]}),
    "qwen2": dict(SMALL_MODEL, n_heads=7, n_kv_heads=1, attn_bias=True, rope_theta=1000000.0,
                  norm_eps=1e-6),
    "gemma_g1": dict(SMALL_MODEL, n_heads=2, n_kv_heads=2, head_dim=256, rope_theta=10000.0,
                     tie_embeddings=True, norm_offset=True, hidden_act="gelu_pytorch_tanh",
                     embed_scale=512 ** 0.5, norm_eps=1e-6),
    "gemma_g8": dict(SMALL_MODEL, n_heads=8, n_kv_heads=1, head_dim=256, rope_theta=10000.0,
                     tie_embeddings=True, norm_offset=True, hidden_act="gelu_pytorch_tanh",
                     embed_scale=512 ** 0.5, norm_eps=1e-6),
}


def perturb_constant_leaves(params, gen) -> None:
    """Seeded values on the leaves ``init_params`` makes constant (norms,
    zero QKV biases), in place, so their arithmetic shows in the logits."""
    for tree in [params] + params["layers"]:
        for key, value in tree.items():
            if key.endswith("norm"):
                value += 0.2 * torch.randn(value.shape, generator=gen)
            elif key in ("bq", "bk", "bv"):
                value += 0.5 * torch.randn(value.shape, generator=gen)


def small_model_params(gen_seed: int, weight_quant: str = "", model=None):
    """(bf16 weights on the card, the same values in float32 on the CPU) of
    ``model`` (phase 4's by default; a family's leaves made constant by
    ``init_params`` are perturbed); with ``weight_quant`` both sides hold the
    same quantized codes and scales, made from the bf16 values."""
    from clearml_serving_tpu_torch.models.llama import init_params
    from clearml_serving_tpu_torch.ops.quant import quantize_llama_params

    gen = torch.Generator().manual_seed(gen_seed)
    cpu_params = init_params(dict(model or SMALL_MODEL, dtype="float32"), gen, device="cpu")
    if model is not None:
        perturb_constant_leaves(cpu_params, gen)
    card_params = _to(cpu_params, DEV, torch.bfloat16)
    ref_params = _to(card_params, "cpu", torch.float32)    # the same bf16 values
    if weight_quant:
        ref_params = quantize_llama_params(ref_params, bits=4 if weight_quant == "int4" else 8)
        card_params = _to(ref_params, DEV, torch.bfloat16)
    return card_params, ref_params


def int4_launches_per_forward(model) -> int:
    """fused_int4_matmul launches of one forward call of an int4 model on
    the card: 7 projections per layer and the lm_head (none when tied; 0
    otherwise)."""
    if model.weight_quant != "int4" or model.device.type != "cuda":
        return 0
    return 7 * model.n_layers + (model.lm_head is not None)


def check_int4_launches(model, launches: int, forwards: int, label: str) -> None:
    want = int4_launches_per_forward(model) * forwards
    if launches != want:
        raise AssertionError("{}: fused_int4_matmul launched {} times for {} forward calls "
                             "(want {})".format(label, launches, forwards, want))


def phase_small_model(gen_seed: int, weight_quant: str = "", family: str = "") -> None:
    """Prefill + 4 paged decode steps of a 2-layer model with head_dim 128
    (G=2) in bf16 on the card (paged attention kernel) against the same
    weights in float32 on the CPU (plain version). Teacher-forced on the
    CPU model's greedy tokens. Tolerance: 5% of the largest reference logit
    (bf16 activations round every op to 2**-8 relative, int8 K/V codes to
    1/254 of each vector's range), and the same top-1 token in 90% of rows;
    a wrong attention moves the logits by their own scale. ``family`` takes
    that model of ``SMALL_FAMILIES`` instead (phase 4e), whose top-1
    agreement counts a row whose top tokens tie inside the logit tolerance,
    as phase 4b's does (yarn's attention factor sharpens the scores, and
    bf16 flips a near-tied row of the 10)."""
    from clearml_serving_tpu_torch.llm.kv_cache import PagedKVCache
    from clearml_serving_tpu_torch.models.llama import Llama
    from clearml_serving_tpu_torch.ops.fused_matmul import fused_int4_matmul

    if family:
        log("phase 4e: small {} model, card (bf16, kernel) vs CPU (float32, plain "
            "version)".format(family))
    elif weight_quant:
        log("phase 4c: small model on {} weights, card (bf16, kernels) vs CPU (float32, "
            "plain versions)".format(weight_quant))
    else:
        log("phase 4: small model, card (bf16, kernel) vs CPU (float32, plain version)")
    base = SMALL_FAMILIES[family] if family else SMALL_MODEL
    card_params, ref_params = small_model_params(gen_seed, weight_quant,
                                                 base if family else None)
    for kv_quant in (("",) if weight_quant else ("", "int8")):
        cfg = dict(base, kv_quant=kv_quant)
        models = {
            "card": Llama(dict(cfg, dtype="bfloat16"), card_params),
            "cpu": Llama(dict(cfg, dtype="float32"), ref_params),
        }
        prompt = torch.randint(0, 256, (2, 40), generator=torch.Generator().manual_seed(1))
        lens = [40, 23]
        int4_before = fused_int4_matmul.launches
        logits = {}
        caches = {}
        for name, model in models.items():
            dev = model.device
            cache = PagedKVCache(model.n_layers, model.n_kv_heads, model.head_dim,
                                 num_pages=16, page_size=16, max_slots=2,
                                 dtype=model.dtype, kv_quant=kv_quant, device=dev)
            steps = []
            for slot, n in enumerate(lens):
                last, mini = model.prefill(prompt[slot:slot + 1].to(dev),
                                           torch.tensor([n], device=dev))
                scales = ((mini["k_scale"][:, 0, :n], mini["v_scale"][:, 0, :n])
                          if kv_quant else ())
                cache.write_prompt(slot, mini["k"][:, 0, :n], mini["v"][:, 0, :n], n,
                                   *scales)
                steps.append(last.float().cpu())
            logits[name] = [torch.cat(steps)]
            caches[name] = cache
        tokens = logits["cpu"][0].argmax(-1)
        for _step in range(4):
            for name, model in models.items():
                dev = model.device
                cache = caches[name]
                pool = cache.pool
                lengths0 = torch.as_tensor(pool.lengths().copy())
                wp, wo = [], []
                for slot in range(2):
                    start = pool.slot_length(slot)
                    pool.extend(slot, 1)
                    ((page, off),) = pool.token_coords(slot, start, 1)
                    wp.append(page)
                    wo.append(off)
                kw = ({"k_scales": cache.k_scale, "v_scales": cache.v_scale}
                      if kv_quant else {})
                out = model.decode_paged(
                    tokens.to(dev), cache.k, cache.v,
                    torch.as_tensor(pool.page_table(4), device=dev), lengths0.to(dev),
                    torch.tensor(wp, device=dev), torch.tensor(wo, device=dev), **kw,
                )
                logits[name].append(out.float().cpu())
            tokens = logits["cpu"][-1].argmax(-1)
        sync()
        # two prefills and four decode steps on the card
        int4_launches = fused_int4_matmul.launches - int4_before
        check_int4_launches(models["card"], int4_launches, len(lens) + 4, "phase 4c")
        card = torch.stack(logits["card"])
        ref = torch.stack(logits["cpu"])
        err = float((card - ref).abs().max())
        limit = 0.05 * float(ref.abs().max())
        strict = float((card.argmax(-1) == ref.argmax(-1)).float().mean())
        agree = strict
        if family:
            # phase 4b's rule over 10 rows: a row agrees when the card's top
            # token ties with the reference's inside the logit tolerance
            top = card.argmax(-1, keepdim=True)
            agree = float((ref.amax(-1) - ref.gather(-1, top)[..., 0] <= limit).float().mean())
        finite = bool(torch.isfinite(card).all())
        log("  kv={:<5} logits max_abs_err {:.3e} (scale {:.2f}), top-1 agreement {:.2f} "
            "(strict {:.2f}), fused_int4_matmul launches {}".format(
                kv_quant or "bf16", err, float(ref.abs().max()), agree, strict, int4_launches))
        if not finite or err > limit or agree < 0.9:
            raise AssertionError("small model on the card disagrees with the CPU reference")


def phase_small_ragged(gen_seed: int, weight_quant: str = "", family: str = "") -> None:
    """Three mixed ``forward_ragged`` steps of phase 4's model, bf16 on the
    card (ragged kernel, q-block aligned layout) against the same weights
    in float32 on the CPU (plain version, the same layout): decode rows at
    several histories, prefill chunks at history 0 and mid-history, an
    idle row. Histories are prefilled on each side; each later step's
    decode tokens are the CPU model's greedy tokens from the step before.
    The tolerance is phase 4's, 5% of the largest reference logit, and 0.9
    top-1 agreement over 33 rows, where a row agrees when the card's top
    token is the reference's or ties with it inside that tolerance: bf16
    activations (and int8 codes of bf16 vs f32 K/V, one apart at rounding
    ties) flip the odd near-tied row, and a flip inside the logit tolerance
    says nothing about the kernel. The strict agreement is printed beside
    it. ``family`` takes that model of ``SMALL_FAMILIES`` (phase 4e)."""
    from clearml_serving_tpu_torch.llm.kv_cache import PagedKVCache
    from clearml_serving_tpu_torch.models.llama import Llama
    from clearml_serving_tpu_torch.ops.fused_matmul import fused_int4_matmul
    from clearml_serving_tpu_torch.ops.paged_attention import RAGGED_QB, ragged_layout

    log("phase 4{}: small {}model forward_ragged{}, card (bf16, kernels) vs CPU "
        "(float32, plain versions)".format("e" if family else "c" if weight_quant else "b",
                                           family + " " if family else "",
                                           " on {} weights".format(weight_quant)
                                           if weight_quant else ""))
    base = SMALL_FAMILIES[family] if family else SMALL_MODEL
    card_params, ref_params = small_model_params(gen_seed, weight_quant,
                                                 base if family else None)
    # (history, query tokens per step): decode rows take one token a step
    rows = [(40, 1), (23, 1), (9, 1), (0, 20), (17, 12), (31, 1), (5, 9), (0, 0),
            (50, 1), (12, 1), (3, 6), (28, 1)]
    r = len(rows)
    prompt = torch.randint(0, 256, (r, 64), generator=torch.Generator().manual_seed(2))
    for kv_quant in (("",) if weight_quant else ("", "int8")):
        cfg = dict(base, kv_quant=kv_quant)
        int4_before = fused_int4_matmul.launches
        models = {
            "card": Llama(dict(cfg, dtype="bfloat16"), card_params),
            "cpu": Llama(dict(cfg, dtype="float32"), ref_params),
        }
        caches = {}
        for name, model in models.items():
            dev = model.device
            cache = PagedKVCache(model.n_layers, model.n_kv_heads, model.head_dim,
                                 num_pages=64, page_size=16, max_slots=r,
                                 dtype=model.dtype, kv_quant=kv_quant, device=dev)
            for slot, (hist, _n) in enumerate(rows):
                if hist:
                    _last, mini = model.prefill(prompt[slot:slot + 1, :hist].to(dev),
                                                torch.tensor([hist], device=dev))
                    scales = ((mini["k_scale"][:, 0], mini["v_scale"][:, 0])
                              if kv_quant else ())
                    cache.write_prompt(slot, mini["k"][:, 0], mini["v"][:, 0], hist, *scales)
            caches[name] = cache
        row_lens = [n for _h, n in rows]
        starts, block_rows, block_q0, t = ragged_layout(row_lens, RAGGED_QB)
        live = [slot for slot, n in enumerate(row_lens) if n]
        decode_tok = prompt[:, 0].clone()
        logits = {"card": [], "cpu": []}
        for step in range(3):
            for name, model in models.items():
                dev = model.device
                cache = caches[name]
                pool = cache.pool
                flat = {key: torch.zeros(t, dtype=torch.int32) for key in
                        ("tokens", "tok_pos", "tok_row", "write_page", "write_offset")}
                tok_valid = torch.zeros(t, dtype=torch.bool)
                row_last = torch.zeros(r, dtype=torch.int32)
                kv_lens = torch.zeros(r, dtype=torch.int32)
                for slot, (hist, n) in enumerate(rows):
                    if not n:
                        continue
                    s = int(starts[slot])
                    pre = pool.slot_length(slot)
                    pool.extend(slot, n)
                    coords = pool.token_coords(slot, pre, n)
                    if n == 1:
                        flat["tokens"][s] = decode_tok[slot] if step else prompt[slot, hist]
                    else:
                        flat["tokens"][s:s + n] = prompt[slot, pre:pre + n]
                    flat["tok_pos"][s:s + n] = pre + torch.arange(n)
                    flat["tok_row"][s:s + n] = slot
                    flat["write_page"][s:s + n] = torch.tensor([p for p, _ in coords])
                    flat["write_offset"][s:s + n] = torch.tensor([o for _, o in coords])
                    tok_valid[s:s + n] = True
                    row_last[slot] = s + n - 1
                    kv_lens[slot] = pre + n
                blocks = {}
                if torch.device(dev).type == "cuda":
                    blocks = {"block_rows": torch.as_tensor(block_rows, device=dev),
                              "block_q0": torch.as_tensor(block_q0, device=dev)}
                kw = ({"k_scales": cache.k_scale, "v_scales": cache.v_scale}
                      if kv_quant else {})
                out = model.forward_ragged(
                    flat["tokens"].long().to(dev), flat["tok_pos"].to(dev),
                    flat["tok_row"].to(dev), tok_valid.to(dev), row_last.to(dev),
                    cache.k, cache.v, torch.as_tensor(pool.page_table(8), device=dev),
                    kv_lens.to(dev), torch.as_tensor(starts, device=dev),
                    torch.tensor(row_lens, dtype=torch.int32, device=dev),
                    flat["write_page"].to(dev), flat["write_offset"].to(dev),
                    **blocks, **kw)
                logits[name].append(out.float().cpu()[live])
            decode_tok = torch.zeros(r, dtype=torch.long)
            decode_tok[live] = logits["cpu"][-1].argmax(-1)
        sync()
        # the histories' prefills and three mixed steps on the card
        int4_launches = fused_int4_matmul.launches - int4_before
        check_int4_launches(models["card"], int4_launches,
                            sum(1 for hist, _n in rows if hist) + 3, "phase 4c ragged")
        card = torch.stack(logits["card"])
        ref = torch.stack(logits["cpu"])
        err = float((card - ref).abs().max())
        limit = 0.05 * float(ref.abs().max())
        top = card.argmax(-1, keepdim=True)
        strict = float((top[..., 0] == ref.argmax(-1)).float().mean())
        agree = float((ref.amax(-1) - ref.gather(-1, top)[..., 0] <= limit).float().mean())
        finite = bool(torch.isfinite(card).all())
        log("  kv={:<5} logits max_abs_err {:.3e} (scale {:.2f}), top-1 agreement {:.2f} "
            "(strict {:.2f}) over {} rows, fused_int4_matmul launches {}".format(
                kv_quant or "bf16", err, float(ref.abs().max()), agree, strict,
                card.shape[0] * card.shape[1], int4_launches))
        if not finite or err > limit or agree < 0.9:
            raise AssertionError("forward_ragged on the card disagrees with the CPU reference")


def phase_small_verify(gen_seed: int) -> None:
    """One ``forward_ragged`` step of phase 4's model with speculative
    verify rows: chain and forest rows of k+1 = 5 tokens at several
    histories (a forest node at its path depth's RoPE position) beside
    decode rows, a prefill chunk and an idle row, bf16 on the card (ragged
    kernel with its tree mask, q-block aligned layout) against the same
    weights in float32 on the CPU (plain version, the same layout). Both
    the last-token logits and the per-position verify logits are held to
    phase 4b's tolerance (5% of the largest reference logit, 0.9 top-1
    agreement up to ties inside it)."""
    from clearml_serving_tpu_torch.llm.kv_cache import PagedKVCache
    from clearml_serving_tpu_torch.models.llama import Llama
    from clearml_serving_tpu_torch.ops.paged_attention import (
        RAGGED_QB, ragged_layout, ragged_paged_attention, tree_ancestors,
    )

    log("phase 4d: small model forward_ragged with verify rows, card (bf16, kernels) vs "
        "CPU (float32, plain versions)")
    card_params, ref_params = small_model_params(gen_seed)
    # (history, query tokens, verify topology)
    rows = [(40, 5, "chain"), (23, 1, None), (9, 5, "forest"), (0, 20, None),
            (31, 5, "forest"), (0, 0, None), (12, 5, "chain"), (28, 1, None)]
    depth_of = {"chain": [0, 1, 2, 3, 4], "forest": [0, 1, 2, 3, 1]}
    r = len(rows)
    gen = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, 256, (r, 64), generator=gen)
    row_lens = [n for _h, n, _t in rows]
    starts, block_rows, block_q0, t = ragged_layout(row_lens, RAGGED_QB)
    tokens = torch.zeros(t, dtype=torch.long)
    tok_pos = torch.zeros(t, dtype=torch.int32)
    tok_row = torch.zeros(t, dtype=torch.int32)
    tok_valid = torch.zeros(t, dtype=torch.bool)
    row_last = torch.zeros(r, dtype=torch.int32)
    kv_lens = torch.zeros(r, dtype=torch.int32)
    anc = torch.full((t, 5), -1, dtype=torch.int32)
    anc[:, 0] = -2
    row_logit_idx = torch.zeros(r, 5, dtype=torch.int32)
    for slot, (hist, n, topo) in enumerate(rows):
        if not n:
            continue
        s = int(starts[slot])
        tokens[s:s + n] = prompt[slot, hist:hist + n]
        depth = torch.tensor(depth_of[topo]) if topo else torch.arange(n)
        if topo:
            anc[s:s + n] = torch.from_numpy(tree_ancestors(*TREE_TOPOLOGIES[topo], width=5))
        tok_pos[s:s + n] = hist + depth
        tok_row[s:s + n] = slot
        tok_valid[s:s + n] = True
        row_last[slot] = s + n - 1
        kv_lens[slot] = hist + n
        row_logit_idx[slot] = s + torch.clamp(torch.arange(5), max=n - 1)
    live = [slot for slot, n in enumerate(row_lens) if n]
    for kv_quant in ("", "int8"):
        cfg = dict(SMALL_MODEL, kv_quant=kv_quant)
        models = {
            "card": Llama(dict(cfg, dtype="bfloat16"), card_params),
            "cpu": Llama(dict(cfg, dtype="float32"), ref_params),
        }
        outs = {}
        tree_before = ragged_paged_attention.tree_launches
        for name, model in models.items():
            dev = model.device
            cache = PagedKVCache(model.n_layers, model.n_kv_heads, model.head_dim,
                                 num_pages=64, page_size=16, max_slots=r,
                                 dtype=model.dtype, kv_quant=kv_quant, device=dev)
            pool = cache.pool
            write_page = torch.zeros(t, dtype=torch.int32)
            write_offset = torch.zeros(t, dtype=torch.int32)
            for slot, (hist, n, _topo) in enumerate(rows):
                if hist:
                    _last, mini = model.prefill(prompt[slot:slot + 1, :hist].to(dev),
                                                torch.tensor([hist], device=dev))
                    scales = ((mini["k_scale"][:, 0], mini["v_scale"][:, 0])
                              if kv_quant else ())
                    cache.write_prompt(slot, mini["k"][:, 0], mini["v"][:, 0], hist, *scales)
                if n:
                    s = int(starts[slot])
                    pool.extend(slot, n)
                    coords = pool.token_coords(slot, hist, n)
                    write_page[s:s + n] = torch.tensor([p for p, _ in coords])
                    write_offset[s:s + n] = torch.tensor([o for _, o in coords])
            blocks = {}
            if torch.device(dev).type == "cuda":
                blocks = {"block_rows": torch.as_tensor(block_rows, device=dev),
                          "block_q0": torch.as_tensor(block_q0, device=dev)}
            kw = ({"k_scales": cache.k_scale, "v_scales": cache.v_scale} if kv_quant else {})
            last, gathered = model.forward_ragged(
                tokens.to(dev), tok_pos.to(dev), tok_row.to(dev), tok_valid.to(dev),
                row_last.to(dev), cache.k, cache.v,
                torch.as_tensor(pool.page_table(8), device=dev), kv_lens.to(dev),
                torch.as_tensor(starts, device=dev),
                torch.tensor(row_lens, dtype=torch.int32, device=dev),
                write_page.to(dev), write_offset.to(dev), **blocks, **kw,
                row_logit_idx=row_logit_idx.to(dev), tree_anc=anc.to(dev))
            outs[name] = torch.cat([last.float().cpu()[live],
                                    gathered.float().cpu()[live].reshape(-1, last.shape[-1])])
        sync()
        tree_launches = ragged_paged_attention.tree_launches - tree_before
        if models["card"].device.type == "cuda" and tree_launches != models["card"].n_layers:
            raise AssertionError("phase 4d: {} tree launches for one forward call of {} "
                                 "layers".format(tree_launches, models["card"].n_layers))
        card, ref = outs["card"], outs["cpu"]
        err = float((card - ref).abs().max())
        limit = 0.05 * float(ref.abs().max())
        top = card.argmax(-1, keepdim=True)
        strict = float((top[:, 0] == ref.argmax(-1)).float().mean())
        agree = float((ref.amax(-1) - ref.gather(-1, top)[:, 0] <= limit).float().mean())
        finite = bool(torch.isfinite(card).all())
        log("  kv={:<5} last + verify logits max_abs_err {:.3e} (scale {:.2f}), top-1 "
            "agreement {:.2f} (strict {:.2f}) over {} rows, tree launches {}".format(
                kv_quant or "bf16", err, float(ref.abs().max()), agree, strict,
                card.shape[0], tree_launches))
        if not finite or err > limit or agree < 0.9:
            raise AssertionError("forward_ragged verify rows on the card disagree with the "
                                 "CPU reference")


# -- phase 5: the main path --------------------------------------------------------

PROMPTS = [
    "Write a haiku about the sea.",
    "Explain paged attention in two sentences.",
    "List three prime numbers larger than one hundred, separated by commas.",
    "What is the capital of France? Answer in one word, then say why it matters.",
]


async def post_chat(session, url, prompt, stream, max_tokens, sampling=None):
    body = {"model": "llama3-8b", "messages": [{"role": "user", "content": prompt}],
            "max_tokens": max_tokens, "stream": stream, **(sampling or {})}
    t0 = time.perf_counter()
    async with session.post(url, json=body) as r:
        if r.status != 200:
            raise AssertionError("HTTP {}: {}".format(r.status, await r.text()))
        if not stream:
            out = await r.json()
            return dict(content=out["choices"][0]["message"]["content"],
                        tokens=out["usage"]["completion_tokens"], ttft_s=None,
                        total_s=time.perf_counter() - t0)
        pieces, ttft = [], None
        async for raw in r.content:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            chunk = json.loads(line[len("data: "):])
            if "error" in chunk:
                raise AssertionError("stream error: {}".format(chunk["error"]))
            piece = chunk["choices"][0]["delta"].get("content")
            if piece:
                ttft = ttft or time.perf_counter() - t0
                pieces.append(piece)
        return dict(content="".join(pieces), tokens=None, ttft_s=ttft,
                    total_s=time.perf_counter() - t0)


def processor_app(engine, tokenizer, url: str = "llama3-8b", **engine_cfg):
    """The port's router (``build_app(processor)``) over a processor whose
    ``llm`` endpoint ``url`` serves ``engine`` (``LLMEngineRequest.wrap``;
    ``engine_cfg``: the endpoint's knobs, such as ``warmup``), on a fresh
    state root under ``build/``. The app's cleanup stops the engine."""
    from clearml_serving_tpu_torch.llm.openai_api import LLMEngineRequest
    from clearml_serving_tpu_torch.serving.main import build_app
    from clearml_serving_tpu_torch.serving.model_request_processor import (
        ModelRequestProcessor,
    )

    processor = ModelRequestProcessor(state_root=state_dir(), force_create=True, name=url,
                                      device=DEV)
    proc = LLMEngineRequest.wrap(engine, tokenizer, url, engine_cfg=engine_cfg)
    processor.add_endpoint(proc.endpoint)
    processor.serialize()
    processor.deserialize(skip_sync=True)
    processor._engine_processor_lookup[url] = proc
    return build_app(processor)


def state_dir() -> str:
    """A fresh control-plane state root under the checkout's ``build/``."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "state")
    os.makedirs(root, exist_ok=True)
    return tempfile.mkdtemp(dir=root)


async def serve_and_chat(engine, tokenizer, max_tokens=32, profiler=None, prompts=PROMPTS,
                         warmup="off"):
    """Start the port's app on a local port (aux ``engine.warmup`` mode
    ``warmup``), warm it up with the same prompts (first-use costs of every
    prefill bucket), zero the counts (their values at that point are kept
    as ``warm_counters``), POST the chats concurrently (the first two
    streaming) and read the counts."""
    import aiohttp
    from aiohttp import web

    from clearml_serving_tpu_torch.ops.fused_matmul import fused_int4_matmul
    from clearml_serving_tpu_torch.ops.paged_attention import paged_attention

    app = processor_app(engine, tokenizer, warmup=warmup)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = runner.addresses[0][1]
    url = "http://127.0.0.1:{}/serve/openai/v1/chat/completions".format(port)
    try:
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as s:
            await asyncio.gather(*[post_chat(s, url, p, False, 4) for p in prompts])
            await engine.wait_drained()
            warm_counters = dict(engine.counters)
            paged_attention.launches = 0
            fused_int4_matmul.launches = 0
            for key in engine.counters:
                engine.counters[key] = 0
            engine.ttft_ms.clear()
            if profiler is not None:
                profiler.start()
            t0 = time.perf_counter()
            results = await asyncio.gather(*[
                post_chat(s, url, p, stream=i < 2, max_tokens=max_tokens)
                for i, p in enumerate(prompts)
            ])
            wall = time.perf_counter() - t0
            await engine.wait_drained()
            if profiler is not None:
                stop_profiler(profiler)
            launches = paged_attention.launches
            counters = dict(engine.counters, ttft_ms=sorted(engine.ttft_ms),
                            int4_launches=fused_int4_matmul.launches,
                            warm_counters=warm_counters,
                            pipeline=engine.lifecycle_stats()["pipeline"])
    finally:
        await runner.cleanup()
    return results, wall, launches, counters


def _engine(params, kv_quant, preset, cuda_graphs=True, **knobs):
    """An engine of ``preset`` on ``params``; a tree holding fewer layers
    than the preset (a depth cut, ``depth_cut``) sets the config's
    ``n_layers`` to its own unless ``knobs`` name a config."""
    from clearml_serving_tpu_torch.llm.openai_api import build_engine
    from clearml_serving_tpu_torch.models.llama import resolve_config

    cfg = {"preset": preset, "cache": "paged", "max_batch": 8, "max_seq_len": 2048,
           "page_size": 16, "decode_steps": 4, "seed": 0, **knobs}
    if params is not None and "config" not in knobs:
        depth = len(params["layers"])
        if depth != resolve_config({"preset": preset})["n_layers"]:
            cfg["config"] = {"n_layers": depth}
    if kv_quant:
        cfg["kv_quant"] = kv_quant
    return build_engine(cfg, device=DEV, params=params, cuda_graphs=cuda_graphs)


def expected_weight_bytes(preset: str, weight_quant: str, config=None) -> int:
    """Bytes of every weight leaf of ``preset`` (with ``config`` over it) in
    its dtype, its projections in ``weight_quant``'s leaf format, QKV biases in
    the dtype and no lm_head when tied: what ``health()["weights"]["bytes"]``
    must read."""
    from clearml_serving_tpu_torch.models.llama import resolve_config
    from clearml_serving_tpu_torch.ops.quant import int4_groups

    cfg = resolve_config({"preset": preset, **(config or {})})
    dim, ffn, vocab = int(cfg["dim"]), int(cfg["ffn_dim"]), int(cfg["vocab_size"])
    heads, kv = int(cfg["n_heads"]), int(cfg["n_kv_heads"])
    hd = int(cfg.get("head_dim") or dim // heads)
    es = torch.tensor([], dtype=getattr(torch, cfg["dtype"])).element_size()

    def leaf(k, n):
        if weight_quant == "int4":
            return k * n // 2 + int4_groups(k) * n * 4
        if weight_quant == "int8":
            return k * n + n * 4
        return k * n * es

    layer = 2 * dim * es + sum(leaf(k, n) for k, n in (
        (dim, heads * hd), (dim, kv * hd), (dim, kv * hd), (heads * hd, dim),
        (dim, ffn), (dim, ffn), (ffn, dim)))
    if cfg.get("attn_bias"):
        layer += (heads + 2 * kv) * hd * es
    head = 0 if cfg.get("tie_embeddings") else leaf(dim, vocab)
    return vocab * dim * es + dim * es + head + int(cfg["n_layers"]) * layer


def check_weights(engine, preset: str, weight_quant: str, config=None) -> dict:
    weights = engine.health()["weights"]
    want = {"quant": weight_quant or "none",
            "bytes": expected_weight_bytes(preset, weight_quant, config)}
    if weights != want:
        raise AssertionError("health()['weights'] reads {}, want {}".format(weights, want))
    return weights


def check_int4_route(engine, c, label) -> None:
    """The int4 kernel once per projection per forward call of the run."""
    forwards = c["prefills"] + c["decode_steps"] + c["ragged_steps"] + c["ragged_chain_steps"]
    check_int4_launches(engine.model, c["int4_launches"], forwards, label)


def phase_main_path(params, kv_quant: str, preset: str = "llama3-8b", weight_quant: str = "",
                    max_tokens: int = 32, prompts=PROMPTS, config=None) -> dict:
    """Phase 5's traffic through the processor on an engine of ``preset``
    (``config``: the aux engine.config over it)."""
    from clearml_serving_tpu_torch.llm import shapes

    knobs = {"weight_quant": weight_quant} if weight_quant else {}
    if config:
        knobs["config"] = config
    engine, tokenizer = _engine(params, kv_quant, preset, **knobs)
    weights = check_weights(engine, preset, weight_quant, config)
    pools = engine.paged_cache.pool_bytes()
    prefill_rows = [shapes.bucket_for(len(tokenizer.encode_chat(tokenizer.apply_chat_template(
        [{"role": "user", "content": p}]))), engine._buckets, engine.max_seq_len)
        for p in prompts]
    results, wall, launches, c = asyncio.run(
        serve_and_chat(engine, tokenizer, max_tokens=max_tokens, prompts=prompts))
    n_layers = engine.model.n_layers
    check_int4_route(engine, c, "main path " + (weight_quant or "bf16"))
    del engine
    if torch.device(DEV).type == "cuda":
        torch.cuda.empty_cache()
    streamed = [r for r in results if r["ttft_s"] is not None]
    steps = c["decode_steps"]
    out = dict(
        weights=weight_quant or "bf16", weight_bytes=weights["bytes"],
        int4_launches=c["int4_launches"], prefills=c["prefills"], prefill_rows=prefill_rows,
        kv=kv_quant or "bf16", wall_s=wall, launches=launches, decode_steps=steps,
        tokens=c["tokens_emitted"],
        # engine-side: request parsed -> first token emitted
        ttft_ms=c["ttft_ms"],
        # client-side, streamed requests: POST -> first SSE chunk with text
        # (random bytes are often held back as partial UTF-8)
        first_text_ms=[r["ttft_s"] * 1e3 for r in streamed],
        # tokens the engine emitted for the four requests over their wall time
        decode_tok_s=c["tokens_emitted"] / wall,
        # engine host time per decode step (chunks end in a device->host read)
        step_ms=c["decode_ms"] / max(1, steps),
        prefill_ms=c["prefill_ms"] / max(1, c["prefills"]),
        pool_gib=(pools["kv"] + pools["scale"]) / 2 ** 30,
    )
    log("  weights={weights} ({weight_bytes} bytes) kv={kv}: wall {wall_s:.3f} s, {tokens} "
        "tokens, decode steps {decode_steps} ({step_ms:.2f} ms each), prefill {prefill_ms:.2f} "
        "ms each, paged_attention launches {launches}, fused_int4_matmul launches "
        "{int4_launches}, prefill rows {prefill_rows}, TTFT {ttft_ms} ms, "
        "{decode_tok_s:.1f} tok/s aggregate, pools {pool_gib:.2f} GiB".format(**out))
    log("  contents:", json.dumps([r["content"][:24] for r in results]))
    if not all(r["content"] for r in results):
        raise AssertionError("an empty completion")
    if any(r["tokens"] is not None and r["tokens"] != max_tokens for r in results):
        raise AssertionError("a completion stopped before max_tokens")
    if steps == 0 or launches != n_layers * steps:
        raise AssertionError("paged_attention launched {} times for {} decode steps of {} "
                             "layers".format(launches, steps, n_layers))
    return out


def phase_profile(params, scheduler: str = "two_dispatch", weight_quant: str = "",
                  pipeline_depth=None, cuda_graphs: bool = True, traffic=None,
                  check_reader: bool = False, ragged_graphs: bool = True) -> dict:
    """The bf16-KV main-path run of a scheduler once more under torch.profiler
    (two-dispatch: phase 5's traffic, or ``traffic``, a ``PIPELINE_TRAFFIC``
    entry): device time by kernel name, each ported kernel's time (the
    union of its grids' intervals) and the device's busy share of the run's
    wall time (the union of all kernel intervals). Profiling adds host
    overhead, so these shares describe this pass only. On a pass whose
    steps replayed graphs (two-dispatch; ragged, its launch keys captured
    by ``warmup: full`` before the profiler starts), the decode kernel's,
    the ragged kernel's and the int4 kernel's instances in the trace must
    equal their ``launches`` counts over the same window: a replay adds the
    counts its capture recorded, and this holds them to kernels the card
    ran. Eager passes count every launch in the wrapper and only print the
    comparison: an
    eager pass's trace has come up short (1020 of 1024 counted grids on an
    H100), and so has a graph pass's (4095 of 4096), as if the profiler
    dropped records. A graph pass whose trace disagrees is therefore
    profiled once more, on a fresh engine: a launch that did not run would
    make the second trace disagree too, and then the phase fails. With
    ``check_reader`` the trace's raw reading is held to ``prof.events()``
    (``device_events``). ``ragged_graphs`` off: a ragged pass's steps run
    eagerly beside graphed decode chunks, as before the ragged graphs
    (the same depth, to set beside the graphed pass)."""
    out = _profiled_pass(params, scheduler, weight_quant, pipeline_depth, cuda_graphs, traffic,
                         check_reader, ragged_graphs)
    if out["checked"] and not out["trace_agrees"]:
        log("  the trace disagrees with the counts: profiling the pass once more")
        out = _profiled_pass(params, scheduler, weight_quant, pipeline_depth, cuda_graphs,
                             traffic, ragged_graphs=ragged_graphs)
        if not out["trace_agrees"]:
            raise AssertionError("the trace holds {} decode-attention, {} ragged-attention and "
                                 "{} int4 grids, the counts say {}, {} and {}".format(
                                     out["traced_paged"], out["traced_ragged"],
                                     out["traced_int4"], out["paged_launches"],
                                     out["ragged_launches"], out["int4_launches"]))
    return out


def device_events(prof, check: bool = False) -> list:
    """The device events of a stopped torch.profiler trace as (name, start
    µs, end µs from the trace's start), read from its raw kineto records,
    as ``prof.events()`` converts them: ``prof.events()`` builds the whole
    host-op tree first, which takes tens of seconds on these traces. With
    ``check`` the two readings must be equal."""
    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    out = [(e.name(), (e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3)
           for e in results.events() if e.device_type() == torch.autograd.DeviceType.CUDA]
    if check:
        ref = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if sorted(out) != sorted(ref):
            raise AssertionError("the raw trace holds {} device events, prof.events() {}"
                                 .format(len(out), len(ref)))
    return out


# phase 6 profiles Llama-3-8B's widths at 8 of its 32 layers (the script's
# time limit: 16 since phase 15 joined it, 8 since phase 16 did)
PROFILE_LAYERS = 8
# phase 10 runs 16 of its 32 layers since phase 16 joined the script, 8
# since phase 18 did (phase 11 stays at 32: at 16, 11c's trace held 64 =
# 16 x 4 paged grids more than the counts, twice, as a first-use capture's
# warm-up chunk in its profiled window would: the counts leave that set-up
# work out)
SURFACE_LAYERS = 8
# phases 7 and 8 run 16 of the 32 layers since phase 17 joined the script
# (its ~45 s on the card; the whole script keeps to half its limit), 8
# since phase 18 did (605.6 s whole on a slow host)
LIFECYCLE_LAYERS = 8
PREFIX_LAYERS = 8
# phase 5f runs 8 of the 32 layers since phase 19 joined the script (16
# since phase 18 did); phase 12 runs 16 since phase 19 joined it (all 32
# before)
GRAPH_LAYERS = 8
ADMIT_LAYERS = 16


def depth_cut(params, n_layers: int) -> dict:
    """The first ``n_layers`` layers of a parameter tree (the tensors
    shared, not copied)."""
    return dict(params, layers=params["layers"][:n_layers])


def _profiled_pass(params, scheduler, weight_quant, pipeline_depth, cuda_graphs,
                   traffic, check_reader=False, ragged_graphs=True) -> dict:
    """One profiled pass of ``phase_profile``: its numbers, and whether
    the trace's decode-attention and int4 grids equal the counts
    (``trace_agrees``; ``checked`` on a two-dispatch pass with graphs).
    The model is the first ``PROFILE_LAYERS`` layers of ``params``."""
    from torch.profiler import ProfilerActivity, profile

    t_pass = time.perf_counter()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    params = depth_cut(params, PROFILE_LAYERS)
    knobs = {}
    if weight_quant:
        knobs["weight_quant"] = weight_quant
    if pipeline_depth is not None:
        knobs["pipeline_depth"] = pipeline_depth
    label = "phase5"
    if scheduler == "ragged":
        engine, tokenizer = _engine(params, "", "llama3-8b", cuda_graphs, **RAGGED_KNOBS, **knobs)
        if not ragged_graphs:
            engine._ragged_graphs = None
        # every plain launch key captured before the profiler starts
        _results, wall, c = asyncio.run(serve_ragged(engine, tokenizer, profiler=prof,
                                                     warmup="full"))
        label = "phase5b"
    elif scheduler == "ragged-tree":
        # phase 5d's tree arm under its traffic
        engine, tokenizer = _engine(params, "", "llama3-8b", cuda_graphs, **TREE_KNOBS, **knobs)
        if not ragged_graphs:
            engine._ragged_graphs = None
        _results, wall, c = asyncio.run(serve_ragged(
            engine, tokenizer, max_tokens=SPEC_MAX_TOKENS, profiler=prof, prompts=SPEC_PROMPTS,
            samplings=SPEC_SAMPLINGS, warmup="full"))
        label = "phase5d"
    else:
        label, prompts, max_tokens = traffic or ("phase5", PROMPTS, 32)
        engine, tokenizer = _engine(params, "", "llama3-8b", cuda_graphs, **knobs)
        _results, wall, launches, c = asyncio.run(serve_and_chat(
            engine, tokenizer, max_tokens=max_tokens, profiler=prof, prompts=prompts))
        c["paged_launches"] = launches
    depth, graphs = engine.pipeline_depth, engine._graphs is not None
    ragged_graphs = engine._ragged_graphs is not None
    del engine
    torch.cuda.empty_cache()
    t_trace = time.perf_counter()
    kernels = device_events(prof, check=check_reader)
    t_trace = time.perf_counter() - t_trace
    by_name = {}
    for name, t0, t1 in kernels:
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e3

    def busy_ms(match=lambda name: True):
        """ms of the union of the matching kernels' intervals: a grid
        launched as a programmatic dependent shows from its early start,
        while it waits on the grid before it, so a sum would count the
        overlap twice."""
        busy, end = 0.0, None
        for t0, t1 in sorted((t0, t1) for name, t0, t1 in kernels if match(name)):
            if end is None or t0 > end:
                busy += t1 - t0
                end = t1
            elif t1 > end:
                busy += t1 - end
                end = t1
        return busy / 1e3

    busy = busy_ms() * 1e3
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # the decode kernel's two grids (csrc/paged_attention.cu)
    attn = busy_ms(lambda k: "paged_split_kernel" in k or "paged_combine_kernel" in k)
    # the ragged kernel's two grids (csrc/ragged_paged_attention.cu)
    ragged = busy_ms(lambda k: "ragged_attention_" in k)
    int4 = busy_ms(lambda k: "w4a16_" in k)
    # one split grid per decode-attention call, one main grid per int4 call
    # (csrc/paged_attention.cu, csrc/fused_int4_matmul.cu)
    traced_paged = sum("paged_split_kernel" in name for name, _t0, _t1 in kernels)
    traced_int4 = sum("w4a16_decode_kernel" in name or "w4a16_block_kernel" in name
                      for name, _t0, _t1 in kernels)
    # one main grid per ragged-attention call (csrc/ragged_paged_attention.cu)
    traced_ragged = sum("ragged_attention_kernel" in name for name, _t0, _t1 in kernels)
    out = dict(scheduler=scheduler, traffic=label, weights=weight_quant or "bf16", depth=depth,
               graphs=graphs, ragged_graphs=ragged_graphs, wall_ms=wall * 1e3,
               device_busy_ms=busy / 1e3, busy_share=busy / 1e3 / (wall * 1e3),
               kernel_ms=total, paged_attention_ms=attn, ragged_attention_ms=ragged,
               int4_matmul_ms=int4, decode_steps=c["decode_steps"],
               step_ms=c["decode_ms"] / max(1, c["decode_steps"]),
               ragged_steps=c["ragged_steps"], graph_replays=c["graph_replays"],
               ragged_replays=c["ragged_replays"],
               ragged_step_ms=c["ragged_ms"] / max(1, c["ragged_steps"]),
               paged_launches=c["paged_launches"], traced_paged=traced_paged,
               int4_launches=c["int4_launches"], traced_int4=traced_int4,
               ragged_launches=c.get("ragged_launches", 0), traced_ragged=traced_ragged,
               top=[(k[:60], v) for k, v in top],
               pass_s=time.perf_counter() - t_pass, trace_s=t_trace)
    log("  profiled {weights}-weight {scheduler} pass, {traffic} traffic (depth {depth}, graphs "
        "{graphs}, ragged graphs {ragged_graphs}): wall {wall_ms:.1f} ms, device busy "
        "{device_busy_ms:.1f} ms ({busy_share:.1%}), kernels {kernel_ms:.1f} ms, paged "
        "attention {paged_attention_ms:.2f} ms over {decode_steps} decode steps "
        "({step_ms:.2f} ms each), ragged "
        "attention {ragged_attention_ms:.2f} ms over {ragged_steps} ragged steps "
        "({ragged_step_ms:.2f} ms each), int4 matmul {int4_matmul_ms:.2f} ms; {graph_replays} "
        "chunk and {ragged_replays} ragged replays; in the trace {traced_paged} "
        "decode-attention, {traced_ragged} ragged-attention and {traced_int4} int4 grids, "
        "counted {paged_launches}, {ragged_launches} and {int4_launches}; the pass "
        "{pass_s:.1f} s, reading its trace {trace_s:.1f} s".format(**out))
    # graphed passes: two-dispatch, and the ragged ones, whose launch keys
    # were all captured before the profiler started
    out["checked"] = graphs and (scheduler == "two_dispatch" or (
        scheduler in ("ragged", "ragged-tree") and ragged_graphs))
    out["trace_agrees"] = (traced_paged, traced_int4, traced_ragged) == (
        c["paged_launches"], c["int4_launches"], c.get("ragged_launches", 0))
    for name, ms in top:
        log("    {:9.2f} ms  {}".format(ms, name[:100]))
    return out


# -- phase 5b: the ragged main path ------------------------------------------------

RAGGED_KNOBS = {"scheduler": "ragged", "step_token_budget": 256}
_NOTES = ("Meeting notes, platform team. The paged KV cache keeps every sequence in "
          "fixed-size pages, so memory holds only the tokens that exist. The ragged "
          "scheduler packs decode rows and prompt chunks into one launch per step, and "
          "the token budget bounds how much prefill rides beside the decode batch. ")
# about 600 to 1500 tokens each through the byte tokenizer
LONG_PROMPTS = [
    "Summarise these notes in one paragraph. " + (_NOTES * 7)[:n]
    for n in (560, 860, 1160, 1460)
]


async def serve_ragged(engine, tokenizer, max_tokens=32, profiler=None, prompts=None,
                       samplings=None, warmup="off"):
    """Start the port's app (aux ``engine.warmup`` mode ``warmup``), warm it
    up with the prompts (default: the four long ones), zero the counts
    (their values at that point are kept as ``warm_counters``), then POST
    the chats (the first two streaming) staggered: each is sent once every
    earlier one has its first token, so every admission's chunk rows share
    launches with live decode rows. Returns (results, wall seconds,
    counters with ttft_ms, step_rows and the kernels' launches, and the
    capture warm-up runs' set-up launches)."""
    import aiohttp
    from aiohttp import web

    from clearml_serving_tpu_torch.ops.fused_matmul import fused_int4_matmul
    from clearml_serving_tpu_torch.ops.paged_attention import (
        paged_attention, ragged_paged_attention,
    )

    app = processor_app(engine, tokenizer, warmup=warmup)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = runner.addresses[0][1]
    url = "http://127.0.0.1:{}/serve/openai/v1/chat/completions".format(port)
    try:
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as s:
            prompts = prompts or LONG_PROMPTS
            samplings = samplings or [None] * len(prompts)
            await asyncio.gather(*[post_chat(s, url, p, False, 4) for p in prompts])
            await engine.wait_drained()
            warm_counters = dict(engine.counters)
            for fn in (paged_attention, ragged_paged_attention, fused_int4_matmul):
                fn.launches = fn.setup_launches = 0
            ragged_paged_attention.tree_launches = 0
            for key in engine.counters:
                engine.counters[key] = 0
            for key in engine.step_rows:
                engine.step_rows[key] = 0
            engine.ttft_ms.clear()
            if profiler is not None:
                profiler.start()
            t0 = time.perf_counter()
            tasks = []
            for i, prompt in enumerate(prompts):
                while len(engine.ttft_ms) < i:
                    await asyncio.sleep(0.002)
                tasks.append(asyncio.ensure_future(
                    post_chat(s, url, prompt, stream=i < 2, max_tokens=max_tokens,
                              sampling=samplings[i])))
            results = await asyncio.gather(*tasks)
            wall = time.perf_counter() - t0
            await engine.wait_drained()
            if profiler is not None:
                stop_profiler(profiler)
            counters = dict(engine.counters, ttft_ms=list(engine.ttft_ms),
                            step_rows=dict(engine.step_rows),
                            paged_launches=paged_attention.launches,
                            ragged_launches=ragged_paged_attention.launches,
                            tree_launches=ragged_paged_attention.tree_launches,
                            int4_launches=fused_int4_matmul.launches,
                            paged_setup=paged_attention.setup_launches,
                            ragged_setup=ragged_paged_attention.setup_launches,
                            warm_counters=warm_counters)
    finally:
        await runner.cleanup()
    return results, wall, counters


def phase_ragged_main_path(params, kv_quant: str, preset: str = "llama3-8b",
                           weight_quant: str = "", config=None) -> dict:
    """Phase 5b's traffic under ``scheduler: ragged`` (``config`` as in
    ``phase_main_path``)."""
    knobs = {"weight_quant": weight_quant} if weight_quant else {}
    if config:
        knobs["config"] = config
    engine, tokenizer = _engine(params, kv_quant, preset, **RAGGED_KNOBS, **knobs)
    weights = check_weights(engine, preset, weight_quant, config)
    prompt_tokens = [len(tokenizer.encode_chat(tokenizer.apply_chat_template(
        [{"role": "user", "content": p}]))) for p in LONG_PROMPTS]
    results, wall, c = asyncio.run(serve_ragged(engine, tokenizer))
    n_layers = engine.model.n_layers
    check_int4_route(engine, c, "ragged main path " + (weight_quant or "bf16"))
    del engine
    if torch.device(DEV).type == "cuda":
        torch.cuda.empty_cache()
    steps = c["ragged_steps"]
    out = dict(
        weights=weight_quant or "bf16", weight_bytes=weights["bytes"],
        int4_launches=c["int4_launches"],
        kv=kv_quant or "bf16", wall_s=wall, prompt_tokens=prompt_tokens,
        tokens=c["tokens_emitted"], ragged_steps=steps, step_rows=c["step_rows"],
        ragged_decode_tokens=c["ragged_decode_tokens"],
        ragged_chain_steps=c["ragged_chain_steps"], decode_steps=c["decode_steps"],
        ragged_launches=c["ragged_launches"], paged_launches=c["paged_launches"],
        # engine-side: request parsed -> first token emitted, in arrival order
        ttft_ms=c["ttft_ms"],
        decode_tok_s=c["tokens_emitted"] / wall,
        # engine host time per ragged step (each ends in a device->host read)
        ragged_step_ms=c["ragged_ms"] / max(1, steps),
        step_ms=c["decode_ms"] / max(1, c["decode_steps"]),
    )
    log("  weights={weights} kv={kv}: prompts {prompt_tokens} tokens, wall {wall_s:.3f} s, "
        "{tokens} tokens, {decode_tok_s:.1f} tok/s aggregate; ragged steps {ragged_steps} "
        "({ragged_step_ms:.2f} ms each), rows {step_rows}, chained window steps "
        "{ragged_chain_steps}; decode steps {decode_steps} ({step_ms:.2f} ms each); launches "
        "ragged {ragged_launches} paged {paged_launches} int4 {int4_launches}; TTFT {ttft_ms} "
        "ms".format(**out))
    log("  contents:", json.dumps([r["content"][:24] for r in results]))
    if not all(r["content"] for r in results):
        raise AssertionError("an empty completion")
    if any(r["tokens"] is not None and r["tokens"] != 32 for r in results) or \
            c["tokens_emitted"] != 32 * len(LONG_PROMPTS):
        raise AssertionError("a completion stopped before max_tokens")
    if c["step_rows"]["prefill"] < 8 or c["step_rows"]["decode"] < 1:
        raise AssertionError("no mixed launches: step rows {}".format(c["step_rows"]))
    if steps == 0 or c["ragged_launches"] != n_layers * steps:
        raise AssertionError("ragged_paged_attention launched {} times for {} ragged steps of "
                             "{} layers".format(c["ragged_launches"], steps, n_layers))
    if c["paged_launches"] != n_layers * (c["decode_steps"] + c["ragged_chain_steps"]):
        raise AssertionError("paged_attention launched {} times for {} decode steps and {} "
                             "chained window steps of {} layers".format(
                                 c["paged_launches"], c["decode_steps"],
                                 c["ragged_chain_steps"], n_layers))
    return out


# -- phase 5d: speculative verify rows on the ragged main path ----------------

SPEC_KNOBS = dict(RAGGED_KNOBS, speculation="ngram", spec_k=4)
TREE_KNOBS = dict(SPEC_KNOBS, spec_tree=True, spec_branch=2)
# (arm, KV, knobs): on bf16 KV the plain ragged arm the greedy streams are
# held to, then chain and tree verify rows; on int8 KV a plain and a tree arm
SPEC_ARMS = [("plain", "", RAGGED_KNOBS), ("chain", "", SPEC_KNOBS), ("tree", "", TREE_KNOBS),
             ("plain", "int8", RAGGED_KNOBS), ("tree", "int8", TREE_KNOBS)]
# repetitive chats (the n-gram proposer drafts from repeats); the third
# samples at temperature 0.7 among its 40 likeliest tokens (the random
# weights' lm_head is zero past the 256 byte ids, which render as nothing)
SPEC_PROMPTS = [
    "Copy this list exactly: " + "red, green, blue, " * 24,
    "Continue the pattern: " + "1 2 3 4 5 6 7 8 9 10 " * 12,
    "Say it again and again: " + "the quick brown fox. " * 20,
    "Repeat: " + "ab ab ab ab cd cd cd cd " * 14,
]
SPEC_SAMPLINGS = [None, None, {"temperature": 0.7, "top_k": 40}, None]
SPEC_MAX_TOKENS = 64


def first_difference(a: str, b: str):
    """Index of the first differing character of two strings (None when
    they are equal)."""
    if a == b:
        return None
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def phase_spec_main_path(params, arm: str, kv_quant: str, knobs: dict,
                         preset: str = "llama3-8b") -> dict:
    """Llama-3-8B behind the HTTP app under ``scheduler: ragged`` (budget
    256) with the arm's speculation knobs; four staggered repetitive chats,
    one sampled. Checks verify rows ran (and tree depths on the tree arm)
    and the launch identities: the ragged kernel once per layer per ragged
    step, its tree variant once per layer per verify step of a tree
    engine, the decode kernel once per layer per decode and chained window
    step."""
    engine, tokenizer = _engine(params, kv_quant, preset, **knobs)
    streams = record_streams(engine)
    results, wall, c = asyncio.run(serve_ragged(
        engine, tokenizer, max_tokens=SPEC_MAX_TOKENS, prompts=SPEC_PROMPTS,
        samplings=SPEC_SAMPLINGS))
    ragged = engine.health()["ragged"]
    n_layers = engine.model.n_layers
    del engine
    if torch.device(DEV).type == "cuda":
        torch.cuda.empty_cache()
    steps = c["ragged_steps"]
    out = dict(
        arm=arm, kv=kv_quant or "bf16", wall_s=wall, tokens=c["tokens_emitted"],
        ragged_steps=steps, verify_steps=c["ragged_verify_steps"], step_rows=c["step_rows"],
        decode_steps=c["decode_steps"], ragged_chain_steps=c["ragged_chain_steps"],
        ragged_launches=c["ragged_launches"], tree_launches=c["tree_launches"],
        paged_launches=c["paged_launches"],
        # decode tokens a ragged launch committed (accepted drafts + bonus)
        accepted_per_launch=c["ragged_decode_tokens"] / max(1, steps),
        ttft_ms=c["ttft_ms"], tok_s=c["tokens_emitted"] / wall,
        ragged_step_ms=c["ragged_ms"] / max(1, steps),
        spec_acceptance=ragged["spec_acceptance"], spec_tree_depth=ragged["spec_tree_depth"],
        spec_proposer=ragged["spec_proposer"],
        contents=[r["content"] for r in results],
        # each chat's (prompt ids, generated ids), from its last request
        token_ids=[next((p, ids) for p, ids in streams.items()
                        if prompt in tokenizer.decode(p)) for prompt in SPEC_PROMPTS],
    )
    log("  {arm} kv={kv}: wall {wall_s:.3f} s, {tokens} tokens, {tok_s:.1f} tok/s; ragged "
        "steps {ragged_steps} ({ragged_step_ms:.2f} ms each; {verify_steps} with verify "
        "rows), {accepted_per_launch:.3f} decode tokens per launch, rows {step_rows}; "
        "launches ragged {ragged_launches} (tree {tree_launches}) paged {paged_launches}; "
        "TTFT {ttft_ms} ms; proposer {spec_proposer}".format(**out))
    if not all(r["content"] for r in results):
        raise AssertionError("an empty completion")
    if c["tokens_emitted"] != SPEC_MAX_TOKENS * len(SPEC_PROMPTS):
        raise AssertionError("a completion stopped before max_tokens: {} tokens".format(
            c["tokens_emitted"]))
    if steps == 0 or c["ragged_launches"] != n_layers * steps:
        raise AssertionError("ragged_paged_attention launched {} times for {} ragged steps of "
                             "{} layers".format(c["ragged_launches"], steps, n_layers))
    if c["paged_launches"] != n_layers * (c["decode_steps"] + c["ragged_chain_steps"]):
        raise AssertionError("paged_attention launched {} times for {} decode and {} chained "
                             "steps".format(c["paged_launches"], c["decode_steps"],
                                            c["ragged_chain_steps"]))
    tree = bool(knobs.get("spec_tree"))
    if c["tree_launches"] != (n_layers * c["ragged_verify_steps"] if tree else 0):
        raise AssertionError("{} tree launches for {} verify steps ({} arm)".format(
            c["tree_launches"], c["ragged_verify_steps"], arm))
    if knobs.get("speculation") and c["step_rows"]["spec_verify"] < 1:
        raise AssertionError("no verify rows ran: {}".format(c["step_rows"]))
    if tree and ragged["spec_tree_depth"]["count"] < 1:
        raise AssertionError("no tree acceptance depth recorded")
    return out


# -- phase 5f: the ragged launch as CUDA graphs --------------------------------

# (arm, KV, knobs, traffic): phase 5b's traffic on bf16 and int8 KV, phase
# 5d's tree arm on its own; each graphed and eager
GRAPHED_ARMS = [("plain", "", RAGGED_KNOBS, "5b"), ("plain", "int8", RAGGED_KNOBS, "5b"),
                ("tree", "", TREE_KNOBS, "5d")]


def step_split_class():
    """``StepSplit`` of ``scripts/ragged_step_split.py``: host timers of a
    ragged step's parts."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "ragged_step_split.py")
    spec = importlib.util.spec_from_file_location("ragged_step_split", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.StepSplit


class ReplayClock:
    """CUDA events on the engine's stream around each ragged replay (its
    uploads, its draws' copies and the graph) while armed: the device time
    of a graphed step, whose kernels run back to back. Armed by
    ``serve_ragged`` around its timed traffic, with the step timers."""

    def __init__(self, engine, split):
        self.split, self.events, self.armed = split, [], False
        graphs = engine._ragged_graphs
        if graphs is None:
            return
        replay = graphs.replay

        def timed(*args):
            if not self.armed:
                return replay(*args)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            out = replay(*args)
            end.record()
            self.events.append((start, end))
            return out

        graphs.replay = timed

    def start(self):
        self.armed = True
        self.split.start()

    def stop(self):
        self.armed = False
        self.split.stop()

    def device_ms(self):
        """Mean device ms of a replay (None: no replay timed)."""
        if not self.events:
            return None
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events) / len(self.events)


def ragged_graph_arm(params, arm, kv, knobs, traffic, graphs, weight_quant="") -> dict:
    """One arm of phase 5f: an engine behind the processor with aux
    ``warmup: full`` under the traffic (``5b``: four long prompts admitted
    beside live decode rows, ``5d``: four repetitive chats, one sampled),
    its steps' host split, its replays' device time, its captures and graph
    memory, and the launch identities of phase 5b and 5d."""
    extra = {"weight_quant": weight_quant} if weight_quant else {}
    engine, tokenizer = _engine(params, kv, "llama3-8b", graphs, **knobs, **extra)
    split = step_split_class()()
    clock = ReplayClock(engine, split)
    kw = ({"max_tokens": SPEC_MAX_TOKENS, "prompts": SPEC_PROMPTS, "samplings": SPEC_SAMPLINGS}
          if traffic == "5d" else {})
    with split.on(engine):
        results, wall, c = asyncio.run(serve_ragged(engine, tokenizer, profiler=clock,
                                                    warmup="full", **kw))
    health = engine.health()
    per_replay = {}
    replayed = engine._ragged_graphs is not None
    if replayed:
        names = ("ragged", "tree", "paged", "int4")
        per_replay = {v.label(): dict(zip(names, counts))
                      for v, (_g, _o, counts) in engine._ragged_graphs._graphs.items()}
    n_layers = engine.model.n_layers
    check_int4_route(engine, c, "5f {} {}".format(arm, weight_quant or kv or "bf16"))
    del engine
    torch.cuda.empty_cache()
    steps = c["ragged_steps"]
    out = dict(
        arm=arm, kv=kv or "bf16", weights=weight_quant or "bf16", graphs=graphs,
        traffic=traffic, wall_s=wall, tokens=c["tokens_emitted"], ragged_steps=steps,
        ragged_replays=c["ragged_replays"], verify_steps=c["ragged_verify_steps"],
        chain_steps=c["ragged_chain_steps"], decode_steps=c["decode_steps"],
        ragged_step_ms=c["ragged_ms"] / max(1, steps),
        replay_device_ms=clock.device_ms(), split=split.summary(),
        serve_captures=c["warm_counters"]["serve_captures"] + c["serve_captures"],
        ragged_launches=c["ragged_launches"], tree_launches=c["tree_launches"],
        paged_launches=c["paged_launches"], int4_launches=c["int4_launches"],
        capture_ms={k: v for k, v in health["graph_variants"].items() if k.startswith("ragged")},
        pool_mib={k: v / 2 ** 20 for k, v in health["graph_pool_bytes"].items()
                  if k.startswith("ragged")},
        per_replay=per_replay, contents=[r["content"] for r in results])
    if c["tokens_emitted"] != (SPEC_MAX_TOKENS * len(SPEC_PROMPTS) if traffic == "5d"
                               else 32 * len(LONG_PROMPTS)):
        raise AssertionError("5f {}: a completion stopped early: {} tokens".format(
            arm, c["tokens_emitted"]))
    if steps == 0 or c["ragged_launches"] != n_layers * steps:
        raise AssertionError("5f {}: ragged_paged_attention launched {} times for {} ragged "
                             "steps of {} layers".format(arm, c["ragged_launches"], steps,
                                                         n_layers))
    if c["paged_launches"] != n_layers * (c["decode_steps"] + c["ragged_chain_steps"]):
        raise AssertionError("5f {}: paged_attention launched {} times for {} decode and {} "
                             "chained steps".format(arm, c["paged_launches"], c["decode_steps"],
                                                    c["ragged_chain_steps"]))
    tree = bool(knobs.get("spec_tree"))
    if c["tree_launches"] != (n_layers * c["ragged_verify_steps"] if tree else 0):
        raise AssertionError("5f {}: {} tree launches for {} verify steps".format(
            arm, c["tree_launches"], c["ragged_verify_steps"]))
    if replayed and (out["serve_captures"] or c["ragged_replays"] != steps):
        raise AssertionError("5f {}: {} captures while serving, {} replays for {} ragged "
                             "steps".format(arm, out["serve_captures"], c["ragged_replays"],
                                            steps))
    return out


def phase_ragged_graphs(params, qparams, card: str) -> dict:
    """Phase 5f: every ragged step a CUDA-graph replay. Each arm of
    ``GRAPHED_ARMS`` graphed and eager (``cuda_graphs: false``), aux
    ``warmup: full``, then an int4-weight arm graphed: ms a ragged step, the
    replays' device share of it, the eager step's host split, capture ms and
    pool MiB per key, captures while serving, the launch counts. Holds:
    content byte-identical graphed and eager, no capture after the warmup,
    the launch identities."""
    t0 = time.perf_counter()
    runs = []
    for arm, kv, knobs, traffic in GRAPHED_ARMS:
        pair = [ragged_graph_arm(params, arm, kv, knobs, traffic, graphs)
                for graphs in (True, False)]
        if pair[0]["contents"] != pair[1]["contents"]:
            raise AssertionError("5f {} {}: content differs graphed and eager: {}".format(
                arm, kv or "bf16", first_difference(pair[0]["contents"][0],
                                                    pair[1]["contents"][0])))
        # the replays' device time over the graphed step's wall; the eager
        # steps are not clocked on the card, so theirs is derived: the
        # graphed replays' device time (the same kernels on the same
        # inputs) over the eager step's wall
        device_ms = pair[0]["replay_device_ms"]
        if device_ms is not None:
            pair[0]["device_share"] = device_ms / pair[0]["ragged_step_ms"]
            pair[1]["derived_device_share"] = device_ms / pair[1]["ragged_step_ms"]
        runs += pair
    int4 = ragged_graph_arm(qparams, "plain", "", RAGGED_KNOBS, "5b", True, weight_quant="int4")
    if int4["replay_device_ms"] is not None:
        int4["device_share"] = int4["replay_device_ms"] / int4["ragged_step_ms"]
    runs.append(int4)
    for run in runs:
        sp = run["split"]
        share = "-"
        if run.get("device_share") is not None:
            share = "{:.1%}".format(run["device_share"])
        elif run.get("derived_device_share") is not None:
            share = "{:.1%} (derived from the graphed replays)".format(
                run["derived_device_share"])
        log("  5f {arm} kv={kv} weights={weights} {mode}: {ragged_steps} ragged steps, "
            "{ragged_step_ms:.2f} ms each, device share {share}; host ms a step: prepare "
            "{p:.2f}, coords {co:.2f}, enqueue {e:.2f}, reads {r:.2f}, other {o:.2f}; "
            "serve captures {serve_captures}; launches ragged {ragged_launches} tree "
            "{tree_launches} paged {paged_launches} int4 {int4_launches} ({card})".format(
                mode="graphed" if run["graphs"] else "eager",
                share=share,
                p=sp["prepare"], co=sp["coords"], e=sp["enqueue"], r=sp["reads"],
                o=sp["other"], card=card, **run))
        if run["graphs"]:
            log("    capture ms {} ; pool MiB {}".format(
                json.dumps({k: round(v, 1) for k, v in run["capture_ms"].items()}),
                json.dumps({k: round(v, 1) for k, v in run["pool_mib"].items()})))
    for run in runs:
        run["contents"] = [text[:24] for text in run["contents"]]
    wall = time.perf_counter() - t0
    log("  phase 5f: {:.1f} s; graph pools {:.1f} MiB on the tree arm ({})".format(
        wall, sum(runs[4]["pool_mib"].values()), card))
    return {"runs": runs, "wall_s": wall}


def record_streams(engine) -> dict:
    """Wraps ``engine.generate`` so that every request's generated token ids
    are kept, by prompt ids (a later request with the same prompt replaces
    an earlier one: the timed run replaces the warm-up)."""
    streams = {}
    generate = engine.generate

    async def recording(request):
        ids = streams[tuple(request.prompt_ids)] = []
        async for token in generate(request):
            ids.append(token)
            yield token

    engine.generate = recording
    return streams


def logit_margins(model, prompt_ids, ids, step, other):
    """At generated position ``step`` of a greedy stream: the top logit, the
    top-2 margin of the model's logits and the logit of ``ids[step]`` less
    that of ``other`` (the token another arm took there), from one bf16
    prefill of the prompt and the stream's first ``step`` tokens (the
    logits are bf16 values: distinct ones near a top logit in [2**e,
    2**(e+1)) lie at least 2**(e-7) apart)."""
    seq = list(prompt_ids) + list(ids[:step])
    tokens = torch.tensor([seq], dtype=torch.long, device=model.device)
    logits, _cache = model.prefill(tokens, torch.tensor([len(seq)]))
    logits = logits[0]
    top = torch.topk(logits, 2).values
    return dict(top1=float(top[0]), top2_margin=float(top[0] - top[1]),
                taken_minus_other=float(logits[ids[step]] - logits[other]),
                taken_is_argmax=int(logits.argmax()) == ids[step])


def compare_spec_streams(spec_runs, model=None) -> None:
    """Each speculative arm's greedy contents against the plain ragged arm's
    on the same KV (bf16 cuBLAS at other row counts may flip a near tie at
    full width: reported, not asserted), and the tree arm's against the
    chain arm's. With ``model``, at the first generated token where an arm
    leaves the plain arm's greedy stream, logs the top-2 logit margin of
    that step (``logit_margins`` on the plain arm's prefix)."""
    greedy = [i for i, sampling in enumerate(SPEC_SAMPLINGS) if sampling is None]
    for run in spec_runs:
        if run["arm"] == "plain":
            continue
        plain_run = next(r for r in spec_runs if r["arm"] == "plain" and r["kv"] == run["kv"])
        run["greedy_vs_plain"] = [first_difference(run["contents"][i], plain_run["contents"][i])
                                  for i in greedy]
        run["greedy_margins"] = []
        for i in greedy:
            prompt_ids, ids = plain_run["token_ids"][i]
            _prompt, spec_ids = run["token_ids"][i]
            step = next((j for j, (a, b) in enumerate(zip(ids, spec_ids)) if a != b), None)
            if step is None or model is None:
                continue
            margins = dict(chat=i, token=step, plain=ids[step], spec=spec_ids[step],
                           **logit_margins(model, prompt_ids, ids, step, spec_ids[step]))
            run["greedy_margins"].append(margins)
            log("  {} kv={} chat {}: first differing token {} (plain {} vs {} {}): top logit "
                "{:.4g}, top-2 margin {:.4g}, logit(plain) - logit({}) {:.4g}, plain's token "
                "is the argmax: {}".format(
                    run["arm"], run["kv"], i, step, ids[step], run["arm"], spec_ids[step],
                    margins["top1"], margins["top2_margin"], run["arm"],
                    margins["taken_minus_other"], margins["taken_is_argmax"]))
        chain_run = next((r for r in spec_runs if r["arm"] == "chain" and r["kv"] == run["kv"]),
                         None)
        if run["arm"] == "tree" and chain_run is not None:
            run["greedy_vs_chain"] = [
                first_difference(run["contents"][i], chain_run["contents"][i]) for i in greedy]
        log("  {} kv={}: greedy streams match the plain ragged arm's: {} (first differing "
            "character per greedy chat: {}; against the chain arm: {})".format(
                run["arm"], run["kv"], all(d is None for d in run["greedy_vs_plain"]),
                run["greedy_vs_plain"], run.get("greedy_vs_chain", "n/a")))


# -- phase 5e: pipelined decode, each chunk one CUDA-graph replay -------------------

# (KV, weights) of the graph checks
GRAPH_CASES = [("", ""), ("int8", ""), ("", "int4")]
# one decode chunk's rows: seven slots at 40-1500 tokens and an idle one
CHUNK_LENGTHS = [1500, 40, 700, 1000, 300, 1200, 90, 0]
CHUNK_STEPS = 4


def graph_chunk_case(params, kv_quant: str, weights: str, sampled: bool) -> dict:
    """One Llama-3-8B decode chunk (8 rows, 4 steps, the engine's page
    table) captured into a CUDA graph (``DecodeGraphs``) and replayed,
    against ``run_chunk`` run eagerly on a clone of the same pools: the
    tokens, the device chain and every pool page must be equal bit for
    bit; a replay adds n_layers x steps decode-attention launches (and 225
    x steps int4 ones), the capture none; the counts one replay added are
    returned. Random pool contents; one row's
    token comes from a host override. Times a replay and an eager chunk
    (CUDA events, means over 5 and 3 runs)."""
    import types

    from clearml_serving_tpu_torch.llm.decode_graph import ChunkLayout, DecodeGraphs, run_chunk
    from clearml_serving_tpu_torch.llm.kv_cache import PagedKVCache
    from clearml_serving_tpu_torch.llm.sampling import gumbel_noise
    from clearml_serving_tpu_torch.models.llama import Llama
    from clearml_serving_tpu_torch.ops.fused_matmul import fused_int4_matmul
    from clearml_serving_tpu_torch.ops.paged_attention import paged_attention

    n = CHUNK_STEPS
    model = Llama(dict({"preset": "llama3-8b"}, **({"kv_quant": kv_quant} if kv_quant else {})),
                  params)
    b, page = len(CHUNK_LENGTHS), 32 if kv_quant else 16
    pages_per_seq = -(-(2048 + n) // page)
    cache = PagedKVCache(model.n_layers, model.n_kv_heads, model.head_dim,
                         num_pages=sum(-(-(t + n) // page) for t in CHUNK_LENGTHS) + 1,
                         page_size=page, max_slots=b, dtype=model.dtype, kv_quant=kv_quant,
                         device=DEV)
    gen = torch.Generator(DEV).manual_seed(5)
    if kv_quant:
        for pool in (cache.k, cache.v):
            pool.copy_(torch.randint(-127, 128, pool.shape, generator=gen, device=DEV))
        for scale in (cache.k_scale, cache.v_scale):
            scale.copy_(torch.rand(scale.shape, generator=gen, device=DEV) * 0.02)
    else:
        for pool in (cache.k, cache.v):
            pool.copy_(torch.randn(pool.shape, generator=gen, device=DEV))
    layout = ChunkLayout(b, pages_per_seq, n)
    i32 = torch.zeros(layout.size_i32, dtype=torch.int32, pin_memory=True)
    f32 = torch.zeros(layout.size_f32, dtype=torch.float32, pin_memory=True)
    v = layout.views(i32.numpy(), f32.numpy())
    for slot, length in enumerate(CHUNK_LENGTHS[:-1]):
        cache.pool.allocate(slot, length + n)
        for i, (pg, off) in enumerate(cache.pool.token_coords(slot, length, n)):
            v["write_pages"][slot, i], v["write_offsets"][slot, i] = pg, off
    v["page_table"][:] = cache.pool.page_table(pages_per_seq)
    v["lengths0"][:] = CHUNK_LENGTHS
    v["temperature"][:] = [0.7, 0.0, 1.0, 0.7, 0.0, 1.3, 0.7, 0.0] if sampled else 0.0
    v["top_k"][:] = [0, 0, 40, 0, 0, 0, 20, 0]
    v["top_p"][:] = [1.0, 1.0, 1.0, 0.9, 1.0, 1.0, 0.95, 1.0]
    v["override_tokens"][1], v["override_mask"][1] = 65, 1
    chain = torch.randint(0, 256, (b,), generator=gen, device=DEV, dtype=torch.int32)
    noise = gumbel_noise((n, b, model.vocab_size), gen, DEV) if sampled else None
    pools = ("k", "v", "k_scale", "v_scale")
    eager_cache = types.SimpleNamespace(kv_quant=kv_quant, **{
        name: None if getattr(cache, name) is None else getattr(cache, name).clone()
        for name in pools})
    dev_views = layout.views(i32.to(DEV), f32.to(DEV))
    eager = run_chunk(model, eager_cache, dev_views, chain, noise, n)
    graphs = DecodeGraphs(model, cache, layout, n)
    graphs.chain.copy_(chain)
    paged_attention.launches = fused_int4_matmul.launches = 0
    graphs.capture(greedy=not sampled)
    if (paged_attention.launches, fused_int4_matmul.launches) != (0, 0):
        raise AssertionError("a capture counted launches")
    out = graphs.replay(not sampled, i32, f32, noise)
    sync()
    label = "{} KV, {} weights, {}".format(kv_quant or "bf16", weights or "bf16",
                                          "sampled" if sampled else "greedy")
    if not torch.equal(out, eager) or not torch.equal(graphs.chain, eager[:, -1]):
        raise AssertionError("graph replay tokens differ from the eager chunk ({})".format(label))
    for name in pools:
        if getattr(cache, name) is not None and not torch.equal(getattr(cache, name),
                                                                getattr(eager_cache, name)):
            raise AssertionError("graph replay wrote other {} pages ({})".format(name, label))
    # the counts one replay added, as measured (the kernels line prints them)
    per_replay = {"paged_attention": paged_attention.launches,
                  "fused_int4_matmul": fused_int4_matmul.launches}
    want = {"paged_attention": model.n_layers * n,
            "fused_int4_matmul": int4_launches_per_forward(model) * n}
    if per_replay != want:
        raise AssertionError("a replay counted {} launches, want {} ({})".format(
            per_replay, want, label))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graphs.replay(not sampled, i32, f32, noise)
    end.record()
    sync()
    replay_ms = start.elapsed_time(end) / 5
    start.record()
    for _ in range(3):
        run_chunk(model, eager_cache, dev_views, chain, noise, n)
    end.record()
    sync()
    eager_ms = start.elapsed_time(end) / 3
    del graphs, cache, eager_cache
    torch.cuda.empty_cache()
    log("  {}: replay bitwise the eager chunk; {:.3f} ms a chunk replayed, {:.3f} ms "
        "eager".format(label, replay_ms, eager_ms))
    return dict(kv=kv_quant or "bf16", weights=weights or "bf16",
                variant="sampled" if sampled else "greedy", replay_ms=replay_ms,
                eager_ms=eager_ms, bitwise=True, launches_per_replay=per_replay)


# phase 5's traffic, and a steadier one: eight chats of 64 tokens (128 before
# phase 14 came: a depth cut)
PIPELINE_TRAFFIC = [("phase5", PROMPTS, 32), ("steady", PROMPTS * 2, 64)]
# phase 6 profiles the steady traffic at 32 tokens a chat: its three
# profiled passes (the eager one above all) set much of the script's length
PROFILED_STEADY = ("steady", PROMPTS * 2, 32)


# (label, depth, cuda_graphs): the eager serial loop, graphs in the serial
# loop, graphs in the pipeline; the middle arm splits the graphs' gain from
# the pipelining's
PIPELINE_ARMS = [("eager1", 1, False), ("graphs1", 1, True), ("graphs2", 2, True)]


def phase_pipeline_arms(params, preset: str = "llama3-8b", traffics=PIPELINE_TRAFFIC) -> list:
    """Each traffic in each of ``PIPELINE_ARMS`` on the same engine config
    and weights (graph arms captured by the endpoint's ``warmup:
    startup``): the greedy contents must be equal across the arms, the
    decode kernel launched n_layers times per decode step, and a graph arm
    must have captured both variants at warmup and none while serving, one
    replay per chunk. Reports wall ms per decode step (the loop's time in
    decode steps over the steps; at depth 2 a chunk computing under a
    prefill's host time is not in it), the mean dispatch and retire ms, and
    tok/s."""
    runs = []
    for traffic, prompts, max_tokens in traffics:
        arms = {}
        for arm, depth, cuda_graphs in PIPELINE_ARMS:
            engine, tokenizer = _engine(params, "", preset, cuda_graphs, pipeline_depth=depth)
            results, wall, launches, c = asyncio.run(serve_and_chat(
                engine, tokenizer, max_tokens=max_tokens, prompts=prompts,
                warmup="startup" if cuda_graphs else "off"))
            n_layers = engine.model.n_layers
            graphs = engine._graphs is not None
            depth = engine.pipeline_depth
            del engine
            if torch.device(DEV).type == "cuda":
                torch.cuda.empty_cache()
            warm, pipe = c["warm_counters"], c["pipeline"]
            steps = c["decode_steps"]
            out = dict(
                traffic=traffic, arm=arm, depth=depth, graphs=graphs, wall_s=wall,
                tokens=c["tokens_emitted"], decode_steps=steps, launches=launches,
                step_ms=c["decode_ms"] / max(1, steps),
                dispatch_ms=pipe["dispatch_ms"]["sum_ms"] / max(1, pipe["dispatch_ms"]["count"]),
                retire_ms=pipe["retire_ms"]["sum_ms"] / max(1, pipe["retire_ms"]["count"]),
                decode_tok_s=c["tokens_emitted"] / wall,
                prefill_ms=c["prefill_ms"] / max(1, c["prefills"]),
                warmup_captures=warm["graph_captures"], serve_captures=c["serve_captures"],
                replays=c["graph_replays"], chunks=c["decode_chunks"],
                contents=[r["content"] for r in results])
            log("  {traffic} {arm} (depth {depth}, graphs {graphs}): wall {wall_s:.3f} s, "
                "{tokens} tokens, {decode_tok_s:.1f} tok/s, {decode_steps} decode steps at "
                "{step_ms:.2f} ms each, dispatch {dispatch_ms:.2f} ms, retire {retire_ms:.2f} "
                "ms, prefill {prefill_ms:.2f} ms; captures {warmup_captures} at warmup, "
                "{serve_captures} serving; replays {replays} of {chunks} chunks".format(**out))
            if steps == 0 or launches != n_layers * steps:
                raise AssertionError("paged_attention launched {} times for {} decode steps "
                                     "of {} layers".format(launches, steps, n_layers))
            if c["tokens_emitted"] != max_tokens * len(prompts):
                raise AssertionError("a completion stopped before max_tokens")
            on_card = torch.device(DEV).type == "cuda"
            if graphs != (cuda_graphs and on_card) or (graphs and (
                    warm["graph_captures"] != 2 or warm["serve_captures"] != 0
                    or c["serve_captures"] != 0 or c["graph_replays"] != c["decode_chunks"])):
                raise AssertionError("{} {}: graphs {}, captures {} at warmup, {} / {} while "
                                     "serving, {} replays of {} chunks".format(
                                         traffic, arm, graphs, warm["graph_captures"],
                                         warm["serve_captures"], c["serve_captures"],
                                         c["graph_replays"], c["decode_chunks"]))
            arms[arm] = out
        base = arms[PIPELINE_ARMS[0][0]]["contents"]
        for arm, out in arms.items():
            if out["contents"] != base:
                raise AssertionError("{}: greedy contents differ between {} and {}: {}".format(
                    traffic, PIPELINE_ARMS[0][0], arm,
                    [first_difference(a, b) for a, b in zip(base, out["contents"])]))
        log("  {}: greedy contents equal in {}".format(traffic, ", ".join(arms)))
        for out in arms.values():
            out["contents"] = [text[:24] for text in out["contents"]]
            runs.append(out)
    return runs


# -- phase 7: the request lifecycle of the default route ------------------------

LIFECYCLE_PROMPT = "Write a short story about a lighthouse keeper and a storm."
# the overload burst: the default admission bound (32 queued) and the 8
# slots that admissions take at once, then 8 more that must shed
LIFECYCLE_BURST = 48
BATCH_PROMPTS = ["Batch job {}: describe the paged KV cache and its page table.".format(i)
                 for i in range(8)]


@contextlib.asynccontextmanager
async def served(engine, tokenizer):
    """The port's app for ``engine`` on a local port: yields (app, base
    URL, client session); the app's cleanup stops the engine."""
    import aiohttp
    from aiohttp import web

    app = processor_app(engine, tokenizer)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    base = "http://127.0.0.1:{}".format(runner.addresses[0][1])
    try:
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as s:
            yield app, base, s
    finally:
        await runner.cleanup()


async def lifecycle_chat(session, base, prompt, max_tokens, stream=False, **fields) -> dict:
    """One chat through the lifecycle: its status, ``Retry-After``, error
    code and stage, content (streamed or not), the SSE error event's type,
    and the client's time to the first content piece."""
    body = {"model": "llama3-8b", "messages": [{"role": "user", "content": prompt}],
            "max_tokens": max_tokens, "stream": stream, **fields}
    t0 = time.perf_counter()
    async with session.post(base + "/serve/openai/v1/chat/completions", json=body) as r:
        out = dict(status=r.status, retry_after=r.headers.get("Retry-After"), code=None,
                   stage=None, content="", tokens=None, error=None, first_text_s=None)
        if r.status != 200:
            payload = await r.json()
            out.update(code=payload.get("code"), stage=payload.get("stage"))
        elif not stream:
            payload = await r.json()
            out.update(content=payload["choices"][0]["message"]["content"],
                       tokens=payload["usage"]["completion_tokens"])
        else:
            pieces = []
            async for raw in r.content:
                line = raw.decode().strip()
                if not line.startswith("data: {"):
                    continue
                chunk = json.loads(line[len("data: "):])
                if "error" in chunk:
                    out["error"] = chunk["error"]["type"]
                    continue
                piece = chunk["choices"][0]["delta"].get("content")
                if piece:
                    out["first_text_s"] = out["first_text_s"] or time.perf_counter() - t0
                    pieces.append(piece)
            out["content"] = "".join(pieces)
    out["total_s"] = time.perf_counter() - t0
    return out


async def until(predicate, timeout: float, what: str) -> None:
    t0 = time.perf_counter()
    while not predicate():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError("timed out after {} s waiting for {}".format(timeout, what))
        await asyncio.sleep(0.005)


def release_card_memory() -> None:
    """Return a dropped engine's pools and graph memory to the card."""
    gc.collect()
    if torch.device(DEV).type == "cuda":
        torch.cuda.empty_cache()


# the tokens of phase 7's batch chats (preemption runs; 128 before) and of
# its drain's streams (64 before), since phase 19 joined the script: at 8
# layers a shorter chat could end before the last one's prefill was
# admitted, so they never all decoded at once
LIFECYCLE_BATCH_TOKENS = 384


async def preemption_run(engine, s, base, interactive: bool) -> dict:
    """8 batch-class chats at ``LIFECYCLE_BATCH_TOKENS``; with ``interactive``, one
    interactive chat once each has 16 tokens. Returns the batch contents,
    the interactive's engine-side TTFT and client-side first text, and the
    engine's preemptions."""
    preempted0 = engine.counters["preemptions"]
    emitted0 = engine.counters["tokens_emitted"]
    batch = [asyncio.ensure_future(lifecycle_chat(s, base, p, LIFECYCLE_BATCH_TOKENS,
                                                  priority="batch"))
             for p in BATCH_PROMPTS]
    try:
        await until(lambda: engine.active_slots == 8, 120, "8 batch chats decoding")
    except AssertionError as ex:
        stats = engine.lifecycle_stats()
        raise AssertionError("{}: {} active slots; finished chats {}; queue depths {}, "
                             "sheds {}, brownout {}, preemptions {}".format(
                                 ex, engine.active_slots,
                                 [(d.result()["status"], d.result()["code"]) for d in batch
                                  if d.done() and not d.exception()],
                                 stats.get("queue_depths"), stats.get("sheds_by_class"),
                                 stats.get("brownout"), stats.get("preemptions"))) from ex
    await until(lambda: engine.counters["tokens_emitted"] - emitted0 >= 8 * 16, 120,
                "16 tokens of each batch chat")
    ttft_ms = first_text_ms = None
    if interactive:
        seen = len(engine.ttft_ms)
        hi = await lifecycle_chat(s, base, LIFECYCLE_PROMPT, 16, stream=True)
        # the only request admitted for the first time meanwhile (a
        # resumed victim keeps its first TTFT)
        new = list(engine.ttft_ms)[seen:]
        if hi["status"] != 200 or hi["error"] or len(new) != 1:
            raise AssertionError("interactive chat: {}, new TTFTs {}".format(hi, new))
        ttft_ms = new[0]
        first_text_ms = hi["first_text_s"] and hi["first_text_s"] * 1e3
    done = await asyncio.gather(*batch)
    await engine.wait_drained()
    if any(d["status"] != 200 or d["tokens"] != LIFECYCLE_BATCH_TOKENS for d in done):
        raise AssertionError("a batch chat failed: {}".format(
            [(d["status"], d["tokens"], d["code"]) for d in done]))
    return dict(contents=[d["content"] for d in done], ttft_ms=ttft_ms,
                first_text_ms=first_text_ms,
                preemptions=engine.counters["preemptions"] - preempted0)


async def default_engine_runs(engine, tokenizer, card: str) -> dict:
    """On one app: the preemption runs (8 batch chats alone, then with an
    interactive arrival), 48 concurrent chats at 16 tokens under the
    default admission bound, a 1 ms TTFT budget on a 2048-bucket prompt, a
    total budget that cuts a stream, then the drain with 4 streams in
    flight."""
    from clearml_serving_tpu_torch.serving.main import drain_app

    async with served(engine, tokenizer) as (app, base, s):
        # the preemption runs come first: the overload below raises the
        # brownout stage, whose batch cap would shorten batch chats
        control = await preemption_run(engine, s, base, interactive=False)
        contended = await preemption_run(engine, s, base, interactive=True)
        if contended["preemptions"] < 1:
            raise AssertionError("no batch chat was preempted")
        same = [a == b for a, b in zip(control["contents"], contended["contents"])]
        log("  preemption: {} preemption(s); batch contents equal to the unpreempted run: "
            "{}; interactive TTFT {:.2f} ms (engine), first text {} ms (client) ({})".format(
                contended["preemptions"], same, contended["ttft_ms"],
                contended["first_text_ms"], card))
        if not all(same):
            raise AssertionError("a preempted batch stream left its unpreempted run")
        t0 = time.perf_counter()
        burst = await asyncio.gather(*[lifecycle_chat(s, base, PROMPTS[i % len(PROMPTS)], 16)
                                       for i in range(LIFECYCLE_BURST)])
        burst_s = time.perf_counter() - t0
        times = list(engine._admit_times)
        drain_rate = (len(times) - 1) / (times[-1] - times[0]) if len(times) > 1 else None
        ok = [b for b in burst if b["status"] == 200]
        shed = [b for b in burst if b["status"] == 429]
        bound = engine.max_pending
        if len(ok) + len(shed) != LIFECYCLE_BURST or not 1 <= len(shed) <= LIFECYCLE_BURST - bound:
            raise AssertionError("overload: {} x 200, {} x 429 of {} (other: {})".format(
                len(ok), len(shed), LIFECYCLE_BURST, [b["status"] for b in burst]))
        if any(b["code"] != "overloaded" or not b["retry_after"] or int(b["retry_after"]) < 1
               for b in shed):
            raise AssertionError("a 429 without Retry-After or code overloaded: {}".format(shed))
        if any(b["tokens"] != 16 for b in ok):
            raise AssertionError("a served chat stopped short of 16 tokens")
        retry_after = sorted(int(b["retry_after"]) for b in shed)
        log("  overload: {} concurrent chats -> {} x 200, {} x 429 in {:.3f} s; Retry-After "
            "{} s beside the observed admission drain rate {} /s ({})".format(
                LIFECYCLE_BURST, len(ok), len(shed), burst_s, retry_after,
                None if drain_rate is None else round(drain_rate, 3), card))
        await engine.wait_drained()
        # a 1 ms TTFT budget cannot hold a 2048-bucket prefill
        ttft = await lifecycle_chat(s, base, LONG_PROMPTS[-1], 8, ttft_timeout=0.001)
        if (ttft["status"], ttft["code"], ttft["stage"]) != (408, "deadline_exceeded", "ttft"):
            raise AssertionError("ttft budget: {}".format(ttft))
        cut = await lifecycle_chat(s, base, LIFECYCLE_PROMPT, 1024, stream=True, timeout=1.0)
        if cut["status"] != 200 or cut["error"] != "DeadlineExceededError" or not cut["content"]:
            raise AssertionError("timeout did not cut the stream: {}".format(cut))
        log("  deadlines: ttft_timeout 0.001 s on a 2048-bucket prompt -> {} {} ({}); timeout "
            "1.0 s cut a 1024-token stream after {} characters in {:.3f} s ({})".format(
                ttft["status"], ttft["code"], ttft["stage"], len(cut["content"]),
                cut["total_s"], card))
        await engine.wait_drained()
        # the drain: 4 streams in flight, a new chat meanwhile
        streams = [asyncio.ensure_future(lifecycle_chat(s, base, p, LIFECYCLE_BATCH_TOKENS,
                                                        stream=True))
                   for p in PROMPTS]
        await until(lambda: engine.active_slots == 4, 120, "4 streams decoding")
        t0 = time.perf_counter()
        drain = asyncio.ensure_future(drain_app(app, app["processor"], timeout=60.0))
        await asyncio.sleep(0.05)
        late = await lifecycle_chat(s, base, LIFECYCLE_PROMPT, 8)
        async with s.get(base + "/ready") as r:
            ready = (r.status, (await r.json())["status"])
        finished = await asyncio.gather(*streams)
        await drain
        drain_s = time.perf_counter() - t0
        if (late["status"], late["code"], bool(late["retry_after"])) != (503, "draining", True):
            raise AssertionError("a chat during the drain: {}".format(late))
        if ready != (503, "draining"):
            raise AssertionError("/ready during the drain: {}".format(ready))
        if any(f["status"] != 200 or f["error"] or not f["content"] for f in finished):
            raise AssertionError("an in-flight stream did not finish: {}".format(finished))
        await engine.wait_drained()
        pool = engine.paged_cache.pool
        if engine.health()["ready"] or pool.free_pages != pool.num_pages - 1:
            raise AssertionError("after the drain: ready {} free pages {} of {}".format(
                engine.health()["ready"], pool.free_pages, pool.num_pages - 1))
        log("  drain: 4 streams in flight finished with 200, a new chat got 503 draining, "
            "/ready 503 draining; drained and stopped in {:.3f} s, every page back "
            "({})".format(drain_s, card))
    return dict(control=control, contended=contended, ok=len(ok), shed=len(shed),
                retry_after=retry_after, drain_rate=drain_rate, burst_s=burst_s,
                ttft_status=ttft["status"], cut_chars=len(cut["content"]), drain_s=drain_s)


async def watchdog_run(engine, tokenizer, card: str) -> dict:
    """A 2 s watchdog; the retire leg stalls 6 s (injected) while 4 chats
    have chunks in flight: they get 503 engine_stalled, /ready reads 503
    until recovery, then 200; the pool's free pages and the next greedy
    chat's content equal those before the trip."""
    from clearml_serving_tpu_torch.llm import faults

    async with served(engine, tokenizer) as (_app, base, s):
        before = await lifecycle_chat(s, base, LIFECYCLE_PROMPT, 32)
        await engine.wait_drained()
        free0 = engine.paged_cache.pool.free_pages
        victims = [asyncio.ensure_future(lifecycle_chat(s, base, p, 512)) for p in PROMPTS]
        await until(lambda: engine.active_slots == 4 and len(engine._inflight) > 0, 120,
                    "4 chats with chunks in flight")
        faults.configure([{"point": "engine.decode.stall", "action": "delay", "delay": 6.0,
                           "times": 1}])
        try:
            t_503 = t_200 = None
            t0 = time.perf_counter()
            while t_200 is None and time.perf_counter() - t0 < 60:
                async with s.get(base + "/ready") as r:
                    now = time.perf_counter()
                    if r.status == 503 and t_503 is None:
                        t_503 = now
                    elif r.status == 200 and t_503 is not None:
                        t_200 = now
                await asyncio.sleep(0.02)
            outcomes = await asyncio.gather(*victims)
        finally:
            faults.clear()
        await engine.wait_drained()
        free1 = engine.paged_cache.pool.free_pages
        after = await lifecycle_chat(s, base, LIFECYCLE_PROMPT, 32)
        trips = engine.counters["watchdog_trips"]
        await engine.wait_drained()
    codes = [(o["status"], o["code"]) for o in outcomes]
    if codes != [(503, "engine_stalled")] * 4 or trips != 1:
        raise AssertionError("watchdog: victims {} trips {}".format(codes, trips))
    if t_503 is None or t_200 is None:
        raise AssertionError("/ready never went 503 then 200")
    if free1 != free0 or after["content"] != before["content"] or after["status"] != 200:
        raise AssertionError("after recovery: free pages {} vs {}, content equal {}".format(
            free1, free0, after["content"] == before["content"]))
    log("  watchdog: 4 in-flight chats -> 503 engine_stalled, one trip; /ready 503 -> 200 "
        "in {:.3f} s (trip to ready, most of it the injected 6 s stall's remainder); free "
        "pages {} before, {} after; the next chat's content equals the one before "
        "({})".format(
            t_200 - t_503, free0, free1, card))
    return dict(trip_to_ready_s=t_200 - t_503, free_pages=free1, trips=trips)


def phase_lifecycle(params, card: str, preset: str = "llama3-8b") -> dict:
    """Phase 7: the default route's request lifecycle at full width, bf16
    KV, default depth 2 with graphs, max_batch 8, behind the HTTP app, with
    the reference's default lifecycle knobs (max_pending 32, a 30 s
    watchdog, preemption, brownout): preemption (8 batch chats, one
    interactive) against the same chats alone and against an engine with
    preemption off; the overload burst, the deadlines and the drain; the
    watchdog on an engine with a 2 s interval. The decode kernel must have
    launched once per layer per decode step of the default engine's
    traffic."""
    from clearml_serving_tpu_torch.ops.paged_attention import paged_attention

    t_phase = time.perf_counter()
    engine, tokenizer = _engine(params, "", preset)
    defaults = (engine.max_pending, engine._watchdog_interval, engine._preempt,
                engine._brownout is not None)
    if defaults != (32, 30.0, True, True):
        raise AssertionError("default lifecycle knobs: {}".format(defaults))
    n_layers = engine.model.n_layers
    paged_attention.launches = 0
    for key in engine.counters:
        engine.counters[key] = 0
    runs = asyncio.run(default_engine_runs(engine, tokenizer, card))
    c = dict(engine.counters)
    launches = paged_attention.launches
    if c["decode_steps"] == 0 or launches != n_layers * c["decode_steps"]:
        raise AssertionError("paged_attention launched {} times for {} decode steps".format(
            launches, c["decode_steps"]))
    control, contended = runs.pop("control"), runs.pop("contended")
    del engine
    release_card_memory()

    async def unpreempted_run(engine, tokenizer):
        async with served(engine, tokenizer) as (_app, base, s):
            return await preemption_run(engine, s, base, interactive=True)

    engine, tokenizer = _engine(params, "", preset, preemption=False)
    unpreempted = asyncio.run(unpreempted_run(engine, tokenizer))
    del engine
    release_card_memory()
    if unpreempted["preemptions"] or unpreempted["contents"] != control["contents"]:
        raise AssertionError("preemption off: {} preemptions, contents equal {}".format(
            unpreempted["preemptions"], unpreempted["contents"] == control["contents"]))
    log("  interactive TTFT with preemption {:.2f} ms, without {:.2f} ms (engine; client "
        "first text {} vs {} ms) ({})".format(
            contended["ttft_ms"], unpreempted["ttft_ms"], contended["first_text_ms"],
            unpreempted["first_text_ms"], card))
    engine, tokenizer = _engine(params, "", preset, watchdog_interval=2)
    watchdog = asyncio.run(watchdog_run(engine, tokenizer, card))
    del engine
    release_card_memory()
    out = dict(card=card, preemptions=contended["preemptions"],
               ttft_ms_preempt=contended["ttft_ms"], ttft_ms_no_preempt=unpreempted["ttft_ms"],
               first_text_ms_preempt=contended["first_text_ms"],
               first_text_ms_no_preempt=unpreempted["first_text_ms"],
               launches=launches, decode_steps=c["decode_steps"], sheds=c["sheds_queue"],
               deadline_ttft=c["deadline_ttft"], deadline_total=c["deadline_total"],
               **runs, **watchdog, seconds=time.perf_counter() - t_phase)
    log("  phase 7 in {:.1f} s".format(out["seconds"]))
    return out


# -- phase 8: the radix prefix cache over shared, refcounted KV pages ----------------

PREFIX_KNOBS = {"prefix_cache": 64, "prefix_block": 64, "prefix_cache_pages": 256}
PREFIX_HEAD = 1024
PREFIX_TAILS = 8
PREFIX_MAX_TOKENS = 32
# (arm, kv, knobs, cuda_graphs): two-dispatch at depth 2 with graphs and
# ragged at budget 256, each on bf16 and int8 KV, and the eager
# two-dispatch bf16 arm the graphed one is held against
PREFIX_ARMS = [("two_dispatch", "", {"pipeline_depth": 2}, True),
               ("two_dispatch_eager", "", {"pipeline_depth": 2}, False),
               ("two_dispatch", "int8", {"pipeline_depth": 2}, True),
               ("ragged", "", RAGGED_KNOBS, True),
               ("ragged", "int8", RAGGED_KNOBS, True)]


def prefix_traffic(seed: int = 0):
    """A 1024-token shared head and 8 tails of 40-200 tokens, token ids made
    from ``seed``; each tail starts with its own token, so the prompts share
    exactly the head."""
    gen = torch.Generator().manual_seed(seed)
    head = torch.randint(1, 256, (PREFIX_HEAD,), generator=gen).tolist()
    lengths = torch.randint(40, 201, (PREFIX_TAILS,), generator=gen).tolist()
    tails = [[i + 1] + torch.randint(1, 256, (n - 1,), generator=gen).tolist()
             for i, n in enumerate(lengths)]
    return head, [head + t for t in tails]


async def _ids_stream(engine, ids, max_tokens=PREFIX_MAX_TOKENS):
    from clearml_serving_tpu_torch.llm.engine import GenRequest

    return [t async for t in engine.generate(GenRequest(prompt_ids=list(ids),
                                                        max_new_tokens=max_tokens))]


def _empty_prefix_cache(engine) -> None:
    """Evict every cached run (the budget set to no node, then restored)."""
    cache = engine._prefix
    keep, cache.max_nodes = cache.max_nodes, 0
    with cache._lock:
        cache._evict_over_budget()
    cache.max_nodes = keep


def _pool_rows(cache, pages):
    """The pools' rows of ``pages``: K, V and the int8 scale rows."""
    idx = torch.as_tensor(pages, dtype=torch.long, device=cache.device)
    return [t[:, :, idx].clone() for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)
            if t is not None]


def wave_sharing(engine, head_pages) -> dict:
    """During the concurrent wave: every live slot's table starts with the
    head's stored page ids, and the pages in use are those of an unshared
    layout less 64 per live slot (each would own a copy of the head; a
    slot's own stored tail blocks, held by the cache and the slot, are
    counted once)."""
    pool = engine.paged_cache.pool
    tables = [pool.slot_pages(s) for s in range(pool.max_slots) if pool.slot_length(s) > 0]
    cached = set(engine._prefix.page_refs())
    used = pool.num_pages - 1 - pool.free_pages
    union = set(cached).union(*map(set, tables))
    own_stored = sum(1 for t in tables for p in t[len(head_pages):] if p in cached)
    saved = sum(len(t) for t in tables) + len(cached) - used - own_stored
    return dict(slots=len(tables), same_head=all(t[:len(head_pages)] == head_pages
                                                  for t in tables),
                used=used, union=len(union), pages_saved=saved, free_pages=pool.free_pages)


def commit_together(engine) -> None:
    """Two-dispatch admissions prefill in workers and commit as they land;
    from here on, the engine commits only once every admission in flight
    has landed, all at one boundary and in slot order, so a concurrent wave
    goes live together, with page ids that do not depend on which prefill
    landed first."""
    commit = engine._commit_ready

    def together():
        if engine._ready and len(engine._ready) == len(engine._admitting):
            landed = sorted(engine._ready, key=lambda item: item[1])
            engine._ready.clear()
            engine._ready.extend(landed)
            commit()

    engine._commit_ready = together


async def prefix_arm_run(engine, head, prompts, logits_prompt=None) -> dict:
    """A throwaway cold + hit pair on another head (first-use costs), the
    cache emptied; then the first prompt alone (a miss and a store), the 7
    others concurrently (the hits, committed together: ``commit_together``),
    the first again (a hit on its own stored run), the cache emptied
    again."""
    commit_together(engine)
    cache = engine._prefix
    warm_head, warm = prefix_traffic(1)
    await _ids_stream(engine, warm[0], 4)
    await _ids_stream(engine, warm[1], 4)
    await engine.wait_drained()
    _empty_prefix_cache(engine)
    for key in engine.counters:
        engine.counters[key] = 0
    engine.ttft_ms.clear()
    cache.hits = cache.misses = cache.hit_tokens = 0
    from clearml_serving_tpu_torch.ops.paged_attention import (paged_attention,
                                                                ragged_paged_attention)
    paged_attention.launches = ragged_paged_attention.launches = 0
    t0 = time.perf_counter()
    first = await _ids_stream(engine, prompts[0])
    await engine.wait_drained()
    c_cold = dict(engine.counters)
    # the head's stored page ids (the probe's lookup is not counted)
    counts = (cache.hits, cache.misses, cache.hit_tokens)
    hit0 = cache.lookup_pages(head + [0], 0)
    head_pages = list(hit0["pages"])
    cache.release(hit0)
    cache.hits, cache.misses, cache.hit_tokens = counts
    head_rows = _pool_rows(engine.paged_cache, head_pages)
    wave = asyncio.ensure_future(asyncio.gather(*(_ids_stream(engine, p) for p in prompts[1:])))
    pool = engine.paged_cache.pool
    await until(lambda: sum(pool.slot_length(s) > 0 for s in range(pool.max_slots))
                == len(prompts) - 1 or wave.done(), 120, "the wave's slots mapped")
    sharing = wave_sharing(engine, head_pages)
    hits = await wave
    await engine.wait_drained()
    c_wave = dict(engine.counters)
    repeat = await _ids_stream(engine, prompts[0])
    await engine.wait_drained()
    wall = time.perf_counter() - t0
    c = dict(engine.counters)
    same_head = all(torch.equal(a, b) for a, b in
                    zip(head_rows, _pool_rows(engine.paged_cache, head_pages)))
    ttft = list(engine.ttft_ms)
    stats = cache.stats()
    logits = hit_vs_cold_logits(engine, logits_prompt) if logits_prompt else None
    out = dict(logits=logits, contents=[first] + list(hits) + [repeat], stats=stats, sharing=sharing,
               head_pages=head_pages, head_unchanged=same_head, counters=c, wall_s=wall,
               paged_launches=paged_attention.launches,
               ragged_launches=ragged_paged_attention.launches,
               ttft_cold_ms=ttft[0], ttft_hit_ms=ttft[1:],
               prefill_ms_cold=c_cold["prefill_ms"] / max(1, c_cold["prefills"]),
               prefill_ms_hit=((c["prefill_ms"] - c_cold["prefill_ms"])
                               / max(1, c["prefills"] - c_cold["prefills"])),
               ragged_steps_per_hit=(c_wave["ragged_steps"] - c_cold["ragged_steps"])
               / (len(prompts) - 1),
               cow_events=engine.paged_cache.pool.cow_events)
    _empty_prefix_cache(engine)
    out["free_after_eviction"] = pool.free_pages
    return out


def prefix_probe_prompt(head):
    """A prompt that shares only the head with the stored runs: its hit
    prefills a 200-token tail in four 64-token segments."""
    gen = torch.Generator().manual_seed(2)
    return head + [PREFIX_TAILS + 1] + torch.randint(1, 256, (199,), generator=gen).tolist()


def hit_vs_cold_logits(engine, prompt) -> dict:
    """The hit path's last logits (the shared pages gathered, the tail
    through ``prefill_chunk`` in 64-token segments: the engine's own
    ``_prefix_admission``) against the cold prefill's, for one prompt at
    bf16 on the card."""
    from clearml_serving_tpu_torch.llm import shapes
    from clearml_serving_tpu_torch.llm.engine import GenRequest

    request = GenRequest(prompt_ids=list(prompt))
    with torch.no_grad():
        hit_last, _cache, plen = engine._run_gated(engine._prefix_admission(request))
        engine._release_prefix_hit(request)
        n = len(prompt)
        bucket = shapes.bucket_for(n, engine._buckets, engine.max_seq_len)
        tokens = torch.zeros((1, bucket), dtype=torch.long)
        tokens[0, :n] = torch.as_tensor(prompt)
        cold_last, _ = engine.model.prefill(tokens.to(DEV),
                                            torch.tensor([n], dtype=torch.int32, device=DEV))
    hit_last, cold_last = hit_last.float()[0], cold_last.float()[0]
    err = float((hit_last - cold_last).abs().max())
    scale = float(cold_last.abs().max())
    return dict(prefix_len=plen, max_abs_err=err, rel_err=err / scale,
                top1_equal=bool(int(hit_last.argmax()) == int(cold_last.argmax())))


def first_token_difference(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def phase_prefix_cache(params, card: str, preset: str = "llama3-8b") -> dict:
    """Phase 8: Llama-3-8B at full width, paged cache (max_batch 8,
    max_seq_len 2048, page_size 16), ``prefix_cache`` 64, ``prefix_block``
    64, ``prefix_cache_pages`` 256, the KV sanitizer armed, in each arm of
    ``PREFIX_ARMS``. Holds hits, misses and hit_tokens to the tree's rule,
    the wave's physical sharing of the head's pages, the head's rows bit for
    bit after the wave, graphed = eager contents, the kernels' launches,
    every page back after eviction with a clean sanitizer, and the hit
    path's logits within 5% of the cold prefill's."""
    from clearml_serving_tpu_torch.ops.paged_attention import (paged_attention,
                                                                ragged_paged_attention)

    t_phase = time.perf_counter()
    head, prompts = prefix_traffic(0)
    armed = os.environ.get("TPUSERVE_SANITIZE")
    os.environ["TPUSERVE_SANITIZE"] = "1"
    runs, logits = [], None
    try:
        for arm, kv, knobs, graphs in PREFIX_ARMS:
            engine, _tok = _engine(params, kv, preset, cuda_graphs=graphs,
                                   **dict(PREFIX_KNOBS, **knobs))
            n_layers = engine.model.n_layers
            main = arm == "two_dispatch" and not kv
            run = asyncio.run(prefix_arm_run(engine, head, prompts,
                                             prefix_probe_prompt(head) if main else None))
            cache = engine._prefix
            rule = [cache.longest_prefix_len(len(prompts[0]))]
            want = dict(hits=len(prompts), misses=1,
                        hit_tokens=PREFIX_HEAD * (len(prompts) - 1) + rule[0])
            got = {k: run["stats"][k] for k in want}
            c = run["counters"]
            sharing = run["sharing"]
            checks = {
                "hit counts": got == want,
                "the wave shares the head's pages": (
                    sharing["slots"] == len(prompts) - 1 and sharing["same_head"]
                    and sharing["union"] == sharing["used"]
                    and sharing["pages_saved"] == (len(prompts) - 1) * len(run["head_pages"])),
                "head rows unchanged": run["head_unchanged"],
                "paged launches": (run["paged_launches"] == n_layers * (
                    c["decode_steps"] + c["ragged_chain_steps"]) > 0),
                "ragged launches": run["ragged_launches"] == n_layers * c["ragged_steps"]
                and (c["ragged_steps"] > 0) == (arm == "ragged"),
                "every page back": (run["free_after_eviction"]
                                    == engine.paged_cache.pool.num_pages - 1),
                "sanitizer": (engine._sanitizer is not None
                              and engine._sanitizer.stats()["failures"] == 0
                              and engine._sanitizer.stats()["checks"] > 0),
                "32 tokens each": all(len(s) == PREFIX_MAX_TOKENS for s in run["contents"]),
            }
            if main:
                logits = run["logits"]
                checks["hit vs cold logits within 5%"] = logits["rel_err"] <= 0.05
            hit_ttft = sorted(run["ttft_hit_ms"])
            log("  {} kv={}{}: hits {hits} misses {misses} hit_tokens {hit_tokens} (want {}); "
                "the wave's {} slots map the head's {} pages: {}, pages saved {}; head rows "
                "unchanged {}; TTFT cold {:.2f} ms, hit median {:.2f} max {:.2f} ms; prefill "
                "{:.2f} ms cold, {:.2f} ms hit; ragged steps per hit admission {:.2f}; "
                "paged_attention {} / ragged_paged_attention {} launches over {} decode, {} "
                "chained and {} ragged steps; cow_events {}; after eviction {} free of {}; "
                "sanitizer {}; wall {:.3f} s ({})".format(
                    arm, kv or "bf16", "" if graphs else " (eager)", want,
                    sharing["slots"], len(run["head_pages"]), sharing["same_head"],
                    sharing["pages_saved"], run["head_unchanged"], run["ttft_cold_ms"],
                    hit_ttft[len(hit_ttft) // 2], hit_ttft[-1], run["prefill_ms_cold"],
                    run["prefill_ms_hit"], run["ragged_steps_per_hit"], run["paged_launches"],
                    run["ragged_launches"], c["decode_steps"], c["ragged_chain_steps"],
                    c["ragged_steps"], run["cow_events"], run["free_after_eviction"],
                    engine.paged_cache.pool.num_pages - 1, engine._sanitizer.stats(),
                    run["wall_s"], card, **got))
            engine.stop()
            del engine, cache
            release_card_memory()
            run.update(arm=arm, kv=kv or "bf16", graphs=graphs, checks=checks)
            runs.append(run)
            failed = [name for name, ok in checks.items() if not ok]
            if failed:
                raise AssertionError("phase 8 {} kv={}: failed {}".format(
                    arm, kv or "bf16", failed))
    finally:
        if armed is None:
            os.environ.pop("TPUSERVE_SANITIZE", None)
        else:
            os.environ["TPUSERVE_SANITIZE"] = armed
    graphed, eager = runs[0], runs[1]
    if graphed["contents"] != eager["contents"]:
        raise AssertionError("the graphed and eager two-dispatch arms' contents differ")
    cold, hit = runs[0]["contents"][0], runs[0]["contents"][-1]
    log("  hit vs cold (bf16, a prompt of {} tokens, prefix {}): last logits max abs err "
        "{:.4f} ({:.4f} of the largest), top-1 equal {}; prompt 0's contents cold vs its "
        "repeat (a hit on its own run) first differ at token {}; graphed = eager contents "
        "({})".format(len(prefix_probe_prompt(head)), logits["prefix_len"], logits["max_abs_err"],
                      logits["rel_err"], logits["top1_equal"],
                      first_token_difference(cold, hit), card))
    for run in runs:
        run["contents"] = [s[:8] for s in run["contents"]]
        del run["head_pages"]
    out = dict(card=card, runs=runs, logits=logits,
               first_difference_cold_vs_repeat=first_token_difference(cold, hit),
               seconds=time.perf_counter() - t_phase)
    log("  phase 8 in {:.1f} s".format(out["seconds"]))
    return out


# -- phase 9: the host-RAM KV tier and the ownership ledger -------------------------

TIER_HEADS = 6
TIER_HEAD = 1024
TIER_MAX_TOKENS = 16   # 32 before phase 14's second cycles came (a depth cut)
TIER_BASE = {"prefix_cache": 256, "prefix_block": 64}
TIER_UNTIERED = dict(TIER_BASE, prefix_cache_pages=512)
TIER_TIERED = dict(TIER_BASE, prefix_cache_pages=128, prefix_cache_host_pages=512)
# (arm, kv, knobs, the arm whose contents it must equal, clone check): A
# two-dispatch at depth 2 with graphs, bf16 KV, no tier; B the same with a
# 128-page device budget over a 512-page host tier; C0 and C the pair on
# int8 KV; D0 and D the pair under the ragged scheduler (budget 256). A
# tiered arm serves the same bytes as its tierless twin, so their contents
# must be equal. B, C and D clone every demoted and promoted page for the
# bitwise check (device copies on the engine's stream); Bt is B without
# the clones, the arm whose times are the tier's
TIER_ARMS = [("A", "", dict(TIER_UNTIERED, pipeline_depth=2), None, False),
             ("B", "", dict(TIER_TIERED, pipeline_depth=2), "A", True),
             ("Bt", "", dict(TIER_TIERED, pipeline_depth=2), "A", False),
             ("C0", "int8", dict(TIER_UNTIERED, pipeline_depth=2), None, False),
             ("C", "int8", dict(TIER_TIERED, pipeline_depth=2), "C0", True),
             ("D0", "", dict(TIER_UNTIERED, **RAGGED_KNOBS), None, False),
             ("D", "", dict(TIER_TIERED, **RAGGED_KNOBS), "D0", True)]
# one page's bytes at Llama-3-8B width (K and V of 32 layers x 8 KV heads x
# 16 tokens x 128; int8 pools add f32 scale rows), device and host alike
TIER_PAGE_BYTES = {"": 2 * 32 * 8 * 16 * 128 * 2, "int8": 2 * 32 * 8 * 16 * (128 + 4)}
LLAMA3_VOCAB = 128256
TIER_STATS = ("hits", "misses", "hit_tokens", "hits_by_tier", "demotions", "promotions",
              "evictions", "nodes", "cached_pages", "host_nodes", "host_pages")
# what the reference's RadixPrefixCache gives for phase 9's sequence of
# lookups and stores (``tier_replay`` over ``tier_warmup_prompts()`` and
# ``tier_traffic()``) at the arms' budgets: the stats after the warmup
# sweep, each chat's hit (tier, length), the stats at the end.
# tests/test_torch_kv_tiering.py replays the sequence through the
# reference's cache and the port's and holds both to these numbers
TIER_EXPECTED = {
    "untiered": {
        "warmup": {"hits": 5, "misses": 7, "hit_tokens": 3648,
                   "hits_by_tier": {"hbm": 5, "host": 0}, "demotions": 0, "promotions": 0,
                   "evictions": 0, "nodes": 57, "cached_pages": 228, "host_nodes": 0,
                   "host_pages": 0},
        "traffic": [["miss", 0]] * TIER_HEADS + [["hbm", TIER_HEAD]] * TIER_HEADS,
        "end": {"hits": 11, "misses": 13, "hit_tokens": 9792,
                "hits_by_tier": {"hbm": 11, "host": 0}, "demotions": 0, "promotions": 0,
                "evictions": 44, "nodes": 128, "cached_pages": 512, "host_nodes": 0,
                "host_pages": 0},
    },
    "tiered": {
        "warmup": {"hits": 5, "misses": 7, "hit_tokens": 3648,
                   "hits_by_tier": {"hbm": 5, "host": 0}, "demotions": 1, "promotions": 0,
                   "evictions": 0, "nodes": 57, "cached_pages": 128, "host_nodes": 25,
                   "host_pages": 100},
        "traffic": [["miss", 0]] * TIER_HEADS + [["host", TIER_HEAD]] * TIER_HEADS,
        "end": {"hits": 11, "misses": 13, "hit_tokens": 9792,
                "hits_by_tier": {"hbm": 5, "host": 6}, "demotions": 13, "promotions": 6,
                "evictions": 12, "nodes": 160, "cached_pages": 128, "host_nodes": 128,
                "host_pages": 512},
    },
}


def tier_traffic(seed: int = 0):
    """Six distinct 1024-token heads (system prompts with few-shot
    examples) and two rounds of one chat per head, each with its own
    40-200-token tail (its first token differs from every other tail's),
    token ids from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    heads = [torch.randint(1, 256, (TIER_HEAD,), generator=gen).tolist()
             for _ in range(TIER_HEADS)]
    rounds = []
    for r in range(2):
        lengths = torch.randint(40, 201, (TIER_HEADS,), generator=gen).tolist()
        rounds.append([head + [240 + TIER_HEADS * r + i]
                       + torch.randint(1, 256, (n - 1,), generator=gen).tolist()
                       for i, (head, n) in enumerate(zip(heads, lengths))])
    return heads, rounds


def tier_warmup_prompts():
    """The prompts of the warmup sweep (``llm/warmup.py``'s cold-then-hit
    pairs) of phase 9's engines: Llama-3-8B's vocabulary, max_seq_len 2048,
    the default prefill buckets, prefix_block 64."""
    from types import SimpleNamespace

    from clearml_serving_tpu_torch.llm import shapes, warmup

    engine = SimpleNamespace(model=SimpleNamespace(vocab_size=LLAMA3_VOCAB),
                             _buckets=shapes.prefill_buckets(None, 2048), max_seq_len=2048,
                             _prefix=SimpleNamespace(block=TIER_BASE["prefix_block"]))
    return [spec["prompt_ids"] for spec in warmup.warmup_plan(engine)]


def tier_stats(cache) -> dict:
    stats = cache.stats()
    return {key: stats[key] for key in TIER_STATS}


def tier_outcome(before: dict, after: dict) -> list:
    """One chat's lookup from the cache's stats around it: ["miss", 0] or
    [tier, hit length]."""
    if after["misses"] > before["misses"]:
        return ["miss", 0]
    tier = "host" if after["hits_by_tier"]["host"] > before["hits_by_tier"]["host"] else "hbm"
    return [tier, after["hit_tokens"] - before["hit_tokens"]]


def tier_replay(pool, cache, warm, traffic) -> dict:
    """Drive a ``RadixPrefixCache`` over ``pool`` (either package's) through
    the calls an engine makes for prompts served one after another:
    admission control's ``match_len``, the admission's lookup (a hit's
    pages mapped into the slot, then its pin dropped), the commit's store
    of the slot's pages. Returns the stats after ``warm``, each prompt of
    ``traffic``'s outcome, and the stats at the end."""
    def one(ids):
        before = tier_stats(cache)
        cache.match_len(ids)
        hit = cache.lookup_pages(ids, 0)
        pool.free(0)
        if hit is not None:
            pool.map_shared(0, list(hit["pages"]), hit["len"])
            cache.release(hit)
        pool.allocate(0, len(ids))
        cache.store_pages(ids, 0, pool.slot_pages(0))
        pool.free(0)
        return tier_outcome(before, tier_stats(cache))

    for ids in warm:
        one(ids)
    after_warm = tier_stats(cache)
    outcomes = [one(ids) for ids in traffic]
    return {"warmup": after_warm, "traffic": outcomes, "end": tier_stats(cache)}


def hook_tier(pc, clone: bool) -> dict:
    """Wrap the cache's demote and promote, timing each call on the host
    (ms). With ``clone``, a demotion first clones the victims' rows (every
    pool, on the engine's stream, so after the writes that made them) and
    a promotion clones the promoted pages' rows right after its copies
    (same stream); ``check()`` then holds each promoted page to its clone
    from before demotion, bit for bit."""
    clones, pairs = {}, []
    counts = {"demotions": 0, "promotions": 0, "demote_ms": [], "promote_ms": [],
              "promote_pages": []}
    real_demote, real_promote = pc.demote_pages, pc.promote_pages

    def rows(pages):
        with (torch.cuda.stream(pc.stream) if pc.stream is not None
              else contextlib.nullcontext()):
            idx = pc._page_index(pages)
            return [pool.index_select(2, idx) for pool in pc._pools()]

    def demote(pages):
        before = rows(pages) if clone else None
        t0 = time.perf_counter()
        host_ids = real_demote(pages)
        counts["demote_ms"].append((time.perf_counter() - t0) * 1e3)
        if clone:
            for i, hid in enumerate(host_ids):
                clones[hid] = [t[:, :, i] for t in before]
        counts["demotions"] += 1
        return host_ids

    def promote(host_ids, pages):
        want = [clones.pop(hid) for hid in host_ids] if clone else None
        t0 = time.perf_counter()
        real_promote(host_ids, pages)
        counts["promote_ms"].append((time.perf_counter() - t0) * 1e3)
        counts["promote_pages"].append(len(pages))
        if clone:
            got = rows(pages)
            pairs.extend((w, [t[:, :, i] for t in got]) for i, w in enumerate(want))
        counts["promotions"] += 1

    def check() -> bool:
        return bool(pairs) and all(torch.equal(a, b) for want, got in pairs
                                   for a, b in zip(want, got))

    pc.demote_pages, pc.promote_pages = demote, promote
    return dict(counts=counts, pairs=pairs, check=check)


async def tier_arm_run(engine, rounds) -> list:
    """The two rounds, one chat at a time: each chat's contents, its
    lookup's outcome, TTFT and prefill time."""
    out = []
    for r, prompts in enumerate(rounds):
        for ids in prompts:
            before, c0 = tier_stats(engine._prefix), dict(engine.counters)
            tokens = await _ids_stream(engine, ids, TIER_MAX_TOKENS)
            await engine.wait_drained()
            out.append(dict(round=r, tokens=tokens, ttft_ms=engine.ttft_ms[-1],
                            outcome=tier_outcome(before, tier_stats(engine._prefix)),
                            prefill_ms=engine.counters["prefill_ms"] - c0["prefill_ms"]))
    return out


def tier_copy_times(kv: str, n_pages: int = 64, reps: int = 5) -> dict:
    """The tier's copies alone, at Llama-3-8B width on a cache of its own
    (2 x ``n_pages`` device pages, an ``n_pages`` host tier, random rows):
    a ``n_pages``-page demotion (call to copy complete, wall; events on the
    engine stream before the call and after it, which waits for the copy;
    the host enqueue), then its promotion into fresh pages (the host
    enqueue, of it the staging into pinned buffers, and the copies and
    scatter between events on the engine stream around ``_upload_pages``),
    the round trip bit for bit, and the yardsticks: one pinned-to-device
    ``copy_`` and one device-to-pinned ``copy_`` of the same bytes (CUDA
    events), and one host ``copy_`` of the same bytes between pinned
    buffers (the staging's memcpy)."""
    from clearml_serving_tpu_torch.llm.kv_cache import PagedKVCache

    pc = PagedKVCache(32, 8, 128, num_pages=2 * n_pages + 1, page_size=16, max_slots=1,
                      dtype=torch.bfloat16, kv_quant=kv, device=DEV)
    gen = torch.Generator(DEV).manual_seed(9)
    for pool in pc._pools():
        if pool.dtype == torch.int8:
            pool.copy_(torch.randint(-127, 128, pool.shape, generator=gen, device=DEV))
        else:
            pool.copy_(torch.randn(pool.shape, generator=gen, device=DEV))
    tier = pc.enable_host_tier(n_pages)
    pages = list(range(1, n_pages + 1))
    fresh = list(range(n_pages + 1, 2 * n_pages + 1))
    before = [pool[:, :, pages].clone() for pool in pc._pools()]
    res = {"alloc_s": tier.alloc_seconds, "bytes": n_pages * tier.page_bytes}
    demote, promote = [], []
    upload_start = torch.cuda.Event(enable_timing=True)
    real_upload = pc._upload_pages

    def upload(rows, pages):
        upload_start.record(pc.stream)
        staged.append(time.perf_counter())
        real_upload(rows, pages)

    pc._upload_pages = upload
    for _ in range(reps):
        staged = []
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        sync()
        start.record(pc.stream)
        t0 = time.perf_counter()
        host_ids = pc.demote_pages(pages)
        enqueue = time.perf_counter() - t0
        end.record(pc.stream)
        end.synchronize()
        demote.append(((time.perf_counter() - t0) * 1e3, start.elapsed_time(end), enqueue * 1e6))
        sync()
        t0 = time.perf_counter()
        pc.promote_pages(host_ids, fresh)
        enqueue = time.perf_counter() - t0
        end.record(pc.stream)
        end.synchronize()
        promote.append((upload_start.elapsed_time(end), enqueue * 1e6,
                        (staged[0] - t0) * 1e3))
        if pc.reap_promotions(force=True) != 1:
            raise AssertionError("a promotion was not reaped")
    res["round_trip_bitwise"] = all(torch.equal(a, pool[:, :, fresh])
                                    for a, pool in zip(before, pc._pools()))
    med = lambda xs: sorted(xs)[len(xs) // 2]   # noqa: E731
    res.update(demote_wall_ms=med([d[0] for d in demote]),
               demote_stream_ms=med([d[1] for d in demote]),
               demote_enqueue_us=med([d[2] for d in demote]),
               promote_stream_ms=med([p[0] for p in promote]),
               promote_enqueue_us=med([p[1] for p in promote]),
               promote_staging_ms=med([p[2] for p in promote]))
    host = torch.empty(res["bytes"], dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(res["bytes"], dtype=torch.uint8, device=DEV)
    h2d, d2h = [], []
    for _ in range(reps):
        for times, dst, src in ((h2d, dev, host), (d2h, host, dev)):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            dst.copy_(src, non_blocking=True)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    res.update(h2d_copy_ms=med(h2d), d2h_copy_ms=med(d2h))
    other = torch.empty_like(host, pin_memory=True)
    memcpy = []
    for _ in range(reps):
        t0 = time.perf_counter()
        other.copy_(host)
        memcpy.append((time.perf_counter() - t0) * 1e3)
    res["host_memcpy_ms"] = med(memcpy)
    del pc, tier, before, host, dev, other
    release_card_memory()
    return res


def phase_kv_tier(params, card: str, preset: str = "llama3-8b") -> dict:
    """Phase 9: the prefix cache's host-RAM tier and the ownership ledger at
    Llama-3-8B full width (max_batch 8, max_seq_len 2048, page_size 16,
    ``prefix_cache`` 256, ``prefix_block`` 64), the KV sanitizer and the
    strict ledger armed, each arm of ``TIER_ARMS`` warmed up, then six
    1024-token heads, one chat each, twice (``tier_traffic``). Holds: each
    tiered arm's contents equal its tierless twin's in both rounds; every
    promoted page's K/V (and scale rows) equal its clone from before
    demotion; the lookups' tiers and hit lengths, the demotions and
    promotions equal ``TIER_EXPECTED`` (the reference's cache over the same
    sequence); every promotion reaped by drain; 0 sanitizer failures and
    no drain-zero ledger entry outstanding; no capture while serving; the
    kernels' launches per step. Prints TTFT and prefill time of cold
    admissions, HBM hits and host hits, the promotions' total time and
    overlap, the 64-page copies beside their yardsticks, the tier's pinned
    allocation time and the page count "auto" would choose here."""
    from clearml_serving_tpu_torch.llm import lifecycle_ledger
    from clearml_serving_tpu_torch.llm.engine import auto_host_tier_pages
    from clearml_serving_tpu_torch.llm.warmup import warmup_plan
    from clearml_serving_tpu_torch.ops.paged_attention import (paged_attention,
                                                                ragged_paged_attention)

    t_phase = time.perf_counter()
    _heads, rounds = tier_traffic(0)
    warm = tier_warmup_prompts()
    saved = {k: os.environ.get(k) for k in ("TPUSERVE_SANITIZE", "TPUSERVE_LEDGER")}
    os.environ.update(TPUSERVE_SANITIZE="1", TPUSERVE_LEDGER="strict")
    runs = {}
    try:
        for arm, kv, knobs, twin, clone in TIER_ARMS:
            engine, _tok = _engine(params, kv, preset, **knobs)
            tiered = engine.paged_cache.host_tier is not None
            expected = TIER_EXPECTED["tiered" if tiered else "untiered"]
            ledger = engine._ledger
            ledger.reset(strict=True)
            pc = engine.paged_cache
            hooks = hook_tier(pc, clone) if tiered else None
            plan_equal = [s["prompt_ids"] for s in warmup_plan(engine)] == warm
            asyncio.run(engine.warmup())
            after_warm = tier_stats(engine._prefix)
            for key in engine.counters:
                engine.counters[key] = 0
            paged_attention.launches = ragged_paged_attention.launches = 0
            t0 = time.perf_counter()
            chats = asyncio.run(tier_arm_run(engine, rounds))
            wall = time.perf_counter() - t0
            c = dict(engine.counters)
            end = tier_stats(engine._prefix)
            tier = engine.lifecycle_stats()["kv_tier"]
            lstats = ledger.stats()
            n_layers = engine.model.n_layers
            outcomes = [chat["outcome"] for chat in chats]
            checks = {
                "the warmup plan": plan_equal,
                "stats after warmup": after_warm == expected["warmup"],
                "hit tiers and lengths": outcomes == expected["traffic"],
                "stats at the end": end == expected["end"],
                "{} tokens each".format(TIER_MAX_TOKENS): all(
                    len(ch["tokens"]) == TIER_MAX_TOKENS for ch in chats),
                "no capture while serving": c["serve_captures"] == 0,
                "paged launches": (paged_attention.launches == n_layers * (
                    c["decode_steps"] + c["ragged_chain_steps"]) > 0),
                "ragged launches": (ragged_paged_attention.launches == n_layers * c["ragged_steps"]
                                    and (c["ragged_steps"] > 0) == ("scheduler" in knobs)),
                "sanitizer": (engine._sanitizer.stats()["failures"] == 0
                              and engine._sanitizer.stats()["checks"] > 0),
                "ledger at drain": (lstats["leaks"] == 0 and lstats["double_releases"] == 0
                                    and lstats["acquires"] > 0
                                    and all(lstats["outstanding"][r] == 0
                                            for r, policy in lifecycle_ledger.RESOURCES.items()
                                            if policy["drain_zero"])),
            }
            if tiered:
                checks.update({
                    "page bytes": tier["page_bytes"] == TIER_PAGE_BYTES[kv],
                    "tier pinned on the card": (pc.host_tier.pinned == pc.host_tier.hk.is_pinned()
                                                == (torch.device(DEV).type == "cuda")),
                    "every promotion reaped": (not pc._promotions
                                               and pc.promo_reaped == hooks["counts"]["promotions"]
                                               and hooks["counts"]["promotions"] > 0),
                })
            if clone:
                checks["promoted rows equal their clones"] = hooks["check"]()
            by = {}
            for chat in chats:
                by.setdefault(chat["outcome"][0], []).append(chat)
            med = lambda xs: sorted(xs)[len(xs) // 2] if xs else None   # noqa: E731
            run = dict(arm=arm, kv=kv or "bf16", tiered=tiered, twin=twin, checks=checks,
                       contents=[ch["tokens"] for ch in chats], outcomes=outcomes,
                       stats_after_warmup=after_warm, stats_end=end, kv_tier=tier,
                       ledger=lstats, sanitizer=engine._sanitizer.stats(), wall_s=wall,
                       counters={k: c[k] for k in ("decode_steps", "ragged_steps",
                                                   "ragged_chain_steps", "prefills",
                                                   "serve_captures", "graph_replays")},
                       paged_launches=paged_attention.launches,
                       ragged_launches=ragged_paged_attention.launches,
                       ttft_ms={k: med([ch["ttft_ms"] for ch in v]) for k, v in by.items()},
                       prefill_ms={k: med([ch["prefill_ms"] for ch in v])
                                   for k, v in by.items()},
                       alloc_s=pc.host_tier.alloc_seconds if tiered else None,
                       tier_calls=hooks["counts"] if tiered else None,
                       chats=[dict(outcome=ch["outcome"], ttft_ms=round(ch["ttft_ms"], 2),
                                   prefill_ms=round(ch["prefill_ms"], 2)) for ch in chats])
            log("  {} kv={} {}{}: lookups {}; after warmup {}; at the end {}; TTFT median ms "
                "{}; prefill median ms {}; kv_tier demotions {} promotions {} hits {} "
                "promo_total_ms {} promo_wait_ms {} overlap {} reaps {}; tier alloc {} s; "
                "launches paged {} ragged {} over {} decode, {} chained, {} ragged steps; "
                "ledger {}; sanitizer {}; wall {:.3f} s ({})".format(
                    arm, kv or "bf16", "tiered" if tiered else "untiered",
                    " ragged" if "scheduler" in knobs else "", outcomes, after_warm, end,
                    run["ttft_ms"], run["prefill_ms"], tier and tier["demotions"],
                    tier and tier["promotions"], tier and tier["hits_by_tier"],
                    tier and tier["promo_total_ms"], tier and tier["promo_wait_ms"],
                    tier and tier["promo_overlap_ratio"], tier and tier["reaps"],
                    run["alloc_s"], run["paged_launches"], run["ragged_launches"],
                    c["decode_steps"], c["ragged_chain_steps"], c["ragged_steps"], lstats,
                    run["sanitizer"], wall, card))
            if tiered:
                calls = hooks["counts"]
                log("    {}: host ms per demotion call {} (rounds of 1 or more runs); per "
                    "promotion call {} for {} pages".format(
                        arm, [round(x, 3) for x in calls["demote_ms"]],
                        [round(x, 3) for x in calls["promote_ms"]], calls["promote_pages"]))
            log("    {}: per chat (outcome, TTFT ms, prefill ms) {}".format(
                arm, [(ch["outcome"][0], ch["ttft_ms"], ch["prefill_ms"])
                      for ch in run["chats"]]))
            engine.stop()
            del engine, pc, hooks
            release_card_memory()
            runs[arm] = run
            failed = [name for name, ok in checks.items() if not ok]
            if failed:
                raise AssertionError("phase 9 arm {}: failed {}".format(arm, failed))
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        lifecycle_ledger.get().reset(strict=False)
        lifecycle_ledger.disarm()
    for arm, run in runs.items():
        if run["twin"] is not None and run["contents"] != runs[run["twin"]]["contents"]:
            first = [first_token_difference(a, b)
                     for a, b in zip(run["contents"], runs[run["twin"]]["contents"])]
            raise AssertionError("phase 9: arm {}'s contents differ from arm {}'s: first "
                                 "differences {}".format(arm, run["twin"], first))
    # the schedulers compute a prompt through other kernels: reported only
    ragged_vs_two = [first_token_difference(a, b)
                     for a, b in zip(runs["D"]["contents"], runs["A"]["contents"])]
    copies = {kv or "bf16": tier_copy_times(kv) for kv in ("", "int8")}
    for kv, row in copies.items():
        if not row["round_trip_bitwise"]:
            raise AssertionError("phase 9: the {} 64-page round trip changed bits".format(kv))
    from clearml_serving_tpu_torch.llm import kv_cache

    auto = {"mem_available_bytes": kv_cache.available_host_memory_bytes(),
            "cohosted": kv_cache.cohosted_worker_processes(),
            **{"pages_" + (kv or "bf16"): auto_host_tier_pages(TIER_PAGE_BYTES[kv])
               for kv in ("", "int8")}}
    log("  each tiered arm's contents equal its tierless twin's (B = Bt = A, C = C0, D = D0); "
        "ragged D against two-dispatch A, first differences by chat: {}".format(ragged_vs_two))
    for kv, row in copies.items():
        log("  64-page copies, {} ({} bytes): demotion {:.3f} ms call to copy complete, "
            "{:.3f} ms between engine-stream events around the call, {:.1f} us enqueue; "
            "promotion {:.1f} us enqueue ({:.3f} ms of it staging on the host), {:.3f} ms "
            "of copies and scatter on the engine stream; yardsticks pinned->device copy_ "
            "{:.3f} ms, device->pinned {:.3f} ms, host pinned->pinned copy_ {:.3f} ms; "
            "round trip bitwise {}; the 64-page tier pinned in {:.3f} s ({})".format(
                kv, row["bytes"], row["demote_wall_ms"], row["demote_stream_ms"],
                row["demote_enqueue_us"], row["promote_enqueue_us"], row["promote_staging_ms"],
                row["promote_stream_ms"], row["h2d_copy_ms"], row["d2h_copy_ms"],
                row["host_memcpy_ms"], row["round_trip_bitwise"], row["alloc_s"], card))
    log("  prefix_cache_host_mb 'auto' here: MemAvailable {} bytes, {} co-hosted process(es): "
        "{} bf16 pages, {} int8 pages ({})".format(
            auto["mem_available_bytes"], auto["cohosted"], auto["pages_bf16"],
            auto["pages_int8"], card))
    for run in runs.values():
        run["contents"] = [t[:8] for t in run["contents"]]
    out = dict(card=card, runs=list(runs.values()), ragged_vs_two_dispatch=ragged_vs_two,
               copies=copies, auto=auto, seconds=time.perf_counter() - t_phase)
    log("  phase 9 in {:.1f} s".format(out["seconds"]))
    return out


SAMPLING_NOTES = ("The port serves the OpenAI routes over paged attention on one card; this "
                  "chat asks for a short answer about how decode batches are formed, ")
# eight ~100-token chats: four seeded sampled with penalties and logprobs,
# two greedy with a logit bias (one forcing 'A' at +100) and logprobs, two
# plain
SAMPLING_CHATS = [
    (SAMPLING_NOTES + "seeded chat {}.".format(i),
     {"temperature": 0.8, "top_p": 0.9, "seed": 1000 + i, "presence_penalty": 0.4,
      "frequency_penalty": 0.3, "repetition_penalty": 1.1, "logprobs": True,
      "top_logprobs": 5})
    for i in range(4)
] + [
    (SAMPLING_NOTES + "greedy chat forced.", {"logit_bias": {"65": 100.0}, "logprobs": True,
                                              "top_logprobs": 5}),
    (SAMPLING_NOTES + "greedy chat nudged.", {"logit_bias": {"101": 3.0}, "logprobs": True,
                                              "top_logprobs": 5}),
    (SAMPLING_NOTES + "plain chat one.", {"temperature": 0.7}),
    (SAMPLING_NOTES + "plain chat two.", {}),
]
SAMPLING_TOKENS = 64   # 128 before phase 14 came (a depth cut)
# a scored-back completion against its decode entries (bf16 logits allow
# two ulps more: bf16_logit_ulp)
SCORE_TOL = 2e-2
SAMPLING_SPEC_TOKENS = 64
# the decode-step timing variants: 8 chats each, SAMPLING_TOKENS tokens
STEP_VARIANTS = [
    ("plain_sampled", {"temperature": 0.8}),
    ("extras_unseeded", {"temperature": 0.8, "presence_penalty": 0.4}),
    ("extras_seeded", {"temperature": 0.8, "presence_penalty": 0.4, "seed": 7}),
    ("extras_seeded_logprobs", {"temperature": 0.8, "presence_penalty": 0.4, "seed": 7,
                                "logprobs": True, "top_logprobs": 5}),
]
SPEC_SAMPLING_GREEDY = [SPEC_PROMPTS[0], SPEC_PROMPTS[1]]


async def post_json(session, base, path, body) -> dict:
    async with session.post(base + path, json=dict(body, model="llama3-8b")) as r:
        if r.status != 200:
            raise AssertionError("{} -> HTTP {}: {}".format(path, r.status, await r.text()))
        return await r.json()


async def sampling_chats(s, base, chats, max_tokens, seed_offset=0) -> list:
    """The chats concurrently (non-streamed): per chat (content, logprob
    content or None, completion tokens, finish reason)."""
    async def one(prompt, fields):
        out = await post_json(s, base, "/serve/openai/v1/chat/completions", dict(
            fields, messages=[{"role": "user", "content": prompt}], max_tokens=max_tokens))
        choice = out["choices"][0]
        lp = choice["logprobs"]["content"] if choice["logprobs"] else None
        return (choice["message"]["content"], lp, out["usage"]["completion_tokens"],
                choice["finish_reason"])

    return list(await asyncio.gather(*(one(p, f) for p, f in chats)))


def _zero_counts(engine) -> None:
    from clearml_serving_tpu_torch.ops.paged_attention import (
        paged_attention, ragged_paged_attention)

    for key in engine.counters:
        engine.counters[key] = 0 if isinstance(engine.counters[key], int) else 0.0
    for fn in (paged_attention, ragged_paged_attention):
        fn.launches = fn.setup_launches = 0
    ragged_paged_attention.tree_launches = 0


def _launch_counts() -> dict:
    """The kernels' launch counts, and the set-up launches of the capture
    warm-up runs (``*_setup``), which the counts leave out and a trace
    holds."""
    from clearml_serving_tpu_torch.ops.paged_attention import (
        paged_attention, ragged_paged_attention)

    return {"paged": paged_attention.launches, "ragged": ragged_paged_attention.launches,
            "tree": ragged_paged_attention.tree_launches,
            "paged_setup": paged_attention.setup_launches,
            "ragged_setup": ragged_paged_attention.setup_launches}


async def sampling_10a(engine, tokenizer, card: str) -> dict:
    """Phase 10a's traffic and holds on one two-dispatch engine (depth 2,
    graphs, warmed up). Returns the seeded contents and the numbers."""
    out = {}
    async with served(engine, tokenizer) as (_app, base, s):
        await engine.warmup()
        _zero_counts(engine)
        t0 = time.perf_counter()
        first = await sampling_chats(s, base, SAMPLING_CHATS, SAMPLING_TOKENS)
        out["wall_s"] = time.perf_counter() - t0
        c = dict(engine.counters)
        launches = _launch_counts()
        n_layers = engine.model.n_layers
        if c["decode_steps"] == 0 or launches["paged"] != n_layers * c["decode_steps"]:
            raise AssertionError("10a: paged_attention launched {} times for {} decode steps"
                                 .format(launches["paged"], c["decode_steps"]))
        out.update(paged_launches=launches["paged"], decode_steps=c["decode_steps"],
                   tokens=c["tokens_emitted"], step_ms=c["decode_ms"] / c["decode_steps"])
        forced = first[4][0]
        if forced != "A" * SAMPLING_TOKENS:
            raise AssertionError("10a: +100 bias did not force 'A' at every step: {!r}".format(
                forced[:40]))
        for content, lp, _n, _f in first[4:6]:
            for item in lp:
                if item["logprob"] != item["top_logprobs"][0]["logprob"] or \
                        item["token"] != item["top_logprobs"][0]["token"]:
                    raise AssertionError("10a: a greedy row's chosen logprob is not its top-1: "
                                         "{}".format(item))
        if any(len(lp) != SAMPLING_TOKENS or len(lp[0]["top_logprobs"]) != 5
               for _c, lp, _n, _f in first[:4]):
            raise AssertionError("10a: a seeded chat lacks its 128 logprob entries of top 5")
        # the four seeded chats alone (the other four absent)
        alone = await sampling_chats(s, base, SAMPLING_CHATS[:4], SAMPLING_TOKENS)
        # min_tokens 16 with EOS biased to the top
        floor = await sampling_chats(s, base, [(SAMPLING_NOTES + "floor.", {
            "min_tokens": 16, "logit_bias": {str(tokenizer.eos_token_id): 100.0}})],
            SAMPLING_TOKENS)
        # n = 4 with seed s against four singles with seeds s..s+3
        body = dict(SAMPLING_CHATS[0][1], messages=[{"role": "user",
                                                     "content": SAMPLING_CHATS[0][0]}],
                    max_tokens=32)
        multi = await post_json(s, base, "/serve/openai/v1/chat/completions", dict(body, n=4))
        singles = await asyncio.gather(*(post_json(
            s, base, "/serve/openai/v1/chat/completions", dict(body, seed=body["seed"] + i))
            for i in range(4)))
        # scoring: a 2047-token prompt, echo + logprobs 5 + max_tokens 0
        ids = [(i * 37 + 11) % 95 + 32 for i in range(2047)]
        await engine.wait_drained()
        on_card = torch.device(DEV).type == "cuda"
        if on_card:
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        scored = await post_json(s, base, "/serve/openai/v1/completions", {
            "prompt": ids, "max_tokens": 0, "echo": True, "logprobs": 5})
        score_s = time.perf_counter() - t0
        score_rise = torch.cuda.max_memory_allocated() - mem0 if on_card else 0
        # a greedy completion scored back
        prompt = SAMPLING_NOTES + "score me."
        gen = await post_json(s, base, "/serve/openai/v1/completions", {
            "prompt": prompt, "max_tokens": 32, "logprobs": 5,
            "return_tokens_as_token_ids": True})
        gen_ids = [int(t.split(":")[1]) for t in gen["choices"][0]["logprobs"]["tokens"]]
        back_ids = tokenizer.encode(prompt) + gen_ids
        back = await post_json(s, base, "/serve/openai/v1/completions", {
            "prompt": back_ids, "max_tokens": 0, "echo": True, "logprobs": 5})
        await engine.wait_drained()
        ulp = bf16_logit_ulp(engine.model, back_ids, len(gen_ids))
        # ms per decode step on 8 x SAMPLING_TOKENS-token chats, per variant (a short
        # run first captures the variant)
        variants = {}
        for name, fields in STEP_VARIANTS:
            chats = [(SAMPLING_NOTES + "timing chat {}.".format(i), dict(
                fields, **({"seed": fields["seed"] + i} if "seed" in fields else {})))
                for i in range(8)]
            await sampling_chats(s, base, chats, 8)
            await engine.wait_drained()
            for key in ("decode_ms", "decode_steps", "serve_captures"):
                engine.counters[key] = 0
            await sampling_chats(s, base, chats, SAMPLING_TOKENS)
            c2 = engine.counters
            if c2["serve_captures"]:
                raise AssertionError("10a: a capture inside the timed {} run".format(name))
            variants[name] = c2["decode_ms"] / max(1, c2["decode_steps"])
        capture_ms = dict(engine.health()["graph_variants"])
    seeded = [r[0] for r in first[:4]]
    if [r[0] for r in alone] != seeded:
        raise AssertionError("10a: the seeded chats alone differ from the 8-chat batch")
    if floor[0][2] != 17 or floor[0][3] != "stop":
        raise AssertionError("10a: min_tokens 16 under a +100 EOS gave {} tokens ({})".format(
            floor[0][2], floor[0][3]))
    if [c["message"]["content"] for c in multi["choices"]] != \
            [r["choices"][0]["message"]["content"] for r in singles]:
        raise AssertionError("10a: n=4 with seed s differs from single seeds s..s+3")
    lp = scored["choices"][0]["logprobs"]
    if len(lp["tokens"]) != 2047 or lp["token_logprobs"][0] is not None or any(
            len(d) < 1 for d in lp["top_logprobs"][1:]):
        raise AssertionError("10a: the 2047-token scoring call is malformed")
    decode_lp = gen["choices"][0]["logprobs"]["token_logprobs"]
    back_lp = back["choices"][0]["logprobs"]["token_logprobs"][-len(gen_ids):]
    diffs = [abs(a - b) for a, b in zip(decode_lp, back_lp)]
    score_err = max(diffs)
    # both paths read bf16 logits (the lm_head's output in the model dtype,
    # as in the reference): two forwards may round the chosen logit and the
    # log-sum-exp's leading logits to neighbouring bf16 values, each moving
    # a logprob by up to one ulp at the largest logit's magnitude, on top
    # of the 2e-2
    score_tol = SCORE_TOL + 2 * ulp
    if len(decode_lp) != len(gen_ids) or score_err > score_tol:
        raise AssertionError("10a: scored-back logprobs differ from the decode path's by {} "
                             "(tolerance {} = 2e-2 + two bf16 ulps {} of the logits)".format(
                                 score_err, score_tol, ulp))
    out.update(seeded=seeded, score_2047_s=score_s, score_transient_bytes=score_rise,
               score_back_max_err=score_err, score_back_over_2e2=sum(d > SCORE_TOL
                                                                     for d in diffs),
               score_back_tol=score_tol, step_ms_variants=variants,
               capture_ms=capture_ms)
    log("  10a: 8 chats x {} tokens in {:.3f} s, {:.3f} ms a decode step (paged_attention "
        "{} launches for {} steps); forced bias, min_tokens 16 (17 with EOS), greedy top-1 "
        "logprobs, n=4 = seeds s..s+3: held ({})".format(
            SAMPLING_TOKENS, out["wall_s"], out["step_ms"], out["paged_launches"],
            out["decode_steps"], card))
    log("  10a: 2047-token echo + logprobs 5 + max_tokens 0 scored in {:.3f} s, "
        "max_memory_allocated rose {:.1f} MiB; a greedy completion scored back within {:.2e} "
        "of its decode entries, {} of {} tokens over 2e-2 (held to {:.5f}) ({})".format(
            score_s, score_rise / 2 ** 20, score_err, out["score_back_over_2e2"], len(diffs),
            score_tol, card))
    log("  10a: ms per decode step, 8 x {}-token chats: {} ({})".format(SAMPLING_TOKENS,
        json.dumps({k: round(v, 3) for k, v in variants.items()}), card))
    log("  10a: graph variants and first-use capture ms: {} ({})".format(
        json.dumps({k: round(v, 1) for k, v in capture_ms.items()}), card))
    return out


def bf16_logit_ulp(model, ids, n_last) -> float:
    """One bf16 ulp at the largest |logit| over the last ``n_last``
    positions' predictions of ``ids`` (one teacher-forced forward): the
    step by which a rounding of the logits can move a logprob."""
    import math

    dev = model.device
    tokens = torch.tensor([ids], dtype=torch.long, device=dev)
    hidden = model.hidden_states(tokens, torch.tensor([len(ids)], dtype=torch.int32,
                                                      device=dev))[0]
    logits = model.logits_of(hidden[len(ids) - 1 - n_last:len(ids) - 1])
    top = float(logits.abs().max())
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


async def seeded_arm(engine, tokenizer) -> list:
    async with served(engine, tokenizer) as (_app, base, s):
        res = await sampling_chats(s, base, SAMPLING_CHATS[:4], SAMPLING_TOKENS)
        await engine.wait_drained()
    return [r[0] for r in res]


async def sampling_10b(engine, tokenizer, card: str) -> dict:
    """The four seeded chats beside two repetitive greedy chats on a ragged
    tree-speculation engine, twice: bitwise equal; the seeded rows never
    verify, the greedy rows do."""
    chats = SAMPLING_CHATS[:4] + [(p, {}) for p in SPEC_SAMPLING_GREEDY]
    verified = []
    variant_of = engine._ragged_variant

    def spy(plan):
        import numpy as np
        if plan["row_logit_idx"] is not None:
            slots = np.nonzero(plan["spec_mask"] | plan["sspec_mask"])[0]
            verified.append([engine._slot_req[int(x)] for x in slots])
        return variant_of(plan)

    engine._ragged_variant = spy
    runs = []
    async with served(engine, tokenizer) as (_app, base, s):
        _zero_counts(engine)
        for _ in range(2):
            runs.append(await sampling_chats(s, base, chats, SAMPLING_SPEC_TOKENS))
            await engine.wait_drained()
        c = dict(engine.counters)
        launches = _launch_counts()
    n_layers = engine.model.n_layers
    if [r[0] for r in runs[0]] != [r[0] for r in runs[1]]:
        raise AssertionError("10b: the replayed composition differs")
    extras_verified = [r for rows in verified for r in rows if r.seed is not None]
    if extras_verified or not any(verified):
        raise AssertionError("10b: {} seeded rows rode verify rows; {} verify steps".format(
            len(extras_verified), len(verified)))
    if launches["ragged"] != n_layers * c["ragged_steps"] or \
            launches["tree"] != n_layers * c["ragged_verify_steps"] or \
            launches["paged"] != n_layers * (c["decode_steps"] + c["ragged_chain_steps"]):
        raise AssertionError("10b: launches {} for counters {}".format(launches, c))
    out = dict(ragged_steps=c["ragged_steps"], verify_steps=c["ragged_verify_steps"],
               ragged_launches=launches["ragged"], tree_launches=launches["tree"],
               paged_launches=launches["paged"], tokens=c["tokens_emitted"])
    log("  10b: 2 x (4 seeded + 2 greedy) chats x {} tokens, bitwise equal; {} ragged steps "
        "({} with verify rows, none of them a seeded row); launches ragged {} tree {} paged "
        "{} ({})".format(SAMPLING_SPEC_TOKENS, out["ragged_steps"], out["verify_steps"],
                         out["ragged_launches"], out["tree_launches"], out["paged_launches"],
                         card))
    return out


def phase_sampling(params, card: str, preset: str = "llama3-8b") -> dict:
    """Phase 10: the sampling surface of the OpenAI routes (10a on a
    two-dispatch engine at depth 2 with graphs and its depth-1 and eager
    arms, 10b on a ragged tree-speculation engine with int8 KV)."""
    t0 = time.perf_counter()
    engine, tokenizer = _engine(params, "", preset, pipeline_depth=2)
    a = asyncio.run(sampling_10a(engine, tokenizer, card))
    del engine
    release_card_memory()
    arms = {}
    for arm, depth, graphs in (("depth1", 1, True), ("eager", 2, False)):
        engine, tokenizer = _engine(params, "", preset, cuda_graphs=graphs,
                                    pipeline_depth=depth)
        arms[arm] = asyncio.run(seeded_arm(engine, tokenizer))
        del engine
        release_card_memory()
        if arms[arm] != a["seeded"]:
            raise AssertionError("10a: the seeded chats differ in the {} arm".format(arm))
    log("  10a: the four seeded chats bitwise equal alone, at depth 1 and eager ({})".format(
        card))
    engine, tokenizer = _engine(params, "int8", preset, **TREE_KNOBS)
    b = asyncio.run(sampling_10b(engine, tokenizer, card))
    del engine
    release_card_memory()
    wall = time.perf_counter() - t0
    log("  phase 10: {:.1f} s".format(wall))
    a.pop("seeded")
    return dict(a, ragged=b, wall_s=wall)


# -- phase 11: guided decoding and tool calling ----------------------------------------

GUIDED_NOTES = ("The port constrains decoding by a grammar on one card; this chat asks for "
                "an answer in a fixed shape, ")
GUIDED_SCHEMA = {"type": "object", "properties": {
    "dir": {"enum": ["north", "south", "east", "west"]}, "n": {"type": "integer"},
    "ok": {"type": "boolean"}}, "required": ["dir", "n", "ok"]}
GUIDED_REGEX = "(north|south|east|west)"
GUIDED_CHOICES = ["yes", "no", "not sure"]
_SCHEMA_FORMAT = {"type": "json_schema", "json_schema": {"name": "reading",
                                                         "schema": GUIDED_SCHEMA}}
# eight ~100-token chats: two compass regexes (greedy, seeded), a choice, two
# schemas (greedy, seeded with penalties), a json_object and two plain ones;
# every one greedy or seeded, so the depth-1 eager run must give its tokens
GUIDED_CHATS = [
    (GUIDED_NOTES + "compass one.", {"guided_regex": GUIDED_REGEX}),
    (GUIDED_NOTES + "compass two.", {"guided_regex": GUIDED_REGEX, "temperature": 0.8,
                                      "seed": 21}),
    (GUIDED_NOTES + "a choice.", {"guided_choice": GUIDED_CHOICES, "temperature": 0.8,
                                   "seed": 22}),
    (GUIDED_NOTES + "schema one.", {"response_format": _SCHEMA_FORMAT}),
    (GUIDED_NOTES + "schema two.", {"response_format": _SCHEMA_FORMAT, "temperature": 0.8,
                                     "seed": 23, "presence_penalty": 0.4,
                                     "frequency_penalty": 0.3}),
    (GUIDED_NOTES + "any object.", {"response_format": {"type": "json_object"},
                                     "temperature": 0.8, "seed": 24}),
    (GUIDED_NOTES + "plain one.", {}),
    (GUIDED_NOTES + "plain two.", {"temperature": 0.7, "seed": 25}),
]
GUIDED_TOKENS = 64   # 128 before phase 14 came (a depth cut)
# each chat reports its token ids (the holds walk ids, not decoded text)
_IDS = {"logprobs": True, "top_logprobs": 1, "return_tokens_as_token_ids": True}
GUIDED_TOOLS = [
    {"type": "function", "function": {
        "name": "set_heading", "description": "Turn the ship to a compass heading",
        "parameters": {"type": "object", "properties": {
            "heading": {"enum": ["north", "south", "east", "west"]}},
            "required": ["heading"]}}},
    {"type": "function", "function": {
        "name": "lights", "description": "Switch the deck lights",
        "parameters": {"type": "object", "properties": {"on": {"type": "boolean"}},
                       "required": ["on"]}}},
]
# a tool call's budget: the longest call the two tools admit is ~60 bytes
TOOL_TOKENS = 96
# (label, tool_choice, streamed): required, forced by name (streamed and
# not: the same call), auto
TOOL_CASES = [("required", "required", False),
              ("forced", {"type": "function", "function": {"name": "lights"}}, False),
              ("forced_streamed", {"type": "function", "function": {"name": "lights"}}, True),
              ("auto", "auto", False)]
# the decode-step timing: 8 chats x GUIDED_TOKENS tokens, plain sampled against the
# same chats under a grammar that admits no EOS before 128 characters
GUIDED_STEP_VARIANTS = [
    ("plain_sampled", {"temperature": 0.8}),
    ("guided_sampled", {"temperature": 0.8, "guided_regex": "[a-z ]{128,160}"}),
]


def guided_pattern(fields: dict):
    """The regex a chat's guided fields compile from (the route's
    ``_guided_spec``), or None for a plain chat."""
    from clearml_serving_tpu_torch.llm import guided

    if fields.get("guided_regex"):
        return fields["guided_regex"]
    if fields.get("guided_choice"):
        return "({})".format("|".join(guided._regex_escape_literal(c)
                                      for c in fields["guided_choice"]))
    rf = fields.get("response_format") or {}
    if rf.get("type") == "json_schema":
        return guided.json_schema_to_regex(rf["json_schema"]["schema"])
    if rf.get("type") == "json_object":
        return guided.json_object_regex(3)
    return None


def check_guided_output(label: str, fields: dict, ids: list, finish: str, eos: int) -> str:
    """One guided chat's hold: a "stop" output is a whole match of its
    grammar (and, for a schema, a JSON object with its keys and types); a
    "length" one walks the grammar's byte DFA without dying. Returns the
    verdict's word."""
    from clearml_serving_tpu_torch.llm import guided

    pattern = guided_pattern(fields)
    dfa = guided.ByteDFA.from_regex(pattern)
    # the grammar admits byte ids alone, and EOS once it is satisfied
    body_ids = ids[:-1] if finish == "stop" and ids and ids[-1] == eos else ids
    stray = [t for t in body_ids if t >= 256]
    if stray:
        raise AssertionError("11: {} emitted non-byte ids {} under its grammar".format(
            label, stray[:8]))
    body = bytes(body_ids)
    if finish == "stop":
        if not dfa.matches(body):
            raise AssertionError("11: {} stopped on {!r}, not a match of its grammar".format(
                label, body[:80]))
        text = body.decode("utf-8")
        rf = fields.get("response_format") or {}
        if rf.get("type") == "json_schema":
            obj = json.loads(text)
            if (set(obj) != {"dir", "n", "ok"} or obj["dir"] not in
                    GUIDED_SCHEMA["properties"]["dir"]["enum"] or type(obj["n"]) is not int
                    or type(obj["ok"]) is not bool):
                raise AssertionError("11: {} is not its schema's object: {}".format(label, obj))
        elif rf.get("type") == "json_object" and not isinstance(json.loads(text), dict):
            raise AssertionError("11: {} is not a JSON object: {!r}".format(label, text))
        elif fields.get("guided_choice") and text not in fields["guided_choice"]:
            raise AssertionError("11: {} is not one of its choices: {!r}".format(label, text))
        return "match"
    if finish != "length" or eos in ids:
        raise AssertionError("11: {} finished {!r}".format(label, finish))
    state = 0
    for b in body:
        state = int(dfa.trans[state, b])
        if state < 0:
            raise AssertionError("11: {}'s {} bytes leave its grammar".format(label, len(body)))
    return "live prefix"


async def guided_chats(s, base, chats, max_tokens) -> list:
    """The chats concurrently: per chat (content, token ids, finish reason);
    a chat whose fields turn logprobs off reports no ids (None)."""
    async def one(prompt, fields):
        out = await post_json(s, base, "/serve/openai/v1/chat/completions", dict(
            _IDS, messages=[{"role": "user", "content": prompt}], max_tokens=max_tokens,
            **fields))
        choice = out["choices"][0]
        ids = ([int(e["token"].split(":")[1]) for e in choice["logprobs"]["content"]]
               if choice["logprobs"] else None)
        return choice["message"]["content"], ids, choice["finish_reason"]

    return list(await asyncio.gather(*(one(p, f) for p, f in chats)))


async def tool_call(s, base, tool_choice, streamed: bool) -> dict:
    """One chat with the two tools: (finish reason, content, [(name,
    arguments)]) from the JSON reply or the SSE deltas."""
    body = {"model": "llama3-8b", "messages": [{"role": "user", "content":
            GUIDED_NOTES + "steer the ship and mind the lights."}], "max_tokens": TOOL_TOKENS,
            "temperature": 0.8, "seed": 31, "tools": GUIDED_TOOLS, "tool_choice": tool_choice,
            "stream": streamed}
    if not streamed:
        out = await post_json(s, base, "/serve/openai/v1/chat/completions", body)
        choice = out["choices"][0]
        calls = [(c["function"]["name"], c["function"]["arguments"])
                 for c in choice["message"].get("tool_calls") or []]
        return {"finish": choice["finish_reason"], "content": choice["message"]["content"],
                "calls": calls}
    content, calls, finish = [], {}, None
    async with s.post(base + "/serve/openai/v1/chat/completions", json=body) as r:
        if r.status != 200:
            raise AssertionError("11b: HTTP {}: {}".format(r.status, await r.text()))
        async for raw in r.content:
            line = raw.decode().strip()
            if not line.startswith("data: {"):
                continue
            chunk = json.loads(line[len("data: "):])
            if "error" in chunk:
                raise AssertionError("11b: SSE error {}".format(chunk["error"]))
            for ch in chunk["choices"]:
                delta = ch["delta"]
                content.append(delta.get("content") or "")
                for tc in delta.get("tool_calls") or []:
                    name, args = calls.get(tc["index"], ("", ""))
                    fn = tc.get("function") or {}
                    calls[tc["index"]] = (name + (fn.get("name") or ""),
                                          args + (fn.get("arguments") or ""))
                finish = ch.get("finish_reason") or finish
    return {"finish": finish, "content": "".join(content) or None,
            "calls": [calls[i] for i in sorted(calls)]}


def check_tool_call(label: str, res: dict, forced) -> None:
    """A required or forced chat answers one schema-valid call with
    finish_reason "tool_calls"; an auto one answers calls or content."""
    if label == "auto" and res["finish"] != "tool_calls":
        if res["finish"] not in ("stop", "length") or res["calls"]:
            raise AssertionError("11b: auto answered {}".format(res))
        return
    if res["finish"] != "tool_calls" or not res["calls"]:
        raise AssertionError("11b: {} answered no call: {}".format(label, res))
    for name, args in res["calls"]:
        obj = json.loads(args)
        if forced and name != forced:
            raise AssertionError("11b: {} called {}, not {}".format(label, name, forced))
        if name == "set_heading":
            ok = set(obj) == {"heading"} and obj["heading"] in ("north", "south", "east", "west")
        elif name == "lights":
            ok = set(obj) == {"on"} and type(obj["on"]) is bool
        else:
            ok = False
        if not ok:
            raise AssertionError("11b: {} called {}({})".format(label, name, args))


def spy_compiles() -> tuple:
    """Time the engine's own grammar compiles (its admission workers call
    ``guided.compile_guided`` once per new grammar, and
    ``token_byte_table`` once per engine): host ms and states by kind, the
    tool calls' schemas apart. Returns (the dict it fills, a function that
    removes the spy)."""
    from clearml_serving_tpu_torch.llm import guided

    out = {}
    compile_guided, token_byte_table = guided.compile_guided, guided.token_byte_table
    choice = guided_pattern({"guided_choice": GUIDED_CHOICES})

    def timed_table(*args, **kwargs):
        t0 = time.perf_counter()
        table = token_byte_table(*args, **kwargs)
        out.setdefault("token_byte_table", (time.perf_counter() - t0) * 1e3)
        return table

    def timed_compile(spec, *args, **kwargs):
        t0 = time.perf_counter()
        grammar = compile_guided(spec, *args, **kwargs)
        ms = (time.perf_counter() - t0) * 1e3
        kind = spec.kind
        if kind == "regex":
            kind = {GUIDED_REGEX: "regex", choice: "choice"}.get(spec.payload, "regex_other")
        elif kind == "json_schema" and json.loads(spec.payload) != GUIDED_SCHEMA:
            kind = "tool_schema"
        if kind not in out:
            out[kind], out[kind + "_states"] = ms, grammar.n_states
        return grammar

    guided.compile_guided, guided.token_byte_table = timed_compile, timed_table

    def restore():
        guided.compile_guided, guided.token_byte_table = compile_guided, token_byte_table

    return out, restore


def check_registry(engine, label: str) -> dict:
    """At drain: every grammar reference back, no DFA state left in a slot,
    and (the ledger armed) no guided.ref, or any drain-zero resource,
    outstanding."""
    from clearml_serving_tpu_torch.llm import lifecycle_ledger

    health = engine.health()
    reg = health["guided"]
    if reg["refs"] != 0 or (engine._gstate >= 0).any():
        raise AssertionError("11{}: registry {} at drain, states {}".format(
            label, reg, engine._gstate.tolist()))
    ledger = health["ledger"]
    if ledger is not None:
        held = {r: n for r, n in ledger["outstanding"].items()
                if lifecycle_ledger.RESOURCES[r]["drain_zero"] and n}
        if ledger["leaks"] or ledger["double_releases"] or held:
            raise AssertionError("11{}: ledger {}".format(label, ledger))
    return reg


async def guided_11a(engine, tokenizer, card: str) -> dict:
    """Phase 11a's traffic and holds (two-dispatch, depth 2, graphs, warmed
    up), and 11b's tool calls on the same engine."""
    out = {}
    eos = tokenizer.eos_token_id
    n_layers = engine.model.n_layers
    async with served(engine, tokenizer) as (_app, base, s):
        await engine.warmup()
        reserved0 = torch.cuda.memory_reserved() if torch.device(DEV).type == "cuda" else 0
        _zero_counts(engine)
        t0 = time.perf_counter()
        first = await guided_chats(s, base, GUIDED_CHATS, GUIDED_TOKENS)
        out["wall_s"] = time.perf_counter() - t0
        await engine.wait_drained()
        c = dict(engine.counters)
        launches = _launch_counts()
        if c["decode_steps"] == 0 or launches["paged"] != n_layers * c["decode_steps"]:
            raise AssertionError("11a: paged_attention launched {} times for {} decode steps"
                                 .format(launches["paged"], c["decode_steps"]))
        verdicts = [check_guided_output(p[-14:], f, ids, finish, eos) if guided_pattern(f)
                    else finish for (p, f), (_t, ids, finish) in zip(GUIDED_CHATS, first)]
        out.update(paged_launches=launches["paged"], decode_steps=c["decode_steps"],
                   tokens=c["tokens_emitted"], verdicts=verdicts,
                   finishes=[r[2] for r in first], captures=c["serve_captures"])
        tools = {}
        for label, choice, streamed in TOOL_CASES:
            tools[label] = await tool_call(s, base, choice, streamed)
            check_tool_call(label, tools[label], "lights" if "forced" in label else None)
        if tools["forced"]["calls"] != tools["forced_streamed"]["calls"]:
            raise AssertionError("11b: the streamed forced call {} is not the non-streamed "
                                 "one {}".format(tools["forced_streamed"], tools["forced"]))
        # ms per decode step, plain sampled against guided in turns (plain,
        # guided, guided, plain; a short run first captures each variant)
        steps = {name: [] for name, _f in GUIDED_STEP_VARIANTS}
        for name, fields in GUIDED_STEP_VARIANTS + GUIDED_STEP_VARIANTS[::-1]:
            chats = [(GUIDED_NOTES + "timing chat {}.".format(i), fields) for i in range(8)]
            if not steps[name]:
                await sampling_chats(s, base, chats, 8)
                await engine.wait_drained()
            for key in ("decode_ms", "decode_steps", "serve_captures"):
                engine.counters[key] = 0
            await sampling_chats(s, base, chats, GUIDED_TOKENS)
            await engine.wait_drained()
            c2 = engine.counters
            if c2["serve_captures"]:
                raise AssertionError("11a: a capture inside the timed {} run".format(name))
            steps[name].append(c2["decode_ms"] / max(1, c2["decode_steps"]))
        reg = check_registry(engine, "a")
        capture_ms = {k: v for k, v in engine.health()["graph_variants"].items()
                      if "guided" in k}
        memory = guided_memory(engine, reserved0)
    out.update(ids=[r[1] for r in first], tools=tools, step_ms=steps, registry=reg,
               capture_ms=capture_ms, memory=memory)
    log("  11a: 8 chats x <= {} tokens in {:.3f} s (paged_attention {} launches for {} decode "
        "steps); outputs {}: held ({})".format(GUIDED_TOKENS, out["wall_s"],
                                                out["paged_launches"], out["decode_steps"],
                                                verdicts, card))
    log("  11b: tool calls {} ({})".format(json.dumps(tools), card))
    log("  11a: ms per decode step, 8 x {}-token chats, plain sampled and guided in turns "
        "(P G G P): {} ({})".format(GUIDED_TOKENS, json.dumps({k: [round(x, 3) for x in v]
                                                 for k, v in steps.items()}), card))
    log("  11a: guided graph variants, first-use capture ms: {}; tables {} ({})".format(
        json.dumps({k: round(v, 1) for k, v in capture_ms.items()}), json.dumps(reg), card))
    log("  11a: device memory of guided decoding: {} ({})".format(json.dumps(memory), card))
    return out


def graph_pool_mib(engine) -> dict:
    """MiB of each captured graph's private memory pool (the segments of
    ``torch.cuda.memory_snapshot()`` whose pool is the graph's), by
    variant label."""
    graphs = engine._graphs._graphs if engine._graphs is not None else {}
    if not graphs:
        return {}
    by_pool = {}
    for seg in torch.cuda.memory_snapshot():
        pool = tuple(seg.get("segment_pool_id") or ())
        by_pool[pool] = by_pool.get(pool, 0) + seg["total_size"]
    return {v.label(): by_pool.get(tuple(graph.pool()), 0) / 2**20
            for v, (graph, _out, _n) in graphs.items()}


def guided_memory(engine, reserved0: int) -> dict:
    """After 11a: the rise of ``memory_reserved`` since warmup (a capture
    empties the allocator's cache first, so this is a floor), each graph's
    pool, the tables' buffers and the guided graphs alive. Holds that no
    outgrown bucket outlives its drop: every buffer pair and guided graph
    is the current bucket's or one awaiting it."""
    engine._drop_outgrown_buckets()
    alive = sorted({v.label() for v in (engine._graphs._graphs if engine._graphs else {})
                    if v.guided})
    buckets = sorted(engine._gdev)
    stale = [b for b, _e in engine._gstale]
    if sorted(set(buckets) - set(stale)) != [engine._gbucket] or any(
            v.guided not in buckets for v in (engine._graphs._graphs if engine._graphs else {})
            if v.guided):
        raise AssertionError("11a: table buckets {} (current {}, awaiting drop {}), guided "
                             "graphs {}".format(buckets, engine._gbucket, stale, alive))
    reserved = torch.cuda.memory_reserved() if torch.device(DEV).type == "cuda" else 0
    return {"reserved_rise_mib": (reserved - reserved0) / 2**20,
            "graph_pool_mib": {k: round(v, 1) for k, v in graph_pool_mib(engine).items()},
            "table_mib": engine.health()["guided"]["table_bytes"] / 2**20,
            "buckets": buckets, "guided_graphs": alive}


async def guided_ids_arm(engine, tokenizer) -> list:
    async with served(engine, tokenizer) as (_app, base, s):
        res = await guided_chats(s, base, GUIDED_CHATS, GUIDED_TOKENS)
        await engine.wait_drained()
        check_registry(engine, "a")
    return [r[1] for r in res]


def trace_grids(prof) -> dict:
    """The ported attention kernels' main grids in a torch.profiler trace:
    one ``ragged_attention_kernel`` per ragged call, one
    ``paged_split_kernel`` per decode-attention call."""
    names = [name for name, _t0, _t1 in device_events(prof)]
    return {"ragged": sum("ragged_attention_kernel" in n for n in names),
            "paged": sum("paged_split_kernel" in n for n in names)}


async def guided_11c_pass(engine, tokenizer, profiler) -> dict:
    """11a's guided chats beside two repetitive greedy chats on a ragged
    tree-speculation engine (int8 KV), profiled when ``profiler`` is given:
    the outputs, the launch counts and the verify rows' requests."""
    # the greedy chats without logprobs: a logprob row never verifies
    chats = GUIDED_CHATS[:6] + [(p, {"logprobs": False}) for p in SPEC_SAMPLING_GREEDY]
    verified = []
    variant_of = engine._ragged_variant

    def spy(plan):
        import numpy as np
        if plan["row_logit_idx"] is not None:
            slots = np.nonzero(plan["spec_mask"] | plan["sspec_mask"])[0]
            verified.append([(engine._slot_req[int(x)], int(engine._gstate[int(x)]))
                             for x in slots])
        return variant_of(plan)

    engine._ragged_variant = spy
    async with served(engine, tokenizer) as (_app, base, s):
        _zero_counts(engine)
        ctx = profiler if profiler is not None else contextlib.nullcontext()
        with ctx:
            res = await guided_chats(s, base, chats, SAMPLING_SPEC_TOKENS)
            await engine.wait_drained()
            if torch.device(DEV).type == "cuda":
                torch.cuda.synchronize()
                if profiler is not None:
                    # the last kernels stay in the trace (``stop_profiler``)
                    time.sleep(PROFILE_TAIL_S)
        c = dict(engine.counters)
        launches = _launch_counts()
        reg = check_registry(engine, "c")
    return {"res": res, "counters": c, "launches": launches, "verified": verified,
            "registry": reg}


def guided_11c(params, preset: str, card: str, eos: int) -> dict:
    """Phase 11c: the ragged tree-speculation pass, profiled; its launch
    counts held to the counters and to the trace's grids. The profiler has
    dropped a record now and then (phase 6): a trace that disagrees is
    profiled once more on a fresh engine, the retry is reported in the
    kernels line (``trace_retries_guided``), and a second disagreement
    fails."""
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.device(DEV).type == "cuda"
    retries = []
    while True:
        t_pass = time.perf_counter()
        engine, tokenizer = _engine(params, "int8", preset, **TREE_KNOBS)
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            if on_card else None
        p = asyncio.run(guided_11c_pass(engine, tokenizer, prof))
        n_layers = engine.model.n_layers
        del engine
        release_card_memory()
        c, launches = p["counters"], p["launches"]
        if launches["ragged"] != n_layers * c["ragged_steps"] or \
                launches["tree"] != n_layers * c["ragged_verify_steps"] or \
                launches["paged"] != n_layers * (c["decode_steps"] + c["ragged_chain_steps"]):
            raise AssertionError("11c: launches {} for counters {}".format(launches, c))
        t_trace = time.perf_counter()
        # the trace holds the counted launches and those of the first-use
        # captures' warm-up runs, which the counts leave out
        ran = {k: launches[k] + launches[k + "_setup"] for k in ("ragged", "paged")}
        grids = trace_grids(prof) if prof is not None else dict(ran)
        t_trace = time.perf_counter() - t_trace
        if grids == ran:
            break
        if retries:
            raise AssertionError("11c: the trace holds {} grids, the counts say {}, twice"
                                 .format(grids, launches))
        retries.append({"traced": grids, "counted": ran})
        log("  11c: the trace holds {} grids, the counts say {}: profiling once more".format(
            grids, launches))
    guided_verified = [r for rows in p["verified"] for r, g in rows
                       if r.guided is not None or g >= 0]
    if guided_verified or not any(p["verified"]):
        raise AssertionError("11c: {} guided rows rode verify rows; {} verify steps".format(
            len(guided_verified), len(p["verified"])))
    chats = GUIDED_CHATS[:6]
    verdicts = [check_guided_output(prompt[-14:], fields, ids, finish, eos)
                for (prompt, fields), (_t, ids, finish) in zip(chats, p["res"])]
    out = dict(ragged_steps=c["ragged_steps"], verify_steps=c["ragged_verify_steps"],
               ragged_launches=launches["ragged"], tree_launches=launches["tree"],
               paged_launches=launches["paged"], traced=grids, verdicts=verdicts,
               setup_launches={k: launches[k + "_setup"] for k in ("ragged", "paged")},
               registry=p["registry"], tokens=c["tokens_emitted"], trace_retries=retries,
               pass_s=time.perf_counter() - t_pass, trace_s=t_trace)
    log("  11c: 6 guided + 2 repetitive greedy chats x {} tokens, int8 KV, tree speculation: "
        "{} ragged steps ({} with verify rows, none of them a guided row); launches ragged {} "
        "tree {} paged {}, the captures' warm-up runs {}, the trace's grids {} ({} retries); "
        "outputs {}; the pass {:.1f} s, reading its trace {:.1f} s ({})".format(
            SAMPLING_SPEC_TOKENS, out["ragged_steps"], out["verify_steps"],
            out["ragged_launches"], out["tree_launches"], out["paged_launches"],
            json.dumps(out["setup_launches"]), json.dumps(grids), len(retries), verdicts,
            out["pass_s"], t_trace, card))
    return out


def phase_guided(params, card: str, preset: str = "llama3-8b") -> dict:
    """Phase 11: guided decoding and tool calling on the OpenAI routes (11a
    on a two-dispatch engine at depth 2 with graphs and its depth-1 eager
    arm, 11b the tool_choice modes on the same engine, 11c on a ragged
    tree-speculation engine with int8 KV), under the ownership ledger."""
    from clearml_serving_tpu_torch.llm import lifecycle_ledger

    t0 = time.perf_counter()
    os.environ["TPUSERVE_LEDGER"] = "1"
    try:
        engine, tokenizer = _engine(params, "", preset, pipeline_depth=2)
        vocab = engine.model.vocab_size
        eos = tokenizer.eos_token_id
        compile_ms, restore = spy_compiles()
        try:
            a = asyncio.run(guided_11a(engine, tokenizer, card))
        finally:
            restore()
        del engine
        release_card_memory()
        log("  11: host ms of the engine's compile of each kind at vocab {}, in its admission "
            "worker: {} ({})".format(vocab, json.dumps({
                k: round(v, 1) if isinstance(v, float) else v
                for k, v in compile_ms.items()}), card))
        split = {"11a+11b": time.perf_counter() - t0}
        engine, tokenizer = _engine(params, "", preset, cuda_graphs=False, pipeline_depth=1)
        eager_ids = asyncio.run(guided_ids_arm(engine, tokenizer))
        del engine
        release_card_memory()
        split["11a eager"] = time.perf_counter() - t0 - sum(split.values())
        if eager_ids != a["ids"]:
            diff = [i for i, (x, y) in enumerate(zip(eager_ids, a["ids"])) if x != y]
            raise AssertionError("11a: chats {} differ between depth 2 with graphs and depth 1 "
                                 "eager".format(diff))
        log("  11a: the 8 chats' tokens equal at depth 1 eager ({})".format(card))
        c = guided_11c(params, preset, card, eos)
        split["11c"] = time.perf_counter() - t0 - sum(split.values())
    finally:
        os.environ.pop("TPUSERVE_LEDGER", None)
        lifecycle_ledger.get().reset(strict=False)
        lifecycle_ledger.disarm()
    wall = time.perf_counter() - t0
    log("  phase 11: {:.1f} s ({})".format(wall, ", ".join(
        "{} {:.1f} s".format(k, v) for k, v in split.items())))
    a.pop("ids")
    return dict(a, compile_ms=compile_ms, ragged=c, wall_s=wall)


# -- phase 12: the two-dispatch admission beside decode --------------------------

ADMIT_CHATS = [
    "Write a haiku about the sea, then explain which image in it matters most to you.",
    "Explain paged attention in two sentences for an engineer new to serving.",
    "List three prime numbers larger than one hundred and say how you checked them.",
    "What is the capital of France? Answer in one word, then say why it matters.",
    "Describe a lighthouse keeper's evening routine in four short sentences please.",
    "Give two reasons a serving engine batches requests, each in one sentence.",
    "Name a river in Europe and a river in Asia, and compare their lengths briefly.",
]
ADMIT_LIVE_TOKENS = 256     # each live chat's tokens
ADMIT_LONG = 1536           # the admitted prompt's tokens (prefill bucket 2048)
ADMIT_LONG_TOKENS = 32
ADMIT_CHUNK = 256           # chunked_prefill of the chunked arms
ADMIT_HEAD = 1024           # 12c: the stored head the admitted prompt hits
# arrivals closer than this (s) came from one retire: one emission
ADMIT_EMISSION_S = 1e-3
# 12a's arms on one engine: (label, prefill_segments_per_decode, chunked_prefill)
ADMIT_ARMS = [("gate_off", 0, None), ("gate2", 2, None), ("gate2_chunked", 2, ADMIT_CHUNK)]
ADMIT_LOGIT_TOL = 0.05      # the small-model tolerance of phase 4
# the capture arm: a seeded sampled chat committed while the admitted prompt
# still prefills (128-token segments, one per decode chunk)
ADMIT_SEEDED = {"temperature": 0.8, "top_k": 40, "seed": 1234}


def admission_traffic(tokenizer):
    """12a's prompts: seven ~100-token chats through the chat template, and
    the admitted prompt of ``ADMIT_LONG`` tokens (BOS and the notes'
    bytes)."""
    live = [tokenizer.encode_chat(tokenizer.apply_chat_template(
        [{"role": "user", "content": text}])) for text in ADMIT_CHATS]
    text = "Summarise these notes in one paragraph. " + _NOTES * 12
    long_ids = [tokenizer.bos_token_id] + list(text.encode())[:ADMIT_LONG - 1]
    return live, long_ids


def timed_prefills(model) -> list:
    """Wrap the model's prefill entry points (once) to record each call's
    host ms: the enqueue of its launches, since no call waits for the card.
    Returns the list the calls append to."""
    if not hasattr(model, "_prefill_call_ms"):
        model._prefill_call_ms = []
        for name in ("prefill", "prefill_chunk"):
            def timed(*args, _fn=getattr(model, name), **kwargs):
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kwargs)
                finally:
                    model._prefill_call_ms.append((time.perf_counter() - t0) * 1e3)

            setattr(model, name, timed)
    return model._prefill_call_ms


def admission_recorder(engine, budget: int):
    """Stand a recording gate in the engine's ``_prefill_gate``: every
    prefill dispatch's acquisition ("P") and every deposit ("D", a decode
    chunk retired) is appended under the gate's lock, so the record's
    order is the order in which permits were taken and refreshed. With
    ``budget`` 0 it never paces (the gate-off arm). ``calls`` are the host
    ms of the model's prefill calls (``timed_prefills``). Returns it."""
    from clearml_serving_tpu_torch.llm.engine import _PrefillGate

    class Recorder(_PrefillGate):
        def __init__(self):
            super().__init__(max(1, budget))
            self.events = []
            self.calls = timed_prefills(engine.model)

        def deposit(self):
            with self._cond:
                super().deposit()
                self.events.append("D")

        def take(self, bypass=False):
            with self._cond:
                taken = super().take(bypass) if budget else True
                if taken:
                    self.events.append("P")
                return taken

    engine._prefill_gate = Recorder()
    return engine._prefill_gate


def emissions(times: list) -> list:
    """A row's emission times: the first arrival of each run of arrivals
    closer than ``ADMIT_EMISSION_S`` (the tokens of one retired chunk)."""
    out, last = [], None
    for t in times:
        if last is None or t - last > ADMIT_EMISSION_S:
            out.append(t)
        last = t
    return out


def max_run(events: str) -> int:
    """The most prefill dispatches ("P") between two decode chunks ("D")."""
    return max((len(run) for run in events.split("D")), default=0)


async def admission_run(engine, request_cls, live, long_ids, recorder=None, seeded=None,
                        capture_log=None) -> dict:
    """12a's traffic on ``engine`` (an entry point a user calls,
    ``generate``): the live chats decode ``ADMIT_LIVE_TOKENS`` each; once
    every one has emitted a decode chunk, the long prompt is submitted
    (greedy, ``ADMIT_LONG_TOKENS``), with ``seeded``'s prompt beside it
    when given. Reads the live rows' emission gaps inside the admission
    window (submission to the admitted prompt's first token), its TTFT,
    the live rows' tok/s in the window and over the run, the pipeline's
    dispatch and retire ms in the window, and the gate's record there."""
    n = len(live)
    rows = n + 1 + (seeded is not None)
    arrivals = [[] for _ in range(rows)]
    tokens = [[] for _ in range(rows)]

    async def consume(i, ids, max_new, **kw):
        async for t in engine.generate(request_cls(prompt_ids=list(ids),
                                                   max_new_tokens=max_new, **kw)):
            arrivals[i].append(time.perf_counter())
            tokens[i].append(int(t))

    tasks = [asyncio.ensure_future(consume(i, ids, ADMIT_LIVE_TOKENS))
             for i, ids in enumerate(live)]
    steps = engine.decode_steps
    await until(lambda: all(len(a) > steps for a in arrivals[:n]), 300, "the live rows decoding")
    pipe0 = engine.lifecycle_stats()["pipeline"]
    if recorder is not None:
        with recorder._cond:
            recorder.events.clear()
            recorder.calls.clear()
    if capture_log is not None:
        capture_log.clear()
    t_submit = time.perf_counter()
    if seeded is not None:
        tasks.append(asyncio.ensure_future(consume(n + 1, seeded, ADMIT_LONG_TOKENS,
                                                   **ADMIT_SEEDED)))
    tasks.append(asyncio.ensure_future(consume(n, long_ids, ADMIT_LONG_TOKENS)))
    await until(lambda: arrivals[n], 300, "the admitted prompt's first token")
    t_first = arrivals[n][0]
    pipe1 = engine.lifecycle_stats()["pipeline"]
    events, calls = None, None
    if recorder is not None:
        with recorder._cond:
            events = "".join(recorder.events)
            calls = list(recorder.calls)
    await asyncio.gather(*tasks)
    await engine.wait_drained()
    gaps, steady = [], []
    for times in arrivals[:n]:
        ems = emissions(times)
        for a, b in zip(ems, ems[1:]):
            (gaps if b > t_submit and a < t_first else steady).append((b - a) * 1e3)
    window = t_first - t_submit
    in_window = sum(1 for times in arrivals[:n] for t in times if t_submit <= t <= t_first)
    live_times = [t for times in arrivals[:n] for t in times]

    def mean_ms(key):
        d = pipe1[key]["count"] - pipe0[key]["count"]
        return (pipe1[key]["sum_ms"] - pipe0[key]["sum_ms"]) / d if d else None

    gaps.sort()
    return dict(
        worst_gap_ms=max(gaps) if gaps else None,
        median_gap_ms=gaps[len(gaps) // 2] if gaps else None,
        steady_gap_ms=sorted(steady)[len(steady) // 2] if steady else None,
        gaps_in_window=len(gaps), ttft_ms=window * 1e3,
        live_tok_s_window=in_window / window,
        live_tok_s=len(live_times) / (max(live_times) - min(live_times)),
        dispatch_ms=mean_ms("dispatch_ms"), retire_ms=mean_ms("retire_ms"),
        dispatch_ms_run=pipe1["dispatch_ms"]["sum_ms"] / max(1, pipe1["dispatch_ms"]["count"]),
        retire_ms_run=pipe1["retire_ms"]["sum_ms"] / max(1, pipe1["retire_ms"]["count"]),
        events=events, prefill_dispatches=events.count("P") if events is not None else None,
        # host ms of each prefill call in the window (the enqueue of its
        # launches beside the loop's threads)
        prefill_call_ms=calls,
        max_segments_between_chunks=max_run(events) if events else None,
        tokens=tokens, captures_during=list(capture_log or ()))


def log_admission(label: str, run: dict, card: str) -> None:
    log("  {} ({}): admitted TTFT {:.2f} ms; live rows' emission gaps in the window: worst "
        "{} ms, median {} ms ({} gaps; steady median {} ms; each emission up to 4 tokens); "
        "live tok/s {:.1f} in the window, {:.1f} over the run; dispatch {} ms, retire {} ms in "
        "the window ({:.2f}, {:.2f} over the run); prefill dispatches {} in the window, at most "
        "{} between decode chunks ({})".format(
            label, card, run["ttft_ms"], _r(run["worst_gap_ms"]), _r(run["median_gap_ms"]),
            run["gaps_in_window"], _r(run["steady_gap_ms"]), run["live_tok_s_window"],
            run["live_tok_s"], _r(run["dispatch_ms"]), _r(run["retire_ms"]),
            run["dispatch_ms_run"], run["retire_ms_run"], run["prefill_dispatches"],
            run["max_segments_between_chunks"], (run["events"] or "not recorded")[:80]))
    if run.get("prefill_call_ms"):
        log("    host ms of its prefill calls in the window: {}".format(
            [round(ms, 1) for ms in run["prefill_call_ms"]]))


def _r(x):
    return None if x is None else round(x, 2)


def check_admission_tokens(label: str, run: dict, n_live: int) -> None:
    lens = [len(t) for t in run["tokens"]]
    want = [ADMIT_LIVE_TOKENS] * n_live + [ADMIT_LONG_TOKENS] * (len(lens) - n_live)
    if lens != want:
        raise AssertionError("{}: token counts {}, want {}".format(label, lens, want))


ADMIT_SLEEP_CYCLES = 1_000_000_000   # ~0.5 s of the card's clock, ahead of a timed prefill


def prefill_costs(engine, ids: list, c: int) -> dict:
    """The admitted prompt's prefill on the idle card, one dispatch and in
    C-token segments (the engine's own ``_prefill_segments``): the host ms
    to enqueue its launches and the device ms to run them. A ~0.5 s device
    sleep goes first, so the launches queue up before the card reaches
    them: the device ms then holds no host gap, and a host ms near the
    sleep says the host waited for the card (its launch queue full)."""
    from clearml_serving_tpu_torch.llm import shapes

    n = len(ids)
    bucket = shapes.bucket_for(n, engine._buckets, engine.max_seq_len)
    tokens = torch.zeros((1, bucket), dtype=torch.long)
    tokens[0, :n] = torch.as_tensor(ids)
    tokens = tokens.to(DEV)
    seq_lens = torch.tensor([n], dtype=torch.int32, device=DEV)
    calls = {"one_dispatch": lambda: engine.model.prefill(tokens, seq_lens),
             "chunked": lambda: engine._run_gated(engine._prefill_segments(
                 engine.model.init_cache(1, -(-bucket // c) * c), ids, 0, c))}
    out = {}
    for label, call in calls.items():
        with torch.no_grad():
            call()                                   # allocator warm
            sync()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(ADMIT_SLEEP_CYCLES)
            start.record()
            t0 = time.perf_counter()
            call()
            host_ms = (time.perf_counter() - t0) * 1e3
            end.record()
            sync()
        out[label] = dict(host_ms=host_ms, device_ms=start.elapsed_time(end))
    return out


def chunked_first_logits(engine, ids: list, c: int) -> dict:
    """The admitted prompt's first-token logits through the engine's
    chunked path (``_prefill_segments`` over ``init_cache`` of the bucket
    rounded up to C) against its one-dispatch prefill, on the card."""
    from clearml_serving_tpu_torch.llm import shapes

    n = len(ids)
    bucket = shapes.bucket_for(n, engine._buckets, engine.max_seq_len)
    tokens = torch.zeros((1, bucket), dtype=torch.long)
    tokens[0, :n] = torch.as_tensor(ids)
    with torch.no_grad():
        plain, _ = engine.model.prefill(tokens.to(DEV),
                                        torch.tensor([n], dtype=torch.int32, device=DEV))
        chunked, _ = engine._run_gated(engine._prefill_segments(
            engine.model.init_cache(1, -(-bucket // c) * c), ids, 0, c))
    plain, chunked = plain.float()[0], chunked.float()[0]
    err = float((chunked - plain).abs().max())
    return dict(max_abs_err=err, rel_err=err / float(plain.abs().max()),
                top1_equal=bool(int(chunked.argmax()) == int(plain.argmax())))


def arm_admission(engine, budget: int, chunk):
    """Set one engine's admission knobs for an arm, as the constructor's
    ``prefill_segments_per_decode`` (a recording gate, pacing at
    ``budget``) and ``chunked_prefill_size``. Returns the recorder."""
    engine._chunked = int(chunk or 0)
    return admission_recorder(engine, budget)


async def admission_12a(engine, tokenizer, card: str) -> dict:
    from clearml_serving_tpu_torch.llm.engine import GenRequest
    from clearml_serving_tpu_torch.ops.paged_attention import paged_attention

    live, long_ids = admission_traffic(tokenizer)
    await engine.warmup()
    # first use of the chunked segments' shapes, before any measured arm;
    # then the admitted prompt alone, with no decode beside it, each way
    engine._chunked = ADMIT_CHUNK
    async for _ in engine.generate(GenRequest(prompt_ids=long_ids, max_new_tokens=2)):
        pass
    await engine.wait_drained()
    alone = {}
    for label, chunk in (("one_dispatch", None), ("chunked", ADMIT_CHUNK)):
        recorder = arm_admission(engine, 2, chunk)
        recorder.calls.clear()
        async for _ in engine.generate(GenRequest(prompt_ids=long_ids, max_new_tokens=1)):
            pass
        await engine.wait_drained()
        alone[label] = dict(ttft_ms=engine.ttft_ms[-1], prefill_call_ms=list(recorder.calls))
    log("  12a: the admitted prompt alone: one dispatch TTFT {:.2f} ms (its prefill call's host "
        "ms {}), chunked {} TTFT {:.2f} ms (segments' host ms {}) ({})".format(
            alone["one_dispatch"]["ttft_ms"],
            [round(ms, 1) for ms in alone["one_dispatch"]["prefill_call_ms"]], ADMIT_CHUNK,
            alone["chunked"]["ttft_ms"],
            [round(ms, 1) for ms in alone["chunked"]["prefill_call_ms"]], card))
    costs = None
    if torch.device(DEV).type == "cuda":
        costs = prefill_costs(engine, long_ids, ADMIT_CHUNK)
        log("  12a: the admitted prompt's prefill on the idle card, its launches queued "
            "behind a device sleep: one dispatch host {:.2f} ms, device {:.2f} ms; {} "
            "segments of {} host {:.2f} ms, device {:.2f} ms ({})".format(
                costs["one_dispatch"]["host_ms"], costs["one_dispatch"]["device_ms"],
                -(-len(long_ids) // ADMIT_CHUNK), ADMIT_CHUNK, costs["chunked"]["host_ms"],
                costs["chunked"]["device_ms"], card))
    n_layers = engine.model.n_layers
    runs = {}
    for label, budget, chunk in ADMIT_ARMS:
        recorder = arm_admission(engine, budget, chunk)
        _zero_counts(engine)
        run = await admission_run(engine, GenRequest, live, long_ids, recorder)
        launches = paged_attention.launches
        check_admission_tokens(label, run, len(live))
        steps = engine.counters["decode_steps"]
        # (the wrappers count CUDA launches only)
        if steps == 0 or launches != n_layers * steps * (torch.device(DEV).type == "cuda"):
            raise AssertionError("12a {}: paged_attention launched {} times for {} decode steps "
                                 "of {} layers".format(label, launches, steps, n_layers))
        if budget and run["max_segments_between_chunks"] > budget:
            raise AssertionError("12a {}: {} prefill dispatches between two decode chunks, "
                                 "budget {}: {}".format(label, run["max_segments_between_chunks"],
                                                        budget, run["events"]))
        want = -(-len(long_ids) // chunk) if chunk else 1
        if run["prefill_dispatches"] != want:
            raise AssertionError("12a {}: {} prefill dispatches in the window, want {}".format(
                label, run["prefill_dispatches"], want))
        run["launches"] = launches
        run["serve_captures"] = engine.counters["serve_captures"]
        log_admission("12a " + label, run, card)
        runs[label] = run
    base = runs[ADMIT_ARMS[0][0]]["tokens"]
    for label, run in runs.items():
        if run["tokens"][:len(live)] != base[:len(live)]:
            raise AssertionError("12a {}: a live row's greedy stream differs from {}'s: {}".format(
                label, ADMIT_ARMS[0][0], [first_token_difference(a, b) for a, b in
                                          zip(base[:len(live)], run["tokens"][:len(live)])]))
    if runs["gate2"]["tokens"][-1] != base[-1]:
        raise AssertionError("12a: the admitted stream differs between gate_off and gate2")
    logits = chunked_first_logits(engine, long_ids, ADMIT_CHUNK)
    chunk_diff = first_token_difference(base[-1], runs["gate2_chunked"]["tokens"][-1])
    log("  12a: live rows' greedy streams equal in every arm; the admitted stream's first "
        "difference chunked vs unchunked: {}; its first-token logits chunked vs one dispatch: "
        "max_abs_err {:.4e}, rel {:.4f} (tolerance {}), top-1 equal {} ({})".format(
            chunk_diff, logits["max_abs_err"], logits["rel_err"], ADMIT_LOGIT_TOL,
            logits["top1_equal"], card))
    if not logits["rel_err"] <= ADMIT_LOGIT_TOL:
        raise AssertionError("12a: chunked first-token logits off by {:.4f} of scale".format(
            logits["rel_err"]))
    # a serve-time capture (the seeded variant's first use) while the
    # admitted prompt prefills in its worker: 128-token segments, one per
    # decode chunk, so its train spans the seeded chat's commit
    seeded, capture_log = live[-1], []
    capture = engine._capture

    def logged_capture(variant):
        capture_log.append((variant.label(), bool(engine._admitting)))
        capture(variant)

    engine._capture = logged_capture
    recorder = arm_admission(engine, 1, 128)
    _zero_counts(engine)
    cap = await admission_run(engine, GenRequest, live[:-1], long_ids, recorder,
                              seeded=seeded, capture_log=capture_log)
    engine._capture = capture
    check_admission_tokens("12a capture", cap, len(live) - 1)
    during = [label for label, admitting in cap["captures_during"] if admitting]
    if engine._graphs is not None and not during:
        raise AssertionError("12a capture: no capture while an admission prefilled: {}".format(
            cap["captures_during"]))
    if cap["tokens"][:len(live) - 1] != base[:len(live) - 1]:
        raise AssertionError("12a capture: a live row's stream differs beside the capture")
    alone = []
    arm_admission(engine, 2, None)
    async for t in engine.generate(GenRequest(prompt_ids=list(seeded),
                                              max_new_tokens=ADMIT_LONG_TOKENS,
                                              **ADMIT_SEEDED)):
        alone.append(int(t))
    await engine.wait_drained()
    if cap["tokens"][-1] != alone:
        raise AssertionError("12a capture: the seeded stream differs from its run alone at {}"
                             .format(first_token_difference(cap["tokens"][-1], alone)))
    log_admission("12a capture (chunked 128, budget 1, a seeded chat beside)", cap, card)
    log("  12a capture: {} captured while an admission prefilled; the live rows' and the "
        "seeded chat's streams as without it ({})".format(during, card))
    for run in list(runs.values()) + [cap]:
        run.pop("tokens")
    return dict(runs=runs, alone=alone, costs=costs, capture=dict(cap, captured=during),
                logits=logits,
                chunked_first_difference=chunk_diff)


async def admission_12b(engine, tokenizer, card: str) -> dict:
    """12a's traffic on int4 weights with chunked prefill: every int4 launch
    of the run is a one-dispatch prefill's 225, a chunked prefill's 224 per
    segment and one lm_head, or a replay's 225 per step."""
    from clearml_serving_tpu_torch.llm.engine import GenRequest
    from clearml_serving_tpu_torch.ops.fused_matmul import fused_int4_matmul
    from clearml_serving_tpu_torch.ops.paged_attention import paged_attention

    live, long_ids = admission_traffic(tokenizer)
    await engine.warmup()
    recorder = arm_admission(engine, 2, ADMIT_CHUNK)
    _zero_counts(engine)
    fused_int4_matmul.launches = 0
    run = await admission_run(engine, GenRequest, live, long_ids, recorder)
    check_admission_tokens("12b", run, len(live))
    c = dict(engine.counters)
    segments = -(-len(long_ids) // ADMIT_CHUNK)
    per_step = int4_launches_per_forward(engine.model)
    # (no int4 launch off the card)
    want = per_step * (len(live) + c["decode_steps"]) + (
        (per_step - 1) * segments + 1 if per_step else 0)
    got = fused_int4_matmul.launches
    log("  12b int4 weights, chunked {}: fused_int4_matmul launches {} = {} x {} one-dispatch "
        "prefills + ({} - 1) x {} segments + 1 lm_head + {} x {} decode steps in {} replays: "
        "{}; paged_attention {} ({})".format(
            ADMIT_CHUNK, got, per_step, len(live), per_step, segments, per_step,
            c["decode_steps"], c["graph_replays"], "held" if got == want else "want {}".format(
                want), paged_attention.launches, card))
    if got != want or c["prefills"] != len(live) + 1:
        raise AssertionError("12b: fused_int4_matmul launched {} times, want {} ({} prefills)"
                             .format(got, want, c["prefills"]))
    if run["max_segments_between_chunks"] > 2:
        raise AssertionError("12b: {} segments between two decode chunks: {}".format(
            run["max_segments_between_chunks"], run["events"]))
    log_admission("12b int4 gate2_chunked", run, card)
    run.pop("tokens")
    return dict(run, int4_launches=got, segments=segments, replays=c["graph_replays"])


async def admission_12c(engine, tokenizer, card: str) -> dict:
    """12a's traffic under the strict ledger and the KV sanitizer with the
    prefix cache: the admitted prompt hits a stored ``ADMIT_HEAD``-token
    head and prefills its tail in ``prefix_block`` segments, paced by the
    gate; the drain audits must be clean."""
    from clearml_serving_tpu_torch.llm import lifecycle_ledger
    from clearml_serving_tpu_torch.llm.engine import GenRequest

    live, long_ids = admission_traffic(tokenizer)
    engine._ledger.reset(strict=True)
    await engine.warmup()
    head = long_ids[:ADMIT_HEAD]
    async for _ in engine.generate(GenRequest(prompt_ids=head + [7] * 64, max_new_tokens=2)):
        pass
    await engine.wait_drained()
    hits0 = engine._prefix.stats()["hits"]
    recorder = arm_admission(engine, 2, None)
    _zero_counts(engine)
    run = await admission_run(engine, GenRequest, live, long_ids, recorder)
    check_admission_tokens("12c", run, len(live))
    block = engine._prefix.block
    segments = -(-(len(long_ids) - ADMIT_HEAD) // block)
    engine._ledger.check("drain", drained=True, domains=engine._ledger_domains())
    stats = engine._ledger.stats()
    outstanding = {r: n for r, n in stats["outstanding"].items()
                   if lifecycle_ledger.RESOURCES[r]["drain_zero"] and n}
    hits = engine._prefix.stats()["hits"] - hits0
    log("  12c strict ledger, prefix hit of {} tokens, tail {} tokens in {} segments of {}: "
        "prefill dispatches {} in the window, at most {} between decode chunks; ledger leaks "
        "{}, double releases {}, drain-zero outstanding {}, sanitizer failures {} ({})".format(
            ADMIT_HEAD, len(long_ids) - ADMIT_HEAD, segments, block, run["prefill_dispatches"],
            run["max_segments_between_chunks"], stats["leaks"], stats["double_releases"],
            outstanding, engine._sanitizer.failures, card))
    if hits < 1 or run["prefill_dispatches"] != segments or segments < 2:
        raise AssertionError("12c: {} hits, {} prefill dispatches for {} tail segments".format(
            hits, run["prefill_dispatches"], segments))
    if stats["leaks"] or stats["double_releases"] or outstanding or engine._sanitizer.failures:
        raise AssertionError("12c: the drain audit is not clean: {}".format(stats))
    if run["max_segments_between_chunks"] > 2:
        raise AssertionError("12c: {} segments between two decode chunks: {}".format(
            run["max_segments_between_chunks"], run["events"]))
    log_admission("12c hit tail", run, card)
    run.pop("tokens")
    return dict(run, hits=hits, segments=segments, leaks=stats["leaks"])


def phase_admission(params, qparams, card: str, preset: str = "llama3-8b") -> dict:
    """Phase 12: the two-dispatch admission beside decode (depth 2 with
    graphs, max_batch 8): 12a's arms on one bf16 engine, the capture arm,
    12b on int4 weights, 12c under the strict ledger with a prefix hit;
    the peak of ``max_memory_allocated`` over the phase."""
    from clearml_serving_tpu_torch.llm import lifecycle_ledger

    t0 = time.perf_counter()
    on_card = torch.device(DEV).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        base_mib = torch.cuda.memory_allocated() / 2 ** 20
    engine, tokenizer = _engine(params, "", preset, pipeline_depth=2)
    a = asyncio.run(admission_12a(engine, tokenizer, card))
    # the peak over 12a's arms: the pools, the graphs, and the prefills'
    # mini caches and activations beside live decode
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20 if on_card else None
    del engine
    release_card_memory()
    split = {"12a": time.perf_counter() - t0}
    engine, tokenizer = _engine(qparams, "", preset, pipeline_depth=2, weight_quant="int4",
                                chunked_prefill=ADMIT_CHUNK)
    b = asyncio.run(admission_12b(engine, tokenizer, card))
    del engine
    release_card_memory()
    split["12b"] = time.perf_counter() - t0 - sum(split.values())
    os.environ["TPUSERVE_LEDGER"] = "strict"
    os.environ["TPUSERVE_SANITIZE"] = "1"
    try:
        engine, tokenizer = _engine(params, "", preset, pipeline_depth=2,
                                    **PREFIX_KNOBS)
        c = asyncio.run(admission_12c(engine, tokenizer, card))
        del engine
        release_card_memory()
    finally:
        os.environ.pop("TPUSERVE_LEDGER", None)
        os.environ.pop("TPUSERVE_SANITIZE", None)
        lifecycle_ledger.get().reset(strict=False)
        lifecycle_ledger.disarm()
    split["12c"] = time.perf_counter() - t0 - sum(split.values())
    wall = time.perf_counter() - t0
    log("  phase 12: {:.1f} s ({}); max_memory_allocated over 12a {} MiB, {} MiB above its "
        "start ({})".format(wall, ", ".join("{} {:.1f} s".format(k, v) for k, v in split.items()),
                            _r(peak_mib), _r(peak_mib - base_mib) if on_card else None, card))
    return dict(a, int4=b, ledger=c, peak_mib=peak_mib,
                peak_rise_mib=peak_mib - base_mib if on_card else None, wall_s=wall)


# -- phase 13: the control plane in front of the LLM route --------------------

# the endpoints' aux engine blocks, written by the CLI as key=value pairs
# phases 13 and 14 run Llama-3-8B's widths at 8 of its 32 layers (the
# script's time limit, since phase 15 joined it); phase 15 runs all 32
CP_LAYERS = 8
CP_ENGINE = {"preset": "llama3-8b", "config": {"n_layers": CP_LAYERS}, "cache": "paged",
             "kv_quant": "int8", "warmup": "startup", "max_batch": 8, "max_seq_len": 2048,
             "seed": 0}
CP_SMALL = {"preset": "llama3-1b", "cache": "paged", "max_batch": 4, "max_seq_len": 1024,
            "seed": 0}
CP_TOPICS = ["the sea", "paged attention", "a lighthouse", "prime numbers", "the city of Paris",
             "a mountain railway", "compilers", "green tea"]
CP_PROMPTS = ["Write four calm sentences about {} for a reader who has never heard of it, "
              "then end with one question.".format(t) for t in CP_TOPICS]
CP_TOKENS = 64
# 13b's streams must outlive chat2's pickup (0.3-1.1 s): 768 tokens at
# CP_LAYERS' ~3.2 ms a step
CP_STREAM_TOKENS = 768
CP_SEEDED = {"temperature": 0.8, "seed": 7}
CP_MEMORY_SLACK = 64 << 20
OPENAI_CHAT = "/serve/openai/v1/chat/completions"
CP_PROBE_CODE = '''import torch


class Preprocess:
    """One torch op on the card per request, over a table made at load."""

    def __init__(self):
        self.table = torch.arange(1024, device="cuda", dtype=torch.float32)

    def process(self, data, state, collect_fn):
        x = torch.tensor(data["x"], device="cuda", dtype=torch.float32)
        return {"y": (x * 2 + self.table[: x.numel()]).tolist()}
'''


def cp_body(model, prompt, max_tokens, stream, **fields) -> dict:
    return {"model": model, "messages": [{"role": "user", "content": prompt}],
            "max_tokens": max_tokens, "stream": stream, **fields}


async def cp_chat(session, base, path, body) -> dict:
    """One chat: its content and finish reason, streamed or not; a status
    other than 200 or an SSE error event fails the run."""
    t0 = time.perf_counter()
    async with session.post(base + path, json=body) as r:
        if r.status != 200:
            raise AssertionError("{} HTTP {}: {}".format(path, r.status, await r.text()))
        if not body.get("stream"):
            out = await r.json()
            choice = out["choices"][0]
            return dict(content=choice["message"]["content"], finish=choice["finish_reason"],
                        total_s=time.perf_counter() - t0)
        pieces, finish, done = [], None, False
        async for raw in r.content:
            line = raw.decode().strip()
            done = done or line == "data: [DONE]"
            if not line.startswith("data: {"):
                continue
            chunk = json.loads(line[len("data: "):])
            if "error" in chunk:
                raise AssertionError("stream error on {}: {}".format(path, chunk["error"]))
            choice = chunk["choices"][0]
            pieces.append(choice["delta"].get("content") or "")
            finish = choice["finish_reason"] or finish
        if not done:
            raise AssertionError("a stream on {} ended without [DONE]".format(path))
        return dict(content="".join(pieces), finish=finish, total_s=time.perf_counter() - t0)


def cp_ids(tokenizer, prompt):
    return tuple(tokenizer.encode_chat(tokenizer.apply_chat_template(
        [{"role": "user", "content": prompt}])))


async def cp_traffic(s, base, engine, model) -> dict:
    """13a's traffic on one app: a first chat (it awaits the endpoint's
    warmup), the counts zeroed, 8 concurrent chats (every other one
    streaming) and one through ``/serve/<model>``; the counts after."""
    from clearml_serving_tpu_torch.ops.fused_matmul import fused_int4_matmul

    t0 = time.perf_counter()
    await cp_chat(s, base, OPENAI_CHAT, cp_body(model, "Warm up.", 4, False))
    warm_s = time.perf_counter() - t0
    await engine.wait_drained()
    _zero_counts(engine)
    fused_int4_matmul.launches = 0
    engine.ttft_ms.clear()
    t0 = time.perf_counter()
    results = await asyncio.gather(*[
        cp_chat(s, base, OPENAI_CHAT, cp_body(model, p, CP_TOKENS, i % 2 == 1))
        for i, p in enumerate(CP_PROMPTS)])
    results.append(await cp_chat(s, base, "/serve/" + model, {
        "messages": [{"role": "user", "content": CP_PROMPTS[0]}], "max_tokens": CP_TOKENS}))
    wall = time.perf_counter() - t0
    await engine.wait_drained()
    c = engine.counters
    steps = c["decode_steps"]
    return dict(contents=[r["content"] for r in results],
                finish=[r["finish"] for r in results], warm_s=warm_s, wall_s=wall,
                launches=_launch_counts(), int4_launches=fused_int4_matmul.launches,
                decode_steps=steps, step_ms=c["decode_ms"] / max(1, steps),
                ttft_ms=sorted(engine.ttft_ms), serve_captures=c["serve_captures"],
                n_layers=engine.model.n_layers,
                graph_replays=c["graph_replays"])


async def cp_streams(s, base, model, n=4) -> list:
    return [asyncio.ensure_future(cp_chat(s, base, OPENAI_CHAT, cp_body(
        model, p, CP_STREAM_TOKENS, True))) for p in CP_PROMPTS[:n]]


def check_cp_traffic(label, run) -> None:
    launches, n_layers = run["launches"], run["n_layers"]
    if run["decode_steps"] == 0 or launches["paged"] != n_layers * run["decode_steps"]:
        raise AssertionError("{}: paged_attention launched {} times for {} decode steps of {} "
                             "layers".format(label, launches["paged"], run["decode_steps"],
                                             n_layers))
    if launches["ragged"] or launches["tree"] or run["int4_launches"]:
        raise AssertionError("{}: kernels off this path launched: {} int4 {}".format(
            label, launches, run["int4_launches"]))
    if run["serve_captures"] or not run["graph_replays"]:
        raise AssertionError("{}: serve_captures {} graph_replays {} after warmup".format(
            label, run["serve_captures"], run["graph_replays"]))
    if any(f != "length" for f in run["finish"]):
        raise AssertionError("{}: a chat ended before max_tokens: {}".format(label, run["finish"]))


def middle(values):
    """The median of a sorted list."""
    return values[len(values) // 2] if values else float("nan")


def card_memory() -> int:
    """``memory_allocated`` at a quiet point."""
    gc.collect()
    sync()
    return torch.cuda.memory_allocated()


async def add_chat2(s, base, processor, cli, engine) -> dict:
    """The CLI adds ``chat2``, the sync daemon picks it up and it answers:
    the seconds to the pickup, ``engine``'s live slots there, the reply and
    ``memory_allocated`` with ``chat2`` built."""
    t0 = time.perf_counter()
    await asyncio.to_thread(cli, ["--yes", "model", "add", "--engine", "llm", "--endpoint",
                                  "chat2", "--aux-config"]
                            + ["engine.{}={}".format(k, json.dumps(v))
                               for k, v in CP_SMALL.items()])
    await until(lambda: "chat2" in processor._endpoints, 30, "the sync daemon to pick chat2 up")
    picked_s = time.perf_counter() - t0
    live = engine.active_slots
    reply = await cp_chat(s, base, OPENAI_CHAT, cp_body("chat2", CP_PROMPTS[1], 16, False))
    return dict(picked_up_s=picked_s, live_at_pickup=live, chat2=reply["content"],
                memory_during=torch.cuda.memory_allocated())


async def remove_chat2(processor, cli) -> float:
    """The CLI removes ``chat2``; the eviction stops its engine and
    releases it (``_release``, under ``CAPTURE_LOCK``). The engine must be
    gone where the release returns, with the endpoint's request still held
    here and nothing collected by this script. Returns the seconds from
    the CLI to the release."""
    proc = processor._engine_processor_lookup["chat2"]
    ref = weakref.ref(proc.engine)
    release, released = proc._release, []

    def recording_release():
        release()
        released.append(ref() is None)

    proc._release = recording_release
    t0 = time.perf_counter()
    await asyncio.to_thread(cli, ["--yes", "model", "remove", "--endpoint", "chat2"])
    await until(lambda: bool(released), 60, "chat2's engine to be released")
    freed_s = time.perf_counter() - t0
    del proc._release
    if "chat2" in processor._engine_processor_lookup or released != [True]:
        raise AssertionError("chat2's engine outlived its release")
    return freed_s


class WatchedLock:
    """A lock's stand-in that records how long each blocking acquire
    waited (the eviction's wait for a capture that holds ``CAPTURE_LOCK``),
    and signals ``waiting`` when one starts to wait."""

    def __init__(self, lock):
        self.lock, self.waits, self.waiting = lock, [], threading.Event()

    def __enter__(self):
        if not self.lock.acquire(blocking=False):
            self.waiting.set()
            t0 = time.perf_counter()
            self.lock.acquire()
            self.waits.append(time.perf_counter() - t0)
        return self

    def __exit__(self, *exc):
        self.lock.release()


async def direct_control_arm() -> dict:
    """The direct app: an engine built from 13's aux block by ``build_engine``
    (the same seed-0 weights the endpoint makes), wrapped into a processor:
    13a's traffic, 13b's four streams and the seeded chat; token ids by
    prompt."""
    import aiohttp
    from aiohttp import web

    from clearml_serving_tpu_torch.llm.openai_api import build_engine

    engine, tokenizer = build_engine(CP_ENGINE, device=DEV)
    streams = record_streams(engine)
    app = processor_app(engine, tokenizer, "chat", warmup=CP_ENGINE["warmup"])
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    base = "http://127.0.0.1:{}".format(runner.addresses[0][1])
    try:
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as s:
            run = await cp_traffic(s, base, engine, "chat")
            check_cp_traffic("13a direct", run)
            run["streams_13a"] = {k: list(v) for k, v in streams.items()}
            long_streams = await asyncio.gather(*(await cp_streams(s, base, "chat")))
            seeded = await cp_chat(s, base, OPENAI_CHAT, cp_body(
                "chat", CP_PROMPTS[5], CP_TOKENS, True, **CP_SEEDED))
            await engine.wait_drained()
    finally:
        await runner.cleanup()
    run.update(streams={k: list(v) for k, v in streams.items()},
               long_contents=[r["content"] for r in long_streams], seeded=seeded["content"])
    return run


async def control_plane_runs(processor, cli) -> dict:
    """13a-13b on the processor ``setup_processor()`` launched: the app on
    a local port, the CLI changing the service under load."""
    import aiohttp
    from aiohttp import web

    from clearml_serving_tpu_torch.serving import model_request_processor as mrp_module
    from clearml_serving_tpu_torch.serving.main import build_app

    proc = processor._engine_processor_lookup["chat"]
    engine, tokenizer = proc.engine, proc.tokenizer
    del proc
    streams = record_streams(engine)
    app = build_app(processor)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    base = "http://127.0.0.1:{}".format(runner.addresses[0][1])
    out = {}
    try:
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as s:
            # 13a
            run = await cp_traffic(s, base, engine, "chat")
            check_cp_traffic("13a processor", run)
            run["streams_13a"] = {k: list(v) for k, v in streams.items()}
            async with s.post(base + "/serve/probe", json={"x": [1, 2, 3]}) as r:
                probe = (r.status, await r.json())
            if probe != (200, {"y": [2.0, 5.0, 8.0]}):
                raise AssertionError("the custom endpoint answered {}".format(probe))
            out["13a"] = run
            # 13b: chat2 added while four streams decode on chat, then
            # removed; a second cycle with nothing else live
            before = card_memory()
            live = await cp_streams(s, base, "chat")
            await until(lambda: engine.active_slots == 4, 120, "4 streams decoding")
            cycle = await add_chat2(s, base, processor, cli, engine)
            live_after_chat2 = engine.active_slots
            long_streams = await asyncio.gather(*live)
            await engine.wait_drained()
            freed_s = await remove_chat2(processor, cli)
            after = card_memory()
            again = await add_chat2(s, base, processor, cli, engine)
            freed2_s = await remove_chat2(processor, cli)
            after2 = card_memory()
            out["13b"] = dict(cycle, live_after_chat2=live_after_chat2, chat2=cycle["chat2"][:24],
                              memory_before=before, memory_after=after, freed_s=freed_s,
                              picked_up2_s=again["picked_up_s"],
                              memory_during2=again["memory_during"], memory_after2=after2,
                              freed2_s=freed2_s,
                              long_contents=[r["content"] for r in long_streams],
                              long_finish=[r["finish"] for r in long_streams])
            if cycle["live_at_pickup"] != 4:
                raise AssertionError("the streams ended before the update: {} live at the "
                                     "pickup".format(cycle["live_at_pickup"]))
            if abs(after - before) > CP_MEMORY_SLACK or after2 > after:
                raise AssertionError("memory_allocated {} B before chat2, {} B after its "
                                     "removal, {} B after the second removal".format(
                                         before, after, after2))
            # 13b: a serve-time capture (the seeded variant) while the
            # custom endpoint is evicted: the capture holds CAPTURE_LOCK as
            # it enters the graph, the eviction starts there and its
            # release waits on the lock; the capture goes on meanwhile
            watched = WatchedLock(mrp_module.CAPTURE_LOCK)
            mrp_module.CAPTURE_LOCK = watched
            real_graph = torch.cuda.graph
            evicted = {}

            def evict() -> None:
                evicted["start"] = time.perf_counter()
                cli(["--yes", "model", "remove", "--endpoint", "probe"])
                processor.deserialize()
                evicted["end"] = time.perf_counter()

            class graph_beside_eviction:
                """``torch.cuda.graph`` that starts the eviction as the
                capture, holding the lock, enters the graph, and waits
                until the eviction's release waits on the lock."""

                def __init__(self, *args, **kwargs):
                    self.ctx = real_graph(*args, **kwargs)

                def __enter__(self):
                    evicted["thread"] = threading.Thread(target=evict)
                    evicted["thread"].start()
                    evicted["release_pending"] = watched.waiting.wait(30.0)
                    evicted["capture_start"] = time.perf_counter()
                    return self.ctx.__enter__()

                def __exit__(self, *exc):
                    try:
                        return self.ctx.__exit__(*exc)
                    finally:
                        evicted["capture_end"] = time.perf_counter()

            captures0 = engine.counters["serve_captures"]
            failures0 = engine.counters["step_failures"]
            torch.cuda.graph = graph_beside_eviction
            try:
                seeded = await cp_chat(s, base, OPENAI_CHAT, cp_body(
                    "chat", CP_PROMPTS[5], CP_TOKENS, True, **CP_SEEDED))
                await asyncio.to_thread(evicted["thread"].join)
            finally:
                torch.cuda.graph = real_graph
                mrp_module.CAPTURE_LOCK = watched.lock
            await engine.wait_drained()
            out["13b_capture"] = dict(
                seeded=seeded["content"],
                capture_ms=(evicted["capture_end"] - evicted["capture_start"]) * 1e3,
                eviction_ms=(evicted["end"] - evicted["start"]) * 1e3,
                release_pending_in_capture=evicted["release_pending"],
                release_waits_ms=[w * 1e3 for w in watched.waits],
                serve_captures=engine.counters["serve_captures"] - captures0,
                step_failures=engine.counters["step_failures"] - failures0)
            if "probe" in processor._engine_processor_lookup:
                raise AssertionError("the custom endpoint was not evicted")
            if (out["13b_capture"]["serve_captures"] != 1 or out["13b_capture"]["step_failures"]
                    or not evicted["release_pending"] or not watched.waits):
                raise AssertionError("the seeded capture beside the eviction: {}".format(
                    out["13b_capture"]))
    finally:
        await runner.cleanup()
    out["streams"] = {k: list(v) for k, v in streams.items()}
    return out


def broker_packets(broker_dir: str, url: str, want: int, timeout: float = 20.0) -> list:
    """The stats packets of endpoint ``url`` in the file broker, once
    ``want`` have arrived (the sender drains its queue every 5 s)."""
    from clearml_serving_tpu_torch.statistics.broker import make_consumer

    consumer, packets = make_consumer("file://" + broker_dir), []
    t0 = time.perf_counter()
    while True:
        packets += [p for p in consumer.poll() if p.get("_url") == url]
        if len(packets) >= want or time.perf_counter() - t0 > timeout:
            return packets
        time.sleep(0.25)


def phase_control_plane(card: str) -> dict:
    """Phase 13 (module docstring): the direct app first, then the CLI, the
    processor's launch and the runs behind its router."""
    from clearml_serving_tpu_torch.__main__ import cli
    from clearml_serving_tpu_torch.serving.main import setup_processor
    from clearml_serving_tpu_torch.state import StateStore

    t0 = time.perf_counter()
    direct = asyncio.run(direct_control_arm())
    direct_s = time.perf_counter() - t0
    release_card_memory()
    root = state_dir()
    broker = os.path.join(root, "broker")
    env = {"TPUSERVE_STATE_ROOT": root, "TPUSERVE_POLL_FREQ": str(1.0 / 60)}
    saved = {k: os.environ.get(k) for k in list(env) + ["TPUSERVE_SERVICE_ID"]}
    os.environ.update(env)
    processor = None
    try:
        probe = os.path.join(root, "probe_preprocess.py")
        with open(probe, "w") as f:
            f.write(CP_PROBE_CODE)
        steps = [["create", "--name", "chip-smoke"],
                 ["--yes", "config", "--metric-log-freq", "1",
                  "--stats-broker", "file://" + broker],
                 ["--yes", "model", "add", "--engine", "llm", "--endpoint", "chat",
                  "--aux-config"] + ["engine.{}={}".format(k, json.dumps(v))
                                     for k, v in CP_ENGINE.items()],
                 ["--yes", "model", "add", "--engine", "custom", "--endpoint", "probe",
                  "--preprocess", probe]]
        for argv in steps:
            if cli(argv) != 0:
                raise AssertionError("the CLI failed: {}".format(argv))
        os.environ["TPUSERVE_SERVICE_ID"] = StateStore(root).find_service("chip-smoke").id
        t0 = time.perf_counter()
        processor = setup_processor(device=DEV)
        sync()  # the endpoint's weights are drawn on the card asynchronously
        launch_s = time.perf_counter() - t0
        if set(processor._engine_processor_lookup) != {"chat", "probe"}:
            raise AssertionError("the launch built {}".format(
                sorted(processor._engine_processor_lookup)))
        t0 = time.perf_counter()
        runs = asyncio.run(control_plane_runs(processor, cli))
        runs_s = time.perf_counter() - t0
        # one stats packet per chat request: the warm-up, 13a's nine, 13b's
        # four streams and the seeded chat
        n_chat = 1 + len(CP_PROMPTS) + 1 + 4 + 1
        packets = broker_packets(broker, "chat", n_chat)
    finally:
        if processor is not None:
            processor.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    # the same token ids as the direct engine, by prompt: 13a's chats (and
    # the warm-up), then 13b's streams across the update and the seeded
    # stream across the eviction, which replace their prompts' entries
    a = runs["13a"]
    for label, got, want in (("13a", a["streams_13a"], direct["streams_13a"]),
                             ("13b", runs["streams"], direct["streams"])):
        # the warmup's own prompts are recorded too
        if set(got) != set(want) or len(got) < len(CP_PROMPTS) + 1:
            raise AssertionError("{}: the recorded prompts differ: {} and {}".format(
                label, len(got), len(want)))
        differ = [k for k in got if got[k] != want[k]]
        if differ:
            raise AssertionError("{}: token ids differ from the direct engine's on {} of {} "
                                 "prompts".format(label, len(differ), len(got)))
    if a["contents"] != direct["contents"]:
        raise AssertionError("13a contents differ from the direct app's")
    if runs["13b"]["long_contents"] != direct["long_contents"]:
        raise AssertionError("13b's streams across the update differ from the direct app's")
    if runs["13b_capture"]["seeded"] != direct["seeded"]:
        raise AssertionError("the seeded stream across the eviction differs from the direct "
                             "app's")
    missing = [p for p in packets if not {"gen_tokens", "prompt_tokens", "ttft"} <= set(p)]
    if len(packets) != n_chat or missing:
        raise AssertionError("{} stats packets for {} chat requests, {} without the engine's "
                             "keys".format(len(packets), n_chat, len(missing)))
    out = dict(launch_s=launch_s, direct_s=direct_s, runs_s=runs_s,
               warm_s={"direct": direct["warm_s"], "processor": a["warm_s"]},
               ttft_ms={"direct": direct["ttft_ms"], "processor": a["ttft_ms"]},
               step_ms={"direct": direct["step_ms"], "processor": a["step_ms"]},
               decode_steps={"direct": direct["decode_steps"], "processor": a["decode_steps"]},
               launches=a["launches"]["paged"], packets=len(packets),
               contents={"direct": [t[:24] for t in direct["contents"]],
                         "processor": [t[:24] for t in a["contents"]]},
               packet_keys=sorted(packets[0]), **{k: runs[k] for k in ("13b", "13b_capture")})
    out["13b"] = dict(out["13b"], long_contents=[t[:24] for t in out["13b"]["long_contents"]])
    log("  13a: contents (processor):", json.dumps([t[:24] for t in a["contents"]]))
    log("  13a: contents (direct):   ", json.dumps([t[:24] for t in direct["contents"]]))
    first = next(iter(sorted(a["streams_13a"])))
    log("  13a: first token ids of one chat, processor {} / direct {}".format(
        a["streams_13a"][first][:8], direct["streams_13a"][first][:8]))
    log("  13a: launch {:.1f} s (both endpoints built); first request (warmup) {:.1f} s "
        "processor / {:.1f} s direct; TTFT median {:.2f} ms processor / {:.2f} ms direct; "
        "{:.3f} ms a decode step processor / {:.3f} direct; paged_attention launches {} = "
        "{} layers x {} decode steps; serve_captures 0; {} broker packets with {} ({})".format(
            launch_s, a["warm_s"], direct["warm_s"], middle(a["ttft_ms"]),
            middle(direct["ttft_ms"]), a["step_ms"], direct["step_ms"], a["launches"]["paged"],
            a["n_layers"], a["decode_steps"], len(packets), sorted(packets[0]), card))
    b = runs["13b"]
    log("  13b: chat2 picked up {:.2f} s after the CLI with {} streams live ({} after chat2 "
        "answered); streams finished {}; memory_allocated before chat2 {} B, during {} B, "
        "after its removal {} B ({:+d} B; released {:.2f} s after the CLI); second cycle: "
        "picked up {:.2f} s, during {} B, after {} B ({:+d} B against the first removal; "
        "released {:.2f} s) ({})".format(
            b["picked_up_s"], b["live_at_pickup"], b["live_after_chat2"], b["long_finish"],
            b["memory_before"], b["memory_during"], b["memory_after"],
            b["memory_after"] - b["memory_before"], b["freed_s"], b["picked_up2_s"],
            b["memory_during2"], b["memory_after2"], b["memory_after2"] - b["memory_after"],
            b["freed2_s"], card))
    cap = runs["13b_capture"]
    log("  13b: the seeded variant captured in {:.1f} ms with the eviction's release pending "
        "on CAPTURE_LOCK (it waited {} ms; the eviction took {:.1f} ms); seeded stream equal to "
        "the direct app's".format(cap["capture_ms"], cap["release_waits_ms"],
                                  cap["eviction_ms"]))
    return out


# -- phase 14: the replica fleet -----------------------------------------------------

# the endpoints' aux engine blocks, written by the CLI as key=value pairs:
# the single engine and the fleets over the same seed-0 weights (each
# endpoint draws them once); the fleets' watchdog at 2 s for 14b
FLEET_BASE = dict(CP_ENGINE, prefix_cache=64, prefix_block=64)
FLEET_WATCHDOG_S = 2
FLEET_STALL_S = 5.0
FLEET_TURN_TOKENS = 32          # 14a: 4 conversations x 3 turns
FLEET_STREAM_TOKENS = 128       # 14b: 4 greedy streams
FLEET_DISAGG_TOKENS = 32        # 14c: 2 chats
FLEET_DISAGG_CHARS = 1024       # 14c's prompts' characters (~1 token each)
FLEET_SECOND_REPLICA_LIMIT = 8 << 30
_FLEET_WORDS = ("tide harbour lantern gull rope anchor mast sail compass reef current "
                "channel buoy keel hull deck stern bow wave shore").split()


def fleet_text(seed: int, chars: int) -> str:
    """Deterministic prose of about ``chars`` characters."""
    words, i = [], seed * 7
    while sum(len(w) + 1 for w in words) < chars:
        words.append(_FLEET_WORDS[(i * 5 + seed) % len(_FLEET_WORDS)])
        i += 1
    return " ".join(words)[:chars]


def fleet_home(tokenizer, messages, block: int) -> str:
    """The replica a 2-replica ring routes ``messages`` to (the router's
    own math: the affinity key over the prompt's head blocks, HRW)."""
    from clearml_serving_tpu_torch.serving.replica_router import affinity_key, hrw_order

    ids = chat_ids(tokenizer, messages)
    return ["r0", "r1"][hrw_order(affinity_key(ids, block), ["r0", "r1"])[0]]


def chat_ids(tokenizer, messages) -> tuple:
    """A chat's prompt ids, as the OpenAI route computes them."""
    return tuple(tokenizer.encode_chat(tokenizer.apply_chat_template(messages)))


def balanced_openers(tokenizer, first: int, n: int, chars: int, block: int,
                     tag: str) -> list:
    """``n`` opening messages (distinct first words) of which half home
    on each replica."""
    picked = {"r0": [], "r1": []}
    seed = first
    while min(len(v) for v in picked.values()) < n // 2:
        text = "{} {}: {}".format(tag, seed, fleet_text(seed, chars))
        home = fleet_home(tokenizer, [{"role": "user", "content": text}], block)
        if len(picked[home]) < n // 2:
            picked[home].append(text)
        seed += 1
    return [t for pair in zip(picked["r0"], picked["r1"]) for t in pair]


def record_fleet(engines, runs=None) -> dict:
    """Wraps each engine's ``generate``: every request's token ids and
    times, by (replica id, prompt ids), into ``runs`` (a new dict if None)."""
    runs = {} if runs is None else runs
    for engine in engines:
        generate = engine.generate

        async def recording(request, engine=engine, generate=generate):
            rec = runs[(engine.replica_id, tuple(request.prompt_ids))] = {
                "tokens": [], "t0": time.perf_counter(), "t_first": None}
            async for token in generate(request):
                if rec["t_first"] is None:
                    rec["t_first"] = time.perf_counter()
                rec["tokens"].append(int(token))
                yield token

        engine.generate = recording
    return runs


async def fleet_chat(s, base, model, messages, max_tokens, stream) -> dict:
    """One chat: status, content, finish reason and the usage's completion
    tokens (a stream asks for its usage chunk); an SSE error event is kept."""
    body = {"model": model, "messages": messages, "max_tokens": max_tokens, "stream": stream}
    if stream:
        body["stream_options"] = {"include_usage": True}
    async with s.post(base + OPENAI_CHAT, json=body) as r:
        if r.status != 200:
            return dict(status=r.status, error=await r.text())
        if not stream:
            out = await r.json()
            return dict(status=200, content=out["choices"][0]["message"]["content"],
                        finish=out["choices"][0]["finish_reason"],
                        completion=out["usage"]["completion_tokens"], error=None)
        pieces, finish, completion, error = [], None, None, None
        async for raw in r.content:
            line = raw.decode().strip()
            if not line.startswith("data: {"):
                continue
            chunk = json.loads(line[len("data: "):])
            if "error" in chunk:
                error = chunk["error"]
                continue
            if chunk.get("usage"):
                completion = chunk["usage"]["completion_tokens"]
            for choice in chunk.get("choices") or ():
                pieces.append(choice["delta"].get("content") or "")
                finish = choice["finish_reason"] or finish
        return dict(status=200, content="".join(pieces), finish=finish, completion=completion,
                    error=error)


def check_chats(label, results, max_tokens) -> None:
    bad = [r for r in results if r["status"] != 200 or r.get("error")
           or r["finish"] != "length" or r["completion"] != max_tokens]
    if bad:
        raise AssertionError("{}: {} of {} chats not 200 / length / {} tokens: {}".format(
            label, len(bad), len(results), max_tokens, bad[:2]))


def fleet_of(processor, url):
    proc = processor._engine_processor_lookup[url]
    return proc.engine


async def add_endpoint(processor, cli, url, aux) -> float:
    """The CLI adds ``url``; returns the seconds to the daemon's pickup."""
    t0 = time.perf_counter()
    argv = ["--yes", "model", "add", "--engine", "llm", "--endpoint", url, "--aux-config"]
    await asyncio.to_thread(cli, argv + ["engine.{}={}".format(k, json.dumps(v))
                                         for k, v in aux.items()])
    await until(lambda: url in processor._endpoints, 60,
                "the sync daemon to pick {} up".format(url))
    return time.perf_counter() - t0


async def remove_fleet(processor, cli, url) -> dict:
    """The CLI removes ``url``; its group and every replica engine must be
    gone where the eviction's release returns (nothing collected here), and
    the process registry must hold no entry for them."""
    from prometheus_client import REGISTRY, generate_latest

    proc = processor._engine_processor_lookup[url]
    group = proc.engine
    refs = [weakref.ref(group)] + [weakref.ref(r.engine) for r in group.replicas]
    del group
    release, released = proc._release, []

    def recording_release():
        release()
        released.append([ref() is None for ref in refs])

    proc._release = recording_release
    t0 = time.perf_counter()
    await asyncio.to_thread(cli, ["--yes", "model", "remove", "--endpoint", url])
    await until(lambda: bool(released), 60, "{}'s engines to be released".format(url))
    freed_s = time.perf_counter() - t0
    del proc._release
    if url in processor._engine_processor_lookup or released != [[True] * len(refs)]:
        raise AssertionError("{}'s engines outlived their release: {}".format(url, released))
    left = [line for line in generate_latest(REGISTRY).decode().splitlines()
            if 'model="{}"'.format(url) in line]
    if left:
        raise AssertionError("the registry still holds {}: {}".format(url, left[:3]))
    return dict(freed_s=freed_s)


def workspace_blocks() -> dict:
    """Live 32 MiB blocks (a cuBLAS workspace's size) by the stream their
    segment belongs to: where the card's memory went between two
    readings."""
    if torch.device(DEV).type != "cuda":
        return {}
    out = {}
    for seg in torch.cuda.memory_snapshot():
        n = sum(1 for b in seg["blocks"]
                if b["state"] == "active_allocated" and b["size"] == 32 << 20)
        if n:
            out[seg["stream"]] = out.get(seg["stream"], 0) + n
    return out


async def drained(*engines) -> None:
    """Every engine drained (no loop variable left bound to one: the
    removal's hold needs the eviction to hold the last reference)."""
    await asyncio.gather(*[e.wait_drained() for e in engines])


def _mean_ms(snap) -> float:
    return snap["sum_ms"] / max(1, sum(snap["counts"]))


async def single_conversations(s, base, tok, block) -> tuple:
    """14a's traffic on ``single``: 4 conversations x 3 turns (two homed
    on each replica of a 2-replica ring by the router's math), each turn
    the last one's messages, its reply and ~100 new characters. Returns
    the messages of every turn and the replies."""
    openers = balanced_openers(tok, 0, 4, 300, block, "Conversation")
    convs = [[{"role": "user", "content": o}] for o in openers]
    turns, results = [], []
    t0 = time.perf_counter()
    for turn in range(3):
        msgs = [list(c) for c in convs]
        turns.append(msgs)
        replies = await asyncio.gather(*[
            fleet_chat(s, base, "single", m, FLEET_TURN_TOKENS, False) for m in msgs])
        results += replies
        for c, reply in zip(convs, replies):
            c += [{"role": "assistant", "content": reply.get("content", "")},
                  {"role": "user", "content": fleet_text(40 + turn * 4 + len(c), 100)}]
    check_chats("14a single", results, FLEET_TURN_TOKENS)
    return turns, results, time.perf_counter() - t0


async def fleet_14a(s, base, processor, tok, runs, turns, single_results) -> dict:
    """The same turns on ``fleet`` (half the chats streaming): each
    conversation on one replica, affine, turns 2-3 hits there, the token
    ids and contents of ``single``."""
    from clearml_serving_tpu_torch.ops.paged_attention import paged_attention

    group = fleet_of(processor, "fleet")
    results = []
    for rep in group.replicas:
        _zero_counts(rep.engine)
    hits0 = {r.name: r.engine._prefix.stats()["hits"] for r in group.replicas}
    routes0 = group.router.stats()["requests"]
    t0 = time.perf_counter()
    for msgs in turns:
        results += await asyncio.gather(*[
            fleet_chat(s, base, "fleet", m, FLEET_TURN_TOKENS, i % 2 == 1)
            for i, m in enumerate(msgs)])
    await drained(*[r.engine for r in group.replicas])
    wall = time.perf_counter() - t0
    check_chats("14a fleet", results, FLEET_TURN_TOKENS)
    launches = paged_attention.launches
    steps = sum(r.engine.counters["decode_steps"] for r in group.replicas)
    n_layers = group.model.n_layers
    if launches != n_layers * steps or steps == 0:
        raise AssertionError("14a: paged_attention launched {} times for {} decode steps of "
                             "{} layers on the two replicas".format(launches, steps, n_layers))
    captures = {r.name: r.engine.counters["serve_captures"] for r in group.replicas}
    if any(captures.values()):
        raise AssertionError("14a: captures while serving: {}".format(captures))
    homes = []
    for c in range(4):
        ids = [chat_ids(tok, turns[t][c]) for t in range(3)]
        where = {name for name in ("r0", "r1") for i in ids if (name, i) in runs}
        if len(where) != 1:
            raise AssertionError("14a: conversation {} ran on {}".format(c, where))
        homes.append(where.pop())
    routes = group.router.stats()["requests"]
    affine = {n: routes[n]["affine"] - routes0[n]["affine"] for n in routes}
    moved = sum(routes[n][k] - routes0[n][k] for n in routes for k in ("spill", "rebalance"))
    hits = {r.name: r.engine._prefix.stats()["hits"] - hits0[r.name] for r in group.replicas}
    want_hits = {n: 2 * homes.count(n) for n in ("r0", "r1")}
    if moved or affine != {n: 3 * homes.count(n) for n in ("r0", "r1")} or hits != want_hits:
        raise AssertionError("14a: homes {} routes {} (spill/rebalance {}) hits {} (want "
                             "{})".format(homes, affine, moved, hits, want_hits))
    differ = []
    for t in range(3):
        for c in range(4):
            ids = chat_ids(tok, turns[t][c])
            if runs[(homes[c], ids)]["tokens"] != runs[(None, ids)]["tokens"]:
                differ.append((c, t))
    if differ:
        raise AssertionError("14a: token ids differ from the single engine's on (conversation, "
                             "turn) {}".format(differ))
    if [r["content"] for r in results] != [r["content"] for r in single_results]:
        raise AssertionError("14a: contents differ from the single endpoint's")
    ttft = []
    for t in range(3):
        for c in range(4):
            rec = runs[(homes[c], chat_ids(tok, turns[t][c]))]
            ttft.append((rec["t_first"] - rec["t0"]) * 1e3)
    step_ms = {r.name: r.engine.counters["decode_ms"] / max(1, r.engine.counters["decode_steps"])
               for r in group.replicas}
    return dict(homes=homes, hits=hits, affine=affine, launches=launches, decode_steps=steps,
                ttft_ms=ttft, wall_s=wall, step_ms=step_ms)


async def fleet_14b(s, base, processor, tok, runs, block) -> dict:
    """4 greedy streams x 128 tokens, two per replica; a retire stall on r1
    trips its watchdog mid-stream; its two streams resume on r0."""
    from clearml_serving_tpu_torch.llm import faults
    from clearml_serving_tpu_torch.llm.engine import GenRequest

    group = fleet_of(processor, "fleet")
    r0, r1 = (r.engine for r in group.replicas)
    openers = balanced_openers(tok, 100, 4, 300, block, "Stream")
    msgs = [[{"role": "user", "content": o}] for o in openers]
    ids = [chat_ids(tok, m) for m in msgs]
    homes = [fleet_home(tok, m, block) for m in msgs]
    victims = [i for i, h in enumerate(homes) if h == "r1"]
    others = {t for i, p in enumerate(ids) if homes[i] == "r0" for t in p}
    marker = next(t for t in ids[victims[0]] if t not in others)
    trips0, failovers0 = r1.counters["watchdog_trips"], group.failovers
    ej0 = group.router.stats()["ejections"]["r1"]
    rd0 = group.router.stats()["readmissions"]["r1"]
    chats = [asyncio.ensure_future(fleet_chat(s, base, "fleet", m, FLEET_STREAM_TOKENS, True))
             for m in msgs]
    await until(lambda: all(len(runs.get(("r1", ids[v]), {}).get("tokens", ())) >= 24
                            for v in victims), 120, "the victims' first 24 tokens")
    faults.configure([{"point": "engine.decode.stall", "action": "delay",
                       "delay": FLEET_STALL_S, "times": 1, "match_token": int(marker)}])
    try:
        await until(lambda: r1.counters["watchdog_trips"] > trips0, 30, "r1's watchdog trip")
        t_trip = time.perf_counter()
        results = await asyncio.gather(*chats)
    finally:
        faults.clear()
    check_chats("14b", results, FLEET_STREAM_TOKENS)
    # the tripped replica recovers, re-warms through its gate and rejoins
    while "r1" not in group.router.ring():
        if time.perf_counter() - t_trip > 120:
            raise AssertionError("r1 did not rejoin the ring: {}".format(group.router.stats()))
        group.router.sweep()
        await asyncio.sleep(0.02)
    rejoin_s = time.perf_counter() - t_trip
    await r0.wait_drained()
    out = dict(homes=homes, victims=victims, failovers=group.failovers - failovers0,
               rejoin_s=rejoin_s, rewarm_s=group.replicas[1].warm_seconds[-1], streams=[])
    resume_s = []
    for v in victims:
        pre = runs[("r1", ids[v])]["tokens"]
        history = tuple(ids[v]) + tuple(pre)
        clone = runs.get(("r0", history))
        if not pre or clone is None or len(pre) + len(clone["tokens"]) != FLEET_STREAM_TOKENS:
            raise AssertionError("14b: stream {} emitted {} tokens on r1 and resumed with {} on "
                                 "r0".format(v, len(pre), clone and len(clone["tokens"])))
        resume_s.append(clone["t_first"] - t_trip)
        # the continuation is a fresh request's on the sibling, cold
        _empty_prefix_cache(r0)
        fresh = [int(t) async for t in r0.generate(GenRequest(
            prompt_ids=list(history), max_new_tokens=len(clone["tokens"])))]
        if fresh != clone["tokens"]:
            raise AssertionError("14b: stream {}'s continuation differs from a fresh request "
                                 "on r0 at token {}".format(v, first_difference(
                                     fresh, clone["tokens"])))
        out["streams"].append(dict(before_trip=len(pre), after=len(clone["tokens"])))
    await r0.wait_drained()
    stats = group.router.stats()
    if (out["failovers"] != len(victims) or r1.counters["watchdog_trips"] != trips0 + 1
            or r0.counters["watchdog_trips"] or stats["ejections"]["r1"] <= ej0
            or stats["readmissions"]["r1"] <= rd0 or stats["ring"] != ["r0", "r1"]):
        raise AssertionError("14b: failovers {}, trips r0 {} r1 {}, router {}".format(
            out["failovers"], r0.counters["watchdog_trips"], r1.counters["watchdog_trips"],
            stats))
    captures = [r.engine.counters["serve_captures"] for r in group.replicas]
    if any(captures):
        raise AssertionError("14b: captures while serving: {}".format(captures))
    out["resume_s"] = resume_s
    return out


def shipment_pages_equal(shipment, engine, ids) -> bool:
    """The shipment's rows equal, bit for bit, the pages ``engine``'s prefix
    cache holds for ``ids`` (a lookup whose hit is given back uncounted)."""
    hit = engine._prefix.lookup_pages(list(ids), 0)
    if hit is None or len(hit["pages"]) < shipment.pages:
        if hit is not None:
            engine._prefix.release(hit)
            engine._prefix.uncount_hit(hit)
        return False
    pages = list(hit["pages"][:shipment.pages])
    engine._prefix.release(hit)
    engine._prefix.uncount_hit(hit)
    got = engine.paged_cache.export_pages(pages)
    return all(torch.equal(got[name], getattr(shipment, name))
               for name in ("hk", "hv", "hk_scale", "hv_scale")
               if getattr(shipment, name) is not None)


def _ship_counts(pre, dec, group, received) -> dict:
    """The ship counters 14c holds, on both replicas and the transport."""
    ps, ds = pre._kv_ship_snapshot(), dec._kv_ship_snapshot()
    tr = ds["transport"]
    return dict(ships=ps["ships"], ship_drops=ps["ship_drops"], draft_aborts=ps["draft_aborts"],
                receives=ds["receives"], hits=ds["hits"], recomputes=ds["recomputes"],
                dropped=tr["dropped"], assembly_drops=tr["assembly_drops"],
                partial_frames=tr["partial_frames"],
                leg_failures=group._disagg_snapshot()["ship_leg_failures"],
                received=len(received))


def check_ships(label, before, after, ragged: bool) -> None:
    """Two chats' worth of ships between two ``_ship_counts`` readings:
    both shipped and hit on the decode replica, under ragged in partial
    frames too, nothing dropped, aborted or recomputed."""
    d = {k: after[k] - before[k] for k in after}
    want = dict(ships=2, ship_drops=0, draft_aborts=0, receives=2, hits=2, recomputes=0,
                dropped=0, assembly_drops=0, leg_failures=0, received=2)
    if any(d[k] != v for k, v in want.items()) or (ragged and d["partial_frames"] < 1):
        raise AssertionError("{}: ship counters moved by {}".format(label, d))


def check_shipped_pages(label, received, pre, dec, ids) -> None:
    """Each shipment's rows, the decode replica's imported pages and the
    prefill replica's own pages of the prompt: the same bits."""
    from clearml_serving_tpu_torch.llm.kv_transport import shipment_key

    by_key = {shipment_key(list(i), dec._prefix.block, 0): i for i in ids}
    for shipment in received:
        i = by_key[shipment.key]
        if not (shipment_pages_equal(shipment, dec, i) and shipment_pages_equal(shipment, pre, i)):
            raise AssertionError("{}: the imported pages differ from the exported "
                                 "ones".format(label))


async def fleet_14c(s, base, processor, cli, tok, runs, url, aux, cold) -> dict:
    """One disaggregated arm: ``url`` added, warmed, two long chats one
    after the other with every hold, the same two chats given the prefill
    replica directly (a monolithic engine) at once and one after the
    other, then two new chats at once with the holds that do not depend on
    what rides beside a row; then removed."""
    from clearml_serving_tpu_torch.ops.paged_attention import (
        paged_attention, ragged_paged_attention)
    from clearml_serving_tpu_torch.llm.engine import GenRequest

    picked_s = await add_endpoint(processor, cli, url, aux)
    t0 = time.perf_counter()
    await fleet_chat(s, base, url, [{"role": "user", "content": "Warm up."}], 4, False)
    warm_s = time.perf_counter() - t0
    group = fleet_of(processor, url)
    pre, dec = (r.engine for r in group.replicas)
    arm_runs = record_fleet([pre, dec])
    await drained(pre, dec)
    _zero_counts(pre)
    _zero_counts(dec)
    received = []
    recv = group.transport.recv

    def recording_recv(dst, key):
        shipment = recv(dst, key)
        if shipment is not None:
            received.append(shipment)
        return shipment

    group.transport.recv = recording_recv
    msgs = [[{"role": "user", "content": "Report {}: {}".format(i, fleet_text(
        200 + i, FLEET_DISAGG_CHARS))}] for i in range(2)]
    ids = [chat_ids(tok, m) for m in msgs]
    # one chat after the other: a ragged launch's rows depend on what else
    # rides it, and each stream is held to a lone hit on the prefill replica
    t0 = time.perf_counter()
    results = [await fleet_chat(s, base, url, m, FLEET_DISAGG_TOKENS, True) for m in msgs]
    wall = time.perf_counter() - t0
    await drained(pre, dec)
    check_chats("14c " + url, results, FLEET_DISAGG_TOKENS)
    # TTFT: from the prefill leg's start to the decode replica's first token
    ttft = [(arm_runs[("r1", i)]["t_first"] - arm_runs[("r0", i)]["t0"]) * 1e3 for i in ids]
    launches = _launch_counts()
    n_layers = group.model.n_layers
    c = [e.counters for e in (pre, dec)]
    paged_want = n_layers * sum(x["decode_steps"] + x["ragged_chain_steps"] for x in c)
    ragged_want = n_layers * sum(x["ragged_steps"] for x in c)
    if launches["paged"] != paged_want or launches["ragged"] != ragged_want or (
            aux.get("scheduler") == "ragged") != (ragged_want > 0):
        raise AssertionError("14c {}: launches {} against {} paged and {} ragged".format(
            url, launches, paged_want, ragged_want))
    ps, ds = pre._kv_ship_snapshot(), dec._kv_ship_snapshot()
    tr = ds["transport"]
    ragged = aux.get("scheduler") == "ragged"
    zero = dict.fromkeys(_ship_counts(pre, dec, group, received), 0)
    check_ships("14c " + url, zero, _ship_counts(pre, dec, group, received), ragged)
    check_shipped_pages("14c " + url, received, pre, dec, ids)
    # a single engine hitting the same prefix length: the prefill replica,
    # which holds the prompts, asked directly, one chat after the other;
    # then both at once (the witness of what rides beside a row)
    def requests(prompts):
        return [GenRequest(prompt_ids=list(i), max_new_tokens=FLEET_DISAGG_TOKENS)
                for i in prompts]

    direct = [await _direct(pre, r) for r in requests(ids)]
    streams = [arm_runs[("r1", i)]["tokens"] for i in ids]
    if streams != direct:
        raise AssertionError("14c {}: the decode replica's streams differ from a hit on the "
                             "prefill replica at tokens {}".format(
                                 url, [first_difference(a, b) for a, b in zip(streams, direct)]))
    together = await asyncio.gather(*[_direct(pre, r) for r in requests(ids)])
    ship_ms, receive_ms = _mean_ms(ps["ship_ms"]), _mean_ms(ds["receive_ms"])
    out = dict(picked_up_s=picked_s, warm_s=warm_s, wall_s=wall,
               ship_ms=ship_ms, receive_ms=receive_ms,
               ships=ps["ships"], ship_pages=ps["ship_pages"], draft_ships=ps["draft_ships"],
               draft_pages=ps["draft_pages"], partial_frames=tr["partial_frames"],
               hits=ds["hits"], launches=launches,
               ttft_ms=ttft,
               first_difference_from_cold=[first_difference(st, cold[i]) for i, st in
                                           zip(ids, streams)],
               monolithic_together_vs_alone=[first_difference(a, b)
                                             for a, b in zip(together, direct)])
    # the concurrent pass: two new chats at once (new heads: nothing of
    # them is cached on either replica)
    msgs = [[{"role": "user", "content": "Summary {}: {}".format(i, fleet_text(
        200 + i, FLEET_DISAGG_CHARS))}] for i in range(2)]
    ids2 = [chat_ids(tok, m) for m in msgs]
    await drained(pre, dec)
    before = _ship_counts(pre, dec, group, received)
    del received[:]
    results = await asyncio.gather(*[fleet_chat(s, base, url, m, FLEET_DISAGG_TOKENS, True)
                                     for m in msgs])
    await drained(pre, dec)
    check_chats("14c concurrent " + url, results, FLEET_DISAGG_TOKENS)
    after = _ship_counts(pre, dec, group, received)
    before["received"] = 0
    check_ships("14c concurrent " + url, before, after, ragged)
    check_shipped_pages("14c concurrent " + url, received, pre, dec, ids2)
    streams2 = [arm_runs[("r1", i)]["tokens"] for i in ids2]
    alone2 = [await _direct(pre, r) for r in requests(ids2)]
    out.update(concurrent_ships=after["ships"] - before["ships"],
               concurrent_hits=after["hits"] - before["hits"],
               concurrent_partial_frames=after["partial_frames"] - before["partial_frames"],
               concurrent_vs_alone=[first_difference(a, b) for a, b in zip(streams2, alone2)])
    del group, pre, dec, recv  # the eviction must be the last to hold them
    out.update(await remove_fleet(processor, cli, url))
    return out


async def _direct(engine, request) -> list:
    return [int(t) async for t in engine.generate(request)]


async def cycle_again(s, base, processor, cli, url, aux) -> dict:
    """``url`` added once more, its replicas warmed by one chat, and
    removed (``remove_fleet``'s holds): the seconds, and
    ``memory_allocated`` after the removal."""
    picked = await add_endpoint(processor, cli, url, aux)
    await fleet_chat(s, base, url, [{"role": "user", "content": "Warm up."}], 4, False)
    await drained(*[r.engine for r in fleet_of(processor, url).replicas])
    out = await remove_fleet(processor, cli, url)
    return dict(out, picked_up_s=picked,
                memory_after=card_memory() if torch.device(DEV).type == "cuda" else 0)


# the statistics controller whose device gauges phase 14 reads (one per
# process: its gauges register on the process registry)
_STATS: list = []


@contextlib.contextmanager
def fleet_memory_readings(readings: dict):
    """``memory_allocated`` after each engine ``build_engine`` constructs
    (``readings["built"]``) and after each replica's warm gate opens
    (``readings["warmed"]``, by replica), while the block runs."""
    from clearml_serving_tpu_torch.llm import openai_api
    from clearml_serving_tpu_torch.llm import replica as replica_mod

    on_card = torch.device(DEV).type == "cuda"
    real_core, real_warm = openai_api.LLMEngineCore, replica_mod.EngineReplica.ensure_warm

    def recording_core(*args, **kwargs):
        engine = real_core(*args, **kwargs)
        if on_card:
            sync()
            readings["built"].append(torch.cuda.memory_allocated())
        return engine

    async def recording_warm(self, full):
        await real_warm(self, full)
        if on_card:
            sync()
            readings["warmed"].setdefault(self.name, torch.cuda.memory_allocated())

    openai_api.LLMEngineCore = recording_core
    replica_mod.EngineReplica.ensure_warm = recording_warm
    try:
        yield readings
    finally:
        openai_api.LLMEngineCore = real_core
        replica_mod.EngineReplica.ensure_warm = real_warm


async def fleet_runs(processor, cli, tok, card: str) -> dict:
    """14a, 14b, the removal and 14c behind the processor's router, each
    logged as it ends."""
    import aiohttp
    from aiohttp import web
    from prometheus_client import REGISTRY, generate_latest

    from clearml_serving_tpu_torch.serving.main import build_app
    from clearml_serving_tpu_torch.statistics.metrics import StatisticsController

    single = processor._engine_processor_lookup["single"].engine
    runs = record_fleet([single])
    app = build_app(processor)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    base = "http://127.0.0.1:{}".format(runner.addresses[0][1])
    on_card = torch.device(DEV).type == "cuda"
    block = FLEET_BASE["prefix_block"]
    out = {}
    try:
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as s:
            await fleet_chat(s, base, "single", [{"role": "user", "content": "Warm up."}], 4,
                             False)
            # the single endpoint's traffic first (14a's turns and 14c's
            # cold streams), so that its first uses precede the fleet's
            # memory readings
            _zero_counts(single)
            turns, single_results, single_wall = await single_conversations(s, base, tok, block)
            single_step_ms = single.counters["decode_ms"] / max(1, single.counters["decode_steps"])
            msgs = [[{"role": "user", "content": "Report {}: {}".format(i, fleet_text(
                200 + i, FLEET_DISAGG_CHARS))}] for i in range(2)]
            cold = await asyncio.gather(*[fleet_chat(s, base, "single", m, FLEET_DISAGG_TOKENS,
                                                     True) for m in msgs])
            check_chats("14c single", cold, FLEET_DISAGG_TOKENS)
            await single.wait_drained()
            cold_ids = {chat_ids(tok, m): runs[(None, chat_ids(tok, m))] for m in msgs}
            out["14c_single_ttft_ms"] = [(r["t_first"] - r["t0"]) * 1e3
                                        for r in cold_ids.values()]
            cold_tokens = {k: r["tokens"] for k, r in cold_ids.items()}
            mem_single = card_memory() if on_card else 0
            blocks_single = workspace_blocks()
            # memory_allocated after each replica is built and after each
            # warms (its graphs): the second replica's own rise
            readings = {"built": [], "warmed": {}}
            with fleet_memory_readings(readings):
                picked = await add_endpoint(processor, cli, "fleet",
                                            dict(FLEET_BASE, replicas=2,
                                                 watchdog_interval=FLEET_WATCHDOG_S))
                t0 = time.perf_counter()
                await fleet_chat(s, base, "fleet", [{"role": "user", "content": "Warm up."}],
                                 4, False)
                warm_s = time.perf_counter() - t0
            group = fleet_of(processor, "fleet")
            record_fleet([r.engine for r in group.replicas], runs)
            await drained(*[r.engine for r in group.replicas])
            mem_fleet = card_memory() if on_card else 0
            ready = await (await s.get(base + "/ready")).json()
            ring = ready["fleet"]["fleet"]["ring"]
            if ring != ["r0", "r1"]:
                raise AssertionError("/ready's fleet ring: {}".format(ready["fleet"]))
            out["14a"] = await fleet_14a(s, base, processor, tok, runs, turns, single_results)
            # the exporter, in process: a statistics controller's device
            # gauges beside the fleet's collectors
            if not _STATS:
                _STATS.append(StatisticsController("", registry=REGISTRY))
            _STATS[0].update_device_gauges()
            text = generate_latest(REGISTRY).decode()
            want = ['engine_ready{model="fleet",replica="r0"} 1.0',
                    'engine_ready{model="fleet",replica="r1"} 1.0',
                    'router_replicas{model="fleet"} 2.0',
                    'engine_kv_pool_bytes{kind="kv",model="fleet",replica="r1"}']
            if on_card:
                want.append('tpu_hbm_bytes_in_use{device="0"}')
            missing = [w for w in want if w not in text]
            if missing:
                raise AssertionError("14a: the Prometheus export lacks {}".format(missing))
            a = out["14a"]
            built, warmed = readings["built"], readings["warmed"]
            second = ((built[1] - built[0]) + (warmed["r1"] - warmed["r0"])
                      if on_card else 0)
            weights = group.model.weight_bytes()
            a.update(picked_up_s=picked, warm_s=warm_s, memory_single=mem_single,
                     memory_fleet=mem_fleet, second_replica_rise=second, weight_bytes=weights,
                     ring=ring, exported=want)
            log("  14a: homes {}, prefix hits per replica {}, affine routes {}, token ids "
                "equal the single endpoint's on all 12 turns; paged_attention {} = {} layers x "
                "{} decode steps; fleet picked up {:.2f} s after the CLI, its first request "
                "(both replicas' warmup) {:.2f} s; memory_allocated: the fleet +{} B ({} B of "
                "weights, once), the second replica +{} B (built +{} B, warmed +{} B) "
                "({})".format(
                    a["homes"], a["hits"], a["affine"], a["launches"],
                    a["launches"] // max(1, a["decode_steps"]), a["decode_steps"], picked,
                    warm_s, mem_fleet - mem_single, weights, second,
                    built[1] - built[0] if on_card else 0,
                    warmed["r1"] - warmed["r0"] if on_card else 0, card))
            a.update(single_wall_s=single_wall, single_step_ms=single_step_ms)
            log("  14a: TTFT ms by turn (conversation order) {}; 12 chats in {:.2f} s on the "
                "fleet, {:.2f} s on the single engine; ms a decode step {} on the replicas, "
                "{:.3f} on the single engine; exported {}".format(
                    [round(x, 2) for x in a["ttft_ms"]], a["wall_s"], single_wall,
                    {k: round(v, 3) for k, v in a["step_ms"].items()}, single_step_ms, want))
            if on_card and not 0 < second < FLEET_SECOND_REPLICA_LIMIT:
                raise AssertionError("the fleet's second replica added {} B".format(second))
            out["14b"] = await fleet_14b(s, base, processor, tok, runs, block)
            b = out["14b"]
            log("  14b: victims {} on r1 tripped its watchdog ({} s stall, {} s interval); {} "
                "failovers to r0, resumed {} s after the trip, each continuation a fresh "
                "request's on r0; tokens before the trip / after: {}; r1 re-warmed in {:.2f} s "
                "and rejoined the ring {:.2f} s after the trip ({})".format(
                    b["victims"], FLEET_STALL_S, FLEET_WATCHDOG_S, b["failovers"],
                    [round(x, 3) for x in b["resume_s"]], b["streams"], b["rewarm_s"],
                    b["rejoin_s"], card))
            del group  # the eviction must be the last to hold it
            out["removal"] = r = await remove_fleet(processor, cli, "fleet")
            mem_after = card_memory() if on_card else 0
            r.update(memory_before=mem_single, memory_after=mem_after,
                     workspace_blocks_before=blocks_single,
                     workspace_blocks_after=workspace_blocks())
            log("  removal: the fleet's group and both engines gone where the release "
                "returned ({:.2f} s after the CLI), no registry entry left; memory_allocated "
                "{} B before the fleet, {} B after ({:+d} B); live 32 MiB blocks by stream "
                "before {}, after {} ({})".format(
                    r["freed_s"], mem_single, mem_after, mem_after - mem_single, blocks_single,
                    r["workspace_blocks_after"], card))
            if abs(mem_after - mem_single) > CP_MEMORY_SLACK:
                raise AssertionError("memory_allocated {} B before the fleet, {} B after its "
                                     "removal".format(mem_single, mem_after))
            # a second cycle on the same streams and threads adds nothing
            fleet_aux = dict(FLEET_BASE, replicas=2, watchdog_interval=FLEET_WATCHDOG_S)
            r["second_cycle"] = again = await cycle_again(s, base, processor, cli, "fleet",
                                                          fleet_aux)
            log("  removal, second cycle: the fleet added again, warmed and removed ({:.2f} s "
                "after the CLI); memory_allocated {} B after ({:+d} B against the first "
                "removal) ({})".format(again["freed_s"], again["memory_after"],
                                       again["memory_after"] - mem_after, card))
            if again["memory_after"] != mem_after:
                raise AssertionError("memory_allocated {} B after the fleet's first removal, {} "
                                     "B after the second".format(mem_after,
                                                                 again["memory_after"]))
            roles = {"replicas": 2, "replica_roles": ["prefill", "decode"],
                     "watchdog_interval": FLEET_WATCHDOG_S}
            out["14c"] = {}
            for arm, knobs in (("two_dispatch", {}),
                               ("ragged", {"scheduler": "ragged", "step_token_budget": 256})):
                url = "disagg" if arm == "two_dispatch" else "disagg_ragged"
                aux = dict(FLEET_BASE, **roles, **knobs)
                out["14c"][arm] = c = await fleet_14c(s, base, processor, cli, tok, runs, url,
                                                      aux, cold_tokens)
                c["memory_after"] = card_memory() if on_card else 0
                log("  14c {}: ships {} ({} pages; {} draft frames of {} pages, {} partial "
                    "frames received), decode hits {}; ship_ms {:.3f} (the prefill replica's "
                    "loop stall), receive_ms {:.3f}; TTFT ms {} disaggregated / {} monolithic "
                    "cold; first difference from the cold monolithic stream at token {}; "
                    "streams equal a hit on the prefill replica; removed in {:.2f} s, "
                    "memory_allocated {:+d} B against before the fleet ({})".format(
                        arm, c["ships"], c["ship_pages"], c["draft_ships"], c["draft_pages"],
                        c["partial_frames"], c["hits"], c["ship_ms"], c["receive_ms"],
                        [round(x, 2) for x in c["ttft_ms"]],
                        [round(x, 2) for x in out["14c_single_ttft_ms"]],
                        c["first_difference_from_cold"], c["freed_s"],
                        c["memory_after"] - mem_single, card))
                log("  14c {}: the prefill replica given the two chats directly, at once "
                    "against one after the other: first differences {}; two new chats at once "
                    "through the fleet: 200 / length, ships {}, decode hits {}, partial frames "
                    "{}, pages bitwise, nothing dropped; their first differences from a lone "
                    "hit on the prefill replica {}".format(
                        arm, c["monolithic_together_vs_alone"], c["concurrent_ships"],
                        c["concurrent_hits"], c["concurrent_partial_frames"],
                        c["concurrent_vs_alone"]))
                if arm == "two_dispatch" and c["memory_after"] > mem_after:
                    # the fleet's streams and threads again: nothing new
                    raise AssertionError("memory_allocated {} B after the fleet's removal, {} B "
                                         "after 14c two_dispatch's".format(
                                             mem_after, c["memory_after"]))
                if arm == "ragged":
                    c["second_cycle"] = again = await cycle_again(s, base, processor, cli, url,
                                                                  aux)
                    log("  14c ragged, second cycle: added again, warmed and removed; "
                        "memory_allocated {:+d} B against its first removal ({})".format(
                            again["memory_after"] - c["memory_after"], card))
                    if again["memory_after"] != c["memory_after"]:
                        raise AssertionError("memory_allocated {} B after 14c ragged's first "
                                             "removal, {} B after the second".format(
                                                 c["memory_after"], again["memory_after"]))
    finally:
        await runner.cleanup()
    return out


def phase_fleet(card: str) -> dict:
    """Phase 14 (module docstring): the CLI, a processor launched with the
    single endpoint, then the fleet endpoints added and removed by the CLI
    while it serves."""
    from clearml_serving_tpu_torch.__main__ import cli
    from clearml_serving_tpu_torch.llm.tokenizer import ByteTokenizer
    from clearml_serving_tpu_torch.models.llama import resolve_config
    from clearml_serving_tpu_torch.serving.main import setup_processor
    from clearml_serving_tpu_torch.state import StateStore

    root = state_dir()
    env = {"TPUSERVE_STATE_ROOT": root, "TPUSERVE_POLL_FREQ": str(1.0 / 60)}
    saved = {k: os.environ.get(k) for k in list(env) + ["TPUSERVE_SERVICE_ID"]}
    os.environ.update(env)
    processor = None
    cfg = resolve_config({"preset": FLEET_BASE["preset"], **(FLEET_BASE.get("config") or {})})
    tok = ByteTokenizer(vocab_size=max(int(cfg["vocab_size"]), 259))
    try:
        for argv in (["create", "--name", "chip-smoke-fleet"],
                     ["--yes", "model", "add", "--engine", "llm", "--endpoint", "single",
                      "--aux-config"] + ["engine.{}={}".format(k, json.dumps(v))
                                         for k, v in FLEET_BASE.items()]):
            if cli(argv) != 0:
                raise AssertionError("the CLI failed: {}".format(argv))
        os.environ["TPUSERVE_SERVICE_ID"] = StateStore(root).find_service("chip-smoke-fleet").id
        processor = setup_processor(device=DEV)
        sync()
        t0 = time.perf_counter()
        out = asyncio.run(fleet_runs(processor, cli, tok, card))
        out["runs_s"] = time.perf_counter() - t0
    finally:
        if processor is not None:
            processor.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


# -- phase 15: the process fleet ------------------------------------------------------

# 15's endpoint: phase 14's block served by two worker processes, each with
# its own CUDA context, Llama, pool and graphs
PROC_BASE = FLEET_BASE   # 8 of 32 layers (all 32 until phase 16 joined the script)
PROC_FLEET = dict(PROC_BASE, replicas=2, replica_backend="process",
                  watchdog_interval=FLEET_WATCHDOG_S)
PROC_TURN_TOKENS = 32           # 15a: 4 conversations x 2 turns
PROC_STREAM_TOKENS = 128        # 15b: 4 greedy streams
PROC_DISAGG_TOKENS = 32         # 15c: 2 chats of ~1024-token prompts
PROC_PARENT_LIMIT = 64 << 20    # the parent's rise in memory_allocated
PROC_GONE_S = 30.0              # a removed fleet's workers must be gone by then
PROC_SLACK = 2 << 30            # the card's bytes in use back where they were


def compute_app_rows() -> list:
    """The card's compute processes as ``nvidia-smi`` lists them: (pid,
    used MiB) rows. (On the card's machine each process of the container is
    a row of its own, every row with pid 1 and the container's summed
    memory: the rows count the processes.)"""
    if torch.device(DEV).type != "cuda":
        return []
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    rows = []
    for line in out.strip().splitlines():
        pid, used = [x.strip() for x in line.split(",")[:2]]
        rows.append((int(pid), int(used) if used.isdigit() else 0))
    return rows


def card_used() -> int:
    """Bytes in use on the card, by every process (``mem_get_info``; 0 off
    the card)."""
    if torch.device(DEV).type != "cuda":
        return 0
    free, total = torch.cuda.mem_get_info()
    return total - free


def pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def worker_memory(group) -> dict:
    """Each worker's ``memory_allocated`` and ``memory_reserved``, read in
    the worker."""
    return {r.name: r.engine.device_memory() for r in group.replicas}


def worker_health(group) -> dict:
    return {r.name: r.engine.health() for r in group.replicas}


def zero_worker_counts(group) -> None:
    for r in group.replicas:
        r.engine.launch_counts(reset=True)


def worker_launches(group) -> dict:
    """The kernels' launches summed over the workers, beside what their
    counters say they must be."""
    total = {"paged": 0, "ragged": 0, "tree": 0, "int4": 0}
    want = {"paged": 0, "ragged": 0}
    n_layers = group.model.n_layers
    for name, h in worker_health(group).items():
        counts = group._replica_by_name(name).engine.launch_counts()
        for k in total:
            total[k] += counts[k]
        c = h["counters"]
        want["paged"] += n_layers * (c["decode_steps"] + c["ragged_chain_steps"])
        want["ragged"] += n_layers * c["ragged_steps"]
    return dict(total, want_paged=want["paged"], want_ragged=want["ragged"])


def check_launches(label, launches, ragged: bool) -> None:
    if (launches["paged"] != launches["want_paged"] or launches["paged"] == 0
            or launches["ragged"] != launches["want_ragged"]
            or ragged != (launches["ragged"] > 0)):
        raise AssertionError("{}: launches {}".format(label, launches))


def worker_step_ms(health: dict) -> float:
    c = health["counters"]
    return c["decode_ms"] / max(1, c["decode_steps"])


async def proc_conversations(s, base, url, turns_in=None, tok=None, block=64) -> tuple:
    """15a's traffic on ``url``: 4 conversations x 2 turns (two homed on
    each worker of a 2-replica ring by the router's math), each turn the
    last one's messages, its reply and ~100 new characters; half the chats
    stream. With ``turns_in`` the turns are replayed as given. Returns the
    turns and the replies."""
    if turns_in is None:
        openers = balanced_openers(tok, 300, 4, 300, block, "Conversation")
        convs = [[{"role": "user", "content": o}] for o in openers]
    turns, results = [], []
    for turn in range(2):
        msgs = turns_in[turn] if turns_in is not None else [list(c) for c in convs]
        turns.append(msgs)
        replies = await asyncio.gather(*[
            fleet_chat(s, base, url, m, PROC_TURN_TOKENS, i % 2 == 1)
            for i, m in enumerate(msgs)])
        results += replies
        if turns_in is None:
            for c, reply in zip(convs, replies):
                c += [{"role": "assistant", "content": reply.get("content", "")},
                      {"role": "user", "content": fleet_text(60 + turn * 4 + len(c), 100)}]
    check_chats("15a " + url, results, PROC_TURN_TOKENS)
    return turns, results


async def proc_15a(s, base, processor, tok, runs, turns, single_results) -> dict:
    """The same turns on ``fleet``: each conversation on one worker, its
    second turn a hit there, the token ids and contents of ``single``."""
    group = fleet_of(processor, "fleet")
    zero_worker_counts(group)
    hits0 = {n: h["prefix_cache"]["hits"] for n, h in worker_health(group).items()}
    t0 = time.perf_counter()
    _, results = await proc_conversations(s, base, "fleet", turns_in=turns)
    await drained(*[r.engine for r in group.replicas])
    wall = time.perf_counter() - t0
    launches = worker_launches(group)
    check_launches("15a", launches, ragged=False)
    health = worker_health(group)
    homes = []
    for c in range(4):
        ids = [chat_ids(tok, turns[t][c]) for t in range(2)]
        where = {name for name in ("r0", "r1") for i in ids if (name, i) in runs}
        if len(where) != 1:
            raise AssertionError("15a: conversation {} ran on {}".format(c, where))
        homes.append(where.pop())
    hits = {n: health[n]["prefix_cache"]["hits"] - hits0[n] for n in health}
    if hits != {n: homes.count(n) for n in ("r0", "r1")} or sorted(homes) != ["r0", "r0",
                                                                              "r1", "r1"]:
        raise AssertionError("15a: homes {} hits {}".format(homes, hits))
    differ = [(c, t) for t in range(2) for c in range(4)
              if runs[(homes[c], chat_ids(tok, turns[t][c]))]["tokens"]
              != runs[(None, chat_ids(tok, turns[t][c]))]["tokens"]]
    if differ:
        first = [first_difference(
            runs[(homes[c], chat_ids(tok, turns[t][c]))]["tokens"],
            runs[(None, chat_ids(tok, turns[t][c]))]["tokens"]) for c, t in differ]
        raise AssertionError("15a: token ids differ from the single engine's on (conversation, "
                             "turn) {} at tokens {}".format(differ, first))
    if [r["content"] for r in results] != [r["content"] for r in single_results]:
        raise AssertionError("15a: contents differ from the single endpoint's")
    captures = {n: h["counters"]["serve_captures"] for n, h in health.items()}
    if any(captures.values()):
        raise AssertionError("15a: captures while serving: {}".format(captures))
    ttft = [(runs[(homes[c], chat_ids(tok, turns[t][c]))]["t_first"]
             - runs[(homes[c], chat_ids(tok, turns[t][c]))]["t0"]) * 1e3
            for t in range(2) for c in range(4)]
    return dict(homes=homes, hits=hits, launches=launches, wall_s=wall, ttft_ms=ttft,
                step_ms={n: worker_step_ms(h) for n, h in health.items()},
                decode_steps={n: h["counters"]["decode_steps"] for n, h in health.items()})


async def proc_15b(s, base, processor, tok, runs, block) -> dict:
    """4 greedy streams x 128 tokens, two per worker; ``replica.proc.crash``
    SIGKILLs worker r1 mid-stream; its streams resume on r0, and r1 comes
    back as a new process through its warm gate."""
    from clearml_serving_tpu_torch.llm import faults
    from clearml_serving_tpu_torch.llm.engine import GenRequest

    group = fleet_of(processor, "fleet")
    r0, r1 = group.replicas
    openers = balanced_openers(tok, 400, 4, 300, block, "Stream")
    msgs = [[{"role": "user", "content": o}] for o in openers]
    ids = [chat_ids(tok, m) for m in msgs]
    homes = [fleet_home(tok, m, block) for m in msgs]
    victims = [i for i, h in enumerate(homes) if h == "r1"]
    pid0, failovers0 = r1.engine.pid, group.failovers
    rows_before, used_before = compute_app_rows(), card_used()
    chats = [asyncio.ensure_future(fleet_chat(s, base, "fleet", m, PROC_STREAM_TOKENS, True))
             for m in msgs]
    await until(lambda: all(len(runs.get(("r1", ids[v]), {}).get("tokens", ())) >= 24
                            for v in victims), 120, "the victims' first 24 tokens")
    faults.configure([{"point": "replica.proc.crash", "action": "raise", "match_token": 1,
                       "times": 1}])
    try:
        await until(lambda: not r1.engine.is_ready, 30, "r1's worker to die")
        t_dead = time.perf_counter()
        results = await asyncio.gather(*chats)
    finally:
        faults.clear()
    check_chats("15b", results, PROC_STREAM_TOKENS)
    await until(lambda: r1.restarts == 1 and r1.engine.is_ready, 180, "r1's restart")
    t_attached = time.perf_counter()
    while "r1" not in group.router.ring():
        if time.perf_counter() - t_dead > 240:
            raise AssertionError("r1 did not rejoin the ring: {}".format(group.router.stats()))
        group.router.sweep()
        await asyncio.sleep(0.02)
    t_rejoin = time.perf_counter()
    pid1 = r1.engine.pid
    if pid1 == pid0 or pid_alive(pid0):
        raise AssertionError("15b: r1's worker {} -> {}, the old one alive: {}".format(
            pid0, pid1, pid_alive(pid0)))
    # the killed worker went with its memory: as many compute processes as
    # before the kill, the card's use where it was, not one worker more
    rows_after, used_after = compute_app_rows(), card_used()
    if len(rows_after) != len(rows_before) or abs(used_after - used_before) > PROC_SLACK:
        raise AssertionError("15b: nvidia-smi rows {} and {} B in use after the restart, {} "
                             "and {} B before the kill".format(rows_after, used_after,
                                                              rows_before, used_before))
    out = dict(homes=homes, victims=victims, failovers=group.failovers - failovers0,
               pids=[pid0, pid1], rows=[len(rows_before), len(rows_after)],
               used=[used_before, used_after], streams=[], resume_s=[],
               respawn_s=t_attached - t_dead, warm_s=r1.warm_seconds[-1],
               rejoin_s=t_rejoin - t_dead)
    for v in victims:
        pre = runs[("r1", ids[v])]["tokens"]
        history = tuple(ids[v]) + tuple(pre)
        clone = runs.get(("r0", history))
        if not pre or clone is None or len(pre) + len(clone["tokens"]) != PROC_STREAM_TOKENS:
            raise AssertionError("15b: stream {} emitted {} tokens on r1 and resumed with {} on "
                                 "r0".format(v, len(pre), clone and len(clone["tokens"])))
        out["resume_s"].append(clone["t_first"] - t_dead)
        # the continuation is a fresh request's with the history as its
        # prompt: on the restarted r1 (a new process, cold; pinned there),
        # and, reported, on r0 (whose cache now holds the history)
        request = GenRequest(prompt_ids=list(history), max_new_tokens=len(clone["tokens"]))
        request._replica_name = "r1"
        fresh = [int(t) async for t in group.generate(request)]
        if request._replica_name != "r1" or fresh != clone["tokens"]:
            raise AssertionError("15b: stream {}'s continuation differs from a fresh request "
                                 "on the restarted r1 at token {} (served on {})".format(
                                     v, first_difference(fresh, clone["tokens"]),
                                     request._replica_name))
        warm = await _direct(r0.engine, GenRequest(prompt_ids=list(history),
                                                   max_new_tokens=len(clone["tokens"])))
        out["streams"].append(dict(before_kill=len(pre), after=len(clone["tokens"]),
                                   r0_hit_first_difference=first_difference(
                                       warm, clone["tokens"])))
    await drained(r0.engine, r1.engine)
    if (out["failovers"] != len(victims) or r1.restarts != 1 or r0.restarts != 0
            or group.router.stats()["ring"] != ["r0", "r1"]):
        raise AssertionError("15b: failovers {}, restarts r0 {} r1 {}, ring {}".format(
            out["failovers"], r0.restarts, r1.restarts, group.router.stats()["ring"]))
    return out


async def remove_process_fleet(processor, cli, url, before: tuple) -> dict:
    """``remove_fleet``'s holds, and: every worker gone within 30 s, the
    card's compute processes and its bytes in use back where they were
    before the fleet (``before``: rows, bytes), the fleet's directory
    removed."""
    group = fleet_of(processor, url)
    pids = [r.engine.pid for r in group.replicas]
    base = group._process_runtime.base_dir
    del group
    t0 = time.perf_counter()
    out = await remove_fleet(processor, cli, url)
    await until(lambda: not any(pid_alive(p) for p in pids), PROC_GONE_S,
                "{}'s workers to exit".format(url))
    out["workers_gone_s"] = time.perf_counter() - t0
    if os.path.exists(base):
        raise AssertionError("{}'s directory {} outlived it".format(url, base))
    rows, used = compute_app_rows(), card_used()
    out.update(pids=pids, rows=len(rows), used=used)
    if len(rows) != len(before[0]) or used > before[1] + PROC_SLACK:
        raise AssertionError("{}: nvidia-smi rows {} and {} B in use after the removal, {} "
                             "and {} B before the fleet".format(url, rows, used, *before))
    return out


async def proc_15c(s, base, processor, cli, tok, url, aux, cold, card_before) -> dict:
    """One disaggregated arm over the socket KV wire: ``url`` added and
    warmed, two long chats one after the other; the decode worker's
    streams equal a hit on the prefill worker; then removed."""
    from clearml_serving_tpu_torch.llm.engine import GenRequest

    picked = await add_endpoint(processor, cli, url, aux)
    t0 = time.perf_counter()
    await fleet_chat(s, base, url, [{"role": "user", "content": "Warm up."}], 4, False)
    boot_warm_s = time.perf_counter() - t0
    group = fleet_of(processor, url)
    pre, dec = (r.engine for r in group.replicas)
    arm_runs = record_fleet([pre, dec])
    await drained(pre, dec)
    zero_worker_counts(group)
    before = worker_health(group)
    msgs = [[{"role": "user", "content": "Report {}: {}".format(i, fleet_text(
        200 + i, FLEET_DISAGG_CHARS))}] for i in range(2)]
    ids = [chat_ids(tok, m) for m in msgs]
    results = [await fleet_chat(s, base, url, m, PROC_DISAGG_TOKENS, True) for m in msgs]
    await drained(pre, dec)
    check_chats("15c " + url, results, PROC_DISAGG_TOKENS)
    ragged = aux.get("scheduler") == "ragged"
    launches = worker_launches(group)
    check_launches("15c " + url, launches, ragged)
    after = worker_health(group)
    ps0, ps = before["r0"]["kv_ship"], after["r0"]["kv_ship"]
    ds0, ds = before["r1"]["kv_ship"], after["r1"]["kv_ship"]
    pw0, pw = ps0["transport"]["wire"], ps["transport"]["wire"]
    dw0, dw = ds0["transport"]["wire"], ds["transport"]["wire"]
    d = dict(ships=ps["ships"] - ps0["ships"], ship_pages=ps["ship_pages"] - ps0["ship_pages"],
             ship_drops=ps["ship_drops"] - ps0["ship_drops"],
             draft_aborts=ps["draft_aborts"] - ps0["draft_aborts"],
             receives=ds["receives"] - ds0["receives"], hits=ds["hits"] - ds0["hits"],
             recomputes=ds["recomputes"] - ds0["recomputes"],
             dropped=ds["transport"]["dropped"] - ds0["transport"]["dropped"],
             assembly_drops=(ds["transport"]["assembly_drops"]
                             - ds0["transport"]["assembly_drops"]),
             partial_frames=(ds["transport"]["partial_frames"]
                             - ds0["transport"]["partial_frames"]),
             send_failures=pw["send_failures"] - pw0["send_failures"],
             recv_failures=dw["recv_failures"] - dw0["recv_failures"],
             frames=pw["frames_sent"] - pw0["frames_sent"],
             wire_bytes=pw["bytes_sent"] - pw0["bytes_sent"],
             leg_failures=group.ship_leg_failures)
    want = dict(ships=2, ship_drops=0, draft_aborts=0, receives=2, hits=2, recomputes=0,
                dropped=0, assembly_drops=0, send_failures=0, recv_failures=0, leg_failures=0)
    if (any(d[k] != v for k, v in want.items()) or d["ship_pages"] <= 0
            or (ragged and d["partial_frames"] < 1) or d["wire_bytes"] <= 0):
        raise AssertionError("15c {}: ship counters moved by {}".format(url, d))
    ttft = [(arm_runs[("r1", i)]["t_first"] - arm_runs[("r0", i)]["t0"]) * 1e3 for i in ids]
    # a single engine hitting the same prefix length: the prefill worker,
    # which holds the prompts, asked directly, one chat after the other
    direct = [await _direct(pre, GenRequest(prompt_ids=list(i),
                                            max_new_tokens=PROC_DISAGG_TOKENS))
              for i in ids]
    streams = [arm_runs[("r1", i)]["tokens"] for i in ids]
    if streams != direct:
        raise AssertionError("15c {}: the decode worker's streams differ from a hit on the "
                             "prefill worker at tokens {}".format(
                                 url, [first_difference(a, b) for a, b in zip(streams, direct)]))
    out = dict(d, picked_up_s=picked, boot_warm_s=boot_warm_s,
               warm_s=[r.warm_seconds[-1] for r in group.replicas],
               ship_ms=_mean_ms(ps["ship_ms"]), receive_ms=_mean_ms(ds["receive_ms"]),
               rtt_ms=_mean_ms(pw["rtt_ms"]), frame_bytes=d["wire_bytes"] / max(1, d["frames"]),
               ttft_ms=ttft, launches=launches,
               first_difference_from_cold=[first_difference(st, cold[i])
                                           for i, st in zip(ids, streams)],
               ping_ms_max={r.name: max(r.ping_ms_max) for r in group.replicas})
    del group, pre, dec  # the eviction must be the last to hold them
    out["removal"] = await remove_process_fleet(processor, cli, url, card_before)
    return out


async def process_fleet_runs(processor, cli, tok, card: str) -> dict:
    """15a, 15b, the removal and 15c behind the processor's router, each
    logged as it ends."""
    import aiohttp
    from aiohttp import web
    from prometheus_client import REGISTRY, generate_latest

    from clearml_serving_tpu_torch.serving.main import build_app

    single = processor._engine_processor_lookup["single"].engine
    runs = record_fleet([single])
    app = build_app(processor)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    base = "http://127.0.0.1:{}".format(runner.addresses[0][1])
    on_card = torch.device(DEV).type == "cuda"
    block = PROC_BASE["prefix_block"]
    out = {}
    try:
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=900)) as s:
            t0 = time.perf_counter()
            await fleet_chat(s, base, "single", [{"role": "user", "content": "Warm up."}], 4,
                             False)
            _zero_counts(single)
            turns, single_results = await proc_conversations(s, base, "single", tok=tok,
                                                             block=block)
            single_step = single.counters["decode_ms"] / max(1, single.counters["decode_steps"])
            msgs = [[{"role": "user", "content": "Report {}: {}".format(i, fleet_text(
                200 + i, FLEET_DISAGG_CHARS))}] for i in range(2)]
            cold = await asyncio.gather(*[fleet_chat(s, base, "single", m, PROC_DISAGG_TOKENS,
                                                     True) for m in msgs])
            check_chats("15c single", cold, PROC_DISAGG_TOKENS)
            await single.wait_drained()
            cold_ids = {chat_ids(tok, m): runs[(None, chat_ids(tok, m))] for m in msgs}
            out["single"] = dict(step_ms=single_step, s=time.perf_counter() - t0,
                                 cold_ttft_ms=[(r["t_first"] - r["t0"]) * 1e3
                                               for r in cold_ids.values()])
            cold_tokens = {k: r["tokens"] for k, r in cold_ids.items()}
            release_card_memory()
            free, total = torch.cuda.mem_get_info() if on_card else (0, 0)
            mem0 = card_memory() if on_card else 0
            before = (compute_app_rows(), card_used())
            log("  15: before the workers spawn: mem_get_info free {} of {} B, this process "
                "memory_allocated {} B, memory_reserved {} B; nvidia-smi compute processes {} "
                "({})".format(free, total, mem0, torch.cuda.memory_reserved() if on_card else 0,
                              before[0], card))
            picked = await add_endpoint(processor, cli, "fleet", PROC_FLEET)
            t0 = time.perf_counter()
            await fleet_chat(s, base, "fleet", [{"role": "user", "content": "Warm up."}], 4,
                             False)
            boot_warm_s = time.perf_counter() - t0
            group = fleet_of(processor, "fleet")
            record_fleet([r.engine for r in group.replicas], runs)
            await drained(*[r.engine for r in group.replicas])
            mem1 = card_memory() if on_card else 0
            pids = [r.engine.pid for r in group.replicas]
            if len(set(pids)) != 2 or os.getpid() in pids:
                raise AssertionError("15a: worker pids {} (this process {})".format(
                    pids, os.getpid()))
            if mem1 - mem0 >= PROC_PARENT_LIMIT:
                raise AssertionError("15a: this process's memory_allocated rose {} B with the "
                                     "process fleet".format(mem1 - mem0))
            # both workers are compute processes of the card, and its use rose
            # by at least what their caching allocators reserved
            used1, wmem, rows = card_used(), worker_memory(group), compute_app_rows()
            if on_card and (len(rows) != len(before[0]) + 2 or used1 - before[1] < sum(
                    m["reserved"] for m in wmem.values())):
                raise AssertionError("15a: nvidia-smi rows {} (before {}), {} B in use "
                                     "(before {}); the workers reserved {}".format(
                                         rows, before[0], used1, before[1], wmem))
            out["15a"] = a = await proc_15a(s, base, processor, tok, runs, turns,
                                            single_results)
            ready = await (await s.get(base + "/ready")).json()
            health = await (await s.get(base + "/health")).json()
            for doc in (ready, health):
                fleet = doc["fleet"]["fleet"]
                got = {n: (row.get("process") or {}).get("pid")
                       for n, row in fleet["per_replica"].items()}
                if fleet["ring"] != ["r0", "r1"] or got != dict(zip(("r0", "r1"), pids)):
                    raise AssertionError("15a: /ready or /health fleet block {}".format(fleet))
            text = generate_latest(REGISTRY).decode()
            want = ['engine_ready{model="fleet",replica="r0"} 1.0',
                    'engine_ready{model="fleet",replica="r1"} 1.0',
                    'engine_kv_pool_bytes{kind="kv",model="fleet",replica="r1"}',
                    'router_replica_backend{backend="process",model="fleet"} 1.0']
            missing = [w for w in want if w not in text]
            if missing:
                raise AssertionError("15a: the Prometheus export lacks {}".format(missing))
            restarts = [r.restarts for r in group.replicas]
            if any(restarts):
                raise AssertionError("15a: restarts no fault caused: {}".format(restarts))
            a.update(picked_up_s=picked, boot_warm_s=boot_warm_s, pids=pids,
                     rows=[len(before[0]), len(rows)], used=[before[1], used1],
                     worker_memory=wmem,
                     warm_s=[r.warm_seconds[-1] for r in group.replicas],
                     parent_rise=mem1 - mem0, single_step_ms=single_step,
                     ping_ms_max={r.name: max(r.ping_ms_max) for r in group.replicas},
                     exported=want)
            log("  15a: workers {} (this process {}); nvidia-smi's compute process rows {} -> "
                "{}, the card's bytes in use {} -> {}, the workers' allocated/reserved B {}; "
                "this process's "
                "memory_allocated {:+d} B; picked up {:.2f} s after the CLI, first request "
                "(boot and both workers' warmup) {:.2f} s, warm s {}; homes {}, hits {}, ids "
                "and contents equal single's; launches {}; ms a decode step {} on the workers "
                "against {:.3f} on single (phase 14a's replicas in its line); TTFT ms {}; "
                "longest ping ms {} ({})".format(
                    pids, os.getpid(), before[0], rows, before[1], used1,
                    {n: (m.get("allocated"), m.get("reserved")) for n, m in wmem.items()},
                    mem1 - mem0, picked, boot_warm_s,
                    [round(x, 2) for x in a["warm_s"]], a["homes"], a["hits"], a["launches"],
                    {k: round(v, 3) for k, v in a["step_ms"].items()}, single_step,
                    [round(x, 2) for x in a["ttft_ms"]],
                    {k: round(v, 2) for k, v in a["ping_ms_max"].items()}, card))
            del group
            out["15b"] = b = await proc_15b(s, base, processor, tok, runs, block)
            log("  15b: r1's worker {} SIGKILLed mid-stream (victims {}, tokens before the kill "
                "/ after {}); {} failovers to r0, resumed {} s after the death; respawned "
                "(new pid {}, handshake) {:.2f} s, re-warmed in {:.2f} s, back in the ring "
                "{:.2f} s after the death; each continuation equals a fresh request on the "
                "restarted r1; nvidia-smi's compute process rows {} and the card's bytes in "
                "use {} before the kill / after the restart ({})".format(
                    b["pids"][0], b["victims"], b["streams"], b["failovers"],
                    [round(x, 3) for x in b["resume_s"]], b["pids"][1], b["respawn_s"],
                    b["warm_s"], b["rejoin_s"], b["rows"], b["used"], card))
            out["removal"] = r = await remove_process_fleet(processor, cli, "fleet", before)
            log("  removal: group and proxies gone where the release returned ({:.2f} s), "
                "no registry entry, workers {} gone {:.2f} s after the CLI, nvidia-smi's "
                "compute process rows {} and the card's bytes in use {} (before the fleet {} "
                "and {}), the fleet's directory removed ({})".format(
                    r["freed_s"], r["pids"], r["workers_gone_s"], r["rows"], r["used"],
                    len(before[0]), before[1], card))
            roles = {"replica_roles": ["prefill", "decode"]}
            out["15c"] = {}
            for arm, knobs in (("two_dispatch", {}),
                               ("ragged", {"scheduler": "ragged", "step_token_budget": 256})):
                url = "pdisagg" if arm == "two_dispatch" else "pdisagg_ragged"
                out["15c"][arm] = c = await proc_15c(s, base, processor, cli, tok, url,
                                                     dict(PROC_FLEET, **roles, **knobs),
                                                     cold_tokens, before)
                log("  15c {}: ships {} ({} pages, {} frames of {:.0f} B mean, {} partial "
                    "frames received), decode hits {}, drops and wire errors 0; ship_ms {:.3f}, "
                    "send round trip {:.3f} ms, receive_ms {:.3f}; TTFT ms {} disaggregated / "
                    "{} single cold; streams equal a hit on the prefill worker, first "
                    "difference from the cold stream {}; first request {:.2f} s; longest "
                    "ping ms {}; workers gone {:.2f} s after the CLI ({})".format(
                        arm, c["ships"], c["ship_pages"], c["frames"], c["frame_bytes"],
                        c["partial_frames"], c["hits"], c["ship_ms"], c["rtt_ms"],
                        c["receive_ms"], [round(x, 2) for x in c["ttft_ms"]],
                        [round(x, 2) for x in out["single"]["cold_ttft_ms"]],
                        c["first_difference_from_cold"], c["boot_warm_s"],
                        {k: round(v, 2) for k, v in c["ping_ms_max"].items()},
                        c["removal"]["workers_gone_s"], card))
    finally:
        await runner.cleanup()
    return out


def phase_process_fleet(card: str) -> dict:
    """Phase 15 (module docstring): a processor launched with ``single``,
    then the process fleets added and removed by the CLI while it serves."""
    from clearml_serving_tpu_torch.__main__ import cli
    from clearml_serving_tpu_torch.llm.tokenizer import ByteTokenizer
    from clearml_serving_tpu_torch.models.llama import resolve_config
    from clearml_serving_tpu_torch.serving.main import setup_processor
    from clearml_serving_tpu_torch.state import StateStore

    root = state_dir()
    env = {"TPUSERVE_STATE_ROOT": root, "TPUSERVE_POLL_FREQ": str(1.0 / 60)}
    saved = {k: os.environ.get(k) for k in list(env) + ["TPUSERVE_SERVICE_ID"]}
    os.environ.update(env)
    processor = None
    cfg = resolve_config({"preset": PROC_BASE["preset"], **(PROC_BASE.get("config") or {})})
    tok = ByteTokenizer(vocab_size=max(int(cfg["vocab_size"]), 259))
    try:
        for argv in (["create", "--name", "chip-smoke-process-fleet"],
                     ["--yes", "model", "add", "--engine", "llm", "--endpoint", "single",
                      "--aux-config"] + ["engine.{}={}".format(k, json.dumps(v))
                                         for k, v in PROC_BASE.items()]):
            if cli(argv) != 0:
                raise AssertionError("the CLI failed: {}".format(argv))
        os.environ["TPUSERVE_SERVICE_ID"] = StateStore(root).find_service(
            "chip-smoke-process-fleet").id
        processor = setup_processor(device=DEV)
        sync()
        t0 = time.perf_counter()
        out = asyncio.run(process_fleet_runs(processor, cli, tok, card))
        out["runs_s"] = time.perf_counter() - t0
    finally:
        if processor is not None:
            processor.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


# -- phase 16: the model families of the paged path behind the HTTP server --------

# The published configurations (each model's config.json), random weights
# from seed 0. Llama-3.1-8B runs on phase 5's weights (its widths are
# Llama-3-8B's) with its scaled RoPE; Qwen2.5-7B and Gemma-7B at full width
# and FAMILY_LAYERS of their 28 layers, for the script's time.
LLAMA31_8B = {"rope_scaling": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                               "high_freq_factor": 4.0,
                               "original_max_position_embeddings": 8192},
              "max_seq_len": 131072}
FAMILY_LAYERS = 8
QWEN25_7B = dict(vocab_size=152064, dim=3584, n_layers=FAMILY_LAYERS, n_heads=28, n_kv_heads=4,
                 ffn_dim=18944, rope_theta=1000000.0, norm_eps=1e-6, max_seq_len=32768,
                 attn_bias=True)
GEMMA_7B = dict(vocab_size=256000, dim=3072, n_layers=FAMILY_LAYERS, n_heads=16, n_kv_heads=16,
                head_dim=256, ffn_dim=24576, rope_theta=10000.0, norm_eps=1e-6, max_seq_len=8192,
                hidden_act="gelu_pytorch_tanh", tie_embeddings=True, norm_offset=True,
                embed_scale=3072 ** 0.5)


def family_params(config: dict) -> dict:
    """A family's weights on the card from seed 0, byte ids only in its
    logits (as ``llama3_8b_params``): the lm_head's columns past the 256
    byte ids are zeroed, or a tied model's embedding rows."""
    from clearml_serving_tpu_torch.models.llama import init_params

    params = init_params(config, torch.Generator(DEV).manual_seed(0), device=DEV)
    if "lm_head" in params:
        params["lm_head"][:, 256:] = 0
    else:
        params["embed"][256:] = 0
    sync()
    return params


def family_run(model: str, preset: str, config, params, scheduler: str, kv_quant: str,
               weight_quant: str = "") -> dict:
    """One arm of phase 16: phase 5's traffic (two-dispatch, depth 2 with
    graphs) or 5b's (ragged, budget 256) through the processor, its counts
    zeroed just before the traffic and read just after; with the decode
    step's ms beside the least time a step could take, the weights' bytes
    read once over the card's memory rate."""
    if scheduler == "ragged":
        run = phase_ragged_main_path(params, kv_quant, preset, weight_quant, config=config)
        paged, ragged = run["paged_launches"], run["ragged_launches"]
    else:
        run = phase_main_path(params, kv_quant, preset, weight_quant, config=config)
        paged, ragged = run["launches"], 0
    bound_ms = 1e3 * run["weight_bytes"] / CARD_BW
    out = dict(model=model, scheduler=scheduler, kv=kv_quant or "bf16",
               weights=weight_quant or "bf16", weight_bytes=run["weight_bytes"],
               ttft_ms=run["ttft_ms"], step_ms=run["step_ms"],
               ragged_step_ms=run.get("ragged_step_ms"), weight_bound_ms=bound_ms,
               step_over_bound=run["step_ms"] / bound_ms if run["decode_steps"] else None,
               decode_steps=run["decode_steps"], ragged_steps=run.get("ragged_steps", 0),
               paged_launches=paged, ragged_launches=ragged,
               int4_launches=run["int4_launches"], decode_tok_s=run["decode_tok_s"])
    log("  {model} {scheduler} kv={kv} weights={weights}: TTFT {ttft_ms} ms, {step_ms:.2f} ms a "
        "decode step against a {weight_bound_ms:.3f} ms weight-byte bound, launches paged "
        "{paged_launches} ragged {ragged_launches} int4 {int4_launches}".format(**out))
    return out


def phase_families(params, qparams) -> dict:
    """Phase 16: Llama-3.1-8B at full depth in four arms (two-dispatch bf16
    and int8 KV, ragged, int4 weights), Qwen2.5-7B on bf16 and int4 weights
    and Gemma-7B (head_dim 256: both attention kernels at D = 256) on both
    schedulers with bf16 and int8 KV, behind the HTTP server through the
    processor, no fallback: every decode step launches the decode kernel
    once a layer, every ragged step the ragged kernel."""
    from clearml_serving_tpu_torch.ops.quant import quantize_llama_params

    runs = []
    log("  llama3.1-8b: 32 layers, rope_scaling llama3 factor 8 (phase 5's weights)")
    for scheduler, kv, wq, tree in (("two_dispatch", "", "", params),
                                    ("two_dispatch", "int8", "", params),
                                    ("ragged", "", "", params),
                                    ("two_dispatch", "", "int4", qparams)):
        runs.append(family_run("llama3.1-8b", "llama3-8b", LLAMA31_8B, tree, scheduler, kv, wq))
    t0 = time.perf_counter()
    qwen = family_params(QWEN25_7B)
    qwen_q = quantize_llama_params(qwen, bits=4)
    sync()
    log("  qwen2.5-7b: {} of 28 layers at full width, attn_bias; weights and int4 made in "
        "{:.1f} s".format(FAMILY_LAYERS, time.perf_counter() - t0))
    for wq, tree in (("", qwen), ("int4", qwen_q)):
        runs.append(family_run("qwen2.5-7b", "qwen2.5-7b", QWEN25_7B, tree, "two_dispatch", "",
                               wq))
    del qwen, qwen_q
    release_card_memory()
    t0 = time.perf_counter()
    gemma = family_params(GEMMA_7B)
    log("  gemma-7b: {} of 28 layers at full width, head_dim 256, tied, offset norms, GeGLU, "
        "embed_scale sqrt(3072); weights made in {:.1f} s".format(
            FAMILY_LAYERS, time.perf_counter() - t0))
    for scheduler in ("two_dispatch", "ragged"):
        for kv in ("", "int8"):
            runs.append(family_run("gemma-7b", "gemma-7b", GEMMA_7B, gemma, scheduler, kv))
    del gemma
    release_card_memory()

    def gemma_launches(scheduler, kv, key):
        return next(r[key] for r in runs if (r["model"], r["scheduler"], r["kv"]) ==
                    ("gemma-7b", scheduler, kv))
    return dict(runs=runs, launches_d256={
        "paged": gemma_launches("two_dispatch", "bf16", "paged_launches"),
        "paged_int8": gemma_launches("two_dispatch", "int8", "paged_launches"),
        "paged_ragged_path": gemma_launches("ragged", "bf16", "paged_launches"),
        "ragged": gemma_launches("ragged", "bf16", "ragged_launches"),
        "ragged_int8": gemma_launches("ragged", "int8", "ragged_launches")})


# -- phase 17: the jax engine type's bundles -----------------------------------

CARD_F32_FLOPS = 67e12     # H100 SXM float32 FLOP/s outside the tensor cores
BUNDLE_SEQ = 128
IRIS = {"in_dim": 4, "hidden": [64, 64], "out_dim": 3}
MNIST = {"in_hw": [28, 28], "in_ch": 1, "channels": [32, 64], "dense": 128, "out_dim": 10}
MNIST_BUCKETS = [1, 4, 16, 64]
BERT_BASE = {"preset": "bert-base", "dtype": "bfloat16", "num_labels": 9}
DEFAULT_BUCKETS = [1, 2, 4, 8, 16, 32, 64, 128]
BUNDLE_ITERS = 10         # timed calls a key at buckets up to 16, 3 above
# the Llama arm: Llama-3-8B at full width (the embedding and lm_head are
# chunked leaves) cut to 8 of 32 layers
LLAMA_BUNDLE = {"preset": "llama3-8b", "n_layers": 8}
LLAMA_BUNDLE_ENGINE = {"cache": "paged", "max_batch": 4, "max_seq_len": 512,
                       "prefill_buckets": [64, 128], "seed": 0}


def cnn_flops(cfg) -> float:
    """Multiply-adds x 2 of one image through ``models/cnn.py``."""
    h, w = cfg["in_hw"]
    ch, flops = cfg["in_ch"], 0
    for c in cfg["channels"]:
        flops += 2 * h * w * 9 * ch * c
        h, w, ch = h // 2, w // 2, c
    flops += 2 * h * w * ch * cfg["dense"] + 2 * cfg["dense"] * cfg["out_dim"]
    return flops


def bundle_flops(name: str, params, rows: int) -> float:
    """Operations of ``rows`` inputs: 2 x (multiplying parameters) x tokens,
    with BERT's attention products (4 x S^2 x dim a layer) beside them."""
    if name.startswith("mnist"):
        return cnn_flops(MNIST) * rows
    if name == "iris":
        return 2.0 * sum(l["w"].numel() for l in params["layers"]) * rows
    mats = sum(t.numel() for layer in params["layers"] for k, t in layer.items()
               if k in ("wqkv", "wo", "w1", "w2")) + params["classifier"]["w"].numel()
    dim = params["word_embed"].shape[1]
    return (2.0 * mats * rows * BUNDLE_SEQ
            + 4.0 * len(params["layers"]) * rows * BUNDLE_SEQ * BUNDLE_SEQ * dim)


def leaf_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(leaf_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(leaf_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if isinstance(tree, torch.Tensor) else 0


def event_ms(fn, iters: int) -> float:
    """ms a call of ``fn`` on the current stream, by CUDA events around
    ``iters`` calls (host gaps included) after one untimed call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bundle_payloads(slot):
    """The phase's payloads, written on the card from seed-0 weights into
    ``slot(name, filename)`` (a path in the processor's registry): the iris
    MLP, the MNIST CNN as a bundle, a GraphDef and a TorchScript file,
    BERT-base as a bundle and as an ONNX export of the same module (f32).
    Returns ({name: (path, endpoint spec, preprocess file)}, {model:
    (reference-layout tree, bundle)})."""
    from clearml_serving_tpu_torch import models
    from clearml_serving_tpu_torch.engines.importers.graphdef_write import cnn_graphdef
    from clearml_serving_tpu_torch.engines.importers.onnx_export import (
        apply_module,
        export_onnx_bytes,
    )
    from clearml_serving_tpu_torch.engines.jax_engine import save_bundle

    paths, trees = {}, {}
    for name, arch, cfg in (("iris", "mlp", IRIS), ("mnist", "cnn", MNIST),
                            ("bert", "bert", BERT_BASE)):
        bundle = models.build_model(arch, cfg)
        tree = bundle.init(torch.Generator(DEV).manual_seed(0))
        paths[name] = slot(name, name + "-bundle")
        t0 = time.perf_counter()
        n = save_bundle(paths[name], arch, cfg, tree)
        log("  {}: {} bundle {:.1f} MB written in {:.2f} s".format(
            name, arch, n / 1e6, time.perf_counter() - t0))
        trees[name] = (tree, bundle)

    def to_f32(node):
        if isinstance(node, dict):
            return {k: to_f32(v) for k, v in node.items()}
        if isinstance(node, list):
            return [to_f32(v) for v in node]
        return node.float()

    mnist_tree, mnist = trees["mnist"]
    module = apply_module(mnist.apply, mnist.convert_params(mnist_tree, DEV))
    np_tree = {k: [{n: t.cpu().numpy() for n, t in layer.items()} for layer in v]
               for k, v in mnist_tree.items()}
    paths["mnist_graphdef"] = slot("mnist_graphdef", "mnist.graphdef")
    with open(paths["mnist_graphdef"], "wb") as f:
        f.write(cnn_graphdef(np_tree))
    paths["mnist_torchscript"] = slot("mnist_torchscript", "mnist.pt")
    torch.jit.trace(module, torch.rand((1, 28, 28), device=DEV)).save(
        paths["mnist_torchscript"])
    bert_tree, bert = trees["bert"]
    t0 = time.perf_counter()
    ids = torch.zeros((1, BUNDLE_SEQ), dtype=torch.int64, device=DEV)
    onnx_bytes = export_onnx_bytes(
        apply_module(bert.apply, to_f32(bert.convert_params(bert_tree, DEV))), [ids, ids],
        ["input_ids", "attention_mask"])
    paths["bert_onnx"] = slot("bert_onnx", "bert.onnx")
    with open(paths["bert_onnx"], "wb") as f:
        f.write(onnx_bytes)
    log("  bert exported to ONNX on the card (torch's classic exporter, its onnxscript "
        "hook bypassed): {:.1f} MB in {:.1f} s".format(len(onnx_bytes) / 1e6,
                                                       time.perf_counter() - t0))
    del onnx_bytes
    bert_spec = dict(input_name=["input_ids", "attention_mask"], input_size=[[128], [128]],
                     input_type=["int32", "int32"])
    mnist_spec = dict(input_name="image", input_type="float32", input_size=[28, 28],
                      auxiliary_cfg={"batching": {"buckets": MNIST_BUCKETS}})
    preprocess = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "examples", "jax_mnist", "preprocess.py")
    specs = {
        "iris": (dict(input_type="float32", input_size=[4]), None),
        "mnist": (mnist_spec, preprocess),
        "mnist_graphdef": (mnist_spec, preprocess),
        "mnist_torchscript": (dict(mnist_spec, input_name="input_0"), None),
        "bert": (bert_spec, None),
        "bert_onnx": (dict(bert_spec, input_type=["int64", "int64"]), None),
    }
    return {name: (paths[name],) + specs[name] for name in specs}, trees


def bundle_inputs(name: str, rows: int, gen):
    """The HTTP body of ``rows`` inputs of endpoint ``name``."""
    if name == "iris":
        return torch.randn((rows, 4), generator=gen).tolist()
    if name.startswith("mnist"):
        images = torch.rand((rows, 28, 28), generator=gen).tolist()
        return {"input_0" if name.endswith("torchscript") else "image": images}
    ids = torch.randint(0, 30522, (rows, BUNDLE_SEQ), generator=gen)
    mask = torch.ones((rows, BUNDLE_SEQ), dtype=torch.int64)
    mask[:, 96:] = 0
    return {"input_ids": ids.tolist(), "attention_mask": mask.tolist()}


def bundle_reference(name, trees, body, rows):
    """The CPU float32 model's output on the body's inputs (numpy)."""
    from clearml_serving_tpu_torch import models

    import numpy as np

    arch, cfg = {"iris": ("mlp", IRIS), "bert": ("bert", BERT_BASE)}.get(
        name.split("_")[0], ("cnn", MNIST))
    tree, _bundle = trees[name.split("_")[0]]
    cpu = models.build_model(arch, dict(cfg, dtype="float32"))

    def f32(node):
        if isinstance(node, dict):
            return {k: f32(v) for k, v in node.items()}
        if isinstance(node, list):
            return [f32(v) for v in node]
        return node.float().cpu()

    params = cpu.convert_params(f32(tree), "cpu")
    with torch.inference_mode():
        if arch == "bert":
            x = [torch.tensor(body["input_ids"]), torch.tensor(body["attention_mask"])]
        elif arch == "mlp":
            x = [torch.tensor(body, dtype=torch.float32)]
        else:
            x = [torch.tensor(next(iter(body.values())), dtype=torch.float32)]
        return np.asarray(cpu.apply(params, *x)[:rows])


async def bundle_requests(processor, name, buckets, gen):
    """POST one batch of each bucket's size to ``/serve/<name>``; returns
    {bucket: (body, JSON answer)}."""
    from aiohttp.test_utils import TestClient, TestServer

    from clearml_serving_tpu_torch.serving.main import build_app

    client = TestClient(TestServer(build_app(processor)))
    await client.start_server()
    try:
        out = {}
        for b in buckets:
            body = bundle_inputs(name, b, gen)
            r = await client.post("/serve/" + name, json=body)
            if r.status != 200:
                raise AssertionError("{} bucket {}: HTTP {}: {}".format(
                    name, b, r.status, await r.text()))
            out[b] = (body, await r.json())
        return out
    finally:
        await client.close()


def bundle_case(processor, name, buckets, trees, gen) -> list:
    """Every bucket of endpoint ``name`` through the router, then per key:
    the replay and eager ms, capture ms, pool MiB, bound, replay == eager
    bitwise, and the gap to the CPU float32 model."""
    import numpy as np

    proc = processor._get_processor(name)
    runner = proc.engine
    answers = asyncio.run(bundle_requests(processor, name, buckets, gen))
    health = runner.health()
    if health["graph_captures"] != len(buckets):
        raise AssertionError("{}: {} captures for {} buckets".format(
            name, health["graph_captures"], len(buckets)))
    tree, _bundle = trees[name.split("_")[0]]
    bf16 = name == "bert"
    rows = []
    for b in buckets:
        body, answer = answers[b]
        arrays = proc._body_to_arrays(proc.preprocess(body, {}))
        graph, inputs, out = runner.entry(arrays)
        with torch.inference_mode():
            graph.replay()
            replayed = out.clone()
            eager = runner._fn(*inputs)
        bitwise = bool(torch.equal(replayed, eager))
        if not bitwise:
            raise AssertionError("{} bucket {}: the replay is not the eager run's bits".format(
                name, b))
        iters = BUNDLE_ITERS if b <= 16 else 3
        with torch.inference_mode():
            replay_ms = event_ms(graph.replay, iters)
            eager_ms = event_ms(lambda: runner._fn(*inputs), iters)
        key = next(k for k in health["graph_keys"] if k.startswith("b{}:".format(b)))
        flops = bundle_flops(name, tree, b)
        peak = CARD_BF16_FLOPS if bf16 else CARD_F32_FLOPS
        # the ONNX export runs in float32: twice the bundle's bf16 bytes
        weight_bytes = leaf_bytes(tree) * (2 if name == "bert_onnx" else 1)
        ops_ms, bytes_ms = flops / peak * 1e3, weight_bytes / CARD_BW * 1e3
        row = dict(bucket=b, replay_ms=round(replay_ms, 4), eager_ms=round(eager_ms, 4),
                   capture_ms=health["graph_keys"][key]["capture_ms"],
                   pool_mib=round(health["graph_keys"][key]["pool_bytes"] / 2 ** 20, 2),
                   bound_ms=round(max(ops_ms, bytes_ms), 5),
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                   bitwise=bitwise)
        if not name.startswith("bert") or b <= 2:
            want = bundle_reference(name, trees, body, b)
            got = replayed.float().cpu().numpy()[:b]
            gap = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
            limit = 0.05 if bf16 else 1e-3
            if not gap <= limit:
                raise AssertionError("{} bucket {}: relative gap {} to the CPU float32 "
                                     "model over {}".format(name, b, gap, limit))
            row["rel_gap_cpu_f32"] = gap
        if name.startswith("mnist") and not name.endswith("torchscript"):
            row["answer"] = {"digit": answer["digit"]}
        rows.append(row)
        log("  {} b{}: replay {:.4f} ms, eager {:.4f} ms, capture {:.1f} ms, pool {:.2f} MiB, "
            "bound {:.5f} ms ({}), gap {}".format(
                name, b, row["replay_ms"], row["eager_ms"], row["capture_ms"], row["pool_mib"],
                row["bound_ms"], row["bound_by"], row.get("rel_gap_cpu_f32", "-")))
    return rows


def llama_bundle_arm(card: str) -> dict:
    """A Llama-3-8B bundle at full width, 8 of 32 layers, written by the
    port's save_bundle into a processor's registry and served through an
    ``llm`` endpoint; greedy content and token ids byte-identical to the
    same seed's preset engine at 8 layers, under both schedulers."""
    import shutil

    from clearml_serving_tpu_torch.engines.jax_engine import save_bundle
    from clearml_serving_tpu_torch.llm.openai_api import build_engine
    from clearml_serving_tpu_torch.models.llama import init_params
    from clearml_serving_tpu_torch.serving.endpoints import ModelEndpoint
    from clearml_serving_tpu_torch.serving.main import build_app
    from clearml_serving_tpu_torch.serving.model_request_processor import (
        ModelRequestProcessor,
    )

    root = state_dir()
    out = {}
    try:
        processor = ModelRequestProcessor(state_root=root, force_create=True, name="llama-b",
                                          device=DEV)
        rec = processor.registry.register("llama3-8b 8 layers", framework="jax")
        bundle_dir = os.path.join(str(rec.files_dir), "llama3-8b-8l")
        t0 = time.perf_counter()
        params = init_params(LLAMA_BUNDLE, torch.Generator(DEV).manual_seed(0), device=DEV)
        sync()
        made_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["bytes"] = save_bundle(bundle_dir, "llama", LLAMA_BUNDLE, params)
        out["write_s"] = round(time.perf_counter() - t0, 2)
        del params
        release_card_memory()
        log("  llama3-8b bundle, 8 layers: {:.3f} GB (weights made in {:.1f} s), written in "
            "{:.2f} s; free disk {:.1f} GB".format(
                out["bytes"] / 1e9, made_s, out["write_s"],
                shutil.disk_usage(bundle_dir).free / 1e9))
        bodies = [{"model": "", "messages": [{"role": "user", "content": p}], "max_tokens": 16,
                   "logprobs": True, "top_logprobs": 1, "return_tokens_as_token_ids": True}
                  for p in PROMPTS[:3]]
        for scheduler in ("two_dispatch", "ragged"):
            knobs = dict(LLAMA_BUNDLE_ENGINE, scheduler=scheduler)
            if scheduler == "ragged":
                knobs["step_token_budget"] = 256
            url = "bundle-" + scheduler
            processor.add_endpoint(ModelEndpoint(engine_type="llm", serving_url=url,
                                                 model_id=rec.id,
                                                 auxiliary_cfg={"engine": knobs}))
            processor.serialize()
            processor.deserialize(skip_sync=True)
            t0 = time.perf_counter()
            proc = processor._get_processor(url)
            sync()
            load_s = round(time.perf_counter() - t0, 2)
            got = asyncio.run(chat_bodies(build_app(processor), url, bodies))
            preset = dict(knobs, preset=LLAMA_BUNDLE["preset"],
                          config={k: v for k, v in LLAMA_BUNDLE.items() if k != "preset"})
            engine, tok = build_engine(preset, device=DEV)
            want = asyncio.run(chat_bodies(processor_app(engine, tok, url), url, bodies))
            if got != want:
                raise AssertionError("llama bundle under {}: {} against the preset engine's "
                                     "{}".format(scheduler, got, want))
            out[scheduler] = dict(load_s=load_s, tokens=[len(ids) for _t, ids in got],
                                  content=[text[:16] for text, _ids in got])
            log("  {}: bundle loaded through the llm endpoint in {:.2f} s; greedy content and "
                "token ids byte-identical to the preset engine's ({} tokens)".format(
                    scheduler, load_s, out[scheduler]["tokens"]))
            # both apps stopped their engines at cleanup
            processor._engine_processor_lookup.pop(url, None)
            processor.remove_endpoint(url)
            processor.serialize()
            del proc, engine
            release_card_memory()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


async def chat_bodies(app, url, bodies) -> list:
    """(content, token ids) of each chat body POSTed to ``app`` as ``url``."""
    from aiohttp.test_utils import TestClient, TestServer

    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        out = []
        for body in bodies:
            r = await client.post("/serve/openai/v1/chat/completions",
                                  json=dict(body, model=url))
            if r.status != 200:
                raise AssertionError("HTTP {}: {}".format(r.status, await r.text()))
            choice = (await r.json())["choices"][0]
            out.append((choice["message"]["content"],
                        [e["token"] for e in choice["logprobs"]["content"]]))
        return out
    finally:
        await client.close()


def phase_bundle_engines(card: str) -> dict:
    """Phase 17: the ``jax`` engine type behind the port's processor: the
    iris MLP, the MNIST CNN (bundle, GraphDef, TorchScript; the example's
    endpoint, buckets and preprocess.py), BERT-base at full width in bf16
    (sequence 128, the default buckets) and its ONNX export through the
    ONNX importer; one CUDA graph per bucket key, each replay bitwise the
    eager run, no fallback. Then the Llama bundle arm."""
    import shutil

    from clearml_serving_tpu_torch.serving.endpoints import ModelEndpoint
    from clearml_serving_tpu_torch.serving.model_request_processor import (
        ModelRequestProcessor,
    )

    root = state_dir()
    results = {}
    try:
        processor = ModelRequestProcessor(state_root=root, force_create=True, name="bundles",
                                          device=DEV)
        records = {}

        def slot(name, filename):
            records[name] = processor.registry.register(name, framework="jax")
            return os.path.join(str(records[name].files_dir), filename)

        payloads, trees = bundle_payloads(slot)
        for name, (_path, spec, preprocess) in payloads.items():
            processor.add_endpoint(ModelEndpoint(engine_type="jax", serving_url=name,
                                                 model_id=records[name].id, **spec),
                                   preprocess_code=preprocess)
        processor.serialize()
        processor.deserialize(skip_sync=True)
        gen = torch.Generator().manual_seed(17)
        for name in payloads:
            buckets = MNIST_BUCKETS if name.startswith("mnist") else DEFAULT_BUCKETS
            t0 = time.perf_counter()
            results[name] = bundle_case(processor, name, buckets, trees, gen)
            log("  ({} in {:.1f} s)".format(name, time.perf_counter() - t0))
        # the ONNX export's logits against the native bundle's, bucket by bucket
        import numpy as np

        for b in (1, 2):
            body = bundle_inputs("bert", b, torch.Generator().manual_seed(b))
            native = processor._get_processor("bert").process(body, {})
            onnx = processor._get_processor("bert_onnx").process(
                {k: np.asarray(v, np.int64) for k, v in body.items()}, {})
            gap = float(np.abs(onnx - native).max() / np.abs(onnx).max())
            if not gap <= 0.05:
                raise AssertionError("bert onnx vs native bundle: relative gap {}".format(gap))
            results.setdefault("bert_onnx_vs_native", []).append(dict(bucket=b, rel_gap=gap))
        del processor
        release_card_memory()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    results["llama"] = llama_bundle_arm(card)
    return results


# -- phase 18: BERT's two routes: the engine server (jax_grpc), the encoder ----

GRPC_URL = "transformer_model"      # the BERT example's endpoint
GRPC_ROWS = 256                     # one-row requests per concurrency
GRPC_CONCURRENCY = [1, 8, 32, 64]
GRPC_BATCHING = ["batching.preferred_batch_size=16", "batching.max_queue_delay_us=5000"]
GRPC_POLL_MIN = 0.01                # the engine server's TPUSERVE_POLL_FREQ (0.6 s)
GRPC_LOGIT_TOL = 2e-2
GRPC_MEMORY_SLACK = 64 << 20
GRPC_SWAP_EXTRA = 128               # answers after the first from the new version
GRPC_START_S = 240.0                # an engine server's limit to serve its model
# the router's channel reconnects soon after a restarted server comes back
# (gRPC's own first reconnect backoff is 1 s, growing to 120 s)
GRPC_CHANNEL_ENV = {"TPUSERVE_GRPC_INITIAL_RECONNECT_BACKOFF_MS": "100",
                    "TPUSERVE_GRPC_MAX_RECONNECT_BACKOFF_MS": "500"}
ENCODER_URL = "bert_embed"
ENCODER_TOKENS = (16, 512)          # the byte tokenizer's ids a text (BOS included)
ENCODER_ITERS = 5


def free_port() -> int:
    import socket

    with contextlib.closing(socket.socket(socket.AF_INET, socket.SOCK_STREAM)) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def grpc_bodies(n: int, seed: int) -> list:
    """``n`` one-row bodies of the example's I/O spec: ids over BERT's
    vocabulary, real lengths 16-128 drawn from ``seed``, the rest masked."""
    gen = torch.Generator().manual_seed(seed)
    vocab = int(BERT_BASE.get("vocab_size", 30522))
    out = []
    for _ in range(n):
        length = int(torch.randint(16, 129, (1,), generator=gen))
        ids = torch.zeros(BUNDLE_SEQ, dtype=torch.int64)
        ids[:length] = torch.randint(0, vocab, (length,), generator=gen)
        mask = (torch.arange(BUNDLE_SEQ) < length).long()
        out.append({"input_ids": [ids.tolist()], "attention_mask": [mask.tolist()]})
    return out


class EngineServerProcess:
    """``tpu-serving-torch-engine`` as a child process of this script (its
    output in ``build/engine_server.log``), on the card unless DEV says
    otherwise."""

    def __init__(self, root: str, service_id: str, port: int, metrics_port: int):
        self.port, self.metrics_port = port, metrics_port
        self.addr = "127.0.0.1:{}".format(port)
        here = os.path.dirname(os.path.abspath(__file__))
        self.log_path = os.path.join(here, "build", "engine_server.log")
        open(self.log_path, "w").close()  # this phase's server only (a restart appends)
        self.env = dict(os.environ, TPUSERVE_STATE_ROOT=root, TPUSERVE_SERVICE_ID=service_id,
                        TPUSERVE_ENGINE_PORT=str(port),
                        TPUSERVE_ENGINE_METRICS_PORT=str(metrics_port),
                        TPUSERVE_POLL_FREQ=str(GRPC_POLL_MIN),
                        PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.proc = None

    def start(self) -> None:
        log_file = open(self.log_path, "a")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "clearml_serving_tpu_torch.engine_server.server",
             "--device", str(DEV)], env=self.env, stdout=log_file, stderr=subprocess.STDOUT)
        log_file.close()

    def status(self, timeout: float = 5.0) -> dict:
        import grpc

        from clearml_serving_tpu_torch.engine_server import protocol

        with grpc.insecure_channel(self.addr) as channel:
            call = channel.unary_unary(protocol.STATUS_METHOD)
            return protocol.decode_obj(call(b"", timeout=timeout))

    def wait_serving(self, want_model_id: str, limit: float = GRPC_START_S) -> dict:
        """Poll ``Status`` until the endpoint serves ``want_model_id``."""
        t0 = time.perf_counter()
        while True:
            if self.proc.poll() is not None:
                raise AssertionError("the engine server exited with {}: {}".format(
                    self.proc.returncode, self.log_tail()))
            try:
                status = self.status()
                model = status["models"].get(GRPC_URL)
                if model is not None and model["model_id"] == want_model_id:
                    return status
            except Exception:
                pass
            if time.perf_counter() - t0 > limit:
                raise AssertionError("the engine server did not serve {} in {} s: {}".format(
                    want_model_id, limit, self.log_tail()))
            time.sleep(0.1)

    def metrics(self) -> dict:
        """The sidecar's samples: {(name, sorted labels): value}."""
        import urllib.request

        from prometheus_client.parser import text_string_to_metric_families

        with urllib.request.urlopen("http://127.0.0.1:{}/metrics".format(self.metrics_port),
                                    timeout=5) as r:
            text = r.read().decode()
        out = {}
        for family in text_string_to_metric_families(text):
            for s in family.samples:
                out[(s.name, tuple(sorted(s.labels.items())))] = s.value
        return out

    def kill(self) -> None:
        import signal

        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(30)

    def stop(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(15)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(15)

    def log_tail(self, n: int = 4000) -> str:
        try:
            with open(self.log_path) as f:
                return f.read()[-n:]
        except OSError:
            return ""


def batch_rows(metrics: dict) -> dict:
    return {kind: metrics.get(("engine_batch_rows_total", (("kind", kind),
                                                            ("model", GRPC_URL))), 0.0)
            for kind in ("real", "padded")}


def queue_delay_buckets(metrics: dict) -> dict:
    """The sidecar's queue-delay histogram: cumulative count per bound."""
    out = {}
    for (name, labels), value in metrics.items():
        d = dict(labels)
        if name == "engine_queue_delay_seconds_bucket" and d.get("model") == GRPC_URL:
            out[d["le"]] = value
    return dict(sorted(out.items(), key=lambda kv: float(kv[0])))


def model_counts(status: dict) -> dict:
    m = status["models"][GRPC_URL]
    keys = ("requests_served", "batches_executed", "rows_executed", "padded_rows",
            "graph_captures", "graph_replays", "eager_runs")
    return {k: int(m[k]) for k in keys}


def check_served_on_the_card(label: str, status: dict) -> None:
    m = status["models"][GRPC_URL]
    if m["graph_captures"] != len(m["graph_keys"]):
        raise AssertionError("{}: {} captures for {} keys: a capture after a key's first "
                             "batch".format(label, m["graph_captures"], m["graph_keys"]))
    if torch.device(DEV).type == "cuda":
        if m["eager_runs"] or not m["graph_replays"]:
            raise AssertionError("{}: {} eager runs, {} replays: a batch ran off the "
                                 "graphs".format(label, m["eager_runs"], m["graph_replays"]))
        if not status.get("memory_allocated"):
            raise AssertionError("{}: the engine server reports no card: {}".format(
                label, status.get("devices")))


def percentile(values, q: float) -> float:
    vals = sorted(values)
    return vals[min(len(vals) - 1, int(round(q * (len(vals) - 1))))]


async def grpc_traffic(client, bodies, concurrency: int, stop=None, on_answer=None) -> dict:
    """POST ``bodies`` to ``/serve/<GRPC_URL>`` with ``concurrency`` in
    flight (round and round until ``stop`` is set, when given). Returns the
    statuses, latencies, wall seconds and the answers by body index."""
    import itertools

    order = itertools.count()
    statuses, lat, answers = {}, [], {}

    async def worker():
        while True:
            i = next(order)
            if stop is None and i >= len(bodies):
                return
            if stop is not None and stop.is_set():
                return
            t0 = time.perf_counter()
            r = await client.post("/serve/" + GRPC_URL, json=bodies[i % len(bodies)])
            body = await r.json()
            t1 = time.perf_counter()
            statuses[r.status] = statuses.get(r.status, 0) + 1
            if r.status == 200:
                lat.append(t1 - t0)
                answers[i] = body
            if on_answer is not None:
                on_answer(i, r.status, body, t1)
            if r.status != 200 and stop is not None:
                await asyncio.sleep(0.05)

    t0 = time.perf_counter()
    await asyncio.gather(*[worker() for _ in range(concurrency)])
    wall = time.perf_counter() - t0
    return dict(statuses=statuses, latencies=lat, wall_s=wall, answers=answers)


def grpc_check_answers(bodies, answers, local, bitwise_rows: set) -> dict:
    """Each answer's logits against the port's ``jax`` endpoint's on the
    same row (``local``: index -> logits, run alone, bucket 1)."""
    import numpy as np

    worst, bitwise, compared = 0.0, 0, 0
    for i, ans in answers.items():
        want = local[i % len(bodies)]
        got = np.asarray(ans, np.float32)
        if got.shape != want.shape:
            raise AssertionError("answer {} has shape {}, want {}".format(i, got.shape,
                                                                           want.shape))
        if not np.allclose(got, want, atol=GRPC_LOGIT_TOL, rtol=GRPC_LOGIT_TOL):
            raise AssertionError("answer {}: logits {} off the jax endpoint's".format(
                i, float(np.abs(got - want).max())))
        worst = max(worst, float(np.abs(got - want).max()))
        compared += 1
        if i in bitwise_rows:
            bitwise += int(np.array_equal(got, want))
    return dict(compared=compared, max_abs_err=worst, bitwise=bitwise,
                bitwise_of=len(bitwise_rows & set(answers)))


def concurrency_row(c, run, counts0, counts1, rows0, rows1, checked) -> dict:
    lat = run["latencies"]
    batches = counts1["batches_executed"] - counts0["batches_executed"]
    rows = counts1["rows_executed"] - counts0["rows_executed"]
    return dict(
        concurrency=c, requests=len(lat), statuses=run["statuses"],
        req_per_s=round(len(lat) / run["wall_s"], 2),
        p50_ms=round(1e3 * percentile(lat, 0.5), 3), p99_ms=round(1e3 * percentile(lat, 0.99), 3),
        batches=batches, mean_rows=round(rows / max(batches, 1), 3),
        padded_rows=counts1["padded_rows"] - counts0["padded_rows"],
        sidecar_real=rows1["real"] - rows0["real"], sidecar_padded=rows1["padded"] - rows0["padded"],
        captures=counts1["graph_captures"] - counts0["graph_captures"], **checked)


async def grpc_phase_runs(processor, server, cli, record_ids) -> dict:
    """18a-18c over one router app (the script's processor, ``build_app``)."""
    from aiohttp.test_utils import TestClient, TestServer

    import numpy as np

    from clearml_serving_tpu_torch.engines import grpc_client
    from clearml_serving_tpu_torch.serving.main import build_app

    out = {}
    bodies = grpc_bodies(GRPC_ROWS, 18)
    local_proc = processor._get_processor("bert_local")
    local = {i: np.asarray(local_proc.process(dict(b), {}), np.float32)
             for i, b in enumerate(bodies)}
    client = TestClient(TestServer(build_app(processor)))
    await client.start_server()
    try:
        # 18a: the example's traffic at each concurrency
        rows = []
        for c in GRPC_CONCURRENCY:
            s0 = await asyncio.to_thread(server.status)
            m0 = await asyncio.to_thread(server.metrics)
            run = await grpc_traffic(client, bodies, c)
            s1 = await asyncio.to_thread(server.status)
            m1 = await asyncio.to_thread(server.metrics)
            if run["statuses"] != {200: len(bodies)}:
                raise AssertionError("18a concurrency {}: statuses {}".format(c, run["statuses"]))
            check_served_on_the_card("18a c{}".format(c), s1)
            # alone in its batch at concurrency 1: the bucket the jax endpoint ran
            checked = grpc_check_answers(bodies, run["answers"], local,
                                         set(run["answers"]) if c == 1 else set())
            row = concurrency_row(c, run, model_counts(s0), model_counts(s1),
                                  batch_rows(m0), batch_rows(m1), checked)
            rows.append(row)
            log("  18a c{concurrency}: {req_per_s} req/s, p50 {p50_ms} ms, p99 {p99_ms} ms; "
                "{batches} batches, {mean_rows} rows a batch, {padded_rows} padded rows "
                "(sidecar: {sidecar_real} real, {sidecar_padded} padded); captures {captures}; "
                "logits within {max_abs_err:.3g} of the jax endpoint's, {bitwise} of "
                "{bitwise_of} bitwise".format(**row))
        status = await asyncio.to_thread(server.status)
        m = status["models"][GRPC_URL]
        out["18a"] = dict(rows=rows, graph_keys=m["graph_keys"],
                          graph_pool_mib=round(m["graph_pool_bytes"] / 2 ** 20, 2),
                          queue_delay=queue_delay_buckets(await asyncio.to_thread(server.metrics)),
                          devices=status["devices"],
                          memory_allocated=status.get("memory_allocated"))
        log("  18a: keys {}, pool {} MiB; queue-delay histogram (cumulative, s): {}".format(
            m["graph_keys"], out["18a"]["graph_pool_mib"], out["18a"]["queue_delay"]))

        # 18b: a second version published by the CLI under concurrency-32 traffic
        before = status.get("memory_allocated", 0)
        stop = asyncio.Event()
        seen = {"changed_at": None, "after": 0}

        def on_answer(i, code, body, t1):
            if code != 200:
                return
            got = np.asarray(body, np.float32)
            if float(np.abs(got - local[i % len(bodies)]).max()) > 0.5:
                if seen["changed_at"] is None:
                    seen["changed_at"] = t1
                seen["after"] += 1
                if seen["after"] >= GRPC_SWAP_EXTRA:
                    stop.set()

        traffic = asyncio.ensure_future(grpc_traffic(client, bodies, 32, stop=stop,
                                                     on_answer=on_answer))
        await asyncio.sleep(0.5)
        t_cli = time.perf_counter()
        argv = ["--yes", "model", "add", "--engine", "jax_grpc", "--endpoint", GRPC_URL,
                "--model-id", record_ids[1], "--input-name", "input_ids", "attention_mask",
                "--input-type", "int32", "int32", "--input-size", "[128]", "[128]",
                "--output-name", "logits", "--output-type", "float32",
                "--aux-config"] + GRPC_BATCHING
        if await asyncio.to_thread(cli, argv) != 0:
            raise AssertionError("the CLI failed: {}".format(argv))
        try:
            await asyncio.wait_for(asyncio.shield(traffic), GRPC_START_S)
        except asyncio.TimeoutError:
            stop.set()
            raise AssertionError("18b: no answer from the new version in {} s".format(
                GRPC_START_S))
        run = traffic.result()
        if set(run["statuses"]) != {200}:
            raise AssertionError("18b: statuses {} under the swap".format(run["statuses"]))
        t_seen = time.perf_counter()
        while True:
            status = await asyncio.to_thread(server.status)
            after = status.get("memory_allocated", 0)
            if status["models"][GRPC_URL]["model_id"] == record_ids[1] and \
                    after - before <= GRPC_MEMORY_SLACK:
                break
            if time.perf_counter() - t_seen > 30:
                raise AssertionError("18b: the server's memory_allocated is {} MiB over the "
                                     "level before the swap".format((after - before) / 2 ** 20))
            await asyncio.sleep(0.1)
        check_served_on_the_card("18b", status)
        out["18b"] = dict(requests=sum(run["statuses"].values()), statuses=run["statuses"],
                          cli_to_new_s=round(seen["changed_at"] - t_cli, 3),
                          memory_before_mib=round(before / 2 ** 20, 1),
                          memory_after_mib=round(after / 2 ** 20, 1),
                          reserved_after_mib=round(status.get("memory_reserved", 0) / 2 ** 20, 1))
        log("  18b: {} requests under the swap, all 200; {} s from the CLI change to the first "
            "answer of the new version; the server's memory_allocated {} MiB before, {} MiB "
            "after the old model's release (reserved {} MiB)".format(
                out["18b"]["requests"], out["18b"]["cli_to_new_s"],
                out["18b"]["memory_before_mib"], out["18b"]["memory_after_mib"],
                out["18b"]["reserved_after_mib"]))

        # 18c: SIGKILL under traffic; retries, then 503s; a restart
        retry0 = dict(grpc_client.RETRY_STATS)
        stop = asyncio.Event()
        marks = {"killed": None, "first_ok_after": None}

        def on_kill_answer(i, code, body, t1):
            if marks["killed"] is not None and code == 200 and marks["first_ok_after"] is None \
                    and t1 > marks["restarted"]:
                marks["first_ok_after"] = t1
                asyncio.get_running_loop().call_later(0.5, stop.set)

        marks["restarted"] = float("inf")
        traffic = asyncio.ensure_future(grpc_traffic(client, bodies, 8, stop=stop,
                                                     on_answer=on_kill_answer))
        await asyncio.sleep(0.5)
        marks["killed"] = time.perf_counter()
        await asyncio.to_thread(server.kill)
        await asyncio.sleep(1.0)  # in-flight calls exhaust their retries meanwhile
        t_restart = time.perf_counter()
        marks["restarted"] = t_restart
        server.start()
        try:
            await asyncio.wait_for(asyncio.shield(traffic), GRPC_START_S)
        except asyncio.TimeoutError:
            stop.set()
            raise AssertionError("18c: not served again {} s after the restart: {}".format(
                GRPC_START_S, server.log_tail()))
        run = traffic.result()
        retries = {k: grpc_client.RETRY_STATS[k] - retry0[k] for k in retry0}
        if set(run["statuses"]) - {200, 503} or not run["statuses"].get(503):
            raise AssertionError("18c: statuses {} across the kill".format(run["statuses"]))
        if not retries["retries"] or not retries["exhausted"]:
            raise AssertionError("18c: retry counts {}".format(retries))
        status = await asyncio.to_thread(server.status)
        check_served_on_the_card("18c", status)
        out["18c"] = dict(statuses=run["statuses"], retries=retries,
                          restart_to_served_s=round(marks["first_ok_after"] - t_restart, 3),
                          kill_to_served_s=round(marks["first_ok_after"] - marks["killed"], 3))
        log("  18c: statuses across the SIGKILL {}, client retries {}; served again {} s after "
            "the restart ({} s after the kill)".format(
                run["statuses"], retries, out["18c"]["restart_to_served_s"],
                out["18c"]["kill_to_served_s"]))
    finally:
        await client.close()
    return out


def phase_engine_server(card: str) -> dict:
    """18a-18c: the BERT example's topology. A BERT-base bundle (seed 0)
    registered by the CLI as the ``jax_grpc`` endpoint of the example's
    I/O spec and batching knobs, served by ``tpu-serving-torch-engine`` in
    its own process on the card; this process is the router."""
    import shutil

    from clearml_serving_tpu_torch.__main__ import cli
    from clearml_serving_tpu_torch.engines.jax_engine import save_bundle
    from clearml_serving_tpu_torch import models
    from clearml_serving_tpu_torch.serving.model_request_processor import (
        ModelRequestProcessor,
    )
    from clearml_serving_tpu_torch.state import StateStore

    root = state_dir()
    saved = {k: os.environ.get(k) for k in ["TPUSERVE_STATE_ROOT", "TPUSERVE_SERVICE_ID"]
             + list(GRPC_CHANNEL_ENV)}
    os.environ.update(GRPC_CHANNEL_ENV, TPUSERVE_STATE_ROOT=root)
    server = None
    try:
        paths = []
        bundle = models.build_model("bert", BERT_BASE)
        for seed in (0, 1):
            path = os.path.join(root, "bert-base-seed{}".format(seed))
            tree = bundle.init(torch.Generator(DEV).manual_seed(seed))
            save_bundle(path, "bert", BERT_BASE, tree)
            paths.append(path)
            del tree
        release_card_memory()
        port, metrics_port = free_port(), free_port()
        steps = [["create", "--name", "chip-smoke-bert"],
                 ["--yes", "config", "--engine-grpc-server", "127.0.0.1:{}".format(port)],
                 ["--yes", "model", "upload", "--name", "bert ner v1", "--framework", "jax",
                  "--path", paths[0]],
                 ["--yes", "model", "upload", "--name", "bert ner v2", "--framework", "jax",
                  "--path", paths[1]]]
        for argv in steps:
            if cli(argv) != 0:
                raise AssertionError("the CLI failed: {}".format(argv))
        service_id = StateStore(root).find_service("chip-smoke-bert").id
        os.environ["TPUSERVE_SERVICE_ID"] = service_id
        reader = ModelRequestProcessor(state_root=root, service_id=service_id, device=DEV)
        record_ids = [reader.registry.query(name=name, max_results=1)[0].id
                      for name in ("bert ner v1", "bert ner v2")]
        spec = ["--input-name", "input_ids", "attention_mask", "--input-type", "int32", "int32",
                "--input-size", "[128]", "[128]", "--output-name", "logits",
                "--output-type", "float32"]
        for argv in (["--yes", "model", "add", "--engine", "jax_grpc", "--endpoint", GRPC_URL,
                      "--model-id", record_ids[0]] + spec + ["--aux-config"] + GRPC_BATCHING,
                     # the same bundle served in this process: the logits' yardstick
                     ["--yes", "model", "add", "--engine", "jax", "--endpoint", "bert_local",
                      "--model-id", record_ids[0]] + spec):
            if cli(argv) != 0:
                raise AssertionError("the CLI failed: {}".format(argv))
        server = EngineServerProcess(root, service_id, port, metrics_port)
        t0 = time.perf_counter()
        server.start()
        status = server.wait_serving(record_ids[0])
        start_s = time.perf_counter() - t0
        log("  engine server up in {:.1f} s on {} ({} device(s)), memory_allocated {:.1f} "
            "MiB, keys {}".format(start_s, status["devices"], status["device_count"],
                                  status.get("memory_allocated", 0) / 2 ** 20,
                                  status["models"][GRPC_URL]["graph_keys"]))
        processor = ModelRequestProcessor(state_root=root, service_id=service_id, device=DEV)
        processor.deserialize(skip_sync=True)
        out = asyncio.run(grpc_phase_runs(processor, server, cli, record_ids))
        out["start_s"] = round(start_s, 2)
        del processor
        release_card_memory()
        return out
    finally:
        if server is not None:
            server.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)


def encoder_texts(n: int, seed: int, lo: int, hi: int) -> list:
    """``n`` texts of ``lo``-``hi`` byte-tokenizer ids each (BOS included)."""
    gen = torch.Generator().manual_seed(seed)
    letters = "abcdefghijklmnopqrstuvwxyz     "
    out = []
    for _ in range(n):
        length = int(torch.randint(lo, hi + 1, (1,), generator=gen)) - 1
        idx = torch.randint(0, len(letters), (length,), generator=gen)
        out.append("".join(letters[int(i)] for i in idx))
    return out


async def encoder_requests(processor) -> dict:
    from aiohttp.test_utils import TestClient, TestServer

    from clearml_serving_tpu_torch.serving.main import build_app

    lo, hi = ENCODER_TOKENS
    calls = {
        "embeddings": {"input": encoder_texts(1, 1, lo, lo + 8) + encoder_texts(
            5, 2, lo, hi - 1) + encoder_texts(1, 3, hi, hi)},
        "embeddings_short": {"input": encoder_texts(3, 4, lo, 100)},
        "pooling": {"input": encoder_texts(2, 5, 64, 128), "return_token_states": True},
        "classify": {"input": encoder_texts(4, 6, lo, 64)},
        "score": {"text_1": encoder_texts(1, 7, 32, hi // 2)[0],
                  "text_2": encoder_texts(3, 8, 32, hi // 2)},
        "rerank": {"query": encoder_texts(1, 9, lo, 64)[0],
                   "documents": encoder_texts(5, 10, 32, hi // 2), "top_n": 3},
    }
    client = TestClient(TestServer(build_app(processor)))
    await client.start_server()
    try:
        out = {}
        for name, body in calls.items():
            route = name.split("_")[0]
            t0 = time.perf_counter()
            r = await client.post("/serve/openai/v1/" + route,
                                  json=dict(body, model=ENCODER_URL))
            answer = await r.json()
            if r.status != 200:
                raise AssertionError("18d {}: HTTP {}: {}".format(name, r.status, answer))
            out[name] = dict(body=body, answer=answer,
                             ms=round(1e3 * (time.perf_counter() - t0), 3))
        r = await client.post("/serve/openai/v1/chat/completions", json={
            "model": ENCODER_URL, "messages": [{"role": "user", "content": "x"}]})
        if r.status != 422:
            raise AssertionError("18d: chat on the encoder endpoint answered {}".format(r.status))
        return out
    finally:
        await client.close()


def phase_encoder_routes(card: str) -> dict:
    """18d: BERT-base (bf16, seed 0) as an ``llm`` endpoint with ``task:
    embed``; the five encoder routes over texts of 16-512 byte-tokenizer
    ids; per (function, batch, seq) key the replay and eager ms and the
    pool; the gap to the CPU float32 port on the same weights."""
    import shutil

    import numpy as np

    from clearml_serving_tpu_torch import models
    from clearml_serving_tpu_torch.llm.encoder import EncoderCore
    from clearml_serving_tpu_torch.serving.endpoints import ModelEndpoint
    from clearml_serving_tpu_torch.serving.model_request_processor import (
        ModelRequestProcessor,
    )

    root = state_dir()
    try:
        processor = ModelRequestProcessor(state_root=root, force_create=True, name="encoder",
                                          device=DEV)
        engine = {"arch": "bert", "preset": BERT_BASE["preset"], "task": "embed", "seed": 0,
                  "config": {k: v for k, v in BERT_BASE.items() if k != "preset"}}
        processor.add_endpoint(ModelEndpoint(engine_type="llm", serving_url=ENCODER_URL,
                                             auxiliary_cfg={"engine": engine}))
        processor.serialize()
        processor.deserialize(skip_sync=True)
        t0 = time.perf_counter()
        enc = processor._get_processor(ENCODER_URL).encoder
        sync()
        load_s = time.perf_counter() - t0
        answers = asyncio.run(encoder_requests(processor))
        health = enc.health()
        if torch.device(DEV).type == "cuda" and (health["eager_runs"] or
                                                 health["graph_captures"] !=
                                                 len(health["graph_keys"])):
            raise AssertionError("18d: {} eager runs, {} captures for {} keys".format(
                health["eager_runs"], health["graph_captures"], len(health["graph_keys"])))
        keys = []
        for label, key in health["graph_keys"].items():
            name, shape = label.split(":", 1)
            b, s = (int(d) for d in shape.split(":")[1].split(",")[0][:-len("int32")].split("x"))
            runner = enc.runner(name)
            arrays = [np.zeros((b, s), np.int32), np.zeros((b, s), np.int32)]
            graph, inputs, _out = runner.entry(arrays)
            with torch.inference_mode():
                replay_ms = event_ms(graph.replay, ENCODER_ITERS)
                eager_ms = event_ms(lambda: runner._fn(*inputs), ENCODER_ITERS)
            keys.append(dict(key=label, replay_ms=round(replay_ms, 4), eager_ms=round(eager_ms, 4),
                             capture_ms=key["capture_ms"],
                             pool_mib=round(key["pool_bytes"] / 2 ** 20, 2)))
            log("  18d {}: replay {:.4f} ms, eager {:.4f} ms, capture {:.1f} ms, pool {:.2f} "
                "MiB".format(label, replay_ms, eager_ms, key["capture_ms"], keys[-1]["pool_mib"]))
        # the CPU float32 port on the same weights
        cpu_bundle = models.build_model("bert", dict(BERT_BASE, dtype="float32"))

        def f32(node):
            if isinstance(node, dict):
                return {k: f32(v) for k, v in node.items()}
            if isinstance(node, list):
                return [f32(v) for v in node]
            return node.float().cpu()

        cpu = EncoderCore(cpu_bundle, cpu_bundle.convert_params(f32(enc.params), "cpu"),
                          device="cpu")
        short = answers["embeddings_short"]
        ids = [enc_tok for enc_tok in (processor._get_processor(ENCODER_URL).tokenizer.encode(t)
                                       for t in short["body"]["input"])]
        got = np.asarray([d["embedding"] for d in short["answer"]["data"]], np.float32)
        want = cpu.embed(ids)
        gap = float(np.abs(got - want).max() / np.abs(want).max())
        logits, want_logits = enc.classify(ids), cpu.classify(ids)
        gap_cls = float(np.abs(logits - want_logits).max() / np.abs(want_logits).max())
        for what, value in (("embeddings", gap), ("classify logits", gap_cls)):
            if not value <= 0.05:
                raise AssertionError("18d {}: relative gap {} to the CPU float32 port".format(
                    what, value))
        out = dict(load_s=round(load_s, 2), keys=keys,
                   graph_pool_mib=round(health["graph_pool_bytes"] / 2 ** 20, 2),
                   route_ms={k: v["ms"] for k, v in answers.items()},
                   rel_gap_cpu_f32={"embeddings": gap, "classify": gap_cls},
                   rerank_top=[r["index"] for r in answers["rerank"]["answer"]["results"]])
        log("  18d: routes (ms, first calls capture) {}; pool {} MiB over {} keys; relative gap "
            "to the CPU f32 port: embeddings {:.4g}, classify logits {:.4g}".format(
                out["route_ms"], out["graph_pool_mib"], len(keys), gap, gap_cls))
        del processor, enc, cpu
        release_card_memory()
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_bert_routes(card: str) -> dict:
    """Phase 18: BERT's two routes on the card (module docstring)."""
    out = phase_engine_server(card)
    out["18d"] = phase_encoder_routes(card)
    return out


# -- phase 19: Whisper's audio routes ------------------------------------------------

# openai/whisper-large-v3's published config.json (d_model 1280, 32 + 32
# layers, 20 heads of 64, ffn 5120, 128 mels, vocab 51866, 1500 source and
# 448 target positions), and its tokenizer's ids: <|startoftranscript|>
# 50258, <|en|> 50259, <|transcribe|> 50360, <|translate|> 50359,
# <|notimestamps|> 50364, the timestamps from 50365, <|endoftext|> 50257
WHISPER_V3 = {
    "vocab_size": 51866, "d_model": 1280, "n_audio_layers": 32, "n_text_layers": 32,
    "n_heads": 20, "ffn_dim": 5120, "n_mels": 128, "max_source_positions": 1500,
    "max_target_positions": 448, "dtype": "bfloat16",
    "transcribe_prompt_ids": [50258, 50259, 50360, 50364],
    "translate_prompt_ids": [50258, 50259, 50359, 50364],
    "notimestamps_token_id": 50364, "timestamp_begin": 50365, "time_precision": 0.02,
    "eos_token_id": 50257, "sampling_rate": 16000, "chunk_length": 30,
}
AUDIO_URL = "whisper-large-v3"
AUDIO_FULL_URL = "whisper-large-v3-full"   # no max_tokens: a window reaches the cache's end
AUDIO_ENGINE = {"decode_steps": 16, "max_tokens": 224}
AUDIO_SMALL_LAYERS = 2        # 19a: the card's model against the CPU's, at full width
AUDIO_CHECK_CHUNKS = 1        # 19b: chunks held graphed against eager, per bucket and mode
AUDIO_WORD_SECONDS = 2.0      # 19c: the word-timestamp clip (the DTW over 320 heads)
AUDIO_ITERS = 3
AUDIO_MEMORY_SLACK = 64 << 20


def audio_wav(seconds: float, seed: int) -> bytes:
    """A seeded 16 kHz int16 WAV: two tones and noise."""
    import io
    import wave

    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    f = 180.0 + 40.0 * seed
    sig = (0.25 * np.sin(2 * np.pi * f * t) + 0.1 * np.sin(2 * np.pi * 2.5 * f * t)
           + 0.05 * rng.standard_normal(len(t)))
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(sig, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def whisper_encode_flops(cfg: dict, rows: int) -> float:
    """The operations of the encode graph for ``rows`` 30 s windows: both
    convolutions, each layer's projections and FFN (2 x the multiplying
    parameters x positions), its attention products (QK^T and PV), and the
    decoder's cross K/V projections the graph writes beside them."""
    d, ffn, mels = cfg["d_model"], cfg["ffn_dim"], cfg["n_mels"]
    t = cfg["max_source_positions"]
    conv = 2 * (2 * t) * mels * d * 3 + 2 * t * d * d * 3
    layer = 2 * t * (4 * d * d + 2 * d * ffn) + 2 * 2 * t * t * d
    cross_kv = cfg["n_text_layers"] * 2 * 2 * t * d * d
    return float(rows * (conv + cfg["n_audio_layers"] * layer + cross_kv))


def whisper_step_bytes(cfg: dict, rows: int) -> float:
    """The bytes one decode step must read in bf16: the decoder's weights it
    multiplies (self q, k, v, o; cross q, o; the FFN) and the tied head,
    once, and per row the cross K/V and the self-K/V cache (the step reads
    every position of it, masked)."""
    d, ffn, vocab = cfg["d_model"], cfg["ffn_dim"], cfg["vocab_size"]
    n, t, m = cfg["n_text_layers"], cfg["max_source_positions"], cfg["max_target_positions"]
    weights = n * (6 * d * d + 2 * d * ffn) + vocab * d
    per_row = n * 2 * (t + m) * d
    return 2.0 * (weights + rows * per_row)


def audio_small_model(card: str) -> dict:
    """19a: Whisper-large-v3's widths at 2 + 2 layers, the same weights
    (seed 0, biases and LayerNorms perturbed) on the CPU in float32 and on
    the card in float32 (TF32 off) and bfloat16, the same mel input (the
    slaney filters on both sides): encoder states and teacher-forced decode
    logits, the largest gap relative to the CPU's largest value."""
    from clearml_serving_tpu_torch import models
    from clearml_serving_tpu_torch.ops.audio import (
        decode_wav,
        log_mel_spectrogram,
        mel_filter_bank,
    )

    cfg = dict(WHISPER_V3, n_audio_layers=AUDIO_SMALL_LAYERS, n_text_layers=AUDIO_SMALL_LAYERS,
               dtype="float32")
    bundle = models.build_model("whisper", cfg)
    gen = torch.Generator().manual_seed(0)
    tree = bundle.init(gen)

    def perturb(node, key=""):
        if isinstance(node, dict):
            for k, v in node.items():
                perturb(v, k)
        elif isinstance(node, list):
            for v in node:
                perturb(v, key)
        elif key in ("b", "bias", "scale"):
            node += 0.2 * torch.randn(node.shape, generator=gen)

    perturb(tree)

    def cast(node, dtype):
        if isinstance(node, dict):
            return {k: cast(v, dtype) for k, v in node.items()}
        if isinstance(node, list):
            return [cast(v, dtype) for v in node]
        return node.to(dtype)

    bf16 = models.build_model("whisper", dict(cfg, dtype="bfloat16"))
    sides = {"cpu": (bundle, bundle.convert_params(tree, "cpu"), "cpu"),
             "f32": (bundle, bundle.convert_params(tree, DEV), DEV),
             "bf16": (bf16, bf16.convert_params(cast(tree, torch.bfloat16), DEV), DEV)}
    pcm = decode_wav(audio_wav(30.0, 0))
    mel = torch.from_numpy(log_mel_spectrogram(
        pcm, mel_filter_bank(cfg["n_mels"]), n_samples=480000)[None])       # [1, 128, 3000]
    tokens = cfg["transcribe_prompt_ids"] + [50365, 440, 1770, 13, 50400, 50400, 2221, 11]
    out = {}
    with torch.inference_mode():
        for name, (b, params, dev) in sides.items():
            t0 = time.perf_counter()
            enc = b.encode(params, mel.to(dev))
            cache = b.init_cache(params, enc, cfg["max_target_positions"])
            logits = []
            for tok in tokens:
                step, cache = b.decode(params, torch.tensor([tok], dtype=torch.int32,
                                                            device=dev), cache)
                logits.append(step[0])
            sync()
            out[name] = dict(enc=enc.float().cpu(), logits=torch.stack(logits).cpu(),
                             s=time.perf_counter() - t0)
    gaps = {}
    for name in ("f32", "bf16"):
        for what in ("enc", "logits"):
            want = out["cpu"][what]
            gaps["{}_{}".format(name, what)] = float((out[name][what] - want).abs().max()
                                                     / want.abs().max())
    limits = {"f32": 1e-3, "bf16": 0.05}
    for key, gap in gaps.items():
        if not gap <= limits[key.split("_")[0]]:
            raise AssertionError("19a {}: relative gap {} to the CPU float32 model".format(
                key, gap))
    log("  19a: whisper-large-v3 widths at {} + {} layers, {} decode steps: relative gap to the "
        "CPU f32 model: card f32 encoder {:.3g}, logits {:.3g} (limit 1e-3); bf16 {:.3g}, "
        "{:.3g} (limit 5%); CPU {:.1f} s, card f32 {:.2f} s".format(
            AUDIO_SMALL_LAYERS, AUDIO_SMALL_LAYERS, len(tokens), gaps["f32_enc"],
            gaps["f32_logits"], gaps["bf16_enc"], gaps["bf16_logits"], out["cpu"]["s"],
            out["f32"]["s"]))
    del sides, out
    release_card_memory()
    return gaps


def whisper_v3_params(bundle) -> dict:
    """Seed-0 weights for the served model. Random weights emit random ids,
    and the byte tokenizer (no tokenizer files) renders only ids < 256: the
    tied embedding's rows from 256 to <|endoftext|> are zeroed, so the
    model writes bytes, timestamps and special ids, and never EOS (as phase
    5 zeroes its lm_head's columns past the byte ids)."""
    params = bundle.init(torch.Generator(DEV).manual_seed(0))
    params["embed"][256:WHISPER_V3["eos_token_id"] + 1] = 0
    return params


def audio_chunks(core, pcms, prompt, ts: bool) -> list:
    """On ``core``'s thread: a batch's encode and prime, then
    ``AUDIO_CHECK_CHUNKS`` chunks (timestamp or plain); their tokens."""
    with core._lock, core._device():
        st = core._encode_and_prime(pcms, prompt, "chunk_ts" if ts else "chunk")
        if ts:
            core._reset_ts(st)
        else:
            core._run("prime", st)
        name = "chunk_ts" if ts else "chunk"
        return [core._run(name, st).cpu().tolist() for _ in range(AUDIO_CHECK_CHUNKS)]


def audio_graphs_vs_eager(core, pcms_all) -> dict:
    """19b: per bucket 1, 2 and 4, the endpoint's graphed core against an
    eager core on its weights: the encode graph's encoder states and cross
    K/V bitwise, the plain and timestamp chunks' tokens equal."""
    from clearml_serving_tpu_torch.llm.audio import AudioCore

    eager = AudioCore(core.bundle, core.params, decode_steps=core.decode_steps,
                      max_new_tokens=core.max_new_tokens, device=DEV, cuda_graphs=False)
    out = {}
    try:
        for b in (1, 2, 4):
            for ts in (False, True):
                prompt = core.prompt_ids("transcribe", ts)
                got = core.worker.submit(audio_chunks, core, pcms_all[:b], prompt, ts).result()
                want = eager.worker.submit(audio_chunks, eager, pcms_all[:b], prompt,
                                           ts).result()
                sync()
                g, e = core._buckets[b], eager._buckets[b]
                same = {key: bool(torch.equal(g["cache"][key], e["cache"][key]))
                        for key in ("cross_k", "cross_v")}
                same["enc"] = bool(torch.equal(g["enc"], e["enc"]))
                if got != want or not all(same.values()):
                    raise AssertionError("19b bucket {} {}: graphed tokens {} / eager {}, "
                                         "bitwise {}".format(b, "ts" if ts else "plain",
                                                             got[0][:8], want[0][:8], same))
            out[b] = "equal"
        log("  19b: buckets 1, 2, 4: encode graph's encoder states and cross K/V bitwise the "
            "eager run's; {} plain and {} timestamp chunks of 16 steps, tokens equal".format(
                AUDIO_CHECK_CHUNKS, AUDIO_CHECK_CHUNKS))
    finally:
        eager.retire()
        eager.worker.submit(lambda: None).result()
    return out


async def audio_requests(app, calls, concurrent: bool) -> list:
    """(status, body, wall s) of each (path, fields) call: a multipart
    upload where ``fields``' file is bytes, a JSON body where it is base64
    text."""
    import aiohttp
    from aiohttp.test_utils import TestClient, TestServer

    async def one(client, path, fields):
        t0 = time.perf_counter()
        if isinstance(fields["file"], str):
            r = await client.post(path, json=fields)
        else:
            form = aiohttp.FormData()
            for k, v in fields.items():
                if k == "file":
                    form.add_field("file", v, filename="audio.wav", content_type="audio/wav")
                else:
                    form.add_field(k, v)
            r = await client.post(path, data=form)
        body = await r.json() if r.content_type == "application/json" else await r.text()
        return r.status, body, time.perf_counter() - t0

    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        if concurrent:
            return list(await asyncio.gather(*[one(client, p, f) for p, f in calls]))
        return [await one(client, p, f) for p, f in calls]
    finally:
        await client.close()


def audio_traffic(processor, label: str, calls, concurrent: bool = True) -> dict:
    """``calls`` through ``build_app(processor)`` (an app a loop), at once or
    one after another; every status 200."""
    from clearml_serving_tpu_torch.serving.main import build_app

    t0 = time.perf_counter()
    got = asyncio.run(audio_requests(build_app(processor), calls, concurrent))
    wall = time.perf_counter() - t0
    bad = [(s, str(b)[:200]) for s, b, _w in got if s != 200]
    if bad:
        raise AssertionError("19c {}: {}".format(label, bad))
    return dict(answers=[b for _s, b, _w in got], wall_s=[round(w, 3) for _s, _b, w in got],
                total_s=wall)


def phase_audio_routes(card: str) -> dict:
    """Phase 19: Whisper-large-v3 (bf16, seed 0) behind the processor and
    ``build_app``: 19a the model against the CPU at 2 + 2 layers, 19b
    graphs against eager per bucket, 19c the audio routes over HTTP, 19d the
    endpoint's removal (module docstring)."""
    import base64
    import shutil

    from clearml_serving_tpu_torch import models
    from clearml_serving_tpu_torch.device import lease_step_worker, return_step_worker
    from clearml_serving_tpu_torch.engines.jax_engine import save_bundle
    from clearml_serving_tpu_torch.llm.decode_graph import _on_capture_thread, capture_graph
    from clearml_serving_tpu_torch.llm.audio import AudioCore
    from clearml_serving_tpu_torch.llm.openai_api import LLMEngineRequest
    from clearml_serving_tpu_torch.ops.audio import decode_wav
    from clearml_serving_tpu_torch.serving.endpoints import ModelEndpoint
    from clearml_serving_tpu_torch.serving.model_request_processor import (
        ModelRequestProcessor,
    )

    seconds = {}
    t0 = time.perf_counter()
    out = {"19a": audio_small_model(card)}
    seconds["19a"] = round(time.perf_counter() - t0, 1)
    root = state_dir()
    try:
        # the phase leases two step threads of the current stream at once
        # (the endpoint's core, and the eager and full cores in turn), and
        # captures on the current stream's warm-up and capture streams: each
        # (thread, stream)'s cuBLAS workspace lives as long as the process
        # (device.py), so all exist before the baseline is read
        stream = torch.cuda.current_stream()
        workers = [lease_step_worker(stream) for _ in range(2)]
        a = torch.ones((64, 64), device=DEV)
        for w in workers:
            w.submit(lambda: float((a @ a).sum())).result()
            return_step_worker(stream, w)

        def tiny_capture():
            with torch.cuda.stream(stream):
                return capture_graph(lambda: a @ a, stream, (), "thread_local")

        graph = _on_capture_thread(tiny_capture)
        del workers, a, graph
        mem0 = card_memory()
        processor = ModelRequestProcessor(state_root=root, force_create=True, name="audio",
                                          device=DEV)
        rec = processor.registry.register("whisper-large-v3 seed 0", framework="jax")
        bundle_dir = os.path.join(str(rec.files_dir), "whisper-large-v3")
        bundle = models.build_model("whisper", WHISPER_V3)
        t0 = time.perf_counter()
        n_bytes = save_bundle(bundle_dir, "whisper", WHISPER_V3, whisper_v3_params(bundle))
        write_s = time.perf_counter() - t0
        release_card_memory()
        processor.add_endpoint(ModelEndpoint(engine_type="llm", serving_url=AUDIO_URL,
                                             model_id=rec.id,
                                             auxiliary_cfg={"engine": AUDIO_ENGINE}))
        processor.serialize()
        processor.deserialize(skip_sync=True)
        t0 = time.perf_counter()
        proc = processor._get_processor(AUDIO_URL)
        core = proc.audio
        sync()
        load_s = time.perf_counter() - t0
        seconds["bundle"] = round(time.perf_counter() - t0 + write_s, 1)
        t0 = time.perf_counter()
        core.warmup()
        warm_s = time.perf_counter() - t0
        seconds["warmup"] = round(warm_s, 1)
        health = core.health()
        keys = {label: dict(capture_ms=k["capture_ms"],
                            pool_mib=round(k["pool_bytes"] / 2 ** 20, 1))
                for label, k in health["graph_keys"].items()}
        log("  19: bundle {:.3f} GB written in {:.2f} s, loaded through the llm endpoint in "
            "{:.2f} s; warmup captured {} graphs in {:.2f} s, pool {:.1f} MiB".format(
                n_bytes / 1e9, write_s, load_s, len(keys), warm_s,
                health["graph_pool_bytes"] / 2 ** 20))
        for label, k in keys.items():
            log("    {}: capture {:.1f} ms, pool {} MiB".format(label, k["capture_ms"],
                                                               k["pool_mib"]))
        wavs = [audio_wav(30.0, i) for i in range(8)]
        pcms = [decode_wav(w) for w in wavs]
        t0 = time.perf_counter()
        out["19b"] = audio_graphs_vs_eager(core, pcms)
        out["19b"]["keys"] = keys
        seconds["19b"] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

        # 19c: HTTP
        tr, tl = "/serve/openai/v1/audio/transcriptions", "/serve/openai/v1/audio/translations"
        # the word request first: verbose_json with both granularities (its
        # alignment key captured at this first use; steady traffic follows)
        clip = audio_wav(AUDIO_WORD_SECONDS, 9)
        runs = {}
        runs["words"] = audio_traffic(processor, "verbose_json words", [(tr, {
            "file": base64.b64encode(clip).decode(), "model": AUDIO_URL,
            "response_format": "verbose_json", "timestamp_granularities": ["segment", "word"]})])
        words_answer = runs["words"]["answers"][0]
        captures0 = core.health()["graph_captures"]
        runs["c1"] = audio_traffic(processor, "concurrency 1",
                                   [(tr, {"file": wavs[0], "model": AUDIO_URL})])
        runs["c4"] = audio_traffic(processor, "concurrency 4",
                                   [(tr, {"file": w, "model": AUDIO_URL}) for w in wavs[:4]])
        runs["c8"] = audio_traffic(processor, "concurrency 8",
                                   [(tr, {"file": w, "model": AUDIO_URL}) for w in wavs])
        # two transcriptions, then two translations, at once: the first
        # translation breaks the first batch and is carried to the next
        # (two batches of bucket 2)
        runs["mixed"] = audio_traffic(processor, "transcriptions and translations at once", [
            (tr if i < 2 else tl, {"file": w, "model": AUDIO_URL})
            for i, w in enumerate(wavs[:4])])
        long_wav = audio_wav(75.0, 11)
        runs["75s"] = audio_traffic(processor, "75 s file", [(tr, {"file": long_wav,
                                                             "model": AUDIO_URL})])
        runs["formats"] = audio_traffic(processor, "formats", [
            (tr, {"file": wavs[0], "model": AUDIO_URL, "response_format": "text"}),
            (tr, {"file": wavs[1], "model": AUDIO_URL, "response_format": "verbose_json"})],
            concurrent=False)
        text, verbose = runs["formats"]["answers"]
        as_json = runs["c1"]["answers"][0]
        if not (isinstance(text, str) and text == as_json["text"]):
            raise AssertionError("19c: text {!r} against json {!r}".format(text[:40],
                                                                           as_json["text"][:40]))
        if not verbose.get("segments") or verbose["duration"] != 30.0:
            raise AssertionError("19c: verbose_json without segments: {}".format(
                str(verbose)[:300]))
        # the words are the DTW's: a direct words_dtw call on the same windows
        clip_pcm = decode_wav(clip)

        async def clip_windows():
            return await core.transcribe_windows_async(clip_pcm, "transcribe", timestamps=True)

        windows = asyncio.run(clip_windows())
        direct = core.words_dtw(clip_pcm, windows, proc.tokenizer, "transcribe")
        if not direct or words_answer.get("words") != direct or not words_answer.get("segments"):
            raise AssertionError("19c: the words are not the DTW's: {} against {}".format(
                str(words_answer.get("words"))[:200], str(direct)[:200]))
        long_answer = runs["75s"]["answers"][0]
        health = core.health()
        if health["graph_captures"] != captures0:
            raise AssertionError("19c: {} captures during steady traffic".format(
                health["graph_captures"] - captures0))
        rows = health["batch_rows"]
        if max(rows) > 4:
            raise AssertionError("19c: a batch of {} rows".format(max(rows)))
        # the arm without max_tokens, on the same weights: its windows reach
        # the cache's end (the clamp)
        full = AudioCore(core.bundle, core.params, decode_steps=AUDIO_ENGINE["decode_steps"],
                         device=DEV)
        full_proc = LLMEngineRequest.wrap(full, proc.tokenizer, AUDIO_FULL_URL)
        processor.add_endpoint(full_proc.endpoint)
        processor.serialize()
        processor.deserialize(skip_sync=True)
        processor._engine_processor_lookup[AUDIO_FULL_URL] = full_proc
        runs["full"] = audio_traffic(processor, "no max_tokens", [
            (tr, {"file": wavs[2], "model": AUDIO_FULL_URL})])
        sync()
        full_length = int(full._buckets[1]["cache"]["length"][0])
        if full_length <= WHISPER_V3["max_target_positions"]:
            raise AssertionError("19c: the full arm's cache reached {} positions".format(
                full_length))
        torch.zeros(1, device=DEV).add_(1).item()   # no device-side assert
        for label, run in runs.items():
            secs = [{"75s": 75.0, "words": AUDIO_WORD_SECONDS}.get(label, 30.0)] * len(
                run["wall_s"])
            rtf = sum(secs) / run["total_s"]
            log("  19c {}: wall s a request {}, {:.2f} s in all, real-time factor {:.1f} "
                "(audio s per wall s)".format(label, run["wall_s"], run["total_s"], rtf))
            run["rtf"] = round(rtf, 2)
            del run["answers"]
        log("  19c: 75 s file {} chars; verbose_json {} segments; {} DTW words on the {} s clip "
            "equal a direct words_dtw call; the full arm's cache reached {} of {} positions "
            "(clamped), no device assert; rows a batch {}; captures after warm-up: 0".format(
                len(long_answer["text"]), len(verbose["segments"]), len(direct),
                AUDIO_WORD_SECONDS, full_length, WHISPER_V3["max_target_positions"], rows))
        # encode and decode-step times against their bounds (the graphs replayed)
        timing = {}

        def time_graphs():
            with core._lock, core._device():
                for b in (1, 2, 4):
                    enc_ms = event_ms(core.graph("encode", b).replay, AUDIO_ITERS)
                    step_ms = event_ms(core.graph("chunk", b).replay,
                                       AUDIO_ITERS) / core.decode_steps
                    enc_bound = whisper_encode_flops(WHISPER_V3, b) / 989e12 * 1e3
                    step_bound = whisper_step_bytes(WHISPER_V3, b) / CARD_BW * 1e3
                    timing[b] = dict(encode_ms=round(enc_ms, 3),
                                     encode_bound_ms=round(enc_bound, 3),
                                     step_ms=round(step_ms, 4),
                                     step_bound_ms=round(step_bound, 4))

        core.worker.submit(time_graphs).result()
        for b, t in timing.items():
            log("  19c bucket {}: encode {:.3f} ms (operations bound {:.3f}, {:.1f}%), decode "
                "step {:.4f} ms (byte bound {:.4f}, {:.1f}%)".format(
                    b, t["encode_ms"], t["encode_bound_ms"],
                    100 * t["encode_bound_ms"] / t["encode_ms"], t["step_ms"],
                    t["step_bound_ms"], 100 * t["step_bound_ms"] / t["step_ms"]))
        host = core.health()["host_ms"]
        per_window = dict(mel_ms=round(host["mel"] / max(1, host["mel_windows"]), 2),
                          dtw_ms=round(host["dtw"] / max(1, host["dtw_windows"]), 1))
        log("  19c host: mel {} ms a window ({} windows), DTW {} ms a window ({} windows)".format(
            per_window["mel_ms"], host["mel_windows"], per_window["dtw_ms"], host["dtw_windows"]))
        out["19c"] = dict(runs=runs, timing=timing, host=per_window, batch_rows=rows,
                          full_length=full_length, words=len(direct))
        seconds["19c"] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

        # 19d: removal; the processor retires both cores, their releases
        # queued behind the calls on their threads
        workers = [core.worker, full.worker]
        del proc, core, full, full_proc
        for url in (AUDIO_URL, AUDIO_FULL_URL):
            processor.remove_endpoint(url)
        processor.serialize()
        processor.deserialize()
        for worker in workers:
            worker.submit(lambda: None).result()
        mem1 = card_memory()
        release_card_memory()
        if mem1 - mem0 > AUDIO_MEMORY_SLACK:
            raise AssertionError("19d: memory_allocated {:.1f} MiB above its level before the "
                                 "endpoint".format((mem1 - mem0) / 2 ** 20))
        out["19d"] = dict(before_mib=round(mem0 / 2 ** 20, 1), after_mib=round(mem1 / 2 ** 20, 1))
        seconds["19d"] = round(time.perf_counter() - t0, 1)
        out["seconds"] = seconds
        log("  19d: endpoint removed under CAPTURE_LOCK; memory_allocated {:.1f} MiB before, "
            "{:.1f} MiB after; seconds {}".format(mem0 / 2 ** 20, mem1 / 2 ** 20, seconds))
        del processor
        release_card_memory()
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def llama3_8b_params() -> dict:
    """Phase 5's weights: Llama-3-8B at full width on the card, random from
    seed 0. Random weights emit random ids; the byte tokenizer renders only
    ids < 256, so the lm_head keeps its columns for the 256 byte ids and
    zeroes the rest: the model then writes text (and never EOS)."""
    from clearml_serving_tpu_torch.models.llama import init_params

    t0 = time.perf_counter()
    params = init_params({"preset": "llama3-8b"}, torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    params["lm_head"][:, 256:] = 0
    sync()
    n_bytes = sum(t.numel() * t.element_size() for t in
                  [params["embed"], params["lm_head"], params["final_norm"]]
                  + [w for layer in params["layers"] for w in layer.values()])
    log("  weights {:.2f} GB made in {:.1f} s".format(n_bytes / 1e9, time.perf_counter() - t0))
    return params


KINETO_MAX_GPU_BUFFER_MB = 1024


def kineto_config(root: str) -> None:
    """Raise the profiler's cap on its GPU record buffers (kineto's
    default, 128 MB, filled on phase 6's busiest passes: "Processed 647658
    GPU records (128664512 bytes)", the records past it dropped) through a
    config file in the checkout's ``build/``, read when the profiler
    starts. An explicit ``KINETO_CONFIG`` wins."""
    path = os.path.join(root, "build", "kineto.conf")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("ACTIVITIES_MAX_GPU_BUFFER_SIZE_MB={}\n".format(KINETO_MAX_GPU_BUFFER_MB))
    os.environ.setdefault("KINETO_CONFIG", path)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    kineto_config(os.path.dirname(os.path.abspath(__file__)))
    from clearml_serving_tpu_torch.models.llama import Llama
    from clearml_serving_tpu_torch.ops import _build
    from clearml_serving_tpu_torch.ops.quant import quantize_llama_params

    t_start = time.perf_counter()
    seconds, t_mark = {}, [t_start]

    def mark(name):
        """The seconds since the last mark, by phase."""
        now = time.perf_counter()
        seconds[name] = round(now - t_mark[0], 1)
        t_mark[0] = now
        log("  (phase {}: {} s, {:.1f} s in all)".format(name, seconds[name], now - t_start))

    card = card_line()
    log("phase 1: card", card)
    log("  torch {} cuda {} device {} x{}".format(
        torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
        torch.cuda.device_count()))
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[-1]
    log("  nvcc", nvcc)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("phase 2: build kernels")
    t0 = time.perf_counter()
    _build.load_library()
    log("  built in {:.1f} s ({})".format(
        time.perf_counter() - t0, _build.BUILD_DIR / _build.LIB_NAME))
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log("  ptxas:", line.strip())

    mark("1-2")
    gen = torch.Generator("cuda").manual_seed(0)
    kern = phase_kernels(gen)
    rkern = phase_ragged_kernel(gen)
    tkern = phase_tree_kernel(gen)
    int4k = phase_int4_kernel(gen)
    mark("3")
    phase_small_model(0)
    phase_small_ragged(0)
    phase_small_verify(0)
    phase_small_model(0, "int4")
    phase_small_ragged(0, "int4")
    for family in SMALL_FAMILIES:
        phase_small_model(0, family=family)
        phase_small_ragged(0, family=family)

    mark("4")
    log("phase 5: main path, llama3-8b full width bf16 behind the HTTP server")
    params = llama3_8b_params()
    runs = [phase_main_path(params, ""), phase_main_path(params, "int8")]
    log("phase 5b: ragged main path, llama3-8b full width, scheduler ragged, "
        "step_token_budget 256")
    ragged_runs = [phase_ragged_main_path(params, ""), phase_ragged_main_path(params, "int8")]
    log("phase 5c: w4a16 main path, llama3-8b full width, int4 weights quantized on the card")
    t0 = time.perf_counter()
    # after the lm_head's columns past the byte ids are zeroed: a zero column
    # quantizes to scale 1.0 and level 0, so it stays exactly zero
    qparams = quantize_llama_params(params, bits=4)
    sync()
    log("  quantized in {:.1f} s".format(time.perf_counter() - t0))
    # the packed tree with its redundant knob under phase 5's traffic with
    # two long prompts (prefills of 1024 and 2048 rows through the kernel),
    # then 5b's; then build_engine quantizes the bf16 tree to int8 itself
    long_prefills = PROMPTS[:2] + [LONG_PROMPTS[0], LONG_PROMPTS[-1]]
    int4_runs = [phase_main_path(qparams, "", weight_quant="int4", prompts=long_prefills),
                 phase_ragged_main_path(qparams, "", weight_quant="int4")]
    if max(int4_runs[0]["prefill_rows"]) <= 512:
        raise AssertionError("no int4 prefill above 512 rows: {}".format(
            int4_runs[0]["prefill_rows"]))
    int8_run = phase_main_path(params, "", weight_quant="int8", max_tokens=8)
    log("phase 5d: speculative verify rows, llama3-8b full width, scheduler ragged, "
        "step_token_budget 256, speculation ngram, spec_k 4")
    spec_runs = [phase_spec_main_path(params, arm, kv, knobs) for arm, kv, knobs in SPEC_ARMS]
    compare_spec_streams(spec_runs, Llama({"preset": "llama3-8b"}, params))
    for run in spec_runs:
        run["contents"] = [text[:24] for text in run["contents"]]
        del run["token_ids"]
    mark("5-5d")
    log("phase 5e: pipelined decode, llama3-8b full width, each decode chunk one CUDA-graph "
        "replay")
    graph_cases = [graph_chunk_case(qparams if weights else params, kv, weights, sampled)
                   for kv, weights in GRAPH_CASES for sampled in (False, True)]
    pipeline_runs = phase_pipeline_arms(params)
    mark("5e")
    log("phase 5f: the ragged launch as CUDA graphs, llama3-8b widths at {} of its 32 layers, "
        "scheduler ragged, warmup full: phase 5b's and 5d's traffic graphed and eager, and on "
        "int4 weights".format(GRAPH_LAYERS))
    ragged_graphs = phase_ragged_graphs(depth_cut(params, GRAPH_LAYERS),
                                        depth_cut(qparams, GRAPH_LAYERS), card)
    mark("5f")
    log("phase 16: the model families of the paged path behind the HTTP server: Llama-3.1-8B "
        "(scaled RoPE) at full depth, Qwen2.5-7B (QKV biases) and Gemma-7B (head_dim 256, "
        "tied, offset norms, GeGLU) at full width, {} of 28 layers".format(FAMILY_LAYERS))
    families = phase_families(params, qparams)
    mark("16")
    log("phase 6: where the time goes, llama3-8b widths at {} of its 32 layers".format(
        PROFILE_LAYERS))
    prof = phase_profile(params, check_reader=True)
    serial_prof = phase_profile(params, pipeline_depth=1, cuda_graphs=False)
    # the steadier traffic in each arm of phase 5e
    steady_profs = [phase_profile(params, pipeline_depth=depth, cuda_graphs=cuda_graphs,
                                  traffic=PROFILED_STEADY)
                    for _arm, depth, cuda_graphs in PIPELINE_ARMS]
    ragged_prof = phase_profile(params, "ragged")
    tree_prof = phase_profile(params, "ragged-tree")
    # the same passes with their ragged steps eager, the decode chunks graphed
    eager_ragged_profs = [phase_profile(params, scheduler, ragged_graphs=False)
                          for scheduler in ("ragged", "ragged-tree")]
    int4_prof = phase_profile(qparams, weight_quant="int4")
    mark("6")
    log("phase 7: request lifecycle, llama3-8b widths at {} of its 32 layers behind the HTTP "
        "server, default lifecycle knobs".format(LIFECYCLE_LAYERS))
    lifecycle = phase_lifecycle(depth_cut(params, LIFECYCLE_LAYERS), card)
    log("phase 8: the radix prefix cache over shared, refcounted KV pages, llama3-8b widths at "
        "{} of its 32 layers, prefix_cache 64, prefix_block 64, prefix_cache_pages 256".format(
            PREFIX_LAYERS))
    mark("7")
    prefix = phase_prefix_cache(depth_cut(params, PREFIX_LAYERS), card)
    mark("8")
    prefix_arm = {(r["arm"], r["kv"]): r for r in prefix["runs"]}
    log("phase 9: the prefix cache's host-RAM KV tier and the ownership ledger, llama3-8b "
        "full width, prefix_cache_pages 128 over prefix_cache_host_pages 512")
    tier = phase_kv_tier(params, card)
    mark("9")
    tier_arm = {r["arm"]: r for r in tier["runs"]}
    # phase 10 runs the first SURFACE_LAYERS layers of phase 5's weights
    log("phase 10: the sampling surface of the OpenAI routes, llama3-8b widths at {} of its "
        "32 layers: penalties, logit bias, seeds, min_tokens, logprobs, n, completions "
        "scoring".format(SURFACE_LAYERS))
    sampling = phase_sampling(depth_cut(params, SURFACE_LAYERS), card)
    mark("10")
    log("phase 11: guided decoding and tool calling on the OpenAI routes, llama3-8b full "
        "width: regex, choice, JSON schema, json_object, tool_choice modes")
    guided = phase_guided(params, card)
    mark("11")
    log("phase 12: the two-dispatch admission beside decode, llama3-8b widths at {} of its 32 "
        "layers: prefills in admission workers, the prefill gate, chunked prefill".format(
            ADMIT_LAYERS))
    admission = phase_admission(depth_cut(params, ADMIT_LAYERS),
                                depth_cut(qparams, ADMIT_LAYERS), card)
    mark("12")
    log("phase 13: the control plane in front of the LLM route: the CLI, the processor and "
        "its sync daemon, the /serve/{{tail}} router, llama3-8b widths at {} of its 32 layers, "
        "int8 KV".format(CP_LAYERS))
    control = phase_control_plane(card)
    mark("13")
    release_card_memory()
    log("phase 14: the replica fleet: two Llama-3-8B replicas over one weight set behind the "
        "prefix-affine router, failover to a sibling, disaggregated prefill/decode over the "
        "shared-slab KV transport, the Prometheus exporter")
    fleet = phase_fleet(card)
    mark("14")
    # phase 15's workers draw their own weights on the card, beside this
    # process's endpoint: phase 5's weights go back to the card first
    del params, qparams
    release_card_memory()
    log("phase 15: the process fleet: two Llama-3-8B worker processes ({} of 32 layers), each "
        "with its own CUDA context, pool and graphs, behind the router; a real SIGKILL and the "
        "restart with re-warm; disaggregated prefill/decode over the socket KV wire".format(
            PROC_BASE["config"]["n_layers"]))
    pfleet = phase_process_fleet(card)
    mark("15")
    log("phase 17: the jax engine type behind the processor: the iris MLP, the MNIST CNN "
        "(bundle, GraphDef, TorchScript), BERT-base (bf16, sequence 128) and its ONNX "
        "export, one CUDA graph per bucket key; a Llama-3-8B bundle (8 of 32 layers) on "
        "the llm route")
    bundles = phase_bundle_engines(card)
    mark("17")
    log("phase 18: BERT's two routes: the BERT example's jax_grpc topology (BERT-base bf16 "
        "behind tpu-serving-torch-engine in its own process, this process the router; "
        "traffic at concurrency {}, a hot swap, a SIGKILL and restart) and the encoder "
        "routes of an llm endpoint with task embed".format(GRPC_CONCURRENCY))
    bert_routes = phase_bert_routes(card)
    mark("18")
    log("phase 19: Whisper's audio routes: whisper-large-v3 (bf16, seed 0, 32 + 32 layers) as an "
        "llm endpoint, its encode and decode chunks as CUDA graphs per batch bucket, "
        "transcriptions and translations over HTTP, DTW word timing")
    audio_routes = phase_audio_routes(card)
    mark("19")

    t = kern["timings"]
    rt = rkern["timings"]
    tt = tkern["timings"]
    tree_bf16 = next(r for r in spec_runs if r["arm"] == "tree" and r["kv"] == "bf16")
    tree_int8 = next(r for r in spec_runs if r["arm"] == "tree" and r["kv"] == "int8")
    graphed = {(r["arm"], r["kv"], r["weights"]): r for r in ragged_graphs["runs"]
               if r["graphs"]}
    g_bf16, g_int8 = graphed[("plain", "bf16", "bf16")], graphed[("plain", "int8", "bf16")]
    g_tree, g_int4 = graphed[("tree", "bf16", "bf16")], graphed[("plain", "bf16", "int4")]

    def key_counts(run, label, kernel):
        """What one replay of a phase-5f key adds to a kernel's count."""
        return run["per_replay"].get(label, {}).get(kernel)

    def per_replay(kernel, kv, weights):
        """The launches one replay of phase 5e's greedy chunk added."""
        return next(g["launches_per_replay"][kernel] for g in graph_cases
                    if (g["kv"], g["weights"], g["variant"]) == (kv, weights, "greedy"))
    kernels = {"kernels": [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "clearml_serving_tpu_torch/csrc/paged_attention.cu",
        "replaces": "clearml_serving_tpu/ops/paged_attention.py:399",
        "tpu": "ops/paged_attention.py:399",
        "launches": runs[0]["launches"],
        "launches_int8": runs[1]["launches"],
        # counted in one replay of phase 5e's decode chunk (bf16 / int8 KV)
        "launches_per_replay": per_replay("paged_attention", "bf16", "bf16"),
        "launches_per_replay_int8": per_replay("paged_attention", "int8", "bf16"),
        "max_abs_err": kern["err_bf16"],
        "max_err_bf16": kern["err_bf16"],
        "max_err_int8": kern["err_int8"],
        # primary shape: 8 rows x 1024 tokens, bf16 pools; CUDA-graph device
        # time (eager_ms: calls one after another through the wrapper)
        "ms": t["bf16_8x1024"]["ms"],
        "eager_ms": t["bf16_8x1024"]["eager_ms"],
        "plain_ms": t["bf16_8x1024"]["plain_ms"],
        "bound_ms": t["bf16_8x1024"]["bound_ms"],
        "bound_by": t["bf16_8x1024"]["bound_by"],
        "library_ms": None,
        # a yardstick that reads no page table: SDPA over the K/V gathered contiguous
        "sdpa_gathered_ms": t["bf16_8x1024"]["sdpa_gathered_ms"],
        "ms_int8": t["int8_8x1024"]["ms"],
        "plain_ms_int8": t["int8_8x1024"]["plain_ms"],
        "bound_ms_int8": t["int8_8x1024"]["bound_ms"],
        "per_case": [dict(case=name, **row) for name, row in t.items()],
        "launches_ragged_path": ragged_runs[0]["paged_launches"],
        # phase 5f: the chained window steps inside the ragged graphs (bf16
        # KV), and one replay of the window-4 and window-2 greedy keys
        "launches_ragged_graphs": g_bf16["paged_launches"],
        "launches_per_replay_ragged_q4": key_counts(g_bf16, "ragged+q4+greedy", "paged"),
        "launches_per_replay_ragged_q2": key_counts(g_bf16, "ragged+q2+greedy", "paged"),
        # phase 8: decode rows reading shared prefix pages (two-dispatch
        # with graphs, bf16 / int8 KV, and the ragged arm's chained steps)
        "launches_prefix": prefix_arm[("two_dispatch", "bf16")]["paged_launches"],
        "launches_prefix_int8": prefix_arm[("two_dispatch", "int8")]["paged_launches"],
        "launches_prefix_ragged_path": prefix_arm[("ragged", "bf16")]["paged_launches"],
        # phase 9: decode rows over promoted prefix pages (arms B and C,
        # two-dispatch with graphs, bf16 / int8 KV, and arm D's chained steps)
        "launches_tier": tier_arm["B"]["paged_launches"],
        "launches_tier_int8": tier_arm["C"]["paged_launches"],
        "launches_tier_ragged_path": tier_arm["D"]["paged_launches"],
        # phase 10: the extras and logprob variants of the decode chunk (10a)
        # and the ragged arm's chained steps (10b)
        "launches_sampling": sampling["paged_launches"],
        "launches_sampling_ragged_path": sampling["ragged"]["paged_launches"],
        # phase 11: the guided variants of the decode chunk (11a) and the
        # ragged arm's chained steps (11c)
        "launches_guided": guided["paged_launches"],
        "launches_guided_ragged_path": guided["ragged"]["paged_launches"],
        # phase 12a: decode replays beside admissions prefilling in workers
        # (the gate at 2, chunked prefill 256)
        "launches_admission": admission["runs"]["gate2_chunked"]["launches"],
        # phase 13a: decode replays of the endpoint the processor built
        # from the CLI's service, behind the router
        "launches_control_plane": control["launches"],
        # phase 14a: decode replays of the two replicas of the fleet
        # endpoint (4 conversations x 3 turns)
        "launches_fleet": fleet["14a"]["launches"],
        # phase 14c: the disaggregated arms' decode launches
        "launches_disagg": fleet["14c"]["two_dispatch"]["launches"]["paged"],
        "launches_disagg_ragged_path": fleet["14c"]["ragged"]["launches"]["paged"],
        # phase 15a: the two worker processes' decode launches (their own
        # counts, zeroed in each worker before the traffic)
        "launches_process_fleet": pfleet["15a"]["launches"]["paged"],
        # phase 15c: the disaggregated workers' decode launches
        "launches_process_disagg": pfleet["15c"]["two_dispatch"]["launches"]["paged"],
        "launches_process_disagg_ragged_path": pfleet["15c"]["ragged"]["launches"]["paged"],
    }, {
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "clearml_serving_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "clearml_serving_tpu/ops/paged_attention.py:881",
        "tpu": "ops/paged_attention.py:881",
        "launches": ragged_runs[0]["ragged_launches"],
        "launches_int8": ragged_runs[1]["ragged_launches"],
        # phase 5f: every ragged step one replay, warmup full (bf16 and int8
        # KV), and one replay of the window-1 greedy key
        "launches_graphed": g_bf16["ragged_launches"],
        "launches_graphed_int8": g_int8["ragged_launches"],
        "replays_graphed": g_bf16["ragged_replays"],
        "launches_per_replay": key_counts(g_bf16, "ragged+q1+greedy", "ragged"),
        "max_abs_err": rkern["err_bf16"],
        "max_err_bf16": rkern["err_bf16"],
        "max_err_int8": rkern["err_int8"],
        # primary shape: the mixed launch (7 decode rows at 1024 + a 128-token
        # chunk); CUDA-graph device time (eager_ms: calls one after another
        # through the wrapper)
        "ms": rt["mixed_bf16"]["ms"],
        "eager_ms": rt["mixed_bf16"]["eager_ms"],
        "plain_ms": rt["mixed_bf16"]["plain_ms"],
        "bound_ms": rt["mixed_bf16"]["bound_ms"],
        "bound_by": rt["mixed_bf16"]["bound_by"],
        "library_ms": None,
        "ms_int8": rt["mixed_int8"]["ms"],
        "eager_ms_int8": rt["mixed_int8"]["eager_ms"],
        "plain_ms_int8": rt["mixed_int8"]["plain_ms"],
        "bound_ms_int8": rt["mixed_int8"]["bound_ms"],
        # one 512-token chunk at history 1536
        "ms_prefill": rt["prefill_bf16"]["ms"],
        "eager_ms_prefill": rt["prefill_bf16"]["eager_ms"],
        "plain_ms_prefill": rt["prefill_bf16"]["plain_ms"],
        "bound_ms_prefill": rt["prefill_bf16"]["bound_ms"],
        "bound_by_prefill": rt["prefill_bf16"]["bound_by"],
        # a yardstick that reads no page table: SDPA, lower-right causal,
        # over the prefill row's K/V gathered contiguous
        "sdpa_gathered_ms_prefill": rt["prefill_bf16"]["sdpa_gathered_ms"],
        "per_case": [dict(case=name, **row) for name, row in rt.items()],
        # phase 8: hit admissions' tail chunk rows over mapped shared pages
        "launches_prefix": prefix_arm[("ragged", "bf16")]["ragged_launches"],
        "launches_prefix_int8": prefix_arm[("ragged", "int8")]["ragged_launches"],
        # phase 9, arm D: hit admissions' tail chunk rows over promoted pages
        "launches_tier": tier_arm["D"]["ragged_launches"],
        # phase 10b: extras rows beside tree verify rows, int8 KV
        "launches_sampling": sampling["ragged"]["ragged_launches"],
        # phase 11c: guided rows beside tree verify rows, int8 KV; a retry
        # of its profiled pass (the first trace disagreed with the counts)
        "launches_guided": guided["ragged"]["ragged_launches"],
        "trace_retries_guided": guided["ragged"]["trace_retries"],
        # phase 14c: the ragged disaggregated arm (the prefill replica's
        # chunk rows, the decode replica's tail rows), both replicas
        "launches_disagg": fleet["14c"]["ragged"]["launches"]["ragged"],
        # phase 15c: the ragged arm's workers (prefill and decode)
        "launches_process_disagg": pfleet["15c"]["ragged"]["launches"]["ragged"],
    }, {
        "name": "ragged_paged_attention[tree_anc]",
        "route": "cuda",
        "source": "clearml_serving_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "clearml_serving_tpu/ops/paged_attention.py:701",
        "tpu": "ops/paged_attention.py:701-722, the tree branch of the kernel called at :881",
        # phase 5d's tree arm: once per layer per verify step
        "launches": tree_bf16["tree_launches"],
        "launches_int8": tree_int8["tree_launches"],
        # phase 5f's tree arm, every verify step one replay, and one replay
        # of the window-1 greedy tree key
        "launches_graphed": g_tree["tree_launches"],
        "launches_per_replay": key_counts(g_tree, "ragged+q1+greedy+tree", "tree"),
        "max_abs_err": tkern["err_bf16"],
        "max_err_bf16": tkern["err_bf16"],
        "max_err_int8": tkern["err_int8"],
        # primary shape: phase 5d's verify launch (4 forest verify rows of 5 at
        # 300-550 history, 2 decode rows, every row's keys split); CUDA-graph
        # device time (eager_ms: calls one after another)
        "ms": tt["verify_forest_bf16"]["ms"],
        "eager_ms": tt["verify_forest_bf16"]["eager_ms"],
        "plain_ms": tt["verify_forest_bf16"]["plain_ms"],
        "bound_ms": tt["verify_forest_bf16"]["bound_ms"],
        "bound_by": tt["verify_forest_bf16"]["bound_by"],
        "library_ms": None,
        # the same launch without the mask, in graph replays alternating
        # with it; mask_cost_ms: the median of the pairs' differences
        "ms_without_mask": tt["verify_forest_bf16"]["untree_ms"],
        "mask_cost_ms": tt["verify_forest_bf16"]["mask_cost_ms"],
        # the same launch with one span (split off), alternating with it;
        # split_gain_ms: the median of (one span - split)
        "ms_one_span": tt["verify_forest_bf16"]["one_span_ms"],
        "split_gain_ms": tt["verify_forest_bf16"]["split_gain_ms"],
        "ms_chain": tt["verify_chain_bf16"]["ms"],
        "ms_int8": tt["verify_forest_int8"]["ms"],
        "eager_ms_int8": tt["verify_forest_int8"]["eager_ms"],
        "ms_int8_without_mask": tt["verify_forest_int8"]["untree_ms"],
        "mask_cost_ms_int8": tt["verify_forest_int8"]["mask_cost_ms"],
        "ms_int8_one_span": tt["verify_forest_int8"]["one_span_ms"],
        # phase 10b's verify steps
        "launches_sampling": sampling["ragged"]["tree_launches"],
        # phase 11c's verify steps, beside guided rows
        "launches_guided": guided["ragged"]["tree_launches"],
        "plain_ms_int8": tt["verify_forest_int8"]["plain_ms"],
        "bound_ms_int8": tt["verify_forest_int8"]["bound_ms"],
        "per_case": [dict(case=name, **row) for name, row in tt.items()],
    }, {
        "name": "paged_attention[head_dim=256]",
        "route": "cuda",
        "source": "clearml_serving_tpu_torch/csrc/paged_attention.cu",
        "replaces": "clearml_serving_tpu/ops/paged_attention.py:399",
        "tpu": "ops/paged_attention.py:399 at D = 256 (its gate D % 128 == 0, :340)",
        # phase 16's Gemma-7B arms: two-dispatch bf16 / int8 KV, the ragged
        # arm's decode and chained steps
        "launches": families["launches_d256"]["paged"],
        "launches_int8": families["launches_d256"]["paged_int8"],
        "launches_ragged_path": families["launches_d256"]["paged_ragged_path"],
        "max_abs_err": kern["err_d256"]["bf16"],
        "max_err_int8": kern["err_d256"]["int8"],
        # primary shape: 8 rows x 1024 tokens at Gemma-7B's heads (Hkv 16,
        # G 1, D 256), bf16 pools; CUDA-graph device time
        "shape": "8x1024 Hkv16 G1 D256",
        **{key: t["bf16_8x1024_d256"][key] for key in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                                       "bound_by", "sdpa_gathered_ms")},
        "library_ms": None,
        "ms_int8": t["int8_8x1024_d256"]["ms"],
        "plain_ms_int8": t["int8_8x1024_d256"]["plain_ms"],
        "bound_ms_int8": t["int8_8x1024_d256"]["bound_ms"],
    }, {
        "name": "ragged_paged_attention[head_dim=256]",
        "route": "cuda",
        "source": "clearml_serving_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "clearml_serving_tpu/ops/paged_attention.py:881",
        "tpu": "ops/paged_attention.py:881 at D = 256 (its gate D % 128 == 0, :803)",
        # phase 16's Gemma-7B ragged arms, bf16 / int8 KV
        "launches": families["launches_d256"]["ragged"],
        "launches_int8": families["launches_d256"]["ragged_int8"],
        # causal and tree rows (chain bitwise the causal launch), split and
        # unsplit, bf16 and int8 (phase 3b)
        "max_abs_err": rkern["err_bf16_d256"],
        "max_err_int8": rkern["err_int8_d256"],
        # primary shape: phase 3b's mixed launch at Gemma-7B's heads
        "shape": "7 decode rows at 1024 + a 128-token chunk, Hkv16 G1 D256",
        **{key: rt["mixed_d256_bf16"][key] for key in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                                       "bound_by")},
        "library_ms": None,
        "ms_int8": rt["mixed_d256_int8"]["ms"],
        "plain_ms_int8": rt["mixed_d256_int8"]["plain_ms"],
        "bound_ms_int8": rt["mixed_d256_int8"]["bound_ms"],
        "ms_prefill": rt["prefill_d256_bf16"]["ms"],
        "bound_ms_prefill": rt["prefill_d256_bf16"]["bound_ms"],
        "bound_by_prefill": rt["prefill_d256_bf16"]["bound_by"],
        "sdpa_gathered_ms_prefill": rt["prefill_d256_bf16"]["sdpa_gathered_ms"],
    }, {
        "name": "fused_int4_matmul",
        "route": "cuda",
        "source": "clearml_serving_tpu_torch/csrc/fused_int4_matmul.cu",
        "replaces": "clearml_serving_tpu/ops/fused_matmul.py:271",
        "tpu": "ops/fused_matmul.py:271",
        # phase 5c under phase 5's traffic with long prompts: 225 per forward call
        "launches": int4_runs[0]["int4_launches"],
        "launches_ragged_path": int4_runs[1]["int4_launches"],
        # phase 12b: 12a's traffic on int4 weights with 256-token chunked
        # prefill segments (M = 256) beside the decode replays
        "launches_admission": admission["int4"]["int4_launches"],
        # counted in one replay of phase 5e's decode chunk on int4 weights
        "launches_per_replay": per_replay("fused_int4_matmul", "bf16", "int4"),
        # phase 5f's int4 arm: the ragged steps' replays (and the decode
        # chunks'), and one replay of the window-1 greedy ragged key
        "launches_ragged_graphs": g_int4["int4_launches"],
        "launches_per_ragged_replay": key_counts(g_int4, "ragged+q1+greedy", "int4"),
        "max_abs_err": int4k["err"],
        # primary call: a decode batch through w_gate / w_up
        "shape": "x[{1},4096] @ W[4096,14336] ({0})".format(*INT4_PRIMARY),
        **{key: int4k["timings"][INT4_PRIMARY][key]
           for key in ("ms", "eager_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                       "library_error", "bf16_ms")},
        # the 225 calls of one decode step at M = 8, summed from the shapes' times
        "decode_step": int4k["decode_step"],
        # the block tiling: one ragged step's 224 projection calls at M = 312
        "ragged_step": int4k["ragged_step"],
        "per_shape": [dict(shape=name, m=m, **row)
                      for (name, m), row in int4k["timings"].items()],
    }]}
    log("main path:", json.dumps({"runs": runs, "ragged_runs": ragged_runs,
                                  "int4_runs": int4_runs, "int8_run": int8_run,
                                  "spec_runs": spec_runs, "graph_cases": graph_cases,
                                  "ragged_graphs": ragged_graphs,
                                  "pipeline_runs": pipeline_runs,
                                  "profile": prof, "serial_profile": serial_prof,
                                  "steady_profiles": steady_profs,
                                  "ragged_profile": ragged_prof,
                                  "tree_profile": tree_prof,
                                  "eager_ragged_profiles": eager_ragged_profs,
                                  "int4_profile": int4_prof,
                                  "lifecycle": lifecycle, "prefix_cache": prefix,
                                  "kv_tier": tier, "sampling": sampling,
                                  "guided": guided, "admission": admission,
                                  "control_plane": control, "fleet": fleet,
                                  "process_fleet": pfleet, "families": families,
                                  "bundle_engines": bundles,
                                  "bert_routes": bert_routes,
                                  "audio_routes": audio_routes}))
    log("seconds by phase:", json.dumps(seconds))
    log("total {:.1f} s".format(time.perf_counter() - t_start))
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
