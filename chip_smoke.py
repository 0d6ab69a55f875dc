#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (an H100 SXM).

    python3 chip_smoke.py

Drives the port (``clearml_serving_tpu_torch``) phase by phase; any failure
exits non-zero before the result lines are printed:

1. the card's name and power limit, torch / CUDA / nvcc versions;
2. builds the CUDA kernels from ``clearml_serving_tpu_torch/csrc`` (set-up
   time, printed with the compiler's register report);
3. holds every kernel against its plain PyTorch version on the card at the
   main path's shapes (bf16 and int8 pools), and times kernel, plain version
   and the bound at the main-path shape;
4. a small model on the card against the same weights in float32 on the CPU
   (prefill + paged decode logits, bf16 and int8 KV);
5. the main path: Llama-3-8B at full width (32 layers, dim 4096, bf16,
   random weights from a seed) behind the port's HTTP server, a paged KV
   cache (max_batch 8, max_seq_len 2048, page_size 16, decode_steps 4),
   four concurrent chat completions (two streaming) with bf16 KV, then again
   with int8 KV on the same weights; every kernel of the path must have
   launched (paged attention: once per layer per decode step).

The last three lines of standard output are the card line, the ``kernels``
JSON line and ``{"ok": true, "device": {...}}``. Timings are CUDA-event
times on the card; ``bound_ms`` is computed from this run's operands.
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
import time

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
    )
    err_int8 = max(
        check_kernel(paged_operands(gen, lengths=mixed, quant=True),
                     "int8 B8 Hkv8 G4 D128 P16 mixed"),
        check_kernel(paged_operands(gen, lengths=mixed, page_size=32, pp=65, g=8,
                                    quant=True), "int8 B8 Hkv8 G8 D128 P32 mixed"),
        check_kernel(paged_operands(gen, lengths=[1024] * 8, quant=True),
                     "int8 B8 Hkv8 G4 D128 P16 8x1024"),
    )
    timings = {}
    layers = 4
    for quant in (False, True):
        ops = paged_operands(gen, lengths=[1024] * 8, quant=quant, layers=layers)

        def kernel(li, ops=ops):
            args, kw = layer_args(ops, li)
            paged_attention(*args, **kw)

        def plain(li, ops=ops):
            args, kw = layer_args(ops, li)
            paged_attention_ref(*args, **kw)

        before = paged_attention.launches
        kernel_ms = time_launches(kernel, layers, 200)
        plain_ms = time_launches(plain, layers, 20)
        paged_attention.launches = before   # timing launches are not the main path's
        name = "int8" if quant else "bf16"
        b_ms, b_by = bound(ops)
        timings[name] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        log("  {} main-path shape (B8 x 1024 live tokens): kernel_ms {:.4f}  plain_ms "
            "{:.4f}  bound_ms {:.4f}  ({:.1f}% of bound)".format(
                name, kernel_ms, plain_ms, timings[name]["bound_ms"],
                100 * timings[name]["bound_ms"] / kernel_ms))
        del ops
    torch.cuda.empty_cache()
    return dict(err_bf16=err_bf16, err_int8=err_int8, timings=timings)


# -- phase 4: small model on the card vs float32 on the CPU ----------------------


def phase_small_model(gen_seed: int) -> None:
    """Prefill + 4 paged decode steps of a 2-layer model with head_dim 128
    (G=2) in bf16 on the card (paged attention kernel) against the same
    weights in float32 on the CPU (plain version). Teacher-forced on the
    CPU model's greedy tokens. Tolerance: 5% of the largest reference logit
    (bf16 activations round every op to 2**-8 relative, int8 K/V codes to
    1/254 of each vector's range), and the same top-1 token in 90% of rows;
    a wrong attention moves the logits by their own scale."""
    from clearml_serving_tpu_torch.llm.kv_cache import PagedKVCache
    from clearml_serving_tpu_torch.models.llama import Llama, init_params

    log("phase 4: small model, card (bf16, kernel) vs CPU (float32, plain version)")
    base = {"vocab_size": 512, "dim": 512, "n_layers": 2, "n_heads": 8,
            "n_kv_heads": 4, "head_dim": 128, "ffn_dim": 1024, "rope_theta": 500000.0}
    cpu_params = init_params(dict(base, dtype="float32"),
                             torch.Generator().manual_seed(gen_seed), device="cpu")

    def to(tree, dtype, device):
        out = {k: v.to(dtype).to(device) for k, v in tree.items() if k != "layers"}
        out["layers"] = [{k: v.to(dtype).to(device) for k, v in layer.items()}
                         for layer in tree["layers"]]
        return out

    card_params = to(cpu_params, torch.bfloat16, DEV)
    ref_params = to(card_params, torch.float32, "cpu")    # the same bf16 values
    for kv_quant in ("", "int8"):
        cfg = dict(base, kv_quant=kv_quant)
        models = {
            "card": Llama(dict(cfg, dtype="bfloat16"), card_params),
            "cpu": Llama(dict(cfg, dtype="float32"), ref_params),
        }
        prompt = torch.randint(0, 256, (2, 40), generator=torch.Generator().manual_seed(1))
        lens = [40, 23]
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
        card = torch.stack(logits["card"])
        ref = torch.stack(logits["cpu"])
        err = float((card - ref).abs().max())
        agree = float((card.argmax(-1) == ref.argmax(-1)).float().mean())
        finite = bool(torch.isfinite(card).all())
        log("  kv={:<5} logits max_abs_err {:.3e} (scale {:.2f}), top-1 agreement {:.2f}"
            .format(kv_quant or "bf16", err, float(ref.abs().max()), agree))
        if not finite or err > 0.05 * float(ref.abs().max()) or agree < 0.9:
            raise AssertionError("small model on the card disagrees with the CPU reference")


# -- phase 5: the main path --------------------------------------------------------

PROMPTS = [
    "Write a haiku about the sea.",
    "Explain paged attention in two sentences.",
    "List three prime numbers larger than one hundred, separated by commas.",
    "What is the capital of France? Answer in one word, then say why it matters.",
]


async def post_chat(session, url, prompt, stream, max_tokens):
    body = {"model": "llama3-8b", "messages": [{"role": "user", "content": prompt}],
            "max_tokens": max_tokens, "stream": stream}
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


async def serve_and_chat(engine, tokenizer, max_tokens=32, profiler=None):
    """Start the port's app on a local port, warm it up with the same four
    prompts (first-use costs of every prefill bucket), zero the counts, POST
    the four chats concurrently (two streaming) and read the counts."""
    import aiohttp
    from aiohttp import web

    from clearml_serving_tpu_torch.llm.openai_api import LLMEngineRequest
    from clearml_serving_tpu_torch.ops.paged_attention import paged_attention
    from clearml_serving_tpu_torch.serving.main import build_app

    app = build_app(LLMEngineRequest(engine, tokenizer, "llama3-8b"))
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = runner.addresses[0][1]
    url = "http://127.0.0.1:{}/serve/openai/v1/chat/completions".format(port)
    try:
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as s:
            await asyncio.gather(*[post_chat(s, url, p, False, 4) for p in PROMPTS])
            paged_attention.launches = 0
            for key in engine.counters:
                engine.counters[key] = 0
            engine.ttft_ms.clear()
            if profiler is not None:
                profiler.start()
            t0 = time.perf_counter()
            results = await asyncio.gather(*[
                post_chat(s, url, p, stream=i < 2, max_tokens=max_tokens)
                for i, p in enumerate(PROMPTS)
            ])
            wall = time.perf_counter() - t0
            if profiler is not None:
                sync()
                profiler.stop()
            launches = paged_attention.launches
            counters = dict(engine.counters, ttft_ms=sorted(engine.ttft_ms))
    finally:
        await runner.cleanup()
    return results, wall, launches, counters


def _engine(params, kv_quant, preset):
    from clearml_serving_tpu_torch.llm.openai_api import build_engine

    cfg = {"preset": preset, "cache": "paged", "max_batch": 8, "max_seq_len": 2048,
           "page_size": 16, "decode_steps": 4, "seed": 0}
    if kv_quant:
        cfg["kv_quant"] = kv_quant
    return build_engine(cfg, device=DEV, params=params)


def phase_main_path(params, kv_quant: str, preset: str = "llama3-8b") -> dict:
    engine, tokenizer = _engine(params, kv_quant, preset)
    pools = engine.paged_cache.pool_bytes()
    results, wall, launches, c = asyncio.run(serve_and_chat(engine, tokenizer))
    n_layers = engine.model.n_layers
    del engine
    if torch.device(DEV).type == "cuda":
        torch.cuda.empty_cache()
    streamed = [r for r in results if r["ttft_s"] is not None]
    steps = c["decode_steps"]
    out = dict(
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
    log("  kv={kv}: wall {wall_s:.3f} s, {tokens} tokens, decode steps {decode_steps} "
        "({step_ms:.2f} ms each), prefill {prefill_ms:.2f} ms each, paged_attention "
        "launches {launches}, TTFT {ttft_ms} ms, {decode_tok_s:.1f} tok/s "
        "aggregate, pools {pool_gib:.2f} GiB".format(**out))
    log("  contents:", json.dumps([r["content"][:24] for r in results]))
    if not all(r["content"] for r in results):
        raise AssertionError("an empty completion")
    if any(r["tokens"] is not None and r["tokens"] != 32 for r in results):
        raise AssertionError("a completion stopped before max_tokens")
    if steps == 0 or launches != n_layers * steps:
        raise AssertionError("paged_attention launched {} times for {} decode steps of {} "
                             "layers".format(launches, steps, n_layers))
    return out


def phase_profile(params) -> dict:
    """The bf16 main-path run once more under torch.profiler: device time by
    kernel name and the device's busy share of the run's wall time (the
    union of kernel intervals). Profiling adds host overhead, so these
    shares describe this pass only."""
    from torch.profiler import ProfilerActivity, profile

    engine, tokenizer = _engine(params, "", "llama3-8b")
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    _results, wall, _launches, c = asyncio.run(
        serve_and_chat(engine, tokenizer, profiler=prof))
    del engine
    torch.cuda.empty_cache()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name, spans = {}, []
    for e in kernels:
        t0, t1 = e.time_range.start, e.time_range.end
        by_name[e.name] = by_name.get(e.name, 0.0) + (t1 - t0) / 1e3
        spans.append((t0, t1))
    busy, end = 0.0, None
    for t0, t1 in sorted(spans):
        if end is None or t0 > end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    attn = sum(v for k, v in by_name.items() if "paged_attention_kernel" in k)
    out = dict(wall_ms=wall * 1e3, device_busy_ms=busy / 1e3,
               busy_share=busy / 1e3 / (wall * 1e3), kernel_ms=total,
               paged_attention_ms=attn, decode_steps=c["decode_steps"],
               top=[(k[:60], v) for k, v in top])
    log("  profiled bf16 pass: wall {wall_ms:.1f} ms, device busy {device_busy_ms:.1f} ms "
        "({busy_share:.1%}), kernels {kernel_ms:.1f} ms, paged attention "
        "{paged_attention_ms:.2f} ms over {decode_steps} decode steps".format(**out))
    for name, ms in top:
        log("    {:9.2f} ms  {}".format(ms, name[:100]))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from clearml_serving_tpu_torch.models.llama import init_params
    from clearml_serving_tpu_torch.ops import _build

    t_start = time.perf_counter()
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

    gen = torch.Generator("cuda").manual_seed(0)
    kern = phase_kernels(gen)
    phase_small_model(0)

    log("phase 5: main path, llama3-8b full width bf16 behind the HTTP server")
    t0 = time.perf_counter()
    cfg = {"preset": "llama3-8b"}
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0), device="cuda")
    # random weights emit random ids; the byte tokenizer renders only ids
    # < 256, so the lm_head keeps its columns for the 256 byte ids and
    # zeroes the rest: the model then writes text (and never EOS)
    params["lm_head"][:, 256:] = 0
    sync()
    n_bytes = sum(t.numel() * t.element_size() for t in
                  [params["embed"], params["lm_head"], params["final_norm"]]
                  + [w for layer in params["layers"] for w in layer.values()])
    log("  weights {:.2f} GB made in {:.1f} s".format(n_bytes / 1e9, time.perf_counter() - t0))
    runs = [phase_main_path(params, ""), phase_main_path(params, "int8")]
    log("phase 6: where the time goes")
    prof = phase_profile(params)

    t = kern["timings"]
    kernels = {"kernels": [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "clearml_serving_tpu_torch/csrc/paged_attention.cu",
        "replaces": "clearml_serving_tpu/ops/paged_attention.py:399",
        "tpu": "ops/paged_attention.py:399",
        "launches": runs[0]["launches"],
        "launches_int8": runs[1]["launches"],
        "max_abs_err": kern["err_bf16"],
        "max_err_bf16": kern["err_bf16"],
        "max_err_int8": kern["err_int8"],
        "ms": t["bf16"]["ms"],
        "plain_ms": t["bf16"]["plain_ms"],
        "bound_ms": t["bf16"]["bound_ms"],
        "bound_by": t["bf16"]["bound_by"],
        "library_ms": None,
        "ms_int8": t["int8"]["ms"],
        "plain_ms_int8": t["int8"]["plain_ms"],
        "bound_ms_int8": t["int8"]["bound_ms"],
    }]}
    log("main path:", json.dumps({"runs": runs, "profile": prof}))
    log("total {:.1f} s".format(time.perf_counter() - t_start))
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
