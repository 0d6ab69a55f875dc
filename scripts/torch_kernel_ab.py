#!/usr/bin/env python3
"""A/B one of the port's kernels against another version of it on one GPU,
in one process: the change (this checkout's sources) and a baseline (the
sources of another checkout, e.g. the parent commit unpacked with ``git
archive`` into a directory that .gitignore lists).

    python3 scripts/torch_kernel_ab.py --baseline build/parent [--kernel paged|ragged|int4]
        [--rows 1,8,16]

Both libraries are built with the same ``nvcc`` flags and called through the
same C entry point on the same operands. Each case is held against the plain
PyTorch version (atol = rtol = 2e-2, as chip_smoke.py) and timed in turns
baseline, change, change, baseline (CUDA events over 300 launches rotating
through 4 layers' pools, so L2 holds no layer from one call to the next).
``--kernel paged`` (the default) times decode attention over batches of
lengths (``CASES``: 8 rows of 96, 1024 and 2048 tokens and mixed lengths) in
CUDA-graph replays, called one after another (``eager_ms``) and as host
enqueue time per call (``host_us``), through either C entry point (with or
without the key-range split's partials, detected from the source), with
two-call bit equality of the change; ``--kernel ragged`` times ragged
attention the same way (either C entry point: with or without the draft-tree
mask, with or without the short rows' key-range split) at chip_smoke.py's
mixed, prefill and draft-tree shapes (chain, forest and dead-node verify
rows) and a batch of mixed rows; ``--kernel int4`` times the w4a16 matmul at every
Llama-3-8B projection shape at M 1, 8, 16, 40, 64, 312 and 2048 (the
lm_head up to 312; ``--rows`` picks a subset), in CUDA-graph replays
rotating through copies of the weights that together exceed the L2, and
called one after another (``eager_ms``, CUDA events) with the host's cost of
enqueueing one call (``host_us``), beside the library's int4 product and a
bf16 matmul; it sums one decode step's 225 calls per decode row count (M <=
16) and one ragged step's 224 projection calls at M = 312. Either checkout's C entry point (with or without the
split-K workspace) is called. ``bitwise_equal`` says whether the two
outputs share every bit (expected where the change leaves a tiling as it
was). Prints the card line, then one JSON line per case.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from clearml_serving_tpu_torch.ops import _build  # noqa: E402
from clearml_serving_tpu_torch.ops.fused_matmul import int4_matmul_plain  # noqa: E402
from clearml_serving_tpu_torch.ops.paged_attention import (  # noqa: E402
    RAGGED_QB,
    paged_attention_ref,
    ragged_paged_attention_ref,
    ragged_partial_sizes,
    ragged_split_plan,
    split_plan,
)
from clearml_serving_tpu_torch.ops.quant import dequantize_int4, quantize_int4  # noqa: E402

CASES = {
    "8x96": [96] * 8,
    "8x1024": [1024] * 8,
    "8x2048": [2048] * 8,
    "mixed": [0, 1, 17, 1024, 2048, 700, 1500, 64],
}


def build_baseline(base: Path) -> ctypes.CDLL:
    csrc = base / "clearml_serving_tpu_torch" / "csrc"
    sources = sorted(str(p) for p in csrc.glob("*.cu"))
    if not sources:
        raise SystemExit("no kernel sources under {}".format(csrc))
    out = ROOT / "build" / "kernels_baseline"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / _build.LIB_NAME
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", *sources, "-o", str(lib)],
                   check=True)
    return ctypes.CDLL(str(lib))


RAGGED_CASES = {
    "mixed": cs.RAGGED_MIXED,
    "prefill": cs.RAGGED_PREFILL,
    "mixed_rows": [(1, 1, 1023), (4, 1, 300), (37, 37, 0), (0, 0, 0), (19, 19, 77),
                   (130, 130, 517), (1, 1, 64)],
}
# chip_smoke.py's draft-tree launch, with chain, forest and dead-node verify rows
RAGGED_TREE_CASES = {"tree_" + topo: topology for topo, topology in cs.TREE_TOPOLOGIES.items()}


def has_split_partials(root: Path) -> bool:
    """Whether a checkout's decode kernel splits the key range across CTAs:
    its C entry point then takes the f32 partials' pointers, the split
    count and the span."""
    src = root / "clearml_serving_tpu_torch" / "csrc" / "paged_attention.cu"
    return "part_acc" in src.read_text()


def entry(lib: ctypes.CDLL, split: bool):
    fn = lib.tpu_torch_paged_attention
    n_ptr, n_int = (11, 10) if split else (8, 8)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, split


def has_tree_mask(root: Path) -> bool:
    """Whether a checkout's ragged kernel takes the draft-tree mask: its C
    entry point then has a tree_anc pointer and a tree width."""
    src = root / "clearml_serving_tpu_torch" / "csrc" / "ragged_paged_attention.cu"
    return "tree_anc" in src.read_text()


def has_ragged_split(root: Path) -> bool:
    """Whether a checkout's ragged kernel splits short rows' keys across
    CTAs: its C entry point then takes row_starts, the f32 partials'
    pointers, the split count and the span."""
    src = root / "clearml_serving_tpu_torch" / "csrc" / "ragged_paged_attention.cu"
    return "part_acc" in src.read_text()


def ragged_entry(lib: ctypes.CDLL, tree_mask: bool, split: bool):
    fn = lib.tpu_torch_ragged_paged_attention
    n_ptr, n_int = (16, 12) if split else (12, 10) if tree_mask else (11, 9)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, tree_mask, split


def ragged_launch(entry, out, q, k, v, table, kv_lens, starts, row_lens, *, block_rows,
                  block_q0, k_scale=None, v_scale=None, tree_anc=None):
    """One launch through any of the three entry points; the split one gets
    its f32 partials allocated here as the wrapper does (one buffer)."""
    fn, tree_mask, split = entry
    quant = k.dtype == torch.int8
    t, hkv, g, d = q.shape
    n_rows, pages_per_seq = table.shape
    scales = [k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None]
    tree = [tree_anc.data_ptr() if tree_anc is not None else None] if tree_mask else []
    width = [tree_anc.shape[1] if tree_anc is not None else 0] if tree_mask else []
    ints = [t // RAGGED_QB, hkv, g, d, k.shape[1], k.shape[2], pages_per_seq, n_rows,
            int(quant)] + width
    if split:
        splits, span = ragged_split_plan(t, n_rows, hkv, pages_per_seq, k.shape[2])
        n_acc, n_ml = ragged_partial_sizes(n_rows, hkv, splits, g, d)
        part, buf = [None] * 3, None
        if n_acc:
            buf = torch.empty(n_acc + 2 * n_ml, dtype=torch.float32, device=q.device)
            acc = buf.data_ptr()
            part = [acc, acc + 4 * n_acc, acc + 4 * (n_acc + n_ml)]
        ptrs = ([q.data_ptr(), k.data_ptr(), v.data_ptr()] + scales
                + [table.data_ptr(), kv_lens.data_ptr(), starts.data_ptr(), row_lens.data_ptr(),
                   block_rows.data_ptr(), block_q0.data_ptr()] + tree + [out.data_ptr()] + part)
        ints += [splits, span]
    else:
        ptrs = ([q.data_ptr(), k.data_ptr(), v.data_ptr()] + scales
                + [table.data_ptr(), kv_lens.data_ptr(), row_lens.data_ptr(),
                   block_rows.data_ptr(), block_q0.data_ptr()] + tree + [out.data_ptr()])
    rc = fn(*ptrs, *ints, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError("launch failed: cudaError {}".format(rc))


def ab_ragged(fns, gen, layers) -> None:
    """Per case and pool type: both kernels against the plain version,
    bitwise equality (expected false against a checkout without the split:
    the summation order differs) and two-call equality of the change, then
    CUDA-graph device times, eager times and host enqueue times in turns
    baseline, change, change, baseline, beside the bound and its share."""
    cases = [(case, rows, None) for case, rows in RAGGED_CASES.items()]
    cases += [(case, cs.RAGGED_TREE, topology) for case, topology in RAGGED_TREE_CASES.items()]
    for quant in (False, True):
        for case, rows, topology in cases:
            ops = cs.ragged_operands(gen, rows, quant=quant, layers=layers)
            anc = cs.tree_anc_for(ops, topology) if topology is not None else None
            argl = [cs.ragged_args(ops, li) for li in range(layers)]
            args, kw = argl[0]
            q, k, v = args[:3]
            scales = {key: kw[key] for key in ("k_scale", "v_scale") if key in kw}
            ref = ragged_paged_attention_ref(q.float(), k if quant else k.float(),
                                             v if quant else v.float(), *args[3:], **scales,
                                             tree_anc=anc)
            b_ms, b_by = cs.ragged_bound(ops, anc)
            row = {"case": case, "kv": "int8" if quant else "bf16",
                   "bound_ms": b_ms, "bound_by": b_by}
            outs = {}
            for name, fn in fns.items():
                outs[name] = torch.empty_like(q)
                ragged_launch(fn, outs[name], *args, **kw, tree_anc=anc)
            again = torch.empty_like(q)
            ragged_launch(fns["change"], again, *args, **kw, tree_anc=anc)
            torch.cuda.synchronize()
            for name in fns:
                row[name + "_max_abs_err"] = float((outs[name].float() - ref).abs().max())
                if not torch.allclose(outs[name].float(), ref, rtol=cs.TOL, atol=cs.TOL):
                    raise AssertionError("{} disagrees with the plain version".format(name))
            row["bitwise_equal"] = bool(torch.equal(outs["change"], outs["baseline"]))
            row["deterministic"] = bool(torch.equal(outs["change"], again))
            if not row["deterministic"]:
                raise AssertionError("two calls of the change on the same inputs differ")
            for name in ("baseline", "change", "change", "baseline"):

                def call(li, fn=fns[name], out=outs[name]):
                    ragged_launch(fn, out, *argl[li][0], **argl[li][1], tree_anc=anc)

                row.setdefault(name + "_ms", []).append(cs.time_graph(call, layers, 300))
                row.setdefault(name + "_eager_ms", []).append(cs.time_launches(call, layers, 300))
                row.setdefault(name + "_host_us", []).append(host_us(call, layers))
            for name in ("baseline", "change"):
                row[name + "_share_of_bound"] = b_ms / min(row[name + "_ms"])
            print(json.dumps(row), flush=True)
            del ops, argl
            torch.cuda.empty_cache()


def has_int4_workspace(root: Path) -> bool:
    """Whether a checkout's int4 kernel splits K for decode rows: its C
    entry point then takes a workspace pointer and its size, and a second
    entry point reports the size."""
    src = root / "clearml_serving_tpu_torch" / "csrc" / "fused_int4_matmul.cu"
    return "tpu_torch_fused_int4_workspace" in src.read_text()


def int4_entry(lib: ctypes.CDLL, workspace: bool):
    try:
        fn = lib.tpu_torch_fused_int4_matmul
    except AttributeError:
        raise SystemExit("this library has no fused_int4_matmul kernel")
    if not workspace:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return fn, None
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_longlong,
                                                                 ctypes.c_void_p]
    fn.restype = ctypes.c_int
    query = lib.tpu_torch_fused_int4_workspace
    query.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    query.restype = ctypes.c_int
    return fn, query


def int4_launcher(entry, m, k, n, group):
    """launch(out, x, q, s) through either entry point, with the workspace
    this shape needs allocated once up front (calls run in stream order).
    Each call launches on the stream current at the call, so a CUDA graph
    captures it."""
    fn, query = entry
    if query is None:
        def launch(out, x, q, s):
            rc = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), m, k, n, group,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError("launch failed: cudaError {}".format(rc))
        return launch, 0
    nbytes = ctypes.c_longlong(0)
    rc = query(m, k, n, group, ctypes.byref(nbytes))
    if rc:
        raise RuntimeError("workspace query failed: cudaError {}".format(rc))
    ws = torch.empty(max(1, nbytes.value), dtype=torch.uint8, device="cuda")

    def launch(out, x, q, s):
        rc = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), ws.data_ptr(),
                m, k, n, group, nbytes.value, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError("launch failed: cudaError {}".format(rc))
    return launch, nbytes.value


# the row counts timed per projection shape: chip_smoke.py's, 16 (the
# largest batch of the decode tiling), 40 (the verify lm_head's gathered
# rows) and 64 (the smallest prefill bucket)
INT4_AB_ROWS = (1, 8, 16, 40, 64, 312, 2048)


def host_us(call, copies, n=64) -> float:
    """Host microseconds to enqueue one call (the C entry point's planning,
    tensor-map encoding and launches), from the wall time of ``n`` calls
    issued back to back; the device finishes them after the clock stops."""
    for i in range(copies):
        call(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        call(i % copies)
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * elapsed / n


def ab_int4(entries, gen, rows) -> None:
    """Per shape and row count: both kernels against the plain version,
    bitwise equality and determinism, then CUDA-graph device times, eager
    times and host enqueue times in turns baseline, change, change,
    baseline, beside the library's int4 product
    and a bf16 matmul on the dequantized weight. Then, per decode row
    count, one decode step's 225 calls summed from the shapes' times (each
    kernel's better turn), and at M = 312 one ragged step's 224 projection
    calls (every shape but the lm_head)."""
    steps = {}
    for name, ((k, n), calls) in cs.INT4_SHAPES.items():
        w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
        q, s = quantize_int4(w)
        del w
        group = k // s.shape[0]
        copies = max(2, -(-120_000_000 // (q.numel() + s.numel() * 4)))
        qs = [(q, s)] + [(q.clone(), s.clone()) for _ in range(copies - 1)]
        w_bf16 = dequantize_int4(q, s, torch.bfloat16)
        copies_bf16 = max(2, -(-120_000_000 // (w_bf16.numel() * 2)))
        ws = [w_bf16] + [w_bf16.clone() for _ in range(copies_bf16 - 1)]
        for m in cs.int4_rows(name, rows):
            x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
            ref = int4_matmul_plain(x.float(), q, s, torch.float32)
            b_ms, b_by = cs.int4_bound(m, k, n, s.shape[0])
            row = {"case": name, "m": m, "k": k, "n": n, "bound_ms": b_ms, "bound_by": b_by}
            launches, outs = {}, {}
            for key, entry in entries.items():
                launches[key], row[key + "_workspace_bytes"] = int4_launcher(entry, m, k, n,
                                                                             group)
                outs[key] = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
                launches[key](outs[key], x, q, s)
            again = torch.empty_like(outs["change"])
            launches["change"](again, x, q, s)
            torch.cuda.synchronize()
            for key in entries:
                row[key + "_max_abs_err"] = float((outs[key].float() - ref).abs().max())
                if not torch.allclose(outs[key].float(), ref, rtol=cs.TOL, atol=cs.TOL):
                    raise AssertionError("{} disagrees with the plain version".format(key))
            row["bitwise_equal"] = bool(torch.equal(outs["change"], outs["baseline"]))
            row["deterministic"] = bool(torch.equal(outs["change"], again))
            if not row["deterministic"]:
                raise AssertionError("two calls of the change on the same inputs differ")
            iters = 400 if m <= 16 else 100 if m <= 512 else 20
            for key in ("baseline", "change", "change", "baseline"):

                def call(i, launch=launches[key], out=outs[key], x=x):
                    launch(out, x, *qs[i])

                row.setdefault(key + "_ms", []).append(cs.time_graph(call, copies, iters))
                row.setdefault(key + "_eager_ms", []).append(
                    cs.time_launches(call, copies, iters))
                row.setdefault(key + "_host_us", []).append(host_us(call, copies))
            row["bf16_ms"] = cs.time_graph(lambda i, x=x: torch.matmul(x, ws[i]), copies_bf16,
                                           iters)
            lib_call, lib_err = cs.library_int4(x, qs)
            row["library_ms"] = (cs.time_graph(lib_call, copies, iters)
                                 if lib_call is not None else None)
            if lib_err:
                row["library_error"] = lib_err
            for key in ("baseline", "change"):
                row[key + "_share_of_bound"] = b_ms / min(row[key + "_ms"])
            print(json.dumps(row), flush=True)
            if m <= 16 or (m == 312 and name != "lm_head"):
                steps.setdefault(m, []).append((calls, row))
            del x, outs, again
        del qs, ws, q, s, w_bf16
        torch.cuda.empty_cache()
    for m, shape_rows in steps.items():
        step = {"case": "decode_step" if m <= 16 else "ragged_step", "m": m,
                "calls": sum(c for c, _ in shape_rows)}
        for key in ("baseline_ms", "change_ms", "baseline_eager_ms", "change_eager_ms",
                    "baseline_host_us", "change_host_us", "library_ms", "bf16_ms", "bound_ms"):
            ts = [min(r[key]) if isinstance(r[key], list) else r[key] for _, r in shape_rows]
            step[key] = (None if None in ts
                         else sum(t * c for t, (c, _) in zip(ts, shape_rows)))
        print(json.dumps(step), flush=True)


def launch(entry, out, q, k, v, table, lengths, k_scale=None, v_scale=None):
    """One call through either entry point; the split one gets its f32
    partials allocated here as the wrapper does (``split_plan``, one
    buffer)."""
    fn, split = entry
    quant = k.dtype == torch.int8
    b, hkv, g, d = q.shape
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
            table.data_ptr(), lengths.data_ptr(), out.data_ptr()]
    ints = [b, hkv, g, d, k.shape[1], k.shape[2], table.shape[1], int(quant)]
    if split:
        splits, span = split_plan(b, hkv, table.shape[1], k.shape[2])
        n_acc, n_ml = b * hkv * splits * g * d, b * hkv * splits * g
        acc = torch.empty(n_acc + 2 * n_ml, dtype=torch.float32, device=q.device).data_ptr()
        ptrs += [acc, acc + 4 * n_acc, acc + 4 * (n_acc + n_ml)]
        ints += [splits, span]
    rc = fn(*ptrs, *ints, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError("launch failed: cudaError {}".format(rc))


def ab_paged(entries, gen, layers) -> None:
    """Per case and pool type: both kernels against the plain version,
    bitwise equality (expected false against a checkout without the split:
    the summation order differs) and two-call equality of the change, then
    CUDA-graph device times, eager times and host enqueue times in turns
    baseline, change, change, baseline, beside the bound and its share."""
    for quant in (False, True):
        for case, lengths in CASES.items():
            ops = cs.paged_operands(gen, lengths=lengths, quant=quant, layers=layers)
            argl = [cs.layer_args(ops, li) for li in range(layers)]
            (q, k, v, table, lens), kw = argl[0]
            ref = paged_attention_ref(q.float(), k if quant else k.float(),
                                      v if quant else v.float(), table, lens, **kw)
            b_ms, b_by = cs.bound(ops)
            row = {"case": case, "kv": "int8" if quant else "bf16",
                   "bound_ms": b_ms, "bound_by": b_by}
            outs = {}
            for name, fn in entries.items():
                outs[name] = torch.empty_like(q)
                launch(fn, outs[name], *argl[0][0], **argl[0][1])
            again = torch.empty_like(q)
            launch(entries["change"], again, *argl[0][0], **argl[0][1])
            torch.cuda.synchronize()
            for name in entries:
                row[name + "_max_abs_err"] = float((outs[name].float() - ref).abs().max())
                if not torch.allclose(outs[name].float(), ref, rtol=cs.TOL, atol=cs.TOL):
                    raise AssertionError("{} disagrees with the plain version".format(name))
            row["bitwise_equal"] = bool(torch.equal(outs["change"], outs["baseline"]))
            row["deterministic"] = bool(torch.equal(outs["change"], again))
            if not row["deterministic"]:
                raise AssertionError("two calls of the change on the same inputs differ")
            for name in ("baseline", "change", "change", "baseline"):

                def call(li, fn=entries[name], out=outs[name]):
                    launch(fn, out, *argl[li][0], **argl[li][1])

                row.setdefault(name + "_ms", []).append(cs.time_graph(call, layers, 300))
                row.setdefault(name + "_eager_ms", []).append(cs.time_launches(call, layers, 300))
                row.setdefault(name + "_host_us", []).append(host_us(call, layers))
            for name in ("baseline", "change"):
                row[name + "_share_of_bound"] = b_ms / min(row[name + "_ms"])
            print(json.dumps(row), flush=True)
            del ops, argl
            torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", required=True, type=Path,
                        help="root of the checkout holding the baseline sources")
    parser.add_argument("--kernel", choices=("paged", "ragged", "int4"), default="paged",
                        help="which kernel to compare (default: paged decode attention)")
    parser.add_argument("--rows", default=",".join(map(str, INT4_AB_ROWS)),
                        help="int4: comma-separated row counts to time (default: %(default)s)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs a GPU", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    gen = torch.Generator("cuda").manual_seed(0)
    layers = 4
    if args.kernel == "ragged":
        ab_ragged({"change": ragged_entry(_build.load_library(), has_tree_mask(ROOT),
                                          has_ragged_split(ROOT)),
                   "baseline": ragged_entry(build_baseline(args.baseline),
                                            has_tree_mask(args.baseline),
                                            has_ragged_split(args.baseline))}, gen, layers)
        return 0
    if args.kernel == "int4":
        ab_int4({"change": int4_entry(_build.load_library(), has_int4_workspace(ROOT)),
                 "baseline": int4_entry(build_baseline(args.baseline),
                                        has_int4_workspace(args.baseline))},
                gen, [int(r) for r in args.rows.split(",")])
        return 0
    ab_paged({"change": entry(_build.load_library(), has_split_partials(ROOT)),
              "baseline": entry(build_baseline(args.baseline),
                                has_split_partials(args.baseline))}, gen, layers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
