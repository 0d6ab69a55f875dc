#!/usr/bin/env python3
"""A/B the port's paged attention kernel against another version of it on
one GPU, in one process: the change (this checkout's sources) and a
baseline (the sources of another checkout, e.g. the parent commit unpacked
with ``git archive`` into a directory that .gitignore lists).

    python3 scripts/torch_kernel_ab.py --baseline build/parent

Both libraries are built with the same ``nvcc`` flags and called through the
same C entry point on the same operands. Each case is held against the plain
PyTorch version (atol = rtol = 2e-2, as chip_smoke.py) and timed in turns
baseline, change, change, baseline (CUDA events over 300 launches rotating
through 4 layers' pools, so L2 holds no layer from one call to the next).
Prints the card line, then one JSON line per case.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from clearml_serving_tpu_torch.ops import _build  # noqa: E402
from clearml_serving_tpu_torch.ops.paged_attention import paged_attention_ref  # noqa: E402

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


def entry(lib: ctypes.CDLL):
    fn = lib.tpu_torch_paged_attention
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(fn, out, q, k, v, table, lengths, k_scale=None, v_scale=None):
    quant = k.dtype == torch.int8
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
            table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            q.shape[0], q.shape[1], q.shape[2], q.shape[3], k.shape[1], k.shape[2],
            table.shape[1], int(quant), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError("launch failed: cudaError {}".format(rc))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", required=True, type=Path,
                        help="root of the checkout holding the baseline sources")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs a GPU", file=sys.stderr)
        return 2
    fns = {"change": entry(_build.load_library()), "baseline": entry(build_baseline(args.baseline))}
    print(cs.card_line(), flush=True)
    gen = torch.Generator("cuda").manual_seed(0)
    layers = 4
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
            for name, fn in fns.items():
                outs[name] = torch.empty_like(q)
                launch(fn, outs[name], *argl[0][0], **argl[0][1])
            torch.cuda.synchronize()
            for name in fns:
                err = float((outs[name].float() - ref).abs().max())
                row[name + "_max_abs_err"] = err
                if not torch.allclose(outs[name].float(), ref, rtol=cs.TOL, atol=cs.TOL):
                    raise AssertionError("{} disagrees with the plain version".format(name))
            row["bitwise_equal"] = bool(torch.equal(outs["change"], outs["baseline"]))
            for name in ("baseline", "change", "change", "baseline"):
                out = outs[name]

                def call(li, fn=fns[name], out=out):
                    launch(fn, out, *argl[li][0], **argl[li][1])

                row.setdefault(name + "_ms", []).append(cs.time_launches(call, layers, 300))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
